"""Public entry points of the hand-written kernels.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors.  Each counts its launches in a plain
integer attribute (`segment_reduce.launches`, `tile_matmul.launches`; the
packed entry `tile_matmul_packed` launches the same kernel and counts in
`tile_matmul.launches`), so a run can show that it went through the
kernels.  `flash_attention` and
`selective_scan` of the JAX package are not ported yet.
"""
from __future__ import annotations

from ._build import build_all
from .segment_reduce import segment_reduce, segment_sum
from .tile_matmul import tile_matmul, tile_matmul_packed

KERNELS = {"segment_reduce": segment_reduce, "tile_matmul": tile_matmul}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["build_all", "segment_reduce", "segment_sum", "tile_matmul",
           "tile_matmul_packed", "launch_counts", "reset_launch_counts",
           "KERNELS"]
