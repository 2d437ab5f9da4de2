"""Public entry points of the hand-written kernels.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors.  Each counts its launches in a plain
integer attribute (`segment_reduce.launches`, `tile_matmul.launches`,
`flash_attention.launches`, `selective_scan.launches`; the packed entry
`tile_matmul_packed` launches the same kernel and counts in
`tile_matmul.launches`; the scan kernel's fused entry
`selective_scan_fused` counts in `selective_scan_fused.launches`; the
backward kernels count in `flash_attention_bwd.launches`,
`selective_scan_fused_bwd.launches` and, for the scan's (a, bx) entry,
`selective_scan_bwd.launches`; the segment kernel's device-count entry
also in `segment_reduce.rows_launches`, "segment_reduce[rows]" below, and
its lanes entry `segment_reduce_lanes` in `segment_reduce.lanes_launches`,
"segment_reduce[lanes]"; the
flash forward's wgmma route, hd 64 and 256 in bf16, also in
`flash_attention.wg_launches`, "flash_attention[wg]", the backward's,
hd 64, 128 and 256 in bf16, in `flash_attention.bwd_wg_launches`,
"flash_attention_bwd[wg]", and of those its split route at hd 64 not
causal in `flash_attention.bwd_split_launches`, "flash_attention_bwd[full,
hd 64]"; the multi-tensor AdamW's two kernels, norm and update, in
`adamw.launches`), so a run can show that it went through the kernels.

The counts are of launches that ran on the device.  A CUDA graph capture
calls the wrappers, but launches nothing: `captured()` takes the counts the
capture added back out and hands them to the caller, who `credit()`s them
again on each replay of that graph.
"""
from __future__ import annotations

from contextlib import contextmanager

from ._build import build_all
from .adamw import adamw
from .flash_attention import (bwd_split_launches, bwd_wg_launches,
                              flash_attention, flash_attention_bwd,
                              wg_launches)
from .segment_reduce import (lanes_launches, rows_launches, segment_reduce,
                             segment_reduce_lanes, segment_sum)
from .selective_scan import (selective_scan, selective_scan_bwd,
                             selective_scan_fused, selective_scan_fused_bwd)
from .tile_matmul import tile_matmul, tile_matmul_packed

# each kernel source's counting wrapper, by source name
KERNELS = {"segment_reduce": segment_reduce, "tile_matmul": tile_matmul,
           "flash_attention": flash_attention,
           "selective_scan": selective_scan,
           "flash_attention_bwd": flash_attention_bwd,
           "selective_scan_bwd": selective_scan_fused_bwd,
           "adamw": adamw}


# every counter: the kernels, the scan's second entry, the (a, bx) entry's
# backward (in the selective_scan_bwd library), and parts of a kernel's
# own count: the segment kernel's device-count and lanes launches, the
# flash forward's and backward's wgmma routes and the backward's split
# route at hd 64
COUNTED = {**KERNELS, "selective_scan_fused": selective_scan_fused,
           "selective_scan_bwd[a, bx]": selective_scan_bwd,
           "segment_reduce[rows]": rows_launches,
           "segment_reduce[lanes]": lanes_launches,
           "flash_attention[wg]": wg_launches,
           "flash_attention_bwd[wg]": bwd_wg_launches,
           "flash_attention_bwd[full, hd 64]": bwd_split_launches}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


@contextmanager
def captured():
    """Around a CUDA graph capture: yields a dict that, on exit, holds the
    launches the captured work made by kernel, and leaves the counters as
    they were before the capture (nothing ran on the device)."""
    before = launch_counts()
    took: dict = {}
    try:
        yield took
    finally:
        for name, fn in COUNTED.items():
            added = fn.launches - before[name]
            fn.launches = before[name]
            if added:
                took[name] = added


def credit(counts: dict) -> None:
    """Count `counts` launches (a replay of a graph that `captured()`
    measured)."""
    for name, n in counts.items():
        COUNTED[name].launches += n


__all__ = ["adamw", "build_all", "segment_reduce", "segment_reduce_lanes",
           "segment_sum", "tile_matmul",
           "tile_matmul_packed", "flash_attention", "flash_attention_bwd",
           "selective_scan", "selective_scan_bwd", "selective_scan_fused",
           "selective_scan_fused_bwd",
           "launch_counts", "reset_launch_counts", "captured", "credit",
           "KERNELS"]
