"""Segment-⊕ (⊕ ∈ {+, min, max}): the CUDA kernel, its wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel `segment_reduce` in
src/repro/kernels/segment_reduce.py (`_kernel`, a one-hot block reduced on
the MXU).  The Hopper kernel (csrc/segment_reduce.cu) is a scatter with
atomics: shared-memory privatised copies of the output when [K, D] fits
(≤ 48K cells), global atomics otherwise.  It is bound by device-memory
bytes — ids and values read once, the [K, D] output filled and written —
and reads no value of a dropped row at all.

Contract (the JAX kernel's): ids [N] int; values [N] or [N, D] →
[K] or [K, D].  Ids < 0 or ≥ K contribute nothing.  Integer values
accumulate exactly in int32, floats in float32; the result has the
accumulator's dtype.  A NaN in a kept row propagates through min/max, as
jnp.min/jnp.max do.  Float sums use atomics, so their last bits change
from run to run; compare them with a tolerance.
"""
from __future__ import annotations

import torch

from . import _build

_OPS = {"+": 0, "min": 1, "max": 2}
_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


def _acc_dtype(dtype):
    return torch.int32 if dtype in _INT_DTYPES else torch.float32


def _identity(op: str, acc):
    if op == "+":
        return 0
    if acc == torch.int32:
        big = torch.iinfo(torch.int32).max
        return big if op == "min" else -big
    return float("inf") if op == "min" else float("-inf")


def segment_reduce_plain(ids, values, num_segments: int, op: str = "+"):
    """The same function in plain PyTorch: ⊕ into a buffer one row larger
    than the output, with every dropped id routed to that last row."""
    if op not in _OPS:
        raise ValueError(f"segment_reduce: unsupported op {op!r}")
    squeeze = values.dim() == 1
    vals = values[:, None] if squeeze else values
    acc = _acc_dtype(vals.dtype)
    vals = vals.to(acc)
    d = vals.shape[1]
    ids = ids.to(torch.int64).reshape(-1)
    keep = (ids >= 0) & (ids < num_segments)
    idx = torch.where(keep, ids, num_segments)
    out = torch.full((num_segments + 1, d), _identity(op, acc), dtype=acc,
                     device=vals.device)
    if op == "+":
        out.index_add_(0, idx, vals)
    else:
        out.scatter_reduce_(0, idx[:, None].expand(-1, d), vals,
                            reduce="amin" if op == "min" else "amax",
                            include_self=True)
        if acc == torch.float32:
            # a NaN in a kept row wins, as in jnp.min/jnp.max, whatever the
            # scatter's own NaN handling on this device
            nans = torch.zeros((num_segments + 1, d), dtype=torch.int32,
                               device=vals.device)
            nans.index_add_(0, idx, torch.isnan(vals).to(torch.int32))
            out = torch.where(nans > 0, torch.full_like(out, float("nan")),
                              out)
    out = out[:num_segments]
    return out[:, 0] if squeeze else out


def segment_reduce(ids, values, num_segments: int, *, op: str = "+"):
    """ids: [N] int; values: [N] or [N, D] -> [num_segments(, D)].

    CPU tensors take the plain version.  CUDA tensors launch the kernel or
    raise; there is no fallback."""
    if op not in _OPS:
        raise ValueError(f"segment_reduce: unsupported op {op!r}")
    if values.device.type == "cpu" and ids.device.type == "cpu":
        return segment_reduce_plain(ids, values, num_segments, op)
    if values.device.type != "cuda" or ids.device != values.device:
        raise ValueError("segment_reduce: ids and values must lie on one "
                         f"CUDA device (got {ids.device}, {values.device})")
    if values.dim() not in (1, 2) or ids.dim() != 1 \
            or ids.shape[0] != values.shape[0]:
        raise ValueError(f"segment_reduce: ids {tuple(ids.shape)} and "
                         f"values {tuple(values.shape)} do not match")
    squeeze = values.dim() == 1
    vals = values[:, None] if squeeze else values
    n, d = vals.shape
    k = int(num_segments)
    if k < 0 or k * max(d, 1) >= 2 ** 31 or n >= 2 ** 62:
        raise ValueError(f"segment_reduce: unsupported sizes n={n} k={k}")
    acc = _acc_dtype(vals.dtype)
    vals = vals.to(acc)
    if vals.stride(0) == 0 and (d == 1 or vals.stride(1) == 1):
        vstride = 0          # one broadcast row: read it, never copy it
    else:
        vals = vals.contiguous()
        vstride = d
    ids32 = ids.to(torch.int32).contiguous()
    out = torch.empty((k, d), dtype=acc, device=vals.device)
    lib = _build.load("segment_reduce")
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    code = lib.segment_reduce_launch(
        0 if acc == torch.float32 else 1, _OPS[op], ids32.data_ptr(),
        vals.data_ptr(), out.data_ptr(), n, d, vstride, k, stream)
    _build.check("segment_reduce", code)
    segment_reduce.launches += 1
    return out[:, 0] if squeeze else out


segment_reduce.launches = 0


def segment_sum(ids, values, num_segments: int):
    """ids: [N] int32; values: [N, D] -> [num_segments, D] float32 (the
    historical float32 entry point of the JAX package)."""
    return segment_reduce(ids, values.to(torch.float32), num_segments, op="+")
