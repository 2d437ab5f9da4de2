"""Segment-⊕ (⊕ ∈ {+, min, max}): the CUDA kernel, its wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel `segment_reduce` in
src/repro/kernels/segment_reduce.py (`_kernel`, a one-hot block reduced on
the MXU in a fixed grid order).  The Hopper kernel (csrc/segment_reduce.cu)
is deterministic like it: the same inputs give the same bits on every
launch, float sums too.  It uses no atomics on device memory and runs no
separate fill: a small [K, D] is reduced into warp-private copies in
shared memory merged in a fixed order, a large one by a partitioned
reduction (rows counted and scattered, stable, into buckets of ids, then
one block a bucket).  Rows of at least `_WIDE_MIN_D` values (the MoE
combine) take the wide route (`_route`): the same count and scatter, of
(id, row index) records only, then a grid of (bucket, column tile) blocks
that read each row's columns straight from the input, bf16 widened in
registers, and ⊕ each output cell in row order in the one thread that
owns it.  It is bound by device-memory bytes — ids and values read once,
the [K, D] output written once — and reads no value of a dropped row at
all.

The order of the sums is fixed by the rows alone, not by N: rows are
reduced in ranges of `RANGE_ROWS` rows, each range in an order fixed by
its own ids and size (`_plan`), and the ranges' results are combined with
⊕ in row order.  So reducing the same rows range by range, and folding the
results in order, gives the same bits as one call over all of them (a
chunked, out-of-core run whose chunks are ranges).

`segment_reduce_lanes` reduces one group-by for the B lanes of a served
flush in one launch a pass (the kernel's lanes entry), each lane over its
own rows counted on the device, with the bits of its own `n_rows=` launch;
the reference vmaps its plan over the batch, which gives its kernel the
batch as one more grid axis.

Contract (the JAX kernel's): ids [N] int; values [N] or [N, D] →
[K] or [K, D].  Ids < 0 or ≥ K contribute nothing.  Integer values
accumulate exactly in int32, floats in float32; the result has the
accumulator's dtype.  The wide route reads float32, int32 and bf16 values
as they are; other dtypes, and bf16 rows narrower than `_WIDE_MIN_D`, are
converted to the accumulator's dtype first.  A NaN in a kept row
propagates through min/max, as jnp.min/jnp.max do.  int32 and int64 ids
are read as they are.
"""
from __future__ import annotations

import ctypes

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


# the kernel's work split (csrc/segment_reduce.cu: kWarps, kSmallCells,
# kSliceCells, kStageBuckets, kScanChunk); a [K, D] of at most _SMALL_CELLS
# cells takes the small path
_WARPS, _SMALL_CELLS, _SCAN_CHUNK = 8, 2048, 4096
_SLICE_CELLS, _STAGE_BUCKETS = 8192, 600
_ROWS_PER_BLOCK = 16384
_SMALL_BLOCKS, _LARGE_BLOCKS = 528, 264   # 4 and 2 blocks an SM of an H100
_MIN_BUCKETS, _MAX_BUCKETS = 512, 4096
RANGE_ROWS = 2 ** 26       # rows one launch takes; the unit of the order
_COMBINE = {"+": torch.add, "min": torch.minimum, "max": torch.maximum}
# the wide route (csrc/segment_reduce.cu: wide_reduce): rows of at least
# _WIDE_MIN_D values; blocks of the count and scatter passes of
# _WIDE_ROWS_PER_BLOCK rows; reduce blocks of up to 256 threads, halved
# down to one warp until there are _WIDE_MIN_BLOCKS (bucket, column tile)
# blocks where the shape allows
_WIDE_MIN_D = 64
_WIDE_ROWS_PER_BLOCK = 2048
_WIDE_MIN_BLOCKS = 264
# the C entries' value dtype codes: the wide entry reads all three, the
# bucketed ones the accumulators' two
_WIDE_DTYPES = {torch.float32: 0, torch.int32: 1, torch.bfloat16: 2}


def _a256(nbytes: int) -> int:
    return -(-nbytes // 256) * 256


def _route(d: int, k: int) -> str:
    """The kernel path of a launch of rows of d values into k segments:
    "wide" for rows of at least _WIDE_MIN_D values, else "small" for a
    [K, D] of at most _SMALL_CELLS cells, else "buckets"."""
    if d >= _WIDE_MIN_D:
        return "wide"
    return "small" if k * d <= _SMALL_CELLS else "buckets"


def _plan(n: int, d: int, k: int, vstride: int):
    """(blocks, shift, scratch bytes) of one launch, from the sizes alone,
    so that the same inputs are reduced in the same order on every launch:
    `_wide_plan`'s on the wide route, else `_bucket_plan`'s."""
    if _route(d, k) == "wide":
        return _wide_plan(n, d, k)
    return _bucket_plan(n, d, k, vstride)


def _wide_plan(n: int, d: int, k: int):
    """The wide route's (blocks, shift, scratch bytes): `blocks` blocks of
    _WIDE_ROWS_PER_BLOCK rows count and scatter; buckets of 2^shift ids,
    the fewest ids a bucket within _MAX_BUCKETS buckets; the scratch holds
    the [bucket, warp range] counts, the scan's chunk sums and an 8-byte
    (id, row) record a row."""
    blocks = max(1, min(_LARGE_BLOCKS, -(-n // _WIDE_ROWS_PER_BLOCK)))
    shift = 0
    while -(-k >> shift) > _MAX_BUCKETS:
        shift += 1
    length = -(-k >> shift) * blocks * _WARPS + 1
    chunks = -(-length // _SCAN_CHUNK)
    return blocks, shift, _a256(4 * length) + _a256(4 * chunks) + 8 * n


def _wide_threads(d: int, k: int, shift: int, itemsize: int) -> int:
    """Threads of a wide reduce block: its column tile is 16 bytes of
    values a thread; 256, halved down to 32 while half the tile still
    covers the row, then while the (bucket, column tile) grid has fewer
    than _WIDE_MIN_BLOCKS blocks."""
    buckets, vec = -(-k >> shift), 16 // itemsize
    threads = 256
    while threads > 32 and threads // 2 * vec >= d:
        threads //= 2
    while threads > 32 and buckets * -(-d // (threads * vec)) \
            < _WIDE_MIN_BLOCKS:
        threads //= 2
    return threads


def _bucket_plan(n: int, d: int, k: int, vstride: int):
    """(blocks, shift, scratch bytes) of the small and bucketed paths.

    `blocks` blocks of 8 warps each walk a fixed contiguous range of rows.
    shift = -1 takes the small path, whose scratch holds the blocks'
    partial [K, D]s; otherwise ids are bucketed 2^shift at a time: slices
    of at most _SMALL_CELLS cells (8 warps' copies in a block's shared
    memory) and at least _MIN_BUCKETS buckets where K allows (blocks of
    the last pass); then slices of up to _SLICE_CELLS (4 warps' copies)
    until at most _STAGE_BUCKETS buckets (whose sectors the scatter can
    stage); at most _MAX_BUCKETS (the counters of the first pass).  The
    large path's scratch holds the [bucket, warp range] counts, the scan's
    chunk sums and the kept rows' ids and (unless broadcast) values."""
    cells = k * d
    if cells <= _SMALL_CELLS:
        blocks = max(1, min(_SMALL_BLOCKS, -(-n // _ROWS_PER_BLOCK)))
        return blocks, -1, blocks * cells * 4 if blocks > 1 else 0
    blocks = max(1, min(_LARGE_BLOCKS, -(-n // _ROWS_PER_BLOCK)))
    shift = 0
    while (2 << shift) * d <= _SMALL_CELLS and k >> (shift + 1) >= _MIN_BUCKETS:
        shift += 1
    while -(-k >> shift) > _STAGE_BUCKETS and (2 << shift) * d <= _SLICE_CELLS:
        shift += 1
    while -(-k >> shift) > _MAX_BUCKETS:
        shift += 1
    length = -(-k >> shift) * blocks * _WARPS + 1
    chunks = -(-length // _SCAN_CHUNK)
    scratch = _a256(4 * length) + _a256(4 * chunks) + _a256(4 * n) \
        + (4 * n * d if vstride else 0)
    return blocks, shift, scratch


def segment_reduce(ids, values, num_segments: int, *, op: str = "+",
                   init=None, n_rows=None):
    """ids: [N] int; values: [N] or [N, D] -> [num_segments(, D)].

    CPU tensors take the plain version, in the kernel's ranges of
    RANGE_ROWS rows folded in row order.  CUDA tensors launch the kernel
    or raise; there is no fallback.  `init` (a result of an earlier call)
    starts the fold: init ⊕ range 1 ⊕ range 2 …, so that rows reduced in
    calls of whole ranges fold as one call over all of them does.

    `n_rows`, a 0-d int32 tensor on the values' device, reduces the first
    n_rows rows alone (clamped to [0, N]), with the bits of a call over
    ids[:n_rows], values[:n_rows].  On the card the kernel reads the count
    on the device (the device-count entry): the grid and scratch are sized
    for N, nothing is read on the host, and a CUDA graph that captured the
    launch reduces whatever count the tensor holds at each replay (a lane
    of a served batch, padded to the batch's rows).  On the CPU the plain
    version runs over [:n_rows]."""
    if op not in _OPS:
        raise ValueError(f"segment_reduce: unsupported op {op!r}")
    if n_rows is not None:
        if init is not None:
            raise ValueError("segment_reduce: n_rows= and init= do not "
                             "combine")
        _check_count(n_rows, values)
        if values.device.type == "cuda":
            return _launch(ids, values, num_segments, op, n_rows)
        n = max(0, min(int(n_rows), values.shape[0]))
        return segment_reduce(ids[:n], values[:n], num_segments, op=op)
    if init is not None:
        return _by_ranges(ids, values, num_segments, op, init)
    if values.device.type == "cpu" and ids.device.type == "cpu":
        return _plain_ranges(ids, values, num_segments, op)
    return _launch(ids, values, num_segments, op)


def _plain_ranges(ids, values, k: int, op: str):
    """The plain version in the kernel's ranges of RANGE_ROWS rows, folded
    in row order: the bits of the kernel's route on the CPU."""
    out = None
    for i in range(0, max(values.shape[0], 1), RANGE_ROWS):
        rows = slice(i, i + RANGE_ROWS)
        part = segment_reduce_plain(ids[rows], values[rows], k, op)
        out = part if out is None else _COMBINE[op](out, part)
    return out


segment_reduce.launches = 0


class _Count:
    """A launch counter beside a wrapper's own."""
    launches = 0


# the device-count entry's launches (`n_rows=`) and the lanes entry's
# (`segment_reduce_lanes`), which segment_reduce's count includes:
# `ops.launch_counts()["segment_reduce[rows]"]` and `["segment_reduce[lanes]"]`
rows_launches = _Count()
lanes_launches = _Count()


def _check_count(n_rows, values) -> None:
    if not torch.is_tensor(n_rows) or n_rows.dtype != torch.int32 \
            or n_rows.dim() != 0 or n_rows.device != values.device:
        raise ValueError(
            "segment_reduce: n_rows must be a 0-d int32 tensor on the "
            f"values' device {values.device} (got {n_rows!r})")


def _launch(ids, values, num_segments: int, op: str, n_rows=None,
            base: int = 0):
    """One launch of the kernel (ranges of RANGE_ROWS rows, folded in row
    order, beyond that); with `n_rows`, of the device-count entry, which
    reduces the first `n_rows - base` rows."""
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
    if k == 0 or d == 0:     # nothing to write: no launch
        out = torch.empty((k, d), dtype=_acc_dtype(vals.dtype),
                          device=vals.device)
        return out[:, 0] if squeeze else out
    if n > RANGE_ROWS:
        return _by_ranges(ids, values, k, op, n_rows=n_rows)
    acc = _acc_dtype(vals.dtype)
    wide = _route(d, k) == "wide"
    if not (wide and vals.dtype in _WIDE_DTYPES):
        vals = vals.to(acc)
    if vals.stride(0) == 0 and (d == 1 or vals.stride(1) == 1):
        vstride = 0          # one broadcast row: read it, never copy it
    else:
        vals = vals.contiguous()
        vstride = d
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int64)
    ids = ids.contiguous()
    blocks, shift, scratch_bytes = _plan(n, d, k, vstride)
    out = torch.empty((k, d), dtype=acc, device=vals.device)
    scratch = torch.empty(max(scratch_bytes, 1), dtype=torch.uint8,
                          device=vals.device)
    lib = _build.load("segment_reduce")
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    args = (_WIDE_DTYPES[vals.dtype], _OPS[op], ids.data_ptr(),
            vals.data_ptr(), out.data_ptr(), n, d, vstride, k, stream,
            int(ids.dtype == torch.int64), scratch.data_ptr(), scratch_bytes,
            blocks, shift)
    if wide:
        # a device count's plan is derived on the device as _wide_plan
        # makes it: the same block cap and rows a block
        count = (None, 0, 1, 1) if n_rows is None else \
            (n_rows.data_ptr(), base, _LARGE_BLOCKS, _WIDE_ROWS_PER_BLOCK)
        code = lib.segment_reduce_wide_launch(
            *args, _wide_threads(d, k, shift, vals.element_size()), *count)
    elif n_rows is None:
        code = lib.segment_reduce_launch(*args)
    else:
        # the device derives the counted rows' plan as _plan does: the
        # same block cap and rows a block
        cap = _SMALL_BLOCKS if shift < 0 else _LARGE_BLOCKS
        code = lib.segment_reduce_launch_rows(*args, n_rows.data_ptr(), base,
                                              cap, _ROWS_PER_BLOCK)
    _build.check("segment_reduce", code)
    segment_reduce.launches += 1
    if n_rows is not None:
        rows_launches.launches += 1
    return out[:, 0] if squeeze else out


def _by_ranges(ids, values, k: int, op: str, out=None, n_rows=None):
    """Range by range, the results combined in row order (after `out`).
    With a device count, a range that starts at or past it is left out of
    the fold by a select on the device, as a call over the counted rows
    has no such range."""
    for i in range(0, values.shape[0], RANGE_ROWS):
        rows = slice(i, i + RANGE_ROWS)
        if n_rows is None:
            part = segment_reduce(ids[rows], values[rows], k, op=op)
        else:
            part = _launch(ids[rows], values[rows], k, op, n_rows, base=i)
        if out is None:
            out = part
        elif n_rows is None:
            out = _COMBINE[op](out, part)
        else:
            out = torch.where(n_rows > i, _COMBINE[op](out, part), out)
    return out


def segment_sum(ids, values, num_segments: int):
    """ids: [N] int32; values: [N, D] -> [num_segments, D] float32 (the
    historical float32 entry point of the JAX package)."""
    return segment_reduce(ids, values.to(torch.float32), num_segments, op="+")


# lanes of one launch of the lanes entry at most (csrc/segment_reduce.cu:
# kMaxLanes)
_MAX_LANES = 32


def segment_reduce_lanes_plain(ids, values, num_segments: int, counts,
                               op: str = "+"):
    """The lanes' function in plain PyTorch: lane by lane, the plain
    version over the lane's first counts[b] rows (clamped to [0, N]), in
    ranges of RANGE_ROWS rows folded in row order; stacked [B, K(, D)]."""
    if op not in _OPS:
        raise ValueError(f"segment_reduce: unsupported op {op!r}")
    outs = []
    for i, v, n in zip(ids, values, counts.tolist()):
        n = max(0, min(int(n), v.shape[0]))
        outs.append(_plain_ranges(i[:n], v[:n], num_segments, op))
    return torch.stack(outs)


def segment_reduce_lanes(ids, values, num_segments: int, counts, *,
                         op: str = "+"):
    """B lanes of one group-by (a served flush's): ids[b] [N] int and
    values[b] [N] or [N, D] -> [B, num_segments(, D)], lane b the reduction
    of its first counts[b] rows (clamped to [0, N]), with the bits of
    `segment_reduce(ids[b], values[b], K, n_rows=counts[b])`.  `counts` is
    a [B] int32 tensor on the values' device; the lanes share N, D and the
    dtypes of ids and values.

    CUDA tensors launch the kernel's lanes entry or raise; there is no
    fallback.  Each pass is one launch over up to 32 lanes (more lanes take
    a launch each 32), a lane's blocks on the grid's second axis, each
    lane's count read on the device, so a CUDA graph that captured the
    call reduces whatever counts the tensor holds at each replay.  Lanes
    longer than RANGE_ROWS go range by range, each range one lanes launch,
    folded in row order.  Wide rows (D >= 64) take a device-count launch a
    lane: no served program has them.  CPU tensors run
    `segment_reduce_lanes_plain`."""
    if op not in _OPS:
        raise ValueError(f"segment_reduce: unsupported op {op!r}")
    ids, values = list(ids), list(values)
    if not values or len(ids) != len(values):
        raise ValueError(f"segment_reduce: {len(ids)} lanes of ids and "
                         f"{len(values)} of values")
    v0 = values[0]
    if not torch.is_tensor(counts) or counts.dtype != torch.int32 \
            or counts.shape != (len(values),) or counts.device != v0.device:
        raise ValueError(
            "segment_reduce: counts must be a [B] int32 tensor on the "
            f"values' device {v0.device} (got {counts!r})")
    if v0.device.type == "cpu":
        return segment_reduce_lanes_plain(ids, values, num_segments, counts,
                                          op)
    for i, v in zip(ids, values):
        if v.device != v0.device or i.device != v0.device \
                or v.shape != v0.shape or v.dtype != v0.dtype \
                or i.shape != ids[0].shape or i.dtype != ids[0].dtype:
            raise ValueError(
                "segment_reduce: the lanes must share a CUDA device and "
                f"their shapes and dtypes (got ids {tuple(i.shape)} "
                f"{i.dtype} on {i.device}, values {tuple(v.shape)} "
                f"{v.dtype} on {v.device}; lane 0: {tuple(ids[0].shape)} "
                f"{ids[0].dtype}, {tuple(v0.shape)} {v0.dtype} on "
                f"{v0.device})")
    k = int(num_segments)
    d = v0.shape[1] if v0.dim() == 2 else 1
    if v0.dim() == 2 and _route(d, k) == "wide":
        # one device-count launch a lane: no served program has wide rows
        return torch.stack([_launch(i, v, k, op, counts[b])
                            for b, (i, v) in enumerate(zip(ids, values))])
    counts = counts.contiguous()
    n = v0.shape[0]
    if n <= RANGE_ROWS:
        return _launch_lanes(ids, values, k, op, counts)
    out = None
    for i in range(0, n, RANGE_ROWS):
        rows = slice(i, i + RANGE_ROWS)
        part = _launch_lanes([x[rows] for x in ids],
                             [v[rows] for v in values], k, op, counts, i)
        if out is None:
            out = part
        else:
            # a lane whose count ends at or before this range has no such
            # range: its result is left as it was, as its own launch's is
            keep = (counts > i).view(-1, *[1] * (part.dim() - 1))
            out = torch.where(keep, _COMBINE[op](out, part), out)
    return out


def _launch_lanes(ids, values, k: int, op: str, counts, base: int = 0):
    """One launch of the lanes entry a pass for each 32 lanes, reducing
    lane b's first `counts[b] - base` rows."""
    v0 = values[0]
    if v0.device.type != "cuda":
        raise ValueError("segment_reduce: the lanes must lie on a CUDA "
                         f"device (got {v0.device})")
    if v0.dim() not in (1, 2) or ids[0].dim() != 1 \
            or ids[0].shape[0] != v0.shape[0]:
        raise ValueError(f"segment_reduce: ids {tuple(ids[0].shape)} and "
                         f"values {tuple(v0.shape)} do not match")
    squeeze = v0.dim() == 1
    vals = [v[:, None] if squeeze else v for v in values]
    n, d = vals[0].shape
    B = len(vals)
    if k < 0 or k * max(d, 1) >= 2 ** 31 or n >= 2 ** 62:
        raise ValueError(f"segment_reduce: unsupported sizes n={n} k={k}")
    acc = _acc_dtype(vals[0].dtype)
    out = torch.empty((B, k, d), dtype=acc, device=v0.device)
    if k == 0 or d == 0:     # nothing to write: no launch
        return out[:, :, 0] if squeeze else out
    vals = [v.to(acc) for v in vals]
    if all(v.stride(0) == 0 and (d == 1 or v.stride(1) == 1) for v in vals):
        vstride = 0          # each lane one broadcast row: never copied
    else:
        vals = [v.contiguous() for v in vals]
        vstride = d
    if ids[0].dtype not in (torch.int32, torch.int64):
        ids = [i.to(torch.int64) for i in ids]
    ids = [i.contiguous() for i in ids]
    blocks, shift, scratch_bytes = _bucket_plan(n, d, k, vstride)
    lane_bytes = _a256(max(scratch_bytes, 1))
    scratch = torch.empty(min(B, _MAX_LANES) * lane_bytes, dtype=torch.uint8,
                          device=v0.device)
    lib = _build.load("segment_reduce")
    stream = torch.cuda.current_stream(v0.device).cuda_stream
    # the device derives each lane's plan as _plan does for its count
    cap = _SMALL_BLOCKS if shift < 0 else _LARGE_BLOCKS
    for lo in range(0, B, _MAX_LANES):
        lanes = range(lo, min(B, lo + _MAX_LANES))
        ptrs = ctypes.c_void_p * len(lanes)
        code = lib.segment_reduce_launch_lanes(
            _WIDE_DTYPES[acc], _OPS[op],
            ptrs(*[ids[b].data_ptr() for b in lanes]),
            ptrs(*[vals[b].data_ptr() for b in lanes]),
            ptrs(*[out[b].data_ptr() for b in lanes]), len(lanes), n, d,
            vstride, k, stream, int(ids[0].dtype == torch.int64),
            scratch.data_ptr(), lane_bytes, blocks, shift,
            counts.data_ptr() + 4 * lo, base, cap, _ROWS_PER_BLOCK)
        _build.check("segment_reduce", code)
        segment_reduce.launches += 1
        lanes_launches.launches += 1
    return out[:, :, 0] if squeeze else out
