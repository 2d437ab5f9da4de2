"""The segment kernel's wide route and the scan's N = 1 path.

Rows of at least `_WIDE_MIN_D` values (the MoE combine) take the segment
kernel's wide route; the program path's group-bys keep their plans and so
their bits, which the CPU tests below pin.  The scan's (a, bx) entry at
N = 1 (the RG-LRU) walks chunks of S in parallel.  The tests marked `cuda`
hold both against their plain versions on the card (and twice for their
bits); they need no jax, so on the machine with the card they run alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_segment_wide.py
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.segment_reduce import (segment_reduce,
                                                segment_reduce_plain)
from repro_torch.kernels.selective_scan import (selective_scan,
                                                selective_scan_plain)

seg = importlib.import_module("repro_torch.kernels.segment_reduce")
scan = importlib.import_module("repro_torch.kernels.selective_scan")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (what, rows, width, segments, value stride, (blocks, shift, scratch)):
# one range of each program-path group-by of chip_smoke.py (phases 3, 5
# and 7: group_by, word_count and histogram's broadcast counts, kmeans,
# pagerank's two ranges of soc-LiveJournal1's edges, phase 2's [N, 8]
# rows) and the served lanes' (phase 6: mix (b)'s group_by, pagerank and
# kmeans at both lengths, mix (a)'s), as the bucketed plan made them
# before the wide route existed
PROGRAM_PLANS = [
    ("group_by", 2 ** 26, 1, 2 ** 20, 1, (264, 11, 541197824)),
    ("word_count", 2 ** 26, 1, 2 ** 17, 0, (264, 8, 272762368)),
    ("histogram", 2 ** 26, 1, 256, 0, (528, -1, 540672)),
    ("histogram_sum", 2 ** 26, 1, 256, 1, (528, -1, 540672)),
    ("kmeans", 2 ** 24, 1, 64, 1, (528, -1, 135168)),
    ("pagerank_first", 2 ** 26, 1, 4_847_571, 1, (264, 13, 541873664)),
    ("pagerank_last", 1_884_909, 1, 4_847_571, 1, (116, 13, 17277876)),
    ("rows_of_8", 2 ** 24, 8, 4096, 8, (264, 3, 608306688)),
    ("mix_b_group_by", 2 ** 20, 1, 2 ** 16, 1, (64, 7, 9437952)),
    ("mix_b_group_by_short", 3 * 2 ** 18, 1, 2 ** 16, 1, (48, 7, 7078400)),
    ("mix_b_pagerank", 2 ** 20, 1, 2 ** 16, 1, (64, 7, 9437952)),
    ("mix_b_kmeans", 2 ** 18, 1, 64, 1, (16, -1, 4096)),
    ("mix_b_kmeans_short", 3 * 2 ** 16, 1, 64, 1, (12, -1, 3072)),
    ("mix_a_group_by", 256, 1, 16, 1, (1, -1, 0)),
    ("mix_a_pagerank", 192, 1, 64, 1, (1, -1, 0)),
    ("mix_a_kmeans", 128, 1, 4, 1, (1, -1, 0)),
]


@pytest.mark.parametrize("what,n,d,k,vstride,plan", PROGRAM_PLANS,
                         ids=[p[0] for p in PROGRAM_PLANS])
def test_program_path_plans_are_pinned(what, n, d, k, vstride, plan):
    # the program path's work split, and so its bits, did not move
    assert seg._route(d, k) != "wide"
    assert seg._plan(n, d, k, vstride) == plan
    assert seg._bucket_plan(n, d, k, vstride) == plan


# the MoE combine: (rows, width, tokens) of qwen3-moe-30b-a3b's 2048-token
# prefill, a decode tick at 4 slots, a 4 x 2048-token training
# microbatch, and arctic-480b's 2048-token prefill (top 2 of d 7168)
MOE_SHAPES = [("prefill", 16_384, 2048, 2048), ("decode", 32, 2048, 4),
              ("training", 65_536, 2048, 8192),
              ("arctic", 4096, 7168, 2048)]


@pytest.mark.parametrize("what,n,d,k", MOE_SHAPES,
                         ids=[s[0] for s in MOE_SHAPES])
def test_moe_shapes_take_the_wide_route(what, n, d, k):
    assert seg._route(d, k) == "wide"
    blocks, shift, scratch = seg._plan(n, d, k, d)
    assert (blocks, shift, scratch) == seg._wide_plan(n, d, k)
    buckets = -(-k >> shift)
    assert buckets <= seg._MAX_BUCKETS and (shift == 0 or
                                            -(-k >> (shift - 1))
                                            > seg._MAX_BUCKETS)
    # the scratch holds an 8-byte record a row beside the counts: no value
    counts = buckets * blocks * seg._WARPS + 1
    assert 8 * n + 4 * counts <= scratch < 8 * n + 4 * counts + 4096 \
        + 4 * (counts // seg._SCAN_CHUNK + 1)
    threads = seg._wide_threads(d, k, shift, 2)
    grid = buckets * -(-d // (threads * 8))
    if what == "decode":
        # 8 rows a token: the whole combine is one round of 16-byte loads
        # of 32 one-warp blocks
        assert threads == 32 and grid == 32
    else:
        assert threads == 256 and grid >= 132


@pytest.mark.parametrize("d,k,itemsize,threads", [
    (2048, 2048, 4, 256), (2048, 2048, 2, 256), (1024, 64, 4, 32),
    (4096, 64, 4, 128), (64, 300_000 >> 7, 4, 32), (256, 9, 4, 32),
    (7168, 2048, 2, 256)])
def test_wide_threads(d, k, itemsize, threads):
    # no wider a tile than the row; narrower ones until the grid fills
    # the card, down to a warp
    assert seg._wide_threads(d, k, 0, itemsize) == threads


@pytest.mark.parametrize("op", ["+", "min", "max"])
@pytest.mark.parametrize("d", [1, 64, 100])
def test_cpu_bf16_values_are_the_widened_float32_rows(op, d):
    # on the CPU, bf16 rows reduce as the plain version of their float32
    # widening (the card's wide route widens in registers)
    r = np.random.default_rng(d)
    n, k = 500, 37
    ids = _t(r.integers(-3, k + 3, n).astype(np.int64))
    vals = _t(r.standard_normal((n, d) if d > 1 else n)
              .astype(np.float32)).to(torch.bfloat16)
    got = segment_reduce(ids, vals, k, op=op)
    want = segment_reduce_plain(ids, vals.float(), k, op)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("s,chunk", [(0, 64), (1, 64), (63, 64), (2048, 64),
                                     (2300, 80), (4096, 128), (8192, 256),
                                     (100_000, 3136)])
def test_n1_chunks(s, chunk):
    # a function of S alone; a multiple of the kernel's 16-step batch; at
    # most 32 chunks, so that a chunk's fold over the earlier ones is short
    assert scan._n1_chunk(s) == chunk
    assert chunk % 16 == 0 and -(-s // chunk) <= scan._N1_CHUNKS


def test_counters_hold_the_device_count_entry():
    assert ops.COUNTED["segment_reduce[rows]"] is seg.rows_launches
    assert ops.COUNTED["segment_reduce[lanes]"] is seg.lanes_launches
    ops.reset_launch_counts()
    segment_reduce(torch.zeros(4, dtype=torch.int32), torch.ones(4), 2,
                   n_rows=torch.tensor(3, dtype=torch.int32))
    ops.segment_reduce_lanes([torch.zeros(4, dtype=torch.int32)],
                             [torch.ones(4)], 2,
                             torch.tensor([3], dtype=torch.int32))
    assert ops.launch_counts()["segment_reduce[rows]"] == 0
    assert ops.launch_counts()["segment_reduce[lanes]"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


def _wide_inputs(cuda, n, k, d, dtype, order="unsorted", seed=0):
    """ids with dropped ones (< 0, ≥ k), rows of d values of `dtype`; the
    dropped rows carry inf and NaN, which must reach no segment."""
    r = np.random.default_rng(seed)
    if order == "sorted":
        ids = np.sort(r.integers(-2, k + 2, n))
    else:
        ids = r.integers(-2, k + 2, n)
    if dtype == torch.int32:
        v = r.integers(-1000, 1000, (n, d)).astype(np.int32)
    else:
        v = r.standard_normal((n, d)).astype(np.float32)
        dropped = (ids < 0) | (ids >= k)
        v[dropped] = np.where(np.arange(d) % 2 == 0, np.inf, np.nan)
    return _t(ids.astype(np.int32)).to(cuda), _t(v).to(cuda, dtype)


def _row_order_sums(ids, vals, k):
    """Each segment's float32 sum of its rows in row order from 0: the
    wide route's order (np.add.at applies the rows in index order)."""
    ids = ids.cpu().numpy()
    v = vals.float().cpu().numpy()
    keep = (ids >= 0) & (ids < k)
    out = np.zeros((k, v.shape[1]), np.float32)
    np.add.at(out, ids[keep], v[keep])
    return torch.from_numpy(out)


def _check_wide(got, ids, vals, k, op):
    want = segment_reduce_plain(ids, vals, k, op)
    if op != "+" or vals.dtype == torch.int32:
        assert torch.equal(got, want)
        return
    scale = segment_reduce_plain(ids, vals.float().abs().nan_to_num(0.0), k)
    assert bool(((got - want).abs() <= 1e-4 * scale + 1e-6).all())
    # the order is the rows': the float32 sums in row order, bit for bit
    assert torch.equal(got.cpu(), _row_order_sums(ids, vals, k))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["unsorted", "sorted"])
@pytest.mark.parametrize("op", ["+", "min", "max"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int32])
def test_cuda_wide_matches_plain(cuda, dtype, op, order):
    # 3000 rows of 200 values into 300 segments (one id a bucket, a column
    # tile wider than the row), ids dropped on both sides; twice the same
    # bits, one launch a call
    ids, vals = _wide_inputs(cuda, 3000, 300, 200, dtype, order)
    before = segment_reduce.launches
    got = segment_reduce(ids, vals, 300, op=op)
    again = segment_reduce(ids, vals, 300, op=op)
    assert segment_reduce.launches == before + 2
    assert got.dtype == (torch.int32 if dtype == torch.int32
                         else torch.float32)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _check_wide(got, ids, vals, 300, op)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d,dtype", [
    (32, 4, 2048, torch.bfloat16),        # a decode tick's combine
    (4096, 2048, 7168, torch.bfloat16),   # arctic-480b's width
    (2000, 50, 1100, torch.float32),      # a ragged last column tile
    (2000, 50, 100, torch.bfloat16),      # rows not 16-byte aligned
    (3000, 20_000, 64, torch.float32),    # 8 ids a bucket (shared slice)
    (3000, 300_000, 256, torch.float32),  # 128 ids a bucket (global slice)
    (1500, 9, 300, torch.int32)])
def test_cuda_wide_shapes(cuda, n, k, d, dtype):
    ids, vals = _wide_inputs(cuda, n, k, d, dtype, seed=n + k)
    for op in ("+", "max"):
        got = segment_reduce(ids, vals, k, op=op)
        assert torch.equal(got, segment_reduce(ids, vals, k, op=op))
        _check_wide(got, ids, vals, k, op)
    # int64 ids give the int32 ids' bits
    assert torch.equal(segment_reduce(ids.long(), vals, k),
                       segment_reduce(ids, vals, k))


@pytest.mark.cuda
def test_cuda_wide_moe_combine_in_runs(cuda):
    # the combine's ids: arange(t).repeat_interleave(k), int64
    t, k, d = 2048, 8, 2048
    ids = torch.arange(t, device=cuda).repeat_interleave(k)
    r = np.random.default_rng(5)
    vals = _t(r.standard_normal((t * k, d)).astype(np.float32)) \
        .to(cuda, torch.bfloat16)
    got = segment_reduce(ids, vals, t)
    assert torch.equal(got, segment_reduce(ids, vals, t))
    _check_wide(got, ids, vals, t, "+")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 20_000])
def test_cuda_wide_device_count_and_init(cuda, k):
    # n_rows= reduces the first rows with the bits of a launch over them;
    # init= folds a call's result into an earlier one's, as the ranges do
    ids, vals = _wide_inputs(cuda, 4000, k, 96, torch.bfloat16, seed=k)
    before = seg.rows_launches.launches
    for m in (0, 1, 2500, 4000):
        count = torch.tensor(m, dtype=torch.int32, device=cuda)
        got = segment_reduce(ids, vals, k, n_rows=count)
        assert torch.equal(got, segment_reduce(ids[:m], vals[:m], k))
    assert seg.rows_launches.launches == before + 4
    first = segment_reduce(ids[:1000], vals[:1000], k)
    folded = segment_reduce(ids[1000:], vals[1000:], k, init=first)
    assert torch.equal(folded, first + segment_reduce(ids[1000:],
                                                      vals[1000:], k))


@pytest.mark.cuda
def test_cuda_wide_broadcast_row(cuda):
    # one row expanded to every row (stride 0) is read, never copied
    ids = torch.randint(-2, 102, (5000,), device=cuda, dtype=torch.int32)
    vals = torch.arange(128, dtype=torch.float32, device=cuda)[None] \
        .expand(5000, 128)
    got = segment_reduce(ids, vals, 100)
    assert torch.equal(got, segment_reduce_plain(ids, vals, 100))


def _scan_err(got, want):
    """Largest error over the largest |value| of the plain version."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("d", [2560, 100])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 63, 64, 2300, 8192])
def test_cuda_scan_n1(cuda, s, with_h0, d, b):
    # the RG-LRU's call: N = 1, c = 1 (y is the state): S shorter than a
    # chunk, one short of it, one chunk, ragged chunks, the long prefill;
    # D past a block's channels; within 1e-5 of the plain version, the
    # last y is h_last's bits, twice the same bits, one launch a call
    r = np.random.default_rng(s + d + b)
    a = _t(np.exp(-np.abs(r.standard_normal((b, s, d, 1)))).astype(
        np.float32)).to(cuda)
    bx = _t(r.standard_normal((b, s, d, 1)).astype(np.float32)).to(cuda)
    c = torch.ones(b, s, 1, device=cuda)
    h0 = _t(r.standard_normal((b, d, 1)).astype(np.float32)).to(cuda) \
        if with_h0 else None
    before = selective_scan.launches
    y, h = selective_scan(a, bx, c, h0, return_state=True)
    assert selective_scan.launches == before + 1
    wy, wh = selective_scan_plain(a, bx, c, h0, return_state=True)
    assert _scan_err(y, wy) <= 1e-5 and _scan_err(h, wh) <= 1e-5
    assert torch.equal(y[:, -1], h[..., 0])
    y2, h2 = selective_scan(a, bx, c, h0, return_state=True)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    # and without the state: the same y
    assert torch.equal(selective_scan(a, bx, c, h0), y)


@pytest.mark.cuda
def test_cuda_scan_n1_any_c(cuda):
    # the TPU kernel's contract at N = 1: y = c·h for any c
    r = np.random.default_rng(9)
    b, s, d = 2, 500, 300
    a = _t(np.exp(-np.abs(r.standard_normal((b, s, d, 1)))).astype(
        np.float32)).to(cuda)
    bx, c = (_t(r.standard_normal(shape).astype(np.float32)).to(cuda)
             for shape in ((b, s, d, 1), (b, s, 1)))
    got = selective_scan(a, bx, c, return_state=True)
    want = selective_scan_plain(a, bx, c, return_state=True)
    for x, w in zip(got, want):
        assert _scan_err(x, w) <= 1e-5
