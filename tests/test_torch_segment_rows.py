"""The segment kernel's device-count entry (`segment_reduce(..., n_rows=)`):
a launch over N rows that reduces the first n of them, the count read on
the device, with the bits of a launch over those n rows alone; and its
lanes entry (`segment_reduce_lanes`): one launch a pass for the B lanes
of a served flush's group-by, lane b over its first counts[b] rows, each
with the bits of its own `n_rows=` launch.  A served flush reduces each
of its group-bys through one lanes call.

On the CPU the wrapper runs the plain version over [:n]; the tests here
hold that route to a launch over [:n], with ranges of RANGE_ROWS rows
shrunk so that a count inside, at and past a range's edge is reached, and
check that the count is a 0-d int32 tensor on the values' device.  The
lanes' plain version is held to B separate `n_rows=` calls bit for bit and
each lane to the JAX package's kernel (interpret mode) at
tests/test_torch_kernels.py's tolerances, and a CPU flush of group_by,
pagerank and kmeans_step makes one lanes call a group-by.  Tests marked
`cuda` hold the kernel itself, bit for bit, against a launch over [:n] on
the small and the partitioned paths (n < N, n = 0, n = N, the count in a
[B] tensor), inside a CUDA graph replayed with other counts, and over
ranges, and the lanes entry against each lane's `n_rows=` launch; they
skip here and need no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_segment_rows.py
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.kernels.segment_reduce import \
        segment_reduce as jax_segment_reduce
except ImportError:     # the card's machine: only the `cuda` tests run there
    pass
from repro_torch.kernels import ops, segment_reduce, segment_reduce_lanes
from repro_torch.kernels.segment_reduce import (segment_reduce_lanes_plain,
                                                segment_reduce_plain)

segment_module = importlib.import_module("repro_torch.kernels.segment_reduce")


def _n(n, device="cpu"):
    return torch.tensor(n, dtype=torch.int32, device=device)


def _case(n, k, d, seed, dtype=np.float32, id_dtype=np.int32):
    r = np.random.default_rng(seed)
    ids = torch.from_numpy(r.integers(-2, k + 2, n).astype(id_dtype))
    shape = (n, d) if d > 1 else (n,)
    if dtype == np.int32:
        vals = torch.from_numpy(r.integers(-50, 50, shape).astype(np.int32))
    else:
        vals = torch.from_numpy(r.standard_normal(shape).astype(dtype))
    return ids, vals


@pytest.mark.parametrize("op", ["+", "min", "max"])
@pytest.mark.parametrize("n", [0, 1, 37, 200, 257])
def test_plain_route_equals_a_launch_over_the_first_rows(op, n):
    ids, vals = _case(257, 20, 1, n)
    want = segment_reduce_plain(ids[:n], vals[:n], 20, op)
    got = segment_reduce(ids, vals, 20, op=op, n_rows=_n(n))
    assert torch.equal(got, want)


def test_plain_route_clamps_the_count_and_takes_rows_of_values():
    ids, vals = _case(64, 9, 3, 1, np.int32)
    assert torch.equal(segment_reduce(ids, vals, 9, n_rows=_n(1000)),
                       segment_reduce_plain(ids, vals, 9))
    assert torch.equal(segment_reduce(ids, vals, 9, n_rows=_n(-5)),
                       segment_reduce_plain(ids[:0], vals[:0], 9))
    # the count is a 0-d int32 tensor on the values' device, nothing else
    for bad in (4, torch.tensor(4), torch.tensor([4], dtype=torch.int32)):
        with pytest.raises(ValueError, match="0-d int32"):
            segment_reduce(ids, vals, 9, n_rows=bad)


@pytest.mark.parametrize("n", [0, 10, 16, 17, 40, 48])
def test_plain_route_over_ranges(monkeypatch, n):
    # a count inside, at and past the edge of a range of RANGE_ROWS rows:
    # the rows left are folded range by range, as a call over them is
    monkeypatch.setattr(segment_module, "RANGE_ROWS", 16)
    ids, vals = _case(48, 7, 1, n)
    got = segment_reduce(ids, vals, 7, n_rows=_n(n))
    assert torch.equal(got, segment_reduce(ids[:n], vals[:n], 7))


def test_n_rows_and_init_do_not_combine():
    ids, vals = _case(8, 3, 1, 0)
    with pytest.raises(ValueError, match="do not combine"):
        segment_reduce(ids, vals, 3, n_rows=_n(4), init=torch.zeros(3))


# ---------------------------------------------------------------------------
# the lanes entry on the CPU: its plain version
# ---------------------------------------------------------------------------

LANE_COUNTS = (0, 1, 61, 23)     # none, one, every one of L = 61, some


def _lanes(B, n, k, d, seed, dtype=np.float32, id_dtype=np.int32):
    cases = [_case(n, k, d, seed + b, dtype, id_dtype) for b in range(B)]
    return [c[0] for c in cases], [c[1] for c in cases]


@pytest.mark.parametrize("op", ["+", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("d", [1, 3])
def test_lanes_plain_equals_a_counted_call_a_lane(op, dtype, id_dtype, d):
    ids, vals = _lanes(len(LANE_COUNTS), 61, 9, d, 7, dtype, id_dtype)
    counts = torch.tensor(LANE_COUNTS, dtype=torch.int32)
    plain = segment_reduce_lanes_plain(ids, vals, 9, counts, op)
    got = segment_reduce_lanes(ids, vals, 9, counts, op=op)
    assert torch.equal(got, plain)
    for b, (i, v) in enumerate(zip(ids, vals)):
        assert torch.equal(plain[b], segment_reduce(i, v, 9, op=op,
                                                    n_rows=counts[b])), b


@pytest.mark.parametrize("op", ["+", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_lanes_against_the_jax_kernel(op, dtype):
    # each lane against the JAX package's Pallas kernel (interpret mode)
    # over its first counts[b] rows; that kernel takes no empty input (its
    # row block divides by N), so the lane of count 0 is held to the ⊕
    # identity, as the JAX kernel's contract gives an empty segment
    ids, vals = _lanes(len(LANE_COUNTS), 61, 9, 3, 11, dtype)
    counts = torch.tensor(LANE_COUNTS, dtype=torch.int32)
    got = segment_reduce_lanes(ids, vals, 9, counts, op=op)
    for b, n in enumerate(LANE_COUNTS):
        if n == 0:
            assert torch.equal(got[b], segment_reduce_plain(
                ids[b][:0], vals[b][:0], 9, op)), b
            continue
        want = jax_segment_reduce(jnp.asarray(ids[b][:n].numpy()),
                                  jnp.asarray(vals[b][:n].numpy()), 9,
                                  op=op, bn=16, bk=8, bd=8)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [0, 10, 16, 17, 40, 48])
def test_lanes_plain_over_ranges(monkeypatch, n):
    # the lanes' counts inside, at and past a range's edge fold range by
    # range, as each lane's own call does
    monkeypatch.setattr(segment_module, "RANGE_ROWS", 16)
    ids, vals = _lanes(3, 48, 7, 1, n)
    counts = torch.tensor([n, 48 - n, 17], dtype=torch.int32)
    got = segment_reduce_lanes(ids, vals, 7, counts)
    for b, m in enumerate(counts.tolist()):
        assert torch.equal(got[b], segment_reduce(ids[b][:m], vals[b][:m],
                                                  7)), b


def test_lanes_take_a_count_a_lane():
    ids, vals = _lanes(3, 8, 3, 1, 0)
    for bad in (torch.tensor([4, 4], dtype=torch.int32),
                torch.tensor([4, 4, 4]), 4,
                torch.tensor([[4, 4, 4]], dtype=torch.int32)):
        with pytest.raises(ValueError, match="counts must be a"):
            segment_reduce_lanes(ids, vals, 3, bad)
    with pytest.raises(ValueError, match="unsupported op"):
        segment_reduce_lanes(ids, vals, 3, torch.zeros(3, dtype=torch.int32),
                             op="*")
    assert ops.COUNTED["segment_reduce[lanes]"] is segment_module.\
        lanes_launches


def _flush_requests(name, rows, r):
    """Requests of `name` whose bags are `rows` long (a served flush)."""
    reqs = []
    for m in rows:
        if name == "group_by":
            reqs.append(dict(S=(r.integers(0, 10, m).astype(np.float32),
                                r.standard_normal(m).astype(np.float32)),
                             C=np.zeros(10, np.float32)))
        elif name == "pagerank":
            nv = 12
            reqs.append(dict(E=(r.integers(0, nv, m).astype(np.float32),
                                r.integers(0, nv, m).astype(np.float32)),
                             P=np.full(nv, 1.0 / nv, np.float32),
                             NP=np.zeros(nv, np.float32),
                             C=np.zeros(nv, np.float32), N=nv,
                             num_steps=3.0, steps=0.0, b=0.85))
        else:
            reqs.append(dict(
                P=(r.standard_normal(m).astype(np.float32),
                   r.standard_normal(m).astype(np.float32)),
                CX=r.standard_normal(4).astype(np.float32),
                CY=r.standard_normal(4).astype(np.float32), K=4,
                D=np.zeros((m, 4), np.float32),
                MinD=np.full(m, 1e30, np.float32),
                Cl=np.zeros(m, np.float32),
                **{k: np.zeros(4, np.float32)
                   for k in ("SX", "SY", "CN", "NX", "NY")}))
    return reqs


@pytest.mark.parametrize("name", ["group_by", "pagerank", "kmeans_step"])
def test_a_cpu_flush_makes_one_lanes_call_a_group_by(monkeypatch, name):
    # the batched walk runs node by node across the lanes: each group-by a
    # region runs is one lanes call of the flush's B lanes (each its own
    # rows), where a solo run makes one segment call; the group-bys of one
    # fused node (kmeans_step's sums) share their call; the lanes equal
    # their solo runs
    from conftest import FakeClock
    from repro_torch.core import compile_program
    from repro_torch.core.programs import ALL
    from repro_torch.serve import PlanServer
    solo_calls, lane_calls = [], []
    real, real_lanes = ops.segment_reduce, ops.segment_reduce_lanes

    def spy(ids, vals, num, *, op="+", init=None, n_rows=None):
        solo_calls.append(ids.shape[0])
        return real(ids, vals, num, op=op, init=init, n_rows=n_rows)

    def spy_lanes(ids, vals, num, counts, *, op="+"):
        lane_calls.append(counts.tolist())
        return real_lanes(ids, vals, num, counts, op=op)
    monkeypatch.setattr(ops, "segment_reduce", spy)
    monkeypatch.setattr(ops, "segment_reduce_lanes", spy_lanes)
    rows = (40, 34, 61)     # one bucket of 64 rows
    reqs = _flush_requests(name, rows, np.random.default_rng(1))
    cp = compile_program(ALL[name], op_select="force:pallas", device="cpu")
    srv = PlanServer({name: cp}, max_batch=len(rows), clock=FakeClock())
    ts = [srv.submit(name, q) for q in reqs]
    assert srv.pump() == len(rows)
    assert solo_calls == [] and lane_calls
    solo = compile_program(ALL[name], op_select="force:pallas", device="cpu")
    solo.run(reqs[0])
    # each call: the flush's lanes of its node's m group-bys, lane by lane
    assert all(c == [n for n in rows for _ in range(len(c) // len(rows))]
               for c in lane_calls), lane_calls
    assert sum(map(len, lane_calls)) == len(rows) * len(solo_calls)
    fused = name == "kmeans_step"
    assert (len(lane_calls) < len(solo_calls)) if fused \
        else lane_calls == [list(rows)] * len(solo_calls)
    for q, t in zip(reqs, ts):
        for k, v in solo.run(q).items():
            assert np.array_equal(t.output[k], v.numpy()), k


def test_lanes_read_the_batch_counts_in_place():
    # a batch's lanes' counts are the elements of its own [B] counts: the
    # lanes call reads that tensor (no copy in the graph); other counts
    # (a product with range extents, none) are stacked, none counting all
    # of the lane's rows
    from repro_torch.core.lower import _Held, _lane_counts
    batch = torch.tensor([0, 5, 7, 3, 9], dtype=torch.int32)
    ids = torch.zeros(12, dtype=torch.int32)

    def held(rows):
        return _Held(ids, ids, 4, "+", rows, None)
    got = _lane_counts([held(batch[b]) for b in range(1, 4)])
    assert got.data_ptr() == batch[1].data_ptr() and got.tolist() == [5, 7, 3]
    got = _lane_counts([held(batch[1] * 2), held(None), held(batch[4])])
    assert got.tolist() == [10, 12, 9] and got.dtype == torch.int32
    got = _lane_counts([held(batch[3]), held(batch[1])])    # not in order
    assert got.tolist() == [3, 5] and got.data_ptr() != batch[3].data_ptr()


# ---------------------------------------------------------------------------
# on the card: the device-count entry of the kernel
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["+", "min", "max"])
@pytest.mark.parametrize("N,k,d", [(100_000, 64, 1), (100_000, 300, 4),
                                   (300_000, 70_000, 1),
                                   (200_000, 5_000, 3)])
def test_cuda_counted_launch_is_bit_equal_to_the_first_rows(cuda, op, N, k,
                                                            d):
    ids, vals = (t.to(cuda) for t in _case(N, k, d, N + k))
    for n in (0, 1, 20_000, 49_999, 75_000, N):
        before = segment_reduce.launches
        got = segment_reduce(ids, vals, k, op=op, n_rows=_n(n, cuda))
        assert segment_reduce.launches == before + 1
        want = segment_reduce(ids[:n], vals[:n], k, op=op)
        assert torch.equal(got, want), n


@pytest.mark.cuda
def test_cuda_counted_launch_int_values_and_int64_ids(cuda):
    ids, vals = (t.to(cuda) for t in _case(120_000, 4_000, 1, 3, np.int32))
    ids64 = ids.to(torch.int64)
    for n in (5, 64_000):
        want = segment_reduce(ids[:n], vals[:n], 4_000)
        assert torch.equal(segment_reduce(ids, vals, 4_000,
                                          n_rows=_n(n, cuda)), want)
        assert torch.equal(segment_reduce(ids64, vals, 4_000,
                                          n_rows=_n(n, cuda)), want)


@pytest.mark.cuda
def test_cuda_counted_launch_broadcast_values(cuda):
    ids, _ = _case(200_000, 100_000, 1, 4)
    ids = ids.to(cuda)
    ones = torch.ones((), device=cuda).expand(200_000)
    for n in (7, 150_000):
        got = segment_reduce(ids, ones, 100_000, n_rows=_n(n, cuda))
        assert torch.equal(got, segment_reduce(ids[:n], ones[:n], 100_000))


@pytest.mark.cuda
def test_cuda_counts_of_a_batch_in_one_graph(cuda):
    # a [B] counts tensor, each lane's launch reading its own element,
    # captured once and replayed after the counts change: every replay has
    # the bits of launches over each lane's own rows
    B, N, k = 3, 80_000, 3_000
    ids, vals = (t.to(cuda) for t in _case(B * N, k, 1, 9))
    ids, vals = ids.view(B, N), vals.view(B, N)
    counts = torch.zeros(B, dtype=torch.int32, device=cuda)
    outs = [None] * B
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # the warm-up builds the kernel
        for b in range(B):
            segment_reduce(ids[b], vals[b], k, n_rows=counts[b])
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for b in range(B):
            outs[b] = segment_reduce(ids[b], vals[b], k, n_rows=counts[b])
    for lens in ((N, 1, 40_000), (0, N - 1, 17)):
        counts.copy_(torch.tensor(lens, dtype=torch.int32))
        g.replay()
        torch.cuda.synchronize()
        for b, n in enumerate(lens):
            assert torch.equal(outs[b],
                               segment_reduce(ids[b, :n], vals[b, :n], k))


@pytest.mark.cuda
def test_cuda_counted_launch_over_ranges(cuda, monkeypatch):
    monkeypatch.setattr(segment_module, "RANGE_ROWS", 2 ** 16)
    ids, vals = (t.to(cuda) for t in _case(3 * 2 ** 16, 50_000, 1, 5))
    for n in (0, 2 ** 16, 2 ** 16 + 5, 3 * 2 ** 16 - 1):
        got = segment_reduce(ids, vals, 50_000, n_rows=_n(n, cuda))
        assert torch.equal(got, segment_reduce(ids[:n], vals[:n], 50_000))


@pytest.mark.parametrize("name,rows", [("group_by", (40, 34)),
                                       ("kmeans_step", (20, 17))])
def test_a_served_lane_hands_the_kernel_its_own_rows(monkeypatch, name,
                                                     rows):
    # the segment wrapper reduces each lane's own rows, not its batch's
    # padded ones: on the CPU the executor cuts the rows (the count is
    # known on the host), on the card it hands the wrapper all of them
    # with the lane's count (an element of the batch's [B] counts); the
    # lanes of a group-by go to one lanes call; and the lanes equal their
    # solo runs
    from conftest import FakeClock
    from repro_torch.core import compile_program
    from repro_torch.core.programs import ALL
    from repro_torch.serve import PlanServer
    seen = []
    real = ops.segment_reduce_lanes

    def spy(ids, vals, num, counts, *, op="+"):
        assert [i.shape[0] for i in ids] == counts.tolist()
        seen.append(counts.tolist())
        return real(ids, vals, num, counts, op=op)
    monkeypatch.setattr(ops, "segment_reduce_lanes", spy)
    cp = compile_program(ALL[name], op_select="force:pallas", device="cpu")
    srv = PlanServer({name: cp}, max_batch=2, clock=FakeClock())
    r = np.random.default_rng(0)
    reqs = []
    for m in rows:
        if name == "group_by":
            reqs.append(dict(S=(r.integers(0, 10, m).astype(np.float32),
                                r.standard_normal(m).astype(np.float32)),
                             C=np.zeros(10, np.float32)))
        else:
            reqs.append(dict(
                P=(r.standard_normal(m).astype(np.float32),
                   r.standard_normal(m).astype(np.float32)),
                CX=r.standard_normal(4).astype(np.float32),
                CY=r.standard_normal(4).astype(np.float32), K=4,
                D=np.zeros((m, 4), np.float32),
                MinD=np.full(m, 1e30, np.float32),
                Cl=np.zeros(m, np.float32),
                **{k: np.zeros(4, np.float32)
                   for k in ("SX", "SY", "CN", "NX", "NY")}))
    ts = [srv.submit(name, q) for q in reqs]
    assert srv.pump() == 2
    # lane by lane within a call: kmeans_step's fused sums share one
    assert seen and all(c == [n for n in rows for _ in range(len(c) // 2)]
                        for c in seen), seen
    solo = compile_program(ALL[name], op_select="force:pallas", device="cpu")
    for q, t in zip(reqs, ts):
        for k, v in solo.run(q).items():
            assert np.array_equal(t.output[k], v.numpy()), k


# ---------------------------------------------------------------------------
# on the card: the lanes entry of the kernel
# ---------------------------------------------------------------------------

def _cuda_lanes(cuda, B, N, k, d, seed, dtype=np.float32, id_dtype=np.int32):
    ids, vals = _lanes(B, N, k, d, seed, dtype, id_dtype)
    return [i.to(cuda) for i in ids], [v.to(cuda) for v in vals]


def _each_lane_own(ids, vals, k, counts, op="+"):
    """Each lane's own device-count launch."""
    return [segment_reduce(i, v, k, op=op, n_rows=counts[b])
            for b, (i, v) in enumerate(zip(ids, vals))]


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["+", "min", "max"])
@pytest.mark.parametrize("N,k,d", [(100_000, 64, 1), (100_000, 300, 4),
                                   (300_000, 70_000, 1),
                                   (200_000, 5_000, 3)])
def test_cuda_lanes_are_bit_equal_to_a_counted_launch_a_lane(cuda, op, N,
                                                             k, d):
    # the small path (K·D ≤ 2048 cells) and the bucketed one, staged
    # (d = 1) and not; counts none, one, some, all
    lens = (0, 1, N // 3, N - 1, N, 77_777)
    ids, vals = _cuda_lanes(cuda, len(lens), N, k, d, N + k)
    counts = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = ops.launch_counts()
    got = segment_reduce_lanes(ids, vals, k, counts, op=op)
    after = ops.launch_counts()
    assert after["segment_reduce[lanes]"] == before["segment_reduce[lanes]"] \
        + 1 and after["segment_reduce[rows]"] == before["segment_reduce[rows]"]
    for b, own in enumerate(_each_lane_own(ids, vals, k, counts, op)):
        assert torch.equal(got[b], own), b
        n = lens[b]
        assert torch.equal(own, segment_reduce(ids[b][:n], vals[b][:n], k,
                                               op=op)), b


@pytest.mark.cuda
def test_cuda_lanes_int_values_int64_ids_and_broadcast_rows(cuda):
    lens = (5, 64_000, 0)
    counts = torch.tensor(lens, dtype=torch.int32, device=cuda)
    ids, vals = _cuda_lanes(cuda, 3, 120_000, 4_000, 1, 3, np.int32,
                            np.int64)
    got = segment_reduce_lanes(ids, vals, 4_000, counts)
    for b, own in enumerate(_each_lane_own(ids, vals, 4_000, counts)):
        assert torch.equal(got[b], own), b
    ones = [torch.ones((), device=cuda).expand(120_000)] * 3
    got = segment_reduce_lanes(ids, ones, 4_000, counts)
    for b, own in enumerate(_each_lane_own(ids, ones, 4_000, counts)):
        assert torch.equal(got[b], own), b


@pytest.mark.cuda
def test_cuda_lanes_past_one_launch(cuda):
    # more lanes than one launch takes (32): a launch a pass each 32
    B, N, k = 40, 5_000, 2_500
    ids, vals = _cuda_lanes(cuda, B, N, k, 1, 8)
    counts = torch.tensor([(b * 997) % (N + 1) for b in range(B)],
                          dtype=torch.int32, device=cuda)
    before = segment_module.lanes_launches.launches
    got = segment_reduce_lanes(ids, vals, k, counts)
    assert segment_module.lanes_launches.launches == before + 2
    for b, own in enumerate(_each_lane_own(ids, vals, k, counts)):
        assert torch.equal(got[b], own), b


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 3_000])
def test_cuda_lanes_in_one_graph(cuda, k):
    # one lanes call captured once and replayed after the counts change:
    # every replay gives each lane the bits of a launch over its own rows
    B, N = 4, 80_000
    ids, vals = _cuda_lanes(cuda, B, N, k, 1, 9)
    counts = torch.zeros(B, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # the warm-up builds the kernel
        segment_reduce_lanes(ids, vals, k, counts)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with ops.captured() as took, torch.cuda.graph(g):
        out = segment_reduce_lanes(ids, vals, k, counts)
    assert took == {"segment_reduce": 1, "segment_reduce[lanes]": 1}
    for lens in ((N, 1, 40_000, 0), (0, N - 1, 17, N)):
        counts.copy_(torch.tensor(lens, dtype=torch.int32))
        g.replay()
        torch.cuda.synchronize()
        for b, n in enumerate(lens):
            assert torch.equal(out[b], segment_reduce(ids[b][:n],
                                                      vals[b][:n], k)), b


@pytest.mark.cuda
def test_cuda_lanes_over_ranges(cuda, monkeypatch):
    monkeypatch.setattr(segment_module, "RANGE_ROWS", 2 ** 16)
    N = 3 * 2 ** 16
    lens = (0, 2 ** 16, 2 ** 16 + 5, N - 1)
    ids, vals = _cuda_lanes(cuda, len(lens), N, 50_000, 1, 5)
    counts = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = segment_module.lanes_launches.launches
    got = segment_reduce_lanes(ids, vals, 50_000, counts)
    assert segment_module.lanes_launches.launches == before + 3
    for b, n in enumerate(lens):
        assert torch.equal(got[b], segment_reduce(ids[b][:n], vals[b][:n],
                                                  50_000)), b


@pytest.mark.cuda
def test_cuda_lanes_refuse_unlike_lanes(cuda):
    ids, vals = _cuda_lanes(cuda, 2, 1_000, 50, 1, 2)
    counts = torch.tensor([10, 20], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="share"):
        segment_reduce_lanes([ids[0], ids[1][:500]],
                             [vals[0], vals[1][:500]], 50, counts)
    with pytest.raises(ValueError, match="share"):
        segment_reduce_lanes(ids, [vals[0], vals[1].cpu()], 50, counts)
