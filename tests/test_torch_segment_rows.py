"""The segment kernel's device-count entry (`segment_reduce(..., n_rows=)`):
a launch over N rows that reduces the first n of them, the count read on
the device, with the bits of a launch over those n rows alone.  A served
lane padded to its batch's rows reduces its group-bys through it.

On the CPU the wrapper runs the plain version over [:n]; the tests here
hold that route to a launch over [:n], with ranges of RANGE_ROWS rows
shrunk so that a count inside, at and past a range's edge is reached, and
check that the count is a 0-d int32 tensor on the values' device.  Tests marked `cuda` hold the kernel
itself, bit for bit, against a launch over [:n] on the small and the
partitioned paths (n < N, n = 0, n = N, the count in a [B] tensor), inside
a CUDA graph replayed with other counts, and over ranges; they skip here
and need no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_segment_rows.py
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import segment_reduce
from repro_torch.kernels.segment_reduce import segment_reduce_plain

segment_module = importlib.import_module("repro_torch.kernels.segment_reduce")


def _n(n, device="cpu"):
    return torch.tensor(n, dtype=torch.int32, device=device)


def _case(n, k, d, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    ids = torch.from_numpy(r.integers(-2, k + 2, n).astype(np.int32))
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
    # with the lane's count (a 0-d int32 view of the batch's counts); and
    # the lanes equal their solo runs
    from conftest import FakeClock
    from repro_torch.core import compile_program
    from repro_torch.core.programs import ALL
    from repro_torch.kernels import ops
    from repro_torch.serve import PlanServer
    seen = []
    real = ops.segment_reduce

    def spy(ids, vals, num, *, op="+", init=None, n_rows=None):
        seen.append(ids.shape[0] if n_rows is None else int(n_rows))
        return real(ids, vals, num, op=op, init=init, n_rows=n_rows)
    monkeypatch.setattr(ops, "segment_reduce", spy)
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
    per_lane = len(seen) // 2
    assert seen == [rows[0]] * per_lane + [rows[1]] * per_lane
    solo = compile_program(ALL[name], op_select="force:pallas", device="cpu")
    for q, t in zip(reqs, ts):
        for k, v in solo.run(q).items():
            assert np.array_equal(t.output[k], v.numpy()), k
