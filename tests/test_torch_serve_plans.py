"""The PyTorch port's plan server (repro_torch.serve.PlanServer) against the
reference's (repro.serve.PlanServer): the ports of the 10 tests of
tests/test_serve_plans.py, on the CPU, with the same FakeClock and scripted
arrival schedules from conftest.

The contract is the reference's: a request served through a padded batch
returns results BIT-IDENTICAL to the port's own solo run() — for all three
mixed-workload programs, including ragged shapes that share a bucket
(padded) and ones that split buckets.  One more test runs the same
requests through the reference's server (JAX on the CPU) and holds the
port's outputs to them within tests/test_core_programs.py's tolerances,
and the `explain_serving()` golden is the reference's text, character for
character, for the same scripted schedule.

Tests marked `cuda` serve on the card (the batch captured into CUDA graphs,
each lane bit-equal to its solo run()); they skip here and need no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serve_plans.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import FakeClock, run_schedule

try:
    from repro.core import programs as jax_progs
    from repro.core.lower import compile_program as jax_compile
    from repro.serve import PlanServer as JaxPlanServer
    from test_core_programs import data_for
except ImportError:     # the card's machine: only the `cuda` tests run there
    pass
from repro_torch.core import compile_program
from repro_torch.core.programs import ALL
from repro_torch.kernels import ops
from repro_torch.serve import PlanServer

WORKLOADS = ("pagerank", "group_by", "kmeans_step")
RTOL, ATOL = 2e-3, 1e-4          # tests/test_core_programs.py's

_CPS = {}


def cps():
    """Module-shared compiled programs (compilation and batch entries are
    the expensive part; the server under test is cheap)."""
    if not _CPS:
        for name in WORKLOADS:
            _CPS[name] = compile_program(ALL[name], device="cpu")
    return _CPS


def ragged(name, scale, seed):
    """data_for() with a rescaled bag — ragged client traffic (the
    reference test's own inputs)."""
    rng = np.random.default_rng(seed)
    d = data_for(name)
    if name == "pagerank":
        N, m = int(d["N"]), max(4, int(len(d["E"][0]) * scale))
        d["E"] = (rng.integers(0, N, m).astype(np.float64),
                  rng.integers(0, N, m).astype(np.float64))
    elif name == "group_by":
        m = max(4, int(len(d["S"][0]) * scale))
        d["S"] = (rng.integers(0, 10, m).astype(np.float64),
                  rng.standard_normal(m))
    elif name == "kmeans_step":
        m = max(8, int(len(d["P"][0]) * scale))
        d["P"] = (rng.standard_normal(m) * 3, rng.standard_normal(m) * 3)
        d["D"] = np.zeros((m, d["K"]))
        d["MinD"] = np.full(m, 1e30)
        d["Cl"] = np.zeros(m)
    return d


# scales whose bag lengths round up to ONE shared power-of-two bucket
# (base lengths: pagerank E=30 → 32, group_by S=40 → 64, kmeans P=20 → 32)
SHARED_BUCKET_SCALES = {
    "pagerank": (1.0, 0.9, 0.8, 0.6),        # 30, 27, 24, 18 rows
    "group_by": (1.0, 0.95, 0.9, 0.85),      # 40, 38, 36, 34 rows
    "kmeans_step": (1.0, 0.95, 0.9, 0.85),   # 20, 19, 18, 17 rows
}


def deep_copy(ins):
    return {k: (tuple(np.copy(c) for c in v) if isinstance(v, tuple)
                else np.copy(v) if isinstance(v, np.ndarray) else v)
            for k, v in ins.items()}


def assert_bit_identical(name, ins, out):
    """Serving-path output must equal a solo run() bitwise."""
    ref = cps()[name].run(deep_copy(ins))
    for k, rv in ref.items():
        np.testing.assert_array_equal(out[k], rv.numpy(),
                                      err_msg=f"{name}:{k}")


def make_server(clock, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("flush_ms", 2.0)
    kw.setdefault("bucket_floor", 8)
    return PlanServer(cps(), clock=clock, **kw)


# ---------------------------------------------------------------------------
# batched == sequential, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", WORKLOADS)
def test_batched_matches_sequential(name, fake_clock):
    srv = make_server(fake_clock)
    reqs = [ragged(name, 1.0, seed) for seed in (0, 1, 2, 3)]
    reqs = [(ins, srv.submit(name, ins)) for ins in reqs]
    assert srv.pump() == 4          # full bucket flushes with no timeout
    for ins, t in reqs:
        assert t.state == "done"
        assert_bit_identical(name, ins, t.output)
    s = srv.stats()
    assert s["flushes"] == 1 and s["batch_traced"] == 1
    assert s["seq_fallbacks"] == 0


@pytest.mark.parametrize("name", WORKLOADS)
def test_ragged_requests_pad_into_shared_bucket(name, fake_clock):
    """Different bag lengths under one bucket edge: padded lanes must not
    perturb results (the §3.4 limit masks and the lane's own row count),
    outputs slice back to each request's own shapes."""
    srv = make_server(fake_clock)
    reqs = [(ins := ragged(name, sc, seed), srv.submit(name, ins))
            for seed, sc in enumerate(SHARED_BUCKET_SCALES[name])]
    assert len(srv.stats()["buckets"]) == 1     # one shared shape bucket
    assert srv.pump() == 4
    for ins, t in reqs:
        assert_bit_identical(name, ins, t.output)
    (row,) = srv.stats()["buckets"].values()
    assert row["pad"] > 0           # padding actually happened


def test_ragged_shapes_land_in_different_buckets(fake_clock):
    """Lengths on opposite sides of a power-of-two edge split buckets —
    and both still serve bit-identically."""
    srv = make_server(fake_clock, max_batch=2)
    small = ragged("group_by", 0.2, 0)      # 8 rows  → bucket 8 (floor)
    large = ragged("group_by", 2.0, 1)      # 80 rows → bucket 128
    ts = srv.submit("group_by", small)
    tl = srv.submit("group_by", large)
    assert len(srv.stats()["buckets"]) == 2
    assert srv.drain() == 2
    assert_bit_identical("group_by", small, ts.output)
    assert_bit_identical("group_by", large, tl.output)


def test_lanes_leave_a_loop_at_their_own_iteration(fake_clock):
    """A batch's loop runs while any lane's condition holds; a lane whose
    condition turned false keeps its carry bit for bit (pagerank lanes of
    0 to 5 steps in one batch, each equal to its solo run())."""
    srv = make_server(fake_clock)
    reqs = []
    for seed, steps in enumerate((0.0, 1.0, 3.0, 5.0)):
        ins = ragged("pagerank", 1.0, seed)
        ins["num_steps"] = steps
        reqs.append((ins, srv.submit("pagerank", ins)))
    assert srv.pump() == 4
    assert srv.stats()["flushes"] == 1
    for ins, t in reqs:
        assert_bit_identical("pagerank", ins, t.output)
    (entry, _), = [v for k, v in cps()["pagerank"]._whole_cache.items()
                   if k[0] == "batched"][-1:]
    assert entry.syncs == 6            # one flag read an iteration, + 1


# ---------------------------------------------------------------------------
# scheduling: full-bucket flush, straggler timeout, scripted arrivals
# ---------------------------------------------------------------------------

def test_straggler_timeout_flush(fake_clock):
    """A single request never fills its bucket; the flush_ms timeout must
    flush it — at exactly the scripted tick, not before."""
    srv = make_server(fake_clock, flush_ms=2.0)
    ins = ragged("group_by", 1.0, 0)
    t = srv.submit("group_by", ins)
    assert srv.pump() == 0                  # t=0: not full, not timed out
    fake_clock.advance(0.0015)
    assert srv.pump() == 0                  # 1.5ms < 2ms: still waiting
    fake_clock.advance(0.0006)
    assert srv.pump() == 1                  # 2.1ms: timeout flush fires
    assert t.state == "done"
    assert_bit_identical("group_by", ins, t.output)
    (row,) = srv.stats()["buckets"].values()
    assert row["reqs"] == 1 and row["flushes"] == 1


def test_scripted_arrivals_mixed_programs(fake_clock):
    """Interleaved arrivals across all three programs on one scripted
    timeline: full buckets flush at arrival, stragglers at timeout."""
    srv = make_server(fake_clock, max_batch=2, flush_ms=2.0)
    tickets = []

    def sub(name, seed):
        ins = ragged(name, 1.0, seed)
        tickets.append((name, ins, srv.submit(name, ins)))

    events = [
        (0.0000, lambda: sub("pagerank", 0)),
        (0.0002, lambda: sub("group_by", 1)),
        (0.0004, lambda: sub("pagerank", 2)),   # fills pagerank bucket
        (0.0006, lambda: sub("kmeans_step", 3)),
        (0.0031, lambda: None),                 # group_by+kmeans time out
    ]
    done = run_schedule(fake_clock, events, srv.pump)
    assert done == 4
    for name, ins, t in tickets:
        assert t.state == "done"
        assert_bit_identical(name, ins, t.output)
    s = srv.stats()
    assert s["admitted"] == s["completed"] == 4 and s["queued"] == 0


def test_second_flush_hits_batch_cache(fake_clock):
    """Same bucket, same lane count → the second flush reuses the batch
    entry (no new entry)."""
    srv = make_server(fake_clock, max_batch=2)
    for seed in (0, 1):
        srv.submit("group_by", ragged("group_by", 1.0, seed))
    assert srv.pump() == 2
    for seed in (2, 3):
        srv.submit("group_by", ragged("group_by", 1.0, seed))
    assert srv.pump() == 2
    s = srv.stats()
    assert s["batch_traced"] == 1 and s["batch_hits"] == 1


def test_cancel_before_flush(fake_clock):
    srv = make_server(fake_clock)
    keep = srv.submit("group_by", ragged("group_by", 1.0, 0))
    gone = srv.submit("group_by", ragged("group_by", 1.0, 1))
    assert srv.cancel(gone)
    assert gone.state == "cancelled"
    with pytest.raises(RuntimeError, match="cancelled"):
        gone.result(0)
    assert srv.drain() == 1
    assert keep.state == "done"
    assert not srv.cancel(keep)             # too late: already served
    s = srv.stats()
    assert s["admitted"] == s["completed"] + s["cancelled"] + s["queued"]


# ---------------------------------------------------------------------------
# golden: the observability surface is the reference's
# ---------------------------------------------------------------------------

def _golden_schedule(server_cls, compile_fn, programs, clock):
    fresh = {n: compile_fn(programs[n]) for n in WORKLOADS}
    srv = server_cls(fresh, clock=clock, max_batch=2, flush_ms=2.0,
                     bucket_floor=8)
    for seed, sc in ((0, 1.0), (1, 0.9)):
        srv.submit("group_by", ragged("group_by", sc, seed))
    assert srv.pump() == 2                  # full bucket at t=0
    srv.submit("kmeans_step", ragged("kmeans_step", 1.0, 2))
    clock.advance(0.004)
    assert srv.pump() == 1                  # straggler timeout at t=4ms
    return srv.explain_serving()


def test_explain_serving_golden():
    """Under a fake clock every number in explain_serving() is exact;
    freshly compiled programs pin the traced/hit counts.  The text is the
    reference server's for the same schedule, character for character."""
    text = _golden_schedule(
        PlanServer, lambda p: compile_program(p, device="cpu"), ALL,
        FakeClock())
    assert text.splitlines()[0] == (
        "== serving plans: 3 programs, max_batch=2, flush=2.0ms, "
        "bucket_floor=8 ==")
    assert "bucket group_by{S:64}#" in text
    assert "depth=0 reqs=2 flushes=1 occ=100% pad=" in text
    assert "bucket kmeans_step{P:32 Cl:32 D:32 MinD:32 K=4}#" in text
    assert ("totals: admitted=3 completed=3 cancelled=0 failed=0 queued=0"
            in text)
    assert "latency: p50=0.0ms p99=4.0ms  throughput=750.0 req/s" in text
    assert ("whole-program cache: 2 batch signatures traced, 0 hits, "
            "0 sequential fallbacks") in text
    ref = _golden_schedule(JaxPlanServer, jax_compile,
                           {n: getattr(jax_progs, n) for n in WORKLOADS},
                           FakeClock())
    assert text == ref


# ---------------------------------------------------------------------------
# batchable-entry hooks (core/lower.py, core/plan.py)
# ---------------------------------------------------------------------------

def test_entry_signature_matches_device_signature():
    """Host-side bucketing key == the device-side compile-cache key, and
    == the reference's host-side key."""
    for name in WORKLOADS:
        cp = cps()[name]
        ins = ragged(name, 1.0, 0)
        host = cp.entry_signature(cp.canonical_inputs(ins))
        dev = cp._signature(cp.prepare_env(deep_copy(ins)))
        assert host == dev, name
        ref = jax_compile(getattr(jax_progs, name))
        assert host == ref.entry_signature(ref.canonical_inputs(ins)), name


def test_bag_row_aligned_analysis():
    """kmeans' per-point scratch arrays ride the bag's row count; the
    dim-N state of pagerank and group_by's keyed map do not — as the
    reference finds."""
    assert cps()["kmeans_step"].bag_row_aligned == {
        "D": "P", "MinD": "P", "Cl": "P"}
    assert cps()["pagerank"].bag_row_aligned == {}
    assert cps()["group_by"].bag_row_aligned == {}
    for name in WORKLOADS:
        ref = jax_compile(getattr(jax_progs, name))
        assert cps()[name].bag_row_aligned == ref.bag_row_aligned


# ---------------------------------------------------------------------------
# against the reference's server
# ---------------------------------------------------------------------------

def test_served_outputs_equal_the_reference_servers():
    """The same ragged requests, one scripted schedule, through both
    servers: every lane of the port's within the programs' tolerances of
    the reference's (float32 sums in another order)."""
    reqs = [(name, ragged(name, sc, seed))
            for name in WORKLOADS
            for seed, sc in enumerate(SHARED_BUCKET_SCALES[name])]
    outs = []
    for server_cls, comp in ((PlanServer,
                              lambda n: compile_program(ALL[n],
                                                        device="cpu")),
                             (JaxPlanServer,
                              lambda n: jax_compile(getattr(jax_progs, n)))):
        srv = server_cls({n: comp(n) for n in WORKLOADS}, clock=FakeClock(),
                         max_batch=4, bucket_floor=8)
        ts = [srv.submit(n, deep_copy(ins)) for n, ins in reqs]
        assert srv.drain() == len(reqs)
        outs.append([t.output for t in ts])
    for (name, _), ours, ref in zip(reqs, *outs):
        assert set(ours) == set(ref)
        for k in ref:
            np.testing.assert_allclose(
                np.asarray(ours[k], np.float64), np.asarray(ref[k],
                                                            np.float64),
                rtol=RTOL, atol=ATOL, err_msg=f"{name}:{k}")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU form")
    return torch.device("cuda")


def _card_request(name, n, seed):
    """A request on the card's data scale, its bag `n` rows long."""
    r = np.random.default_rng(seed)
    if name == "group_by":
        return dict(S=(r.integers(-3, 4099, n).astype(np.float32),
                       r.standard_normal(n).astype(np.float32)),
                    C=np.zeros(4096, np.float32))
    if name == "pagerank":
        nv = 4096
        return dict(E=(r.integers(0, nv, n).astype(np.float32),
                       r.integers(0, nv, n).astype(np.float32)),
                    P=np.full(nv, 1.0 / nv, np.float32),
                    NP=np.zeros(nv, np.float32), C=np.zeros(nv, np.float32),
                    N=nv, num_steps=4.0, steps=0.0, b=0.85)
    k = 16
    return dict(P=(r.standard_normal(n).astype(np.float32) * 3,
                   r.standard_normal(n).astype(np.float32) * 3),
                CX=r.standard_normal(k).astype(np.float32),
                CY=r.standard_normal(k).astype(np.float32), K=k,
                D=np.zeros((n, k), np.float32),
                MinD=np.full(n, 1e30, np.float32), Cl=np.zeros(n, np.float32),
                SX=np.zeros(k, np.float32), SY=np.zeros(k, np.float32),
                CN=np.zeros(k, np.float32), NX=np.zeros(k, np.float32),
                NY=np.zeros(k, np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", WORKLOADS)
def test_cuda_served_lanes_bit_equal_to_solo_runs(cuda, name):
    # ragged requests padded into one bucket, two flushes of one batch
    # entry (a capture, then a replay with other row counts), every lane
    # bit-equal to its request's solo whole run() on the card
    cp = compile_program(ALL[name], device=cuda)
    solo = compile_program(ALL[name], device=cuda)
    srv = PlanServer({name: cp}, max_batch=4, clock=FakeClock())
    reqs = [_card_request(name, n, i) for i, n in
            enumerate((30_000, 17_000, 32_768, 20_001,
                       25_000, 16_385, 31_000, 18_000))]
    if name == "pagerank":          # lanes leave the loop at their own step
        for i, r in enumerate(reqs):
            r["num_steps"] = float(i % 5)
    ops.reset_launch_counts()
    ts = [srv.submit(name, ins) for ins in reqs]
    assert srv.drain() == 8
    assert ops.launch_counts()["segment_reduce"] > 0
    s = srv.stats()
    assert s["flushes"] == 2 and s["batch_traced"] == 1 \
        and s["batch_hits"] == 1 and s["seq_fallbacks"] == 0
    for ins, t in zip(reqs, ts):
        ref = solo.run(ins)
        for k, v in ref.items():
            assert np.array_equal(t.output[k], v.cpu().numpy()), (name, k)


def test_batched_call_takes_stacked_numpy_as_the_reference_does():
    # the reference's contract: [B, ...]-stacked numpy values, [B] row
    # counts, the limit sets; each lane bit-equal to its solo run(), the
    # entry cached under the caller's key
    cp = compile_program(ALL["kmeans_step"], device="cpu")
    reqs = [cp.canonical_inputs(ragged("kmeans_step", sc, i))
            for i, sc in enumerate((1.0, 0.85))]
    L = 32
    arrays, lengths = {}, {}
    for name, t in cp.program.params.items():
        if t.kind == "dim":
            continue
        vals = [r[name] for r in reqs]
        if t.kind == "bag":
            arrays[name] = tuple(
                np.stack([np.pad(v[c], (0, L - len(v[c]))) for v in vals])
                for c in range(len(vals[0])))
            lengths[name] = np.array([len(v[0]) for v in vals], np.int32)
        elif name in cp.bag_row_aligned:
            arrays[name] = np.stack([np.pad(v, [(0, L - len(v))]
                                            + [(0, 0)] * (v.ndim - 1))
                                     for v in vals])
            lengths[name] = np.array([len(v) for v in vals], np.int32)
        else:
            arrays[name] = np.stack(vals)
    limit_arrays = tuple(sorted(cp.bag_row_aligned))
    for hit in (0, 1):
        out = cp.batched_call("k", {"K": 4}, arrays, lengths, ("P",),
                              limit_arrays)
        assert cp.trace_count == 1 and cp.cache_hits == hit
    for b, r in enumerate(reqs):
        ref = cps()["kmeans_step"].run(r)
        for k, v in ref.items():
            lane = out[k][b][tuple(slice(0, s) for s in v.shape)]
            np.testing.assert_array_equal(lane, v.numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# every program, hot keys, and where padding keeps the bits
# ---------------------------------------------------------------------------

def _stretched(name, m, seed):
    """data_for(name) with every bag (and bag-aligned array) stretched to
    `m` rows: the rows repeat, float values perturbed so that an order of
    summation that followed the padding would show in the bits."""
    r = np.random.default_rng(seed)
    d = data_for(name)
    cp = compile_program(ALL[name], device="cpu")
    params = ALL[name].program.params
    bags = [n for n, t in params.items() if t.kind == "bag"]

    def stretch(a):
        a = np.resize(a, (m,) + a.shape[1:])
        if np.all(a == np.round(a)):        # keys and counts stay whole
            return a
        return a * (1.0 + 1e-3 * r.standard_normal(a.shape))
    for b in bags:
        cols = d[b] if isinstance(d[b], tuple) else (d[b],)
        d[b] = tuple(stretch(c) for c in cols)
    for arr, bag in cp.bag_row_aligned.items():
        if bag in bags:
            d[arr] = np.resize(d[arr], (m,) + np.shape(d[arr])[1:])
    return d


@pytest.mark.parametrize("name", sorted(ALL))
def test_every_program_served_bit_identical_to_solo(name, fake_clock):
    # ragged requests that share one padded bucket (300, 290, 260 and 257
    # rows pad to 512): every lane bit-identical to its solo run()
    solo = compile_program(ALL[name], device="cpu")
    srv = PlanServer({name: compile_program(ALL[name], device="cpu")},
                     max_batch=4, clock=fake_clock)
    has_bag = any(t.kind == "bag"
                  for t in ALL[name].program.params.values())
    reqs = [_stretched(name, m, i) if has_bag else data_for(name)
            for i, m in enumerate((300, 290, 260, 257))]
    ts = [srv.submit(name, deep_copy(q)) for q in reqs]
    assert srv.pump() == 4
    s = srv.stats()
    assert s["flushes"] == 1 and s["seq_fallbacks"] == 0
    for q, t in zip(reqs, ts):
        assert t.state == "done"
        for k, v in solo.run(deep_copy(q)).items():
            np.testing.assert_array_equal(t.output[k], v.numpy(),
                                          err_msg=f"{name}:{k}")


def _hot_group_by(n, seed, hot=0.6):
    r = np.random.default_rng(seed)
    keys = r.integers(0, 64, n)
    keys[r.random(n) < hot] = 7
    return dict(S=(keys.astype(np.float32),
                   r.standard_normal(n).astype(np.float32)),
                C=np.zeros(64, np.float32))


def test_hot_key_requests_salt_as_their_solo_runs(fake_clock, monkeypatch):
    # a request whose solo run salts its hot key is served in a lane salted
    # alike (its own bucket), bit-identical to that run; a uniform request
    # of the same shape takes the unsalted bucket.  The CPU's cost table
    # prices no collisions, so it takes the card's here, where hot keys
    # salt
    from repro_torch.core import op_select
    monkeypatch.setitem(op_select._COSTS, "cpu", op_select._COSTS["cuda"])
    cp = compile_program(ALL["group_by"], device="cpu")
    solo = compile_program(ALL["group_by"], device="cpu")
    hot = [_hot_group_by(n, i) for i, n in enumerate((6000, 5000))]
    cold = _hot_group_by(6000, 9, hot=0.0)
    assert cp.request_salts(cp.canonical_inputs(hot[0]))
    assert not cp.request_salts(cp.canonical_inputs(cold))
    srv = PlanServer({"group_by": cp}, max_batch=4, clock=fake_clock)
    ts = [srv.submit("group_by", deep_copy(q)) for q in (*hot, cold)]
    assert srv.drain() == 3
    assert srv.stats()["flushes"] == 2
    for q, t in zip((*hot, cold), ts):
        want = solo.run(deep_copy(q))["C"].numpy()
        np.testing.assert_array_equal(t.output["C"], want)
    solo.run(deep_copy(hot[0]))
    assert "salt=16x[probe]" in solo.explain()


def test_which_programs_pad_on_the_card():
    # on the card a lane is padded only where its bits stay its solo
    # run's: group-bys through the segment kernel's device count, maps,
    # min and max; a float total or axis sum over a bag is not, and such a
    # program is bucketed at its requests' own shapes.  On the CPU the
    # executor cuts every lane's rows, so every program pads
    from repro_torch.core.lower import pads_exactly
    exact = {name: pads_exactly(compile_program(p, device="cpu").plan,
                                p.program, "cuda")
             for name, p in ALL.items()}
    assert {n for n, ok in exact.items() if not ok} == {
        "average", "count", "conditional_count", "conditional_sum",
        "equal", "linear_regression"}
    assert all(compile_program(p, device="cpu").pads_exactly
               for p in ALL.values())
    # a group-by forced off the segment kernel loses the device count
    forced = compile_program(ALL["group_by"], op_select="force:scatter",
                             device="cpu")
    assert not pads_exactly(forced.plan, forced.program, "cuda")


def test_unpadded_buckets_stack_requests_at_their_own_rows(fake_clock,
                                                           monkeypatch):
    # a program that does not pad keeps each bag at its own rows: requests
    # of one length share a bucket with no row counts, another length
    # takes another bucket, and every lane equals its solo run()
    cp = compile_program(ALL["average"], device="cpu")
    monkeypatch.setattr(type(cp), "pads_exactly", property(lambda s: False))
    solo = compile_program(ALL["average"], device="cpu")
    srv = PlanServer({"average": cp}, max_batch=4, clock=fake_clock)
    reqs = [_stretched("average", m, i)
            for i, m in enumerate((300, 300, 290))]
    ts = [srv.submit("average", deep_copy(q)) for q in reqs]
    assert srv.drain() == 3
    s = srv.stats()
    assert s["flushes"] == 2
    assert all(b["pad"] == 0.0 for b in s["buckets"].values())
    assert all(not b.limit_bags for b in srv._buckets.values())
    for q, t in zip(reqs, ts):
        for k, v in solo.run(deep_copy(q)).items():
            np.testing.assert_array_equal(t.output[k], v.numpy(), err_msg=k)
