"""Round fusion in the PyTorch port (pass 11, DESIGN.md §9): the plan
groups adjacent rounds into FusedRound regions exactly as the reference's
does, and the distributed executor runs a region as ONE dispatch sequence
with its collectives between the members — a SeqLoop whose whole body is a
region under a host-driven loop, one flag read an iteration (the port's
deliberate divergence from the reference's on-device while_loop), a loop
whose body is all replicated through the single-device executor.  Every
form equals single-device run() on an 8-rank gloo group: fused rounds, the
per-member fallback after a failed region, REP-everything and
round_fusion=False.
"""
import numpy as np
import pytest

from repro_torch.core import (compile_program, dim, loop_program, matrix,
                              scalar, vector)
from repro_torch.core import faults as F
from repro_torch.core.plan import FusedRound, SeqLoop, flatten
from repro_torch.core.programs import ALL
from repro_torch.launch.ranks import RankGroup


@pytest.fixture(scope="module")
def g8():
    with RankGroup(8, device="cpu") as g:
        yield g


@loop_program
def power_iter(M: matrix, v: vector, w: vector, n: dim,
               steps: scalar, k: scalar):
    while steps < k:
        steps += 1.0
        for i in range(0, n):
            w[i] = 0.0
        for i in range(0, n):
            for j in range(0, n):
                w[i] += M[i, j] * v[j]
        for i in range(0, n):
            v[i] = w[i] / n


def _program(name):
    return power_iter if name == "power_iter" else ALL[name]


def rank_run(mesh, name, ins, kw=None, shard_dense=True, runs=1,
             specs=()):
    from repro_torch.core.distributed import compile_distributed
    dp = compile_distributed(_program(name), mesh, ("data",),
                             shard_dense=shard_dense, **(kw or {}))
    dp.faults.sleep = lambda s: None
    for _ in range(runs):
        with F.inject(*specs):
            out = dp.run(ins)
    return {"out": {k: v.cpu().numpy() for k, v in out.items()},
            "rounds": dp.explain_rounds(), "faults": dp.explain_faults(),
            "flags": dp.flag_reads}


def _single(name, ins, **kw):
    out = compile_program(_program(name), device="cpu", **kw).run(ins)
    return {k: v.numpy() for k, v in out.items()}


def _check(results, want, tol=1e-4):
    for k in want:
        a = np.asarray(results[0]["out"][k], np.float64)
        b = np.asarray(want[k], np.float64)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        assert np.max(np.abs(a - b) / (np.abs(b) + 1.0)) < tol, k
        for r in results[1:]:
            assert np.array_equal(r["out"][k], results[0]["out"][k]), k


def _pagerank(seed=5, N=13):
    rng = np.random.default_rng(seed)
    return dict(E=(rng.integers(0, N, 64).astype(np.float64),
                   rng.integers(0, N, 64).astype(np.float64)),
                P=np.full(N, 1 / N), NP=np.zeros(N), C=np.zeros(N),
                N=N, num_steps=3.0, steps=0.0, b=0.85)


def _kmeans(seed=5, npts=24):
    rng = np.random.default_rng(seed)
    return dict(P=(rng.standard_normal(npts) * 3,
                   rng.standard_normal(npts) * 3),
                CX=rng.standard_normal(4), CY=rng.standard_normal(4), K=4,
                D=np.zeros((npts, 4)), MinD=np.full(npts, 1e30),
                Cl=np.zeros(npts), SX=np.zeros(4), SY=np.zeros(4),
                CN=np.zeros(4), NX=np.zeros(4), NY=np.zeros(4))


# ---------------------------------------------------------------------------
# plan structure: the reference's grouping
# ---------------------------------------------------------------------------

def test_seq_loop_body_becomes_one_region():
    cp = compile_program(ALL["pagerank"], device="cpu")
    loop = next(n for n in cp.plan if isinstance(n, SeqLoop))
    assert len(loop.body) == 1 and isinstance(loop.body[0], FusedRound)
    assert len(loop.body[0].parts) == 4   # steps, NP:=0, NP⊕, P:=
    assert "FusedRound{4 members}" in cp.explain()


def test_top_level_adjacent_rounds_group():
    cp = compile_program(ALL["kmeans_step"], device="cpu")
    assert len(cp.plan) == 1 and isinstance(cp.plan[0], FusedRound)
    assert len(flatten(cp.plan)) == len(cp.plan[0].parts)


def test_round_fusion_off_keeps_plan_flat():
    cp = compile_program(ALL["pagerank"], round_fusion=False, device="cpu")
    assert not any(isinstance(n, FusedRound) for n in flatten(cp.plan))
    loop = next(n for n in cp.plan if isinstance(n, SeqLoop))
    assert not any(isinstance(n, FusedRound) for n in loop.body)


def test_single_member_blocks_not_wrapped():
    cp = compile_program(ALL["histogram"], device="cpu")
    assert not any(isinstance(n, FusedRound) for n in cp.plan)


@pytest.mark.parametrize("name", ["pagerank", "kmeans_step",
                                  "matrix_factorization_step"])
def test_grouping_equals_reference(name):
    from repro.core import compile_program as jcompile
    from repro.core.programs import ALL as JALL
    for fusion in (True, False):
        ours = compile_program(ALL[name], round_fusion=fusion, device="cpu")
        ref = jcompile(JALL[name], round_fusion=fusion)
        assert ours.explain().split("\nwhole-program:")[0] == \
            ref.explain().split("\nwhole-program:")[0]


@pytest.mark.parametrize("name", ["pagerank", "kmeans_step"])
def test_fusion_preserves_results_single_device(name):
    ins = _pagerank() if name == "pagerank" else _kmeans()
    a = _single(name, ins)
    b = _single(name, ins, round_fusion=False)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# distributed: the fused forms on 8 ranks
# ---------------------------------------------------------------------------

def test_fused_rounds_distributed(g8):
    """pagerank's loop is ONE fused dispatch sequence under a host-driven
    loop (4 flag reads for 3 steps), the collectives inside it, N = 13 not
    divisible by 8; a second run takes the region from the round cache;
    kmeans is one top-level region; REP-everything fails the fused-loop
    guard (stores not aligned) and round_fusion=False runs a round a
    node, both with the same results."""
    ins = _pagerank()
    single = _single("pagerank", ins)
    # no speculation: a backup copy of the loop would read its flags too
    res = g8.run(rank_run, "pagerank", ins, kw=dict(speculative=False),
                 runs=2)
    _check(res, single)
    text = res[0]["rounds"]
    assert "FusedRound{4 members}" in text, text
    assert "loop: host-driven loop over ONE fused round (one flag read " \
           "per iteration)" in text, text
    assert "round: fused round: 4 members, 1 dispatch sequence; " \
           "host-driven loop (one flag read per iteration)" in text, text
    assert "reduce(psum_scatter[cost])→NP" in text, text
    assert "all_gather: P" in text, text
    assert "round cache: 2 traced, 2 hits" in text, text
    assert res[0]["flags"] == 4               # 3 iterations + the exit

    km = _kmeans()
    res = g8.run(rank_run, "kmeans_step", km)
    _check(res, _single("kmeans_step", km))
    assert "fused round: 6 members, 1 dispatch sequence" in res[0]["rounds"]

    rep = g8.run(rank_run, "pagerank", ins, shard_dense=False)
    _check(rep, single)
    assert "host-driven (4 condition syncs)" in rep[0]["rounds"]
    assert "fused round" not in rep[0]["rounds"]

    off = g8.run(rank_run, "pagerank", ins, kw=dict(round_fusion=False))
    _check(off, single)
    assert "FusedRound" not in off[0]["rounds"]


def test_failed_region_falls_back_to_per_member_rounds(g8):
    """A fused region that fails (a classified deterministic fault at
    `dist.fused_compile`) descends to per-member rounds for the run:
    results unchanged, one `fused->per-member rounds` descent."""
    ins = _pagerank()
    spec = F.FaultSpec("dist.fused_compile", "deterministic", nth=1)
    res = g8.run(rank_run, "pagerank", ins, specs=(spec,))
    _check(res, _single("pagerank", ins))
    for r in res:
        assert "descend  [fused->per-member rounds]" in r["faults"]
        assert "host-driven (" in r["rounds"]


def test_replicated_body_loop_runs_through_single_device_executor(g8):
    rng = np.random.default_rng(9)
    n = 16
    ins = dict(M=rng.standard_normal((n, n)) * 0.1, v=np.full(n, 1.0 / n),
               w=np.zeros(n), n=n, steps=0.0, k=3.0)
    single = _single("power_iter", ins)
    res = g8.run(rank_run, "power_iter", ins)
    _check(res, single)
    assert "host-driven loop over ONE fused round" in res[0]["rounds"]
    rep = g8.run(rank_run, "power_iter", ins, shard_dense=False)
    _check(rep, single)
    text = rep[0]["rounds"]
    assert "single-device executor loop (replicated body, one flag read " \
           "per iteration)" in text, text
    assert "host-driven (" not in text, text
