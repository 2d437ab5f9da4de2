"""Distributed rounds of the PyTorch port (repro_torch.core.distributed)
on 4- and 8-rank gloo groups on the CPU: outputs equal the port's single-
device run() and the interpreter, placements are the reference's, the
round strategies and exchange decisions are the reference's goldens, and
where the reference's own distributed run still works on the CPU
(a subprocess with forced host devices) the port gives its outputs and
its round strategies on the same inputs.

One group of rank processes a module (`RankGroup`, spawned once and fed
every case): the ranks meet at a file store under a temporary directory,
every collective has a timeout and each call a deadline, so a hung
collective fails its test instead of the suite.  The case functions run
on the ranks and import no jax.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import (bag, compile_program, dim, interpret,
                              loop_program, matrix, scalar, vector)
from repro_torch.core.dist_analysis import Dist
from repro_torch.core.programs import ALL
from repro_torch.launch.ranks import RankGroup

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def g4():
    with RankGroup(4, device="cpu") as g:
        yield g


@pytest.fixture(scope="module")
def g8():
    with RankGroup(8, device="cpu") as g:
        yield g


# ---------------------------------------------------------------------------
# programs defined here (the frontend reads their source from this file)
# ---------------------------------------------------------------------------

@loop_program
def col_sums(B: bag[1], M: matrix, R: vector, m: dim):
    # a +-product of gathers contracting the BAG axis: an EinsumContract
    # whose rounds run the masked AxisReduce inside each rank
    for i, w in items(B):
        for j in range(0, m):
            R[j] += M[i, j]


@loop_program
def loop_reader(V: bag[1], A: vector, s: scalar, steps: scalar):
    # A is bag-derived (ONED_VAR) but re-read inside a loop: the planner
    # inserts a Rebalance round after its producer
    for i, v in items(V):
        A[i] = v * 2.0
    while steps < 3.0:
        steps += 1.0
        for i, v in items(V):
            s += A[i]


PROGRAMS = {"col_sums": col_sums, "loop_reader": loop_reader}


def _program(name):
    return PROGRAMS.get(name) or ALL[name]


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------

def _np(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def rank_run(mesh, name, ins, kw=None, shard_dense=True, runs=1):
    """compile_distributed(p, mesh).run(ins) on one rank: its outputs,
    explain_rounds() and placement facts."""
    from repro_torch.core.distributed import compile_distributed
    dp = compile_distributed(_program(name), mesh, ("data",),
                             shard_dense=shard_dense, **(kw or {}))
    for _ in range(runs):
        out = dp.run(ins)
    placed, bag_limits, array_limits = dp.place(ins)
    shapes = {k: ([tuple(c.shape) for c in v] if isinstance(v, tuple)
                  else tuple(getattr(v, "shape", ()))) for k, v in placed.items()}
    return {"out": _np(out), "rounds": dp.explain_rounds(),
            "bag_limits": bag_limits, "array_limits": array_limits,
            "shapes": shapes,
            "placements": {k: v.name for k, v in dp.placements.items()}}


# ---------------------------------------------------------------------------
# inputs (the reference suites' own sizes and seeds)
# ---------------------------------------------------------------------------

def _cases():
    rng = np.random.default_rng(7)
    nv = 16
    n, m, l = 10, 6, 5
    return {
        "word_count": dict(W=rng.integers(0, nv, 64).astype(np.float64),
                           C=np.zeros(nv)),
        "group_by": dict(S=(rng.integers(0, nv, 64).astype(np.float64),
                            rng.standard_normal(64)), C=np.zeros(nv)),
        "histogram": dict(P=tuple(rng.integers(0, nv, 64).astype(np.float64)
                                  for _ in range(3)),
                          R=np.zeros(nv), G=np.zeros(nv), B=np.zeros(nv)),
        "conditional_sum": dict(V=rng.standard_normal(64), s=0.0,
                                limit=0.3),
        "pagerank": dict(E=(rng.integers(0, 12, 64).astype(np.float64),
                            rng.integers(0, 12, 64).astype(np.float64)),
                         P=np.full(12, 1 / 12), NP=np.zeros(12),
                         C=np.zeros(12), N=12, num_steps=2.0, steps=0.0,
                         b=0.85),
        "matrix_multiplication": dict(M=rng.standard_normal((16, 8)),
                                      N=rng.standard_normal((8, 12)),
                                      R=np.zeros((16, 12)), n=16, m=12, l=8),
        "kmeans_step": dict(P=(rng.standard_normal(24) * 3,
                               rng.standard_normal(24) * 3),
                            CX=rng.standard_normal(4),
                            CY=rng.standard_normal(4), K=4,
                            D=np.zeros((24, 4)), MinD=np.full(24, 1e30),
                            Cl=np.zeros(24), SX=np.zeros(4), SY=np.zeros(4),
                            CN=np.zeros(4), NX=np.zeros(4), NY=np.zeros(4)),
        "matrix_factorization_step": dict(
            R=rng.standard_normal((n, m)),
            P=rng.standard_normal((n, l)) * 0.1,
            Q=rng.standard_normal((l, m)) * 0.1,
            Pp=rng.standard_normal((n, l)) * 0.1,
            Qp=rng.standard_normal((l, m)) * 0.1,
            pq=np.zeros((n, m)), err=np.zeros((n, m)),
            n=n, m=m, l=l, a=0.01, lam=0.1),
    }


CASES = _cases()


def _single(name, ins, **kw):
    return _np(compile_program(_program(name), device="cpu", **kw)
               .run(ins))


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1.0))) if a.size \
        else 0.0


def _check(results, want, tol=1e-4, what=""):
    """Every rank's outputs within `tol` of `want`, and the ranks equal."""
    for k in want:
        err = _rel(results[0]["out"][k], want[k])
        assert err < tol, (what, k, err)
        for r in results[1:]:
            assert np.array_equal(r["out"][k], results[0]["out"][k]), \
                (what, k, "ranks differ")


# ---------------------------------------------------------------------------
# outputs: 4 and 8 ranks against single-device run() and the interpreter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("world", [4, 8])
def test_distributed_equals_single_device(name, world, g4, g8):
    g = g4 if world == 4 else g8
    ins = CASES[name]
    res = g.run(rank_run, name, ins)
    _check(res, _single(name, ins), what=(name, world))
    oracle = interpret(_program(name).program, ins)
    _check(res, {k: oracle[k] for k in res[0]["out"]}, what=(name, "interp"))


def test_odd_length_bag_pads_and_shards(g8):
    """65 rows on 8 ranks: the bag shards as 9-row blocks (72 padded), the
    logical length travels as a bag limit, the results do not change."""
    rng = np.random.default_rng(11)
    nv, n = 16, 65
    cases = {
        "word_count": dict(W=rng.integers(0, nv, n).astype(np.float64),
                           C=np.zeros(nv)),
        "group_by": dict(S=(rng.integers(0, nv, n).astype(np.float64),
                            rng.standard_normal(n)), C=np.zeros(nv)),
        "conditional_sum": dict(V=rng.standard_normal(n), s=0.0, limit=0.3),
    }
    for name, ins in cases.items():
        res = g8.run(rank_run, name, ins)
        bagname = next(k for k, t in ALL[name].program.params.items()
                       if t.kind == "bag")
        for r in res:
            assert r["bag_limits"][bagname] == n, (name, r["bag_limits"])
            assert all(s == (9,) for s in r["shapes"][bagname]), r["shapes"]
        _check(res, _single(name, ins), what=name)


def test_dense_arrays_shard_not_replicate(g4):
    """PageRank's rank vectors shard as row blocks on 4 ranks with N = 13
    (padded to 16, 3 rows masked); the REP-everything fallback
    (shard_dense=False) places them whole and agrees within 1e-6; every
    matrix factorization factor is ONED_ROW (l=5, n=10 not divisible)."""
    rng = np.random.default_rng(17)
    N = 13
    ins = dict(E=(rng.integers(0, N, 40).astype(np.float64),
                  rng.integers(0, N, 40).astype(np.float64)),
               P=np.full(N, 1 / N), NP=np.zeros(N), C=np.zeros(N),
               N=N, num_steps=3.0, steps=0.0, b=0.85)
    text = compile_program(ALL["pagerank"], device="cpu").explain()
    assert "P=ONED_ROW(i)" in text and "P=REP" not in text, text
    single = _single("pagerank", ins)
    res = g4.run(rank_run, "pagerank", ins)
    for r in res:
        assert r["array_limits"]["P"] == N        # padded 13 → 16
        assert r["shapes"]["P"] == (4,)           # a row block a rank
        assert r["placements"]["P"] == "ONED_ROW"
    _check(res, single)
    rep = g4.run(rank_run, "pagerank", ins, shard_dense=False)
    for r in rep:
        assert r["array_limits"] == {} and r["shapes"]["P"] == (N,)
        assert r["placements"]["P"] == "REP"
    _check(rep, single, tol=1e-6)
    _check(rep, res[0]["out"], tol=1e-6)

    n, m, l = 10, 6, 5
    mf = dict(R=rng.standard_normal((n, m)),
              P=rng.standard_normal((n, l)) * 0.1,
              Q=rng.standard_normal((l, m)) * 0.1,
              Pp=rng.standard_normal((n, l)) * 0.1,
              Qp=rng.standard_normal((l, m)) * 0.1,
              pq=np.zeros((n, m)), err=np.zeros((n, m)),
              n=n, m=m, l=l, a=0.01, lam=0.1)
    cp = compile_program(ALL["matrix_factorization_step"], device="cpu")
    assert all(d == Dist.ONED_ROW for d in cp.dists.values()), cp.dists
    _check(g4.run(rank_run, "matrix_factorization_step", mf),
           _single("matrix_factorization_step", mf))


def test_bag_driven_einsum_distributes(g8):
    from repro_torch.core.plan import EinsumContract
    cp = compile_program(col_sums, device="cpu")
    assert any(isinstance(x, EinsumContract) for x in cp.plan), cp.explain()
    ins = _col_sums_inputs()
    _check(g8.run(rank_run, "col_sums", ins), _np(cp.run(ins)))


def _col_sums_inputs():
    rng = np.random.default_rng(13)
    nb, m = 24, 5
    return dict(B=rng.standard_normal(nb), M=rng.standard_normal((nb, m)),
                R=np.zeros(m), m=m)


def test_gspmd_mode_raises():
    from repro_torch.core.distributed import DistributedProgram
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(("data",), {"data": 1}, 0, torch.device("cpu"), "gloo")
    cp = compile_program(ALL["word_count"], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DistributedProgram(cp, mesh, mode="gspmd")


# ---------------------------------------------------------------------------
# the rebalance round (fusion and the loop forms: test_torch_round_fusion)
# ---------------------------------------------------------------------------

def test_rebalance_round_and_balance_lines(g4):
    """A bag-derived array re-read in a loop is rebalanced (13 live rows on
    4 ranks of 4-row blocks): the round is exact and explain_rounds()
    prints its per-rank counts and the balance factor."""
    cp = compile_program(loop_reader, device="cpu")
    assert cp.dists["A"] == Dist.ONED_ROW
    v = np.random.default_rng(3).standard_normal(13)
    ins = dict(V=v, A=np.zeros(13), s=0.0, steps=0.0)
    res = g4.run(rank_run, "loop_reader", ins)
    _check(res, _single("loop_reader", ins))
    text = res[0]["rounds"]
    assert "balance[A]: rows/shard=[4, 4, 4, 1] factor=1.23 " \
           "(rebalance inserted)" in text, text
    assert "rows/shard=[4, 4, 4, 1] balance=1.23" in text, text


# ---------------------------------------------------------------------------
# exchange decisions (op_select) and their rounds
# ---------------------------------------------------------------------------

_EXCHANGE = [(1024, 1, "+", 8, 128, "ONED_ROW"), (1024, 1, "min", 8, 128,
                                                  "ONED_ROW"),
             (1024, 1, "+", 8, 128, "REP"), (4096, 1, "+", 4, 512,
                                             "ONED_ROW"),
             (1 << 19, 1, "max", 8, 512, "ONED_ROW")]
_DEST = [(128, 1, "+", 8), (1 << 20, 1, "+", 8), (16, 1, "+", 4),
         (1 << 19, 1, "+", 4), (4096, 4, "min", 8)]


def test_exchange_decisions_equal_reference():
    """The cpu cost row is the reference's: every exchange and
    destination decision equals the reference selector's."""
    from repro.core.op_select import EXCHANGE_CANDIDATES as JX
    from repro.core.op_select import OpSelector as JSel

    from repro_torch.core.op_select import EXCHANGE_CANDIDATES, OpSelector
    assert EXCHANGE_CANDIDATES == JX
    ours = OpSelector(mode="cost", cache_path=None, platform="cpu")
    ref = JSel(mode="cost", cache_path=None, platform="cpu")
    for k, d, op, p, n_loc, dist in _EXCHANGE:
        a = ours.choose_exchange(k=k, d=d, op=op, nshards=p, n_local=n_loc,
                                 dest_dist=dist)
        b = ref.choose_exchange(k=k, d=d, op=op, nshards=p, n_local=n_loc,
                                dest_dist=dist)
        assert (a.backend, a.source, a.why) == (b.backend, b.source, b.why)
    for k, d, op, p in _DEST:
        a = ours.choose_reduce_dest(k=k, d=d, op=op, nshards=p)
        b = ref.choose_reduce_dest(k=k, d=d, op=op, nshards=p)
        assert (a.backend, a.source) == (b.backend, b.source), (k, d, op)
    # the goldens of the reference's suite
    assert ours.choose_reduce_dest(k=128, d=1, op="+",
                                   nshards=8).backend == "replicate"
    assert ours.choose_reduce_dest(k=1 << 20, d=1, op="+",
                                   nshards=8).backend == "shard"
    # the card's row has no collective costs between cards yet: every
    # destination keeps the reference's construction (sharded)
    card = OpSelector(mode="cost", cache_path=None, platform="cuda")
    for k, d, op, p in _DEST:
        assert card.choose_reduce_dest(k=k, d=d, op=op, nshards=p).backend \
            == "shard", (k, d, op)
    forced = OpSelector(mode="force:allreduce", cache_path=None,
                        platform="cpu")
    assert forced.choose_exchange(k=1024, d=1, op="+", nshards=8,
                                  n_local=128).source == "forced"


def _group_by_inputs(nv, ne, seed):
    rng = np.random.default_rng(seed)
    return dict(S=(rng.integers(0, nv, ne).astype(np.float64),
                   rng.standard_normal(ne)), C=np.zeros(nv))


def test_exchange_decision_in_rounds(g8):
    # small K: sharding the 128-row destination does not pay — it is
    # demoted to REP and the exchange is a plain all_reduce
    ins = _group_by_inputs(128, 1024, 11)
    res = g8.run(rank_run, "group_by", ins)
    _check(res, _single("group_by", ins))
    text = res[0]["rounds"]
    assert "placement: C→REP (dest-replicate[cost])" in text, text
    assert "reduce(psum)" in text and "per-shard[C]: segment:" in text
    assert "transport: all_reduce over gloo" in text, text
    # large K: the dense partial + reduce-scatter exchange pays
    ins = _group_by_inputs(1 << 19, 4096, 12)
    res = g8.run(rank_run, "group_by", ins)
    _check(res, _single("group_by", ins))
    text = res[0]["rounds"]
    assert "placement:" not in text, text
    assert "reduce(psum_scatter[cost])" in text, text
    assert "transport: reduce_scatter_tensor over gloo" in text, text


def _streams(nv, ne, rng):
    return {"one_key": np.zeros(ne),
            "zipf": ((rng.zipf(1.5, ne) - 1) % nv).astype(np.float64),
            "neg_oob": rng.integers(-nv, 2 * nv, ne).astype(np.float64)}


@pytest.mark.parametrize("nv,ne,op_select,salting,want,forbid", [
    # salted rounds fold key*S+salt back to [K] before the exchange, so
    # the wire format (a dense [K] partial) is unchanged
    (1 << 19, 4096, "force:psum_scatter", "force:4",
     ["reduce(psum_scatter", "salt=4x[hint]"], []),
    (1 << 19, 4096, "force:allreduce", "off",
     ["reduce(allreduce[forced]"], ["salt="]),
    # small K demotes the destination to REP: salting composes with it
    (128, 2048, "cost", "force:4", ["placement: C→REP", "salt=4x[hint]"],
     []),
], ids=["psum_scatter-salted", "allreduce", "rep-salted"])
def test_distributed_degenerate_streams(g8, nv, ne, op_select, salting,
                                        want, forbid):
    rng = np.random.default_rng(13)
    kw = dict(op_select=op_select, skew_salting=salting)
    for stream, keys in _streams(nv, ne, rng).items():
        ins = dict(S=(keys, rng.standard_normal(ne)), C=np.zeros(nv))
        res = g8.run(rank_run, "group_by", ins, kw=kw)
        _check(res, _single("group_by", ins), what=stream)
        text = res[0]["rounds"]
        for w in want:
            assert w in text, (stream, w, text)
        for f in forbid:
            assert f not in text, (stream, f, text)


def test_probe_salts_alike_on_every_rank(g4):
    """The hot-key probe reads the GLOBAL inputs: a stream whose hot key
    lives in one rank's block salts every rank's round alike."""
    ne, nv = 8192, 1 << 12
    keys = np.arange(ne, dtype=np.float64) % nv
    keys[:ne // 2] = 7.0                     # rank 0 and 1 hold the hot key
    ins = dict(S=(keys, np.ones(ne)), C=np.zeros(nv))
    res = g4.run(rank_run_cuda_costs, "group_by", ins)
    _check(res, _single("group_by", ins))
    assert "salt=" in res[0]["rounds"], res[0]["rounds"]
    assert all(r["rounds"] == res[0]["rounds"] for r in res)


def rank_run_cuda_costs(mesh, name, ins):
    """rank_run with the card's cost model (on CPU tensors)."""
    from repro_torch.core.distributed import compile_distributed
    dp = compile_distributed(_program(name), mesh, ("data",))
    dp.cp.selector.platform = "cuda"
    out = dp.run(ins)
    return {"out": _np(out), "rounds": dp.explain_rounds()}


# ---------------------------------------------------------------------------
# the live reference: a subprocess with forced host devices runs the
# reference's distributed program on the same inputs
# ---------------------------------------------------------------------------

_REF_CODE = """
import os, sys, json, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
from repro.core.distributed import compile_distributed
from repro.core.programs import ALL
from repro.launch.mesh import make_test_mesh
import _ref_programs
tmp = sys.argv[1]
with open(os.path.join(tmp, "cases.pkl"), "rb") as f:
    cases = pickle.load(f)
mesh = make_test_mesh((8,), ("data",))
rounds = {}
for key, (name, ins, kw) in cases.items():
    fn = getattr(_ref_programs, name, None) or ALL[name]
    dp = compile_distributed(fn, mesh, ("data",), mode="shardmap", **kw)
    res = dp.run(ins)
    np.savez(os.path.join(tmp, key + ".npz"),
             **{k: np.asarray(v, np.float64) for k, v in res.items()})
    rounds[key] = dp.explain_rounds()
print("REF_JSON" + json.dumps(rounds))
"""

_REF_PROGRAMS = """
from repro.core import bag, dim, loop_program, matrix, vector


@loop_program
def col_sums(B: bag[1], M: matrix, R: vector, m: dim):
    for i, w in items(B):
        for j in range(0, m):
            R[j] += M[i, j]
"""


def _round_lines(text):
    return [ln.strip() for ln in text.splitlines()
            if ln.strip().startswith("round:")]


def test_against_the_live_reference(g8, tmp_path):
    """The two reference scenarios whose distributed run still works here
    (a bag-driven einsum; degenerate group-by streams through both
    exchanges with salting): the port's 8-rank outputs are within 1e-4 of
    the reference's, and its round strategies are the reference's."""
    import pickle
    rng = np.random.default_rng(29)
    keys = ((rng.zipf(1.5, 4096) - 1) % (1 << 19)).astype(np.float64)
    vals = rng.standard_normal(4096)
    small = rng.integers(0, 128, 2048).astype(np.float64)
    cases = {
        "col_sums": ("col_sums", _col_sums_inputs(), {}),
        "psum_scatter": ("group_by", dict(S=(keys, vals),
                                          C=np.zeros(1 << 19)),
                         dict(op_select="force:psum_scatter",
                              skew_salting="force:4")),
        "allreduce": ("group_by", dict(S=(keys, vals), C=np.zeros(1 << 19)),
                      dict(op_select="force:allreduce", skew_salting="off")),
        "rep": ("group_by", dict(S=(small, vals[:2048]), C=np.zeros(128)),
                dict(op_select="cost", skew_salting="force:4")),
    }
    with open(tmp_path / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    (tmp_path / "_ref_programs.py").write_text(_REF_PROGRAMS)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), os.path.join(_ROOT, "src")]))
    r = subprocess.run([sys.executable, "-c", _REF_CODE, str(tmp_path)],
                       cwd=_ROOT, capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rounds = json.loads(r.stdout.split("REF_JSON", 1)[1])
    for key, (name, ins, kw) in cases.items():
        res = g8.run(rank_run, name, ins, kw=kw)
        with np.load(tmp_path / f"{key}.npz") as z:
            want = {k: z[k] for k in z.files}
        _check(res, want, what=key)
        assert _round_lines(res[0]["rounds"]) == \
            _round_lines(rounds[key]), (key, res[0]["rounds"], rounds[key])
