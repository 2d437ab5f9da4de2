"""Surgical recovery in the distributed rounds of the PyTorch port
(DESIGN.md §13), on 4- and 8-rank gloo groups on the CPU: losing one
shard's partition mid-pagerank — after a round (the `dist.shard_lost`
site) and inside one (`dist.round_exec`) — recovers bit-identical to the
fault-free run with zero ladder descents, with the reference's ledger
texts; the block-restricted recompute's working set is the 1/P block; a
flapping worker and disabled lineage escalate to the ladder; a round that
straggles against its own earlier runs gets one speculative backup; the
peer-replica carry tier ring-copies over the group and falls back past a
torn replica; the ladder takes a deterministic error to REP-everything
once and a capacity error to the chunked tier.

Every rank runs the same injection schedule, so the ranks fire each site
together, as the reference's one controller does — except where a test
injects on one rank only: a failure the other ranks do not share fails
every rank (RankDivergence), and a transient before a round's first
collective is retried on its rank alone.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import compile_program
from repro_torch.core import faults as F
from repro_torch.core.programs import ALL
from repro_torch.launch.ranks import RankFailure, RankGroup
from repro_torch.runtime import LoopRunner
from repro_torch.runtime.ft import PeerReplica


@pytest.fixture(scope="module")
def g4():
    with RankGroup(4, device="cpu") as g:
        yield g


@pytest.fixture(scope="module")
def g8():
    with RankGroup(8, device="cpu") as g:
        yield g


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _pagerank_inputs():
    rng = np.random.default_rng(42)
    ne, N = 30, 10
    return dict(E=(rng.integers(0, N, ne).astype(np.float64),
                   rng.integers(0, N, ne).astype(np.float64)),
                P=np.full(N, 1.0 / N), NP=np.zeros(N), C=np.zeros(N),
                N=N, num_steps=3.0, steps=0.0, b=0.85)


INS = _pagerank_inputs()


def _mk(mesh, **kw):
    from repro_torch.core.distributed import compile_distributed
    cp = compile_program(ALL["pagerank"], device=mesh.device, **kw)
    cp.policy.backoff_s = 0.0
    cp.policy.max_backoff_s = 0.0
    cp.faults.sleep = lambda s: None
    return compile_distributed(cp, mesh)


def rank_faulted(mesh, specs=(), kw=None, fake_clock=False, spy=False,
                 ins=None, only=None, vote_timeout_s=None):
    """pagerank under `specs` on one rank (on rank `only` alone when it is
    given): outputs, ledger, counters, and (spy) the (block rows, padded
    global rows) of every block-restricted recompute this rank made."""
    import repro_torch.core.distributed as D
    dp = _mk(mesh, **(kw or {}))
    if only is not None and mesh.rank != only:
        specs = ()
    if vote_timeout_s is not None:
        dp.vote_timeout_s = vote_timeout_s
    shapes = []
    orig = D.DistributedProgram._recompute_blocks

    def watch(self, k, pre, env, rec):
        out = orig(self, k, pre, env, rec)
        if out:
            shapes.extend((int(v.shape[0]),
                           int(pre[d].shape[0]) * self.dp_n)
                          for d, v in out.items())
        return out
    clk = None
    if fake_clock:
        clk = FakeClock()
        dp.faults.clock = clk
    if spy:
        D.DistributedProgram._recompute_blocks = watch
    try:
        with F.inject(*specs, clock=clk):
            out = dp.run(INS if ins is None else ins)
    finally:
        D.DistributedProgram._recompute_blocks = orig
    return {"out": {k: v.cpu().numpy() for k, v in out.items()},
            "faults": dp.explain_faults(),
            "counters": dict(dp.faults.counters),
            "saved": dp.faults.spec_saved_s, "shapes": shapes}


def _bit(res, ref):
    for r in res:
        for k in ref:
            assert np.array_equal(r["out"][k], ref[k]), k


def _close(res, ref):
    for r in res:
        for k in ref:
            y = np.asarray(ref[k], np.float64)
            x = np.asarray(r["out"][k], np.float64)
            assert np.max(np.abs(x - y) / (np.abs(y) + 1.0)) < 1e-6, k


def _lost(site, nth, shard, times=1):
    return F.FaultSpec(site, kind="shard_lost", nth=nth, times=times,
                       shard=shard)


def _ref(g, **kw):
    res = g.run(rank_faulted, (), kw)
    return res[0]["out"]


@pytest.mark.parametrize("world", [4, 8])
def test_shard_loss_lineage_recovery_acceptance(world, g4, g8):
    """1-of-P shard loss mid-pagerank — after a pre-loop round, after a
    round inside the loop, and inside a round — recovers bit-identical to
    the fault-free run with zero ladder descents."""
    g = g4 if world == 4 else g8
    kw = dict(round_fusion=False)
    ref = _ref(g, **kw)

    # 1) pre-loop reduce into a replicated destination: nothing to redo
    res = g.run(rank_faulted, [_lost("dist.shard_lost", 1, 3)], kw)
    _bit(res, ref)
    for r in res:
        assert r["counters"].get("descend", 0) == 0
        assert r["counters"]["recovered"] == 1
        assert "nothing to recompute" in r["faults"]
        assert "lineage depth" in r["faults"]

    # 2) mid-loop aligned store: block-restricted recompute, 1/P of it
    res = g.run(rank_faulted, [_lost("dist.shard_lost", 7, world - 3)], kw,
                spy=True)
    _bit(res, ref)
    for r in res:
        assert r["counters"].get("descend", 0) == 0
        assert f"block-restricted recompute (1/{world} of the round)" \
            in r["faults"], r["faults"]
        assert "checksum ok" in r["faults"]
    # the recompute's working set is rank k's block, never the whole
    shapes = [s for r in res for s in r["shapes"]]
    assert shapes and all(blk * world == npad for blk, npad in shapes), \
        shapes
    assert sum(bool(r["shapes"]) for r in res) == 1      # rank k alone

    # 3) mid-loop unaligned reduce: replay the round + re-slice
    res = g.run(rank_faulted, [_lost("dist.shard_lost", 6, 1)], kw)
    _bit(res, ref)
    for r in res:
        assert r["counters"].get("descend", 0) == 0
        assert "replay round + re-slice" in r["faults"], r["faults"]

    # 4) MID-round loss (before the outputs applied): one same-level
    # re-dispatch from the host inputs
    res = g.run(rank_faulted, [_lost("dist.round_exec", 5, 2)], kw)
    _bit(res, ref)
    for r in res:
        assert r["counters"].get("descend", 0) == 0
        assert "same-level re-dispatch" in r["faults"]


def test_shard_loss_ledger_texts_equal_reference(g8):
    """The `recovered` text is the reference's, word for word: its format
    (core/distributed.py of the reference) filled with the reference
    plan's own lineage facts for the lost round."""
    from repro.core import compile_program as jcompile
    from repro.core import plan as JP
    from repro.core.programs import ALL as JALL
    res = g8.run(rank_faulted, [_lost("dist.shard_lost", 7, 5)],
                 dict(round_fusion=False))
    ours = compile_program(ALL["pagerank"], device="cpu",
                           round_fusion=False)
    jcp = jcompile(JALL["pagerank"], round_fusion=False)
    assert ours.explain_lineage() == jcp.explain_lineage()
    loop = next(n for n in jcp.plan if isinstance(n, JP.SeqLoop))
    node = next(n for n in loop.body
                if isinstance(n, JP.DenseMap) and n.dest == "P")
    lin = node.lineage
    reads = ", ".join(f"{a}:{k}" for a, k in lin.reads) or "none"
    want = (f"  recovered[round:DenseMap] shard 5/8: P[10:12] via "
            f"block-restricted recompute (1/8 of the round); lineage "
            f"depth={lin.depth} (a from-scratch restart would replay "
            f"{lin.depth} round(s)); reads[{reads}]; checksum ok")
    for r in res:
        assert want in r["faults"].splitlines(), (want, r["faults"])


def test_fused_loop_loss_replays_the_region(g4):
    ref = _ref(g4)
    res = g4.run(rank_faulted, [_lost("dist.shard_lost", 2, 2)])
    _bit(res, ref)
    for r in res:
        assert r["counters"].get("descend", 0) == 0
        assert "replay fused loop + re-slice" in r["faults"], r["faults"]


def test_shard_loss_escalation_and_speculation(g8):
    kw = dict(round_fusion=False)
    ref = _ref(g8, **kw)
    # the same shard lost twice within the TTL: a flapping worker — the
    # ladder takes over (REP-everything is close, not bit-identical)
    res = g8.run(rank_faulted, [_lost("dist.shard_lost", 4, 5, times=2)],
                 kw)
    _close(res, ref)
    for r in res:
        assert r["counters"]["descend"] >= 1
        assert "flapping" in r["faults"] and "TTL" in r["faults"]
    # lineage disabled: every shard loss is a ladder event
    res = g8.run(rank_faulted, [_lost("dist.shard_lost", 4, 5)],
                 dict(round_fusion=False, lineage=False))
    _close(res, ref)
    for r in res:
        assert r["counters"]["descend"] >= 1
        assert r["counters"].get("recovered", 0) == 0
    # a straggling round on a fake clock: the 12th round, the loop's 4th
    # NP reduce, 100× the trailing median of its own three earlier runs:
    # ONE backup copy, which wins
    ins = dict(INS, num_steps=5.0)
    specs = [F.FaultSpec("dist.round_exec", "slow", nth=1, times=11,
                         delay_s=0.01),
             F.FaultSpec("dist.round_exec", "slow", nth=12, delay_s=1.0)]
    res = g8.run(rank_faulted, specs, kw, fake_clock=True, ins=ins)
    _bit(res, g8.run(rank_faulted, (), kw, ins=ins)[0]["out"])
    for r in res:
        assert r["counters"]["straggler"] >= 1
        assert r["counters"]["speculative"] == 1
        assert r["saved"] > 0.5
        assert "backup won" in r["faults"]
        assert r["counters"].get("descend", 0) == 0


def test_ladder_deterministic_to_rep_and_capacity_to_chunked(g4):
    kw = dict(round_fusion=False)
    ref = _ref(g4, **kw)
    res = g4.run(rank_faulted, [F.FaultSpec("dist.round_exec",
                                            "deterministic", nth=1)], kw)
    _close(res, ref)
    for r in res:
        assert r["counters"]["descend"] == 1
        assert "descend  [rounds->rep]" in r["faults"], r["faults"]
    res = g4.run(rank_faulted, [F.FaultSpec("dist.round_exec", "capacity",
                                            nth=1)], kw)
    _close(res, ref)
    for r in res:
        assert "descend  [rounds->chunked]" in r["faults"], r["faults"]


def test_transient_after_a_collective_retries_the_run_on_every_rank(g4):
    """A transient at a round's reduce-scatter, after the round's
    all_gather went out: no rank retries the round alone; the ranks
    settle it and retry the whole run together, bit-equal."""
    kw = dict(round_fusion=False)
    ref = _ref(g4, **kw)
    res = g4.run(rank_faulted, [F.FaultSpec("dist.exchange", "transient",
                                            nth=3)], kw)
    _bit(res, ref)
    for r in res:
        assert "retry    [dist]" in r["faults"], r["faults"]
        assert "retry    [round:" not in r["faults"], r["faults"]
        assert r["counters"].get("descend", 0) == 0


def test_one_rank_transient_before_its_collectives_retries_in_place(g4):
    """A transient on one rank before its round's first collective is
    retried there, in place: the others never see it."""
    kw = dict(round_fusion=False)
    ref = _ref(g4, **kw)
    res = g4.run(rank_faulted, [F.FaultSpec("dist.round_exec", "transient",
                                            nth=2)], kw, only=1)
    _bit(res, ref)
    for r in res:
        assert r["counters"].get("retry", 0) == (r is res[1])
        assert r["counters"].get("descend", 0) == 0


def test_one_rank_capacity_fault_fails_every_rank(g4):
    """A capacity error on one rank alone: that rank may not take the
    chunked tier while the others wait in a collective, so every rank
    fails with RankDivergence and none descends."""
    kw = dict(round_fusion=False)
    with pytest.raises(RankFailure) as err:
        g4.run(rank_faulted, [F.FaultSpec("dist.round_exec", "capacity",
                                          nth=1)], kw, only=2,
               vote_timeout_s=2.0, deadline_s=120)
    text = str(err.value)
    parts = text.split("--- rank ")[1:]
    assert sorted(int(p.split(" ")[0]) for p in parts) == [0, 1, 2, 3], text
    for p in parts:
        assert "RankDivergence" in p, p
        assert "descend" not in p, p
    assert "rank 2 of 4: capacity failure at level rounds" in text, text
    # the group was torn down; the next call starts a new one
    _bit(g4.run(rank_faulted, (), kw), _ref(g4, **kw))


# ---------------------------------------------------------------------------
# the peer-replica carry tier
# ---------------------------------------------------------------------------

def rank_peer_replica(mesh):
    """Ring copies on the group: each rank's blocks live on its
    neighbour and come back verified; a replica torn on rank 1 (it holds
    rank 0's block) sends every rank back to the previous snapshot."""
    pr = PeerReplica(mesh=mesh, dp=("data",))
    x = torch.arange(4.0) + 4 * mesh.rank
    y = x * 2
    pr.mirror(0, 1, 1, {"P": x})
    pr.mirror(0, 2, 2, {"P": y})
    held = pr.snaps[-1]["data"]["P"].clone()
    li, it, step, carry = pr.latest_good()
    first = (it, bool(torch.equal(carry["P"], y)),
             bool(torch.equal(held, torch.arange(4.0) * 2
                              + 8 * ((mesh.rank - 1) % mesh.size))))
    if mesh.rank == 1:
        pr.snaps[-1]["data"]["P"][3] += 1.0
    li, it, step, carry = pr.latest_good()
    return first, (it, bool(torch.equal(carry["P"], x))), list(pr.torn)


def test_peer_replica_ring_copy_on_the_group(g4):
    for first, second, torn in g4.run(rank_peer_replica):
        assert first == (2, True, True)
        assert second == (1, True)
        assert torn == [2]


def test_peer_replica_torn_falls_back_to_previous_good():
    led = F.FaultLedger(name="peer")
    pr = PeerReplica(ledger=led)
    a, b = np.arange(8.0), np.arange(8.0) * 3
    pr.mirror(0, 1, 10, {"P": a})
    pr.mirror(0, 2, 11, {"P": b})
    pr.snaps[-1]["data"]["P"][2] += 1.0     # torn write
    li, it, step, carry = pr.latest_good()
    assert (li, it, step) == (0, 1, 10)
    assert np.array_equal(np.asarray(carry["P"]), a)
    assert pr.torn == [11]
    assert led.counters["escalate"] == 1


def test_peer_replica_depth_bound():
    pr = PeerReplica(depth=2)
    for i in range(5):
        pr.mirror(0, i, i, {"x": np.full(4, float(i))})
    assert len(pr.snaps) == 2
    assert pr.latest_good()[1] == 4


def _fresh(ins):
    return {k: (tuple(np.array(c) for c in v) if isinstance(v, tuple)
                else v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in ins.items()}


def test_loop_runner_restores_carry_from_peer_replica(tmp_path):
    """The in-memory tier beats the disk tier on recency: a loop killed at
    iteration k restores its carry from the newest GOOD peer snapshot and
    finishes bit-identical to an uninterrupted stepwise run."""
    ins = _fresh(INS)
    ins["num_steps"] = 6.0
    cp = compile_program(ALL["pagerank"], device="cpu")
    cp.faults.sleep = lambda s: None
    ref = cp.run_stepwise(_fresh(ins))
    runner = LoopRunner(cp, str(tmp_path), every=10 ** 6, peer_every=1)
    with F.inject(F.FaultSpec("lower.loop_iter", "deterministic", nth=4,
                              message="kill -9")):
        with pytest.raises(F.DeterministicFault):
            runner.run(_fresh(ins), resume=False)
    assert runner.peer is not None and runner.peer.snaps
    out = runner.run(_fresh(ins), resume=True)
    assert runner.peer_restores == 1
    assert cp.faults.counters["recovered"] >= 1
    assert "peer replica" in cp.explain_faults()
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


def test_shard_lost_during_chunk_loop_resumes_chunk_granular(tmp_path):
    def wc_inputs(n):
        r = np.random.default_rng(0)
        return dict(W=r.integers(0, 10, n).astype(np.float64),
                    C=np.zeros(10))

    def quiet(cp):
        cp.faults.sleep = lambda s: None
        return cp

    ref = quiet(compile_program(ALL["word_count"], device="cpu")).run(
        wc_inputs(1024))
    cp = quiet(compile_program(ALL["word_count"], out_of_core="force",
                               chunk_rows=128, device="cpu"))   # 8 chunks
    runner = LoopRunner(cp, str(tmp_path), every=1)
    with pytest.raises(F.ShardLostFault):
        with F.inject(F.FaultSpec("lower.chunk_step", "shard_lost",
                                  nth=6, times=10 ** 6, shard=3)):
            runner.run(wc_inputs(1024), resume=False)
    assert runner.saves >= 1
    cp2 = quiet(compile_program(ALL["word_count"], out_of_core="force",
                                chunk_rows=128, device="cpu"))
    runner2 = LoopRunner(cp2, str(tmp_path), every=1)
    out = runner2.run(wc_inputs(1024), resume=True)
    assert runner2.resumed_from is not None
    for k in ref:
        assert torch.equal(out[k], ref[k]), k
    assert cp2.chunker.chunks_run < 8       # completed chunks NOT re-run
