"""Out-of-core execution in the PyTorch port (`core/chunked.py`): plans
whose inputs dwarf the device budget stream bag tiles through resident
destination accumulators.  The port of tests/test_outofcore.py, on the CPU:

* bit-identity — a chunked run equals the all-resident `run_stepwise()`
  for EVERY tile size (scatter backend), and `run()` for loop-free
  programs;
* admission — a memory estimate over budget routes run() through the
  chunked path up front, recorded in the ledger;
* the ladder — capacity errors descend whole → chunked (and eager →
  chunked), repeated capacity INSIDE the stream halves the tile,
  transients retry in place at the chunk sites, deterministic faults
  surface;
* resume — a killed chunked run restarts from the last chunk checkpoint
  through `runtime.LoopRunner`.

Beyond the reference's tests: the port's chunked outputs against the JAX
package's, `explain_chunked()` equal to the reference's for every
program, the bag offsets and limits of the executor against the
reference's, and the card's fold — a + group-by of a chunk body on the
segment kernel folds a running partial range by range and combines it
with the destination after the last chunk — rehearsed on the CPU with
the range size patched down.  Tests marked `cuda` run the stream on the
card and skip here:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_outofcore.py
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

try:
    from repro.core import compile_program as jax_compile
    from repro.core import faults as JF
    from repro.core.programs import ALL as JAX_ALL
    from repro.runtime import LoopRunner as JaxLoopRunner
    from test_core_programs import data_for
except ImportError:     # the card's machine: only the `cuda` tests run there
    pass
from repro_torch.core import compile_program, parse_program
from repro_torch.core import faults as F
from repro_torch.core import plan as P
from repro_torch.core.chunked import (DEFAULT_CHUNK_ROWS, ChunkLoop,
                                      choose_chunk_rows, default_chunk_rows)
from repro_torch.core.programs import ALL
from repro_torch.runtime import LoopRunner

# the module (the package's `segment_reduce` is the wrapper function)
SR = importlib.import_module("repro_torch.kernels.segment_reduce")

N, NE = 64, 512
RTOL, ATOL = 2e-3, 1e-4          # tests/test_core_programs.py's


def pr_inputs(seed=7, ne=NE, steps=3.0):
    r = np.random.default_rng(seed)
    return dict(E=(r.integers(0, N, ne).astype(np.int32),
                   r.integers(0, N, ne).astype(np.int32)),
                P=np.full(N, 1.0 / N, np.float32),
                NP=np.zeros(N, np.float32), C=np.zeros(N, np.float32),
                N=N, num_steps=steps, steps=0.0, b=0.85)


def wc_inputs(seed=3, n=1024, k=32):
    r = np.random.default_rng(seed)
    return dict(W=(r.integers(0, k, n).astype(np.int32),),
                C=np.zeros(k, np.float32))


def gb_inputs(seed=5, n=1000, k=24, c0=True):
    r = np.random.default_rng(seed)
    return dict(S=(r.integers(-2, k + 2, n).astype(np.float32),
                   r.standard_normal(n, dtype=np.float32)),
                C=(r.standard_normal(k, dtype=np.float32) if c0
                   else np.zeros(k, np.float32)))


def _quiet(cp):
    cp.faults.sleep = lambda s: None
    return cp


def _pr(**kw):
    return _quiet(compile_program(ALL["pagerank"], op_select="force:scatter",
                                  device="cpu", **kw))


def _wc(**kw):
    return _quiet(compile_program(ALL["word_count"],
                                  op_select="force:scatter", device="cpu",
                                  **kw))


def _bitident(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def _close(ours, ref):
    for k in ref:
        np.testing.assert_allclose(
            ours[k].cpu().numpy().astype(np.float64),
            np.asarray(ref[k], np.float64), rtol=RTOL, atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# the chunking pass
# ---------------------------------------------------------------------------

def test_chunk_plan_wraps_bag_nodes():
    ck = _wc(out_of_core="force").chunker
    loops = [n for n in ck.plan if isinstance(n, ChunkLoop)]
    assert len(loops) == 1
    assert loops[0].chunk_bag == "W"
    assert "C" in loops[0].carry


def test_chunk_plan_recurses_into_seq_loops():
    ck = _pr(out_of_core="force").chunker
    assert ck.n_chunk_loops >= 2    # C outside the while, NP inside it
    outer = [n for n in ck.plan if isinstance(n, ChunkLoop)]
    assert outer, "degree count must stream at top level"


def test_chunk_bodies_pin_bit_identical_backend():
    """Streaming folds partial results chunk-by-chunk: on the CPU only the
    direct scatter left-fold commutes with that split bit-exactly, so
    chunk bodies pin backend=scatter and salt=1 regardless of op_select;
    a program on the card pins a + group-by to the segment kernel."""
    cp = compile_program(ALL["word_count"], device="cpu")
    for node in P.flatten(cp.chunker.plan):
        if isinstance(node, ChunkLoop):
            for inner in P.flatten(node.body):
                if isinstance(inner, P.SegmentReduce):
                    assert inner.backend == "scatter"
                    assert inner.salt == 1
    # what a program on the card pins (forced here: the plain version)
    card = compile_program(ALL["word_count"], op_select="force:pallas",
                           device="cpu")
    segs = [s for n in card.chunker.plan if isinstance(n, ChunkLoop)
            for s in P.flatten(n.body) if isinstance(s, P.SegmentReduce)]
    assert segs and all(s.backend == "pallas" and s.salt == 1 for s in segs)


def test_choose_chunk_rows_fits_budget():
    cp = _wc()
    est = cp.estimate_memory(wc_inputs())
    rows = choose_chunk_rows(est, est.fixed_bytes + 64 * est.per_row("W"),
                             n_rows=1024)
    assert 1 <= rows <= 64
    assert est.fixed_bytes + rows * est.per_row("W") <= \
        est.fixed_bytes + 64 * est.per_row("W")
    # a roomy budget clamps to the full bag, a hopeless one to 1 row
    assert choose_chunk_rows(est, 10 ** 12, n_rows=1024) == 1024
    assert choose_chunk_rows(est, 0, n_rows=1024) == 1


def test_default_chunk_rows_is_a_range_on_the_card():
    """A divergence kept on purpose: the reference's 4096-row default on
    the CPU, one range of the segment kernel (2^26 rows) on the card —
    the unit its order is fixed by (4096 would be 131,072 launches for a
    2^29-row bag, and not the all-resident bits)."""
    assert default_chunk_rows("cpu") == DEFAULT_CHUNK_ROWS == 4096
    assert default_chunk_rows("cuda") == SR.RANGE_ROWS == 2 ** 26
    assert _wc(out_of_core="force")._initial_chunk_rows(wc_inputs()) == 4096


# ---------------------------------------------------------------------------
# bit-identity
# ---------------------------------------------------------------------------

def test_word_count_chunked_bitwise_vs_run():
    ref = _wc().run(wc_inputs())
    for tile in (1024, 100, 17):
        out = _wc(out_of_core="force", chunk_rows=tile).run(wc_inputs())
        assert _bitident(ref, out), tile


def test_pagerank_chunked_bitwise_vs_stepwise():
    """All tile sizes — including a non-divisor (7), whose last tile is
    short — reproduce the all-resident host-driven run bit-exactly."""
    ref = _pr().run_stepwise(pr_inputs(steps=5.0))
    for tile in (512, 100, 64, 7):
        out = _pr(out_of_core="force", chunk_rows=tile).run(
            pr_inputs(steps=5.0))
        assert _bitident(ref, out), tile


def test_ten_x_over_budget_completes():
    """The acceptance scenario: an edge bag ~10× the simulated budget
    streams to the bit-identical answer, with the chosen tile keeping
    fixed + tile·per_row within budget (peak O(tile + dests))."""
    ins = pr_inputs(steps=3.0)
    probe = _pr()
    est = probe.estimate_memory(ins)
    budget = est.fixed_bytes + est.bag_bytes["E"] // 10
    cp = _pr(memory_budget=budget)
    assert cp._ooc_admits(ins)
    rows = cp._initial_chunk_rows(ins)
    assert est.fixed_bytes + rows * est.per_row("E") <= budget
    out = cp.run(ins)
    ref = _pr().run_stepwise(pr_inputs(steps=3.0))
    assert _bitident(ref, out)
    assert cp.faults.counters["admission"] >= 1
    wc = _wc(memory_budget=400)      # W is 4KiB — 10× over
    out2 = wc.run(wc_inputs())
    assert _bitident(_wc().run(wc_inputs()), out2)


def test_admission_is_visible():
    cp = _wc(memory_budget=400)
    cp.run(wc_inputs())
    text = cp.explain_faults()
    assert "admission" in text and "chunked" in text
    assert "budget" in cp.explain_memory(wc_inputs())
    assert "[chunked]" in cp.explain_chunked()


def test_off_disables_admission():
    cp = _wc(memory_budget=400, out_of_core="off")
    assert not cp._ooc_admits(wc_inputs())
    assert _bitident(_wc().run(wc_inputs()), cp.run(wc_inputs()))


# ---------------------------------------------------------------------------
# the ladder: capacity → chunked, halving, retries
# ---------------------------------------------------------------------------

def test_capacity_at_whole_descends_to_chunked():
    cp = _wc()
    with F.inject(F.FaultSpec("lower.whole_trace", "capacity", nth=1,
                              times=10 ** 6)):
        out = cp.run(wc_inputs())
    assert _bitident(_wc().run(wc_inputs()), out)
    assert cp.faults.level_reached == "chunked"
    text = cp.explain_faults()
    assert "whole->chunked" in text and "recover" in text
    assert "whole->eager" not in text


def test_capacity_at_eager_descends_to_chunked():
    cp = _wc()
    with F.inject(F.FaultSpec("lower.whole_trace", "deterministic", nth=1),
                  F.FaultSpec("lower.node", "capacity", nth=1)):
        out = cp.run(wc_inputs())
    assert _bitident(_wc().run(wc_inputs()), out)
    assert "eager->chunked" in cp.explain_faults()


def test_capacity_mid_stream_halves_the_tile():
    cp = _wc(out_of_core="force", chunk_rows=256)
    with F.inject(F.FaultSpec("lower.chunk_step", "capacity", nth=2)):
        out = cp.run(wc_inputs())
    assert _bitident(_wc().run(wc_inputs()), out)
    text = cp.explain_faults()
    assert "chunked[256]->chunked[128]" in text
    assert cp.faults.level_reached == "chunked[128]"


def test_repeated_capacity_keeps_halving():
    cp = _wc(out_of_core="force", chunk_rows=64)
    with F.inject(F.FaultSpec("lower.chunk_step", "capacity", nth=1,
                              times=3)):
        out = cp.run(wc_inputs())
    assert _bitident(_wc().run(wc_inputs()), out)
    text = cp.explain_faults()
    assert "chunked[64]->chunked[32]" in text
    assert "chunked[32]->chunked[16]" in text


def test_transient_at_chunk_boundary_retries_in_place():
    cp = _wc(out_of_core="force", chunk_rows=128)
    with F.inject(F.FaultSpec("lower.chunk_step", "transient", nth=3)) \
            as inj:
        out = cp.run(wc_inputs())
    assert inj.fired
    assert _bitident(_wc().run(wc_inputs()), out)
    assert cp.faults.counters["retry"] >= 1
    assert cp.faults.counters["descend"] == 0


def test_transient_mid_prefetch_retries_in_place():
    cp = _wc(out_of_core="force", chunk_rows=128)
    with F.inject(F.FaultSpec("lower.chunk_prefetch", "transient",
                              nth=2)) as inj:
        out = cp.run(wc_inputs())
    assert inj.fired
    assert _bitident(_wc().run(wc_inputs()), out)
    assert cp.faults.counters["retry"] >= 1


def test_deterministic_in_stream_surfaces():
    cp = _wc(out_of_core="force", chunk_rows=128)
    with pytest.raises(F.DeterministicFault):
        with F.inject(F.FaultSpec("lower.chunk_step", "deterministic",
                                  nth=2, times=10 ** 6)):
            cp.run(wc_inputs())


def test_pagerank_capacity_descent_is_bitwise_stepwise():
    """whole → chunked must hold the STEPWISE identity even for a looped
    program (the chunked executor is host-driven like run_stepwise)."""
    cp = _pr()
    with F.inject(F.FaultSpec("lower.whole_trace", "capacity", nth=1,
                              times=10 ** 6)):
        out = cp.run(pr_inputs())
    ref = _pr().run_stepwise(pr_inputs())
    assert _bitident(ref, out)
    assert cp.faults.level_reached == "chunked"


# ---------------------------------------------------------------------------
# chunk-granular checkpoint/resume
# ---------------------------------------------------------------------------

def test_killed_chunked_run_resumes_from_chunk_checkpoint(tmp_path):
    ref = _pr(out_of_core="force", chunk_rows=64).run(pr_inputs(steps=5.0))

    cp = _pr(out_of_core="force", chunk_rows=64)
    runner = LoopRunner(cp, str(tmp_path), every=1)
    with pytest.raises(F.DeterministicFault):
        with F.inject(F.FaultSpec("lower.chunk_step", "deterministic",
                                  nth=5, times=10 ** 6)):
            runner.run(pr_inputs(steps=5.0), resume=False)
    assert runner.saves >= 1

    cp2 = _pr(out_of_core="force", chunk_rows=64)
    runner2 = LoopRunner(cp2, str(tmp_path), every=1)
    out = runner2.run(pr_inputs(steps=5.0), resume=True)
    assert runner2.resumed_from is not None
    assert _bitident(ref, out)


def test_resume_skips_completed_chunks(tmp_path):
    """The fast-forward is real: the resumed run must execute fewer
    chunks of the killed loop than a cold run would."""
    ins = wc_inputs(n=1024)
    cp = _wc(out_of_core="force", chunk_rows=128)   # 8 chunks
    runner = LoopRunner(cp, str(tmp_path), every=1)
    with pytest.raises(F.DeterministicFault):
        with F.inject(F.FaultSpec("lower.chunk_step", "deterministic",
                                  nth=6, times=10 ** 6)):
            runner.run(ins, resume=False)

    cp2 = _wc(out_of_core="force", chunk_rows=128)
    runner2 = LoopRunner(cp2, str(tmp_path), every=1)
    out = runner2.run(ins, resume=True)
    assert _bitident(_wc().run(wc_inputs(n=1024)), out)
    assert cp2.chunker.chunks_run < 8


@pytest.mark.parametrize("tile2", [64, 256])
def test_resume_goes_on_from_the_rows_folded(tmp_path, tile2):
    """A chunk checkpoint records the rows its stream folded, so a resume
    that streams another tile (another budget, the halving rung's) goes
    on from that row: no row is skipped or folded twice."""
    ins = wc_inputs(n=1024)
    cp = _wc(out_of_core="force", chunk_rows=128)
    runner = LoopRunner(cp, str(tmp_path), every=1)
    with pytest.raises(F.DeterministicFault):
        with F.inject(F.FaultSpec("lower.chunk_step", "deterministic",
                                  nth=4, times=10 ** 6)):
            runner.run(ins, resume=False)
    _, flat, extra = runner.mgr.restore_flat(runner.mgr.latest())
    assert int(flat["loop0/#rows"]) == 384 and extra["loops"]["0"] == 3
    cp2 = _wc(out_of_core="force", chunk_rows=tile2)
    out = LoopRunner(cp2, str(tmp_path), every=1).run(ins, resume=True)
    assert _bitident(_wc().run(ins), out)
    assert cp2.chunker.chunks_run == -(-(1024 - 384) // tile2)


def test_kill_after_a_halving_descent_resumes(tmp_path):
    """A stream that halved its tile (256 → 128) and was then killed
    resumes at its first tile (256) from the rows the halved stream had
    folded, and within the resumed call a capacity error halves again
    from the same restored state."""
    ins = wc_inputs(n=1024)
    cp = _wc(out_of_core="force", chunk_rows=256)
    runner = LoopRunner(cp, str(tmp_path), every=1)
    with pytest.raises(F.DeterministicFault):
        with F.inject(F.FaultSpec("lower.chunk_step", "capacity", nth=2),
                      F.FaultSpec("lower.chunk_step", "deterministic",
                                  nth=6, times=10 ** 6)):
            runner.run(ins, resume=False)
    assert "chunked[256]->chunked[128]" in cp.explain_faults()
    _, flat, _ = runner.mgr.restore_flat(runner.mgr.latest())
    assert int(flat["loop0/#rows"]) == 384
    want = _wc().run(ins)
    cp2 = _wc(out_of_core="force", chunk_rows=256)
    out = LoopRunner(cp2, str(tmp_path), every=0).run(ins, resume=True)
    assert _bitident(want, out)
    assert cp2.chunker.chunks_run == 3          # rows 384, 640, 896
    cp3 = _wc(out_of_core="force", chunk_rows=256)
    with F.inject(F.FaultSpec("lower.chunk_step", "capacity", nth=2)):
        out = LoopRunner(cp3, str(tmp_path), every=0).run(ins, resume=True)
    assert _bitident(want, out)
    assert cp3.faults.level_reached == "chunked[128]"
    assert cp3.chunker.chunks_run == 1 + 5      # 256 at 384; 128 from 384


def test_a_reference_chunk_snapshot_is_refused(tmp_path):
    """The JAX package's chunk checkpoint counts chunks of a tile it does
    not record: the port refuses it rather than resume at a guessed tile
    (the reference's default is 4096 rows, the card's one range)."""
    ins = wc_inputs(n=1024)
    jcp = jax_compile(JAX_ALL["word_count"], op_select="force:scatter",
                      out_of_core="force", chunk_rows=100)
    jcp.faults.sleep = lambda s: None
    with pytest.raises(JF.DeterministicFault):
        with JF.inject(JF.FaultSpec("lower.chunk_step", "deterministic",
                                    nth=5, times=10 ** 6)):
            JaxLoopRunner(jcp, str(tmp_path), every=1).run(ins,
                                                          resume=False)
    runner = LoopRunner(_wc(out_of_core="force", chunk_rows=100),
                        str(tmp_path), every=1)
    with pytest.raises(ValueError, match="#rows"):
        runner.run(ins, resume=True)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ALL))
def test_explain_chunked_equals_the_reference(name):
    ours = compile_program(ALL[name], device="cpu").explain_chunked()
    assert ours == jax_compile(JAX_ALL[name]).explain_chunked()


@pytest.mark.parametrize("name", sorted(ALL))
def test_chunked_outputs_match_the_reference(name):
    """Every program streamed at a tile that divides no bag (7 rows) in
    both packages, on the same inputs: the reference's test tolerance."""
    ins = data_for(name)
    ours = compile_program(ALL[name], out_of_core="force", chunk_rows=7,
                           device="cpu").run(ins)
    ref = jax_compile(JAX_ALL[name], out_of_core="force",
                      chunk_rows=7).run(ins)
    _close(ours, ref)


def test_pagerank_chunked_and_stepwise_match_the_reference():
    ins = pr_inputs(steps=5.0)
    ref_c = jax_compile(JAX_ALL["pagerank"], op_select="force:scatter",
                        out_of_core="force", chunk_rows=100).run(ins)
    _close(_pr(out_of_core="force", chunk_rows=100).run(ins), ref_c)
    ref_s = jax_compile(JAX_ALL["pagerank"],
                        op_select="force:scatter").run_stepwise(ins)
    _close(_pr().run_stepwise(ins), ref_s)


# annotations stay strings (each package's parser reads its own names)
def windowed(V: bag[1], R: vector, n: dim):  # noqa: F821
    for i, v in items(V):
        R[i] = v * 2.0


def test_bag_offsets_and_limits_match_the_reference():
    """ExecContext.bag_offsets makes the bag index var global and
    bag_limits masks rows by their GLOBAL index: a window of a bag run
    through CompiledProgram.execute gives the reference's destination (a
    store keyed by the bag index var writes the window's own rows)."""
    from repro.core import parse_program as jax_parse
    r = np.random.default_rng(11)
    v = r.standard_normal(40).astype(np.float32)
    for off, rows, lim in ((0, 40, 40), (16, 24, 30), (8, 10, 12)):
        outs = []
        for parse, comp, kw in ((parse_program, compile_program,
                                 {"device": "cpu"}),
                                (jax_parse, jax_compile, {})):
            cp = comp(parse(windowed), compile_mode="eager", **kw)
            env = cp.prepare_env(dict(V=(v[off:off + rows],),
                                      R=np.zeros(40, np.float32), n=40))
            cp.execute(env, bag_offsets={"V": off}, bag_limits={"V": lim})
            outs.append(np.asarray(env["R"]))
        np.testing.assert_array_equal(outs[0], outs[1])
        want = np.zeros(40, np.float32)
        hi = min(off + rows, lim)
        want[off:hi] = v[off:hi] * 2.0
        np.testing.assert_array_equal(outs[0], want)


# ---------------------------------------------------------------------------
# the card's fold, rehearsed on the CPU
# ---------------------------------------------------------------------------

def _on_kernel(name, **kw):
    """A program whose chunk bodies pin a + group-by to the segment kernel
    ("pallas": its plain version on the CPU), as a program on the card
    does, so that its destinations fold running partials."""
    return _quiet(compile_program(ALL[name], op_select="force:pallas",
                                  device="cpu", **kw))


@pytest.mark.parametrize("name,ins", [("group_by", gb_inputs),
                                      ("word_count", wc_inputs)])
def test_running_partial_fold_is_the_all_resident_fold(monkeypatch, name,
                                                       ins):
    """The segment kernel orders a sum by ranges of RANGE_ROWS rows (the
    plain version on the CPU does too); patched down to 64 rows, a stream
    of whole ranges (64, 128, 256 rows) folds each destination's running
    partial range by range and combines it with the destination once, so
    it equals the all-resident run bit for bit, whose destination does
    NOT start at zero.  Folding each tile into the destination
    (dest ⊕ t1 ⊕ t2 …) would not."""
    monkeypatch.setattr(SR, "RANGE_ROWS", 64)
    x = ins(c0=True) if name == "group_by" else dict(
        wc_inputs(), C=np.random.default_rng(2).standard_normal(
            32).astype(np.float32))
    ref = _on_kernel(name, compile_mode="eager").run(x)
    for tile in (64, 128, 256):
        cp = _on_kernel(name, out_of_core="force", chunk_rows=tile)
        assert _bitident(ref, cp.run(x)), tile
        assert "inexact" not in cp.explain_faults()
    # the scatter backend folds straight into the destination: same bits
    sc = _quiet(compile_program(ALL[name], op_select="force:scatter",
                                device="cpu", compile_mode="eager")).run(x)
    for tile in (64, 100, 7):
        out = _quiet(compile_program(
            ALL[name], op_select="force:scatter", device="cpu",
            out_of_core="force", chunk_rows=tile)).run(x)
        assert _bitident(sc, out), tile


def test_sub_range_tiles_are_close_and_say_so(monkeypatch):
    """A tile that is not a whole number of ranges reassociates the float
    sums: within float32 rounding of the all-resident run, and the ledger
    says that it is not bit-identical."""
    monkeypatch.setattr(SR, "RANGE_ROWS", 64)
    x = gb_inputs(c0=True)
    ref = _on_kernel("group_by", compile_mode="eager").run(x)
    cp = _on_kernel("group_by", out_of_core="force", chunk_rows=100)
    out = cp.run(x)
    scale = float(ref["C"].abs().max())
    assert float((out["C"] - ref["C"]).abs().max()) <= 1e-4 * scale
    text = cp.explain_faults()
    assert "inexact" in text and "not bit-identical" in text
    assert "chunked[100]" in text


def test_running_partial_resumes_bit_identical(monkeypatch, tmp_path):
    """A chunk checkpoint carries each running partial: a stream killed
    mid-way resumes to the uninterrupted bits with fewer chunks run."""
    monkeypatch.setattr(SR, "RANGE_ROWS", 64)
    x = gb_inputs(c0=True)
    ref = _on_kernel("group_by", out_of_core="force",
                     chunk_rows=128).run(x)
    cp = _on_kernel("group_by", out_of_core="force", chunk_rows=128)
    runner = LoopRunner(cp, str(tmp_path), every=1)
    with pytest.raises(F.DeterministicFault):
        with F.inject(F.FaultSpec("lower.chunk_step", "deterministic",
                                  nth=5, times=10 ** 6)):
            runner.run(x, resume=False)
    _, flat, _ = runner.mgr.restore_flat(runner.mgr.latest())
    assert "loop0/C#partial" in flat
    cp2 = _on_kernel("group_by", out_of_core="force", chunk_rows=128)
    out = LoopRunner(cp2, str(tmp_path), every=1).run(x, resume=True)
    assert _bitident(ref, out)
    assert cp2.chunker.chunks_run < -(-1000 // 128)


def test_bags_on_the_device_are_sliced_where_they_lie():
    """Tensor inputs are read where the caller put them: the stream never
    writes the caller's destination (the runner's own copies)."""
    x = wc_inputs()
    c = torch.zeros(32)
    ins = dict(W=(torch.from_numpy(x["W"][0]),), C=c)
    out = _wc(out_of_core="force", chunk_rows=100).run(ins)
    assert torch.equal(c, torch.zeros(32))
    assert _bitident(_wc().run(wc_inputs()), out)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segment kernel has no CPU form")
    return torch.device("cuda")


def _card_gb(rng, n, k=4096):
    return dict(S=(rng.integers(-3, k + 3, n).astype(np.float32),
                   rng.standard_normal(n, dtype=np.float32)),
                C=rng.standard_normal(k, dtype=np.float32))


@pytest.mark.cuda
def test_cuda_stream_of_whole_ranges_is_bit_equal(cuda, monkeypatch):
    """group_by streamed from pinned host memory on the card, ranges
    patched down to 2^16 rows: whole-range tiles give the all-resident
    eager bits and launch the segment kernel once a range; a sub-range
    tile stays within 1e-4 and the ledger says so."""
    from repro_torch.kernels import ops
    monkeypatch.setattr(SR, "RANGE_ROWS", 2 ** 16)
    x = _card_gb(np.random.default_rng(0), 5 * 2 ** 16 + 123)
    ref = compile_program(ALL["group_by"], compile_mode="eager",
                          op_select="force:pallas").run(x)
    for tile in (2 ** 16, 2 ** 17):
        cp = compile_program(ALL["group_by"], out_of_core="force",
                             chunk_rows=tile)
        ops.reset_launch_counts()
        out = cp.run(x)
        assert ops.launch_counts()["segment_reduce"] == 6
        assert torch.equal(out["C"], ref["C"]), tile
        assert "inexact" not in cp.explain_faults()
    cp = compile_program(ALL["group_by"], out_of_core="force",
                         chunk_rows=50_000)
    out = cp.run(x)
    scale = float(ref["C"].abs().max())
    assert float((out["C"] - ref["C"]).abs().max()) <= 1e-4 * scale
    assert "not bit-identical" in cp.explain_faults()


@pytest.mark.cuda
def test_cuda_back_to_back_streams_keep_their_bits(cuda, monkeypatch):
    """Two streamed runs with no host sync between them: the second run's
    first tile copy must not land in a buffer the first run's last step
    still reads (the caching allocator hands the freed block on), so the
    FIRST run's result keeps its all-resident bits."""
    monkeypatch.setattr(SR, "RANGE_ROWS", 2 ** 20)
    rng = np.random.default_rng(3)
    xs = [_card_gb(rng, 4 * 2 ** 20 + 77) for _ in range(2)]
    ref = [compile_program(ALL["group_by"], compile_mode="eager",
                           op_select="force:pallas").run(x)["C"].clone()
           for x in xs]
    cp = compile_program(ALL["group_by"], out_of_core="force",
                         chunk_rows=2 ** 20)
    for _ in range(3):
        torch.cuda.synchronize()
        first = cp.run(xs[0])["C"]
        second = cp.run(xs[1])["C"]
        torch.cuda.synchronize()
        assert torch.equal(first, ref[0])
        assert torch.equal(second, ref[1])


@pytest.mark.cuda
def test_cuda_oom_inside_a_capture_descends_to_chunked(cuda, monkeypatch):
    """An out-of-memory error raised while whole mode captures its graphs
    ends the capture, frees the failed entry before the chunked rung
    allocates, and the call descends whole → chunked with the
    all-resident bits; the card stays usable for a later capture."""
    import gc
    from repro_torch.core import lower
    x = _card_gb(np.random.default_rng(1), 300_000)
    ref = compile_program(ALL["group_by"], compile_mode="eager",
                          op_select="force:pallas").run(x)["C"]
    run_node = lower.PlanExecutor.run_node

    def oom_in_capture(self, node, env, ctx=lower._EMPTY_CTX):
        if torch.cuda.is_current_stream_capturing():
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 1.00 GiB (inside a "
                "capture)")
        return run_node(self, node, env, ctx)

    cp = compile_program(ALL["group_by"], op_select="force:pallas")
    cp.faults.sleep = lambda s: None
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    monkeypatch.setattr(lower.PlanExecutor, "run_node", oom_in_capture)
    out = cp.run(x)["C"]
    monkeypatch.undo()
    assert torch.equal(out, ref)
    text = cp.explain_faults()
    assert cp.faults.level_reached == "chunked"
    assert "whole->chunked" in text and "out of memory" in text
    assert not cp._whole_cache and cp.trace_failures == 1
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= base + out.numel() * 4 + 2 ** 20
    again = compile_program(ALL["group_by"], op_select="force:pallas")
    assert torch.equal(again.run(x)["C"], ref) and again.trace_count == 1
