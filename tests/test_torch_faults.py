"""The fault-injection harness and the degradation ladder of the PyTorch
port, on the CPU: the port of tests/test_faults.py's backend-neutral unit
tests (run against the port's copy of core/faults.py) and its
single-device ladder.  Scripted faults at the `lower.whole_trace` and
`lower.node` sites recover bit-identically at the same level (transients),
descend whole → eager exactly once (a deterministic fault with a level left
below it), surface (a deterministic fault at every level), or reach the
interpreter (a transient that persists); a failed signature sits out its
disable ttl alone and is re-attempted after it.  Where a schedule is
deterministic, the port's ledger text equals the JAX package's, both with
out_of_core="off" and with "auto" (where a capacity error descends to the
chunked rung).  Mid-loop checkpoint/resume rides the same harness: a
SeqLoop run by `run_stepwise` under `runtime.LoopRunner` and killed at
iteration k resumes bit-identically.
"""
import numpy as np
import pytest
import torch

from repro.core import compile_program as jax_compile
from repro.core import faults as JF
from repro.core.programs import ALL as JAX_ALL
from repro_torch.core import compile_program, interpret
from repro_torch.core import faults as F
from repro_torch.core import plan as P
from repro_torch.core.programs import ALL
from repro_torch.runtime import LoopRunner
from test_core_programs import data_for


def _fresh(ins):
    out = {}
    for k, v in ins.items():
        if isinstance(v, tuple):
            out[k] = tuple(np.array(c) for c in v)
        elif isinstance(v, np.ndarray):
            out[k] = v.copy()
        else:
            out[k] = v
    return out


def _quiet(cp):
    cp.faults.sleep = lambda s: None        # no real backoff sleeps
    return cp


def _bitident(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# harness unit behaviour
# ---------------------------------------------------------------------------

def test_unknown_site_rejected():
    with pytest.raises(ValueError, match="unknown injection site"):
        F.FaultSpec("no.such.site")


def test_unknown_kind_rejected():
    with pytest.raises(ValueError, match="unknown fault kind"):
        F.FaultSpec("lower.node", "flaky")


def test_site_is_noop_without_injector():
    F.site("lower.node", node="MapExpr")     # must not raise or record
    assert F.active() is None


def test_nth_hit_counting():
    with F.inject(F.FaultSpec("lower.node", "transient", nth=3)) as inj:
        for _ in range(2):
            F.site("lower.node")
        with pytest.raises(F.TransientFault):
            F.site("lower.node")
        F.site("lower.node")                 # hit 4: spec exhausted
    assert inj.hits["lower.node"] == 4
    assert [f["hit"] for f in inj.fired] == [3]


def test_classify():
    assert F.classify(F.TransientFault("x")) == "transient"
    assert F.classify(F.CapacityFault("x")) == "capacity"
    assert F.classify(F.DeterministicFault("x")) == "deterministic"
    assert F.classify(MemoryError()) == "capacity"
    assert F.classify(RuntimeError("RESOURCE_EXHAUSTED: oom")) == "capacity"
    assert F.classify(RuntimeError("UNAVAILABLE: peer reset")) == "transient"
    assert F.classify(RuntimeError("DEADLINE_EXCEEDED")) == "transient"
    # the safe default: unknown errors must never be retried forever
    assert F.classify(ValueError("bad user input")) == "deterministic"


def test_classify_real_oom_messages():
    """Allocator messages of CUDA and torch (and of XLA): every one reads
    as capacity, and torch's own OutOfMemoryError does by its type."""
    real = [
        "RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
        "75497472 bytes.",
        "RESOURCE_EXHAUSTED: Ran out of memory in memory space hbm. "
        "Used 33.61G of 15.48G hbm. Exceeded hbm capacity by 18.13G.",
        "Resource exhausted: Out of memory while trying to allocate "
        "4294967296 bytes.",
        "CUDA_ERROR_OUT_OF_MEMORY: out of memory",
        "CUDA out of memory. Tried to allocate 20.00 MiB",
        "INTERNAL: Failed to allocate 1073741824 bytes",
    ]
    for msg in real:
        assert F.classify(RuntimeError(msg)) == "capacity", msg
    assert F.classify(torch.cuda.OutOfMemoryError("")) == "capacity"

    class XlaRuntimeError(RuntimeError):
        pass

    assert F.classify(XlaRuntimeError("RESOURCE_EXHAUSTED: oom")) \
        == "capacity"
    assert F.classify(XlaRuntimeError("INTERNAL: unknown")) \
        == "deterministic"
    # word-boundary matching: "bloom"/"BOOM" must NOT read as OOM
    assert F.classify(RuntimeError("bloom filter rebuild failed")) \
        == "deterministic"
    assert F.classify(RuntimeError("BOOM")) == "deterministic"
    assert F.classify(RuntimeError("device OOM during fusion")) \
        == "capacity"


def test_run_with_retries_bounded_backoff():
    ledger = F.FaultLedger("t")
    sleeps = []
    attempts = []

    def fn():
        attempts.append(1)
        raise F.TransientFault("UNAVAILABLE")

    with pytest.raises(F.TransientFault):
        F.run_with_retries(fn, policy=F.RetryPolicy(max_retries=3,
                                                    backoff_s=0.01),
                           ledger=ledger, label="x", sleep=sleeps.append)
    assert len(attempts) == 4                # 1 initial + 3 retries
    assert sleeps == [0.01, 0.02, 0.04]      # exponential, recorded
    assert ledger.counters["retry"] == 3


def test_run_with_retries_never_retries_deterministic():
    ledger = F.FaultLedger("t")
    attempts = []

    def fn():
        attempts.append(1)
        raise F.DeterministicFault("user error")

    with pytest.raises(F.DeterministicFault):
        F.run_with_retries(fn, policy=F.RetryPolicy(), ledger=ledger,
                           label="x", sleep=lambda s: None)
    assert len(attempts) == 1 and ledger.counters["retry"] == 0


def test_straggler_watchdog_trailing_median():
    ledger = F.FaultLedger("t")
    for _ in range(5):
        ledger.note_time("round", 0.01)
    ledger.note_time("round", 0.2)           # 20x the trailing median
    assert ledger.counters["straggler"] == 1
    assert "straggler" in ledger.explain()


# ---------------------------------------------------------------------------
# single-device ladder matrix: site x kind x mode on three programs
# ---------------------------------------------------------------------------

PROGRAMS = ("pagerank", "group_by", "kmeans_step")
# the sites on each mode's path (eager builds no whole-program entry)
SITE_MODES = [("lower.whole_trace", "whole"), ("lower.node", "whole"),
              ("lower.node", "eager")]


def _cp(name, **kw):
    return _quiet(compile_program(ALL[name], device="cpu", **kw))


@pytest.mark.parametrize("name", PROGRAMS)
@pytest.mark.parametrize("site,mode", SITE_MODES)
def test_transient_recovers_bitidentical(name, site, mode):
    """A transient fault at any site is retried at the SAME ladder level:
    the re-attempt runs the identical computation, so recovery is
    bit-identical to the fault-free run of the same mode."""
    ins = data_for(name)
    ref = _cp(name, compile_mode=mode).run(_fresh(ins))
    cp = _cp(name, compile_mode=mode)
    with F.inject(F.FaultSpec(site, "transient", nth=1)) as inj:
        out = cp.run(_fresh(ins))
    assert inj.fired, "spec never fired"
    assert _bitident(out, ref)
    assert cp.faults.counters["retry"] >= 1
    assert cp.faults.counters["recover"] >= 1
    assert cp.faults.counters["descend"] == 0


@pytest.mark.parametrize("name", PROGRAMS)
@pytest.mark.parametrize("site", ("lower.whole_trace", "lower.node"))
def test_deterministic_descends_whole_to_eager(name, site):
    """A deterministic fault inside the whole-program attempt gets its ONE
    ladder descent: the eager level absorbs it, and the result is
    bit-identical to a fault-free EAGER run."""
    ins = data_for(name)
    ref = _cp(name, compile_mode="eager").run(_fresh(ins))
    cp = _cp(name)
    with F.inject(F.FaultSpec(site, "deterministic", nth=1)) as inj:
        out = cp.run(_fresh(ins))
    assert inj.fired
    assert _bitident(out, ref)
    assert cp.faults.counters["descend"] == 1
    assert cp.faults.level_reached == "eager"
    assert cp.trace_failures == 1 and cp._whole_disabled


@pytest.mark.parametrize("name", PROGRAMS)
@pytest.mark.parametrize("mode", ("whole", "eager"))
def test_deterministic_forever_surfaces(name, mode):
    """A deterministic error that reproduces at every level SURFACES after
    at most one ladder descent — never an infinite retry, and never the
    interpreter oracle (which would silently mask a user error)."""
    cp = _cp(name, compile_mode=mode)
    with F.inject(F.FaultSpec("lower.node", "deterministic", nth=1,
                              times=10 ** 6)):
        with pytest.raises(F.DeterministicFault):
            cp.run(_fresh(data_for(name)))
    assert cp.faults.counters["descend"] <= 1
    assert cp.faults.level_reached != "interp"


@pytest.mark.parametrize("mode", ("whole", "eager"))
def test_persistent_transient_reaches_interp_oracle(mode):
    """Transients that persist past the bounded retries descend all the
    way to the interpreter oracle — correct float64 results, returned as
    the port's tensors (allclose, not bit-identical; the ledger says the
    level was reached)."""
    name = "group_by"
    ins = data_for(name)
    ref = interpret(ALL[name].program,
                    {k: (np.array(v, np.float64)
                         if isinstance(v, np.ndarray) else v)
                     for k, v in _fresh(ins).items()})
    cp = _cp(name, compile_mode=mode)
    with F.inject(F.FaultSpec("lower.node", "transient", nth=1,
                              times=10 ** 6)):
        out = cp.run(_fresh(ins))
    np.testing.assert_allclose(out["C"].numpy().astype(np.float64),
                               np.asarray(ref["C"], np.float64),
                               rtol=1e-5, atol=1e-6)
    assert isinstance(out["C"], torch.Tensor)
    assert cp.faults.level_reached == "interp"
    assert cp.faults.counters["retry"] >= cp.policy.max_retries


# ---------------------------------------------------------------------------
# per-signature whole-program disable
# ---------------------------------------------------------------------------

def test_whole_disable_is_per_signature():
    """A failed entry for one input signature does not disable
    whole-program mode for other signatures."""
    cp = _cp("group_by")
    small = data_for("group_by")
    big = dict(small)
    big["S"] = (np.concatenate([small["S"][0]] * 2),
                np.concatenate([small["S"][1]] * 2))
    with F.inject(F.FaultSpec("lower.whole_trace", "deterministic", nth=1)):
        cp.run(_fresh(small))                # signature A: build fails
    assert cp.trace_failures == 1 and len(cp._whole_bad) == 1
    cp.run(_fresh(big))                      # signature B: builds fine
    assert cp.trace_count == 1
    assert len(cp._whole_bad) == 1           # A still sitting out its ttl


def test_whole_disable_expires_and_retraces():
    """The per-signature disable is a bounded sit-out: after `disable_ttl`
    eager runs the entry is built again (and succeeds once the fault is
    gone), with the probes counting it."""
    cp = _cp("group_by")
    cp.policy.disable_ttl = 2
    ins = data_for("group_by")
    with F.inject(F.FaultSpec("lower.whole_trace", "deterministic", nth=1)):
        cp.run(_fresh(ins))
    assert cp._whole_disabled and cp.trace_count == 0
    ref = cp.run(_fresh(ins))                # ttl 2 -> 1 (eager)
    cp.run(_fresh(ins))                      # ttl expires -> re-built
    assert cp.trace_count == 1 and cp.whole_retries == 1
    assert not cp._whole_disabled
    out = cp.run(_fresh(ins))                # whole-program again, cached
    assert cp.cache_hits >= 1
    assert _bitident(out, ref)


def test_explain_faults_renders_ledger():
    cp = _cp("pagerank")
    ins = data_for("pagerank")
    with F.inject(F.FaultSpec("lower.whole_trace", "transient", nth=1)):
        cp.run(_fresh(ins))
    text = cp.explain_faults()
    assert "== fault ledger: pagerank ==" in text
    assert "retries=1 descents=0 recoveries=1" in text
    assert "retry" in text and "[whole]" in text
    assert "whole-program: 0 trace failures" in text


# ---------------------------------------------------------------------------
# the ledger text against the JAX package's, schedule by schedule
# ---------------------------------------------------------------------------

# (site, kind, nth, times, mode): one scripted schedule, then three clean
# runs of the same signature (the ttl, its expiry and the cache).  Both
# packages run with out_of_core="off", where a capacity error descends
# whole → eager → interp, and with "auto", where it descends to the chunked
# rung (and a capacity error at every node halves the tile down to 1 row
# and surfaces: both packages raise the same error)
SCHEDULES = [
    ("lower.whole_trace", "capacity", 1, 1, "whole"),
    ("lower.node", "capacity", 1, 10 ** 6, "whole"),
    ("lower.whole_trace", "transient", 1, 1, "whole"),
    ("lower.whole_trace", "deterministic", 1, 1, "whole"),
    ("lower.whole_trace", "transient", 1, 3, "whole"),
    ("lower.node", "transient", 1, 1, "whole"),
    ("lower.node", "deterministic", 1, 1, "whole"),
    ("lower.node", "deterministic", 2, 1, "whole"),
    ("lower.node", "transient", 1, 10 ** 6, "eager"),
]


def _ledger(pkg, cp, ins, spec):
    site, kind, nth, times, _ = spec
    cp.faults.sleep = lambda s: None
    cp.policy.disable_ttl = 2
    raised = None
    with pkg.inject(pkg.FaultSpec(site, kind, nth=nth, times=times)):
        try:
            cp.run(_fresh(ins))
        except pkg.FaultError as ex:
            raised = f"{type(ex).__name__}: {ex}"
    for _ in range(3):
        cp.run(_fresh(ins))
    return cp.explain_faults(), cp.explain().splitlines()[-1], raised


def _schedule_id(s):
    return "-".join(map(str, s[:3])) + f"x{s[3]}-{s[4]}"


@pytest.mark.parametrize("name", ("group_by", "word_count", "pagerank"))
@pytest.mark.parametrize(
    "spec,out_of_core",
    [(s, "off") for s in SCHEDULES] + [(s, "auto") for s in SCHEDULES],
    ids=[_schedule_id(s) for s in SCHEDULES]
    + [_schedule_id(s) + "-auto" for s in SCHEDULES])
def test_ledger_text_equals_the_reference(name, spec, out_of_core):
    ins = data_for(name)
    mode = spec[4]
    ours = _ledger(F, compile_program(ALL[name], compile_mode=mode,
                                      out_of_core=out_of_core, device="cpu"),
                   ins, spec)
    ref = _ledger(JF, jax_compile(JAX_ALL[name], compile_mode=mode,
                                  out_of_core=out_of_core), ins, spec)
    assert ours == ref
    if spec[1] == "capacity" and out_of_core == "off":
        assert "chunked" not in ours[0]
    if spec[1] == "capacity" and out_of_core == "auto":
        assert "whole->chunked" in ours[0]


# ---------------------------------------------------------------------------
# mid-loop checkpoint/resume
# ---------------------------------------------------------------------------

def test_seq_loops_numbering():
    cp = compile_program(ALL["pagerank"], device="cpu")
    loops = P.seq_loops(cp.plan)
    assert loops and all(isinstance(n, P.SeqLoop) for _, n in loops)
    assert [i for i, _ in loops] == list(range(len(loops)))


@pytest.mark.parametrize("every", (1, 2))
def test_midloop_kill_resumes_bitidentical(every, tmp_path):
    """An iterative plan killed at iteration k resumes from the latest
    carry snapshot with BIT-IDENTICAL final outputs vs an uninterrupted
    stepwise run — whether every iteration was snapshotted or only every
    other one."""
    ins = data_for("pagerank")
    ins["num_steps"] = 6.0
    cp = _cp("pagerank")
    assert P.seq_loops(cp.plan), "pagerank must have a top-level SeqLoop"
    ref = cp.run_stepwise(_fresh(ins))
    runner = LoopRunner(cp, str(tmp_path / "ck"), every=every)
    with F.inject(F.FaultSpec("lower.loop_iter", "deterministic", nth=4,
                              message="kill -9")):
        with pytest.raises(F.DeterministicFault):
            runner.run(_fresh(ins), resume=False)
    at_kill = runner.mgr.latest()
    assert at_kill is not None and runner.saves >= 1
    resumed = LoopRunner(cp, str(tmp_path / "ck"), every=every)
    out = resumed.run(_fresh(ins), resume=True)
    assert resumed.resumed_from == at_kill
    assert _bitident(out, ref)


def test_stepwise_matches_run_bitwise():
    """In the port a stepwise run and run() execute the same host loop on
    the same nodes: the same bits, eager and whole mode (the reference's
    differ within float tolerance: a host loop against lax.while_loop) —
    and a stepwise run repeats itself exactly."""
    ins = data_for("pagerank")
    a = _cp("pagerank").run_stepwise(_fresh(ins))
    assert _bitident(a, _cp("pagerank", compile_mode="eager").run(
        _fresh(ins)))
    assert _bitident(a, _cp("pagerank").run(_fresh(ins)))
    assert _bitident(a, _cp("pagerank").run_stepwise(_fresh(ins)))


@pytest.mark.parametrize("name", ("pagerank", "group_by", "kmeans_step"))
def test_stepwise_matches_the_reference(name):
    """The port's run_stepwise against the JAX package's on the same
    inputs, with an observer that sees every iteration's carry."""
    ins = data_for(name)
    seen, jseen = [], []
    ours = _cp(name).run_stepwise(
        _fresh(ins), observer=lambda li, it, c: seen.append((li, it)))
    ref = jax_compile(JAX_ALL[name]).run_stepwise(
        _fresh(ins), observer=lambda li, it, c: jseen.append((li, it)))
    assert seen == jseen
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy().astype(np.float64),
                                   np.asarray(ref[k], np.float64),
                                   rtol=2e-3, atol=1e-4, err_msg=k)
