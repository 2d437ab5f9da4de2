"""Whole-program compilation in the PyTorch port: CompiledProgram.run()
builds ONE cached entry per (static dims, shapes, dtypes) signature — CUDA
graphs captured from the eager plan on the card; on the CPU the same entry
runs its regions eagerly into its static buffers — and replays it on every
later call, with the per-node eager path as the fallback.

The port of tests/test_whole_program.py (whole == eager on every program,
the compile-cache keying contract, the explain line), plus the port's whole
run() against the JAX package's on the same seeded numpy inputs, the
`whole-program:` line equal to the reference's for one call sequence, and
the regions and host loop of a SeqLoop (pagerank's body, zero iterations,
nested loops), the inputs an entry does not stage (those no run reads) and
the bound on the entries a program keeps.  Donation (`donate=True`): the
ports of the reference's two donation tests (results unchanged, the donated
tensor consumed, SeqLoop carries, numpy inputs safe on repeat), donated
bits equal to whole mode's on every program, the feed-back pattern (the
caller hands back what the last call returned) copying no byte of a
donated name in or out, an output the caller holds never overwritten,
`donate=on` on the explain line as in the reference's, and memest's donate
credit equal to the reference's.

Tests marked `cuda` run on the card (the capture itself) and skip here;
they need no jax, so the card's machine runs them alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_whole_program.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

try:
    from repro.core import compile_program as jax_compile
    from repro.core import parse_program as jax_parse
    from repro.core.programs import ALL as JAX_ALL
    from test_core_programs import data_for
except ImportError:     # the card's machine: only the `cuda` tests run there
    pass
from repro_torch.core import compile_program, parse_program
from repro_torch.core import graphs as G
from repro_torch.core.programs import ALL
from repro_torch.kernels import ops

RTOL, ATOL = 2e-3, 1e-4          # tests/test_core_programs.py's


def _fresh(ins):
    """Deep-copy an input dict (runs must not share buffers)."""
    out = {}
    for k, v in ins.items():
        if isinstance(v, tuple):
            out[k] = tuple(np.array(c) for c in v)
        elif isinstance(v, np.ndarray):
            out[k] = v.copy()
        else:
            out[k] = v
    return out


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _check_equal(a, b, names, rtol=1e-5, atol=1e-6):
    for k in names:
        np.testing.assert_allclose(np.asarray(_np(a[k]), np.float64),
                                   np.asarray(_np(b[k]), np.float64),
                                   rtol=rtol, atol=atol, err_msg=k)


def _bits_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in b)


def _entry(cp):
    (entry, _), = cp._whole_cache.values()
    return entry


# ---------------------------------------------------------------------------
# whole == eager on every benchmark program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ALL))
def test_whole_equals_eager(name):
    ins = data_for(name)
    whole = compile_program(ALL[name], device="cpu")
    eager = compile_program(ALL[name], compile_mode="eager", device="cpu")
    out_w = whole.run(_fresh(ins))
    out_e = eager.run(_fresh(ins))
    _check_equal(out_w, out_e, out_w)
    # the same nodes ran on the same values: the same bits
    assert _bits_equal(out_w, out_e)
    # the whole-program path actually ran (no silent eager fallback) …
    assert whole.trace_count == 1 and not whole._whole_disabled
    # … and the eager configuration never built an entry
    assert eager.trace_count == 0


@pytest.mark.parametrize("name", sorted(ALL))
def test_whole_equals_the_reference_whole_run(name):
    ins = data_for(name)
    ours = compile_program(ALL[name], device="cpu").run(_fresh(ins))
    ref = jax_compile(JAX_ALL[name]).run(_fresh(ins))
    _check_equal(ours, ref, ref, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# compile-cache keying
# ---------------------------------------------------------------------------

def test_identical_shapes_hit_the_cache():
    ins = data_for("word_count")
    cp = compile_program(ALL["word_count"], device="cpu")
    a = cp.run(_fresh(ins))
    b = cp.run(_fresh(ins))
    assert cp.trace_count == 1 and cp.cache_hits == 1
    _check_equal(a, b, a)


def test_different_bag_length_retraces():
    rng = np.random.default_rng(0)
    cp = compile_program(ALL["word_count"], device="cpu")
    ref = compile_program(ALL["word_count"], compile_mode="eager",
                          device="cpu")
    for n in (50, 80):                   # different N ⇒ new signature
        ins = dict(W=rng.integers(0, 10, n).astype(np.float64),
                   C=np.zeros(10))
        _check_equal(cp.run(_fresh(ins)), ref.run(_fresh(ins)), ["C"])
    assert cp.trace_count == 2 and cp.cache_hits == 0


def test_different_dtype_retraces():
    # bag columns keep their dtype: an int32 key column and a float32 one
    # are DIFFERENT signatures (float64 inputs canonicalise to float32 and
    # share one)
    rng = np.random.default_rng(1)
    cp = compile_program(ALL["word_count"], device="cpu")
    keys = rng.integers(0, 10, 32)
    rf = cp.run(dict(W=keys.astype(np.float32), C=np.zeros(10)))
    ri = cp.run(dict(W=keys.astype(np.int32), C=np.zeros(10)))
    assert cp.trace_count == 2            # bag dtype is part of the key
    np.testing.assert_allclose(_np(rf["C"]), _np(ri["C"]), rtol=1e-5)


def test_different_dims_retrace():
    rng = np.random.default_rng(2)
    cp = compile_program(ALL["matrix_addition"], device="cpu")
    for n in (4, 7):                     # dims are static: shapes differ
        M = rng.standard_normal((n, 3))
        out = cp.run(dict(M=M, N=M, R=np.zeros((n, 3)), n=n, m=3))
        np.testing.assert_allclose(_np(out["R"]), 2 * M, rtol=1e-5)
    assert cp.trace_count == 2


def test_explain_reports_compile_cache():
    ins = data_for("group_by")
    cp = compile_program(ALL["group_by"], device="cpu")
    cp.run(_fresh(ins))
    cp.run(_fresh(ins))
    text = cp.explain()
    assert "whole-program: mode=whole, 1 traced, 1 cache hits" in text
    text_e = compile_program(ALL["group_by"], compile_mode="eager",
                             device="cpu").explain()
    assert "whole-program: mode=eager" in text_e


def test_explain_line_equals_the_reference():
    # same shape twice, then a new bag length: 2 traced, 1 cache hit
    rng = np.random.default_rng(3)
    ours = compile_program(ALL["word_count"], device="cpu")
    ref = jax_compile(JAX_ALL["word_count"])
    for n in (40, 40, 64):
        ins = dict(W=rng.integers(0, 10, n).astype(np.float64),
                   C=np.zeros(10))
        ours.run(_fresh(ins))
        ref.run(_fresh(ins))
        assert ours.explain().splitlines()[-1] == \
            ref.explain().splitlines()[-1]
    assert ours.explain().splitlines()[-1] == \
        "whole-program: mode=whole, 2 traced, 1 cache hits"


# ---------------------------------------------------------------------------
# inputs and outputs: the entry's own buffers
# ---------------------------------------------------------------------------

def test_caller_tensors_are_neither_adopted_nor_written():
    ins = data_for("pagerank")
    cp = compile_program(ALL["pagerank"], device="cpu")
    t_ins = {k: (tuple(torch.from_numpy(np.array(c, np.float32)) for c in v)
                 if isinstance(v, tuple) else
                 torch.from_numpy(np.array(v, np.float32))
                 if isinstance(v, np.ndarray) else v)
             for k, v in ins.items()}
    before = {k: v.clone() for k, v in t_ins.items()
              if isinstance(v, torch.Tensor)}
    a = cp.run(t_ins)
    kept = {k: v.clone() for k, v in a.items()}
    b = cp.run(t_ins)
    for k, v in before.items():
        assert torch.equal(t_ins[k], v), k
    # a later call writes the entry's buffers, never an earlier result
    for k in a:
        assert torch.equal(a[k], kept[k]) and torch.equal(a[k], b[k]), k
        assert not any(G._shares(a[k], x) for x in t_ins.values()
                       if isinstance(x, torch.Tensor))
    assert cp.cache_hits == 1


@pytest.mark.parametrize("name", sorted(ALL))
def test_a_later_call_reads_its_own_inputs(name):
    # a cache hit copies in every input that a run reads: a stale buffer,
    # or a stand-in that some node reads after all, would differ from eager
    first, later = data_for(name), data_for(name)
    for k, v in later.items():
        if isinstance(v, np.ndarray) and np.array_equal(v, first[k]):
            later[k] = v + 1.0
    whole = compile_program(ALL[name], device="cpu")
    whole.run(_fresh(first))
    out_w = whole.run(_fresh(later))
    out_e = compile_program(ALL[name], compile_mode="eager",
                            device="cpu").run(_fresh(later))
    assert _bits_equal(out_w, out_e)
    assert whole.trace_count == 1 and whole.cache_hits == 1


@pytest.mark.parametrize("name, unread", [
    ("kmeans_step", {"D", "NX", "NY"}), ("matrix_addition", {"R"}),
    ("matrix_multiplication", {"R"}), ("pagerank", set()),
    ("group_by", set())])
def test_inputs_no_run_reads_are_neither_copied_nor_held(name, unread):
    # the first node that names D, NX, NY or R is a store that replaces it
    # whole: the entry holds a stand-in without memory for it
    cp = compile_program(ALL[name], device="cpu")
    cp.run(_fresh(data_for(name)))
    entry = _entry(cp)
    assert entry.unread == unread
    for k in unread:
        buf = entry.inputs[k]
        assert buf.untyped_storage().nbytes() == buf.element_size()
    for k, buf in entry.inputs.items():
        if k not in unread and isinstance(buf, torch.Tensor) and buf.dim():
            assert buf.untyped_storage().nbytes() > buf.element_size(), k


def test_the_cache_keeps_the_latest_signatures():
    # a few entries at most, the least recently used evicted and freed
    import weakref
    from repro_torch.core.lower import WHOLE_ENTRIES
    assert WHOLE_ENTRIES == 2
    ins = {n: data_for("word_count") for n in ("a", "b", "c")}
    ins["b"]["W"] = ins["b"]["W"][:30]
    ins["c"]["W"] = ins["c"]["W"][:20]
    cp = compile_program(ALL["word_count"], device="cpu")
    eager = compile_program(ALL["word_count"], compile_mode="eager",
                            device="cpu")
    cp.run(_fresh(ins["a"]))
    cp.run(_fresh(ins["b"]))
    first, second = (e for e, _ in cp._whole_cache.values())
    assert _bits_equal(cp.run(_fresh(ins["a"])), eager.run(_fresh(ins["a"])))
    assert cp.trace_count == 2 and cp.cache_hits == 1
    buf = weakref.ref(second.inputs["W"][0])
    cp.run(_fresh(ins["c"]))         # evicts b's entry, the least recent
    assert cp.trace_count == 3 and len(cp._whole_cache) == WHOLE_ENTRIES
    assert [e for e, _ in cp._whole_cache.values()][0] is first
    assert buf() is None and second.inputs == {} and second.items == []
    assert _bits_equal(cp.run(_fresh(ins["b"])), eager.run(_fresh(ins["b"])))
    assert cp.trace_count == 4


@pytest.mark.parametrize("mode", ["whole", "eager", "donate"])
def test_a_run_leaves_no_reference_cycle(mode):
    # a run's values, and a dropped program's entry, are freed when the
    # last reference goes, not when the cyclic garbage collector runs
    import gc
    import weakref
    ins = data_for("pagerank")
    gc.disable()
    try:
        cp = compile_program(ALL["pagerank"], device="cpu",
                             compile_mode="eager" if mode == "eager"
                             else "whole", donate=mode == "donate")
        out = cp.run(_fresh(ins))
        ref = weakref.ref(out["P"])
        del out
        assert ref() is None
        if mode != "eager":
            ref = weakref.ref(_entry(cp))
        del cp
        assert ref() is None
    finally:
        gc.enable()


def test_a_failed_entry_is_freed(monkeypatch):
    # the exception a failed build leaves in `_last_whole_exc` keeps no
    # frame, so nothing of the failed entry outlives the call
    import gc
    import weakref
    from repro_torch.core import faults as F
    built = []
    init = G.Entry.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        built.append(weakref.ref(self))
    monkeypatch.setattr(G.Entry, "__init__", record)
    cp = compile_program(ALL["pagerank"], device="cpu")
    gc.disable()
    try:
        with F.inject(F.FaultSpec("lower.node", "deterministic", nth=2)):
            cp.run(_fresh(data_for("pagerank")))
        assert cp.trace_failures == 1 and cp._last_whole_exc is not None
        assert len(built) == 1 and built[0]() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# SeqLoop: regions, the host loop, zero iterations
# ---------------------------------------------------------------------------

def test_pagerank_loop_body_is_its_own_region():
    ins = data_for("pagerank")
    cp = compile_program(ALL["pagerank"], device="cpu")
    cp.run(_fresh(ins))
    entry = _entry(cp)
    pre, (loop, (body,)) = entry.items
    assert isinstance(pre, G._Region) and isinstance(loop, G._Loop)
    assert pre.enter is loop and [type(n).__name__ for n in pre.nodes] \
        == ["SegmentReduce"]
    assert isinstance(body, G._Region) and body.back is loop
    assert set(loop.carry) == {"steps", "NP", "P"}
    assert entry.graphs == 2
    # one flag read an iteration, and one for the exit
    assert entry.syncs == int(ins["num_steps"]) + 1


@pytest.mark.parametrize("steps", [0.0, 1.0, 4.0])
def test_seq_loop_iterations_including_zero(steps):
    ins = data_for("pagerank")
    ins["num_steps"] = steps
    cp = compile_program(ALL["pagerank"], device="cpu")
    eager = compile_program(ALL["pagerank"], compile_mode="eager",
                            device="cpu")
    for _ in range(2):                   # the capture, then a replay
        out = cp.run(_fresh(ins))
        assert _bits_equal(out, eager.run(_fresh(ins)))
        assert float(out["steps"]) == steps
        assert _entry(cp).syncs == int(steps) + 1
    ref = jax_compile(JAX_ALL["pagerank"]).run(_fresh(ins))
    _check_equal(out, ref, ref, rtol=RTOL, atol=ATOL)


def nested_loops(V: vector, W: vector, n: dim, i: scalar, j: scalar,
                 k: scalar, m: scalar, S: scalar, T: scalar):
    T += 1.0
    while i < k:
        i += 1.0
        j = 0.0
        while j < m:
            j += 1.0
            S += j
            for q in range(0, n):
                V[q] = V[q] * 0.5 + W[q]
        for q in range(0, n):
            W[q] = W[q] + 1.0
    T += S


@pytest.mark.parametrize("k", [0.0, 1.0, 3.0])
def test_nested_loops(k):
    ours_p, ref_p = parse_program(nested_loops), jax_parse(nested_loops)
    rng = np.random.default_rng(4)
    ins = dict(V=rng.standard_normal(5), W=rng.standard_normal(5), n=5,
               i=0.0, j=0.0, k=k, m=2.0, S=0.0, T=0.0)
    cp = compile_program(ours_p, device="cpu")
    eager = compile_program(ours_p, compile_mode="eager", device="cpu")
    for _ in range(2):
        out = cp.run(_fresh(ins))
        assert _bits_equal(out, eager.run(_fresh(ins)))
    entry = _entry(cp)
    # before the outer loop; before the inner loop; the inner body; after
    # the inner loop; after the outer loop
    assert entry.graphs == 5
    assert entry.syncs == 1 + int(k) * (1 + 2 + 1)
    ref = jax_compile(ref_p).run(_fresh(ins))
    _check_equal(out, ref, ref, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# buffer donation (mutated destinations + SeqLoop carries)
# ---------------------------------------------------------------------------

def _tensors(ins, device="cpu"):
    """The inputs as tensors on `device` in their canonical dtypes."""
    from repro_torch.convert import inputs_from_numpy
    return inputs_from_numpy(_fresh(ins), device)


def test_donation_results_unchanged_and_buffer_freed():
    ins = data_for("word_count")
    ref = compile_program(ALL["word_count"], compile_mode="eager",
                          device="cpu").run(_fresh(ins))
    cp = compile_program(ALL["word_count"], donate=True, device="cpu")
    c_in = torch.zeros(10, dtype=torch.float32)   # dest buffer, on-device
    out = cp.run(dict(W=ins["W"].copy(), C=c_in))
    _check_equal(out, ref, ["C"])
    # the destination tensor was donated to the call and consumed
    assert c_in.numel() == 0


def test_donation_seq_loop_carries():
    ins = data_for("pagerank")
    ref = compile_program(ALL["pagerank"], compile_mode="eager",
                          device="cpu").run(_fresh(ins))
    cp = compile_program(ALL["pagerank"], donate=True, device="cpu")
    p_in = torch.full((10,), 0.1, dtype=torch.float32)   # loop carry
    fresh = _fresh(ins)
    fresh["P"] = p_in
    out = cp.run(fresh)
    _check_equal(out, ref, out)
    assert p_in.numel() == 0
    # numpy inputs are copied in per call: donation stays safe on repeat
    # runs with fresh buffers
    out2 = cp.run(_fresh(ins))
    _check_equal(out2, ref, out2)
    assert cp.trace_count == 1 and cp.cache_hits == 1


@pytest.mark.parametrize("name", sorted(ALL))
def test_donated_bits_equal_whole_mode(name):
    ins = data_for(name)
    want = compile_program(ALL[name], device="cpu").run(_fresh(ins))
    cp = compile_program(ALL[name], donate=True, device="cpu")
    assert _bits_equal(cp.run(_fresh(ins)), want)
    assert _bits_equal(cp.run(_tensors(ins)), want)
    assert cp.trace_count == 1 and cp.cache_hits == 1


@pytest.mark.parametrize("name", ["kmeans_step", "pagerank", "word_count",
                                  "matrix_addition"])
def test_feed_back_copies_no_donated_byte(name):
    # the caller hands back what the last call returned: the values lie in
    # the entry's buffers already, and the outputs are those buffers
    ins = data_for(name)
    whole = compile_program(ALL[name], device="cpu")
    cp = compile_program(ALL[name], donate=True, device="cpu")
    first = cp.run(_fresh(ins))
    entry = _entry(cp)
    staged, cloned = entry.staged_bytes, entry.cloned_bytes
    before = dict(entry.staged)
    assert cloned == 0
    nxt = _tensors(ins)
    nxt.update(first)
    held = dict(first)
    want = whole.run(dict(_tensors(ins), **whole.run(_fresh(ins))))
    out = cp.run(nxt)
    assert _bits_equal(out, want)
    donated = set(first)
    rest = sum(t.nbytes for k, v in nxt.items() if k not in donated
               and k not in entry.unread
               for t in (v if isinstance(v, tuple) else (v,))
               if isinstance(t, torch.Tensor))
    assert entry.staged_bytes - staged == rest
    assert all(entry.staged[k] == before[k] for k in donated)
    assert entry.cloned_bytes == 0 and entry.rebinds == 0
    for k, v in held.items():               # consumed
        assert v.numel() == 0, k
    for k, v in out.items():                # the entry's own buffers
        assert G._is_view_of(v, entry.inputs[k]), k


def test_a_held_output_is_never_overwritten():
    # every call has other inputs, so an overwrite would change the values
    # held: the outputs themselves, a view of one and a numpy array on one
    cp = compile_program(ALL["pagerank"], donate=True, device="cpu")
    whole = compile_program(ALL["pagerank"], device="cpu")
    kept = []
    for i in range(4):
        ins = data_for("pagerank")
        out = cp.run(_fresh(ins))           # the previous outputs are held
        assert _bits_equal(out, whole.run(_fresh(ins)))
        held = (out, out["P"][2:5], out["P"].numpy())
        kept.append((held, {k: v.clone() for k, v in out.items()}))
    for (out, view, arr), copy in kept:
        assert _bits_equal(out, copy)
        assert torch.equal(view, copy["P"][2:5])
        np.testing.assert_array_equal(arr, copy["P"].numpy())
    # on the CPU the entry moved to fresh buffers: nothing was copied out
    # and there are no graphs to capture again
    entry = _entry(cp)
    assert entry.rebinds == 0 and entry.cloned_bytes == 0
    # numpy outputs held across the feed-back of another name's output
    a = cp.run(_fresh(data_for("pagerank")))["P"].numpy()
    snap = a.copy()
    cp.run(_fresh(data_for("pagerank")))
    np.testing.assert_array_equal(a, snap)


def test_explain_line_with_donation_equals_the_reference():
    rng = np.random.default_rng(3)
    ours = compile_program(ALL["word_count"], donate=True, device="cpu")
    ref = jax_compile(JAX_ALL["word_count"], donate=True)
    for n in (40, 40, 64):
        ins = dict(W=rng.integers(0, 10, n).astype(np.float64),
                   C=np.zeros(10))
        ours.run(_fresh(ins))
        ref.run(_fresh(ins))
        assert ours.explain().splitlines()[-1] == \
            ref.explain().splitlines()[-1]
    assert ours.explain().splitlines()[-1] == \
        "whole-program: mode=whole, 2 traced, 1 cache hits, donate=on"


@pytest.mark.parametrize("name", ["kmeans_step", "pagerank", "word_count"])
def test_memest_donate_credit_equals_the_reference(monkeypatch, name):
    # donation credits the donated destinations' buffers, as in the
    # reference: with the reference's constants, explain_memory() is its
    # text character for character
    from repro_torch.core import memest
    monkeypatch.setattr(memest, "INDEX_BYTES", 4)
    monkeypatch.setattr(memest, "DENSE_TEMPS", 1)
    ins = data_for(name)
    budget = 4096
    ours = compile_program(ALL[name], donate=True, memory_budget=budget,
                           device="cpu").explain_memory(ins)
    ref = jax_compile(JAX_ALL[name], donate=True,
                      memory_budget=budget).explain_memory(ins)
    assert ours == ref
    plain = compile_program(ALL[name], memory_budget=budget,
                            device="cpu").estimate_memory(ins)
    donated = compile_program(ALL[name], donate=True, memory_budget=budget,
                              device="cpu").estimate_memory(ins)
    assert donated.peak_bytes <= plain.peak_bytes


# ---------------------------------------------------------------------------
# on the card: the capture itself
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU form")
    return torch.device("cuda")


def _card_inputs(name, rng):
    n, k, nv = 50_000, 4096, 20_000
    if name == "group_by":
        return dict(S=(rng.integers(-3, k + 3, n).astype(np.float32),
                       rng.standard_normal(n, dtype=np.float32)),
                    C=np.zeros(k, np.float32))
    src = rng.integers(0, nv, n).astype(np.float32)
    dst = rng.integers(0, nv, n).astype(np.float32)
    return dict(E=(src, dst), P=np.full(nv, 1.0 / nv, np.float32),
                NP=np.zeros(nv, np.float32), C=np.zeros(nv, np.float32),
                N=nv, num_steps=5.0, steps=0.0, b=0.85)


def _on(ins, device):
    return {k: (tuple(torch.from_numpy(c).to(device) for c in v)
                if isinstance(v, tuple) else torch.from_numpy(v).to(device)
                if isinstance(v, np.ndarray) else v)
            for k, v in ins.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["group_by", "pagerank"])
def test_cuda_whole_bit_equal_to_eager_and_launches(cuda, name):
    ins = _card_inputs(name, np.random.default_rng(5))
    whole = compile_program(ALL[name], device=cuda)
    eager = compile_program(ALL[name], compile_mode="eager", device=cuda)
    for form in (ins, _on(ins, cuda)):    # host and device inputs
        out_e = eager.run(form)
        first = whole.run(form)           # warm-up, capture, replay
        assert _bits_equal(first, out_e)
        ops.reset_launch_counts()
        out_e = eager.run(form)
        eager_counts = ops.launch_counts()
        ops.reset_launch_counts()
        out_w = whole.run(form)
        torch.cuda.synchronize()
        assert ops.launch_counts() == eager_counts
        assert eager_counts["segment_reduce"] > 0
        assert _bits_equal(out_w, out_e)
        for v in out_w.values():
            assert v.device.type == "cuda"
    assert whole.trace_count == 1 and whole.trace_failures == 0
    assert whole.cache_hits == 3 and whole.faults.counters["descend"] == 0
    assert _entry(whole).graphs == (2 if name == "pagerank" else 1)


@pytest.mark.cuda
def test_cuda_failed_capture_leaves_the_card_usable(cuda, monkeypatch):
    ins = _card_inputs("group_by", np.random.default_rng(6))
    ref = compile_program(ALL["group_by"], compile_mode="eager",
                          device=cuda).run(ins)
    cp = compile_program(ALL["group_by"], device=cuda)
    cp.policy.disable_ttl = 1
    run_node = cp.executor.run_node

    def host_read_under_capture(node, env, ctx=None):
        out = run_node(node, env, ctx) if ctx is not None \
            else run_node(node, env)
        if torch.cuda.is_current_stream_capturing():
            out.sum().item()             # a sync: illegal in a capture
        return out
    monkeypatch.setattr(cp.executor, "run_node", host_read_under_capture)
    out = cp.run(ins)
    assert cp.trace_failures == 1 and cp.trace_count == 0
    assert cp.faults.level_reached == "eager"
    assert _bits_equal(out, ref)
    torch.cuda.synchronize()
    # the card goes on: the eager rung, and a fresh capture once the fault
    # is gone and the signature's ttl has run out
    monkeypatch.undo()
    out = cp.run(ins)
    assert cp.trace_count == 1 and cp.whole_retries == 1
    assert _bits_equal(out, ref)
    assert _bits_equal(cp.run(ins), ref) and cp.cache_hits == 1


@pytest.mark.cuda
def test_cuda_evicted_entries_free_their_memory(cuda):
    # five signatures in a row, each smaller than the one before: the
    # memory held between calls never exceeds that of the first two
    import gc
    ins = _card_inputs("group_by", np.random.default_rng(7))
    cp = compile_program(ALL["group_by"], device=cuda)
    held = []
    for cut in range(5):
        form = _on(dict(ins, S=tuple(c[:len(c) - 1000 * cut]
                                     for c in ins["S"])), cuda)
        out = cp.run(form)
        del out, form
        gc.collect()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert cp.trace_count == 5 and len(cp._whole_cache) == 2
    assert max(held[2:]) <= held[1]


@pytest.mark.cuda
def test_cuda_a_persisting_fault_surfaces_on_the_card(cuda):
    # on the card the interpreter is no rung: a capacity error that persists
    # reaches the caller, and nothing ran on the host — without the
    # out-of-core tier from the eager level; with it (the default) once the
    # chunked rung has halved its tile down to one row
    from repro_torch.core import faults as F
    ins = _card_inputs("group_by", np.random.default_rng(8))
    for ooc, level in (("off", "eager"), ("auto", "chunked[1]")):
        cp = compile_program(ALL["group_by"], out_of_core=ooc, device=cuda)
        cp.faults.sleep = lambda s: None
        with F.inject(F.FaultSpec("lower.node", "capacity", nth=1,
                                  times=10 ** 6)):
            with pytest.raises(F.CapacityFault):
                cp.run(_on(ins, cuda))
        assert cp.faults.level_reached == level
        assert "interp" not in cp.explain_faults()
        if ooc == "off":
            assert cp.faults.counters["descend"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["group_by", "pagerank"])
def test_cuda_donation_feed_back_and_held_outputs(cuda, name):
    # on the card: donated bits equal whole mode's; the feed-back pattern
    # copies no byte of a donated name and recaptures nothing; a fresh
    # donated tensor is consumed; a held output survives the next call,
    # and a held view of one makes the entry recapture its graphs
    ins = _card_inputs(name, np.random.default_rng(2))
    whole = compile_program(ALL[name], device=cuda)
    cp = compile_program(ALL[name], device=cuda, donate=True)
    want = whole.run(_on(ins, cuda))
    fresh = _on(ins, cuda)
    given = {k: fresh[k] for k in want if isinstance(fresh[k], torch.Tensor)}
    out = cp.run(fresh)
    assert _bits_equal(out, want)
    assert all(v.numel() == 0 for v in given.values())
    entry = _entry(cp)
    want2 = whole.run(dict(_on(ins, cuda), **want))
    staged, cloned = entry.staged_bytes, entry.cloned_bytes
    before = dict(entry.staged)
    nxt = dict(_on(ins, cuda), **out)
    out2 = cp.run(nxt)
    torch.cuda.synchronize()
    assert _bits_equal(out2, want2)
    assert entry.staged_bytes > staged          # the bag, as before
    assert all(entry.staged[k] == before[k] for k in out)
    assert entry.cloned_bytes == cloned and entry.rebinds == 0
    kept = {k: v.clone() for k, v in out2.items()}
    out3 = cp.run(_on(ins, cuda))
    torch.cuda.synchronize()
    assert _bits_equal(out2, kept) and _bits_equal(out3, want)
    view = out3[next(iter(out3))][1:]
    snap = view.clone()
    out4 = cp.run(_on(ins, cuda))
    torch.cuda.synchronize()
    assert torch.equal(view, snap) and entry.rebinds == 1
    assert _bits_equal(out4, want)
