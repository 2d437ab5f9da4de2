"""The peak-device-bytes estimator of the PyTorch port (`core/memest.py`,
a copy of the reference's with two constants changed to price the port's
executor): the port of tests/test_memest.py's 10 tests, and
`explain_memory()` held against the JAX package's for every program —
equal character for character with the reference's constants put back,
and, with the port's, different only in the lines those constants price.
"""
from __future__ import annotations

import re

import numpy as np
import pytest

from repro.core import compile_program as jax_compile
from repro.core.programs import ALL as JAX_ALL
from repro_torch.convert import inputs_from_numpy
from repro_torch.core import compile_program
from repro_torch.core import memest
from repro_torch.core.programs import ALL
from test_core_programs import data_for


def _cp(name, **kw):
    return compile_program(ALL[name], device="cpu", **kw)


def _wc_inputs(n=256, k=16):
    r = np.random.default_rng(0)
    return dict(W=(r.integers(0, k, n).astype(np.int32),),
                C=np.zeros(k, np.float32))


def _pr_inputs(n=64, ne=512):
    r = np.random.default_rng(1)
    return dict(E=(r.integers(0, n, ne).astype(np.int32),
                   r.integers(0, n, ne).astype(np.int32)),
                P=np.full(n, 1.0 / n, np.float32),
                NP=np.zeros(n, np.float32), C=np.zeros(n, np.float32),
                N=n, num_steps=3.0, steps=0.0, b=0.85)


def test_fmt_bytes():
    assert memest.fmt_bytes(512) == "512B"
    assert memest.fmt_bytes(2048) == "2.0KiB"
    assert memest.fmt_bytes(3 * 1024 ** 2) == "3.0MiB"
    assert "GiB" in memest.fmt_bytes(5 * 1024 ** 3)


def test_shape_env_kinds():
    cp = _cp("pagerank")
    ins = inputs_from_numpy(_pr_inputs(), "cpu", cp.program.params)
    env = memest.shape_env(cp.program, ins)
    assert env["N"] == ("dim", 64)
    kind, rows, cols = env["E"]
    assert kind == "bag" and rows == 512 and len(cols) == 2
    assert env["P"][0] == "array" and env["P"][1] == (64,)


def test_estimate_charges_more_than_resident():
    """The peak must exceed the raw resident footprint: temporaries for
    the widest node (gathered operands, masks, keys) are real bytes."""
    cp = _cp("word_count")
    ins = inputs_from_numpy(_wc_inputs(), "cpu", cp.program.params)
    est = memest.estimate(cp.plan, cp.program, memest.shape_env(
        cp.program, ins))
    assert est.peak_bytes > est.resident > 0
    assert est.bag_bytes["W"] >= 256  # one int32 column of 256 rows
    assert est.per_row("W") > 0
    assert est.fixed_bytes < est.peak_bytes


def test_estimate_scales_with_rows():
    cp = _cp("word_count")
    small = cp.estimate_memory(_wc_inputs(n=256))
    big = cp.estimate_memory(_wc_inputs(n=4096))
    assert big.peak_bytes > 4 * small.peak_bytes
    # fixed bytes (dests + non-bag residents) do NOT scale with the bag
    assert big.fixed_bytes == small.fixed_bytes


def test_summary_verdict_flips_on_budget():
    cp = _cp("word_count")
    est = cp.estimate_memory(_wc_inputs())
    roomy = est.summary(10 * est.peak_bytes)
    tight = est.summary(est.peak_bytes // 4)
    assert "all-resident" in roomy and "chunked" not in roomy
    assert "chunked" in tight
    assert "peak≈" in est.summary(None)


def test_explain_includes_memory_line_after_estimate():
    cp = _cp("word_count", memory_budget=10 ** 9)
    cp.estimate_memory(_wc_inputs())
    assert "memory: peak≈" in cp.explain()
    long = cp.explain_memory(_wc_inputs())
    assert "== memory estimate" in long and "streaming" in long


def test_estimate_memory_is_cached():
    cp = _cp("word_count")
    a = cp.estimate_memory(_wc_inputs())
    b = cp.estimate_memory(_wc_inputs())
    assert a is b
    c = cp.estimate_memory(_wc_inputs(n=512))
    assert c is not a


def test_signature_env_matches_concrete_env():
    """What a shape bucket's signature gives (the port's compile-cache
    key, dtype names and all) equals the estimate of concrete inputs of
    those shapes."""
    cp = _cp("word_count")
    ins = inputs_from_numpy(_wc_inputs(n=256), "cpu", cp.program.params)
    sig = cp._signature(ins)
    env_a = memest.shape_env(cp.program, ins)
    env_b = memest.shape_env_from_signature(cp.program, sig)
    pa = memest.estimate(cp.plan, cp.program, env_a).peak_bytes
    pb = memest.estimate(cp.plan, cp.program, env_b).peak_bytes
    assert pa == pb


def test_loop_program_peaks_at_widest_node():
    """pagerank's SeqLoop charges the MAX over its body nodes, not the
    sum — iterations reuse the same buffers."""
    cp = _cp("pagerank")
    est = cp.estimate_memory(_pr_inputs())
    node_peaks = [c.temp + c.dest + c.collective for c in est.nodes]
    assert est.peak_bytes == est.resident + max(node_peaks)


def test_explain_text_lists_nodes():
    cp = _cp("pagerank")
    text = cp.explain_memory(_pr_inputs())
    assert "SegmentReduce" in text or "segment" in text.lower()
    assert "resident" in text and "budget" not in text.splitlines()[0]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

# the lines the port's constants may change: a node's temporaries and the
# peak and streaming lines that sum them
CHANGED = re.compile(r"^(\[\d+\] .*: temp |memory: peak≈|streaming: )")


@pytest.mark.parametrize("name", sorted(ALL))
def test_explain_memory_equals_the_reference(monkeypatch, name):
    ins = data_for(name)
    budget = 4096
    ref = jax_compile(JAX_ALL[name], memory_budget=budget).explain_memory(ins)
    ours = _cp(name, memory_budget=budget).explain_memory(ins)
    a, b = ours.splitlines(), ref.splitlines()
    assert len(a) == len(b)
    changed = [x for x, y in zip(a, b) if x != y]
    assert all(CHANGED.match(x) for x in changed), changed
    # the reference's constants put back: character for character
    monkeypatch.setattr(memest, "INDEX_BYTES", 4)
    monkeypatch.setattr(memest, "DENSE_TEMPS", 1)
    assert _cp(name, memory_budget=budget).explain_memory(ins) == ref


def test_port_constants_price_the_group_by_higher():
    """word_count's SegmentReduce: the reference charges 4 bytes a cell a
    slot (value, key, mask: 12 bytes a row); the port 28 (a key at
    INDEX_BYTES = 20), which covers the 21 bytes a row its eager run
    peaked at on an H100 (PERF.md §5)."""
    ins = _wc_inputs(n=1024)
    ours = _cp("word_count").estimate_memory(ins)
    ref = jax_compile(JAX_ALL["word_count"]).estimate_memory(ins)
    assert ref.nodes[0].temp == 1024 * 12
    assert ours.nodes[0].temp == 1024 * 28
