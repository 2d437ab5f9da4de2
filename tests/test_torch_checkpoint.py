"""Checkpoints of the PyTorch port (`repro_torch.checkpoint`,
`repro_torch.runtime`): the single-device cases of tests/test_checkpoint.py
on the CPU — restart bit-exactness, the atomic commit, keep-last-n, the
straggler watchdog, torn snapshots skipped to the previous good one, the
crc32 stamps, legacy snapshots without them — plus snapshots restored
across the two packages in both directions (the `.npz` format is
shared), a loop carry snapshotted by the JAX package's LoopRunner resumed
by the port's, and tensors restored onto the template's device.

The reference's restart and straggler tests drive its TrainRunner; here
the port holds the same contracts on LoopRunner, which drives a pagerank
loop, and tests/test_torch_train.py holds them on the port's TrainRunner.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.core import compile_program as jax_compile
from repro.core.programs import ALL as JAX_ALL
from repro.runtime import LoopRunner as JaxLoopRunner
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import CorruptSnapshot
from repro_torch.core import compile_program
from repro_torch.core.programs import ALL
from repro_torch.runtime import LoopRunner, SimulatedFailure, TrainRunner

NV = 16


def pr_inputs(steps=6.0, seed=1):
    r = np.random.default_rng(seed)
    return dict(E=(r.integers(0, NV, 200).astype(np.float32),
                   r.integers(0, NV, 200).astype(np.float32)),
                P=np.full(NV, 1.0 / NV, np.float32),
                NP=np.zeros(NV, np.float32), C=np.zeros(NV, np.float32),
                N=NV, num_steps=steps, steps=0.0, b=0.85)


def _pr():
    cp = compile_program(ALL["pagerank"], device="cpu")
    cp.faults.sleep = lambda s: None
    return cp


def _bitident(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_restart_resumes_bit_exact(tmp_path):
    """Killed at iteration 5 with snapshots every 2 iterations: the
    restart resumes from iteration 4's carry and ends with the
    uninterrupted run's bits."""
    ref = LoopRunner(_pr(), str(tmp_path / "a"), every=2).run(
        pr_inputs(), resume=False)

    r1 = LoopRunner(_pr(), str(tmp_path / "b"), every=2)
    save = r1._observer

    def dying(li, it, carry):
        save(li, it, carry)
        if it == 5:
            raise SimulatedFailure(f"injected failure at {it}")
    r1._observer = dying
    with pytest.raises(SimulatedFailure):
        r1.run(pr_inputs(), resume=False)
    r1.mgr.wait()

    r2 = LoopRunner(_pr(), str(tmp_path / "b"), every=2)
    out = r2.run(pr_inputs(), resume=True)
    _, _, extra = r2.mgr.restore_flat(r2.resumed_from)
    assert extra["loops"] == {"0": 4}
    assert _bitident(out, ref)


def test_atomic_commit_ignores_partial(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(2, {"w": torch.ones(3)})
    os.makedirs(tmp_path / "step_00000009.tmp")  # simulated crash mid-write
    assert mgr.latest() == 2


def test_keep_last_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((2,), float(s))})
    assert mgr.steps() == [3, 4]


def test_async_write_completes(tmp_path):
    """The disk write runs on a background thread; the device → host copy
    is taken at save(), so writing the tensor afterwards changes nothing
    on disk."""
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    w = torch.arange(6.0)
    mgr.save(1, {"w": w, "nested": [w * 2, {"b": torch.tensor(3)}]})
    w.zero_()
    mgr.wait()
    _, flat, _ = mgr.restore_flat(1)
    np.testing.assert_array_equal(flat["w"], np.arange(6.0,
                                                       dtype=np.float32))
    assert set(flat) == {"w", "nested/0", "nested/1/b"}


def test_straggler_watchdog():
    """A slow iteration of a LoopRunner-driven loop is flagged by the
    program's trailing-median watchdog, in explain_faults()."""
    import tempfile
    import time
    cp = _pr()
    calls = []
    cond = cp.executor.loop_cond

    def slow_cond(*a, **kw):
        calls.append(1)
        if len(calls) == 7:
            time.sleep(0.5)
        return cond(*a, **kw)
    cp.executor.loop_cond = slow_cond
    with tempfile.TemporaryDirectory() as d:
        LoopRunner(cp, d, every=100).run(pr_inputs(steps=9.0),
                                         resume=False)
    assert cp.faults.counters["straggler"] >= 1
    assert "straggler[loop0.iter]" in cp.explain_faults()


def test_torn_snapshot_skipped_to_previous_good(tmp_path):
    """A torn write / bit flip in the NEWEST snapshot fails its crc32
    verification and latest() falls back to the previous good snapshot
    instead of restoring garbage."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(2, {"w": np.arange(8.0)})
    mgr.save(4, {"w": np.arange(8.0) * 2})
    payload = tmp_path / "step_00000004" / "params.npz"
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF                 # one flipped byte mid-file
    payload.write_bytes(bytes(raw))

    assert mgr.verify(2) and not mgr.verify(4)
    assert mgr.latest() == 2
    assert mgr.skipped == [4]

    step, flat, _ = mgr.restore_flat(2)
    np.testing.assert_array_equal(flat["w"], np.arange(8.0))


def test_restore_checks_each_array_as_it_reads(tmp_path):
    """restore_flat and restore raise CorruptSnapshot on the bit-flipped
    snapshot; resume() walks newest first on that reader and skips it."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(2, {"w": np.arange(8.0)})
    mgr.save(4, {"w": np.arange(8.0) * 2})
    payload = tmp_path / "step_00000004" / "params.npz"
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    payload.write_bytes(bytes(raw))

    with pytest.raises(CorruptSnapshot):
        mgr.restore_flat(4)
    with pytest.raises(CorruptSnapshot):
        mgr.restore(4, {"w": np.zeros(8)})
    step, flat, _ = mgr.resume(mgr.restore_flat)
    assert step == 2 and mgr.skipped == [4]
    np.testing.assert_array_equal(flat["w"], np.arange(8.0))
    assert CheckpointManager(str(tmp_path / "none")).resume(
        mgr.restore_flat) is None


def test_snapshot_checksums_written_and_verify(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, {"w": torch.arange(4.0)}, opt_state={"m": torch.zeros(4)})
    with open(tmp_path / "step_00000001" / "checksums.json") as f:
        sums = json.load(f)
    assert set(sums) == {"params.npz", "opt.npz"}
    assert "w" in sums["params.npz"] and "m" in sums["opt.npz"]
    assert mgr.verify(1)


def test_legacy_snapshot_without_checksums_accepted(tmp_path):
    """Pre-checksum snapshots (no checksums.json) restore as-is: absence
    of stamps is not evidence of corruption."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(3, {"w": torch.ones(3)})
    os.remove(tmp_path / "step_00000003" / "checksums.json")
    assert mgr.verify(3)
    assert mgr.latest() == 3


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

def _tree(r):
    return {"layer": [r.standard_normal((3, 4)).astype(np.float32),
                      r.integers(0, 9, 5).astype(np.int32)],
            "b": {"x": r.standard_normal(2).astype(np.float32)}}


def test_port_snapshot_restores_in_the_reference(tmp_path):
    tree = _tree(np.random.default_rng(0))
    ours = {"layer": [torch.from_numpy(a) for a in tree["layer"]],
            "b": {"x": torch.from_numpy(tree["b"]["x"])}}
    CheckpointManager(str(tmp_path), async_write=False).save(
        5, ours, opt_state={"m": torch.ones(2)}, extra={"k": 1})
    ref = JaxCheckpointManager(str(tmp_path), async_write=False)
    assert ref.latest() == 5 and ref.verify(5)
    step, params, opt, extra = ref.restore(5, tree, {"m": np.zeros(2)})
    assert step == 5 and extra == {"k": 1}
    for a, b in zip(params["layer"], tree["layer"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(np.asarray(params["b"]["x"]),
                                  tree["b"]["x"])
    np.testing.assert_array_equal(np.asarray(opt["m"]), np.ones(2))


def test_reference_snapshot_restores_in_the_port(tmp_path):
    tree = _tree(np.random.default_rng(1))
    JaxCheckpointManager(str(tmp_path), async_write=False).save(
        7, tree, opt_state={"m": np.full(2, 3.0, np.float32)})
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    assert mgr.latest() == 7 and mgr.verify(7)
    template = {"layer": [torch.zeros(3, 4), torch.zeros(5,
                                                         dtype=torch.int32)],
                "b": {"x": torch.zeros(2)}}
    step, params, opt, _ = mgr.restore(7, template, {"m": torch.zeros(2)})
    assert step == 7
    assert params["layer"][1].dtype == torch.int32
    assert params["layer"][0].device == template["layer"][0].device
    for a, b in zip(params["layer"], tree["layer"]):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(params["b"]["x"].numpy(), tree["b"]["x"])
    np.testing.assert_array_equal(opt["m"].numpy(), np.full(2, 3.0))


def test_reference_loop_snapshot_resumes_in_the_port(tmp_path):
    """A pagerank carry snapshotted mid-loop by the JAX package's
    LoopRunner resumes in the port (its restored carry in the canonical
    dtypes), to the reference's stepwise result within its tolerance."""
    ins = pr_inputs(steps=6.0)
    jcp = jax_compile(JAX_ALL["pagerank"])
    jcp.faults.sleep = lambda s: None
    jr = JaxLoopRunner(jcp, str(tmp_path), every=1)
    from repro.core import faults as JF
    with JF.inject(JF.FaultSpec("lower.loop_iter", "deterministic", nth=4)):
        with pytest.raises(JF.DeterministicFault):
            jr.run(ins, resume=False)
    ref = jcp.run_stepwise(ins)
    runner = LoopRunner(_pr(), str(tmp_path), every=1)
    out = runner.run(ins, resume=True)
    assert runner.resumed_from is not None
    for k in ref:
        np.testing.assert_allclose(out[k].numpy().astype(np.float64),
                                   np.asarray(ref[k], np.float64),
                                   rtol=2e-3, atol=1e-4, err_msg=k)
    _, flat, extra = runner.mgr.restore_flat(runner.mgr.latest())
    assert extra["loops"]["0"] == 6


def test_unported_tiers_raise(tmp_path):
    # the peer-replica tier came with the distributed rounds (Queue 1 item
    # 5): it builds; the training runner came with item 6: it runs (its
    # tests against the reference's are in test_torch_train.py)
    runner = LoopRunner(_pr(), str(tmp_path), peer_every=1)
    assert runner.peer is not None and runner.peer.snaps == []

    class Data:
        def next_batch(self):
            return None

        def state(self):
            return {"step": 0, "seed": 0}

    tr = TrainRunner(lambda p, o, b: (p, o, {"loss": 0.0}),
                     {"w": np.ones(3, np.float32)}, None, Data(),
                     ckpt_dir=str(tmp_path / "train"), ckpt_every=2)
    assert tr.run(4) == {"loss": 0.0} and tr.step == 4
    assert tr.mgr.steps() == [2, 4]


def test_restore_onto_the_named_device(tmp_path):
    """A restore places tensors on the device the caller names, or on the
    template's: never silently elsewhere."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, {"w": torch.arange(3.0)})
    _, p, _, _ = mgr.restore(1, {"w": torch.zeros(3, dtype=torch.float64)},
                             device="cpu")
    assert p["w"].dtype == torch.float64 and p["w"].device.type == "cpu"
    np.testing.assert_array_equal(p["w"].numpy(), [0.0, 1.0, 2.0])
