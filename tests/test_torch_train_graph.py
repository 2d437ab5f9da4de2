"""The train step wrapped by `graphed_step` (`repro_torch.train.graph`, the
port's counterpart of the reference's `jax.jit` of its step).

On the CPU the wrapper runs the step eagerly over its static batch
buffers and the in-place state, as it does around the capture on the
card: these tests hold that path bit-equal to the plain step, against the
reference's jitted step, across batch signatures and through a resumed
`TrainRunner`.  The capture itself runs on the card (chip_smoke.py's
phase 8 and `[train-dp]`).
"""
import types

import numpy as np
import pytest
import torch

import test_torch_train as T
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.models import get_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import TrainRunner
from repro_torch.runtime.ft import SimulatedFailure
from repro_torch.train import CaptureError, graphed_step, make_train_step

# one smoke config of each family: dense, moe (with a microbatch of 2),
# ssm, hybrid (rec + lattn) and audio
FAMILIES = {"dense": ("llama3-8b", 1), "moe": ("qwen3-moe-30b-a3b", 2),
            "ssm": ("falcon-mamba-7b", 1), "hybrid": ("recurrentgemma-2b", 1),
            "audio": ("whisper-tiny", 1)}


def _cfg(arch, microbatch=1):
    return smoke_config(arch).replace(ce_chunk=8, microbatch=microbatch)


def _data(cfg, b=4, s=16, seed=3):
    return SyntheticLMData(cfg.vocab_size, b, s, seed=seed,
                           with_frames=cfg.enc_seq
                           if cfg.family == "audio" else 0,
                           d_model=cfg.d_model,
                           with_pos_ids=cfg.family == "vlm")


def _model(cfg, seed=0):
    model = get_model(cfg, device="cpu").init(seed)
    return model, adamw_init(dict(model.named_leaves()))


def _bits(model, opt):
    return [t.detach().clone() for _, t in model.named_leaves()] \
        + [t.clone() for t in opt.mu.values()] \
        + [t.clone() for t in opt.nu.values()] + [opt.step.clone()]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_graphed_step_bit_equal_to_plain_step(family):
    arch, mb = FAMILIES[family]
    cfg = _cfg(arch, mb)
    data = _data(cfg)
    batches = [data.next_batch() for _ in range(3)]
    runs = {}
    for name in ("plain", "graphed"):
        model, opt = _model(cfg)
        step = make_train_step(cfg, compress_grads=False)
        if name == "graphed":
            step = graphed_step(step)
        metrics = []
        for b in batches:
            model, opt, m = step(model, opt, b)
            metrics.append({k: v.clone() for k, v in m.items()})
        runs[name] = (_bits(model, opt), metrics)
        if name == "graphed":
            assert step.entries_built == 1
    (a, ma), (b, mb_) = runs["plain"], runs["graphed"]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for x, y in zip(ma, mb_):
        assert x.keys() == y.keys() == {"loss", "grad_norm", "lr"}
        assert all(torch.equal(x[k], y[k]) for k in x)


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-tiny"])
def test_graphed_step_matches_reference(arch, monkeypatch):
    """The wrapped step against the reference's jitted step, as
    tests/test_torch_train.py's test_train_step_matches_reference holds the
    plain one: loss and grad_norm each step, the parameters after the
    first step and the last, at its tolerances."""
    monkeypatch.setattr(T, "make_train_step", lambda *a, **kw: graphed_step(
        make_train_step(*a, **kw)))
    cfg, jcfg, params, model = T._pair(arch)
    (_, jopt), (model, opt) = T._steps_against_reference(
        "steps", arch, cfg, jcfg, params, model, T._batches(cfg, 3))
    assert int(opt.step) == int(jopt.step) == 3


def test_new_batch_shape_makes_new_entry():
    cfg = _cfg("llama3-8b")
    model, opt = _model(cfg)
    step = graphed_step(make_train_step(cfg, compress_grads=False))
    step(model, opt, _data(cfg, 4, 16).next_batch())
    first = step.entry
    assert step.entries_built == 1 and tuple(
        first.inputs["tokens"].shape) == (4, 16)
    step(model, opt, _data(cfg, 4, 16, seed=4).next_batch())
    assert step.entries_built == 1 and step.entry is first
    step(model, opt, _data(cfg, 2, 8).next_batch())
    assert step.entries_built == 2 and step.entry is not first
    assert tuple(step.entry.inputs["tokens"].shape) == (2, 8)
    assert first.inputs == {}          # the old entry's buffers let go
    # another model's tensors: a new entry too
    other, oopt = _model(cfg, seed=1)
    step(other, oopt, _data(cfg, 2, 8).next_batch())
    assert step.entries_built == 3


def test_metrics_are_not_overwritten_by_the_next_call():
    cfg = _cfg("llama3-8b")
    model, opt = _model(cfg)
    step = graphed_step(make_train_step(cfg, compress_grads=False))
    data = _data(cfg)
    _, _, m1 = step(model, opt, data.next_batch())
    keep = {k: v.clone() for k, v in m1.items()}
    _, _, m2 = step(model, opt, data.next_batch())
    assert not torch.equal(m1["loss"], m2["loss"])
    for k, v in keep.items():
        assert torch.equal(m1[k], v)
        assert m1[k].data_ptr() != m2[k].data_ptr()
        assert m1[k].data_ptr() != step.entry.out[k].data_ptr()


def _runner(tmp, ckpt_every=2, seed=0):
    cfg = _cfg("llama3-8b")
    model, opt = _model(cfg, seed)
    step = graphed_step(make_train_step(cfg, compress_grads=False))
    return TrainRunner(step, model, opt, _data(cfg), ckpt_dir=str(tmp),
                       ckpt_every=ckpt_every)


def test_resumed_runner_keeps_its_entry_and_bits(tmp_path):
    """An unbroken run of 6 steps against one failed at step 5 (snapshots
    every 2) and a third runner that has already stepped (its entry
    built) resuming the step-4 snapshot in place: bit-equal, and the
    third runner's step function keeps its one entry."""
    full = _runner(tmp_path / "a")
    full.run(6)
    broken = _runner(tmp_path / "b")
    with pytest.raises(SimulatedFailure):
        broken.run(6, fail_at_step=5)
    broken.mgr.wait()
    again = _runner(tmp_path / "b", ckpt_every=10 ** 6, seed=1)
    again.run(1)
    assert again.step_fn.entries_built == 1
    assert again.maybe_resume() and again.step == 4
    assert int(again.opt_state.step) == 4 and again.data.step == 4
    again.run(6)
    assert again.step_fn.entries_built == 1
    for a, b in zip(_bits(full.params, full.opt_state),
                    _bits(again.params, again.opt_state)):
        assert torch.equal(a, b)


def test_graph_over_a_mesh_that_stages_through_host_raises():
    """gloo ranks that share a card stage their all_reduce through pinned
    host memory, which a graph cannot capture."""
    coll = types.SimpleNamespace(direct=frozenset(),
                                 transport=lambda op: "gloo via pinned host")
    mesh = types.SimpleNamespace(device=torch.device("cuda", 0), coll=coll)
    step = types.SimpleNamespace(mesh=mesh, exchange=None)
    with pytest.raises(CaptureError, match="pinned host"):
        graphed_step(step)
    # the same mesh on the CPU: the step runs eagerly, nothing to capture
    mesh.device = torch.device("cpu")
    assert graphed_step(step).mesh is mesh


def test_capture_error_names_the_line_of_the_package():
    from repro_torch.core.capture import where
    from repro_torch.models.common import apply_mrope
    try:
        apply_mrope(torch.zeros(1, 2, 1, 8), torch.zeros(1, 2, 3), 1e4,
                    (1, 1, 1))
    except Exception as ex:      # [.., 4] angles against an hd/2 of 4
        at = where(ex)
    assert at.startswith("repro_torch/models/common.py:")
    assert "(apply_mrope)" in at


def test_host_batch_is_staged_into_the_entry_buffers():
    cfg = _cfg("whisper-tiny")
    model, opt = _model(cfg)
    step = graphed_step(make_train_step(cfg, compress_grads=False))
    batch = _data(cfg).next_batch()
    step(model, opt, batch)
    for k, v in batch.items():
        buf = step.entry.inputs[k]
        assert buf.dtype == torch.from_numpy(np.asarray(v)).dtype
        assert torch.equal(buf, torch.from_numpy(np.asarray(v)))
