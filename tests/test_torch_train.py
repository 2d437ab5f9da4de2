"""The PyTorch port's training path against the JAX package's, on the CPU.

The reference's `model.init(0)` weights are carried across with
`lm_params_from_numpy` (`whisper_params_from_numpy` for the audio
family); batches come from the shared `SyntheticLMData` (numpy; with the
encoder's frames for the audio family and M-RoPE positions for the vlm
family, as the reference's launcher builds them).  The port's
`make_train_step` is held against the reference's
`jax.jit(make_train_step(...))` on the smoke configs of all ten
architectures with `ce_chunk=8` at S = 16, so that the chunked
cross-entropy runs: loss, grad_norm and every gradient leaf within 1e-4
of max |ref| (float32, the same math summed in another order), the
parameters after the first step and after three within 1e-5 absolute (a
few named elements, whose first gradient is float32 rounding, may leave
it after the first step by AdamW's reach, and are then set to the
reference's values: `ROUNDING_ELEMENTS`).  Then the port's own
forms (remat full / dots / none within 1e-6; microbatch 2 against 1
within 1e-5), the reference's checkpoint, recovery and system tests of
the train loop, snapshots that cross between the packages, and the
launcher's loss against the reference launcher's.
"""
import collections
import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import list_archs
from repro.configs import smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.runtime import TrainRunner as JaxTrainRunner
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy,
                                 lm_tree_from_numpy, lm_tree_to_numpy,
                                 whisper_params_from_numpy,
                                 whisper_params_to_numpy,
                                 whisper_tree_from_numpy,
                                 whisper_tree_to_numpy)
from repro_torch.core import faults as F
from repro_torch.data import SyntheticLMData
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import TrainRunner
from repro_torch.runtime.ft import SimulatedFailure
from repro_torch.train import make_train_step
from repro_torch.train.step import _slices

ARCHS = list_archs()  # all ten: dense, ssm, moe, vlm, hybrid and audio
GRAD_TOL = 1e-4      # loss, grad_norm, every gradient leaf: of max |ref|
PARAM_TOL = 1e-5     # parameters after three steps, absolute
LR = 3e-4            # both packages' train steps' default
B, S = 4, 16


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _audio(cfg):
    return cfg.family == "audio"


def _from_numpy(cfg, tree):
    """The port's model (LM or Whisper) holding the reference's tree."""
    load = whisper_params_from_numpy if _audio(cfg) else lm_params_from_numpy
    return load(cfg, tree, device="cpu")


def _to_numpy(cfg, model):
    """The reference's parameter tree from the port's model."""
    dump = whisper_params_to_numpy if _audio(cfg) else lm_params_to_numpy
    return dump(cfg, model)


def _tree_to_numpy(cfg, leaves):
    """The reference's stacked tree of a dict keyed like the model's
    parameters (gradients, moments)."""
    dump = whisper_tree_to_numpy if _audio(cfg) else lm_tree_to_numpy
    return dump(cfg, leaves)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's `model.init(0)` of an arch's smoke config (what
    `_pair`'s overrides change, the loss's chunking, remat and
    microbatching, leaves its parameters as they are)."""
    return jax_get_model(jax_smoke_config(arch)).init(0)


def _pair(arch, **over):
    """(port cfg, reference cfg, reference params, port model with them)."""
    jcfg = jax_smoke_config(arch).replace(ce_chunk=8, **over)
    cfg = smoke_config(arch).replace(ce_chunk=8, **over)
    params = _ref_params(arch)
    tree = jax.tree.map(np.asarray, params)
    return cfg, jcfg, params, _from_numpy(cfg, tree)


def _data(cfg, b=B, s=S, seed=3):
    """The reference launcher's data for a config: frames for the audio
    family, M-RoPE positions for the vlm family."""
    return SyntheticLMData(cfg.vocab_size, b, s, seed=seed,
                           with_frames=cfg.enc_seq if _audio(cfg) else 0,
                           d_model=cfg.d_model,
                           with_pos_ids=cfg.family == "vlm")


def _batches(cfg, n, seed=3):
    data = _data(cfg, seed=seed)
    return [data.next_batch() for _ in range(n)]


def _ref_grad_fn(jcfg):
    """The reference's jitted (loss, gradients) of one batch."""
    jmodel = jax_get_model(jcfg)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(p, b),
                                    has_aux=True))

    def grads(params, batch):
        (jloss, _), jgrads = vg(params, batch)
        return float(jloss), dict(_flat(jax.tree.map(np.asarray, jgrads)))
    return grads


# Elements whose first reference gradient is at float32 rounding: |g|
# below this share of its leaf's max |g| (the two packages' gradients of
# one leaf differ by up to about 6e-7 of its max, summed in other orders).
# AdamW's first step, lr·g/(|g| + eps) of the clipped g, takes such an
# element's move from the rounding where |g| is near eps or below, so the
# two packages may move it apart by up to two of the step's lr.
ROUNDING = 1e-5
# The elements of that kind that leave PARAM_TOL after the first step, per
# test, arch and leaf, at most this many each (at the tests' seeds and
# batches).  recurrentgemma-2b's g0/s0 w_in: g 4.1e-8 in the reference and
# 2.1e-7 in the port, of a leaf whose max |g| is 0.19; qwen2-72b's k bias,
# whose gradient is zero in exact arithmetic (softmax takes no constant
# that a query adds to all its scores).  Every other element is held to
# PARAM_TOL.
ROUNDING_ELEMENTS = {
    ("steps", "recurrentgemma-2b"): {"g0/s0_rec/mlp/w_in": 1},
    ("compress", "recurrentgemma-2b"): {"g0/s0_rec/mlp/w_in": 1,
                                        "g0/s1_rec/mlp/w_in": 1},
    ("compress", "qwen2-72b"): {"g0/s0_dense/attn/bk": 1},
    ("microbatch", "qwen3-moe-30b-a3b"): {"g0/s0_moe/attn/wo": 1},
}


def _tree_from_numpy(cfg, tree: dict, into: dict):
    """Copy the reference's stacked tree into a dict keyed like the port's
    parameters (the inverse of `_tree_to_numpy`)."""
    load = whisper_tree_from_numpy if _audio(cfg) else lm_tree_from_numpy
    load(cfg, tree, into)


def _unflat(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *heads, last = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _rounding(grads: dict) -> dict:
    """Per leaf, the mask of elements whose gradient is float32 rounding."""
    out = {}
    for k, g in grads.items():
        g = np.abs(np.asarray(g, np.float64))
        out[k] = g < ROUNDING * g.max()
    return out


def _check_params(got: dict, want: dict, rounding=None, allowed=None):
    """Every parameter within PARAM_TOL absolute.  Given the masks of
    `_rounding`, an element of them may leave it by up to AdamW's reach
    of one step (2·lr), if `allowed` (leaf: count) names as many in its
    leaf."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        err = np.abs(np.asarray(got[k], np.float64) - w)
        bad = err > PARAM_TOL
        free = rounding[k] if rounding is not None else np.zeros_like(bad)
        held = bad & ~free
        assert not held.any(), (k, float(err[held].max()), int(held.sum()))
        n = int(bad.sum())
        assert n <= (allowed or {}).get(k, 0), (k, n, allowed)
        assert not n or float(err[bad].max()) <= 2 * LR + PARAM_TOL, k


def _align(cfg, pairs, rounding):
    """Set the port's values of the rounding elements to the reference's,
    in each (port dict keyed like the parameters, reference tree) pair, so
    that what AdamW made of their rounding does not carry into the other
    elements' later steps."""
    for mine, ref in pairs:
        got = dict(_flat(_tree_to_numpy(cfg, mine)))
        for k, w in _flat(jax.tree.map(np.asarray, ref)):
            got[k] = np.where(rounding[k], w, got[k]).astype(got[k].dtype)
        _tree_from_numpy(cfg, _unflat(got), mine)


def _steps_against_reference(test, arch, cfg, jcfg, params, model, batches,
                             k=1, compress=False):
    """The port's and the reference's jitted train steps over `batches`
    from the same parameters, each step's loss and grad_norm within
    GRAD_TOL, and the parameters within PARAM_TOL after the first step
    (but for the rounding elements of its reference gradients, over its k
    microbatches, averaged, that `ROUNDING_ELEMENTS` names for `test` and
    `arch`; those are then set to the reference's values, parameters and
    moments) and after the last.  Returns the two states."""
    ref_grads = _ref_grad_fn(jcfg.replace(microbatch=1))
    first = {}
    for part in _slices(batches[0], k):
        for n, x in ref_grads(params, part)[1].items():
            first[n] = first.get(n, 0.0) + np.asarray(x, np.float64) / k
    rounding = _rounding(first)
    jstep = jax.jit(jax_make_train_step(jcfg, None, ("data",),
                                        compress_grads=compress))
    step = make_train_step(cfg, compress_grads=compress)
    jopt, opt = jax_adamw_init(params), adamw_init(dict(model.named_leaves()))
    for i, b in enumerate(batches):
        params, jopt, jm = jstep(params, jopt, b)
        model, opt, m = step(model, opt, b)
        assert _rel(float(m["loss"]), float(jm["loss"])) <= GRAD_TOL
        assert _rel(float(m["grad_norm"]), float(jm["grad_norm"])) \
            <= GRAD_TOL
        if i == 0:
            _check_params(dict(_flat(_to_numpy(cfg, model))),
                          dict(_flat(jax.tree.map(np.asarray, params))),
                          rounding, ROUNDING_ELEMENTS.get((test, arch)))
            _align(cfg, [(dict(model.named_leaves()), params),
                         (opt.mu, jopt.mu), (opt.nu, jopt.nu)], rounding)
    _check_params(dict(_flat(_to_numpy(cfg, model))),
                  dict(_flat(jax.tree.map(np.asarray, params))))
    return (params, jopt), (model, opt)


def _port_grads(model, batch):
    model.train_mode()
    leaves = dict(model.named_leaves())
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    cfg, jcfg, params, model = _pair(arch)
    batches = _batches(cfg, 3)
    # the gradients of the first step, leaf by leaf
    jloss, want = _ref_grad_fn(jcfg)(params, batches[0])
    loss, grads = _port_grads(model, batches[0])
    assert _rel(loss, jloss) <= GRAD_TOL
    got = dict(_flat(_tree_to_numpy(cfg, grads)))
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k], want[k]) <= GRAD_TOL, k
    # three steps of each package's train step
    (params, jopt), (model, opt) = _steps_against_reference(
        "steps", arch, cfg, jcfg, params, model, batches)
    assert int(opt.step) == int(jopt.step) == 3
    for name, tree in (("mu", jopt.mu), ("nu", jopt.nu)):
        mine = dict(_flat(_tree_to_numpy(cfg, getattr(opt, name))))
        for k, w in _flat(jax.tree.map(np.asarray, tree)):
            assert _rel(mine[k], w) <= GRAD_TOL, (name, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_compress_grads_matches_reference(arch):
    """bf16 gradient compression before the update, as the reference's."""
    cfg, jcfg, params, model = _pair(arch)
    _steps_against_reference("compress", arch, cfg, jcfg, params, model,
                             _batches(cfg, 2, seed=5), compress=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_forms_agree(arch):
    """remat full (a checkpoint a layer), dots (a selective checkpoint
    that keeps the matrix products) and none: the same loss and gradients
    within 1e-6 of max |g|."""
    out = {}
    for remat in ("full", "dots", "none"):
        cfg, _, _, model = _pair(arch, remat=remat)
        out[remat] = _port_grads(model, _batches(cfg, 1)[0])
    loss, grads = out["none"]
    for remat in ("full", "dots"):
        l2, g2 = out[remat]
        assert abs(l2 - loss) <= 1e-6 * abs(loss), remat
        for k in grads:
            assert _rel(g2[k].numpy(), grads[k].numpy()) <= 1e-6, (remat, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatch_two_agrees_with_one(arch):
    """cfg.microbatch = 2 (float32 gradients summed over two half batches,
    divided by 2) against one whole batch: loss and parameters after two
    steps within 1e-5.  A moe config routes each microbatch with its own
    capacity, in both packages, so here its capacity factor is its expert
    count, at which no row drops (`test_moe_microbatch_matches_reference`
    holds the dropping form against the reference's)."""
    over = {}
    if smoke_config(arch).num_experts:
        over["capacity_factor"] = float(smoke_config(arch).num_experts)
    runs = {}
    for k in (1, 2):
        cfg, _, _, model = _pair(arch, microbatch=k, **over)
        step = make_train_step(cfg, compress_grads=False)
        opt = adamw_init(dict(model.named_leaves()))
        for b in _batches(cfg, 2):
            model, opt, m = step(model, opt, b)
        runs[k] = (float(m["loss"]), dict(_flat(_to_numpy(cfg, model))))
    assert abs(runs[1][0] - runs[2][0]) <= 1e-5 * abs(runs[1][0])
    for k, v in runs[1][1].items():
        np.testing.assert_allclose(runs[2][1][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b"])
def test_moe_microbatch_matches_reference(arch):
    """microbatch 2 on a moe config, with the capacity that drops rows:
    each half batch routed with its own capacity, as the reference's scan
    over microbatches routes it.  Two steps against the reference's
    jitted step (`_steps_against_reference`)."""
    cfg, jcfg, params, model = _pair(arch, microbatch=2)
    _steps_against_reference("microbatch", arch, cfg, jcfg, params,
                             model, _batches(cfg, 2, seed=7), k=2)


def test_mrope_loss_matches_reference():
    """qwen2-vl-72b's loss with M-RoPE positions (three different streams
    from a seed) and random nonzero QKV biases: loss and every gradient
    leaf within 1e-4 of max |ref|; the positions change the loss."""
    from test_torch_models import with_biases
    arch = "qwen2-vl-72b"
    jcfg = jax_smoke_config(arch).replace(ce_chunk=8)
    cfg = smoke_config(arch).replace(ce_chunk=8)
    params = with_biases(jax_get_model(jcfg).init(0))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    batch = SyntheticLMData(cfg.vocab_size, B, S, seed=3,
                            with_pos_ids=True).next_batch()
    batch["pos_ids"] = np.random.default_rng(4).integers(
        0, 3 * S, (B, S, 3)).astype(np.int32)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p, b: jax_get_model(jcfg).loss(p, b), has_aux=True)(
        params, batch)
    loss, grads = _port_grads(model, batch)
    assert _rel(loss, float(jloss)) <= GRAD_TOL
    got = dict(_flat(lm_tree_to_numpy(cfg, grads)))
    for k, w in _flat(jax.tree.map(np.asarray, jgrads)):
        assert _rel(got[k], w) <= GRAD_TOL, k
    plain, _ = _port_grads(model, {k: v for k, v in batch.items()
                                   if k != "pos_ids"})
    assert abs(plain - loss) > 1e-4


def test_mesh_raises_naming_the_roadmap_item():
    """A mesh is data parallelism (tests/test_torch_train_dp.py); one
    whose model axis is larger than 1 asks for tensor parallelism, which
    raises naming its ROADMAP item before any collective."""
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(("data", "model"), {"data": 1, "model": 2}, 0,
                torch.device("cpu"), "gloo")
    with pytest.raises(NotImplementedError,
                       match="Tensor parallelism over the model axis"):
        make_train_step(smoke_config("llama3-8b"), mesh=mesh)


def test_serving_builds_no_graph_after_training():
    cfg, _, _, model = _pair("llama3-8b")
    model.train_mode()
    logits, cache = model.prefill(torch.zeros((1, 5), dtype=torch.int32), 8)
    assert not logits.requires_grad
    assert all(not t.requires_grad for c in cache for t in c.values())


# ---------------------------------------------------------------------------
# counterparts of the reference's tests of the train loop
# (tests/test_checkpoint.py, test_recovery.py, test_system.py)
# ---------------------------------------------------------------------------

def _mk(tmp, arch="llama3-8b", ckpt_every=2):
    cfg = smoke_config(arch)
    model = _from_numpy(cfg, jax.tree.map(np.asarray, _ref_params(arch)))
    data = _data(cfg, 4, 16)
    step = make_train_step(cfg, None, ("data",), compress_grads=False)
    return TrainRunner(step, model, adamw_init(dict(model.named_leaves())),
                       data, ckpt_dir=str(tmp), ckpt_every=ckpt_every)


def _state(r):
    return [t.detach().clone() for _, t in r.params.named_leaves()] \
        + [r.opt_state.mu[k].clone() for k in r.opt_state.mu] \
        + [r.opt_state.nu[k].clone() for k in r.opt_state.nu]


@pytest.mark.parametrize("arch", ARCHS)
def test_restart_resumes_bit_exact(tmp_path, arch):
    r_full = _mk(tmp_path / "a", arch)
    r_full.run(6)

    r1 = _mk(tmp_path / "b", arch)
    with pytest.raises(SimulatedFailure):
        r1.run(6, fail_at_step=5)
    r1.mgr.wait()

    r2 = _mk(tmp_path / "b", arch)
    assert r2.maybe_resume()
    assert r2.step == 4
    assert r2.data.step == 4            # token stream resumes exactly
    assert int(r2.opt_state.step) == 4
    r2.run(6)
    for a, b in zip(_state(r_full), _state(r2)):
        assert torch.equal(a, b)


class _CountingNpz:
    """np.load's NpzFile, counting each array read by (file, key)."""

    def __init__(self, zf, path, reads):
        self.zf, self.path, self.reads = zf, path, reads
        self.files = zf.files

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.zf.close()

    def __getitem__(self, k):
        self.reads[(self.path, k)] += 1
        return self.zf[k]


def test_resume_reads_each_array_of_its_snapshot_once(tmp_path,
                                                      monkeypatch):
    """maybe_resume reads every array of the snapshot it restores once,
    checking its crc32 as it is loaded, and no array of an older one."""
    r1 = _mk(tmp_path)
    r1.run(4)
    reads = collections.Counter()
    real_load = np.load
    monkeypatch.setattr(np, "load", lambda path, *a, **kw: _CountingNpz(
        real_load(path, *a, **kw), str(path), reads))
    r2 = _mk(tmp_path)
    assert r2.maybe_resume() and r2.step == 4
    monkeypatch.undo()
    d = tmp_path / "step_00000004"
    expect = {}
    for fname in ("params.npz", "opt.npz"):
        with np.load(d / fname) as zf:
            expect.update({(str(d / fname), k): 1 for k in zf.files})
    assert dict(reads) == expect
    for a, b in zip(_state(r1), _state(r2)):
        assert torch.equal(a, b)


def test_resume_lets_a_host_fault_through(tmp_path, monkeypatch):
    """A MemoryError while a snapshot is read is no torn snapshot: it
    reaches the caller, and no snapshot is recorded as skipped."""
    r1 = _mk(tmp_path)
    r1.run(4)

    def out_of_memory(*a, **kw):
        raise MemoryError("host out of memory")

    monkeypatch.setattr(np, "load", out_of_memory)
    r2 = _mk(tmp_path)
    with pytest.raises(MemoryError):
        r2.maybe_resume()
    assert r2.mgr.skipped == [] and r2.step == 0


@pytest.mark.parametrize("part", ["params.npz", "opt.npz"])
def test_resume_skips_a_bit_flipped_newest_snapshot(tmp_path, part):
    """A flipped byte in either part of the newest snapshot is caught as
    it is read: the resume falls back to the older snapshot (recorded in
    `skipped`), bit-equal to a run stopped there."""
    r_at2 = _mk(tmp_path / "ref")
    r_at2.run(2)
    r1 = _mk(tmp_path / "run")
    r1.run(4)
    path = tmp_path / "run" / "step_00000004" / part
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    r2 = _mk(tmp_path / "run")
    assert r2.maybe_resume() and r2.step == 2
    assert r2.mgr.skipped == [4]
    assert r2.data.step == 2
    for a, b in zip(_state(r_at2), _state(r2)):
        assert torch.equal(a, b)


def test_straggler_watchdog(tmp_path):
    r = _mk(tmp_path, ckpt_every=100)
    orig = r.step_fn
    took = []

    def slow_step(p, o, b):
        # step 6 sleeps well past 3x the steps before it (the first, which
        # warms up, aside), however slow a loaded machine makes them
        if r.step == 6:
            time.sleep(1.0 + 4 * max(took[1:]))
        t = time.perf_counter()
        out = orig(p, o, b)
        took.append(time.perf_counter() - t)
        return out

    r.step_fn = slow_step
    r.run(8)
    assert 6 in r.straggler_events


def test_train_runner_shares_fault_ledger(tmp_path):
    """The TrainRunner watchdog IS the shared FaultLedger trailing-median
    idiom — events land in the ledger a caller passed in."""
    class Data:
        def next_batch(self):
            return None

    led = F.FaultLedger(name="shared")
    calls = {"n": 0}

    def step(p, o, b):
        calls["n"] += 1
        if calls["n"] == 7:
            time.sleep(0.25)
        return p, o, {}

    r = TrainRunner(step, {}, None, Data(), ckpt_dir=str(tmp_path),
                    ckpt_every=10 ** 6, ledger=led)
    assert r.faults is led
    r.run(9)
    assert 6 in r.straggler_events
    assert led.counters["straggler"] >= 1
    assert "train.step" in r.explain_faults()


def test_train_driver_end_to_end(tmp_path):
    from repro_torch.launch.train import main
    loss = main(["--arch", "llama3-8b", "--smoke", "--steps", "6",
                 "--global-batch", "4", "--seq", "16", "--device", "cpu",
                 "--ckpt", str(tmp_path), "--ckpt-every", "3"])
    assert np.isfinite(loss)
    # resume continues from the checkpoint
    loss2 = main(["--arch", "llama3-8b", "--smoke", "--steps", "8",
                  "--global-batch", "4", "--seq", "16", "--device", "cpu",
                  "--ckpt", str(tmp_path), "--resume"])
    assert np.isfinite(loss2)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-tiny"])
def test_train_launcher_loss_matches_reference(tmp_path, monkeypatch, arch):
    """`python -m repro_torch.launch.train --smoke --device cpu` builds the
    reference launcher's data (M-RoPE positions for the vlm family, the
    encoder's frames for the audio family) and, holding the reference's
    weights, ends two steps at the reference launcher's loss (1e-4
    relative)."""
    from repro.launch.train import main as jax_main
    from repro_torch.launch.train import main
    from repro_torch.models import LM, Whisper
    args = ["--arch", arch, "--smoke", "--steps", "2", "--global-batch",
            "4", "--seq", "16", "--ckpt-every", "100", "--seed", "0"]
    want = jax_main(args + ["--ckpt", str(tmp_path / "ref")])
    tree = jax.tree.map(np.asarray,
                        jax_get_model(jax_smoke_config(arch)).init(0))

    def init_from_jax(self, seed=0):
        assert seed == 0
        loaded = _from_numpy(self.cfg, tree)
        self.load_state_dict(loaded.state_dict())
        return self
    monkeypatch.setattr(Whisper if arch == "whisper-tiny" else LM, "init",
                        init_from_jax)
    got = main(args + ["--ckpt", str(tmp_path / "port"), "--device", "cpu"])
    assert _rel(got, want) <= GRAD_TOL, (got, want)


def test_loss_decreases_on_learnable_data():
    """Real learning signal: constant-token data should drive CE down."""
    cfg = smoke_config("llama3-8b")
    model = lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jax_get_model(
            jax_smoke_config("llama3-8b")).init(0)), device="cpu")
    step = make_train_step(cfg, None, ("data",), lr=1e-2,
                           compress_grads=False)
    batch = {"tokens": np.full((4, 16), 7, np.int32),
             "labels": np.full((4, 16), 7, np.int32)}
    opt = adamw_init(dict(model.named_leaves()))
    first = None
    for _ in range(10):
        model, opt, m = step(model, opt, batch)
        first = first if first is not None else float(m["loss"])
    assert float(m["loss"]) < first * 0.5, (first, float(m["loss"]))


# ---------------------------------------------------------------------------
# snapshots that cross between the packages
# ---------------------------------------------------------------------------

def _jax_runner(tmp, ckpt_every=2, arch="llama3-8b"):
    jcfg = jax_smoke_config(arch)
    params = jax_get_model(jcfg).init(0)
    data = _data(jcfg, 4, 16)
    step = jax.jit(jax_make_train_step(jcfg, None, ("data",),
                                       compress_grads=False))
    return JaxTrainRunner(step, params, jax_adamw_init(params), data,
                          ckpt_dir=str(tmp), ckpt_every=ckpt_every)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    r = _jax_runner(tmp_path_factory.mktemp("ref"), ckpt_every=10 ** 6)
    r.run(6)
    return dict(_flat(jax.tree.map(np.asarray, r.params)))


def _check_against(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float32), w,
                                   rtol=0, atol=PARAM_TOL, err_msg=k)


def test_reference_snapshot_resumes_in_port(tmp_path, reference_run):
    ref = _jax_runner(tmp_path)
    ref.run(4)                     # snapshots at steps 2 and 4
    ref.mgr.wait()
    r = _mk(tmp_path)              # the same directory, the port's runner
    assert r.maybe_resume()
    assert r.step == 4 and r.data.step == 4 and int(r.opt_state.step) == 4
    r.run(6)
    _check_against(dict(_flat(lm_params_to_numpy(r.params.cfg, r.params))),
                   reference_run)


def test_port_snapshot_resumes_in_reference(tmp_path, reference_run):
    r = _mk(tmp_path)
    r.run(4)
    r.mgr.wait()
    ref = _jax_runner(tmp_path)
    assert ref.maybe_resume()
    assert ref.step == 4 and ref.data.step == 4
    assert int(ref.opt_state.step) == 4
    ref.run(6)
    _check_against(dict(_flat(jax.tree.map(np.asarray, ref.params))),
                   reference_run)



@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "recurrentgemma-2b",
                                  "whisper-tiny"])
def test_family_snapshots_cross_between_the_packages(tmp_path, arch):
    """A moe, a hybrid and a Whisper snapshot cross both ways: the port
    resumes the reference's step-4 snapshot and holds its parameters and
    moments bit for bit, and the reference resumes the port's."""
    ref = _jax_runner(tmp_path / "a", arch=arch)
    ref.run(4)
    ref.mgr.wait()
    r = _mk(tmp_path / "a", arch)
    assert r.maybe_resume()
    assert r.step == 4 and r.data.step == 4 and int(r.opt_state.step) == 4
    cfg = r.params.cfg
    got = dict(_flat(_to_numpy(cfg, r.params)))
    for k, w in _flat(jax.tree.map(np.asarray, ref.params)):
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    for name in ("mu", "nu"):
        mine = dict(_flat(_tree_to_numpy(cfg, getattr(r.opt_state, name))))
        for k, w in _flat(jax.tree.map(np.asarray,
                                       getattr(ref.opt_state, name))):
            np.testing.assert_array_equal(mine[k], w, err_msg=(name, k))
    port = _mk(tmp_path / "b", arch)
    port.run(4)
    port.mgr.wait()
    back = _jax_runner(tmp_path / "b", arch=arch)
    assert back.maybe_resume() and back.step == 4 and back.data.step == 4
    want = dict(_flat(_to_numpy(cfg, port.params)))
    for k, w in _flat(jax.tree.map(np.asarray, back.params)):
        np.testing.assert_array_equal(w, want[k], err_msg=k)


# ---------------------------------------------------------------------------
# RankGroup runs on the card unless asked for the CPU
# ---------------------------------------------------------------------------

def test_rank_group_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.launch.ranks import RankGroup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RankGroup(2)
    g = RankGroup(2, device="cpu")          # nothing starts before run()
    assert g.backend == "gloo" and g.device == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert RankGroup(2).backend == "nccl"   # one card a rank
    assert RankGroup(4).backend == "gloo"   # ranks share the cards


@pytest.mark.parametrize("module", ["repro_torch.convert",
                                    "repro_torch.models.lm",
                                    "repro_torch.runtime.ft",
                                    "repro_torch.train.step"])
def test_each_training_module_imports_first(module):
    """The training path's modules and the weight converter import in a
    fresh interpreter as its first import: no import cycle between
    `convert`, `core` and the models."""
    src = Path(__file__).resolve().parent.parent / "src"
    r = subprocess.run([sys.executable, "-c", f"import {module}"],
                       env={**os.environ, "PYTHONPATH": str(src)},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
