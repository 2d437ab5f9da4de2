"""What the ranks of tests/test_torch_train_dp.py run: the port's data-
parallel train step on one rank of a `RankGroup`, on its part of the
global batch.  Imports torch, numpy and the port only (no jax): the test
computes the reference in its own process and sends numpy arrays here.
"""
import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.convert import (lm_params_from_numpy, lm_tree_from_numpy,
                                 lm_tree_to_numpy, whisper_params_from_numpy,
                                 whisper_tree_from_numpy,
                                 whisper_tree_to_numpy)
from repro_torch.data import SyntheticLMData
from repro_torch.models import moe
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import TrainRunner
from repro_torch.train import make_train_step
from repro_torch.train import step as step_mod

B, S = 4, 16


def config(arch, over):
    return smoke_config(arch).replace(ce_chunk=8, **over)


def _audio(cfg):
    return cfg.family == "audio"


def data(cfg, seed, rank=0, world=1):
    """The reference launcher's data (frames for the audio family, M-RoPE
    positions for the vlm family), rank `rank`'s rows of `world`."""
    return SyntheticLMData(cfg.vocab_size, B, S, seed=seed,
                           host_index=rank, host_count=world,
                           microbatch=cfg.microbatch,
                           with_frames=cfg.enc_seq if _audio(cfg) else 0,
                           d_model=cfg.d_model,
                           with_pos_ids=cfg.family == "vlm")


def model_of(cfg, tree):
    load = whisper_params_from_numpy if _audio(cfg) else lm_params_from_numpy
    return load(cfg, tree, device="cpu")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _unflat(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *heads, last = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def state(cfg, model, opt) -> dict:
    """{"params" | "mu" | "nu": {reference path: numpy}} of a rank."""
    dump = whisper_tree_to_numpy if _audio(cfg) else lm_tree_to_numpy
    leaves = dict(model.named_leaves())
    return {name: {k: np.array(v) for k, v in _flat(dump(cfg, part))}
            for name, part in (("params", leaves), ("mu", opt.mu),
                               ("nu", opt.nu))}


def _align(cfg, model, opt, align):
    """Set the elements `align["mask"]` marks to the reference's values,
    in the parameters and both moments (test_torch_train's `_align`)."""
    dump = whisper_tree_to_numpy if _audio(cfg) else lm_tree_to_numpy
    load = whisper_tree_from_numpy if _audio(cfg) else lm_tree_from_numpy
    for name, leaves in (("params", dict(model.named_leaves())),
                         ("mu", opt.mu), ("nu", opt.nu)):
        got = dict(_flat(dump(cfg, leaves)))
        for k, mask in align["mask"].items():
            got[k] = np.where(mask, align[name][k], got[k]) \
                .astype(got[k].dtype)
        load(cfg, _unflat(got), leaves)


def _probe():
    """Wrap the MoE dispatch: (experts, kept) of every call, in order."""
    seen, real = [], moe._dispatch

    def probed(flat_e, *a, **kw):
        out = real(flat_e, *a, **kw)
        seen.append((flat_e.numpy().copy(), out[1].numpy().copy()))
        return out
    moe._dispatch = probed
    return seen, lambda: setattr(moe, "_dispatch", real)


def train(mesh, arch, over, tree, steps, seed, compress=False, align=None):
    """`steps` steps of the data-parallel step from the reference's
    weights `tree`, on this rank's rows: per step the loss, grad_norm and
    state (after the step, before `align` is applied to the first), and
    the MoE dispatches' (experts, kept) in call order."""
    cfg = config(arch, over)
    model = model_of(cfg, tree)
    rows = data(cfg, seed, mesh.rank, mesh.size)
    step = make_train_step(cfg, mesh, compress_grads=compress)
    opt = adamw_init(dict(model.named_leaves()))
    seen, restore = _probe()
    calls, nbytes = dict(mesh.coll.calls), dict(mesh.coll.bytes)
    out = []
    try:
        for i in range(steps):
            model, opt, m = step(model, opt, rows.next_batch())
            out.append({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "state": state(cfg, model, opt)})
            if i == 0 and align is not None:
                _align(cfg, model, opt, align)
    finally:
        restore()
    return {"steps": out, "dispatch": seen,
            "calls": _since(mesh.coll.calls, calls),
            "bytes": _since(mesh.coll.bytes, nbytes)}


def _since(counts, before: dict) -> dict:
    """The counts made since `before` (the mesh's collectives live as long
    as the rank)."""
    return {k: n - before.get(k, 0) for k, n in counts.items()
            if n != before.get(k, 0)}


def runner(mesh, arch, tree, ckpt_dir, ckpt_every, seed):
    """A TrainRunner of the data-parallel step on this rank."""
    cfg = config(arch, {})
    model = model_of(cfg, tree)
    step = make_train_step(cfg, mesh, compress_grads=False)
    return TrainRunner(step, model, adamw_init(dict(model.named_leaves())),
                       data(cfg, seed, mesh.rank, mesh.size),
                       ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)


def run_to(mesh, arch, tree, ckpt_dir, ckpt_every, seed, steps,
           fail_at=None, resume=False):
    """A runner on this rank run to `steps` (failing at `fail_at`, then
    waiting for rank 0's snapshots), resumed first if `resume`: (resumed
    step, data step, state) of the rank."""
    from repro_torch.runtime.ft import SimulatedFailure
    r = runner(mesh, arch, tree, ckpt_dir, ckpt_every, seed)
    resumed = r.maybe_resume() and r.step if resume else None
    data_step = r.data.step
    try:
        r.run(steps, fail_at_step=fail_at)
    except SimulatedFailure:
        r.wait()
    return {"resumed": resumed, "data_step": data_step, "step": r.step,
            "state": state(r.params.cfg, r.params, r.opt_state)}


def exchanged(mesh, arch, tree, seed):
    """Two steps with compress_grads=True: per step the loss and grad_norm,
    and of the first step this rank's gradients before the exchange
    ("local") and after it ("exchanged", the bf16 sum), as float32."""
    cfg = config(arch, {})
    model = model_of(cfg, tree)
    rows = data(cfg, seed, mesh.rank, mesh.size)
    step = make_train_step(cfg, mesh, compress_grads=True)
    opt = adamw_init(dict(model.named_leaves()))
    seen, real = {}, step_mod.GradBuckets.mean

    def probed(self, grads, loss, compress):
        local = {k: g.float().numpy().copy() for k, g in grads.items()}
        out = real(self, grads, loss, compress)
        seen.setdefault("local", local)
        seen.setdefault("exchanged", {k: g.float().numpy().copy()
                                      for k, g in out[0].items()})
        return out
    step_mod.GradBuckets.mean = probed
    steps = []
    try:
        for _ in range(2):
            model, opt, m = step(model, opt, rows.next_batch())
            steps.append({"loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"])})
    finally:
        step_mod.GradBuckets.mean = real
    return {**seen, "steps": steps}


def bucketed(mesh, arch, tree, seed, nbytes):
    """Two steps with buckets of at most `nbytes`: the state after them,
    the buckets (count, (bytes, leaves) each), whether the second step
    reused the first's, and the collective calls."""
    cfg = config(arch, {})
    model = model_of(cfg, tree)
    rows = data(cfg, seed, mesh.rank, mesh.size)
    calls = dict(mesh.coll.calls)
    real, step_mod.BUCKET_BYTES = step_mod.BUCKET_BYTES, nbytes
    try:
        step = make_train_step(cfg, mesh, compress_grads=False)
        opt = adamw_init(dict(model.named_leaves()))
        ptrs = []
        for _ in range(2):
            model, opt, _ = step(model, opt, rows.next_batch())
            ptrs.append([b[0].data_ptr() for b in step.exchange.buckets])
    finally:
        step_mod.BUCKET_BYTES = real
    buckets = step.exchange.buckets
    return {"state": state(cfg, model, opt), "buckets": len(buckets),
            "same_buckets": ptrs[0] == ptrs[1],
            "sizes": [(b[0].numel() * b[0].element_size(), len(b[2]))
                      for b in buckets],
            "calls": _since(mesh.coll.calls, calls)}


def drifted(mesh, arch, tree, seed):
    """One step from weights that differ on rank 1 (ReplicaDivergence)."""
    cfg = config(arch, {})
    model = model_of(cfg, tree)
    if mesh.rank == 1:
        with torch.no_grad():
            model.final_norm.add_(1e-3)
    step = make_train_step(cfg, mesh, compress_grads=False)
    step(model, adamw_init(dict(model.named_leaves())),
         data(cfg, seed, mesh.rank, mesh.size).next_batch())
