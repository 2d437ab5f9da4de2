"""Training step: loss -> grads -> AdamW, the PyTorch port of the
reference's src/repro/train/step.py.

`make_train_step(cfg, ...)` returns `train_step(model, opt_state, batch)
-> (model, opt_state, metrics)`.  The model is updated in
place (its parameters and the moments of `opt_state`); the reference's
functional step returns new trees instead.  Semantics are the reference's:

* gradient-accumulation microbatching (cfg.microbatch = k > 1): the batch
  cut into k slices along its first dimension, float32 gradients summed
  over them in order and divided by k, the loss likewise;
* optional bf16 gradient compression (`compress_grads`): float32
  gradients cast to bf16 before the update;
* AdamW (`optim/adamw.py`) with the given lr and weight decay; metrics
  {"loss", "grad_norm", "lr"}, as 0-d tensors (read them with float()).

The model is any of the ten architectures' (`models.get_model`): an `LM`
of dense, moe, ssm, rec and lattn layers, or `Whisper`, whose batch also
carries the encoder's frames.  The step runs eagerly (the reference jits
it; a CUDA-graph step is a ROADMAP.md item).  `mesh` other than None
raises: data-parallel training over a `RankGroup` is not ported yet.
"""
from __future__ import annotations

import torch

from ..optim.adamw import adamw_update


def _slices(batch: dict, k: int) -> list[dict]:
    b = len(batch["tokens"])
    if b % k:
        raise ValueError(f"microbatch {k} does not divide the batch of {b}")
    m = b // k
    return [{key: v[i * m:(i + 1) * m] for key, v in batch.items()}
            for i in range(k)]


def make_train_step(cfg, mesh=None, dp_axes=("data",), lr=3e-4,
                    compress_grads=True, weight_decay=0.1):
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step: data-parallel training over a mesh is not "
            "ported yet (ROADMAP.md, Queue 1, 'Data-parallel training over "
            "a RankGroup'); pass mesh=None")
    k = max(1, cfg.microbatch)

    def grads_of(model, params, batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), metrics, dict(zip(params, grads))

    def train_step(model, opt_state, batch):
        model.train_mode()
        params = dict(model.named_leaves())
        if k == 1:
            loss, metrics, grads = grads_of(model, params, batch)
            metrics = {n: v.detach() for n, v in metrics.items()}
        else:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for mb in _slices(batch, k):
                l, _, g = grads_of(model, params, mb)
                for n, gi in g.items():
                    grads[n] += gi.float()
                loss = loss + l
                del g
            grads = {n: g / k for n, g in grads.items()}
            loss = loss / k
            metrics = {"loss": loss}
        if compress_grads:
            grads = {n: g.to(torch.bfloat16) if g.dtype == torch.float32
                     else g for n, g in grads.items()}
        _, opt_state, om = adamw_update(params, grads, opt_state, lr=lr,
                                        weight_decay=weight_decay)
        return model, opt_state, {**metrics, **om}

    return train_step
