"""AdamW with float32 moments, global-norm clipping and a cosine schedule:
the PyTorch port of the reference's src/repro/optim/adamw.py.

The update is the reference's formula term for term, in float32, under
`torch.no_grad` (not `torch.optim`): clip by the global norm, bias-corrected
moments, decoupled weight decay, the result cast back to each parameter's
dtype.  Moments are float32 (bf16 under the config's `opt_dtype="bf16"`).

The port updates in place.  `params` is a flat dict {path: tensor} (an
LM's `dict(model.named_leaves())`) or a module, whose parameters are taken
by name; grads and the moments are dicts with the same keys.  The update
is `kernels.adamw`: on the card two multi-tensor launches over every leaf
(the global norm and clip scale to device scalars, then each element's
p, g, m, v read once and p, m, v written once, the formula's float32
operations in its order, each rounded alone); on the CPU its plain
versions, the norm summed in the kernel's order and the update leaf by
leaf.  The step counter is incremented in place on its device, and the
learning rate and the bias corrections are formed there, so that a CUDA
graph of the train step (`train/graph.py`) replays them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels.adamw import adamw, clip_scale


class AdamWState(NamedTuple):
    step: torch.Tensor        # scalar int32
    mu: dict                  # {path: tensor} like params, float32 (or bf16)
    nu: dict

    def to_tree(self, layout) -> dict:
        """The state as a snapshot holds it: `.step`, `.mu` and `.nu`, the
        keys under which the reference's checkpoint manager flattens its
        AdamWState; `layout` maps a dict of moments to their tree (the
        model's `to_tree`)."""
        return {".step": self.step, ".mu": layout(self.mu),
                ".nu": layout(self.nu)}

    @torch.no_grad()
    def load_tree(self, tree: dict, load) -> None:
        """Copy a tree of `to_tree`'s layout into this state in place;
        `load(tree, into)` copies a moments' tree into a dict of moments
        (the model's `load_tree`)."""
        load(tree[".mu"], self.mu)
        load(tree[".nu"], self.nu)
        self.step.fill_(int(tree[".step"]))


def _leaves(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


def adamw_init(params, dtype=torch.float32) -> AdamWState:
    params = _leaves(params)

    def z(p):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)
    dev = next(iter(params.values())).device if params else "cpu"
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      {k: z(p) for k, p in params.items()},
                      {k: z(p) for k, p in params.items()})


@torch.no_grad()
def global_norm(grads: dict) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ g²), float32, the leaves in dict order."""
    total = None
    for g in grads.values():
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """({path: g·scale float32}, the global norm), scale = min(1, max_norm /
    (norm + 1e-9))."""
    gn = global_norm(grads)
    scale = clip_scale(gn, max_norm)
    return {k: g.float() * scale for k, g in grads.items()}, gn


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


@torch.no_grad()
def adamw_update(params, grads: dict, state: AdamWState, *, lr, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1, max_norm=1.0):
    """Update `params` and the moments in place; returns (params, the state
    with its step counter incremented in place, metrics {"grad_norm",
    "lr"}).  grads may be bf16; the math is float32.  The global norm is
    taken before any leaf changes."""
    params = _leaves(params)
    step = state.step.add_(1)
    lr_t = lr(step) if callable(lr) else torch.full(
        (), lr, dtype=torch.float32, device=step.device)
    stepf = step.float()
    b1t = 1.0 - torch.pow(b1, stepf)
    b2t = 1.0 - torch.pow(b2, stepf)
    gn, _ = adamw(list(params.values()), [grads[k] for k in params],
                  [state.mu[k] for k in params], [state.nu[k] for k in params],
                  lr_t=lr_t, b1t=b1t, b2t=b2t, b1=b1, b2=b2, eps=eps,
                  weight_decay=weight_decay, max_norm=max_norm)
    return params, state, {"grad_norm": gn, "lr": lr_t}
