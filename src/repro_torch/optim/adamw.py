"""AdamW with float32 moments, global-norm clipping and a cosine schedule:
the PyTorch port of the reference's src/repro/optim/adamw.py.

The update is the reference's formula term for term, in float32, under
`torch.no_grad` (not `torch.optim`): clip by the global norm, bias-corrected
moments, decoupled weight decay, the result cast back to each parameter's
dtype.  Moments are float32 (bf16 under the config's `opt_dtype="bf16"`).

The port updates in place.  `params` is a flat dict {path: tensor} (an
LM's `dict(model.named_leaves())`) or a module, whose parameters are taken
by name; grads and the moments are dicts with the same keys, in the same
order.  Every leaf is updated with float32 temporaries of its own size
only, one leaf at a time.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


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


def _clip_scale(gn, max_norm: float):
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """({path: g·scale float32}, the global norm), scale = min(1, max_norm /
    (norm + 1e-9))."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
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
    """Update `params` and the moments in place; returns (params, new state,
    metrics {"grad_norm", "lr"}).  grads may be bf16; the math is float32.
    The global norm is taken before any leaf changes; each leaf is then
    clipped, updated and written back on its own."""
    params = _leaves(params)
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)     # clip_by_global_norm, leaf by leaf
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=step.device)
    stepf = step.float()
    b1t = 1.0 - torch.tensor(b1, dtype=torch.float32,
                             device=step.device) ** stepf
    b2t = 1.0 - torch.tensor(b2, dtype=torch.float32,
                             device=step.device) ** stepf
    for k, p in params.items():
        g = grads[k].float() * scale
        m, v = state.mu[k], state.nu[k]
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        mh = m32 / b1t
        vh = v32 / b2t
        p32 = p.float()
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p32
        p.copy_((p32 - lr_t * delta).to(p.dtype))
        m.copy_(m32.to(m.dtype))
        v.copy_(v32.to(v.dtype))
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gn, "lr": lr_t}
