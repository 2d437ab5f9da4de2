"""Shared model-building machinery.

A parameter is described by a :class:`ParamDef`, as in the reference
package; a nested dict (or list) of them becomes a :class:`ParamTree`, an
`nn.Module` whose submodules and parameters carry the same names, so that
`p["attn"]["wq"]` reads as it does over the reference's param dicts.
Weights are stored as the reference stores them (a dense weight [in, out],
used as `x @ w`), so a weight converts one to one.  Parameters are made
without gradients, for serving; training turns them on
(`LM.train_mode()`).

Mesh and sharding helpers (`constrain`, `pspec_for`, `LOGICAL_RULES`) are
not ported: every rank holds the whole model, and training over a mesh is
data parallelism alone (train/step.py); the sharding constraints' tensor
parallelism over `model` is the ROADMAP.md item "Tensor parallelism over
the model axis".
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: tuple[str, ...]        # one logical axis name per dim
    dtype: Any = torch.bfloat16
    init: str = "lecun"             # lecun | normal | zeros | ones | ssm_a | ssm_dt

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"ParamDef: shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def generator_for(seed: int, path: str, device) -> torch.Generator:
    """A generator seeded from (seed, parameter path): every parameter
    draws its own stream, whatever the order of initialisation."""
    h = hashlib.sha256(f"{seed}/{path}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(h[:8], "little") & (2 ** 63 - 1))
    return g


# a "normal" or "lecun" leaf is drawn in slices of leading rows of at most
# _SLICE_CELLS cells, from the same generator: the float32 draw of a whole
# leaf (an arctic-480b expert stack is 4.5e9 cells) would not fit beside
# the model on one card; a leaf of at most _SLICE_CELLS cells is one draw
_SLICE_CELLS = 2 ** 30


def init_array(d: ParamDef, g: torch.Generator, device) -> torch.Tensor:
    """A "zeros", "ones", "ssm_a" or "ssm_dt" tensor drawn as the
    reference's `init_array` draws it (the same distributions; other
    numbers, since the generators differ)."""
    shape, dtype = d.shape, d.dtype
    if d.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if d.init == "ssm_a":  # A_log init: log(1..N) broadcast over d_inner
        n = shape[-1]
        a = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device))
        return a.expand(shape).to(dtype).contiguous()
    if d.init == "ssm_dt":  # dt bias ~ log-uniform in [1e-3, 1e-1]
        u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return torch.log(torch.expm1(dt)).to(dtype)
    raise ValueError(f"unknown init {d.init!r}")


def _init_in_slices(p: torch.Tensor, d: ParamDef, g: torch.Generator):
    """Fill a "normal" or "lecun" leaf as the reference's `init_array`
    draws it, slice by slice of leading rows, each a float32 draw of at
    most _SLICE_CELLS cells scaled by the whole leaf's scale."""
    if d.init == "normal":
        scale = 0.02
    else:
        # lecun: fan_in = product of all but last dim (or last-but-one
        # for stacks)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = 1.0 / fan_in ** 0.5
    rows = max(1, _SLICE_CELLS // (p.numel() // p.shape[0]))
    for i in range(0, p.shape[0], rows):
        part = p[i:i + rows]
        x = torch.randn(part.shape, generator=g, dtype=torch.float32,
                        device=p.device)
        part.copy_(x.mul_(scale))


class ParamTree(nn.Module):
    """A nested dict of ParamDefs as a module: a dict becomes a submodule,
    a list an `nn.ModuleList`, a ParamDef a parameter (allocated, not
    initialised: `init` fills it)."""

    def __init__(self, defs: dict, device):
        super().__init__()
        for name, d in defs.items():
            if isinstance(d, ParamDef):
                self.register_parameter(name, nn.Parameter(
                    torch.empty(d.shape, dtype=d.dtype, device=device),
                    requires_grad=False))
            elif isinstance(d, list):
                self.add_module(name, nn.ModuleList(
                    ParamTree(x, device) for x in d))
            else:
                self.add_module(name, ParamTree(d, device))
        self._defs = defs

    def __getitem__(self, name):
        return getattr(self, name)

    def get(self, name, default=None):
        return getattr(self, name, default)

    def leaves(self, prefix: str = ""):
        """(path, parameter, ParamDef) of every parameter, in order."""
        for name, d in self._defs.items():
            path = f"{prefix}{name}"
            if isinstance(d, ParamDef):
                yield path, getattr(self, name), d
            elif isinstance(d, list):
                for i, sub in enumerate(getattr(self, name)):
                    yield from sub.leaves(f"{path}/{i}/")
            else:
                yield from getattr(self, name).leaves(f"{path}/")

    def named_leaves(self):
        """(path, parameter) of every parameter, in the order they are
        made ("embed", ..., "layers/<l>/attn/wq", ...)."""
        return ((path, p) for path, p, _ in self.leaves())

    @torch.no_grad()
    def init(self, seed: int = 0):
        """Fill every parameter from `seed`, each from its own generator on
        the parameter's device."""
        for path, p, d in self.leaves():
            g = generator_for(seed, path, p.device)
            if d.init in ("normal", "lecun"):
                _init_in_slices(p, d, g)
            else:
                p.copy_(init_array(d, g, p.device))
        return self


# ---------------------------------------------------------------------------
# Basic NN ops (plain tensor functions)
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def dense(x, w, b=None):
    """x [..., d] @ w [d, f]; mixed dtypes promote, as jnp.einsum does."""
    dt = torch.promote_types(x.dtype, w.dtype)
    y = x.to(dt) @ w.to(dt)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def swiglu(x, w_gate, w_in, w_out):
    h = torch.nn.functional.silu(dense(x, w_gate)) * dense(x, w_in)
    return dense(h, w_out)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, pos, theta: float):
    """x: [..., S, H, hd]; pos: broadcastable to [..., S] (int)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    angles = pos.float()[..., None] * freqs                  # [..., S, hd/2]
    angles = angles[..., None, :]                            # [..., S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, pos3, theta: float, sections: tuple[int, ...]):
    """M-RoPE: head_dim/2 split into len(sections) position streams.

    x: [B, S, H, hd]; pos3: [B, S, 3] (temporal/height/width).  As the
    reference computes it: frequency j takes stream sec_id[j]'s position
    as its angle, with no frequency factor (the reference computes the
    frequencies and leaves them out; ROADMAP.md, 'Reference limits').
    `theta` is unused for that reason."""
    sec_id = torch.cat([torch.full((n,), i, device=x.device)   # [hd/2]
                        for i, n in enumerate(sections)])
    pos = pos3.float()[..., sec_id] if pos3.shape[-1] == 3 else pos3.float()
    angles = pos[..., None, :]                               # [B, S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
