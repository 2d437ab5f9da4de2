"""RG-LRU recurrent block (recurrentgemma-2b), as the reference's
`models/recurrent.py` computes it.

The gates are the reference's, in float32 (`_gates`).  The recurrence
h_t = a_t ⊙ h_{t-1} + b_t over [B, S, lru_width] is the selective scan at
N = 1 with c = 1 (so y_t is h_t itself): one call of the hand-written
scan kernel's (a, bx) entry per layer and prefill on the card, from h0
and returning the last state for the decode cache.  When autograd records
(training), the call goes through `selective_scan_grad`, whose backward
is the same entry's hand-written reverse walk, so a, b and everything
before them (the gates, `lam`, `in_x`, the conv) get their gradients;
torch differentiates the gates.  The reference scans
chunks of `scan_chunk` steps with `associative_scan`; the port walks the
whole sequence in order, which is the same recurrence summed in another
order, and holds nothing wider than [B, S, lru_width].  Decode is one
plain step.  Gate projections are dense [w, w], as the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.selective_scan import selective_scan_grad
from .common import ParamDef, dense
from .ssm import _causal_conv

_C = 8.0  # RG-LRU exponent scale


def rglru_defs(cfg) -> dict[str, ParamDef]:
    d, w, k = cfg.d_model, cfg.lru_width, cfg.ssm_conv
    dt = cfg.param_dtype
    return {
        "in_x": ParamDef((d, w), ("embed", "lru"), dt),
        "in_y": ParamDef((d, w), ("embed", "lru"), dt),
        "conv_w": ParamDef((k, w), ("conv", "lru"), dt),
        "conv_b": ParamDef((w,), ("lru",), dt, init="zeros"),
        "gate_a": ParamDef((w, w), ("lru", "none"), dt),
        "gate_x": ParamDef((w, w), ("lru", "none"), dt),
        "lam": ParamDef((w,), ("lru",), torch.float32, init="ones"),
        "out": ParamDef((w, d), ("lru", "embed"), dt),
    }


def rglru_cache_defs(cfg, batch: int):
    """(shape, dtype) of each cache leaf."""
    w, k = cfg.lru_width, cfg.ssm_conv
    return {"conv": ((batch, k - 1, w), cfg.cache_dtype),
            "h": ((batch, w), torch.float32)}


def _gates(p, xc):
    """a_t (decay) and gated input for xc: [B, C, w] (float32 math)."""
    x32 = xc.float()
    r = torch.sigmoid(dense(x32, p["gate_a"].float()))
    i = torch.sigmoid(dense(x32, p["gate_x"].float()))
    log_a = -_C * F.softplus(p["lam"]) * r                    # [B,C,w]
    a = torch.exp(log_a)
    gated = i * x32
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * gated
    return a, b


def rglru_forward(cfg, p, x, *, h0=None, conv0=None, return_state=False):
    """x: [B,S,d] -> [B,S,d] (with return_state also the decode cache
    {conv, h})."""
    xb = dense(x, p["in_x"])
    yg = F.gelu(dense(x, p["in_y"]), approximate="tanh")
    xc, conv_tail = _causal_conv(xb, p["conv_w"], p["conv_b"], conv0)
    a, bb = _gates(p, xc)
    h_seq, h_last = selective_scan_grad(
        a[..., None], bb[..., None],
        None if h0 is None else h0.float()[..., None], return_state=True)
    out = dense((h_seq * yg.float()).to(x.dtype), p["out"])
    if return_state:
        return out, {"conv": conv_tail.to(cfg.cache_dtype),
                     "h": h_last[..., 0]}
    return out


def rglru_decode(cfg, p, x, cache):
    """x: [B,1,d]; cache: {conv: [B, k-1, w], h: [B, w]}.  Returns (y,
    new cache)."""
    k = cfg.ssm_conv
    xb = dense(x, p["in_x"])
    yg = F.gelu(dense(x, p["in_y"]), approximate="tanh")
    window = torch.cat([cache["conv"].to(xb.dtype), xb], dim=1)
    xc = sum(window[:, i] * p["conv_w"][i].to(xb.dtype) for i in range(k))
    xc = (xc + p["conv_b"].to(xb.dtype))[:, None]             # [B,1,w]
    a, bb = _gates(p, xc)
    h = a[:, 0] * cache["h"] + bb[:, 0]                       # [B,w]
    out = dense((h[:, None] * yg.float()).to(x.dtype), p["out"])
    return out, {"conv": window[:, 1:].to(cfg.cache_dtype), "h": h}
