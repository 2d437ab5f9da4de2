"""Mamba-1 selective SSM block (falcon-mamba-7b), as the reference's
`models/ssm.py` computes it.

The prefill hands the scan's small inputs (dt [B, S, di], A [di, N], B and
C [B, S, N], the conv'd activations x) to `selective_scan_fused`, which
forms the discretised a_t = exp(dt·A) and bx_t = (dt·x)·B itself.  On the
card the hand-written kernel forms them in registers, so it takes the
whole prompt in one call per layer and nothing [B, S, di, N]-sized is
allocated.  On the CPU its plain version materialises them, so there the
reference's chunking bounds memory: one chunk of `scan_chunk` steps at a
time (the whole sequence when `scan_chunk` does not divide it), each from
the state the previous chunk left.  The reference scans a chunk with
`associative_scan`; the port walks it in order, which is the same
recurrence summed in another order.  Decode is one plain step.

Training runs the same forward with autograd on: the scan goes through
`selective_scan_fused_grad`, whose backward is the hand-written
`selective_scan_bwd` kernel on the card (the chunks of the CPU path chain
through h, whose gradient the Function carries back).  The dt projection
stays float32, as the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.selective_scan import selective_scan_fused_grad
from .common import ParamDef, dense


def ssm_defs(cfg) -> dict[str, ParamDef]:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, k = cfg.ssm_dt_rank, cfg.ssm_conv
    dt = cfg.param_dtype
    return {
        "in_proj": ParamDef((d, 2 * di), ("embed", "dinner"), dt),
        "conv_w": ParamDef((k, di), ("conv", "dinner"), dt),
        "conv_b": ParamDef((di,), ("dinner",), dt, init="zeros"),
        "x_proj": ParamDef((di, dtr + 2 * n), ("dinner", "none"), dt),
        "dt_proj": ParamDef((dtr, di), ("dtrank", "dinner"), dt),
        "dt_bias": ParamDef((di,), ("dinner",), torch.float32, init="ssm_dt"),
        "a_log": ParamDef((di, n), ("dinner", "state"), torch.float32,
                          init="ssm_a"),
        "d_skip": ParamDef((di,), ("dinner",), torch.float32, init="ones"),
        "out_proj": ParamDef((di, d), ("dinner", "embed"), dt),
    }


def ssm_cache_defs(cfg, batch: int):
    """(shape, dtype) of each cache leaf."""
    di, n, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"conv": ((batch, k - 1, di), cfg.cache_dtype),
            "h": ((batch, di, n), torch.float32)}


def _causal_conv(x, w, b, init_state=None):
    """Depthwise causal conv over seq. x: [B,S,di]; w: [k,di]."""
    k = w.shape[0]
    if init_state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = init_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(k))
    return out + b.to(x.dtype), xp[:, -(k - 1):] if k > 1 else pad


def _ssm_inputs(cfg, p, x):
    """The scan's inputs before discretisation, from conv'd activations x:
    [B, C, di] -> dt [B, C, di], A [di, N], B and C [B, C, N], float32."""
    n, dtr = cfg.ssm_state, cfg.ssm_dt_rank
    proj = dense(x, p["x_proj"]).float()
    dt_r, bt, ct = torch.split(proj, [dtr, n, n], dim=-1)
    dt = F.softplus(dense(dt_r, p["dt_proj"].float()) + p["dt_bias"])
    a = -torch.exp(p["a_log"])                                # [di, N]
    return dt, a, bt, ct


def _ssm_params(cfg, p, x):
    """Per-step SSM tensors from conv'd activations x: [B, C, di]."""
    dt, a, bt, ct = _ssm_inputs(cfg, p, x)
    da = torch.exp(dt[..., None] * a)                         # [B,C,di,N]
    db_x = (dt * x.float())[..., None] * bt[..., None, :]
    return da, db_x, ct


def mamba_forward(cfg, p, x, *, h0=None, conv0=None, return_state=False):
    """x: [B,S,d] -> [B,S,d].  Chunked selective scan."""
    b, s, _ = x.shape
    xz = dense(x, p["in_proj"])
    xin, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_tail = _causal_conv(xin, p["conv_w"], p["conv_b"], conv0)
    xc = F.silu(xc)

    if xc.device.type == "cuda":
        chunk = s     # the kernel materialises nothing N-wide: one call
    else:
        chunk = min(cfg.scan_chunk, s)
        if s % chunk != 0:
            chunk = s  # fallback: single chunk for odd lengths
    h = h0
    ys = []
    for c0 in range(0, s, chunk):
        xc_c = xc[:, c0:c0 + chunk]
        dt, a, bt, ct = _ssm_inputs(cfg, p, xc_c)
        y_c, h = selective_scan_fused_grad(dt, a, bt, ct, xc_c, h,
                                           return_state=True)
        ys.append(y_c)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    y = y + xc.float() * p["d_skip"]
    y = (y * F.silu(z.float())).to(x.dtype)
    out = dense(y, p["out_proj"])
    if return_state:
        return out, {"conv": conv_tail.to(cfg.cache_dtype), "h": h}
    return out


def mamba_decode(cfg, p, x, cache):
    """One-step decode. x: [B,1,d]; cache: {conv:[B,k-1,di], h:[B,di,N]}.
    Returns (y, new cache)."""
    xz = dense(x, p["in_proj"])
    xin, z = torch.chunk(xz, 2, dim=-1)                        # [B,1,di]
    k = cfg.ssm_conv
    window = torch.cat([cache["conv"].to(xin.dtype), xin], dim=1)  # [B,k,di]
    xc = sum(window[:, i] * p["conv_w"][i].to(xin.dtype) for i in range(k))
    xc = F.silu(xc + p["conv_b"].to(xin.dtype))[:, None]         # [B,1,di]
    da, db, ct = _ssm_params(cfg, p, xc)
    h = da[:, 0] * cache["h"] + db[:, 0]                       # [B,di,N]
    y = torch.einsum("bdn,bn->bd", h, ct[:, 0])
    y = y + xc[:, 0].float() * p["d_skip"]
    y = (y * F.silu(z[:, 0].float()))[:, None].to(x.dtype)
    out = dense(y, p["out_proj"])
    return out, {"conv": window[:, 1:].to(cfg.cache_dtype), "h": h}
