"""Layer-kind dispatch: param defs + forward/prefill/decode per block kind.

Ported kinds: "dense" (GQA attn + SwiGLU), "moe" (GQA attn + MoE
[+ dense residual SwiGLU]) and "ssm" (Mamba-1).  The reference's "rec"
and "lattn" kinds raise NotImplementedError naming their ROADMAP.md item.

`pos_ids` ([B, S, 3] M-RoPE positions) reaches the attention layers;
`moe_groups` (decode only) the MoE layers' capacity groups.
"""
from __future__ import annotations

import torch

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .common import ParamDef, rms_norm, swiglu

NOT_PORTED = {
    "rec": "ROADMAP.md, 'Modules to port': the rec and lattn layers",
    "lattn": "ROADMAP.md, 'Modules to port': the rec and lattn layers",
}


def _check_kind(kind: str):
    if kind in NOT_PORTED:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                  f"({NOT_PORTED[kind]})")
    if kind not in ("dense", "moe", "ssm"):
        raise ValueError(kind)


def _norm_def(cfg):
    return ParamDef((cfg.d_model,), ("embed",), torch.float32, init="zeros")


def _mlp_defs(cfg):
    d, ff = cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    return {"w_gate": ParamDef((d, ff), ("embed", "ff"), dt),
            "w_in": ParamDef((d, ff), ("embed", "ff"), dt),
            "w_out": ParamDef((ff, d), ("ff", "embed"), dt)}


def block_defs(cfg, kind: str) -> dict:
    _check_kind(kind)
    if kind == "ssm":
        return {"ln": _norm_def(cfg), "ssm": ssm_mod.ssm_defs(cfg)}
    if kind == "moe":
        d = {"ln1": _norm_def(cfg), "attn": attn.attn_defs(cfg),
             "ln2": _norm_def(cfg), "moe": moe_mod.moe_defs(cfg)}
        if cfg.dense_residual:
            d["mlp"] = _mlp_defs(cfg)
        return d
    return {"ln1": _norm_def(cfg), "attn": attn.attn_defs(cfg),
            "ln2": _norm_def(cfg), "mlp": _mlp_defs(cfg)}


def block_cache_defs(cfg, kind: str, batch: int, max_seq: int):
    _check_kind(kind)
    if kind == "ssm":
        return ssm_mod.ssm_cache_defs(cfg, batch)
    return attn.attn_cache_defs(cfg, batch, max_seq)


def _ffn(cfg, kind, p, h, moe_groups=1):
    if kind == "moe":
        y = moe_mod.moe_forward(cfg, p["moe"], h, groups=moe_groups)
        if cfg.dense_residual:
            y = y + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_in"],
                           p["mlp"]["w_out"])
        return y
    return swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_in"], p["mlp"]["w_out"])


def block_forward(cfg, kind, p, x, pos_ids=None):
    """Training-mode block. x: [B,S,d] -> [B,S,d]."""
    if kind == "ssm":
        return x + ssm_mod.mamba_forward(cfg, p["ssm"], rms_norm(x, p["ln"]))
    h = x + attn.attn_forward(cfg, p["attn"], rms_norm(x, p["ln1"]),
                              pos_ids=pos_ids)
    return h + _ffn(cfg, kind, p, rms_norm(h, p["ln2"]))


def block_prefill(cfg, kind, p, x, cache, pos_ids=None):
    if kind == "ssm":
        y, c = ssm_mod.mamba_forward(cfg, p["ssm"], rms_norm(x, p["ln"]),
                                     return_state=True)
        return x + y, c
    y, c = attn.attn_prefill(cfg, p["attn"], rms_norm(x, p["ln1"]), cache,
                             pos_ids=pos_ids)
    h = x + y
    return h + _ffn(cfg, kind, p, rms_norm(h, p["ln2"])), c


def block_decode(cfg, kind, p, x, cache, pos, pos_ids=None, moe_groups=1):
    if kind == "ssm":
        y, c = ssm_mod.mamba_decode(cfg, p["ssm"], rms_norm(x, p["ln"]),
                                    cache)
        return x + y, c
    y, c = attn.attn_decode(cfg, p["attn"], rms_norm(x, p["ln1"]), cache,
                            pos, pos_ids=pos_ids)
    h = x + y
    return h + _ffn(cfg, kind, p, rms_norm(h, p["ln2"]), moe_groups), c
