"""Layer-kind dispatch: param defs + forward/prefill/decode per block kind.

Kinds: "dense" (GQA attn + SwiGLU), "moe" (GQA attn + MoE [+ dense
residual SwiGLU]), "ssm" (Mamba-1), "rec" (RG-LRU + SwiGLU) and "lattn"
(local-window attn + SwiGLU), as the reference's `models/blocks.py`.

`pos_ids` ([B, S, 3] M-RoPE positions) reaches the attention layers;
`moe_groups` (decode only) the MoE layers' capacity groups; `mesh` and
`dp_axes` (training over a mesh) the MoE layers.
"""
from __future__ import annotations

import torch

from . import attention as attn
from . import moe as moe_mod
from . import recurrent as rec_mod
from . import ssm as ssm_mod
from .common import ParamDef, rms_norm, swiglu


def _norm_def(cfg):
    return ParamDef((cfg.d_model,), ("embed",), torch.float32, init="zeros")


def _mlp_defs(cfg):
    d, ff = cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    return {"w_gate": ParamDef((d, ff), ("embed", "ff"), dt),
            "w_in": ParamDef((d, ff), ("embed", "ff"), dt),
            "w_out": ParamDef((ff, d), ("ff", "embed"), dt)}


def block_defs(cfg, kind: str) -> dict:
    if kind in ("dense", "lattn"):
        return {"ln1": _norm_def(cfg), "attn": attn.attn_defs(cfg),
                "ln2": _norm_def(cfg), "mlp": _mlp_defs(cfg)}
    if kind == "moe":
        d = {"ln1": _norm_def(cfg), "attn": attn.attn_defs(cfg),
             "ln2": _norm_def(cfg), "moe": moe_mod.moe_defs(cfg)}
        if cfg.dense_residual:
            d["mlp"] = _mlp_defs(cfg)
        return d
    if kind == "ssm":
        return {"ln": _norm_def(cfg), "ssm": ssm_mod.ssm_defs(cfg)}
    if kind == "rec":
        return {"ln1": _norm_def(cfg), "rec": rec_mod.rglru_defs(cfg),
                "ln2": _norm_def(cfg), "mlp": _mlp_defs(cfg)}
    raise ValueError(kind)


def block_cache_defs(cfg, kind: str, batch: int, max_seq: int):
    if kind in ("dense", "moe"):
        return attn.attn_cache_defs(cfg, batch, max_seq)
    if kind == "lattn":
        return attn.attn_cache_defs(cfg, batch, max_seq, window=cfg.window)
    if kind == "ssm":
        return ssm_mod.ssm_cache_defs(cfg, batch)
    if kind == "rec":
        return rec_mod.rglru_cache_defs(cfg, batch)
    raise ValueError(kind)


def _ffn(cfg, kind, p, h, moe_groups=1, mesh=None, dp_axes=("data",)):
    if kind == "moe":
        y = moe_mod.moe_forward(cfg, p["moe"], h, mesh, dp_axes,
                                groups=moe_groups)
        if cfg.dense_residual:
            y = y + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_in"],
                           p["mlp"]["w_out"])
        return y
    return swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_in"], p["mlp"]["w_out"])


def _window(cfg, kind):
    return cfg.window if kind == "lattn" else 0


def block_forward(cfg, kind, p, x, pos_ids=None, mesh=None,
                  dp_axes=("data",)):
    """Training-mode block. x: [B,S,d] -> [B,S,d]."""
    if kind == "ssm":
        return x + ssm_mod.mamba_forward(cfg, p["ssm"], rms_norm(x, p["ln"]))
    if kind == "rec":
        h = x + rec_mod.rglru_forward(cfg, p["rec"], rms_norm(x, p["ln1"]))
        return h + _ffn(cfg, kind, p, rms_norm(h, p["ln2"]))
    h = x + attn.attn_forward(cfg, p["attn"], rms_norm(x, p["ln1"]),
                              window=_window(cfg, kind), pos_ids=pos_ids)
    return h + _ffn(cfg, kind, p, rms_norm(h, p["ln2"]), mesh=mesh,
                    dp_axes=dp_axes)


def block_prefill(cfg, kind, p, x, cache, pos_ids=None):
    if kind == "ssm":
        y, c = ssm_mod.mamba_forward(cfg, p["ssm"], rms_norm(x, p["ln"]),
                                     return_state=True)
        return x + y, c
    if kind == "rec":
        y, c = rec_mod.rglru_forward(cfg, p["rec"], rms_norm(x, p["ln1"]),
                                     return_state=True)
        h = x + y
        return h + _ffn(cfg, kind, p, rms_norm(h, p["ln2"])), c
    y, c = attn.attn_prefill(cfg, p["attn"], rms_norm(x, p["ln1"]), cache,
                             window=_window(cfg, kind), pos_ids=pos_ids)
    h = x + y
    return h + _ffn(cfg, kind, p, rms_norm(h, p["ln2"])), c


def block_decode(cfg, kind, p, x, cache, pos, pos_ids=None, moe_groups=1):
    if kind == "ssm":
        y, c = ssm_mod.mamba_decode(cfg, p["ssm"], rms_norm(x, p["ln"]),
                                    cache)
        return x + y, c
    if kind == "rec":
        y, c = rec_mod.rglru_decode(cfg, p["rec"], rms_norm(x, p["ln1"]),
                                    cache)
        h = x + y
        return h + _ffn(cfg, kind, p, rms_norm(h, p["ln2"])), c
    y, c = attn.attn_decode(cfg, p["attn"], rms_norm(x, p["ln1"]), cache,
                            pos, window=_window(cfg, kind), pos_ids=pos_ids)
    h = x + y
    return h + _ffn(cfg, kind, p, rms_norm(h, p["ln2"]), moe_groups), c
