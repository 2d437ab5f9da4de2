"""GQA attention: global-causal, local-window (sliding), bidirectional
(encoder) and cross-attention, for training, prefill and decode, as the
reference's `models/attention.py` computes it, without the mesh
constraints.

Every full-sequence form (causal, causal within a window, non-causal with
any Sq and Sk) runs the hand-written `flash_attention` kernel on
[B·Hq, S, hd]; when autograd records, through its Function, whose
backward is the hand-written `flash_attention_bwd` kernel (the repeated
K/V heads' gradients are summed over each group by autograd of
`_repeat_kv`), the window and hd 256 (lattn) included.  The reference
slices each query chunk's key span for a window; both kernels skip the
key tiles no row of a block reaches, which is the same O(S·window) work.
Decode attention is plain torch, as the reference computes it outside
any kernel.

Local attention keeps a ring buffer of min(window, max_seq) rows.  Its
placement is the reference's: a prefill longer than the ring stores the
last `cap` keys at slots 0..cap-1, and decode writes position p at slot
p % cap and reads each slot's position back from that rule, so after a
prompt whose length the ring does not divide, decode attends to
positions other than the window's (ROADMAP.md, 'Reference limits').
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import flash_attention_grad
from .common import ParamDef, apply_mrope, apply_rope, dense

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------

def attn_defs(cfg) -> dict[str, ParamDef]:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    defs = {
        "wq": ParamDef((d, hq * hd), ("embed", "qkv"), dt),
        "wk": ParamDef((d, hkv * hd), ("embed", "qkv"), dt),
        "wv": ParamDef((d, hkv * hd), ("embed", "qkv"), dt),
        "wo": ParamDef((hq * hd, d), ("qkv", "embed"), dt),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((hq * hd,), ("qkv",), dt, init="zeros")
        defs["bk"] = ParamDef((hkv * hd,), ("qkv",), dt, init="zeros")
        defs["bv"] = ParamDef((hkv * hd,), ("qkv",), dt, init="zeros")
    return defs


def attn_cache_defs(cfg, batch: int, max_seq: int, *, window: int = 0):
    """(shape, dtype) of each cache leaf: [B, max_seq, Hkv, hd], or a ring
    of min(window, max_seq) rows for local attention."""
    s = min(window, max_seq) if window > 0 else max_seq
    shp = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (shp, cfg.cache_dtype), "v": (shp, cfg.cache_dtype)}


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def _repeat_kv(k, v, hq):
    g = hq // k.shape[2]
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    return k, v


def attention_core(q, k, v, *, causal=True, window=0):
    """q: [B,Sq,Hq,hd]; k,v: [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd], through the
    flash_attention kernel; query i and key j at positions i and j (the
    reference's q_pos and k_pos), causal keeping j <= i and `window` > 0
    keeping j > i - window.  The reference's query chunking (`attn_chunk`)
    bounds the memory of its [Sq, Sk] scores; the kernel never forms them,
    so it takes the whole sequence at once."""
    b, sq, hq, hd = q.shape
    sk = k.shape[1]
    k, v = _repeat_kv(k, v, hq)

    def heads_first(x, s):
        return x.transpose(1, 2).reshape(b * hq, s, hd)
    out = flash_attention_grad(heads_first(q, sq), heads_first(k, sk),
                               heads_first(v, sk), causal=causal,
                               window=window)
    return out.reshape(b, hq, sq, hd).transpose(1, 2)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + cache handling)
# ---------------------------------------------------------------------------

def _project_qkv(cfg, p, x):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(x, p["wq"], p.get("bq")).reshape(b, s, hq, hd)
    k = dense(x, p["wk"], p.get("bk")).reshape(b, s, hkv, hd)
    v = dense(x, p["wv"], p.get("bv")).reshape(b, s, hkv, hd)
    return q, k, v


def _rope(cfg, q, k, pos, pos_ids):
    """M-RoPE from `pos_ids` ([B, S, 3]) when the config has sections and
    the caller gives them, plain RoPE at `pos` otherwise (as the
    reference: its decode gets no pos_ids from the engine)."""
    if cfg.pos_embed != "rope":
        return q, k
    if cfg.mrope_sections and pos_ids is not None:
        sec = cfg.mrope_sections
        return (apply_mrope(q, pos_ids, cfg.rope_theta, sec),
                apply_mrope(k, pos_ids, cfg.rope_theta, sec))
    return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos,
                                                          cfg.rope_theta)


def attn_forward(cfg, p, x, *, window=0, causal=True, pos_ids=None):
    """Training / encoder forward (no cache). x: [B,S,d]."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    pos = torch.arange(s, device=x.device)
    q, k = _rope(cfg, q, k, pos, pos_ids)
    out = attention_core(q, k, v, causal=causal, window=window)
    return dense(out.reshape(b, s, -1), p["wo"])


def attn_prefill(cfg, p, x, cache, *, window=0, pos_ids=None):
    """Prefill: causal attention (within `window` when > 0), and the
    post-rope k/v stored into the zeroed cache it is given (`LM.prefill`
    makes a fresh one): at positions 0..S-1, or, for a ring shorter than
    the prompt, the last `cap` keys at slots 0..cap-1 (the reference's
    placement).  Returns (y, cache)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    pos = torch.arange(s, device=x.device)
    q, k = _rope(cfg, q, k, pos, pos_ids)
    out = attention_core(q, k, v, causal=True, window=window)
    kc, vc = cache["k"], cache["v"]
    w = kc.shape[1]
    if window > 0 and w < s:          # the ring keeps the last `w` steps
        kc.copy_(k[:, s - w:])
        vc.copy_(v[:, s - w:])
    else:
        kc[:, :s] = k.to(kc.dtype)
        vc[:, :s] = v.to(vc.dtype)
    return dense(out.reshape(b, s, -1), p["wo"]), {"k": kc, "v": vc}


def attn_decode(cfg, p, x, cache, pos, *, window=0, pos_ids=None):
    """One-token decode.  x: [B,1,d]; pos: [B] int, each row's count of
    tokens so far (a scalar is taken for every row).  Row r's rope angle
    is pos[r] (or, with `pos_ids` [B, 1, 3] on an M-RoPE config, its
    M-RoPE angles).  Global attention: its k/v land at cache[r, pos[r]]
    and it attends to the cache positions ≤ pos[r].  Local attention
    (`window` > 0): they land at ring slot pos[r] % cap, and it attends to
    the slots whose position by that rule, pos[r] - age, is ≥ 0 and less
    than min(window, cap) steps back.  Updates the cache in place."""
    b = x.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64) \
        .reshape(-1).expand(b)
    q = dense(x, p["wq"], p.get("bq")).reshape(b, 1, hq, hd)
    k = dense(x, p["wk"], p.get("bk")).reshape(b, 1, hkv, hd)
    v = dense(x, p["wv"], p.get("bv")).reshape(b, 1, hkv, hd)
    q, k = _rope(cfg, q, k, pos[:, None], pos_ids)

    kc, vc = cache["k"], cache["v"]
    cap = kc.shape[1]
    rows = torch.arange(b, device=x.device)
    # the ring's slot; else the reference's update slice, which clamps
    slot = torch.remainder(pos, cap) if window > 0 else pos.clamp(0, cap - 1)
    kc[rows, slot] = k[:, 0].to(kc.dtype)
    vc[rows, slot] = v[:, 0].to(vc.dtype)

    idx = torch.arange(cap, device=x.device)[None, :]
    if window > 0:
        age = torch.remainder(slot[:, None] - idx, cap)  # 0: this token
        valid = (pos[:, None] - age >= 0) & (age < min(window, cap))
    else:
        valid = idx <= pos[:, None]
    kf, vf = _repeat_kv(kc.to(q.dtype), vc.to(q.dtype), hq)
    scores = torch.einsum("bqhd,bshd->bhqs", q, kf).float()
    scores = scores * (hd ** -0.5)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=x.device))
    w = torch.softmax(scores, dim=-1).to(vf.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", w, vf).reshape(b, 1, hq * hd)
    return dense(out.to(x.dtype), p["wo"]), cache


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_attn_forward(cfg, p, x, enc_kv):
    """x: [B,S,d]; enc_kv: (k, v) precomputed from the encoder's output
    ([B, S_enc, Hkv, hd] each).  Non-causal, through the kernel."""
    b, s, _ = x.shape
    hq, hd = cfg.num_heads, cfg.head_dim
    q = dense(x, p["wq"], p.get("bq")).reshape(b, s, hq, hd)
    k, v = enc_kv
    out = attention_core(q, k, v, causal=False)
    return dense(out.reshape(b, s, -1), p["wo"])


def cross_kv(cfg, p, enc_out):
    b, s, _ = enc_out.shape
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    k = dense(enc_out, p["wk"], p.get("bk")).reshape(b, s, hkv, hd)
    v = dense(enc_out, p["wv"], p.get("bv")).reshape(b, s, hkv, hd)
    return k, v
