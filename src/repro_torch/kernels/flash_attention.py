"""Attention with an online softmax, causal or not: the CUDA kernel, its
wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel `flash_attention` in
src/repro/kernels/flash_attention.py (`_kernel`), the TPU target of the LM
stack's `attention_core`.  The Hopper kernel (csrc/flash_attention.cu) runs
one block per (batch·head, 64-row query tile) and keeps the running max,
sum and accumulator in float32 registers.  It is bound by operations
(4·BH·hd·Sq·Sk flops, about half that when causal).  bfloat16 inputs do
both products on the tensor cores (mma.sync, K/V staged in bf16 by
cp.async in 64-key tiles); float32 inputs keep float32 FMAs.

Contract (the JAX kernel's): q [BH, Sq, hd], k and v [BH, Sk, hd], one
dtype (float32 or bfloat16) → [BH, Sq, hd] in q's dtype.  Scores are
scaled by hd^-0.5; causal masks key j from query i when j > i (query row i
aligns with key row i) with a score of -1e30.  Unlike the TPU kernel, any
Sq and Sk are taken: the kernel masks the ragged last tiles itself.
"""
from __future__ import annotations

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
NEG = -1e30


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention: q, k and v must be [BH, S, hd]")
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not "
                         "match")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("flash_attention: q, k and v must share a dtype")


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """The same function in plain PyTorch: softmax(q kᵀ·scale + mask) v in
    float32 (the math of the reference's flash_attention_ref)."""
    _check(q, k, v)
    hd = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (hd ** -0.5)
    if causal:
        sq, sk = s.shape[1], s.shape[2]
        mask = torch.arange(sk, device=q.device)[None, :] \
            <= torch.arange(sq, device=q.device)[:, None]
        s = torch.where(mask[None], s, torch.full((), NEG, device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True):
    """q: [BH, Sq, hd]; k, v: [BH, Sk, hd] -> [BH, Sq, hd] in q's dtype.

    CPU tensors take the plain version.  CUDA tensors launch the kernel or
    raise; there is no fallback."""
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    _check(q, k, v)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must lie on one CUDA "
                         f"device (got {q.device}, {k.device}, {v.device})")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype}")
    bh, sq, hd = q.shape
    sk = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if sk == 0 or max(bh * sq, bh * sk) * hd >= 2 ** 62:
        raise ValueError(f"flash_attention: unsupported sizes bh={bh} "
                         f"sq={sq} sk={sk}")
    # the bf16 kernel copies 16-byte chunks: a view that starts off a
    # 16-byte boundary is copied to a fresh allocation
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone()
               for x in (q.contiguous(), k.contiguous(), v.contiguous()))
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), bh, sq, sk, hd, hd ** -0.5, int(causal), stream)
    _build.check("flash_attention", code)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
