"""Attention with an online softmax, causal or not, optionally within a
local window: the CUDA kernel, its wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel `flash_attention` in
src/repro/kernels/flash_attention.py (`_kernel`), the TPU target of the LM
stack's `attention_core`.  The Hopper kernels (csrc/flash_attention.cu)
keep each query row's running max, sum and accumulator in float32
registers.  They are bound by operations (4·BH·hd·Sq·Sk flops, about half
that when causal).  `_route` picks the kernel of a launch:
  * "wgmma": bfloat16 at hd 64 and 256 from 64 query rows (whisper-tiny's
    attention, recurrentgemma-2b's lattn layers) on Hopper's warpgroup
    products, Q, K and V in shared memory in 64-key tiles; at hd 256 two
    consumer warpgroups of 64 rows fed by TMA from a producer warpgroup,
    taking turns so that one's softmax runs under the other's products,
    at hd 64 one warpgroup a block and several blocks an SM.  Counted in
    `wg_launches` too ("flash_attention[wg]" in `ops.launch_counts()`);
  * "mma": the rest of bfloat16 (hd 16, 32 and 128; a decode tick's one
    query row) on mma.sync, one block per (batch·head, 64-row query
    tile), K/V staged by cp.async in 64-key tiles (32 at hd 256);
  * "f32": float32 inputs keep float32 FMAs.

Contract (the JAX kernel's): q [BH, Sq, hd], k and v [BH, Sk, hd], one
dtype (float32 or bfloat16) → [BH, Sq, hd] in q's dtype.  Scores are
scaled by hd^-0.5; causal masks key j from query i when j > i (query row i
aligns with key row i) with a score of -1e30.  Unlike the TPU kernel, any
Sq and Sk are taken: the kernel masks the ragged last tiles itself.
`window` > 0 also masks key j from query i when j <= i - window (the
reference's local attention, `_scores_mask` in src/repro/models/
attention.py, which computes it in jnp outside the TPU kernel); a windowed
block visits only the key tiles its rows' windows reach.  hd is one of
HEAD_DIMS.  `return_lse=True` also returns each query row's log-sum-exp
of its scaled, masked scores ([BH, Sq] float32, natural log); the output
is the same bits with or without it.

The backward (csrc/flash_attention_bwd.cu, `flash_attention_bwd`) is new:
the TPU kernel has none, and the reference trains through the jnp form.
It recomputes the weights from q, k and the forward's lse, and sums with
no float atomics (the same bits on every launch).  In bf16 it runs on
wgmma at hd 64, 128 and 256 (counted in `bwd_wg_launches` too,
"flash_attention_bwd[wg]" in `ops.launch_counts()`), by `_bwd_route`:
  * "wgmma": at hd 128, and hd 64 causal, one pass over the keys, adding
    each key block's part of dQ into a float32 workspace in a fixed
    order; at hd 256 (recurrentgemma-2b's lattn) one launch of dK/dV
    blocks and dQ blocks, each fed by TMA from a producer warpgroup;
  * "wgmma-split": hd 64 not causal (whisper-tiny's encoder and
    cross-attention), hd 256's split design at hd 64, whose scratch is D
    alone (counted in `bwd_split_launches` too, "flash_attention_bwd[full,
    hd 64]").
hd 16 and 32 keep a dK/dV kernel and a dQ kernel on mma.sync.  The
window is taken at hd 16, 32 and 256 and in float32, whose kernels walk
only the band of tiles it keeps; bf16 at hd 64 and 128 refuses it with a
ValueError (no model trains a window at those widths).
`FlashAttention` is the autograd Function the training path calls
(`flash_attention_grad`): on the card both directions launch the
kernels, on the CPU both run their plain versions.
"""
from __future__ import annotations

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
BWD_HEAD_DIMS = (16, 32, 64, 128, 256)
# the bf16 backward's one-pass wgmma kernel: no window at these widths
WGMMA_HEAD_DIMS = (64, 128)
# the bf16 backward's wgmma routes: the one-pass kernel, hd 256's dK/dV
# and dQ blocks, and hd 64's when not causal
WG_BWD_HEAD_DIMS = (64, 128, 256)
WG_BWD_ROUTES = ("wgmma", "wgmma-split")
# the bf16 forward's wgmma kernel: these widths, from WG_MIN_SQ query rows
# (one consumer warpgroup's tile); the rest stays on mma.sync
WG_FWD_HEAD_DIMS = (64, 256)
WG_MIN_SQ = 64
NEG = -1e30


class _Count:
    """A launch counter beside a wrapper's own."""
    launches = 0


# the wgmma route's launches (`_route` "wgmma"), which flash_attention's
# count includes: `ops.launch_counts()["flash_attention[wg]"]`
wg_launches = _Count()
# the backward's wgmma routes (bf16 at WG_BWD_HEAD_DIMS), which
# flash_attention_bwd's count includes:
# `ops.launch_counts()["flash_attention_bwd[wg]"]`
bwd_wg_launches = _Count()
# of those, the "wgmma-split" route's (bf16 at hd 64, not causal):
# `ops.launch_counts()["flash_attention_bwd[full, hd 64]"]`
bwd_split_launches = _Count()


def _route(dtype, hd: int, sq: int) -> str:
    """The forward kernel of a launch: "f32" for float32 inputs; for
    bfloat16 "wgmma" at hd 64 and 256 from WG_MIN_SQ query rows, else
    "mma" (hd 16, 32 and 128, and fewer rows: a decode tick's Sq = 1)."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if hd in WG_FWD_HEAD_DIMS and sq >= WG_MIN_SQ else "mma"


def _bwd_route(dtype, hd: int, causal: bool = True) -> str:
    """The backward kernels of a launch: "f32" for float32 inputs; for
    bfloat16 "wgmma-split" at hd 64 not causal (dK/dV and dQ blocks),
    "wgmma" at the rest of WG_BWD_HEAD_DIMS (the one-pass kernel at hd 64
    causal and hd 128, hd 256's dK/dV and dQ blocks), else "mma" (hd 16,
    32)."""
    if dtype == torch.float32:
        return "f32"
    if hd == 64 and not causal:
        return "wgmma-split"
    return "wgmma" if hd in WG_BWD_HEAD_DIMS else "mma"


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


def _check_window(causal, window):
    """The window is local causal attention's (lattn): with causal=False
    a row past Sk - 1 + window would keep no key, where the kernel and the
    plain version would disagree, so that form is refused."""
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if window > 0 and not causal:
        raise ValueError(f"flash_attention: window {window} needs "
                         "causal=True")


def _scores(q, k, causal, window=0):
    """The scaled float32 scores [BH, Sq, Sk] and the mask of the kept
    (query, key) pairs (None when neither causal nor windowed): the
    reference's `_scores_mask`."""
    hd = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (hd ** -0.5)
    if not causal and window <= 0:
        return s, None
    sq, sk = s.shape[1], s.shape[2]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    q_pos = torch.arange(sq, device=q.device)[:, None]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return s, mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          return_lse: bool = False):
    """The same function in plain PyTorch: softmax(q kᵀ·scale + mask) v in
    float32 (the math of the reference's flash_attention_ref, with the
    window of its `_scores_mask`)."""
    _check(q, k, v)
    _check_window(causal, int(window))
    s, mask = _scores(q, k, causal, window)
    if mask is not None:
        s = torch.where(mask[None], s, torch.full((), NEG, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def _on_card(name, *tensors):
    """Check that the tensors lie on one CUDA device and share a dtype the
    kernels take."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs must lie on one CUDA device (got "
                         f"{[str(t.device) for t in tensors]})")
    if tensors[0].dtype not in _DTYPES \
            or any(t.dtype != tensors[0].dtype for t in tensors):
        raise ValueError(f"{name}: inputs must share a dtype of "
                         f"{list(_DTYPES)} (got "
                         f"{[str(t.dtype) for t in tensors]})")


def _sizes(name, q, k, head_dims=HEAD_DIMS):
    bh, sq, hd = q.shape
    sk = k.shape[1]
    if hd not in head_dims:
        raise ValueError(f"{name}: head_dim {hd} not in {head_dims}")
    if sk == 0 or max(bh * sq, bh * sk) * hd >= 2 ** 62:
        raise ValueError(f"{name}: unsupported sizes bh={bh} sq={sq} "
                         f"sk={sk}")
    return bh, sq, sk, hd


def _aligned(*tensors):
    """Contiguous copies where needed: the bf16 kernels copy 16-byte
    chunks, so a view that starts off a 16-byte boundary is copied to a
    fresh allocation."""
    return [x if x.data_ptr() % 16 == 0 else x.clone()
            for x in (t.contiguous() for t in tensors)]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """q: [BH, Sq, hd]; k, v: [BH, Sk, hd] -> [BH, Sq, hd] in q's dtype,
    or (out, lse [BH, Sq] float32) with return_lse.  `window` > 0 keeps
    key j for query i only when j > i - window, and needs causal=True.

    CPU tensors take the plain version.  CUDA tensors launch the kernel or
    raise; there is no fallback."""
    window = int(window)
    _check_window(causal, window)
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     return_lse=return_lse)
    _check(q, k, v)
    _on_card("flash_attention", q, k, v)
    bh, sq, sk, hd = _sizes("flash_attention", q, k)
    q, k, v = _aligned(q, k, v)
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    tail = (bh, sq, sk, hd, hd ** -0.5, int(causal), window, stream)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    route = _route(q.dtype, hd, sq)
    if route == "wgmma":
        code = lib.flash_attention_wg_launch(
            *ptrs, None if lse is None else lse.data_ptr(), *tail)
    elif return_lse:
        code = lib.flash_attention_lse_launch(_DTYPES[q.dtype], *ptrs,
                                              lse.data_ptr(), *tail)
    else:
        code = lib.flash_attention_launch(_DTYPES[q.dtype], *ptrs, *tail)
    _build.check("flash_attention", code)
    flash_attention.launches += 1
    if route == "wgmma":
        wg_launches.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0):
    """The backward in plain PyTorch, the explicit formula in float32 with
    the weights materialised: P = exp(s − lse) (masked, as the forward's
    `_scores` with the window: 0), D = rowsum(dO ⊙ O), dS = P ⊙ (dO·Vᵀ −
    D), dV = Pᵀ·dO, dK = scale·dSᵀ·Q, dQ = scale·dS·K.  Returns (dq, dk,
    dv) in the inputs' dtype."""
    _check(q, k, v)
    _check_window(causal, int(window))
    scale = q.shape[-1] ** -0.5
    s, mask = _scores(q, k, causal, int(window))
    p = torch.exp(s - lse.float()[..., None])
    if mask is not None:
        p = torch.where(mask[None], p, torch.zeros((), device=q.device))
    do32 = do.float()
    dv = torch.einsum("bqk,bqd->bkd", p, do32)
    dp = torch.einsum("bqd,bkd->bqk", do32, v.float())
    d = (do32 * o.float()).sum(-1)
    ds = p * (dp - d[..., None])
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float()) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_scratch_floats(bh, sq, hd, dtype, causal=True):
    """Floats of the backward's scratch: D [BH, Sq]; for the bf16 one-pass
    kernel (hd 128, and hd 64 causal) also its sync words (a ticket
    counter and a flag a (bh, 64-row query tile)), padded to 16 bytes, and
    the float32 dQ workspace, a part of 64·hd a (bh, query tile)
    (flash_attention_bwd.cu's entry point)."""
    n = bh * sq
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS \
            and _bwd_route(dtype, hd, causal) == "wgmma":
        tiles = bh * -(-sq // 64)
        n = -(-(n + 1 + tiles) // 4) * 4 + tiles * 64 * hd
    return n


def _check_bwd_window(name, dtype, hd, window):
    """The card's backward takes no window in bf16 at the one-pass
    kernel's widths."""
    if window > 0 and dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        raise ValueError(f"{name}: no window in the bf16 backward at head_dim "
                         f"{hd} (the one-pass wgmma kernel); it is taken at "
                         f"head_dim 16, 32 and 256 and in float32")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """The gradients (dq, dk, dv) of flash_attention's output `o` given its
    gradient `do`, from q, k, v and the forward's lse; shapes and dtype
    as the forward's inputs.  `window` is the forward's.

    CPU tensors take the plain version.  CUDA tensors launch the kernels
    or raise; there is no fallback."""
    window = int(window)
    tensors = (q, k, v, o, lse, do)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window)
    _check(q, k, v)
    _check_window(causal, window)
    _on_card("flash_attention_bwd", q, k, v, o, do)
    bh, sq, sk, hd = _sizes("flash_attention_bwd", q, k, BWD_HEAD_DIMS)
    _check_bwd_window("flash_attention_bwd", q.dtype, hd, window)
    if o.shape != q.shape or do.shape != q.shape \
            or tuple(lse.shape) != (bh, sq):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} and lse {tuple(lse.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if lse.device != q.device:
        raise ValueError("flash_attention_bwd: lse must lie on q's device")
    q, k, v, o, do = _aligned(q, k, v, o, do)
    lse = lse.to(torch.float32).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    d = torch.empty(_bwd_scratch_floats(bh, sq, hd, q.dtype, causal),
                    dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_attention_bwd_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), d.data_ptr(), bh, sq, sk, hd,
        hd ** -0.5, int(causal), window, stream)
    _build.check("flash_attention_bwd", code)
    flash_attention_bwd.launches += 1
    route = _bwd_route(q.dtype, hd, causal)
    if route in WG_BWD_ROUTES:
        bwd_wg_launches.launches += 1
    if route == "wgmma-split":
        bwd_split_launches.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """flash_attention with its backward: the forward keeps q, k, v, the
    output and its lse; the backward is `flash_attention_bwd`, with the
    forward's causal flag and window."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window=0):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_grad(q, k, v, *, causal: bool = True, window: int = 0):
    """flash_attention, differentiable: through `FlashAttention` when
    autograd records (grad mode on and an input requires grad), else the
    plain forward call, which computes no lse.  The card's backward takes
    no window in bf16 at hd 64 or 128: there `flash_attention_bwd` raises
    ValueError."""
    window = int(window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        _check_window(causal, window)
        return FlashAttention.apply(q, k, v, causal, window)
    return flash_attention(q, k, v, causal=causal, window=window)
