"""The AdamW update of every leaf at once: the multi-tensor CUDA kernel,
its wrapper and its plain PyTorch versions.

The reference has no Pallas kernel here: XLA fuses its update
(src/repro/optim/adamw.py, `adamw_update`) into the train step that
src/repro/launch/train.py jits.  The port's counterpart is
csrc/adamw.cu, two launches a step over every leaf:

* the norm launch: one block a (leaf, chunk of CHUNK elements), each
  chunk's Σ g² in a fixed order to a partial, the last block to finish
  summing the partials in a fixed order into the global norm and the clip
  scale `clamp(max_norm / (gn + 1e-9), max=1)`, two float32 device
  scalars;
* the update launch: one block a (leaf, chunk), each element's p, g, m
  and v read once and p, m and v written once, the plain update's float32
  expression in its order with every operation rounded alone.

`adamw(params, grads, mu, nu, lr_t=, b1t=, b2t=, ...)` updates in place
and returns (norm, scale).  CUDA tensors launch the kernels or raise;
there is no fallback.  CPU tensors run the plain versions:
`adamw_norm_plain`, whose sums take the kernel's order (so that the card
gives its bits), and `adamw_update_plain`, the port's per-leaf update
unchanged in its arithmetic.  `adamw.launches` counts the launches of
both kernels: one of each for every MAX_LEAVES leaves (one table).

Bound: bytes (22 an element for bf16 parameters and gradients with
float32 moments, and the norm's 2), against the plain update's ~200 in
about twenty float32 passes with temporaries of each leaf's size.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

THREADS = 256        # a block of the norm launch; its sums' tree width
ITERS = 64           # elements a thread sums in order, a chunk
CHUNK = THREADS * ITERS
MAX_LEAVES = 600     # leaves a launch's table holds (kMaxLeaves)
CLIP_EPS = 1e-9      # the reference's clip_by_global_norm: gn + 1e-9

_DTYPES = (torch.float32, torch.bfloat16)


def clip_scale(gn, max_norm: float):
    """min(1, max_norm / (gn + 1e-9)), as the kernel rounds it (a tensor's
    `max_norm / x` is `x.reciprocal() * max_norm`)."""
    return torch.clamp(max_norm / (gn + CLIP_EPS), max=1.0)


def _warp_tree(v):
    """[..., 32] → [...]: lane 0's value after a shuffle-down tree of
    offsets 16, 8, 4, 2, 1."""
    off = v.shape[-1] // 2
    while off:
        v = v[..., :off] + v[..., off:2 * off]
        off //= 2
    return v[..., 0]


def _block_tree(v):
    """[..., THREADS] → [...]: the kernel's block sum, each warp's tree,
    then the warp sums' tree (padded with zeros to a warp)."""
    w = _warp_tree(v.reshape(*v.shape[:-1], THREADS // 32, 32))
    return _warp_tree(F.pad(w, (0, 32 - THREADS // 32)))


def _chunk_partials(g):
    """One float32 partial a chunk of the leaf: thread t's Σ g² over
    elements t, t + THREADS, ... of the chunk in order, then the tree."""
    x = g.detach().reshape(-1).float()
    chunks = -(-x.numel() // CHUNK)
    x = F.pad(x, (0, chunks * CHUNK - x.numel())).view(chunks, ITERS,
                                                         THREADS)
    acc = torch.zeros((chunks, THREADS), dtype=torch.float32,
                      device=x.device)
    for i in range(ITERS):
        acc = acc + x[:, i] * x[:, i]
    return _block_tree(acc)


@torch.no_grad()
def adamw_norm_plain(grads, max_norm: float):
    """(global norm, clip scale) of a list of gradients, float32 0-d, the
    sums in the kernel's order: its bits."""
    parts = torch.cat([_chunk_partials(g) for g in grads if g.numel()])
    rows = -(-parts.numel() // THREADS)
    parts = F.pad(parts, (0, rows * THREADS - parts.numel())).view(
        rows, THREADS)
    acc = torch.zeros(THREADS, dtype=torch.float32, device=parts.device)
    for r in range(rows):
        acc = acc + parts[r]
    gn = torch.sqrt(_block_tree(acc))
    return gn, clip_scale(gn, max_norm)


@torch.no_grad()
def adamw_update_plain(params, grads, mu, nu, scale, lr_t, b1t, b2t, *, b1,
                       b2, eps, weight_decay):
    """The per-leaf update in place (lists of tensors, in one order): each
    leaf clipped by `scale`, its moments and parameter updated in float32
    with temporaries of its own size, and written back."""
    for p, gr, m, v in zip(params, grads, mu, nu):
        g = gr.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        mh = m32 / b1t
        vh = v32 / b2t
        p32 = p.float()
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p32
        p.copy_((p32 - lr_t * delta).to(p.dtype))
        m.copy_(m32.to(m.dtype))
        v.copy_(v32.to(v.dtype))


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _check(params, grads, mu, nu, scalars):
    dev = params[0].device
    for name, ts in (("parameter", params), ("gradient", grads),
                     ("moment", mu), ("moment", nu)):
        for t in ts:
            if t.device != dev or t.dtype not in _DTYPES:
                raise ValueError(f"adamw: a {name} of {t.dtype} on "
                                 f"{t.device}; the kernel takes float32 or "
                                 f"bf16 on {dev}")
    for p, g, m, v in zip(params, grads, mu, nu):
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"adamw: shapes {tuple(p.shape)}, "
                             f"{tuple(g.shape)}, {tuple(m.shape)}, "
                             f"{tuple(v.shape)} of one leaf differ")
        if m.dtype != v.dtype:
            raise ValueError(f"adamw: moments of {m.dtype} and {v.dtype}")
        for t in (p, m, v):
            if not t.is_contiguous():
                raise ValueError("adamw: a parameter or moment updated in "
                                 "place must be contiguous")
    for s in scalars:
        if s.device != dev or s.dtype != torch.float32 or s.numel() != 1:
            raise ValueError(f"adamw: lr_t, b1t and b2t must be float32 "
                             f"scalars on {dev}, got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")


@torch.no_grad()
def adamw(params, grads, mu, nu, *, lr_t, b1t, b2t, b1: float, b2: float,
          eps: float, weight_decay: float, max_norm: float):
    """Clip by the global norm and update every leaf in place.  params,
    grads, mu, nu: lists of one leaf's tensors at each index; lr_t, b1t
    (1 − b1^t) and b2t float32 0-d tensors.  Returns (global norm, clip
    scale), float32 0-d tensors."""
    if not params or not all(len(x) == len(params)
                             for x in (grads, mu, nu)):
        raise ValueError("adamw: params, grads and moments must hold the "
                         "same leaves, at least one")
    if params[0].device.type == "cpu":
        return adamw_plain(params, grads, mu, nu, lr_t=lr_t, b1t=b1t,
                           b2t=b2t, b1=b1, b2=b2, eps=eps,
                           weight_decay=weight_decay, max_norm=max_norm)
    _check(params, grads, mu, nu, (lr_t, b1t, b2t))
    dev = params[0].device
    grads = [g.contiguous() for g in grads]
    n = [p.numel() for p in params]
    if not any(n):
        raise ValueError("adamw: the leaves hold no element")
    kinds = [(p.dtype == torch.bfloat16) | (g.dtype == torch.bfloat16) << 1
             | (m.dtype == torch.bfloat16) << 2
             for p, g, m in zip(params, grads, mu)]
    lib = _build.load("adamw")
    if (lib.adamw_chunk_elems(), lib.adamw_max_leaves()) != (CHUNK,
                                                             MAX_LEAVES):
        raise RuntimeError(
            f"adamw: the kernel's chunk and table ({lib.adamw_chunk_elems()}"
            f", {lib.adamw_max_leaves()}) are not CHUNK, MAX_LEAVES = "
            f"{CHUNK}, {MAX_LEAVES}")
    launches = sum(any(n[i:i + MAX_LEAVES])
                   for i in range(0, len(n), MAX_LEAVES))
    blocks = sum(-(-k // CHUNK) for k in n)
    partials = torch.empty(blocks, dtype=torch.float32, device=dev)
    done = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    n_arr = (ctypes.c_longlong * len(n))(*n)
    k_arr = (ctypes.c_int * len(kinds))(*kinds)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.adamw_norm_launch(_ptrs(grads), n_arr, k_arr, len(n),
                                 partials.data_ptr(), done.data_ptr(),
                                 out.data_ptr(), max_norm, CLIP_EPS, stream)
    _build.check("adamw", code)
    adamw.launches += launches
    code = lib.adamw_update_launch(
        _ptrs(params), _ptrs(grads), _ptrs(mu), _ptrs(nu), n_arr, k_arr,
        len(n), out.data_ptr(), lr_t.data_ptr(), b1t.data_ptr(),
        b2t.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, weight_decay, stream)
    _build.check("adamw", code)
    adamw.launches += launches
    return out[0], out[1]


adamw.launches = 0


@torch.no_grad()
def adamw_plain(params, grads, mu, nu, *, lr_t, b1t, b2t, b1: float,
                b2: float, eps: float, weight_decay: float, max_norm: float):
    """`adamw`'s plain versions on any device: the chunk-ordered norm, then
    the per-leaf update."""
    gn, scale = adamw_norm_plain(grads, max_norm)
    adamw_update_plain(params, grads, mu, nu, scale, lr_t, b1t, b2t, b1=b1,
                       b2=b2, eps=eps, weight_decay=weight_decay)
    return gn, scale
