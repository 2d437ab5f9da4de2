"""The Mamba-1 selective scan: the CUDA kernel, its two wrappers and their
plain PyTorch versions.

    h_t = a_t ⊙ h_{t-1} + bx_t ;  y_t = Σ_N c_t ⊙ h_t

Replaces the Pallas TPU kernel `selective_scan` in
src/repro/kernels/selective_scan.py (`_kernel`), which keeps the [bd, N]
state in VMEM while it walks the sequence.  The Hopper kernel
(csrc/selective_scan.cu) keeps it in registers: a block owns 32 channels,
each channel's N states spread over N / 2 lanes of a warp (two states a
thread), a sequential loop over S in tiles staged in shared memory, and a
shuffle sum over the lanes for y.

Two entries, built from one kernel template:

* `selective_scan(a, bx, c, h0, return_state)`, the TPU kernel's
  contract: a, bx [B, S, D, N], c [B, S, N] → y [B, S, D], all float32.
  Bound by device-memory bytes (a and bx read once, y written once).  At
  N = 1 (the RG-LRU) it takes a path of its own: S cut into chunks of
  `_n1_chunk(S)` steps walked in parallel, each chunk's (Π a, h_end)
  folded from h0 in chunk order (`selective_scan_n1_launch`).
* `selective_scan_fused(dt, A, Bm, Cm, x, h0, return_state)`, the
  discretisation fused in: a_t = exp(dt·A) and bx_t = (dt·x)·B are formed
  in registers, in the order the model's `_ssm_params` computes them, so
  nothing [B, S, D, N]-sized is written.  dt [B, S, D] float32 (after
  softplus), A [D, N] float32 (-exp(a_log)), Bm and Cm [B, S, N] float32,
  x [B, S, D] float32 or bf16 (widened in registers).  Bound by the S·D·N
  exponentials or the [B, S, D] bytes.  a = exp2f(dt·A·log2 e), float32
  exp2 of a pre-scaled argument: at most 2 ulp, plus about
  ln2·|dt·A·log2 e|·2^-23 relative (≈ 1e-6 at |dt·A| = 10) against exp.

Beyond the TPU kernel, which starts from zero and returns y alone, both
take an optional h0 [B, D, N] that starts the recurrence, and
`return_state=True` also returns the final state h_last [B, D, N].  Each
entry counts its own launches (`selective_scan.launches`,
`selective_scan_fused.launches`).

The fused entry has a backward (csrc/selective_scan_bwd.cu,
`selective_scan_fused_bwd`), new work: the TPU kernel has none, and the
reference trains through `associative_scan`.  For it the forward also
writes the state before every 16 steps ([B, ceil(S/16), D, N] float32;
the interval is kCkpt of csrc/selective_scan.cuh, which `ckpt_steps()`
reads from the library), from which the backward recomputes each chunk's
states in registers and walks them in reverse; its sums over D and over
B·S are partials reduced in a fixed order, with no float atomics.
`SelectiveScanFused` is the autograd Function the training path calls
(`selective_scan_fused_grad`): on the card both directions launch the
kernels, on the CPU both run their plain versions.

The (a, bx) entry has a backward at N = 1 (`selective_scan_bwd`, the
`selective_scan_n1_bwd_launch` entry of csrc/selective_scan_bwd.cu): the
RG-LRU's call, where c = 1 makes y the state h itself, so the reverse
walk over a, h and dy gives da, dbx and dh0.  Like the forward at N = 1
it cuts S into chunks of `_n1_chunk(S)` steps walked in parallel: each
chunk's (Π a, carry out) first, then each chunk from dh_last folded
through the later chunks' pairs.  Its plain version takes the same order,
each sum and product rounded on its own, so that the kernel gives its
bits; `selective_scan_bwd_sequential` is the one reverse walk.
`SelectiveScan` is its autograd Function and `selective_scan_grad` the
call the RG-LRU makes: on the card both directions launch the kernels, on
the CPU both run their plain versions.  A recorded call the backward
cannot take (N > 1) raises.
"""
from __future__ import annotations

import torch

from . import _build


def _check(a, bx, c, h0):
    if a.dim() != 4 or a.shape != bx.shape:
        raise ValueError(f"selective_scan: a {tuple(a.shape)} and bx "
                         f"{tuple(bx.shape)} must be one [B, S, D, N] shape")
    b, s, d, n = a.shape
    if tuple(c.shape) != (b, s, n):
        raise ValueError(f"selective_scan: c {tuple(c.shape)} != {(b, s, n)}")
    if h0 is not None and tuple(h0.shape) != (b, d, n):
        raise ValueError(f"selective_scan: h0 {tuple(h0.shape)} != "
                         f"{(b, d, n)}")


def selective_scan_plain(a, bx, c, h0=None, *, return_state: bool = False):
    """The same function in plain PyTorch: a loop over S in float32."""
    _check(a, bx, c, h0)
    b, s, d, n = a.shape
    a, bx, c = a.float(), bx.float(), c.float()
    h = torch.zeros((b, d, n), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    y = torch.empty((b, s, d), dtype=torch.float32, device=a.device)
    for t in range(s):
        h = a[:, t] * h + bx[:, t]
        y[:, t] = (h * c[:, t, None, :]).sum(-1)
    return (y, h) if return_state else y


def selective_scan(a, bx, c, h0=None, *, return_state: bool = False):
    """a, bx: [B, S, D, N]; c: [B, S, N] -> y [B, S, D] float32, or
    (y, h_last [B, D, N]) with return_state.

    CPU tensors take the plain version.  CUDA tensors launch the kernel or
    raise; there is no fallback."""
    tensors = (a, bx, c) if h0 is None else (a, bx, c, h0)
    if all(t.device.type == "cpu" for t in tensors):
        return selective_scan_plain(a, bx, c, h0, return_state=return_state)
    _check(a, bx, c, h0)
    if a.device.type != "cuda" or any(t.device != a.device for t in tensors):
        raise ValueError("selective_scan: inputs must lie on one CUDA device")
    b, s, d, n = a.shape
    _check_sizes(b, s, d, n)
    a, bx, c = (_f32(t) for t in (a, bx, c))
    h0 = None if h0 is None else _f32(h0)
    y, h_last = _outputs(b, s, d, n, return_state, a.device)
    lib = _build.load("selective_scan")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    ptrs = (a.data_ptr(), bx.data_ptr(), c.data_ptr(), _ptr(h0),
            y.data_ptr(), _ptr(h_last))
    if n == 1:
        chunk = _n1_chunk(s)
        carry = torch.empty(2 * b * max(1, -(-s // chunk)) * d,
                            dtype=torch.float32, device=a.device)
        code = lib.selective_scan_n1_launch(*ptrs, carry.data_ptr(), b, s,
                                            d, chunk, stream)
    else:
        code = lib.selective_scan_launch(*ptrs, b, s, d, n, stream)
    _build.check("selective_scan", code)
    selective_scan.launches += 1
    return (y, h_last) if return_state else y


selective_scan.launches = 0

# the N = 1 path's chunks: at most _N1_CHUNKS of at least _N1_MIN_CHUNK
# steps, a multiple of 16 (csrc/selective_scan.cu: kN1Batch)
_N1_CHUNKS, _N1_MIN_CHUNK = 32, 64


def _n1_chunk(s: int) -> int:
    """Steps a chunk of the N = 1 path: from S alone, so that the same
    inputs are folded in the same order on every launch."""
    return max(_N1_MIN_CHUNK, -(-s // (16 * _N1_CHUNKS)) * 16)


# ---------------------------------------------------------------------------
# the fused entry: the discretisation in the kernel's registers
# ---------------------------------------------------------------------------

def _check_fused(dt, A, Bm, Cm, x, h0):
    if dt.dim() != 3 or tuple(x.shape) != tuple(dt.shape):
        raise ValueError(f"selective_scan_fused: dt {tuple(dt.shape)} and x "
                         f"{tuple(x.shape)} must be one [B, S, D] shape")
    b, s, d = dt.shape
    if A.dim() != 2 or A.shape[0] != d:
        raise ValueError(f"selective_scan_fused: A {tuple(A.shape)} is not "
                         f"[{d}, N]")
    n = A.shape[1]
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if tuple(t.shape) != (b, s, n):
            raise ValueError(f"selective_scan_fused: {name} "
                             f"{tuple(t.shape)} != {(b, s, n)}")
    if h0 is not None and tuple(h0.shape) != (b, d, n):
        raise ValueError(f"selective_scan_fused: h0 {tuple(h0.shape)} != "
                         f"{(b, d, n)}")
    return b, s, d, n


def selective_scan_fused_plain(dt, A, Bm, Cm, x, h0=None, *,
                               return_state: bool = False):
    """The same function in plain PyTorch: the model's discretisation
    (a = exp(dt·A), bx = (dt·x)·B, [B, S, D, N] float32) followed by the
    plain scan."""
    _check_fused(dt, A, Bm, Cm, x, h0)
    dt = dt.float()
    a = torch.exp(dt[..., None] * A.float())
    bx = (dt * x.float())[..., None] * Bm.float()[..., None, :]
    return selective_scan_plain(a, bx, Cm, h0, return_state=return_state)


def _fused_on_card(name, dt, A, Bm, Cm, x, h0, *rest):
    """Check the fused entry's inputs (and `rest`, tensors or None) for a
    launch; returns (b, s, d, n)."""
    b, s, d, n = _check_fused(dt, A, Bm, Cm, x, h0)
    tensors = [t for t in (dt, A, Bm, Cm, x, h0, *rest) if t is not None]
    if dt.device.type != "cuda" or any(t.device != dt.device
                                       for t in tensors):
        raise ValueError(f"{name}: inputs must lie on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x is {x.dtype}, not float32 or bfloat16")
    _check_sizes(b, s, d, n)
    return b, s, d, n


def _fused_launch(dt, A, Bm, Cm, x, h0, return_state, ckpt):
    """Launch the fused entry on the card: (y, h_last or None, the
    checkpoint states or None)."""
    b, s, d, n = _fused_on_card("selective_scan_fused", dt, A, Bm, Cm, x, h0)
    dt, A, Bm, Cm = (_f32(t) for t in (dt, A, Bm, Cm))
    x = _aligned(x.contiguous())
    h0 = None if h0 is None else _f32(h0)
    y, h_last = _outputs(b, s, d, n, return_state, dt.device)
    lib = _build.load("selective_scan")
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    args = (dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            x.data_ptr(), int(x.dtype == torch.bfloat16), _ptr(h0),
            y.data_ptr(), _ptr(h_last))
    if ckpt:
        states = torch.empty((b, -(-s // ckpt_steps()), d, n),
                             dtype=torch.float32, device=dt.device)
        code = lib.selective_scan_fused_ckpt_launch(
            *args, states.data_ptr(), b, s, d, n, stream)
    else:
        states = None
        code = lib.selective_scan_fused_launch(*args, b, s, d, n, stream)
    _build.check("selective_scan", code)
    selective_scan_fused.launches += 1
    return y, h_last, states


def selective_scan_fused(dt, A, Bm, Cm, x, h0=None, *,
                         return_state: bool = False):
    """dt, x: [B, S, D]; A: [D, N]; Bm, Cm: [B, S, N] -> y [B, S, D]
    float32, or (y, h_last [B, D, N]) with return_state.  x may be bf16;
    the rest is float32.

    CPU tensors take the plain version.  CUDA tensors launch the kernel or
    raise; there is no fallback."""
    tensors = [t for t in (dt, A, Bm, Cm, x, h0) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return selective_scan_fused_plain(dt, A, Bm, Cm, x, h0,
                                          return_state=return_state)
    y, h_last, _ = _fused_launch(dt, A, Bm, Cm, x, h0, return_state, False)
    return (y, h_last) if return_state else y


selective_scan_fused.launches = 0


# ---------------------------------------------------------------------------
# the fused entry's backward
# ---------------------------------------------------------------------------

def ckpt_steps() -> int:
    """Steps between the states the forward keeps for the backward: kCkpt
    of csrc/selective_scan.cuh, read from the built library (the card
    alone keeps states)."""
    return _build.load("selective_scan").selective_scan_ckpt_steps()


def selective_scan_fused_bwd_plain(dt, A, Bm, Cm, x, h0, dy, dh_last=None):
    """The backward in plain PyTorch, float32: the states h_t of a forward
    loop, then the reverse walk g_t = C_t·dy_t + a_{t+1}·g_{t+1} (from
    dh_last), with z = dt·A and dz_t = g_t·h_{t-1}·a_t:
    ddt = Σ_n (g·B·x + dz·A), dx = dt·Σ_n g·B, dB = Σ_d g·dt·x,
    dC = Σ_d dy·h, dA = Σ_{b,t} dz·dt, dh0 = a_0·g_0.  Returns (ddt, dA,
    dBm, dCm, dx, dh0), each in its input's dtype (dh0 float32)."""
    b, s, d, n = _check_fused(dt, A, Bm, Cm, x, h0)
    dt32, A32, B32, C32 = (t.float() for t in (dt, A, Bm, Cm))
    x32, dy32 = x.float(), dy.float()
    h = torch.zeros((b, d, n), dtype=torch.float32, device=dt.device) \
        if h0 is None else h0.float()
    hs = [h]
    for t in range(s):
        a = torch.exp(dt32[:, t, :, None] * A32)
        h = a * h + (dt32[:, t] * x32[:, t])[..., None] * B32[:, t, None, :]
        hs.append(h)
    g = torch.zeros_like(h) if dh_last is None else dh_last.float().clone()
    ddt = torch.empty_like(dt32)
    dx = torch.empty_like(x32)
    dB = torch.empty_like(B32)
    dC = torch.empty_like(C32)
    dA = torch.zeros_like(A32)
    for t in reversed(range(s)):
        a = torch.exp(dt32[:, t, :, None] * A32)
        g = g + C32[:, t, None, :] * dy32[:, t, :, None]
        gb = g * B32[:, t, None, :]
        dz = g * hs[t] * a
        ddt[:, t] = (gb * x32[:, t, :, None] + dz * A32).sum(-1)
        dx[:, t] = gb.sum(-1) * dt32[:, t]
        dB[:, t] = (g * (dt32[:, t] * x32[:, t])[..., None]).sum(1)
        dC[:, t] = (dy32[:, t, :, None] * hs[t + 1]).sum(1)
        dA += (dz * dt32[:, t, :, None]).sum(0)
        g = a * g
    return (ddt.to(dt.dtype), dA.to(A.dtype), dB.to(Bm.dtype),
            dC.to(Cm.dtype), dx.to(x.dtype), g)


def selective_scan_fused_bwd(dt, A, Bm, Cm, x, h0, dy, dh_last=None, *,
                             states=None):
    """The gradients (ddt, dA, dBm, dCm, dx, dh0) of selective_scan_fused's
    y (gradient dy [B, S, D]) and h_last (gradient dh_last [B, D, N], None
    for zero).  dx is in x's dtype, the rest float32.

    CPU tensors take the plain version, which recomputes the states from
    h0.  CUDA tensors launch the kernels from `states`, the checkpoint
    states the forward wrote (`SelectiveScanFused`), or raise; there is no
    fallback."""
    tensors = [t for t in (dt, A, Bm, Cm, x, h0, dy, dh_last, states)
               if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return selective_scan_fused_bwd_plain(dt, A, Bm, Cm, x, h0, dy,
                                              dh_last)
    b, s, d, n = _fused_on_card("selective_scan_fused_bwd", dt, A, Bm, Cm,
                                x, h0, dy, dh_last, states)
    every = ckpt_steps()
    if states is None or tuple(states.shape) != (b, -(-s // every), d, n):
        raise ValueError("selective_scan_fused_bwd: the card's backward "
                         "needs the forward's checkpoint states [B, "
                         f"ceil(S/{every}), D, N]")
    if tuple(dy.shape) != (b, s, d) or (dh_last is not None and tuple(
            dh_last.shape) != (b, d, n)):
        raise ValueError("selective_scan_fused_bwd: dy or dh_last does not "
                         "fit the forward's shapes")
    dt, A, Bm, Cm, states, dy = (_f32(t) for t in (dt, A, Bm, Cm, states,
                                                   dy))
    x = _aligned(x.contiguous())
    dh_last = None if dh_last is None else _f32(dh_last)
    ddt, dBm, dCm = (torch.empty_like(t) for t in (dt, Bm, Cm))
    dA = torch.empty_like(A)
    dx = torch.empty_like(x)
    dh0 = torch.empty((b, d, n), dtype=torch.float32, device=dt.device)
    # dA's parts, then dB's and dC's for blocks of 32 channels: the most
    # the kernel takes (its blocks hold 32 to 128 channels)
    nblk = -(-d // 32)
    scratch = torch.empty(b * d * n + 2 * b * nblk * s * n,
                          dtype=torch.float32, device=dt.device)
    lib = _build.load("selective_scan_bwd")
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    code = lib.selective_scan_bwd_launch(
        dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        x.data_ptr(), int(x.dtype == torch.bfloat16), states.data_ptr(),
        dy.data_ptr(), _ptr(dh_last), ddt.data_ptr(), dx.data_ptr(),
        dA.data_ptr(), dBm.data_ptr(), dCm.data_ptr(), dh0.data_ptr(),
        scratch.data_ptr(), b, s, d, n, stream)
    _build.check("selective_scan_bwd", code)
    selective_scan_fused_bwd.launches += 1
    return ddt, dA, dBm, dCm, dx, dh0


selective_scan_fused_bwd.launches = 0


class SelectiveScanFused(torch.autograd.Function):
    """selective_scan_fused with its backward: (y, h_last) of (dt, A, Bm,
    Cm, x, h0); h0 may be None.  On the card the forward also keeps the
    checkpoint states for `selective_scan_fused_bwd`."""

    @staticmethod
    def forward(ctx, dt, A, Bm, Cm, x, h0):
        ctx.set_materialize_grads(False)
        tensors = [t for t in (dt, A, Bm, Cm, x, h0) if t is not None]
        if all(t.device.type == "cpu" for t in tensors):
            y, h_last = selective_scan_fused_plain(dt, A, Bm, Cm, x, h0,
                                                   return_state=True)
            states = None
        else:
            y, h_last, states = _fused_launch(dt, A, Bm, Cm, x, h0, True,
                                              True)
        ctx.save_for_backward(dt, A, Bm, Cm, x, h0, states)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, A, Bm, Cm, x, h0, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(dt.shape, dtype=torch.float32, device=dt.device)
        ddt, dA, dBm, dCm, dx, dh0 = selective_scan_fused_bwd(
            dt, A, Bm, Cm, x, h0, dy, dh_last, states=states)
        return ddt, dA, dBm, dCm, dx, (None if h0 is None else dh0)


def selective_scan_fused_grad(dt, A, Bm, Cm, x, h0=None, *,
                              return_state: bool = False):
    """selective_scan_fused, differentiable: through `SelectiveScanFused`
    when autograd records (grad mode on and an input requires grad), else
    the plain forward call, which keeps no states."""
    inputs = [t for t in (dt, A, Bm, Cm, x, h0) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        y, h_last = SelectiveScanFused.apply(dt, A, Bm, Cm, x, h0)
        return (y, h_last) if return_state else y
    return selective_scan_fused(dt, A, Bm, Cm, x, h0,
                                return_state=return_state)


# ---------------------------------------------------------------------------
# the (a, bx) entry's backward at N = 1: the RG-LRU
# ---------------------------------------------------------------------------

def selective_scan_bwd_sequential(a, h, h0, dy, dh_last=None):
    """The backward of the (a, bx) entry at N = 1 with c = 1, in plain
    PyTorch, float32, one reverse walk over S: a, h (the forward's y,
    which is the state), dy [B, S, D]; h0 and dh_last [B, D] or None
    (zero).  g_t = dy_t + a_{t+1}·g_{t+1} from dh_last gives da_t =
    g_t·h_{t-1} (h_{-1} = h0), dbx_t = g_t and dh0 = a_0·g_0.  Returns
    (da, dbx, dh0), float32."""
    b, s, d = a.shape
    a, h, dy = a.float(), h.float(), dy.float()
    start = torch.zeros((b, d), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    carry = torch.zeros_like(start) if dh_last is None \
        else dh_last.float().clone()
    da, dbx = torch.empty_like(a), torch.empty_like(a)
    for t in reversed(range(s)):
        g = dy[:, t] + carry
        da[:, t] = g * (h[:, t - 1] if t > 0 else start)
        dbx[:, t] = g
        carry = a[:, t] * g
    return da, dbx, carry


def selective_scan_bwd_plain(a, h, h0, dy, dh_last=None):
    """The same gradients as `selective_scan_bwd_sequential`, in the
    kernel's order (csrc/selective_scan_bwd.cu, n1_bwd_totals and
    n1_bwd_walk), each sum and product rounded on its own, so that the
    kernel gives these bits: S cut in chunks of `_n1_chunk(S)` steps
    (the last padded with steps a = 1, dy = 0, which hand the carry on
    exactly); each chunk's (Π a, carry out from zero) walked backward;
    the carry into each chunk, dh_last folded through the later chunks'
    pairs, last chunk first; then each chunk walked from its carry."""
    b, s, d = a.shape
    dev = a.device
    a, h, dy = a.float(), h.float(), dy.float()
    start = torch.zeros((b, d), dtype=torch.float32, device=dev) \
        if h0 is None else h0.float()
    c = torch.zeros_like(start) if dh_last is None else dh_last.float()
    chunk = _n1_chunk(s)
    n = max(1, -(-s // chunk))
    pad = n * chunk - s

    def chunks(x, fill):
        x = torch.cat([x, x.new_full((b, pad, d), fill)], 1)
        return x.view(b, n, chunk, d)

    ac, gc = chunks(a, 1.0), chunks(dy, 0.0)
    hc = chunks(torch.cat([start[:, None], h], 1)[:, :s], 0.0)   # h_{t-1}
    prod = torch.ones((b, n, d), dtype=torch.float32, device=dev)
    out = torch.zeros((b, n, d), dtype=torch.float32, device=dev)
    for i in reversed(range(chunk)):
        out = ac[:, :, i] * (gc[:, :, i] + out)
        prod = prod * ac[:, :, i]
    into = torch.empty_like(out)
    for k in reversed(range(n)):
        into[:, k] = c
        c = prod[:, k] * c + out[:, k]
    da = torch.empty((b, n, chunk, d), dtype=torch.float32, device=dev)
    dbx = torch.empty_like(da)
    c = into
    for i in reversed(range(chunk)):
        g = gc[:, :, i] + c
        da[:, :, i] = g * hc[:, :, i]
        dbx[:, :, i] = g
        c = ac[:, :, i] * g
    return (da.view(b, n * chunk, d)[:, :s], dbx.view(b, n * chunk, d)[:, :s],
            c[:, 0])


def _abx_check(a, h, h0, dy, dh_last):
    if a.dim() != 3 or a.shape != h.shape or a.shape != dy.shape:
        raise ValueError(f"selective_scan_bwd: a {tuple(a.shape)}, h "
                         f"{tuple(h.shape)} and dy {tuple(dy.shape)} must be "
                         "one [B, S, D] shape")
    b, s, d = a.shape
    for name, t in (("h0", h0), ("dh_last", dh_last)):
        if t is not None and tuple(t.shape) != (b, d):
            raise ValueError(f"selective_scan_bwd: {name} {tuple(t.shape)} "
                             f"!= {(b, d)}")
    return b, s, d


def selective_scan_bwd(a, h, h0, dy, dh_last=None):
    """The (a, bx) entry's gradients (da, dbx, dh0) at N = 1, c = 1, from
    its a, its output h and h0, given dy (and dh_last, None for zero):
    shapes as `selective_scan_bwd_plain`'s, float32.

    CPU tensors take the plain version.  CUDA tensors launch the kernel or
    raise; there is no fallback."""
    tensors = [t for t in (a, h, h0, dy, dh_last) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return selective_scan_bwd_plain(a, h, h0, dy, dh_last)
    b, s, d = _abx_check(a, h, h0, dy, dh_last)
    if a.device.type != "cuda" or any(t.device != a.device for t in tensors):
        raise ValueError("selective_scan_bwd: inputs must lie on one CUDA "
                         "device")
    _check_sizes(b, s, d, 1)
    a, h, dy = (_f32(t) for t in (a, h, dy))
    h0 = None if h0 is None else _f32(h0)
    dh_last = None if dh_last is None else _f32(dh_last)
    da, dbx = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty((b, d), dtype=torch.float32, device=a.device)
    chunk = _n1_chunk(s)
    carry = torch.empty(2 * b * max(1, -(-s // chunk)) * d,
                        dtype=torch.float32, device=a.device)
    lib = _build.load("selective_scan_bwd")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = lib.selective_scan_n1_bwd_launch(
        a.data_ptr(), h.data_ptr(), _ptr(h0), dy.data_ptr(), _ptr(dh_last),
        da.data_ptr(), dbx.data_ptr(), dh0.data_ptr(), carry.data_ptr(), b,
        s, d, chunk, stream)
    _build.check("selective_scan_bwd", code)
    selective_scan_bwd.launches += 1
    return da, dbx, dh0


selective_scan_bwd.launches = 0


class SelectiveScan(torch.autograd.Function):
    """The (a, bx) entry at N = 1 with c = 1, with its backward: (y,
    h_last) of (a, bx [B, S, D, 1], h0 [B, D, 1] or None).  The forward
    keeps a, y (the states) and h0 for `selective_scan_bwd`."""

    @staticmethod
    def forward(ctx, a, bx, h0):
        ctx.set_materialize_grads(False)
        b, s = a.shape[:2]
        ones = torch.ones((b, s, 1), dtype=torch.float32, device=a.device)
        y, h_last = selective_scan(a, bx, ones, h0, return_state=True)
        ctx.save_for_backward(a, y, h0)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        a, y, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        da, dbx, dh0 = selective_scan_bwd(
            a[..., 0], y, None if h0 is None else h0[..., 0], dy,
            None if dh_last is None else dh_last[..., 0])
        return da[..., None], dbx[..., None], \
            None if h0 is None else dh0[..., None]


def selective_scan_grad(a, bx, h0=None, *, return_state: bool = False):
    """selective_scan at c = 1, differentiable.  When autograd records
    (grad mode on and an input requires grad), through `SelectiveScan`:
    N must be 1, the form the kernel's backward takes, or it raises, on
    either device.  Otherwise the forward call."""
    inputs = [t for t in (a, bx, h0) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        if a.shape[-1] != 1:
            raise NotImplementedError(
                f"selective_scan_grad: the backward takes N = 1 (got N = "
                f"{a.shape[-1]})")
        y, h_last = SelectiveScan.apply(a, bx, h0)
        return (y, h_last) if return_state else y
    c = torch.ones(a.shape[:2] + (a.shape[-1],), dtype=torch.float32,
                   device=a.device)
    return selective_scan(a, bx, c, h0, return_state=return_state)


# ---------------------------------------------------------------------------
# shared by both entries
# ---------------------------------------------------------------------------

def _check_sizes(b, s, d, n):
    if n > 32 or n & (n - 1) or b > 65535 or b * s * d * n >= 2 ** 62:
        raise ValueError(f"selective_scan: unsupported shape {(b, s, d, n)} "
                         "(N must be a power of two ≤ 32)")


def _aligned(t):
    """`t`, or a copy when its data does not start on a 16-byte boundary
    (the kernel reads a thread's states as one vector)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _f32(t):
    return _aligned(t.to(torch.float32).contiguous())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _outputs(b, s, d, n, return_state, device):
    y = torch.empty((b, s, d), dtype=torch.float32, device=device)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=device) \
        if return_state else None
    return y, h_last
