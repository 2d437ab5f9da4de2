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
  Bound by device-memory bytes (a and bx read once, y written once).
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
    code = lib.selective_scan_launch(
        a.data_ptr(), bx.data_ptr(), c.data_ptr(), _ptr(h0), y.data_ptr(),
        _ptr(h_last), b, s, d, n, stream)
    _build.check("selective_scan", code)
    selective_scan.launches += 1
    return (y, h_last) if return_state else y


selective_scan.launches = 0


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
    b, s, d, n = _check_fused(dt, A, Bm, Cm, x, h0)
    if dt.device.type != "cuda" or any(t.device != dt.device
                                       for t in tensors):
        raise ValueError("selective_scan_fused: inputs must lie on one CUDA "
                         "device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"selective_scan_fused: x is {x.dtype}, not "
                         "float32 or bfloat16")
    _check_sizes(b, s, d, n)
    dt, A, Bm, Cm = (_f32(t) for t in (dt, A, Bm, Cm))
    x = _aligned(x.contiguous())
    h0 = None if h0 is None else _f32(h0)
    y, h_last = _outputs(b, s, d, n, return_state, dt.device)
    lib = _build.load("selective_scan")
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    code = lib.selective_scan_fused_launch(
        dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        x.data_ptr(), int(x.dtype == torch.bfloat16), _ptr(h0), y.data_ptr(),
        _ptr(h_last), b, s, d, n, stream)
    _build.check("selective_scan", code)
    selective_scan_fused.launches += 1
    return (y, h_last) if return_state else y


selective_scan_fused.launches = 0


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
