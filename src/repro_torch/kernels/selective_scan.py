"""The Mamba-1 selective scan: the CUDA kernel, its wrapper and its plain
PyTorch version.

    h_t = a_t ⊙ h_{t-1} + bx_t ;  y_t = Σ_N c_t ⊙ h_t

Replaces the Pallas TPU kernel `selective_scan` in
src/repro/kernels/selective_scan.py (`_kernel`), which keeps the [bd, N]
state in VMEM while it walks the sequence.  The Hopper kernel
(csrc/selective_scan.cu) keeps it in registers: one thread per (b, d, n),
the N lanes of a channel side by side in a warp, a sequential loop over S
and a shuffle sum over N for y.  It is bound by device-memory bytes (a and
bx read once, y written once).

Contract: a, bx [B, S, D, N], c [B, S, N] → y [B, S, D], all float32.
Beyond the TPU kernel, which starts from zero and returns y alone, an
optional h0 [B, D, N] starts the recurrence and `return_state=True` also
returns the final state h_last [B, D, N]; with neither it is the TPU
kernel's function.
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
    if n > 32 or n & (n - 1) or b > 65535 or a.numel() >= 2 ** 62:
        raise ValueError(f"selective_scan: unsupported shape {(b, s, d, n)} "
                         "(N must be a power of two ≤ 32)")
    a, bx, c = (t.to(torch.float32).contiguous() for t in (a, bx, c))
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    y = torch.empty((b, s, d), dtype=torch.float32, device=a.device)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=a.device) \
        if return_state else None
    lib = _build.load("selective_scan")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = lib.selective_scan_launch(
        a.data_ptr(), bx.data_ptr(), c.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        None if h_last is None else h_last.data_ptr(), b, s, d, n, stream)
    _build.check("selective_scan", code)
    selective_scan.launches += 1
    return (y, h_last) if return_state else y


selective_scan.launches = 0
