"""Block-sparse tiled matmul over a §5 packed lhs: the CUDA kernel, its
wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel `tile_matmul` in
src/repro/kernels/tile_matmul.py (`_kernel` unmasked, `_masked_kernel`
masked).  The TPU grid cannot skip a block, so the TPU kernel multiplies an
absent tile out; the Hopper kernel (csrc/tile_matmul.cu) reads the mask in
the block and skips the tile, which then contributes exactly zero.  It is
bound by operations (2·M·N·K·density flops); each block computes one
128×128 output tile in float32 registers from operands staged in shared
memory.

Contract (the JAX kernel's): a [M, K] and b [K, N], float32 or bfloat16 →
[M, N] float32.  `tile_mask` [ceil(M/bm), ceil(K/bk)] optional: lhs tile
(i, k) contributes mask[i, k] × its product, and nothing when the mask is 0.
`tile_matmul_packed` runs the same kernel on a §5 packed lhs where it lies,
[Mt, Kt, bm, bk] tiles of a logical (M, K) matrix: the main path's form.
Both count their launches in `tile_matmul.launches`.
"""
from __future__ import annotations

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _blocks(a, b, tile_mask, bm: int, bk: int):
    m, k = a.shape
    k2, _ = b.shape
    if k != k2:
        raise ValueError(f"tile_matmul: inner dims differ ({k} vs {k2})")
    bm, bk = max(1, min(bm, m)), max(1, min(bk, k))
    if tile_mask is not None:
        want = (-(-m // bm), -(-k // bk))
        if tuple(tile_mask.shape) != want:
            raise ValueError(f"tile_matmul: tile_mask {tuple(tile_mask.shape)}"
                             f" != {want} for bm={bm}, bk={bk}")
    return bm, bk


def tile_matmul_plain(a, b, tile_mask=None, *, bm: int = 128, bk: int = 128):
    """The same function in plain PyTorch: expand the mask to elements,
    zero the absent tiles exactly, and multiply in float32."""
    bm, bk = _blocks(a, b, tile_mask, bm, bk)
    a = a.to(torch.float32)
    if tile_mask is not None:
        me = tile_mask.to(torch.float32).repeat_interleave(bm, 0) \
            .repeat_interleave(bk, 1)[:a.shape[0], :a.shape[1]]
        a = torch.where(me != 0, a * me, torch.zeros((), dtype=a.dtype,
                                                     device=a.device))
    return a @ b.to(torch.float32)


def tile_matmul(a, b, tile_mask=None, *, bm: int = 128, bk: int = 128):
    """a: [M, K]; b: [K, N] -> [M, N] float32.

    CPU tensors take the plain version.  CUDA tensors launch the kernel or
    raise; there is no fallback."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return tile_matmul_plain(a, b, tile_mask, bm=bm, bk=bk)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("tile_matmul: a and b must be matrices")
    bm, bk = _blocks(a, b, tile_mask, bm, bk)
    s0, s1 = a.stride()
    return _launch(a, (bm * s0, bk * s1, s0, s1), b, tile_mask, a.shape[0],
                   a.shape[1], bm, bk)


def _unpacked(tiles, shape):
    mt, kt, bm, bk = tiles.shape
    return tiles.permute(0, 2, 1, 3).reshape(mt * bm, kt * bk)[
        :shape[0], :shape[1]]


def _packed_blocks(tiles, tile_mask, shape, b):
    if tiles.dim() != 4 or b.dim() != 2:
        raise ValueError("tile_matmul_packed: tiles must be [Mt, Kt, bm, bk] "
                         "and b a matrix")
    mt, kt, bm, bk = tiles.shape
    m, k = (int(x) for x in shape)
    if (mt, kt) != (-(-m // bm), -(-k // bk)) or \
            tuple(tile_mask.shape) != (mt, kt):
        raise ValueError(f"tile_matmul_packed: tiles {tuple(tiles.shape)} and "
                         f"mask {tuple(tile_mask.shape)} do not pack {m}x{k}")
    if b.shape[0] != k:
        raise ValueError(f"tile_matmul_packed: inner dims differ ({k} vs "
                         f"{b.shape[0]})")
    return m, k, bm, bk


def tile_matmul_packed_plain(tiles, tile_mask, shape, b):
    """The packed product in plain PyTorch: unpack the tiles, then the
    plain masked product."""
    _, _, bm, bk = _packed_blocks(tiles, tile_mask, shape, b)
    return tile_matmul_plain(_unpacked(tiles, shape), b, tile_mask, bm=bm,
                             bk=bk)


def tile_matmul_packed(tiles, tile_mask, shape, b):
    """The §5 packed lhs — tiles [Mt, Kt, bm, bk] with their presence mask
    [Mt, Kt], logical shape (M, K) — times b [K, N] -> [M, N] float32.  The
    same kernel as `tile_matmul`, reading the tiles where they lie.

    CPU tensors take the plain version.  CUDA tensors launch the kernel or
    raise; there is no fallback."""
    if tiles.device.type == "cpu" and b.device.type == "cpu":
        return tile_matmul_packed_plain(tiles, tile_mask, shape, b)
    m, k, bm, bk = _packed_blocks(tiles, tile_mask, shape, b)
    return _launch(tiles, tiles.stride(), b, tile_mask, m, k, bm, bk)


def _launch(a, sa, b, tile_mask, m: int, k: int, bm: int, bk: int):
    """Launch the kernel on lhs storage `a`, read through the four strides
    `sa` (see csrc/tile_matmul.cu), as the logical [m, k] matrix."""
    if a.device.type != "cuda" or b.device != a.device or (
            tile_mask is not None and tile_mask.device != a.device):
        raise ValueError("tile_matmul: operands must lie on one CUDA device")
    # one working type for both operands: float32 unless both are bfloat16
    dt = torch.bfloat16 if a.dtype == b.dtype == torch.bfloat16 \
        else torch.float32
    if a.dtype != dt:
        a = a.to(dt)
        sa = tuple(a.stride()) if a.dim() == 4 else \
            (bm * a.stride(0), bk * a.stride(1), *a.stride())
    b = b.to(dt).contiguous()
    n = b.shape[1]
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"tile_matmul: unsupported sizes {m}x{k}x{n}")
    mask = None if tile_mask is None \
        else tile_mask.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = _build.load("tile_matmul")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = lib.tile_matmul_launch(
        _DTYPES[dt], a.data_ptr(), *sa, b.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        m, n, k, bm, bk, stream)
    _build.check("tile_matmul", code)
    tile_matmul.launches += 1
    return out


tile_matmul.launches = 0
