"""Packed (tiled) matrices — paper §5, on torch tensors.

A TiledMatrix stores [bm, bn] dense tiles plus a tile-presence mask.
`pack`/`unpack` are the paper's conversion comprehensions; the compiler
FUSES them away: when a tiled matrix flows into the matmul-shaped
contraction, the executor runs the block-sparse `tile_matmul` CUDA kernel
directly on the packed representation (no unpack), which is the §5 claim
("programs directly access the packed structures").  Any other access
unpacks on the fly.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TiledMatrix:
    tiles: torch.Tensor     # [Mt, Nt, bm, bn]
    mask: torch.Tensor      # [Mt, Nt] float32 (1 = tile present)
    shape: tuple            # logical (un-padded) shape

    @property
    def tile_shape(self):
        return self.tiles.shape[2], self.tiles.shape[3]


def pack(m: torch.Tensor, bm: int = 128, bn: int = 128,
         prune_zero: bool = True) -> TiledMatrix:
    """Dense/sparse matrix -> tiles (paper's pack(M) comprehension)."""
    h, w = m.shape
    hp, wp = -(-h // bm) * bm, -(-w // bn) * bn
    mp = torch.zeros((hp, wp), dtype=m.dtype, device=m.device)
    mp[:h, :w] = m
    tiles = mp.reshape(hp // bm, bm, wp // bn, bn).permute(0, 2, 1, 3) \
        .contiguous()
    if prune_zero:
        mask = (tiles.abs().sum(dim=(2, 3)) > 0).to(torch.float32)
    else:
        mask = torch.ones(tiles.shape[:2], dtype=torch.float32,
                          device=m.device)
    return TiledMatrix(tiles, mask, (h, w))


def unpack(t: TiledMatrix) -> torch.Tensor:
    """Tiles -> dense matrix (paper's unpack(N) comprehension)."""
    mt, nt, bm, bn = t.tiles.shape
    tiles = t.tiles * t.mask[:, :, None, None].to(t.tiles.dtype)
    full = tiles.permute(0, 2, 1, 3).reshape(mt * bm, nt * bn)
    return full[:t.shape[0], :t.shape[1]]


def matmul_tiled(a: TiledMatrix, b) -> torch.Tensor:
    """Block-sparse matmul on the packed representation via the
    tile_matmul kernel, which reads the tiles where they lie (the mask
    skips absent tiles)."""
    from ..kernels import ops
    bdense = unpack(b) if isinstance(b, TiledMatrix) else b
    return ops.tile_matmul_packed(a.tiles, a.mask, a.shape, bdense)
