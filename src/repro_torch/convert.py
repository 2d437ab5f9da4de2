"""Inputs carried across from numpy (or torch) into the port.

The system has no weights: a program's "parameters" are its inputs and its
§5 packed matrices.  `inputs_from_numpy` applies the reference package's
input canonicalisation (its `CompiledProgram.prepare_env`): with 64-bit
types off, a float64 column becomes float32 and an int64 one int32; dense
vector/matrix/map params take float32 or int32 by their declared type;
dims stay python ints.  `tiled_from_arrays` rebuilds a packed matrix from
the numpy fields (`tiles`, `mask`, `shape`) of the reference package's
TiledMatrix; the caller does the `np.asarray`.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.tiles import TiledMatrix

_NP_CANON = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
             np.dtype(np.uint64): np.uint32,
             np.dtype(np.complex128): np.complex64}
_TORCH_CANON = {torch.float64: torch.float32, torch.int64: torch.int32,
                torch.complex128: torch.complex64}


def to_tensor(v, device, dtype=None) -> torch.Tensor:
    """One value as a tensor on `device`, in its canonical dtype (or in
    `dtype` when given)."""
    if isinstance(v, torch.Tensor):
        t = v
    elif isinstance(v, bool):
        t = torch.tensor(v)
    elif isinstance(v, (int, np.integer)) and not isinstance(v, np.bool_):
        t = torch.tensor(int(v), dtype=torch.int32)
    elif isinstance(v, (float, np.floating)):
        t = torch.tensor(float(v), dtype=torch.float32)
    else:
        a = np.asarray(v)
        a = np.ascontiguousarray(a.astype(_NP_CANON.get(a.dtype, a.dtype),
                                          copy=False))
        if not a.flags.writeable:    # torch tensors are always writable
            a = a.copy()
        t = torch.from_numpy(a)
    want = dtype if dtype is not None else _TORCH_CANON.get(t.dtype, t.dtype)
    return t.to(device=device, dtype=want)


def tiled_from_arrays(tiles, mask, shape, device) -> TiledMatrix:
    """A packed matrix from numpy (or torch) tiles [Mt, Nt, bm, bn], its
    presence mask [Mt, Nt] and its logical shape."""
    return TiledMatrix(to_tensor(tiles, device),
                       to_tensor(mask, device, torch.float32),
                       tuple(int(s) for s in shape))


def inputs_from_numpy(inputs: dict, device, params=None) -> dict:
    """Canonicalise a program's inputs onto `device`.  `params` (a
    Program's param table) gives each name its declared kind; without it a
    tuple is a bag, a python int a dim, and everything else a tensor in its
    own canonical dtype."""
    out = {}
    names = params.keys() if params is not None else inputs.keys()
    for name in names:
        v = inputs[name]
        t = params.get(name) if params is not None else None
        kind = t.kind if t is not None else None
        if isinstance(v, TiledMatrix):     # §5 packed input
            out[name] = TiledMatrix(v.tiles.to(device),
                                    v.mask.to(device=device,
                                              dtype=torch.float32), v.shape)
        elif kind == "dim" or (kind is None and isinstance(v, int)
                               and not isinstance(v, bool)):
            out[name] = int(v)
        elif kind == "bag" or (kind is None and isinstance(v, tuple)):
            cols = v if isinstance(v, tuple) else (v,)
            out[name] = tuple(to_tensor(c, device) for c in cols)
        elif kind in ("vector", "matrix", "map"):
            out[name] = to_tensor(
                v, device, torch.float32 if t.dtype == "float"
                else torch.int32)
        else:
            out[name] = to_tensor(v, device)
    return out
