"""Inputs carried across from numpy (or torch) into the port.

The system has no weights: a program's "parameters" are its inputs and its
§5 packed matrices.  `inputs_from_numpy` applies the reference package's
input canonicalisation (its `CompiledProgram.prepare_env`): with 64-bit
types off, a float64 column becomes float32 and an int64 one int32; dense
vector/matrix/map params take float32 or int32 by their declared type;
dims stay python ints.  `tiled_from_arrays` rebuilds a packed matrix from
the numpy fields (`tiles`, `mask`, `shape`) of the reference package's
TiledMatrix; the caller does the `np.asarray`.

For the LM stack, `lm_params_from_numpy` loads the reference's parameter
tree (its `model.init(seed)`, leaves as numpy arrays) into the port's
`LM`, one stacked leaf `g<gi>/s<i>_<kind>/...[r]` into each layer module;
`lm_cache_from_numpy` and `lm_cache_to_numpy` carry a cache across in
both directions, so that caches compare leaf by leaf.
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
        a = a.astype(_NP_CANON.get(a.dtype, a.dtype), copy=False)
        if not a.flags.c_contiguous:   # (ascontiguousarray makes 0-d 1-d)
            a = np.ascontiguousarray(a)
        if not a.flags.writeable:    # torch tensors are always writable
            a = a.copy()
        t = torch.from_numpy(a)
    want = dtype if dtype is not None else _TORCH_CANON.get(t.dtype, t.dtype)
    return t.to(device=device, dtype=want)


def canonical_numpy(v) -> np.ndarray:
    """One value as a numpy array in its canonical dtype: the host-side
    mirror of `to_tensor` (no device, no copy where none is needed)."""
    if isinstance(v, bool):
        return np.asarray(v)
    if isinstance(v, (int, np.integer)) and not isinstance(v, np.bool_):
        return np.asarray(int(v), np.int32)
    if isinstance(v, (float, np.floating)):
        return np.asarray(float(v), np.float32)
    a = np.asarray(v)
    return a.astype(_NP_CANON.get(a.dtype, a.dtype), copy=False)


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


def _np_to_tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _leaf_paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}"


def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@torch.no_grad()
def lm_params_from_numpy(cfg, tree: dict, device="cuda"):
    """The port's `LM` holding the reference's parameters: `tree` is the
    reference's `model.init(seed)` with numpy leaves.  Shapes and dtypes
    must be the config's; every leaf of the tree is used exactly once."""
    from .models.lm import LM, layer_slots
    model = LM(cfg, device=device)
    used = set()

    def load(param, key, index=None):
        t = _np_to_tensor(_at(tree, key), param.device)
        if index is not None:
            t = t[index]
        if tuple(t.shape) != tuple(param.shape) or t.dtype != param.dtype:
            raise ValueError(f"{key}: {tuple(t.shape)} {t.dtype} does not "
                             f"fit {tuple(param.shape)} {param.dtype}")
        param.copy_(t)
        used.add(key)

    for name in ("embed", "final_norm", "lm_head"):
        load(getattr(model, name), name)
    for layer, (g, s, r, _) in zip(model.layers, layer_slots(cfg)):
        for path, p, _ in layer.leaves():
            load(p, f"{g}/{s}/{path}", r)
    extra = set(_leaf_paths(tree)) - used
    if extra:
        raise ValueError(f"leaves of the tree that the port has no place "
                         f"for: {sorted(extra)}")
    return model


def lm_cache_from_numpy(cfg, tree: dict, device="cuda") -> list:
    """The port's per-layer cache list from the reference's stacked cache
    tree (numpy leaves [L, B, ...])."""
    from .models.lm import layer_slots
    return [{k: _np_to_tensor(a[r], device) for k, a in tree[g][s].items()}
            for g, s, r, _ in layer_slots(cfg)]


def lm_cache_to_numpy(cfg, cache: list) -> dict:
    """The reference's stacked cache tree from the port's cache list;
    bfloat16 leaves come back as float32 (numpy has no bfloat16)."""
    from .models.lm import layer_slots
    stacks: dict = {}
    for (g, s, _, _), c in zip(layer_slots(cfg), cache):
        for k, t in c.items():
            if t.dtype == torch.bfloat16:
                t = t.float()
            stacks.setdefault(g, {}).setdefault(s, {}).setdefault(
                k, []).append(t.detach().cpu().numpy())
    return {g: {s: {k: np.stack(v) for k, v in d.items()}
                for s, d in gd.items()} for g, gd in stacks.items()}
