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
`LM`, one stacked leaf `g<gi>/s<i>_<kind>/...[r]` into each layer module,
and `lm_params_to_numpy` is its inverse; `lm_tree_to_numpy` and
`lm_tree_from_numpy` do the same for any dict keyed like the model's
parameters (the AdamW moments), so that a training snapshot of either
package resumes in the other.  `lm_cache_from_numpy` and
`lm_cache_to_numpy` carry a cache across in both directions, so that
caches compare leaf by leaf.  `whisper_params_from_numpy` and
`whisper_params_to_numpy` do the same for the Whisper model, whose
reference tree stacks the encoder's layers into `enc/...` [L, ...] and
the decoder's into `dec/...`; `whisper_tree_to_numpy` and
`whisper_tree_from_numpy` carry its moments, as the LM's.
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


def lm_slots(cfg) -> list[tuple[str, str, int | None]]:
    """(the port's parameter path, the reference's leaf key, the index in
    that stacked leaf or None) of every parameter, in the port's order."""
    from .models.lm import LM, layer_slots
    slots = layer_slots(cfg)
    out = []
    for path, _ in LM(cfg, device="meta").named_leaves():
        if path.startswith("layers/"):
            _, l, sub = path.split("/", 2)
            g, s, r, _ = slots[int(l)]
            out.append((path, f"{g}/{s}/{sub}", r))
        else:
            out.append((path, path, None))
    return out


def _put(tree: dict, key: str, value):
    *head, last = key.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def whisper_slots(cfg) -> list[tuple[str, str, int | None]]:
    """`lm_slots` for the Whisper model: the port's `enc/<l>/...` and
    `dec/<l>/...` are entry l of the reference's stacked `enc/...` and
    `dec/...`."""
    from .models.whisper import Whisper
    out = []
    for path, _ in Whisper(cfg, device="meta").named_leaves():
        side, *rest = path.split("/", 2)
        if side in ("enc", "dec"):
            out.append((path, f"{side}/{rest[1]}", int(rest[0])))
        else:
            out.append((path, path, None))
    return out


def _stacked_to_numpy(slots, leaves: dict) -> dict:
    stacks: dict = {}
    for path, key, r in slots:
        t = leaves[path].detach()
        a = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
        stacks.setdefault(key, []).append(a if r is None else (r, a))
    tree: dict = {}
    for key, parts in stacks.items():
        if isinstance(parts[0], tuple):
            value = np.stack([a for _, a in sorted(parts, key=lambda x: x[0])])
        else:
            value = parts[0]
        _put(tree, key, value)
    return tree


def lm_tree_to_numpy(cfg, leaves: dict) -> dict:
    """The reference's stacked tree (numpy leaves, `g<gi>/s<i>_<kind>/...`
    [L, ...]) from a dict keyed by the port's parameter paths (an LM's
    `named_leaves()`, or AdamW moments); bfloat16 comes back as float32
    (numpy has no bfloat16: the reference casts on restore)."""
    return _stacked_to_numpy(lm_slots(cfg), leaves)


def lm_params_to_numpy(cfg, model) -> dict:
    """The reference's parameter tree from the port's `LM`: the inverse of
    `lm_params_from_numpy`."""
    return lm_tree_to_numpy(cfg, dict(model.named_leaves()))


@torch.no_grad()
def lm_tree_from_numpy(cfg, tree: dict, into: dict) -> dict:
    """Copy the reference's stacked tree into `into`, a dict of tensors
    keyed by the port's parameter paths (shapes must fit; each tensor
    keeps its dtype and device).  Every leaf of the tree must be used."""
    return _stacked_from_numpy(lm_slots(cfg), tree, into)


def _stacked_from_numpy(slots, tree: dict, into: dict) -> dict:
    used = set()
    for path, key, r in slots:
        dst = into[path]
        t = _np_to_tensor(_at(tree, key), dst.device)
        if r is not None:
            t = t[r]
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: {tuple(t.shape)} does not fit "
                             f"{path} {tuple(dst.shape)}")
        dst.copy_(t.to(dst.dtype))
        used.add(key)
    extra = set(_leaf_paths(tree)) - used
    if extra:
        raise ValueError(f"leaves of the tree that the port has no place "
                         f"for: {sorted(extra)}")
    return into


def _load_params(model, slots, tree: dict):
    params = dict(model.named_leaves())
    for path, key, r in slots:
        a = _at(tree, key)
        dt = _np_to_tensor(a[:1] if r is not None else a, "cpu").dtype
        if dt != params[path].dtype:
            raise ValueError(f"{key}: {dt} does not fit {path} "
                             f"{params[path].dtype}")
    _stacked_from_numpy(slots, tree, params)
    return model


@torch.no_grad()
def lm_params_from_numpy(cfg, tree: dict, device="cuda"):
    """The port's `LM` holding the reference's parameters: `tree` is the
    reference's `model.init(seed)` with numpy leaves.  Shapes and dtypes
    must be the config's; every leaf of the tree is used exactly once."""
    from .models.lm import LM
    return _load_params(LM(cfg, device=device), lm_slots(cfg), tree)


@torch.no_grad()
def whisper_params_from_numpy(cfg, tree: dict, device="cuda"):
    """The port's `Whisper` holding the reference's parameters (its
    `Whisper(cfg).init(seed)` with numpy leaves), as
    `lm_params_from_numpy`."""
    from .models.whisper import Whisper
    return _load_params(Whisper(cfg, device=device), whisper_slots(cfg),
                        tree)


def whisper_tree_to_numpy(cfg, leaves: dict) -> dict:
    """`lm_tree_to_numpy` for the Whisper model: the reference's stacked
    tree (`enc/...`, `dec/...` [L, ...]) from a dict keyed by the port's
    Whisper parameter paths (its leaves, or AdamW moments)."""
    return _stacked_to_numpy(whisper_slots(cfg), leaves)


@torch.no_grad()
def whisper_tree_from_numpy(cfg, tree: dict, into: dict) -> dict:
    """`lm_tree_from_numpy` for the Whisper model: the reference's stacked
    tree copied into `into`, a dict of tensors keyed by the port's
    Whisper parameter paths."""
    return _stacked_from_numpy(whisper_slots(cfg), tree, into)


def whisper_params_to_numpy(cfg, model) -> dict:
    """The reference's Whisper parameter tree from the port's `Whisper`:
    the inverse of `whisper_params_from_numpy`."""
    return whisper_tree_to_numpy(cfg, dict(model.named_leaves()))


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
