"""Fault-tolerant checkpointing: the PyTorch port of the reference's
src/repro/checkpoint/manager.py, with the same format on disk, so that a
snapshot written by either package restores in the other.

* **Shard-agnostic format**: leaves are saved as full arrays in `.npz`
  files (`params.npz`, `opt.npz`), keyed by their path in the tree
  (dict keys, list/tuple indices, joined by "/", dict keys in sorted
  order as jax's tree walk takes them).
* **Atomic**: write to `step_XXXXXXXX.tmp/` then rename; a crash mid-write
  never corrupts the newest valid checkpoint; `latest()` scans only
  completed directories.
* **Verified**: every snapshot carries per-array crc32 stamps
  (`checksums.json`, `core.faults.checksum`); `latest()` verifies and
  SKIPS a torn or corrupted snapshot to the previous good one instead of
  restoring garbage.  `restore` and `restore_flat` check each array as
  they load it, so `resume(read)`, which walks the snapshots newest
  first with the same skip, reads each array it restores once.
* **Async**: the copy to the host is synchronous (a copy, so the caller
  may go on writing its tensors), the disk write happens on a background
  thread so the loop is not stalled on I/O.

Restores place tensors on the device the caller names, or else on the
device of the template's leaf: never silently on the CPU.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
import zlib

import numpy as np
import torch

from ..core.faults import checksum


def _walk(tree, prefix=""):
    """(path, leaf) for every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _host(leaf) -> np.ndarray:
    """A copy of the leaf on the host: the caller may go on writing it
    while the snapshot is written."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:      # numpy has no bfloat16
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree) -> dict:
    return {path: _host(leaf) for path, leaf in _walk(tree)}


def _unflatten_like(template, flat: dict, device=None, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, device, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        vals = [_unflatten_like(v, flat, device, f"{prefix}{i}/")
                for i, v in enumerate(template)]
        return type(template)(vals)
    arr = flat[prefix[:-1]]
    if torch.is_tensor(template):
        return torch.from_numpy(np.array(arr)).to(
            device=device if device is not None else template.device,
            dtype=template.dtype)
    if hasattr(template, "dtype"):
        return np.asarray(arr).astype(template.dtype)
    return arr


class CorruptSnapshot(Exception):
    """A snapshot whose bytes fail their crc32 stamps, or cannot be read."""


# what reading torn or truncated bytes raises (a KeyError is a stamped
# array or a checksums.json entry that is missing; a json error is a
# ValueError)
_TORN = (zipfile.BadZipFile, EOFError, ValueError, KeyError, OSError,
         zlib.error)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self.skipped: list[int] = []    # steps latest()/resume() refused
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------- write -------------------------
    def save(self, step: int, params, opt_state=None, extra: dict | None = None):
        self.wait()
        snap = {
            "params": _flatten(params),
            "opt": _flatten(opt_state) if opt_state is not None else {},
        }
        meta = {"step": int(step), "extra": extra or {}}
        sums = {fname: {k: checksum(v) for k, v in snap[part].items()}
                for part, fname in (("params", "params.npz"),
                                    ("opt", "opt.npz"))}

        def write():
            tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "params.npz"), **snap["params"])
            np.savez(os.path.join(tmp, "opt.npz"), **snap["opt"])
            with open(os.path.join(tmp, "checksums.json"), "w") as f:
                json.dump(sums, f)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)           # atomic commit
            self._gc()

        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------- read -------------------------
    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def _arrays(self, step: int, part: str):
        """(path, np.ndarray) of one part ("params" or "opt") of a
        snapshot, each array read once and checked against its crc32
        stamp as it is loaded.  Raises CorruptSnapshot on a mismatch, a
        stamped array that is missing, or bytes that cannot be read (what
        torn bytes raise; a MemoryError or any other fault propagates).  A
        pre-checksum snapshot (no checksums.json) is read as it is — the
        stamp protects against torn/corrupted bytes, and a legacy
        snapshot's absence of stamps is not evidence of either."""
        if part not in ("params", "opt"):
            raise ValueError(f"part {part!r} is not 'params' or 'opt'")
        d = os.path.join(self.dir, f"step_{step:08d}")
        fname = f"{part}.npz"
        try:
            sums = None
            cpath = os.path.join(d, "checksums.json")
            if os.path.exists(cpath):
                with open(cpath) as f:
                    sums = json.load(f)[fname]
            seen = set()
            with np.load(os.path.join(d, fname)) as zf:
                for k in zf.files:
                    arr = zf[k]
                    if sums is not None and k in sums \
                            and checksum(arr) != int(sums[k]):
                        raise CorruptSnapshot(f"step {step}: {fname}/{k} "
                                              "fails its crc32")
                    seen.add(k)
                    yield k, arr
            if sums is not None and sums.keys() - seen:
                raise CorruptSnapshot(f"step {step}: {fname} lacks "
                                      f"{sorted(sums.keys() - seen)}")
        except _TORN as ex:
            raise CorruptSnapshot(f"step {step}: {fname}: {ex!r}") from ex

    def verify(self, step: int) -> bool:
        """Whether every array in the snapshot matches its crc32 stamp
        (read one array at a time, nothing kept)."""
        try:
            for part in ("params", "opt"):
                for _ in self._arrays(step, part):
                    pass
        except CorruptSnapshot:
            return False
        return True

    def latest(self) -> int | None:
        """Newest snapshot that VERIFIES.  A torn or bit-flipped snapshot
        is skipped (recorded in `self.skipped`) and the previous good one
        is returned instead — restoring garbage is strictly worse than
        restoring slightly older state."""
        for s in reversed(self.steps()):
            if self.verify(s):
                return s
            self.skipped.append(s)
        return None

    def resume(self, read):
        """`read(step)` of the newest snapshot it reads without a
        CorruptSnapshot, or None when none does.  `read` is `restore_flat`,
        `restore` or a caller's own function over them, so each array of
        the snapshot restored is read once and checked as it is loaded; a
        torn or bit-flipped snapshot is skipped (recorded in
        `self.skipped`) for the next older one, as `latest()` does."""
        for s in reversed(self.steps()):
            try:
                return read(s)
            except CorruptSnapshot:
                self.skipped.append(s)
        return None

    def _meta(self, step: int) -> dict:
        try:
            with open(os.path.join(self.dir, f"step_{step:08d}",
                                   "meta.json")) as f:
                return json.load(f)
        except _TORN as ex:
            raise CorruptSnapshot(f"step {step}: meta.json: {ex!r}") from ex

    def restore(self, step: int, params_template, opt_template=None,
                device=None):
        """Returns (step, params, opt_state, extra), each tree shaped like
        its template: a tensor leaf comes back in the template leaf's
        dtype on `device`, or else on the template leaf's device; a numpy
        leaf in its dtype.  Every array is checked against its crc32 stamp
        as it is read (CorruptSnapshot on a mismatch)."""
        meta = self._meta(step)
        params = _unflatten_like(params_template,
                                 dict(self._arrays(step, "params")), device)
        opt = None
        if opt_template is not None:
            opt = _unflatten_like(opt_template,
                                  dict(self._arrays(step, "opt")), device)
        return meta["step"], params, opt, meta["extra"]

    def restore_flat(self, step: int, part: str = "params"):
        """Template-free read: (step, {path: np.ndarray}, extra) of the
        snapshot's params (or, with part="opt", its optimizer state), each
        array checked against its crc32 stamp as it is read
        (CorruptSnapshot on a mismatch).  The mid-loop resume path
        (runtime/ft.LoopRunner) uses this — after a crash there is no live
        tree to unflatten into; the flat keys (``loop<i>/<carry-name>``)
        are self-describing — and so does the LM's TrainRunner, which
        copies the reference's stacked leaves into its layers."""
        meta = self._meta(step)
        return meta["step"], dict(self._arrays(step, part)), meta["extra"]
