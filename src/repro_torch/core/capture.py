"""One step function captured as a CUDA graph: what the graphed train step
(`train/graph.py`) and the graphed serving steps (`serve/graph.py`) share.

A `StepGraph` is one signature's executable.  On the card its first call
(`build`) runs the step eagerly on a side stream (the kernels' builds,
cuBLAS's handles: PyTorch's warm-up before a capture); that is the call's
result.  The step is then captured under `ops.captured()`, which runs
nothing, into a memory pool (the entry's own, or one that several entries
share); each later call (`replay`) replays the graph and credits the
launches the capture counted (`kernels/ops.py`) and any other counters
the caller took out around the capture.  On the CPU `run_cpu` runs the
step eagerly each call and copies its outputs into the first call's, so
that the CPU tests cover everything but the capture.

The wrappers keep their own static inputs (`buffers` and `stage` for a
batch of named arrays) and hand `build`, `replay` and `run_cpu` a `work()`
that reads them.

There is no fallback.  A capture that fails raises `CaptureError`, which
names the line of the package whose operation the capture refused.
"""
from __future__ import annotations

import contextlib
import gc
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ..kernels import ops

_PACKAGE = Path(__file__).resolve().parents[1]
# the wrappers' own files, which a capture error's line is never in
_WRAPPERS = ("capture.py", "graph.py")


class CaptureError(RuntimeError):
    pass


def where(ex: BaseException) -> str:
    """The innermost frame of the package in an exception's traceback, the
    wrappers' apart: file:line (function): its source line."""
    frames = [(Path(f.filename).resolve(), f)
              for f in traceback.extract_tb(ex.__traceback__)]
    frames = [(p, f) for p, f in frames if p.is_relative_to(_PACKAGE)
              and p.name not in _WRAPPERS]
    if not frames:
        return "outside the package"
    path, f = frames[-1]
    rel = path.relative_to(_PACKAGE.parent)
    return f"{rel}:{f.lineno} ({f.name}): {(f.line or '').strip()}"


def leaves(tree) -> list:
    """The tensors of a tree of lists, tuples and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [t for v in tree for t in leaves(v)]


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return type(tree)(_clone(v) for v in tree)


def signature(batch: dict) -> tuple:
    """A batch's name, shape and dtype for each array."""
    return tuple((k, tuple(v.shape), str(v.dtype)) for k, v in batch.items())


def _dtype(v) -> torch.dtype:
    if isinstance(v, torch.Tensor):
        return v.dtype
    return torch.from_numpy(np.empty(0, dtype=v.dtype)).dtype


def buffers(batch: dict, device) -> dict:
    """Static device buffers for a batch of numpy arrays or tensors."""
    return {k: torch.empty(tuple(v.shape), dtype=_dtype(v), device=device)
            for k, v in batch.items()}


def stage(inputs: dict, batch: dict) -> None:
    """Copy a batch's arrays into its static buffers."""
    for k, buf in inputs.items():
        v = batch[k]
        buf.copy_(torch.from_numpy(np.ascontiguousarray(v))
                  if isinstance(v, np.ndarray) else v)


class StepGraph:
    """One signature's graph (on the card) and its static outputs `out`."""

    def __init__(self, device, what: str):
        self.device, self.what = device, what
        self.card = device.type == "cuda"
        self.graph = self.pool = self.out = None
        self.launches: dict = {}
        self.counts = None
        self.warm_s = self.capture_s = 0.0

    def run_cpu(self, work):
        """The step eagerly, its outputs copied into the first call's."""
        got = work()
        if self.out is None:
            self.out = _clone(got)
        else:
            for a, b in zip(leaves(self.out), leaves(got), strict=True):
                a.copy_(b)
        return self.out

    def build(self, work, pool=None, counts=None, release=False):
        """The first call on the card: `work()` eagerly on a side stream,
        then its capture into `pool` (a new one when None), with `counts`
        (a context that takes other counters out of the capture, and whose
        `credit()` adds them back on each replay).  `release` returns the
        warm-up's cached blocks to the device before the pool grows beside
        them.  Returns the eager call's outputs."""
        dev = self.device
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = work()
        cur.wait_stream(side)
        for t in leaves(first):
            t.record_stream(cur)
        torch.cuda.synchronize(dev)
        self.warm_s = time.perf_counter() - t0
        if release:
            gc.collect()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        graph = torch.cuda.CUDAGraph()
        try:
            with ops.captured() as took, counts or contextlib.nullcontext(), \
                    torch.cuda.graph(graph, pool=self.pool):
                out = work()
        except Exception as ex:
            self.free()
            raise CaptureError(f"{self.what}: the capture failed at "
                               f"{where(ex)}: {type(ex).__name__}: {ex}"
                               ) from ex
        self.graph, self.out, self.launches = graph, out, took
        self.counts = counts
        self.capture_s = time.perf_counter() - t0
        return first

    def replay(self):
        self.graph.replay()
        ops.credit(self.launches)
        if self.counts is not None:
            self.counts.credit()
        return self.out

    def free(self) -> None:
        self.graph = self.pool = self.out = None
