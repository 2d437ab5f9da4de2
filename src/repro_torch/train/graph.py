"""The train step as one CUDA graph: the port's counterpart of the
reference's `jax.jit(make_train_step(...))` (src/repro/launch/train.py).

`graphed_step(step_fn)` wraps a `make_train_step` function and is called
as it is: `step(model, opt_state, batch) -> (model, opt_state, metrics)`.
As jit traces once for each shape, it keeps an entry for each batch
signature (every array's name, shape and dtype):

* static device buffers for the batch, into which each call copies its
  arrays (a numpy batch or tensors);
* on the card, one graph of the whole step: the loss, the backward, the
  microbatches' accumulation, the gradient exchange over a NCCL mesh and
  the AdamW kernel's two launches.  The entry's first call runs the step
  eagerly on a side stream (autograd's and cuBLAS's first use, the
  kernels' builds, the replicas' check, which reads crc32s on the host);
  that is the call's step.  The step is then captured under
  `ops.captured()`, which runs nothing; each later call copies the batch
  in, replays, credits the launches the capture counted
  (`kernels/ops.py`) and the mesh's collective calls and bytes, and
  returns clones of the metrics, which the next replay overwrites;
* on the CPU, the step run eagerly over the same static buffers and the
  same in-place state, its metrics copied into the entry's outputs and
  cloned as on the card, so that the CPU tests cover everything but the
  capture (as `core/graphs.py`'s `Entry`).

The graph holds the addresses of the parameters, the moments and the step
counter, which the step updates in place: `load_tree` copies a snapshot
into them, so a resumed `TrainRunner` keeps its graph.  A call with other
tensors (another model) or another signature builds a new entry; the old
entry's graph and its memory pool are freed first, and the warm-up's
cached blocks are returned to the device before the capture, so that the
two do not add up.

There is no fallback.  A capture that fails raises `CaptureError`, which
names the line of the package whose operation the capture refused.  On
the card a mesh whose all_reduce stages through pinned host memory (gloo
ranks that share a card) raises at once: gloo cannot be captured.
"""
from __future__ import annotations

import gc
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ..kernels import ops

_PACKAGE = Path(__file__).resolve().parents[1]


class CaptureError(RuntimeError):
    pass


def _signature(batch: dict) -> tuple:
    return tuple((k, tuple(v.shape), str(v.dtype)) for k, v in batch.items())


def _state(model, opt_state) -> tuple:
    """The addresses a graph of the step holds: every parameter, moment and
    the step counter."""
    return tuple(t.data_ptr() for t in (
        *[p for _, p in model.named_leaves()], *opt_state.mu.values(),
        *opt_state.nu.values(), opt_state.step))


def _where(ex: BaseException) -> str:
    """The innermost frame of the package in an exception's traceback:
    file:line (function): its source line."""
    frames = [(Path(f.filename).resolve(), f)
              for f in traceback.extract_tb(ex.__traceback__)]
    frames = [(p, f) for p, f in frames if p.is_relative_to(_PACKAGE)
              and p.name != "graph.py"]
    if not frames:
        return "outside the package"
    path, f = frames[-1]
    rel = path.relative_to(_PACKAGE.parent)
    return f"{rel}:{f.lineno} ({f.name}): {(f.line or '').strip()}"


class _Counts:
    """A mesh's collective counters taken out around a capture and
    credited again on each replay, as `ops.captured` / `ops.credit` do
    for the kernels."""

    def __init__(self, coll):
        self.coll = coll
        self.took = None

    def _now(self):
        c = self.coll
        return dict(c.calls), dict(c.bytes), c.issued

    def __enter__(self):
        if self.coll is not None:
            self.before = self._now()
        return self

    def __exit__(self, *exc):
        if self.coll is None:
            return
        (calls, nbytes, issued), (c0, b0, i0) = self._now(), self.before
        self.took = ({k: n - c0.get(k, 0) for k, n in calls.items()},
                     {k: n - b0.get(k, 0) for k, n in nbytes.items()},
                     issued - i0)
        self.coll.calls.clear()
        self.coll.calls.update(c0)
        self.coll.bytes.clear()
        self.coll.bytes.update(b0)
        self.coll.issued = i0

    def credit(self):
        if self.coll is None or self.took is None:
            return
        calls, nbytes, issued = self.took
        self.coll.calls.update(calls)
        self.coll.bytes.update(nbytes)
        self.coll.issued += issued


class _Entry:
    """One batch signature's static buffers and, on the card, its graph."""

    def __init__(self, key, batch: dict, device, state):
        self.key, self.state, self.device = key, state, device
        self.card = device.type == "cuda"
        self.inputs = {k: torch.empty(tuple(v.shape), dtype=_dtype(v),
                                      device=device)
                       for k, v in batch.items()}
        self.graph = self.pool = None
        self.out = None              # the metrics' static tensors
        self.launches: dict = {}
        self.counts = None
        self.warm_s = self.capture_s = 0.0

    def stage(self, batch: dict) -> None:
        for k, buf in self.inputs.items():
            v = batch[k]
            buf.copy_(torch.from_numpy(np.ascontiguousarray(v))
                      if isinstance(v, np.ndarray) else v)

    def run_cpu(self, step_fn, model, opt_state):
        model, opt_state, metrics = step_fn(model, opt_state, self.inputs)
        if self.out is None:
            self.out = {k: torch.empty_like(v) for k, v in metrics.items()}
        for k, v in metrics.items():
            self.out[k].copy_(v)
        return model, opt_state, self._clones()

    def build(self, step_fn, model, opt_state, coll):
        """The first call on the card: the step eagerly on a side stream,
        then the capture.  Returns the eager step's result."""
        dev = self.device
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            model, opt_state, metrics = step_fn(model, opt_state,
                                                self.inputs)
        cur.wait_stream(side)
        first = {k: v.clone() for k, v in metrics.items()}
        del metrics
        torch.cuda.synchronize(dev)
        self.warm_s = time.perf_counter() - t0
        # the warm-up's cached blocks go back to the device before the
        # graph's pool grows beside them
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        self.counts = _Counts(coll)
        try:
            with ops.captured() as took, self.counts, \
                    torch.cuda.graph(graph, pool=self.pool):
                _, _, out = step_fn(model, opt_state, self.inputs)
        except Exception as ex:
            self.free()
            raise CaptureError(f"graphed_step: the capture of the train "
                               f"step failed at {_where(ex)}: "
                               f"{type(ex).__name__}: {ex}") from ex
        self.graph, self.out, self.launches = graph, out, took
        self.capture_s = time.perf_counter() - t0
        return model, opt_state, first

    def replay(self, model, opt_state):
        self.graph.replay()
        ops.credit(self.launches)
        self.counts.credit()
        return model, opt_state, self._clones()

    def _clones(self) -> dict:
        return {k: v.clone() for k, v in self.out.items()}

    def free(self) -> None:
        self.graph = self.pool = self.out = None
        self.inputs = {}


def _dtype(v) -> torch.dtype:
    if isinstance(v, torch.Tensor):
        return v.dtype
    return torch.from_numpy(np.empty(0, dtype=v.dtype)).dtype


class GraphedStep:
    """`graphed_step`'s callable: the step function's interface and its
    `.mesh` and `.exchange`; `entries_built` counts the entries made,
    `entry` is the live one."""

    def __init__(self, step_fn):
        self.step_fn = step_fn
        self.mesh = getattr(step_fn, "mesh", None)
        self.exchange = getattr(step_fn, "exchange", None)
        self.entry = None
        self.entries_built = 0
        coll = self.mesh.coll if self.mesh is not None else None
        if coll is not None and self.mesh.device.type == "cuda" \
                and "all_reduce" not in coll.direct:
            raise CaptureError(
                f"graphed_step: the mesh's all_reduce goes through pinned "
                f"host memory ({coll.transport('all_reduce')}: ranks that "
                "share a card), which a CUDA graph cannot capture; give "
                "each rank a card of its own (NCCL) or run the step eagerly")

    def __call__(self, model, opt_state, batch):
        key = _signature(batch)
        state = _state(model, opt_state)
        e = self.entry
        if e is None or e.key != key or e.state != state:
            if e is not None:
                e.free()
                self.entry = e = None
                gc.collect()
                if model.device.type == "cuda":
                    torch.cuda.empty_cache()
            e = _Entry(key, batch, model.device, state)
            e.stage(batch)
            self.entries_built += 1
            self.entry = e
            if not e.card:
                return e.run_cpu(self.step_fn, model, opt_state)
            try:
                return e.build(self.step_fn, model, opt_state,
                               None if self.mesh is None else self.mesh.coll)
            except BaseException:
                self.entry = None
                raise
        e.stage(batch)
        if e.card:
            return e.replay(model, opt_state)
        return e.run_cpu(self.step_fn, model, opt_state)


def graphed_step(step_fn) -> GraphedStep:
    """The step function as one CUDA graph for each batch signature on the
    card, eagerly over the same static buffers on the CPU."""
    return GraphedStep(step_fn)
