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
  the AdamW kernel's two launches (`core/capture.py`'s `StepGraph`, which
  the serving steps share).  The entry's first call runs the step
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

import torch

from ..core.capture import CaptureError, StepGraph, buffers, signature, stage


def _state(model, opt_state) -> tuple:
    """The addresses a graph of the step holds: every parameter, moment and
    the step counter."""
    return tuple(t.data_ptr() for t in (
        *[p for _, p in model.named_leaves()], *opt_state.mu.values(),
        *opt_state.nu.values(), opt_state.step))


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


class _Entry(StepGraph):
    """One batch signature's static buffers and, on the card, its graph of
    the step, whose outputs (`out`) are the metrics' static tensors."""

    def __init__(self, key, batch: dict, device, state):
        super().__init__(device, "graphed_step")
        self.key, self.state = key, state
        self.inputs = buffers(batch, device)

    def stage(self, batch: dict) -> None:
        stage(self.inputs, batch)

    def free(self) -> None:
        super().free()
        self.inputs = {}


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
        key = signature(batch)
        state = _state(model, opt_state)
        e = self.entry

        def work():         # the step updates the state in place
            return self.step_fn(model, opt_state, e.inputs)[2]
        if e is not None and e.key == key and e.state == state:
            e.stage(batch)
            metrics = e.replay() if e.card else e.run_cpu(work)
            # clones: the next call overwrites the static metrics
            return model, opt_state, {k: v.clone()
                                      for k, v in metrics.items()}
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
            return model, opt_state, {k: v.clone()
                                      for k, v in e.run_cpu(work).items()}
        coll = None if self.mesh is None else self.mesh.coll
        try:
            return model, opt_state, e.build(work, counts=_Counts(coll),
                                             release=True)
        except BaseException:
            self.entry = None
            raise


def graphed_step(step_fn) -> GraphedStep:
    """The step function as one CUDA graph for each batch signature on the
    card, eagerly over the same static buffers on the CPU."""
    return GraphedStep(step_fn)
