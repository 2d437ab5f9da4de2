"""The serving steps as CUDA graphs: the port's counterpart of the
reference's `jax.jit` of its engine's decode and of its prefill, one
program a prompt length (src/repro/serve/engine.py:44-47,
`static_argnames=("plen",)`), and of its launcher's two steps
(src/repro/launch/serve.py:45-46).  Each entry is a `StepGraph`
(`core/capture.py`, shared with the train step): on the card its first
call runs the step eagerly on a side stream and captures it, later calls
replay it and credit its launches; on the CPU it runs the step eagerly
over the same static buffers each call, so that the CPU tests cover
everything but the capture.

`graphed_decode(step)` wraps a `make_decode_step` function and is called
as it is, `(model, cache, token, pos) -> (logits, cache)`.  Its one entry
is made for a model, a cache and a number of rows, and holds:

* static device buffers for the token [B, 1] and the position [B], both
  int64 and views of one buffer, so that a call with host values (the
  engine's numpy arrays, the launcher's int) fills them with one
  host-to-device copy, from pinned memory on the card; a device tensor is
  copied on the device;
* the caller's cache as the graph's state, updated in place.  Attention
  writes its k/v in place; the ssm and rec decodes return fresh `conv`
  and `h` tensors, and `LM.decode` rebinds the layer's entry to them.  The
  step runs on a shallow copy of the cache's lists and dicts, and every
  leaf it returns that is not the caller's is copied back into the
  caller's: a replay then reads the state the last call left;
* the logits as its static output, overwritten by the next call.

The graph holds the addresses of the cache's tensors and of the model's
parameters.  The engine and the launcher never rebind either, so the
entry is kept for as long as the call passes the same model and cache
objects (and rows): a check of three identities a tick.  A caller that
rebinds a leaf of its cache or a parameter makes a new `graphed_decode`.

`graphed_prefill(step)` wraps a `make_prefill_step` function, `(model,
batch) -> (logits, cache)`.  A batch signature (every array's name, shape
and dtype: in the engine one a prompt length, in the launcher [batch,
plen] and the frames or M-RoPE positions beside it) is graphed when it is
seen a second time: its first call runs the plain step, as most prompt
lengths come once and a capture costs more than the eager prefill it
replaces.  Prompts are not padded to a bucket: padding would change the
ssm and rec states and the last token's position.  The entries are an
LRU of the PREFILL_ENTRIES latest signatures, and the signatures seen
once another of that size; the oldest entry's graph and outputs are
freed before a new one is built.  The entries' graphs share one memory
pool, so that the temporaries of one prefill take the memory of
another's: a call's outputs (the last token's logits and the fresh
cache) are valid until the next call of the same `graphed_prefill`,
which may overwrite them.  The engine splices them into its slot at once;
the launcher decodes from them and prefills once.

There is no fallback.  A capture that fails raises `CaptureError`, which
names the line of the package whose operation the capture refused.
"""
from __future__ import annotations

import gc
from collections import OrderedDict

import numpy as np
import torch

from ..core.capture import StepGraph, buffers, leaves, signature, stage

# prompt lengths (prefill signatures) whose graphs a graphed prefill keeps,
# and that it remembers as seen once, as the plan cache keeps
# WHOLE_ENTRIES (core/lower.py)
PREFILL_ENTRIES = 8


def _shallow(tree):
    """A copy of the tree's lists and dicts holding the same tensors."""
    if isinstance(tree, dict):
        return {k: _shallow(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shallow(v) for v in tree]
    return tree


def _write_back(static, new) -> None:
    """Copy every leaf of `new` that is not `static`'s own into it."""
    for a, b in zip(leaves(static), leaves(new), strict=True):
        if a is not b:
            a.copy_(b)


class _Decode(StepGraph):
    """The decode's static token and position buffers over its cache."""

    def __init__(self, device, rows: int, cache, model, step_fn):
        super().__init__(device, "graphed_decode")
        both = torch.empty(2 * rows, dtype=torch.int64, device=device)
        self.host = torch.empty(2 * rows, dtype=torch.int64,
                                pin_memory=self.card)
        self.both, self.rows = both, rows
        self.token, self.pos = both[:rows].view(rows, 1), both[rows:]
        self.ready = torch.cuda.Event() if self.card else None
        self.cache, self.model, self.step_fn = cache, model, step_fn

    def stage(self, token, pos) -> None:
        """Fill the token and position buffers: the host values by one
        copy of the staging buffer, then a device tensor's on the
        device."""
        rows = self.rows
        on_device, on_host = [], False
        if self.ready is not None:
            self.ready.synchronize()    # the last copy out of `host` is done
        for dst, lo, v in ((self.token, 0, token), (self.pos, rows, pos)):
            if self.card and isinstance(v, torch.Tensor) and v.is_cuda:
                on_device.append((dst, v))
            else:
                self.host[lo:lo + rows].view(dst.shape).copy_(
                    torch.as_tensor(np.asarray(v), dtype=torch.int64))
                on_host = True
        if on_host:
            self.both.copy_(self.host, non_blocking=self.card)
            if self.ready is not None:
                self.ready.record()
        for dst, v in on_device:
            dst.copy_(v)

    def work(self):
        logits, new = self.step_fn(self.model, _shallow(self.cache),
                                   self.token, self.pos)
        _write_back(self.cache, new)
        return logits

    def free(self) -> None:
        super().free()
        self.cache = self.model = None


class GraphedDecode:
    """`graphed_decode`'s callable: the decode step's interface.
    `entries_built` counts the entries made, `entry` is the live one."""

    def __init__(self, step_fn):
        self.step_fn = step_fn
        self.entry = None
        self.entries_built = 0

    def __call__(self, model, cache, token, pos):
        e = self.entry
        if e is not None and e.cache is cache and e.model is model \
                and e.rows == len(token):
            e.stage(token, pos)
            return (e.replay() if e.card else e.run_cpu(e.work)), cache
        if e is not None:
            e.free()
            self.entry = e = None
            gc.collect()
            if model.device.type == "cuda":
                torch.cuda.empty_cache()
        e = _Decode(model.device, len(token), cache, model, self.step_fn)
        e.stage(token, pos)
        self.entries_built += 1
        self.entry = e
        if not e.card:
            return e.run_cpu(e.work), cache
        try:
            return e.build(e.work), cache
        except BaseException:
            self.entry = None
            raise


class _Prefill(StepGraph):
    """One batch signature's static input buffers."""

    def __init__(self, key, device, batch: dict, model, step_fn):
        super().__init__(device, "graphed_prefill")
        self.key, self.model, self.step_fn = key, model, step_fn
        self.inputs = buffers(batch, device)

    def stage(self, batch: dict) -> None:
        stage(self.inputs, batch)

    def work(self):
        return self.step_fn(self.model, self.inputs)

    def free(self) -> None:
        super().free()
        self.inputs, self.model = {}, None


class GraphedPrefill:
    """`graphed_prefill`'s callable: the prefill step's interface.
    `entries` maps each kept signature to its entry, oldest first, and
    `seen` the signatures seen once; `entries_built` counts the entries
    made, `plain_calls` the first sights run by the plain step."""

    def __init__(self, step_fn):
        self.step_fn = step_fn
        self.entries: OrderedDict = OrderedDict()
        self.seen: OrderedDict = OrderedDict()
        self.entries_built = self.plain_calls = 0
        self.pool = None

    def _drop(self, key) -> None:
        self.entries.pop(key).free()
        gc.collect()

    def __call__(self, model, batch: dict):
        key = signature(batch)
        e = self.entries.get(key)
        if e is not None and e.model is not model:
            self._drop(key)
            e = None
        if e is not None:
            self.entries.move_to_end(key)
            e.stage(batch)
            return e.replay() if e.card else e.run_cpu(e.work)
        if self.seen.pop(key, None) is None:
            # its first sight: the plain step, and the signature noted
            self.seen[key] = True
            while len(self.seen) > PREFILL_ENTRIES:
                self.seen.popitem(last=False)
            self.plain_calls += 1
            return self.step_fn(model, {
                k: torch.as_tensor(v, device=model.device)
                for k, v in batch.items()})
        while len(self.entries) >= PREFILL_ENTRIES:
            self._drop(next(iter(self.entries)))
        e = _Prefill(key, model.device, batch, model, self.step_fn)
        e.stage(batch)
        self.entries[key] = e
        self.entries_built += 1
        if not e.card:
            return e.run_cpu(e.work)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        try:
            return e.build(e.work, self.pool)
        except BaseException:
            self.entries.pop(key, None)
            raise


def graphed_decode(step_fn) -> GraphedDecode:
    """The decode step as one CUDA graph for the model and cache in use on
    the card, eagerly over the same static buffers on the CPU."""
    return GraphedDecode(step_fn)


def graphed_prefill(step_fn) -> GraphedPrefill:
    """The prefill step as one CUDA graph a batch signature seen twice (an
    LRU of PREFILL_ENTRIES) on the card, eagerly over the same static
    buffers on the CPU; a signature's first call runs the plain step."""
    return GraphedPrefill(step_fn)
