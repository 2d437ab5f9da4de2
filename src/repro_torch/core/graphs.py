"""Whole-program execution: one entry per compile-cache signature, replayed
on every later call with that signature.

This is the port's form of the reference's whole-program path
(src/repro/core/lower.py:1437-1511), where jax.jit traces the whole plan
into one XLA computation.  Here the executable is CUDA graphs captured from
the eager plan, and the hand-written kernels run inside them.
`CompiledProgram._run_whole` (lower.py) keys the entries, caches them and
retires a signature whose entry failed to build.

Regions.  The plan is cut at each SeqLoop into regions, recursively: the
nodes before the loop, the loop's body, and the nodes after it.  A region is
a maximal run of nodes that are not loops, and is one graph.  A region
before a loop ends by copying the loop's initial carry into the carry's
static buffers and evaluating the loop condition into a device flag (so a
loop that runs no iteration works); the last region of a loop body ends by
copying the new carry into the same buffers and evaluating the condition
again.  The host replays the body's graphs while the flag reads true: one
flag read an iteration, the syncs the eager path pays, and one graph launch
in place of one launch per op.

Memory.  The entry owns static buffers for the inputs and copies each
call's inputs into them (device tensors device to device, host data host to
device); it never adopts or writes the caller's tensors.  An input that no
run reads (the first node that names it is a store that replaced it whole,
as the first run showed) is neither copied nor held: its buffer is a
stand-in of its shape and dtype without memory.  All graphs of an
entry share one memory pool and are captured in the order in which they are
replayed; the entry holds every value that crosses graphs (carries, flags,
values of an earlier region that a later one reads).  Outputs are cloned
out of that memory before they are returned, so that the next call cannot
overwrite a result that a caller holds.

Capture.  The first call runs the plan eagerly once on a side stream
(PyTorch's warm-up before a capture): that builds the kernels, creates the
library handles and resolves operator selection, so an autotune
measurement never runs under capture.  It then captures the graphs and
returns the outputs of a replay.  A wrapper counts a launch when it is
called, so the counts a capture adds are taken back out and credited again
on each replay of that graph (kernels/ops.py).  The `lower.node` injection
site fires while a region is captured, and not on a replay, as the
reference's fires while the plan is traced.

On the CPU, which has no graphs, the same entry runs each region's nodes
eagerly into the same static buffers, carry copy-back and flag; the sites
fire the first time a region runs, and that run finds the inputs no run
reads.  `free()` lets go of everything an entry holds (lower.py keeps a few
entries and frees the one it evicts).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from . import plan as P
from .loop_ast import RejectionError


class _Loop:
    """A SeqLoop of the plan: the static buffers of its carry and the
    device flag that says whether the body runs again.  Its body's
    schedule lies beside it in the schedule, so that no region of the body
    refers back to an object that holds the region (a reference cycle
    would keep an entry's graphs alive until the cyclic garbage collector
    runs)."""

    def __init__(self, node: P.SeqLoop):
        self.node = node
        self.carry: dict = {}
        self.flag = None


class _Region:
    """A maximal run of nodes that are not loops: one CUDA graph.  It ends
    by entering the loop `enter` (initial carry and first condition), or by
    closing the body of the loop `back` (new carry and next condition)."""

    def __init__(self, nodes: list, enter=None, back=None):
        self.nodes = nodes
        self.enter = enter
        self.back = back
        self.graph = None
        self.launches: dict = {}      # kernel launches one replay makes
        self.fired = False            # its injection sites have fired

    def work(self, executor, env: dict, ctx) -> None:
        executor.execute(self.nodes, env, ctx)
        loop = self.enter or self.back
        if loop is None:
            return
        new = {c: executor._t(env[c]) for c in loop.node.carry}
        if self.enter is not None:
            for c, v in new.items():
                if c not in loop.carry:
                    loop.carry[c] = torch.empty(v.shape, dtype=v.dtype,
                                                device=v.device)
        bufs = loop.carry
        for c, v in new.items():
            b = bufs[c]
            if v.shape != b.shape or v.dtype != b.dtype:
                raise RejectionError(
                    f"SeqLoop carry '{c}' changes from {tuple(b.shape)} "
                    f"{b.dtype} to {tuple(v.shape)} {v.dtype}")
            # a new value that shares memory with a carry buffer (an
            # unchanged or swapped carry) is read in full before any write
            if any(_shares(v, o) for o in bufs.values()):
                new[c] = v.clone()
        for c, v in new.items():
            bufs[c].copy_(v)
        env.update(bufs)
        if loop.flag is None:
            loop.flag = torch.empty((), dtype=torch.bool,
                                    device=executor.device)
        loop.flag.copy_(executor.loop_cond(loop.node, env, ctx))


def _shares(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _flat(nodes):
    for n in nodes:
        if isinstance(n, P.FusedRound):    # plain sequencing on one device
            yield from _flat(n.parts)
        else:
            yield n


def schedule(nodes, back=None) -> list:
    """The regions of `nodes` in execution order, each loop as the pair
    (its _Loop, the schedule of its body)."""
    items, run = [], []
    for n in _flat(nodes):
        if isinstance(n, P.SeqLoop):
            loop = _Loop(n)
            items.append(_Region(run, enter=loop))
            run = []
            items.append((loop, schedule(n.body, back=loop)))
        else:
            run.append(n)
    if run or back is not None:
        items.append(_Region(run, back=back))
    return items


def _regions(items) -> list:
    out = []
    for it in items:
        out.extend(_regions(it[1]) if isinstance(it, tuple) else [it])
    return out


def _leaves(v) -> tuple:
    return v if isinstance(v, tuple) else (v,)


def unread(plan, names, outputs, replaced) -> set:
    """The inputs among `names` that no run reads: the first node that
    names each one is a store that replaced it whole (its id is in
    `replaced`, as a run recorded) and does not read it.  Every other input
    is read: by a node, by a loop (its condition, body or carry), or as an
    output that the plan leaves as it came."""
    read: dict = {}
    for n in _flat(plan):
        if isinstance(n, P.SeqLoop):
            for name in (*n.reads, *n.carry):
                read.setdefault(name, True)
            continue
        parts = n.parts if isinstance(n, P.Fused) else (n,)
        for p in parts:
            for name in getattr(p, "reads", ()):
                read.setdefault(name, True)
        for p in parts:
            read.setdefault(p.dest, id(p) not in replaced)
    return {n for n in names
            if not read.get(n, n in outputs)}


def _stand_in(b: torch.Tensor) -> torch.Tensor:
    """A tensor of `b`'s shape and dtype that holds no memory of its own:
    what a store that replaces it whole reads of it."""
    return torch.empty((), dtype=b.dtype, device=b.device).expand(b.shape)


@contextmanager
def _quiet(executor):
    """The executor's injection sites off: a run that is neither the
    capture nor the first run of a region."""
    prev, executor.sites = executor.sites, False
    try:
        yield
    finally:
        executor.sites = prev


class Entry:
    """The executable of one signature: static input buffers, the
    schedule of regions and loops, and (on the card) one captured graph a
    region.  `run(env)` takes the call's inputs in their canonical dtypes,
    on the host or on the device, and returns fresh output tensors."""

    def __init__(self, executor, plan, outputs, ctx, env: dict):
        self.executor = executor
        self.plan = plan
        self.outputs = tuple(outputs)
        self.ctx = ctx
        self.device = executor.device
        self.items = schedule(plan)
        self.inputs = {n: self._buffer(v) for n, v in env.items()}
        self.unread = None    # the inputs no run reads, once a run showed
        self.env = None       # on the card: the env the graphs captured
        self._held: list = []
        self.syncs = 0        # host reads of a loop flag in the last run

    def _buffer(self, v):
        if isinstance(v, int):             # a dim: part of the signature
            return v
        if isinstance(v, tuple):           # a bag's columns
            return tuple(self._buffer(c) for c in v)
        return torch.empty(v.shape, dtype=v.dtype, device=self.device)

    @property
    def graphs(self) -> int:
        """Graphs a run replays (on the CPU: the regions it runs)."""
        return len(_regions(self.items))

    def run(self, env: dict) -> dict:
        self._stage(env)
        self.syncs = 0
        if self.device.type == "cuda":
            if self.env is None:
                self._capture()
            self._replay(self.items)
            out = self.env
        elif self.unread is None:
            with self._recorded():
                out = self._run_cpu(self.items, dict(self.inputs))
        else:
            out = self._run_cpu(self.items, dict(self.inputs))
        return {n: out[n].clone() for n in self.outputs}

    @contextmanager
    def _recorded(self):
        """Around the first run: records the stores that replace their
        destination whole, then finds the inputs no run reads and drops
        their buffers for stand-ins."""
        ex = self.executor
        ex.replaced = set()
        try:
            yield
            arrays = [n for n, b in self.inputs.items()
                      if torch.is_tensor(b)]
            self.unread = unread(self.plan, arrays, self.outputs,
                                 ex.replaced)
        finally:
            ex.replaced = None
        for name in self.unread:
            self.inputs[name] = _stand_in(self.inputs[name])

    def free(self) -> None:
        """Let go of the graphs, the values in their pool and the static
        buffers: an evicted entry, or one that failed to build, holds no
        memory whoever still refers to it."""
        self.items, self.inputs, self.env = [], {}, None
        self._held.clear()

    def _stage(self, env: dict) -> None:
        for name, buf in self.inputs.items():
            if isinstance(buf, int) or name in (self.unread or ()):
                continue            # a dim, or an input no run reads
            for b, s in zip(_leaves(buf), _leaves(env[name])):
                if s.dim() == 0 and s.device.type == "cpu" \
                        and b.device.type != "cpu":
                    b.fill_(s.item())        # a host scalar: no copy, no sync
                else:
                    b.copy_(s)

    def _read(self, flag) -> bool:
        self.syncs += 1
        return bool(flag)

    # ---- the card ----
    def _capture(self) -> None:
        from ..kernels import ops
        ex = self.executor
        env = dict(self.inputs)
        try:
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side), _quiet(ex), self._recorded():
                ex.execute(self.plan, dict(env), self.ctx)
            cur.wait_stream(side)
            notes = dict(ex.decisions)
            env = dict(self.inputs)       # with the stand-ins
            self._capture_block(self.items, env,
                                torch.cuda.graph_pool_handle(), ops)
        except BaseException:
            # nothing of a failed build stays alive with the exception that
            # the caller keeps: not its graphs, not the values in their
            # pool, not the static buffers
            self.free()
            raise
        self.env = env
        ex.decisions.update(notes)    # the warm-up's, not the capture's own

    def _capture_block(self, items, env: dict, pool, ops) -> None:
        for it in items:
            if isinstance(it, tuple):
                loop, body = it
                benv = dict(env)
                benv.update(loop.carry)
                self._capture_block(body, benv, pool, ops)
                env.update(loop.carry)
                continue
            g = torch.cuda.CUDAGraph()
            with ops.captured() as took, torch.cuda.graph(g, pool=pool):
                it.work(self.executor, env, self.ctx)
            it.graph, it.launches = g, took
            self._held.append(list(env.values()))

    def _replay(self, items) -> None:
        from ..kernels import ops
        for it in items:
            if isinstance(it, tuple):
                loop, body = it
                while self._read(loop.flag):
                    self._replay(body)
            else:
                it.graph.replay()
                ops.credit(it.launches)

    # ---- the CPU ----
    def _run_cpu(self, items, env: dict) -> dict:
        for it in items:
            if isinstance(it, tuple):
                loop, body = it
                while self._read(loop.flag):
                    benv = dict(env)
                    benv.update(loop.carry)
                    self._run_cpu(body, benv)
                env.update(loop.carry)
                continue
            if it.fired:
                with _quiet(self.executor):
                    it.work(self.executor, env, self.ctx)
            else:
                it.work(self.executor, env, self.ctx)
                it.fired = True
        return env
