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
device).  An input that no run reads (the first node that names it is a
store that replaced it whole, as the first run showed) is neither copied
nor held: its buffer is a stand-in of its shape and dtype without memory.
All graphs of an entry share one memory pool and are captured in the order
in which they are replayed; the entry holds every value that crosses graphs
(carries, flags, values of an earlier region that a later one reads).
Outputs are cloned out of that memory before they are returned, so that the
next call cannot overwrite a result that a caller holds.

Donation (`donate=`, the reference's donate_argnums).  A donated name is an
output that is also an input (a mutated destination or a loop carry).  Its
entry ends with one more step, in the last graph: the output's value is
written back into the input's static buffer, and the caller gets that
buffer (a tensor on it) in place of a clone; on the card a donated name
that no run reads (kmeans' D) has no buffer and no write-back, and the
caller gets the graphs' own memory that holds the output.  A caller who
hands the tensor back as the next call's input (the feed-back pattern)
costs no copy in and none out: its values already lie where the graph
reads them.  A
caller's tensor on the program's device given for a donated name is
consumed (`Tensor.set_()` leaves it without elements), as jax deletes a
donated array; its memory, with every view of it, is the call's.  A buffer
the caller may still hold when another value comes in for it is moved out
of the way.  On the CPU the entry takes a fresh buffer (no copy: the
caller's tensor and any numpy array on it keep their memory).  Capture
fixes addresses on the card, so there the caller's tensor, when nothing
else refers to its memory, takes a copy of its values (counted as cloned
bytes, as the clone it replaces); otherwise the entry takes a new buffer
and captures its graphs again (a rebind, counted).  `staged_bytes`,
`cloned_bytes` and `rebinds` count what the calls copied in, copied out
and recaptured.

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

Batches (`BatchEntry`, the serving layer's batched call; the reference
vmaps its traced plan).  Host reads of a flag do not batch, so a batch of
B requests of one padded signature runs the plan B times, once a lane,
inside the same graphs (the walk of the schedule is Entry's, `_Walk`, with
B lanes where an Entry has one), node by node across the lanes; a
group-by on the segment kernel is one call of its lanes entry for all B
lanes (`PlanExecutor.lanes`).  Each region is one
graph that holds every lane's nodes, each lane reading its slice of stacked buffers
[B, ...] and its own row counts (`ExecContext.bag_limits` and
`array_limits`: 0-d views into [B] int32 counts that each call's staging
fills, so that one capture serves every call of the signature).  A loop
runs while any lane's condition holds, one flag read an iteration; a lane
whose condition is false keeps its carry bit for bit (a select, not
arithmetic).  All of a batch's inputs, outputs and counts lie in one byte
buffer (`Layout`): a call is one copy in from the staged batch, the
replays, and one copy of the outputs' range back to the host; the outputs
are written back over their inputs (donated).  `HostBatch` is the stacked
batch on the host (pinned memory on the card), `Batch` its copy on the
device, queued on the current stream (the serving layer stages the next
flush's while the device still works on the last one): the entry's own
buffer is written only by the call itself, in stream order, so a flush
never writes what a replay still reads.
"""
from __future__ import annotations

import weakref
from collections import Counter
from collections.abc import Mapping
from contextlib import contextmanager

import numpy as np
import torch

from . import plan as P
from .loop_ast import RejectionError


class _Loop:
    """A SeqLoop of the plan and its state in a walk of B lanes: each
    lane's carry buffers, the lanes' device flags [B] (whether each lane's
    body runs again) and `any` (whether any lane's does; on one lane, its
    flag).  Its body's schedule lies beside it in the schedule, so that no
    region of the body refers back to an object that holds the region (a
    reference cycle would keep an entry's graphs alive until the cyclic
    garbage collector runs)."""

    def __init__(self, node: P.SeqLoop):
        self.node = node
        self.lanes: list = []
        self.flags = self.any = None

    def start(self, B: int, device) -> None:
        self.lanes = [dict() for _ in range(B)]
        self.flags = torch.zeros(B, dtype=torch.bool, device=device)
        self.any = self.flags[0] if B == 1 else \
            torch.zeros((), dtype=torch.bool, device=device)

    @property
    def carry(self) -> dict:
        """Lane 0's carry buffers (an Entry's one lane)."""
        return self.lanes[0]


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


def _shares(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _is_view_of(a: torch.Tensor, b: torch.Tensor) -> bool:
    """`a` is `b` element for element: the same memory, offset, shape,
    strides and dtype."""
    return a.data_ptr() == b.data_ptr() and a.dtype == b.dtype \
        and a.shape == b.shape and a.stride() == b.stride() \
        and a.device == b.device


def _uses(t: torch.Tensor) -> int:
    """How many tensors (and storage objects) refer to `t`'s memory (a
    torch function without a public name: the only way to see a view the
    caller keeps of a lent buffer on the card)."""
    return torch._C._storage_Use_Count(t.untyped_storage()._cdata)


def _write_back(buf: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """`v` written into `buf` (a donated input's buffer); returns `buf`."""
    if not _is_view_of(v, buf):
        buf.copy_(v.clone() if _shares(v, buf) else v)
    return buf


def _final(items: list) -> list:
    """`items` ending with a region (one without nodes after a last
    loop), which then holds the write-back step."""
    if not items or isinstance(items[-1], tuple):
        items.append(_Region([]))
    return items


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


class _Walk:
    """The walk of a schedule that Entry and BatchEntry share: B lanes of
    the plan (an Entry has one), each with its env and its ExecContext.  A
    region runs its nodes one by one, each on every lane (the injection
    sites fire for lane 0),
    then, in the last region, the write-back (`_finish`), then its loop
    step: each lane's new carry copied into its buffers and its condition
    into its flag.  With more than one lane, a lane whose condition was
    false keeps its carry bit for bit (a select, not arithmetic) and its
    flag, and the loop runs while any flag holds.  On the card each region
    is captured once into a graph and replayed; on the CPU it runs
    eagerly."""

    last = None               # the region that ends with the write-back

    def _walk(self, executor, plan, ctxs: list) -> None:
        self.executor = executor
        self.plan = plan
        self.device = executor.device
        self.card = self.device.type == "cuda"    # graphs, or eager regions
        self.ctxs = ctxs
        for it in _items(self.items):
            if isinstance(it, tuple):
                it[0].start(len(ctxs), self.device)
        self._held: list = []
        self.syncs = 0        # host reads of a loop flag in the last run

    @property
    def graphs(self) -> int:
        """Graphs a run replays (on the CPU: the regions it runs)."""
        return len(_regions(self.items))

    def _finish(self, envs: list) -> None:
        """The last region's write-back."""

    def _read(self, flag) -> bool:
        self.syncs += 1
        return bool(flag)

    def _work(self, it: _Region, envs: list) -> None:
        ex = self.executor
        # node by node across the lanes: every lane runs a node before any
        # runs the next, so that under a batch's `lanes()` the lanes of a
        # group-by reach the segment kernel in one call (settle)
        for node in it.nodes:
            vals = [ex.run_node(node, envs[0], self.ctxs[0])]
            with _quiet(ex):
                vals += [ex.run_node(node, env, ctx) for env, ctx
                         in zip(envs[1:], self.ctxs[1:])]
            for env, v in zip(envs, ex.settle(vals)):
                ex.assign(node, env, v)
        if it is self.last:
            self._finish(envs)
        loop = it.enter or it.back
        if loop is None:
            return
        many = len(envs) > 1
        for b, (env, ctx) in enumerate(zip(envs, self.ctxs)):
            bufs = loop.lanes[b]
            new = {c: ex._t(env[c]) for c in loop.node.carry}
            for c, v in new.items():
                if it.enter is not None and c not in bufs:
                    bufs[c] = torch.empty(v.shape, dtype=v.dtype,
                                          device=v.device)
                if v.shape != bufs[c].shape or v.dtype != bufs[c].dtype:
                    raise RejectionError(
                        f"SeqLoop carry '{c}' changes from "
                        f"{tuple(bufs[c].shape)} {bufs[c].dtype} to "
                        f"{tuple(v.shape)} {v.dtype}")
            if it.back is not None and many:
                # a lane whose condition was false keeps its carry
                new = {c: torch.where(loop.flags[b], v, bufs[c])
                       for c, v in new.items()}
            # a new value that shares memory with a carry buffer (an
            # unchanged or swapped carry) is read in full before any write
            for c, v in new.items():
                if any(_shares(v, o) for o in bufs.values()):
                    new[c] = v.clone()
            for c, v in new.items():
                bufs[c].copy_(v)
            env.update(bufs)
            cond = ex.loop_cond(loop.node, env, ctx)
            if it.back is not None and many:
                cond = cond & loop.flags[b]
            loop.flags[b].copy_(cond)
        if many:
            loop.any.copy_(loop.flags.any())

    # ---- the card ----
    def _capture(self, warm, envs) -> list:
        """The graphs captured: `warm()` first runs the plan eagerly once
        on a side stream (PyTorch's warm-up before a capture), then each
        region is captured, in the order of its replays, into one pool,
        over `envs()`.  Returns the captured envs.  A failed build leaves
        nothing alive (`free`)."""
        from ..kernels import ops
        ex = self.executor
        try:
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side), _quiet(ex):
                warm()
            cur.wait_stream(side)
            notes = dict(ex.decisions)
            envs = envs()
            self._capture_block(self.items, envs,
                                torch.cuda.graph_pool_handle(), ops)
        except BaseException:
            # nothing of a failed build stays alive with the exception that
            # the caller keeps: not its graphs, not the values in their
            # pool, not the static buffers
            self.free()
            raise
        ex.decisions.update(notes)    # the warm-up's, not the capture's own
        return envs

    def _capture_block(self, items, envs: list, pool, ops) -> None:
        for it in items:
            if isinstance(it, tuple):
                loop, body = it
                self._capture_block(
                    body, [dict(e, **loop.lanes[b])
                           for b, e in enumerate(envs)], pool, ops)
                for b, e in enumerate(envs):
                    e.update(loop.lanes[b])
                continue
            g = torch.cuda.CUDAGraph()
            with ops.captured() as took, torch.cuda.graph(g, pool=pool):
                self._work(it, envs)
            it.graph, it.launches = g, took
            self._held.append([list(e.values()) for e in envs])

    def _replay(self, items) -> None:
        from ..kernels import ops
        for it in items:
            if isinstance(it, tuple):
                loop, body = it
                while self._read(loop.any):
                    self._replay(body)
            else:
                it.graph.replay()
                ops.credit(it.launches)

    # ---- the CPU ----
    def _run_cpu(self, items, envs: list) -> list:
        for it in items:
            if isinstance(it, tuple):
                loop, body = it
                while self._read(loop.any):
                    self._run_cpu(body, [dict(e, **loop.lanes[b])
                                         for b, e in enumerate(envs)])
                for b, e in enumerate(envs):
                    e.update(loop.lanes[b])
                continue
            if it.fired:
                with _quiet(self.executor):
                    self._work(it, envs)
            else:
                self._work(it, envs)
                it.fired = True
        return envs


class Entry(_Walk):
    """The executable of one signature: static input buffers, the
    schedule of regions and loops, and (on the card) one captured graph a
    region.  `run(env)` takes the call's inputs in their canonical dtypes,
    on the host or on the device, and returns fresh output tensors, or,
    for a donated name, a tensor on the entry's buffer."""

    def __init__(self, executor, plan, outputs, ctx, env: dict, donate=()):
        self.outputs = tuple(outputs)
        self.items = schedule(plan)
        self._walk(executor, plan, [ctx])
        self.inputs = {n: self._buffer(v) for n, v in env.items()}
        self.unread = None    # the inputs no run reads, once a run showed
        self.env = None       # on the card: the env the graphs captured
        # donation: the outputs written back into their input's buffer
        # (dropped at the first run where the output's shape or dtype is
        # not its input's)
        self.wb = {n for n in donate if n in self.outputs
                   and torch.is_tensor(self.inputs.get(n))}
        if self.wb:
            self.last = _final(self.items)[-1]
        # on the card, the donated names no run reads: their outputs are
        # lent from the graphs' own memory, with no buffer and no write-back
        self._direct: set = set()
        self._home = {}       # donated name → the memory its output lies in
        self._free = {}       # donated name → uses of that memory, unlent
        self._lent = {}       # donated name → the tensor the caller got
        self.staged = Counter()   # name → bytes copied in, over all calls
        self.cloned = Counter()   # name → bytes copied out, over all calls
        self.rebinds = 0          # recaptures for a buffer the caller holds

    def _buffer(self, v):
        if isinstance(v, int):             # a dim: part of the signature
            return v
        if isinstance(v, tuple):           # a bag's columns
            return tuple(self._buffer(c) for c in v)
        return torch.empty(v.shape, dtype=v.dtype, device=self.device)

    @property
    def staged_bytes(self) -> int:
        return sum(self.staged.values())

    @property
    def cloned_bytes(self) -> int:
        return sum(self.cloned.values())

    def run(self, env: dict, donated=None) -> dict:
        """One call.  `donated` maps donated names to the caller's tensors
        on this device: each is consumed once the call has run."""
        donated = donated or {}
        fed = self._adopt(donated)
        self._stage(env, fed)
        self.syncs = 0
        if self.card:
            if self.env is None:
                self.env = self._capture(self._warm, self._envs)[0]
            self._replay(self.items)
            res = self.env
        elif self.unread is None:
            with self._recorded():
                res = self._run_cpu(self.items, self._envs())[0]
        else:
            res = self._run_cpu(self.items, self._envs())[0]
        out = {}
        for n in self.outputs:
            if n not in self.wb:
                out[n] = res[n].clone()
                self.cloned[n] += out[n].nbytes
        self._home = {n: res[n] if n in self._direct else self.inputs[n]
                      for n in self.wb}
        del res
        for t in donated.values():
            t.set_()                 # consumed: no elements left
        for n, home in self._home.items():
            if self.card:
                self._free[n] = _uses(home)
            out[n] = home.detach()
            self._lent[n] = weakref.ref(out[n])
        return {n: out[n] for n in self.outputs}

    def _adopt(self, donated: dict) -> set:
        """The donated names whose values already lie in their buffers
        (the caller fed back what the last call returned).  Every other
        donated name's buffer may still be held by the caller, and is moved
        out of the way first.  On the CPU, which has no graphs and so no
        addresses to keep, the entry takes a fresh buffer and leaves the
        caller's tensor, its views and any numpy array on its memory as
        they are.  On the card a buffer that anyone else still refers to is
        moved: the tensor the caller got keeps its values in memory of its
        own when nothing else refers to the buffer, else the buffer is
        replaced and the graphs are captured again."""
        fed = {n for n, t in donated.items()
               if n in self._home and _is_view_of(t, self._home[n])}
        if not self.card:
            for n, home in self._home.items():
                if n not in fed:
                    self.inputs[n] = torch.empty_like(home)
            return fed
        moved = []
        for n, home in self._home.items():
            extra = _uses(home) - self._free[n] - (n in fed)
            if extra <= 0:
                continue
            lent = self._lent[n]()
            if extra == 1 and lent is not None and _is_view_of(lent, home) \
                    and n not in fed:
                # only the tensor the caller got: it takes its own copy
                lent.set_(lent.clone())
                self.cloned[n] += lent.nbytes
                continue
            if n not in self._direct:  # the graphs' own memory: recaptured
                self.inputs[n] = torch.empty_like(home)
            fed.discard(n)             # its values: staged from the caller
            moved.append(n)
        if moved:
            self.rebinds += 1
            if self.env is not None:
                self._recapture()
        return fed

    def _envs(self) -> list:
        return [dict(self.inputs)]

    def _warm(self) -> None:
        with self._recorded():
            self.executor.execute(self.plan, dict(self.inputs),
                                  self.ctxs[0])

    def _finish(self, envs: list) -> None:
        """The last region's step under donation: each donated output
        written back into its input's buffer."""
        env = envs[0]
        for n in sorted(self.wb - self._direct):
            buf, v = self.inputs[n], env[n]
            if not torch.is_tensor(v) or v.shape != buf.shape \
                    or v.dtype != buf.dtype:
                self.wb.discard(n)     # returned as a clone, as undonated
                continue
            env[n] = _write_back(buf, v)

    @contextmanager
    def _recorded(self):
        """Around the first run: records the stores that replace their
        destination whole, then finds the inputs no run reads and drops
        their buffers for stand-ins.  A donated one keeps its buffer for
        the write-back, except on the card, where its output is lent from
        the graphs' memory (`_direct`)."""
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
        if self.card:
            self._direct = self.wb & self.unread
        for name in self.unread - (self.wb - self._direct):
            self.inputs[name] = _stand_in(self.inputs[name])

    def free(self) -> None:
        """Let go of the graphs, the values in their pool and the static
        buffers: an evicted entry, or one that failed to build, holds no
        memory whoever still refers to it."""
        self.items, self.inputs, self.env = [], {}, None
        self._held.clear()

    def _stage(self, env: dict, fed=()) -> None:
        for name, buf in self.inputs.items():
            if isinstance(buf, int) or name in (self.unread or ()) \
                    or name in fed:
                continue   # a dim, an input no run reads, or one fed back
            for b, s in zip(_leaves(buf), _leaves(env[name])):
                if s.dim() == 0 and s.device.type == "cpu" \
                        and b.device.type != "cpu":
                    b.fill_(s.item())        # a host scalar: no copy, no sync
                else:
                    b.copy_(s)
                self.staged[name] += b.nbytes

    # ---- the card ----
    def _recapture(self) -> None:
        """The graphs captured again over the current buffers (a donated
        buffer the caller holds was replaced)."""
        from ..kernels import ops
        for r in _regions(self.items):
            r.graph = None
        self._held.clear()
        envs = self._envs()
        with _quiet(self.executor):
            self._capture_block(self.items, envs,
                                torch.cuda.graph_pool_handle(), ops)
        self.env = envs[0]


# ---------------------------------------------------------------------------
# batches: the serving layer's batched call
# ---------------------------------------------------------------------------

_ALIGN = 256         # bytes between two values of a batch's buffer


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype)).dtype


class Layout:
    """Where each value of a batch lies in one byte buffer: the outputs
    first, so that their range goes back to the host in one copy, then
    the other inputs, then the row counts.  `spec` lists (key, shape,
    torch dtype): key a param name, (bag, column) for a bag's column, or
    ("#rows", name) for a padded name's [B] int32 row counts."""

    def __init__(self, spec, outputs):
        first = [e for o in outputs for e in spec if e[0] == o]
        rest = [e for e in spec if e not in first]
        self.slots: dict = {}
        off = 0
        for key, shape, dtype in first + rest:
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            self.slots[key] = (off, tuple(shape), dtype)
            off += -(-n // _ALIGN) * _ALIGN
            if key in outputs:
                self.out_bytes = off
        if not first:
            self.out_bytes = 0
        self.outputs = tuple(o for o in outputs if o in self.slots)
        self.nbytes = max(off, 1)

    def key(self) -> tuple:
        return tuple((k, s, str(d)) for k, (_, s, d) in self.slots.items())

    def views(self, buf: torch.Tensor, keys=None) -> dict:
        out = {}
        for key in (self.slots if keys is None else keys):
            off, shape, dtype = self.slots[key]
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            out[key] = buf[off:off + n].view(dtype).view(shape)
        return out


def _group(views: dict):
    """Per-key views → the param dict (bags as tuples of columns) and the
    row counts by name."""
    arrays, rows, cols = {}, {}, {}
    for key, v in views.items():
        if isinstance(key, tuple) and key[0] == "#rows":
            rows[key[1]] = v
        elif isinstance(key, tuple):
            cols.setdefault(key[0], {})[key[1]] = v
        else:
            arrays[key] = v
    for name, c in cols.items():
        arrays[name] = tuple(c[i] for i in range(len(c)))
    return arrays, rows


def batch_spec(arrays: dict, lengths: dict) -> list:
    """The Layout spec of stacked values: `arrays` name → [B, ...] array
    (a bag: a tuple of [B, L] columns), `lengths` name → [B] row counts;
    numpy or torch."""
    def dt(v):
        return v.dtype if torch.is_tensor(v) else torch_dtype(v.dtype)
    spec = []
    for name, v in arrays.items():
        if isinstance(v, tuple):
            spec += [((name, i), tuple(c.shape), dt(c))
                     for i, c in enumerate(v)]
        else:
            spec.append((name, tuple(v.shape), dt(v)))
    spec += [(("#rows", name), tuple(v.shape), torch.int32)
             for name, v in lengths.items()]
    return spec


class HostBatch:
    """A batch stacked on the host, in pinned memory when it goes to the
    card: `arrays` and `lengths` are numpy views of its one buffer, which
    the caller fills."""

    def __init__(self, spec, outputs, device):
        self.device = torch.device(device)
        self.layout = Layout(spec, tuple(outputs))
        self.buf = torch.empty(self.layout.nbytes, dtype=torch.uint8,
                               pin_memory=self.device.type == "cuda")
        host = self.buf.numpy()
        views = {k: host[o:o + int(np.prod(s, dtype=np.int64))
                         * d.itemsize].view(_np_dtype(d)).reshape(s)
                 for k, (o, s, d) in self.layout.slots.items()}
        self.arrays, self.lengths = _group(views)

    @classmethod
    def of(cls, arrays: dict, lengths: dict, outputs, device) -> "HostBatch":
        """A host batch holding copies of stacked numpy values."""
        hb = cls(batch_spec(arrays, lengths), outputs, device)
        for name, v in arrays.items():
            for dst, src in zip(_leaves(hb.arrays[name]), _leaves(v)):
                dst[...] = src
        for name, v in lengths.items():
            hb.lengths[name][...] = v
        return hb

    def to_device(self) -> "Batch":
        """The batch staged on its device: on the card one copy from the
        pinned buffer, queued on the current stream behind the work
        already there (the host goes on at once); on the CPU the host
        buffer is the batch."""
        if self.device.type != "cuda":
            return Batch(self.layout, self.buf)
        dev = torch.empty(self.layout.nbytes, dtype=torch.uint8,
                          device=self.device)
        dev.copy_(self.buf, non_blocking=True)
        return Batch(self.layout, dev)


class Batch:
    """A staged batch: its layout and its one buffer on the device."""

    def __init__(self, layout: Layout, buf: torch.Tensor):
        self.layout = layout
        self.buf = buf


class Outputs(Mapping):
    """A batched call's outputs, name → [B, ...] numpy array, from one
    copy of the outputs' range to the host; on the card the copy is
    waited for at the first read, so that the caller can queue more work
    (the next batch's staging) before it."""

    def __init__(self, arrays: dict, event=None):
        self._arrays = arrays
        self._event = event

    def _ready(self) -> dict:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._arrays

    def __getitem__(self, name):
        return self._ready()[name]

    def __iter__(self):
        return iter(self._arrays)

    def __len__(self) -> int:
        return len(self._arrays)


class BatchEntry(_Walk):
    """The executable of one batch signature: one buffer for the stacked
    inputs, outputs and row counts (`layout`), B lanes of the plan in
    each region's graph.  `run(batch)` stages a Batch of that layout and
    returns the outputs [B, ...] as numpy arrays, from one copy to the
    host."""

    def __init__(self, executor, plan, outputs, static: dict,
                 layout: Layout, limit_bags=(), limit_arrays=(),
                 salts=None):
        self.outputs = tuple(outputs)
        self.layout = layout
        self.items = _final(schedule(plan))
        self.last = self.items[-1]    # it writes the outputs back
        self.buf = torch.empty(layout.nbytes, dtype=torch.uint8,
                               device=executor.device)
        arrays, rows = _group(layout.views(self.buf))
        self.stacked = arrays
        first = next(iter(arrays.values()))
        self.lanes = int(_leaves(first)[0].shape[0])
        self.envs = [dict(static, **{n: _lane(v, b)
                                     for n, v in arrays.items()})
                     for b in range(self.lanes)]
        self._walk(executor, plan,
                   [_lane_ctx(rows, b, limit_bags, limit_arrays, salts)
                    for b in range(self.lanes)])
        self.captured = False
        self.staged_bytes = 0
        self.returned_bytes = 0

    def run(self, batch: Batch) -> "Outputs":
        if batch.layout.key() != self.layout.key():
            raise ValueError("a batch of another layout than its entry's")
        self._stage(batch)
        self.syncs = 0
        with self.executor.lanes():
            if self.card:
                if not self.captured:
                    # the warm-up: lane 0 once, eagerly, writing nothing it
                    # reads
                    self._capture(lambda: self.executor.execute(
                        self.plan, dict(self.envs[0]), self.ctxs[0]),
                        self._envs)
                    self.captured = True
                self._replay(self.items)
            else:
                self._run_cpu(self.items, self._envs())
        return self._outputs()

    def _envs(self) -> list:
        return [dict(e) for e in self.envs]

    def free(self) -> None:
        self.items, self.envs, self.stacked, self.buf = [], [], {}, None
        self._held.clear()

    def _stage(self, batch: Batch) -> None:
        self.buf.copy_(batch.buf)
        self.staged_bytes += batch.buf.nbytes

    def _outputs(self) -> "Outputs":
        n = self.layout.out_bytes
        event = None
        if self.card:
            host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            host.copy_(self.buf[:n], non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        else:
            host = self.buf[:n].clone()
        self.returned_bytes += n
        views = self.layout.views(host, self.layout.outputs)
        return Outputs({k: views[k].numpy() for k in self.outputs}, event)

    def _finish(self, envs: list) -> None:
        """Each lane's outputs written back over its inputs (donated)."""
        for b, env in enumerate(envs):
            for n in self.outputs:
                buf = _lane(self.stacked[n], b)
                v = env[n]
                if not torch.is_tensor(v) or v.shape != buf.shape \
                        or v.dtype != buf.dtype:
                    raise RejectionError(
                        f"output '{n}' leaves a batch lane as "
                        f"{tuple(getattr(v, 'shape', ()))} "
                        f"{getattr(v, 'dtype', type(v))}, not as it came")
                env[n] = _write_back(buf, v)


def _items(items):
    for it in items:
        yield it
        if isinstance(it, tuple):
            yield from _items(it[1])


def _lane(v, b: int):
    return tuple(c[b] for c in v) if isinstance(v, tuple) else v[b]


def _lane_ctx(rows: dict, b: int, limit_bags, limit_arrays, salts):
    from .lower import ExecContext
    return ExecContext(bag_limits={n: rows[n][b] for n in limit_bags},
                       array_limits={n: rows[n][b] for n in limit_arrays},
                       salts=dict(salts or {}))
