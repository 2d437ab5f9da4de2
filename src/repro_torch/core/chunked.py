"""Chunked out-of-core execution: the capacity rung of the fault ladder.

When a call's estimated peak (memest.py) exceeds the memory budget, or an
all-resident attempt dies with a classified capacity error, the plan is
rewritten so that its bag-consuming nodes stream the bag through
device-resident destination accumulators in row tiles:

  * `chunk_plan` groups maximal runs of chunk-safe single-bag nodes into
    `ChunkLoop`s — a `SeqLoop` subclass, so the loop inherits the plan's
    explain/carry/checkpoint contracts (`plan.seq_loops` enumerates it;
    `runtime.LoopRunner` checkpoints its carry per chunk);
  * `ChunkRunner` keeps the bag columns on the host and streams them (its
    docstring says how);
  * a tile rides the executor's offset machinery
    (`ExecContext.bag_offsets`): the offset makes the bag index var
    global, so no node body changes at all.

The plan half (`ChunkLoop`, `chunk_plan`, `_chunkable`, `_reads_ok`,
`_make_loop`, `choose_chunk_rows`) is the reference's
(src/repro/core/chunked.py), with one exception, `_pin_bit_identical`:

  * On the CPU a grouped SegmentReduce of a chunk body is pinned to the
    scatter backend, as in the reference.  Its `index_add_` folds straight
    into the RUNNING destination, a serial left fold, so splitting the bag
    into tiles gives `(((dest ⊕ t1) ⊕ t2) ⊕ …)`: the same fold, in the
    same row order, as the single all-resident scatter.
  * On the card `index_add_` is atomic and its float sums change from run
    to run (op_select.DETERMINISTIC keeps float + group-bys off it), so a
    + group-by of a chunk body is pinned to the deterministic segment
    kernel ("pallas").  That kernel fixes its order by ranges of
    RANGE_ROWS rows and folds the ranges' results in row order, and the
    executor then combines the result with the destination.  So the
    runner folds a running partial for such a destination, range by
    range from the identity (`ExecContext.partials`, the kernel's
    `init=`), and combines it with the destination once,
    after the last chunk: with tiles of whole ranges that is the
    all-resident fold bit for bit.  A tile that is not a whole number of
    ranges (a tight budget, the halving rung) reassociates the float
    sums: still correct (exact for integers and min/max, within float32
    rounding for float +), and the fault ledger says that it is not
    bit-identical.  The card's default tile is one range, not the
    reference's 4096 rows (`default_chunk_rows`).  A program on the CPU
    that forces the segment kernel (op_select="force:pallas") pins it in
    chunk bodies too, and folds as the card does.
  * A chunk checkpoint records the rows its stream has folded (`ROWS`),
    and a resume goes on from that row with the tile of the resumed run
    (the halving rung's, another budget's): the reference counts chunks
    of a tile it does not record, so a chunk snapshot of the JAX package
    is refused rather than resumed at a guessed tile.
  * Hot-key salting stays off inside chunk bodies (salt = 1), as in the
    reference: a [K, S] salted partial folded per tile is another
    association.

ScalarReduce chunks combine per-tile partials with ⊕: exact for min/max,
reassociated (allclose) for float +, here as in the reference.

Fault sites `lower.chunk_step` / `lower.chunk_prefetch` fire before every
step and tile copy; transients retry in place at chunk granularity,
capacity errors propagate to the halving rung of
`CompiledProgram._run_chunked`.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import torch

from . import faults as F
from . import plan as P
from .dist_analysis import aligned_reads, gathers_of

__all__ = ["ChunkLoop", "chunk_plan", "choose_chunk_rows", "ChunkRunner",
           "DEFAULT_CHUNK_ROWS", "default_chunk_rows"]

# the reference's default tile, and the port's on the CPU
DEFAULT_CHUNK_ROWS = 4096
# a restored running partial's key in a chunk checkpoint's carry
PARTIAL = "#partial"
# the rows a chunk checkpoint's carry has folded: a resume goes on from
# that row, whatever tile the resumed run streams
ROWS = "#rows"


def default_chunk_rows(device) -> int:
    """The tile when neither chunk_rows nor a budget says: the reference's
    4096 rows on the CPU; on the card one range of the segment kernel
    (2^26 rows), the unit its order is fixed by — 4096 would be 131,072
    launches for a 2^29-row bag, and not the all-resident bits."""
    if torch.device(device).type == "cuda":
        from ..kernels.segment_reduce import RANGE_ROWS
        return RANGE_ROWS
    return DEFAULT_CHUNK_ROWS


# ---------------------------------------------------------------------------
# the plan node
# ---------------------------------------------------------------------------

@dataclass
class ChunkLoop(P.SeqLoop):
    """Outer streaming loop over row tiles of one bag.  `cond` is None —
    the trip count is ceil(rows/tile), known only at run time from the
    concrete bag, so the ChunkRunner drives it host-side.  Reaching the
    plain executor (e.g. an all-resident run of a chunked plan) degrades
    to simple sequencing of the body with the whole bag as one tile —
    same results."""
    chunk_bag: str = ""

    def describe(self) -> str:
        return (f"ChunkLoop(stream {self.chunk_bag} tiles, "
                f"carry={','.join(self.carry)})")


# ---------------------------------------------------------------------------
# the chunking pass
# ---------------------------------------------------------------------------

_CHUNK_LEAVES = (P.SegmentReduce, P.Scatter, P.ScalarReduce, P.AxisReduce,
                 P.MapExpr)


def _bag_axis(node):
    space = getattr(node, "space", None)
    if space is None:
        return None, None
    bags = [a for a in space.axes if a.kind == "bag"]
    if len(bags) != 1:
        return None, None
    return bags[0].bag, bags[0].var


def _chunkable(node) -> bool:
    """One bag axis, and every row tile's contribution ⊕-folds into the
    destination independently of the other tiles."""
    if isinstance(node, P.Fused):
        return (_bag_axis(node)[0] is not None
                and all(isinstance(p, _CHUNK_LEAVES) for p in node.parts))
    if not isinstance(node, _CHUNK_LEAVES):
        return False
    bag, var = _bag_axis(node)
    if bag is None:
        return False
    if isinstance(node, P.MapExpr) and not isinstance(node, P.AxisReduce):
        # a store only chunks when each tile writes its own rows: the bag
        # axis var must key the destination
        if node.key_axes is None or var not in node.key_axes:
            return False
    return True


def _reads_ok(node, gdests: set, bag_var: str) -> bool:
    """May `node` join a group whose earlier members write `gdests`?
    Only if every read of those still-accumulating destinations is
    row-local (leading-indexed by the bag axis var): tile c reads only
    rows tile c just wrote.  Any other read would observe a partial
    fold."""
    if not gdests:
        return True
    aligned = aligned_reads(node, bag_var)
    gathered = set(gathers_of(node))
    for name in gdests:
        if name in gathered and name not in aligned:
            return False
        if name not in gathered and name in getattr(node, "reads", frozenset()):
            return False              # scalar/whole-array read of a partial
    return True


def _pin_bit_identical(node, plus: str = "scatter"):
    """Copy a node for a chunk body, pinning choices that keep the tiled
    fold bit-identical to the all-resident one (module docstring): a +
    group-by takes `plus` ("scatter" on the CPU, the segment kernel
    "pallas" on the card), any other the scatter backend."""
    n2 = copy.copy(node)
    if isinstance(n2, P.Fused):
        n2.parts = [_pin_bit_identical(p, plus) for p in node.parts]
        return n2
    if isinstance(n2, P.SegmentReduce):
        cands = n2.candidates or ()
        if n2.op == "+" and plus in cands:
            n2.backend = plus
        elif "scatter" in cands:
            n2.backend = "scatter"
        n2.salt = 1                   # no hot-key spreading inside a tile
    return n2


def _make_loop(group: list, bag: str, plus: str = "scatter") -> ChunkLoop:
    body = [_pin_bit_identical(n, plus) for n in group]
    carry: list = []
    for n in group:
        for d in P.dests_of(n):
            if d not in carry:
                carry.append(d)
    reads = frozenset().union(*(getattr(n, "reads", frozenset())
                                for n in group))
    return ChunkLoop(stmt=group[0].stmt, space=group[0].space,
                     reads=reads, cond=None, body=body,
                     carry=tuple(carry), chunk_bag=bag)


def chunk_plan(nodes, prog=None, plus: str = "scatter"):
    """Rewrite a plan so bag-consuming nodes stream: returns
    (new_plan, n_chunk_loops).  Non-bag nodes and unchunkable shapes run
    all-resident between the streaming loops — correctness never depends
    on a node being grouped, only peak memory does.  `plus` is the
    backend a + group-by of a chunk body is pinned to."""
    out: list = []
    nloops = 0
    group: list = []
    gbag = gvar = None
    gdests: set = set()

    def flush():
        nonlocal group, gbag, gvar, gdests, nloops
        if group:
            out.append(_make_loop(group, gbag, plus))
            nloops += 1
        group, gbag, gvar, gdests = [], None, None, set()

    for n in P.flatten(nodes):
        if isinstance(n, P.SeqLoop):
            flush()
            body2, k = chunk_plan(n.body, prog, plus)
            if k:
                n2 = copy.copy(n)
                n2.body = body2
                out.append(n2)
                nloops += k
            else:
                out.append(n)
            continue
        if _chunkable(n):
            bag, var = _bag_axis(n)
            # a second writer of a group destination must NOT interleave
            # with the first at tile granularity: the all-resident fold
            # finishes one node's contributions before the next begins
            same_dest = any(d in gdests for d in P.dests_of(n))
            if group and (bag != gbag or same_dest
                          or not _reads_ok(n, gdests, gvar)):
                flush()
            if not group:
                gbag, gvar = bag, var
            group.append(n)
            gdests.update(P.dests_of(n))
        else:
            flush()
            out.append(n)
    flush()
    return out, nloops


# ---------------------------------------------------------------------------
# chunk sizing
# ---------------------------------------------------------------------------

def choose_chunk_rows(est, budget: int, n_rows: int | None = None) -> int:
    """Largest power-of-two tile with fixed + rows·per_row ≤ budget
    (per_row already charges two tiles for the prefetch double buffer)."""
    per = max(1, est.per_row())
    avail = int(budget) - est.fixed_bytes
    if avail <= per:
        rows = 1
    else:
        rows = 1 << (int(avail // per).bit_length() - 1)
    if n_rows:
        rows = min(rows, int(n_rows))
    return max(1, rows)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _bags_of(node) -> set:
    """The bags a node (or a loop's, a fused region's members) iterates."""
    out: set = set()
    for n in P.flatten([node]):
        if isinstance(n, P.SeqLoop):
            out |= set().union(*(_bags_of(b) for b in n.body))
        space = getattr(n, "space", None)
        if space is not None:
            out |= {a.bag for a in space.axes if a.kind == "bag"}
        for p in getattr(n, "parts", ()) or ():
            out |= _bags_of(p)
    return out


def _segment_parts(nodes):
    for n in nodes:
        if isinstance(n, P.Fused):
            yield from _segment_parts(n.parts)
        elif isinstance(n, P.SegmentReduce):
            yield n


class ChunkRunner:
    """Executes the chunked form of a CompiledProgram's plan.

    Bags stay on the host (pinned on the card: `pin_memory()` once a run,
    unless the caller's columns already are); everything else goes to the
    program's device.  A ChunkLoop streams its bag in tiles of
    `chunk_rows` rows: each tile is copied `non_blocking` on a side stream
    into one of two device buffers, an event orders the copy before the
    step that reads the buffer, and another orders that step before the
    next copy that overwrites it, so the copy of tile c+1 runs under the
    step of tile c.  A bag the caller put on the card is sliced where it
    lies.  The step runs the body eagerly on the tile; the destinations
    are the runner's own device copies (never the caller's tensors),
    updated in place after each step.  The last tile is the remaining
    rows: not zero-padded to a full tile, because the segment kernel's
    work split follows the rows a launch is given, and only the unpadded
    tile gives the all-resident bits."""

    def __init__(self, cp):
        self.cp = cp
        self.device = cp.device
        self._plan = None
        self._nloops = 0
        self.last_chunk_rows: int | None = None
        self.chunks_run = 0
        self._noted = False           # the not-bit-identical note, a run

    @property
    def plus(self) -> str:
        """The backend a + group-by of a chunk body is pinned to: the
        segment kernel on the card, or where the program forces it (its
        plain version on the CPU); the scatter backend otherwise."""
        if self.device.type == "cuda" or self.cp.selector.forced == "pallas":
            return "pallas"
        return "scatter"

    @property
    def plan(self):
        if self._plan is None:
            self._plan, self._nloops = chunk_plan(self.cp.plan,
                                                  self.cp.program, self.plus)
        return self._plan

    @property
    def n_chunk_loops(self) -> int:
        _ = self.plan
        return self._nloops

    def explain(self) -> str:
        return P.explain(self.plan, name=f"{self.cp.program.name} [chunked]",
                         decisions=self.cp.executor.decisions)

    # ---- env ----
    def prepare_env(self, inputs: dict) -> dict:
        """The call's inputs in their canonical dtypes: bags on the host
        (pinned when the program runs on the card) or where the caller put
        them on the card; everything else on the program's device."""
        from ..convert import inputs_from_numpy
        from .tiles import TiledMatrix
        params = self.cp.program.params
        env = inputs_from_numpy(inputs, None, params)
        for name, v in env.items():
            if params[name].kind == "bag":
                env[name] = tuple(self._host_column(c) for c in v)
            elif isinstance(v, TiledMatrix):
                env[name] = TiledMatrix(v.tiles.to(self.device),
                                        v.mask.to(self.device), v.shape)
            elif torch.is_tensor(v):
                env[name] = v.to(self.device)
        return env

    def _host_column(self, c: torch.Tensor) -> torch.Tensor:
        if c.device.type != "cpu" or self.device.type == "cpu":
            return c                   # on the card already, or a CPU run
        return c if c.is_pinned() else c.pin_memory()

    # ---- driving ----
    def run(self, inputs: dict, *, chunk_rows: int,
            observer=None, loop_state=None) -> dict:
        """Same contract as CompiledProgram.run / run_stepwise: observer
        (when given) fires per top-level loop iteration — per CHUNK for a
        ChunkLoop — and `loop_state` fast-forwards both loop kinds, which
        is what makes LoopRunner resume chunk-granular."""
        env = self.prepare_env(inputs)
        self.last_chunk_rows = int(chunk_rows)
        self._noted = False
        li = 0
        for node in self.plan:
            st = (loop_state or {}).get(li)
            if isinstance(node, ChunkLoop):
                self._stream(node, env, chunk_rows, li=li,
                             observer=observer, state=st)
                li += 1
            elif isinstance(node, P.SeqLoop):
                self._host_loop(node, env, chunk_rows, li=li,
                                observer=observer, state=st)
                li += 1
            else:
                self._resident(node, env)
        return {n: env[n] for n in self.cp.program.outputs}

    def _resident(self, node, env):
        """A node that does not stream: all-resident, its bags (if any)
        copied to the card for it."""
        from .lower import _EMPTY_CTX
        e = env
        moved = {b: tuple(c.to(self.device, non_blocking=True)
                          for c in env[b])
                 for b in _bags_of(node)
                 if b in env and env[b] and env[b][0].device != self.device}
        if moved:
            e = dict(env)
            e.update(moved)
        self.cp.executor.execute([node], e, _EMPTY_CTX)
        if moved:
            env.update({k: v for k, v in e.items() if k not in moved})

    def _host_loop(self, node, env, chunk_rows, *, li, observer, state):
        """A SeqLoop whose body streams: the executor's host loop with the
        body streamed, checkpointed per ITERATION exactly like
        run_stepwise's loops."""
        from .lower import _EMPTY_CTX
        it = 0
        if state is not None:
            it, carry = state
            env.update(self.cp.carry_in(node.carry, carry))

        def body(e):
            for b in node.body:
                if isinstance(b, ChunkLoop):
                    self._stream(b, e, chunk_rows, li=None, observer=None,
                                 state=None)
                else:
                    self._resident(b, e)

        self.cp.executor._exec_seq_loop(node, env, _EMPTY_CTX, li=li, it=it,
                                        observer=observer, body=body)

    # ---- the stream ----
    def _partials(self, node: ChunkLoop) -> dict:
        """The destinations of the body's + group-bys on the segment
        kernel that no body node reads: each folds a running partial."""
        if self.plus != "pallas":
            return {}
        reads = set().union(*(getattr(b, "reads", frozenset())
                              for b in P.flatten(node.body)))
        return {s.dest: s.op for s in _segment_parts(P.flatten(node.body))
                if s.op == "+" and s.backend == "pallas"
                and s.dest not in reads}

    def _note_inexact(self, node: ChunkLoop, env, tile: int, lo: int,
                      n: int, partial_ops: dict) -> None:
        """On the card, say in the ledger when a + group-by's float sums
        are not the all-resident ones: tiles that are not whole ranges
        (or a resume from a row inside a range), or a destination the
        body reads back (folded tile by tile)."""
        from ..kernels.segment_reduce import RANGE_ROWS
        if self._noted or self.plus != "pallas" or (lo == 0 and tile >= n):
            return
        floats = [s.dest for s in _segment_parts(P.flatten(node.body))
                  if s.op == "+" and s.backend == "pallas"
                  and env[s.dest].dtype.is_floating_point]
        if not floats:
            return
        if tile % RANGE_ROWS == 0 and lo % RANGE_ROWS == 0 \
                and all(d in partial_ops for d in floats):
            return
        self._noted = True
        self.cp.faults.record(
            "inexact", f"chunked[{tile}]",
            f"tiles of {tile} rows: the float sums of {','.join(floats)} "
            f"are not folded in whole ranges of {RANGE_ROWS} rows "
            "(within float32 rounding, not bit-identical to the "
            "all-resident run)")

    def _stream(self, node: ChunkLoop, env, chunk_rows, *, li,
                observer, state):
        from .lower import COMBINE, ExecContext
        bag = node.chunk_bag
        cols = env[bag]
        n = int(cols[0].shape[0]) if cols else 0
        if n == 0:
            return                     # ⊕ over an empty bag contributes identity
        tile = max(1, min(int(chunk_rows), n))
        ex = self.cp.executor
        partial_ops = self._partials(node)
        it, lo = 0, 0
        src = {d: env[d] for d in node.carry}
        partials = {d: None for d in partial_ops}
        if state is not None:
            it, carry = state
            lo = _rows_done(carry, n)
            src = self.cp.carry_in(node.carry, carry)
            saved = self.cp.carry_in(
                [d + PARTIAL for d in partial_ops if d + PARTIAL in carry],
                carry)
            partials.update({k[:-len(PARTIAL)]: v for k, v in saved.items()})
        self._note_inexact(node, env, tile, lo, n, partial_ops)
        # the runner's own copies: a step never writes the caller's tensors
        dests = {d: ex._t(v).to(self.device).clone() for d, v in src.items()}
        tiles = _Tiles(cols, tile, n, self.device)
        offsets = range(lo, n, tile)

        def prefetch(k):
            def attempt():
                F.site("lower.chunk_prefetch", loop=li, chunk=it + k)
                return tiles.fetch(k, offsets[k])
            return F.run_with_retries(attempt, policy=self.cp.policy,
                                      ledger=self.cp.faults,
                                      label=f"prefetch[{bag}]")

        nxt = prefetch(0) if offsets else None
        for k, off in enumerate(offsets):
            cur, nxt = nxt, None

            def attempt(k=k, off=off, cur=cur):
                F.site("lower.chunk_step", loop=li, chunk=it + k)
                e = dict(env)
                e.update(dests)
                e[bag] = tiles.ready(k, cur)
                parts = dict(partials)
                ctx = ExecContext(bag_offsets={bag: off}, partials=parts)
                ex.execute(node.body, e, ctx)
                return {d: e[d] for d in node.carry}, parts

            new, parts = F.run_with_retries(attempt, policy=self.cp.policy,
                                            ledger=self.cp.faults,
                                            label=f"chunk[{bag}]")
            tiles.used(k)
            # the next tile crosses host → device while this step runs
            if k + 1 < len(offsets):
                nxt = prefetch(k + 1)
            for d, v in new.items():
                if v is not dests[d]:
                    dests[d].copy_(v)
            partials = parts
            self.chunks_run += 1
            if observer is not None and li is not None:
                carry = dict(dests)
                carry.update({d + PARTIAL: p for d, p in partials.items()
                              if p is not None})
                carry[ROWS] = torch.tensor(min(off + tile, n))
                observer(li, it + k + 1, carry)
        for d, op in partial_ops.items():
            p = partials[d]
            if p is not None:
                dests[d] = COMBINE[op](
                    dests[d], p.reshape(dests[d].shape).to(dests[d].dtype))
        env.update(dests)


def _rows_done(carry: dict, n: int) -> int:
    """The row a chunk checkpoint's stream goes on from.  A carry that does
    not record it (a snapshot of the JAX package, which counts chunks of a
    tile it does not record) is refused: guessing the tile would skip rows
    or fold them twice."""
    if ROWS not in carry:
        raise ValueError(
            f"a chunk loop's state must record the rows it folded "
            f"({ROWS!r} in its carry); this one records only a chunk count "
            "of an unknown tile: run the stream from the start")
    rows = int(carry[ROWS])
    if not 0 <= rows <= n:
        raise ValueError(f"a chunk loop's state folded {rows} rows of a "
                         f"bag of {n}")
    return rows


class _Tiles:
    """The tiles of one bag's columns.  Host columns on the card: two
    device buffers of a full tile, filled by `non_blocking` copies on a
    side stream (`fetch`), each ordered before the step that reads it
    (`ready`) and after the step that last read its buffer (`used`).  The
    side stream starts after all work already queued on the main one, so
    a first copy never lands in memory a step still in flight reads (the
    caching allocator hands out blocks freed by launched, unfinished
    work), and the buffers are freed only once the side stream's copies
    are done.  Columns on the card, or a run on the CPU: views of the
    columns."""

    def __init__(self, cols, tile: int, n: int, device):
        self.cols, self.tile, self.n = cols, tile, n
        self.copying = device.type == "cuda" and \
            cols[0].device.type == "cpu"
        if self.copying:
            self.side = torch.cuda.Stream(device)
            self.main = torch.cuda.current_stream(device)
            self.bufs = [tuple(torch.empty((tile,) + c.shape[1:],
                                           dtype=c.dtype, device=device)
                               for c in cols) for _ in range(2)]
            for b in self.bufs:
                for t in b:
                    t.record_stream(self.side)
            self.side.wait_stream(self.main)
            self.copied = [torch.cuda.Event(), torch.cuda.Event()]
            self.read = [None, None]   # the step that last read a buffer

    def fetch(self, k: int, lo: int):
        """The tile of rows [lo, lo + tile), into buffer k % 2."""
        rows = min(self.tile, self.n - lo)
        if not self.copying:
            return tuple(col[lo:lo + rows] for col in self.cols)
        i = k % 2
        with torch.cuda.stream(self.side):
            if self.read[i] is not None:
                self.side.wait_event(self.read[i])
            for b, col in zip(self.bufs[i], self.cols):
                b[:rows].copy_(col[lo:lo + rows], non_blocking=True)
            self.copied[i].record(self.side)
        return tuple(b[:rows] for b in self.bufs[i])

    def ready(self, k: int, cur):
        """Tile k for the step: the step's stream waits for its copy."""
        if self.copying:
            self.main.wait_event(self.copied[k % 2])
        return cur

    def used(self, k: int) -> None:
        """The step of tile k was launched: a later copy into its buffer
        waits for it."""
        if self.copying:
            ev = torch.cuda.Event()
            ev.record(self.main)
            self.read[k % 2] = ev
