"""Distributed execution of compiled loop programs over a torch.distributed
process group — the paper's DISC backend, as rounds of the executor on
each rank's row blocks with collectives between them (DESIGN.md §4, §6).
The PyTorch port of the reference's core/distributed.py, `shardmap` mode.

One process a rank (multi-controller).  The reference is single-
controller: one process, a mesh of devices and shard_map round bodies.
Here every rank of the mesh's group (launch/mesh.py) calls
`run(inputs)` with the same GLOBAL host inputs; `place()` keeps the rank's
own row block of every bag and of every dense array the distribution
analysis placed ONED_ROW (dist_analysis.py), padded to a multiple of the
rank count under the reference's bag / array limits, and replicates the
rest.  Every rank returns the global outputs: row-block outputs are
all-gathered and cut to their logical length, so each rank's result is
the reference's `run()` result.  The env a round sees holds, for each
name, the rank's block (bags and ONED arrays) or the whole value (REP).

Each plan node runs as one of the reference's rounds, on the executor
(lower.py) with the per-rank ExecContext fields (bag offsets, row
offsets, axis overrides, alignment certificates):

    aligned store round    MapExpr/Scatter keyed by the round axis: every
                           rank writes only its own block; no collective
    aligned reduce round   AxisReduce/EinsumContract/TiledMatmul keyed by
                           the round axis: local partial-⊕ into the local
                           block; no collective
    unaligned reduce round local partial-⊕ into a dense [K(, D)] partial,
                           then the exchange op_select picks: all_reduce
                           (REP destination), or reduce_scatter_tensor /
                           all_reduce + narrow (ONED destination).  A
                           salted group-by folds its key*S+salt partial to
                           [K] BEFORE the exchange
    rebalance round        plan.Rebalance (ONED_VAR → ONED_ROW): live-row
                           counts exchanged (all_reduce), exclusive cumsum
                           offsets, one reduce_scatter all-to-all
    replicated             everything else: the node's block operands are
                           all-gathered, it runs on every rank on the
                           global values, and a ONED destination keeps the
                           rank's block

Reads the analysis could not prove aligned are all-gathered on entry to
the round; the collectives are core/collectives.py's, whose transport is
fixed by (backend, device, operation).

Rounds run eagerly: the reference's cache of one jitted round per (node,
strategy, static params) is kept as a cache of round closures, with its
`_round_traces` / `_round_hits` counters, so `explain_rounds()` reports
them as the reference does.  A `plan.FusedRound` region runs as ONE
dispatch sequence: its members in order with their collectives between
them.  A SeqLoop whose whole body is one region runs that sequence under
a host-driven loop, one flag read an iteration (the reference runs an
on-device lax.while_loop inside its one shard_map program: a deliberate
divergence, ROADMAP.md).  A guard failure falls back to per-member
rounds; fusion never changes results, only dispatch.

The failure ladder (DESIGN.md §11–§13) is the reference's: retries at
each level, then REP-everything placements, then the single-device
program; a capacity error takes the chunked tier.  With one controller a
rank, a failure that reaches the ladder is settled among the ranks first
(`_settle`): ranks that failed alike retry or descend together, and a
rank that failed alone (or ranks that failed differently) fail every
rank with RankDivergence instead of descending on their own.  A lost
shard's block is recovered surgically from lineage (block-restricted
recompute or a replay of the round, checksum-verified), a straggling
round gets one speculative backup.  Every decision that chooses collectives is the same
on every rank: it depends on global shapes, on the global inputs (the
hot-key probe), on replicated values (loop conditions) or on a flag the
ranks agree on (straggler, recovery verification).

`mode="gspmd"` (XLA's SPMD partitioner) has no PyTorch counterpart that
would run the port's kernels: it raises (ROADMAP.md).
"""
from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch

from .. import convert as _convert   # a module: convert imports core
from . import faults as F
from . import plan
from .collectives import Collectives
from .dist_analysis import (Dist, aligned_reads, leading_key_var,
                            round_axis, shard_slice_certificates)
from .lower import (COMBINE, CompiledProgram, ExecContext, ShardOffset,
                    _host, identity, salt_for_node)

_STORE_NODES = (plan.MapExpr, plan.Scatter)
_ALIGNABLE_REDUCES = (plan.AxisReduce, plan.EinsumContract, plan.TiledMatmul)


class RankDivergence(RuntimeError):
    """The ranks of the group did not fail alike: one failed alone, or
    they failed in different ways.  No rank descends the ladder alone
    (its collectives would pair with others' of another level), so every
    rank raises this and the group is torn down."""


class DistributedProgram:
    # how long a failed rank waits for the others' outcome of the same
    # step before it takes them to be blocked in a collective (seconds)
    vote_timeout_s = 60.0

    def __init__(self, cp: CompiledProgram, mesh, dp_axes=("data",),
                 mode: str = "shardmap", shard_dense: bool = True):
        if mode == "gspmd":
            raise NotImplementedError(
                "mode='gspmd' (XLA's SPMD partitioner) has no PyTorch "
                "counterpart that runs the port's kernels: ROADMAP.md, "
                "Queue 1, 'Distributed rounds: gspmd mode'")
        if mode != "shardmap":
            raise ValueError(f"unknown mode {mode!r}")
        if cp.device.type != mesh.device.type or None not in (
                cp.device.index, mesh.device.index) \
                and cp.device.index != mesh.device.index:
            raise ValueError(f"the program runs on {cp.device}, the mesh's "
                             f"rank on {mesh.device}")
        self.cp = cp
        self.mesh = mesh
        self.dp = tuple(dp_axes)
        self.mode = mode
        self.dp_n = 1
        for a in self.dp:
            self.dp_n *= mesh.shape[a]
        if self.dp_n != mesh.size:
            raise ValueError(f"the data-parallel axes {self.dp} span "
                             f"{self.dp_n} of the group's {mesh.size} ranks")
        self.shard = mesh.rank           # this rank's block index
        self.coll = Collectives(mesh)
        self._bags = frozenset(n for n, t in cp.program.params.items()
                               if t.kind == "bag")
        # placement = inferred distribution, capped at ONED_ROW
        self.dists = dict(cp.dists) if shard_dense else \
            {a: Dist.REP for a in cp.dists}
        self.placements = {a: min(d, Dist.ONED_ROW)
                           for a, d in self.dists.items()}
        # arrays the plan only ever touches as unaligned reduce dests /
        # cross-shard reads: place() may demote them to REP per run when
        # the op_select cost model says a sharded destination does not pay
        # for their size.  Placement only: results never change
        from .dist_analysis import demotable_dests
        self._demotable = demotable_dests(cp.plan, cp.program) \
            if shard_dense else {}
        self._base_placements = dict(self.placements)
        self._demoted: dict = {}        # name → Decision, per run
        # round closure per (node, strategy, static params): SeqLoop
        # iterations and repeated run() calls reuse the round instead of
        # deriving it again; fused regions share the cache
        self._round_cache: dict = {}
        self._round_traces = 0
        self._round_hits = 0
        # region ids whose fused execution failed a guard THIS run
        self._fused_bail: set = set()
        # id(node) → round strategy of the LAST run(), id(leaf) → the
        # per-rank materialization; cache hits restore the snapshot taken
        # when their round was built
        self._strategy: dict = {}
        self._decisions: dict = {}
        self._strategy_by_key: dict = {}
        self._round_notes: dict = {}
        # id(node) → the collectives its round ran and their transport
        self._transport: dict = {}
        self._static_cache: dict = {}
        # skew observability (explain_rounds "balance:" lines)
        self._rebalanced = frozenset(
            n.dest for n in _walk_plan(cp.plan)
            if isinstance(n, plan.Rebalance))
        self._balance: dict = {}
        # id(node) → hot-key salt factor of this run (probed on the global
        # inputs, so every rank salts alike)
        self._node_salts: dict = {}
        # failure policy: the ledger and retry policy are SHARED with the
        # wrapped CompiledProgram — one ladder per program
        self.faults = cp.faults
        self.policy = cp.policy
        self._force_rep = False
        # ---- surgical recovery (DESIGN.md §13) ----
        self._shard_loss: dict = {}
        self.lineage_enabled = cp.config.lineage
        self.speculative = cp.config.speculative
        self._spec_done: set = set()
        self._round_times: dict = {}    # round → its earlier wall times
        self.flag_reads = 0             # loop flags read on the host, last run

    def _placed_oned(self, name) -> bool:
        # ONED_VAR counts: variable-length arrays still shard as equal
        # physical row blocks — only their LOGICAL live lengths differ
        return self.placements.get(name, Dist.REP) >= Dist.ONED_VAR

    def _blocked(self, name) -> bool:
        """True when the env holds the rank's block of `name`."""
        return name in self._bags or self._placed_oned(name)

    # ------------------------- input placement -------------------------
    def place(self, inputs: dict):
        """This rank's part of the global inputs: the row block of every bag
        and ONED_ROW dense array (dim 0 padded with zero rows to a
        multiple of the rank count), the whole of the rest.  Returns
        (placed, bag_limits, array_limits); the limit dicts map each padded
        name to its logical dim-0 length, which every consumer masks by."""
        out = {}
        bag_limits: dict[str, int] = {}
        array_limits: dict[str, int] = {}
        self.placements = dict(self._base_placements)
        self._demoted = {}
        if self._force_rep:
            # REP-everything ladder level: every dense array replicates
            # (bags still shard — they are the iteration space)
            self.placements = {a: Dist.REP for a in self.placements}
        params = self.cp.program.params
        for name, t in params.items():
            if t.kind not in ("vector", "matrix", "map") \
                    or name not in self._demotable \
                    or not self._placed_oned(name):
                continue
            shp = _shape(inputs[name])
            if not shp:
                continue
            dec = self.cp.selector.choose_reduce_dest(
                k=int(shp[0]), d=math.prod(int(d_) for d_ in shp[1:]),
                op=self._demotable[name], nshards=self.dp_n)
            if dec.backend == "replicate":
                self.placements[name] = Dist.REP
                self._demoted[name] = dec
        dev = self.mesh.device
        for name, t in params.items():
            v = inputs[name]
            if t.kind == "bag":
                cols = v if isinstance(v, tuple) else (v,)
                n = int(_shape(cols[0])[0])
                if n % self.dp_n:
                    bag_limits[name] = n
                out[name] = tuple(self._block_of(c, None) for c in cols)
            elif t.kind == "dim":
                out[name] = int(v)
            elif t.kind in ("vector", "matrix", "map"):
                dt = torch.float32 if t.dtype == "float" else torch.int32
                if self._placed_oned(name):
                    n = int(_shape(v)[0])
                    if n % self.dp_n:
                        array_limits[name] = n
                    out[name] = self._block_of(v, dt)
                else:
                    out[name] = _convert.to_tensor(v, dev, dt)
            else:
                out[name] = _convert.to_tensor(v, dev, None)
        return out, bag_limits, array_limits

    def _block_of(self, v, dtype) -> torch.Tensor:
        """Rows [rank·blk, (rank+1)·blk) of v's dim 0 padded to a multiple
        of the rank count, in the canonical dtype on the rank's device;
        only the block is cut from the host array."""
        n = int(_shape(v)[0])
        blk = -(-n // self.dp_n)
        lo = min(self.shard * blk, n)
        hi = min(lo + blk, n)
        piece = _convert.to_tensor(v[lo:hi], self.mesh.device, dtype)
        if hi - lo < blk:
            pad = torch.zeros((blk - (hi - lo),) + tuple(piece.shape[1:]),
                              dtype=piece.dtype, device=piece.device)
            piece = torch.cat([piece, pad])
        return piece

    # ---- blocks and global values ----
    def _global(self, name, v):
        """The whole (padded) value of `name` from the rank's block."""
        if name in self._bags:
            return tuple(self.coll.all_gather(c) for c in v)
        if self._placed_oned(name):
            return self.coll.all_gather(v)
        return v

    def _block(self, v: torch.Tensor) -> torch.Tensor:
        blk = v.shape[0] // self.dp_n
        return v.narrow(0, self.shard * blk, blk)

    def _gshape(self, name, env) -> tuple:
        """The global (padded) shape of `name`, whatever the env holds."""
        v = env[name]
        col = v[0] if isinstance(v, tuple) else v
        shp = tuple(col.shape)
        if self._blocked(name) and shp:
            shp = (shp[0] * self.dp_n,) + shp[1:]
        return shp

    def _rows(self, name, env) -> int:
        return int(self._gshape(name, env)[0])

    def _agree(self, flag: bool) -> bool:
        """True on every rank when it is true on any rank (a decision that
        chooses collectives must be the same everywhere)."""
        if self.dp_n == 1:
            return bool(flag)
        return bool(self.coll.agree(bool(flag)))

    # ------------------------- collectives -------------------------
    def _combine_shard(self, part, op: str, dest_oned: bool,
                       exchange: str = "psum_scatter"):
        """Cross-rank ⊕ of an unaligned partial: all_reduce for a
        replicated destination; for a row-block destination the exchange
        op_select chose — reduce-scatter (each rank receives its K/P rows)
        or all_reduce + narrow (the only form for min and max)."""
        if not dest_oned:
            return self.coll.all_reduce(part, op)
        if op == "+" and exchange == "psum_scatter":
            return self.coll.reduce_scatter(part)
        return self._block(self.coll.all_reduce(part, op))

    # ------------------- rebalance rounds (ONED_VAR → ONED_ROW) ----------
    def _rebalance_local(self, x, lim):
        """The rebalance round on this rank's block: a size exchange (one-
        hot all_reduce of live-row counts), exclusive-cumsum global
        offsets, a scatter of the live rows to their balanced positions,
        then a reduce_scatter back to equal blocks.  Each position
        receives exactly ONE nonzero addend, so the composition is an
        exact all-to-all, not an approximate reduction."""
        dev = x.device
        blk = x.shape[0]
        npad = blk * self.dp_n
        rows = self.shard * blk + torch.arange(blk, device=dev)
        live = rows < lim
        cnt = live.sum().to(torch.int32)
        onehot = torch.zeros(self.dp_n, dtype=torch.int32, device=dev)
        onehot[self.shard] = cnt
        counts = self.coll.all_reduce(onehot, "+")
        start = (torch.cumsum(counts, 0) - counts)[self.shard]
        pos = start + torch.cumsum(live.to(torch.int32), 0) - 1
        pos = torch.where(live, pos, npad)    # dead rows: the spare row
        buf = torch.zeros((npad + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=dev)
        buf.index_add_(0, pos.to(torch.int64), x)
        return self.coll.reduce_scatter(buf[:npad])

    def _shard_counts(self, npad: int, lim):
        """Host-side mirror of the size exchange (for observability): the
        live row count each rank holds under the canonical front-packed
        layout, plus the max/mean balance factor."""
        blk = npad // self.dp_n
        if lim is None:
            lim = npad
        counts = [max(0, min(blk, lim - s * blk)) for s in range(self.dp_n)]
        mean = sum(counts) / len(counts)
        factor = (max(counts) / mean) if mean else float("inf")
        return counts, factor

    def _exec_rebalance(self, node, env, array_limits):
        """Run a plan.Rebalance as its own cached round.  Elided — with an
        explain_rounds note — when the destination is replicated (nothing
        to balance) or carries no limit (blocks already equal)."""
        dest = node.dest
        if not self._placed_oned(dest):
            self._strategy[id(node)] = "rebalance: elided (replicated dest)"
            return
        npad = self._rows(dest, env)
        blk = npad // self.dp_n
        lim = array_limits.get(dest)
        if lim is None:
            self._strategy[id(node)] = (
                f"rebalance: elided (already balanced, {blk} rows × "
                f"{self.dp_n} shards)")
            return
        v = env[dest]
        cache_key = ("rebalance", id(node), tuple(v.shape), str(v.dtype),
                     lim)
        fn = self._round_cache.get(cache_key)
        if fn is None:
            fn = partial(self._rebalance_local, lim=lim)
            self._round_cache[cache_key] = fn
            self._round_traces += 1
        else:
            self._round_hits += 1
        prev = env[dest]
        env[dest] = fn(prev)
        counts, factor = self._shard_counts(npad, lim)
        self._strategy[id(node)] = (
            f"rebalance(size-exchange psum + all-to-all psum_scatter)"
            f"→{dest}; rows/shard={counts} balance={factor:.2f}")
        self._transport[id(node)] = self._transport_text(
            ("all_reduce", "reduce_scatter_tensor"))
        self._shard_lost_site(
            node, "rebalance", env, [(dest, "rebalance")], {dest: prev},
            lambda _fn=fn, _p=prev: {dest: _fn(_p)},
            unit="rebalance round")

    def _transport_text(self, ops) -> str:
        return ", ".join(f"{op} over {self.coll.transport(op)}"
                         for op in dict.fromkeys(ops))

    # ---- per-node round classification (runtime shape guards) ----
    def _round_spec(self, node, env):
        """Decide how to run `node`: None = replicated; else a dict with
        the round axis, per-part kinds (store / aligned / reduce) and the
        read classification (localize vs all_gather).  Every guard failure
        degrades to a coarser-but-correct strategy, never to an error."""
        parts = list(node.parts) if isinstance(node, plan.Fused) else [node]
        dests_set = {p.dest for p in parts}
        space = node.space
        static = self._static_cache.get(id(node))
        if static is None:
            axis = round_axis(node if not isinstance(node, plan.Fused)
                              else parts[0])
            static = (axis,
                      aligned_reads(node, axis) if axis is not None
                      else frozenset(),
                      _gather_names(node))
            self._static_cache[id(node)] = static
        axis, aligned, gather_names = static
        rng = None
        if space.has_bag:
            if axis is None and not plan.is_reduce(node):
                return None
            axis_rows = self._rows(next(
                a.bag for a in space.axes if a.kind == "bag"), env) \
                if axis is not None else None
        else:
            if axis is None:
                return None
            aspec = next(a for a in space.axes if a.var == axis)
            try:
                lo = self.cp.executor.static_int(aspec.lo, env)
                hi = self.cp.executor.static_int(aspec.hi, env)
            except Exception:
                return None
            if lo != 0 or hi <= 0:
                return None
            axis_rows = hi + (-hi) % self.dp_n
            # (block, limit, total): no mask needed when the rows tile
            # evenly (limit=None); `total` = padded global extent, the
            # bound certifying per-rank slices of replicated operands
            rng = (axis_rows // self.dp_n,
                   hi if axis_rows != hi else None,
                   axis_rows)

        def dest_aligned(p):
            return (axis is not None
                    and leading_key_var(p) == axis
                    and self._placed_oned(p.dest)
                    and self._rows(p.dest, env) == axis_rows)

        kinds = []
        for p in parts:
            if isinstance(p, _STORE_NODES):
                # stores run replicated unless every rank writes (and
                # reads, for read-modify-writes) strictly within its block
                if not dest_aligned(p):
                    return None
                if p.dest in gather_names and p.dest not in aligned:
                    return None            # self-read not block-local
                kinds.append("store")
            elif plan.is_reduce(p):
                if isinstance(p, _ALIGNABLE_REDUCES) and dest_aligned(p):
                    kinds.append("aligned")
                elif space.has_bag:
                    kinds.append("reduce")
                else:
                    return None            # range round: no psum source
            else:
                return None
        # localized reads must tile exactly like the round axis
        local = frozenset(n for n in aligned
                          if n not in dests_set
                          and self._placed_oned(n)
                          and self._rows(n, env) == axis_rows)
        return {"parts": parts, "kinds": kinds, "axis": axis, "rng": rng,
                "local": local, "axis_rows": axis_rows}

    def _exec_shardmap(self, nodes, env, limits, array_limits):
        for node in nodes:
            if isinstance(node, plan.SeqLoop):
                # best: the whole loop as ONE fused dispatch sequence under
                # a host-driven loop (collectives inside the region)
                if len(node.body) == 1 \
                        and isinstance(node.body[0], plan.FusedRound) \
                        and self._exec_fused(node.body[0], env, limits,
                                             array_limits, loop=node):
                    continue
                # next: a fully-replicated body needs no collectives inside
                # the loop — the single-device executor runs it on the
                # global values
                if self._loop_replicated(node, env):
                    self._strategy[id(node)] = (
                        "single-device executor loop (replicated body, "
                        "one flag read per iteration)")
                    self._exec_replicated([node], env, limits, array_limits)
                    for b in plan.flatten(node.body):
                        self._decisions.update(self._part_notes(b))
                    continue
                # fallback: host-driven loop, body nodes distributed
                # recursively with one condition sync per iteration
                syncs = 0
                while self._cond(node, env):
                    syncs += 1
                    self._exec_shardmap(node.body, env, limits, array_limits)
                self._strategy[id(node)] = \
                    f"host-driven ({syncs + 1} condition syncs)"
                continue

            if isinstance(node, plan.FusedRound):
                if self._exec_fused(node, env, limits, array_limits):
                    continue
                # a runtime guard failed: per-member rounds
                self._exec_shardmap(node.parts, env, limits, array_limits)
                continue

            if isinstance(node, plan.Rebalance):
                self._exec_rebalance(node, env, array_limits)
                continue

            spec = self._round_spec(node, env) \
                if (plan.is_reduce(node) or isinstance(node, _STORE_NODES)) \
                else None
            if spec is None:
                # replicated execution (identical result on all ranks)
                self._strategy[id(node)] = "replicated"
                self._exec_replicated([node], env, limits, array_limits)
                self._decisions.update(self._part_notes(node))
                continue
            self._run_round(node, spec, env, limits, array_limits)

    def _cond(self, node, env) -> bool:
        """A SeqLoop's condition, read on the host (one flag read)."""
        from .passes import _expr_names
        names: set = set()
        _expr_names(node.cond, names)
        genv = dict(env)
        for n in names:
            if n in env and self._blocked(n):
                genv[n] = self._global(n, env[n])
        self.flag_reads += 1
        return bool(self.cp.executor.loop_cond(node, genv))

    def _exec_replicated(self, nodes, env, limits, array_limits):
        """Run `nodes` on every rank on the global values: each block they
        touch is all-gathered first, and a ONED destination keeps the
        rank's block of the result."""
        names = _names_of(nodes)
        genv = dict(env)
        gathered = []
        for n in sorted(names):
            if n in env and self._blocked(n):
                genv[n] = self._global(n, env[n])
                gathered.append(n)
        for node in nodes:
            self._set_transport(node, self._transport_text(
                ("all_gather_into_tensor",)) if gathered else None)
        self.cp.execute(genv, bag_limits=limits, array_limits=array_limits,
                        nodes=nodes)
        for node in nodes:
            for d in plan.dests_of(node):
                env[d] = self._block(genv[d]) if self._blocked(d) \
                    else genv[d]

    def _loop_replicated(self, node, env) -> bool:
        """True when every leaf of the SeqLoop body classifies replicated
        (no round axis anywhere): the whole loop runs through the single-
        device executor instead of a loop of per-node dispatches."""
        for b in plan.flatten(node.body):
            if isinstance(b, plan.SeqLoop):
                if not self._loop_replicated(b, env):
                    return False
                continue
            if plan.is_reduce(b) or isinstance(b, _STORE_NODES):
                if self._round_spec(b, env) is not None:
                    return False
        return True

    def _straggled(self, key, label, dt) -> bool:
        """The straggler watchdog of the rounds: the ledger's rule
        (FaultLedger.note_time: slower than straggler_factor × the
        trailing median, a flagged sample not folded in), over the earlier
        executions of the SAME round (`key`).  Rounds differ in size by
        orders of magnitude — a fused loop runs all its iterations in one
        call, and on the card a round's host time is its device time only
        where it reads a flag — so one window over all of them (the
        reference's) flags every large round and doubles it."""
        times = self._round_times.setdefault(key, [])
        window = times[-20:]
        if len(window) >= 3:
            med = sorted(window)[len(window) // 2]
            if med > 0 and dt > self.faults.straggler_factor * med:
                self.faults.record("straggler", label,
                                   f"{dt * 1e3:.1f}ms vs median "
                                   f"{med * 1e3:.1f}ms")
                return True
        times.append(dt)
        return False

    def _call_round(self, fn, args, site_name, label, key):
        """Execute a round/fused closure under the failure policy: the
        injection site fires per attempt, transients retry at this level
        (bounded, backoff), and the wall time feeds the straggler watchdog
        of round `key`.  Capacity/deterministic errors re-raise —
        descending is the caller's move.

        A flagged straggler additionally triggers speculative re-execution
        (DESIGN.md §13): at most ONE backup copy of the flagged round per
        run (the ranks agree on the flag first), first finisher wins.
        Both copies run the same closure on the same operands, so
        adopting either never changes results."""
        def attempt():
            F.site(site_name, label=label)
            issued = self.coll.issued
            try:
                return fn(*args)
            except Exception as ex:
                if self.dp_n > 1 and self.coll.issued != issued:
                    # a collective went out: a retry on this rank alone
                    # would pair its collectives with the others' next
                    # ones, so the run settles it with the ranks instead
                    ex.unpaired = True
                raise
        t0 = self.faults.clock()
        out = F.run_with_retries(attempt, policy=self.policy,
                                 ledger=self.faults, label=label)
        dt = self.faults.clock() - t0
        # a round with fewer than 3 earlier runs flags on no rank (every
        # rank has run it as often), so the ranks need not agree on it
        eligible = len(self._round_times.get(key, ())) >= 3
        straggled = self._straggled(key, label, dt)
        if self.speculative and key not in self._spec_done and eligible \
                and self._agree(straggled):
            self._spec_done.add(key)
            t1 = self.faults.clock()
            backup = fn(*args)        # no injection site: the backup runs
            #                           on a different (healthy) worker
            dt2 = self.faults.clock() - t1
            if dt2 < dt:
                saved = dt - dt2
                self.faults.spec_saved_s += saved
                self.faults.record(
                    "speculative", label,
                    f"backup won: {dt2 * 1e3:.1f}ms vs straggler "
                    f"{dt * 1e3:.1f}ms (saved {saved * 1e3:.1f}ms); "
                    f"straggler copy cancelled")
                out = backup
            else:
                self.faults.record(
                    "speculative", label,
                    f"original finished first ({dt * 1e3:.1f}ms); backup "
                    f"cancelled after {dt2 * 1e3:.1f}ms")
        return out

    def _salts_of(self, parts) -> dict:
        return {p.dest: self._node_salts[id(p)] for p in parts
                if self._node_salts.get(id(p), 1) > 1}

    def _exchanges(self, parts, kinds, spec, env, dest_oned) -> dict:
        """op_select's exchange for every unaligned reduce part, keyed on
        (K, D, ⊕, ranks, rank-local rows, dest sharding)."""
        n_loc = (spec["axis_rows"] or self.dp_n) // self.dp_n
        out = {}
        for p, k in zip(parts, kinds):
            if k == "reduce":
                shp = self._gshape(p.dest, env)
                out[p.dest] = self.cp.selector.choose_exchange(
                    k=int(shp[0]) if shp else 1,
                    d=math.prod(int(d_) for d_ in shp[1:]), op=p.op,
                    nshards=self.dp_n, n_local=n_loc,
                    dest_dist="ONED_ROW" if dest_oned[p.dest] else "REP")
        return out

    def _run_round(self, node, spec, env, limits, array_limits):
        cp = self.cp
        parts, kinds = spec["parts"], spec["kinds"]
        axis, rng, local = spec["axis"], spec["rng"], spec["local"]
        dests = [p.dest for p in parts]
        params = cp.program.params
        reads = sorted(set(node.reads) - set(dests))
        dims = {n: env[n] for n in reads
                if n in params and params[n].kind == "dim"}
        names = [n for n in reads if n not in dims]
        bagnames = node.space.bag_names
        # ONED reads the analysis could NOT prove aligned cross ranks: all-
        # gather them on entry
        gathered = tuple(n for n in names
                         if n not in bagnames and n not in local
                         and self._placed_oned(n))
        args = [env[n] for n in names]
        store_dests = [p.dest for p, k in zip(parts, kinds) if k == "store"]
        args += [env[d] for d in store_dests]

        dest_shapes = tuple(self._gshape(d, env) for d in dests)
        dest_dtypes = tuple(env[d].dtype if torch.is_tensor(env[d])
                            else torch.float32 for d in dests)
        node_lims = {b: limits[b] for b in bagnames if b in limits}
        arr_lims = {n: array_limits[n]
                    for n in set(names) | set(dests) if n in array_limits}
        dest_oned = {d: self._placed_oned(d) for d in dests}
        exchanges = self._exchanges(parts, kinds, spec, env, dest_oned)
        salts = self._salts_of(parts)

        cache_key = (id(node), tuple(kinds), tuple(names),
                     tuple(store_dests), gathered, tuple(sorted(local)),
                     tuple(sorted(node_lims.items())),
                     tuple(sorted(arr_lims.items())),
                     tuple(sorted(dims.items())),
                     dest_shapes, dest_dtypes,
                     spec["axis"], spec["rng"],
                     tuple(sorted(self._demoted)),
                     tuple(sorted((d, x.backend)
                                  for d, x in exchanges.items())),
                     tuple(sorted(salts.items())))
        rlabel = f"round:{type(node).__name__}"
        # everything a block-restricted recompute of THIS round needs
        rec = {"spec": spec, "names": tuple(names),
               "bagnames": frozenset(bagnames), "gathered": gathered,
               "store_dests": tuple(store_dests), "dims": dims,
               "node_lims": node_lims, "arr_lims": arr_lims,
               "salts": salts}
        colls = [("all_gather_into_tensor",)] if gathered else []
        for p, k in zip(parts, kinds):
            if k == "reduce":
                colls.append(_exchange_ops(p.op, dest_oned[p.dest],
                                           exchanges[p.dest].backend))
        transport = self._transport_text(
            [op for ops in colls for op in ops]) if colls else None

        def replay(_fn=None, _args=tuple(args), _parts=parts,
                   _kinds=kinds):
            res2 = _fn(*_args)
            out2 = {}
            for p, k2, r in zip(_parts, _kinds, res2):
                out2[p.dest] = r if k2 == "store" else \
                    COMBINE[p.op](pre[p.dest], r)
            return out2

        fn = self._round_cache.get(cache_key)
        if fn is not None:
            self._round_hits += 1
            results = self._call_round(fn, args, "dist.round_exec", rlabel,
                                       id(node))
            # restore the build-time snapshot: the cached round re-runs
            # exactly what was built, whatever happened in between
            self._strategy[id(node)] = self._strategy_by_key[cache_key]
            self._decisions.update(self._round_notes[cache_key])
            self._set_transport(node, transport)
            pre = {p.dest: env[p.dest] for p in parts}
            self._apply(parts, kinds, results, env)
            self._shard_lost_site(
                node, rlabel, env, list(zip(dests, kinds)), pre,
                partial(replay, _fn=fn), rec)
            return

        self._strategy[id(node)] = self._round_desc(
            parts, kinds, axis, exchanges, dest_oned, gathered, local)
        self._set_transport(node, transport)
        fn = partial(self._round_body, parts=parts, kinds=kinds,
                     names=tuple(names), stores=tuple(store_dests),
                     bags=tuple(bagnames), gather=gathered,
                     local=tuple(local), lims=node_lims, alims=arr_lims,
                     dims=dims, shapes=dest_shapes, dtypes=dest_dtypes,
                     axis=axis, rng=rng, dest_oned=dest_oned,
                     exch={d: x.backend for d, x in exchanges.items()},
                     salts=salts)
        results = self._call_round(fn, args, "dist.round_exec", rlabel,
                                   id(node))
        # cached once it ran: a hit restores the snapshot taken here
        self._round_cache[cache_key] = fn
        self._round_traces += 1
        notes = self._part_notes(node)
        self._round_notes[cache_key] = notes
        self._decisions.update(notes)
        self._strategy_by_key[cache_key] = self._strategy[id(node)]
        pre = {p.dest: env[p.dest] for p in parts}
        self._apply(parts, kinds, results, env)
        self._shard_lost_site(node, rlabel, env, list(zip(dests, kinds)),
                              pre, partial(replay, _fn=fn), rec)

    def _set_transport(self, node, text):
        if text is None:
            self._transport.pop(id(node), None)
        else:
            self._transport[id(node)] = text

    def _round_body(self, *vals, parts, kinds, names, stores, bags, gather,
                    local, lims, alims, dims, shapes, dtypes, axis, rng,
                    dest_oned, exch, salts):
        """One round on this rank: the reference's shard_map body."""
        cp = self.cp
        dev = self.mesh.device
        shard = self.shard
        e2 = dict(zip(names + stores, vals))
        e2.update(dims)
        for n in gather:           # analysis: this read crosses ranks
            e2[n] = self.coll.all_gather(e2[n])
        # globalize indexes: rank-local row r is offset + r
        offs = {b: ShardOffset(shard * e2[b][0].shape[0]) for b in bags}
        row_offs = {n: ShardOffset(shard * e2[n].shape[0]) for n in local}
        axis_ov = {}
        if rng is not None:
            blk, lim, total = rng
            axis_ov[axis] = (ShardOffset(shard * blk), blk, lim, total)
        outs = []
        for p, k, shp, dt in zip(parts, kinds, shapes, dtypes):
            ro = dict(row_offs)
            # alignment certificates: localized reads tile exactly like the
            # round axis (checked in _round_spec), and store/aligned
            # destinations by construction
            cert = set(local)
            if k == "store":
                ro[p.dest] = ShardOffset(shard * e2[p.dest].shape[0])
                cert.add(p.dest)
            elif k == "aligned":
                blk0 = shp[0] // self.dp_n
                e2[p.dest] = _full((blk0,) + tuple(shp[1:]), p.op, dt, dev)
                ro[p.dest] = ShardOffset(shard * blk0)
                cert.add(p.dest)
            else:
                e2[p.dest] = _full(shp, p.op, dt, dev)
            ctx = ExecContext(bag_offsets=offs, bag_limits=lims,
                              row_offsets=ro, array_limits=alims,
                              axis_overrides=axis_ov,
                              aligned=frozenset(cert), salts=salts)
            res = cp.executor.run_node(p, e2, ctx)
            if k == "reduce":
                res = self._combine_shard(res, p.op, dest_oned[p.dest],
                                          exch.get(p.dest, "psum_scatter"))
            outs.append(res)
        return tuple(outs)

    def _round_desc(self, parts, kinds, axis, exchanges, dest_oned,
                    gathered, local) -> str:
        """The round strategy explain_rounds() prints — the reference's
        text, shared between single-node rounds and fused members."""
        desc = []
        for p, k in zip(parts, kinds):
            if k == "reduce":
                x = exchanges[p.dest]
                coll = f"{x.backend}[{x.source}]" if dest_oned[p.dest] \
                    else "psum"
                desc.append(f"reduce({coll})→{p.dest}")
            else:
                desc.append(f"{k}→{p.dest}")   # store/aligned: no collective
        extras = []
        if gathered:
            extras.append("all_gather: " + ",".join(gathered))
        if local:
            extras.append("local blocks: " + ",".join(sorted(local)))
        for p, k in zip(parts, kinds):
            if k == "aligned":   # per-rank contraction: the certificates
                cert = shard_slice_certificates(p, axis, frozenset(local))
                extras.append(
                    f"slice-certs[{p.dest}]: " + (", ".join(
                        f"{a}={c}" for a, c in sorted(cert.items()))
                        if cert else "none (dense grid)"))
        return (f"{' + '.join(desc)} over {axis}"
                + ("; " + "; ".join(extras) if extras else ""))

    # ------------------- fused regions (pass 11, DESIGN.md §9) -----------
    def _exec_fused(self, region, env, limits, array_limits,
                    loop=None) -> bool:
        """Run a FusedRound region as ONE dispatch sequence: its members in
        order with their collectives between them, one cached closure for
        the region.  With `loop`, the sequence runs under the loop's host-
        driven iteration (one flag read an iteration; the condition reads
        only replicated values).  Returns False when a runtime guard fails
        (a member not round-classifiable, a §5 packed value, a condition
        reading a row block); the caller then falls back to per-member
        rounds / the host-driven loop.  Fusion never changes results."""
        from .passes import _expr_names, _scalar_member
        from .tiles import TiledMatrix
        cp = self.cp
        bail_key = id(region) if loop is None else id(loop)
        if bail_key in self._fused_bail:
            return False

        def bail() -> bool:
            self._fused_bail.add(bail_key)
            return False

        # ---- classify members against runtime shapes ----
        units = []
        for m in region.parts:
            if isinstance(m, plan.Rebalance):
                units.append(("rebalance", m, None))
                continue
            spec = self._round_spec(m, env) \
                if (plan.is_reduce(m) or isinstance(m, _STORE_NODES)) \
                else None
            if spec is not None:
                units.append(("round", m, spec))
                continue
            if not _scalar_member(m) or m.space.has_bag or any(
                    self._gshape(d, env) != () for d in plan.dests_of(m)):
                return bail()
            units.append(("scalar", m, None))

        # ---- name universe, entry representations ----
        params = cp.program.params
        all_names: set = set()
        bagnames_all: set = set()
        for _k, m, _s in units:
            all_names |= set(m.reads) | set(plan.dests_of(m))
            bagnames_all |= set(m.space.bag_names)
        creads: set = set()
        if loop is not None:
            _expr_names(loop.cond, creads)
            all_names |= {n for n in creads
                          if n in params or n in cp.program.outputs}
        dims = {n: env[n] for n in all_names
                if n in params and params[n].kind == "dim"}
        names = sorted(n for n in all_names if n not in dims)
        if any(isinstance(env[n], TiledMatrix) for n in names):
            return bail()                 # §5 reps cannot cross ranks
        reps = {}
        for n in names:
            if n in bagnames_all:
                reps[n] = "bag"
            elif self._placed_oned(n):
                reps[n] = "block"
            else:
                reps[n] = "global"
        entry_reps = dict(reps)
        if loop is not None:
            # the condition evaluates on every rank: every read replicated
            for n in creads:
                if n in dims:
                    continue
                if reps.get(n, "global") == "block":
                    return bail()

        # ---- static instruction plan (rep transitions, collectives) ----
        instrs = []
        exchanges_all = {}
        colls = []
        for kind, m, spec in units:
            if kind == "rebalance":
                lim = array_limits.get(m.dest)
                active = reps.get(m.dest) == "block" and lim is not None
                instrs.append(("rebalance", m, active, lim))
                if active:
                    colls += ["all_reduce", "reduce_scatter_tensor"]
                continue
            if kind == "scalar":
                reads = sorted(n for n in m.reads if n not in dims)
                g = tuple(n for n in reads if reps.get(n) == "block")
                instrs.append(("scalar", m, g))
                if g:
                    colls.append("all_gather_into_tensor")
                for d in plan.dests_of(m):
                    reps[d] = "global"
                continue
            parts, kinds = spec["parts"], spec["kinds"]
            axis, rng = spec["axis"], spec["rng"]
            member_dests = {p.dest for p in parts}
            reads = sorted(set(m.reads) - member_dests - set(dims))
            bagnames = tuple(m.space.bag_names)
            local_eff = tuple(sorted(
                n for n in spec["local"] if reps.get(n) == "block"))
            gathered = tuple(sorted(
                n for n in reads
                if n not in bagnames and n not in local_eff
                and reps.get(n) == "block"))
            if gathered:
                colls.append("all_gather_into_tensor")
            convs = []
            doned = []
            dest_oned = {}
            for p, k in zip(parts, kinds):
                if k == "reduce":
                    oned = self._placed_oned(p.dest)
                    need = "block" if oned else "global"
                else:                     # store/aligned: dest is ONED
                    oned = True
                    need = "block"
                doned.append(oned)
                dest_oned[p.dest] = oned
                if reps.get(p.dest, "global") != need:
                    convs.append((p.dest, need))
                    if need == "global":
                        colls.append("all_gather_into_tensor")
                reps[p.dest] = need
            exch = self._exchanges(parts, kinds, spec, env, dest_oned)
            for p, k in zip(parts, kinds):
                if k == "reduce":
                    colls += _exchange_ops(p.op, dest_oned[p.dest],
                                           exch[p.dest].backend)
            exchanges_all.update(exch)
            instrs.append(("round", m, parts, tuple(kinds), axis, rng,
                           gathered, local_eff, tuple(convs),
                           {d: x.backend for d, x in exch.items()},
                           tuple(doned), bagnames, self._salts_of(parts)))
        endconvs = []
        if loop is not None:
            # the loop carries keep a stable representation: convert back
            # to the entry rep at body end (normally a no-op)
            for c in loop.carry:
                if reps.get(c) != entry_reps.get(c):
                    endconvs.append((c, entry_reps[c]))
                    if entry_reps[c] == "global":
                        colls.append("all_gather_into_tensor")
                    reps[c] = entry_reps[c]
        dests_order = []
        for _k, m, _s in units:
            for d in plan.dests_of(m):
                if d not in dests_order:
                    dests_order.append(d)

        # ---- operands, cache key ----
        node_lims = {b: limits[b] for b in sorted(bagnames_all)
                     if b in limits}
        arr_lims = {n: array_limits[n] for n in names if n in array_limits}
        args = []
        sig = []
        for n in names:
            v = env[n]
            if entry_reps[n] == "bag":
                sig.append((n, "bag", tuple(
                    (tuple(c.shape), str(c.dtype)) for c in v)))
            else:
                sig.append((n, entry_reps[n], tuple(_shape(v)),
                            str(getattr(v, "dtype", type(v).__name__))))
            args.append(v)

        def _ikey(i):
            if i[0] == "scalar":
                return (i[0], id(i[1]), i[2])
            if i[0] == "rebalance":
                return (i[0], id(i[1]), i[2], i[3])
            return (i[0], id(i[1]), i[3], i[4], i[5], i[6], i[7], i[8],
                    tuple(sorted(i[9].items())), i[10], i[11],
                    tuple(sorted(i[12].items())))

        cache_key = ("fused", bail_key, tuple(sig),
                     tuple(_ikey(i) for i in instrs),
                     tuple(endconvs), tuple(sorted(node_lims.items())),
                     tuple(sorted(arr_lims.items())),
                     tuple(sorted(dims.items())),
                     tuple(sorted(self._demoted)))
        unit = "fused loop" if loop is not None else "fused region"
        transport = self._transport_text(colls) if colls else None
        fn = self._round_cache.get(cache_key)
        if fn is not None:
            self._round_hits += 1
            try:
                results = self._call_round(fn, args, "dist.fused_compile",
                                           "fused", bail_key)
            except RankDivergence:
                raise
            except Exception as ex:      # noqa: BLE001 — ladder descent
                # the per-member fallback is the next ladder level for a
                # fused region (fusion never changes results), for every
                # rank or none
                self._settle(ex, "fused")
                self.faults.descend("fused", "per-member rounds", ex)
                return bail()
            self._strategy.update(self._strategy_by_key[cache_key])
            self._decisions.update(self._round_notes[cache_key])
            self._set_transport(region, transport)
            pre = {d: env[d] for d in dests_order}
            for d, res in zip(dests_order, results):
                env[d] = res
            self._shard_lost_site(
                region, "fused", env,
                [(d, "fused") for d in dests_order], pre,
                lambda _fn=fn, _a=tuple(args):
                    dict(zip(dests_order, _fn(*_a))), unit=unit)
            return True

        # build time: record the region + per-member strategies
        strat = {}
        n_members = len(units)
        head = f"fused round: {n_members} member" + \
            ("s" if n_members != 1 else "") + ", 1 dispatch sequence"
        if loop is not None:
            head += "; host-driven loop (one flag read per iteration)"
            strat[id(loop)] = ("host-driven loop over ONE fused round "
                               "(one flag read per iteration)")
        strat[id(region)] = head
        for instr in instrs:
            if instr[0] == "scalar":
                strat[id(instr[1])] = "replicated scalar (inside fused round)"
                continue
            if instr[0] == "rebalance":
                _t, m, active, lim = instr
                if active:
                    cts, fac = self._shard_counts(self._rows(m.dest, env),
                                                  lim)
                    strat[id(m)] = (
                        f"rebalance(size-exchange psum + all-to-all "
                        f"psum_scatter)→{m.dest} (inside fused round); "
                        f"rows/shard={cts} balance={fac:.2f}")
                else:
                    strat[id(m)] = ("rebalance: elided ("
                                    + ("already balanced"
                                       if reps.get(m.dest) == "block"
                                       else "replicated dest") + ")")
                continue
            (_t, m, parts, kinds, axis, _rng, gathered, local_eff,
             _convs, _exch_b, doned, _bags, _salts) = instr
            strat[id(m)] = self._round_desc(
                parts, kinds, axis, exchanges_all,
                {p.dest: o for p, o in zip(parts, doned)},
                gathered, local_eff)
        self._strategy.update(strat)
        self._set_transport(region, transport)

        fn = partial(self._fused_body, names=tuple(names), dims=dims,
                     instrs=tuple(instrs), endconvs=tuple(endconvs),
                     dests_order=tuple(dests_order), node_lims=node_lims,
                     arr_lims=arr_lims,
                     dshapes={d: self._gshape(d, env) for d in dests_order},
                     ddtypes={d: getattr(env[d], "dtype", torch.float32)
                              for d in dests_order},
                     loop=loop)
        try:
            results = self._call_round(fn, args, "dist.fused_compile",
                                       "fused", bail_key)
        except RankDivergence:
            raise
        except Exception as ex:           # noqa: BLE001 — ladder descent
            # a member the fused sequence cannot run, or a classified
            # non-transient fault — fall back to per-member rounds,
            # results unchanged; every rank falls back, or none does
            self._settle(ex, "fused")
            self.faults.descend("fused", "per-member rounds", ex)
            for k in strat:
                self._strategy.pop(k, None)
            self._transport.pop(id(region), None)
            return bail()
        self._round_cache[cache_key] = fn
        self._round_traces += 1
        notes = {}
        for _k, m, _s in units:
            notes.update(self._part_notes(m))
        self._round_notes[cache_key] = notes
        self._decisions.update(notes)
        self._strategy_by_key[cache_key] = strat
        pre = {d: env[d] for d in dests_order}
        for d, res in zip(dests_order, results):
            env[d] = res
        self._shard_lost_site(
            region, "fused", env, [(d, "fused") for d in dests_order], pre,
            lambda _fn=fn, _a=tuple(args): dict(zip(dests_order, _fn(*_a))),
            unit=unit)
        return True

    def _fused_body(self, *vals, names, dims, instrs, endconvs, dests_order,
                    node_lims, arr_lims, dshapes, ddtypes, loop):
        """A fused region on this rank: the members in order, the
        collectives between them; under `loop`, as the body of its host-
        driven loop."""
        cp = self.cp
        dev = self.mesh.device
        shard = self.shard
        e2 = dict(zip(names, vals))
        e2.update(dims)

        def convert(e, nme, need):
            e[nme] = self._block(e[nme]) if need == "block" \
                else self.coll.all_gather(e[nme])

        def run_body(e2):
            for instr in instrs:
                if instr[0] == "rebalance":
                    _t, m, active, lim = instr
                    if active:
                        e2[m.dest] = self._rebalance_local(e2[m.dest], lim)
                    continue
                if instr[0] == "scalar":
                    _t, m, g = instr
                    eu = dict(e2)
                    for n in g:
                        eu[n] = self.coll.all_gather(eu[n])
                    ctx = ExecContext(bag_limits=node_lims,
                                      array_limits=arr_lims)
                    e2[m.dest] = cp.executor.run_node(m, eu, ctx)
                    continue
                (_t, m, parts, kinds, axis, rng, gathered, local_eff,
                 convs, exch, doned, bagnames, salts) = instr
                for d, need in convs:
                    convert(e2, d, need)
                eu = dict(e2)
                for n in gathered:
                    eu[n] = self.coll.all_gather(eu[n])
                offs = {b: ShardOffset(shard * eu[b][0].shape[0])
                        for b in bagnames}
                row_offs = {n: ShardOffset(shard * eu[n].shape[0])
                            for n in local_eff}
                axis_ov = {}
                if rng is not None:
                    blk, lim, total = rng
                    axis_ov[axis] = (ShardOffset(shard * blk), blk, lim,
                                     total)
                for p, k, oned in zip(parts, kinds, doned):
                    shp, dt = dshapes[p.dest], ddtypes[p.dest]
                    ro = dict(row_offs)
                    cert = set(local_eff)
                    prev = e2[p.dest]
                    if k == "store":
                        eu[p.dest] = prev
                        ro[p.dest] = ShardOffset(shard * prev.shape[0])
                        cert.add(p.dest)
                    elif k == "aligned":
                        blk0 = shp[0] // self.dp_n
                        eu[p.dest] = _full((blk0,) + tuple(shp[1:]), p.op,
                                           dt, dev)
                        ro[p.dest] = ShardOffset(shard * blk0)
                        cert.add(p.dest)
                    else:
                        eu[p.dest] = _full(shp, p.op, dt, dev)
                    ctx = ExecContext(bag_offsets=offs, bag_limits=node_lims,
                                      row_offsets=ro, array_limits=arr_lims,
                                      axis_overrides=axis_ov,
                                      aligned=frozenset(cert), salts=salts)
                    res = cp.executor.run_node(p, eu, ctx)
                    if k == "store":
                        e2[p.dest] = res
                    elif k == "aligned":
                        e2[p.dest] = COMBINE[p.op](prev, res)
                    else:             # unaligned reduce
                        exchd = self._combine_shard(
                            res, p.op, oned, exch.get(p.dest, "psum_scatter"))
                        e2[p.dest] = COMBINE[p.op](prev, exchd)
            return e2

        if loop is None:
            e2 = run_body(e2)
            return tuple(e2[d] for d in dests_order)
        # the loop: each iteration sees the entry values plus the carry,
        # and only the carry leaves it (the reference's while_loop)
        carry = {n: e2[n] for n in loop.carry}
        while True:
            ec = dict(e2)
            ec.update(carry)
            self.flag_reads += 1
            if not bool(cp.executor.loop_cond(loop, ec)):
                break
            eb = run_body(ec)
            for nme, need in endconvs:
                convert(eb, nme, need)
            carry = {n: eb[n] for n in loop.carry}
        e2.update(carry)
        return tuple(e2[d] for d in dests_order)

    def _part_notes(self, node) -> dict:
        """Snapshot the executor's materialization decisions for the
        node's leaves, as they stand right after this node executed."""
        notes = {}
        parts = node.parts if isinstance(node, plan.Fused) else [node]
        for p in parts:
            d = self.cp.executor.decisions.get(id(p))
            if d is None and isinstance(p, plan.TiledMatmul):
                # dense lhs resolved to the einsum underneath
                d = self.cp.executor.decisions.get(id(p.contract))
            if d is not None:
                notes[id(p)] = d
        return notes

    @staticmethod
    def _apply(parts, kinds, results, env):
        """Fold a round's outputs back into the env: stores replace their
        destination, reductions ⊕-combine with it."""
        for p, k, res in zip(parts, kinds, results):
            if k == "store":
                env[p.dest] = res
            else:
                env[p.dest] = COMBINE[p.op](env[p.dest], res)

    # ------------- surgical shard recovery (DESIGN.md §13) -------------
    def _shard_lost_site(self, node, rlabel, env, writes, pre, replay,
                         rec=None, unit="round"):
        """Fire the post-round shard-loss site (a worker dying while
        holding the partition it just produced) and recover surgically.
        `writes` is [(dest, kind)] for everything the round applied, `pre`
        maps each dest to its pre-apply value (the surviving copy recovery
        re-fetches), `replay` re-runs the round's cached closure and
        returns {dest: this rank's result}, and `rec` (leaf rounds only)
        carries what a block-restricted recompute needs."""
        if F.active() is None:
            return                    # zero-cost outside the fault harness
        try:
            F.site("dist.shard_lost", label=rlabel)
        except F.ShardLostFault as ex:
            self._recover_shard(node, rlabel, env, ex, writes, pre,
                                replay, rec, unit)

    def _recover_shard(self, node, rlabel, env, ex, writes, pre, replay,
                       rec, unit):
        """Lineage-based recovery of ONE lost shard partition (DESIGN.md
        §13).  Every rank runs it; the block belongs to rank k, which
        poisons it first and recovers it, and the others take part in the
        collectives.  Replicated destinations cost nothing (every survivor
        holds a full copy); aligned stores / aligned reduces recompute ONLY
        block k from surviving inputs (1/P of the round); sharded unaligned
        reduces and fused regions replay the cached round and re-slice.
        Every recovered block is verified against the checksum taken
        before the loss (the peer's stamp), and the ranks agree on the
        verdict.  No ladder descent — unless the same shard was already
        lost within the policy TTL (a flapping worker) or verification
        fails: then the original fault re-raises and run()'s ladder takes
        over."""
        lin = getattr(node, "lineage", None)
        k = ex.shard % self.dp_n
        mine = k == self.shard
        now = self.faults.clock()
        last = self._shard_loss.get(k)
        self._shard_loss[k] = now
        if not self.lineage_enabled or lin is None:
            ex.escalated = True       # pre-§13 behaviour: ladder descent
            raise ex
        if self._agree(last is not None
                       and (now - last) < self.policy.shard_loss_ttl_s):
            self.faults.record(
                "escalate", rlabel,
                f"shard {k} lost twice within "
                f"{self.policy.shard_loss_ttl_s:.0f}s TTL — flapping "
                f"worker, recomputing onto it again is throwaway; ladder "
                f"takes over")
            ex.escalated = True       # run(): skip same-level re-dispatch
            raise ex
        lost, free = [], []
        for dest, kind in writes:
            if not self._placed_oned(dest):
                free.append(dest)     # survivors hold the full copy
                continue
            v = env[dest]
            blk = int(v.shape[0])
            crc = None
            if mine:
                crc = F.checksum(_host(v))       # the peer-held stamp
                # the partition died with its worker: poison it so a
                # recovery bug that reads the dead block cannot verify
                env[dest] = _kill_block(v)
            lost.append((dest, kind, k * blk, blk, crc))
        if not lost:
            self.faults.recovered(
                rlabel,
                f"shard {k}/{self.dp_n}: nothing to recompute — every "
                f"written array is replicated, survivors hold full copies "
                f"(lineage depth={lin.depth})")
            return
        names = ", ".join(f"{d}[{s}:{s + b}]" for d, _k2, s, b, _c in lost)

        def verified(blocks) -> bool:
            # rank k's verdict, which every rank adopts
            ok = (blocks is not None and all(
                F.checksum(_host(blocks[d])) == c
                for d, _k2, _s, _b, c in lost)) if mine else True
            return not self._agree(not ok)

        blocks = None
        mode = ""
        if rec is not None and all(k2 in ("store", "aligned")
                                   for _d, k2, _s, _b, _c in lost):
            # gathered reads: the full array the survivors hold
            rec = dict(rec, gathered_vals={
                n: self.coll.all_gather(env[n]) for n in rec["gathered"]})
            if mine:
                try:
                    blocks = self._recompute_blocks(k, pre, env, rec)
                except Exception:     # noqa: BLE001 — fall back to replay
                    blocks = None
            if verified(blocks):
                mode = (f"block-restricted recompute "
                        f"(1/{self.dp_n} of the round)")
            else:
                blocks = None         # bit mismatch: replay instead
        if not mode:
            full = replay()
            blocks = {d: full[d] for d, _k2, _s, _b, _c in lost} \
                if mine else None
            if not verified(blocks):
                self.faults.record(
                    "escalate", rlabel,
                    f"shard {k}: recovered blocks failed peer-checksum "
                    f"verification — ladder takes over")
                ex.escalated = True   # run(): skip same-level re-dispatch
                raise ex
            mode = f"replay {unit} + re-slice"
        if mine:
            for d, _k2, _s, _b, _c in lost:
                env[d] = blocks[d].to(env[d].dtype)
        reads = ", ".join(f"{a}:{k2}" for a, k2 in lin.reads) or "none"
        self.faults.recovered(
            rlabel,
            f"shard {k}/{self.dp_n}: {names} via {mode}; lineage "
            f"depth={lin.depth} (a from-scratch restart would replay "
            f"{lin.depth} round(s)); reads[{reads}]; checksum ok"
            + (f"; free(rep): {','.join(free)}" if free else ""))

    def _recompute_blocks(self, k, pre, env, rec):
        """The round's body for the ONE rank k, with no collective: its
        bag and localized blocks and store operands are its own surviving
        inputs, replicated arrays are whole, gathered reads use the full
        array the survivors hold (`rec["gathered_vals"]`); the exact
        ExecContext the dead worker ran under is rebuilt and the member
        nodes run.  Returns {dest: block} for the round's row-block
        destinations: 1/P of each, never a full-size intermediate."""
        cp = self.cp
        dev = self.mesh.device
        spec = rec["spec"]
        parts, kinds = spec["parts"], spec["kinds"]
        axis, rng, local = spec["axis"], spec["rng"], spec["local"]
        bagnames = rec["bagnames"]
        e2 = dict(rec["dims"])
        offs, row_offs = {}, {}
        for n in rec["names"]:
            v = env[n]
            if n in bagnames:
                e2[n] = v
                offs[n] = ShardOffset(k * int(v[0].shape[0]))
            elif n in local:
                e2[n] = v
                row_offs[n] = ShardOffset(k * int(v.shape[0]))
            elif n in rec["gathered"]:
                e2[n] = rec["gathered_vals"][n]
            else:
                e2[n] = v             # replicated: full copy
        for d in rec["store_dests"]:  # store operands enter as blocks
            e2[d] = pre[d]
        axis_ov = {}
        if rng is not None:
            blk, lim, total = rng
            axis_ov[axis] = (ShardOffset(k * blk), blk, lim, total)
        out = {}
        for p, kind in zip(parts, kinds):
            if not self._placed_oned(p.dest):
                continue
            blk0 = int(pre[p.dest].shape[0])
            dt = pre[p.dest].dtype
            ro = dict(row_offs)
            cert = set(local)
            e3 = dict(e2)
            ro[p.dest] = ShardOffset(k * blk0)
            cert.add(p.dest)
            ctx = ExecContext(bag_offsets=offs, bag_limits=rec["node_lims"],
                              row_offsets=ro, array_limits=rec["arr_lims"],
                              axis_overrides=axis_ov,
                              aligned=frozenset(cert), salts=rec["salts"])
            if kind == "store":
                out[p.dest] = cp.executor.run_node(p, e3, ctx)
            elif kind == "aligned":
                e3[p.dest] = _full((blk0,) + tuple(pre[p.dest].shape[1:]),
                                   p.op, dt, dev)
                res = cp.executor.run_node(p, e3, ctx)
                out[p.dest] = COMBINE[p.op](pre[p.dest], res)
            else:                     # unaligned reduce: replay instead
                return None
        return out

    # ------------------------- explain -------------------------
    def explain_rounds(self) -> str:
        """Spark-EXPLAIN-style dump of the round strategy chosen for every
        plan node in the LAST run() — aligned store / aligned reduce /
        unaligned reduce (with its exchange) / replicated — with the
        per-rank materialization the executor chose for it and, where the
        round ran collectives, their transport.  Classification depends on
        runtime row counts, so call after run()."""
        out = [f"== distributed rounds: {self.cp.program.name} "
               f"({self.dp_n} shards over {self.dp}, mode={self.mode}) =="]
        out.append(f"round cache: {self._round_traces} traced, "
                   f"{self._round_hits} hits")
        if self._demoted:
            out.append("placement: " + ", ".join(
                f"{n}→REP (dest-{d.backend}[{d.source}])"
                for n, d in sorted(self._demoted.items())))
        for n, (cts, fac, kind) in sorted(self._balance.items()):
            out.append(f"balance[{n}]: rows/shard={cts} "
                       f"factor={fac:.2f} ({kind})")
        self._round_lines(self.cp.plan, 0, out)
        return "\n".join(out)

    def explain_faults(self) -> str:
        """The shared per-program failure ledger (one ladder per program,
        whichever layer — distributed or single-device — descended it)."""
        return self.cp.explain_faults()

    def _round_lines(self, nodes, indent, out):
        pre = "  " * indent
        for node in nodes:
            if isinstance(node, plan.SeqLoop):
                out.append(f"{pre}{node.describe()}")
                strat = self._strategy.get(id(node))
                if strat is not None:
                    out.append(f"{pre}    loop: {strat}")
                self._transport_line(node, pre, out)
                self._round_lines(node.body, indent + 1, out)
                continue
            if isinstance(node, plan.FusedRound):
                out.append(f"{pre}{node.describe()}")
                strat = self._strategy.get(id(node))
                if strat is not None:
                    out.append(f"{pre}    round: {strat}")
                self._transport_line(node, pre, out)
                self._round_lines(node.parts, indent + 1, out)
                continue
            out.append(f"{pre}{node.describe()}")
            strat = self._strategy.get(id(node))
            if strat is not None:
                out.append(f"{pre}    round: {strat}")
            self._transport_line(node, pre, out)
            parts = node.parts if isinstance(node, plan.Fused) else [node]
            for p in parts:
                d = self._decisions.get(id(p))
                if d is not None:
                    out.append(f"{pre}    per-shard[{p.dest}]: {d}")

    def _transport_line(self, node, pre, out):
        t = self._transport.get(id(node))
        if t is not None and id(node) in self._strategy:
            out.append(f"{pre}    transport: {t}")

    # ------------------------- entry -------------------------
    def run(self, inputs: dict) -> dict:
        """Distributed ladder (DESIGN.md §11/§12): fused → per-member
        rounds (inside _run_once, via _fused_bail) → REP-everything
        placements → the wrapped single-device program, whose own ladder
        goes on below.  Transients retry at each level first; a
        deterministic error gets exactly ONE descent (REP-everything) and
        surfaces if it reproduces there.  A capacity error never ascends
        the memory curve: it descends straight to the chunked out-of-core
        tier (or to single-device when out_of_core="off")."""
        try:
            return F.run_with_retries(
                lambda: self._once(inputs),
                policy=self.policy, ledger=self.faults, label="dist")
        except RankDivergence:
            raise
        except Exception as ex:          # noqa: BLE001 — ladder descent
            if F.classify(ex) == "capacity":
                return self._descend_capacity("rounds", inputs, ex)
            if F.classify(ex) == "shard_lost" \
                    and not getattr(ex, "escalated", False):
                # MID-round loss (the worker died before its outputs
                # applied — nothing to recompute): the program's inputs
                # survive on the host, so ONE same-level re-dispatch
                # re-places them before any ladder descent
                try:
                    out = self._once(inputs)
                    self.faults.recovered(
                        "dist",
                        "mid-round shard loss: same-level re-dispatch "
                        "onto the surviving pool (inputs survive on the "
                        "host; no round output was lost)")
                    return out
                except RankDivergence:
                    raise
                except Exception as ex2:  # noqa: BLE001 — ladder descent
                    ex = ex2
                    if F.classify(ex) == "capacity":
                        return self._descend_capacity("rounds", inputs, ex)
            self.faults.descend("rounds", "rep", ex)
            if F.classify(ex) == "deterministic":
                out = self._once(inputs, force_rep=True)
                self.faults.recover("rep")
                return out
            try:
                out = F.run_with_retries(
                    lambda: self._once(inputs, force_rep=True),
                    policy=self.policy, ledger=self.faults, label="rep")
                self.faults.recover("rep")
                return out
            except RankDivergence:
                raise
            except Exception as ex2:     # noqa: BLE001 — ladder descent
                if F.classify(ex2) == "deterministic":
                    raise
                if F.classify(ex2) == "capacity":
                    return self._descend_capacity("rep", inputs, ex2)
                self.faults.descend("rep", "single-device", ex2)
                out = self.cp.run(inputs)
                self.faults.recover("single-device")
                return out

    def _once(self, inputs: dict, force_rep: bool = False) -> dict:
        """One run at a level; a failure is settled among the ranks before
        any rank retries or descends."""
        try:
            return self._run_once(inputs, force_rep)
        except RankDivergence:
            raise
        except Exception as ex:          # noqa: BLE001 — settled, re-raised
            self._settle(ex, "rep" if force_rep else "rounds")
            raise

    def _settle(self, ex, level: str) -> None:
        """A failure of a run at `level`, settled among the ranks: each
        rank posts its outcome (the failure's class) and waits for the
        others'.  Ranks that failed alike go on together — the caller's
        retry or descent depends only on that outcome, the same on every
        rank.  Otherwise a rank failed alone (the others are blocked in a
        collective it will not join, or still working) or the ranks
        failed differently: the rank tears the group down, so the blocked
        ranks fail and settle in turn, and raises RankDivergence."""
        if self.dp_n == 1:
            return
        kind = F.classify(ex) + ("/escalated" if getattr(ex, "escalated",
                                                          False) else "")
        kinds = self.coll.vote(kind, self.vote_timeout_s)
        if kinds is not None:
            ex.unpaired = False      # every rank retries the whole run
            return
        self.faults.record("diverged", level,
                           f"rank {self.shard} failed ({kind}: "
                           f"{type(ex).__name__}) and the other ranks did "
                           f"not fail alike within {self.vote_timeout_s:g} "
                           f"s; group torn down")
        self.coll.abort()
        raise RankDivergence(
            f"rank {self.shard} of {self.dp_n}: {kind} failure at level "
            f"{level} that the other ranks did not share ({ex})") from ex

    def _descend_capacity(self, from_level: str, inputs: dict, ex) -> dict:
        """Capacity exit: down the memory curve (DESIGN.md §12)."""
        if self.cp.out_of_core != "off":
            self.faults.descend(from_level, "chunked", ex)
            return self.cp._run_chunked(inputs, recovering=True)
        self.faults.descend(from_level, "single-device", ex)
        out = self.cp.run(inputs)
        self.faults.recover("single-device")
        return out

    def _probe_salts(self, inputs: dict, limits: dict) -> dict:
        """id(node) → hot-key salt factor, probed on the GLOBAL inputs
        (every rank holds them), so every rank salts alike."""
        params = self.cp.program.params
        penv = {}
        for name, t in params.items():
            if t.kind == "bag":
                v = inputs[name]
                penv[name] = v if isinstance(v, tuple) else (v,)
            elif t.kind in ("vector", "matrix", "map"):
                shp = _shape(inputs[name])
                if shp and self._placed_oned(name):
                    shp = (shp[0] + (-shp[0]) % self.dp_n,) + tuple(shp[1:])
                penv[name] = torch.empty(shp, device="meta")
        out = {}
        skew = self.cp.config.skew_salting
        for n in _walk_plan(self.cp.plan):
            s = salt_for_node(n, penv, self.cp.selector, skew,
                              nshards=self.dp_n, bag_limits=limits)
            if s > 1:
                out[id(n)] = s
        return out

    def _run_once(self, inputs: dict, force_rep: bool = False) -> dict:
        self._fused_bail = set()     # placements/shapes are per-run
        self._spec_done = set()      # speculation budget is per run
        self.flag_reads = 0
        self._force_rep = force_rep
        try:
            env, limits, array_limits = self.place(inputs)
        finally:
            self._force_rep = False  # place() consumed it
        self._node_salts = self._probe_salts(inputs, limits)
        # balance observability: the per-rank live row counts every
        # ONED_VAR / rebalanced array holds THIS run
        self._balance = {}
        for name, d in self.dists.items():
            if name in self._rebalanced:
                kind = "rebalance inserted"
            elif d == Dist.ONED_VAR:
                kind = "rebalance elided"
            else:
                continue
            if not self._placed_oned(name) or name not in env:
                continue
            shp = self._gshape(name, env)
            if not shp:
                continue
            cts, fac = self._shard_counts(int(shp[0]),
                                          array_limits.get(name))
            self._balance[name] = (cts, fac, kind)
        self._exec_shardmap(self.cp.plan, env, limits, array_limits)
        out = {}
        for n in self.cp.program.outputs:
            v = self._global(n, env[n])
            lim = array_limits.get(n)
            out[n] = v if lim is None else v[:lim]   # drop pad rows
        return out


def _exchange_ops(op: str, dest_oned: bool, backend: str) -> tuple:
    """The collectives of one unaligned reduce's exchange."""
    if dest_oned and op == "+" and backend == "psum_scatter":
        return ("reduce_scatter_tensor",)
    return ("all_reduce",)


def _full(shape, op, dtype, device) -> torch.Tensor:
    """A destination filled with the ⊕ identity."""
    return torch.full(tuple(shape), identity(op, dtype).item(), dtype=dtype,
                      device=device)


def _kill_block(v: torch.Tensor) -> torch.Tensor:
    """The block died with its worker: poisoned with NaN / an integer
    sentinel rather than left stale, so any recovery path that reads the
    dead block fails the checksum verification instead of passing."""
    if v.dtype.is_floating_point:
        fill = float("nan")
    elif v.dtype != torch.bool:
        fill = torch.iinfo(v.dtype).min
    else:
        fill = False
    return torch.full_like(v, fill)


def _shape(v) -> tuple:
    return tuple(v.shape) if hasattr(v, "shape") else np.shape(v)


def _names_of(nodes) -> set:
    """Every name the nodes read or write, loop conditions included."""
    from .passes import _expr_names
    out: set = set()
    for n in nodes:
        if isinstance(n, plan.SeqLoop):
            _expr_names(n.cond, out)
            out |= set(n.carry)
            out |= _names_of(n.body)
        elif isinstance(n, (plan.FusedRound, plan.Fused)):
            out |= set(n.reads)
            out |= _names_of(n.parts)
        else:
            out |= set(getattr(n, "reads", ()))
            out |= set(plan.dests_of(n))
    return out


def _gather_names(node) -> frozenset:
    from .dist_analysis import gathers_of
    return frozenset(gathers_of(node))


def _walk_plan(nodes):
    """Every leaf plan node, containers opened (SeqLoop bodies, FusedRound
    regions, Fused parts)."""
    for n in nodes:
        if isinstance(n, plan.SeqLoop):
            yield from _walk_plan(n.body)
        elif isinstance(n, plan.FusedRound):
            yield from _walk_plan(n.parts)
        elif isinstance(n, plan.Fused):
            yield from n.parts
        else:
            yield n


def compile_distributed(fn_or_prog, mesh, dp_axes=("data",),
                        mode: str = "shardmap", shard_dense: bool = True,
                        **kw) -> DistributedProgram:
    """The distributed form of a program over `mesh` (launch/mesh.py):
    `compile_program(fn, **kw)` on the mesh's device, or an already
    compiled program on it."""
    from .lower import compile_program
    if isinstance(fn_or_prog, CompiledProgram):
        cp = fn_or_prog
    else:
        kw.setdefault("device", mesh.device)
        cp = compile_program(fn_or_prog, **kw)
    return DistributedProgram(cp, mesh, dp_axes, mode, shard_dense)
