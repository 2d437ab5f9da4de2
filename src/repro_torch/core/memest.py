"""Peak-device-bytes estimation over a physical plan (DESIGN.md §12).

A static pass: given the plan and the *shapes* of a call's inputs (never
the values), predict how many device bytes the all-resident executor
needs at its worst moment.  The estimate drives three consumers:

  * admission — `CompiledProgram` compares it against `memory_budget`
    before dispatch and routes oversized calls to the chunked
    out-of-core tier (core/chunked.py) instead of letting XLA OOM;
  * chunk sizing — `chunked.choose_chunk_rows` solves
    ``fixed + rows·per_row ≤ budget`` for the streaming tile;
  * serving — `serve/plans.py` caps concurrent lanes per flush at
    ``budget // peak`` so a batch never projects past the budget.

The model is deliberately simple and leans conservative (admission
errs toward chunking, which is always correct, never toward OOM):

  resident   every parameter array and bag column, at the dtype the
             executor would place it with (prepare_env canonicalizes
             floats to f32 / ints to i32);
  temps      grid nodes materialize index grids + gathered operand
             values + masks over the full iteration space — counted as
             ``cells × 4 bytes × (value + keys + reads + conds + mask)``;
             dense fast-path nodes (DenseMap, columnar ScalarReduce,
             einsum) skip the grids and cost operands + partial only;
  dest copy  a non-donated functional update holds old and new
             destination simultaneously; whole-program donation credits
             it back (the `donation credit` line);
  collective per-round partial-⊕ buffers + gathered remote operands
             when the plan runs on `nshards` > 1 devices.

peak = resident + max over nodes (temp + dest copy + collective).

The PyTorch port's copy of the reference's module (src/repro/core/
memest.py), changed in its imports, in reading a torch dtype by its name,
and in two constants, so that it prices the temporaries the PORT's
executor makes (core/lower.py) rather than jnp's, and errs toward
chunking on the card as it promises:

  INDEX_BYTES  a key or gathered index of the general grid path costs 20
               bytes a cell (the reference: 4).  The executor casts it to
               int32, widens it to int64 and clamps it (4 + 8 + 8 bytes:
               torch has no clip-mode gather and no drop-mode scatter,
               lower.py's `eval` and `scatter_drop`).  The reference's 4
               bytes a slot estimated 12 bytes a row for word_count and
               group_by, whose eager run() on an H100 peaked 21 bytes a
               row above its inputs (PERF.md §5, chip_smoke.py phase 3),
               and 0.81 GB for pagerank against a measured 2.05.
  DENSE_TEMPS  a DenseMap holds 2 + reads destination-sized temporaries
               (the reference: 1 + reads): eager torch materializes each
               operator's result where XLA fuses the expression
               (matrix_factorization_step: 0.268 GB estimated, 0.28
               measured).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import plan as P
from .loop_ast import Const, Var

__all__ = ["MemEstimate", "NodeCost", "shape_env", "shape_env_from_signature",
           "estimate", "fmt_bytes"]

# bytes a cell of a key or gathered index on the general grid path (module
# docstring); the reference charges 4
INDEX_BYTES = 20
# destination-sized temporaries of a DenseMap beyond one per read; the
# reference charges 1
DENSE_TEMPS = 2


def fmt_bytes(n: int) -> str:
    n = int(n)
    if abs(n) < 1024:
        return f"{n}B"
    for unit, div in (("KiB", 1024), ("MiB", 1024 ** 2), ("GiB", 1024 ** 3)):
        if abs(n) < div * 1024 or unit == "GiB":
            return f"{n / div:.1f}{unit}"
    return f"{n}B"


def _canon_dtype(dt) -> np.dtype:
    """Mirror prepare_env/jnp.asarray x64→x32 canonicalization."""
    if str(dt).startswith("torch."):     # a torch dtype, read by its name
        dt = str(dt)[len("torch."):]
    dt = np.dtype(dt)
    if dt == np.float64:
        return np.dtype(np.float32)
    if dt == np.int64:
        return np.dtype(np.int32)
    if dt == np.uint64:
        return np.dtype(np.uint32)
    return dt


# ---------------------------------------------------------------------------
# shape environments — name → ("dim", v) | ("bag", rows, cols) | ("array", shape, itemsize)
# ---------------------------------------------------------------------------

def shape_env(prog, inputs: dict) -> dict:
    """Shape-only view of a concrete inputs dict (host-side; never forces
    a device transfer — only `.shape`/`.dtype` are touched)."""
    env: dict = {}
    for name, t in prog.params.items():
        v = inputs[name]
        if t.kind == "dim":
            env[name] = ("dim", int(v))
        elif t.kind == "bag":
            cols = v if isinstance(v, tuple) else (v,)
            centries = tuple(
                (tuple(np.shape(c)), _canon_dtype(getattr(c, "dtype", np.float32)).itemsize)
                for c in cols)
            rows = centries[0][0][0] if centries and centries[0][0] else 0
            env[name] = ("bag", int(rows), centries)
        else:
            itemsize = 4        # executor places f32 / i32
            env[name] = ("array", tuple(np.shape(v)), itemsize)
    return env


def shape_env_from_signature(prog, sig) -> dict:
    """Same view built from a `CompiledProgram._signature` tuple — what the
    serving layer has for a shape bucket (DESIGN.md §10) without any
    concrete request payload."""
    env: dict = {}
    for entry in sig:
        name, kind = entry[0], entry[1]
        if kind == "dim":
            env[name] = ("dim", int(entry[2]))
        elif kind == "bag":
            centries = tuple((tuple(shape), _canon_dtype(dt).itemsize)
                             for shape, dt in entry[2])
            rows = centries[0][0][0] if centries and centries[0][0] else 0
            env[name] = ("bag", int(rows), centries)
        else:
            env[name] = ("array", tuple(entry[2]), 4)
    return env


def _bag_bytes(entry) -> int:
    _, rows, cols = entry
    return sum(int(np.prod(shape or (1,))) * item for shape, item in cols)


def _bag_row_bytes(entry) -> int:
    _, rows, cols = entry
    if rows <= 0:
        return sum(item for _, item in cols)
    return max(1, _bag_bytes(entry) // max(rows, 1))


def _array_bytes(entry) -> int:
    _, shape, item = entry
    return int(np.prod(shape or (1,))) * item


# ---------------------------------------------------------------------------
# static extent evaluation
# ---------------------------------------------------------------------------

def _static(e, dims: dict) -> int | None:
    if e is None:
        return None
    if isinstance(e, Const):
        return int(e.value)
    if isinstance(e, Var):
        v = dims.get(e.name)
        return int(v) if isinstance(v, (int, np.integer)) else None
    lhs = getattr(e, "lhs", None)
    rhs = getattr(e, "rhs", None)
    op = getattr(e, "op", None)
    if lhs is not None and rhs is not None and op is not None:
        a, b = _static(lhs, dims), _static(rhs, dims)
        if a is None or b is None:
            return None
        try:
            return int({"+": a + b, "-": a - b, "*": a * b,
                        "//": a // b if b else 0, "/": a // b if b else 0,
                        "%": a % b if b else 0}.get(op))
        except (TypeError, ZeroDivisionError):
            return None
    return None


def _axis_extent(a: P.AxisSpec, dims: dict, bags: dict) -> int:
    if a.kind == "bag":
        entry = bags.get(a.bag)
        return entry[1] if entry else 0
    lo = _static(a.lo, dims)
    hi = _static(a.hi, dims)
    if lo is None or hi is None:
        return 1
    return max(0, hi - lo)


def _space_cells(space: P.IterSpace, dims: dict, bags: dict) -> int:
    cells = 1
    for a in space.axes:
        cells *= max(1, _axis_extent(a, dims, bags))
    return cells


def _count_reads(node) -> int:
    """Gathered operand values materialized over the grid."""
    seen = 0

    def visit(e):
        nonlocal seen
        if isinstance(e, P.Gather):
            seen += 1

    exprs = []
    for attr in ("value", "bool_any"):
        v = getattr(node, attr, None)
        if v is not None:
            exprs.append(v)
    exprs.extend(getattr(node, "keys", ()) or ())
    space = getattr(node, "space", None)
    if space is not None:
        exprs.extend(space.conds)
    for e in exprs:
        P._walk_exprs(e, visit)
    return seen


# ---------------------------------------------------------------------------
# per-node temp model
# ---------------------------------------------------------------------------

@dataclass
class NodeCost:
    label: str
    temp: int = 0          # grid / operand temporaries while the node runs
    dest: int = 0          # destination bytes (the functional-update copy)
    collective: int = 0    # per-round exchange buffers when nshards > 1
    per_row: dict = field(default_factory=dict)   # bag → streaming bytes/row


def _dest_bytes(name: str, env: dict) -> int:
    entry = env.get(name)
    if entry is None:
        return 4                       # loop counters / fresh scalars
    if entry[0] == "array":
        return _array_bytes(entry)
    if entry[0] == "bag":
        return _bag_bytes(entry)
    return 4                           # dim


def _node_cost(node, env: dict, dims: dict, bags: dict, nshards: int) -> NodeCost:
    if isinstance(node, (P.Fused, P.FusedRound)):
        parts = [_node_cost(p, env, dims, bags, nshards) for p in node.parts]
        if isinstance(node, P.Fused):       # parts share one grid: temps coexist
            c = NodeCost(node.describe(),
                         temp=sum(p.temp for p in parts),
                         dest=sum(p.dest for p in parts),
                         collective=sum(p.collective for p in parts))
        else:                               # members run sequentially
            c = NodeCost(node.describe(),
                         temp=max((p.temp for p in parts), default=0),
                         dest=max((p.dest for p in parts), default=0),
                         collective=max((p.collective for p in parts), default=0))
        for p in parts:
            for bag, pr in p.per_row.items():
                c.per_row[bag] = max(c.per_row.get(bag, 0), pr)
        return c

    if isinstance(node, P.SeqLoop):
        body = [_node_cost(p, env, dims, bags, nshards) for p in node.body]
        c = NodeCost(node.describe(),
                     temp=max((p.temp for p in body), default=0),
                     dest=sum(_dest_bytes(d, env) for d in node.carry),
                     collective=max((p.collective for p in body), default=0))
        for p in body:
            for bag, pr in p.per_row.items():
                c.per_row[bag] = max(c.per_row.get(bag, 0), pr)
        return c

    if isinstance(node, P.Rebalance):
        d = _dest_bytes(node.dest, env)
        return NodeCost(node.describe(), temp=d, dest=d,
                        collective=d if nshards > 1 else 0)

    space = getattr(node, "space", None)
    dest = _dest_bytes(getattr(node, "dest", ""), env)
    label = node.describe()
    cells = _space_cells(space, dims, bags) if space is not None else 1
    n_reads = _count_reads(node)
    n_keys = len(getattr(node, "keys", ()) or
                 getattr(node, "key_axes", ()) or ())
    n_conds = len(space.conds) if space is not None else 0

    if isinstance(node, P.DenseMap):
        # vectorized whole-array expression: operands + result, no grids
        temp = DENSE_TEMPS * dest + n_reads * dest
    elif isinstance(node, (P.EinsumContract, P.TiledMatmul)):
        contract = node.contract if isinstance(node, P.TiledMatmul) else node
        ops = 0
        prod = contract.product
        if prod is not None:
            for g in prod.factors:
                ops += _dest_bytes(g.array, env)
        temp = ops + dest
    elif isinstance(node, P.ScalarReduce) and node.dense:
        # columnar fold over bag value columns: one value vector + masks
        rows = max((bags[b][1] for b in space.bag_names if b in bags),
                   default=cells) if space is not None else 1
        temp = rows * 4 * 2
    else:
        # general grid path: a value and one mask stack (4 bytes/cell
        # each, f32/u32), and an index grid per axis-keyed slot and per
        # read at INDEX_BYTES a cell (int32, int64, clamp)
        temp = cells * (4 * (1 + max(1, n_conds))
                        + INDEX_BYTES * (n_keys + n_reads))

    coll = 0
    if nshards > 1 and P.is_reduce(node):
        # partial-⊕ buffer on every shard + gathered remote operands
        coll = dest + sum(_dest_bytes(g, env)
                          for g in _gather_names(node))

    cost = NodeCost(label, temp=temp, dest=dest, collective=coll)
    if space is not None:
        for a in space.axes:
            if a.kind == "bag" and a.bag in bags:
                rows = max(1, bags[a.bag][1])
                cost.per_row[a.bag] = max(1, math.ceil(temp / rows))
    return cost


def _gather_names(node) -> set:
    names: set = set()

    def visit(e):
        if isinstance(e, P.Gather):
            names.add(e.array)

    for attr in ("value", "bool_any"):
        v = getattr(node, attr, None)
        if v is not None:
            P._walk_exprs(v, visit)
    for k in getattr(node, "keys", ()) or ():
        P._walk_exprs(k, visit)
    return names


# ---------------------------------------------------------------------------
# the estimate
# ---------------------------------------------------------------------------

@dataclass
class MemEstimate:
    program: str
    resident: int                  # all params placed on device
    bag_bytes: dict                # bag → total bytes (streamable share)
    dest_bytes: int                # bytes of all plan destinations
    nodes: list                    # NodeCost, plan order
    donation_credit: int           # dest copies whole-program donation elides
    peak: int                      # resident + worst node moment
    nshards: int = 1

    @property
    def peak_bytes(self) -> int:
        return self.peak

    @property
    def fixed_bytes(self) -> int:
        """What stays device-resident under chunked streaming: everything
        except the bags themselves (dests, dense params, scalars)."""
        return max(0, self.resident - sum(self.bag_bytes.values())) \
            + self.dest_bytes

    def per_row(self, bag: str | None = None) -> int:
        """Streaming bytes per bag row: the tile's columns (double-buffered
        host→device prefetch keeps two tiles in flight) plus the widest
        per-row grid temp of any node that consumes the bag."""
        rows_pr = {}
        for b, total in self.bag_bytes.items():
            base = 2 * max(1, total // max(1, self._bag_rows.get(b, 1)))
            node_pr = max((c.per_row.get(b, 0) for c in self.nodes), default=0)
            rows_pr[b] = base + node_pr
        if bag is not None:
            return rows_pr.get(bag, 1)
        return max(rows_pr.values(), default=1)

    _bag_rows: dict = field(default_factory=dict)

    def summary(self, budget: int | None = None) -> str:
        line = (f"memory: peak≈{fmt_bytes(self.peak)} "
                f"(resident {fmt_bytes(self.resident)}, "
                f"worst-node temps {fmt_bytes(self.peak - self.resident)}"
                + (f", donation credit {fmt_bytes(self.donation_credit)}"
                   if self.donation_credit else "") + ")")
        if budget is not None:
            verdict = "all-resident" if self.peak <= budget else "chunked"
            line += f"  budget={fmt_bytes(budget)} → {verdict}"
        return line

    def explain(self, budget: int | None = None) -> str:
        out = [f"== memory estimate: {self.program} =="]
        out.append(f"resident: {fmt_bytes(self.resident)}"
                   + (f"  (bags {fmt_bytes(sum(self.bag_bytes.values()))})"
                      if self.bag_bytes else "")
                   + (f"  [{self.nshards} shards]" if self.nshards > 1 else ""))
        for i, c in enumerate(self.nodes):
            extra = ""
            if c.collective:
                extra += f" +collective {fmt_bytes(c.collective)}"
            out.append(f"[{i}] {c.label}: temp {fmt_bytes(c.temp)}"
                       f" +dest-copy {fmt_bytes(c.dest)}{extra}")
        out.append(self.summary(budget))
        if self.bag_bytes:
            prs = ", ".join(f"{b}≈{fmt_bytes(self.per_row(b))}/row"
                            for b in sorted(self.bag_bytes))
            out.append(f"streaming: fixed {fmt_bytes(self.fixed_bytes)}, {prs}")
        return "\n".join(out)


def estimate(plan, prog, env: dict, *, donate: bool = False,
             nshards: int = 1) -> MemEstimate:
    """env: a `shape_env`/`shape_env_from_signature` dict."""
    dims = {n: e[1] for n, e in env.items() if e[0] == "dim"}
    bags = {e_name: entry for e_name, entry in
            ((n, e) for n, e in env.items() if e[0] == "bag")}
    # bag axes refer to bags by BAG NAME == param name
    resident = 0
    bag_bytes = {}
    for name, entry in env.items():
        if entry[0] == "bag":
            b = _bag_bytes(entry)
            resident += b
            bag_bytes[name] = b
        elif entry[0] == "array":
            resident += _array_bytes(entry)

    nodes = P.flatten(plan)
    costs = [_node_cost(n, env, dims, bags, nshards) for n in nodes]

    dests: list = []
    for n in nodes:
        for d in P.dests_of(n):
            if d not in dests:
                dests.append(d)
    dest_total = sum(_dest_bytes(d, env) for d in dests)

    credit = 0
    worst = 0
    for c in costs:
        copy = 0 if donate else c.dest
        if donate:
            credit = max(credit, c.dest)
        worst = max(worst, c.temp + copy + c.collective)

    est = MemEstimate(program=getattr(prog, "name", "?"),
                      resident=resident, bag_bytes=bag_bytes,
                      dest_bytes=dest_total, nodes=costs,
                      donation_credit=credit,
                      peak=resident + worst, nshards=nshards)
    est._bag_rows = {n: e[1] for n, e in env.items() if e[0] == "bag"}
    return est
