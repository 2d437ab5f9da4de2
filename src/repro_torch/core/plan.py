"""Physical-plan IR — the artifact between translation and execution.

The translator (translate.py) produces target *comprehensions* (paper Fig. 2);
the pass pipeline (passes.py) turns each comprehension into one of the
physical operators below; the executor (lower.py) materializes the chosen
operator in JAX; distributed.py maps the same nodes onto a device mesh.
Nothing downstream of passes.py re-derives a plan decision — recognition
happens once, here, and every backend consumes the same plan.

Operator catalogue (paper rule in brackets):

  MapExpr         elementwise store over the iteration space  [15b, axis keys]
  Scatter         store at computed affine keys (.at[].set, drop)       [15b]
  SegmentReduce   group-by on computed keys → scatter-⊕ / Pallas kernel [15a]
  AxisReduce      group-by on pure axis keys → ⊕-reduce over the
                  contracted axes, no shuffle            [Rule 17 generalized]
  EinsumContract  +-reduction of a product of gathers → MXU contraction
                  (beyond-paper; falls back to AxisReduce at runtime)
  TiledMatmul     matmul-shaped EinsumContract on a §5 packed lhs →
                  block-sparse Pallas tile_matmul, no unpack
  ScalarReduce    total aggregation into a scalar / fixed cell  [Rule 16]
  SeqLoop         sequential while over the mutated-variable carry   [15f]
  Fused           consecutive reductions sharing one iteration space,
                  merged so distributed execution runs one collective round
  Rebalance       explicit redistribution restoring balanced ONED_ROW row
                  blocks for an ONED_VAR (variable-block) array — inserted
                  by the distribution analysis' _rebalance fixed point
                  (HPAT idiom) when a consumer needs equal blocks; a no-op
                  on a single device

Expression trees inside nodes contain `Gather` — the physical read operator
(clipped gather + inRange mask); `broadcast_ok` marks reads the
identity-traversal pass proved to be whole-array traversals, which the
executor turns into a broadcast instead of a gather when extents line up.

Runtime guards: extents and input representations (packed vs dense) are only
known at run(); optimistic nodes (EinsumContract, TiledMatmul) therefore
carry a `fallback` chain the executor walks when a guard fails.  A fallback
never changes results, only the operator used.

Every leaf node also carries a `shardings` annotation — written by the
distribution-analysis pass (dist_analysis.py) after the pipeline — mapping
each dense operand (destination first, then reads) to its inferred
placement on a device mesh: ``REP`` (replicated), ``ONED_ROW(i)``
(block-partitioned on dim 0, aligned with axis var `i` in this node),
``ONED_ROW`` (partitioned, unaligned access here) or ``TWOD_BLOCK``
(2-D block candidate; matmul operands).  `explain()` prints one
`shardings:` line per node so the chosen distribution is part of the
plan's observable contract; distributed.py consumes the same annotations
to place arrays and pick collectives.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from .comprehension import Get, pretty
from .loop_ast import Expr, Var


# ---------------------------------------------------------------------------
# physical read
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Gather(Expr):
    """Physical array read: gather with clipped indices + inRange mask.
    `broadcast_ok` = indices are distinct generator-axis vars, so when the
    runtime extents cover the array this is the array itself, broadcast."""
    array: str
    idxs: tuple[Expr, ...]
    broadcast_ok: bool = False


# ---------------------------------------------------------------------------
# iteration space
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AxisSpec:
    kind: str                    # "range" | "bag"
    var: str                     # the axis variable (loop index)
    lo: Optional[Expr] = None    # range bounds (None for bag axes)
    hi: Optional[Expr] = None
    bag: Optional[str] = None    # bag name (bag axes)
    vals: tuple[str, ...] = ()   # bag value-column variables


@dataclass(frozen=True)
class IterSpace:
    axes: tuple[AxisSpec, ...]
    conds: tuple[Expr, ...] = ()

    @property
    def axis_vars(self) -> tuple[str, ...]:
        return tuple(a.var for a in self.axes)

    @property
    def bag_names(self) -> tuple[str, ...]:
        return tuple(a.bag for a in self.axes if a.kind == "bag")

    @property
    def has_bag(self) -> bool:
        return any(a.kind == "bag" for a in self.axes)

    @property
    def bagval_vars(self) -> tuple[str, ...]:
        return tuple(v for a in self.axes for v in a.vals)

    def pretty(self) -> str:
        return "×".join(self.axis_vars) if self.axes else "·"


# ---------------------------------------------------------------------------
# static einsum description
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EinsumFactors:
    """A +-product of gathers: factors[i] is indexed purely by generator-axis
    vars (factor_axes[i]); `others` are residual axis-free scalar factors."""
    factors: tuple[Gather, ...]
    factor_axes: tuple[tuple[str, ...], ...]
    others: tuple[Expr, ...] = ()

    def spec(self, key_axes) -> str:
        ins = ",".join("".join(a) for a in self.factor_axes)
        return ins + "->" + "".join(key_axes)


# ---------------------------------------------------------------------------
# plan nodes
# ---------------------------------------------------------------------------

@dataclass
class MapExpr:
    """Elementwise store: dest[key_axes] := value over the space (key_axes
    None = scalar assignment guarded by the space's conds)."""
    stmt: Any
    space: IterSpace
    reads: frozenset
    dest: str
    value: Expr
    key_axes: Optional[tuple[str, ...]] = None
    shardings: Optional[dict] = None   # dist_analysis annotation
    lineage = None   # RoundLineage recovery recipe (core/lineage.py, §13)

    def describe(self) -> str:
        if self.key_axes is None:
            return f"MapExpr(scalar) → {self.dest}"
        return (f"MapExpr[{self.space.pretty()}] → "
                f"{self.dest}[{','.join(self.key_axes)}]")


@dataclass
class DenseMap(MapExpr):
    """Dense fast-path specialization of MapExpr (pass: dense-fastpath):
    the iteration space is a 0-based all-range space whose key order IS the
    axis order, and every read in the value is an identity gather (indexed
    by exactly the key axes, in order) or a scalar.  The executor lowers it
    to a plain vectorized jnp expression over whole arrays — no index-grid
    materialization, no gathers, no masks, no .at[].set — locally and per
    shard (aligned operands are used as local blocks, replicated ones via a
    bounds-certified dynamic slice).  Runtime extent mismatch falls back to
    the general MapExpr path; results never change."""

    def describe(self) -> str:
        return (f"DenseMap[{self.space.pretty()}] → "
                f"{self.dest}[{','.join(self.key_axes)}]"
                f"  (vectorized, gathers elided)")


@dataclass
class Scatter:
    """Store at computed affine keys (restrictions ⇒ no duplicate keys)."""
    stmt: Any
    space: IterSpace
    reads: frozenset
    dest: str
    keys: tuple[Expr, ...]
    value: Expr
    shardings: Optional[dict] = None   # dist_analysis annotation
    lineage = None   # RoundLineage recovery recipe (core/lineage.py, §13)

    def describe(self) -> str:
        return f"Scatter[{self.space.pretty()}] → {self.dest} (drop OOB)"


@dataclass
class SegmentReduce:
    """Group-by on computed keys → segment-⊕ into the destination index
    space (the paper's shuffle).  `candidates` is the backend candidate
    set the operator-selection pass attached (op_select.py, DESIGN.md §8):
    scatter-⊕ / sort-based segment reduce / one-hot dot_general / the
    Pallas MXU kernel.  `backend="auto"` defers the choice to the
    cost-model/autotune selector at trace time (shapes are known there);
    any concrete name pins it.  The executor records the resolved choice —
    explain() prints it as a `selected:` line after a run."""
    stmt: Any
    space: IterSpace
    reads: frozenset
    dest: str
    keys: tuple[Expr, ...]
    op: str
    value: Expr
    backend: str = "scatter"     # "auto" | one of `candidates`
    candidates: tuple[str, ...] = ("scatter",)
    shardings: Optional[dict] = None   # dist_analysis annotation
    salt: Optional[int] = None   # hot-key salting static hint: spread each
    # key over S sub-destinations (key*S + salt), fold salts after; None =
    # let op_select.choose_salt decide per shape class / runtime probe
    lineage = None   # RoundLineage recovery recipe (core/lineage.py, §13)

    def describe(self) -> str:
        b = self.backend if self.backend != "auto" else \
            "auto{" + "|".join(self.candidates) + "}"
        return (f"SegmentReduce({self.op}, backend={b})"
                f"[{self.space.pretty()}] → {self.dest}")


@dataclass
class AxisReduce:
    """Group-by on pure axis keys (Rule 17 generalized): ⊕-reduce the
    contracted axes; elementwise merge when nothing is contracted.

    `product` is the dense fast-path MXU certificate (pass:
    dense-fastpath): when the +-reduced value is recognized as a product of
    axis-indexed gathers, the executor materializes THIS SAME operator via
    jnp.einsum instead of the dense iteration grid.  Unlike EinsumContract
    this is not a plan-level operator change — the node stays an
    AxisReduce (the paper-faithful operator choice, kept under
    optimize_contractions=False) and only its local materialization rides
    the MXU; guard failure falls back to the grid."""
    stmt: Any
    space: IterSpace
    reads: frozenset
    dest: str
    key_axes: tuple[str, ...]
    op: str
    value: Expr
    product: Optional[EinsumFactors] = None   # dense-fastpath MXU certificate
    shardings: Optional[dict] = None   # dist_analysis annotation
    lineage = None   # RoundLineage recovery recipe (core/lineage.py, §13)

    @property
    def contracted(self) -> tuple[str, ...]:
        ks = set(self.key_axes)
        return tuple(a for a in self.space.axis_vars if a not in ks)

    def describe(self) -> str:
        over = ",".join(self.contracted) or "·"
        base = (f"AxisReduce({self.op} over {over}) → "
                f"{self.dest}[{','.join(self.key_axes)}]")
        if self.product is not None:
            base += f"  [mxu: '{self.product.spec(self.key_axes)}']"
        return base


@dataclass
class EinsumContract:
    """+-contraction of a product of gathers (or a ±-sum of such products in
    `terms` mode) lowered to jnp.einsum.  Falls back to `fallback` when a
    runtime extent guard fails."""
    stmt: Any
    space: IterSpace
    reads: frozenset
    dest: str
    key_axes: tuple[str, ...]
    product: Optional[EinsumFactors] = None
    scalars: tuple[Expr, ...] = ()        # axis-free factors (terms mode)
    terms: Optional[tuple] = None         # ((sign, Expr, EinsumFactors|None), ...)
    fallback: Optional[AxisReduce] = None
    candidates: tuple[str, ...] = ("einsum", "dense-grid")  # guard chain
    shardings: Optional[dict] = None      # dist_analysis annotation
    lineage = None   # RoundLineage recovery recipe (core/lineage.py, §13)

    @property
    def op(self) -> str:
        return "+"      # einsum recognition only fires on +-reductions

    @property
    def contracted(self) -> tuple[str, ...]:
        ks = set(self.key_axes)
        return tuple(a for a in self.space.axis_vars if a not in ks)

    def describe(self) -> str:
        if self.product is not None:
            ops = ",".join(f.array for f in self.product.factors)
            return (f"EinsumContract('{self.product.spec(self.key_axes)}'; "
                    f"{ops}) → {self.dest}")
        return (f"EinsumContract(term-split, {len(self.terms or ())} terms "
                f"over {','.join(self.contracted)}) → {self.dest}")


@dataclass
class TiledMatmul:
    """§5 packed-array fusion: a matmul-shaped contraction whose lhs arrives
    as a TiledMatrix runs the block-sparse Pallas tile_matmul directly on
    the tiles (no unpack).  Dense lhs at runtime → `contract`."""
    stmt: Any
    space: IterSpace
    reads: frozenset
    dest: str
    contract: EinsumContract
    candidates: tuple[str, ...] = ("pallas-tiled", "unpack-einsum")
    shardings: Optional[dict] = None   # dist_analysis annotation
    lineage = None   # RoundLineage recovery recipe (core/lineage.py, §13)

    @property
    def op(self) -> str:
        return "+"

    @property
    def lhs(self) -> str:
        return self.contract.product.factors[0].array

    @property
    def rhs(self) -> str:
        return self.contract.product.factors[1].array

    def describe(self) -> str:
        return (f"TiledMatmul(pallas tile_matmul on packed {self.lhs}, "
                f"rhs {self.rhs}) → {self.dest}")


@dataclass
class ScalarReduce:
    """Rule 16: total ⊕-aggregation into a scalar, or into one fixed cell
    (`point`) for constant group-by keys.  `dense` is the dense fast-path
    certificate (pass: dense-fastpath): the value and conditions read only
    bag value columns and scalars — the reduction is a pure columnar
    ⊕-fold with no gathers and no index-grid materialization."""
    stmt: Any
    space: IterSpace
    reads: frozenset
    dest: str
    op: str
    value: Expr
    point: Optional[tuple[int, ...]] = None
    bool_any: Optional[Expr] = None  # peephole: max/min of float(bool) → any/all
    dense: bool = False              # dense-fastpath columnar certificate
    shardings: Optional[dict] = None  # dist_analysis annotation
    lineage = None   # RoundLineage recovery recipe (core/lineage.py, §13)

    def describe(self) -> str:
        tgt = self.dest if self.point is None else \
            f"{self.dest}[{','.join(map(str, self.point))}]"
        tail = "  [dense: columnar, no gathers]" if self.dense else ""
        return f"ScalarReduce({self.op})[{self.space.pretty()}] → {tgt}{tail}"


@dataclass
class SeqLoop:
    """lax.while_loop over the carry of body-mutated variables."""
    stmt: Any
    space: IterSpace
    reads: frozenset
    cond: Expr
    body: list = field(default_factory=list)
    carry: tuple[str, ...] = ()
    lineage = None   # RoundLineage recovery recipe (core/lineage.py, §13)

    def describe(self) -> str:
        return f"SeqLoop(carry={','.join(self.carry)})"


@dataclass
class Rebalance:
    """Explicit redistribution of one ONED_VAR array back to balanced
    ONED_ROW row blocks (HPAT's rebalance round).  Inserted by
    pass_distribution when the analysis' `_rebalance` fixed point pins the
    array up from ONED_VAR (dist_analysis.analyze rebalance_out =
    "inserted").  Distributed execution is a cached shard_map round built
    from the existing exchange machinery: per-shard live-row counts are
    exchanged with a one-hot `psum` (size exchange), exclusive-cumsummed
    into global offsets, and rows are scattered to their balanced global
    positions then redistributed with `psum_scatter` (each target position
    receives exactly one addend, so the composition is an exact all-to-all,
    not an approximate reduction).  On canonical front-packed layouts the
    round is value-identity; the single-device executor runs it as a
    no-op.  Results never change — only the placement contract."""
    stmt: Any
    space: IterSpace
    reads: frozenset
    dest: str                          # the array being rebalanced in place
    shardings: Optional[dict] = None   # dist_analysis annotation
    lineage = None   # RoundLineage recovery recipe (core/lineage.py, §13)

    def describe(self) -> str:
        return (f"Rebalance({self.dest}) "
                f"(size exchange + all-to-all, ONED_VAR→ONED_ROW)")


@dataclass
class Fused:
    """Cross-statement fusion: consecutive reductions over one iteration
    space with disjoint destinations; distributed mode runs them as a single
    shard_map round."""
    stmt: Any
    space: IterSpace
    reads: frozenset
    parts: list = field(default_factory=list)
    lineage = None   # RoundLineage recovery recipe (core/lineage.py, §13)

    def describe(self) -> str:
        return f"Fused[{self.space.pretty()}] {{{len(self.parts)} updates}}"


@dataclass
class FusedRound:
    """Round-fusion region (pass 11, round-fusion): adjacent plan nodes the
    distributed executor may run as ONE shard_map program, with the
    collectives (psum / psum_scatter / all_gather) placed INSIDE the fused
    body instead of one jit+shard_map dispatch per node.  Unlike `Fused`
    (one iteration space, disjoint destinations, parallel parts) the
    members here execute SEQUENTIALLY — later members see earlier results —
    and each member keeps its own round classification (aligned store /
    aligned reduce / unaligned reduce / replicated scalar).  A SeqLoop
    whose whole body is one region additionally runs as an ON-DEVICE
    lax.while_loop inside the same shard_map program when its condition is
    computable from the carry, eliminating the per-iteration host sync.
    lineage = None   # RoundLineage recovery recipe (core/lineage.py, §13)

    The single-device executor treats the region as plain sequencing; the
    distributed executor verifies member compatibility against runtime
    shapes at round-build time and falls back to per-member rounds when a
    guard fails.  Grouping never changes results, only dispatch."""
    stmt: Any
    space: IterSpace
    reads: frozenset
    parts: list = field(default_factory=list)

    def describe(self) -> str:
        return f"FusedRound{{{len(self.parts)} members}}"


PlanNode = Any

REDUCE_NODES = (SegmentReduce, AxisReduce, EinsumContract, TiledMatmul,
                ScalarReduce)


def dests_of(node: PlanNode) -> tuple[str, ...]:
    if isinstance(node, Fused):
        return tuple(p.dest for p in node.parts)
    if isinstance(node, FusedRound):
        out: list = []
        for p in node.parts:
            for d in dests_of(p):
                if d not in out:
                    out.append(d)
        return tuple(out)
    if isinstance(node, SeqLoop):
        return node.carry
    return (node.dest,)


def flatten(nodes) -> list:
    """Top-level nodes with FusedRound regions opened (members in order).
    SeqLoop and Fused are NOT opened — they are operators, not regions."""
    out: list = []
    for n in nodes:
        if isinstance(n, FusedRound):
            out.extend(flatten(n.parts))
        else:
            out.append(n)
    return out


def seq_loops(nodes) -> list:
    """(index, SeqLoop) for every top-level sequential loop in execution
    order, FusedRound containers opened — the stable loop numbering the
    checkpoint/resume path keys carry snapshots by (DESIGN.md §11).
    Nested SeqLoops are not enumerated: they execute inside their parent
    loop's body and their state is covered by the parent's carry."""
    return [(i, n) for i, n in enumerate(
        n for n in flatten(nodes) if isinstance(n, SeqLoop))]


def is_reduce(node: PlanNode) -> bool:
    return isinstance(node, REDUCE_NODES) or (
        isinstance(node, Fused)
        and all(isinstance(p, REDUCE_NODES) for p in node.parts))


# ---------------------------------------------------------------------------
# bag-row alignment (batchable-entry hook, serving layer — DESIGN.md §10)
# ---------------------------------------------------------------------------

def _walk_exprs(e, fn):
    if e is None:
        return
    fn(e)
    for attr in ("lhs", "rhs", "e"):
        if hasattr(e, attr):
            _walk_exprs(getattr(e, attr), fn)
    for attr in ("args", "idxs"):
        if hasattr(e, attr):
            for a in getattr(e, attr):
                _walk_exprs(a, fn)


def bag_row_arrays(plan) -> dict:
    """array name → bag name for every dense array whose dim-0 rides a
    bag's ROW axis: somewhere in the plan the array is read with a bag
    AXIS var (the `items()` index) as its leading index, or stored with a
    bag axis var as its leading key axis.  Such an array's dim-0 extent is
    the bag's row count by construction, so a caller padding the bag's
    rows (the serving layer's shape buckets, DESIGN.md §10) must pad the
    array's dim-0 in lockstep and thread a matching `array_limits` entry.
    Arrays whose leading index is a range var or a computed expression are
    NOT included — their dim-0 is pinned by a static dim, never the bag
    length.  An array aligned with two different bags is dropped (no
    single pad length is correct for it)."""
    out: dict = {}
    dropped: set = set()

    def note(arr: str, bag: str):
        if out.setdefault(arr, bag) != bag:
            dropped.add(arr)

    def visit(nodes):
        for node in nodes:
            if isinstance(node, SeqLoop):
                visit(node.body)
                continue
            if isinstance(node, (Fused, FusedRound)):
                visit(node.parts)
                continue
            space = getattr(node, "space", None)
            if space is None:
                continue
            bagvars = {a.var: a.bag for a in space.axes if a.kind == "bag"}
            if not bagvars:
                continue

            def read(e, _bv=bagvars):
                if isinstance(e, (Gather, Get)) and e.idxs:
                    i0 = e.idxs[0]
                    if isinstance(i0, Var) and i0.name in _bv:
                        note(e.array, _bv[i0.name])

            for attr in ("value", "cond", "bool_any"):
                _walk_exprs(getattr(node, attr, None), read)
            for k in getattr(node, "keys", ()) or ():
                _walk_exprs(k, read)
            for c in space.conds:
                _walk_exprs(c, read)
            key_axes = getattr(node, "key_axes", None)
            if key_axes and key_axes[0] in bagvars:
                note(node.dest, bagvars[key_axes[0]])
            if isinstance(node, EinsumContract) and node.fallback is not None:
                visit([node.fallback])
            elif isinstance(node, TiledMatmul):
                visit([node.contract])
    visit(plan)
    return {a: b for a, b in out.items() if a not in dropped}


# ---------------------------------------------------------------------------
# plan pretty-printer (Spark-EXPLAIN-style)
# ---------------------------------------------------------------------------

def _node_lines(node: PlanNode, indent: int, tiled, out: list,
                decisions=None):
    pre = "  " * indent
    if isinstance(node, SeqLoop):
        out.append(f"{pre}{node.describe()}")
        for b in node.body:
            _node_lines(b, indent + 1, tiled, out, decisions)
        return
    if isinstance(node, (Fused, FusedRound)):
        out.append(f"{pre}{node.describe()}")
        for p in node.parts:
            _node_lines(p, indent + 1, tiled, out, decisions)
        return
    if isinstance(node, TiledMatmul) and node.lhs not in tiled:
        # resolve the runtime representation guard for display
        _node_lines(node.contract, indent, tiled, out, decisions)
        return
    line = f"{pre}{node.describe()}"
    if isinstance(node, EinsumContract) and node.fallback is not None:
        line += f"  [fallback: {node.fallback.describe()}]"
    if isinstance(node, TiledMatmul):
        line += f"  [dense lhs: {node.contract.describe()}]"
    out.append(line)
    if node.stmt is not None:
        out.append(f"{pre}    {pretty(node.stmt)}")
    if getattr(node, "shardings", None):
        out.append(f"{pre}    shardings: " + ", ".join(
            f"{k}={v}" for k, v in node.shardings.items()))
    if decisions:
        d = decisions.get(id(node))
        if d is None and isinstance(node, TiledMatmul):
            d = decisions.get(id(node.contract))
        if d is not None:
            out.append(f"{pre}    selected: {d}")


def explain(plan: list, name: str = "", tiled=(), decisions=None) -> str:
    """Pretty-print the chosen physical operator per statement.  `tiled`
    names parameters assumed to arrive as §5 packed TiledMatrix inputs,
    resolving the TiledMatmul-vs-einsum runtime guard for display.
    `decisions` (id(node) → tag, the executor's trace-time record) adds a
    `selected:` line per node — the operator-selection subsystem's
    observable contract (op_select.py): which backend actually ran."""
    out = [f"== physical plan{': ' + name if name else ''} =="]
    for i, node in enumerate(plan):
        sub: list = []
        _node_lines(node, 0, frozenset(tiled), sub, decisions)
        out.append(f"[{i}] {sub[0]}")
        out.extend("    " + s for s in sub[1:])
    return "\n".join(out)
