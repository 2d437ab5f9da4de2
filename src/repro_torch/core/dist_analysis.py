"""Distribution analysis: infer a sharding for every dense array.

The paper's scalability argument (§6, Fig. 4–5) assumes *all* large
operands are partitioned.  Sharding only bags (the pre-pass behaviour)
replicates every dense array — PageRank ranks, k-means centroids and
matrix-factorization factors — so range-driven programs could not grow
past one device's memory.  This pass closes that gap the HPAT way
(Totoni et al., `distributed_analysis.py`): a fixed-point inference over
the physical plan assigning each array a distribution from the lattice

    REP  ≤  ONED_VAR  ≤  ONED_ROW  ≤  TWOD_BLOCK

    REP         replicated on every device (always-correct fallback, ⊥)
    ONED_VAR    row-partitioned along dim 0 with VARIABLE per-shard live
                lengths (HPAT's OneD_Var): bag-derived and filtered
                arrays, whose live extent is data-dependent — each shard
                holds an equal physical block but a different logical row
                count (the pad+mask limit)
    ONED_ROW    block-partitioned along dim 0 over the dp mesh axes,
                equal (balanced) live blocks
    TWOD_BLOCK  2-D block-partition candidate (matmul operands); the
                current executors place it as ONED_ROW — the lattice
                point records that a 2-D placement would be legal

Inference is optimistic-then-meet: every dense array starts at the top
(`TWOD_BLOCK`) and constraints only move it *down* (`meet` = min), so the
fixed point exists and is reached monotonically.  Two HPAT-style sweeps:

  sweep 1 (writes)  each plan node caps its destination at the best
                    distribution the distributed executor can *produce*
                    for that node shape (see `_dest_cap`); arrays read in
                    a SeqLoop condition meet to REP (the condition is
                    evaluated replicated every iteration).
  sweep 2 (reads)   "rebalance": any appearance outside a matmul-shaped
                    contraction caps an array at ONED_ROW, so TWOD_BLOCK
                    survives only for pure matmul operands.

The sweeps repeat until no distribution changes (the lattice has height
3, so at most a few iterations).  Loop-carried arrays need no extra
constraint: a distribution is a property of the *array*, not of a program
point, so a SeqLoop body sees one stable sharding across iterations by
construction — the meet over all its writers.

After the base fixed point, a `_rebalance` pass (HPAT's `_rebalance_arrs`
re-run idiom) revisits every array left at ONED_VAR and decides whether
variable blocks are acceptable where it is consumed.  Readers that only
walk the producing axis element-wise tolerate skewed blocks, so the array
KEEPS ONED_VAR and the rebalance is *elided*; a reader that slices by
global offsets (a contraction certificate) or re-reads the array across
SeqLoop iterations needs balanced blocks, so the array is pinned up to
ONED_ROW — recording that an explicit rebalance round must be *inserted*
after its producer — and the whole analysis re-runs with the pin until no
new pin appears.  `analyze(..., rebalance_out=...)` reports the final
{array: "inserted" | "elided"} decisions; pass_distribution materializes
the inserted ones as `plan.Rebalance` nodes.

Guarantee: a changed distribution never changes a result, only its
placement.  Every node keeps a replicated execution path (distributed.py
falls back to it whenever a runtime shape guard fails), and REP-everything
remains the global fallback (`PlanConfig.infer_distributions=False` or
`DistributedProgram(shard_dense=False)`).

Annotations: each leaf plan node gets a `shardings` dict — destination
first, then read operands — mapping array name to a `Sharding` whose str()
is e.g. ``ONED_ROW(i)`` (sharded on dim 0, aligned with axis var `i` in
this node), ``ONED_ROW`` (sharded, unaligned access here), ``TWOD_BLOCK``
or ``REP``.  `CompiledProgram.explain()` prints them per operand.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Optional

from . import plan as P
from .comprehension import Get
from .loop_ast import BinOp, Call, Const, Program, UnOp, Var


class Dist(IntEnum):
    """The distribution lattice; smaller = more replicated (meet = min)."""
    REP = 0
    ONED_VAR = 1      # row-partitioned, variable per-shard live lengths
    ONED_ROW = 2
    TWOD_BLOCK = 3


def meet(a: Dist, b: Dist) -> Dist:
    return Dist(min(a, b))


@dataclass(frozen=True)
class Sharding:
    """One operand's inferred placement within one plan node."""
    dist: Dist
    axis: Optional[str] = None    # aligned iteration-axis var, when known

    def __str__(self) -> str:
        if self.dist >= Dist.ONED_VAR and self.axis:
            return f"{self.dist.name}({self.axis})"
        return self.dist.name


# ---------------------------------------------------------------------------
# plan walking helpers
# ---------------------------------------------------------------------------

def dense_arrays(prog: Program) -> frozenset:
    return frozenset(n for n, t in prog.params.items()
                     if t.kind in ("vector", "matrix", "map"))


def leaf_nodes(nodes):
    """Yield every leaf plan node (Fused parts, FusedRound regions and
    SeqLoop bodies opened)."""
    for n in nodes:
        if isinstance(n, (P.SeqLoop, P.FusedRound)):
            yield from leaf_nodes(n.body if isinstance(n, P.SeqLoop)
                                  else n.parts)
        elif isinstance(n, P.Fused):
            yield from n.parts
        else:
            yield n


def _walk_gathers(e, acc: dict):
    if isinstance(e, (P.Gather, Get)):
        acc.setdefault(e.array, []).append(tuple(e.idxs))
        for i in e.idxs:
            _walk_gathers(i, acc)
    elif isinstance(e, BinOp):
        _walk_gathers(e.lhs, acc)
        _walk_gathers(e.rhs, acc)
    elif isinstance(e, UnOp):
        _walk_gathers(e.e, acc)
    elif isinstance(e, Call):
        for a in e.args:
            _walk_gathers(a, acc)


def gathers_of(node) -> dict:
    """Array name → list of index tuples for every read in the node (for
    Fused, the union over all parts: alignment must hold everywhere)."""
    acc: dict = {}
    if isinstance(node, P.TiledMatmul):
        return gathers_of(node.contract)
    if isinstance(node, P.Fused):
        for p in node.parts:
            for name, idx_lists in gathers_of(p).items():
                acc.setdefault(name, []).extend(idx_lists)
        for e in node.space.conds:
            _walk_gathers(e, acc)
        return acc
    exprs = list(node.space.conds)
    if hasattr(node, "value"):
        exprs.append(node.value)
    exprs.extend(getattr(node, "keys", ()))
    if isinstance(node, P.EinsumContract) and node.fallback is not None:
        exprs.append(node.fallback.value)   # original value pre-recognition
    for e in exprs:
        _walk_gathers(e, acc)
    return acc


def aligned_reads(node, axis_var: str) -> frozenset:
    """Arrays whose EVERY read in `node` is leading-indexed by `axis_var`
    (dim 0 of the array walks in lockstep with the sharded axis, so a
    per-shard row block serves all of the node's reads of it)."""
    out = set()
    for name, idx_lists in gathers_of(node).items():
        if all(idxs and isinstance(idxs[0], Var) and idxs[0].name == axis_var
               for idxs in idx_lists):
            out.add(name)
    return frozenset(out)


def leading_key_var(node) -> Optional[str]:
    """The axis var indexing dim 0 of the destination, when it is one."""
    if isinstance(node, P.TiledMatmul):
        node = node.contract
    keys = getattr(node, "key_axes", None)
    if keys:
        return keys[0]
    keys = getattr(node, "keys", None)
    if keys and isinstance(keys[0], Var) and \
            keys[0].name in node.space.axis_vars:
        return keys[0].name
    return None


def _static_zero(e) -> bool:
    return isinstance(e, Const) and e.value == 0


# ---------------------------------------------------------------------------
# bounds certificates for per-shard slices (DESIGN.md §7)
# ---------------------------------------------------------------------------

def _contract_groups(node):
    """The node's recognized contraction factor groups ((factors,
    factor_axes) pairs), or None when it carries no product certificate."""
    if isinstance(node, P.TiledMatmul):
        node = node.contract
    if isinstance(node, P.EinsumContract):
        if node.product is not None:
            return [(node.product.factors, node.product.factor_axes)]
        if node.terms:
            out = [(ef.factors, ef.factor_axes)
                   for _s, _t, ef, _f in node.terms if ef is not None]
            return out or None
        return None
    if isinstance(node, P.AxisReduce) and node.product is not None:
        return [(node.product.factors, node.product.factor_axes)]
    return None


def shard_slice_certificates(node, axis: str, local: frozenset):
    """Structural bounds certificates for running `node`'s contraction as a
    per-shard jnp.einsum inside a shard_map round over `axis`.  For every
    factor, each occurrence of the round axis must be provably sliceable
    without relying on lax.dynamic_slice's silent clamping:

      "local"   the factor is an axis-aligned local block (every read
                leading-indexed by the round axis, rows tiling like the
                axis): its dim-0 block IS the shard's window, slice at 0.
      "window"  the factor stays global on the shard: a dynamic_slice
                window [offset, offset+extent) whose bound offset+extent ≤
                padded-global-extent is checked against the physical dim
                at trace time (zero-padding the + identity when shorter).
      "static"  the round axis does not index this factor; plain static
                slicing applies.

    Returns {array: certificate}; None when some factor admits no
    certificate (or an unrecognized term still needs a gather grid) — the
    executor will then fall back to the masked dense-grid path.  The
    numeric halves of these certificates (row counts, padded extents) are
    re-checked by lower._sliced_operand at trace time; this function is
    the static contract distributed.py consults and explain_rounds()
    prints."""
    groups = _contract_groups(node)
    if groups is None:
        return None
    inner = node.contract if isinstance(node, P.TiledMatmul) else node
    if isinstance(inner, P.EinsumContract) and inner.terms:
        for _s, term, ef, _f in inner.terms:
            acc: dict = {}
            _walk_gathers(term, acc)
            if ef is None and acc:
                return None     # unrecognized term needs the gather grid
    bagvars = {a.var for a in node.space.axes if a.kind == "bag"}
    cert: dict = {}
    for factors, factor_axes in groups:
        for f, faxes in zip(factors, factor_axes):
            kind = "static"
            for dim_i, axn in enumerate(faxes):
                if axn != axis and axn not in bagvars:
                    continue
                if dim_i == 0 and f.array in local:
                    kind = "local"
                elif axn == axis and f.array not in local:
                    kind = "window"
                else:
                    return None
            prev = cert.get(f.array)
            if prev is not None and prev != kind and "static" not in \
                    (prev, kind):
                return None     # conflicting requirements across reads
            cert[f.array] = kind if prev in (None, "static") else prev
    return cert


def round_axis(node) -> Optional[str]:
    """The axis a shard_map round for THIS node would split: the single bag
    axis when the space is bag-driven, else the leading destination key
    axis provided it is a range axis starting at 0 (so contiguous row
    blocks of the destination line up with contiguous index blocks of the
    axis).  None when no such axis exists (replicated execution)."""
    bags = [a for a in node.space.axes if a.kind == "bag"]
    if len(bags) == 1:
        return bags[0].var
    if bags:
        return None                      # bag join: no single shard axis
    lead = leading_key_var(node)
    for a in node.space.axes:
        if a.var == lead and a.kind == "range" and _static_zero(a.lo):
            return lead
    return None


_ALIGNED_DEST_NODES = (P.MapExpr, P.Scatter, P.AxisReduce, P.EinsumContract,
                       P.TiledMatmul)


def _benefits_from_sharding(node, name: str) -> bool:
    """Does THIS node's use of `name` ever exploit a ONED_ROW placement?
    True for a destination that can run an aligned (collective-free)
    store/reduce round, and for a read the round can serve from the local
    block.  An unaligned reduce destination (SegmentReduce: computed
    keys) and a gathered read never benefit — sharding them only changes
    the exchange/placement cost."""
    axis = round_axis(node)
    if axis is None:
        return False
    if getattr(node, "dest", None) == name:
        return isinstance(node, _ALIGNED_DEST_NODES) and \
            leading_key_var(node) == axis
    return name in aligned_reads(node, axis)


def demotable_dests(nodes, prog: Program) -> dict:
    """Dense arrays whose EVERY plan use is placement-neutral (unaligned
    reduce destination or cross-shard read): the distributed runtime may
    freely demote them to REP when op_select.choose_reduce_dest says a
    sharded destination doesn't pay for their size (DESIGN.md §8) —
    demotion never forfeits an aligned round and never changes results
    (REP is the lattice ⊥, correct everywhere).  Returns {name: ⊕} — the
    monoid of a reduce writing the array ("+" when it is only read), so
    the placement decision is keyed on the real exchange it replaces."""
    dense = dense_arrays(prog)
    keep: set = set()
    ops: dict = {}
    for n in _all_nodes(nodes):
        if isinstance(n, P.SeqLoop):
            continue
        touched = set(gathers_of(n)) | {getattr(n, "dest", None)}
        if getattr(n, "dest", None) in dense and hasattr(n, "op"):
            ops.setdefault(n.dest, n.op)
        for name in touched & dense:
            if _benefits_from_sharding(n, name):
                keep.add(name)
    return {name: ops.get(name, "+") for name in dense - keep}


def _dest_cap(node) -> Optional[Dist]:
    """Best distribution the distributed executor can PRODUCE for this
    node's destination; None when the destination is a scalar."""
    if isinstance(node, P.Rebalance):
        return Dist.ONED_ROW          # the round's whole point: balance
    if isinstance(node, P.ScalarReduce):
        if node.point is None:
            return None               # scalar destination
        return Dist.ONED_ROW if node.space.has_bag else Dist.REP
    if isinstance(node, P.SegmentReduce):
        # computed keys: partial-⊕ + psum_scatter works only when the bag
        # drives the round; range-driven segment writes run replicated
        return Dist.ONED_ROW if node.space.has_bag else Dist.REP
    if isinstance(node, (P.AxisReduce, P.EinsumContract, P.TiledMatmul)):
        if node.space.has_bag:
            ra = round_axis(node)
            if ra is not None and ra == leading_key_var(node):
                # dest rows walk the bag itself (e.g. a per-point min):
                # live row counts are data-dependent → variable blocks
                return Dist.ONED_VAR
            return Dist.ONED_ROW      # unaligned partial + psum_scatter
        return Dist.ONED_ROW if round_axis(node) is not None else Dist.REP
    if isinstance(node, (P.MapExpr, P.Scatter)):
        if isinstance(node, P.MapExpr) and node.key_axes is None:
            return None               # guarded scalar assignment
        ra = round_axis(node)
        if ra is not None and ra == leading_key_var(node):
            # aligned store round, rows stay local.  A bag-driven or
            # filtered write leaves DATA-DEPENDENT live row counts per
            # shard (HPAT's OneD_Var): the physical blocks stay equal but
            # the logical lengths vary, so the best the executor can
            # claim is ONED_VAR; _rebalance later decides whether a
            # reader needs the blocks rebalanced up to ONED_ROW.
            bagvars = {a.var for a in node.space.axes if a.kind == "bag"}
            if ra in bagvars or node.space.conds:
                return Dist.ONED_VAR
            return Dist.ONED_ROW
        return Dist.REP               # scattered writes cross shards
    return Dist.REP


def _matmul_operands(node) -> frozenset:
    """Gather arrays eligible to stay TWOD_BLOCK: the two rank-2 factors of
    a matmul-shaped contraction (the pass_tiled_fusion shape)."""
    if isinstance(node, P.TiledMatmul):
        node = node.contract
    if not (isinstance(node, P.EinsumContract) and node.product is not None):
        return frozenset()
    fa = node.product.factor_axes
    if len(fa) == 2 and len(fa[0]) == 2 and len(fa[1]) == 2 \
            and fa[0][1] == fa[1][0] \
            and tuple(node.key_axes) == (fa[0][0], fa[1][1]):
        return frozenset(f.array for f in node.product.factors)
    return frozenset()


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------

def _rebalance_targets(nodes) -> frozenset:
    """Arrays that, were they left at ONED_VAR, would break or degrade a
    consumer: contraction-certified readers slice factors by GLOBAL
    offsets (shard_slice_certificates assumes equal live blocks), and
    SeqLoop-touched state is re-read every iteration (a skewed block
    compounds across rounds).  Everything else — element-wise readers
    walking the producing axis, computed-key gathers — tolerates variable
    blocks and lets the array keep ONED_VAR."""
    out: set = set()
    for n in leaf_nodes(nodes):
        groups = _contract_groups(n)
        if groups:
            for factors, _axes in groups:
                out.update(f.array for f in factors)
    for n in _all_nodes(nodes):
        if isinstance(n, P.SeqLoop):
            for m in leaf_nodes(n.body):
                out.update(gathers_of(m))
                d = getattr(m, "dest", None)
                if d is not None:
                    out.add(d)
    return frozenset(out)


def analyze(nodes: list, prog: Program, config=None,
            rebalance_out: Optional[dict] = None) -> dict:
    """Infer array distributions by fixed-point meet; annotate every leaf
    node with its `shardings` dict and return {array: Dist}.

    When `rebalance_out` is given it is filled with the `_rebalance`
    decisions: {array: "inserted"} for ONED_VAR arrays pinned up to
    ONED_ROW (an explicit rebalance round must restore balanced blocks
    after their producer) and {array: "elided"} for arrays that keep
    variable blocks."""
    dense = dense_arrays(prog)
    if config is not None and not getattr(config, "infer_distributions", True):
        dists = {a: Dist.REP for a in dense}
        _annotate(nodes, dists)
        return dists

    pins: set = set()       # ONED_VAR arrays lifted to ONED_ROW by rebalance

    def run_base() -> dict:
        dists = {a: Dist.TWOD_BLOCK for a in dense}   # optimistic top

        def cap(name, d):
            if d == Dist.ONED_VAR and name in pins:
                d = Dist.ONED_ROW   # a rebalance round restores balance
            if name in dists and dists[name] > d:
                dists[name] = Dist(d)
                return True
            return False

        changed = True
        while changed:                # monotone descent, lattice height 3
            changed = False
            # sweep 1: write-side constraints (what each node can produce)
            for n in _all_nodes(nodes):
                if isinstance(n, P.SeqLoop):
                    acc: dict = {}
                    _walk_gathers(n.cond, acc)
                    for name in acc:      # cond is evaluated replicated
                        changed |= cap(name, Dist.REP)
                    continue
                dc = _dest_cap(n)
                if dc is not None and n.dest in dists:
                    changed |= cap(n.dest, dc)
            # sweep 2: read-side rebalance (TWOD only for matmul operands)
            for n in leaf_nodes(nodes):
                mm = _matmul_operands(n)
                for name in gathers_of(n):
                    if name not in mm:
                        changed |= cap(name, Dist.ONED_ROW)
                if getattr(n, "dest", None) in dists and n.dest not in mm:
                    changed |= cap(n.dest, Dist.ONED_ROW)
        return dists

    # HPAT's _rebalance_arrs idiom: run to fixed point, promote ONED_VAR
    # arrays whose consumers need balanced blocks, and re-run the whole
    # analysis with the pins until no new pin appears (each iteration can
    # only ADD pins, so this terminates in ≤ |dense| re-runs).
    # skew_rebalance=False disables promotion entirely: every ONED_VAR
    # array keeps variable blocks (the pad+mask fallback), and
    # pass_distribution then inserts no Rebalance nodes.
    needs = _rebalance_targets(nodes) \
        if config is None or getattr(config, "skew_rebalance", True) \
        else frozenset()
    while True:
        dists = run_base()
        promote = {a for a, d in dists.items()
                   if d == Dist.ONED_VAR and a in needs} - pins
        if not promote:
            break
        pins |= promote
    if rebalance_out is not None:
        for a in sorted(pins):
            if dists[a] >= Dist.ONED_ROW:   # still sharded after the pin
                rebalance_out[a] = "inserted"
        for a in sorted(a for a, d in dists.items() if d == Dist.ONED_VAR):
            rebalance_out[a] = "elided"

    _annotate(nodes, dists)
    return dists


def _all_nodes(nodes):
    """Leaf nodes plus the SeqLoop containers themselves."""
    for n in nodes:
        if isinstance(n, P.SeqLoop):
            yield n
            yield from _all_nodes(n.body)
        elif isinstance(n, P.FusedRound):
            yield from _all_nodes(n.parts)
        elif isinstance(n, P.Fused):
            yield from n.parts
        else:
            yield n


def _annotate(nodes, dists: dict):
    for n in leaf_nodes(nodes):
        sh: dict = {}
        axis = round_axis(n)
        dest = getattr(n, "dest", None)
        if dest in dists:
            lead = leading_key_var(n)
            sh[dest] = Sharding(dists[dest],
                                lead if lead == axis and
                                dists[dest] >= Dist.ONED_VAR else None)
        ar = aligned_reads(n, axis) if axis else frozenset()
        for name in sorted(gathers_of(n)):
            if name in dists and name != dest:
                sh[name] = Sharding(dists[name],
                                    axis if name in ar and
                                    dists[name] >= Dist.ONED_VAR else None)
        n.shardings = sh
        if isinstance(n, P.TiledMatmul):
            n.contract.shardings = sh   # explain() shows the dense-lhs form


def collect(nodes) -> dict:
    """Program-level {array: Dist} from node annotations (analyze() wrote a
    single consistent value per array, so any occurrence is the answer)."""
    out: dict = {}
    for n in leaf_nodes(nodes):
        for name, sh in (getattr(n, "shardings", None) or {}).items():
            out[name] = sh.dist
    return out
