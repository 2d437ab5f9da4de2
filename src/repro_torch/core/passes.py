"""Optimizer pass pipeline: target comprehensions → physical plan.

Every *recognition* decision the compiler makes lives here, as an ordered
sequence of passes over plan nodes (lower.py only materializes the chosen
operators, with runtime extent/representation guards).  The ordering is a
contract (see DESIGN.md):

  1. iteration-spaces           comprehension qualifiers → IterSpace; every
                                statement gets its naive physical operator
                                (the paper-faithful plan)
  2. identity-traversal         Get reads whose indices are distinct
                                generator-axis vars → broadcast-eligible
                                Gather (no gather when extents cover)
  3. axis-key-classification    group-by keys that are pure axis vars →
                                AxisReduce (Rule 17 generalized); constant
                                keys → ScalarReduce at a point (Rule 16)
  4. dense-fastpath             operator *specialization*, never an operator
                                change: identity-space MapExpr → DenseMap
                                (vectorized store, no index grids/gathers);
                                +-AxisReduce of a product of gathers gets an
                                MXU `product` certificate (executed via
                                jnp.einsum even in the paper-faithful
                                configuration); gather-free ScalarReduce
                                marked `dense` (pure columnar fold)
  5. einsum-recognition         +-AxisReduce of a product of gathers (or a
                                ±-sum of products) → EinsumContract
                                (beyond-paper MXU contraction)
  6. tiled-fusion               matmul-shaped EinsumContract → TiledMatmul
                                (§5: block-sparse Pallas kernel on packed
                                lhs, no unpack)
  7. dead-store-elimination     a store fully overwritten by a later
                                equal-coverage unconditional store, with no
                                intervening reader, is dropped
  8. update-fusion              consecutive reductions sharing an iteration
                                space and touching disjoint state → Fused
                                (one distributed collective round)
  9. distribution-analysis      fixed-point inference of a per-array
                                sharding (REP ≤ ONED_ROW ≤ TWOD_BLOCK) over
                                the finished plan; annotation-only
                                (dist_analysis.py, DESIGN.md §6)
 10. operator-selection         backend CANDIDATE sets on SegmentReduce
                                (scatter / sort / onehot / pallas) and the
                                contraction nodes; the concrete choice is
                                resolved at trace time by the cost-model /
                                autotune selector (op_select.py, DESIGN.md
                                §8); annotation-only
 11. round-fusion               adjacent shard-mappable nodes → FusedRound
                                regions (one shard_map program per region,
                                collectives inside; a fully-fusable SeqLoop
                                body becomes the on-device-loop candidate);
                                sequencing-only — the single-device
                                executor runs members unchanged (DESIGN.md
                                §9)

Passes 2-6 must run in this order: classification consumes rewritten reads,
dense-fastpath recognizes products on AxisReduce nodes from 3, einsum
promotes that recognition to EinsumContract nodes, tiled-fusion consumes
EinsumContract nodes.  Passes 7-8 are cleanups over the final operator
choice and must run last among the transforms (fusion would otherwise hide
stores from the deadness scan).  Passes 9-11 transform nothing — they must
see the FINAL operator choices (a Fused round places all its parts, an
eliminated store constrains nothing), so they run after everything else;
10 follows 9 because a backend's shape class includes the destination's
inferred sharding, and 11 follows both because a region groups nodes whose
round classification (placements included) is already final.
"""
from __future__ import annotations

from dataclasses import dataclass

from . import plan as P
from .comprehension import (BagGen, BulkStore, BulkUpdate, Cond, Get,
                            RangeGen, ScalarAgg, ScalarAssign, SeqWhile)
from .loop_ast import (BinOp, Call, Const, Index, Program, RejectionError,
                       UnOp, Var)


@dataclass(frozen=True)
class PlanConfig:
    optimize_contractions: bool = True   # False = paper-faithful plans
    use_kernels: bool = False            # legacy: force the Pallas segment
    #                                      kernel (= op_select "force:pallas")
    infer_distributions: bool = True     # False = REP-everything annotations
    dense_fastpath: bool = True          # False = no executor specialization
    op_select: str = "cost"              # "cost" | "autotune" | "force:<b>"
    autotune_cache: str = ".repro_autotune.json"   # on-disk decision cache
    round_fusion: bool = True            # False = one shard_map per node
    skew_rebalance: bool = True          # False = never pin ONED_VAR up /
    #                                      insert Rebalance rounds (fallback:
    #                                      arrays keep variable blocks)
    skew_salting: str = "auto"           # hot-key salting for group-bys:
    #                                      "auto" (cost model + runtime
    #                                      probe) | "off" | "force:<S>"
    #                                      (static hint: S sub-keys per key)
    out_of_core: str = "auto"            # chunked capacity tier (§12):
    #                                      "auto" (admit vs budget + descend
    #                                      on capacity) | "force" | "off"
    memory_budget: int | None = None     # device bytes the admission check
    #                                      holds a call's memest peak under
    chunk_rows: int | None = None        # pinned streaming tile; None =
    #                                      derive from budget (memest)
    lineage: bool = True                 # False = no RoundLineage recipes:
    #                                      shard loss descends the ladder
    #                                      instead of recovering surgically
    speculative: bool = True             # False = straggler watchdog stays
    #                                      log-only (no backup executions)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _space_of(quals) -> P.IterSpace:
    axes, conds = [], []
    for q in quals:
        if isinstance(q, RangeGen):
            axes.append(P.AxisSpec("range", q.var, lo=q.lo, hi=q.hi))
        elif isinstance(q, BagGen):
            axes.append(P.AxisSpec("bag", q.idx, bag=q.bag, vals=q.vals))
        else:
            conds.append(q.e)
    return P.IterSpace(tuple(axes), tuple(conds))


def _expr_names(e, acc: set):
    if isinstance(e, (Get, P.Gather, Index)):
        acc.add(e.array)
        for i in e.idxs:
            _expr_names(i, acc)
    elif isinstance(e, Var):
        acc.add(e.name)
    elif isinstance(e, BinOp):
        _expr_names(e.lhs, acc)
        _expr_names(e.rhs, acc)
    elif isinstance(e, UnOp):
        _expr_names(e.e, acc)
    elif isinstance(e, Call):
        for a in e.args:
            _expr_names(a, acc)


def _refs_of(st, prog: Program) -> frozenset:
    """Env names a statement reads (params/outputs only; loop vars shadow)."""
    names: set = set()
    bound: set = set()
    for q in getattr(st, "quals", []):
        if isinstance(q, BagGen):
            names.add(q.bag)
            bound |= set(q.vals) | {q.idx}
        elif isinstance(q, RangeGen):
            _expr_names(q.lo, names)
            _expr_names(q.hi, names)
            bound.add(q.var)
        else:
            _expr_names(q.e, names)
    if hasattr(st, "value"):
        _expr_names(st.value, names)
    for k in getattr(st, "keys", ()):
        _expr_names(k, names)
    names -= bound
    return frozenset(n for n in names
                     if n in prog.params or n in prog.outputs)


def _axis_keys(keys, space: P.IterSpace):
    """Keys that are distinct pure generator-axis vars, else None."""
    axis_vars = set(space.axis_vars)
    names = []
    for k in keys:
        if isinstance(k, Var) and k.name in axis_vars:
            names.append(k.name)
        else:
            return None
    return names if len(set(names)) == len(names) else None


def _var_axis_map(space: P.IterSpace) -> dict:
    """var → axis name, for axis vars and bag value-column vars."""
    m = {}
    for a in space.axes:
        m[a.var] = a.var
        for v in a.vals:
            m[v] = a.var
    return m


def _axes_used(e, space: P.IterSpace) -> set:
    va = _var_axis_map(space)
    used: set = set()

    def go(x):
        if isinstance(x, Var):
            if x.name in va:
                used.add(va[x.name])
        elif isinstance(x, (Get, P.Gather)):
            for i in x.idxs:
                go(i)
        elif isinstance(x, BinOp):
            go(x.lhs)
            go(x.rhs)
        elif isinstance(x, UnOp):
            go(x.e)
        elif isinstance(x, Call):
            for a in x.args:
                go(a)
    go(e)
    return used


def _transform_blocks(nodes: list, block_fn) -> list:
    """Apply a statement-block transform to the top level and every SeqLoop
    body (fusion/deadness never cross a sequential-loop boundary)."""
    out = block_fn(nodes)
    for n in out:
        if isinstance(n, P.SeqLoop):
            n.body = _transform_blocks(n.body, block_fn)
    return out


def _map_nodes(nodes: list, node_fn) -> list:
    out = []
    for n in nodes:
        if isinstance(n, P.SeqLoop):
            n.body = _map_nodes(n.body, node_fn)
            out.append(node_fn(n))
        else:
            out.append(node_fn(n))
    return out


# ---------------------------------------------------------------------------
# pass 1: iteration-space construction (naive / paper-faithful operators)
# ---------------------------------------------------------------------------

def build_spaces(target: list, prog: Program) -> list:
    nodes = []
    for st in target:
        if isinstance(st, BulkUpdate):
            nodes.append(P.SegmentReduce(
                st, _space_of(st.quals), _refs_of(st, prog),
                st.dest, tuple(st.keys), st.op, st.value))
        elif isinstance(st, BulkStore):
            nodes.append(P.Scatter(
                st, _space_of(st.quals), _refs_of(st, prog),
                st.dest, tuple(st.keys), st.value))
        elif isinstance(st, ScalarAgg):
            nodes.append(P.ScalarReduce(
                st, _space_of(st.quals), _refs_of(st, prog),
                st.dest, st.op, st.value))
        elif isinstance(st, ScalarAssign):
            nodes.append(P.MapExpr(
                st, _space_of(st.quals), _refs_of(st, prog),
                st.dest, st.value, key_axes=None))
        elif isinstance(st, SeqWhile):
            body = build_spaces(st.body, prog)
            carry: list = []
            for b in body:
                for d in P.dests_of(b):
                    if d not in carry:
                        carry.append(d)
            reads: set = set()
            _expr_names(st.cond, reads)
            reads = {n for n in reads if n in prog.params or n in prog.outputs}
            for b in body:
                reads |= b.reads
            nodes.append(P.SeqLoop(st, P.IterSpace(()), frozenset(reads),
                                   st.cond, body, tuple(carry)))
        else:
            raise RejectionError(f"cannot plan statement {st}")
    return nodes


# ---------------------------------------------------------------------------
# pass 2: identity-traversal elimination (physical reads)
# ---------------------------------------------------------------------------

def _rewrite_reads(e, axis_vars: frozenset):
    if isinstance(e, (Get, P.Gather)):
        idxs = tuple(_rewrite_reads(i, axis_vars) for i in e.idxs)
        names = [i.name for i in idxs if isinstance(i, Var)]
        ok = (len(names) == len(idxs) and len(set(names)) == len(names)
              and all(n in axis_vars for n in names))
        return P.Gather(e.array, idxs, broadcast_ok=ok)
    if isinstance(e, BinOp):
        return BinOp(e.op, _rewrite_reads(e.lhs, axis_vars),
                     _rewrite_reads(e.rhs, axis_vars))
    if isinstance(e, UnOp):
        return UnOp(e.op, _rewrite_reads(e.e, axis_vars))
    if isinstance(e, Call):
        return Call(e.fn, tuple(_rewrite_reads(a, axis_vars) for a in e.args))
    return e


def pass_identity_traversal(nodes: list, prog, config) -> list:
    def fix(n):
        av = frozenset(n.space.axis_vars)
        n.space = P.IterSpace(
            n.space.axes, tuple(_rewrite_reads(c, av) for c in n.space.conds))
        if hasattr(n, "value"):
            n.value = _rewrite_reads(n.value, av)
        if hasattr(n, "keys"):
            n.keys = tuple(_rewrite_reads(k, av) for k in n.keys)
        if isinstance(n, P.SeqLoop):
            n.cond = _rewrite_reads(n.cond, frozenset())
        return n
    return _map_nodes(nodes, fix)


# ---------------------------------------------------------------------------
# pass 3: axis-key classification (Rules 16/17)
# ---------------------------------------------------------------------------

def _bool_any(node: P.ScalarReduce):
    """max/min over float(bool) lowers to any/all — record the peephole."""
    v = node.value
    if node.op in ("max", "min") and isinstance(v, Call) and \
            v.fn == "float" and not node.space.conds:
        return v.args[0]
    return None


def pass_classify_keys(nodes: list, prog, config) -> list:
    def fix(n):
        if isinstance(n, P.SegmentReduce):
            if n.keys and all(isinstance(k, Const) for k in n.keys):
                sr = P.ScalarReduce(n.stmt, n.space, n.reads, n.dest, n.op,
                                    n.value,
                                    point=tuple(int(k.value) for k in n.keys))
                sr.bool_any = _bool_any(sr)
                return sr
            ka = _axis_keys(n.keys, n.space)
            if ka is not None:
                return P.AxisReduce(n.stmt, n.space, n.reads, n.dest,
                                    tuple(ka), n.op, n.value)
            return n      # backend chosen by pass 10 (operator-selection)
        if isinstance(n, P.Scatter):
            ka = _axis_keys(n.keys, n.space)
            if ka is not None and set(ka) == set(n.space.axis_vars):
                return P.MapExpr(n.stmt, n.space, n.reads, n.dest, n.value,
                                 key_axes=tuple(ka))
            return n
        if isinstance(n, P.ScalarReduce):
            n.bool_any = _bool_any(n)
        return n
    return _map_nodes(nodes, fix)


# ---------------------------------------------------------------------------
# pass 4: dense fast-path operator specialization
# ---------------------------------------------------------------------------

def _static_zero_lo(e) -> bool:
    return isinstance(e, Const) and e.value == 0


def _identity_gather(g, key_axes) -> bool:
    return (len(g.idxs) == len(key_axes)
            and all(isinstance(ix, Var) and ix.name == a
                    for ix, a in zip(g.idxs, key_axes)))


def _dense_value_ok(e, key_axes, axis_vars: set) -> bool:
    """Evaluating `e` over the identity space needs no index grids: every
    array read is an identity gather (indexed by exactly the key axes, in
    order) and no bare axis var appears outside gather indices."""
    if isinstance(e, (Get, P.Gather)):
        return _identity_gather(e, key_axes)
    if isinstance(e, Var):
        return e.name not in axis_vars
    if isinstance(e, Const):
        return True
    if isinstance(e, BinOp):
        return (_dense_value_ok(e.lhs, key_axes, axis_vars)
                and _dense_value_ok(e.rhs, key_axes, axis_vars))
    if isinstance(e, UnOp):
        return _dense_value_ok(e.e, key_axes, axis_vars)
    if isinstance(e, Call):
        return all(_dense_value_ok(a, key_axes, axis_vars) for a in e.args)
    return False


def pass_dense_fastpath(nodes: list, prog, config) -> list:
    """Operator *specialization* (not a plan-level operator change):

    * MapExpr whose iteration space provably equals its write space — all
      0-based range axes, key order = axis order, no conditions, identity
      gathers only — becomes `DenseMap`: the executor emits one vectorized
      jnp expression with no index grids, masks or scatters (runtime
      extent mismatch falls back to the general MapExpr path).
    * +-AxisReduce whose value is a product of axis-indexed gathers gets a
      `product` MXU certificate: the executor contracts via jnp.einsum
      instead of materializing the dense iteration grid.  The node itself
      is unchanged — this is how the paper-faithful configuration
      (optimize_contractions=False) keeps native-BLAS inner loops without
      changing its operator choices.
    * ScalarReduce whose value/conditions contain no array reads is marked
      `dense` (pure columnar fold — certifies that no gather or index grid
      is materialized for it).
    """
    if not config.dense_fastpath:
        return nodes

    def fix(n):
        if isinstance(n, P.AxisReduce) and n.op == "+" \
                and not n.space.conds and n.contracted:
            n.product = _product_factors(n.value, n.space, n.key_axes,
                                         n.contracted)
            return n
        if isinstance(n, P.ScalarReduce):
            n.dense = not (_has_gather(n.value)
                           or any(_has_gather(c) for c in n.space.conds))
            return n
        if type(n) is not P.MapExpr or n.key_axes is None:
            return n
        sp = n.space
        if sp.conds or not sp.axes:
            return n
        if any(a.kind != "range" or not _static_zero_lo(a.lo)
               for a in sp.axes):
            return n
        if n.key_axes != sp.axis_vars:
            return n
        if not _dense_value_ok(n.value, n.key_axes, set(sp.axis_vars)):
            return n
        return P.DenseMap(n.stmt, sp, n.reads, n.dest, n.value,
                          key_axes=n.key_axes)
    return _map_nodes(nodes, fix)


# ---------------------------------------------------------------------------
# pass 5: einsum recognition (beyond-paper contraction)
# ---------------------------------------------------------------------------

def _product_factors(value, space: P.IterSpace, key_axes, contracted,
                     require_all_keys: bool = True):
    """Static half of the contraction recognizer: value must be a product of
    axis-indexed gathers times axis-free scalars covering all axes."""
    axis_vars = set(space.axis_vars)
    bagvals = set(space.bagval_vars)
    factors: list = []
    others: list = []

    def flatten(e):
        if isinstance(e, BinOp) and e.op == "*":
            flatten(e.lhs)
            flatten(e.rhs)
        elif isinstance(e, P.Gather):
            factors.append(e)
        else:
            others.append(e)
    flatten(value)
    if not factors:
        return None
    factor_axes = []
    for f in factors:
        axs = []
        for ix in f.idxs:
            if not (isinstance(ix, Var) and ix.name in axis_vars):
                return None
            axs.append(ix.name)
        factor_axes.append(tuple(axs))
    for o in others:
        if isinstance(o, Const):
            continue
        if isinstance(o, Var) and o.name not in axis_vars \
                and o.name not in bagvals:
            continue
        return None
    used = {a for axs in factor_axes for a in axs}
    need = set(contracted) | (set(key_axes) if require_all_keys else set())
    if not need <= used:
        return None
    return P.EinsumFactors(tuple(factors), tuple(factor_axes), tuple(others))


def _term_split(node: P.AxisReduce, contracted):
    """value = s1*s2*(±Σ terms): axis-free scalar factors stripped, each
    product term einsum-recognized (terms free of the contracted axes reduce
    to extent-product × term at runtime)."""
    scalars: list = []
    value = node.value
    while isinstance(value, BinOp) and value.op == "*":
        if not _axes_used(value.lhs, node.space):
            scalars.append(value.lhs)
            value = value.rhs
        elif not _axes_used(value.rhs, node.space):
            scalars.append(value.rhs)
            value = value.lhs
        else:
            break
    terms: list = []

    def split(e, sign):
        if isinstance(e, BinOp) and e.op in ("+", "-"):
            split(e.lhs, sign)
            split(e.rhs, sign if e.op == "+" else -sign)
        elif isinstance(e, UnOp) and e.op == "neg":
            split(e.e, -sign)
        else:
            terms.append((sign, e))
    split(value, 1)
    if len(terms) < 2:
        return None
    entries = []
    for sign, term in terms:
        if not (_axes_used(term, node.space) & set(contracted)):
            # contraction-free term (Σ_j c = |j|·c): recognize its product
            # structure too when possible, so the per-shard executor can
            # slice operands instead of materializing a gather grid
            ef = _product_factors(term, node.space, node.key_axes, (),
                                  require_all_keys=False)
            entries.append((sign, term, ef, True))
        else:
            ef = _product_factors(term, node.space, node.key_axes, contracted)
            if ef is None:
                return None
            entries.append((sign, term, ef, False))
    return tuple(scalars), tuple(entries)


def pass_einsum(nodes: list, prog, config) -> list:
    if not config.optimize_contractions:
        return nodes

    def fix(n):
        if not isinstance(n, P.AxisReduce) or n.op != "+" or n.space.conds:
            return n
        contracted = n.contracted
        if not contracted:
            return n
        # dense-fastpath already recognized the product; promote it to a
        # plan-level EinsumContract (recognition happens once).  The
        # fallback grid drops its MXU certificate: the contract's own
        # einsum path subsumes it, and a failed guard must not re-fail.
        ef = n.product if n.product is not None else \
            _product_factors(n.value, n.space, n.key_axes, contracted)
        n.product = None
        if ef is not None:
            return P.EinsumContract(n.stmt, n.space, n.reads, n.dest,
                                    n.key_axes, product=ef, fallback=n)
        ts = _term_split(n, contracted)
        if ts is not None:
            scalars, entries = ts
            return P.EinsumContract(n.stmt, n.space, n.reads, n.dest,
                                    n.key_axes, scalars=scalars,
                                    terms=entries, fallback=n)
        return n
    return _map_nodes(nodes, fix)


# ---------------------------------------------------------------------------
# pass 6: §5 tiled-matmul fusion
# ---------------------------------------------------------------------------

def pass_tiled_fusion(nodes: list, prog, config) -> list:
    if not config.optimize_contractions:
        return nodes

    def fix(n):
        if not (isinstance(n, P.EinsumContract) and n.product is not None):
            return n
        fa = n.product.factor_axes
        if len(fa) == 2 and len(fa[0]) == 2 and len(fa[1]) == 2 \
                and fa[0][1] == fa[1][0] \
                and tuple(n.key_axes) == (fa[0][0], fa[1][1]):
            return P.TiledMatmul(n.stmt, n.space, n.reads, n.dest, contract=n)
        return n
    return _map_nodes(nodes, fix)


# ---------------------------------------------------------------------------
# pass 7: dead-store elimination
# ---------------------------------------------------------------------------

def _reads_name(node, name: str) -> bool:
    if name in node.reads:
        return True
    # reduce-type nodes implicitly read-modify-write their destinations
    if P.is_reduce(node) and name in P.dests_of(node):
        return True
    return isinstance(node, P.SeqLoop) and name in P.dests_of(node)


def _pure_store(n) -> bool:
    return isinstance(n, (P.MapExpr, P.Scatter))


def _has_gather(e) -> bool:
    if isinstance(e, (Get, P.Gather)):
        return True
    if isinstance(e, BinOp):
        return _has_gather(e.lhs) or _has_gather(e.rhs)
    if isinstance(e, UnOp):
        return _has_gather(e.e)
    if isinstance(e, Call):
        return any(_has_gather(a) for a in e.args)
    return False


def _same_coverage(killer, victim) -> bool:
    """killer unconditionally writes at least every key victim writes.
    The killer's VALUE must be gather-free: a gather whose index lands out
    of range drops that row at runtime (empty-bag semantics), so a store
    with gathers in its value may write fewer cells than the victim did."""
    # compare at the MapExpr/Scatter family level: DenseMap is a MapExpr
    # specialization with identical write coverage
    both_map = isinstance(killer, P.MapExpr) and isinstance(victim, P.MapExpr)
    both_scatter = isinstance(killer, P.Scatter) and \
        isinstance(victim, P.Scatter)
    if not (both_map or both_scatter) or killer.dest != victim.dest:
        return False
    if killer.space.axes != victim.space.axes or killer.space.conds:
        return False
    if _has_gather(killer.value):
        return False
    if both_map:
        return killer.key_axes == victim.key_axes
    return killer.keys == victim.keys


def pass_dead_stores(nodes: list, prog, config) -> list:
    def block(b):
        keep = []
        for i, n in enumerate(b):
            dead = False
            if _pure_store(n):
                for k in b[i + 1:]:
                    if _reads_name(k, n.dest):
                        break
                    if isinstance(k, P.SeqLoop):
                        break               # conservative: opaque region
                    if _pure_store(k) and _same_coverage(k, n):
                        dead = True
                        break
            if not dead:
                keep.append(n)
        return keep
    return _transform_blocks(nodes, block)


# ---------------------------------------------------------------------------
# pass 8: cross-statement update fusion
# ---------------------------------------------------------------------------

_FUSABLE = (P.SegmentReduce, P.AxisReduce, P.ScalarReduce)


def pass_fuse_updates(nodes: list, prog, config) -> list:
    def block(b):
        out: list = []
        i = 0
        while i < len(b):
            n = b[i]
            if not isinstance(n, _FUSABLE):
                out.append(n)
                i += 1
                continue
            group = [n]
            dests = {n.dest}
            reads = set(n.reads)
            j = i + 1
            while j < len(b):
                m = b[j]
                if not isinstance(m, _FUSABLE) or m.space != n.space:
                    break
                if m.dest in dests or m.dest in reads or (set(m.reads) & dests):
                    break
                group.append(m)
                dests.add(m.dest)
                reads |= m.reads
                j += 1
            if len(group) >= 2:
                out.append(P.Fused(None, n.space,
                                   frozenset(reads - dests), parts=group))
                i = j
            else:
                out.append(n)
                i += 1
        return out
    return _transform_blocks(nodes, block)


# ---------------------------------------------------------------------------
# pass 9: distribution analysis (annotation-only; see dist_analysis.py)
# ---------------------------------------------------------------------------

def pass_distribution(nodes: list, prog, config) -> list:
    from .dist_analysis import analyze
    rb: dict = {}
    analyze(nodes, prog, config, rebalance_out=rb)
    inserted = sorted(a for a, d in rb.items() if d == "inserted")
    if inserted and getattr(config, "skew_rebalance", True):
        # materialize the analysis' "insert an explicit rebalance"
        # decisions as plan nodes (one per pinned array, placed right
        # after its last producer), then re-annotate so the new nodes
        # carry shardings like every other leaf
        _insert_rebalances(nodes, set(inserted))
        analyze(nodes, prog, config)
    return nodes


def _insert_rebalances(nodes: list, arrays: set) -> None:
    """Insert a `P.Rebalance` after the LAST node writing each pinned array
    (in the block — top level or SeqLoop body — where that write lives), so
    every later reader sees balanced ONED_ROW blocks."""

    def last_writer(block):
        found = {}
        for i, n in enumerate(block):
            if isinstance(n, P.SeqLoop):
                last_writer(n.body)
                continue
            for d in P.dests_of(n):
                if d in arrays:
                    found[d] = (i, n)
        # insert in reverse index order so earlier positions stay valid
        for name, (i, n) in sorted(found.items(),
                                   key=lambda kv: -kv[1][0]):
            space = getattr(n, "space", P.IterSpace(()))
            block.insert(i + 1, P.Rebalance(None, space,
                                            frozenset({name}), name))
            arrays.discard(name)

    last_writer(nodes)


# ---------------------------------------------------------------------------
# pass 10: operator selection (annotation-only; see op_select.py)
# ---------------------------------------------------------------------------

def pass_select_backend(nodes: list, prog, config) -> list:
    """Attach the backend CANDIDATE SET to every node that has more than
    one correct materialization (SegmentReduce today; EinsumContract /
    TiledMatmul carry their guard chains as declared candidates).  The
    concrete choice is deferred to trace time (`backend="auto"`), when the
    selector (op_select.OpSelector — cost model or autotune cache) sees
    the concrete (N, K, D, dtype, dest-sharding) shape class.  Runs after
    distribution analysis because the shape class includes the
    destination's inferred sharding.  The legacy `use_kernels=True` flag
    (the pre-subsystem static choice) maps to pinning `pallas`; an
    `op_select="force:<backend>"` config pins that backend on every node
    whose candidate set contains it (tests / A-B benchmarks)."""
    forced = None
    if config.use_kernels:
        forced = "pallas"
    elif config.op_select.startswith("force:"):
        forced = config.op_select.split(":", 1)[1]
    # hot-key salting policy → static pin.  "auto" leaves salt=None: the
    # run-time probe (lower.collect_salts) decides per call from the
    # concrete key data.  "off" pins S=1 (disables probe and salting);
    # "force:<S>" pins S on every eligible node (the executor still
    # ignores the pin where salting is undefined: multi-key / non-1-D).
    salting = getattr(config, "skew_salting", "auto")
    salt_pin = None
    if salting == "off":
        salt_pin = 1
    elif salting.startswith("force:"):
        salt_pin = int(salting.split(":", 1)[1])

    def fix(n):
        if isinstance(n, P.Fused):
            # this pass runs AFTER update-fusion (it needs pass 9's
            # shardings), so it must reach the reduces inside Fused rounds
            n.parts = [fix(p) for p in n.parts]
            return n
        if isinstance(n, P.SegmentReduce):
            from .op_select import SEGMENT_CANDIDATES
            n.candidates = SEGMENT_CANDIDATES.get(n.op, ("scatter",))
            if forced is not None and forced in n.candidates:
                n.backend = forced
            else:
                n.backend = "auto"
            if salt_pin is not None:
                n.salt = salt_pin
            return n
        if isinstance(n, P.TiledMatmul):
            fix(n.contract)      # the dense-lhs resolution shares the pin
        if isinstance(n, (P.EinsumContract, P.TiledMatmul)) \
                and forced is not None and forced in n.candidates:
            n.candidates = (forced,)
        return n
    return _map_nodes(nodes, fix)


# ---------------------------------------------------------------------------
# pass 11: round fusion (distributed dispatch; see plan.FusedRound)
# ---------------------------------------------------------------------------

def _scalar_member(n) -> bool:
    """Nodes the distributed executor can run replicated inside a fused
    shard_map region: scalar assignments and scalar ⊕-aggregations (their
    reads are scalars / replicated values; bag-driven ScalarReduce instead
    classifies as an unaligned reduce with a psum exchange)."""
    if isinstance(n, P.ScalarReduce):
        return True
    return type(n) in (P.MapExpr, P.DenseMap) and n.key_axes is None


def _fusable_member(n) -> bool:
    """Static half of the fused-round compatibility check: can this node in
    principle run as one sub-round of a single shard_map program?  The
    runtime half (row counts, placements, TiledMatrix representations) is
    re-checked at round-build time in distributed.py; a failure there falls
    back to per-member rounds, never to an error."""
    from .dist_analysis import leading_key_var, round_axis
    if isinstance(n, P.SeqLoop):
        return False                     # loops fuse their own bodies
    if isinstance(n, P.Rebalance):
        return True                      # one collective sub-round
    if _scalar_member(n):
        return True
    if isinstance(n, P.Fused):
        return all(_fusable_member(p) for p in n.parts)
    if isinstance(n, (P.MapExpr, P.Scatter)):
        ax = round_axis(n)
        return ax is not None and leading_key_var(n) == ax
    if isinstance(n, P.SegmentReduce):
        return n.space.has_bag           # range-driven: no psum source
    if isinstance(n, (P.AxisReduce, P.EinsumContract, P.TiledMatmul)):
        return n.space.has_bag or round_axis(n) is not None
    return False


def pass_fuse_rounds(nodes: list, prog, config) -> list:
    """Group adjacent shard-mappable nodes into `FusedRound` regions so the
    distributed executor dispatches ONE shard_map program per region, with
    the collectives inside it.  A SeqLoop whose entire body is fusable gets
    its body wrapped in a single region — the precondition for running the
    loop as an on-device lax.while_loop (no per-iteration host sync).
    Annotation-level sequencing only: every member keeps its own operator,
    classification and candidate set, and the single-device executor runs
    the members exactly as if they were never grouped."""
    if not config.round_fusion:
        return nodes

    def region(group):
        reads: set = set()
        dests: set = set()
        for g in group:
            reads |= set(g.reads)
            dests.update(P.dests_of(g))
        return P.FusedRound(None, P.IterSpace(()),
                            frozenset(reads - dests), parts=group)

    def block(b):
        out: list = []
        group: list = []

        def flush():
            if len(group) >= 2:
                out.append(region(list(group)))
            else:
                out.extend(group)
            group.clear()

        for n in b:
            if _fusable_member(n):
                group.append(n)
            else:
                flush()
                out.append(n)
        flush()
        return out

    def fix_loops(ns):
        for n in ns:
            if isinstance(n, P.SeqLoop):
                fix_loops(n.body)
                if n.body and all(_fusable_member(x) for x in n.body):
                    # whole body in ONE region (even a single member): the
                    # on-device loop needs one shard_map program per body
                    n.body = [region(list(n.body))]
                else:
                    n.body = block(n.body)
        return ns

    return block(fix_loops(nodes))


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _pass_lineage(nodes, prog, config):
    """Pass 12 (round-lineage): annotate every round with its RoundLineage
    recovery recipe (core/lineage.py, DESIGN.md §13).  Runs last — a
    recipe names the FINAL round classification and placements.  Imported
    lazily to keep passes.py's module graph acyclic."""
    from .lineage import pass_lineage
    return pass_lineage(nodes, prog, config)


PIPELINE = (
    ("identity-traversal", pass_identity_traversal),
    ("axis-key-classification", pass_classify_keys),
    ("dense-fastpath", pass_dense_fastpath),
    ("einsum-recognition", pass_einsum),
    ("tiled-fusion", pass_tiled_fusion),
    ("dead-store-elimination", pass_dead_stores),
    ("update-fusion", pass_fuse_updates),
    ("distribution-analysis", pass_distribution),
    ("operator-selection", pass_select_backend),
    ("round-fusion", pass_fuse_rounds),
    ("round-lineage", _pass_lineage),
)


def plan_program(target: list, prog: Program,
                 config: PlanConfig = PlanConfig()) -> list:
    """Run the full pipeline: target comprehensions → physical plan."""
    nodes = build_spaces(target, prog)
    for _name, fn in PIPELINE:
        nodes = fn(nodes, prog, config)
    return nodes
