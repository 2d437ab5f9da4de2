"""Dependence analysis and parallelization restrictions (paper §3.2,
Definition 3.1).

For every statement in a for-loop nest we compute readers R[s], writers
W[s] and aggregators A[s] (L-values), the context (enclosing loop indexes)
and affinity of destinations, then check:

  1. every non-incremental update destination is affine (different location
     at each iteration, covering all loop indexes in context);
  2. no (writer|aggregator, reader) overlap, except
     (a) same L-value, writer precedes (or equals) the reader statement;
     (b) aggregate-then-read of the same L-value, read destination affine,
         and context(s1) ∩ context(s2) == indexes(d1).

Two hardenings beyond the paper's letter (gaps in Def. 3.1 that break
Theorem 3.1; documented in DESIGN.md):
  * overlapping aggregator destinations must use the SAME ⊕ monoid;
  * write/aggregate overlap on one array is only allowed in the matmul
    shape: identical L-value, writer first, writer affine, and
    context(writer) ∩ context(agg) == indexes(d).

For-loops containing while-loops: the paper sequentializes them; we reject
with a diagnostic (none of the paper's benchmarks need it).

Scope note: this module decides WHETHER a loop parallelizes (AST-level,
reject-or-accept).  The complementary question of WHERE each array lives
on a device mesh — replicated or partitioned — is answered later, over
the finished physical plan, by dist_analysis.py (DESIGN.md §6); that
analysis never rejects, it only meets distributions down to REP.
"""
from __future__ import annotations

from dataclasses import dataclass

from .loop_ast import (Assign, BinOp, Call, Const, Dest, DIndex, DVar, Expr,
                       ForIn, ForRange, If, IncUpdate, Index, Program,
                       RejectionError, Stmt, UnOp, Var, While)


# ---------------------------------------------------------------------------
# expression helpers
# ---------------------------------------------------------------------------

def expr_reads(e: Expr, acc: list):
    """Collect read L-values: array accesses and scalar variables."""
    if isinstance(e, Index):
        acc.append(("arr", e.array, e.idxs))
        for i in e.idxs:
            expr_reads(i, acc)
    elif isinstance(e, Var):
        acc.append(("var", e.name, ()))
    elif isinstance(e, BinOp):
        expr_reads(e.lhs, acc)
        expr_reads(e.rhs, acc)
    elif isinstance(e, UnOp):
        expr_reads(e.e, acc)
    elif isinstance(e, Call):
        for a in e.args:
            expr_reads(a, acc)


def expr_vars(e: Expr) -> set[str]:
    acc: set[str] = set()

    def go(x):
        if isinstance(x, Var):
            acc.add(x.name)
        elif isinstance(x, Index):
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
    return acc


def is_affine_expr(e: Expr, affine_vars: set[str]) -> bool:
    """c0 + c1*i1 + ... over loop-index vars (paper's affine expressions)."""
    if isinstance(e, Const):
        return isinstance(e.value, (int, float))
    if isinstance(e, Var):
        return e.name in affine_vars
    if isinstance(e, UnOp) and e.op == "neg":
        return is_affine_expr(e.e, affine_vars)
    if isinstance(e, BinOp):
        if e.op in ("+", "-"):
            return is_affine_expr(e.lhs, affine_vars) and \
                is_affine_expr(e.rhs, affine_vars)
        if e.op == "*":
            lc = isinstance(e.lhs, Const)
            rc = isinstance(e.rhs, Const)
            return (lc and is_affine_expr(e.rhs, affine_vars)) or \
                   (rc and is_affine_expr(e.lhs, affine_vars))
    return False


def dest_key(d: Dest):
    return d.name if isinstance(d, DVar) else d.array


def dest_equal(d1: Dest, d2) -> bool:
    """Syntactic equality between a destination and a read L-value tuple."""
    if isinstance(d1, DVar):
        return d2[0] == "var" and d2[1] == d1.name
    return d2[0] == "arr" and d2[1] == d1.array and d2[2] == d1.idxs


@dataclass
class UpdateInfo:
    stmt: Stmt
    order: int
    context: tuple[str, ...]       # enclosing loop index tokens
    affine_vars: set[str]          # loop index vars usable in affine exprs
    reads: list                    # [(kind, name, idxs)]


def _collect(stmts, ctx, affine_vars, out, order, loop_id=[0]):
    for s in stmts:
        if isinstance(s, (Assign, IncUpdate)):
            reads: list = []
            expr_reads(s.value, reads)
            if isinstance(s.dest, DIndex):
                for i in s.dest.idxs:
                    expr_reads(i, reads)
            out.append(UpdateInfo(s, order[0], ctx, set(affine_vars), reads))
            order[0] += 1
        elif isinstance(s, ForRange):
            _collect(s.body, ctx + (s.var,), affine_vars | {s.var}, out, order)
        elif isinstance(s, ForIn):
            loop_id[0] += 1
            idx = s.pats[0] if s.with_index else f"$i{loop_id[0]}"
            val_pats = s.pats[1:] if s.with_index else s.pats
            # value pattern vars are NOT affine indexes (non-injective)
            _collect(s.body, ctx + (idx,), affine_vars | {idx}, out, order)
        elif isinstance(s, If):
            # condition reads participate as readers of a pseudo-statement
            reads = []
            expr_reads(s.cond, reads)
            out.append(UpdateInfo(s, order[0], ctx, set(affine_vars), reads))
            order[0] += 1
            _collect(s.then, ctx, affine_vars, out, order)
            _collect(s.els, ctx, affine_vars, out, order)
        elif isinstance(s, While):
            raise RejectionError(
                "while-loop inside a for-loop: the paper sequentializes this "
                "case; unsupported here (rejected)")


def _affine_dest(d: Dest, u: UpdateInfo) -> bool:
    if isinstance(d, DVar):
        return len(u.context) == 0
    if not all(is_affine_expr(i, u.affine_vars) for i in d.idxs):
        return False
    used = set()
    for i in d.idxs:
        used |= expr_vars(i) & u.affine_vars
    return set(u.context) <= used


def _indexes(d: Dest, u: UpdateInfo) -> set[str]:
    if isinstance(d, DVar):
        return set()
    used = set()
    for i in d.idxs:
        used |= expr_vars(i) & set(u.context)
    return used


def check_loop(loop: Stmt):
    """Check Def. 3.1 for one outermost for-loop."""
    out: list[UpdateInfo] = []
    if isinstance(loop, ForRange):
        _collect(loop.body, (loop.var,), {loop.var}, out, [0])
    else:
        assert isinstance(loop, ForIn)
        idx = loop.pats[0] if loop.with_index else "$i0"
        _collect(loop.body, (idx,), {idx}, out, [0])

    updates = [u for u in out if isinstance(u.stmt, (Assign, IncUpdate))]

    # Restriction 1: non-incremental destinations must be affine
    for u in updates:
        if isinstance(u.stmt, Assign) and not _affine_dest(u.stmt.dest, u):
            raise RejectionError(
                f"non-affine destination in '{type(u.stmt).__name__}' of "
                f"{dest_key(u.stmt.dest)}: destination must be a distinct "
                f"location covering loop indexes {u.context} "
                f"(paper §3.2 Restriction 1)")

    # Restriction 2 with exceptions (a), (b)
    for u1 in updates:
        d1 = u1.stmt.dest
        is_agg = isinstance(u1.stmt, IncUpdate)
        for u2 in out:
            for r in u2.reads:
                if r[1] != dest_key(d1):
                    continue
                if (r[0] == "var") != isinstance(d1, DVar):
                    continue
                # overlap found: try exceptions
                if not is_agg:
                    # (a): same L-value, write precedes (or is) the read
                    if dest_equal(d1, r) and u1.order <= u2.order:
                        continue
                else:
                    # (b): aggregate-then-read same L-value, read dest
                    # affine, context(s1) ∩ context(s2) == indexes(d1)
                    rd = DVar(r[1]) if r[0] == "var" else DIndex(r[1], r[2])
                    if dest_equal(d1, r) and u1.order < u2.order and \
                            _affine_dest(rd, u2) and \
                            set(u1.context) & set(u2.context) == \
                            _indexes(d1, u1):
                        continue
                raise RejectionError(
                    f"recurrence: '{dest_key(d1)}' is "
                    f"{'aggregated' if is_agg else 'written'} and read in "
                    f"the same loop without a Def-3.1 exception "
                    f"(paper §3.2 Restriction 2)")

    # Hardening 1: overlapping aggregator destinations need one monoid
    ops: dict[str, set[str]] = {}
    for u in updates:
        if isinstance(u.stmt, IncUpdate):
            ops.setdefault(dest_key(u.stmt.dest), set()).add(u.stmt.op)
    for name, s in ops.items():
        if len(s) > 1:
            raise RejectionError(
                f"mixed ⊕ monoids {sorted(s)} aggregate into '{name}' in one "
                f"loop — loop splitting would reorder them (hardening of "
                f"Def. 3.1, see DESIGN.md)")

    # Hardening 3: two writers into one array must use IDENTICAL index
    # expressions.  The paper's Def. 3.1 only restricts (writer, reader)
    # pairs; `for i {D[i]:=i; D[i+1]:=i}` passes its letter but loop
    # splitting changes the result (found by hypothesis fuzzing — see
    # EXPERIMENTS.md §Paper-gaps).
    writers: dict[str, list[UpdateInfo]] = {}
    for u in updates:
        if isinstance(u.stmt, Assign) and isinstance(u.stmt.dest, DIndex):
            writers.setdefault(u.stmt.dest.array, []).append(u)
    for name, us in writers.items():
        idxs = {u.stmt.dest.idxs for u in us}
        if len(idxs) > 1:
            raise RejectionError(
                f"two non-incremental writes into '{name}' with different "
                f"index maps in one loop — loop splitting would reorder "
                f"them (hardening 3 of Def. 3.1, see DESIGN.md)")

    # Hardening 2: write/aggregate overlap only in the matmul shape
    for u1 in updates:
        if not isinstance(u1.stmt, Assign):
            continue
        d1 = u1.stmt.dest
        for u2 in updates:
            if not isinstance(u2.stmt, IncUpdate):
                continue
            d2 = u2.stmt.dest
            if dest_key(d1) != dest_key(d2):
                continue
            ok = (isinstance(d1, DIndex) == isinstance(d2, DIndex)
                  and u1.order < u2.order
                  and _affine_dest(d1, u1)
                  and set(u1.context) & set(u2.context) == _indexes(d1, u1)
                  and (isinstance(d1, DVar) or d1.idxs == d2.idxs))
            if not ok:
                raise RejectionError(
                    f"write+aggregate of '{dest_key(d1)}' in one loop outside "
                    f"the init-then-accumulate shape (hardening of Def. 3.1)")


def check(prog: Program):
    """Check all outermost for-loops of the program (statements outside
    loops are sequential glue and always fine)."""
    def walk(stmts):
        for s in stmts:
            if isinstance(s, (ForRange, ForIn)):
                check_loop(s)
            elif isinstance(s, While):
                walk(s.body)
            elif isinstance(s, If):
                walk(s.then)
                walk(s.els)
    walk(prog.body)
    return True
