"""Monoid comprehension IR (paper §3.3) and target code (§3.8).

A target statement is either sequential glue (scalar assign, while, block)
or one of the three bulk comprehension forms produced by the Fig. 2 rules:

  BulkUpdate:  d := d ◁ {(k, w ⊕ (⊕/v)) | q̄, group by k}      (rule 15a)
  BulkStore:   d := d ◁ {(k, v) | q̄}                           (rule 15b)
  ScalarAgg:   v := v ⊕ (⊕/{e | q̄})                            (rule 16 applied)

Qualifier sources are already §3.6-optimized: dense-array accesses inside
expressions appear as `Get` (gather + implicit inRange guard), i.e. the
paper's `(i,v) ← V, i = e` join with a range generator is fused into an
indexed read — the limit case of loop-iteration elimination for dense
arrays (DESIGN.md §2).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from .loop_ast import Expr


# ---------------------------------------------------------------------------
# comprehension-level expressions: loop_ast.Expr plus Get (guarded gather)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Get(Expr):
    """{ v | (i̅, v) ← array, i̅ = idxs } for a dense array: a gather with an
    implicit inRange condition."""
    array: str
    idxs: tuple[Expr, ...]


# ---------------------------------------------------------------------------
# qualifiers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RangeGen:
    var: str
    lo: Expr
    hi: Expr            # exclusive


@dataclass(frozen=True)
class BagGen:
    """(idx, *vals) ← bag (struct-of-arrays source)."""
    idx: str
    vals: tuple[str, ...]
    bag: str


@dataclass(frozen=True)
class Cond:
    e: Expr


Qual = Any  # RangeGen | BagGen | Cond


# ---------------------------------------------------------------------------
# target statements
# ---------------------------------------------------------------------------

@dataclass
class BulkUpdate:
    """dest := dest ◁⊕ {(keys, ⊕/value) | quals, group by keys}."""
    dest: str
    keys: tuple[Expr, ...]
    op: str
    value: Expr
    quals: list = field(default_factory=list)


@dataclass
class BulkStore:
    """dest := dest ◁ {(keys, value) | quals} (affine keys: no duplicates)."""
    dest: str
    keys: tuple[Expr, ...]
    value: Expr
    quals: list = field(default_factory=list)


@dataclass
class ScalarAgg:
    """var := var ⊕ (⊕/{value | quals}) — rule 16 total aggregation."""
    dest: str
    op: str
    value: Expr
    quals: list = field(default_factory=list)


@dataclass
class ScalarAssign:
    dest: str
    value: Expr          # scalar expression over env (may contain Get)
    quals: list = field(default_factory=list)  # conds only (top-level if)


@dataclass
class SeqWhile:
    cond: Expr
    body: list = field(default_factory=list)


TargetStmt = Any


# ---------------------------------------------------------------------------
# pretty printer (paper-style comprehensions, for docs/tests)
# ---------------------------------------------------------------------------

def _pe(e: Expr) -> str:
    from .loop_ast import BinOp, Call, Const, Index, UnOp, Var
    if isinstance(e, Var):
        return e.name
    if isinstance(e, Const):
        return repr(e.value)
    if isinstance(e, Get):
        return f"{e.array}[{', '.join(_pe(i) for i in e.idxs)}]"
    if isinstance(e, Index):
        return f"{e.array}[{', '.join(_pe(i) for i in e.idxs)}]"
    if isinstance(e, BinOp):
        return f"({_pe(e.lhs)} {e.op} {_pe(e.rhs)})"
    if isinstance(e, UnOp):
        return f"({e.op} {_pe(e.e)})"
    if isinstance(e, Call):
        return f"{e.fn}({', '.join(_pe(a) for a in e.args)})"
    return str(e)


def _pq(q) -> str:
    if isinstance(q, RangeGen):
        return f"{q.var} ← range({_pe(q.lo)}, {_pe(q.hi)})"
    if isinstance(q, BagGen):
        pats = ", ".join((q.idx,) + q.vals)
        return f"({pats}) ← {q.bag}"
    return _pe(q.e)


def pretty(stmt: TargetStmt) -> str:
    if isinstance(stmt, BulkUpdate):
        k = ", ".join(_pe(e) for e in stmt.keys)
        qs = ", ".join(_pq(q) for q in stmt.quals)
        return (f"{stmt.dest} := {stmt.dest} ◁ {{ (({k}), {stmt.op}/v) | {qs}, "
                f"let v = {_pe(stmt.value)}, group by ({k}) }}")
    if isinstance(stmt, BulkStore):
        k = ", ".join(_pe(e) for e in stmt.keys)
        qs = ", ".join(_pq(q) for q in stmt.quals)
        return f"{stmt.dest} := {stmt.dest} ◁ {{ (({k}), {_pe(stmt.value)}) | {qs} }}"
    if isinstance(stmt, ScalarAgg):
        qs = ", ".join(_pq(q) for q in stmt.quals)
        return (f"{stmt.dest} := {stmt.dest} {stmt.op} "
                f"({stmt.op}/{{ {_pe(stmt.value)} | {qs} }})")
    if isinstance(stmt, ScalarAssign):
        return f"{stmt.dest} := {_pe(stmt.value)}"
    if isinstance(stmt, SeqWhile):
        inner = "; ".join(pretty(b) for b in stmt.body)
        return f"while ({_pe(stmt.cond)}) {{ {inner} }}"
    return str(stmt)
