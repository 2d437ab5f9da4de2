"""AST of the loop-based language (paper Figure 1).

Destinations (L-values), expressions and statements.  Types of interest:
scalars, vector[n], matrix[n,m], map[K]->V (bounded int-keyed, implicit
zero), and bags (read-only input collections, struct-of-arrays).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Expr:
    pass


@dataclass(frozen=True)
class Var(Expr):
    name: str


@dataclass(frozen=True)
class Const(Expr):
    value: Any


@dataclass(frozen=True)
class Index(Expr):
    """Array access v[e1, ..., en]."""
    array: str
    idxs: tuple[Expr, ...]


@dataclass(frozen=True)
class BinOp(Expr):
    op: str          # + - * / // % ** min max == != < <= > >= and or
    lhs: Expr
    rhs: Expr


@dataclass(frozen=True)
class UnOp(Expr):
    op: str          # neg not
    e: Expr


@dataclass(frozen=True)
class Call(Expr):
    fn: str          # sqrt exp log abs sin cos tanh sigmoid float int
    args: tuple[Expr, ...]


# ---------------------------------------------------------------------------
# Destinations (L-values)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Dest:
    pass


@dataclass(frozen=True)
class DVar(Dest):
    name: str


@dataclass(frozen=True)
class DIndex(Dest):
    array: str
    idxs: tuple[Expr, ...]


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------

@dataclass
class Stmt:
    pass


@dataclass
class Assign(Stmt):
    dest: Dest
    value: Expr


@dataclass
class IncUpdate(Stmt):
    """d ⊕= e for commutative ⊕ in {+, *, min, max}."""
    dest: Dest
    op: str
    value: Expr


@dataclass
class ForRange(Stmt):
    var: str
    lo: Expr
    hi: Expr          # EXCLUSIVE (python range semantics)
    body: list[Stmt] = field(default_factory=list)


@dataclass
class ForIn(Stmt):
    """Iterate over a bag: `for (a, b) in E` / `for v in V` (values) /
    `for i, v in items(V)` (index+value)."""
    pats: tuple[str, ...]
    bag: str
    with_index: bool
    body: list[Stmt] = field(default_factory=list)


@dataclass
class While(Stmt):
    cond: Expr
    body: list[Stmt] = field(default_factory=list)


@dataclass
class If(Stmt):
    cond: Expr
    then: list[Stmt] = field(default_factory=list)
    els: list[Stmt] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Declared types of program variables
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TypeInfo:
    kind: str                 # scalar | vector | matrix | map | bag | dim
    dims: tuple[str, ...] = ()   # symbolic dim names (vector/matrix/map)
    fields: int = 1           # components for bags of tuples
    dtype: str = "float"


@dataclass
class Program:
    name: str
    params: dict[str, TypeInfo]
    body: list[Stmt]
    outputs: tuple[str, ...]     # mutated variables (in declaration order)
    source: str = ""

    def pretty(self) -> str:
        out = [f"program {self.name}({', '.join(self.params)}):"]

        def pe(e: Expr) -> str:
            if isinstance(e, Var):
                return e.name
            if isinstance(e, Const):
                return repr(e.value)
            if isinstance(e, Index):
                return f"{e.array}[{', '.join(pe(i) for i in e.idxs)}]"
            if isinstance(e, BinOp):
                return f"({pe(e.lhs)} {e.op} {pe(e.rhs)})"
            if isinstance(e, UnOp):
                return f"({e.op} {pe(e.e)})"
            if isinstance(e, Call):
                return f"{e.fn}({', '.join(pe(a) for a in e.args)})"
            return str(e)

        def pd(d: Dest) -> str:
            if isinstance(d, DVar):
                return d.name
            return f"{d.array}[{', '.join(pe(i) for i in d.idxs)}]"

        def ps(s: Stmt, ind: int):
            pre = "  " * ind
            if isinstance(s, Assign):
                out.append(f"{pre}{pd(s.dest)} := {pe(s.value)}")
            elif isinstance(s, IncUpdate):
                out.append(f"{pre}{pd(s.dest)} {s.op}= {pe(s.value)}")
            elif isinstance(s, ForRange):
                out.append(f"{pre}for {s.var} = {pe(s.lo)}, {pe(s.hi)}-1 do")
                for b in s.body:
                    ps(b, ind + 1)
            elif isinstance(s, ForIn):
                pats = ", ".join(s.pats)
                out.append(f"{pre}for ({pats}) in {s.bag} do")
                for b in s.body:
                    ps(b, ind + 1)
            elif isinstance(s, While):
                out.append(f"{pre}while ({pe(s.cond)}) do")
                for b in s.body:
                    ps(b, ind + 1)
            elif isinstance(s, If):
                out.append(f"{pre}if ({pe(s.cond)})")
                for b in s.then:
                    ps(b, ind + 1)
                if s.els:
                    out.append(f"{pre}else")
                    for b in s.els:
                        ps(b, ind + 1)

        for s in self.body:
            ps(s, 1)
        return "\n".join(out)


class RejectionError(Exception):
    """Program violates the parallelization restrictions (paper Def. 3.1)."""
