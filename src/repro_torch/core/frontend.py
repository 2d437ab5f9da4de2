"""Python-source frontend: `@loop_program` parses the decorated function's
body (via the `ast` module) into the paper's loop language (Figure 1).

Parameter annotations declare types:

    @loop_program
    def matmul(M: matrix["n", "l"], N: matrix["l", "m"],
               R: matrix["n", "m"], n: dim, m: dim, l: dim):
        for i in range(0, n):
            for j in range(0, m):
                R[i, j] = 0.0
                for k in range(0, l):
                    R[i, j] += M[i, k] * N[k, j]

Notes vs. the paper's concrete syntax: `range(lo, hi)` is EXCLUSIVE
(python semantics); `for (s, d) in E` iterates bags of tuples; `for i, v
in items(V)` gives (index, value) pairs; maps are int-keyed with implicit
zero (the paper's benchmarks only ⊕= into maps).
"""
from __future__ import annotations

import ast as pyast
import inspect
import textwrap

from .loop_ast import (Assign, BinOp, Call, Const, DIndex, DVar, Expr,
                       ForIn, ForRange, If, IncUpdate, Index, Program,
                       RejectionError, Stmt, TypeInfo, UnOp, Var, While)


# ------------------------- type annotation helpers -------------------------

class _Ann:
    def __init__(self, kind, dims=(), fields=1, dtype="float"):
        self.info = TypeInfo(kind, tuple(dims), fields, dtype)

    def __getitem__(self, dims):
        if not isinstance(dims, tuple):
            dims = (dims,)
        return _Ann(self.info.kind, [str(d) for d in dims],
                    self.info.fields, self.info.dtype)


class _Bag:
    def __getitem__(self, n):
        return _Ann("bag", (), int(n) if not isinstance(n, tuple) else len(n))


vector = _Ann("vector", ("n",))
matrix = _Ann("matrix", ("n", "m"))
map_ = _Ann("map", ("k",))
bag = _Bag()
dim = _Ann("dim")
scalar = _Ann("scalar")
intscalar = _Ann("scalar", dtype="int")

_ANNOT = {"vector": vector, "matrix": matrix, "map_": map_, "dim": dim,
          "scalar": scalar, "intscalar": intscalar}

_BINOPS = {pyast.Add: "+", pyast.Sub: "-", pyast.Mult: "*", pyast.Div: "/",
           pyast.FloorDiv: "//", pyast.Mod: "%", pyast.Pow: "**"}
_CMPOPS = {pyast.Eq: "==", pyast.NotEq: "!=", pyast.Lt: "<", pyast.LtE: "<=",
           pyast.Gt: ">", pyast.GtE: ">="}
_CALLS = {"sqrt", "exp", "log", "abs", "sin", "cos", "tanh", "sigmoid",
          "float", "int", "min", "max"}


def _expr(node) -> Expr:
    if isinstance(node, pyast.Name):
        return Var(node.id)
    if isinstance(node, pyast.Constant):
        return Const(node.value)
    if isinstance(node, pyast.Subscript):
        if not isinstance(node.value, pyast.Name):
            raise RejectionError("only named arrays can be indexed")
        sl = node.slice
        idxs = tuple(_expr(e) for e in (sl.elts if isinstance(sl, pyast.Tuple)
                                        else [sl]))
        return Index(node.value.id, idxs)
    if isinstance(node, pyast.BinOp):
        op = _BINOPS.get(type(node.op))
        if op is None:
            raise RejectionError(f"unsupported operator {node.op}")
        return BinOp(op, _expr(node.left), _expr(node.right))
    if isinstance(node, pyast.UnaryOp):
        if isinstance(node.op, pyast.USub):
            return UnOp("neg", _expr(node.operand))
        if isinstance(node.op, pyast.Not):
            return UnOp("not", _expr(node.operand))
        raise RejectionError("unsupported unary op")
    if isinstance(node, pyast.Compare):
        if len(node.ops) != 1:
            raise RejectionError("chained comparisons unsupported")
        return BinOp(_CMPOPS[type(node.ops[0])], _expr(node.left),
                     _expr(node.comparators[0]))
    if isinstance(node, pyast.BoolOp):
        op = "and" if isinstance(node.op, pyast.And) else "or"
        e = _expr(node.values[0])
        for v in node.values[1:]:
            e = BinOp(op, e, _expr(v))
        return e
    if isinstance(node, pyast.Call):
        if not isinstance(node.func, pyast.Name) or node.func.id not in _CALLS:
            raise RejectionError(f"unsupported call {pyast.dump(node)[:60]}")
        return Call(node.func.id, tuple(_expr(a) for a in node.args))
    if isinstance(node, pyast.IfExp):
        # e1 if c else e2  ->  where-style select
        return Call("where", (_expr(node.test), _expr(node.body),
                              _expr(node.orelse)))
    raise RejectionError(f"unsupported expression {pyast.dump(node)[:80]}")


_CALLS = _CALLS | {"where"}


def _dest(node) -> DVar | DIndex:
    if isinstance(node, pyast.Name):
        return DVar(node.id)
    if isinstance(node, pyast.Subscript):
        e = _expr(node)
        return DIndex(e.array, e.idxs)
    raise RejectionError("unsupported assignment destination")


_AUGOPS = {pyast.Add: "+", pyast.Mult: "*"}


def _stmts(nodes) -> list[Stmt]:
    out: list[Stmt] = []
    for node in nodes:
        if isinstance(node, pyast.Assign):
            if len(node.targets) != 1:
                raise RejectionError("multi-target assignment unsupported")
            dest = _dest(node.targets[0])
            val = _expr(node.value)
            # `d = min(d, e)` / `d = max(d, e)` sugar for the commutative
            # min/max incremental updates (paper's ⊕=)
            if isinstance(val, Call) and val.fn in ("min", "max") and \
                    len(val.args) == 2:
                d_as_expr = Var(dest.name) if isinstance(dest, DVar) \
                    else Index(dest.array, dest.idxs)
                if val.args[0] == d_as_expr:
                    out.append(IncUpdate(dest, val.fn, val.args[1]))
                    continue
                if val.args[1] == d_as_expr:
                    out.append(IncUpdate(dest, val.fn, val.args[0]))
                    continue
            out.append(Assign(dest, val))
        elif isinstance(node, pyast.AugAssign):
            op = _AUGOPS.get(type(node.op))
            if op is None:
                raise RejectionError(f"unsupported ⊕= operator {node.op}")
            out.append(IncUpdate(_dest(node.target), op, _expr(node.value)))
        elif isinstance(node, pyast.For):
            it = node.iter
            if isinstance(it, pyast.Call) and isinstance(it.func, pyast.Name) \
                    and it.func.id == "range":
                if not isinstance(node.target, pyast.Name):
                    raise RejectionError("range loop needs a simple index var")
                args = it.args
                lo = _expr(args[0]) if len(args) > 1 else Const(0)
                hi = _expr(args[1] if len(args) > 1 else args[0])
                out.append(ForRange(node.target.id, lo, hi, _stmts(node.body)))
            else:
                with_index = False
                if isinstance(it, pyast.Call) and isinstance(it.func, pyast.Name) \
                        and it.func.id == "items":
                    with_index = True
                    bag_name = it.args[0].id
                elif isinstance(it, pyast.Name):
                    bag_name = it.id
                else:
                    raise RejectionError("unsupported loop iterable")
                tgt = node.target
                pats = tuple(e.id for e in tgt.elts) if isinstance(tgt, pyast.Tuple) \
                    else (tgt.id,)
                out.append(ForIn(pats, bag_name, with_index, _stmts(node.body)))
        elif isinstance(node, pyast.While):
            out.append(While(_expr(node.test), _stmts(node.body)))
        elif isinstance(node, pyast.If):
            out.append(If(_expr(node.test), _stmts(node.body),
                          _stmts(node.orelse)))
        elif isinstance(node, pyast.Expr) and isinstance(node.value, pyast.Constant):
            continue  # docstring
        elif isinstance(node, pyast.Pass):
            continue
        else:
            raise RejectionError(f"unsupported statement {type(node).__name__}")
    return out


def _mutated(stmts) -> list[str]:
    names: list[str] = []

    def dest_name(d):
        return d.name if isinstance(d, DVar) else d.array

    def walk(ss):
        for s in ss:
            if isinstance(s, (Assign, IncUpdate)):
                n = dest_name(s.dest)
                if n not in names:
                    names.append(n)
            for attr in ("body", "then", "els"):
                if hasattr(s, attr):
                    walk(getattr(s, attr))
    walk(stmts)
    return names


def parse_program(fn) -> Program:
    src = textwrap.dedent(inspect.getsource(fn))
    tree = pyast.parse(src)
    fdef = tree.body[0]
    assert isinstance(fdef, (pyast.FunctionDef,))
    params: dict[str, TypeInfo] = {}
    hints = fn.__annotations__
    for a in fdef.args.args:
        ann = hints.get(a.arg)
        if isinstance(ann, str):  # PEP-563 stringized annotations
            ann = eval(ann, {**_ANNOT, "bag": bag}, dict(fn.__globals__))
        if isinstance(ann, _Ann):
            params[a.arg] = ann.info
        elif ann is None:
            params[a.arg] = TypeInfo("scalar")
        else:
            raise RejectionError(f"parameter {a.arg}: unknown annotation {ann}")
    body = _stmts(fdef.body)
    outs = tuple(n for n in _mutated(body))
    return Program(fdef.name, params, body, outs, source=src)


def loop_program(fn):
    """Decorator: parse into the loop language; attach the Program."""
    prog = parse_program(fn)
    fn.program = prog
    return fn
