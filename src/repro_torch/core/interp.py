"""Reference sequential interpreter of the loop language — the correctness
oracle for the compiler (paper Theorem A.1 is validated empirically by
comparing compiled output against this, see tests/test_core_properties.py).

Semantics notes (paper §3.4): an array read whose index is out of range
denotes the EMPTY BAG, which propagates — the enclosing statement instance
contributes nothing.  Same for a destination index out of range.
"""
from __future__ import annotations

import math

import numpy as np

from .loop_ast import (Assign, BinOp, Call, Const, DIndex, DVar, ForIn,
                       ForRange, If, IncUpdate, Index, Program, Stmt, UnOp,
                       Var, While)


class _Missing(Exception):
    pass


_BIN = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "//": lambda a, b: a // b, "%": lambda a, b: a % b,
    "**": lambda a, b: a ** b,
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "and": lambda a, b: bool(a) and bool(b),
    "or": lambda a, b: bool(a) or bool(b),
}

_FN = {"sqrt": math.sqrt, "exp": math.exp, "log": math.log, "abs": abs,
       "sin": math.sin, "cos": math.cos, "tanh": math.tanh,
       "sigmoid": lambda x: 1.0 / (1.0 + math.exp(-x)),
       "float": float, "int": int, "min": min, "max": max,
       "where": lambda c, a, b: a if c else b}

_AGG = {"+": lambda a, b: a + b, "*": lambda a, b: a * b,
        "min": min, "max": max}


def _index(env, name, idxs):
    arr = env[name]
    ii = tuple(int(i) for i in idxs)
    for d, i in zip(arr.shape, ii):
        if i < 0 or i >= d:
            raise _Missing()
    return arr[ii]


def run(prog: Program, inputs: dict) -> dict:
    env = {}
    for name, t in prog.params.items():
        v = inputs[name]
        if t.kind in ("vector", "matrix", "map"):
            env[name] = np.array(v, dtype=np.float64 if t.dtype == "float"
                                 else np.int64)
        elif t.kind == "bag":
            env[name] = tuple(np.asarray(c) for c in v) if isinstance(v, tuple) \
                else (np.asarray(v),)
        else:
            env[name] = v

    def ev(e) -> float:
        if isinstance(e, Var):
            v = env[e.name]
            if isinstance(v, _Missing):
                raise _Missing()
            return v
        if isinstance(e, Const):
            return e.value
        if isinstance(e, Index):
            return _index(env, e.array, [ev(i) for i in e.idxs])
        if isinstance(e, BinOp):
            return _BIN[e.op](ev(e.lhs), ev(e.rhs))
        if isinstance(e, UnOp):
            return -ev(e.e) if e.op == "neg" else not ev(e.e)
        if isinstance(e, Call):
            return _FN[e.fn](*[ev(a) for a in e.args])
        raise TypeError(e)

    def exec_stmt(s: Stmt):
        if isinstance(s, (Assign, IncUpdate)):
            try:
                val = ev(s.value)
                if isinstance(s.dest, DVar):
                    if isinstance(s, IncUpdate):
                        env[s.dest.name] = _AGG[s.op](env[s.dest.name], val)
                    else:
                        env[s.dest.name] = val
                else:
                    arr = env[s.dest.array]
                    ii = tuple(int(ev(i)) for i in s.dest.idxs)
                    for d, i in zip(arr.shape, ii):
                        if i < 0 or i >= d:
                            raise _Missing()
                    if isinstance(s, IncUpdate):
                        arr[ii] = _AGG[s.op](arr[ii], val)
                    else:
                        arr[ii] = val
            except _Missing:
                pass  # empty-bag semantics: contributes nothing
        elif isinstance(s, ForRange):
            lo, hi = int(ev(s.lo)), int(ev(s.hi))
            for i in range(lo, hi):
                env[s.var] = i
                for b in s.body:
                    exec_stmt(b)
        elif isinstance(s, ForIn):
            cols = env[s.bag]
            if isinstance(cols, np.ndarray):
                cols = (cols,)
            n = len(cols[0])
            for r in range(n):
                if s.with_index:
                    env[s.pats[0]] = r
                    for j, p in enumerate(s.pats[1:]):
                        env[p] = cols[j][r]
                else:
                    for j, p in enumerate(s.pats):
                        env[p] = cols[j][r]
                for b in s.body:
                    exec_stmt(b)
        elif isinstance(s, While):
            while ev(s.cond):
                for b in s.body:
                    exec_stmt(b)
        elif isinstance(s, If):
            try:
                c = ev(s.cond)
            except _Missing:
                return
            for b in (s.then if c else s.els):
                exec_stmt(b)

    for s in prog.body:
        exec_stmt(s)
    return {n: env[n] for n in prog.outputs}
