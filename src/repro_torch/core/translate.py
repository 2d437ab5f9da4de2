"""Translation of loop programs to target comprehension code — the paper's
Figure 2 rules, with Rule (2) (comprehension unnesting) applied on the fly
so every produced comprehension is already flat, and the §3.6 loop-
iteration elimination specialized to dense arrays (array accesses become
`Get` gathers with implicit inRange guards).

Rule map:
  E  (11a-g): `_expr` — expressions lift to (qualifiers, value expr)
  K  (12a-c): destination key exprs = translated destination indexes
  D  (13a-c): old destination value — implicit in the ◁⊕ merge of BulkUpdate
  U  (14a-c): `BulkStore`/`BulkUpdate` carry the dest merge
  S  (15a-h): `translate_stmt` threading the loop-qualifier list q̄
  Rule (16):  constant (empty) key group-by → ScalarAgg total aggregation
  Rule (17):  unique affine keys → handled in lower.py (axis reduction /
              elementwise merge instead of a shuffle-style segment reduce)
"""
from __future__ import annotations

from .comprehension import (BagGen, BulkStore, BulkUpdate, Cond, Get,
                            RangeGen, ScalarAgg, ScalarAssign, SeqWhile)
from .loop_ast import (Assign, BinOp, Call, Const, DIndex, DVar, Expr, ForIn,
                       ForRange, If, IncUpdate, Index, Program,
                       RejectionError, Stmt, UnOp, Var, While)


class Translator:
    def __init__(self, prog: Program):
        self.prog = prog
        self.fresh = 0

    # ---- rule E: lift an expression to (extra qualifiers, value expr) ----
    def _expr(self, e: Expr, quals: list) -> Expr:
        if isinstance(e, (Var, Const)):
            return e                                     # rules (11a)/(11g)
        if isinstance(e, Index):                         # rule (11c) + §3.6
            idxs = tuple(self._expr(i, quals) for i in e.idxs)
            return Get(e.array, idxs)
        if isinstance(e, BinOp):                         # rule (11d)
            return BinOp(e.op, self._expr(e.lhs, quals),
                         self._expr(e.rhs, quals))
        if isinstance(e, UnOp):
            return UnOp(e.op, self._expr(e.e, quals))
        if isinstance(e, Call):
            return Call(e.fn, tuple(self._expr(a, quals) for a in e.args))
        raise RejectionError(f"untranslatable expression {e}")

    # ---- rules S (15a-h) ----
    def translate_stmt(self, s: Stmt, quals: list) -> list:
        if isinstance(s, IncUpdate):                     # rule (15a)
            q = list(quals)
            val = self._expr(s.value, q)
            if isinstance(s.dest, DVar):                 # rule (16): () key
                return [ScalarAgg(s.dest.name, s.op, val, q)]
            keys = tuple(self._expr(i, q) for i in s.dest.idxs)  # rule K
            return [BulkUpdate(s.dest.array, keys, s.op, val, q)]

        if isinstance(s, Assign):                        # rule (15b)
            q = list(quals)
            val = self._expr(s.value, q)
            if isinstance(s.dest, DVar):
                if any(isinstance(x, (RangeGen, BagGen)) for x in q):
                    raise RejectionError(
                        f"scalar '{s.dest.name}' assigned inside a loop")
                return [ScalarAssign(s.dest.name, val, q)]
            keys = tuple(self._expr(i, q) for i in s.dest.idxs)
            return [BulkStore(s.dest.array, keys, val, q)]

        if isinstance(s, ForRange):                      # rule (15d)
            q = quals + [RangeGen(s.var, s.lo, s.hi)]
            out = []
            for b in s.body:                             # rule (15h) + Thm 3.1
                out += self.translate_stmt(b, q)
            return out

        if isinstance(s, ForIn):                         # rule (15e)
            self.fresh += 1
            idx = s.pats[0] if s.with_index else f"$i{self.fresh}"
            vals = s.pats[1:] if s.with_index else s.pats
            q = quals + [BagGen(idx, tuple(vals), s.bag)]
            out = []
            for b in s.body:
                out += self.translate_stmt(b, q)
            return out

        if isinstance(s, If):                            # rule (15g)
            qc = list(quals)
            c = self._expr(s.cond, qc)
            out = []
            for b in s.then:
                out += self.translate_stmt(b, qc + [Cond(c)])
            for b in s.els:
                out += self.translate_stmt(b, qc + [Cond(UnOp("not", c))])
            return out

        if isinstance(s, While):                         # rule (15f)
            if quals:
                raise RejectionError("while inside for is sequentialized by "
                                     "the paper; rejected here")
            body = []
            for b in s.body:
                body += self.translate_stmt(b, [])
            qc: list = []
            cond = self._expr(s.cond, qc)
            return [SeqWhile(cond, body)]

        raise RejectionError(f"untranslatable statement {s}")

    def translate(self) -> list:
        out = []
        for s in self.prog.body:
            out += self.translate_stmt(s, [])
        return out


def translate(prog: Program) -> list:
    return Translator(prog).translate()
