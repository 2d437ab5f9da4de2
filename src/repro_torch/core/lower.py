"""Plan execution: physical-plan nodes → PyTorch, eagerly, on one device.

The pipeline is  translate (Fig. 2) → passes.plan_program (operator
recognition, see passes.py) → PlanExecutor (this module).  The planner is
the reference package's, copied, so both packages execute the same plan.
The executor performs NO recognition: it materializes the chosen node,
checking the runtime guards (extents, packed-vs-dense inputs) that static
planning cannot see; when a guard fails it walks the node's `fallback`
chain — results never change, only the operator used.

Node → PyTorch mapping:

  MapExpr         broadcast value over the iteration space; full replace,
                  or a store at meshgrid keys with drop semantics
  DenseMap        dense fast path: ONE vectorized expression over whole
                  arrays — no index grids, gathers, masks or stores (guard:
                  extents cover the destination exactly) — else MapExpr
  Scatter         store at computed keys, out-of-range rows dropped
  SegmentReduce   one of four backends chosen by op_select.py: scatter-⊕,
                  sort + segmented ⊕, one-hot matmul, or the hand-written
                  CUDA segment kernel (backend name "pallas")
  AxisReduce      ⊕-reduce over contracted axes; a `product` certificate
                  contracts via torch.einsum instead of the dense grid
  EinsumContract  torch.einsum over sliced operands — else its AxisReduce
                  fallback
  TiledMatmul     the block-sparse CUDA tile kernel on the §5 packed lhs
                  (guard: lhs arrives as TiledMatrix) — else einsum
  ScalarReduce    total ⊕-reduce (+ any/all peephole for max/min of
                  float(bool)); `point` targets one destination cell
  SeqLoop         host `while` loop over the carry, one bool(cond) device
                  sync per iteration
  Fused           parts executed against the shared iteration space

Three places where PyTorch differs from the reference's JAX and the
executor compensates:

  * No drop-mode scatter.  An out-of-range index_put_/index_add_/
    scatter_reduce_ on CUDA raises a device-side assert that poisons the
    CUDA context, so every store flattens its keys, routes each dropped key
    to a sentinel slot one past the destination, and slices it off.
  * No clip-mode gather.  Indices are checked as (ix >= 0) & (ix < d) on
    int64, recorded as the inRange mask, clamped, then gathered.
  * No weak types.  Inputs are cast to float32/int32 as the reference's
    64-bit-off canonicalisation does (convert.py); constants stay python
    scalars, which PyTorch, like JAX, does not let widen a tensor's dtype.

Only the eager path is here.  Whole-program compilation, the fault
ladder, out-of-core streaming and the batched serving entry are later
work (ROADMAP.md); a failure surfaces as an exception.
"""
from __future__ import annotations

import numbers
import operator
from dataclasses import dataclass, field

import torch

from . import plan as P
from .analysis import check as check_restrictions
from .comprehension import Get
from .loop_ast import (BinOp, Call, Const, Program, RejectionError, UnOp,
                       Var)
from .passes import PlanConfig, plan_program
from .translate import translate


# ---------------------------------------------------------------------------
# scalars and tensors
# ---------------------------------------------------------------------------

def _is_t(x) -> bool:
    return isinstance(x, torch.Tensor)


def as_tensor(x, device) -> torch.Tensor:
    """A python scalar as a 0-d tensor in the reference's 64-bit-off dtype
    (bool / int32 / float32); tensors pass through."""
    if _is_t(x):
        return x
    if isinstance(x, bool):
        return torch.full((), x, dtype=torch.bool, device=device)
    if isinstance(x, numbers.Integral):
        return torch.full((), int(x), dtype=torch.int32, device=device)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _ndim(x) -> int:
    return x.dim() if _is_t(x) else 0


def _logical(fn):
    def op(a, b):
        if not _is_t(a) and not _is_t(b):
            return bool(fn(torch.tensor(bool(a)), torch.tensor(bool(b))))
        dev = a.device if _is_t(a) else b.device
        return fn(as_tensor(a, dev), as_tensor(b, dev))
    return op


# python operators dispatch to the tensor methods (remainder for %, floor
# division for //, as jnp.mod and jnp.floor_divide) and keep python
# arithmetic when both sides are python scalars
OPS = {
    "+": operator.add, "-": operator.sub, "*": operator.mul,
    "/": operator.truediv, "//": operator.floordiv, "%": operator.mod,
    "**": operator.pow,
    "==": operator.eq, "!=": operator.ne, "<": operator.lt,
    "<=": operator.le, ">": operator.gt, ">=": operator.ge,
    "and": _logical(torch.logical_and), "or": _logical(torch.logical_or),
}


def _where(c, a, b):
    c = c if c.dtype == torch.bool else c != 0
    return torch.where(c, a, b)


# the executor hands every function tensors (python scalars become 0-d
# tensors first)
FNS = {"sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
       "abs": torch.abs, "sin": torch.sin, "cos": torch.cos,
       "tanh": torch.tanh, "sigmoid": torch.sigmoid,
       "float": lambda x: x.to(torch.float32),
       "int": lambda x: x.to(torch.int32),
       "min": torch.minimum, "max": torch.maximum,
       "where": _where}


def _reduce(op: str, x: torch.Tensor, dims=None) -> torch.Tensor:
    """⊕-reduce over `dims` (all dims when None)."""
    if dims is None:
        dims = tuple(range(x.dim()))
    dims = tuple(dims)
    if not dims:
        return x
    if op == "+":
        return torch.sum(x, dim=dims)
    if op == "min":
        return torch.amin(x, dim=dims)
    if op == "max":
        return torch.amax(x, dim=dims)
    for d in sorted(dims, reverse=True):       # "*": one dim at a time
        x = torch.prod(x, dim=d)
    return x


REDUCE = {o: (lambda x, dims=None, _o=o: _reduce(_o, x, dims))
          for o in ("+", "*", "min", "max")}
COMBINE = {"+": torch.add, "*": torch.mul, "min": torch.minimum,
           "max": torch.maximum}


def identity(op: str, dtype, device="cpu") -> torch.Tensor:
    """The ⊕ identity element for masked-out rows."""
    if op == "+":
        return torch.zeros((), dtype=dtype, device=device)
    if op == "*":
        return torch.ones((), dtype=dtype, device=device)
    if dtype.is_floating_point:
        big = float("inf")
    else:
        big = torch.iinfo(dtype).max
    return torch.full((), -big if op == "max" else big, dtype=dtype,
                      device=device)


def scatter_drop(dest: torch.Tensor, keys: list, vals, op=None):
    """dest with `vals` stored (op None) or ⊕-combined (op) at the index
    tuple `keys`, dropping every row whose key is out of range in any dim.
    The torch stand-in for a JAX mode="drop" scatter: keys are flattened
    on int64, a dropped row is sent to the sentinel slot `dest.numel()` of
    a buffer one larger than dest, and the sentinel is sliced off."""
    if len(keys) != dest.dim():
        raise RejectionError(f"store into a rank-{dest.dim()} destination "
                             f"with {len(keys)} keys")
    vals = as_tensor(vals, dest.device).to(dest.dtype)
    shape = torch.broadcast_shapes(*(k.shape for k in keys), vals.shape)
    num = dest.numel()
    flat = ok = None
    for k, d in zip(keys, dest.shape):
        k = k.to(torch.int64)
        okd = (k >= 0) & (k < d)
        ok = okd if ok is None else ok & okd
        kc = k.clamp(0, max(d - 1, 0))
        flat = kc if flat is None else flat * d + kc
    flat = torch.where(ok, flat, num).expand(shape).reshape(-1)
    v = vals.expand(shape).reshape(-1)
    buf = torch.empty(num + 1, dtype=dest.dtype, device=dest.device)
    buf[:num] = dest.reshape(-1)
    if op is None:
        buf.index_put_((flat,), v)
    elif op == "+":
        buf.index_add_(0, flat, v)
    else:
        buf.scatter_reduce_(0, flat, v, {"*": "prod", "min": "amin",
                                         "max": "amax"}[op],
                            include_self=True)
    return buf[:num].reshape(dest.shape)


def segment_flat(backend: str, ids, vals, num: int, op: str):
    """[N]-flat segment-⊕ partial via the chosen backend.  `ids` == `num`
    marks dropped rows; the partial's row i is the ⊕ of all vals whose
    id == i, with the ⊕ identity for empty segments."""
    dev = vals.device
    if backend == "scatter":
        # ⊕ into an identity-filled [num+1] partial; sentinel rows land in
        # the discard row and are sliced off
        buf = identity(op, vals.dtype, dev).repeat(num + 1)
        return scatter_drop(buf, [ids], vals, op)[:num]
    if backend == "sort":
        # sort the ids, then ⊕ each sorted run into a [num+1] partial whose
        # last row is the discard row of the sentinel ids
        sid, order = torch.sort(ids.to(torch.int64), stable=True)
        buf = identity(op, vals.dtype, dev).repeat(num + 1)
        return scatter_drop(buf, [sid], vals[order], op)[:num]
    if backend == "onehot":
        # group-by as matmul: [N] values × [N, num] one-hot.  Integer
        # values accumulate exactly in float64 (below 2^53; CUDA has no
        # int32 matmul); floats in float32.  Sentinel rows' VALUES are
        # zeroed too: their one-hot row is all zeros, but 0 × inf/NaN would
        # still contaminate the product
        is_int = not vals.dtype.is_floating_point and vals.dtype != torch.bool
        acc = torch.float64 if is_int else torch.float32
        vals = torch.where(ids == num, torch.zeros((), dtype=vals.dtype,
                                                   device=dev), vals)
        oh = (ids[:, None] == torch.arange(num, device=dev)[None, :]).to(acc)
        res = (vals.to(acc)[None, :] @ oh)[0]
        return res.to(vals.dtype) if is_int else res
    if backend == "pallas":
        from ..kernels import ops as kops
        return kops.segment_reduce(ids, vals, num, op=op)
    raise RejectionError(f"unknown segment backend {backend!r}")


class Axes:
    """Materialized iteration space: ordered axes with concrete extents."""

    def __init__(self):
        self.order: list[str] = []
        self.extent: dict[str, int] = {}

    def add(self, name: str, n: int):
        self.order.append(name)
        self.extent[name] = n

    def pos(self, name: str) -> int:
        return self.order.index(name)

    def shape(self):
        return tuple(self.extent[a] for a in self.order)

    def expand(self, arr, axis_name: str):
        """1-D array along `axis_name` → broadcast rank."""
        shape = [1] * len(self.order)
        shape[self.pos(axis_name)] = -1
        return torch.reshape(arr, shape)


@dataclass(frozen=True)
class ExecContext:
    """Per-call plan parameters.

      bag_limits    bag → logical row count when its columns were padded
                    (a serving bucket): rows at or beyond it are masked
      array_limits  array → logical dim-0 length of a padded dense array:
                    reads beyond it are masked and writes dropped, so pad
                    rows never change a result (paper §3.4)
      salts         group-by dest → salt factor the run-time hot-key probe
                    chose (op_select.probe_hot_fraction + choose_salt)

    The reference's per-shard fields (bag/row offsets, axis overrides,
    alignment certificates) come with the distributed slice."""
    bag_limits: dict = field(default_factory=dict)
    array_limits: dict = field(default_factory=dict)
    salts: dict = field(default_factory=dict)


_EMPTY_CTX = ExecContext()


def salt_for_node(node, env, selector, skew_salting: str, *,
                  nshards: int = 1, bag_limits=None) -> int:
    """Run-time half of the hot-key salting decision for one group-by
    node: probe the CONCRETE key column host-side and ask the selector for
    the salt factor (1 = do not salt).  Only fires in "auto" mode on nodes
    without a static pin, and only for a single key that IS a bag column,
    reduced into a 1-D destination."""
    if not isinstance(node, P.SegmentReduce) or node.salt is not None \
            or skew_salting != "auto":
        return 1
    if len(node.keys) != 1 or not isinstance(node.keys[0], Var):
        return 1
    dest = env.get(node.dest)
    if dest is None or _ndim(dest) != 1:
        return 1
    kv = node.keys[0].name
    bag, col = None, 0
    for a in node.space.axes:
        if a.kind == "bag" and kv in a.vals:
            bag, col = a.bag, a.vals.index(kv)
            break
    if bag is None or bag not in env:
        return 1
    bv = env[bag]
    c = (bv if isinstance(bv, tuple) else (bv,))[col]
    n = int(c.shape[0])
    lim = (bag_limits or {}).get(bag)
    if lim is not None:
        n = min(n, int(lim))
    if n == 0:
        return 1
    from .op_select import PROBE_ROWS, probe_hot_fraction
    hot = probe_hot_fraction(c[:min(n, PROBE_ROWS)].cpu().numpy())
    dec = selector.choose_salt(n=n, k=int(dest.shape[0]), op=node.op,
                               nshards=nshards, hot_frac=hot)
    return int(dec.backend.split(":", 1)[1]) \
        if dec.backend.startswith("salt:") else 1


def collect_salts(nodes, env, selector, skew_salting: str, *,
                  nshards: int = 1, bag_limits=None) -> dict:
    """dest → salt factor for every probe-decided group-by in the plan
    (walks SeqLoop bodies and fused regions)."""
    out: dict = {}

    def walk(ns):
        for n in ns:
            if isinstance(n, P.SeqLoop):
                walk(n.body)
            elif isinstance(n, (P.Fused, P.FusedRound)):
                walk(n.parts)
            else:
                s = salt_for_node(n, env, selector, skew_salting,
                                  nshards=nshards, bag_limits=bag_limits)
                if s > 1:
                    out[n.dest] = s
    walk(nodes)
    return out


# ---------------------------------------------------------------------------
# plan executor
# ---------------------------------------------------------------------------

class PlanExecutor:
    def __init__(self, prog: Program, selector=None, device="cpu"):
        self.prog = prog
        self.device = torch.device(device)
        # id(node) → the materialization the executor last chose for it
        # ("einsum", "dense-store", "segment:pallas[cost]", …);
        # CompiledProgram.explain() reads it
        self.decisions: dict = {}
        self._selector = selector

    @property
    def selector(self):
        if self._selector is None:
            from .op_select import OpSelector
            self._selector = OpSelector(platform=self.device.type,
                                        device=str(self.device))
        return self._selector

    def note(self, node, tag: str) -> None:
        self.decisions[id(node)] = tag

    def _t(self, x) -> torch.Tensor:
        return as_tensor(x, self.device)

    def _arange(self, n: int) -> torch.Tensor:
        return torch.arange(n, dtype=torch.int32, device=self.device)

    # ---- static scalars (dims / range bounds) ----
    def static_int(self, e, env) -> int:
        if isinstance(e, Const):
            return int(e.value)
        if isinstance(e, Var):
            v = env[e.name]
            if isinstance(v, int) and not isinstance(v, bool):
                return int(v)
            raise RejectionError(
                f"range bound '{e.name}' must be a static dim (python int)")
        if isinstance(e, BinOp):
            l = self.static_int(e.lhs, env)
            r = self.static_int(e.rhs, env)
            return int({"+": l + r, "-": l - r, "*": l * r,
                        "//": l // r, "/": l // r}[e.op])
        raise RejectionError(f"non-static range bound {e}")

    # ---- materialize an IterSpace against the env ----
    def build_space(self, space: P.IterSpace, env, ctx: ExecContext):
        ax = Axes()
        binding: dict[str, tuple] = {}  # var -> ("range", axis, lo)|("bagval", axis, col)
        for a in space.axes:
            if a.kind == "range":
                lo = self.static_int(a.lo, env)
                hi = self.static_int(a.hi, env)
                ax.add(a.var, max(hi - lo, 0))
                binding[a.var] = ("range", a.var, lo)
            else:
                bagv = env[a.bag]
                cols = bagv if isinstance(bagv, tuple) else (bagv,)
                n = int(cols[0].shape[0])
                ax.add(a.var, n)
                binding[a.var] = ("range", a.var, 0)
        base_masks = []
        for a in space.axes:
            if a.kind == "range":
                continue
            bagv = env[a.bag]
            cols = bagv if isinstance(bagv, tuple) else (bagv,)
            for j, v in enumerate(a.vals):
                binding[v] = ("bagval", a.var, cols[j])
            lim = ctx.bag_limits.get(a.bag)
            if lim is not None:
                base_masks.append(ax.expand(
                    self._arange(ax.extent[a.var]) < lim, a.var))
        return ax, binding, list(space.conds), base_masks

    # ---- expression evaluation over the iteration space ----
    def eval(self, e, env, ax: Axes, binding, masks: list,
             ctx: ExecContext = _EMPTY_CTX):
        if isinstance(e, Const):
            return e.value
        if isinstance(e, Var):
            if e.name in binding:
                kind, axis, aux = binding[e.name]
                if kind == "range":
                    return ax.expand(aux + self._arange(ax.extent[axis]),
                                     axis)
                return ax.expand(aux, axis)
            return env[e.name]
        if isinstance(e, (P.Gather, Get)):
            arr = env[e.array]
            from .tiles import TiledMatrix, unpack
            if isinstance(arr, TiledMatrix):   # §5 fallback: unpack on read
                arr = unpack(arr)
            # identity-traversal broadcast: statically marked eligible, and
            # the runtime extents cover the array exactly (no gather); a
            # padded array never qualifies, its extent is not its dim
            bc_ok = e.broadcast_ok if isinstance(e, P.Gather) else True
            if bc_ok and len(e.idxs) == arr.dim() and \
                    e.array not in ctx.array_limits and \
                    all(isinstance(ix, Var) and ix.name in binding
                        and binding[ix.name][0] == "range"
                        and binding[ix.name][2] == 0
                        and ax.extent[ix.name] == d
                        for ix, d in zip(e.idxs, arr.shape)) and \
                    len({ix.name for ix in e.idxs}) == len(e.idxs):
                names = [ix.name for ix in e.idxs]
                shape = [1] * len(ax.order)
                perm_src = sorted(names, key=ax.pos)
                a2 = arr.permute([names.index(a) for a in perm_src])
                for a in perm_src:
                    shape[ax.pos(a)] = ax.extent[a]
                return torch.reshape(a2, shape)
            idxs = [self.eval(i, env, ax, binding, masks, ctx)
                    for i in e.idxs]
            lim = ctx.array_limits.get(e.array)
            cooked = []
            for dim_i, (d, ix) in enumerate(zip(arr.shape, idxs)):
                ix = self._t(ix).to(torch.int32)
                if dim_i == 0 and lim is not None:   # logical bound
                    masks.append(ix < lim)
                # inRange on int64 (torch has no clip-mode gather and thin
                # uint32 support): the mask keeps §3.4 semantics, the clamp
                # keeps the gather in bounds — a dropped row's gathered
                # value is never observable
                ix = ix.to(torch.int64)
                masks.append((ix >= 0) & (ix < d))
                cooked.append(ix.clamp(0, max(d - 1, 0)))
            if len(cooked) == 1:
                return arr[cooked[0]]
            return arr[tuple(torch.broadcast_tensors(*cooked))]
        if isinstance(e, BinOp):
            return OPS[e.op](self.eval(e.lhs, env, ax, binding, masks, ctx),
                             self.eval(e.rhs, env, ax, binding, masks, ctx))
        if isinstance(e, UnOp):
            v = self.eval(e.e, env, ax, binding, masks, ctx)
            if e.op == "neg":
                return -v
            return torch.logical_not(v) if _is_t(v) else not v
        if isinstance(e, Call):
            return FNS[e.fn](*[self._t(self.eval(a, env, ax, binding,
                                                 masks, ctx))
                               for a in e.args])
        raise RejectionError(f"cannot execute expression {e}")

    def _mask(self, conds, env, ax, binding, masks,
              ctx: ExecContext = _EMPTY_CTX):
        for c in conds:
            masks.append(self.eval(c, env, ax, binding, masks, ctx))
        uniq: list = []                  # repeated masks: AND each once
        for x in masks:
            if not any(x is u for u in uniq):
                uniq.append(x)
        if not uniq:
            return None
        m = self._t(uniq[0])
        if m.dtype != torch.bool:
            m = m != 0
        for x in uniq[1:]:
            m = torch.logical_and(m, self._t(x))
        return m.expand(ax.shape()) if ax.order else m

    def _full(self, val, shape) -> torch.Tensor:
        return self._t(val).expand(shape)

    # ------------------------------------------------------------------
    # node execution.  run_node returns the NEW VALUE of each destination
    # (a tuple for Fused); execute() assigns them into the env.
    # ------------------------------------------------------------------

    def execute(self, nodes, env, ctx: ExecContext = _EMPTY_CTX):
        for node in nodes:
            if isinstance(node, P.SeqLoop):
                self._exec_seq_loop(node, env, ctx)
            elif isinstance(node, P.FusedRound):
                # round-fusion region: plain sequencing on a single device
                self.execute(node.parts, env, ctx)
            elif isinstance(node, P.Fused):
                for part, v in zip(node.parts, self.run_node(node, env, ctx)):
                    env[part.dest] = v
            else:
                env[node.dest] = self.run_node(node, env, ctx)

    def run_node(self, node, env, ctx: ExecContext = _EMPTY_CTX):
        if isinstance(node, P.Rebalance):
            # single device: one shard holds every row — the identity
            self.note(node, "rebalance:noop[single-device]")
            return env[node.dest]
        if isinstance(node, P.DenseMap):
            res = self._exec_dense_map(node, env, ctx)
            if res is not None:
                return res
            self.note(node, "fallback:general-store")
            return self._exec_map(node, env, ctx)
        if isinstance(node, P.MapExpr):
            return self._exec_map(node, env, ctx)
        if isinstance(node, P.Scatter):
            return self._exec_scatter(node, env, ctx)
        if isinstance(node, P.SegmentReduce):
            return self._exec_segment(node, env, ctx)
        if isinstance(node, P.AxisReduce):
            return self._exec_axis_reduce(node, env, ctx)
        if isinstance(node, P.EinsumContract):
            return self._exec_einsum(node, env, ctx)
        if isinstance(node, P.TiledMatmul):
            return self._exec_tiled(node, env, ctx)
        if isinstance(node, P.ScalarReduce):
            return self._exec_scalar_reduce(node, env, ctx)
        if isinstance(node, P.Fused):
            return tuple(self.run_node(p, env, ctx) for p in node.parts)
        raise RejectionError(f"cannot execute plan node {node}")

    # ---- stores ----
    def _eval_dense(self, e, key_axes, ax, binding, env, ctx):
        """Whole-array evaluation of a dense-fastpath value: identity
        gathers resolve to the operand, scalars broadcast.  None when a
        guard fails (caller takes the general grid path)."""
        if isinstance(e, Const):
            return e.value
        if isinstance(e, Var):
            return env[e.name]
        if isinstance(e, (P.Gather, Get)):
            arr = env[e.array]
            from .tiles import TiledMatrix, unpack
            if isinstance(arr, TiledMatrix):
                arr = unpack(arr)
            if arr.dim() != len(key_axes):
                return None
            return self._sliced_operand(arr, key_axes, ax, binding)
        if isinstance(e, BinOp):
            lhs = self._eval_dense(e.lhs, key_axes, ax, binding, env, ctx)
            rhs = self._eval_dense(e.rhs, key_axes, ax, binding, env, ctx)
            if lhs is None or rhs is None:
                return None
            return OPS[e.op](lhs, rhs)
        if isinstance(e, UnOp):
            v = self._eval_dense(e.e, key_axes, ax, binding, env, ctx)
            if v is None:
                return None
            if e.op == "neg":
                return -v
            return torch.logical_not(v) if _is_t(v) else not v
        if isinstance(e, Call):
            args = [self._eval_dense(a, key_axes, ax, binding, env, ctx)
                    for a in e.args]
            if any(a is None for a in args):
                return None
            return FNS[e.fn](*[self._t(a) for a in args])
        return None

    def _exec_dense_map(self, node: P.DenseMap, env, ctx):
        """DenseMap fast path: the pass proved identity indexing; verify
        that the extents cover the destination exactly, then evaluate ONE
        vectorized expression.  None when a guard fails."""
        from .tiles import TiledMatrix
        dest = env[node.dest]
        if isinstance(dest, TiledMatrix):
            return None
        ax, binding, conds, base = self.build_space(node.space, env, ctx)
        if tuple(ax.shape()) != tuple(dest.shape):
            return None          # space must cover the dest exactly
        if ctx.array_limits.get(node.dest) is not None:
            return None          # a padded dest needs the drop path
        val = self._eval_dense(node.value, node.key_axes, ax, binding, env,
                               ctx)
        if val is None:
            return None
        val = self._full(val, ax.shape()).to(dest.dtype)
        self.note(node, "dense-store")
        return val

    def _exec_map(self, node: P.MapExpr, env, ctx):
        ax, binding, conds, base = self.build_space(node.space, env, ctx)
        if node.key_axes is None:          # guarded scalar assignment
            masks = list(base)
            val = self._t(self.eval(node.value, env, ax, binding, masks,
                                    ctx))
            m = self._mask(conds, env, ax, binding, masks, ctx)
            if m is not None:
                old = env.get(node.dest)
                old = torch.zeros_like(val) if old is None else self._t(old)
                return torch.where(m, val, old)
            return val

        dest = env[node.dest]
        masks = list(base)
        val = self.eval(node.value, env, ax, binding, masks, ctx)
        m = self._mask(conds, env, ax, binding, masks, ctx)
        key_axes = node.key_axes
        val = self._full(val, ax.shape())
        perm = [ax.order.index(a) for a in key_axes]
        val = val.permute(perm)
        if m is not None:
            m = m.expand(ax.shape()).permute(perm)
        los = [binding[a][2] for a in key_axes]
        exts = [ax.extent[a] for a in key_axes]
        dest_lim = ctx.array_limits.get(node.dest)
        static0 = all(l == 0 for l in los)
        if tuple(exts) == tuple(dest.shape) and static0 and m is None \
                and dest_lim is None:
            return val.to(dest.dtype)                      # full replace
        grids = list(torch.meshgrid(
            *[los[i] + self._arange(exts[i]) for i in range(len(exts))],
            indexing="ij"))
        keep = m
        if dest_lim is not None:          # pad rows: drop (logical bound)
            ok = grids[0] < dest_lim
            keep = ok if keep is None else (keep & ok)
        if keep is not None:
            grids[0] = torch.where(keep, grids[0], dest.shape[0])  # drop
        return scatter_drop(dest, grids, val)

    def _exec_scatter(self, node: P.Scatter, env, ctx):
        ax, binding, conds, base = self.build_space(node.space, env, ctx)
        dest = env[node.dest]
        masks = list(base)
        val = self.eval(node.value, env, ax, binding, masks, ctx)
        m = self._mask(conds, env, ax, binding, masks, ctx)
        shape = ax.shape()
        val = self._full(val, shape)
        kk = [self._t(self.eval(k, env, ax, binding, masks, ctx))
              .to(torch.int32).expand(shape) for k in node.keys]
        dest_lim = ctx.array_limits.get(node.dest)
        ok = m
        if dest_lim is not None:          # logical bound: pad rows drop
            lim_ok = kk[0] < dest_lim
            ok = lim_ok if ok is None else ok & lim_ok
        if ok is not None:                # condition/pad drops: sentinel
            kk[0] = torch.where(ok, kk[0], dest.shape[0])
        return scatter_drop(dest, kk, val)

    # ---- reductions ----
    def _segment_backend(self, node: P.SegmentReduce, n_rows, dest):
        """Resolve the group-by backend for this node: a pinned backend is
        honored verbatim; "auto" asks the selector with the concrete shape
        class (rows reduced, flattened segment count, dtype, and the
        destination's analyzed sharding)."""
        if node.backend != "auto":
            self.note(node, f"segment:{node.backend}[pinned]")
            return node.backend
        sh = (node.shardings or {}).get(node.dest)
        dec = self.selector.choose_segment(
            n=int(n_rows), k=int(dest.numel()), d=1, op=node.op,
            dtype=str(dest.dtype).replace("torch.", ""),
            dest_dist=sh.dist.name if sh is not None else "REP",
            candidates=node.candidates)
        self.note(node, f"segment:{dec.backend}[{dec.source}]")
        return dec.backend

    def _exec_segment(self, node: P.SegmentReduce, env, ctx):
        ax, binding, conds, base = self.build_space(node.space, env, ctx)
        dest = env[node.dest]
        masks = list(base)
        keys = [self.eval(k, env, ax, binding, masks, ctx)
                for k in node.keys]
        val = self.eval(node.value, env, ax, binding, masks, ctx)
        m = self._mask(conds, env, ax, binding, masks, ctx)
        shape = ax.shape()
        val = self._full(val, shape)
        kk = [self._t(k).to(torch.int32).expand(shape) for k in keys]
        lim0 = ctx.array_limits.get(node.dest)
        n_rows = 1
        for d_ in shape:
            n_rows *= d_
        backend = self._segment_backend(node, n_rows, dest)
        salt_s, salt_src = self._segment_salt(node, ctx, dest)
        if salt_s > 1:
            # hot-key salting: spread every key over S sub-destinations —
            # `key*S + salt` with salt = global row index mod S — reduce a
            # [K·S] partial, then ⊕-fold the [K, S] view back to [K]
            flat, num = self._ravel_keys([k.reshape(-1) for k in kk],
                                         dest.shape, limit0=lim0)
            if m is not None:
                flat = torch.where(m.reshape(-1), flat, num)
            salt = self._arange(flat.shape[0]) % salt_s
            salted = torch.where(flat < num, flat * salt_s + salt,
                                 num * salt_s)
            vflat = val.reshape(-1).to(dest.dtype)
            part = segment_flat(backend, salted, vflat, num * salt_s,
                                node.op)
            part = REDUCE[node.op](part.reshape(num, salt_s), (1,))
            self.note(node, self.decisions.get(id(node), "")
                      + f" salt={salt_s}x[{salt_src}]")
            return COMBINE[node.op](
                dest, part.reshape(dest.shape).to(dest.dtype))
        if backend != "scatter":
            # flattened-segment backends (sort / onehot / pallas): ravel
            # the key tuple against the physical dims, route every dropped
            # row (OOB key, negative key, padded row, failed condition) to
            # the sentinel segment `num`, reduce into a [num] partial and
            # ⊕-combine with the destination
            flat, num = self._ravel_keys([k.reshape(-1) for k in kk],
                                         dest.shape, limit0=lim0)
            if m is not None:
                flat = torch.where(m.reshape(-1), flat, num)  # dropped
            vflat = val.reshape(-1).to(dest.dtype)
            seg = segment_flat(backend, flat, vflat, num, node.op)
            return COMBINE[node.op](
                dest, seg.reshape(dest.shape).to(dest.dtype))
        # scatter-⊕ straight into the destination; rows dropped for any
        # reason (OOB or negative key, failed condition, out-of-range value
        # gather, padded row) go to the sentinel slot
        if m is not None:
            kk[0] = torch.where(m, kk[0], -1)
        if lim0 is not None:      # logical dim-0 bound (padded rows)
            kk[0] = torch.where(kk[0] >= lim0, -1, kk[0])
        return scatter_drop(dest, kk, val, node.op)

    def _segment_salt(self, node: P.SegmentReduce, ctx, dest):
        """Resolve the hot-key salt factor for this node: the static hint
        (`node.salt`) wins; otherwise the caller's run-time probe result
        (`ctx.salts`).  Single-key 1-D destinations only."""
        if len(node.keys) != 1 or dest.dim() != 1:
            return 1, None
        if node.salt is not None:
            return (int(node.salt), "hint") if node.salt > 1 else (1, None)
        s = ctx.salts.get(node.dest)
        if s is not None and int(s) > 1:
            return int(s), "probe"
        return 1, None

    def _ravel_keys(self, kk, dshape, limit0=None):
        """Flatten index tuples against the PHYSICAL dims; `limit0` bounds
        dim-0 keys by the logical row count when the destination rows were
        padded.  int32, as in the reference."""
        num = 1
        for d in dshape:
            num *= d
        flat = torch.zeros_like(kk[0])
        ok = torch.ones_like(kk[0], dtype=torch.bool)
        for dim_i, (k, d) in enumerate(zip(kk, dshape)):
            hi = limit0 if dim_i == 0 and limit0 is not None else d
            ok &= (k >= 0) & (k < hi)
            flat = flat * d + k.clamp(0, max(d - 1, 0))
        flat = torch.where(ok, flat, num)
        return flat, num

    def _keyed_combine(self, dest, partial, key_axes, ax, binding, op,
                       in_key_order, dest_lim=None):
        """⊕ a partial (indexed by the key axes) into dest.  `dest_lim`
        drops rows at or beyond the logical row count (padding)."""
        partial = self._t(partial)
        if not in_key_order:
            cur = [a for a in ax.order if a in key_axes]
            partial = partial.permute([cur.index(a) for a in key_axes])
        los = [binding[a][2] for a in key_axes]
        exts = [ax.extent[a] for a in key_axes]
        static0 = all(l == 0 for l in los)
        if tuple(exts) == tuple(dest.shape) and static0 and dest_lim is None:
            return COMBINE[op](dest, partial.to(dest.dtype))
        rows = los[0] + self._arange(exts[0])
        if dest_lim is not None:
            rows = torch.where(rows < dest_lim, rows, dest.shape[0])
        grids = [
            (rows if i == 0 else los[i] + self._arange(exts[i])).reshape(
                [-1 if j == i else 1 for j in range(len(exts))])
            for i in range(len(exts))]
        return scatter_drop(dest, grids, partial, op)

    def _exec_axis_reduce(self, node: P.AxisReduce, env, ctx):
        ax, binding, conds, base = self.build_space(node.space, env, ctx)
        dest = env[node.dest]
        contracted = node.contracted
        # dense fast path: the value is a certified +-product of gathers —
        # contract with torch.einsum instead of materializing the grid
        if node.product is not None and not conds \
                and self._mxu_masks_ok(node.space, node.key_axes, ctx):
            partial = self._product_partial(node.product, node.key_axes, ax,
                                            binding, env, ctx)
            if partial is not None:
                self.note(node, "mxu-einsum")
                return self._keyed_combine(
                    dest, partial, node.key_axes, ax, binding, "+",
                    in_key_order=True,
                    dest_lim=ctx.array_limits.get(node.dest))
        self.note(node, "dense-grid")
        masks = list(base)
        val = self.eval(node.value, env, ax, binding, masks, ctx)
        m = self._mask(conds, env, ax, binding, masks, ctx)
        val = self._full(val, ax.shape())
        if m is not None:
            val = torch.where(m, val, identity(node.op, val.dtype,
                                               self.device))
        if contracted:
            partial = REDUCE[node.op](
                val, tuple(ax.pos(a) for a in contracted))
        else:
            partial = val
        return self._keyed_combine(dest, partial, node.key_axes, ax, binding,
                                   node.op, in_key_order=False,
                                   dest_lim=ctx.array_limits.get(node.dest))

    # ---- contractions (runtime guards; fall back on failure) ----
    def _mxu_masks_ok(self, space: P.IterSpace, key_axes, ctx) -> bool:
        """A product contraction has no masks: a padded bag would let its
        pad rows contribute, so it takes the masked dense-grid path."""
        return not any(a.kind == "bag" and ctx.bag_limits.get(a.bag)
                       is not None for a in space.axes)

    def _sliced_operand(self, arr, faxes, ax, binding):
        """Slice a contraction operand to the iteration extents along each
        factor axis; None when the window does not fit the operand."""
        for dim_i, (d, axn) in enumerate(zip(arr.shape, faxes)):
            lo = binding[axn][2]
            ext = ax.extent[axn]
            if lo != 0 or ext != d:
                if lo + ext > d:
                    return None
                arr = arr.narrow(dim_i, lo, ext)
        return arr

    def _product_partial(self, ef: P.EinsumFactors, key_axes, ax, binding,
                         env, ctx: ExecContext = _EMPTY_CTX):
        """torch.einsum over the factor gathers; None when an offset/extent
        guard fails (caller falls back).  Factors covering only a subset
        of the key axes come back expanded with size-1 dims."""
        from .tiles import TiledMatrix, unpack
        letters = {a: chr(ord('a') + i) for i, a in enumerate(ax.order)}
        specs = []
        operands = []
        used: set = set()
        for f, faxes in zip(ef.factors, ef.factor_axes):
            arr = env[f.array]
            if isinstance(arr, TiledMatrix):
                arr = unpack(arr)
            spec = "".join(letters[axn]
                           for _, axn in zip(arr.shape, faxes))
            arr = self._sliced_operand(arr, faxes, ax, binding)
            if arr is None:
                return None
            specs.append(spec)
            operands.append(arr)
            used.update(faxes)
        out_axes = [a for a in key_axes if a in used]
        out_spec = "".join(letters[a] for a in out_axes)
        res = torch.einsum(",".join(specs) + "->" + out_spec, *operands)
        if tuple(out_axes) != tuple(key_axes):
            res = torch.reshape(
                res, [ax.extent[a] if a in used else 1 for a in key_axes])
        for o in ef.others:
            res = res * self.eval(o, env, ax, binding, [], ctx)
        return res

    def _terms_partial(self, node: P.EinsumContract, ax, binding, env,
                       ctx: ExecContext = _EMPTY_CTX):
        key_axes = node.key_axes
        contracted = node.contracted
        key_exts = tuple(ax.extent[a] for a in ax.order if a in key_axes)
        cur = [a for a in ax.order if a in key_axes]
        perm = [cur.index(a) for a in key_axes]
        mult = 1
        for a in contracted:
            mult *= ax.extent[a]
        total = None
        for sign, term, ef, free in node.terms:
            if ef is not None:
                part = self._product_partial(ef, key_axes, ax, binding, env,
                                             ctx)
                if part is None:
                    return None
                if free:        # Σ over the contracted axes of a term free
                    part = part * mult      # of them = extent-product × term
            else:               # unrecognized contraction-free term:
                masks: list = []            # grid-evaluate (Σ_j c = |j|·c)
                v = self.eval(term, env, ax, binding, masks, ctx)
                if masks:
                    return None
                v = self._t(v)
                if v.dim() == 0:
                    part = v.expand(key_exts)
                else:  # full-rank with size-1 contracted dims: drop them
                    part = torch.squeeze(
                        v, dim=tuple(ax.pos(a) for a in contracted))
                    part = part.expand(key_exts)
                part = part.permute(perm) * mult
            total = part * sign if total is None else total + part * sign
        for sc in node.scalars:
            total = total * self.eval(sc, env, ax, binding, [], ctx)
        return self._t(total).expand(
            tuple(ax.extent[a] for a in key_axes))

    def _exec_einsum(self, node: P.EinsumContract, env, ctx):
        ax, binding, conds, base = self.build_space(node.space, env, ctx)
        partial = None
        # the candidate set IS the guard chain; op_select="force:dense-grid"
        # narrows it to the fallback, skipping the einsum attempt entirely
        if "einsum" in node.candidates and \
                self._mxu_masks_ok(node.space, node.key_axes, ctx):
            if node.product is not None:
                partial = self._product_partial(node.product, node.key_axes,
                                                ax, binding, env, ctx)
            else:
                partial = self._terms_partial(node, ax, binding, env, ctx)
        if partial is None:
            self.note(node, "fallback:dense-grid")
            return self.run_node(node.fallback, env, ctx)
        self.note(node, "einsum")
        dest = env[node.dest]
        return self._keyed_combine(dest, partial, node.key_axes, ax, binding,
                                   "+", in_key_order=True,
                                   dest_lim=ctx.array_limits.get(node.dest))

    def _exec_tiled(self, node: P.TiledMatmul, env, ctx):
        from .tiles import TiledMatrix, matmul_tiled, unpack
        ein = node.contract
        lhs = env[node.lhs]
        if not isinstance(lhs, TiledMatrix):
            return self.run_node(ein, env, ctx)
        ax, binding, conds, base = self.build_space(node.space, env, ctx)
        if base:
            return self.run_node(ein, env, ctx)
        # packed lhs must be used at full extent (no slicing on tiles)
        for d, axn in zip(lhs.shape, ein.product.factor_axes[0]):
            if binding[axn][2] != 0 or ax.extent[axn] != d:
                return self.run_node(ein, env, ctx)
        rhs = env[node.rhs]
        if isinstance(rhs, TiledMatrix):
            rhs = unpack(rhs)
        rhs = self._sliced_operand(rhs, ein.product.factor_axes[1], ax,
                                   binding)
        if rhs is None:
            return self.run_node(ein, env, ctx)
        # packed lhs, guards passed: op_select decides whether the
        # block-sparse tile kernel or unpack+einsum contracts.  A single-
        # element candidate set (op_select="force:<b>") is honored verbatim
        if len(node.candidates) == 1:
            choice, src = node.candidates[0], "pinned"
        else:
            dec = self.selector.choose_contract(
                m=int(lhs.shape[0]), k=int(lhs.shape[1]),
                n=int(rhs.shape[1]), candidates=node.candidates)
            choice, src = dec.backend, dec.source
        if choice == "unpack-einsum":
            self.note(node, f"tiled:unpack-einsum[{src}]")
            return self.run_node(ein, env, ctx)
        self.note(node, f"tiled:pallas-tiled[{src}]")
        res = matmul_tiled(lhs, rhs)
        for o in ein.product.others:
            res = res * self.eval(o, env, ax, binding, [], ctx)
        dest = env[node.dest]
        return self._keyed_combine(dest, res, ein.key_axes, ax, binding,
                                   "+", in_key_order=True,
                                   dest_lim=ctx.array_limits.get(node.dest))

    # ---- scalar reductions ----
    def _total_reduce(self, node: P.ScalarReduce, env, ax, binding, conds,
                      base, ctx: ExecContext = _EMPTY_CTX):
        masks: list = []
        if node.bool_any is not None and not base:
            # peephole: max/min over float(bool) → any/all (same result)
            b = self.eval(node.bool_any, env, ax, binding, masks, ctx)
            if not masks and ax.order:
                b = self._t(b)
                b = b if b.dtype == torch.bool else b != 0
                red = torch.any if node.op == "max" else torch.all
                return red(b).to(torch.float32)
        masks = list(base)
        val = self.eval(node.value, env, ax, binding, masks, ctx)
        m = self._mask(conds, env, ax, binding, masks, ctx)
        val = self._full(val, ax.shape()) if ax.order else self._t(val)
        if m is not None:
            val = torch.where(m, val, identity(node.op, val.dtype,
                                               self.device))
        return REDUCE[node.op](val) if ax.order else val

    def _exec_scalar_reduce(self, node: P.ScalarReduce, env, ctx):
        ax, binding, conds, base = self.build_space(node.space, env, ctx)
        total = self._total_reduce(node, env, ax, binding, conds, base, ctx)
        dest = self._t(env[node.dest])
        if node.point is not None:      # Rule 16: one-cell ⊕ update
            pt = tuple(node.point)
            if len(pt) != dest.dim() or not all(
                    -d <= p < d for p, d in zip(pt, dest.shape)):
                return dest             # out-of-range cell: dropped
            out = dest.clone()
            out[pt] = COMBINE[node.op](out[pt], total.to(dest.dtype))
            return out
        return COMBINE[node.op](dest, total.to(dest.dtype))

    # ---- sequential loop ----
    def _exec_seq_loop(self, node: P.SeqLoop, env, ctx):
        """A host loop: the condition costs one device sync per iteration.
        Each iteration sees the env as it was before the loop plus the
        current carry; only the carry leaves the loop (the reference's
        while_loop semantics)."""
        carry = {n: self._t(env[n]) for n in node.carry}
        while True:
            e2 = dict(env)
            e2.update(carry)
            if not bool(self.eval(node.cond, e2, Axes(), {}, [], ctx)):
                break
            self.execute(node.body, e2, ctx)
            carry = {n: self._t(e2[n]) for n in node.carry}
        env.update(carry)

    def eval_scalar(self, e, env):
        """Evaluate an expression outside any iteration space."""
        return self.eval(e, env, Axes(), {}, [])


# ---------------------------------------------------------------------------
# program compilation
# ---------------------------------------------------------------------------

def resolve_device(device) -> torch.device:
    """The device a program runs on.  CUDA is the default; without a card
    that raises, and a caller that wants the CPU says so."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class CompiledProgram:
    def __init__(self, prog: Program, target, optimize_contractions=True,
                 op_select="cost", autotune_cache=None,
                 compile_mode="eager", skew_salting="auto", device="cuda"):
        if compile_mode == "whole":
            raise NotImplementedError(
                "compile_mode='whole' is not ported yet (ROADMAP.md, "
                "Queue 1: whole-program compilation); use 'eager'")
        if compile_mode != "eager":
            raise ValueError(f"unknown compile_mode {compile_mode!r}")
        self.program = prog
        self.target = target
        self.device = resolve_device(device)
        self.compile_mode = compile_mode
        from .op_select import CACHE_FILE, OpSelector
        if autotune_cache is None:
            autotune_cache = CACHE_FILE
        self.config = PlanConfig(optimize_contractions=optimize_contractions,
                                 op_select=op_select,
                                 autotune_cache=autotune_cache,
                                 skew_salting=skew_salting)
        self.plan = plan_program(target, prog, self.config)
        from .dist_analysis import collect
        self.dists = collect(self.plan)   # array → Dist (pass-8 annotations)
        self.selector = OpSelector(op_select, cache_path=autotune_cache,
                                   platform=self.device.type,
                                   device=str(self.device))
        self.executor = PlanExecutor(prog, self.selector, self.device)

    def explain(self, tiled=()) -> str:
        """Spark-EXPLAIN-style dump of the chosen physical operator per
        statement.  `tiled` names params assumed to arrive §5-packed.
        After a run(), nodes whose backend the operator-selection
        subsystem resolved carry a `selected:` line (e.g.
        ``selected: segment:pallas[cost]``)."""
        text = P.explain(self.plan, self.program.name, tiled,
                         decisions=self.executor.decisions)
        return text + f"\nwhole-program: mode={self.compile_mode}"

    # -- public execution interface --
    def execute(self, env: dict, *, bag_limits=None, array_limits=None,
                nodes=None, salts=None) -> None:
        ctx = ExecContext(bag_limits or {}, array_limits or {}, salts or {})
        self.executor.execute(self.plan if nodes is None else nodes, env, ctx)

    def prepare_env(self, inputs: dict) -> dict:
        """Inputs on this program's device in the reference's canonical
        dtypes (convert.inputs_from_numpy)."""
        from ..convert import inputs_from_numpy
        return inputs_from_numpy(inputs, self.device, self.program.params)

    def run(self, inputs: dict) -> dict:
        """Run the plan eagerly on this program's device.  A failure
        surfaces as an exception; nothing descends to another rung."""
        env = self.prepare_env(inputs)
        self.execute(env, salts=collect_salts(
            self.plan, env, self.selector, self.config.skew_salting))
        return {n: env[n] for n in self.program.outputs}


def compile_program(fn_or_prog, *, optimize_contractions=True,
                    op_select="cost", autotune_cache=None,
                    compile_mode="eager", skew_salting="auto",
                    device="cuda") -> CompiledProgram:
    """Front door: loop program → restrictions check (Def. 3.1) →
    comprehension translation (Fig. 2) → pass pipeline (passes.py) →
    executable physical plan on `device` ("cuda" by default; "cpu" must be
    asked for).

    op_select picks the group-by-⊕ backend policy: "cost" (default)
    resolves each SegmentReduce's backend from the analytical shape-class
    cost model; "autotune" measures every candidate once per shape class
    and persists the winner to `autotune_cache` (default
    `.repro_torch_autotune.json`); "force:<backend>" pins one backend
    everywhere its candidate set allows ("force:pallas" pins the CUDA
    segment kernel).  optimize_contractions=False is the paper-faithful
    plan (no einsum recognition).  skew_salting picks the hot-key salting
    policy: "auto", "off" or "force:<S>".  compile_mode: only "eager" is
    ported.  The planner's other switches keep the reference's defaults."""
    prog = fn_or_prog if isinstance(fn_or_prog, Program) \
        else fn_or_prog.program
    check_restrictions(prog)
    target = translate(prog)
    return CompiledProgram(prog, target, optimize_contractions, op_select,
                           autotune_cache, compile_mode, skew_salting, device)
