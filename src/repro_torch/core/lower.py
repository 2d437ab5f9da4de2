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

run() is the reference's: whole-program mode by default (graphs.py: the
plan captured into CUDA graphs, one entry per compile-cache signature for
the WHOLE_ENTRIES latest signatures, a signature whose entry fails to build
sitting out `policy.disable_ttl` runs), the per-node eager path under it,
and, for a program the caller put on the CPU, the sequential interpreter at
the bottom of the fault ladder (faults.py, a copy of the reference's; on
the card an error that persists at the eager level surfaces).  A capacity
error takes the out-of-core rung (chunked.py), whole → chunked and eager →
chunked, and a call whose memest estimate exceeds `memory_budget` streams
from the start; `run_stepwise` is the checkpointable entry (host loops
numbered, an observer after each iteration or chunk).

`donate=True` donates the mutated destinations and loop carries of the
whole-program path: a caller's tensor on the program's device given for one
is consumed, and the output that takes its place is the entry's buffer,
costing no copy when the caller feeds it back (graphs.py).  The serving
hooks (`canonical_inputs`, `entry_signature`, `bag_row_aligned`,
`batched_call`) are the reference's: the batched call runs B padded
requests of one signature as the lanes of one entry of CUDA graphs
(graphs.BatchEntry), each lane bit-identical to its request's solo run():
a row count on the host cuts a lane's rows (the CPU), one on the device
masks them and the segment kernel reads it there (the card), where
`pads_exactly` says which programs may be padded at all; `request_salts`
salts a lane's hot keys as its solo run does.  Under `lanes()` (a batched
entry's runs) a group-by on the segment kernel is held (`_Held`) until
every lane has run its node, and the lanes' rows are reduced by one call
of the kernel's lanes entry (`settle`).
"""
from __future__ import annotations

import numbers
import operator
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from . import faults as F
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


def segment_flat(backend: str, ids, vals, num: int, op: str, rows=None):
    """[N]-flat segment-⊕ partial via the chosen backend.  `ids` == `num`
    marks dropped rows; the partial's row i is the ⊕ of all vals whose
    id == i, with the ⊕ identity for empty segments.

    `rows` (a lane padded on the card, its count on the device): the
    segment kernel reduces the first `rows` rows alone, with the bits of a
    call over them; the padded rows are routed to the sentinel already, so
    every other backend, which takes only sums whose order does not show
    (integer sums, min, max), ignores it."""
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
        return kops.segment_reduce(ids, vals, num, op=op, n_rows=rows)
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


class ShardOffset(int):
    """A row offset that differs between the ranks of a distributed round
    (rank × block rows).  It is a python int on each rank, but the
    executor treats it as the reference treats a traced offset inside a
    shard_map round: no guard may take a path because of its value (shard
    0's offset of 0 is not a static 0), so every rank runs the same
    materialization of a node."""

    __slots__ = ()


def _static(lo) -> bool:
    """An offset every rank shares (a python int that is no ShardOffset)."""
    return isinstance(lo, int) and not isinstance(lo, ShardOffset)


@dataclass(frozen=True)
class ExecContext:
    """Per-call plan parameters.

      bag_offsets     bag → global index of the first row its columns hold
                      (a chunk of an out-of-core stream is a window of the
                      bag, a rank's block of a sharded bag another): the
                      bag index var is global, so a store keyed by it
                      writes the window's own rows
      bag_limits      bag → logical row count when its columns were padded
                      (a serving bucket, a bag padded to a multiple of the
                      ranks): rows whose GLOBAL index is at or beyond it
                      are masked
      row_offsets     array → global row index of the rank's block's first
                      row (distributed.py): the executor subtracts it, so
                      dim-0 reads and writes of the array target the block
      array_limits    array → logical dim-0 length of a padded dense array:
                      reads beyond it are masked and writes dropped, so pad
                      rows never change a result (paper §3.4)
      axis_overrides  range-axis var → (offset, extent, limit, total): a
                      distributed round localizes the axis to the rank's
                      row block like a sharded bag axis (offset globalizes
                      the index var, rows beyond `limit` are masked).
                      `total` is the padded global extent (ranks ×
                      extent), the bounds certificate for slicing a
                      replicated operand per rank: offset + extent ≤ total,
                      so when total ≤ the operand's dim the window cannot
                      leave it (DESIGN.md §7)
      aligned         alignment certificates: names whose dim-0 block is
                      exactly the round axis' window, so the executor may
                      take its window start as local row 0
      salts           group-by dest → salt factor the run-time hot-key
                      probe chose (op_select.probe_hot_fraction +
                      choose_salt)
      partials        group-by dest → its running [K] partial (None before
                      the first range), for the chunk steps of an
                      out-of-core run on the card (chunked.py): a node of
                      a flattened backend folds its segment results into
                      the partial range by range, in row order, and leaves
                      the destination as it is, so that the stream's fold
                      is the all-resident one (the segment kernel's order
                      is fixed by ranges of RANGE_ROWS rows)

    Per-rank offsets are ShardOffsets (see there)."""
    bag_offsets: dict = field(default_factory=dict)
    bag_limits: dict = field(default_factory=dict)
    row_offsets: dict = field(default_factory=dict)
    array_limits: dict = field(default_factory=dict)
    axis_overrides: dict = field(default_factory=dict)
    aligned: frozenset = frozenset()
    salts: dict = field(default_factory=dict)
    partials: dict = field(default_factory=dict)


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
    from ..convert import canonical_numpy
    from .op_select import PROBE_ROWS, probe_hot_fraction
    # the column may be the caller's host array (distributed.py probes the
    # global inputs, which every rank holds)
    hot = probe_hot_fraction(canonical_numpy(_host(c[:min(n, PROBE_ROWS)])))
    dec = selector.choose_salt(n=n, k=int(dest.shape[0]), op=node.op,
                               nshards=nshards, hot_frac=hot)
    return int(dec.backend.split(":", 1)[1]) \
        if dec.backend.startswith("salt:") else 1


def collect_salts(nodes, env, selector, skew_salting: str, *,
                  nshards: int = 1, bag_limits=None) -> dict:
    """dest → salt factor for every probe-decided group-by in the plan
    (walks SeqLoop bodies and fused regions)."""
    out: dict = {}
    for n in _leaf_nodes(nodes):
        s = salt_for_node(n, env, selector, skew_salting, nshards=nshards,
                          bag_limits=bag_limits)
        if s > 1:
            out[n.dest] = s
    return out


def _leaf_nodes(nodes):
    # a module-level generator, not a closure that calls itself: such a
    # closure is a reference cycle, and one that holds `env` would keep a
    # run's every value alive until the cyclic garbage collector runs
    for n in nodes:
        if isinstance(n, P.SeqLoop):
            yield from _leaf_nodes(n.body)
        elif isinstance(n, (P.Fused, P.FusedRound)):
            yield from _leaf_nodes(n.parts)
        else:
            yield n


def _on_device(count) -> bool:
    """A row count that lies on a device (a served lane's on the card),
    which the executor masks by instead of cutting the rows."""
    return _is_t(count) and count.device.type != "cpu"


def _lane_rows(space: P.IterSpace, ax: "Axes", ctx: ExecContext):
    """The flattened rows of a lane padded on the card (its count on the
    device): None unless the space's leading axis is a bag under such a
    count and every other axis is a range; then the lane's own rows are
    the first count · (the other extents) rows of the flattened space, in
    the order of its solo run's."""
    if not ctx.bag_limits or not space.axes:
        return None
    lead = space.axes[0]
    if lead.kind != "bag" or not _on_device(ctx.bag_limits.get(lead.bag)) \
            or ctx.bag_offsets.get(lead.bag) \
            or any(a.kind == "bag" for a in space.axes[1:]):
        return None
    rest = 1
    for a in ax.order[1:]:
        rest *= ax.extent[a]
    lim = ctx.bag_limits[lead.bag]
    return lim * rest if rest != 1 else lim


def pads_exactly(plan, program: Program, device) -> bool:
    """Whether a served lane padded past its rows keeps the bits of its
    solo run on `device`.  On the CPU the executor cuts a lane's rows (its
    count is known on the host), so it always does.  On the card a lane
    runs over the padded rows, masked by its count on the device: maps,
    stores, min and max, and integer sums give the bits of the unpadded
    rows in any order, and a float + group-by whose space leads with the
    bag reduces through the segment kernel's device-count entry.  A float
    sum or product over a bag reduced any other way (a total or an axis
    reduction, a contraction) adds in an order that follows the padded
    length: the serving layer runs such a program at its requests' own
    shapes."""
    if torch.device(device).type == "cpu":
        return True
    for n in _leaf_nodes(plan):
        space = getattr(n, "space", None)
        if space is None or not any(a.kind == "bag" for a in space.axes) \
                or isinstance(n, (P.MapExpr, P.DenseMap, P.Scatter,
                                  P.Rebalance)):
            continue
        op = getattr(n, "op", None)
        t = program.params.get(getattr(n, "dest", None))
        if op in ("min", "max") or (t is not None and t.dtype != "float"):
            continue
        if isinstance(n, P.SegmentReduce) and op == "+" \
                and space.axes[0].kind == "bag" \
                and not any(a.kind == "bag" for a in space.axes[1:]) \
                and (n.backend == "pallas" or (
                    n.backend == "auto"
                    and "pallas" in (n.candidates or ()))):
            continue
        return False
    return True


class _Held:
    """A group-by's segment-kernel reduction held back until every lane of
    a batch has run its node: the lane's flat ids and values, its row count
    on the device (None: all its rows), and `then`, which makes the node's
    value of the [num] partial."""

    __slots__ = ("ids", "vals", "num", "op", "rows", "then", "value")

    def __init__(self, ids, vals, num, op, rows, then):
        self.ids, self.vals, self.num, self.op = ids, vals, num, op
        self.rows, self.then = rows, then
        self.value = None


def _lane_counts(held: list) -> torch.Tensor:
    """The [B] int32 row counts of held reductions: the [B] tensor the
    lanes' counts are consecutive elements of (a batch's own counts), else
    one stacked on the device, a lane with no count counting all its
    rows."""
    rows = [h.rows for h in held]
    r0 = rows[0]
    if r0 is not None and all(
            r is not None and r.dtype == torch.int32 and r.dim() == 0
            and r.untyped_storage().data_ptr()
            == r0.untyped_storage().data_ptr()
            and r.data_ptr() == r0.data_ptr() + 4 * b
            for b, r in enumerate(rows)):
        return r0.as_strided((len(rows),), (1,))
    return torch.stack([
        h.rows.to(torch.int32) if h.rows is not None else
        torch.full((), h.ids.shape[0], dtype=torch.int32,
                   device=h.ids.device) for h in held])


def _reduce_held(held: list) -> None:
    """Each held reduction's value: the lanes of one group-by shape (K, op,
    value and id dtypes, value width; on the card also the rows, which a
    launch's lanes share, where the CPU's counts cut each lane's) reduced
    by one `segment_reduce_lanes` call."""
    from ..kernels import ops as kops
    groups: dict = {}
    for h in held:
        key = (h.num, h.op, h.vals.dtype, h.ids.dtype, h.vals.device,
               tuple(h.vals.shape[0 if h.vals.is_cuda else 1:]))
        groups.setdefault(key, []).append(h)
    for (num, op, *_), lanes in groups.items():
        res = kops.segment_reduce_lanes([h.ids for h in lanes],
                                        [h.vals for h in lanes], num,
                                        _lane_counts(lanes), op=op)
        for h, r in zip(lanes, res):
            h.value = h.then(r)


def _settled(v):
    if isinstance(v, _Held):
        return v.value
    if isinstance(v, tuple) and any(isinstance(x, _Held) for x in v):
        return tuple(_settled(x) for x in v)
    return v


# ---------------------------------------------------------------------------
# plan executor
# ---------------------------------------------------------------------------

class PlanExecutor:
    def __init__(self, prog: Program, selector=None, device="cuda"):
        self.prog = prog
        self.device = resolve_device(device)
        # id(node) → the materialization the executor last chose for it
        # ("einsum", "dense-store", "segment:pallas[cost]", …);
        # CompiledProgram.explain() reads it
        self.decisions: dict = {}
        self._selector = selector
        # the `lower.node` injection site fires (off while graphs.py replays
        # a region on the CPU or warms up before a capture)
        self.sites = True
        # while a set: the ids of the stores that replaced their whole
        # destination without reading its old value (graphs.py stages no
        # input that such a store writes before anything reads it)
        self.replaced = None
        # under lanes(): the group-bys held for one lanes launch
        self.held = None

    @property
    def selector(self):
        if self._selector is None:
            from .op_select import OpSelector
            self._selector = OpSelector(platform=self.device.type,
                                        device=str(self.device))
        return self._selector

    def note(self, node, tag: str) -> None:
        self.decisions[id(node)] = tag

    def _replace(self, node, val):
        if self.replaced is not None:
            self.replaced.add(id(node))
        return val

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
                ov = ctx.axis_overrides.get(a.var)
                if ov is not None:      # localized to the rank's row block
                    off, ext, _lim, _tot = ov
                    ax.add(a.var, ext)
                    binding[a.var] = ("range", a.var, off)
                    continue
                lo = self.static_int(a.lo, env)
                hi = self.static_int(a.hi, env)
                ax.add(a.var, max(hi - lo, 0))
                binding[a.var] = ("range", a.var, lo)
            else:
                bagv = env[a.bag]
                cols = bagv if isinstance(bagv, tuple) else (bagv,)
                n = int(cols[0].shape[0])
                off = ctx.bag_offsets.get(a.bag, 0)
                lim = ctx.bag_limits.get(a.bag)
                if lim is not None and not _on_device(lim):
                    # a count the host knows cuts the rows: the space is
                    # the unpadded bag's, and so is every reduction's order
                    n = max(0, min(n, int(lim) - int(off)))
                ax.add(a.var, n)
                binding[a.var] = ("range", a.var, off)
        base_masks = []
        for a in space.axes:
            if a.kind == "range":
                ov = ctx.axis_overrides.get(a.var)
                if ov is not None and ov[2] is not None:
                    off, ext, lim, _tot = ov  # mask rows ≥ the logical extent
                    base_masks.append(ax.expand(
                        (off + self._arange(ext)) < lim, a.var))
                continue
            bagv = env[a.bag]
            cols = bagv if isinstance(bagv, tuple) else (bagv,)
            n = ax.extent[a.var]
            for j, v in enumerate(a.vals):
                c = cols[j]
                binding[v] = ("bagval", a.var,
                              c if c.shape[0] == n else c[:n])
            lim = ctx.bag_limits.get(a.bag)
            if _on_device(lim):          # a count on the device masks them
                off = binding[a.var][2]
                base_masks.append(ax.expand(
                    (off + self._arange(n)) < lim, a.var))
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
            # padded or localized array never qualifies, its extent is not
            # its dim
            bc_ok = e.broadcast_ok if isinstance(e, P.Gather) else True
            window = bc_ok and self._window_read(e, arr, ax, binding, ctx)
            if bc_ok and len(e.idxs) == arr.dim() and (window or (
                    e.array not in ctx.row_offsets and
                    e.array not in ctx.array_limits)) and \
                    all(isinstance(ix, Var) and ix.name in binding
                        and binding[ix.name][0] == "range"
                        and ((dim_i == 0 and window) or (
                            _static(binding[ix.name][2])
                            and binding[ix.name][2] == 0
                            and ax.extent[ix.name] == d))
                        for dim_i, (ix, d) in enumerate(zip(e.idxs,
                                                           arr.shape))) and \
                    len({ix.name for ix in e.idxs}) == len(e.idxs):
                names = [ix.name for ix in e.idxs]
                if window:
                    # the rank's block read from its first row: the window
                    # is the array's own leading rows (a view)
                    v0 = e.idxs[0].name
                    off = binding[v0][2]
                    arr = arr.narrow(0, 0, ax.extent[v0])
                    lim = ctx.array_limits.get(e.array)
                    if lim is not None:     # logical bound, global coords
                        masks.append(ax.expand(
                            (off + self._arange(ax.extent[v0])) < lim, v0))
                shape = [1] * len(ax.order)
                perm_src = sorted(names, key=ax.pos)
                a2 = arr.permute([names.index(a) for a in perm_src])
                for a in perm_src:
                    shape[ax.pos(a)] = ax.extent[a]
                return torch.reshape(a2, shape)
            idxs = [self.eval(i, env, ax, binding, masks, ctx)
                    for i in e.idxs]
            off = ctx.row_offsets.get(e.array)
            lim = ctx.array_limits.get(e.array)
            cooked = []
            for dim_i, (d, ix) in enumerate(zip(arr.shape, idxs)):
                ix = self._t(ix).to(torch.int32)
                if dim_i == 0:
                    if lim is not None:     # logical bound, global coords
                        masks.append(ix < lim)
                    if off is not None:     # localize to the rank's block
                        ix = ix - off
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

    @staticmethod
    def _window_read(e, arr, ax, binding, ctx) -> bool:
        """A read of a localized array under an alignment certificate whose
        leading index is an iteration axis starting at the block's own
        offset: it reads the block's first rows, in order, as they are."""
        off = ctx.row_offsets.get(e.array)
        if e.array not in ctx.aligned or not isinstance(off, ShardOffset) \
                or not e.idxs or not isinstance(e.idxs[0], Var):
            return False
        b = binding.get(e.idxs[0].name)
        return (b is not None and b[0] == "range"
                and isinstance(b[2], ShardOffset) and int(b[2]) == int(off)
                and ax.extent[e.idxs[0].name] <= arr.shape[0])

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
                if node.cond is None and getattr(node, "chunk_bag", None):
                    # a ChunkLoop (chunked.py) reaching the plain executor:
                    # the whole bag is resident here, so the stream
                    # degrades to one all-resident "tile" — plain
                    # sequencing of the body, same results
                    self.execute(node.body, env, ctx)
                    continue
                self._exec_seq_loop(node, env, ctx)
            elif isinstance(node, P.FusedRound):
                # round-fusion region: plain sequencing on a single device
                self.execute(node.parts, env, ctx)
            else:
                self.assign(node, env,
                            self.settle([self.run_node(node, env, ctx)])[0])

    @contextmanager
    def lanes(self):
        """Around a batched entry's runs: each group-by on the segment
        kernel is held (run_node returns a `_Held` in its place) until
        `settle`, which reduces the held lanes in one lanes call.  A node
        that `execute` runs is settled at once, as a batch of one lane."""
        prev, self.held = self.held, []
        try:
            yield
        finally:
            self.held = prev

    def settle(self, values: list) -> list:
        """`values` (one node's run_node results, a lane each) with the
        group-bys held since the last settle reduced."""
        if self.held:
            held, self.held = self.held, []
            _reduce_held(held)
        return [_settled(v) for v in values]

    @staticmethod
    def assign(node, env, v) -> None:
        """A node's settled value into the env: one destination, or each
        part's of a Fused node."""
        if isinstance(node, P.Fused):
            for part, x in zip(node.parts, v):
                env[part.dest] = x
        else:
            env[node.dest] = v

    def run_node(self, node, env, ctx: ExecContext = _EMPTY_CTX):
        # per-node guard site: under a capture it fires at capture time only
        # (graphs.py), as the reference's fires at trace time only
        if self.sites:
            F.site("lower.node", node=type(node).__name__)
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
            # pad_ok=False: a store must DROP out-of-range writes (keep the
            # old destination), which zero-padding cannot emulate
            return self._sliced_operand(arr, e.array, key_axes, ax, binding,
                                        ctx, pad_ok=False)
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
        lim = None
        for pos, a in enumerate(node.space.axes):
            ov = ctx.axis_overrides.get(a.var)
            if ov is not None:
                if pos != 0:     # only the round axis may be localized
                    return None
                lim = ov[2]
        if tuple(ax.shape()) != tuple(dest.shape):
            return None          # space must cover the dest exactly
        if ctx.array_limits.get(node.dest) is not None \
                and node.dest not in ctx.aligned:
            return None          # a padded global dest needs the drop path
        val = self._eval_dense(node.value, node.key_axes, ax, binding, env,
                               ctx)
        if val is None:
            return None
        val = self._full(val, ax.shape()).to(dest.dtype)
        self.note(node, "dense-store")
        if lim is None:
            return self._replace(node, val)
        # keep the (zero) pad rows beyond the limit: the store reads dest
        ov = ctx.axis_overrides[node.space.axes[0].var]
        keep = (ov[0] + self._arange(ov[1])) < lim
        return torch.where(keep.reshape((-1,) + (1,) * (val.dim() - 1)),
                           val, dest)

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
            return self._replace(node, val)

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
        dest_off = ctx.row_offsets.get(node.dest)
        dest_lim = ctx.array_limits.get(node.dest)
        static0 = all(_static(l) and l == 0 for l in los)
        if tuple(exts) == tuple(dest.shape) and static0 and m is None \
                and dest_lim is None:
            return self._replace(node, val.to(dest.dtype))  # full replace
        if self._window_at_row0(node.dest, los, exts, dest, dest_off, ctx):
            # alignment certificate: the store's window is the first rows
            # of the rank's block, so it writes them in place of an index
            # grid (a round of kmeans' D: 2^24 × 64 cells)
            val = val.to(dest.dtype)
            keep = m
            if dest_lim is not None:
                ok = (los[0] + self._arange(exts[0])) < dest_lim
                ok = ok.reshape((-1,) + (1,) * (val.dim() - 1))
                keep = ok if keep is None else keep & ok
            win = dest[:exts[0]]
            new = val if keep is None else torch.where(keep, val, win)
            if exts[0] == dest.shape[0]:
                return new
            return torch.cat([new, dest[exts[0]:]])
        grids = list(torch.meshgrid(
            *[los[i] + self._arange(exts[i]) for i in range(len(exts))],
            indexing="ij"))
        keep = m
        if dest_lim is not None:          # pad rows: drop (logical bound)
            ok = grids[0] < dest_lim
            keep = ok if keep is None else (keep & ok)
        if dest_off is not None:          # localize rows to the rank's block
            grids[0] = grids[0] - dest_off
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
        dest_off = ctx.row_offsets.get(node.dest)
        dest_lim = ctx.array_limits.get(node.dest)
        ok = m
        if dest_lim is not None:          # logical bound: pad rows drop
            lim_ok = kk[0] < dest_lim
            ok = lim_ok if ok is None else ok & lim_ok
        if dest_off is not None:          # localize to the rank's block
            kk[0] = kk[0] - dest_off
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
        rows = _lane_rows(node.space, ax, ctx)
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
            # the GLOBAL row index keeps the assignment independent of how
            # the bag was cut into windows
            off = 0
            lead = node.space.axes[0] if node.space.axes else None
            if lead is not None and lead.kind == "bag":
                off = int(ctx.bag_offsets.get(lead.bag, 0))
            salt = (off + self._arange(flat.shape[0])) % salt_s
            salted = torch.where(flat < num, flat * salt_s + salt,
                                 num * salt_s)
            vflat = val.reshape(-1).to(dest.dtype)
            self.note(node, self.decisions.get(id(node), "")
                      + f" salt={salt_s}x[{salt_src}]")

            def unsalt(part):
                part = REDUCE[node.op](part.reshape(num, salt_s), (1,))
                return COMBINE[node.op](
                    dest, part.reshape(dest.shape).to(dest.dtype))
            return self._segment(backend, salted, vflat, num * salt_s,
                                 node.op, rows, unsalt)
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
            if node.dest in ctx.partials:
                # a chunk step (segment kernel): fold into the running
                # partial, range by range; the destination takes it after
                # the last chunk
                from ..kernels import ops as kops
                ctx.partials[node.dest] = kops.segment_reduce(
                    flat, vflat, num, op=node.op,
                    init=ctx.partials[node.dest])
                return dest
            return self._segment(
                backend, flat, vflat, num, node.op, rows,
                lambda seg: COMBINE[node.op](
                    dest, seg.reshape(dest.shape).to(dest.dtype)))
        # scatter-⊕ straight into the destination; rows dropped for any
        # reason (OOB or negative key, failed condition, out-of-range value
        # gather, padded row) go to the sentinel slot
        if m is not None:
            kk[0] = torch.where(m, kk[0], -1)
        if lim0 is not None:      # logical dim-0 bound (padded rows)
            kk[0] = torch.where(kk[0] >= lim0, -1, kk[0])
        return scatter_drop(dest, kk, val, node.op)

    def _segment(self, backend, ids, vals, num, op, rows, then):
        """`then` of the [num] partial of a flattened group-by; under
        lanes() a segment-kernel one is held for the lanes launch."""
        if backend != "pallas" or self.held is None:
            return then(segment_flat(backend, ids, vals, num, op, rows))
        held = _Held(ids, vals, num, op, rows, then)
        self.held.append(held)
        return held

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
                       in_key_order, dest_lim=None, dest_off=None,
                       dest_name=None, ctx: ExecContext = _EMPTY_CTX):
        """⊕ a partial (indexed by the key axes) into dest.  `dest_off`
        localizes dim-0 rows to the rank's block; `dest_lim` drops rows at
        or beyond the logical row count (padding)."""
        partial = self._t(partial)
        if not in_key_order:
            cur = [a for a in ax.order if a in key_axes]
            partial = partial.permute([cur.index(a) for a in key_axes])
        los = [binding[a][2] for a in key_axes]
        exts = [ax.extent[a] for a in key_axes]
        # alignment certificate: the destination's block IS the round
        # axis' window, so the window starts at local row 0.  Rows beyond
        # the logical limit carry the ⊕ identity in the partial (masked
        # upstream), so the whole-block combine leaves pad rows alone
        if dest_name is not None and dest_name in ctx.aligned and key_axes \
                and key_axes[0] in ctx.axis_overrides \
                and isinstance(los[0], ShardOffset) \
                and exts[0] == dest.shape[0]:
            los[0] = 0
            dest_off = None
            dest_lim = None
        static0 = all(_static(l) and l == 0 for l in los)
        if tuple(exts) == tuple(dest.shape) and static0 and dest_lim is None:
            return COMBINE[op](dest, partial.to(dest.dtype))
        rows = los[0] + self._arange(exts[0])
        if dest_lim is not None:
            ok = rows < dest_lim
            local = rows if dest_off is None else rows - dest_off
            rows = torch.where(ok, local, dest.shape[0])
        elif dest_off is not None:
            rows = rows - dest_off
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
                partial = self._limit_mask_partial(partial, node.key_axes,
                                                   ctx)
                self.note(node, "mxu-einsum")
                return self._keyed_combine(
                    dest, partial, node.key_axes, ax, binding, "+",
                    in_key_order=True, **self._dest_args(node, ctx))
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
                                   **self._dest_args(node, ctx))

    # ---- contractions (runtime guards; fall back on failure) ----
    @staticmethod
    def _window_at_row0(name, los, exts, dest, dest_off, ctx) -> bool:
        """A store's window, under an alignment certificate, starts at the
        first row of the rank's block of `name` (its leading key starts
        at the block's own offset) and lies inside it."""
        return (dest_off is not None and name in ctx.aligned
                and len(los) == dest.dim() and los
                and isinstance(los[0], ShardOffset)
                and int(los[0]) == int(dest_off)
                and exts[0] <= dest.shape[0]
                and all(_static(l) and l == 0 for l in los[1:])
                and tuple(exts[1:]) == tuple(dest.shape[1:]))

    @staticmethod
    def _dest_args(node, ctx) -> dict:
        return dict(dest_lim=ctx.array_limits.get(node.dest),
                    dest_off=ctx.row_offsets.get(node.dest),
                    dest_name=node.dest, ctx=ctx)

    def _mxu_masks_ok(self, space: P.IterSpace, key_axes, ctx) -> bool:
        """A product contraction has no masks.  A bag padded under a count
        on the device would let its pad rows contribute, so it takes the
        masked dense-grid path (a count on the host cut the rows); of the
        localized range axes only the LEADING KEY axis may carry a pad
        limit (its rows beyond it are zeroed by `_limit_mask_partial`)."""
        for a in space.axes:
            if a.kind == "bag":
                if _on_device(ctx.bag_limits.get(a.bag)):
                    return False
            else:
                ov = ctx.axis_overrides.get(a.var)
                if ov is not None and ov[2] is not None and \
                        (not key_axes or a.var != key_axes[0]):
                    return False
        return True

    def _limit_mask_partial(self, partial, key_axes, ctx):
        """Zero the partial's leading rows beyond the round axis' limit
        (padding): zero is the + identity, so the combine never perturbs
        the destination's pad rows, which stay zero."""
        ov = ctx.axis_overrides.get(key_axes[0]) if key_axes else None
        if ov is None or ov[2] is None:
            return partial
        off, ext, lim, _tot = ov
        partial = self._t(partial)
        keep = (off + self._arange(ext)) < lim
        keep = keep.reshape((-1,) + (1,) * (partial.dim() - 1))
        return torch.where(keep, partial,
                           torch.zeros((), dtype=partial.dtype,
                                       device=partial.device))

    def _sliced_operand(self, arr, name, faxes, ax, binding,
                        ctx: ExecContext = _EMPTY_CTX, pad_ok=True):
        """Slice a contraction operand to the iteration extents along each
        factor axis; None when an offset/extent guard fails.

        A per-rank offset (ShardOffset) is admitted only under a
        certificate, as the reference admits a traced one:

        * `name in ctx.aligned` (dim 0): the operand's block IS the round
          axis' window; no slice at all, local rows 0..extent.
        * a global operand (never localized): the axis' padded global
          extent `total` is the same on every rank; when total ≤ the dim,
          every window [offset, offset+extent) ⊆ [0, dim) (the bounds
          certificate, DESIGN.md §7).  A shorter operand is zero-padded
          to `total` first where the caller allows it (`pad_ok`: a +
          contraction, where a zero row is an out-of-range read's empty
          bag, and rows at or beyond the limit are masked anyway).
        """
        for dim_i, (d, axn) in enumerate(zip(arr.shape, faxes)):
            lo = binding[axn][2]
            ext = ax.extent[axn]
            if _static(lo):
                if lo != 0 or ext != d:
                    if lo + ext > d:
                        return None
                    arr = arr.narrow(dim_i, lo, ext)
                continue
            if dim_i == 0 and name in ctx.aligned:
                if ext != d:
                    return None      # certificate requires block == window
                continue
            ov = ctx.axis_overrides.get(axn)
            if ov is not None and name not in ctx.row_offsets \
                    and ov[3] is not None and (ov[3] <= d or pad_ok):
                if ov[3] > d:
                    pad = [0, 0] * arr.dim()
                    pad[2 * (arr.dim() - 1 - dim_i) + 1] = ov[3] - d
                    arr = torch.nn.functional.pad(arr, pad)
                arr = arr.narrow(dim_i, int(lo), ext)
                continue
            return None
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
            arr = self._sliced_operand(arr, f.array, faxes, ax, binding,
                                       ctx)
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
        partial = self._limit_mask_partial(partial, node.key_axes, ctx)
        self.note(node, "einsum")
        dest = env[node.dest]
        return self._keyed_combine(dest, partial, node.key_axes, ax, binding,
                                   "+", in_key_order=True,
                                   **self._dest_args(node, ctx))

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
            lo = binding[axn][2]
            if not _static(lo) or lo != 0 or ax.extent[axn] != d:
                return self.run_node(ein, env, ctx)
        rhs = env[node.rhs]
        if isinstance(rhs, TiledMatrix):
            rhs = unpack(rhs)
        rhs = self._sliced_operand(rhs, node.rhs, ein.product.factor_axes[1],
                                   ax, binding, ctx)
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
                                   **self._dest_args(node, ctx))

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
    def _exec_seq_loop(self, node: P.SeqLoop, env, ctx, *, li=None, it=0,
                       observer=None, body=None):
        """A host loop: the condition costs one device sync per iteration.
        Each iteration sees the env as it was before the loop plus the
        current carry; only the carry leaves the loop (the reference's
        while_loop semantics).

        The stepwise entries number the loop (`li`, plan.seq_loops order):
        then every iteration passes the `lower.loop_iter` site, counts
        from `it` (a resumed loop's), and calls ``observer(li, it,
        carry)`` after it.  `body(env)` replaces the body's execution (the
        out-of-core runner streams it)."""
        carry = {n: self._t(env[n]) for n in node.carry}
        while True:
            e2 = dict(env)
            e2.update(carry)
            if not bool(self.loop_cond(node, e2, ctx)):
                break
            if li is not None:
                F.site("lower.loop_iter", loop=li, iteration=it)
            if body is None:
                self.execute(node.body, e2, ctx)
            else:
                body(e2)
            carry = {n: self._t(e2[n]) for n in node.carry}
            it += 1
            if observer is not None:
                observer(li, it, dict(carry))
        env.update(carry)

    def loop_cond(self, node: P.SeqLoop, env,
                  ctx: ExecContext = _EMPTY_CTX) -> torch.Tensor:
        """A SeqLoop's condition as a 0-d bool tensor, not read on the
        host."""
        c = self._t(self.eval(node.cond, env, Axes(), {}, [], ctx))
        return (c if c.dtype == torch.bool else c != 0).reshape(())

    def eval_scalar(self, e, env):
        """Evaluate an expression outside any iteration space."""
        return self.eval(e, env, Axes(), {}, [])


# ---------------------------------------------------------------------------
# program compilation
# ---------------------------------------------------------------------------

# signatures whose whole-program entries a CompiledProgram keeps (LRU)
WHOLE_ENTRIES = 2
# batch signatures (bucket, lanes) whose batched entries it keeps (LRU): a
# served bucket meets a few lane counts (powers of two up to max_batch)
BATCH_ENTRIES = 8


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
                 compile_mode="whole", donate=False, skew_salting="auto",
                 out_of_core="auto", memory_budget=None, chunk_rows=None,
                 device="cuda", round_fusion=True, lineage=True,
                 speculative=True):
        if compile_mode not in ("whole", "eager"):
            raise ValueError(f"unknown compile_mode {compile_mode!r}")
        if out_of_core not in ("auto", "force", "off"):
            raise ValueError(f"unknown out_of_core {out_of_core!r}")
        self.program = prog
        self.target = target
        self.device = resolve_device(device)
        from .op_select import CACHE_FILE, OpSelector
        if autotune_cache is None:
            autotune_cache = CACHE_FILE
        self.config = PlanConfig(optimize_contractions=optimize_contractions,
                                 op_select=op_select,
                                 autotune_cache=autotune_cache,
                                 skew_salting=skew_salting,
                                 out_of_core=out_of_core,
                                 memory_budget=memory_budget,
                                 chunk_rows=chunk_rows,
                                 round_fusion=round_fusion,
                                 lineage=lineage, speculative=speculative)
        self.plan = plan_program(target, prog, self.config)
        from .dist_analysis import collect
        self.dists = collect(self.plan)   # array → Dist (pass-8 annotations)
        self.selector = OpSelector(op_select, cache_path=autotune_cache,
                                   platform=self.device.type,
                                   device=str(self.device))
        self.executor = PlanExecutor(prog, self.selector, self.device)
        # ---- whole-program compilation (graphs.py) ----
        # run() captures the ENTIRE plan into one cached entry of CUDA
        # graphs per (static dims, shapes, dtypes, salts) signature and
        # replays it on every later call.  compile_mode="eager" keeps the
        # per-node path (the fallback, also taken when an entry fails to
        # build or an input arrives §5-packed).  `donate` additionally
        # donates the mutated destinations and SeqLoop carries (graphs.py):
        # a caller's tensor on the device given for one is consumed, and
        # the output is the entry's own buffer (numpy inputs are copied in
        # per call, so donation is always safe for them)
        self.compile_mode = compile_mode
        self.donate = donate
        # signature → (entry, decisions), the most recently used last; an
        # entry holds its inputs' buffers and its graphs' pool, so only the
        # WHOLE_ENTRIES latest signatures keep theirs
        self._whole_cache: OrderedDict = OrderedDict()
        # per-SIGNATURE failure memo: an entry that failed to build
        # disables only ITS signature, for policy.disable_ttl runs; then it
        # is re-attempted
        self._whole_bad: dict = {}     # signature key → remaining ttl
        self.trace_count = 0           # entries built (test probe)
        self.cache_hits = 0
        self.trace_failures = 0        # entries that failed to build
        self.whole_retries = 0         # expired disables re-attempted
        self.faults = F.FaultLedger(prog.name)   # failure ledger
        self.policy = F.RetryPolicy()
        self._last_whole_exc = None    # why the LAST _run_whole descended
        # ---- out-of-core capacity tier (chunked.py) ----
        # out_of_core: "auto" = admit against memory_budget when set, and
        # descend to chunked streaming on classified capacity errors;
        # "force" = every run() streams; "off" = capacity bottoms out at
        # the eager (on the CPU, interp) rung.  chunk_rows pins the tile;
        # None derives it from the budget via memest/choose_chunk_rows
        self.out_of_core = out_of_core
        self.memory_budget = memory_budget
        self.chunk_rows = chunk_rows
        self._chunker = None           # lazy chunked.ChunkRunner
        self._mem_last = None          # last memest.MemEstimate (explain)
        self._mem_cache: dict = {}     # shape key → MemEstimate
        self._donate_names = frozenset(
            d for n in self.plan for d in P.dests_of(n)
            if prog.params.get(d) is not None
            and prog.params[d].kind != "dim")

    @property
    def _whole_disabled(self) -> bool:
        """True while ANY signature is sitting out its disable ttl."""
        return bool(self._whole_bad)

    def explain(self, tiled=()) -> str:
        """Spark-EXPLAIN-style dump of the chosen physical operator per
        statement.  `tiled` names params assumed to arrive §5-packed.
        After a run(), nodes whose backend the operator-selection
        subsystem resolved carry a `selected:` line (e.g.
        ``selected: segment:pallas[cost]``).  The trailing
        `whole-program:` line reports the compile-cache state — how many
        signatures were captured and how many run() calls hit the cache."""
        text = P.explain(self.plan, self.program.name, tiled,
                         decisions=self.executor.decisions)
        mode = "eager" if self.compile_mode != "whole" or \
            self._whole_disabled else "whole"
        text += (f"\nwhole-program: mode={mode}, {self.trace_count} traced, "
                 f"{self.cache_hits} cache hits"
                 + (", donate=on" if self.donate else "")
                 + (f", {self.trace_failures} trace failures "
                    f"({len(self._whole_bad)} signatures sitting out ttl, "
                    f"{self.whole_retries} re-attempted)"
                    if self.trace_failures or self.whole_retries else ""))
        if self._mem_last is not None:
            text += "\n" + self._mem_last.summary(self.memory_budget)
        return text

    # ---- out-of-core capacity tier (chunked.py) ----
    @property
    def chunker(self):
        if self._chunker is None:
            from .chunked import ChunkRunner
            self._chunker = ChunkRunner(self)
        return self._chunker

    def estimate_memory(self, inputs: dict):
        """Peak-device-bytes estimate for this call's shapes (memest.py),
        the admission check's input; cached per shape class and shown by
        explain() and explain_memory()."""
        from . import memest
        senv = memest.shape_env(self.program, inputs)
        key = tuple(sorted((n, repr(e)) for n, e in senv.items()))
        est = self._mem_cache.get(key)
        if est is None:
            est = memest.estimate(self.plan, self.program, senv,
                                  donate=self.donate)
            self._mem_cache[key] = est
        self._mem_last = est
        return est

    def explain_memory(self, inputs: dict) -> str:
        return self.estimate_memory(inputs).explain(self.memory_budget)

    def explain_chunked(self) -> str:
        """The chunked (out-of-core) form of the plan, ChunkLoops shown."""
        return self.chunker.explain()

    def explain_lineage(self) -> str:
        """The per-round recovery recipes (lineage.py): one `lineage:` line
        a round naming the shard axis, the write class, each read's
        surviving source and the depth a restart would replay."""
        from .lineage import explain_lineage
        return explain_lineage(self.plan, self.program.name)

    def _ooc_admits(self, inputs: dict) -> bool:
        """True when this call must take the chunked tier up front: forced,
        or its estimated peak exceeds the memory budget (the hard
        admission check: stream instead of running out of memory)."""
        if self.out_of_core == "force":
            return True
        if self.out_of_core == "off" or self.memory_budget is None:
            return False
        est = self.estimate_memory(inputs)
        if est.peak_bytes > self.memory_budget:
            from .memest import fmt_bytes
            self.faults.record(
                "admission", "chunked",
                f"estimated peak {fmt_bytes(est.peak_bytes)} > budget "
                f"{fmt_bytes(self.memory_budget)}: streaming chunked")
            return True
        return False

    def _initial_chunk_rows(self, inputs: dict) -> int:
        if self.chunk_rows:
            return int(self.chunk_rows)
        from .chunked import choose_chunk_rows, default_chunk_rows
        if self.memory_budget is not None:
            return choose_chunk_rows(self.estimate_memory(inputs),
                                     self.memory_budget)
        return default_chunk_rows(self.device)

    def _run_chunked(self, inputs: dict, *, observer=None, loop_state=None,
                     recovering=False):
        """The chunked rung: stream bag tiles through resident
        accumulators (chunked.py).  A capacity error INSIDE the stream
        halves the tile and retries (descending the memory curve, never
        ascending it) until a 1-row tile fails too."""
        rows = self._initial_chunk_rows(inputs)
        while True:
            try:
                out = self.chunker.run(inputs, chunk_rows=rows,
                                       observer=observer,
                                       loop_state=loop_state)
                if recovering:
                    self.faults.recover("chunked")
                return out
            except Exception as ex:           # noqa: BLE001 — ladder
                if F.classify(ex) != "capacity" or rows <= 1:
                    raise
                # the failed stream's buffers die with its frames
                _without_traceback(ex)
                self.faults.descend(f"chunked[{rows}]",
                                    f"chunked[{rows // 2}]", ex)
                rows //= 2
                recovering = True

    # -- public execution interface --
    def execute(self, env: dict, *, bag_offsets=None, bag_limits=None,
                array_limits=None, nodes=None, salts=None) -> None:
        ctx = ExecContext(bag_offsets=bag_offsets or {},
                          bag_limits=bag_limits or {},
                          array_limits=array_limits or {},
                          salts=salts or {})
        self.executor.execute(self.plan if nodes is None else nodes, env, ctx)

    def prepare_env(self, inputs: dict) -> dict:
        """Inputs on this program's device in the reference's canonical
        dtypes (convert.inputs_from_numpy)."""
        from ..convert import inputs_from_numpy
        return inputs_from_numpy(inputs, self.device, self.program.params)

    # ---- whole-program path ----
    def _signature(self, env):
        """Compile-cache key: static dims by VALUE (they define shapes),
        arrays by shape+dtype.  None = this env cannot take the whole-
        program path (§5 packed inputs execute eagerly)."""
        from .tiles import TiledMatrix
        sig = []
        for name, t in self.program.params.items():
            v = env[name]
            if t.kind == "dim":
                sig.append((name, "dim", v))
            elif t.kind == "bag":
                sig.append((name, "bag", tuple(
                    (tuple(c.shape), _dtype_name(c)) for c in v)))
            elif isinstance(v, TiledMatrix):
                return None
            else:
                sig.append((name, t.kind, tuple(v.shape), _dtype_name(v)))
        return tuple(sig)

    def _run_whole(self, inputs: dict):
        # the call's inputs in their canonical dtypes where the caller put
        # them: the entry copies them into its own buffers
        from ..convert import inputs_from_numpy
        env = inputs_from_numpy(inputs, None, self.program.params)
        sig = self._signature(env)
        if sig is None:
            return None                       # packed inputs: eager path
        # run-time hot-key probe (skew salting): the resolved factors are
        # part of the cache key, and the probe's host copy runs before any
        # graph
        salts = collect_salts(self.plan, env, self.selector,
                              self.config.skew_salting)
        key = (sig, self.donate, tuple(sorted(salts.items())))
        # the caller's tensors on the device given for donated names: the
        # call consumes them
        donated = {n: inputs[n] for n in self._donate_names
                   if self.donate and torch.is_tensor(inputs.get(n))
                   and inputs[n].device.type == self.device.type}
        left = self._whole_bad.get(key)
        if left is not None:
            # this signature's entry failed recently: sit out the rest of
            # its disable ttl at the eager level, then re-attempt
            if left > 1:
                self._whole_bad[key] = left - 1
                return None
            del self._whole_bad[key]
            self.whole_retries += 1
            self.faults.record("retry", "whole",
                               "signature disable ttl expired: "
                               "re-attempting whole-program trace")
        ent = self._whole_cache.get(key)
        if ent is None:
            from .graphs import Entry

            def attempt():
                F.site("lower.whole_trace", program=self.program.name)
                entry = Entry(self.executor, self.plan, self.program.outputs,
                              ExecContext(salts=salts), env,
                              donate=self._donate_names if self.donate
                              else ())
                # captures, then replays
                return entry, entry.run(env, donated)
            try:
                entry, out = F.run_with_retries(
                    attempt, policy=self.policy, ledger=self.faults,
                    label="whole")
            except Exception as ex:           # noqa: BLE001 — ladder
                self.trace_failures += 1
                self._whole_bad[key] = self.policy.disable_ttl
                self._last_whole_exc = _without_traceback(ex)
                # capacity never ascends the memory curve: the chunked
                # tier is the rung, not eager (the same all-resident
                # buffers, the same out-of-memory error)
                to = "chunked" if (F.classify(ex) == "capacity"
                                   and self.out_of_core != "off") else "eager"
                self.faults.descend("whole", to, ex)
                return None                   # run() picks the rung
            self.trace_count += 1
            self._whole_cache[key] = (entry, dict(self.executor.decisions))
            self._evict(batched=False)
            return out
        entry, notes = ent
        self._whole_cache.move_to_end(key)
        self.cache_hits += 1
        out = entry.run(env, donated)
        # restore the decisions noted when this signature was captured, so
        # explain() stays accurate
        self.executor.decisions.update(notes)
        return out

    def _evict(self, batched: bool) -> None:
        """Keep the latest WHOLE_ENTRIES solo entries (or BATCH_ENTRIES
        batched ones), freeing the least recently used."""
        cap = BATCH_ENTRIES if batched else WHOLE_ENTRIES
        keys = [k for k in self._whole_cache
                if (k[0] == "batched") == batched]
        for k in keys[:max(0, len(keys) - cap)]:
            self._whole_cache.pop(k)[0].free()

    # ---- batchable entry (the serving layer, serve/plans.py) ----
    # The PlanServer coalesces concurrent invocations of one program into
    # one batched call.  These hooks are its contract, the reference's: a
    # host-side mirror of prepare_env (requests canonicalize without
    # touching the device), the signature key that doubles as the shape-
    # bucketing function, and the batched call itself, cached in the SAME
    # whole-program cache.

    def canonical_inputs(self, inputs: dict) -> dict:
        """Numpy mirror of prepare_env: the same dtype rules
        (convert.inputs_from_numpy), on the host.  §5 packed inputs are
        rejected: they execute eagerly and cannot batch."""
        from ..convert import canonical_numpy
        from .tiles import TiledMatrix
        out = {}
        for name, t in self.program.params.items():
            v = inputs[name]
            if isinstance(v, TiledMatrix):
                raise ValueError(
                    f"param '{name}': packed (TiledMatrix) inputs cannot "
                    "take the batched serving path")
            if t.kind == "dim":
                out[name] = int(v)
            elif t.kind == "bag":
                cols = v if isinstance(v, tuple) else (v,)
                out[name] = tuple(canonical_numpy(_host(c)) for c in cols)
            elif t.kind in ("vector", "matrix", "map"):
                out[name] = np.asarray(
                    _host(v), np.float32 if t.dtype == "float" else np.int32)
            else:
                out[name] = canonical_numpy(_host(v))
        return out

    def entry_signature(self, cinputs: dict) -> tuple:
        """The whole-program compile-cache key of one canonicalized
        request: static dims BY VALUE, arrays by shape+dtype — exactly
        `_signature`, computed host-side.  This IS the serving layer's
        bucketing function."""
        sig = []
        for name, t in self.program.params.items():
            v = cinputs[name]
            if t.kind == "dim":
                sig.append((name, "dim", int(v)))
            elif t.kind == "bag":
                sig.append((name, "bag", tuple(
                    (tuple(c.shape), str(c.dtype)) for c in v)))
            else:
                sig.append((name, t.kind, tuple(np.shape(v)),
                            str(np.asarray(v).dtype)))
        return tuple(sig)

    @property
    def bag_row_aligned(self) -> dict:
        """array → bag for dense params whose dim-0 rides a bag's row
        count (plan.bag_row_arrays): the arrays a shape bucket must pad in
        lockstep with that bag, under a matching `array_limits` mask."""
        if not hasattr(self, "_bag_row_aligned"):
            self._bag_row_aligned = P.bag_row_arrays(self.plan)
        return self._bag_row_aligned

    @property
    def pads_exactly(self) -> bool:
        """Whether a served lane of this program may be padded past its
        rows and keep its solo run's bits on this device (pads_exactly)."""
        if not hasattr(self, "_pads_exactly"):
            self._pads_exactly = pads_exactly(self.plan, self.program,
                                              self.device)
        return self._pads_exactly

    def request_salts(self, cinputs: dict) -> tuple:
        """The hot-key salts a solo run() of one canonicalized request
        takes, as sorted (dest, factor) pairs: the same probe over its host
        values, so that a served lane salts as its solo run does."""
        env = {}
        for name, v in cinputs.items():
            if isinstance(v, tuple):
                env[name] = tuple(torch.from_numpy(c) for c in v)
            elif isinstance(v, np.ndarray):
                env[name] = torch.from_numpy(v)
            else:
                env[name] = v
        return tuple(sorted(collect_salts(
            self.plan, env, self.selector, self.config.skew_salting).items()))

    def batched_call(self, key, static: dict, arrays, lengths: dict = None,
                     limit_bags=(), limit_arrays=(), salts=None):
        """Run the plan over a leading request axis: `arrays` maps every
        non-dim param to a [B, ...]-stacked value (bags as tuples of [B, N]
        columns) and `lengths` each padded bag / bag-aligned array to its
        [B] logical row counts, threaded per lane through
        ExecContext.{bag,array}_limits so pad rows never change a result;
        or `arrays` is the batch already staged on the device
        (graphs.Batch, the serving layer's), its row counts inside.  `key`
        is the caller's padded bucket signature (it must determine shapes,
        B and the limit sets); entries (graphs.BatchEntry) live in the SAME
        `_whole_cache` as single-request signatures and count toward
        trace_count / cache_hits.  Mutated destinations are donated: each
        lane's output is written back over its input in the entry's
        buffer.  Returns the outputs [B, ...] as numpy arrays (one copy to
        the host).  `salts` (dest → factor, the lanes' request_salts, which
        `key` must determine) salts every lane's hot-key group-bys as their
        solo runs do.  Raises on failure — the serving layer falls back to
        sequential run() per request."""
        from .graphs import Batch, BatchEntry, HostBatch
        batch = arrays
        if not isinstance(batch, Batch):
            batch = HostBatch.of(arrays, lengths or {}, self.program.outputs,
                                 self.device).to_device()
        ck = ("batched", key)
        ent = self._whole_cache.get(ck)
        if ent is None:
            entry = BatchEntry(self.executor, self.plan, self.program.outputs,
                               dict(static), batch.layout, limit_bags,
                               limit_arrays, dict(salts or {}))
            out = entry.run(batch)       # captures, then replays
            self.trace_count += 1
            self._whole_cache[ck] = (entry, dict(self.executor.decisions))
            self._evict(batched=True)
            return out
        entry, notes = ent
        self._whole_cache.move_to_end(ck)
        self.cache_hits += 1
        out = entry.run(batch)
        self.executor.decisions.update(notes)
        return out

    def run(self, inputs: dict) -> dict:
        # hard admission check: a call whose estimated peak exceeds the
        # memory budget streams chunked from the start
        if self._ooc_admits(inputs):
            return self._run_chunked(inputs)
        whole_failed = False
        if self.compile_mode == "whole":
            self._last_whole_exc = None
            out = self._run_whole(inputs)
            if out is not None:
                return out
            ex = self._last_whole_exc
            whole_failed = ex is not None
            if whole_failed and F.classify(ex) == "capacity" \
                    and self.out_of_core != "off":
                # whole → chunked: the capacity rung
                return self._run_chunked(inputs, recovering=True)

        def eager():
            env = self.prepare_env(inputs)
            self.execute(env, salts=collect_salts(
                self.plan, env, self.selector, self.config.skew_salting))
            return {n: env[n] for n in self.program.outputs}

        # degradation ladder: whole → eager per-node (the executor's own
        # node fallback chains live inside) → chunked streaming for
        # capacity, the interpreter oracle (on the CPU only) for the rest.
        # Transients retry at each level with bounded backoff;
        # deterministic errors get AT MOST one descent before surfacing.
        # On the card the oracle is no rung: it runs on the host, where
        # the caller did not ask the program to run
        try:
            out = F.run_with_retries(eager, policy=self.policy,
                                     ledger=self.faults, label="eager")
            if whole_failed:
                self.faults.recover("eager")
            return out
        except Exception as ex:               # noqa: BLE001 — ladder
            if F.classify(ex) == "deterministic":
                # a user error reproduces at every level: surface it, never
                # fall through to the oracle (which would mask it)
                raise
            if F.classify(ex) == "capacity" and self.out_of_core != "off":
                # eager → chunked: stream tiles; the eager run's buffers
                # die with its frames first
                _without_traceback(ex)
                self.faults.descend("eager", "chunked", ex)
                try:
                    return self._run_chunked(inputs, recovering=True)
                except Exception as ex2:      # noqa: BLE001 — ladder
                    if F.classify(ex2) == "deterministic" or \
                            self.device.type != "cpu":
                        raise
                    return self._run_interp(inputs, "chunked", ex2)
            if self.device.type != "cpu":
                raise
            # a transient (or capacity error) persisting past the eager
            # retries: the interpreter is the bottom rung — correct results
            # from float64 numpy, not bit-identical (the ledger says so)
            return self._run_interp(inputs, "eager", ex)

    def _run_interp(self, inputs: dict, from_level: str, ex) -> dict:
        self.faults.descend(from_level, "interp", ex)
        from ..convert import to_tensor
        from .interp import run as _oracle
        out = _oracle(self.program, _host_inputs(inputs))
        self.faults.recover("interp")
        return {n: to_tensor(out[n], self.device)
                for n in self.program.outputs}

    def explain_faults(self) -> str:
        """Render the failure ledger next to explain(): retry/descent/
        recovery events plus the per-signature whole-program disable
        state."""
        text = self.faults.explain()
        text += (f"\nwhole-program: {self.trace_failures} trace failures, "
                 f"{len(self._whole_bad)} signatures sitting out ttl "
                 f"(budget {self.policy.disable_ttl} runs), "
                 f"{self.whole_retries} re-attempted")
        return text

    # ---- checkpointable execution ----
    def run_stepwise(self, inputs: dict, *, loop_state=None, observer=None):
        """Eager execution with the top-level sequential loops numbered
        (plan.seq_loops order) — the checkpoint/resume entry.  After every
        iteration of loop `li`, ``observer(li, iteration, carry)`` gets
        the loop carry as live tensors: runtime/ft.LoopRunner snapshots it
        through CheckpointManager.

        ``loop_state`` maps li → (iteration, {carry: array}) and fast-
        forwards that loop: the nodes before it run again (pure and
        deterministic from the same inputs), the carry is restored in the
        inputs' canonical dtypes (convert.to_tensor), and iteration goes
        on from there.  A resumed run is bit-identical to an uninterrupted
        one: both run the same per-iteration computations on the same
        carry values.  The loop is the eager path's own host loop, so a
        stepwise run has eager run()'s bits too.

        Out-of-core runs route to the chunked plan, whose top-level
        ChunkLoops are SeqLoops in this numbering: the observer fires once
        per CHUNK with the accumulator carry, so LoopRunner checkpoints
        resume a killed stream at its last chunk."""
        if self._ooc_admits(inputs):
            return self._run_chunked(inputs, observer=observer,
                                     loop_state=loop_state)
        env = self.prepare_env(inputs)
        ctx = ExecContext(salts=collect_salts(
            self.plan, env, self.selector, self.config.skew_salting))
        loop_state = dict(loop_state or {})
        li = 0
        for node in P.flatten(self.plan):
            if not isinstance(node, P.SeqLoop):
                self.executor.execute([node], env, ctx)
                continue
            it = 0
            st = loop_state.get(li)
            if st is not None:
                it, carry = st
                env.update(self.carry_in(node.carry, carry))
            self.executor._exec_seq_loop(node, env, ctx, li=li, it=it,
                                         observer=observer)
            li += 1
        return {n: env[n] for n in self.program.outputs}

    def carry_in(self, names, carry: dict) -> dict:
        """A restored loop carry on this program's device, in the
        canonical dtypes the inputs take (either package's snapshot)."""
        from ..convert import to_tensor
        return {c: to_tensor(carry[c], self.device) for c in names}


def _without_traceback(ex: BaseException) -> BaseException:
    """`ex` and the exceptions chained to it, without their tracebacks: a
    kept traceback's frames would keep a failed entry's graphs, pool and
    buffers alive."""
    seen = set()
    e = ex
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        e.__traceback__ = None
        e = e.__cause__ or e.__context__
    return ex


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _host_inputs(inputs: dict) -> dict:
    """The interpreter's inputs: tensors as numpy arrays on the host."""
    return {k: _host(v) for k, v in inputs.items()}


def _host(v):
    from .tiles import TiledMatrix, unpack
    if isinstance(v, TiledMatrix):
        v = unpack(v)
    if isinstance(v, tuple):
        return tuple(_host(c) for c in v)
    return v.detach().cpu().numpy() if torch.is_tensor(v) else v


def compile_program(fn_or_prog, *, optimize_contractions=True,
                    op_select="cost", autotune_cache=None,
                    compile_mode="whole", donate=False, skew_salting="auto",
                    out_of_core="auto", memory_budget=None,
                    chunk_rows=None, device="cuda", round_fusion=True,
                    lineage=True, speculative=True) -> CompiledProgram:
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
    policy: "auto", "off" or "force:<S>".

    compile_mode picks the execution strategy of run(): "whole" (default)
    captures the entire plan into ONE cached entry of CUDA graphs per
    (dims, shapes, dtypes) signature and replays it (graphs.py; on the CPU
    the same entry runs its regions eagerly); "eager" keeps the per-node
    dispatch path, also the automatic fallback when an entry fails to build
    or inputs arrive §5-packed.  A failure descends whole → eager, and on
    the CPU on to the interpreter (faults.py); on the card an error that
    persists at the eager level surfaces.  donate=True additionally
    donates mutated destinations and SeqLoop carries to the whole-program
    entry: a tensor on the device given for one is consumed (left without
    elements), and the output returned for it is the entry's buffer,
    which a caller feeds back at no copy.

    The distributed switches are the reference's: round_fusion=False
    keeps one round a node, lineage=False leaves rounds without recovery
    recipes (a lost shard descends the ladder) and speculative=False keeps
    the straggler watchdog log-only (core/distributed.py).  On one device
    they change only the plan's grouping, never a result.

    Out-of-core (chunked.py): memory_budget (bytes) turns on the hard
    admission check — a call whose memest peak estimate exceeds it
    streams bag tiles through resident accumulators instead of running
    all-resident; a classified capacity error (torch.OutOfMemoryError, or
    an injected one) descends whole → chunked and eager → chunked.
    out_of_core: "auto" (default) = admit and descend as above; "force" =
    every run streams; "off" = no chunked rung.  chunk_rows pins the tile;
    None derives it from the budget, else takes the default (4096 rows on
    the CPU as in the reference; on the card the segment kernel's range,
    2^26 rows, the unit its order is fixed by).

    `run_stepwise(inputs, loop_state=, observer=)` is the checkpointable
    entry (runtime.LoopRunner drives it)."""
    prog = fn_or_prog if isinstance(fn_or_prog, Program) \
        else fn_or_prog.program
    check_restrictions(prog)
    target = translate(prog)
    return CompiledProgram(prog, target, optimize_contractions, op_select,
                           autotune_cache, compile_mode, donate,
                           skew_salting, out_of_core, memory_budget,
                           chunk_rows, device, round_fusion, lineage,
                           speculative)
