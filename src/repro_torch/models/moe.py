"""Mixture-of-Experts layer on one device, as the reference's
`models/moe.py` computes it in its local mode.

The combine step is the paper's incremental-update pattern

    for a in assignments:  Y[token(a)] += weight(a) * expert_out(a)

a group-by destination index with a commutative ⊕ (paper §3.7).  Here it
runs the hand-written `segment_reduce` kernel on the card (its wide
route: the rows handed in as they are, bf16 included, widened in
registers, float32 accumulation, the same bits on every launch) and its
plain version on the CPU, as every other float + group-by of the port
does; the result is
cast back to the activation dtype once.  The reference adds the k
contributions into a buffer of the activation dtype, so in bf16 the two
differ in rounding only.

Routing is the reference's: the router's logits in float32, the top k by
a stable descending sort (the lower expert index first among equal
logits, as `jax.lax.top_k`), softmax over the k.  The expert pass is the
reference's padded form: rows scattered into a static [E, cap_e, d]
buffer by (expert, rank within the expert), overflow rows dropped, three
batched products over all experts.  `groups=G` cuts the rows into G
equal groups of tokens, each with its own capacity and ranks, which
equals G separate calls: the serve engine's batched decode passes its
slots, as the reference vmaps a one-sequence decode over them.

Training: the combine is an autograd Function (`SegmentAdd`) whose
forward is the segment kernel and whose backward is the gather
`dy[src]` in the values' dtype, the transpose of the reference's
`.at[].add` (an XLA gather, outside any Pallas kernel).  The router's
top-k and the padded expert pass differentiate through torch, as the
reference's do through `lax.top_k` and its einsums.

Data parallelism (`moe_forward(mesh=...)` with `model` = 1): the reference
runs the local mode on the global microbatch, so its capacity and each
row's rank within its expert count every rank's rows, in global row order
(rank r's rows are the r-th part of it).  Each rank here routes its own
rows with the capacity of the global row count, and a row's rank is its
rank among this rank's rows plus the rows of lower ranks routed to the
same expert (an all-gather of E counts a call): the slots, and the rows
dropped, are the reference's.  Under remat the recompute issues the
gather again, in the same order on every rank.  The reference's expert-
parallel modes (`ep_alltoall`, `ep_local`, under shard_map, `model` > 1)
wait for more than one card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import segment_reduce
from .common import ParamDef, dense


def moe_defs(cfg) -> dict[str, ParamDef]:
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = cfg.param_dtype
    dm = "embed" if cfg.fsdp_experts else "none"  # FSDP d_model dim or not
    return {
        "router": ParamDef((d, e), ("embed", "none"), dt),
        "w_gate": ParamDef((e, d, ff), ("experts", dm, "expert_ff"), dt),
        "w_in": ParamDef((e, d, ff), ("experts", dm, "expert_ff"), dt),
        "w_out": ParamDef((e, ff, d), ("experts", "expert_ff", dm), dt),
    }


def _router(cfg, p, xt):
    """xt: [T, d] -> (weights [T, k] float32, experts [T, k] int64)."""
    logits = dense(xt, p["router"]).float()
    top, experts = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.top_k
    return torch.softmax(top[:, :k], dim=-1), experts[:, :k]


def _cap_e(n_rows: int, n_experts: int, cf: float) -> int:
    cap = math.ceil(n_rows / n_experts * cf)
    return max(8, -(-cap // 8) * 8)


def _ranks(flat_e, n_experts: int, groups: int):
    """Each row's position among the rows of its group routed to the same
    expert, in row order (the paper's group-by cumsum).  The one-hot is
    laid out expert-major, [G, E, rows], so that the scan runs along the
    contiguous dimension: a scan down the columns of [rows, E] runs one
    thread a column on the card (3.6 ms on an H100 at 16,384 rows and 128
    experts)."""
    onehot = F.one_hot(flat_e.view(groups, -1), n_experts) \
        .transpose(1, 2).contiguous()
    rank = torch.cumsum(onehot, dim=2).gather(1, flat_e.view(groups, 1, -1))
    return rank.reshape(-1) - 1


def _bmm(a, w):
    dt = torch.promote_types(a.dtype, w.dtype)
    return torch.bmm(a.to(dt), w.to(dt))


def _padded_expert_pass(x_rows, flat_e, slot, keep, n_experts, width,
                        w_gate, w_in, w_out):
    """Rows into a static [E, width, d] buffer at (expert, slot), dropped
    rows into a spare slot cut off before the products; all experts as
    one batched SwiGLU; per-row outputs gathered back ([N, d]), dropped
    rows zero."""
    d = x_rows.shape[1]
    buf = torch.zeros((n_experts, width + 1, d), dtype=x_rows.dtype,
                      device=x_rows.device)
    buf[flat_e, slot] = x_rows
    buf = buf[:, :width]
    h = F.silu(_bmm(buf, w_gate)) * _bmm(buf, w_in)
    y = _bmm(h, w_out)
    out = y[flat_e, torch.where(keep, slot, 0)]
    return out * keep[:, None].to(out.dtype)


class SegmentAdd(torch.autograd.Function):
    """The combine with its backward: the forward is the segment kernel
    (the rows unwidened, float32 sums), the backward gathers each row's
    segment gradient, `dy[src]`, in the values' dtype."""

    @staticmethod
    def forward(ctx, values, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        ctx.dtype = values.dtype
        return segment_reduce(segment_ids, values, num_segments)

    @staticmethod
    def backward(ctx, dy):
        segment_ids, = ctx.saved_tensors
        return dy[segment_ids].to(ctx.dtype), None, None


def segment_add(values, segment_ids, num_segments: int):
    """The group-by ⊕ combine: [N, d] rows summed into [num_segments, d]
    float32 by the `segment_reduce` kernel (its plain version on the
    CPU); differentiable in `values` through `SegmentAdd` when autograd
    records.  Every id must lie in [0, num_segments): the gather of the
    backward reads one segment a row."""
    if torch.is_grad_enabled() and values.requires_grad:
        return SegmentAdd.apply(values, segment_ids, num_segments)
    return segment_reduce(segment_ids, values, num_segments)


def _dispatch(flat_e, n_experts: int, groups: int, cf: float, coll=None):
    """(slot [N], keep [N], width) of the routed rows (token-major, then
    the k choices): each group of N/groups rows gets cap_e slots an
    expert, a kept row the slot group·cap_e + its rank; a row of rank
    ≥ cap_e is dropped.  With `coll` (one group): the rows of every rank
    of its mesh, N each, in rank order, are the group."""
    n = flat_e.shape[0]
    per = n // groups
    cap_e = _cap_e(per * (1 if coll is None else coll.n), n_experts, cf)
    rank = _ranks(flat_e, n_experts, groups)
    if coll is not None:
        # E counts on the device (bincount reads its input's max on the
        # host)
        counts = torch.zeros(n_experts, dtype=torch.int32,
                             device=flat_e.device).index_add_(
            0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
        every = coll.all_gather(counts[None])
        rank = rank + every[:coll.rank].sum(0).to(rank.device)[flat_e]
    keep = rank < cap_e
    group = torch.arange(n, device=flat_e.device) // per
    slot = torch.where(keep, group * cap_e + rank, groups * cap_e)
    return slot, keep, groups * cap_e


def moe_local(cfg, p, x, groups: int = 1, coll=None):
    """x: [B, S, d] -> [B, S, d].  `groups` cuts the B·S tokens, in order,
    into that many equal groups, each routed with its own capacity.
    `coll` (a mesh's Collectives; one group): x is this rank's part of a
    microbatch that every rank of the mesh holds a part of, routed as
    one."""
    b, s, d = x.shape
    t = b * s
    if coll is not None and groups != 1:
        raise ValueError("moe_local: the rows of a mesh's ranks are routed "
                         "as one group")
    if t % groups:
        raise ValueError(f"moe_local: {t} tokens do not cut into {groups} "
                         "equal groups")
    xt = x.reshape(t, d)
    gw, ge = _router(cfg, p, xt)
    k = cfg.top_k
    flat_e = ge.reshape(t * k)
    flat_w = gw.reshape(t * k)
    src = torch.arange(t, device=x.device).repeat_interleave(k)
    slot, keep, width = _dispatch(flat_e, cfg.num_experts, groups,
                                  cfg.capacity_factor, coll)
    ys = _padded_expert_pass(xt[src], flat_e, slot, keep, cfg.num_experts,
                             width, p["w_gate"], p["w_in"], p["w_out"])
    y = segment_add(ys * flat_w[:, None].to(ys.dtype), src, t)
    return y.reshape(b, s, d).to(x.dtype)


def moe_forward(cfg, p, x, mesh=None, dp_axes=("data",), groups: int = 1):
    """The reference's entry: local on one device; over a mesh with
    `model` = 1, local on each rank's part of the global microbatch (its
    capacity counted over all of it); a `model` axis larger than 1 (the
    reference's expert-parallel modes) raises."""
    if mesh is None:
        return moe_local(cfg, p, x, groups)
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            "moe_forward: expert parallelism over a mesh is not ported yet "
            "(ROADMAP.md, Queue 1, 'expert parallelism over a RankGroup'); "
            "give the mesh model = 1")
    from ..launch.mesh import dp_world
    dp_world(mesh, dp_axes)
    return moe_local(cfg, p, x, groups, coll=mesh.coll)
