"""The collectives of the distributed rounds (core/distributed.py), over a
torch.distributed process group.  Each maps one to one to the reference's
shard_map collective:

    lax.psum / pmax / pmin               all_reduce (SUM / MAX / MIN)
    lax.psum_scatter(tiled=True)         reduce_scatter_tensor
    "allreduce + slice" exchange         all_reduce + narrow
    lax.all_gather(tiled=True)           all_gather_into_tensor
    lax.ppermute (a ring shift)          batch_isend_irecv

The transport is fixed up front by (backend, device, operation), never by
catching a failure: NCCL on the card, gloo on the CPU, and gloo on the card
when several ranks share one (NCCL refuses two ranks on one device), where
an operation whose CUDA form gloo lacks goes through a pinned host buffer
(`DIRECT`).  Every collective passes the `dist.exchange` fault site and
counts its calls and the bytes this rank hands it.

Beside the group, `vote` settles a failure among the ranks through the
group's store, and `abort` tears the group down so that ranks blocked in
a collective this rank will not join fail instead of waiting out the
group's timeout.
"""
from __future__ import annotations

import itertools
import time
from collections import Counter

import torch

from . import faults as F

OPS = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
       "batch_isend_irecv")

# (backend, device type) → the operations that take the device's tensors
# directly; the pair's other operations stage through pinned host memory.
# gloo on the card stages every one: handed CUDA tensors, torch
# 2.11.0+cu128's gloo killed its rank (gloo::IoException, "writev: Bad
# address") on an H100 (PERF.md), and the ranks that share one card are
# the only users of that pair
DIRECT = {
    ("nccl", "cuda"): frozenset(OPS),
    ("gloo", "cpu"): frozenset(OPS),
    ("gloo", "cuda"): frozenset(),
}

_REDUCE_OPS = {"+": "SUM", "min": "MIN", "max": "MAX"}

# the votes of this process, in order: ranks that go through the same
# sequence of votes pair them by number
_VOTES = itertools.count()


def _reduce_scatter():
    # reduce_scatter_tensor; torch ≥ 2.13 names it reduce_scatter_single
    import torch.distributed as dist
    return getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor


def _all_gather():
    # all_gather_into_tensor; torch ≥ 2.13 names it all_gather_single
    import torch.distributed as dist
    return getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor


class Collectives:
    """The collectives of one mesh, with their transport and counters
    (`calls`, `bytes`: by operation, this rank's input bytes; `issued`:
    the collectives handed to the group, agreements included)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.group
        self.n = mesh.size
        self.rank = mesh.rank
        self.backend = mesh.backend
        self.direct = DIRECT.get((self.backend, mesh.device.type),
                                 frozenset())
        self.calls: Counter = Counter()
        self.bytes: Counter = Counter()
        self.issued = 0

    def transport(self, op: str) -> str:
        return self.backend if op in self.direct \
            else f"{self.backend} via pinned host"

    def transports(self) -> str:
        """One line: the transport of every operation."""
        return ", ".join(f"{op}={self.transport(op)}" for op in OPS)

    # ---- staging ----
    def staging(self, op: str, numel: int, dtype) -> torch.Tensor | None:
        """A pinned host buffer of `numel` elements for `op`'s input where
        its transport stages (None where it takes the device's tensors), to
        hand to calls again and again: pinning is not free."""
        if op in self.direct:
            return None
        return torch.empty(numel, dtype=dtype, pin_memory=True)

    def _enter(self, coll: str, x: torch.Tensor, staging=None,
               **payload) -> torch.Tensor:
        F.site("dist.exchange", collective=coll, **payload)
        self.calls[coll] += 1
        self.bytes[coll] += x.numel() * x.element_size()
        self.issued += 1
        x = x.contiguous()
        if coll in self.direct:
            return x
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True) \
            if staging is None else staging.view(x.shape)
        buf.copy_(x)
        return buf

    def _empty(self, op, shape, like: torch.Tensor) -> torch.Tensor:
        if op in self.direct:
            return torch.empty(shape, dtype=like.dtype,
                               device=self.mesh.device)
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)

    def _leave(self, y: torch.Tensor) -> torch.Tensor:
        return y.to(self.mesh.device) if y.device != self.mesh.device else y

    # ---- operations ----
    def all_reduce(self, x: torch.Tensor, op: str = "+") -> torch.Tensor:
        """The ⊕ of every rank's x (a new tensor; x is left as it was)."""
        import torch.distributed as dist
        y = self._enter("all_reduce", x, op=op)
        y = y.clone() if y is x or y.data_ptr() == x.data_ptr() else y
        dist.all_reduce(y, op=getattr(dist.ReduceOp, _REDUCE_OPS[op]),
                        group=self.group)
        return self._leave(y)

    def all_reduce_(self, x: torch.Tensor, op: str = "+",
                    staging: torch.Tensor | None = None) -> torch.Tensor:
        """x ← the ⊕ of every rank's x, in place (x contiguous), through
        `staging` (from `staging("all_reduce", ...)`) where the transport
        stages.  Returns x."""
        import torch.distributed as dist
        y = self._enter("all_reduce", x, staging=staging, op=op)
        dist.all_reduce(y, op=getattr(dist.ReduceOp, _REDUCE_OPS[op]),
                        group=self.group)
        if y is not x:
            x.copy_(y)
        return x

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The + of every rank's x, this rank's dim-0 block of it."""
        import torch.distributed as dist
        y = self._enter("reduce_scatter_tensor", x, op="+")
        out = self._empty("reduce_scatter_tensor",
                          (y.shape[0] // self.n,) + tuple(y.shape[1:]), y)
        _reduce_scatter()(out, y, group=self.group)
        return self._leave(out)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's dim-0 block, concatenated in rank order."""
        import torch.distributed as dist
        y = self._enter("all_gather_into_tensor", x)
        out = self._empty("all_gather_into_tensor",
                          (y.shape[0] * self.n,) + tuple(y.shape[1:]), y)
        _all_gather()(out, y, group=self.group)
        return self._leave(out)

    def agree(self, flag: bool) -> bool:
        """True on every rank when it is true on any rank: a control
        all_reduce (MAX of one int32; no fault site) for decisions that
        choose collectives, which must be the same everywhere.  Counted
        as `agree`, apart from the rounds' all_reduces."""
        import torch.distributed as dist
        x = torch.tensor([int(flag)], dtype=torch.int32)
        if "all_reduce" in self.direct:
            x = x.to(self.mesh.device)
        self.calls["agree"] += 1
        self.bytes["agree"] += 4
        self.issued += 1
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return bool(x.item())

    def vote(self, outcome: str, timeout_s: float) -> list | None:
        """Every rank's `outcome` of one step, in rank order, through the
        group's store (no collective: a rank blocked in one cannot join
        it).  None when a rank posted another outcome, or some rank
        posted none within `timeout_s`: that rank is still inside the
        step, blocked in a collective or working.  A rank that returns
        None posts `diverged` over its outcome, so that a rank which comes
        to the vote later does not take it for agreement."""
        import torch.distributed.distributed_c10d as c10d
        store = c10d._get_default_store() if self.group is None else \
            c10d._get_process_group_store(self.group)
        seq = next(_VOTES)
        keys = [f"repro_torch/vote/{seq}/{r}" for r in range(self.n)]
        store.set(keys[self.rank], outcome)
        end = time.monotonic() + timeout_s
        got: dict = {}
        while True:
            for r, k in enumerate(keys):
                if r not in got and store.check([k]):
                    got[r] = store.get(k).decode()
                    if got[r] != outcome:
                        store.set(keys[self.rank], "diverged")
                        return None
            if len(got) == self.n:
                return [got[r] for r in range(self.n)]
            if time.monotonic() > end:
                store.set(keys[self.rank], "diverged")
                return None
            time.sleep(0.005)

    def abort(self):
        """Tear the group down: the ranks blocked in a collective that
        this rank will not join fail at once (gloo closes its pairs)."""
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group(self.group)

    def ring_shift(self, x: torch.Tensor, inverse: bool = False
                   ) -> torch.Tensor:
        """x of the previous rank (the next one with `inverse`): every
        rank's block moves one rank along the ring."""
        import torch.distributed as dist
        y = self._enter("batch_isend_irecv", x)
        out = self._empty("batch_isend_irecv", tuple(y.shape), y)
        step = -1 if inverse else 1
        ops = [dist.P2POp(dist.isend, y, (self.rank + step) % self.n,
                          group=self.group),
               dist.P2POp(dist.irecv, out, (self.rank - step) % self.n,
                          group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._leave(out)
