"""Training step: loss -> grads -> AdamW, the PyTorch port of the
reference's src/repro/train/step.py.

`make_train_step(cfg, ...)` returns `train_step(model, opt_state, batch)
-> (model, opt_state, metrics)`.  The model is updated in
place (its parameters and the moments of `opt_state`); the reference's
functional step returns new trees instead.  Semantics are the reference's:

* gradient-accumulation microbatching (cfg.microbatch = k > 1): the batch
  cut into k slices along its first dimension, float32 gradients summed
  over them in order and divided by k, the loss likewise;
* optional bf16 gradient compression (`compress_grads`): float32
  gradients cast to bf16 before the update;
* AdamW (`optim/adamw.py`) with the given lr and weight decay; metrics
  {"loss", "grad_norm", "lr"}, as 0-d tensors (read them with float()).

The model is any of the ten architectures' (`models.get_model`): an `LM`
of dense, moe, ssm, rec and lattn layers, or `Whisper`, whose batch also
carries the encoder's frames.  The step runs eagerly; `train/graph.py`'s
`graphed_step` wraps it as the reference's `jax.jit` does (one CUDA graph
of the whole step for each batch signature on the card).  AdamW is the
multi-tensor kernel (`kernels/adamw.py`) on the card.

Data parallelism (`mesh`, launch/mesh.py): every rank of the mesh's group
runs the step on its part of the global batch (`SyntheticLMData(...,
host_index=rank, host_count=P, microbatch=cfg.microbatch)` gives it its
rows), and the result is the reference's step on the whole batch, which
GSPMD cuts over `data` with an all-reduce of the gradients:

* each rank's gradients as above (the MoE layers count their capacity over
  every rank's rows, models/moe.py); each float32 gradient divided by P,
  then cast to bf16 under `compress_grads` (the reference compresses
  before its all-reduce: the two differ by bf16 rounding alone), then
  summed over the ranks in a few contiguous buckets (`GradBuckets`), the
  loss likewise in float32;
* AdamW on the summed gradients, so `loss` and `grad_norm` are the global
  ones and every rank's parameters and moments stay bit-equal.  The first
  call checks that the ranks start from the same parameters (a crc32 a
  leaf, all-gathered): a replica that drifted raises `ReplicaDivergence`.

The exchange is issued at every world size, a world of 1 included, and
goes through `Collectives.all_reduce_` (the `dist.exchange` fault site,
calls and bytes in `mesh.coll`).  A mesh axis other than the data-parallel
ones larger than 1 raises (tensor parallelism is not ported).
"""
from __future__ import annotations

import math

import torch

from ..core.faults import checksum
from ..launch.mesh import dp_world
from ..optim.adamw import adamw_update

# the most bytes a bucket holds; a larger leaf is a bucket of its own
BUCKET_BYTES = 1 << 28


class ReplicaDivergence(RuntimeError):
    pass


def _slices(batch: dict, k: int) -> list[dict]:
    b = len(batch["tokens"])
    if b % k:
        raise ValueError(f"microbatch {k} does not divide the batch of {b}")
    m = b // k
    return [{key: v[i * m:(i + 1) * m] for key, v in batch.items()}
            for i in range(k)]


class GradBuckets:
    """The gradient exchange of one step function: the gradients copied, in
    leaf order, into contiguous buckets of one wire dtype each, every
    bucket summed over the ranks by one all_reduce.  The buckets, and their
    pinned host staging where the transport stages (gloo ranks that share
    a card), are made at the first call and kept; a call whose leaves
    differ in name, shape or wire dtype lays them out anew."""

    def __init__(self, coll):
        self.coll = coll
        self.key = None
        self.buckets = []         # (flat, staging, [(name, offset, shape)])
        self.loss = None          # (one float32, staging)

    def _layout(self, grads: dict, wire: dict):
        self.buckets, cur, size = [], [], 0

        def close():
            if cur:
                dt = wire[cur[0][0]]
                flat = torch.empty(size, dtype=dt,
                                   device=self.coll.mesh.device)
                self.buckets.append(
                    (flat, self.coll.staging("all_reduce", size, dt),
                     list(cur)))
        for name, g in grads.items():
            if cur and (wire[name] != wire[cur[0][0]] or (size + g.numel())
                        * wire[name].itemsize > BUCKET_BYTES):
                close()
                cur, size = [], 0
            cur.append((name, size, tuple(g.shape)))
            size += g.numel()
        close()
        dev = self.coll.mesh.device
        self.loss = (torch.empty(1, dtype=torch.float32, device=dev),
                     self.coll.staging("all_reduce", 1, torch.float32))

    def mean(self, grads: dict, loss, compress: bool):
        """(the ranks' mean gradients {name: tensor}, their mean loss): each
        rank's float32 gradient divided by P, cast to the wire dtype (bf16
        under `compress` for a float32 gradient, else its own), summed.
        The gradients are views of the buckets, good until the next call.
        Empties `grads`, so that each local gradient is freed once it is in
        its bucket."""
        n = self.coll.n
        wire = {k: torch.bfloat16 if compress and g.dtype == torch.float32
                else g.dtype for k, g in grads.items()}
        key = tuple((k, tuple(g.shape), wire[k]) for k, g in grads.items())
        if key != self.key:
            self._layout(grads, wire)
            self.key = key
        out = {}
        for flat, staging, leaves in self.buckets:
            for name, off, shape in leaves:
                g = grads.pop(name)
                view = flat[off:off + math.prod(shape)].view(shape)
                # float32 arithmetic, one rounding to the wire dtype
                torch.div(g, n, out=view)
                out[name] = view
                del g
            self.coll.all_reduce_(flat, staging=staging)
        buf, staging = self.loss
        torch.div(loss.detach().reshape(1), n, out=buf)
        self.coll.all_reduce_(buf, staging=staging)
        return out, buf[0].clone()


def check_replicas(mesh, params: dict):
    """Raise ReplicaDivergence unless every rank of the mesh holds the same
    parameters, bit for bit: a crc32 of each leaf's bytes, all-gathered
    (nothing to compare at a world of 1)."""
    if mesh.size == 1:
        return
    crcs = torch.tensor([checksum(p.detach().reshape(-1).view(torch.uint8)
                                  .cpu().numpy()) for p in params.values()],
                        dtype=torch.int64)
    every = mesh.coll.all_gather(crcs.to(mesh.device)).cpu() \
        .view(mesh.size, -1)
    differ = [name for i, name in enumerate(params)
              if bool((every[:, i] != every[0, i]).any())]
    if differ:
        raise ReplicaDivergence(
            f"rank {mesh.rank}: the ranks' parameters differ in "
            f"{len(differ)} of {len(params)} leaves (first {differ[:3]}): "
            "every replica must start from the same weights")


def make_train_step(cfg, mesh=None, dp_axes=("data",), lr=3e-4,
                    compress_grads=True, weight_decay=0.1):
    k = max(1, cfg.microbatch)
    exchange = None
    if mesh is not None:
        dp_world(mesh, dp_axes)
        exchange = GradBuckets(mesh.coll)
    checked = [mesh is None]

    def grads_of(model, params, batch):
        loss, metrics = model.loss(batch, mesh, dp_axes)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), metrics, dict(zip(params, grads))

    def train_step(model, opt_state, batch):
        model.train_mode()
        params = dict(model.named_leaves())
        if not checked[0]:
            check_replicas(mesh, params)
            checked[0] = True
        if k == 1:
            loss, metrics, grads = grads_of(model, params, batch)
            metrics = {n: v.detach() for n, v in metrics.items()}
        else:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for mb in _slices(batch, k):
                l, _, g = grads_of(model, params, mb)
                for n, gi in g.items():
                    grads[n] += gi.float()
                loss = loss + l
                del g
            grads = {n: g / k for n, g in grads.items()}
            loss = loss / k
            metrics = {"loss": loss}
        if exchange is not None:
            grads, metrics["loss"] = exchange.mean(grads, loss,
                                                   compress_grads)
        elif compress_grads:
            grads = {n: g.to(torch.bfloat16) if g.dtype == torch.float32
                     else g for n, g in grads.items()}
        _, opt_state, om = adamw_update(params, grads, opt_state, lr=lr,
                                        weight_decay=weight_decay)
        return model, opt_state, {**metrics, **om}

    train_step.mesh = mesh
    train_step.exchange = exchange
    return train_step
