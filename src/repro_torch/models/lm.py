"""Decoder-only LM: embedding -> layers -> head, for training and serving.

The reference stacks each layout group's layers into [L, ...] leaves
(`g<gi>/s<i>_<kind>`) and scans over them; the port keeps one module per
layer in an `nn.ModuleList`, in the order the layers run, and loops.
`layer_slots(cfg)` says which stacked leaf (group, kind key, index) each
layer of the port is, which is all a weight converter needs.  The cache is
a list with one dict per layer (dense and moe: k, v [B, max_seq, Hkv,
hd]; ssm: conv [B, k-1, d_inner], h [B, d_inner, N] float32).

Training: `loss(batch, mesh=None, dp_axes=("data",))` is the reference's
(the mesh reaches the MoE layers, whose capacity then counts the rows of
every rank of a data-parallel step) — embedding, the layers (each
under the config's `remat`: "full" is `torch.utils.checkpoint`, "dots"
a selective checkpoint that saves the matrix products' outputs, as the
reference's `dots_with_no_batch_dims_saveable`, "none" none), and
`chunked_ce`.  No layer draws random numbers, so the checkpoints keep no
RNG state (`preserve_rng_state=False`: a CUDA graph of the step captures
no generator reads).  The embedding gathers with `F.embedding`, whose
backward sums a token's rows in a fixed order (no atomics).  Parameters are made
without gradients (serving); `train_mode()` turns them on.  Serving runs
under `torch.no_grad` and builds no autograd graph.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..convert import lm_tree_from_numpy, lm_tree_to_numpy
from ..core.lower import resolve_device
from .blocks import (block_cache_defs, block_decode, block_defs,
                     block_forward, block_prefill)
from .common import ParamDef, ParamTree, dense, rms_norm


def layer_slots(cfg) -> list[tuple[str, str, int, str]]:
    """(group key, kind key, index in the stack, kind) of each layer, in
    the order the layers run: the reference's g<gi>/s<i>_<kind>[r]."""
    out = []
    for gi, (pattern, reps) in enumerate(cfg.layout):
        for r in range(reps):
            for i, kind in enumerate(pattern):
                out.append((f"g{gi}", f"s{i}_{kind}", r, kind))
    return out


def _top_defs(cfg) -> dict:
    embed_logical = ("vocab", "embed") if cfg.shard_embed_vocab \
        else ("none", "embed")
    return {"embed": ParamDef((cfg.vocab_size, cfg.d_model), embed_logical,
                              cfg.param_dtype, init="normal"),
            "final_norm": ParamDef((cfg.d_model,), ("embed",),
                                   torch.float32, init="zeros"),
            "lm_head": ParamDef((cfg.d_model, cfg.vocab_size),
                                ("embed", "vocab"), cfg.param_dtype)}


def _ce_sum(head_fn, x, labels):
    """Σ (logsumexp(logits) − logits[label]) over the rows, float32."""
    logits = head_fn(x)
    ls = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum((ls - true).float())


def chunked_ce(cfg, head_fn, x, labels):
    """Fused cross-entropy: a loop over sequence chunks whose [B, chunk, V]
    logits are recomputed in backward (a checkpoint a chunk) instead of
    saving [B, S, V] float32.  One chunk when `ce_chunk` does not divide S
    or equals it, as the reference."""
    b, s, _ = x.shape
    chunk = min(cfg.ce_chunk, s)
    if s % chunk != 0 or s == chunk:
        logits = head_fn(x)
        ls = torch.logsumexp(logits, dim=-1)
        true = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.mean(ls - true)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        total = total + checkpoint(_ce_sum, head_fn, x[:, c0:c0 + chunk],
                                   labels[:, c0:c0 + chunk],
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total / (b * s)


def _save_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of the matrix products without
    batch dimensions (`aten.mm`: every dense projection), recompute the
    rest."""
    return CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, fn, *args):
    """fn(*args) under the config's remat policy."""
    if cfg.remat == "none":
        return fn(*args)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_products))
    if cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r} is not one of full, dots, "
                         "none")
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _device(device) -> torch.device:
    dev = torch.device(device)
    # "meta" builds a model of shapes alone (no storage)
    return dev if dev.type == "meta" else resolve_device(dev)


class LM(ParamTree):
    def __init__(self, cfg, device="cuda"):
        kinds = [kind for *_, kind in layer_slots(cfg)]
        super().__init__({**_top_defs(cfg),
                          "layers": [block_defs(cfg, k) for k in kinds]},
                         _device(device))
        self.cfg = cfg
        self.kinds = kinds

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def to_tree(self, leaves: dict | None = None) -> dict:
        """The parameters (or `leaves`, a dict keyed like them: the AdamW
        moments) as the reference's stacked tree of numpy leaves, the
        layout of a training snapshot that either package resumes."""
        if leaves is None:
            leaves = dict(self.named_leaves())
        return lm_tree_to_numpy(self.cfg, leaves)

    def load_tree(self, tree: dict, into: dict | None = None) -> None:
        """Copy a tree of `to_tree`'s layout into the parameters (or into
        `into`, a dict keyed like them), in place."""
        if into is None:
            into = dict(self.named_leaves())
        lm_tree_from_numpy(self.cfg, tree, into)

    def train_mode(self):
        """Turn gradients on for every parameter (the training step calls
        it); returns the model."""
        return self.requires_grad_(True)

    # ---------------- caches ----------------
    def init_cache(self, batch: int, max_seq: int) -> list[dict]:
        return [{k: torch.zeros(shape, dtype=dt, device=self.device)
                 for k, (shape, dt) in block_cache_defs(
                     self.cfg, kind, batch, max_seq).items()}
                for kind in self.kinds]

    # ---------------- backbone ----------------
    def _embed(self, tokens):
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = F.embedding(tokens, self.embed).to(cfg.compute_dtype)
        if cfg.scale_embed:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype)
        return x

    def _head(self, x):
        cfg = self.cfg
        logits = dense(rms_norm(x, self.final_norm), self.lm_head).float()
        if cfg.logits_softcap:
            c = cfg.logits_softcap
            logits = c * torch.tanh(logits / c)
        return logits

    def _forward(self, x, pos_ids, mesh=None, dp_axes=("data",)):
        for p, kind in zip(self.layers, self.kinds):
            x = _remat(self.cfg, block_forward, self.cfg, kind, p, x,
                       pos_ids, mesh, dp_axes)
        return x

    def _pos_ids(self, pos_ids):
        return None if pos_ids is None else \
            torch.as_tensor(pos_ids, device=self.device).long()

    # ---------------- public entry points ----------------
    def loss(self, batch, mesh=None, dp_axes=("data",)):
        """batch: {tokens: [B, S], labels: [B, S], (pos_ids: [B, S, 3])}
        (numpy or tensors) -> (loss, {"loss": loss}), the mean next-token
        cross-entropy, float32.  With a mesh the batch is this rank's part
        of a data-parallel step's (the MoE layers route it as part of the
        whole); the loss is this part's."""
        x = self._embed(batch["tokens"])
        x = self._forward(x, self._pos_ids(batch.get("pos_ids")), mesh,
                          dp_axes)
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        loss = chunked_ce(self.cfg, self._head, x, labels)
        return loss, {"loss": loss}

    @torch.no_grad()
    def prefill(self, tokens, max_seq: int, pos_ids=None):
        """tokens: [B, S] (pos_ids: [B, S, 3] M-RoPE positions) -> (last-
        token logits [B, V] float32, filled cache)."""
        b, _ = tokens.shape
        cache = self.init_cache(b, max_seq)
        x = self._embed(tokens)
        pos_ids = self._pos_ids(pos_ids)
        for l, (p, kind) in enumerate(zip(self.layers, self.kinds)):
            x, cache[l] = block_prefill(self.cfg, kind, p, x, cache[l],
                                        pos_ids)
        return self._head(x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode(self, cache, token, pos, pos_ids=None, moe_groups: int = 1):
        """One decode step. token: [B, 1]; pos: [B] int (or a scalar for
        every row), each row's count of tokens so far; pos_ids: [B, 1, 3]
        M-RoPE positions.  `moe_groups` cuts the rows into that many
        equal groups, each routed through the MoE layers with its own
        capacity (the engine passes its slots; 1 is the reference's
        `model.decode` on a batch).  Returns (logits [B, V] float32,
        cache); the cache is updated in place."""
        x = self._embed(token)
        # one host-to-device copy of the positions for all layers
        pos = torch.as_tensor(pos, device=self.device).long().reshape(-1) \
            .expand(x.shape[0])
        pos_ids = self._pos_ids(pos_ids)
        for l, (p, kind) in enumerate(zip(self.layers, self.kinds)):
            x, cache[l] = block_decode(self.cfg, kind, p, x, cache[l], pos,
                                       pos_ids, moe_groups)
        return self._head(x)[:, 0], cache
