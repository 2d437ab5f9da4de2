"""Decoder-only LM: embedding -> layers -> head, for serving.

The reference stacks each layout group's layers into [L, ...] leaves
(`g<gi>/s<i>_<kind>`) and scans over them; the port keeps one module per
layer in an `nn.ModuleList`, in the order the layers run, and loops.
`layer_slots(cfg)` says which stacked leaf (group, kind key, index) each
layer of the port is, which is all a weight converter needs.  The cache is
a list with one dict per layer (dense: k, v [B, max_seq, Hkv, hd]; ssm:
conv [B, k-1, d_inner], h [B, d_inner, N] float32).

`loss`/`chunked_ce` wait for the training slice.
"""
from __future__ import annotations

import torch

from ..core.lower import resolve_device
from .blocks import block_cache_defs, block_decode, block_defs, block_prefill
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
        x = self.embed[tokens].to(cfg.compute_dtype)
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

    # ---------------- public entry points ----------------
    @torch.no_grad()
    def prefill(self, tokens, max_seq: int):
        """tokens: [B, S] -> (last-token logits [B, V] float32, filled
        cache)."""
        b, _ = tokens.shape
        cache = self.init_cache(b, max_seq)
        x = self._embed(tokens)
        for l, (p, kind) in enumerate(zip(self.layers, self.kinds)):
            x, cache[l] = block_prefill(self.cfg, kind, p, x, cache[l])
        return self._head(x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode(self, cache, token, pos):
        """One decode step. token: [B, 1]; pos: [B] int (or a scalar for
        every row), each row's count of tokens so far.  Returns (logits
        [B, V] float32, cache); the cache is updated in place."""
        x = self._embed(token)
        # one host-to-device copy of the positions for all layers
        pos = torch.as_tensor(pos, device=self.device).long().reshape(-1) \
            .expand(x.shape[0])
        for l, (p, kind) in enumerate(zip(self.layers, self.kinds)):
            x, cache[l] = block_decode(self.cfg, kind, p, x, cache[l], pos)
        return self._head(x)[:, 0], cache
