"""Whisper-style encoder-decoder backbone (whisper-tiny), as the
reference's `models/whisper.py` computes it.

The modality frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings [B, enc_seq, d] (no mel conv stack).
Sinusoidal positions on both sides.  Decoder layers: causal self-attention
-> cross-attention -> GELU MLP with biases.  The reference stacks each
side's layers into [L, ...] leaves (`enc/...`, `dec/...`) and scans over
them; the port keeps one module a layer (`enc/<l>/...`, `dec/<l>/...`)
and loops; `convert.whisper_params_from_numpy` carries the reference's
tree across.

Every full-sequence attention runs the hand-written `flash_attention`
kernel: the encoder's non-causal self-attention over the frames, the
decoder's causal self-attention in prefill, and cross-attention (Sq
tokens against Sk = enc_seq frames) in prefill and decode.  The decoder's
self-attention in decode is plain torch, as for the LM.

The cache is the reference's: "self", the decoder's self-attention k/v
(here a list of one {k, v} [B, max_seq, Hkv, hd] a layer), and
"cross_k" / "cross_v" [L, B, enc_seq, Hkv, hd], the encoder output's
projections made once by the prefill.

Training: `loss(batch)` is the reference's (batch {frames, tokens,
labels}): the encoder, the decoder, then `chunked_ce` over the decoder's
output, with every layer's body rematerialized (`checkpoint`, as the
reference's `jax.checkpoint` around each scanned body, whatever the
config's `remat`); the attentions run the flash kernel's Function, whose
backward is the hand-written `flash_attention_bwd`.  `train_mode()`
turns gradients on; `to_tree`/`load_tree` give `TrainRunner` the
reference's stacked tree (`convert.whisper_slots`), so that a training
snapshot of either package resumes in the other.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..convert import whisper_tree_from_numpy, whisper_tree_to_numpy
from . import attention as attn
from .common import ParamDef, ParamTree, dense, rms_norm
from .lm import _device, chunked_ce


def _sinusoid(seq: int, d: int, offset=0, device=None):
    """[seq, d] (or [B, seq, d] for a [B] offset) sin | cos positions
    offset + 0..seq-1, float32.  An int offset is added on the device as
    a scalar (no copy from the host: a CUDA graph captures the step)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)
    if isinstance(offset, int):
        pos = float(offset) + pos
    else:
        pos = torch.as_tensor(offset, device=device).float()[..., None] + pos
    inv = torch.exp(-math.log(10000.0) * torch.arange(
        0, d, 2, dtype=torch.float32, device=device) / d)
    ang = pos[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _norm_def(cfg):
    return ParamDef((cfg.d_model,), ("embed",), torch.float32, init="zeros")


def _mlp_defs(cfg):
    d, ff = cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    return {"w_in": ParamDef((d, ff), ("embed", "ff"), dt),
            "b_in": ParamDef((ff,), ("ff",), dt, init="zeros"),
            "w_out": ParamDef((ff, d), ("ff", "embed"), dt),
            "b_out": ParamDef((d,), ("embed",), dt, init="zeros")}


def _enc_layer_defs(cfg):
    return {"ln1": _norm_def(cfg), "attn": attn.attn_defs(cfg),
            "ln2": _norm_def(cfg), "mlp": _mlp_defs(cfg)}


def _dec_layer_defs(cfg):
    return {"ln1": _norm_def(cfg), "self": attn.attn_defs(cfg),
            "ln2": _norm_def(cfg), "cross": attn.attn_defs(cfg),
            "ln3": _norm_def(cfg), "mlp": _mlp_defs(cfg)}


def _mlp(p, x):
    h = F.gelu(dense(x, p["w_in"], p["b_in"]), approximate="tanh")
    return dense(h, p["w_out"], p["b_out"])


def _enc_layer(cfg, p, x):
    x = x + attn.attn_forward(cfg, p["attn"], rms_norm(x, p["ln1"]),
                              causal=False)
    return x + _mlp(p["mlp"], rms_norm(x, p["ln2"]))


def _dec_layer(cfg, p, x, enc):
    """A decoder layer in training: causal self-attention over x, then
    cross-attention to the encoder's output, then the MLP."""
    x = x + attn.attn_forward(cfg, p["self"], rms_norm(x, p["ln1"]),
                              causal=True)
    kv = attn.cross_kv(cfg, p["cross"], enc)
    x = x + attn.cross_attn_forward(cfg, p["cross"], rms_norm(x, p["ln2"]),
                                    kv)
    return x + _mlp(p["mlp"], rms_norm(x, p["ln3"]))


def dec_layers(cfg) -> int:
    return sum(len(p) * r for p, r in cfg.layout)


class Whisper(ParamTree):
    def __init__(self, cfg, device="cuda"):
        if cfg.pos_embed != "sinusoidal":
            raise ValueError(f"Whisper: pos_embed {cfg.pos_embed!r}, not "
                             "'sinusoidal'")
        n_dec = dec_layers(cfg)
        super().__init__({
            "embed": ParamDef((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed"), cfg.param_dtype,
                              init="normal"),
            "enc": [_enc_layer_defs(cfg) for _ in range(cfg.enc_layers)],
            "dec": [_dec_layer_defs(cfg) for _ in range(n_dec)],
            "enc_norm": _norm_def(cfg),
            "final_norm": _norm_def(cfg),
            "lm_head": ParamDef((cfg.d_model, cfg.vocab_size),
                                ("embed", "vocab"), cfg.param_dtype),
        }, _device(device))
        self.cfg = cfg
        self.dec_layers = n_dec

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def to_tree(self, leaves: dict | None = None) -> dict:
        """The parameters (or `leaves`, a dict keyed like them: the AdamW
        moments) as the reference's stacked tree of numpy leaves, the
        layout of a training snapshot that either package resumes."""
        if leaves is None:
            leaves = dict(self.named_leaves())
        return whisper_tree_to_numpy(self.cfg, leaves)

    def load_tree(self, tree: dict, into: dict | None = None) -> None:
        """Copy a tree of `to_tree`'s layout into the parameters (or into
        `into`, a dict keyed like them), in place."""
        if into is None:
            into = dict(self.named_leaves())
        whisper_tree_from_numpy(self.cfg, tree, into)

    def train_mode(self):
        """Turn gradients on for every parameter (the training step calls
        it); returns the model."""
        return self.requires_grad_(True)

    def loss(self, batch, mesh=None, dp_axes=("data",)):
        """batch: {frames: [B, S_enc, d], tokens: [B, S], labels: [B, S]}
        (numpy or tensors) -> (loss, {"loss": loss}), the mean next-token
        cross-entropy of the decoder, float32.  `mesh` and `dp_axes` are
        the reference's arguments; no layer here needs them (no MoE), so
        over a mesh the loss is that of this rank's rows."""
        enc = self._encoder(batch["frames"], remat=True)
        x = self._dec_embed(batch["tokens"])
        for p in self.dec:
            x = checkpoint(_dec_layer, self.cfg, p, x, enc,
                           use_reentrant=False, preserve_rng_state=False)
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        loss = chunked_ce(self.cfg, self._head, x, labels)
        return loss, {"loss": loss}

    # -------------- encoder --------------
    def _encoder(self, frames, remat=False):
        cfg = self.cfg
        x = torch.as_tensor(frames, device=self.device).to(cfg.compute_dtype)
        x = x + _sinusoid(x.shape[1], cfg.d_model,
                          device=self.device).to(x.dtype)[None]
        for p in self.enc:
            x = checkpoint(_enc_layer, cfg, p, x, use_reentrant=False,
                           preserve_rng_state=False) \
                if remat else _enc_layer(cfg, p, x)
        return rms_norm(x, self.enc_norm)

    @torch.no_grad()
    def encode(self, frames):
        """frames: [B, S_enc, d] (stub embeddings) -> [B, S_enc, d]."""
        return self._encoder(frames)

    # -------------- decoder --------------
    def _dec_embed(self, tokens, offset=0):
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = F.embedding(tokens, self.embed).to(cfg.compute_dtype)
        pe = _sinusoid(tokens.shape[1], cfg.d_model, offset, self.device)
        return x + pe.to(x.dtype)

    def _head(self, x):
        return dense(rms_norm(x, self.final_norm), self.lm_head).float()

    # -------------- serving --------------
    def init_cache(self, batch: int, max_seq: int) -> dict:
        cfg = self.cfg
        cross = (self.dec_layers, batch, cfg.enc_seq, cfg.num_kv_heads,
                 cfg.head_dim)
        return {
            "self": [{k: torch.zeros(shape, dtype=dt, device=self.device)
                      for k, (shape, dt) in attn.attn_cache_defs(
                          cfg, batch, max_seq).items()}
                     for _ in range(self.dec_layers)],
            "cross_k": torch.zeros(cross, dtype=cfg.cache_dtype,
                                   device=self.device),
            "cross_v": torch.zeros(cross, dtype=cfg.cache_dtype,
                                   device=self.device),
        }

    @torch.no_grad()
    def prefill(self, frames, tokens, max_seq: int):
        """frames: [B, S_enc, d]; tokens: [B, S] -> (last-token logits
        [B, V] float32, cache)."""
        cfg = self.cfg
        enc = self.encode(frames)
        cache = self.init_cache(tokens.shape[0], max_seq)
        x = self._dec_embed(tokens)
        for l, p in enumerate(self.dec):
            y, cache["self"][l] = attn.attn_prefill(
                cfg, p["self"], rms_norm(x, p["ln1"]), cache["self"][l])
            x = x + y
            k, v = attn.cross_kv(cfg, p["cross"], enc)
            x = x + attn.cross_attn_forward(cfg, p["cross"],
                                            rms_norm(x, p["ln2"]), (k, v))
            x = x + _mlp(p["mlp"], rms_norm(x, p["ln3"]))
            cache["cross_k"][l] = k
            cache["cross_v"][l] = v
        return self._head(x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode(self, cache, token, pos):
        """One decode step. token: [B, 1]; pos: the count of tokens so far
        (an int, or [B] for each row).  Returns (logits [B, V] float32,
        cache); the cache is updated in place."""
        cfg = self.cfg
        x = self._dec_embed(token, offset=pos)
        pos = torch.as_tensor(pos, device=self.device).long().reshape(-1) \
            .expand(x.shape[0])
        for l, p in enumerate(self.dec):
            y, cache["self"][l] = attn.attn_decode(
                cfg, p["self"], rms_norm(x, p["ln1"]), cache["self"][l], pos)
            x = x + y
            kv = (cache["cross_k"][l].to(cfg.compute_dtype),
                  cache["cross_v"][l].to(cfg.compute_dtype))
            x = x + attn.cross_attn_forward(cfg, p["cross"],
                                            rms_norm(x, p["ln2"]), kv)
            x = x + _mlp(p["mlp"], rms_norm(x, p["ln3"]))
        return self._head(x)[:, 0], cache
