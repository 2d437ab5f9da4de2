"""Model/arch configuration and the architecture registry.

A copy of the reference package's `configs/base.py` with torch dtypes in
place of jnp dtypes.  Every field is kept, so that a config reads the same
in both packages; the perf knobs of the reference's sharded runs are
carried but unused."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

# layout entry kinds: "dense" (attn+SwiGLU), "moe" (attn+MoE),
# "ssm" (mamba), "rec" (RG-LRU+MLP), "lattn" (local-window attn+MLP)
Layout = tuple[tuple[tuple[str, ...], int], ...]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    vocab_size: int
    layout: Layout
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    qkv_bias: bool = False
    rope_theta: float = 1e6
    pos_embed: str = "rope"          # rope | sinusoidal | none
    window: int = 0                  # local attention window
    mrope_sections: tuple[int, ...] = ()
    scale_embed: bool = False
    logits_softcap: float = 0.0
    # moe
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25
    # ssm / recurrent
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0
    lru_width: int = 0
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500
    # numerics / perf knobs
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    cache_dtype: Any = torch.bfloat16
    attn_chunk: int = 1024
    scan_chunk: int = 256
    ce_chunk: int = 512              # tokens per chunk in the fused CE loss
    remat: str = "full"              # full | dots | none
    # perf knobs of the reference's sharded runs (unused by the port yet)
    shard_embed_vocab: bool = True
    fsdp_experts: bool = True
    microbatch: int = 1
    opt_dtype: str = "f32"
    sp_attn: bool = True

    @property
    def d_inner(self) -> int:
        return self.d_model * self.ssm_expand

    @property
    def num_layers(self) -> int:
        return sum(len(pat) * reps for pat, reps in self.layout)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: dict[str, Any] = {}


def register(fn):
    """Decorator: registers `fn() -> ModelConfig` under the config name."""
    cfg = fn()
    _REGISTRY[cfg.name] = cfg
    return fn


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from . import archs  # noqa: F401  (populates the registry)


def smoke_config(name: str) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    cfg = get_config(name)
    shrink = dict(
        d_model=64, d_ff=128, num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16, vocab_size=256, param_dtype=torch.float32,
        compute_dtype=torch.float32, cache_dtype=torch.float32,
        attn_chunk=32, scan_chunk=8, microbatch=1,
    )
    if cfg.num_experts:
        shrink.update(num_experts=4, top_k=2, moe_d_ff=64)
    if cfg.ssm_state:
        shrink.update(ssm_state=4, ssm_dt_rank=8)
    if cfg.lru_width:
        shrink.update(lru_width=64)
    if cfg.window:
        shrink.update(window=16)
    if cfg.enc_layers:
        shrink.update(enc_layers=2, enc_seq=16)
    if cfg.mrope_sections:
        shrink.update(mrope_sections=(2, 3, 3))  # sums to head_dim/2 = 8
    # shrink the layout to ~one period + leftovers
    layout = tuple((pat, min(reps, 2)) for pat, reps in cfg.layout[:2])
    return cfg.replace(layout=layout, **shrink)
