"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — GQA, 128k vocab [arXiv:2407.21783]."""
from .base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        d_model=4096,
        vocab_size=128256,
        layout=((("dense",), 32),),
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        rope_theta=5e5,
        attn_chunk=2048,         # §Perf: -13% HBM traffic at equal memory
    )
