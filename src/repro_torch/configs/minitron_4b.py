"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron [arXiv:2407.14679]."""
from .base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        d_model=3072,
        vocab_size=256000,
        layout=((("dense",), 32),),
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        rope_theta=1e4,
        microbatch=2,            # §Perf: fits 16 GB/chip
    )
