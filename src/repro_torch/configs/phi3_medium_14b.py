"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA [arXiv:2404.14219]."""
from .base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        d_model=5120,
        vocab_size=100352,
        layout=((("dense",), 40),),
        num_heads=40,
        num_kv_heads=10,
        head_dim=128,
        d_ff=17920,
        rope_theta=1e4,
        microbatch=2,            # §Perf: fits 16 GB/chip
    )
