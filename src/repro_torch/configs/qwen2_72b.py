"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — GQA, QKV bias [arXiv:2407.10671]."""
from .base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        d_model=8192,
        vocab_size=152064,
        layout=((("dense",), 80),),
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        qkv_bias=True,
        rope_theta=1e6,
        microbatch=4,            # §Perf: fits 16 GB/chip (31->15 GB)
    )
