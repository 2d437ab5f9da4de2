"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191].

Backbone only per assignment: the vision frontend is a STUB — input_specs()
supplies M-RoPE position ids [B, S, 3] (temporal/height/width) as if
produced by the patch-embedding pipeline.
"""
from .base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        d_model=8192,
        vocab_size=152064,
        layout=((("dense",), 80),),
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        qkv_bias=True,
        rope_theta=1e6,
        mrope_sections=(16, 24, 24),  # sums to head_dim/2
        microbatch=4,            # §Perf: fits 16 GB/chip
    )
