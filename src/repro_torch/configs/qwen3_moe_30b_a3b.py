"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936 — MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from .base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        d_model=2048,
        vocab_size=151936,
        layout=((("moe",), 48),),
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=0,                      # no dense FFN: MoE only
        moe_d_ff=768,
        num_experts=128,
        top_k=8,
        rope_theta=1e6,
    )
