"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000
— MoE 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base]."""
from .base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        d_model=7168,
        vocab_size=32000,
        layout=((("moe",), 35),),
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,                   # dense residual MLP (runs alongside MoE)
        moe_d_ff=4864,
        num_experts=128,
        top_k=2,
        dense_residual=True,
        rope_theta=1e6,
        microbatch=8,            # §Perf: 145->32 GB/chip (512-chip pod fits)
        opt_dtype="bf16",        # §Perf: halves the Adam-moment floor
        attn_chunk=512,
    )
