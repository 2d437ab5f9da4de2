"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, 1:2 ratio [arXiv:2402.19427].

Layout: (rec, rec, lattn) x 8 periods + (rec, rec) leftover = 26 layers.
"""
from .base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        d_model=2560,
        vocab_size=256000,
        layout=(
            (("rec", "rec", "lattn"), 8),
            (("rec", "rec"), 1),
        ),
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        window=2048,
        lru_width=2560,
        ssm_conv=4,
        rope_theta=1e4,
        scale_embed=True,
        logits_softcap=30.0,
        microbatch=2,            # §Perf: fits 16 GB/chip
    )
