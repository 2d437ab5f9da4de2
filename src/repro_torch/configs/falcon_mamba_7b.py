"""falcon-mamba-7b [ssm]: 64L d_model=4096, attn-free, vocab=65024,
ssm_state=16 — Mamba-1 architecture [arXiv:2410.05355]."""
from .base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        d_model=4096,
        vocab_size=65024,
        layout=((("ssm",), 64),),
        ssm_state=16,
        ssm_expand=2,
        ssm_conv=4,
        ssm_dt_rank=256,            # ceil(d_model / 16)
        pos_embed="none",
    )
