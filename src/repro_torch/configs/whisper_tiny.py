"""whisper-tiny [audio]: 4L enc + 4L dec, d_model=384 6H (kv=6) d_ff=1536
vocab=51865 — encoder-decoder; conv frontend is a STUB (input_specs()
provides precomputed frame embeddings [B, enc_seq, d]) [arXiv:2212.04356].

Positional embeddings are sinusoidal on both sides (the reference decoder
uses a learned 448-slot table; sinusoidal generalizes to the stress shapes
— adaptation noted in DESIGN.md).
"""
from .base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        d_model=384,
        vocab_size=51865,
        layout=((("dec",), 4),),
        enc_layers=4,
        enc_seq=1500,
        num_heads=6,
        num_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        pos_embed="sinusoidal",
        microbatch=2,            # §Perf: big-batch tiny-model memory
    )
