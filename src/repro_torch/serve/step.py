"""Serving steps: prefill (builds the cache) and decode (one new token with
a KV/state cache of `max_seq`).  The port's model carries its weights, so a
step takes the model where the reference's takes params.  The audio
family's prefill takes the batch's stub frames [B, enc_seq, d] beside its
tokens."""
from __future__ import annotations

import torch


def make_prefill_step(cfg, max_seq):
    if cfg.family == "audio":
        def prefill_step(model, batch):
            return model.prefill(batch["frames"], batch["tokens"], max_seq)
    else:
        def prefill_step(model, batch):
            return model.prefill(batch["tokens"], max_seq,
                                 pos_ids=batch.get("pos_ids"))
    return prefill_step


def make_decode_step(cfg, moe_groups: int = 1):
    """`moe_groups`: see `LM.decode` (the engine passes its slots; the
    audio family has no MoE layer and takes none)."""
    if cfg.family == "audio":
        def decode_step(model, cache, token, pos):
            # the sinusoid takes the position as a tensor: an int would be
            # a constant of a captured graph
            pos = torch.as_tensor(pos, device=model.device).long() \
                .reshape(-1).expand(len(token))
            return model.decode(cache, token, pos)
    else:
        def decode_step(model, cache, token, pos):
            return model.decode(cache, token, pos, moe_groups=moe_groups)
    return decode_step
