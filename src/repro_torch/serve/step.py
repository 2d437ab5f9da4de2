"""Serving steps: prefill (builds the cache) and decode (one new token with
a KV/state cache of `max_seq`).  The port's model carries its weights, so a
step takes the model where the reference's takes params."""
from __future__ import annotations


def make_prefill_step(cfg, max_seq):
    if cfg.family == "audio":
        raise NotImplementedError("the audio family (Whisper) is not ported "
                                  "yet (ROADMAP.md, 'Modules to port')")

    def prefill_step(model, batch):
        return model.prefill(batch["tokens"], max_seq)
    return prefill_step


def make_decode_step(cfg):
    def decode_step(model, cache, token, pos):
        return model.decode(cache, token, pos)
    return decode_step
