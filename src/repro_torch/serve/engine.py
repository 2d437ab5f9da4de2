"""Continuous-batching serve engine.

Fixed-slot batched decoding: requests join a slot after a prefill into
that slot's cache region, decode steps run for the whole batch every tick,
and finished slots are recycled.

Per-slot positions: the reference `vmap`s a batch-1 decode over the slots;
the port runs one decode over [slots, 1] tokens with a pos[slots] vector,
so that each row ropes at its own position, writes its k/v at its own
cache position and attends to the positions ≤ its own.  MoE layers route
each slot's token as a group of its own (`moe_groups=slots`): capacity
couples the rows of one call, and a batch routed as one would let other
slots, idle ones included, take a slot's capacity.

Compiled steps: as the reference jits its decode and its prefill a prompt
length, the engine runs both through `serve/graph.py` by default: one CUDA
graph for the decode over the engine's own cache (updated in place), one a
prompt length seen twice for the prefill (a length's first prefill runs
the plain step), whose outputs are spliced into the slot at once.  Both
paths take the argmax of the returned logits and read it once a tick.
`graphed=False` runs the plain steps eagerly, for comparing the two.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graph import graphed_decode, graphed_prefill
from .step import make_decode_step, make_prefill_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [len] int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg, model, *, slots: int = 4, max_seq: int = 128,
                 graphed: bool = True):
        if cfg.family == "audio":      # the reference's refusal
            raise ValueError("enc-dec engine: use Whisper API "
                             "(make_prefill_step / make_decode_step)")
        self.cfg = cfg
        self.model = model
        self.slots = slots
        self.max_seq = max_seq
        self.graphed = graphed
        prefill = make_prefill_step(cfg, max_seq)
        decode = make_decode_step(cfg, moe_groups=slots)
        if graphed:
            prefill, decode = graphed_prefill(prefill), graphed_decode(decode)
        self._prefill, self._decode = prefill, decode
        self.cache = model.init_cache(slots, max_seq)
        self.pos = np.zeros(slots, np.int64)
        self.active: list[Request | None] = [None] * slots
        self.queue: list[Request] = []
        self._next_rid = 0

    # ---- public API ----
    def submit(self, prompt: np.ndarray, max_new: int, rid: int | None = None):
        # rid defaults to a monotonic counter: `len(self.queue)` would
        # recycle ids once the queue drains, aliasing distinct requests.
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        r = Request(rid, prompt, max_new)
        self.queue.append(r)
        return r

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                r = self.queue.pop(0)
                logits, cache1 = self._prefill(
                    self.model, {"tokens": np.asarray(r.prompt)[None]})
                # splice the single-sequence cache into slot s
                for full, one in zip(self.cache, cache1):
                    for k, t in one.items():
                        full[k][s:s + 1] = t
                self.pos[s] = len(r.prompt)
                r.out.append(int(torch.argmax(logits[0])))
                self.active[s] = r

    def step(self):
        """One engine tick: admit new requests, one decode step for all
        active slots, retire finished ones.  Returns #active + #queued."""
        self._admit()
        if not any(self.active):
            return 0
        toks = np.zeros((self.slots, 1), np.int64)
        for s, r in enumerate(self.active):
            if r is not None:
                toks[s, 0] = r.out[-1]
        logits, self.cache = self._decode(self.model, self.cache, toks,
                                          self.pos)
        nxt = torch.argmax(logits, -1).cpu().numpy()
        n_active = 0
        for s, r in enumerate(self.active):
            if r is None:
                continue
            self.pos[s] += 1
            r.out.append(int(nxt[s]))
            if len(r.out) >= r.max_new or self.pos[s] >= self.max_seq - 1:
                r.done = True
                self.active[s] = None
            else:
                n_active += 1
        return n_active + len(self.queue)

    def run(self, max_ticks: int = 1000):
        t = 0
        while (any(self.active) or self.queue) and t < max_ticks:
            self.step()
            t += 1
