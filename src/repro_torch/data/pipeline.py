"""Deterministic synthetic LM data pipeline: a copy of the reference's
src/repro/data/pipeline.py (numpy only), so that both packages draw the
same token stream from (seed, step).

One addition, `microbatch` (the train config's k): a host's rows are its
share of each of the k microbatches, not one contiguous block.  The
reference's step on a global batch takes microbatch i as global rows
[i·B/k, (i+1)·B/k) and GSPMD cuts those over the data axis, so host h of
H holds the h-th of H equal parts of each, in row order; the port's data-
parallel step then cuts its local rows into k slices as the single-device
step does.  With k = 1 (the default) that is the reference's contiguous
slice.

Designed for the multi-host setting: every host draws only its slice of the
global batch (host-sharded loading), and the pipeline position (`step`) is
part of its checkpointable state so a restarted/elastically-rescaled job
resumes the exact token stream (fault tolerance; see checkpoint/).
"""
from __future__ import annotations

import numpy as np


class SyntheticLMData:
    def __init__(self, vocab_size: int, global_batch: int, seq_len: int,
                 seed: int = 0, host_index: int = 0, host_count: int = 1,
                 with_frames: int = 0, d_model: int = 0,
                 with_pos_ids: bool = False, microbatch: int = 1):
        if global_batch % (host_count * microbatch):
            raise ValueError(f"global batch {global_batch} does not cut "
                             f"into {microbatch} microbatches of "
                             f"{host_count} hosts' equal shares")
        self.vocab = vocab_size
        self.global_batch = global_batch
        self.local_batch = global_batch // host_count
        self.seq = seq_len
        self.seed = seed
        self.host = host_index
        self.step = 0
        self.with_frames = with_frames
        self.d_model = d_model
        self.with_pos_ids = with_pos_ids
        self.microbatch = microbatch

    # --- checkpointable state ---
    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict, host_index: int | None = None,
                host_count: int | None = None):
        """Elastic restore: host topology may differ from save time."""
        self.step = int(state["step"])
        self.seed = int(state["seed"])
        if host_count is not None:
            if self.global_batch % (host_count * self.microbatch):
                raise ValueError(f"global batch {self.global_batch} does "
                                 f"not cut into {self.microbatch} "
                                 f"microbatches of {host_count} hosts' "
                                 "equal shares")
            self.local_batch = self.global_batch // host_count
            self.host = host_index or 0

    def _rng(self):
        # independent of host_count: key on (seed, step) then slice rows
        return np.random.default_rng((self.seed, self.step))

    def _rows(self):
        """This host's rows of the global batch: its part of each
        microbatch (a slice when there is one microbatch)."""
        k = self.microbatch
        part = self.local_batch // k
        if k == 1:
            lo = self.host * part
            return slice(lo, lo + part)
        per = self.global_batch // k
        lo = np.arange(k)[:, None] * per + self.host * part
        return (lo + np.arange(part)[None, :]).reshape(-1)

    def next_batch(self) -> dict:
        rng = self._rng()
        tokens = rng.integers(0, self.vocab,
                              size=(self.global_batch, self.seq + 1),
                              dtype=np.int32)
        sl = self._rows()
        batch = {"tokens": tokens[sl, :-1], "labels": tokens[sl, 1:]}
        if self.with_frames:
            batch["frames"] = rng.standard_normal(
                (self.global_batch, self.with_frames, self.d_model),
                dtype=np.float32)[sl]
        if self.with_pos_ids:
            pos = np.broadcast_to(np.arange(self.seq, dtype=np.int32)[None, :, None],
                                  (self.local_batch, self.seq, 3))
            batch["pos_ids"] = np.ascontiguousarray(pos)
        self.step += 1
        return batch
