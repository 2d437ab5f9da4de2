"""Operator selection: cost-modeled + autotuned backend choice for the
group-by-⊕ hot path (DESIGN.md §8), on PyTorch.

The right materialization of `SegmentReduce` depends on the shape of the
reduction (rows N, segments K, value columns D), the dtype and the device.
This module owns that choice.  Candidate backends:

  scatter   scatter-⊕ into the destination with every dropped key routed to
            a sentinel row (torch has no drop mode)
  sort      sort the keys, then a segmented ⊕ over the sorted run
  onehot    [N, K] one-hot × [N] values as a matmul — group-by as matrix
            multiplication; integer values accumulate exactly in float64
  pallas    the hand-written segment kernel.  The plan keeps the reference
            package's backend names (`"pallas"`, `"pallas-tiled"`) so that
            the planner is the same code in both packages; in this package
            `"pallas"` is the CUDA kernel of kernels/csrc/segment_reduce.cu
            and `"pallas-tiled"` the CUDA kernel of
            kernels/csrc/tile_matmul.cu.  On a CPU tensor each runs its
            plain PyTorch version.

plus the §5 packed-matmul choice (`pallas-tiled` vs unpack+einsum) and the
hot-key salting factor.

Two modes, one interface:

  cost      (default) an analytical model over shape classes, one row of
            per-element costs per platform ("cuda" or "cpu", read from the
            device the program runs on).  Deterministic: same shapes → same
            decision (golden-testable).
  autotune  measure every candidate once per SHAPE CLASS ((N, K, D)
            bucketed to powers of two, dtype, op, dest sharding) on the
            first encounter, persist the winner to an on-disk cache
            (`.repro_torch_autotune.json` by default, keyed by platform),
            so the timing cost is paid once per class.

`force:<backend>` short-circuits both (tests, A/B runs, and the legacy
`use_kernels=True` flag, which maps to `force:pallas`).

Decisions are made when a node runs — concrete shapes are known there, and
a decision changes only the computation, never its result (every backend
implements the same ⊕-merge with paper §3.4 drop semantics).  The executor
records each decision; `explain()` prints it per node.
"""
from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass
from typing import Optional

# candidate sets per monoid ⊕ (correctness, not preference: onehot only
# sums; sort covers every monoid; the segment kernel does +, min and max)
SEGMENT_CANDIDATES = {
    "+": ("scatter", "sort", "onehot", "pallas"),
    "min": ("scatter", "sort", "pallas"),
    "max": ("scatter", "sort", "pallas"),
    "*": ("scatter", "sort"),
}

CONTRACT_CANDIDATES = ("pallas-tiled", "unpack-einsum")

# hot-key salting sub-destination factors (the S in key*S + salt); "none"
# is always a candidate — it is the status quo
SALT_FACTORS = (4, 8, 16)

CACHE_FILE = ".repro_torch_autotune.json"

# H100 SXM device-memory rate, bytes per µs (3.35 TB/s)
_HBM_BYTES_PER_US = 3.35e6


def _bucket(x: int) -> int:
    """Ceil-log2 shape-class bucket: 1→0, 2→1, 3..4→2, 5..8→3, ..."""
    return max(0, int(x) - 1).bit_length()


@dataclass(frozen=True)
class Decision:
    """One resolved backend choice, with its provenance for explain()."""
    backend: str
    source: str          # "cost" | "autotune" | "cache" | "forced"
    why: str = ""

    def __str__(self) -> str:
        tail = f": {self.why}" if self.why else ""
        return f"{self.backend}[{self.source}{tail}]"


# ---------------------------------------------------------------------------
# the analytical cost model
# ---------------------------------------------------------------------------
# Abstract cost in µs: fixed dispatch overhead + per-element rates.
#
# The cpu row is the reference package's cpu row, unchanged, so that both
# packages make the same choices on the CPU.  The segment kernel's CPU form
# is its plain version, which the model never picks (pallas_fixed).
#
# The cuda row holds first-principles estimates for an H100 (dup_row
# apart, see below); autotune mode replaces them with measurement the
# first time a class is seen on the card.  The segment kernel reads 4
# bytes of id and 4 of value per row and writes the [K, D] output once,
# so its rows cost 8 bytes and its cells 8 bytes (fill + write) at
# 3.35 TB/s, plus one launch.  The torch scatter reads the same row
# through an int64 index it must first build (≈ 24 bytes a row); sort
# adds a radix sort per row and log₂N; onehot materializes an [N, K]
# matrix (≈ 8 bytes a cell).
# tile_mxu equals einsum_cell: the packed product does the same flops as
# the dense einsum, and wins by the unpack it saves — the relation the
# reference package's tpu row encodes.

_COSTS = {
    "cpu": dict(fixed=60.0, scatter_row=0.12, sort_row=0.05,
                onehot_cell=0.002, pallas_cell=0.002, pallas_fixed=2e5,
                pallas_row=0.0, pallas_kd=0.0,
                tile_mxu=math.inf, einsum_cell=4e-5, unpack_cell=1.5e-3,
                dup_row=0.0, salt_fold=0.004),
    "cuda": dict(fixed=10.0, scatter_row=24 / _HBM_BYTES_PER_US,
                 sort_row=32 / _HBM_BYTES_PER_US,
                 onehot_cell=8 / _HBM_BYTES_PER_US,
                 pallas_cell=0.0, pallas_fixed=5.0,
                 pallas_row=8 / _HBM_BYTES_PER_US,
                 pallas_kd=8 / _HBM_BYTES_PER_US,
                 tile_mxu=3e-8, einsum_cell=3e-8,
                 unpack_cell=8 / _HBM_BYTES_PER_US,
                 dup_row=1.7e-3, salt_fold=3e-4),
}
# dup_row: extra per-row cost when rows COLLIDE on one destination row —
# on the GPU, atomics on one address serialize in L2.  The cuda value is
# measured: chip_smoke.py's hot-key segment case on an H100 (a quarter of
# 2^26 rows on one of 2^20 segments) takes 1.7 ns more per hot row than
# uniform keys.  The CPU loop is sequential regardless, so 0: cost mode
# never salts on CPU.  salt_fold: per-cell cost of the [K, S] ⊕-fold that
# merges the salted sub-destinations back.


def _segment_cost(c: dict, backend: str, n: int, k: int, d: int) -> float:
    nd = n * max(1, d)
    nkd = n * k * max(1, d)
    if backend == "scatter":
        return c["fixed"] + c["scatter_row"] * nd
    if backend == "sort":
        return c["fixed"] + c["sort_row"] * n * (math.log2(max(2, n)) +
                                                 max(1, d))
    if backend == "onehot":
        return c["fixed"] + c["onehot_cell"] * nkd
    if backend == "pallas":
        return (c["pallas_fixed"] + c["pallas_cell"] * nkd
                + c["pallas_row"] * nd + c["pallas_kd"] * k * max(1, d))
    return math.inf


PROBE_ROWS = 4096          # rows of the key column the skew probe samples


def probe_hot_fraction(keys, cap: int = PROBE_ROWS) -> float:
    """Run-time skew probe: the fraction of rows held by the most frequent
    key in a host-side prefix sample of the key column (≤ `cap` rows,
    copied to the host once per call)."""
    import numpy as np
    a = np.asarray(keys)[:cap].reshape(-1)
    if a.size == 0:
        return 0.0
    _, counts = np.unique(a, return_counts=True)
    return float(counts.max()) / float(a.size)


def uniform_max_count(s: int, k: int) -> float:
    """A bound on the count of the most frequent key in `s` draws of `k`
    uniform keys, exceeded with probability ≲ 1/k: the mean s/k plus the
    Bernstein margin √(2·(s/k)·ln k) + ⅔·ln k of a union over the k keys.
    When k ≫ s the mean is below one row, yet the hottest key of a
    uniform sample still shows up two or three times."""
    lam = s / max(1, k)
    lnk = math.log(max(2, k))
    return lam + math.sqrt(2.0 * lam * lnk) + 2.0 / 3.0 * lnk


def _hot_bucket(hot_frac: float) -> int:
    """Skew bucket for the salt shape class: eighths of the stream held by
    the hottest key (0 = uniform … 8 = single-key)."""
    return max(0, min(8, int(hot_frac * 8.0 + 0.5)))


# ---------------------------------------------------------------------------
# autotune measurement (the executor's own backends on synthetic data)
# ---------------------------------------------------------------------------

_MEASURE_CELL_CAP = 2e8     # onehot materializes N×K: skip beyond this


def _measure_segment(backend: str, n: int, k: int, d: int, op: str,
                     dtype: str, device: str) -> float:
    """µs per call of one backend on synthetic data of the class shape,
    through the executor's own `segment_flat` and ⊕-combine."""
    import numpy as np
    import torch

    from .lower import COMBINE, segment_flat

    cells = n * k * max(1, d)
    if backend == "onehot" and cells > _MEASURE_CELL_CAP:
        return math.inf          # never materialized at this size: never wins
    dt = getattr(torch, str(dtype).replace("torch.", ""))
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, k, n), dtype=torch.int32,
                          device=device)
    vals = torch.as_tensor(rng.standard_normal(n)).to(device=device,
                                                      dtype=dt)
    dest = torch.zeros((k,), dtype=dt, device=device)

    def fn():
        return COMBINE[op](dest, segment_flat(backend, ids, vals, k, op)
                           .to(dt))

    # no try: a candidate that fails to build or launch raises here, so no
    # decision is made (or cached) while a kernel is broken
    cuda = torch.device(device).type == "cuda"
    fn()                                       # warm up (and build)
    if cuda:
        torch.cuda.synchronize(device)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / reps * 1e6


# ---------------------------------------------------------------------------
# the selector
# ---------------------------------------------------------------------------

class OpSelector:
    """Resolves backend choices per shape class.  One instance per
    CompiledProgram (shared with its executor); the on-disk cache is shared
    across instances via its path.  `platform` is the device type the
    program runs on: "cuda" or "cpu"."""

    def __init__(self, mode: str = "cost",
                 cache_path: Optional[str] = CACHE_FILE,
                 platform: str = "cuda", device: Optional[str] = None):
        self.mode = mode
        self.cache_path = cache_path
        self.platform = platform
        self.device = device or platform
        self._cache: dict = {}
        if mode.startswith("force:"):
            self.forced: Optional[str] = mode.split(":", 1)[1]
        else:
            self.forced = None
            if mode not in ("cost", "autotune"):
                raise ValueError(f"unknown op_select mode {mode!r}")
        # the cache is the override channel in EVERY mode: autotune writes
        # measured segment classes into it, and hand-supplied entries must
        # be honored by cost mode too — a cost-mode hit reports "cache"
        if cache_path and os.path.exists(cache_path):
            self.load(cache_path)

    def _costs(self) -> dict:
        return _COSTS.get(self.platform, _COSTS["cpu"])

    # ---- cache ----
    def load(self, path: str) -> None:
        try:
            with open(path) as f:
                blob = json.load(f)
            if blob.get("version") == 1 and \
                    blob.get("platform") == self.platform:
                self._cache.update(blob.get("decisions", {}))
        except (OSError, ValueError):
            pass                 # unreadable cache never breaks execution

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.cache_path
        if not path:
            return
        with open(path, "w") as f:
            json.dump({"version": 1, "platform": self.platform,
                       "decisions": dict(sorted(self._cache.items()))},
                      f, indent=1)

    def _remember(self, key: str, entry: dict) -> None:
        self._cache[key] = entry
        if self.cache_path:
            try:
                self.save()
            except OSError:
                pass             # read-only FS: keep the in-memory decision

    # ---- segment reduce ----
    def segment_class(self, n: int, k: int, d: int, op: str, dtype,
                      dest_dist: str) -> str:
        return (f"segment|{op}|{dtype}|n{_bucket(n)}|k{_bucket(k)}"
                f"|d{_bucket(max(1, d))}|{dest_dist}")

    def choose_segment(self, *, n: int, k: int, d: int, op: str, dtype,
                       dest_dist: str = "REP",
                       candidates: Optional[tuple] = None) -> Decision:
        cands = candidates or SEGMENT_CANDIDATES.get(op, ("scatter",))
        if self.forced is not None and self.forced in cands:
            return Decision(self.forced, "forced")
        # a forced backend the candidate set does not admit (e.g.
        # force:onehot on a min-group-by) falls through to the model —
        # pinning only applies where the pin is correct
        key = self.segment_class(n, k, d, op, str(dtype), dest_dist)
        hit = self._cache.get(key)
        if hit is not None and hit.get("backend") in cands:
            return Decision(hit["backend"], "cache", key)
        if self.mode == "autotune":
            us = {b: _measure_segment(b, n, k, max(1, d), op, dtype,
                                      self.device)
                  for b in cands}
            best = min(us, key=us.get)
            self._remember(key, {"backend": best, "shape": [n, k, d],
                                 "us": {b: (round(t, 1) if
                                            math.isfinite(t) else None)
                                        for b, t in us.items()}})
            return Decision(best, "autotune", key)
        c = self._costs()
        cost = {b: _segment_cost(c, b, n, k, max(1, d)) for b in cands}
        best = min(cost, key=cost.get)
        return Decision(best, "cost", key)

    # ---- hot-key salting (skew-aware group-by, DESIGN.md §6) ----
    def salt_class(self, n: int, k: int, op: str, nshards: int,
                   hot_frac: float) -> str:
        return (f"salt|{op}|n{_bucket(n)}|k{_bucket(k)}|p{nshards}"
                f"|h{_hot_bucket(hot_frac)}")

    def choose_salt(self, *, n: int, k: int, op: str, nshards: int = 1,
                    hot_frac: float = 0.0) -> Decision:
        """Should this group-by salt its hot keys — spread each key over S
        sub-destinations (`key*S + salt`) and ⊕-fold the [K, S] partial
        back — and at which S?  A key holding fraction h of n rows forces
        h·n colliding updates on one destination row, and salting divides
        that chain by S at the price of a k·S fold."""
        key = self.salt_class(n, k, op, nshards, hot_frac)
        hit = self._cache.get(key)
        if hit is not None:
            return Decision(hit["backend"], "cache", key)
        # skew guard: a key is only "hot" when it holds several times its
        # fair 1/K share — below that, the collision chain is the inherent
        # n/K every group-by pays, and salting can only add fold cost — AND
        # more rows of the probe's sample than the hottest of K uniform
        # keys would (the sample is ≤ PROBE_ROWS rows: with K ≫ that, 4×
        # the fair share is a fraction of one row)
        sample = min(n, PROBE_ROWS)
        if hot_frac * max(1, k) < 4.0 or \
                hot_frac * sample <= uniform_max_count(sample, k):
            return Decision("none", "cost", key)
        c = self._costs()
        # only EXCESS collisions beyond the balanced chain serialize extra
        dup = c["dup_row"] * max(0.0, hot_frac - 1.0 / max(1, k)) * n
        cost = {"none": dup}
        for s in SALT_FACTORS:
            cost[f"salt:{s}"] = c["fixed"] + dup / s + c["salt_fold"] * k * s
        best = min(cost, key=cost.get)
        return Decision(best, "cost", key)

    # ---- §5 packed contraction ----
    def choose_contract(self, *, m: int, k: int, n: int,
                        candidates: tuple = CONTRACT_CANDIDATES) -> Decision:
        """Packed-lhs matmul: the block-sparse tile kernel on the tiles vs
        unpacking and contracting on the dense einsum path.  Keyed on the
        dense flop volume."""
        if self.forced is not None and self.forced in candidates:
            return Decision(self.forced, "forced")
        key = f"contract|m{_bucket(m)}|k{_bucket(k)}|n{_bucket(n)}"
        hit = self._cache.get(key)
        if hit is not None and hit.get("backend") in candidates:
            return Decision(hit["backend"], "cache", key)
        c = self._costs()
        flops = m * k * n
        tiled = c["tile_mxu"] * flops
        einsum = c["einsum_cell"] * flops + c["unpack_cell"] * m * k
        best = "pallas-tiled" if tiled <= einsum else "unpack-einsum"
        return Decision(best, "cost", key)
