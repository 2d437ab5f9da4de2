"""Fault-injection runtime + failure policy engine (DESIGN.md §11).

The paper targets Spark because the RDD substrate supplies fault
tolerance for free; this module is the JAX reproduction's equivalent
substrate, split into three pieces every layer shares:

* **Injection harness** — named sites (`SITES`) threaded through the
  executor (`lower.py`), the distributed backend (`distributed.py`) and
  the serving layer (`serve/plans.py`).  `site(name, **payload)` is a
  no-op unless a `FaultInjector` is active (one global read per call),
  in which case scripted `FaultSpec`s fire on the Nth hit: transient
  UNAVAILABLE-style errors, RESOURCE_EXHAUSTED capacity errors,
  deterministic user errors, NaN poisoning of a request lane, or a
  slow-round straggler that advances the injected clock.  Everything is
  deterministic — tests replay exact schedules.

* **Classifier + retry policy** — `classify(exc)` sorts any exception
  into transient / capacity / deterministic / shard_lost (a peer died
  holding data → the surgical-recovery lane, DESIGN.md §13);
  `run_with_retries` retries
  transients at the SAME ladder level with bounded exponential backoff,
  and re-raises everything else for the caller to descend the ladder.
  Deterministic errors get AT MOST one ladder descent before they
  surface (a user error reproduces at every level — retrying it forever
  would hide it); capacity errors descend immediately (the same
  allocation will fail again at this level).

* **Failure ledger** — one `FaultLedger` per compiled program (shared
  with its distributed wrapper) recording retries, ladder descents,
  recoveries and straggler events; `CompiledProgram.explain_faults()`
  renders it golden-testably next to explain()/explain_rounds().
"""
from __future__ import annotations

import re
import time
import zlib
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np


def checksum(x) -> int:
    """crc32 integrity stamp over an array's dtype, shape and raw bytes —
    the ONE checksum every robustness tier shares: checkpoint snapshots
    (checkpoint/manager.py), peer-replicated loop carries (runtime/ft.py)
    and shard-recovery verification (distributed._recover_shard) all stamp
    and verify with this, so a block recovered from any tier checks out
    against a stamp taken by any other."""
    a = np.asarray(x)
    h = zlib.crc32(str((a.dtype.str, a.shape)).encode())
    # the raw bytes as a uint8 view: the same bytes as tobytes(), no copy
    raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return zlib.crc32(raw, h) & 0xFFFFFFFF

# every named injection site threaded through the system; `site()`
# rejects names outside this registry so a renamed call-site cannot
# silently detach its scripted faults
SITES = frozenset({
    "lower.whole_trace",     # whole-program trace + call (lower._run_whole)
    "lower.node",            # per-node guard (PlanExecutor.run_node)
    "lower.loop_iter",       # host-driven SeqLoop iteration (run_stepwise)
    "dist.fused_compile",    # fused-region shard_map compile/exec
    "dist.round_exec",       # per-round jit+shard_map execution
    "dist.exchange",         # collective exchange (trace-time, in-body)
    "serve.stack",           # host-side batch stacking (poisonable)
    "serve.device_put",      # host→device transfer of a stacked batch
    "serve.batched_call",    # vmapped whole-program dispatch
    "lower.chunk_step",      # out-of-core chunk step dispatch (chunked.py)
    "lower.chunk_prefetch",  # out-of-core tile host→device prefetch
    "dist.shard_lost",       # post-round shard-partition loss (surgical
    #                          recovery, DESIGN.md §13) — fires AFTER a
    #                          round executed, modelling a worker dying
    #                          while holding its output partition
})

KINDS = ("transient", "capacity", "deterministic", "poison", "slow",
         "shard_lost")


class FaultError(Exception):
    """Base class of injected faults (classification is by subclass)."""


class TransientFault(FaultError):
    """Scripted UNAVAILABLE-style error: retryable at the same level."""


class CapacityFault(FaultError):
    """Scripted RESOURCE_EXHAUSTED-style error: descend, don't retry."""


class DeterministicFault(FaultError):
    """Scripted user error: reproduces at every level, surfaces after at
    most one ladder descent."""


class ShardLostFault(FaultError):
    """A shard's output partition was lost after a round executed (worker
    death).  `shard` is the lost partition index; the distributed executor
    recovers it surgically from lineage (DESIGN.md §13) instead of
    descending the ladder — unless the same shard was already lost within
    the policy TTL."""

    def __init__(self, msg: str, shard: int = 0):
        super().__init__(msg)
        self.shard = int(shard)


class PoisonedOutput(Exception):
    """A served lane carried non-finite values (serve nan_guard)."""


@dataclass
class FaultSpec:
    """One scripted fault: fire at `site` on hits `nth..nth+times-1`
    (1-based, counted per site).  `rid`-matched specs ignore the hit
    counter and instead fire whenever the request id appears in the
    site's payload (serving sites pass `rids`), up to `times` firings —
    that is how a single poisoned request deterministically fails every
    batch it rides in.  `delay_s` is the injected-clock advance of a
    `slow` spec; `message` overrides the raised text; `shard` is the
    partition index a `shard_lost` spec kills."""

    site: str
    kind: str = "transient"
    nth: int = 1
    times: int = 1
    rid: int | None = None
    delay_s: float = 0.0
    message: str = ""
    shard: int = 0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown injection site {self.site!r} "
                             f"(registry: {sorted(SITES)})")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclass
class RetryPolicy:
    """Bounded retry + backoff for transients, and the expiry of the
    per-signature whole-program disable memo (DESIGN.md §11 table)."""

    max_retries: int = 2       # same-level re-attempts for transients
    backoff_s: float = 0.02    # initial backoff, doubled per attempt
    max_backoff_s: float = 0.5
    disable_ttl: int = 8       # eager runs a failed whole signature sits
    #                            out before its trace is re-attempted
    shard_loss_ttl_s: float = 60.0   # a SECOND loss of the same shard
    #                            within this window escalates to the
    #                            ladder (the "worker" is flapping —
    #                            recomputing onto it again is throwaway)


class FaultInjector:
    """Deterministic scripted-fault dispenser; activate with inject()."""

    def __init__(self, *specs: FaultSpec, clock=None):
        self.specs = list(specs)
        self.clock = clock              # needs .advance(s) for slow specs
        self.hits: Counter = Counter()  # site → calls seen
        self.fired: list[dict] = []     # every firing, in order
        self._rid_left = {id(s): s.times for s in self.specs
                          if s.rid is not None}

    def fire(self, name: str, payload: dict) -> None:
        self.hits[name] += 1
        k = self.hits[name]
        for s in self.specs:
            if s.site != name:
                continue
            if s.rid is not None:
                rids = payload.get("rids") or ()
                if s.rid not in rids or self._rid_left[id(s)] <= 0:
                    continue
                self._rid_left[id(s)] -= 1
            elif not (s.nth <= k < s.nth + s.times):
                continue
            self.fired.append({"site": name, "kind": s.kind, "hit": k,
                               "rid": s.rid})
            self._act(s, name, k, payload)

    def _act(self, s: FaultSpec, name: str, k: int, payload: dict) -> None:
        if s.kind == "slow":
            if self.clock is not None and hasattr(self.clock, "advance"):
                self.clock.advance(s.delay_s)
            return
        if s.kind == "poison":
            # NaN-poison the matched request's lane in the stacked batch
            # (serve.stack passes mutable numpy arrays + the lane rids)
            arrays = payload.get("arrays")
            rids = payload.get("rids") or ()
            if arrays is None or s.rid not in rids:
                return
            lane = rids.index(s.rid)
            for v in arrays.values():
                for col in (v if isinstance(v, tuple) else (v,)):
                    if np.issubdtype(col.dtype, np.floating):
                        col[lane] = np.nan
            return
        msg = s.message or f"injected {s.kind} fault at {name} (hit {k})"
        if s.kind == "transient":
            raise TransientFault(f"UNAVAILABLE: {msg}")
        if s.kind == "capacity":
            raise CapacityFault(f"RESOURCE_EXHAUSTED: {msg}")
        if s.kind == "shard_lost":
            raise ShardLostFault(f"shard {s.shard} lost: {msg}", s.shard)
        raise DeterministicFault(msg)


_ACTIVE: FaultInjector | None = None


def active() -> FaultInjector | None:
    return _ACTIVE


@contextmanager
def inject(*specs: FaultSpec, clock=None):
    """Activate a scripted injector for the with-block (tests/benches).
    Yields the injector so callers can assert on hits/fired."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = inj = FaultInjector(*specs, clock=clock)
    try:
        yield inj
    finally:
        _ACTIVE = prev


def site(name: str, **payload) -> None:
    """The hook placed at every injection site.  Zero-cost when no
    injector is active; under jit/vmap it fires at TRACE time only
    (python-level), which is exactly where compile faults live."""
    inj = _ACTIVE
    if inj is not None:
        inj.fire(name, payload)


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

_TRANSIENT_TOKENS = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
                     "connection reset", "socket closed", "NCCL")
# matched case-insensitively against str(exc) — real allocator messages
# disagree on casing across backends ("RESOURCE_EXHAUSTED: Out of
# memory", "Resource exhausted: ...", CUDA's "out of memory", TPU's
# "Ran out of memory in memory space hbm")
_CAPACITY_TOKENS = ("resource_exhausted", "resource exhausted",
                    "out of memory", "out_of_memory",
                    "ran out of memory", "failed to allocate",
                    "allocation failure", "hbm exhausted")
# "OOM" only as a standalone word — a bare substring would classify
# "bloom rebuild failed" as capacity
_OOM_WORD = re.compile(r"(?<![A-Za-z0-9])OOM(?![A-Za-z0-9])", re.IGNORECASE)
# real runtime errors that mean a peer/device DIED holding data — the
# surgical-recovery lane (DESIGN.md §13), distinct from transients (the
# data is gone, a same-level retry reads from a corpse) and from
# capacity (nothing is over budget)
_SHARD_LOST_TOKENS = ("device lost", "device unavailable",
                      "device_unavailable", "worker lost", "peer down",
                      "data transfer failed", "slice has been terminated")
# exception TYPES that mean capacity regardless of message wording:
# jaxlib's XlaRuntimeError subclasses (XlaRuntimeError itself carries the
# status token, but backends also raise dedicated OOM types), numpy's
# _ArrayMemoryError (a MemoryError subclass, caught above), torch-style
# OutOfMemoryError — matched by NAME up the MRO so classification never
# imports backend modules
_CAPACITY_TYPE_NAMES = frozenset({"OutOfMemoryError", "XlaOomError"})


def classify(exc: BaseException) -> str:
    """transient / capacity / deterministic.  Injected faults classify by
    type; real runtime errors by exception type name and the XLA status
    tokens their messages carry, case-insensitively (an honest
    ``XlaRuntimeError: RESOURCE_EXHAUSTED`` from a too-big allocation
    lands in the same capacity lane as the scripted one).  Anything
    unrecognized is deterministic — the safe default, because retrying an
    unknown error forever is the one behaviour the ladder must never
    exhibit."""
    if isinstance(exc, TransientFault):
        return "transient"
    if isinstance(exc, ShardLostFault):
        return "shard_lost"
    if isinstance(exc, CapacityFault) or isinstance(exc, MemoryError):
        return "capacity"
    if isinstance(exc, DeterministicFault):
        return "deterministic"
    if any(t.__name__ in _CAPACITY_TYPE_NAMES for t in type(exc).__mro__):
        return "capacity"
    s = str(exc)
    low = s.lower()
    if any(t in low for t in _CAPACITY_TOKENS) or _OOM_WORD.search(s):
        return "capacity"
    if any(t in low for t in _SHARD_LOST_TOKENS):
        return "shard_lost"
    if any(t in s for t in _TRANSIENT_TOKENS):
        return "transient"
    return "deterministic"


# ---------------------------------------------------------------------------
# failure ledger
# ---------------------------------------------------------------------------

@dataclass
class FaultLedger:
    """Per-program record of everything the failure policy did:
    retries, ladder descents, recoveries, straggler rounds.  `clock` and
    `sleep` are injectable (fake-clock tests never sleep for real); the
    straggler watchdog is the runtime/ft.py trailing-median idiom applied
    to round/batch wall times."""

    name: str = ""
    events: list = field(default_factory=list)
    counters: Counter = field(default_factory=Counter)
    straggler_factor: float = 3.0

    def __post_init__(self):
        self.clock = time.monotonic
        self.sleep = time.sleep
        self._times: list[float] = []
        self._last_med = 0.0           # trailing median at the last
        #                                straggler firing (speculation math)
        self.spec_saved_s = 0.0        # wall time the speculative copies
        #                                won back (bench accounting)
        self.level_reached = ""        # deepest ladder level this program
        #                                ever descended to

    def record(self, kind: str, label: str, detail: str = "") -> None:
        self.events.append((kind, label, detail))
        self.counters[kind] += 1

    def retry(self, label: str, exc, attempt: int, delay: float) -> None:
        self.record("retry", label,
                    f"{type(exc).__name__} attempt {attempt}, "
                    f"backoff {delay * 1e3:.0f}ms")

    def descend(self, frm: str, to: str, exc) -> None:
        self.level_reached = to
        self.record("descend", f"{frm}->{to}",
                    f"{classify(exc)}: {str(exc)[:96]}")

    def recover(self, label: str) -> None:
        self.record("recover", label)

    def recovered(self, label: str, detail: str = "") -> None:
        """Surgical shard recovery (lineage recompute / peer replica /
        speculative win) — distinct from `recover`, which marks a
        same-level RETRY succeeding."""
        self.record("recovered", label, detail)

    def note_time(self, label: str, dt: float) -> bool:
        """Straggler watchdog: a round exceeding straggler_factor × the
        trailing-median round time is an event (TrainRunner idiom).
        Returns True when the sample straggled.  A flagged sample is NOT
        folded into the trailing window — one genuine straggler must not
        drag the median up and mask the next one (two consecutive slow
        rounds both flag)."""
        window = self._times[-20:]
        straggled = False
        if len(window) >= 3:
            med = sorted(window)[len(window) // 2]
            if med > 0 and dt > self.straggler_factor * med:
                self._last_med = med
                self.record("straggler", label,
                            f"{dt * 1e3:.1f}ms vs median {med * 1e3:.1f}ms")
                straggled = True
        if not straggled:
            self._times.append(dt)
        return straggled

    def explain(self) -> str:
        """Golden-testable text form, the way explain()/explain_rounds()
        pin the plan: the counter summary line, then every event."""
        c = self.counters
        out = [f"== fault ledger: {self.name} ==",
               f"retries={c['retry']} descents={c['descend']} "
               f"recoveries={c['recover']} stragglers={c['straggler']}"
               + (f" shard-recovered={c['recovered']}"
                  if c["recovered"] else "")
               + (f" speculative={c['speculative']}"
                  if c["speculative"] else "")
               + (f"  ladder-level-reached={self.level_reached}"
                  if self.level_reached else "")]
        for kind, label, detail in self.events:
            out.append(f"  {kind:<9}[{label}]"
                       + (f" {detail}" if detail else ""))
        return "\n".join(out)


def run_with_retries(fn, *, policy: RetryPolicy, ledger: FaultLedger,
                     label: str, sleep=None):
    """Execute fn(), retrying TRANSIENT failures at the same ladder level
    with bounded exponential backoff.  Capacity and deterministic errors
    re-raise immediately — descending the ladder is the caller's move,
    and how far a deterministic error may descend (exactly one level) is
    enforced there.  Records retry + recover events in the ledger."""
    zzz = sleep if sleep is not None else ledger.sleep
    attempt = 0
    while True:
        try:
            out = fn()
            if attempt:
                ledger.recover(label)
            return out
        except Exception as ex:            # noqa: BLE001 — policy engine
            # `unpaired`: a distributed round failed after a collective
            # went out; it is retried only by the whole run, on every rank
            if classify(ex) != "transient" or attempt >= policy.max_retries \
                    or getattr(ex, "unpaired", False):
                raise
            delay = min(policy.backoff_s * (2 ** attempt),
                        policy.max_backoff_s)
            attempt += 1
            ledger.retry(label, ex, attempt, delay)
            zzz(delay)
