"""Multi-tenant plan serving: shape-bucketed batching of concurrent
CompiledProgram invocations (DESIGN.md §10), on PyTorch.

The port of the reference's serving layer (src/repro/serve/plans.py).  A
request queue admits concurrent invocations of registered programs,
buckets them by the whole-program compile-cache signature (static dims by
value, shapes, dtypes — the cache's keying IS the bucketing function),
pads ragged same-program requests up to the bucket shape, and coalesces
each bucket into ONE batched whole-program call
(CompiledProgram.batched_call: the batch's lanes captured together into
one entry of CUDA graphs, core/graphs.py).  Padding is semantics-free:
padded bag rows and padded bag-aligned array rows carry per-lane
`bag_limits`/`array_limits` row counts — the same §3.4 pad+mask machinery
the reference trusts.  A served request returns bit-identical results to
its solo run(), on the CPU and on the card: on the CPU the executor cuts a
lane's rows to its count; on the card the segment kernel reduces a lane's
own rows alone, and a program whose padded lanes would sum floats in
another order (a total or axis reduction over a bag) is bucketed at its
requests' own shapes instead (CompiledProgram.pads_exactly).  A request
whose solo run salts hot keys is salted alike in its lane.

Scheduling is deterministic and clock-injected: a bucket flushes when it
reaches `max_batch` requests or when its oldest request has waited
`flush_ms` (the straggler timeout).  `pump()` advances the server one
scheduling step against the injected clock — tests drive it with a fake
clock and scripted arrivals, production drives it from a background thread
(`start()`) or any event loop.  The next ready bucket is prepared while
the card still computes: bucket k+1 is stacked into pinned host memory
and its copy to the card queued behind bucket k's work, before bucket k's
outputs are read; the stacking overlaps the device's work, the copy does
not (it runs in stream order, and the stacking takes longer than a
flush's device work).  The server runs where its programs run:
compiled for the card, it serves on the card, and without one it does not
start (compile_program raises); a kernel that fails to build or launch
fails its flush, never falls back to a plain version.

Observability mirrors explain(): `stats()` returns the counters (per-bucket
queue depth, batch occupancy, padded-row fraction, p50/p99 latency,
requests/sec, batch-signature compile-cache hits/misses) and
`explain_serving()` renders the golden-testable text form.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import deque

import numpy as np
import torch

from ..core import faults as F
from ..core.graphs import HostBatch, torch_dtype


class QueueFull(RuntimeError):
    """Admission refused: the server-wide queue cap is reached.  Raised
    from submit() BEFORE a ticket exists — a shed request is never
    admitted, so the ledger invariant (admitted = completed + cancelled +
    failed + queued) is untouched; the shed is counted in stats()."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed while it was still queued: it is
    shed before pad/stack/flush ever spends work on it."""


def _bucket_len(n: int, floor: int) -> int:
    """Bucket edge for a row count: next power of two, at least `floor`.
    Ragged same-program requests round up to a shared edge so they share
    one traced batch computation instead of one signature each."""
    L = max(int(floor), 1)
    while L < n:
        L *= 2
    return L


def _pad_into(dst: np.ndarray, a: np.ndarray) -> None:
    """`a` into the first rows of `dst`, zeros in the padded rest."""
    n = a.shape[0]
    dst[:n] = a
    dst[n:] = 0


def _to_numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _pct(xs, q):
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


class PlanTicket:
    """One admitted invocation: resolves to the program's output dict
    (numpy, sliced back to the request's own shapes), or to cancelled /
    failed.  `result()` blocks (real-clock servers run a pump thread);
    deterministic tests drain() the server instead and read `output`."""

    __slots__ = ("rid", "program", "cin", "bucket", "t_submit", "deadline",
                 "state", "output", "error", "_event", "_completions")

    def __init__(self, rid, program, cin, bucket, t_submit, deadline=None):
        self.rid = rid
        self.program = program
        self.cin = cin                 # canonicalized inputs (numpy)
        self.bucket = bucket
        self.t_submit = t_submit
        self.deadline = deadline       # absolute clock time, or None
        self.state = "queued"
        self.output = None
        self.error = None
        self._event = threading.Event()
        self._completions = 0          # must stay ≤ 1 (no duplicate resolve)

    def done(self) -> bool:
        return self.state != "queued"

    def result(self, timeout=None) -> dict:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} still queued")
        if self.state == "cancelled":
            raise RuntimeError(f"request {self.rid} was cancelled")
        if self.state == "failed":
            raise self.error
        return self.output

    def _resolve(self, state, output=None, error=None):
        self._completions += 1
        assert self._completions == 1, \
            f"request {self.rid} resolved twice ({self.state} -> {state})"
        self.state = state
        self.output = output
        self.error = error
        self._event.set()


class _Bucket:
    """One shape class of one program: the queue plus its counters."""

    __slots__ = ("key", "cp", "program", "label", "static", "bag_pads",
                 "arr_pads", "limit_bags", "limit_arrays", "tickets",
                 "flushes", "reqs", "traced", "hits", "real_lanes", "lanes",
                 "pad_rows", "bag_rows", "failed_flushes", "est_peak",
                 "lane_cap", "salts")

    def __init__(self, key, cp, program, label, static, bag_pads, arr_pads,
                 salts=()):
        self.key = key
        self.cp = cp
        self.program = program
        self.label = label
        self.static = static               # dim name → value
        self.bag_pads = bag_pads           # bag name → padded row count
        self.arr_pads = arr_pads           # array name → padded dim-0
        self.salts = dict(salts)           # dest → hot-key salt factor
        self.limit_bags = tuple(sorted(bag_pads))
        self.limit_arrays = tuple(sorted(arr_pads))
        self.tickets: deque = deque()
        self.flushes = 0
        self.reqs = 0
        self.traced = 0
        self.hits = 0
        self.real_lanes = 0                # requests actually served
        self.lanes = 0                     # batch lanes dispatched (≥ real)
        self.pad_rows = 0                  # padded bag rows
        self.bag_rows = 0                  # total bag rows dispatched
        self.failed_flushes = 0            # batched calls that raised
        self.est_peak = None               # estimated device bytes per lane
        self.lane_cap = None               # memory_budget // est_peak

    def occ(self) -> float:
        return 100.0 * self.real_lanes / self.lanes if self.lanes else 0.0

    def padf(self) -> float:
        return 100.0 * self.pad_rows / self.bag_rows if self.bag_rows \
            else 0.0


class PlanServer:
    """Shared serving engine for compiled loop programs.

      server = PlanServer({"pagerank": cp_pr, "group_by": cp_gb})
      server.start()                      # background pump thread
      t = server.submit("group_by", dict(S=(k, v), C=np.zeros(10)))
      out = t.result(timeout=5.0)         # numpy output dict

    Deterministic mode (tests): pass `clock=fake_clock`, never start a
    thread, and call `pump()` / `drain()` explicitly — every scheduling
    decision reads the injected clock, so scripted arrival schedules
    replay exactly.

    `max_batch` caps requests per flush; `flush_ms` bounds how long a
    straggler waits for company; `bucket_floor` is the smallest bag bucket
    edge (row counts round up to powers of two from there);
    `batch_round=True` also rounds the LANE count up to a power of two
    (replicating the first request into dummy lanes, outputs dropped) so
    the compile cache holds O(log max_batch) entries per bucket instead of
    one per distinct batch size.  `memory_budget` (device bytes) makes
    admission memory-aware: each bucket's flush is capped at
    budget // estimated-peak-per-lane lanes (excess requests wait,
    `mem_deferred`), and requests whose single lane cannot fit shed with a
    RESOURCE_EXHAUSTED error (`mem_shed`) instead of OOM-killing a
    flush."""

    def __init__(self, programs: dict, *, max_batch: int = 8,
                 flush_ms: float = 2.0, bucket_floor: int = 8,
                 batch_round: bool = True, clock=None, prefetch: bool = True,
                 sequential_fallback: bool = True, deadline_ms: float = None,
                 queue_cap: int = None, nan_guard: bool = True,
                 bisect: bool = True, memory_budget: int = None,
                 speculative: bool = True):
        self._programs = dict(programs)
        self.max_batch = int(max_batch)
        self.flush_s = float(flush_ms) / 1e3
        self.bucket_floor = int(bucket_floor)
        self.batch_round = bool(batch_round)
        self.prefetch = bool(prefetch)
        self.sequential_fallback = bool(sequential_fallback)
        # robustness knobs (DESIGN.md §11): default request deadline (per
        # request override in submit()), server-wide admission cap, per-lane
        # non-finite output guard, and failed-batch bisection
        self.deadline_s = None if deadline_ms is None \
            else float(deadline_ms) / 1e3
        self.queue_cap = None if queue_cap is None else int(queue_cap)
        self.nan_guard = bool(nan_guard)
        self.bisect = bool(bisect)
        # memory-aware admission (DESIGN.md §12): with a device budget set,
        # each bucket gets a lane cap = budget // estimated-peak-per-lane
        # (memest over the bucket's padded signature).  A flush never takes
        # more lanes than fit — the remainder WAITS in queue (mem_deferred)
        # instead of the whole batch OOM-killing mid-flight; a request whose
        # single lane already exceeds the budget is shed with a
        # RESOURCE_EXHAUSTED error (mem_shed) that classify() reads as
        # capacity, steering the caller toward out-of-core run().
        self.memory_budget = None if memory_budget is None \
            else int(memory_budget)
        self.mem_deferred = 0              # lanes queued past their flush
        self.mem_shed = 0                  # requests too big for the budget
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.RLock()
        self._buckets: dict = {}           # key → _Bucket (insertion order)
        self._staged: dict = {}            # key → (rids, Bp, device pytree)
        self._next_rid = 0
        self._t0 = None                    # first submit time
        self._t_last = None                # last completion time
        self._lat = deque(maxlen=8192)     # completion latencies (seconds)
        self.admitted = 0
        self.completed = 0
        self.cancelled = 0
        self.failed = 0
        self.seq_fallbacks = 0
        self.load_shed = 0                 # admissions refused (queue cap)
        self.deadline_expired = 0          # queued requests shed at deadline
        self.failed_flushes = 0            # batched calls that raised
        self.bisections = 0                # failed batches split in half
        self.poisoned = 0                  # lanes failed by the nan guard
        # speculative re-execution of straggling flushes (DESIGN.md §13)
        self.speculative = bool(speculative)
        self.speculated = 0                # backup flushes launched
        # failure policy (DESIGN.md §11): server-level ledger on the
        # injected clock; with a fake clock, retry backoff never really
        # sleeps — tests replay schedules deterministically
        self.faults = F.FaultLedger("serve")
        self.faults.clock = self._clock
        if clock is not None:
            self.faults.sleep = lambda s: None
        self.policy = F.RetryPolicy()
        self._thread = None
        self._stop = None

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, program: str, inputs: dict, *,
               deadline_ms: float = None) -> PlanTicket:
        """Admit one invocation: canonicalize host-side, bucket by the
        padded compile-cache signature, enqueue.  Never blocks and never
        touches the device.  Raises QueueFull (no ticket, load-shed
        counted) when the server-wide admission cap is reached;
        `deadline_ms` (or the server default) arms a deadline after which
        the still-queued request is shed before any pad/flush work."""
        cp = self._programs[program]
        cin = cp.canonical_inputs(inputs)
        with self._lock:
            if self.queue_cap is not None:
                queued = sum(len(b.tickets) for b in self._buckets.values())
                if queued >= self.queue_cap:
                    self.load_shed += 1
                    raise QueueFull(
                        f"queue cap {self.queue_cap} reached "
                        f"({self.load_shed} shed so far)")
            b = self._bucket_for(program, cp, cin)
            now = self._clock()
            if self._t0 is None:
                self._t0 = now
            dl_s = float(deadline_ms) / 1e3 if deadline_ms is not None \
                else self.deadline_s
            t = PlanTicket(self._next_rid, program, cin, b, now,
                           deadline=None if dl_s is None else now + dl_s)
            self._next_rid += 1
            b.tickets.append(t)
            self.admitted += 1
            return t

    def cancel(self, ticket: PlanTicket) -> bool:
        """Withdraw a still-queued request.  False once it flushed."""
        with self._lock:
            if ticket.done():
                return False
            try:
                ticket.bucket.tickets.remove(ticket)
            except ValueError:
                return False
            self._staged.pop(ticket.bucket.key, None)
            ticket._resolve("cancelled")
            self.cancelled += 1
            return True

    def _bucket_for(self, program, cp, cin) -> _Bucket:
        """The request's bucket.  Its bags round up to a bucket edge where
        a padded lane keeps its solo run's bits on the program's device
        (CompiledProgram.pads_exactly), else they keep their own rows; a
        request whose solo run salts hot keys shares a bucket only with
        requests salted alike, and its lane salts as that run does."""
        params = cp.program.params
        aligned = cp.bag_row_aligned
        pad = cp.pads_exactly
        bag_pads, bag_lens = {}, {}
        for name, t in params.items():
            if t.kind == "bag":
                n = int(cin[name][0].shape[0])
                bag_lens[name] = n
                if pad:
                    bag_pads[name] = _bucket_len(n, self.bucket_floor)
        arr_pads = {}
        for arr, bag in aligned.items():
            v = cin.get(arr)
            if bag in bag_pads and isinstance(v, np.ndarray) and v.ndim \
                    and v.shape[0] == bag_lens[bag]:
                arr_pads[arr] = bag_pads[bag]
        static, psig = {}, []
        for name, t in params.items():
            v = cin[name]
            if t.kind == "dim":
                static[name] = int(v)
                psig.append((name, "dim", int(v)))
            elif t.kind == "bag":
                L = bag_pads.get(name, bag_lens[name])
                psig.append((name, "bag", tuple(
                    ((L,) + tuple(c.shape[1:]), str(c.dtype)) for c in v)))
            else:
                shp = tuple(np.shape(v))
                if name in arr_pads:
                    shp = (arr_pads[name],) + shp[1:]
                psig.append((name, t.kind, shp, str(np.asarray(v).dtype)))
        key = (program, tuple(psig), frozenset(arr_pads))
        salts = cp.request_salts(cin)
        if salts:
            key += (salts,)
        b = self._buckets.get(key)
        if b is None:
            b = _Bucket(key, cp, program, self._label(program, key, static,
                                                      bag_pads, arr_pads),
                        static, bag_pads, arr_pads, salts)
            self._mem_size(b, tuple(psig))
            self._buckets[key] = b
        return b

    def _mem_size(self, b: _Bucket, psig) -> None:
        """Estimate peak device bytes for ONE lane of this bucket (the
        padded signature IS the shape set every lane runs at) and derive
        the lane cap.  Estimation failure just leaves the bucket uncapped
        — admission control is an optimization, never a correctness
        gate."""
        if self.memory_budget is None:
            return
        try:
            from ..core import memest
            senv = memest.shape_env_from_signature(b.cp.program, psig)
            est = memest.estimate(b.cp.plan, b.cp.program, senv)
            b.est_peak = int(est.peak_bytes)
            if b.est_peak > 0:
                b.lane_cap = self.memory_budget // b.est_peak
        except Exception:                  # noqa: BLE001 — advisory only
            return

    def _take_n(self, b: _Bucket) -> int:
        """Lanes one flush of this bucket may take: max_batch, tightened
        by the memory-derived lane cap."""
        n = self.max_batch
        if b.lane_cap is not None:
            n = min(n, max(b.lane_cap, 1))
        return n

    @staticmethod
    def _label(program, key, static, bag_pads, arr_pads) -> str:
        parts = [f"{n}:{L}" for n, L in bag_pads.items()]
        parts += [f"{n}:{L}" for n, L in sorted(arr_pads.items())]
        parts += [f"{n}={v}" for n, v in static.items()]
        h = hashlib.md5(repr(key).encode()).hexdigest()[:4]
        return f"{program}{{{' '.join(parts)}}}#{h}"

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    def _next_ready(self, now, force=False):
        """Deterministic flush order: full buckets first (insertion
        order), then timed-out stragglers, then — under drain — anything
        non-empty."""
        for key, b in self._buckets.items():
            if len(b.tickets) >= self.max_batch:
                return key
        for key, b in self._buckets.items():
            if b.tickets and now - b.tickets[0].t_submit >= self.flush_s:
                return key
        if force:
            for key, b in self._buckets.items():
                if b.tickets:
                    return key
        return None

    def pump(self) -> int:
        """One scheduling step: flush every ready bucket (full or
        timed-out against the injected clock).  Returns the number of
        requests completed.  Thread-safe; deterministic under a fake
        clock."""
        return self._pump(force=False)

    def drain(self) -> int:
        """Flush everything regardless of readiness until no request is
        queued.  Returns the number of requests completed."""
        return self._pump(force=True)

    def _pump(self, force: bool) -> int:
        done = 0
        with self._lock:
            while True:
                now = self._clock()
                self._shed_expired(now)
                key = self._next_ready(now, force=force)
                if key is None:
                    return done
                done += self._flush(self._buckets[key], force)

    def _shed_expired(self, now) -> None:
        """Deadline shedding, BEFORE pad/stack/flush: queued requests
        whose deadline passed fail with DeadlineExceeded and never cost a
        lane.  A staged prefetch whose ticket set changed is dropped."""
        for b in self._buckets.values():
            if not any(tk.deadline is not None and now >= tk.deadline
                       for tk in b.tickets):
                continue
            keep = deque()
            while b.tickets:
                tk = b.tickets.popleft()
                if tk.deadline is not None and now >= tk.deadline:
                    tk._resolve("failed", error=DeadlineExceeded(
                        f"request {tk.rid} shed after "
                        f"{(now - tk.t_submit) * 1e3:.1f}ms in queue"))
                    self.failed += 1
                    self.deadline_expired += 1
                else:
                    keep.append(tk)
            b.tickets = keep
            self._staged.pop(b.key, None)

    # ------------------------------------------------------------------
    # flush: stack → device_put → one batched call → unstack
    # ------------------------------------------------------------------

    def _round_lanes(self, B: int) -> int:
        if not self.batch_round:
            return B
        Bp = 1
        while Bp < B:
            Bp *= 2
        return min(Bp, self.max_batch)

    def _stack(self, b: _Bucket, take):
        """Host-side coalescing of one flush: pad each request's bags (and
        bag-aligned arrays) to the bucket shape, stack along a new lane
        axis, round the lane count up (dummy lanes replicate request 0 and
        are dropped after the call).  The stack is written straight into
        one host buffer (graphs.HostBatch: pinned when it goes to the card)
        whose `arrays` and `lengths` are numpy views, ready for one copy
        to the device."""
        Bp = self._round_lanes(len(take))
        if b.lane_cap is not None:
            # never let lane ROUNDING inflate a batch past the budget the
            # admission cap just enforced (dummy lanes cost real memory)
            Bp = max(len(take), min(Bp, b.lane_cap))
        lanes = list(take) + [take[0]] * (Bp - len(take))
        hb = HostBatch(self._spec(b, take[0], Bp), b.cp.program.outputs,
                       b.cp.device)
        arrays, lengths = hb.arrays, hb.lengths
        for name, t in b.cp.program.params.items():
            if t.kind == "dim":
                continue
            if t.kind == "bag":
                for ci, col in enumerate(arrays[name]):
                    for i, tk in enumerate(lanes):
                        _pad_into(col[i], tk.cin[name][ci])
                if name in b.bag_pads:
                    lengths[name][:] = [tk.cin[name][0].shape[0]
                                        for tk in lanes]
            elif name in b.arr_pads:
                for i, tk in enumerate(lanes):
                    _pad_into(arrays[name][i], tk.cin[name])
                lengths[name][:] = [tk.cin[name].shape[0] for tk in lanes]
            else:
                for i, tk in enumerate(lanes):
                    arrays[name][i] = tk.cin[name]
        # poisonable injection point: the stacked batch is mutable numpy
        # here, one lane per request — a rid-matched poison spec NaNs
        # exactly its request's lane (the nan guard must then isolate it)
        F.site("serve.stack", program=b.program,
               rids=[tk.rid for tk in lanes], arrays=arrays)
        return Bp, hb

    @staticmethod
    def _spec(b: _Bucket, first: PlanTicket, Bp: int) -> list:
        """The layout of one flush's stack: each non-dim param [Bp, ...]
        at the bucket's padded shape (a bag column by column), and the [Bp]
        row counts of each padded name."""
        spec = []
        for name, t in b.cp.program.params.items():
            v = first.cin[name]
            if t.kind == "dim":
                continue
            if t.kind == "bag":
                L = b.bag_pads.get(name, v[0].shape[0])
                spec += [((name, i), (Bp, L) + c.shape[1:],
                          torch_dtype(c.dtype)) for i, c in enumerate(v)]
                if name in b.bag_pads:
                    spec.append((("#rows", name), (Bp,), torch.int32))
            elif name in b.arr_pads:
                spec.append((name, (Bp, b.arr_pads[name]) + v.shape[1:],
                             torch_dtype(v.dtype)))
                spec.append((("#rows", name), (Bp,), torch.int32))
            else:
                spec.append((name, (Bp,) + v.shape, torch_dtype(v.dtype)))
        return spec

    def _device_put(self, hb: HostBatch):
        """The stacked batch to its device: on the card one copy from
        pinned memory, queued behind the work in flight
        (graphs.HostBatch.to_device)."""
        F.site("serve.device_put")
        return hb.to_device()

    def _stage(self, b: _Bucket):
        """Prefetch: stack the bucket's next flush and queue its
        host→device transfer now, while the in-flight computation still
        runs.  Consumed by _flush when the ticket set matches.  Purely an
        overlap optimization — a fault here just skips the prefetch; the
        flush restacks and meets the fault on its own dispatch path."""
        take = list(b.tickets)[:self._take_n(b)]
        if not take:
            return
        try:
            Bp, hb = self._stack(b, take)
            dev = self._device_put(hb)
        except Exception:                  # noqa: BLE001 — optimization only
            return
        self._staged[b.key] = (tuple(t.rid for t in take), Bp, dev)

    def _call_batch(self, b: _Bucket, take, Bp, arrays, lengths):
        """One batched call under the failure policy: transients retry
        at this level (batch intact); anything else raises to _dispatch,
        which bisects the batch.  The wall time feeds the straggler
        watchdog; a flagged straggling flush triggers speculative
        re-execution (DESIGN.md §13) — at most ONE backup copy per flush,
        first finisher wins, the loser is cancelled.  Both copies run the
        same cached batched entry on the same staged batch, so adopting
        the faster one never changes any lane's answer."""
        rids = tuple(tk.rid for tk in take)
        label = f"batch[{Bp}]"

        def call(buf=arrays):
            return b.cp.batched_call((b.key, Bp), b.static, buf, lengths,
                                     b.limit_bags, b.limit_arrays, b.salts)

        def attempt():
            F.site("serve.batched_call", program=b.program, rids=rids)
            return call()

        # batched_call donates the mutated destinations: each lane's outputs
        # overwrite its inputs in place — in the ENTRY's buffer, into which
        # every call first copies the staged batch.  The staged batch itself
        # is never written, so a backup copy re-reads the original inputs
        # from it (the reference reserves a spare of the donated operands,
        # which its first dispatch consumes)
        t0 = self._clock()
        out = F.run_with_retries(attempt, policy=self.policy,
                                 ledger=self.faults, label=label)
        dt = self._clock() - t0
        straggled = self.faults.note_time(label, dt)
        if straggled and self.speculative:
            self.speculated += 1
            t1 = self._clock()
            backup = call(arrays)
            #                       no injection site: the backup flush
            #                       dispatches to a healthy replica
            dt2 = self._clock() - t1
            if dt2 < dt:
                self.faults.spec_saved_s += dt - dt2
                self.faults.record(
                    "speculative", label,
                    f"backup flush won: {dt2 * 1e3:.1f}ms vs straggler "
                    f"{dt * 1e3:.1f}ms (saved {(dt - dt2) * 1e3:.1f}ms); "
                    f"straggler copy cancelled")
                out = backup
            else:
                self.faults.record(
                    "speculative", label,
                    f"original flush finished first ({dt * 1e3:.1f}ms); "
                    f"backup cancelled after {dt2 * 1e3:.1f}ms")
        return out

    def _flush(self, b: _Bucket, force: bool) -> int:
        if b.lane_cap == 0:
            return self._shed_oversize(b)
        n = min(self._take_n(b), len(b.tickets))
        if b.lane_cap is not None and len(b.tickets) > n:
            # memory-aware admission: the rest of the bucket WAITS for the
            # next flush instead of riding a batch projected past the
            # device budget and OOM-killing everyone mid-flight
            self.mem_deferred += len(b.tickets) - n
            self.faults.record(
                "defer", b.label,
                f"{len(b.tickets) - n} lanes held: lane_cap={b.lane_cap} "
                f"(peak≈{b.est_peak}B/lane, budget={self.memory_budget}B)")
        take = [b.tickets.popleft() for _ in range(n)]
        if not take:
            return 0
        return self._dispatch(b, take, force, staged_ok=True)

    def _shed_oversize(self, b: _Bucket) -> int:
        """A single lane of this bucket already exceeds the device budget:
        no batch composition can serve it, so every queued request sheds
        with a capacity-classified error (the caller's remedy is the
        out-of-core run() path, not a retry here)."""
        self._staged.pop(b.key, None)
        shed = 0
        while b.tickets:
            tk = b.tickets.popleft()
            tk._resolve("failed", error=RuntimeError(
                f"RESOURCE_EXHAUSTED: request {tk.rid} needs "
                f"≈{b.est_peak} bytes/lane, over the "
                f"{self.memory_budget}-byte serving budget; run it "
                f"out-of-core (memory_budget= on compile_program)"))
            self.failed += 1
            self.mem_shed += 1
            shed += 1
        if shed:
            self.faults.record("shed", b.label,
                               f"{shed} oversize requests: "
                               f"peak≈{b.est_peak}B/lane > "
                               f"budget={self.memory_budget}B")
        return shed

    def _dispatch(self, b: _Bucket, take, force, staged_ok) -> int:
        """Serve `take` as ONE batched call.  Success accounting happens
        ONLY here on the success path (failed flushes must not inflate
        served lanes/occupancy/latency — they get their own counters); a
        failed call descends to _resolve_failed_batch (bisection)."""
        trace0 = b.cp.trace_count
        try:
            staged = self._staged.pop(b.key, None) if staged_ok else None
            if staged is not None \
                    and staged[0] == tuple(t.rid for t in take):
                Bp, batch = staged[1], staged[2]
            else:
                Bp, hb = self._stack(b, take)
                batch = self._device_put(hb)
            out = self._call_batch(b, take, Bp, batch, None)
        except Exception as ex:            # noqa: BLE001 — ladder descent
            b.failed_flushes += 1
            self.failed_flushes += 1
            return self._resolve_failed_batch(b, take, force, ex)
        if b.cp.trace_count > trace0:
            b.traced += 1
        else:
            b.hits += 1
        # overlap: stack the NEXT ready bucket and queue its host→device
        # transfer while this (asynchronously dispatched) computation
        # runs; its outputs' copy to the host is waited for at the first
        # read below
        if self.prefetch:
            nk = self._next_ready(self._clock(), force=force)
            if nk is not None and nk not in self._staged:
                self._stage(self._buckets[nk])
        host = {n: np.asarray(v) for n, v in out.items()}
        b.flushes += 1
        b.lanes += Bp
        for tk in take:
            for bag, L in b.bag_pads.items():
                n = tk.cin[bag][0].shape[0]
                b.pad_rows += L - n
                b.bag_rows += L
        now = self._clock()
        self._t_last = now
        for i, tk in enumerate(take):
            res, finite = {}, True
            for n, v in host.items():
                lane = v[i]
                want = tuple(np.shape(tk.cin[n]))
                if lane.shape != want:
                    lane = lane[tuple(slice(0, s) for s in want)]
                res[n] = lane
                if self.nan_guard \
                        and np.issubdtype(lane.dtype, np.floating) \
                        and not np.all(np.isfinite(lane)):
                    finite = False
            if not finite:
                # per-lane poison isolation: only THIS request fails; its
                # batchmates' lanes are untouched and complete right here
                tk._resolve("failed", error=F.PoisonedOutput(
                    f"request {tk.rid}: non-finite values in output"))
                self.failed += 1
                self.poisoned += 1
                continue
            tk._resolve("done", output=res)
            b.reqs += 1
            b.real_lanes += 1
            self.completed += 1
            self._lat.append(now - tk.t_submit)
        return len(take)

    def _resolve_failed_batch(self, b: _Bucket, take, force, err) -> int:
        """A batched call failed after retries.  With one request there is
        nothing left to split: serve it through the sequential fallback
        (or fail it).  Otherwise BISECT: each half re-dispatches as its
        own batched call, so one poisoned request ends up failing alone in
        O(log B) extra calls while every other request still completes
        batched — never the all-sequential stampede."""
        if len(take) == 1 or not self.bisect:
            now = self._clock()
            self._t_last = now
            for tk in take:
                self._complete_fallback(tk, err, now)
            return len(take)
        self.bisections += 1
        mid = len(take) // 2
        done = self._dispatch(b, take[:mid], force, staged_ok=False)
        done += self._dispatch(b, take[mid:], force, staged_ok=False)
        return done

    def _complete_fallback(self, tk, err, now):
        """Batched trace failed: serve this request alone through the
        ordinary run() path (the guaranteed fallback), or fail it."""
        if not self.sequential_fallback:
            tk._resolve("failed", error=err)
            self.failed += 1
            return
        try:
            out = self._programs[tk.program].run(dict(tk.cin))
            tk._resolve("done",
                        output={n: _to_numpy(v) for n, v in out.items()})
            self.completed += 1
            self.seq_fallbacks += 1
            self._lat.append(now - tk.t_submit)
        except Exception as ex:            # noqa: BLE001
            tk._resolve("failed", error=ex)
            self.failed += 1

    # ------------------------------------------------------------------
    # blocking / threaded / async front ends
    # ------------------------------------------------------------------

    def start(self, poll_s: float = 2e-4):
        """Run pump() from a daemon thread (real-clock servers)."""
        if self._thread is not None:
            return
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                if self.pump() == 0:
                    time.sleep(poll_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="plan-server-pump")
        self._thread.start()

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    def run(self, program: str, inputs: dict, timeout: float = 60.0) -> dict:
        """Submit and wait.  With a pump thread this just blocks on the
        ticket; without one it pumps inline (real clock only)."""
        t = self.submit(program, inputs)
        if self._thread is not None:
            return t.result(timeout)
        deadline = time.monotonic() + timeout
        while not t.done():
            if self.pump() == 0:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"request {t.rid} still queued")
                time.sleep(1e-4)
        return t.result(0)

    async def arun(self, program: str, inputs: dict,
                   timeout: float = 60.0) -> dict:
        """Asyncio front end: submit, then await the ticket without
        blocking the event loop.  Requires a running pump thread."""
        import asyncio
        t = self.submit(program, inputs)
        return await asyncio.to_thread(t.result, timeout)

    # ------------------------------------------------------------------
    # observability (stats() is the data, explain_serving() the text)
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            queued = sum(len(b.tickets) for b in self._buckets.values())
            lanes = sum(b.lanes for b in self._buckets.values())
            real = sum(b.real_lanes for b in self._buckets.values())
            lat_ms = [x * 1e3 for x in self._lat]
            span = (self._t_last - self._t0) \
                if self._t0 is not None and self._t_last is not None else 0.0
            return {
                "admitted": self.admitted, "completed": self.completed,
                "cancelled": self.cancelled, "failed": self.failed,
                "queued": queued,
                "seq_fallbacks": self.seq_fallbacks,
                "load_shed": self.load_shed,
                "deadline_expired": self.deadline_expired,
                "failed_flushes": self.failed_flushes,
                "bisections": self.bisections,
                "poisoned": self.poisoned,
                "mem_deferred": self.mem_deferred,
                "mem_shed": self.mem_shed,
                "speculated": self.speculated,
                "spec_saved_ms": self.faults.spec_saved_s * 1e3,
                "retries": self.faults.counters["retry"],
                "flushes": sum(b.flushes for b in self._buckets.values()),
                "batch_traced": sum(b.traced
                                    for b in self._buckets.values()),
                "batch_hits": sum(b.hits for b in self._buckets.values()),
                "p50_ms": _pct(lat_ms, 0.50), "p99_ms": _pct(lat_ms, 0.99),
                "rps": self.completed / span if span > 0 else 0.0,
                "occupancy": 100.0 * real / lanes if lanes else 0.0,
                "buckets": {
                    b.label: {"depth": len(b.tickets), "reqs": b.reqs,
                              "flushes": b.flushes, "occ": b.occ(),
                              "pad": b.padf(), "traced": b.traced,
                              "hits": b.hits, "est_peak": b.est_peak,
                              "lane_cap": b.lane_cap}
                    for b in self._buckets.values()},
            }

    def explain_serving(self) -> str:
        """Golden-testable dump of the serving state, the way explain()
        pins the plan: one row per shape bucket, then the admission
        totals, the latency/throughput probes, and the batch-signature
        compile-cache line."""
        s = self.stats()
        out = [f"== serving plans: {len(self._programs)} programs, "
               f"max_batch={self.max_batch}, "
               f"flush={self.flush_s * 1e3:.1f}ms, "
               f"bucket_floor={self.bucket_floor} =="]
        for label, r in s["buckets"].items():
            out.append(f"bucket {label}: depth={r['depth']} "
                       f"reqs={r['reqs']} flushes={r['flushes']} "
                       f"occ={r['occ']:.0f}% pad={r['pad']:.0f}% "
                       f"traced={r['traced']} hits={r['hits']}")
        out.append(f"totals: admitted={s['admitted']} "
                   f"completed={s['completed']} "
                   f"cancelled={s['cancelled']} failed={s['failed']} "
                   f"queued={s['queued']}")
        out.append(f"latency: p50={s['p50_ms']:.1f}ms "
                   f"p99={s['p99_ms']:.1f}ms  "
                   f"throughput={s['rps']:.1f} req/s")
        out.append(f"whole-program cache: {s['batch_traced']} batch "
                   f"signatures traced, {s['batch_hits']} hits, "
                   f"{s['seq_fallbacks']} sequential fallbacks")
        out.append(f"robustness: load_shed={s['load_shed']} "
                   f"deadline_expired={s['deadline_expired']} "
                   f"failed_flushes={s['failed_flushes']} "
                   f"bisections={s['bisections']} "
                   f"poisoned={s['poisoned']} retries={s['retries']} "
                   f"speculated={s['speculated']}")
        if self.memory_budget is not None:
            from ..core.memest import fmt_bytes
            caps = "  ".join(
                f"{r['lane_cap'] if r['lane_cap'] is not None else '-'}"
                f"@{fmt_bytes(r['est_peak']) if r['est_peak'] else '?'}"
                for r in s["buckets"].values())
            out.append(f"memory: budget={fmt_bytes(self.memory_budget)} "
                       f"mem_deferred={s['mem_deferred']} "
                       f"mem_shed={s['mem_shed']}  "
                       f"lane_caps=[{caps}]")
        return "\n".join(out)

    def explain_faults(self) -> str:
        """The serving layer's failure ledger (retries, stragglers) —
        the per-program ladders live on each CompiledProgram."""
        return self.faults.explain()
