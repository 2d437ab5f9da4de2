"""Fault-tolerance runtime around the train loop and iterative plans: the
PyTorch port of the reference's src/repro/runtime/ft.py.

* periodic checkpoints + resume-from-latest: of the LM's parameters,
  optimizer state and data position (`TrainRunner`), and of a loop's
  carry (`LoopRunner`), through `checkpoint.CheckpointManager`, whose
  `.npz` format either package reads;
* **straggler watchdog**: per-step and per-iteration wall times feed a
  `FaultLedger.note_time` (the trailing-median watchdog the executor and
  the serving layer share), visible in `explain_faults()`;
* **peer-replicated carry snapshots** (DESIGN.md §13): an in-memory tier
  ABOVE the disk checkpoints — every `peer_every` iterations the loop
  carries are ring-copied to the neighbouring rank (`batch_isend_irecv`,
  core/collectives.py) and checksummed, so a lost rank restores its carry
  from the peer without touching disk; a torn replica fails its checksum
  and the previous good one is used instead (`PeerReplica`);
* simulated failure for tests (`SimulatedFailure`).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..core.faults import FaultLedger, checksum
from ..core.lower import _host


class SimulatedFailure(Exception):
    pass


class PeerReplica:
    """In-memory peer-replicated snapshot tier (DESIGN.md §13).

    Disk checkpoints survive a full-job restart but cost serialization and
    I/O a save; losing ONE rank should not need them.  This tier keeps the
    last `depth` carry snapshots in memory, each of this rank's arrays
    ring-copied to the next rank (one `batch_isend_irecv` shift over the
    mesh's group: rank k's values live on rank k+1, so rank k dying leaves
    every one of them on a survivor) and stamped with the shared crc32
    `core.faults.checksum`.  `latest_good()` shifts the newest snapshot
    back and verifies the stamp; a torn replica (a write interrupted by
    the very failure it protects against) fails its checksum and the
    PREVIOUS good snapshot is returned instead — the ranks agree on the
    verdict, so all of them return the same snapshot.  Without a mesh (one
    process) the "copy" is a host-side mirror: same protocol, same
    stamps, no collective."""

    def __init__(self, mesh=None, dp=("data",), depth: int = 2,
                 ledger: FaultLedger | None = None):
        self.mesh = mesh
        self.dp = tuple(dp)
        self.depth = int(depth)
        self.ledger = ledger
        self.snaps: list[dict] = []     # oldest → newest
        self.torn: list[int] = []       # steps whose replica failed verify
        self.dp_n = 1
        self._coll = None
        if mesh is not None:
            for a in self.dp:
                self.dp_n *= mesh.shape[a]
            if self.dp_n > 1:
                from ..core.collectives import Collectives
                self._coll = Collectives(mesh)

    # ------------------------- ring copy -------------------------
    def _ring(self, x, inverse: bool):
        """This rank's array one rank along the ring (back with
        `inverse`); without a group, a host mirror (a defensive copy)."""
        if self._coll is None:
            return np.array(_host(x))
        return self._coll.ring_shift(
            torch.as_tensor(x).to(self.mesh.device), inverse=inverse)

    # ------------------------- write / read -------------------------
    def mirror(self, li: int, it: int, step: int, carry: dict) -> None:
        snap = {"li": int(li), "it": int(it), "step": int(step),
                "data": {}, "crc": {}}
        for name, v in carry.items():
            snap["crc"][name] = checksum(_host(v))
            snap["data"][name] = self._ring(v, inverse=False)
        self.snaps.append(snap)
        del self.snaps[:-self.depth]

    def latest_good(self):
        """(li, it, step, carry) from the newest snapshot whose every
        array verifies against its stamp; torn snapshots are skipped to
        the previous good one.  None when nothing usable remains."""
        for snap in reversed(self.snaps):
            carry = {}
            ok = True
            for name, v in snap["data"].items():
                back = self._ring(v, inverse=True)
                if checksum(_host(back)) != snap["crc"][name]:
                    ok = False
                carry[name] = back
            if self._coll is not None:
                ok = not self._coll.agree(not ok)
            if ok:
                return snap["li"], snap["it"], snap["step"], carry
            self.torn.append(snap["step"])
            if self.ledger is not None:
                self.ledger.record(
                    "escalate", f"loop{snap['li']}",
                    f"peer replica at iteration {snap['it']} is torn "
                    f"(checksum mismatch) — previous good snapshot used")
        return None


def _nest(flat: dict, prefix: str = "") -> dict:
    """{"a/b": x} -> {"a": {"b": x}}, over the keys that start with
    `prefix` (which is dropped)."""
    tree: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *head, last = key[len(prefix):].split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


class TrainRunner:
    """The train loop's runner: periodic checkpoints (every `ckpt_every`
    steps, with the data pipeline's position), resume from the latest
    snapshot that verifies, the shared `FaultLedger` straggler watchdog,
    and simulated failure — the reference's, with its arguments (no
    `shardings`: every rank holds the whole model).

    Over a mesh (the step function's `mesh`, a data-parallel step of
    `train.make_train_step`), every rank runs its own runner on the same
    `ckpt_dir` with its own data (`host_index` = its rank): only rank 0
    writes snapshots (the replicas are bit-equal), `wait()` lets every
    rank go on only once rank 0's writes are whole, and `maybe_resume`
    restores the same snapshot on every rank (they agree on its step and
    then on their parameters' crc32s) and re-slices the data for the
    rank.  A snapshot holds the whole model whatever the world size, so it
    resumes on any number of ranks, one process without a mesh included.

    `step_fn(params, opt_state, batch) -> (params, opt_state, metrics)`.
    `params` and `opt_state` are saved as they stand and restored like
    their template, unless `params` gives its own snapshot layout:
    `params.to_tree(leaves=None)` and `params.load_tree(tree, into=None)`
    (the port's `LM`: the reference's stacked tree), with `opt_state`'s
    `to_tree(layout)` and `load_tree(tree, load)` (`AdamWState`: the
    reference's `.step`, `.mu/<leaf>`, `.nu/<leaf>`).  A resume then
    copies into the model and the moments in place, and a snapshot of
    either package resumes in the other."""

    def __init__(self, step_fn, params, opt_state, data, ckpt_dir: str,
                 ckpt_every: int = 10, straggler_factor: float = 3.0,
                 ledger: FaultLedger | None = None):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.data = data
        self.mgr = CheckpointManager(ckpt_dir)
        self.ckpt_every = ckpt_every
        self.mesh = getattr(step_fn, "mesh", None)
        self.step = 0
        # ONE straggler watchdog for the whole system: the shared
        # FaultLedger trailing-median idiom (same as core rounds and
        # served batches)
        self.faults = ledger if ledger is not None else \
            FaultLedger(name="train")
        self.faults.straggler_factor = straggler_factor
        self.straggler_events: list[int] = []   # flagged step indices

    def explain_faults(self) -> str:
        return self.faults.explain()

    def _trees(self):
        """(params tree, optimizer tree) in the snapshot's layout."""
        to_tree = getattr(self.params, "to_tree", None)
        if to_tree is None:
            return self.params, self.opt_state
        opt = None if self.opt_state is None else \
            self.opt_state.to_tree(to_tree)
        return to_tree(), opt

    def save(self):
        """Checkpoint the current step (the data position with it): rank
        0's part over a mesh."""
        if self.mesh is not None and self.mesh.rank != 0:
            return
        params, opt = self._trees()
        self.mgr.save(self.step, params, opt,
                      extra={"data": self.data.state()})

    def _restore(self, step: int):
        """(step, params, opt_state, extra) of one snapshot, every array
        read once and checked as it is loaded: both parts are read before
        a live tree is written, so a corrupt opt.npz leaves it as it was."""
        load_tree = getattr(self.params, "load_tree", None)
        if load_tree is None:
            return self.mgr.restore(step, self.params, self.opt_state)
        saved, flat, extra = self.mgr.restore_flat(step)
        oflat = None if self.opt_state is None else \
            self.mgr.restore_flat(step, part="opt")[1]
        load_tree(_nest(flat))
        if oflat is not None:
            self.opt_state.load_tree(_nest(oflat), load_tree)
        return saved, self.params, self.opt_state, extra

    def maybe_resume(self):
        """Restore the newest snapshot that verifies (a corrupt one is
        skipped for the next older, `mgr.skipped`); False when there is
        none."""
        found = self.mgr.resume(self._restore)
        if self.mesh is not None:
            self._agree(-1 if found is None else found[0])
        if found is None:
            return False
        self.step, self.params, self.opt_state, extra = found
        if self.mesh is not None and hasattr(self.params, "named_leaves"):
            from ..train.step import check_replicas
            check_replicas(self.mesh, dict(self.params.named_leaves()))
        if "data" in extra:
            self.data.restore(extra["data"],
                              host_index=self.data.host,
                              host_count=self.data.global_batch
                              // self.data.local_batch)
        return True

    def _agree(self, step: int):
        """Raise unless every rank resumes the snapshot of `step` (-1:
        none)."""
        from ..train.step import ReplicaDivergence
        every = self.mesh.coll.all_gather(torch.tensor(
            [step], dtype=torch.int64, device=self.mesh.device)).tolist()
        if len(set(every)) > 1:
            raise ReplicaDivergence(f"the ranks resume different snapshots "
                                    f"(steps by rank {every})")

    def wait(self):
        """Wait for the snapshots being written; over a mesh every rank
        waits for rank 0's (a barrier after its writes), so that no rank
        reads a snapshot before it is whole."""
        self.mgr.wait()
        if self.mesh is not None:
            self.mesh.coll.agree(False)     # a barrier: every rank joins

    def run(self, num_steps: int, fail_at_step: int | None = None):
        metrics = None
        while self.step < num_steps:
            if fail_at_step is not None and self.step == fail_at_step:
                raise SimulatedFailure(f"injected failure at {self.step}")
            batch = self.data.next_batch()
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            if self.faults.note_time("train.step",
                                     time.perf_counter() - t0):
                self.straggler_events.append(self.step)
            self.step += 1
            if self.step % self.ckpt_every == 0:
                self.save()
        self.wait()
        return metrics


class LoopRunner:
    """Mid-loop checkpoint/resume for ITERATIVE PLANS.

    Drives ``CompiledProgram.run_stepwise`` (host-driven loops) and
    snapshots every loop carry through CheckpointManager every ``every``
    iterations, keyed ``loop<i>/<carry-name>`` with the iteration count in
    the checkpoint metadata.  A plan killed at iteration k (crash, or an
    injected ``lower.loop_iter`` fault) restarts with ``resume=True``:
    nodes before the loop re-execute (pure + deterministic), the carry is
    restored from the latest snapshot, and the final outputs are
    BIT-IDENTICAL to an uninterrupted stepwise run — both execute the
    exact same per-iteration body computations on the same carry values
    (npz array round-trips are exact).  Per-iteration wall times feed the
    program's straggler watchdog (`explain_faults()`).

    Out-of-core runs ride the same machinery unchanged: a ChunkLoop is a
    top-level SeqLoop to run_stepwise, so its observer fires per CHUNK and
    a killed streamed run resumes from the last chunk checkpoint,
    fast-forwarding past completed tiles (on the card the carry includes
    each running partial of chunked.py).

    With ``peer_every`` > 0 the carries ADDITIONALLY mirror to the
    in-memory peer-replica tier (`PeerReplica`, ring copies over `mesh`'s
    group, or a host mirror without one) every ``peer_every`` iterations:
    resume prefers the newest GOOD peer snapshot over the disk tier when
    the peer is fresher (memory beats disk on recency AND latency; disk
    survives what memory cannot — a full-job restart still restores from
    npz).  Both tiers verify the shared crc32 stamp and skip torn
    snapshots to the previous good one."""

    def __init__(self, cp, ckpt_dir: str, every: int = 1, keep: int = 3,
                 async_write: bool = False, peer_every: int = 0,
                 mesh=None, dp=("data",)):
        self.cp = cp
        self.mgr = CheckpointManager(ckpt_dir, keep=keep,
                                     async_write=async_write)
        self.every = int(every)
        self.saves = 0
        self.resumed_from = None       # checkpoint step of the last resume
        self.peer_every = int(peer_every)
        self.peer = PeerReplica(mesh=mesh, dp=dp, ledger=cp.faults) \
            if peer_every else None
        self.peer_restores = 0
        self._step = 0
        self._t_last = 0.0

    def run(self, inputs: dict, resume: bool = True) -> dict:
        loop_state = None
        self.resumed_from = None
        if resume:
            found = self.mgr.resume(self.mgr.restore_flat)
            if found is not None:
                step, flat, extra = found
                loop_state = {}
                for li_s, it in (extra.get("loops") or {}).items():
                    li = int(li_s)
                    carry = {k.split("/", 1)[1]: v for k, v in flat.items()
                             if k.startswith(f"loop{li}/")}
                    loop_state[li] = (int(it), carry)
                self.resumed_from = step
                self._step = step
            good = self.peer.latest_good() if self.peer is not None \
                else None
            if good is not None:
                li, it, step, carry = good
                disk_it = loop_state.get(li, (-1, None))[0] \
                    if loop_state else -1
                if it > disk_it:
                    loop_state = loop_state or {}
                    loop_state[li] = (it, {c: _host(v)
                                           for c, v in carry.items()})
                    self.resumed_from = step
                    self._step = max(self._step, step)
                    self.peer_restores += 1
                    self.cp.faults.recovered(
                        f"loop{li}",
                        f"carry restored from peer replica (iteration "
                        f"{it}, ring copy verified against checksum; disk "
                        f"tier was at iteration {max(disk_it, 0)})")
        self._t_last = time.perf_counter()
        out = self.cp.run_stepwise(inputs, loop_state=loop_state,
                                   observer=self._observer)
        self.mgr.wait()
        return out

    def _observer(self, li, it, carry):
        self._step += 1
        now = time.perf_counter()
        self.cp.faults.note_time(f"loop{li}.iter", now - self._t_last)
        self._t_last = now
        if self.every and it % self.every == 0:
            self.mgr.save(self._step,
                          {f"loop{li}/{c}": v for c, v in carry.items()},
                          extra={"loops": {str(li): int(it)}})
            self.saves += 1
        if self.peer is not None and it % self.peer_every == 0:
            self.peer.mirror(li, it, self._step, dict(carry))
