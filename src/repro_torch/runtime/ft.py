"""Fault-tolerance runtime around iterative plans: the PyTorch port of the
reference's src/repro/runtime/ft.py.

* periodic checkpoints of a loop's carry + resume-from-latest
  (`LoopRunner`, through `checkpoint.CheckpointManager`, whose `.npz`
  format either package reads);
* **straggler watchdog**: per-iteration wall times feed the program's
  `FaultLedger.note_time` (the trailing-median watchdog the executor and
  the serving layer share), visible in `explain_faults()`;
* simulated failure for tests (`SimulatedFailure`).

Still to come (ROADMAP.md): the peer-replica carry tier (`peer_every`),
which ring-copies carries across shards, waits for the distributed rounds
(Queue 1 item 5); `TrainRunner` waits for the training step (item 6).
"""
from __future__ import annotations

import time

from ..checkpoint import CheckpointManager


class SimulatedFailure(Exception):
    pass


class TrainRunner:
    """The training loop's runner: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TrainRunner waits for the training step of the LM stack "
            "(ROADMAP.md, Queue 1 item 6, 'The training step')")


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

    ``peer_every`` > 0 (the reference's in-memory peer-replica tier)
    raises NotImplementedError: it waits for the distributed rounds."""

    def __init__(self, cp, ckpt_dir: str, every: int = 1, keep: int = 3,
                 async_write: bool = False, peer_every: int = 0):
        if peer_every:
            raise NotImplementedError(
                "the peer-replica carry tier (peer_every > 0) needs "
                "ring copies across shards: ROADMAP.md, Queue 1 item 5, "
                "'Distributed rounds, skew and surgical recovery'")
        self.cp = cp
        self.mgr = CheckpointManager(ckpt_dir, keep=keep,
                                     async_write=async_write)
        self.every = int(every)
        self.saves = 0
        self.resumed_from = None       # checkpoint step of the last resume
        self._step = 0
        self._t_last = 0.0

    def run(self, inputs: dict, resume: bool = True) -> dict:
        loop_state = None
        self.resumed_from = None
        if resume:
            latest = self.mgr.latest()
            if latest is not None:
                step, flat, extra = self.mgr.restore_flat(latest)
                loop_state = {}
                for li_s, it in (extra.get("loops") or {}).items():
                    li = int(li_s)
                    carry = {k.split("/", 1)[1]: v for k, v in flat.items()
                             if k.startswith(f"loop{li}/")}
                    loop_state[li] = (int(it), carry)
                self.resumed_from = step
                self._step = step
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
