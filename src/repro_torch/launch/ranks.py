"""A group of rank processes on one machine: spawn P workers, one
torch.distributed rank each, and run functions on every rank.

    from repro_torch.launch.ranks import RankGroup
    with RankGroup(4) as g:              # one card a rank (or raises)
        outs = g.run(fn, *args)          # [fn(mesh, *args) on rank r]
    with RankGroup(4, device="cpu") as g:   # the CPU, over gloo
        ...

`fn` must be importable by the workers (a module-level function); it gets
the rank's Mesh (launch/mesh.py) first.  The group meets at a file store in
a temporary directory (no port is taken), every collective has the
group's timeout, and `run` waits for the ranks under a deadline: a rank
that fails or hangs fails the call (the group is then torn down and the
next call starts a new one), so a hung collective cannot stall the caller
for longer than the deadline.  `device` is where every rank computes:
None (the default) for the card `cuda:(rank % device_count)` — raising
at construction when there is no card, like every entry point of the
port that runs on the card unless asked for the CPU — or "cpu", or one
card that several ranks share ("cuda:0").  `backend` None picks NCCL when
each rank owns a card (device None and no more ranks than cards) and gloo
otherwise.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import traceback


def _worker(rank, world, store, backend, device, timeout_s, inq, outq):
    import torch
    import torch.distributed as dist

    from .mesh import make_test_mesh, rank_device
    torch.set_num_threads(1)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    mesh = make_test_mesh((world,), ("data",), device=device)
    try:
        while True:
            job = inq.get()
            if job is None:
                break
            fn, args, kwargs = job
            try:
                outq.put((rank, True, fn(mesh, *args, **kwargs)))
            except Exception:                # noqa: BLE001 — report it
                outq.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():    # a divergence tears the group down
            dist.destroy_process_group()


class RankFailure(RuntimeError):
    pass


class RankGroup:
    def __init__(self, world: int, *, backend: str | None = None,
                 device=None, timeout_s: float = 60.0,
                 deadline_s: float = 240.0):
        import torch
        self.world = int(world)
        if device is None and not torch.cuda.is_available():
            raise RuntimeError(
                f"RankGroup({self.world}): no CUDA device is available for "
                "one card a rank; pass device='cpu' to run the ranks on the "
                "CPU")
        if backend is None:
            own_card = device is None \
                and self.world <= torch.cuda.device_count()
            backend = "nccl" if own_card else "gloo"
        self.backend = backend
        self.device = device
        self.timeout_s = float(timeout_s)
        self.deadline_s = float(deadline_s)
        self._procs = None

    def _start(self):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="ranks-")
        store = os.path.join(self._dir, "store")
        self._outq = ctx.Queue()
        self._inqs = [ctx.Queue() for _ in range(self.world)]
        self._procs = [ctx.Process(target=_worker, daemon=True, args=(
            r, self.world, store, self.backend, self.device, self.timeout_s,
            self._inqs[r], self._outq)) for r in range(self.world)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, deadline_s=None, **kwargs) -> list:
        """fn(mesh, *args, **kwargs) on every rank; the results in rank
        order.  Raises RankFailure when a rank raised, died or missed the
        deadline."""
        if self._procs is None:
            self._start()
        for q in self._inqs:
            q.put((fn, args, kwargs))
        out = [None] * self.world
        left = set(range(self.world))
        errors = []
        import time
        end = time.monotonic() + (deadline_s or self.deadline_s)
        while left:
            try:
                rank, ok, res = self._outq.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in left if not self._procs[r].is_alive()]
                if dead or time.monotonic() > end:
                    self.close(force=True)
                    why = (f"ranks {dead} died" if dead else
                           f"ranks {sorted(left)} missed the "
                           f"{deadline_s or self.deadline_s:.0f} s deadline")
                    raise RankFailure(why + "".join(errors)) from None
                continue
            left.discard(rank)
            if ok:
                out[rank] = res
            else:
                errors.append(f"\n--- rank {rank} ---\n{res}")
        if errors:
            # a rank that raised may have left the others' collectives out
            # of step: start the next call on a new group
            self.close(force=True)
            raise RankFailure("".join(errors))
        return out

    def close(self, force: bool = False):
        if self._procs is None:
            return
        started = [p for p in self._procs if p.pid is not None]
        if not force:
            for q in self._inqs:
                q.put(None)
            for p in started:
                p.join(timeout=30)
        for p in started:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self._procs = None
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
