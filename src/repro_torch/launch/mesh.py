"""The mesh a distributed program runs over: one process a rank.

The reference builds a jax Mesh of devices inside one process and runs
each round as a shard_map body over it.  PyTorch's collectives are
multi-controller instead: every rank is a process of one
torch.distributed group, calls the program with the same global inputs,
and holds its own row block (core/distributed.py).  A Mesh here wraps the
group the caller already initialized: its world size, this process's
rank, the data-parallel axes and the device the rank computes on.

    dist.init_process_group("gloo", init_method="file:///tmp/store",
                            rank=r, world_size=4)
    mesh = make_test_mesh((4,), ("data",), device="cpu")

The device is `cuda:(rank % device_count)` unless the caller names one.
A rank never goes on on the CPU because it found no card: asking for the
card without one raises.

Training over a mesh is pure data parallelism (`dp_world`): every rank one
replica, the batch cut over the data-parallel axes.  An axis outside them
larger than 1 (the reference's `model` axis, which its sharding
constraints use for tensor parallelism) raises.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: dict                  # axis name → size
    rank: int                    # this process's rank in the group
    device: torch.device         # where this rank computes
    backend: str                 # the group's backend ("nccl" or "gloo")
    group: object = None         # the process group (None: the default)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @functools.cached_property
    def coll(self):
        """The mesh's collectives for training (core/collectives.py): the
        gradient exchange and the MoE layers' count gathers count their
        calls and bytes in one place."""
        from ..core.collectives import Collectives
        return Collectives(self)


def rank_device(rank: int, device=None) -> torch.device:
    """The device of a rank: `device` when given, else the card
    `rank % device_count`.  Raises without a card."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the ranks on the CPU")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_test_mesh(shape=(1,), axes=("data",), device=None,
                   group=None) -> Mesh:
    """A mesh over the current process group (torch.distributed must be
    initialized), whose world size must equal the product of `shape`."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_test_mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    world = dist.get_world_size(group)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"group has {world}")
    rank = dist.get_rank(group)
    return Mesh(axes, dict(zip(axes, shape)), rank,
                rank_device(rank, device), dist.get_backend(group), group)


def axis_sizes(mesh) -> dict[str, int]:
    return dict(mesh.shape)


def dp_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def dp_world(mesh, dp_axes=("data",)) -> int:
    """The number of data-parallel replicas of a mesh over `dp_axes`: every
    rank of its group.  Raises where another axis is larger than 1: the
    port trains over a mesh by data parallelism alone."""
    wide = {a: n for a, n in mesh.shape.items()
            if a not in tuple(dp_axes) and n > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} outside the data-parallel axes "
            f"{tuple(dp_axes)}: tensor parallelism is not ported yet "
            "(ROADMAP.md, Queue 1, 'Tensor parallelism over the model "
            "axis'); give every other axis size 1")
    return mesh.size
