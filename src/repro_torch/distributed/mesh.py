"""The mesh of the port: one process per shard, SPMD (counterpart of
``repro.launch.mesh.make_host_mesh`` and of ``jax.sharding.Mesh`` as the
JAX runtime uses it).

JAX's mesh is a set of devices inside one process, and ``shard_map`` runs
the per-shard program on each. Here each shard is a process (a rank of a
``torch.distributed`` process group) that runs the same program on its own
slice of the weights; the collectives between them are the two below,
written once and used by every sharded step:

* :meth:`Mesh.all_gather` — JAX's ``all_gather(..., tiled=True)``: the
  ranks' tensors concatenated along ``dim`` in rank order;
* :meth:`Mesh.psum` — ``all_reduce(SUM)``;
* :meth:`Mesh.pmax` — ``all_reduce(MAX)`` (the compressed gradient
  exchange agrees on its int8 scales with it).

A one-rank mesh needs no process group (``group=None``): its collectives
are identities, as on JAX's one-device ``Mesh``. Given a group, even one
of size 1, the collectives go through it.

The caller picks the group's backend: ``nccl`` with one rank per device,
``gloo`` on the CPU or where ranks share a device (NCCL refuses two ranks
on one device). The port never switches backend by itself. Gloo takes
CUDA tensors for ``all_gather`` and ``all_reduce`` and moves them through
the host.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device

AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a one-axis mesh.

    ``group``: the ``torch.distributed`` process group (None: one rank, no
    group). ``size``: its number of ranks. ``rank``: this process's index
    on the axis. ``device``: this rank's device, stated by the caller
    (``cuda:<local rank>`` with one rank per card; every rank passes the
    same card where they share one). ``axis``: the axis name. Hashable:
    a placement on it is part of the executor's cache key."""
    group: Optional[object]
    size: int
    rank: int
    device: torch.device
    axis: str = AXIS

    def __post_init__(self):
        if self.size < 1 or not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} of a mesh of {self.size}")
        if self.group is None and self.size != 1:
            raise ValueError(f"a mesh of {self.size} ranks needs a process "
                             f"group")
        object.__setattr__(self, "device", torch.device(self.device))

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (a new tensor; ``t`` is kept)."""
        if self.group is None:
            return t
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of every rank's ``t`` (a new tensor)."""
        if self.group is None:
            return t
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        out = t.contiguous().clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out


def local_mesh(device="cuda") -> Mesh:
    """A one-rank mesh without a process group (JAX's one-device mesh), on
    the card unless the caller asks for the CPU (``resolve_device``: it
    raises when there is no card)."""
    return Mesh(group=None, size=1, rank=0, device=resolve_device(device))


def init_mesh(world_size: int, rank: int, *, init_file: str, device,
              backend: str, timeout_s: float = 60.0) -> Mesh:
    """Join a ``world_size``-rank process group of ``backend`` (``nccl``
    or ``gloo``, the caller's choice) that meets in ``init_file`` (a
    ``FileStore``: no port to pick, so concurrent groups cannot
    collide), and return this rank's :class:`Mesh` on ``device``. A
    collective that waits longer than ``timeout_s`` raises, so a lost rank
    fails its group instead of hanging it. Pair with
    ``torch.distributed.destroy_process_group()``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(str(init_file), world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(group=dist.group.WORLD, size=world_size, rank=rank,
                device=device)
