"""The mesh of the port: one process per shard, SPMD (counterpart of
``repro.launch.mesh.make_host_mesh`` and of ``jax.sharding.Mesh`` as the
JAX runtime uses it).

JAX's mesh is a set of devices inside one process, and ``shard_map`` runs
the per-shard program on each. Here each shard is a process (a rank of a
``torch.distributed`` process group) that runs the same program on its own
slice of the weights. A mesh has one axis (``init_mesh``, ``local_mesh``:
the recurrent stacks' ``model`` axis) or several named axes
(:func:`named_mesh`: ``("data", "model")``, ``("pod", "data", "model")``,
``("pod",)``), with the ranks laid out row-major over them as
``jax.make_mesh`` lays out devices: the last axis varies fastest. Each
axis of a multi-axis mesh is a one-axis sub-mesh (:meth:`Mesh.sub`): the
group of the ranks that share every other coordinate. The collectives are
per axis, each the JAX collective of the same name:

* :meth:`Mesh.all_gather` -- ``all_gather(..., tiled=True)``: the ranks'
  tensors concatenated along ``dim`` in axis order;
* :meth:`Mesh.psum` -- ``all_reduce(SUM)``;
* :meth:`Mesh.pmax` -- ``all_reduce(MAX)`` (the compressed gradient
  exchange agrees on its int8 scales with it);
* :meth:`Mesh.all_to_all` -- ``all_to_all(..., tiled=True)``;
* :meth:`Mesh.ppermute` -- ``ppermute``, over ``batch_isend_irecv``.

A one-rank mesh needs no process group (``group=None``): its collectives
are identities, as on JAX's one-device ``Mesh``. Given a group, even one
of size 1, the collectives go through it.

The caller picks the group's backend: ``nccl`` with one rank per device,
``gloo`` on the CPU or where ranks share a device (NCCL refuses two ranks
on one device). The port never switches backend by itself. Gloo takes
CUDA tensors for ``all_gather`` and ``all_reduce`` and moves them through
the host; ``all_to_all`` and the point-to-point sends of ``ppermute`` on a
gloo group are given host copies of CUDA tensors by the mesh itself (the
transport of those two over gloo, not a second path). Over gloo, a psum of
a 16-bit float tensor is summed in float32 and rounded once, and 16-bit
tensors are moved as their bytes.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh.

    ``group``: the ``torch.distributed`` process group of all its ranks
    (None: one rank, no group). ``size``: its number of ranks. ``rank``:
    this process's index in it. ``device``: this rank's device, stated by
    the caller (``cuda:<local rank>`` with one rank per card; every rank
    passes the same card where they share one). ``axis``: the axis name of
    a one-axis mesh (a multi-axis mesh's names joined by commas).
    ``subs``: a multi-axis mesh's one-axis sub-meshes, one per axis in
    order (empty for a one-axis mesh). Hashable: a placement on it is part
    of the executor's cache key."""
    group: Optional[object]
    size: int
    rank: int
    device: torch.device
    axis: str = AXIS
    subs: Tuple["Mesh", ...] = ()

    def __post_init__(self):
        if self.size < 1 or not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} of a mesh of {self.size}")
        if self.group is None and self.size != 1:
            raise ValueError(f"a mesh of {self.size} ranks needs a process "
                             f"group")
        if self.subs and math.prod(m.size for m in self.subs) != self.size:
            raise ValueError(f"axes {self.shape} do not make {self.size} "
                             f"ranks")
        object.__setattr__(self, "device", torch.device(self.device))

    # -- axes ------------------------------------------------------------

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(m.axis for m in self.subs) if self.subs else (self.axis,)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        if not self.subs:
            return {self.axis: self.size}
        return {m.axis: m.size for m in self.subs}

    def sub(self, name: str) -> "Mesh":
        """The one-axis mesh of axis ``name``: this rank and the ranks that
        share its every other coordinate, ``rank`` its coordinate."""
        if not self.subs:
            if name != self.axis:
                raise KeyError(f"no axis {name!r} in a mesh of "
                               f"{self.axis_names}")
            return self
        for m in self.subs:
            if m.axis == name:
                return m
        raise KeyError(f"no axis {name!r} in a mesh of {self.axis_names}")

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on axis ``name`` (``lax.axis_index``)."""
        return self.sub(name).rank

    def _on(self, axis: Optional[str]) -> "Mesh":
        if axis is not None:
            return self.sub(axis)
        if self.subs:
            raise ValueError(f"name the axis of a mesh of {self.axis_names}")
        return self

    # -- collectives (each over one axis; None on a one-axis mesh) -------

    def all_gather(self, t: torch.Tensor, dim: int,
                   axis: Optional[str] = None) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in axis order."""
        m = self._on(axis)
        if m.group is None:
            return t
        wire = _bits(t)
        parts = [torch.empty_like(wire) for _ in range(m.size)]
        dist.all_gather(parts, wire, group=m.group)
        return torch.cat([_unbits(x, t.dtype) for x in parts], dim=dim)

    def psum(self, t: torch.Tensor, axis: Optional[str] = None
             ) -> torch.Tensor:
        """The sum of every rank's ``t`` (a new tensor; ``t`` is kept)."""
        m = self._on(axis)
        if m.group is None:
            return t
        return m._all_reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor, axis: Optional[str] = None
             ) -> torch.Tensor:
        """The elementwise max of every rank's ``t`` (a new tensor)."""
        m = self._on(axis)
        if m.group is None:
            return t
        return m._all_reduce(t, dist.ReduceOp.MAX)

    def all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int,
                   axis: Optional[str] = None) -> torch.Tensor:
        """JAX's ``all_to_all(t, axis, split_dim, concat_dim, tiled=True)``:
        ``t`` is cut into ``size`` equal chunks along ``split_dim``, chunk
        j goes to the rank at coordinate j, and the chunks received are
        concatenated along ``concat_dim`` in the senders' order. On a gloo
        group a CUDA tensor travels as a host copy."""
        m = self._on(axis)
        n = t.shape[split_dim]
        if n % m.size:
            raise ValueError(f"dim {split_dim} of {tuple(t.shape)} does not "
                             f"split over {m.size} ranks")
        if m.group is None:
            return t
        host = _via_host(m.group, t)
        send = [_bits(c) for c in (t.to("cpu") if host else t).chunk(
            m.size, dim=split_dim)]
        # one flat buffer of equal parts: all_to_all_single is the exchange
        # every backend has (gloo has no list all_to_all in every release)
        flat = torch.cat([c.reshape(-1) for c in send])
        got = torch.empty_like(flat)
        dist.all_to_all_single(got, flat, group=m.group)
        out = torch.cat([_unbits(c.view(send[0].shape), t.dtype)
                         for c in got.chunk(m.size)], dim=concat_dim)
        return out.to(t.device) if host else out

    def ppermute(self, t: torch.Tensor, perm: Sequence[Tuple[int, int]],
                 axis: Optional[str] = None) -> torch.Tensor:
        """JAX's ``ppermute``: for each (src, dst) pair of axis
        coordinates, the rank at dst receives src's ``t``; a rank that
        receives nothing gets zeros. On a gloo group a CUDA tensor travels
        as a host copy."""
        m = self._on(axis)
        me = m.rank
        dsts = [d for s, d in perm if s == me]
        srcs = [s for s, d in perm if d == me]
        if len(srcs) > 1 or len(dsts) > 1:
            raise ValueError(f"perm {perm} is not a permutation")
        if m.group is None:
            return t.clone() if srcs else torch.zeros_like(t)
        host = _via_host(m.group, t)
        wire = _bits(t.to("cpu") if host else t)
        out = torch.zeros_like(wire)
        ops = []
        for d in dsts:
            if d == me:
                out.copy_(wire)
            else:
                ops.append(dist.P2POp(dist.isend, wire,
                                      dist.get_global_rank(m.group, d),
                                      m.group))
        for s in srcs:
            if s != me:
                ops.append(dist.P2POp(dist.irecv, out,
                                      dist.get_global_rank(m.group, s),
                                      m.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = _unbits(out, t.dtype)
        return out.to(t.device) if host else out

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        low = (t.dtype in (torch.bfloat16, torch.float16)
               and dist.get_backend(self.group) == "gloo")
        out = t.contiguous().to(torch.float32 if low else t.dtype,
                                copy=True)
        dist.all_reduce(out, op=op, group=self.group)
        return out.to(t.dtype) if low else out


def _via_host(group, t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


_BITS = (torch.bfloat16, torch.float16)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, a 16-bit float tensor as its bytes (uint8, the
    last dim doubled): data movement that no backend refuses (gloo takes
    no bfloat16 and no int16)."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype in _BITS else t


def _unbits(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(dtype) if dtype in _BITS else t


def local_mesh(device="cuda", axes: Optional[Sequence[str]] = None) -> Mesh:
    """A one-rank mesh without a process group (JAX's one-device mesh), on
    the card unless the caller asks for the CPU (``resolve_device``: it
    raises when there is no card). ``axes``: names of a multi-axis mesh,
    each of size 1 (default: the one ``model`` axis)."""
    dev = resolve_device(device)
    if axes is None:
        return Mesh(group=None, size=1, rank=0, device=dev)
    return Mesh(group=None, size=1, rank=0, device=dev, axis=",".join(axes),
                subs=tuple(Mesh(group=None, size=1, rank=0, device=dev,
                                axis=a) for a in axes))


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


def named_mesh(axes, device="cuda") -> Mesh:
    """This rank's multi-axis :class:`Mesh` over the default process group
    (``init_mesh`` or ``torch.distributed.init_process_group`` first):
    ``axes`` is an ordered mapping (or pairs) of axis name -> size whose
    product is the world size, ranks laid out row-major. Every rank makes
    one group per axis and per set of other coordinates, all ranks in the
    same order (``dist.new_group`` is collective), and keeps the groups it
    is in. The same world can hold several such meshes (``("data",)`` and
    then ``("data", "model")``). ``device``: this rank's device, on the
    card unless the caller asks for the CPU (``"cuda"`` is the current
    card: ``init_mesh`` sets it)."""
    axes = tuple(dict(axes).items())
    names = tuple(a for a, _ in axes)
    dims = tuple(int(n) for _, n in axes)
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(dims) != world:
        raise ValueError(f"axes {dict(axes)} do not make {world} ranks")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    coord = _coords(rank, dims)
    subs = []
    for i, name in enumerate(names):
        mine = None
        others = [range(d) for j, d in enumerate(dims) if j != i]
        for rest in itertools.product(*others):
            ranks = []
            for c in range(dims[i]):
                full = list(rest)
                full.insert(i, c)
                ranks.append(_flat(full, dims))
            g = dist.new_group(ranks=ranks)
            if rank in ranks:
                mine = Mesh(group=g, size=dims[i], rank=coord[i],
                            device=device, axis=name)
        subs.append(mine)
    return Mesh(group=dist.group.WORLD, size=world, rank=rank,
                device=device, axis=",".join(names), subs=tuple(subs))


def _coords(rank: int, dims) -> list:
    out = []
    for d in reversed(dims):
        out.append(rank % d)
        rank //= d
    return out[::-1]


def _flat(coord, dims) -> int:
    r = 0
    for c, d in zip(coord, dims):
        r = r * d + c
    return r

