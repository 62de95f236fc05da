"""Logical-axis -> mesh-axis sharding rules, with profiles (counterpart of
``repro.distributed.sharding``).

Params declare LOGICAL axes (``repro_torch.core.params.Spec``); activations
are named with logical tuples at block boundaries. This module resolves
both to partition specs for a concrete mesh, dropping mesh axes that do not
divide a dimension and using each mesh axis once, exactly as JAX's rules
do: :func:`resolve_pspec` returns a :class:`P` that compares equal, element
for element, with JAX's ``PartitionSpec``.

Profiles (the paper's design study, system-wide):

* ``default``   -- Megatron TP over "model" (+ FSDP params over "data"):
  column-parallel in-projections, row-parallel out-projections (psum).
* ``sp``        -- default + sequence parallelism: activations between
  blocks shard their sequence axis over "model".
* ``rowwise``   -- the PAPER's scheme applied to recurrent/decode matvecs:
  output rows (GRU "gates", recurrent "hidden") sharded over "model";
  aggregation is an all-gather of activations, never a psum of partials.
* ``cascade``   -- the paper's baseline: recurrent CONTRACTION dims
  sharded over "model" (partial sums -> psum), output rows replicated.

Where JAX hands a whole array and a ``NamedSharding`` to XLA, the port
hands each rank its block: :func:`param_shardings` cuts a tree to this
rank's blocks (what ``jax.device_put(x, NamedSharding)`` leaves on one
device), :func:`block` one tensor. Activations stay whole on every rank
outside the explicit collective regions (MoE's expert exchange, the
pipeline), so :func:`constrain` changes nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.params import _map_tree, is_spec
from repro_torch.distributed.mesh import Mesh

Rules = Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...]

_BASE: Rules = (
    # --- activations ---
    ("batch", ("pod", "data")),
    ("act_seq", ()),                 # () = explicitly replicated
    ("act_embed", ()),
    ("act_heads", ("model",)),
    ("act_kv_heads", ("model",)),
    ("act_mlp", ("model",)),
    ("act_experts", ("data",)),
    ("act_gates", ("model",)),       # row-parallel recurrent activations
    ("act_hidden", ()),
    # KV-cache capacity: picks up "model" when kv_heads cannot divide it
    # (GQA kv<16) -- flash-decode-style sequence sharding of the cache.
    ("act_kv_seq", ("model",)),
    # SP-attention fallback: shard the sequence over model when heads can't
    ("act_seq_tp", ("model",)),
    # --- params ---
    ("layers", ()),
    ("vocab", ("model",)),
    ("embed", ("data",)),            # FSDP/ZeRO-3 weight shard
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("head_dim", ()),
    ("mlp", ("model",)),
    ("experts", ("data",)),          # EP
    ("expert_mlp", ("model",)),
    # --- recurrent cells (paper) ---
    ("gates", ("model",)),           # U/W output rows -> the row-wise scheme
    ("hidden", ()),                  # contraction replicated (rowwise)
    ("rnn_in", ()),
    ("state", ()), ("conv", ()), ("dt", ()),
    ("frames", ()), ("patches", ()), ("vis_embed", ()),
    ("podwise", ("pod",)),           # per-pod local state (EF residuals)
)


def _with(rules: Rules, **over) -> Rules:
    d = dict(rules)
    for k, v in over.items():
        d[k] = v
    return tuple(d.items())


PROFILES: dict = {
    "default": _BASE,
    # sequence parallelism: inter-block activations shard seq over model
    "sp": _with(_BASE, act_seq=("model",)),
    # paper's row-wise scheme (it IS the default for recurrent axes)
    "rowwise": _BASE,
    # paper's baseline: contraction-parallel recurrence (cascade + psum)
    "cascade": _with(_BASE, gates=(), hidden=("model",),
                     act_gates=(), act_hidden=()),
}


class P(tuple):
    """A partition spec: one entry per leading dimension, each None
    (replicated), a mesh axis name, or a tuple of names (the first
    major); trailing Nones dropped. A tuple, so it compares equal element
    for element with JAX's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


@dataclass(frozen=True)
class ShardCtx:
    """Everything a model needs to place itself on a mesh.

    ``mesh``: this rank's :class:`~repro_torch.distributed.mesh.Mesh`, or
    None (one process, no sharding). ``profile``: a key of
    :data:`PROFILES`. ``manual`` lists mesh axes an enclosing per-rank
    program already consumed: the rules may only use the others."""
    mesh: Optional[Mesh] = None
    profile: str = "default"
    manual: Tuple[str, ...] = ()

    @property
    def rules(self) -> Rules:
        return PROFILES[self.profile]

    def axis_size(self, name: str) -> int:
        if self.mesh is None or name not in self.mesh.axis_names:
            return 1
        return self.mesh.shape[name]


NO_SHARD = ShardCtx()


def resolve_pspec(axes: Sequence[Optional[str]], shape: Sequence[int],
                  ctx: ShardCtx) -> P:
    """Logical axes tuple -> partition spec: for each dimension the mesh
    axes its rule names that are in the mesh, not used by an earlier
    dimension, not manual, and divide the dimension (with the axes kept
    before them)."""
    if ctx.mesh is None:
        return P()
    rules = dict(ctx.rules)
    names, sizes = ctx.mesh.axis_names, ctx.mesh.shape
    used: set = set()
    out = []
    for dim, name in zip(shape, axes):
        entry: Tuple[str, ...] = ()
        if name is not None:
            entry = tuple(rules.get(name, ()) or ())
        picked = []
        size = 1
        for ax in entry:
            if ax not in names or ax in used or ax in ctx.manual:
                continue
            if dim % (size * sizes[ax]) != 0:
                continue
            picked.append(ax)
            size *= sizes[ax]
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def param_pspecs(specs, ctx: ShardCtx):
    """Spec tree -> partition-spec tree."""
    return _map_tree(lambda _p, s: resolve_pspec(s.axes, s.shape, ctx)
                     if is_spec(s) else s, specs)


def entry_axes(entry) -> Tuple[str, ...]:
    """A partition-spec entry as a tuple of mesh axis names."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def block_index(mesh: Mesh, axes: Sequence[str],
                coords: Optional[dict] = None) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of a dimension split over
    the mesh axes ``axes``, the first major (JAX's layout of
    ``P(("pod", "data"))``). ``coords``: another rank's coordinates by
    axis name, in place of this rank's."""
    idx, n = 0, 1
    for ax in axes:
        c = mesh.axis_index(ax) if coords is None else coords[ax]
        idx = idx * mesh.shape[ax] + c
        n *= mesh.shape[ax]
    return idx, n


def block(x: torch.Tensor, pspec: Sequence, mesh: Mesh,
          coords: Optional[dict] = None) -> torch.Tensor:
    """This rank's block (or, with ``coords``, that rank's) of the whole
    tensor ``x`` under ``pspec``: a view."""
    for dim, entry in enumerate(pspec):
        axes = entry_axes(entry)
        if not axes:
            continue
        i, n = block_index(mesh, axes, coords)
        size = x.shape[dim] // n
        x = x.narrow(dim, i * size, size)
    return x


def param_shardings(specs, ctx: ShardCtx, params):
    """This rank's block of every leaf of ``params`` (the whole tree, the
    structure of ``specs``) by :func:`param_pspecs`: the port's
    ``jax.device_put(params, param_shardings(specs, ctx))``."""
    if ctx.mesh is None:
        raise ValueError("param_shardings needs a mesh")
    pspecs = param_pspecs(specs, ctx)
    return _map_tree(lambda path, x: x if x is None
                     else block(x, _at(pspecs, path), ctx.mesh), params)


def _at(tree, path):
    for k in path:
        tree = tree[k] if isinstance(tree, dict) else tree[int(k)]
    return tree


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]],
              ctx: ShardCtx) -> torch.Tensor:
    """``x`` unchanged. JAX's constraint (``with_sharding_constraint``)
    picks the layout XLA gives an activation, never its values; each rank
    of the port holds activations whole outside the explicit collective
    regions, so there is no layout to pick. Kept at JAX's points so the
    blocks read as JAX's do."""
    return x


def sharding_for(x_shape: Sequence[int], axes: Sequence[Optional[str]],
                 ctx: ShardCtx) -> P:
    """The partition spec of an activation of ``x_shape`` with logical
    ``axes`` (JAX's ``NamedSharding(ctx.mesh, resolve_pspec(...))``)."""
    if ctx.mesh is None:
        raise ValueError("sharding_for needs a mesh")
    return resolve_pspec(axes, x_shape, ctx)
