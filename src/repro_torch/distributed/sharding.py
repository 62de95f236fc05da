"""What a model needs to place itself on a mesh (counterpart of
``repro.distributed.sharding.ShardCtx``). The JAX package's logical-axis
rules, ``constrain`` and ``axis_size`` (which only those rules read) wait
for the LM zoo: the recurrent stacks shard through the executor's
``Placement`` alone."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.distributed.mesh import Mesh


@dataclass(frozen=True)
class ShardCtx:
    """``mesh``: this rank's :class:`~repro_torch.distributed.mesh.Mesh`,
    or None (one process, no sharding)."""
    mesh: Optional[Mesh] = None


NO_SHARD = ShardCtx()
