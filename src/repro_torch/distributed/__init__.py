"""Meshes of processes for the port's sharded backends (counterpart of the
mesh parts of ``repro.launch.mesh`` and ``repro.distributed``)."""
from repro_torch.distributed.mesh import Mesh, init_mesh, local_mesh
from repro_torch.distributed.sharding import NO_SHARD, ShardCtx

__all__ = ["Mesh", "ShardCtx", "NO_SHARD", "init_mesh", "local_mesh"]
