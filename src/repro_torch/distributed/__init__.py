"""Meshes of processes for the port's sharded paths (counterpart of the
mesh parts of ``repro.launch.mesh`` and ``repro.distributed``)."""
from repro_torch.distributed.mesh import (Mesh, init_mesh, local_mesh,
                                          named_mesh)
from repro_torch.distributed.sharding import (NO_SHARD, PROFILES, ShardCtx,
                                              constrain, param_pspecs,
                                              param_shardings, resolve_pspec)

__all__ = ["Mesh", "ShardCtx", "NO_SHARD", "PROFILES", "init_mesh",
           "local_mesh", "named_mesh", "resolve_pspec", "param_pspecs",
           "param_shardings", "constrain"]
