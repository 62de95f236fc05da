"""Pipeline parallelism over the ``pod`` axis: the GPipe microbatch schedule
(counterpart of ``repro.distributed.pipeline``).

Each rank of the axis is one stage and holds that stage's params. Stage s
processes microbatch m at tick t = s + m; after every tick each stage's
output hops to the next stage by ``ppermute`` (M + n - 1 ticks in all).
Every stage runs the same program with activity masking, as JAX's
``shard_map`` does; the last stage banks the finished microbatches and a
``psum`` replicates them on every rank.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.params import map_trees
from repro_torch.distributed.mesh import Mesh


def pipeline_apply(stage_fn: Callable, stage_params, xs: torch.Tensor, *,
                   mesh: Mesh, axis: str = "pod") -> torch.Tensor:
    """Run ``stage_fn(params_s, x)`` as an n-stage pipeline over ``axis``.

    ``stage_params``: THIS rank's stage params (JAX's block of the
    ``(n_stages, ...)`` tree: each leaf without the stage dim; cut a whole
    tree with ``map_trees(lambda a: a[mesh.axis_index(axis)], tree)``).
    ``xs``: (M, mb, d) microbatches, the same on every rank. Returns (M,
    mb, d) outputs, the same on every rank."""
    n = mesh.shape[axis]
    idx = mesh.axis_index(axis)
    M, mb, d = xs.shape
    hop = [(i, (i + 1) % n) for i in range(n)]
    act = torch.zeros((mb, d), dtype=xs.dtype, device=xs.device)
    outs = torch.zeros((M, mb, d), dtype=xs.dtype, device=xs.device)
    for t in range(M + n - 1):
        m = t - idx                                   # my microbatch id
        active = 0 <= m < M
        x_in = xs[min(max(m, 0), M - 1)] if idx == 0 else act
        y = stage_fn(stage_params, x_in)
        if not active:
            y = torch.zeros_like(y)
        if idx == n - 1 and active:                   # the last stage banks
            outs[m] = y
        act = mesh.ppermute(y, hop, axis)             # hop to the next stage
    # outputs live on the last stage only; replicate them
    return mesh.psum(outs if idx == n - 1 else torch.zeros_like(outs), axis)


def sequential_reference(stage_fn: Callable, stage_params, xs: torch.Tensor
                         ) -> torch.Tensor:
    """Oracle: every stage one after another on every microbatch
    (``stage_params`` the whole tree, stage dim first)."""
    leaves = []
    map_trees(leaves.append, stage_params)
    n = leaves[0].shape[0]
    out = []
    for x in xs:
        for s in range(n):
            x = stage_fn(map_trees(lambda a: a[s], stage_params), x)
        out.append(x)
    return torch.stack(out)
