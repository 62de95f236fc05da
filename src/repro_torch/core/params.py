"""Parameter specs: declare-once shapes, materialized with torch.

Counterpart of ``repro.core.params`` (without the logical sharding axes,
which nothing in the port reads yet): a model declares its parameters as a
nested dict/tuple of :class:`Spec` leaves, and :func:`init_params` turns
that tree into tensors, seeded per path with a ``torch.Generator`` (the
numbers differ from ``jax.random``'s; tests that compare the two
frameworks carry the JAX tree over with :func:`params_from_numpy`).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

_DTYPES = {"float32": torch.float32, "int32": torch.int32}


@dataclass(frozen=True)
class Spec:
    """Declaration of one parameter tensor."""
    shape: Tuple[int, ...]
    init: str = "fan_in"        # fan_in | recurrent | zeros
    dtype: Optional[str] = None  # None -> model param_dtype


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def _path_seed(seed: int, path_s: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{path_s}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def _init_one(spec: Spec, seed: int, path_s: str, param_dtype: str,
              device: torch.device) -> torch.Tensor:
    dtype = _DTYPES[spec.dtype or param_dtype]
    shape = tuple(spec.shape)
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    # drawn on the CPU generator so a seed gives the same weights on every
    # device, then moved
    gen = torch.Generator().manual_seed(_path_seed(seed, path_s))
    noise = torch.randn(shape, generator=gen, dtype=torch.float32)
    if spec.init == "fan_in":
        std = 1.0 / np.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
    elif spec.init == "recurrent":
        std = 1.0 / np.sqrt(shape[-1])
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    return (std * noise).to(dtype=dtype, device=device)


def _map_tree(fn, tree, path=()):
    """Apply ``fn(path, leaf)`` over a nested dict/tuple/list tree."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def init_params(specs, seed: int = 0, param_dtype: str = "float32", *,
                device="cuda"):
    """Materialize a spec tree into tensors on ``device`` (deterministic per
    path: the same seed gives the same tensors on the CPU and the card)."""
    dev = resolve_device(device)
    return _map_tree(
        lambda path, s: _init_one(s, seed, "/".join(path), param_dtype, dev)
        if is_spec(s) else s, specs)


def params_from_numpy(tree, device="cuda"):
    """Carry a parameter (or cache) tree of numpy arrays into the port with
    the same layout: ``{"cell": ...}`` at depth 1, ``{"cells": (...)}``
    deeper, tuples stay tuples (a cache's per-layer ``h``). Leaves that are
    not arrays (ints, strings, None) pass through."""
    dev = resolve_device(device)

    def leaf(_path, x):
        if isinstance(x, (np.ndarray, np.generic)):
            return torch.from_numpy(np.array(x)).to(dev)
        return x
    return _map_tree(leaf, tree)
