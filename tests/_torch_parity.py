"""Helpers shared by the ``test_torch_*`` parity tests: parameters made once
by the JAX package's ``init_params`` (with random, nonzero biases), carried
to both frameworks as numpy arrays."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.params import init_params as jax_init_params
from repro_torch.core.params import params_from_numpy

TOL = 1e-5   # fp32 across frameworks: different summation orders and libm


def _with_biases(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.normal(scale=0.3, size=v.shape).astype(np.float32)
                    if k == "b" else _with_biases(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_with_biases(v, rng) for v in tree)
    return tree


def numpy_params(specs, seed: int = 0):
    """JAX ``init_params`` as numpy, biases replaced by seeded noise so the
    bias paths are exercised (the specs initialize them to zero)."""
    tree = jax.tree.map(np.asarray, jax_init_params(specs, jax.random.key(seed)))
    return _with_biases(tree, np.random.default_rng(seed + 1))


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return params_from_numpy(tree, device="cpu")


def close(actual, expected, tol: float = TOL) -> None:
    if isinstance(actual, torch.Tensor):
        actual = actual.detach().cpu().numpy()
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=tol, atol=tol)
