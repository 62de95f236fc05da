"""Helpers shared by the ``test_torch_*`` parity tests: parameters made once
by the JAX package's ``init_params`` (with random, nonzero biases), carried
to both frameworks as numpy arrays; and :func:`run_ranks`, which runs a
script as the ranks of a CPU mesh."""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

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


SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def run_ranks(body: str, n: int, workdir, timeout: float = 240.0) -> None:
    """Run ``body`` (a python script) as ``n`` SPMD ranks, each in its own
    process: ``python -c body n rank store workdir``, where ``store`` is a
    file the ranks meet in (``repro_torch.distributed.init_mesh``; no
    port, so parallel test workers cannot collide). Each rank's output
    goes to ``workdir/rank<r>.log``. A rank that fails, or does not end
    within ``timeout`` seconds, fails the caller; every rank is stopped
    before this returns."""
    workdir = Path(workdir)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    store = workdir / f"store{n}"
    procs, logs = [], []
    try:
        for r in range(n):
            logs.append(open(workdir / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", body, str(n), str(r), str(store),
                 str(workdir)], stdout=logs[-1], stderr=subprocess.STDOUT,
                env=env))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (
            f"rank {r} of {n} exited {p.returncode}:\n"
            + (workdir / f"rank{r}.log").read_text()[-4000:])


# executor backend names, JAX package -> port ("pallas" and "cuda" are the
# kernel-family preferences)
NAME_MAP = {"xla": "eager", "pallas": "cuda", "pallas_fused": "cuda_fused",
            "pallas_chain": "cuda_chain", "pallas_fused_q8": "cuda_fused_q8",
            "pallas_chain_q8": "cuda_chain_q8",
            "pallas_sharded": "cuda_sharded", "sharded": "sharded",
            "sharded_decode": "sharded_decode", "auto": "auto"}


def port_rows(entries):
    """Calibration rows with JAX backend names renamed to the port's."""
    return [dict(e, backend=NAME_MAP.get(e["backend"], e["backend"]))
            for e in entries]


def hermetic_runtimes() -> None:
    """Empty cost models (static dispatch) and closed q8 gates in both
    packages' runtimes, so no calibration file in the working directory
    moves a choice under test."""
    from repro.core import runtime as jrt
    from repro_torch.core import runtime as rt
    for r in (jrt, rt):
        r.set_cost_model(r.CostModel({}, source="<tests: static>"))
        r.set_quant_accuracy(r.QuantAccuracy({}, source="<tests: closed>"))
