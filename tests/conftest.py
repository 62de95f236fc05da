"""Shared test fixtures. NOTE: no XLA_FLAGS here — single-process tests see
1 device; multi-device tests run their bodies in a subprocess (see
``run_multidev``)."""
import os
import subprocess
import sys
import textwrap

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (inside a fixture) "
                   "where there is none")


def run_multidev(body: str, n_devices: int = 4, timeout: int = 420) -> str:
    """Run ``body`` in a fresh python with n host devices; returns stdout.
    The body must print 'PASS' on success."""
    script = ("import os\n"
              f"os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count={n_devices}'\n"
              + textwrap.dedent(body))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=timeout, env=env)
    assert proc.returncode == 0, f"stderr:\n{proc.stderr[-4000:]}"
    assert "PASS" in proc.stdout, f"stdout:\n{proc.stdout[-2000:]}\nstderr:\n{proc.stderr[-2000:]}"
    return proc.stdout


@pytest.fixture(scope="session")
def multidev():
    return run_multidev


@pytest.fixture(scope="session", autouse=True)
def _hermetic_gru_costs():
    """Pin the GRU executor to the STATIC cost table for the whole suite:
    a stray BENCH_backend_costs.json in the cwd (e.g. from a local
    benchmark run) must not flip backend choices under test. Tests that
    exercise calibration install their own model via set_cost_model."""
    from repro.core import runtime
    runtime.set_cost_model(runtime.CostModel({}, source="<tests: static>"))
    yield


@pytest.fixture(scope="session", autouse=True)
def _hermetic_quant_gate():
    """Pin the q8 accuracy gate CLOSED for the whole suite: a stray
    BENCH_quant_accuracy.json in the cwd (e.g. from a local harness run)
    must not make the q8 backends auto-eligible under test. Exact-name
    pins bypass the gate, so the q8 parity tests are unaffected; gating
    tests install their own report via set_quant_accuracy."""
    from repro.core import runtime
    runtime.set_quant_accuracy(runtime.QuantAccuracy(
        {}, source="<tests: closed>"))
    yield
