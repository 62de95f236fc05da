"""The port's q8 accuracy harness (``repro_torch.quant.accuracy``) against
the JAX package's on the CPU, and the port's q8 gate reading only the
port's artifact.

* the harness at the same small settings as JAX's (the same initial
  params, carried over): the same training stream and final loss within
  1e-4, JAX's artifact schema, and each q8 pin's logits within 1e-5 of
  JAX's q8 pin (``pallas_*_q8``, in interpret mode) on the same trained
  params; at depth 1 and at depth 3, H=32;
* the gate: a passing ``BENCH_quant_accuracy.json`` (the JAX package's
  file) or ``$REPRO_GRU_QUANT_ACC`` leaves the port's gate closed;
  ``BENCH_quant_accuracy_torch.json`` or ``$REPRO_TORCH_GRU_QUANT_ACC``
  opens it; the harness's own artifact opens it when it passed.

The module pins the port's gate closed around its tests and writes every
artifact under ``tmp_path``.
"""
import dataclasses
import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.core.params import init_params as jinit
from repro.models import gru_lm as jgru_lm
from repro.quant import accuracy as jacc
from repro_torch.configs.base import GRUConfig, ShapeConfig, get_config
from repro_torch.core import runtime
from repro_torch.core.params import params_from_numpy
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.quant import accuracy

from _torch_parity import NAME_MAP, SRC

LOSS_TOL = 1e-4
LOGIT_TOL = 1e-5
SMALL = dict(train_steps=30, train_batch=32, eval_batches=1, eval_batch=16,
             csv=False)


@pytest.fixture(scope="module", autouse=True)
def _closed_port_gate():
    closed = runtime.QuantAccuracy({}, source="<tests: closed>")
    runtime.set_quant_accuracy(closed)
    yield
    runtime.set_quant_accuracy(closed)


@pytest.fixture
def closed_gate():
    runtime.set_quant_accuracy(runtime.QuantAccuracy(
        {}, source="<tests: closed>"))
    yield
    runtime.set_quant_accuracy(runtime.QuantAccuracy(
        {}, source="<tests: closed>"))


def _jax_init(depth, hidden):
    mc = jget("gru-jet")
    g = mc.gru
    if depth:
        g = dataclasses.replace(g, num_layers=depth)
    if hidden:
        g = dataclasses.replace(g, hidden_dim=hidden)
    mc = mc.replace(gru=g)
    return mc, jax.tree.map(np.asarray, jinit(jgru_lm.lm_specs(mc),
                                              jax.random.key(0)))


def _start_from(monkeypatch, init):
    """The harness's initial params: JAX's (``init_params`` of the same
    specs), carried over, in place of the port's seeded draw."""
    monkeypatch.setattr(accuracy, "init_params", lambda specs, seed, device:
                        params_from_numpy(init, device=device))


@pytest.mark.parametrize("depth,hidden", [(None, None), (3, 32)])
def test_harness_matches_jaxs(tmp_path, monkeypatch, closed_gate, depth,
                              hidden):
    jmc, init = _jax_init(depth, hidden)
    _start_from(monkeypatch, init)
    kw = dict(arch="gru-jet", depth=depth, hidden=hidden, **SMALL)
    jout = jacc.run(**kw, json_path=str(tmp_path / "jax.json"))
    out, params = accuracy.run(**kw, json_path=str(tmp_path / "port.json"),
                               device="cpu", return_params=True)
    assert abs(out["final_loss"] - jout["final_loss"]) <= LOSS_TOL
    assert json.loads((tmp_path / "port.json").read_text()) == out
    assert set(out) == set(jout) and out["device"] == "cpu"
    for k in ("bench", "schema", "arch", "config", "train_steps", "bound",
              "tie_eps"):
        assert out[k] == jout[k], k
    assert set(out["backends"]) == {NAME_MAP[b] for b in jout["backends"]}
    for jb, m in jout["backends"].items():
        assert set(out["backends"][NAME_MAP[jb]]) == set(m)
    # each q8 pin against JAX's on the same trained params
    xs = SyntheticStream(get_config("gru-jet"), ShapeConfig(
        "quant_eval", jmc.gru.seq_len, 16, "prefill")).batch_at(
        10_000)["features"]
    jparams = jax.tree.map(lambda t: np.asarray(t.numpy()), params)
    for jb in jacc.Q8_BACKENDS:
        want = jacc._eval_logits(jax.tree.map(jax.numpy.asarray, jparams),
                                 dataclasses.replace(jmc.gru, backend=jb),
                                 jax.numpy.asarray(xs))
        gcfg = dataclasses.replace(get_config("gru-jet").gru,
                                   num_layers=jmc.gru.num_layers,
                                   hidden_dim=jmc.gru.hidden_dim,
                                   backend=NAME_MAP[jb])
        got = accuracy._eval_logits(params, gcfg, torch.from_numpy(xs))
        np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # the oracle against JAX's xla oracle, likewise
    want = jacc._eval_logits(jax.tree.map(jax.numpy.asarray, jparams),
                             dataclasses.replace(jmc.gru, backend="xla"),
                             jax.numpy.asarray(xs))
    got = accuracy._eval_logits(
        params, dataclasses.replace(get_config("gru-jet").gru,
                                    num_layers=jmc.gru.num_layers,
                                    hidden_dim=jmc.gru.hidden_dim),
        torch.from_numpy(xs))
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_trained_params_carry_no_graph_into_the_kernels(closed_gate):
    params, loss = accuracy._train(get_config("gru-jet"), 8, 3, 0.05,
                                   device="cpu")
    assert np.isfinite(loss)
    assert not any(p.requires_grad for p in jax.tree.leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    g = dataclasses.replace(get_config("gru-jet").gru,
                            backend="cuda_fused_q8")
    logits = accuracy._eval_logits(params, g, torch.zeros(2, 5, 5))
    assert logits.shape == (2, 5)


def _write(path, passed=True, bench="gru_quant_accuracy"):
    path.write_text(json.dumps({"bench": bench, "passed": passed,
                                "backends": {}}))
    return path


def test_the_jax_artifact_never_opens_the_ports_gate(tmp_path, monkeypatch,
                                                     closed_gate):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(runtime.QUANT_ACC_ENV, raising=False)
    jax_file = _write(tmp_path / "BENCH_quant_accuracy.json")
    monkeypatch.setenv("REPRO_GRU_QUANT_ACC", str(jax_file))
    runtime.set_quant_accuracy(None)          # re-arm the lazy default load
    assert not runtime.quant_gate_open()
    assert runtime.quant_accuracy().source == "BENCH_quant_accuracy_torch.json"
    cfg = GRUConfig(input_dim=5, hidden_dim=8, num_layers=2, backend="auto",
                    quant="int8")
    assert not runtime.compile(cfg, batch=2).decode_backend.endswith("_q8")
    # the port's own file opens it
    _write(tmp_path / "BENCH_quant_accuracy_torch.json")
    runtime.set_quant_accuracy(None)
    assert runtime.quant_gate_open()
    assert runtime.quant_accuracy().source == "BENCH_quant_accuracy_torch.json"
    # the port's env var wins over the file, and a failing artifact closes
    failing = _write(tmp_path / "failing.json", passed=False)
    monkeypatch.setenv(runtime.QUANT_ACC_ENV, str(failing))
    runtime.set_quant_accuracy(None)
    assert not runtime.quant_gate_open()
    monkeypatch.setenv(runtime.QUANT_ACC_ENV, str(
        _write(tmp_path / "other.json", bench="gru_decode_step_latency")))
    runtime.set_quant_accuracy(None)
    assert not runtime.quant_gate_open()


def test_the_harness_artifact_opens_the_gate(tmp_path, monkeypatch,
                                            closed_gate):
    _start_from(monkeypatch, _jax_init(None, None)[1])
    path = tmp_path / "BENCH_quant_accuracy_torch.json"
    out = accuracy.run(arch="gru-jet", **SMALL, json_path=str(path),
                       device="cpu")
    assert out["passed"]
    assert not runtime.quant_gate_open()
    assert runtime.load_quant_accuracy(path).passed
    assert runtime.quant_gate_open()
    cfg = dataclasses.replace(get_config("gru-jet").gru, quant="int8",
                              backend="cuda")
    legal = {s.name for s in runtime._REGISTRY.values()
             if runtime._legal(s, cfg, op="decode", masked=False, batch=8,
                               mesh=None)}
    assert {"cuda_fused_q8", "cuda_chain_q8"} <= legal


def test_cli_writes_the_ports_artifact(tmp_path):
    path = tmp_path / "art.json"
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"}
    p = subprocess.run([sys.executable, "-m", "repro_torch.quant.accuracy",
                        "--smoke", "--train-steps", "10", "--eval-batches",
                        "1", "--device", "cpu", "--json", str(path)],
                       capture_output=True, text=True, timeout=240, env=env,
                       cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    art = json.loads(path.read_text())
    assert art["bench"] == "gru_quant_accuracy"
    assert set(art["backends"]) == set(accuracy.Q8_BACKENDS)
    lines = p.stdout.splitlines()
    assert lines[-1].startswith(f"quant_acc_passed,{int(art['passed'])},")
    assert {ln.split(",")[0] for ln in lines[:-1]} == {
        f"quant_acc_{b}" for b in accuracy.Q8_BACKENDS}
