"""The port's package boundary: no file under ``src/repro_torch/`` imports
``jax`` or anything of ``repro`` (checked on the AST), importing the
serving engine pulls no jax into the process, and the entry points raise
instead of quietly running on the CPU when there is no card and the
caller did not ask for the CPU."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 15
    offenders = [(str(f.relative_to(SRC)), m) for f in files
                 for m in _imported_modules(f)
                 if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert offenders == []


def test_importing_the_engine_loads_no_jax():
    code = ("import sys; import repro_torch.serve.engine, "
            "repro_torch.launch.serve, repro_torch.kernels.gru_sequence.ops, "
            "repro_torch.models.transformer, "
            "repro_torch.kernels.flash_attn.ops, "
            "repro_torch.kernels.decode_attn.ops, "
            "repro_torch.distributed.pipeline, "
            "repro_torch.distributed.sharding, repro_torch.models.moe; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card guard cannot fire")


def test_entry_points_raise_without_a_card(no_card):
    from repro_torch import resolve_device
    from repro_torch.configs.base import get_config
    from repro_torch.core import runtime
    from repro_torch.core.params import init_params
    from repro_torch.launch import serve as cli
    from repro_torch.models import gru_lm
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("gru-jet")
    specs = gru_lm.lm_specs(cfg)
    params = init_params(specs, seed=0, device="cpu")
    q8 = cfg.replace(gru=dataclasses.replace(cfg.gru,
                                             backend="cuda_fused_q8"))
    for call in (lambda: resolve_device(),
                 lambda: init_params(specs),
                 lambda: runtime.prepare(params, cfg.gru),
                 lambda: gru_lm.prepare_params(params, cfg),
                 lambda: ServeEngine(cfg, params),
                 lambda: cli.main(["--arch", "gru-jet"]),
                 lambda: runtime.prepare(params, q8.gru),
                 lambda: ServeEngine(q8, params),
                 lambda: cli.main(["--arch", "gru-jet-deep", "--gru-backend",
                                   "cuda_fused_q8"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    # asked for explicitly, the CPU works
    eng = ServeEngine(cfg, params, device="cpu")
    assert eng.params["cells"][0]["u"].device.type == "cpu"
    assert eng.generate([]) == []
    np.testing.assert_array_equal(
        runtime.prepare(params, cfg.gru, device="cpu").stacked["u"][0],
        params["cell"]["u"])
