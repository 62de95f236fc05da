"""Stacks too wide for a kernel's shared memory, under ``backend="cuda"``:
dispatch treats the shape as illegal for that kernel's backend, so the
stack falls through ``cuda_fused`` -> ``cuda_chain`` -> ``eager`` (the same
on the CPU and on the card) and serves, as JAX's Pallas backends serve it.

Each backend's ``fits`` comes from its wrappers' ``smem_bytes*`` at the
compiled batch's tile (``min(batch, 4)`` rows) against the 232,448 bytes a
Hopper block may use. Results are held against JAX's ``xla`` backend
within rtol=atol=1e-5 (fp32 across frameworks), and class streams equal
JAX's ``ServeEngine``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.distributed.sharding import ShardCtx
from repro.models import api as jax_api
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_config
from repro_torch.core import runtime
from repro_torch.kernels._launch import SMEM_LIMIT
from repro_torch.kernels.gru_sequence import kernel as K
from repro_torch.kernels.slstm_cell import kernel as SK
from repro_torch.models import api as mapi
from repro_torch.serve.engine import Request, ServeEngine

from _torch_parity import close, numpy_params, to_jax, to_torch

# (arch, GRUConfig changes, what serves prefill and decode under "cuda")
WIDE = [("gru-jet-deep", dict(hidden_dim=64), "cuda_chain"),
        ("gru-jet", dict(hidden_dim=256), "eager"),
        ("slstm-jet", dict(hidden_dim=128), "eager")]


def _cfgs(arch, change, port_backend="cuda"):
    jcfg = jax_get_config(arch)
    jcfg = jcfg.replace(gru=dataclasses.replace(jcfg.gru, backend="xla",
                                                **change))
    cfg = get_config(arch)
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru, backend=port_backend,
                                              **change))
    return cfg, jcfg


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(int(rng.integers(1, 12)), 5)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("arch,change,want", WIDE)
def test_wide_stack_serves_under_cuda_like_jax_xla(arch, change, want):
    cfg, jcfg = _cfgs(arch, change)
    p = numpy_params(jax_api.get_api(jcfg).specs(jcfg), seed=23)
    # the kernel the preference names does not take this stack
    dims = cfg.gru.resolved_layer_dims
    smem = SK.smem_bytes if arch.startswith("slstm") else K.smem_bytes
    assert smem(len(dims), dims[0], 4) > SMEM_LIMIT
    # bucketed, masked prefill logits and state
    rng = np.random.default_rng(2)
    lens, Sb = (3, 8, 1), 8
    feats = np.zeros((3, Sb, 5), np.float32)
    mask = np.zeros((3, Sb), bool)
    for i, S in enumerate(lens):
        feats[i, Sb - S:] = rng.normal(size=(S, 5))
        mask[i, Sb - S:] = True
    api, japi = mapi.get_api(cfg), jax_api.get_api(jcfg)
    tlog, tcache = api.prefill(to_torch(p), cfg, {
        "features": torch.from_numpy(feats), "mask": torch.from_numpy(mask)})
    jlog, jcache = japi.prefill(to_jax(p), jcfg, {
        "features": jnp.asarray(feats), "mask": jnp.asarray(mask)}, ShardCtx())
    close(tlog, jlog)
    for a, b in zip(tcache["h"], jcache["h"]):
        close(a, b)
    # served streams, more requests than slots
    prompts = _prompts(5, seed=4)
    jeng = JServeEngine(jcfg, to_jax(p), ShardCtx(), max_batch=3)
    jout = [r.out for r in jeng.generate(
        [JRequest(prompt=x, max_new_tokens=4) for x in prompts])]
    K.reset_launch_counts()
    eng = ServeEngine(cfg, to_torch(p), max_batch=3, device="cpu")
    out = [r.out for r in eng.generate(
        [Request(prompt=x, max_new_tokens=4) for x in prompts])]
    assert out == jout
    stats = eng.latency_stats()
    assert set(eng.prefill_backends) == {want}
    assert stats["decode_backend_steps"] == {want: stats["steps"]}


def test_exact_pin_on_a_wide_stack_falls_through_like_an_illegal_pin():
    cfg, _ = _cfgs("gru-jet-deep", dict(hidden_dim=64), "cuda_fused")
    exe = runtime.compile(cfg.gru, batch=8, seq=16, mask=True)
    assert (exe.sequence_backend, exe.decode_backend) == ("cuda_chain",) * 2
    # an exact pin on the eager backend stays there
    cfg, _ = _cfgs("gru-jet-deep", dict(hidden_dim=64), "eager")
    assert runtime.compile(cfg.gru, batch=8).decode_backend == "eager"
    # the q8 pin fits at this width (int8 rows): it keeps its backend
    cfg, _ = _cfgs("gru-jet-deep", dict(hidden_dim=64), "cuda_fused_q8")
    assert runtime.compile(cfg.gru, batch=8).decode_backend == "cuda_fused_q8"


@pytest.mark.parametrize("H,batch,fused", [
    (133, 8, True),       # the widest depth-1 stack at the 4-row tile
    (134, 8, False),
    (134, 1, True),       # a 1-row tile takes a few more units
    (138, 1, False)])
def test_fit_is_checked_at_the_compiled_batch_tile(H, batch, fused):
    cfg = get_config("gru-jet")
    g = dataclasses.replace(cfg.gru, hidden_dim=H, backend="cuda")
    exe = runtime.compile(g, batch=batch, seq=8, mask=True)
    assert exe.sequence_backend == ("cuda_fused" if fused else "eager")
    assert exe.decode_backend == exe.sequence_backend
    bt = min(batch, 4)
    assert (K.smem_bytes(1, H, bt) <= SMEM_LIMIT) == fused


def test_chain_checks_every_layer():
    """A heterogeneous stack goes to the chain; one layer too wide for the
    depth-1 kernel sends it to eager. The q8 chain's kernels (both take
    up to H=267 at the 4-row tile) are checked per layer too."""
    cfg = get_config("gru-jet-deep")
    ok = dataclasses.replace(cfg.gru, layer_dims=(32, 133, 20),
                             backend="cuda")
    exe = runtime.compile(ok, batch=8, seq=8, mask=True)
    assert (exe.sequence_backend, exe.decode_backend) == ("cuda_chain",) * 2
    wide = dataclasses.replace(ok, layer_dims=(32, 134, 20))
    exe = runtime.compile(wide, batch=8, seq=8, mask=True)
    assert (exe.sequence_backend, exe.decode_backend) == ("eager",) * 2
    q8 = dataclasses.replace(ok, layer_dims=(32, 267, 20),
                             backend="cuda_chain_q8")
    assert runtime.compile(q8, batch=8).decode_backend == "cuda_chain_q8"
    q8 = dataclasses.replace(q8, layer_dims=(32, 268, 20))
    exe = runtime.compile(q8, batch=8, seq=8, mask=True)
    assert (exe.sequence_backend, exe.decode_backend) == ("eager",) * 2
