"""The port's serving path (``repro_torch.serve.engine``, ``models.gru_lm``,
``launch.serve``) against the JAX ``ServeEngine`` on the CPU.

Same parameters (JAX ``init_params`` as numpy), same ragged feature
prompts, more requests than slots: the per-request class streams must be
equal, and the bucketed, masked prefill logits agree within
rtol=atol=1e-5 (fp32 across frameworks). Inside the port a masked
bucketed prefill matches the unpadded prompt within 1e-6 (only the batch
shape of the matmuls differs).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.distributed.sharding import ShardCtx
from repro.models import api as jax_api
from repro.models import gru_lm as jax_gru_lm
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_config
from repro_torch.core.params import init_params
from repro_torch.kernels.gru_sequence import kernel as K
from repro_torch.launch import serve as cli
from repro_torch.models import gru_lm
from repro_torch.serve.clock import ManualClock
from repro_torch.serve.engine import Request, ServeEngine, bucket_len

from _torch_parity import close, numpy_params, to_jax, to_torch

ARCHS = ("gru-jet", "gru-jet-deep")
SLOTS = 3


def _with_backend(cfg, backend):
    return cfg.replace(gru=dataclasses.replace(cfg.gru, backend=backend))


def _workload(seed=0, n=7):
    """Ragged prompts (1..12 vectors, two buckets), mixed budgets, two
    requests with streamed decode features."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        S = int(rng.integers(1, 13))
        prompt = rng.normal(size=(S, 5)).astype(np.float32)
        stream = (rng.normal(size=(6, 5)).astype(np.float32)
                  if i % 3 == 0 else None)
        out.append((prompt, int(rng.integers(2, 7)), stream))
    return out


@pytest.fixture(scope="module")
def params_np():
    return {a: numpy_params(jax_api.get_api(jax_get_config(a)).specs(
        jax_get_config(a)), seed=11) for a in ARCHS}


@pytest.fixture(scope="module")
def jax_streams(params_np):
    out = {}
    for arch in ARCHS:
        cfg = jax_get_config(arch)
        eng = JServeEngine(cfg, to_jax(params_np[arch]), ShardCtx(),
                           max_batch=SLOTS)
        reqs = [JRequest(prompt=p, max_new_tokens=n, stream=s)
                for p, n, s in _workload()]
        out[arch] = [r.out for r in eng.generate(reqs)]
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ("eager", "cuda"))
def test_class_streams_equal_jax_engine(arch, backend, params_np,
                                        jax_streams):
    cfg = _with_backend(get_config(arch), backend)
    K.reset_launch_counts()
    eng = ServeEngine(cfg, to_torch(params_np[arch]), max_batch=SLOTS,
                      device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=n, stream=s)
            for p, n, s in _workload()]
    done = eng.generate(reqs)
    assert [r.out for r in done] == jax_streams[arch]
    assert all(r.done for r in done)
    want = "cuda_fused" if backend == "cuda" else "eager"
    stats = eng.latency_stats()
    assert set(eng.prefill_backends) == {want}
    assert stats["decode_backend_steps"] == {want: stats["steps"]}
    assert stats["requests"] == len(reqs) and stats["prefills"] >= 2
    # on CPU tensors the wrappers ran their plain versions: nothing launched
    assert [k.launches for k in K.KERNELS] == [0, 0, 0]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ("eager", "cuda"))
def test_prefill_logits_match_jax(arch, backend, params_np):
    cfg = _with_backend(get_config(arch), backend)
    rng = np.random.default_rng(2)
    lens = (3, 8, 1, 6)
    Sb = bucket_len(max(lens))
    feats = np.zeros((len(lens), Sb, 5), np.float32)
    mask = np.zeros((len(lens), Sb), bool)
    for i, S in enumerate(lens):
        feats[i, Sb - S:] = rng.normal(size=(S, 5))
        mask[i, Sb - S:] = True
    jlog, jcache = jax_gru_lm.prefill(
        to_jax(params_np[arch]), jax_get_config(arch),
        {"features": jnp.asarray(feats), "mask": jnp.asarray(mask)})
    tlog, tcache = gru_lm.prefill(
        to_torch(params_np[arch]), cfg,
        {"features": torch.from_numpy(feats), "mask": torch.from_numpy(mask)})
    close(tlog, jlog)
    for a, b in zip(tcache["h"], jcache["h"]):
        close(a, b)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ("eager", "cuda"))
def test_masked_bucketed_prefill_matches_unpadded(arch, backend, params_np):
    cfg = _with_backend(get_config(arch), backend)
    params = gru_lm.prepare_params(to_torch(params_np[arch]), cfg, "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.normal(size=(S, 5)).astype(np.float32) for S in (3, 5, 1)]
    eng = ServeEngine(cfg, params, max_batch=4, device="cpu")
    feats, mask = eng._gru_prefill_batch(prompts, 8)
    blog, bcache = gru_lm.prefill(params, cfg, {
        "features": torch.from_numpy(feats), "mask": torch.from_numpy(mask)})
    for i, p in enumerate(prompts):
        ulog, ucache = gru_lm.prefill(params, cfg,
                                      {"features": torch.from_numpy(p[None])})
        close(blog[i], ulog[0], tol=1e-6)
        for hb, hu in zip(bcache["h"], ucache["h"]):
            close(hb[i], hu[0], tol=1e-6)
    # the fully masked slot keeps the zero state
    assert all(torch.count_nonzero(h[3]) == 0 for h in bcache["h"])


def test_engine_clock_and_stats():
    cfg = get_config("gru-jet")
    params = init_params(gru_lm.lm_specs(cfg), seed=1, device="cpu")
    clock = ManualClock()
    eng = ServeEngine(cfg, params, max_batch=2, clock=clock, device="cpu")
    assert np.isnan(eng.latency_stats()["p99_s"])         # empty: NaN
    done = eng.generate([Request(prompt=np.ones((4, 5), np.float32),
                                 max_new_tokens=3) for _ in range(3)])
    stats = eng.latency_stats()
    assert [len(r.out) for r in done] == [3, 3, 3]
    # 3 lanes of 3 steps on 2 slots: 6 steps, the first one not recorded
    assert stats["steps"] == 5 and stats["p99_s"] == 0.0
    assert stats["requests"] == 3 and stats["prefills"] == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_prefill_layout(arch):
    cfg = get_config(arch)
    cache = gru_lm.init_cache(cfg, 3, device="cpu")
    params = init_params(gru_lm.lm_specs(cfg), seed=2, device="cpu")
    _, filled = gru_lm.prefill(params, cfg,
                               {"features": torch.zeros(3, 4, 5)})
    assert [tuple(h.shape) for h in cache["h"]] == \
        [tuple(h.shape) for h in filled["h"]]
    assert all(torch.count_nonzero(h) == 0 for h in cache["h"])
    assert cache["pos"].dtype == torch.int32 and int(filled["pos"]) == 3
    # a decode step from the empty cache advances the position
    logits, nxt = gru_lm.decode_step(params, cfg, cache, torch.zeros(3, 5))
    assert logits.shape == (3, 5) and int(nxt["pos"]) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_main_on_cpu(arch, capsys):
    done = cli.main(["--arch", arch, "--requests", "5", "--slots", "2",
                     "--vary-prompt", "--max-new", "3", "--gru-backend",
                     "cuda", "--device", "cpu", "--seed", "4"])
    assert [len(r.out) for r in done] == [3] * 5
    out = capsys.readouterr().out
    assert "decode latency (cpu)" in out
    assert "executor: prefill=cuda_fused decode=cuda_fused" in out


@pytest.mark.parametrize("backend", ("eager", "cuda"))
def test_eos_ends_class_streams_like_jax(backend):
    """A lane retires when its class equals ``eos_id`` (JAX engine
    :628-629), not only at ``max_new_tokens``: gru-jet, 4 slots, 6
    requests of 12 new tokens, ``eos_id=4``; the streams equal JAX's, and
    ``t_admit`` times the queue wait."""
    jcfg = jax_get_config("gru-jet")
    p = numpy_params(jax_api.get_api(jcfg).specs(jcfg), seed=0)
    work = [(pr, s) for pr, _, s in _workload(seed=1, n=6)]
    jeng = JServeEngine(jcfg, to_jax(p), ShardCtx(), max_batch=4)
    want = [r.out for r in jeng.generate(
        [JRequest(prompt=pr, max_new_tokens=12, stream=s, eos_id=4)
         for pr, s in work])]
    class Ticking(ManualClock):         # every reading one second later
        def now(self):
            return self.advance(1.0)

    eng = ServeEngine(_with_backend(get_config("gru-jet"), backend),
                      to_torch(p), max_batch=4, clock=Ticking(),
                      device="cpu")
    reqs = [Request(prompt=pr, max_new_tokens=12, stream=s, eos_id=4)
            for pr, s in work]
    done = eng.generate(reqs)
    assert [r.out for r in done] == want
    assert [len(r.out) for r in done] == [2, 1, 12, 6, 12, 12]
    for r in done:       # 4 ends a stream, and only as its last class
        assert 4 not in r.out[:-1]
        assert r.out[-1] == 4 or len(r.out) == 12
        assert r.done and r.t_submit < r.t_admit < r.t_finish
    assert eng.queue_waits == [r.t_admit - r.t_submit for r in
                               sorted(done, key=lambda r: r.t_admit)]
    assert eng.latency_stats()["requests"] == 6
