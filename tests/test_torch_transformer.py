"""The port's dense LM (``repro_torch.models.{layers,attention,transformer}``,
the LM wave of ``repro_torch.serve.engine`` and ``--arch qwen3-0.6b`` in
``repro_torch.launch.serve``) against the JAX package on the CPU.

Same parameters (JAX ``init_params`` as numpy, the norm scales perturbed
so their products are exercised), same tokens, fp32 compute
(``dtype="float32"``). Tolerances: the layers within rtol=atol=1e-6 (one
op chain each, different libm); the transformer's logits and KV cache
within 1e-4 (two layers of fp32 matmuls in a different summation order);
``slot_pos`` and ``pos`` equal; greedy token streams equal.

``attn_impl`` names differ between the packages; every test names both
sides: port ``cuda`` = JAX ``pallas`` (the kernels; here their plain
versions against the Pallas kernels in interpret mode), port ``chunked``
= JAX ``xla_flash``, ``naive`` = ``naive``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import get_smoke_config as jax_get_smoke_config
from repro.distributed.sharding import ShardCtx
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.params import init_params, params_from_numpy
from repro_torch.kernels.decode_attn import kernel as DK
from repro_torch.kernels.flash_attn import kernel as FK
from repro_torch.launch import serve as cli
from repro_torch.models import api as mapi
from repro_torch.models import layers, transformer
from repro_torch.serve.clock import ManualClock
from repro_torch.serve.engine import Request, ServeEngine

from _torch_parity import close, numpy_params, to_jax, to_torch

ARCH = "qwen3-0.6b"
IMPLS = (("cuda", "pallas"), ("chunked", "xla_flash"), ("naive", "naive"))
LOGIT_TOL = 1e-4


def _cfgs(port_impl, jax_impl):
    return (get_smoke_config(ARCH).replace(dtype="float32",
                                           attn_impl=port_impl),
            jax_get_smoke_config(ARCH).replace(dtype="float32",
                                               attn_impl=jax_impl))


def _perturb_scales(tree, rng):
    """Norm scales (init ones) -> 1 + 0.1 N(0, 1), so the scale multiply
    is tested."""
    if isinstance(tree, dict):
        return {k: (1.0 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
                if k in ("scale", "q_norm", "k_norm")
                else _perturb_scales(v, rng) for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def params_np():
    cfg = jax_get_smoke_config(ARCH)
    return _perturb_scales(numpy_params(jtransformer.lm_specs(cfg), seed=5),
                           np.random.default_rng(6))


def _tokens(lens, vocab, seed):
    """Left-padded (token 0) prompts of these lengths, as the engine pads."""
    rng = np.random.default_rng(seed)
    S = max(lens)
    toks = np.zeros((len(lens), S), np.int32)
    for i, n in enumerate(lens):
        toks[i, S - n:] = rng.integers(1, vocab, size=n)
    return toks


# --- layers -----------------------------------------------------------------

def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    for kind, p in (("rmsnorm", {"scale": scale}),
                    ("layernorm", {"scale": scale, "bias": bias})):
        close(layers.norm_apply(to_torch(p), torch.from_numpy(x), kind),
              jlayers.norm_apply(to_jax(p), jnp.asarray(x), kind), tol=1e-6)
    xh = rng.normal(size=(3, 5, 4, 16)).astype(np.float32)
    sh = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    close(layers.head_rmsnorm(torch.from_numpy(sh), torch.from_numpy(xh)),
          jlayers.head_rmsnorm(jnp.asarray(sh), jnp.asarray(xh)), tol=1e-6)
    mlp = {k: {"w": (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)}
           for k, s in (("wg", (64, 128)), ("wu", (64, 128)),
                        ("wd", (128, 64)), ("w1", (64, 128)),
                        ("w2", (128, 64)))}
    for kind in ("swiglu", "gelu"):
        close(layers.mlp_apply(to_torch(mlp), torch.from_numpy(x), kind),
              jlayers.mlp_apply(to_jax(mlp), jnp.asarray(x), kind), tol=1e-6)
    table = (0.02 * rng.normal(size=(256, 64))).astype(np.float32)
    toks = rng.integers(0, 256, size=(3, 5)).astype(np.int32)
    close(layers.embed_apply(torch.from_numpy(table), torch.from_numpy(toks),
                             torch.float32),
          jlayers.embed_apply(jnp.asarray(table), jnp.asarray(toks),
                              jnp.float32), tol=0)
    for tied, w in ((True, table), (False, table.T.copy())):
        got = layers.unembed_apply(torch.from_numpy(w), torch.from_numpy(x),
                                   tied)
        assert got.dtype == torch.float32
        close(got, jlayers.unembed_apply(jnp.asarray(w), jnp.asarray(x),
                                         tied), tol=1e-6)


@pytest.mark.parametrize("theta", (10_000.0, 1_000_000.0))
def test_rope_split_half_matches_jax(theta):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4097, size=(2, 7)).astype(np.int32)
    pos[0, 0] = 4096
    for shape in ((2, 7, 3, 128), (2, 7, 16)):
        x = rng.normal(size=shape).astype(np.float32)
        close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta),
              jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
              tol=1e-6)
    close(layers.rope_freqs(128, theta), jlayers.rope_freqs(128, theta),
          tol=1e-6)


# --- params ---------------------------------------------------------------

def test_params_from_numpy_carries_the_lm_tree(params_np):
    cfg = get_smoke_config(ARCH)
    tp = to_torch(params_np)
    assert set(tp) == {"embed", "blocks", "final_norm"}   # tied: no lm_head
    assert tuple(tp["embed"].shape) == (cfg.vocab_size, cfg.d_model)
    L, hd = cfg.num_layers, cfg.resolved_head_dim
    wq = tp["blocks"]["attn"]["wq"]["w"]
    assert tuple(wq.shape) == (L, cfg.d_model, cfg.num_heads * hd)
    assert tuple(tp["blocks"]["attn"]["q_norm"].shape) == (L, hd)
    np.testing.assert_array_equal(wq.numpy(),
                                  params_np["blocks"]["attn"]["wq"]["w"])
    # the port's own specs declare the same tree
    mine = init_params(transformer.lm_specs(cfg), seed=0, device="cpu")
    assert jax.tree.structure(mine) == jax.tree.structure(tp)
    assert [tuple(t.shape) for t in jax.tree.leaves(mine)] == \
        [tuple(t.shape) for t in jax.tree.leaves(tp)]
    # bfloat16 arrays arrive bit for bit
    b16 = np.asarray(jnp.asarray(params_np["embed"][:3], jnp.bfloat16))
    t16 = params_from_numpy({"e": b16}, device="cpu")["e"]
    assert t16.dtype == torch.bfloat16
    np.testing.assert_array_equal(t16.float().numpy(), b16.astype(np.float32))


def test_full_config_counts():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size) == (28, 1024, 151936)
    assert cfg.resolved_head_dim == 128 and cfg.attn_impl == "cuda"
    assert cfg.param_count() == jax_get_config(ARCH).param_count()
    assert 590e6 < cfg.param_count() < 600e6


# --- the transformer ------------------------------------------------------

@pytest.mark.parametrize("port_impl,jax_impl", IMPLS)
def test_prefill_and_decode_match_jax(port_impl, jax_impl, params_np):
    cfg, jcfg = _cfgs(port_impl, jax_impl)
    tp, jp = to_torch(params_np), to_jax(params_np)
    toks = _tokens((11, 5, 2), cfg.vocab_size, seed=3)
    close(transformer.forward(tp, cfg, torch.from_numpy(toks)),
          jtransformer.forward(jp, jcfg, jnp.asarray(toks)), LOGIT_TOL)
    tlog, tcache = transformer.prefill(tp, cfg, torch.from_numpy(toks))
    jlog, jcache = jtransformer.prefill(jp, jcfg, jnp.asarray(toks))
    close(tlog, jlog, LOGIT_TOL)
    for name in ("k", "v"):
        close(tcache["layers"][name], jcache["layers"][name], LOGIT_TOL)
    np.testing.assert_array_equal(tcache["layers"]["slot_pos"].numpy(),
                                  np.asarray(jcache["layers"]["slot_pos"]))
    assert int(tcache["pos"]) == int(jcache["pos"]) == toks.shape[1] - 1
    step_toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(8, 3)).astype(np.int32)
    for t in step_toks:
        tlog, tcache = transformer.decode_step(tp, cfg, tcache,
                                               torch.from_numpy(t))
        jlog, jcache = jtransformer.decode_step(jp, jcfg, jcache,
                                                jnp.asarray(t))
        close(tlog, jlog, LOGIT_TOL)
        np.testing.assert_array_equal(
            tcache["layers"]["slot_pos"].numpy(),
            np.asarray(jcache["layers"]["slot_pos"]))
        assert int(tcache["pos"]) == int(jcache["pos"])
    for name in ("k", "v"):
        close(tcache["layers"][name], jcache["layers"][name], LOGIT_TOL)


def test_decode_writes_the_cache_in_place(params_np):
    cfg, _ = _cfgs("cuda", "pallas")
    tp = to_torch(params_np)
    toks = _tokens((4, 4), cfg.vocab_size, seed=8)
    _, cache = transformer.prefill(tp, cfg, torch.from_numpy(toks),
                                   headroom=2)
    k = cache["layers"]["k"]
    ptr, C = k.data_ptr(), k.shape[3]
    tok = torch.tensor([1, 2])
    for step in range(4):       # C = 6: positions 4, 5 fill the headroom,
        _, cache = transformer.decode_step(tp, cfg, cache, tok)  # 6, 7 wrap
        assert cache["layers"]["k"].data_ptr() == ptr
        p = 4 + step
        assert int(cache["pos"]) == p
        assert (cache["layers"]["slot_pos"][:, p % C] == p).all()
    assert cache["layers"]["slot_pos"][0].tolist() == [6, 7, 2, 3, 4, 5]


def test_init_cache_matches_prefill_layout():
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    cache = transformer.init_cache(cfg, 2, 10, device="cpu")
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    assert tuple(cache["layers"]["k"].shape) == (L, 2, Hkv, 10, hd)
    assert (cache["layers"]["slot_pos"] == -1).all()
    assert int(cache["pos"]) == -1 and cache["pos"].dtype == torch.int32
    params = init_params(transformer.lm_specs(cfg), seed=1, device="cpu")
    logits, cache = transformer.decode_step(params, cfg, cache,
                                            torch.tensor([3, 4]))
    assert tuple(logits.shape) == (2, cfg.vocab_size)
    assert int(cache["pos"]) == 0
    assert cache["layers"]["slot_pos"][:, 0].tolist() == [0] * L


def test_prepare_params_casts_dense_weights_once():
    cfg = get_smoke_config(ARCH)                    # bfloat16 compute
    params = init_params(transformer.lm_specs(cfg), seed=1, device="cpu")
    prep = mapi.get_api(cfg).prepare_params(params, cfg, "cpu")
    assert prep["embed"].dtype == torch.bfloat16
    assert prep["blocks"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert prep["blocks"]["ln1"]["scale"].dtype == torch.float32
    assert prep["blocks"]["attn"]["q_norm"].dtype == torch.float32
    toks = torch.from_numpy(_tokens((6, 3), cfg.vocab_size, seed=2))
    a, _ = transformer.prefill(params, cfg, toks)
    b, _ = transformer.prefill(prep, cfg, toks)
    assert torch.equal(a, b)        # the same numbers as the per-call cast


@pytest.mark.parametrize("family", ("audio", "vlm"))
def test_audio_and_vlm_families_resolve(family):
    """``get_api`` gives the whisper and llava namespaces; the engine
    serves neither (JAX's ``generate`` raises for both too)."""
    from repro_torch.models import llava, whisper
    mod, arch = {"audio": (whisper, "whisper-large-v3"),
                 "vlm": (llava, "llava-next-mistral-7b")}[family]
    cfg = get_smoke_config(arch)
    api = mapi.get_api(cfg)
    assert api.specs is mod.lm_specs and api.prefill is mod.prefill
    assert mapi.get_api(get_smoke_config(ARCH).replace(
        family=family)).specs is mod.lm_specs
    eng = ServeEngine(cfg, init_params(api.specs(cfg), device="cpu"),
                      max_batch=2, clock=ManualClock(), device="cpu")
    with pytest.raises(NotImplementedError, match="model API directly"):
        eng.generate([Request(prompt=np.arange(1, 12, dtype=np.int32),
                              max_new_tokens=2)])


# --- the engine and the CLI ----------------------------------------------

PROMPT_LENS = (3, 7, 5, 11)


def _lm_requests(vocab, eos_id=-1):
    rng = np.random.default_rng(1)
    return [dict(prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                 max_new_tokens=8, eos_id=eos_id) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def jax_lm_streams(params_np):
    """JAX's streams without an eos, and with an eos taken from the middle
    of one of them (so it occurs)."""
    def serve(jax_impl, eos):
        jcfg = _cfgs("cuda", jax_impl)[1]
        eng = JServeEngine(jcfg, to_jax(params_np), ShardCtx(), max_batch=4)
        done = eng.generate([JRequest(**r) for r in
                             _lm_requests(jcfg.vocab_size, eos)])
        return [r.out for r in done]
    out = {(impl, -1): serve(impl, -1) for impl in ("pallas", "xla_flash")}
    eos = out[("pallas", -1)][1][3]
    out[("pallas", eos)] = serve("pallas", eos)
    return out, eos


@pytest.mark.parametrize("port_impl,jax_impl,with_eos", (
    ("cuda", "pallas", False), ("chunked", "xla_flash", False),
    ("cuda", "pallas", True)))
def test_engine_streams_equal_jax(port_impl, jax_impl, with_eos, params_np,
                                  jax_lm_streams):
    streams, eos_id = jax_lm_streams
    eos = eos_id if with_eos else -1
    cfg = _cfgs(port_impl, jax_impl)[0]
    FK.flash_attention.launches = DK.flash_decode.launches = 0
    eng = ServeEngine(cfg, to_torch(params_np), max_batch=4,
                      clock=ManualClock(), device="cpu")
    done = eng.generate([Request(**r) for r in
                         _lm_requests(cfg.vocab_size, eos)])
    want = streams[(jax_impl, eos)]
    assert [r.out for r in done] == want
    assert all(r.done for r in done)
    if eos != -1:
        # the eos occurs, and ends exactly the streams it occurs in
        assert any(eos in s for s in want)
        for s in want:
            assert (s.index(eos) == len(s) - 1) if eos in s else len(s) == 8
    stats = eng.latency_stats()
    assert stats["requests"] == 4 and stats["prefills"] == 1
    assert stats["served_dtype"] == "float32"
    assert stats["steps"] == max(len(s) for s in want) - 1
    # CPU tensors: the wrappers ran their plain versions, nothing launched
    assert FK.flash_attention.launches == DK.flash_decode.launches == 0


def test_engine_lm_wave_is_one_batch(params_np):
    cfg = _cfgs("cuda", "pallas")[0]
    eng = ServeEngine(cfg, to_torch(params_np), max_batch=2, device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        eng.generate([Request(prompt=np.array([1, 2], np.int32))] * 3)
    with pytest.raises(ValueError, match="cell families"):
        eng.gru_wave_begin([])


def test_cli_lm_smoke_on_cpu(capsys):
    done = cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--requests", "3", "--prompt-len", "6", "--max-new",
                     "4", "--seed", "2"])
    assert [len(r.out) for r in done] == [4, 4, 4]
    assert all(len(r.prompt) == 6 for r in done)
    out = capsys.readouterr().out
    assert "decode latency (cpu)" in out and "bfloat16" in out
    assert "attention: cuda (2 layers" in out


def test_cli_lm_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card guard cannot fire")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--arch", ARCH, "--smoke"])
