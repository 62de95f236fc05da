"""The transformer configs beyond qwen3-0.6b against the JAX package on the
CPU: the MoE family (qwen2-moe-a2.7b, qwen3-moe-235b-a22b) and the dense
qwen2.5-3b, phi4-mini-3.8b and command-r-35b (layernorm, a parallel
attention || MLP block), each at its SMOKE size in fp32, through the port's
``chunked`` attention and JAX's ``xla_flash``.

Same parameters (JAX ``init_params`` as numpy, norm scales perturbed),
same tokens. Tolerances: logits, ``loss_fn``'s ``ce`` and ``aux`` within
1e-5 (two layers of fp32 matmuls in other summation orders); greedy token
streams equal; ``prepare_params``' logits ``torch.equal`` to the per-call
casts' (bf16, inside the port). Full-size configs are only counted
(``param_count``, ``active_param_count``), never built.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import get_smoke_config as jax_get_smoke_config
from repro.distributed.sharding import ShardCtx
from repro.models import transformer as jtransformer
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.core.params import flatten, init_params, param_count
from repro_torch.models import api as mapi
from repro_torch.models import moe, transformer
from repro_torch.serve.clock import ManualClock
from repro_torch.serve.engine import Request, ServeEngine

from _torch_parity import close, numpy_params, to_jax, to_torch

MOE = ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b")
DENSE = ("qwen2.5-3b", "phi4-mini-3.8b", "command-r-35b")
ARCHS = MOE + DENSE
TOL = 1e-5


def _cfgs(arch, **kw):
    return (get_smoke_config(arch).replace(dtype="float32",
                                           attn_impl="chunked", **kw),
            jax_get_smoke_config(arch).replace(dtype="float32",
                                               attn_impl="xla_flash", **kw))


def _perturb_scales(tree, rng):
    """Norm scales (init ones) -> 1 + 0.1 N(0, 1), layernorm biases (init
    zeros) -> 0.1 N(0, 1), so both are exercised."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("scale", "q_norm", "k_norm"):
                out[k] = (1.0 + 0.1 * rng.normal(size=v.shape)).astype(
                    np.float32)
            elif k == "bias":
                out[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
            else:
                out[k] = _perturb_scales(v, rng)
        return out
    return tree


def _params_np(jcfg, seed=5):
    return _perturb_scales(numpy_params(jtransformer.lm_specs(jcfg), seed),
                           np.random.default_rng(seed + 1))


def _tokens(lens, vocab, seed):
    """Left-padded (token 0) prompts of these lengths, as the engine pads."""
    rng = np.random.default_rng(seed)
    S = max(lens)
    toks = np.zeros((len(lens), S), np.int32)
    for i, n in enumerate(lens):
        toks[i, S - n:] = rng.integers(1, vocab, size=n)
    return toks


def _run_both(cfg, jcfg, params_np, steps=8):
    """forward, prefill, ``steps`` decode steps and the loss on both sides,
    each compared as it comes."""
    tp, jp = to_torch(params_np), to_jax(params_np)
    toks = _tokens((11, 5, 2), cfg.vocab_size, seed=3)
    close(transformer.forward(tp, cfg, torch.from_numpy(toks)),
          jtransformer.forward(jp, jcfg, jnp.asarray(toks)), TOL)
    tlog, tcache = transformer.prefill(tp, cfg, torch.from_numpy(toks))
    jlog, jcache = jtransformer.prefill(jp, jcfg, jnp.asarray(toks))
    close(tlog, jlog, TOL)
    for name in ("k", "v"):
        close(tcache["layers"][name], jcache["layers"][name], TOL)
    step_toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(steps, 3)).astype(np.int32)
    for t in step_toks:
        tlog, tcache = transformer.decode_step(tp, cfg, tcache,
                                               torch.from_numpy(t))
        jlog, jcache = jtransformer.decode_step(jp, jcfg, jcache,
                                                jnp.asarray(t))
        close(tlog, jlog, TOL)
        np.testing.assert_array_equal(
            tcache["layers"]["slot_pos"].numpy(),
            np.asarray(jcache["layers"]["slot_pos"]))
        assert int(tcache["pos"]) == int(jcache["pos"])
    for name in ("k", "v"):
        close(tcache["layers"][name], jcache["layers"][name], TOL)
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(2, 16)),
             "targets": rng.integers(0, cfg.vocab_size, size=(2, 16)),
             "mask": (rng.random((2, 16)) > 0.2).astype(np.float32)}
    batch["tokens"] = batch["tokens"].astype(np.int32)
    batch["targets"] = batch["targets"].astype(np.int32)
    loss, m = transformer.loss_fn(tp, cfg, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    jloss, jm = jtransformer.loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                                for k, v in batch.items()})
    for k in ("ce", "aux"):
        close(m[k].detach(), jm[k], TOL)
    close(loss.detach(), jloss, TOL)
    return m


# --- configs ----------------------------------------------------------------

def test_every_new_arch_resolves_to_the_transformer_api():
    for arch in ARCHS:
        assert arch in ALL_ARCHS
        for cfg in (get_config(arch), get_smoke_config(arch)):
            api = mapi.get_api(cfg)
            assert api.specs is transformer.lm_specs
            assert api.decode_step is transformer.decode_step
            assert cfg.name == arch and cfg.attn_impl == "cuda"
    assert get_config("qwen2-moe-a2.7b").family == "moe"
    assert get_config("command-r-35b").parallel_block
    for family, arch in (("audio", "whisper-large-v3"),
                         ("vlm", "llava-next-mistral-7b")):
        cfg = get_smoke_config(arch)      # resolved now; the engine raises
        api = mapi.get_api(cfg)
        assert api.specs is not transformer.lm_specs
        eng = ServeEngine(cfg, init_params(api.specs(cfg), device="cpu"),
                          max_batch=2, clock=ManualClock(), device="cpu")
        with pytest.raises(NotImplementedError, match="model API directly"):
            eng.generate([Request(prompt=np.arange(1, 12, dtype=np.int32),
                                  max_new_tokens=2)])


def test_cells_are_jaxs():
    """``configs.shapes.cells()`` yields JAX's (arch, shape, skip reason)
    triples in JAX's order, every one of JAX's 13 archs resolving."""
    import dataclasses
    from repro.configs.base import ALL_ARCHS as JAX_ALL_ARCHS
    from repro.configs.shapes import cells as jax_cells
    from repro_torch.configs.shapes import cells
    mine = [(a, dataclasses.astuple(s), r) for a, s, r in cells()]
    theirs = [(a, dataclasses.astuple(s), r) for a, s, r in jax_cells()]
    assert mine == theirs and len(mine) == 43
    assert sum(r is not None for _, _, r in mine) == 8
    assert ALL_ARCHS == JAX_ALL_ARCHS
    for arch in ALL_ARCHS:
        mapi.get_api(get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_jaxs_field_for_field(arch):
    import dataclasses
    for mine, theirs in ((get_config(arch), jax_get_config(arch)),
                         (get_smoke_config(arch), jax_get_smoke_config(arch))):
        for f in dataclasses.fields(mine):
            if f.name in ("attn_impl", "gru"):     # the port's names / cells
                continue
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            if f.name == "moe" and a is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, f.name


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_param_counts_are_jaxs(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    if cfg.moe is None:
        assert cfg.active_param_count() == cfg.param_count()
        return
    # JAX's arithmetic counts num_experts; the spec tree holds the padded
    # experts and their router columns (kept as JAX has it), and the
    # leaves the arithmetic leaves out: the shared expert's gate, the
    # q/k/v biases, the qk-norm scales, the final norm
    m, E = cfg.moe, moe.padded_experts(cfg.moe)
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    assert (E, m.num_experts) == {"qwen2-moe-a2.7b": (64, 60),
                                  "qwen3-moe-235b-a22b": (128, 128)}[arch]
    pad = L * (E - m.num_experts) * (3 * d * m.d_expert + d)
    left_out = d + (L * d if m.shared_d_ff else 0)
    if cfg.qkv_bias:
        left_out += L * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
    if cfg.qk_norm:
        left_out += L * 2 * hd
    assert param_count(transformer.lm_specs(cfg)) == \
        cfg.param_count() + pad + left_out
    assert cfg.active_param_count() < cfg.param_count()


def test_qwen2_moe_full_size_is_what_one_card_serves():
    cfg = get_config("qwen2-moe-a2.7b")
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size) == (24, 2048, 151936)
    assert moe.padded_experts(cfg.moe) == 64 and cfg.moe.top_k == 4
    n = param_count(transformer.lm_specs(cfg))
    assert 15.1e9 < n < 15.2e9                     # 30.3 GB in bf16
    assert cfg.param_count() == 14_315_585_536


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_are_jaxs(arch):
    cfg, jcfg = get_smoke_config(arch), jax_get_smoke_config(arch)
    mine = flatten(init_params(transformer.lm_specs(cfg), 0, device="cpu"))
    theirs = flatten(to_torch(numpy_params(jtransformer.lm_specs(jcfg))))
    assert list(mine) == list(theirs)
    for k in mine:
        assert mine[k].shape == theirs[k].shape, k


# --- the model against JAX's ------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_and_loss_match_jax(arch):
    cfg, jcfg = _cfgs(arch)
    m = _run_both(cfg, jcfg, _params_np(jcfg))
    if arch in MOE:
        assert float(m["aux"]) > 0.0
    else:
        assert float(m["aux"]) == 0.0


def test_qwen3_moe_past_48_layers_matches_jaxs_scanned_decode():
    """JAX decodes above 48 layers by ``lax.scan`` (``_decode_step_scanned``);
    the port's one loop gives its numbers."""
    cfg, jcfg = _cfgs("qwen3-moe-235b-a22b", num_layers=50)
    _run_both(cfg, jcfg, _params_np(jcfg), steps=3)


def test_prepare_params_gives_the_per_call_casts_logits():
    for arch in MOE:
        cfg = get_smoke_config(arch)                   # bfloat16 compute
        params = init_params(transformer.lm_specs(cfg), seed=1, device="cpu")
        prep = mapi.get_api(cfg).prepare_params(params, cfg, "cpu")
        blk = prep["blocks"]["moe"]
        for k in ("wg", "wu", "wd"):
            assert blk[k].dtype == torch.bfloat16
            assert torch.equal(blk[k], params["blocks"]["moe"][k]
                               .to(torch.bfloat16))
        assert blk["router"].dtype == torch.float32
        if "shared" in blk:
            assert blk["shared"]["wg"]["w"].dtype == torch.bfloat16
            assert blk["shared_gate"].dtype == torch.float32
        # the leaf-by-leaf build is the same tree
        again = transformer.init_prepared(cfg, 1, "cpu")
        for k, v in flatten(prep).items():
            assert v.dtype == flatten(again)[k].dtype
            assert torch.equal(v, flatten(again)[k]), k
        toks = torch.from_numpy(_tokens((6, 3), cfg.vocab_size, seed=2))
        a, ca = transformer.prefill(params, cfg, toks)
        b, cb = transformer.prefill(prep, cfg, toks)
        assert torch.equal(a, b)
        nxt = torch.tensor([5, 7])
        for _ in range(3):
            a, ca = transformer.decode_step(params, cfg, ca, nxt)
            b, cb = transformer.decode_step(prep, cfg, cb, nxt)
            assert torch.equal(a, b)


# --- the engine -----------------------------------------------------------

PROMPT_LENS = (3, 7, 5, 11)


def _lm_requests(vocab):
    rng = np.random.default_rng(1)
    return [dict(prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                 max_new_tokens=8) for n in PROMPT_LENS]


@pytest.mark.parametrize("arch", MOE)
def test_engine_streams_equal_jax(arch):
    cfg, jcfg = _cfgs(arch)
    params_np = _params_np(jcfg)
    jeng = JServeEngine(jcfg, to_jax(params_np), ShardCtx(), max_batch=4)
    want = [r.out for r in jeng.generate(
        [JRequest(**r) for r in _lm_requests(cfg.vocab_size)])]
    eng = ServeEngine(cfg, to_torch(params_np), max_batch=4,
                      clock=ManualClock(), device="cpu")
    done = eng.generate([Request(**r) for r in _lm_requests(cfg.vocab_size)])
    assert [r.out for r in done] == want
    assert all(len(s) == 8 for s in want)
    stats = eng.latency_stats()
    assert stats["prefills"] == 1 and stats["steps"] == 7


def test_cli_serves_the_moe_smoke_config_on_cpu(capsys):
    from repro_torch.launch import serve as cli
    done = cli.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--device",
                     "cpu", "--requests", "3", "--prompt-len", "6",
                     "--max-new", "4"])
    assert [len(r.out) for r in done] == [4, 4, 4]
    out = capsys.readouterr().out
    assert "bfloat16" in out and "attention: cuda (2 layers" in out


def test_serve_batched_example_on_cpu(capsys):
    from repro_torch.examples import serve_batched
    done = serve_batched.main(["--arch", "qwen2-moe-a2.7b", "--device",
                               "cpu"])
    assert [len(r.out) for r in done] == [24] * 4
    assert all(len(r.prompt) == 12 for r in done)


def test_train_cli_moe_smoke_carries_the_aux(capsys):
    from repro_torch.launch import train as tcli
    state = tcli.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--device",
                       "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
                       "--log-every", "1"])
    out = capsys.readouterr().out
    assert "attn_impl: cuda -> chunked" in out and "done: 3 steps" in out
    assert int(state["step"]) == 3
    cfg = get_smoke_config("qwen2-moe-a2.7b").replace(attn_impl="chunked")
    toks = torch.randint(0, cfg.vocab_size, (2, 16))
    loss, m = transformer.loss_fn(state["params"], cfg,
                                  {"tokens": toks, "targets": toks})
    assert float(m["aux"].detach()) > 0.0
    assert torch.allclose(loss.detach(), (m["ce"] + m["aux"]).detach())
