"""The port's whisper encoder-decoder (``repro_torch.models.whisper``,
family ``audio``, ``whisper-large-v3``) and the attention modes it adds
(non-causal, cross-attention with Sq != Sk, the cross decode) against
JAX's ``repro.models.whisper`` and ``repro.models.attention`` on the CPU,
at SMOKE size (2 + 2 layers, d_model 64, 4/4 heads, 16 frames) in fp32.

Same parameters (JAX ``init_params`` as numpy; the LayerNorm scales and
biases perturbed off their init, the dense biases noise), same frames and
tokens. Port ``chunked`` = JAX ``xla_flash``; port ``cuda`` runs the
kernels' plain versions on CPU tensors and is held against JAX's
``pallas`` (its Pallas flash attention in interpret mode). Tolerances:
1e-5 (rtol = atol) for attention, encoder, logits, losses and caches
(fp32 products in other summation orders); loss gradients 1e-4.

Repair (J5): JAX's prefill gives the decoder's self-attention ring exactly
S slots, so its first decode step overwrites position 0, still inside the
causal window, and its decode departs from its own teacher-forced
``forward``. The port's ring has 64 empty slots after the prompt; its
decode equals that ``forward`` and equals JAX's own ``decode_step`` run
from JAX's prefill cache padded with empty slots.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ASSIGNED_ARCHS as JAX_ASSIGNED
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import get_smoke_config as jax_get_smoke_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.data.pipeline import SyntheticStream as JStream
from repro.distributed.sharding import ShardCtx
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import whisper as jwhisper
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import ASSIGNED_ARCHS, get_config, \
    get_smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.params import flatten, init_params, param_count
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.models import api as mapi
from repro_torch.models import attention, whisper
from repro_torch.serve.clock import ManualClock
from repro_torch.serve.engine import Request, ServeEngine

from _torch_lm import ZEROS, cfgs, params_np, tokens
from _torch_parity import close, to_jax, to_torch

ARCH = "whisper-large-v3"
TOL = 1e-5
CTX = ShardCtx()
IMPLS = (("chunked", "xla_flash"), ("cuda", "pallas"))


@pytest.fixture(scope="module")
def both():
    cfg, jcfg = cfgs(ARCH)
    pn = params_np(jwhisper.lm_specs(jcfg), zeros=ZEROS + ("bias",))
    return cfg, jcfg, pn, to_torch(pn), to_jax(pn)


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)


def _batches(frames, toks):
    return ({"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(toks)},
            {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)})


# --- configs and specs ------------------------------------------------------

def test_configs_are_jaxs_field_for_field():
    for mine, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         (get_smoke_config(ARCH), jax_get_smoke_config(ARCH))):
        for f in dataclasses.fields(mine):
            if f.name in ("attn_impl", "gru"):     # the port's names / cells
                continue
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            if f.name == "encoder":
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, f.name
        assert mine.param_count() == theirs.param_count()
        assert mine.family == "audio" and mine.attn_impl == "cuda"
        assert mapi.get_api(mine).specs is whisper.lm_specs
    full = get_config(ARCH)
    assert (full.num_heads, full.num_kv_heads, full.resolved_head_dim,
            full.encoder.num_layers, full.encoder.num_frames) == \
        (20, 20, 64, 32, 1500)
    assert ASSIGNED_ARCHS == JAX_ASSIGNED


def test_spec_tree_is_jaxs_and_the_seed_fixes_it(both):
    cfg = get_smoke_config(ARCH)
    mine = flatten(init_params(whisper.lm_specs(cfg), 0, device="cpu"))
    theirs = flatten(both[3])
    assert list(mine) == list(theirs)
    for k in mine:
        assert mine[k].shape == theirs[k].shape, k
    again = flatten(init_params(whisper.lm_specs(cfg), 0, device="cpu"))
    assert all(torch.equal(mine[k], again[k]) for k in mine)
    from repro.core.params import param_count as jparam_count
    n = param_count(whisper.lm_specs(get_config(ARCH)))
    assert n == jparam_count(jwhisper.lm_specs(jax_get_config(ARCH)))
    assert n == 1_534_809_600          # ModelConfig.param_count + the norms


@pytest.mark.parametrize("d", [64, 1280])
def test_sinusoid_matches_jax(d):
    """fp32 as JAX forms it; the frequencies' ``exp`` may differ by an ulp
    between libms, so positions are held up to 63 (the SMOKE sizes)."""
    pos = np.arange(64)
    close(whisper.sinusoid(torch.from_numpy(pos), d),
          jwhisper.sinusoid(jnp.asarray(pos), d), TOL)
    assert whisper.sinusoid(torch.arange(3)[None], d).shape == (1, 3, d)


# --- the attention modes -------------------------------------------------------

def _attn_params(tp, jp, which):
    take = lambda t: {k: {kk: vv[0] for kk, vv in v.items()}  # noqa: E731
                      for k, v in t["dec_blocks"][which].items()}
    return take(tp), take(jp)


@pytest.mark.parametrize("impl,jimpl", IMPLS)
@pytest.mark.parametrize("mode", ["non_causal", "cross"])
def test_attention_modes_match_jax(both, impl, jimpl, mode):
    """``causal=False`` over the sequence (the encoder) and with ``kv``
    (cross-attention: Sq = 5 queries against Sk = 16 encoder positions),
    port ``chunked`` vs JAX ``xla_flash`` and port ``cuda`` (plain
    versions) vs JAX ``pallas`` (interpret mode)."""
    cfg, jcfg, _, tp, jp = both
    cfg, jcfg = cfg.replace(attn_impl=impl), jcfg.replace(attn_impl=jimpl)
    p, jpp = _attn_params(tp, jp, "cross_attn")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    kw, jkw = {}, {}
    if mode == "cross":
        hd = cfg.resolved_head_dim
        k, v = (rng.normal(size=(2, 16, cfg.num_kv_heads, hd)).astype(
            np.float32) for _ in range(2))
        kw["kv"] = (torch.from_numpy(k), torch.from_numpy(v))
        jkw["kv"] = (jnp.asarray(k), jnp.asarray(v))
    out, (k_out, _) = attention.attention(p, cfg, torch.from_numpy(x),
                                          causal=False, **kw)
    jout, (jk, _) = jattn.attention(jpp, jcfg, jnp.asarray(x), ctx=CTX,
                                    causal=False, **jkw)
    close(out, jout, TOL)
    close(k_out, jk, TOL)
    causal, _ = attention.attention(p, cfg, torch.from_numpy(x), **kw)
    assert (causal - out).abs().max() > 1e-3       # the mask matters


@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_cross_decode_reads_every_written_slot(both, impl, jimpl):
    """``decode_attend(cross=True)`` against JAX's ``decode_attention(cross=
    True)``: every slot with ``slot_pos >= 0`` is valid, even past
    ``pos``; an empty slot (-1) is not; the cache is not written."""
    cfg, jcfg, _, tp, jp = both
    cfg, jcfg = cfg.replace(attn_impl=impl), jcfg.replace(attn_impl=jimpl)
    p, jpp = _attn_params(tp, jp, "cross_attn")
    rng = np.random.default_rng(6)
    C, hd = 16, cfg.resolved_head_dim
    kc, vc = (rng.normal(size=(2, cfg.num_kv_heads, C, hd)).astype(
        np.float32) for _ in range(2))
    slot_pos = np.arange(C, dtype=np.int32)
    slot_pos[3] = -1
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    pos = 2                                    # before most of the slots
    positions = torch.full((2, 1), pos)
    q = attention.project_q(p, cfg, torch.from_numpy(x), positions,
                            rope=False)
    k_t, v_t = torch.from_numpy(kc), torch.from_numpy(vc)
    out = attention.decode_attend(p, cfg, q[:, 0], k_t, v_t,
                                  torch.from_numpy(slot_pos),
                                  torch.tensor(pos), cross=True)
    jout, jc = jattn.decode_attention(
        jpp, jcfg, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc),
                                    "slot_pos": jnp.asarray(slot_pos)},
        jnp.asarray(pos, jnp.int32), ctx=CTX, cross=True)
    close(out, jout, TOL)
    np.testing.assert_array_equal(np.asarray(jc["k"]), kc)
    assert torch.equal(k_t, torch.from_numpy(kc))
    self_mode = attention.decode_attend(p, cfg, q[:, 0], k_t, v_t,
                                        torch.from_numpy(slot_pos),
                                        torch.tensor(pos))
    assert (self_mode - out).abs().max() > 1e-3


# --- the model ---------------------------------------------------------------

@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_encode_matches_jax(both, impl, jimpl):
    cfg, jcfg, _, tp, jp = both
    cfg, jcfg = cfg.replace(attn_impl=impl), jcfg.replace(attn_impl=jimpl)
    fr = _frames(cfg, 2, 1)
    close(whisper.encode(tp, cfg, torch.from_numpy(fr)),
          jwhisper.encode(jp, jcfg, jnp.asarray(fr), ctx=CTX), TOL)


@pytest.mark.parametrize("S", [6, 9])
def test_forward_loss_and_grads_match_jax(both, S):
    cfg, jcfg, pn, tp, jp = both
    fr = _frames(cfg, 2, S)
    toks = tokens((S, S - 2), cfg.vocab_size, seed=S)
    tb, jb = _batches(fr, toks)
    close(whisper.forward(tp, cfg, tb),
          jwhisper.forward(jp, jcfg, jb, ctx=CTX), TOL)
    rng = np.random.default_rng(9)
    tgt = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    mask = (rng.random((2, S)) > 0.2).astype(np.float32)
    tb.update(targets=torch.from_numpy(tgt), mask=torch.from_numpy(mask))
    jb.update(targets=jnp.asarray(tgt), mask=jnp.asarray(mask))
    params = to_torch(pn)
    for v in flatten(params).values():
        v.requires_grad_(True)
    loss, m = whisper.loss_fn(params, cfg, tb)
    loss.backward()
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jwhisper.loss_fn(p, jcfg, jb, ctx=CTX), has_aux=True)(jp)
    close(loss.detach(), jloss, TOL)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    grads, jgrads = flatten(params), flatten(jax.tree.map(np.asarray, jg))
    assert list(grads) == list(jgrads)
    for k, v in grads.items():
        close(v.grad, jgrads[k], 1e-4)


def _check_cache(tc, jc, S):
    """The port's cache against JAX's prefill cache: the cross cache in
    values and layout; the self ring's first S slots, then 64 empty."""
    for k in ("k", "v"):
        close(tc["cross"][k], jc["cross"][k], TOL)
        close(tc["self"][k][:, :, :, :S], jc["self"][k], TOL)
        assert not tc["self"][k][:, :, :, S:].any()
    np.testing.assert_array_equal(tc["cross"]["slot_pos"].numpy(),
                                  np.asarray(jc["cross"]["slot_pos"]))
    sp = tc["self"]["slot_pos"].numpy()
    np.testing.assert_array_equal(sp[:, :S], np.asarray(jc["self"]["slot_pos"]))
    assert sp.shape[1] == S + whisper.HEADROOM and (sp[:, S:] == -1).all()
    assert int(tc["pos"]) == int(jc["pos"]) == S - 1


@pytest.mark.parametrize("impl,jimpl", IMPLS)
@pytest.mark.parametrize("S", [4, 7])
def test_prefill_and_decode_match_jax_forward(both, impl, jimpl, S):
    """Prefill and 3 decode steps against JAX's teacher-forced ``forward``
    over the prompt and the fed tokens; the caches JAX's."""
    cfg, jcfg, _, tp, jp = both
    cfg, jcfg = cfg.replace(attn_impl=impl), jcfg.replace(attn_impl=jimpl)
    fr = _frames(cfg, 2, 20 + S)
    toks = tokens((S, S), cfg.vocab_size, seed=20 + S)
    nxt = np.random.default_rng(S).integers(1, cfg.vocab_size,
                                            (2, 3)).astype(np.int32)
    full = np.asarray(jwhisper.forward(
        jp, jcfg, {"frames": jnp.asarray(fr),
                   "tokens": jnp.asarray(np.concatenate([toks, nxt], 1))},
        ctx=CTX))
    tb, jb = _batches(fr, toks)
    tl, tc = mapi.get_api(cfg).prefill(tp, cfg, tb)
    jl, jc = jwhisper.prefill(jp, jcfg, jb, ctx=CTX)
    close(tl, jl, TOL)
    close(tl, full[:, S - 1], TOL)
    _check_cache(tc, jc, S)
    cross = {k: v.clone() for k, v in tc["cross"].items()}
    for t in range(3):
        tl, tc = whisper.decode_step(tp, cfg, tc, torch.from_numpy(nxt[:, t]))
        close(tl, full[:, S + t], TOL)
        assert int(tc["pos"]) == S + t
    assert all(torch.equal(cross[k], tc["cross"][k]) for k in cross)
    assert tc["self"]["slot_pos"][0, S:S + 3].tolist() == [S, S + 1, S + 2]


def _pad_jax_cache(jc, extra):
    """JAX's prefill cache with ``extra`` empty slots after the prompt
    (``slot_pos = -1``, zero K/V): the headroom its prefill lacks."""
    pad = ((0, 0), (0, 0), (0, 0), (0, extra), (0, 0))
    sp = jc["self"]["slot_pos"]
    return {"self": {"k": jnp.pad(jc["self"]["k"], pad),
                     "v": jnp.pad(jc["self"]["v"], pad),
                     "slot_pos": jnp.concatenate(
                         [sp, jnp.full((sp.shape[0], extra), -1, jnp.int32)],
                         1)},
            "cross": jc["cross"], "pos": jc["pos"]}


@pytest.mark.parametrize("S", [3, 5])
def test_self_ring_headroom_repair(both, S):
    """J5: the port's prefill + decode equals JAX's teacher-forced
    ``forward`` step by step; JAX's own decode from its S-slot ring
    departs from it by more than 1e-2 (it overwrote position 0); JAX's
    decode from the same cache padded with empty slots equals the port."""
    cfg, jcfg, _, tp, jp = both
    fr = _frames(cfg, 2, 40 + S)
    toks = tokens((S, S), cfg.vocab_size, seed=40 + S)
    nxt = np.random.default_rng(S).integers(1, cfg.vocab_size,
                                            (2, 3)).astype(np.int32)
    full = np.asarray(jwhisper.forward(
        jp, jcfg, {"frames": jnp.asarray(fr),
                   "tokens": jnp.asarray(np.concatenate([toks, nxt], 1))},
        ctx=CTX))
    tb, jb = _batches(fr, toks)
    tl, tc = whisper.prefill(tp, cfg, tb)
    _, jc = jwhisper.prefill(jp, jcfg, jb, ctx=CTX)
    assert jc["self"]["k"].shape[3] == S
    padded = _pad_jax_cache(jc, 8)
    jax_err = 0.0
    for t in range(3):
        tok = nxt[:, t]
        tl, tc = whisper.decode_step(tp, cfg, tc, torch.from_numpy(tok))
        jl, jc = jwhisper.decode_step(jp, jcfg, jc, jnp.asarray(tok), ctx=CTX)
        pl, padded = jwhisper.decode_step(jp, jcfg, padded, jnp.asarray(tok),
                                          ctx=CTX)
        close(tl, full[:, S + t], TOL)
        close(tl, pl, TOL)
        jax_err = max(jax_err, float(np.abs(np.asarray(jl)
                                            - full[:, S + t]).max()))
    assert jax_err > 1e-2


def test_init_cache_is_jaxs():
    cfg, jcfg = cfgs(ARCH)
    mine = whisper.init_cache(cfg, 2, 10, device="cpu")
    theirs = jwhisper.init_cache(jcfg, 2, 10)
    fm, ft = flatten(mine), flatten(jax.tree.map(np.asarray, theirs))
    assert list(fm) == list(ft)
    for k in fm:
        assert tuple(fm[k].shape) == ft[k].shape, k
        np.testing.assert_array_equal(fm[k].numpy(), ft[k])


def test_decode_writes_only_the_self_ring_in_place(both):
    cfg, _, _, tp, _ = both
    tb, _ = _batches(_frames(cfg, 2, 3), tokens((6, 6), cfg.vocab_size, 3))
    _, cache = whisper.prefill(tp, cfg, tb)
    k, ck = cache["self"]["k"], cache["cross"]["k"]
    k0, ck0 = k.clone(), ck.clone()
    _, out = whisper.decode_step(tp, cfg, cache, torch.tensor([1, 2]))
    assert out["self"]["k"] is k and not torch.equal(k, k0)
    assert out["cross"]["k"] is ck and torch.equal(ck, ck0)


# --- serving prep, batches, the engine ---------------------------------------

def test_prepare_params_casts_only_the_dense_weights():
    cfg = get_smoke_config(ARCH).replace(attn_impl="chunked")   # bf16
    params = init_params(whisper.lm_specs(cfg), seed=1, device="cpu")
    with torch.no_grad():
        for v in flatten(params).values():
            if v.dim() <= 2 and not v.any():       # the LayerNorm biases
                v.normal_(0.0, 0.1)
    api = mapi.get_api(cfg)
    prep = api.prepare_params(params, cfg, "cpu")
    flat = flatten(prep)
    for path, v in flat.items():
        dense = path.split("/")[-1] == "w" or path == "embed"
        assert v.dtype == (torch.bfloat16 if dense else torch.float32), path
    again = flatten(api.init_prepared(cfg, 1, "cpu"))
    for k, v in again.items():
        assert v.dtype == flat[k].dtype
        if not k.endswith("bias"):
            assert torch.equal(v, flat[k]), k
    tb, _ = _batches(_frames(cfg, 2, 5), tokens((7, 4), cfg.vocab_size, 2))
    a, ca = whisper.prefill(params, cfg, tb)
    b, cb = whisper.prefill(prep, cfg, tb)
    assert torch.equal(a, b)
    for _ in range(3):
        a, ca = whisper.decode_step(params, cfg, ca, torch.tensor([5, 7]))
        b, cb = whisper.decode_step(prep, cfg, cb, torch.tensor([5, 7]))
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_concrete_batch_is_jaxs_bit_for_bit(shape):
    """Frames drawn in JAX's sorted-key order (frames, targets, tokens):
    the same values in both packages (SMOKE widths, a short sequence)."""
    cfg, jcfg = get_smoke_config(ARCH), jax_get_smoke_config(ARCH)
    sh = dataclasses.replace(SHAPES[shape], seq_len=12, global_batch=2)
    jsh = dataclasses.replace(JSHAPES[shape], seq_len=12, global_batch=2)
    mine = mapi.concrete_batch(cfg, sh, seed=3, device="cpu")
    theirs = japi.concrete_batch(jcfg, jsh, seed=3)
    assert sorted(mine) == sorted(theirs)
    if shape != "decode_32k":
        assert mine["frames"].shape == (2, 16, 64)
        assert mine["frames"].dtype == torch.bfloat16
    for k in mine:
        a = mine[k].float().numpy() if mine[k].is_floating_point() \
            else mine[k].numpy()
        np.testing.assert_array_equal(a, np.asarray(theirs[k], np.float32)
                                      if mine[k].is_floating_point()
                                      else np.asarray(theirs[k]))


def test_synthetic_stream_is_jaxs_bit_for_bit():
    cfg, jcfg = get_smoke_config(ARCH), jax_get_smoke_config(ARCH)
    sh = dataclasses.replace(SHAPES["train_4k"], seq_len=10, global_batch=3)
    jsh = dataclasses.replace(JSHAPES["train_4k"], seq_len=10, global_batch=3)
    for step in (0, 7):
        mine, theirs = SyntheticStream(cfg, sh).batch_at(step), \
            JStream(jcfg, jsh).batch_at(step)
        assert sorted(mine) == sorted(theirs) == ["frames", "targets",
                                                  "tokens"]
        for k in mine:
            np.testing.assert_array_equal(mine[k], theirs[k])


def test_engine_generate_raises_as_jaxs(both):
    cfg, jcfg, pn, tp, _ = both
    reqs = [dict(prompt=np.array([1, 2, 3], np.int32), max_new_tokens=2)]
    eng = ServeEngine(cfg, tp, max_batch=2, clock=ManualClock(),
                      device="cpu")
    jeng = JServeEngine(jcfg, to_jax(pn), ShardCtx(), max_batch=2)
    for e, R in ((eng, Request), (jeng, JRequest)):
        with pytest.raises(NotImplementedError, match="model API directly"):
            e.generate([R(**r) for r in reqs])
    with pytest.raises(NotImplementedError):
        eng.generate([])
