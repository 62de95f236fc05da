"""The port's llava vision-language model (``repro_torch.models.llava``,
family ``vlm``, ``llava-next-mistral-7b``) and the transformer's
``inputs_embeds`` against JAX's ``repro.models.llava`` on the CPU, at
SMOKE size (2 layers, d_model 64, 4/2 heads, 8 patches of 32) in fp32.

Same parameters (JAX ``init_params`` as numpy; the RMSNorm scales
perturbed off their init, the projector's biases noise), same patches and
tokens. Port ``chunked`` = JAX ``xla_flash``; port ``cuda`` runs the
kernels' plain versions on CPU tensors and is held against JAX's
``pallas`` (its two Pallas attention kernels in interpret mode).
Tolerances: 1e-5 (rtol = atol) for the merged embeddings, logits, losses
and caches; loss gradients 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import get_smoke_config as jax_get_smoke_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.data.pipeline import SyntheticStream as JStream
from repro.distributed.sharding import ShardCtx
from repro.models import api as japi
from repro.models import llava as jllava
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.params import flatten, init_params, param_count
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.models import api as mapi
from repro_torch.models import llava, transformer
from repro_torch.serve.clock import ManualClock
from repro_torch.serve.engine import Request, ServeEngine

from _torch_lm import cfgs, params_np, tokens
from _torch_parity import close, to_jax, to_torch

ARCH = "llava-next-mistral-7b"
TOL = 1e-5
CTX = ShardCtx()
IMPLS = (("chunked", "xla_flash"), ("cuda", "pallas"))


@pytest.fixture(scope="module")
def both():
    cfg, jcfg = cfgs(ARCH)
    pn = params_np(jllava.lm_specs(jcfg))
    return cfg, jcfg, pn, to_torch(pn), to_jax(pn)


def _patches(cfg, B, seed):
    v = cfg.vision
    return np.random.default_rng(seed).normal(
        size=(B, v.num_patches, v.embed_dim)).astype(np.float32)


def _batches(patches, toks):
    return ({"patches": torch.from_numpy(patches),
             "tokens": torch.from_numpy(toks)},
            {"patches": jnp.asarray(patches), "tokens": jnp.asarray(toks)})


# --- configs and specs ------------------------------------------------------

def test_configs_are_jaxs_field_for_field():
    for mine, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         (get_smoke_config(ARCH), jax_get_smoke_config(ARCH))):
        for f in dataclasses.fields(mine):
            if f.name in ("attn_impl", "gru"):     # the port's names / cells
                continue
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            if f.name == "vision":
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, f.name
        assert mine.param_count() == theirs.param_count()
        assert mine.family == "vlm" and mine.attn_impl == "cuda"
        api = mapi.get_api(mine)
        assert api.specs is llava.lm_specs
        assert api.decode_step is transformer.decode_step
    full = get_config(ARCH)
    assert (full.num_heads, full.num_kv_heads, full.resolved_head_dim,
            full.vision.num_patches, full.vision.embed_dim) == \
        (32, 8, 128, 576, 1024)


def test_spec_tree_is_jaxs_and_the_seed_fixes_it(both):
    cfg = get_smoke_config(ARCH)
    mine = flatten(init_params(llava.lm_specs(cfg), 0, device="cpu"))
    theirs = flatten(both[3])
    assert list(mine) == list(theirs)
    for k in mine:
        assert mine[k].shape == theirs[k].shape, k
    assert "projector/w1/b" in mine and "projector/w2/w" in mine
    from repro.core.params import param_count as jparam_count
    n = param_count(llava.lm_specs(get_config(ARCH)))
    assert n == jparam_count(jllava.lm_specs(jax_get_config(ARCH)))
    # ModelConfig.param_count (the transformer) + the projector + norms
    assert n == 7_262_711_808


# --- the merged embeddings and the model ------------------------------------

def test_merged_embeds_match_jax(both):
    cfg, jcfg, _, tp, jp = both
    pa = _patches(cfg, 2, 1)
    toks = tokens((12, 10), cfg.vocab_size, seed=1)
    got = llava._merged_embeds(tp, cfg, torch.from_numpy(toks),
                               torch.from_numpy(pa))
    want = jllava._merged_embeds(jp, jcfg, jnp.asarray(toks),
                                 jnp.asarray(pa))
    close(got, want, TOL)
    P = cfg.vision.num_patches
    assert torch.equal(got[:, P:], tp["embed"][torch.from_numpy(
        toks[:, P:]).long()])


def test_a_sequence_shorter_than_the_patches_raises(both):
    cfg, _, _, tp, _ = both
    pa = torch.from_numpy(_patches(cfg, 1, 2))
    with pytest.raises(ValueError, match=r"\b5 tokens\b.*\b8 image patches"):
        llava._merged_embeds(tp, cfg, torch.ones(1, 5, dtype=torch.int32),
                             pa)


@pytest.mark.parametrize("impl,jimpl", IMPLS)
@pytest.mark.parametrize("S", [8, 13])
def test_forward_matches_jax(both, impl, jimpl, S):
    cfg, jcfg, _, tp, jp = both
    cfg, jcfg = cfg.replace(attn_impl=impl), jcfg.replace(attn_impl=jimpl)
    tb, jb = _batches(_patches(cfg, 2, S), tokens((S, S - 3),
                                                  cfg.vocab_size, seed=S))
    close(mapi.get_api(cfg).forward(tp, cfg, tb),
          jllava.forward(jp, jcfg, jb, ctx=CTX), TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_jax(both, masked):
    """The text mask (positions >= P) alone, and times a batch mask; every
    leaf's gradient, the projector's among them."""
    cfg, jcfg, pn, _, jp = both
    S = 12
    tb, jb = _batches(_patches(cfg, 2, 3), tokens((S, S), cfg.vocab_size, 3))
    rng = np.random.default_rng(9)
    tgt = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    tb["targets"], jb["targets"] = torch.from_numpy(tgt), jnp.asarray(tgt)
    if masked:
        m = (rng.random((2, S)) > 0.3).astype(np.float32)
        tb["mask"], jb["mask"] = torch.from_numpy(m), jnp.asarray(m)
    params = to_torch(pn)
    for v in flatten(params).values():
        v.requires_grad_(True)
    loss, met = llava.loss_fn(params, cfg, tb)
    loss.backward()
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jllava.loss_fn(p, jcfg, jb, ctx=CTX), has_aux=True)(jp)
    close(loss.detach(), jloss, TOL)
    close(met["ce"].detach(), jm["ce"], TOL)
    grads, jgrads = flatten(params), flatten(jax.tree.map(np.asarray, jg))
    assert list(grads) == list(jgrads)
    for k, v in grads.items():
        close(v.grad, jgrads[k], 1e-4)
    assert float(grads["projector/w1/w"].grad.abs().sum()) > 0
    # the image positions carry no loss: changing their targets changes
    # nothing
    tb2 = dict(tb, targets=tb["targets"].clone())
    tb2["targets"][:, :cfg.vision.num_patches] = 0
    with torch.no_grad():
        assert torch.equal(llava.loss_fn(params, cfg, tb2)[0], loss.detach())


@pytest.mark.parametrize("impl,jimpl", IMPLS)
@pytest.mark.parametrize("S", [9, 12])
def test_prefill_and_decode_match_jax(both, impl, jimpl, S):
    """Prefill and 3 decode steps against JAX's teacher-forced ``forward``
    (the patches in the first P positions of both); the cache is JAX's
    prefill cache in values and layout (64 empty slots after the prompt),
    and JAX's decode steps give the same logits."""
    cfg, jcfg, _, tp, jp = both
    cfg, jcfg = cfg.replace(attn_impl=impl), jcfg.replace(attn_impl=jimpl)
    pa = _patches(cfg, 2, 30 + S)
    toks = tokens((S, S), cfg.vocab_size, seed=30 + S)
    nxt = np.random.default_rng(S).integers(1, cfg.vocab_size,
                                            (2, 3)).astype(np.int32)
    full = np.asarray(jllava.forward(
        jp, jcfg, {"patches": jnp.asarray(pa),
                   "tokens": jnp.asarray(np.concatenate([toks, nxt], 1))},
        ctx=CTX))
    tb, jb = _batches(pa, toks)
    tl, tc = mapi.get_api(cfg).prefill(tp, cfg, tb)
    jl, jc = jllava.prefill(jp, jcfg, jb, ctx=CTX)
    close(tl, jl, TOL)
    close(tl, full[:, S - 1], TOL)
    for k in ("k", "v"):
        close(tc["layers"][k], jc["layers"][k], TOL)
    np.testing.assert_array_equal(tc["layers"]["slot_pos"].numpy(),
                                  np.asarray(jc["layers"]["slot_pos"]))
    for t in range(3):
        tok = nxt[:, t]
        tl, tc = llava.decode_step(tp, cfg, tc, torch.from_numpy(tok))
        jl, jc = jllava.decode_step(jp, jcfg, jc, jnp.asarray(tok), ctx=CTX)
        close(tl, full[:, S + t], TOL)
        close(tl, jl, TOL)
    for k in ("k", "v"):
        close(tc["layers"][k], jc["layers"][k], TOL)


def test_hidden_states_take_inputs_embeds(both):
    """The transformer with ``inputs_embeds`` equal to its own embedding
    of the tokens is the plain transformer, bit for bit."""
    cfg, _, _, tp, _ = both
    toks = torch.from_numpy(tokens((7, 7), cfg.vocab_size, 4))
    x = tp["embed"][toks.long()]
    a = transformer.hidden_states(tp, cfg, toks)[0]
    b = transformer.hidden_states(tp, cfg, toks, inputs_embeds=x)[0]
    assert torch.equal(a, b)
    la, _ = transformer.prefill(tp, cfg, toks)
    lb, _ = transformer.prefill(tp, cfg, toks, inputs_embeds=x)
    assert torch.equal(la, lb)


# --- serving prep, batches, the engine ---------------------------------------

def test_prepare_params_and_init_prepared():
    cfg = get_smoke_config(ARCH).replace(attn_impl="chunked")   # bf16
    api = mapi.get_api(cfg)
    params = init_params(llava.lm_specs(cfg), seed=1, device="cpu")
    prep = flatten(api.prepare_params(params, cfg, "cpu"))
    for path, v in prep.items():
        leaf = path.split("/")[-1]
        cast = leaf in ("w", "b") or path in ("embed", "lm_head")
        assert v.dtype == (torch.bfloat16 if cast else torch.float32), path
    again = flatten(api.init_prepared(cfg, 1, "cpu"))
    assert list(again) == list(prep)
    for k, v in again.items():
        assert v.dtype == prep[k].dtype and torch.equal(v, prep[k]), k
    tb, _ = _batches(_patches(cfg, 2, 5), tokens((10, 10), cfg.vocab_size, 5))
    a, ca = llava.prefill(params, cfg, tb)
    b, cb = llava.prefill(api.prepare_params(params, cfg, "cpu"), cfg, tb)
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_concrete_batch_is_jaxs_bit_for_bit(shape):
    """Patches drawn in JAX's sorted-key order (patches, targets, tokens)."""
    cfg, jcfg = get_smoke_config(ARCH), jax_get_smoke_config(ARCH)
    sh = dataclasses.replace(SHAPES[shape], seq_len=12, global_batch=2)
    jsh = dataclasses.replace(JSHAPES[shape], seq_len=12, global_batch=2)
    mine = mapi.concrete_batch(cfg, sh, seed=5, device="cpu")
    theirs = japi.concrete_batch(jcfg, jsh, seed=5)
    assert sorted(mine) == sorted(theirs)
    if shape != "decode_32k":
        assert mine["patches"].shape == (2, 8, 32)
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
    for step in (0, 5):
        mine, theirs = SyntheticStream(cfg, sh).batch_at(step), \
            JStream(jcfg, jsh).batch_at(step)
        assert sorted(mine) == sorted(theirs) == ["patches", "targets",
                                                  "tokens"]
        for k in mine:
            np.testing.assert_array_equal(mine[k], theirs[k])


def test_engine_generate_raises_as_jaxs(both):
    cfg, jcfg, pn, tp, _ = both
    reqs = [dict(prompt=np.arange(1, 12, dtype=np.int32), max_new_tokens=2)]
    eng = ServeEngine(cfg, tp, max_batch=2, clock=ManualClock(),
                      device="cpu")
    jeng = JServeEngine(jcfg, to_jax(pn), ShardCtx(), max_batch=2)
    for e, R in ((eng, Request), (jeng, JRequest)):
        with pytest.raises(NotImplementedError, match="model API directly"):
            e.generate([R(**r) for r in reqs])
