"""The port's eager GRU core (``repro_torch.core.gru``) against the JAX
reference (``repro.core.gru``) on the CPU. Same parameters (the JAX
``init_params`` tree, carried over by ``params_from_numpy``) and the same
numpy inputs; tolerance rtol=atol=1e-5 (fp32 across frameworks)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GRUConfig as JCfg
from repro.core import gru as jgru
from repro_torch.configs.base import GRUConfig as TCfg
from repro_torch.core import gru as tgru
from repro_torch.core.params import init_params, params_from_numpy

from _torch_parity import close, numpy_params, to_jax, to_torch

X, H, B, T = 5, 8, 3, 6


def _cfgs(**kw):
    return JCfg(**kw), TCfg(**kw)


def _mask(rng, B, T):
    m = rng.random((B, T)) > 0.3
    m[:, -1] = True
    return m


STEP_CASES = list(itertools.product(("v1", "v3"), (True, False),
                                    (True, False),
                                    ("rowwise", "cascade", "dense")))


@pytest.mark.parametrize("variant,fused,decoupled,mode", STEP_CASES)
def test_gru_step_matches_jax(variant, fused, decoupled, mode):
    jc, tc = _cfgs(input_dim=X, hidden_dim=H, variant=variant,
                   fused_gates=fused, decoupled_wx=decoupled,
                   matvec_mode=mode)
    cell = numpy_params(jgru.gru_cell_specs(X, H))
    rng = np.random.default_rng(3)
    h = rng.normal(scale=0.5, size=(B, H)).astype(np.float32)
    x = rng.normal(size=(B, X)).astype(np.float32)
    if decoupled:
        xp = x @ cell["w"]
        want = jgru.gru_step(to_jax(cell), jnp.asarray(h),
                             x_proj=jnp.asarray(xp), cfg=jc)
        got = tgru.gru_step(to_torch(cell), torch.from_numpy(h),
                            x_proj=torch.from_numpy(xp), cfg=tc)
    else:
        want = jgru.gru_step(to_jax(cell), jnp.asarray(h), x=jnp.asarray(x),
                             cfg=jc)
        got = tgru.gru_step(to_torch(cell), torch.from_numpy(h),
                            x=torch.from_numpy(x), cfg=tc)
    close(got, want)


@pytest.mark.parametrize("mode", ("rowwise", "cascade", "dense"))
@pytest.mark.parametrize("block", (0, 3))
def test_matvec_modes_match_dense(mode, block):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, 12)).astype(np.float32)
    w = rng.normal(size=(12, 24)).astype(np.float32)
    got = tgru.matvec(torch.from_numpy(x), torch.from_numpy(w), mode, block)
    want = jgru.matvec(jnp.asarray(x), jnp.asarray(w), mode, block)
    close(got, want)


SEQ_CASES = list(itertools.product(("v1", "v3"),
                                   ("rowwise", "cascade", "dense"),
                                   (True, False)))


@pytest.mark.parametrize("variant,mode,decoupled", SEQ_CASES)
def test_masked_sequence_matches_jax(variant, mode, decoupled):
    jc, tc = _cfgs(input_dim=X, hidden_dim=H, variant=variant,
                   matvec_mode=mode, decoupled_wx=decoupled)
    cell = numpy_params(jgru.gru_cell_specs(X, H), seed=1)
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(B, T, X)).astype(np.float32)
    h0 = rng.normal(scale=0.5, size=(B, H)).astype(np.float32)
    mask = _mask(rng, B, T)
    jT, jall = jgru.gru_sequence_xla(to_jax(cell), jnp.asarray(h0),
                                     jnp.asarray(xs), cfg=jc,
                                     return_all=True, mask=jnp.asarray(mask))
    tT, tall = tgru.gru_sequence_eager(to_torch(cell), torch.from_numpy(h0),
                                       torch.from_numpy(xs), cfg=tc,
                                       return_all=True,
                                       mask=torch.from_numpy(mask))
    close(tT, jT)
    close(tall, jall)


def _deep_cfgs(variant, **kw):
    return _cfgs(input_dim=X, hidden_dim=H, num_layers=3, variant=variant,
                 layer_matvec_modes=("rowwise", "cascade", "rowwise"), **kw)


@pytest.mark.parametrize("variant", ("v1", "v3"))
@pytest.mark.parametrize("masked", (False, True))
def test_stack_sequence_matches_jax(variant, masked):
    jc, tc = _deep_cfgs(variant)
    cells = numpy_params(jgru.gru_stack_specs(jc), seed=2)
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(B, T, X)).astype(np.float32)
    h0s = tuple(rng.normal(scale=0.5, size=(B, H)).astype(np.float32)
                for _ in range(3))
    mask = _mask(rng, B, T) if masked else None
    jf, jall = jgru.gru_stack_sequence_xla(
        to_jax(cells), to_jax(h0s), jnp.asarray(xs), cfg=jc, return_all=True,
        mask=None if mask is None else jnp.asarray(mask))
    tf, tall = tgru.gru_stack_sequence_eager(
        to_torch(cells), to_torch(h0s), torch.from_numpy(xs), cfg=tc,
        return_all=True, mask=None if mask is None else torch.from_numpy(mask))
    assert len(tf) == 3
    for a, b in zip(tf, jf):
        close(a, b)
    close(tall, jall)


@pytest.mark.parametrize("variant", ("v1", "v3"))
@pytest.mark.parametrize("depth", (1, 3))
def test_stack_decode_matches_jax(variant, depth):
    jc, tc = _cfgs(input_dim=X, hidden_dim=H, num_layers=depth,
                   variant=variant)
    cells = numpy_params(jgru.gru_stack_specs(jc), seed=3)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, X)).astype(np.float32)
    hs = tuple(rng.normal(scale=0.5, size=(B, H)).astype(np.float32)
               for _ in range(depth))
    want = jgru.gru_stack_decode_xla(to_jax(cells), to_jax(hs),
                                     jnp.asarray(x), cfg=jc)
    got = tgru.gru_stack_decode_eager(to_torch(cells), to_torch(hs),
                                      torch.from_numpy(x), cfg=tc)
    for a, b in zip(got, want):
        close(a, b)


@pytest.mark.parametrize("masked", (False, True))
def test_reference_oracles_match_jax(masked):
    jc, tc = _deep_cfgs("v1")
    cells = numpy_params(jgru.gru_stack_specs(jc), seed=4)
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(B, T, X)).astype(np.float32)
    h0s = tuple(np.zeros((B, H), np.float32) for _ in range(3))
    mask = _mask(rng, B, T) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    jT, jall = jgru.gru_reference(to_jax(cells[0]), jnp.asarray(h0s[0]),
                                  jnp.asarray(xs), return_all=True, mask=jm)
    tT, tall = tgru.gru_reference(to_torch(cells[0]),
                                  torch.from_numpy(h0s[0]),
                                  torch.from_numpy(xs), return_all=True,
                                  mask=tm)
    close(tT, jT)
    close(tall, jall)
    jf, _ = jgru.gru_stack_reference(to_jax(cells), to_jax(h0s),
                                     jnp.asarray(xs), mask=jm)
    tf, _ = tgru.gru_stack_reference(to_torch(cells), to_torch(h0s),
                                     torch.from_numpy(xs), mask=tm)
    for a, b in zip(tf, jf):
        close(a, b)


@pytest.mark.parametrize("depth", (1, 3))
def test_classifier_layout_and_classify(depth):
    jc, tc = _cfgs(input_dim=X, hidden_dim=H, num_layers=depth)
    tree = numpy_params(jgru.gru_classifier_specs(jc), seed=5)
    assert set(tree) == ({"cell", "head"} if depth == 1 else {"cells", "head"})
    tp = to_torch(tree)
    assert set(tp) == set(tree)
    if depth > 1:
        assert isinstance(tp["cells"], tuple) and len(tp["cells"]) == depth
    # port specs declare the same shapes as the JAX specs
    specs = tgru.gru_classifier_specs(tc)
    shapes = jax.tree.map(lambda a: a.shape, tree)
    made = init_params(specs, seed=0, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), made,
                        is_leaf=lambda a: isinstance(a, torch.Tensor)) == shapes
    xs = np.random.default_rng(8).normal(size=(B, T, X)).astype(np.float32)
    want = jgru.gru_classify(to_jax(tree), jnp.asarray(xs), cfg=jc)
    got = tgru.gru_classify(tp, torch.from_numpy(xs), cfg=tc)
    close(got, want)


def test_init_params_seeded_and_device_independent():
    specs = tgru.gru_classifier_specs(TCfg(num_layers=2, hidden_dim=H))
    a = init_params(specs, seed=7, device="cpu")
    b = init_params(specs, seed=7, device="cpu")
    c = init_params(specs, seed=8, device="cpu")
    assert torch.equal(a["cells"][1]["u"], b["cells"][1]["u"])
    assert not torch.equal(a["cells"][1]["u"], c["cells"][1]["u"])
    assert not torch.equal(a["cells"][0]["w"][:, :H], a["cells"][1]["u"][:, :H])
    assert torch.count_nonzero(a["head"]["b"]) == 0
    # a cache's per-layer h tuple converts with its layout
    hs = params_from_numpy({"h": (np.ones((2, H), np.float32),) * 2},
                           device="cpu")
    assert isinstance(hs["h"], tuple) and hs["h"][1].shape == (2, H)
