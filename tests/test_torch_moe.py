"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``: ``moe_apply`` with ``ShardCtx()``, its
one-device path, and the oracle ``moe_ref``) on the CPU, at both MoE
configs' SMOKE sizes (qwen2-moe-a2.7b: 8 experts padded to 16, top-2, a
shared expert, no renormalisation; qwen3-moe-235b-a22b: top-2,
renormalised, no shared expert), fp32.

Same parameters (JAX ``init_params`` as numpy), same inputs. Tolerances:
outputs within 1e-5 and the aux loss within 1e-6 of JAX's; the router's
gradient within 1e-5. ``torch.topk`` does not promise ``lax.top_k``'s
lower-index-first order on ties, so nothing here is held bit for bit
across the frameworks; the routing itself (the chosen experts) is equal.
The capacity drops are compared pair for pair: each side's own dispatch
runs on probe weights under which a token's output counts the experts
that kept it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_get_smoke_config
from repro.distributed.sharding import ShardCtx as JShardCtx
from repro.models import moe as jmoe
from repro_torch.configs.base import get_smoke_config
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.models import moe

from _torch_parity import close, numpy_params, to_jax, to_torch

ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b")
TOL, AUX_TOL = 1e-5, 1e-6


def _cfgs(arch, factor=None):
    cfg = get_smoke_config(arch).replace(dtype="float32")
    jcfg = jax_get_smoke_config(arch).replace(dtype="float32")
    if factor is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=factor))
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    capacity_factor=factor))
    return cfg, jcfg


def _params(arch, seed=0):
    return numpy_params(jmoe.moe_specs(jax_get_smoke_config(arch)), seed)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(arch, x, factor=None, seed=0, p=None):
    cfg, jcfg = _cfgs(arch, factor)
    p = _params(arch, seed) if p is None else p
    out, aux = moe.moe_apply(to_torch(p), cfg, torch.from_numpy(x))
    jout, jaux = jmoe.moe_apply(to_jax(p), jcfg, jnp.asarray(x),
                                ctx=JShardCtx())
    return (out, aux), (jout, jaux), p, cfg, jcfg


def _routing(p, cfg, x):
    """(port top_i, JAX top_i) of the tokens x (B,S,D)."""
    xf = x.reshape(-1, cfg.d_model)
    _, _, top_i = moe.route(to_torch(p), cfg.moe, torch.from_numpy(xf))
    E = jmoe.padded_experts(cfg.moe)
    logits = jnp.asarray(xf) @ jnp.asarray(p["router"])
    logits = jnp.where(jnp.arange(E)[None] < cfg.moe.num_experts, logits,
                       jmoe.NEG_INF)
    _, jtop_i = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.moe.top_k)
    return top_i.numpy(), np.asarray(jtop_i)


def _probe(D, E, F):
    """Weights under which expert e maps a token whose feature 0 is 1 to
    the one-hot row e (silu(10) * 1 * 1/silu(10)), so with every combine
    weight 1 a token's output row counts the experts that kept it."""
    wg = np.zeros((E, D, F), np.float32)
    wu = np.zeros((E, D, F), np.float32)
    wd = np.zeros((E, F, D), np.float32)
    wg[:, 0, 0] = 10.0
    wu[:, 0, 0] = 1.0
    silu10 = 10.0 / (1.0 + np.exp(-10.0))
    for e in range(E):
        wd[e, 0, e] = 1.0 / silu10
    return wg, wu, wd


def _kept(eidx_port, eidx_jax, cfg, T, C):
    """(port, JAX) kept matrices (T, E) of bools: pair (t, e) kept."""
    E, D, F = jmoe.padded_experts(cfg.moe), cfg.d_model, cfg.moe.d_expert
    assert D >= E
    wg, wu, wd = _probe(D, E, F)
    x = np.zeros((T, D), np.float32)
    x[:, 0] = 1.0
    probs = np.ones(eidx_port.shape, np.float32)
    out = moe._dispatch_compute_combine(
        torch.from_numpy(x), torch.from_numpy(probs),
        torch.from_numpy(eidx_port).long(), torch.from_numpy(wg),
        torch.from_numpy(wu), torch.from_numpy(wd), E=E, C=C,
        compute_dtype=torch.float32).numpy()
    jout = np.asarray(jmoe._dispatch_compute_combine(
        jnp.asarray(x), jnp.asarray(probs), jnp.asarray(eidx_jax),
        jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd), E=E, C=C,
        ep_axis=None, tp_axis=None, ep_size=1, compute_dtype=jnp.float32))
    for o in (out, jout):     # every kept pair contributes exactly 1
        np.testing.assert_allclose(o[:, :E], np.round(o[:, :E]), atol=1e-5)
        assert set(np.round(o[:, :E]).ravel()) <= {0.0, 1.0}
    return out[:, :E] > 0.5, jout[:, :E] > 0.5


def _first_occupants(eidx, C):
    """The pairs JAX's semantics keep: each expert's first C pairs in
    token order."""
    kept = np.zeros((eidx.shape[0], int(eidx.max()) + 1), bool)
    seen = {}
    for t in range(eidx.shape[0]):
        for e in eidx[t]:
            seen[int(e)] = seen.get(int(e), 0) + 1
            kept[t, int(e)] = seen[int(e)] <= C
    return kept


# --- the layer against JAX's ---------------------------------------------

@pytest.mark.parametrize("factor", (8.0, 0.1))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, factor):
    x = _x((2, 8, 64), seed=1)
    (out, aux), (jout, jaux), p, cfg, _ = _both(arch, x, factor)
    close(out, jout, TOL)
    close(aux, jaux, AUX_TOL)
    assert aux.dtype == torch.float32 and float(aux) > 0.0
    top_i, jtop_i = _routing(p, cfg, x)
    np.testing.assert_array_equal(np.sort(top_i, -1), np.sort(jtop_i, -1))
    T, E = 16, moe.padded_experts(cfg.moe)
    C = moe._capacity(T, cfg.moe.top_k, E, factor)
    kept, jkept = _kept(top_i, jtop_i, cfg, T, C)
    np.testing.assert_array_equal(kept, jkept)
    np.testing.assert_array_equal(kept[:, :int(top_i.max()) + 1],
                                  _first_occupants(top_i, C))
    n_pairs = T * cfg.moe.top_k
    if factor == 8.0:
        assert C >= T and kept.sum() == n_pairs                # no drops
    else:
        assert C == 1 and 0 < kept.sum() < n_pairs             # drops


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ref_matches_jax_and_the_capacity_path(arch):
    cfg, jcfg = _cfgs(arch, 8.0)
    p = _params(arch, seed=2)
    x = _x((2, 8, 64), seed=3)
    ref = moe.moe_ref(to_torch(p), cfg, torch.from_numpy(x))
    close(ref, jmoe.moe_ref(to_jax(p), jcfg, jnp.asarray(x)), TOL)
    out, _ = moe.moe_apply(to_torch(p), cfg, torch.from_numpy(x))
    # no drops at factor 8: the capacity path is the oracle (JAX's own
    # test holds its pair at 2e-4)
    close(out, ref, 2e-4)
    cfg_drop, _ = _cfgs(arch, 0.1)
    dropped, _ = moe.moe_apply(to_torch(p), cfg_drop, torch.from_numpy(x))
    assert bool(torch.isfinite(dropped).all())
    assert (dropped - ref).abs().max().item() > 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_batch_at_capacity_one(arch):
    """B = 4 tokens at a decode step: C = ceil(4*2/16*1.25) = 1, so an
    expert chosen by two requests keeps the earlier one's token only, and a
    request's output depends on its wave-mates (JAX's semantics)."""
    cfg, _ = _cfgs(arch)
    p = _params(arch, seed=4)
    E = moe.padded_experts(cfg.moe)
    assert moe._capacity(4, cfg.moe.top_k, E, cfg.moe.capacity_factor) == 1
    for seed in range(100, 200):     # inputs under which some pair drops
        x = _x((4, 1, 64), seed)
        top_i, _ = _routing(p, cfg, x)
        if len(np.unique(top_i)) < top_i.size:
            break
    (out, aux), (jout, jaux), _, _, _ = _both(arch, x, seed=4)
    close(out, jout, TOL)
    close(aux, jaux, AUX_TOL)
    top_i, jtop_i = _routing(p, cfg, x)
    kept, jkept = _kept(top_i, jtop_i, cfg, 4, 1)
    np.testing.assert_array_equal(kept, jkept)
    want = _first_occupants(top_i, 1)
    np.testing.assert_array_equal(kept[:, :want.shape[1]], want)
    assert kept[0].sum() == cfg.moe.top_k      # the first request keeps all
    assert kept.sum() < top_i.size             # some later one lost a pair
    t = int(np.nonzero(kept.sum(1) < cfg.moe.top_k)[0][0])
    alone, _ = moe.moe_apply(to_torch(p), cfg, torch.from_numpy(x[t:t + 1]))
    assert (alone[0] - out[t]).abs().max().item() > 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_experts_never_routed(arch):
    cfg, _ = _cfgs(arch)
    E = moe.padded_experts(cfg.moe)
    assert E == 16 and cfg.moe.num_experts == 8
    p = _params(arch)
    p["router"] = p["router"].copy()
    p["router"][:, cfg.moe.num_experts:] = 100.0    # the padding's logits win
    x = _x((2, 8, 64), seed=5)
    probs, _, top_i = moe.route(to_torch(p), cfg.moe, torch.from_numpy(x)
                                .reshape(-1, 64))
    assert int(top_i.max()) < cfg.moe.num_experts
    assert float(probs[:, cfg.moe.num_experts:].abs().max()) == 0.0
    (out, _), (jout, _), _, _, _ = _both(arch, x, p=p)
    close(out, jout, TOL)


@pytest.mark.parametrize("seed", range(10))
def test_combine_weights_sum(seed):
    """Renormalized top-k routing weights sum to 1 per token (JAX's
    ``test_combine_weights_sum``), and equal JAX's."""
    arch = ARCHS[0]
    cfg, _ = _cfgs(arch)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, norm_topk_prob=True))
    p = numpy_params(jmoe.moe_specs(jax_get_smoke_config(arch)), seed % 7)
    xf = _x((6, cfg.d_model), seed)
    _, top_p, _ = moe.route(to_torch(p), cfg.moe, torch.from_numpy(xf))
    np.testing.assert_allclose(top_p.sum(-1).numpy(), 1.0, rtol=1e-5)
    E = jmoe.padded_experts(cfg.moe)
    logits = jnp.asarray(xf) @ jnp.asarray(p["router"])
    logits = jnp.where(jnp.arange(E)[None] < cfg.moe.num_experts, logits,
                       jmoe.NEG_INF)
    jtop_p, _ = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.moe.top_k)
    jtop_p = jtop_p / jtop_p.sum(-1, keepdims=True)
    close(top_p, jtop_p, 1e-6)


@pytest.mark.parametrize("factor", (1.25, 0.1))
@pytest.mark.parametrize("arch", ARCHS)
def test_router_gradient_matches_jax(arch, factor):
    cfg, jcfg = _cfgs(arch, factor)
    p = _params(arch, seed=6)
    x = _x((2, 8, 64), seed=7)
    tp = to_torch(p)
    leaves = {k: v for k, v in tp.items() if isinstance(v, torch.Tensor)}
    for v in leaves.values():
        v.requires_grad_(True)
    out, aux = moe.moe_apply(tp, cfg, torch.from_numpy(x))
    loss = (out ** 2).mean() + aux
    grads = torch.autograd.grad(loss, list(leaves.values()))

    def jloss(jp):
        o, a = jmoe.moe_apply(jp, jcfg, jnp.asarray(x), ctx=JShardCtx())
        return (o ** 2).mean() + a
    jl, jg = jax.value_and_grad(jloss)(to_jax(p))
    close(loss.detach(), jl, TOL)
    for k, g in zip(leaves, grads):
        close(g, jg[k], TOL)
    assert float(grads[list(leaves).index("router")].abs().sum()) > 0


def test_moe_apply_under_a_mesh_raises():
    """Under a mesh the layer serves and refuses autograd, naming the
    ROADMAP item that brings training under a multi-axis mesh; without
    autograd a one-rank {data, model} mesh gives the one-device bits (the
    mesh path on many ranks: ``test_torch_moe_mesh.py``)."""
    from repro_torch.distributed import local_mesh
    cfg, _ = _cfgs(ARCHS[0])
    p = to_torch(_params(ARCHS[0]))
    ctx = ShardCtx(mesh=local_mesh("cpu", axes=("data", "model")))
    x = torch.from_numpy(_x((2, 3, 64), seed=4))
    assert torch.equal(moe.moe_apply(p, cfg, x, ctx=ctx)[0],
                       moe.moe_apply(p, cfg, x)[0])
    p["wg"].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        moe.moe_apply(p, cfg, x, ctx=ctx)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_specs_are_jaxs(arch):
    cfg = get_smoke_config(arch)
    mine = moe.moe_specs(cfg)
    theirs = jmoe.moe_specs(jax_get_smoke_config(arch))

    def flat(t, pre=""):
        return ({k2: v2 for k, v in t.items()
                 for k2, v2 in flat(v, pre + k + "/").items()}
                if isinstance(t, dict) else {pre[:-1]: t})
    fm, ft = flat(mine), flat(theirs)
    assert sorted(fm) == sorted(ft)
    for k in fm:
        assert (tuple(fm[k].shape), fm[k].init, fm[k].scale) == \
            (tuple(ft[k].shape), ft[k].init, ft[k].scale), k
