"""The port's sLSTM family on the CPU (``repro_torch.core.slstm``,
``kernels/slstm_cell``, ``models/slstm_lm``, ``slstm-jet``), against the
JAX package.

* (a) the eager core: gate math, stack sequence (masked and not) and
  decode against ``repro.core.slstm``'s ``*_xla`` backends and
  ``slstm_stack_reference``; the family registry against JAX's;
* (b) the plain kernel versions: the sequence against the Pallas
  ``slstm_stack_sequence_kernel`` in interpret mode (masked and not) and
  JAX's ``slstm_stack_sequence_ref``; the decode against
  ``slstm_stack_decode_ref`` and ``slstm_stack_decode_xla`` (the Pallas
  decode does not run under this jax); the wrappers on CPU tensors;
* (c) dispatch equal to JAX's ``compile`` (names mapped);
* (d) ``prepare`` builds the 4H stacks once and no int8 views;
* (e) the ``cuda_fused`` and ``eager`` executors against JAX's ``xla``
  executor;
* (f) masked bucketed prefill bitwise equal to the unpadded prompt, all
  four leaves;
* (g) served class streams equal to JAX's ``ServeEngine``; the first token
  is prefill plus one re-fed step; ``init_cache``; unknown families;
* (h) the CLI.

Sizes: H 8 and 16, B=3, T=5, depths 1-3 (and a (16, 8) heterogeneous
stack for the eager backend); the served configs at their own widths
(``slstm-jet`` and a depth-3 H=32 stack). Tolerance rtol=atol=1e-5
across frameworks (fp32, different summation orders and libm), bitwise
inside the port. Inputs are made from numpy seeds.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, numpy_params, to_jax, to_torch
from repro.configs.base import GRUConfig as JCfg
from repro.configs.base import get_config as jax_get_config
from repro.core import cells as jcells
from repro.core import runtime as jruntime
from repro.core import slstm as jslstm
from repro.distributed.sharding import ShardCtx
from repro.kernels.slstm_cell import ref as jsref
from repro.kernels.slstm_cell.kernel import \
    slstm_stack_sequence_kernel as jseq
from repro.models import api as jax_api
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import slstm_jet
from repro_torch.configs.base import GRUConfig as TCfg
from repro_torch.configs.base import get_config
from repro_torch.core import cells, runtime
from repro_torch.core import slstm as tslstm
from repro_torch.core.params import init_params
from repro_torch.kernels.gru_sequence import kernel as K
from repro_torch.kernels.slstm_cell import kernel as SK
from repro_torch.kernels.slstm_cell import ops, ref
from repro_torch.launch import serve as cli
from repro_torch.models import api, slstm_lm
from repro_torch.serve.engine import Request, ServeEngine

T, B, X = 5, 3, 5
DIMS = ((8,), (16, 16), (8, 8, 8))
SLOTS = 3
# JAX backend name -> the port's
PORT_NAME = {"xla": "eager", "pallas_fused": "cuda_fused"}


def _all_kernels():
    return K.KERNELS + K.Q8_KERNELS + K.CHAIN_Q8_KERNELS + SK.SLSTM_KERNELS


def _no_launches():
    return all(k.launches == 0 for k in _all_kernels())


@pytest.fixture(autouse=True)
def _static_jax_costs():
    """JAX's runtime on its static cost table, whatever artifacts lie in
    the working directory."""
    jruntime.set_cost_model(jruntime.CostModel({}, source="<tests: static>"))
    yield


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _state(rng, dims, batch=B):
    """A flat mid-sequence state (n > 0) per layer, row 0 at the initial
    state (c = n = h = 0, m = M_INIT)."""
    out = []
    for d in dims:
        c, n = _f32(rng, batch, d, scale=0.5), np.abs(_f32(rng, batch, d)) + .5
        m, h = _f32(rng, batch, d), _f32(rng, batch, d, scale=0.5)
        c[0], n[0], m[0], h[0] = 0.0, 0.0, tslstm.M_INIT, 0.0
        out += [c, n, m, h]
    return tuple(out)


def _mask(rng, t=T, batch=B):
    """Ragged left padding; row 1 fully masked."""
    mask = np.zeros((batch, t), bool)
    for i in range(batch):
        mask[i, t - int(rng.integers(1, t + 1)):] = True
    mask[1] = False
    return mask


def _case(dims, seed):
    jc = JCfg(input_dim=X, layer_dims=dims, family="slstm")
    p = numpy_params({"cells": jslstm.slstm_stack_specs(jc)}, seed=seed)
    rng = np.random.default_rng(seed + 1)
    return dict(jc=jc, tc=TCfg(input_dim=X, layer_dims=dims, family="slstm"),
                p=p, jcells=to_jax(p)["cells"], tcells=to_torch(p)["cells"],
                xs=_f32(rng, B, T, X), x=_f32(rng, B, X), mask=_mask(rng),
                state=_state(rng, dims))


def _closes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w)


# ---------------------------------------------------------------------------
# (a) the eager core and the family registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", (8, 16))
def test_gate_math_matches_jax(H):
    rng = np.random.default_rng(H)
    c, n, m, h = _state(rng, (H,))
    xp, u = _f32(rng, B, 4 * H, scale=2.0), _f32(rng, H, 4 * H, scale=.5)
    b = _f32(rng, 4 * H, scale=0.3)
    args = (c, n, m, h, xp, u, b)
    got = tslstm.slstm_gate_math(*map(_t, args))
    _closes(got, jslstm.slstm_gate_math(*map(_j, args)))
    # the first step from M_INIT: the forget term is exactly 0
    assert torch.equal(got[1][0], torch.exp(got[2][0] - got[2][0]))


@pytest.mark.parametrize("dims,masked",
                         itertools.product(DIMS + ((16, 8),), (False, True)))
def test_eager_stack_matches_jax(dims, masked):
    c = _case(dims, seed=10 + len(dims))
    mask = c["mask"] if masked else None
    got_f, got_hs = tslstm.slstm_stack_sequence_eager(
        c["tcells"], tuple(map(_t, c["state"])), _t(c["xs"]), cfg=c["tc"],
        return_all=True, mask=_t(mask))
    jstate = tuple(map(_j, c["state"]))
    want_f, want_hs = jslstm.slstm_stack_sequence_xla(
        c["jcells"], jstate, _j(c["xs"]), cfg=c["jc"], return_all=True,
        mask=_j(mask))
    _closes(got_f + (got_hs,), want_f + (want_hs,))
    ref_f, ref_hs = jslstm.slstm_stack_reference(
        c["jcells"], jstate, _j(c["xs"]), return_all=True, mask=_j(mask))
    _closes(got_f + (got_hs,), ref_f + (ref_hs,))
    tref = tslstm.slstm_stack_reference(
        c["tcells"], tuple(map(_t, c["state"])), _t(c["xs"]),
        return_all=True, mask=_t(mask))
    _closes(tref[0] + (tref[1],), ref_f + (ref_hs,))
    if masked:                       # the fully masked row keeps its leaves
        for g, s in zip(got_f, c["state"]):
            assert torch.equal(g[1], _t(s)[1])
    got = tslstm.slstm_stack_decode_eager(
        c["tcells"], tuple(map(_t, c["state"])), _t(c["x"]), cfg=c["tc"])
    _closes(got, jslstm.slstm_stack_decode_xla(c["jcells"], jstate,
                                               _j(c["x"]), cfg=c["jc"]))


def test_family_registry_matches_jax():
    for name in ("gru", "slstm"):
        t, j = cells.get_family(name), jcells.get_family(name)
        assert (t.gates, t.state_leaves, t.state_names, t.h_leaf,
                t.supports_quant) == (j.gates, j.state_leaves, j.state_names,
                                      j.h_leaf, j.supports_quant)
    cfg = TCfg(input_dim=X, layer_dims=(8, 16), family="slstm")
    state = cells.get_family("slstm").init_state(cfg, B)
    want = jslstm.stack_state0(JCfg(input_dim=X, layer_dims=(8, 16),
                                    family="slstm"), B)
    assert len(state) == len(want) == 8
    for a, b in zip(state, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(cells.UnknownCellFamily):
        cells.get_family("convgru")


def test_config_matches_jax():
    t, j = get_config("slstm-jet"), jax_get_config("slstm-jet")
    assert (t.name, t.family, t.gru.family) == (j.name, j.family,
                                               j.gru.family)
    for f in ("input_dim", "hidden_dim", "num_classes", "num_layers",
              "matvec_mode", "fused_gates", "decoupled_wx"):
        assert getattr(t.gru, f) == getattr(j.gru, f), f
    assert t.gru.backend == "eager" and j.gru.backend == "xla"
    assert slstm_jet.SMOKE is slstm_jet.CONFIG
    wide = slstm_jet.scaled(hidden=48, input_dim=16)
    assert (wide.gru.hidden_dim, wide.gru.input_dim, wide.gru.family) == (
        48, 16, "slstm")


# ---------------------------------------------------------------------------
# (b) the plain kernel versions
# ---------------------------------------------------------------------------

def _raw(dims, seed):
    """The kernels' raw-array interface of one case: four (L,B,H) leaves,
    time-major x_proj, stacked weights, (T,B) float mask."""
    c = _case(dims, seed)
    st = ops.prepare_stacked_cells(c["tcells"])
    L = len(dims)
    leaves = tuple(np.stack([c["state"][4 * l + k] for l in range(L)])
                   for k in range(4))
    xp = np.ascontiguousarray(
        (c["xs"] @ c["p"]["cells"][0]["w"]).transpose(1, 0, 2))
    w = tuple(st[k].numpy() for k in ("u", "w_deep", "b"))
    return leaves, xp, w, np.ascontiguousarray(c["mask"].T, np.float32)


@pytest.mark.parametrize("dims,masked",
                         itertools.product(((8,), (16, 16, 16)),
                                           (False, True)))
def test_sequence_plain_matches_pallas_interpret(dims, masked):
    leaves, xp, w, mask = _raw(dims, seed=20 + len(dims))
    m = mask if masked else None
    args = (*leaves, xp, *w)
    got = ref.slstm_stack_sequence_ref(*map(_t, args), _t(m))
    _closes(got, jseq(*map(_j, args), _j(m), interpret=True))
    if not masked:                           # JAX's ref takes no mask
        _closes(got, jsref.slstm_stack_sequence_ref(*map(_j, args)))
    else:                                    # frozen row 1: bitwise
        for k in range(4):
            assert torch.equal(got[1 + k][:, 1], _t(leaves[k])[:, 1])
    # the wrapper takes the plain path for CPU tensors, launching nothing
    K.reset_launch_counts()
    wr = SK.slstm_stack_sequence_kernel(*map(_t, args), _t(m))
    assert all(torch.equal(a, b) for a, b in zip(wr, got)) and _no_launches()


@pytest.mark.parametrize("dims", ((8,), (16, 16, 16)))
def test_decode_plain_matches_ref_and_xla(dims):
    c = _case(dims, seed=30 + len(dims))
    leaves, _, w, _ = _raw(dims, seed=30 + len(dims))
    xp = c["x"] @ c["p"]["cells"][0]["w"]
    args = (*leaves, xp, *w)
    got = ref.slstm_stack_decode_ref(*map(_t, args))
    _closes(got, jsref.slstm_stack_decode_ref(*map(_j, args)))
    flat = jslstm.slstm_stack_decode_xla(c["jcells"],
                                         tuple(map(_j, c["state"])),
                                         _j(c["x"]), cfg=c["jc"])
    L = len(dims)
    _closes(got, tuple(np.stack([np.asarray(flat[4 * l + k])
                                 for l in range(L)]) for k in range(4)))
    K.reset_launch_counts()
    wr = SK.slstm_stack_decode_kernel(*map(_t, args), batch_block=2)
    assert all(torch.equal(a, b) for a, b in zip(wr, got)) and _no_launches()


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    leaves, xp, w, mask = _raw((8, 8), seed=3)
    lv, xp, (u, wd, b) = tuple(map(_t, leaves)), _t(xp), tuple(map(_t, w))
    with pytest.raises(TypeError):              # float64 leaf
        SK.slstm_stack_sequence_kernel(lv[0].double(), *lv[1:], xp, u, wd, b)
    with pytest.raises(ValueError):             # a GRU's 3H gate columns
        SK.slstm_stack_sequence_kernel(*lv, xp[..., :24], u, wd, b)
    with pytest.raises(ValueError):             # leaves of another batch
        SK.slstm_stack_sequence_kernel(lv[0][:, :2], *lv[1:], xp, u, wd, b)
    with pytest.raises(ValueError):             # non-contiguous state
        SK.slstm_stack_decode_kernel(
            *lv[:3], lv[3].transpose(1, 2).contiguous().transpose(1, 2),
            xp[0], u, wd, b)
    with pytest.raises(ValueError, match="tile"):
        SK.slstm_stack_decode_kernel(*lv, xp[0], u, wd, b, batch_block=257)
    with pytest.raises(ValueError):             # the mask is (T,B)
        SK.slstm_stack_sequence_kernel(*lv, xp, u, wd, b, _t(mask).T)
    with pytest.raises(ValueError, match="shared memory"):
        H = 128                                 # 256 KB of U alone
        z = torch.zeros(1, 1, H)
        SK.slstm_stack_decode_kernel(z, z, z, z, torch.zeros(1, 4 * H),
                                     torch.zeros(1, H, 4 * H),
                                     torch.zeros(1, 1, 4 * H),
                                     torch.zeros(1, 4 * H))


def test_smem_bytes_fit_the_served_shapes():
    """slstm-jet's block needs under the 48 KB default, the depth-3 H=32
    stack needs the opt-in above it (both far under 227 KB)."""
    assert SK.smem_bytes(1, 20, 4) < 48 * 1024
    assert 48 * 1024 < SK.smem_bytes(3, 32, 4) < 227 * 1024


# ---------------------------------------------------------------------------
# (c) dispatch parity, (d) prepare
# ---------------------------------------------------------------------------

PREFS = ((None, None), ("pallas", "cuda"), ("auto", "auto"),
         ("xla", "eager"), ("pallas_fused", "cuda_fused"),
         ("pallas_fused_q8", "cuda_fused_q8"),
         ("pallas_chain", "cuda_chain"))


@pytest.mark.parametrize("pref", PREFS, ids=lambda p: p[1] or "default")
@pytest.mark.parametrize("dims", ((), (8, 16)), ids=("uniform", "hetero"))
@pytest.mark.parametrize("masked", (False, True))
def test_dispatch_matches_jax_runtime(pref, dims, masked):
    jkw = {"backend": pref[0]} if pref[0] else {}
    tkw = {"backend": pref[1]} if pref[1] else {}
    shape = dict(input_dim=X, hidden_dim=8, num_layers=2, layer_dims=dims,
                 family="slstm")
    jexe = jruntime.compile(JCfg(**shape, **jkw), batch=B, mask=masked)
    texe = runtime.compile(TCfg(**shape, **tkw), batch=B, mask=masked)
    assert (texe.sequence_backend, texe.decode_backend) == (
        PORT_NAME[jexe.sequence_backend], PORT_NAME[jexe.decode_backend])


@pytest.mark.parametrize("backend,quant", (("cuda_fused_q8", ""),
                                           ("cuda", "int8")))
def test_prepare_builds_4h_stacks_once_and_no_int8_views(backend, quant):
    c = _case((8, 8, 8), seed=5)
    tc = dataclasses.replace(c["tc"], backend=backend, quant=quant)
    sp = runtime.prepare(to_torch(c["p"]), tc, device="cpu")
    assert sp.quant is None
    assert tuple(sp.stacked["u"].shape) == (3, 8, 32)
    assert tuple(sp.stacked["w_deep"].shape) == (2, 8, 32)
    assert tuple(sp.stacked["b"].shape) == (3, 32)
    assert torch.equal(sp.stacked["u"][1], c["tcells"][1]["u"])
    again = runtime.prepare(sp, tc, device="cpu")       # no restacking
    assert all(again.stacked[k] is v for k, v in sp.stacked.items())
    assert again.quant is None
    one = runtime.prepare(to_torch(_case((8,), seed=6)["p"]),
                          dataclasses.replace(tc, layer_dims=(8,)),
                          device="cpu")
    assert tuple(one.stacked["w_deep"].shape) == (1, 1, 32)
    # heterogeneous stacks get no fused stacks
    het = _case((16, 8), seed=7)
    assert runtime.prepare(to_torch(het["p"]), het["tc"],
                           device="cpu").stacked is None


# ---------------------------------------------------------------------------
# (e) the executors against JAX's xla executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims,backend",
                         list(itertools.product(DIMS, ("cuda_fused",
                                                       "eager")))
                         + [((16, 8), "eager")])
def test_executor_matches_jax_xla(dims, backend):
    c = _case(dims, seed=40 + len(dims))
    jexe = jruntime.compile(dataclasses.replace(c["jc"], backend="xla"),
                            batch=B, seq=T, mask=True)
    texe = runtime.compile(dataclasses.replace(c["tc"], backend=backend),
                           batch=B, seq=T, mask=True)
    assert jexe.sequence_backend == jexe.decode_backend == "xla"
    assert texe.sequence_backend == texe.decode_backend == backend
    sp = runtime.prepare(to_torch(c["p"]), texe.cfg, device="cpu")
    jstate, tstate = tuple(map(_j, c["state"])), tuple(map(_t, c["state"]))
    K.reset_launch_counts()
    got, want = [], []
    for exe, prm, st, cv, out in ((jexe, c["jcells"], jstate, _j, want),
                                  (texe, sp, tstate, _t, got)):
        finals, hs = exe.sequence(prm, st, cv(c["xs"]), return_all=True,
                                  mask=cv(c["mask"]))
        out += [*finals, hs, *exe.prefill(prm, st, cv(c["xs"])),
                *exe.decode(prm, st, cv(c["x"]))]
    assert len(got) == 12 * len(dims) + 1
    _closes(got, want)
    assert _no_launches()


# ---------------------------------------------------------------------------
# serving: (f) bitwise mask exactness, (g) class streams, (h) the CLI
# ---------------------------------------------------------------------------

CONFIGS = ("slstm-jet", "deep")


def _deep(gru):
    return dataclasses.replace(gru, num_layers=3, hidden_dim=32)


def _jax_cfg(name):
    cfg = jax_get_config("slstm-jet")
    return cfg if name == "slstm-jet" else dataclasses.replace(
        cfg, gru=_deep(cfg.gru))


def _port_cfg(name, backend):
    cfg = get_config("slstm-jet")
    gru = dataclasses.replace(cfg.gru, backend=backend)
    return cfg.replace(gru=gru if name == "slstm-jet" else _deep(gru))


@pytest.fixture(scope="module")
def params_np():
    out = {}
    for name in CONFIGS:
        cfg = _jax_cfg(name)
        out[name] = numpy_params(jax_api.get_api(cfg).specs(cfg), seed=19)
    return out


@pytest.mark.parametrize("backend", ("cuda_fused", "eager"))
@pytest.mark.parametrize("name", CONFIGS)
def test_masked_bucketed_prefill_equals_unpadded_bitwise(backend, name,
                                                         params_np):
    """Each prompt is compared at its slot in a batch of the engine's slot
    count (the CPU's elementwise kernels vectorize by position, so equal
    numbers need equal positions); within that, freezing a dead step must
    change nothing in any of the four leaves."""
    cfg = _port_cfg(name, backend)
    params = slstm_lm.prepare_params(to_torch(params_np[name]), cfg, "cpu")
    rng = np.random.default_rng(3)
    prompts = [_f32(rng, S, X) for S in (3, 5, 1, 7, 8)]
    slots = len(prompts) + 1
    eng = ServeEngine(cfg, params, max_batch=slots, device="cpu")
    feats, mask = eng._gru_prefill_batch(prompts, 8)
    blog, bcache = slstm_lm.prefill(params, cfg, {
        "features": torch.from_numpy(feats), "mask": torch.from_numpy(mask)})
    for i, p in enumerate(prompts):
        alone = np.zeros((slots,) + p.shape, np.float32)
        alone[i] = p
        ulog, ucache = slstm_lm.prefill(params, cfg,
                                        {"features": torch.from_numpy(alone)})
        assert torch.equal(blog[i], ulog[i])
        for hb, hu in zip(bcache["h"], ucache["h"]):
            assert torch.equal(hb[i], hu[i])
    # the fully masked slot keeps the initial state, m = M_INIT included
    init = slstm_lm.init_cache(cfg, slots, device="cpu")
    assert all(torch.equal(a[-1], b[-1])
               for a, b in zip(bcache["h"], init["h"]))


def _workload(seed=0, n=6):
    """Ragged prompts (1..8 vectors), mixed budgets, two requests with
    streamed decode features."""
    rng = np.random.default_rng(seed)
    return [(_f32(rng, int(rng.integers(1, 9)), X), int(rng.integers(2, 6)),
             _f32(rng, 4, X) if i % 3 == 0 else None) for i in range(n)]


@pytest.fixture(scope="module")
def jax_streams(params_np):
    out = {}
    for name in CONFIGS:
        jeng = JServeEngine(_jax_cfg(name), to_jax(params_np[name]),
                            ShardCtx(), max_batch=SLOTS)
        out[name] = [r.out for r in jeng.generate(
            [JRequest(prompt=p, max_new_tokens=n, stream=s)
             for p, n, s in _workload()])]
    return out


@pytest.mark.parametrize("backend", ("cuda", "cuda_fused", "eager"))
@pytest.mark.parametrize("name", CONFIGS)
def test_class_streams_equal_jax_engine(name, backend, params_np,
                                        jax_streams):
    K.reset_launch_counts()
    eng = ServeEngine(_port_cfg(name, backend), to_torch(params_np[name]),
                      max_batch=SLOTS, device="cpu")
    done = eng.generate([Request(prompt=p, max_new_tokens=n, stream=s)
                         for p, n, s in _workload()])
    assert [r.out for r in done] == jax_streams[name]
    want = "eager" if backend == "eager" else "cuda_fused"
    stats = eng.latency_stats()
    assert set(eng.prefill_backends) == {want}
    assert stats["decode_backend_steps"] == {want: stats["steps"]}
    assert stats["served_dtype"] == "float32" and stats["prefills"] >= 2
    # the cache is four leaves per layer, scattered leaf by leaf on admit
    assert len(eng.api.cache_specs(eng.cfg, SLOTS)["h"]) == \
        4 * eng.cfg.gru.resolved_num_layers
    assert _no_launches()            # CPU tensors: the plain versions ran


@pytest.mark.parametrize("name", CONFIGS)
def test_first_token_is_prefill_plus_one_refed_step(name, params_np):
    """The engine emits ``out[0]`` after one decode step that re-feeds the
    prompt's last vector (not the prefill's argmax): the dense JAX oracle
    over the prompt and then that vector once more gives the same class."""
    rng = np.random.default_rng(8)
    prompt = _f32(rng, 6, X)
    eng = ServeEngine(_port_cfg(name, "cuda"), to_torch(params_np[name]),
                      max_batch=2, device="cpu")
    out = eng.generate([Request(prompt=prompt, max_new_tokens=1)])[0].out
    jp = to_jax(params_np[name])
    jc = _jax_cfg(name).gru
    refed = np.concatenate([prompt, prompt[-1:]])[None]
    finals, _ = jslstm.slstm_stack_reference(
        jp["cells"], jslstm.stack_state0(jc, 1), jnp.asarray(refed))
    logits = finals[-1] @ jp["head"]["w"] + jp["head"]["b"]
    assert out == [int(jnp.argmax(logits[0]))]
    plog, _ = slstm_lm.prefill(eng.params, eng.cfg,
                               {"features": _t(prompt[None])})
    jlog = (jslstm.slstm_stack_reference(
        jp["cells"], jslstm.stack_state0(jc, 1),
        jnp.asarray(prompt[None]))[0][-1] @ jp["head"]["w"]
        + jp["head"]["b"])
    close(plog, jlog)


@pytest.mark.parametrize("name", CONFIGS)
def test_init_cache_starts_m_at_m_init(name):
    cfg = _port_cfg(name, "cuda")
    L = cfg.gru.resolved_num_layers
    cache = slstm_lm.init_cache(cfg, 3, device="cpu")
    assert len(cache["h"]) == 4 * L
    for l in range(L):
        c, n, m, h = cache["h"][4 * l:4 * l + 4]
        assert torch.all(m == tslstm.M_INIT)
        assert all(torch.count_nonzero(x) == 0 for x in (c, n, h))
    params = init_params(slstm_lm.lm_specs(cfg), seed=2, device="cpu")
    logits, nxt = slstm_lm.decode_step(params, cfg, cache, torch.zeros(3, X))
    assert logits.shape == (3, 5) and int(nxt["pos"]) == 1
    assert [tuple(s.shape) for s in nxt["h"]] == \
        [tuple(s.shape) for s in cache["h"]]
    logits_fw = slstm_lm.forward(params, cfg,
                                 {"features": torch.zeros(3, 4, X)})
    logits_pf, _ = slstm_lm.prefill(params, cfg,
                                    {"features": torch.zeros(3, 4, X)})
    assert torch.equal(logits_fw, logits_pf)


def test_unknown_family_still_raises():
    cfg = get_config("slstm-jet")
    bad = cfg.replace(family="convgru",
                      gru=dataclasses.replace(cfg.gru, family="convgru"))
    with pytest.raises(cells.UnknownCellFamily):
        api.get_api(bad)
    with pytest.raises(cells.UnknownCellFamily):
        ServeEngine(bad, {}, device="cpu")
    with pytest.raises(cells.UnknownCellFamily):
        runtime.compile(bad.gru, batch=2)


def test_cli_serves_slstm_jet_on_cpu(capsys):
    done = cli.main(["--arch", "slstm-jet", "--requests", "5", "--slots",
                     "2", "--vary-prompt", "--max-new", "3", "--gru-backend",
                     "cuda", "--device", "cpu", "--seed", "4"])
    assert [len(r.out) for r in done] == [3] * 5
    out = capsys.readouterr().out
    assert "decode latency (cpu)" in out and "float32)" in out
    assert "executor: prefill=cuda_fused decode=cuda_fused" in out


def test_cli_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card guard cannot fire")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--arch", "slstm-jet", "--gru-backend", "cuda"])
