"""The port's per-layer chains on the CPU: ``cuda_chain`` (the depth-1 fp32
sequence kernel per layer) and ``cuda_chain_q8`` (the depth-1 q8 sequence
kernel and the q8 step kernel per layer), against the JAX package.

* (a) dispatch: for the same configs both runtimes pick the same backend
  (JAX names mapped to the port's);
* (b) the plain ``gru_sequence_q8_ref`` against JAX's interpret-mode
  ``gru_sequence_q8_kernel`` and its ``gru_sequence_q8_ref``, and the
  single-layer entry ``gru_sequence_cuda_q8`` against JAX's
  ``gru_sequence_pallas_q8``; the plain
  ``gru_step_q8_ref`` against JAX's interpret-mode ``gru_step_q8`` and
  ``gru_cell/ref.py``'s ``gru_step_q8_ref``;
* (c) the ``cuda_chain`` executor against JAX's ``pallas_chain`` executor
  (sequence, masked, ``return_all``, decode);
* (d) the ``cuda_chain_q8`` executor against ``tests/_q8.py``'s
  ``pallas_chain_q8`` oracles and JAX's ``pallas_chain_q8`` executor;
* (e) masked, bucketed chain prefill equal to the unpadded prompt,
  bitwise, both chains;
* (f) served class streams: ``cuda_chain`` equal to JAX's ``ServeEngine``,
  ``cuda_chain_q8`` equal to a loop of JAX's q8 chain prefill and
  ``pallas_chain_q8`` decode oracle; no kernel launches on the CPU;
* (g) the CLI with ``--gru-backend cuda_chain_q8``.

Sizes: H <= 16, B=3, T=5, dims (16,), (8, 8, 8) and (16, 8) for the stack
tests; the served configs at their own widths, plus gru-jet-deep with
``layer_dims=(32, 32, 20)``. Tolerance rtol=atol=1e-5 across frameworks
(different summation orders and libm), bitwise inside the port. Inputs
are made from numpy seeds.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _q8 import q8_stack_decode, q8_stack_finals
from _torch_parity import close, numpy_params, to_jax, to_torch
from repro.configs.base import GRUConfig as JCfg
from repro.configs.base import get_config as jax_get_config
from repro.core import gru as jgru
from repro.core import runtime as jruntime
from repro.core.params import quantize_gru_cells as jquantize_gru_cells
from repro.distributed.sharding import ShardCtx
from repro.kernels.gru_cell import ref as jcref
from repro.kernels.gru_cell.kernel import gru_step_q8 as jstep_q8
from repro.kernels.gru_sequence import ops as jops
from repro.kernels.gru_sequence import ref as jref
from repro.kernels.gru_sequence.kernel import gru_sequence_q8_kernel as jseq_q8
from repro.models import api as jax_api
from repro.models import gru_lm as jax_gru_lm
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import GRUConfig as TCfg
from repro_torch.configs.base import get_config
from repro_torch.core import runtime
from repro_torch.kernels.gru_cell import kernel as CK
from repro_torch.kernels.gru_cell import ref as cref
from repro_torch.kernels.gru_sequence import kernel as K
from repro_torch.kernels.gru_sequence import ops, ref
from repro_torch.launch import serve as cli
from repro_torch.models import gru_lm
from repro_torch.serve.engine import Request, ServeEngine

T, B, X = 5, 3, 5
DIMS = ((16,), (8, 8, 8), (16, 8))
VARIANTS = ("v1", "v3")
HETERO = (32, 32, 20)
SLOTS = 3
# JAX backend name -> the port's
PORT_NAME = {"xla": "eager", "pallas_fused": "cuda_fused",
             "pallas_chain": "cuda_chain", "pallas_fused_q8": "cuda_fused_q8",
             "pallas_chain_q8": "cuda_chain_q8"}


def _all_kernels():
    return K.KERNELS + K.Q8_KERNELS + K.CHAIN_Q8_KERNELS


def _no_launches():
    return all(k.launches == 0 for k in _all_kernels())


@pytest.fixture(autouse=True)
def _static_closed_runtimes():
    """Both runtimes on the static cost table with a closed accuracy gate,
    whatever artifacts lie in the working directory."""
    jruntime.set_cost_model(jruntime.CostModel({}, source="<tests: static>"))
    jruntime.set_quant_accuracy(jruntime.QuantAccuracy(
        {}, source="<tests: closed>"))
    closed = runtime.QuantAccuracy({}, source="<tests: closed>")
    runtime.set_quant_accuracy(closed)
    yield
    runtime.set_quant_accuracy(closed)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# (a) dispatch parity with the JAX runtime
# ---------------------------------------------------------------------------

PREFS = ((None, None), ("pallas", "cuda"), ("auto", "auto"),
         ("xla", "eager"), ("pallas_fused", "cuda_fused"),
         ("pallas_chain", "cuda_chain"), ("pallas_fused_q8", "cuda_fused_q8"),
         ("pallas_chain_q8", "cuda_chain_q8"))


@pytest.mark.parametrize("pref", PREFS, ids=lambda p: p[1] or "default")
@pytest.mark.parametrize("dims", ((), (8, 16)), ids=("uniform", "hetero"))
@pytest.mark.parametrize("quant", ("", "int8"))
@pytest.mark.parametrize("masked", (False, True))
def test_dispatch_matches_jax_runtime(pref, dims, quant, masked):
    jkw = {"backend": pref[0]} if pref[0] else {}
    tkw = {"backend": pref[1]} if pref[1] else {}
    shape = dict(input_dim=X, hidden_dim=8, num_layers=2, layer_dims=dims,
                 quant=quant)
    jexe = jruntime.compile(JCfg(**shape, **jkw), batch=B, mask=masked)
    texe = runtime.compile(TCfg(**shape, **tkw), batch=B, mask=masked)
    assert (texe.sequence_backend, texe.decode_backend) == (
        PORT_NAME[jexe.sequence_backend], PORT_NAME[jexe.decode_backend])


# ---------------------------------------------------------------------------
# (b) the plain q8 chain kernels against JAX's
# ---------------------------------------------------------------------------

def _q8_layer(H, seed):
    """One layer: float32 state, inputs and mask plus JAX-quantized int8
    rows of a random U."""
    rng = np.random.default_rng(seed)
    cell = {"w": jnp.asarray(_f32(rng, H, 3 * H, scale=H ** -0.5)),
            "u": jnp.asarray(_f32(rng, H, 3 * H, scale=H ** -0.5)),
            "b": jnp.asarray(_f32(rng, 3 * H, scale=0.3))}
    q = jquantize_gru_cells((cell,)).cells[0]
    return dict(h0=_f32(rng, B, H, scale=0.5), xp=_f32(rng, T, B, 3 * H),
                u_q=np.asarray(q["u_q"]), u_eff=np.asarray(q["u_eff"]),
                b=np.asarray(cell["b"]),
                mask=(rng.random((T, B)) > 0.3).astype(np.float32))


ARGS = ("h0", "xp", "u_q", "u_eff", "b")


@pytest.mark.parametrize("H,variant,masked",
                         itertools.product((8, 16), VARIANTS, (False, True)))
def test_sequence_q8_plain_matches_jax(H, variant, masked):
    a = _q8_layer(H, seed=H)
    m = a["mask"] if masked else None
    args = [a[k] for k in ARGS]
    got = ref.gru_sequence_q8_ref(*map(_t, args), _t(m), variant)
    close(got, jseq_q8(*map(_j, args), _j(m), variant=variant,
                       interpret=True))
    if not masked:                           # the JAX oracle takes no mask
        close(got, jref.gru_sequence_q8_ref(*map(_j, args), variant=variant))
    # the wrapper takes the plain path for CPU tensors, launching nothing
    K.reset_launch_counts()
    w = K.gru_sequence_q8_kernel(*map(_t, args), _t(m), variant=variant)
    assert torch.equal(w, got) and _no_launches()


@pytest.mark.parametrize("H,variant", itertools.product((8, 16), VARIANTS))
def test_step_q8_plain_matches_jax(H, variant):
    a = _q8_layer(H, seed=20 + H)
    args = [a["h0"], a["xp"][0], a["u_q"], a["u_eff"], a["b"]]
    got = cref.gru_step_q8_ref(*map(_t, args), variant)
    close(got, jstep_q8(*map(_j, args), variant=variant, interpret=True))
    close(got, jcref.gru_step_q8_ref(*map(_j, args), variant=variant))
    K.reset_launch_counts()
    w = CK.gru_step_q8(*map(_t, args), variant=variant)
    assert torch.equal(w, got) and _no_launches()


@pytest.mark.parametrize("variant,masked",
                         itertools.product(VARIANTS, (False, True)))
def test_single_layer_q8_entry_matches_jax(variant, masked):
    """``gru_sequence_cuda_q8`` (one q8 cell over (B,T,X) features) against
    JAX's ``gru_sequence_pallas_q8`` in interpret mode."""
    rng = np.random.default_rng(7)
    jc = JCfg(input_dim=X, hidden_dim=16, variant=variant)
    cell = numpy_params(jgru.gru_stack_specs(jc), seed=8)[0]
    jcell = to_jax(cell)
    q = jquantize_gru_cells((jcell,)).cells[0]
    xs, h0 = _f32(rng, B, T, X), _f32(rng, B, 16, scale=0.5)
    mask = rng.random((B, T)) > 0.3 if masked else None
    want = jops.gru_sequence_pallas_q8(jcell, q, _j(h0), _j(xs), cfg=jc,
                                       return_all=True, mask=_j(mask))
    got = ops.gru_sequence_cuda_q8(
        to_torch(cell), {k: _t(v) for k, v in q.items()}, _t(h0), _t(xs),
        cfg=TCfg(input_dim=X, hidden_dim=16, variant=variant),
        return_all=True, mask=_t(mask))
    close(got[0], want[0])
    close(got[1], want[1])


def test_chain_q8_wrappers_raise_on_what_the_kernels_do_not_take():
    a = {k: _t(v) for k, v in _q8_layer(8, seed=1).items()}
    args = [a[k] for k in ARGS]
    with pytest.raises(TypeError):              # float weight rows
        K.gru_sequence_q8_kernel(args[0], args[1], args[2].float(),
                                 *args[3:])
    with pytest.raises(ValueError):             # stacked (L,3H,H) rows
        K.gru_sequence_q8_kernel(args[0], args[1], args[2][None], *args[3:])
    with pytest.raises(ValueError):             # unknown variant
        CK.gru_step_q8(args[0], args[1][0], *args[2:], variant="v2")
    with pytest.raises(ValueError):             # a non-contiguous state
        CK.gru_step_q8(args[0].t().contiguous().t(), args[1][0], *args[2:])
    with pytest.raises(ValueError, match="exact"):
        Hbig = cref.Q8_EXACT_MAX_H + 1
        CK.gru_step_q8(torch.zeros(1, Hbig), torch.zeros(1, 3 * Hbig),
                       torch.zeros(3 * Hbig, Hbig, dtype=torch.int8),
                       torch.zeros(3 * Hbig), torch.zeros(3 * Hbig))


def test_batch_tile_takes_at_most_one_row_per_thread():
    """Each of a block's first ``tile`` threads writes its row's liveness,
    so every wrapper refuses a tile wider than the block (256 threads)."""
    h, xp = torch.zeros(1, 300, 2), torch.zeros(300, 6)
    u, wd, b = torch.zeros(1, 2, 6), torch.zeros(1, 1, 6), torch.zeros(1, 6)
    assert K.gru_stack_decode_kernel(h, xp, u, wd, b,
                                     batch_block=256).shape == (1, 300, 2)
    with pytest.raises(ValueError, match="tile"):
        K.gru_stack_decode_kernel(h, xp, u, wd, b, batch_block=257)


# ---------------------------------------------------------------------------
# (c), (d) the chain executors against JAX's chain executor and oracles
# ---------------------------------------------------------------------------

def _stack_case(dims, variant, seed):
    jc = JCfg(input_dim=X, layer_dims=dims, variant=variant)
    p = numpy_params(jgru.gru_stack_specs(jc), seed=seed)
    rng = np.random.default_rng(seed + 1)
    return dict(jc=jc, p=p, jcells=jgru.stack_cell_params(to_jax(p), jc),
                xs=_f32(rng, B, T, X), x=_f32(rng, B, X),
                mask=rng.random((B, T)) > 0.3,
                h0s=tuple(_f32(rng, B, d, scale=0.5) for d in dims))


def _run_both(jexe, texe, jparams, tparams, c):
    """Masked ``return_all`` sequence, unmasked finals and one decode step
    from the same states, through a JAX and a port executable."""
    jh0, th0 = tuple(map(_j, c["h0s"])), tuple(map(_t, c["h0s"]))
    out = []
    for exe, prm, h0, cv in ((jexe, jparams, jh0, _j),
                             (texe, tparams, th0, _t)):
        finals, hs = exe.sequence(prm, h0, cv(c["xs"]), return_all=True,
                                  mask=cv(c["mask"]))
        plain = exe.prefill(prm, h0, cv(c["xs"]))
        out.append((*finals, hs, *plain, *exe.decode(prm, h0, cv(c["x"]))))
    return out


@pytest.mark.parametrize("dims,variant", itertools.product(DIMS, VARIANTS))
def test_cuda_chain_matches_jax_pallas_chain(dims, variant):
    c = _stack_case(dims, variant, seed=40 + len(dims))
    jexe = jruntime.compile(dataclasses.replace(c["jc"],
                                                backend="pallas_chain"),
                            batch=B, seq=T, mask=True)
    tc = TCfg(input_dim=X, layer_dims=dims, variant=variant,
              backend="cuda_chain")
    texe = runtime.compile(tc, batch=B, seq=T, mask=True)
    assert jexe.sequence_backend == jexe.decode_backend == "pallas_chain"
    assert texe.sequence_backend == texe.decode_backend == "cuda_chain"
    K.reset_launch_counts()
    want, got = _run_both(jexe, texe, c["jcells"], to_torch(c["p"]), c)
    assert len(got) == len(want) == 3 * len(dims) + 1
    for g, w in zip(got, want):
        close(g, w)
    assert _no_launches()


@pytest.mark.parametrize("dims,variant", itertools.product(DIMS, VARIANTS))
def test_cuda_chain_q8_matches_q8_oracles(dims, variant):
    c = _stack_case(dims, variant, seed=50 + len(dims))
    tc = TCfg(input_dim=X, layer_dims=dims, variant=variant,
              backend="cuda_chain_q8")
    exe = runtime.compile(tc, batch=B, seq=T, mask=True)
    assert exe.sequence_backend == exe.decode_backend == "cuda_chain_q8"
    sp = runtime.prepare(to_torch(c["p"]), tc, device="cpu")
    assert len(sp.quant.cells) == len(dims)
    assert (sp.quant.stacked is None) == (len(set(dims)) > 1)
    K.reset_launch_counts()
    jh0, th0 = tuple(map(_j, c["h0s"])), tuple(map(_t, c["h0s"]))
    for g, w in zip(exe.prefill(sp, th0, _t(c["xs"])),
                    q8_stack_finals("pallas_chain_q8", c["jcells"], jh0,
                                    _j(c["xs"]), c["jc"])):
        close(g, w)
    dec = exe.decode(sp, th0, _t(c["x"]))
    for g, w in zip(dec, q8_stack_decode("pallas_chain_q8", c["jcells"], jh0,
                                         _j(c["x"]), c["jc"])):
        close(g, w)
    # masked, return_all: against JAX's own pallas_chain_q8 executor
    jexe = jruntime.compile(dataclasses.replace(c["jc"],
                                                backend="pallas_chain_q8"),
                            batch=B, seq=T, mask=True)
    assert jexe.sequence_backend == jexe.decode_backend == "pallas_chain_q8"
    want, got = _run_both(jexe, exe, c["jcells"], sp, c)
    for g, w in zip(got, want):
        close(g, w)
    assert _no_launches()
    # raw params (no prepare) quantize on the way and agree bitwise
    raw = exe.decode(to_torch(c["p"]), th0, _t(c["x"]))
    assert all(torch.equal(a, b) for a, b in zip(raw, dec))


# ---------------------------------------------------------------------------
# serving: (e) bitwise mask exactness, (f) class streams, (g) the CLI
# ---------------------------------------------------------------------------

CONFIGS = ("gru-jet", "gru-jet-deep", "hetero")


def _jax_cfg(name, backend=None):
    cfg = jax_get_config("gru-jet-deep" if name == "hetero" else name)
    gru = cfg.gru
    if name == "hetero":
        gru = dataclasses.replace(gru, layer_dims=HETERO)
    if backend:
        gru = dataclasses.replace(gru, backend=backend)
    return dataclasses.replace(cfg, gru=gru)


def _port_cfg(name, backend):
    cfg = get_config("gru-jet-deep" if name == "hetero" else name)
    gru = dataclasses.replace(cfg.gru, backend=backend)
    if name == "hetero":
        gru = dataclasses.replace(gru, layer_dims=HETERO)
    return cfg.replace(gru=gru)


@pytest.fixture(scope="module")
def params_np():
    out = {}
    for name in CONFIGS:
        cfg = _jax_cfg(name)
        out[name] = numpy_params(jax_api.get_api(cfg).specs(cfg), seed=17)
    return out


@pytest.mark.parametrize("backend", ("cuda_chain", "cuda_chain_q8"))
@pytest.mark.parametrize("name", ("gru-jet-deep", "hetero"))
def test_masked_bucketed_chain_prefill_equals_unpadded_bitwise(
        backend, name, params_np):
    """Each prompt is compared at its slot in a batch of the engine's slot
    count (the CPU's elementwise kernels vectorize by position, so equal
    numbers need equal positions); within that, freezing a dead step must
    change nothing, in every layer of the chain."""
    cfg = _port_cfg(name, backend)
    params = gru_lm.prepare_params(to_torch(params_np[name]), cfg, "cpu")
    rng = np.random.default_rng(3)
    prompts = [_f32(rng, S, X) for S in (3, 5, 1, 7, 8)]
    slots = len(prompts) + 1
    eng = ServeEngine(cfg, params, max_batch=slots, device="cpu")
    feats, mask = eng._gru_prefill_batch(prompts, 8)
    blog, bcache = gru_lm.prefill(params, cfg, {
        "features": torch.from_numpy(feats), "mask": torch.from_numpy(mask)})
    for i, p in enumerate(prompts):
        alone = np.zeros((slots,) + p.shape, np.float32)
        alone[i] = p
        ulog, ucache = gru_lm.prefill(params, cfg,
                                      {"features": torch.from_numpy(alone)})
        assert torch.equal(blog[i], ulog[i])
        for hb, hu in zip(bcache["h"], ucache["h"]):
            assert torch.equal(hb[i], hu[i])
    # the fully masked slot keeps the zero state in every layer
    assert all(torch.count_nonzero(h[-1]) == 0 for h in bcache["h"])


def _workload(seed=0, n=6):
    """Ragged prompts (1..8 vectors), mixed budgets, two requests with
    streamed decode features."""
    rng = np.random.default_rng(seed)
    return [(_f32(rng, int(rng.integers(1, 9)), X), int(rng.integers(2, 6)),
             _f32(rng, 4, X) if i % 3 == 0 else None) for i in range(n)]


def _serve_port(name, backend, params):
    K.reset_launch_counts()
    eng = ServeEngine(_port_cfg(name, backend), to_torch(params),
                      max_batch=SLOTS, device="cpu")
    done = eng.generate([Request(prompt=p, max_new_tokens=n, stream=s)
                         for p, n, s in _workload()])
    stats = eng.latency_stats()
    assert set(eng.prefill_backends) == {backend}
    assert stats["decode_backend_steps"] == {backend: stats["steps"]}
    # on CPU tensors the wrappers ran their plain versions
    assert _no_launches()
    return [r.out for r in done], stats


@pytest.mark.parametrize("name", CONFIGS)
def test_cuda_chain_class_streams_equal_jax_engine(name, params_np):
    jeng = JServeEngine(_jax_cfg(name), to_jax(params_np[name]), ShardCtx(),
                        max_batch=SLOTS)
    want = [r.out for r in jeng.generate(
        [JRequest(prompt=p, max_new_tokens=n, stream=s)
         for p, n, s in _workload()])]
    got, stats = _serve_port(name, "cuda_chain", params_np[name])
    assert got == want
    assert stats["served_dtype"] == "float32"


def _jax_q8_chain_stream(name, params, prompt, n, stream):
    """One request's classes: JAX's prefill at the pallas_chain_q8 pin
    (interpret mode), then per step the ``pallas_chain_q8`` decode oracle
    of ``tests/_q8.py`` and the head, feeding the stream or else the last
    prompt vector."""
    cfg = _jax_cfg(name, "pallas_chain_q8")
    jp = to_jax(params)
    _, cache = jax_gru_lm.prefill(jp, cfg, {"features": _j(prompt[None])})
    cells = jgru.stack_cell_params(jp, cfg.gru)
    hs, out = tuple(cache["h"]), []
    for s in range(n):
        x = stream[s] if stream is not None and s < len(stream) else prompt[-1]
        hs = q8_stack_decode("pallas_chain_q8", cells, hs, _j(x[None]),
                             cfg.gru)
        logits = hs[-1] @ jp["head"]["w"] + jp["head"]["b"]
        out.append(int(jnp.argmax(logits[0])))
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_cuda_chain_q8_class_streams_equal_jax_q8_loop(name, params_np):
    want = [_jax_q8_chain_stream(name, params_np[name], p, n, s)
            for p, n, s in _workload()]
    got, stats = _serve_port(name, "cuda_chain_q8", params_np[name])
    assert got == want
    assert stats["served_dtype"] == "int8"


def test_cli_serves_the_q8_chain_on_cpu(capsys):
    done = cli.main(["--arch", "gru-jet-deep", "--requests", "4", "--slots",
                     "2", "--vary-prompt", "--max-new", "3", "--gru-backend",
                     "cuda_chain_q8", "--device", "cpu", "--seed", "5"])
    assert [len(r.out) for r in done] == [3] * 4
    out = capsys.readouterr().out
    assert "steps, int8)" in out
    assert "executor: prefill=cuda_chain_q8 decode=cuda_chain_q8" in out
