"""The port's int8 (q8) datapath on the CPU: ``cuda_fused_q8`` and its
plain versions against the JAX package's q8 code.

* (a) weight quantization equal to JAX's bitwise;
* (b) the plain q8 stack sequence against JAX's interpret-mode
  ``gru_stack_sequence_q8_kernel`` and its ``*_q8_ref``;
* (c) the plain q8 decode against ``gru_stack_decode_q8_ref`` (the JAX
  q8 decode kernel does not run under this jax);
* (d) the ``cuda_fused_q8`` executor against ``tests/_q8.py``'s oracles;
* (e) the runtime's q8 rules (pin, gate, static costs, served dtype);
* (f) masked, bucketed q8 prefill equal to the unpadded prompt, bitwise;
* (g) served class streams equal to a loop built from JAX's q8 prefill and
  q8 decode oracle.

Tolerance rtol=atol=1e-5 (float32 across frameworks: the int8 sums are
exact on both sides, the float32 epilogues use different libm) unless a
test says bitwise. Inputs are made from numpy seeds.
"""
import dataclasses
import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _q8 import q8_stack_decode, q8_stack_finals
from _torch_parity import close, numpy_params, to_jax, to_torch
from repro.configs.base import GRUConfig as JCfg
from repro.configs.base import get_config as jax_get_config
from repro.core import gru as jgru
from repro.core.params import quantize_gru_cells as jquantize_gru_cells
from repro.core.params import quantize_rows_int8 as jquantize_rows_int8
from repro.kernels.gru_sequence import ref as jref
from repro.kernels.gru_sequence.kernel import (gru_stack_sequence_q8_kernel as
                                               jstack_q8)
from repro.models import api as jax_api
from repro.models import gru_lm as jax_gru_lm
from repro_torch.configs.base import GRUConfig as TCfg
from repro_torch.configs.base import get_config
from repro_torch.core import gru as tgru
from repro_torch.core import runtime
from repro_torch.core.params import quantize_gru_cells, quantize_rows_int8
from repro_torch.kernels.gru_cell.ref import Q8_EXACT_MAX_H
from repro_torch.kernels.gru_sequence import kernel as K
from repro_torch.kernels.gru_sequence import ref
from repro_torch.models import gru_lm
from repro_torch.serve.engine import Request, ServeEngine

T, B, H, X = 5, 3, 8, 5
ARCHS = ("gru-jet", "gru-jet-deep")


@pytest.fixture(autouse=True)
def _closed_gate():
    """Every test starts and ends with a closed accuracy gate, whatever
    artifact lies in the working directory."""
    closed = runtime.QuantAccuracy({}, source="<tests: closed>")
    runtime.set_quant_accuracy(closed)
    yield
    runtime.set_quant_accuracy(closed)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _q8_arrays(L, seed):
    """Float32 state, inputs and mask plus JAX-quantized int8 views."""
    rng = np.random.default_rng(seed)
    u = _f32(rng, L, H, 3 * H, scale=H ** -0.5)
    wd = _f32(rng, max(L - 1, 1), H, 3 * H, scale=H ** -0.5)
    cells = tuple({"w": jnp.asarray(wd[l - 1] if l else wd[0]),
                   "u": jnp.asarray(u[l]),
                   "b": jnp.asarray(_f32(rng, 3 * H, scale=0.3))}
                  for l in range(L))
    st = {k: np.asarray(v) for k, v in
          jquantize_gru_cells(cells).stacked.items()}
    return dict(h0=_f32(rng, L, B, H, scale=0.5), xp=_f32(rng, T, B, 3 * H),
                mask=(rng.random((T, B)) > 0.3).astype(np.float32), **st)


Q8_KEYS = ("u_q", "u_eff", "wd_q", "wd_eff", "b")


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# (a) weight quantization, bitwise
# ---------------------------------------------------------------------------

def _same_bits(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _halfway_rows():
    # scale 1: entries at exact halves round to even (0.5->0, 1.5->2,
    # 2.5->2, -0.5->-0, -2.5->-2); an all-zero column gets scale 1
    w = np.zeros((6, 3), np.float32)
    w[:, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    w[:, 1] = [-127.0, 3.5, -3.5, 126.5, 0.0, 1.0]
    return w


@pytest.mark.parametrize("case", ["normal", "scaled", "halfway", "zeros"])
def test_quantize_rows_int8_bitwise_equal_jax(case):
    rng = np.random.default_rng(0)
    w = {"normal": lambda: _f32(rng, 12, 24),
         "scaled": lambda: _f32(rng, 32, 96, scale=1e-3),
         "halfway": _halfway_rows,
         "zeros": lambda: np.zeros((4, 6), np.float32)}[case]()
    q, eff = quantize_rows_int8(torch.from_numpy(w))
    jq, jeff = jquantize_rows_int8(jnp.asarray(w))
    _same_bits(q, jq)
    _same_bits(eff, jeff)
    assert q.shape == (w.shape[1], w.shape[0]) and q.is_contiguous()


@pytest.mark.parametrize("dims", [(8,), (8, 8, 8), (16, 8)])
def test_quantize_gru_cells_bitwise_equal_jax(dims):
    jc = JCfg(input_dim=X, layer_dims=dims)
    p = numpy_params(jgru.gru_stack_specs(jc), seed=2)
    got = quantize_gru_cells(tgru.stack_cell_params(to_torch(p)))
    want = jquantize_gru_cells(jgru.stack_cell_params(to_jax(p), jc))
    assert len(got.cells) == len(want.cells) == len(dims)
    for g, w in zip(got.cells, want.cells):
        assert set(g) == set(w) == {"u_q", "u_eff"}
        for k in g:
            _same_bits(g[k], w[k])
    if want.stacked is None:                 # heterogeneous: no stack
        assert got.stacked is None
        return
    assert set(got.stacked) == set(want.stacked) == set(Q8_KEYS)
    for k in Q8_KEYS:
        _same_bits(got.stacked[k], want.stacked[k])
    if len(dims) == 1:                       # the L=1 placeholders
        assert tuple(got.stacked["wd_q"].shape) == (1, 3 * dims[0], 1)
        assert tuple(got.stacked["wd_eff"].shape) == (1, 3 * dims[0])


# ---------------------------------------------------------------------------
# (b), (c) the plain versions against JAX's q8 kernel and oracles
# ---------------------------------------------------------------------------

SEQ_CASES = list(itertools.product((1, 3), ("v1", "v3"), (False, True)))


@pytest.mark.parametrize("L,variant,masked", SEQ_CASES)
def test_stack_sequence_q8_plain_matches_jax(L, variant, masked):
    a = _q8_arrays(L, seed=10 * L + masked)
    m = a["mask"] if masked else None
    q = [a[k] for k in Q8_KEYS]
    got_hs, got_hT = ref.gru_stack_sequence_q8_ref(
        _t(a["h0"]), _t(a["xp"]), *map(_t, q), _t(m), variant)
    want_hs, want_hT = jstack_q8(_j(a["h0"]), _j(a["xp"]), *map(_j, q),
                                 _j(m), variant=variant, interpret=True)
    close(got_hs, want_hs)
    close(got_hT, want_hT)
    if not masked:                           # the JAX oracle takes no mask
        ref_hs, ref_hT = jref.gru_stack_sequence_q8_ref(
            _j(a["h0"]), _j(a["xp"]), *map(_j, q), variant=variant)
        close(got_hs, ref_hs)
        close(got_hT, ref_hT)
    # the wrapper takes the plain path for CPU tensors, launching nothing
    K.reset_launch_counts()
    w_hs, w_hT = K.gru_stack_sequence_q8_kernel(
        _t(a["h0"]), _t(a["xp"]), *map(_t, q), _t(m), variant=variant)
    assert torch.equal(w_hs, got_hs) and torch.equal(w_hT, got_hT)
    assert [k.launches for k in K.Q8_KERNELS] == [0, 0]


@pytest.mark.parametrize("L,variant", itertools.product((1, 3),
                                                        ("v1", "v3")))
def test_stack_decode_q8_plain_matches_jax_ref(L, variant):
    a = _q8_arrays(L, seed=20 + L)
    q = [a[k] for k in Q8_KEYS]
    got = ref.gru_stack_decode_q8_ref(_t(a["h0"]), _t(a["xp"][0]),
                                      *map(_t, q), variant)
    want = jref.gru_stack_decode_q8_ref(_j(a["h0"]), _j(a["xp"][0]),
                                        *map(_j, q), variant=variant)
    close(got, want)
    K.reset_launch_counts()
    w = K.gru_stack_decode_q8_kernel(_t(a["h0"]), _t(a["xp"][0]),
                                     *map(_t, q), variant=variant)
    assert torch.equal(w, got)
    assert [k.launches for k in K.Q8_KERNELS] == [0, 0]


def test_q8_plain_path_refuses_inexact_widths():
    L, Hbig = 1, Q8_EXACT_MAX_H + 1
    with pytest.raises(ValueError, match="exact"):
        K.gru_stack_decode_q8_kernel(
            torch.zeros(L, 1, Hbig), torch.zeros(1, 3 * Hbig),
            torch.zeros(L, 3 * Hbig, Hbig, dtype=torch.int8),
            torch.zeros(L, 3 * Hbig), torch.zeros(1, 3 * Hbig, 1,
                                                  dtype=torch.int8),
            torch.zeros(1, 3 * Hbig), torch.zeros(L, 3 * Hbig))


# ---------------------------------------------------------------------------
# (d) the cuda_fused_q8 executor against the executor-level q8 oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,variant", itertools.product((1, 3),
                                                        ("v1", "v3")))
def test_cuda_fused_q8_executor_matches_q8_oracles(L, variant):
    jc = JCfg(input_dim=X, hidden_dim=H, num_layers=L, variant=variant)
    p = numpy_params(jgru.gru_stack_specs(jc), seed=30 + L)
    jcells = jgru.stack_cell_params(to_jax(p), jc)
    rng = np.random.default_rng(31)
    xs = _f32(rng, B, T, X)
    h0s = tuple(_f32(rng, B, H, scale=0.5) for _ in range(L))
    x = _f32(rng, B, X)
    tc = TCfg(input_dim=X, hidden_dim=H, num_layers=L, variant=variant,
              backend="cuda_fused_q8")
    exe = runtime.compile(tc, batch=B, seq=T)
    assert exe.sequence_backend == exe.decode_backend == "cuda_fused_q8"
    sp = runtime.prepare(to_torch(p), tc, device="cpu")
    assert sp.quant is not None and sp.quant.stacked is not None
    finals = exe.prefill(sp, tuple(map(_t, h0s)), _t(xs))
    want = q8_stack_finals("pallas_fused_q8", jcells, tuple(map(_j, h0s)),
                           _j(xs), jc)
    for g, w in zip(finals, want):
        close(g, w)
    dec = exe.decode(sp, tuple(map(_t, h0s)), _t(x))
    want = q8_stack_decode("pallas_fused_q8", jcells, tuple(map(_j, h0s)),
                           _j(x), jc)
    for g, w in zip(dec, want):
        close(g, w)
    # raw params (no prepare) quantize on the way and agree bitwise
    raw = exe.decode(to_torch(p), tuple(map(_t, h0s)), _t(x))
    assert all(torch.equal(a, b) for a, b in zip(raw, dec))


# ---------------------------------------------------------------------------
# (e) the runtime's q8 rules
# ---------------------------------------------------------------------------

def _open_gate():
    runtime.set_quant_accuracy(runtime.QuantAccuracy(
        {"bench": "gru_quant_accuracy", "passed": True}, source="<t>"))


def _backends(**kw):
    exe = runtime.compile(TCfg(input_dim=X, hidden_dim=H, num_layers=2, **kw),
                          batch=B, mask=True)
    return exe.sequence_backend, exe.decode_backend


def test_exact_pin_bypasses_the_gate():
    runtime.set_quant_accuracy(runtime.QuantAccuracy(
        {"bench": "gru_quant_accuracy", "passed": False}, source="<f>"))
    assert not runtime.quant_gate_open()
    assert _backends(backend="cuda_fused_q8") == ("cuda_fused_q8",) * 2
    # heterogeneous dims: the fused q8 kernels cannot serve, fall through
    # to the float32 chain (JAX: pallas_chain; the q8 chain needs its own
    # pin or an open gate)
    exe = runtime.compile(TCfg(input_dim=X, layer_dims=(8, 16),
                               backend="cuda_fused_q8"), batch=B)
    assert exe.decode_backend == "cuda_chain"


@pytest.mark.parametrize("pref", ("auto", "cuda", "eager"))
def test_quant_flag_without_open_gate_never_runs_q8(pref):
    assert not _backends(backend=pref, quant="int8")[0].endswith("_q8")
    assert not _backends(backend=pref, quant="int8")[1].endswith("_q8")
    # an open gate makes q8 a candidate, but the static costs (150) keep
    # every preference on its float32 choice
    _open_gate()
    want = {"auto": "cuda_fused", "cuda": "cuda_fused", "eager": "eager"}
    assert _backends(backend=pref, quant="int8") == (want[pref],) * 2
    assert _backends(backend=pref) == (want[pref],) * 2


def test_gate_loads_from_disk_and_flips_drop_executables(tmp_path):
    cfg = TCfg(input_dim=X, hidden_dim=H, num_layers=2, backend="auto",
               quant="int8")
    before = runtime.compile(cfg, batch=B)
    assert runtime.compile(cfg, batch=B) is before
    good = tmp_path / "BENCH_quant_accuracy.json"
    good.write_text(json.dumps({"bench": "gru_quant_accuracy",
                                "passed": True, "backends": {}}))
    assert runtime.load_quant_accuracy(good).passed
    assert runtime.quant_gate_open()
    assert runtime.compile(cfg, batch=B) is not before
    for text in (json.dumps({"bench": "gru_decode_step_latency"}),
                 json.dumps({"bench": "gru_quant_accuracy", "passed": False}),
                 "{not json", "[1, 2]"):
        bad = tmp_path / "bad.json"
        bad.write_text(text)
        assert not runtime.load_quant_accuracy(bad).passed
        assert not runtime.quant_gate_open()
    assert not runtime.load_quant_accuracy(tmp_path / "missing.json").passed


def test_backend_dtype_and_prepare_builds_quant_views_only_when_asked():
    assert runtime.backend_dtype("cuda_fused_q8") == "int8"
    assert runtime.backend_dtype("cuda_fused") == "float32"
    assert runtime.backend_dtype(None) == "float32"
    jc = JCfg(input_dim=X, hidden_dim=H, num_layers=2)
    p = to_torch(numpy_params(jgru.gru_stack_specs(jc), seed=4))
    base = TCfg(input_dim=X, hidden_dim=H, num_layers=2)
    assert runtime.prepare(p, base, device="cpu").quant is None
    for kw in ({"quant": "int8"}, {"backend": "cuda_fused_q8"}):
        sp = runtime.prepare(p, dataclasses.replace(base, **kw),
                             device="cpu")
        assert sp.quant.stacked["u_q"].dtype == torch.int8
        # prepared once: a second prepare reuses the same views
        again = runtime.prepare(
            {"cells": sp.cells, "quant_cells": sp.quant},
            dataclasses.replace(base, **kw), device="cpu")
        assert again.quant.stacked["u_q"] is sp.quant.stacked["u_q"]


# ---------------------------------------------------------------------------
# serving: (f) bitwise mask exactness, (g) class streams against JAX
# ---------------------------------------------------------------------------

def _q8_cfg(cfg, backend):
    return cfg.replace(gru=dataclasses.replace(cfg.gru, backend=backend))


@pytest.fixture(scope="module")
def params_np():
    return {a: numpy_params(jax_api.get_api(jax_get_config(a)).specs(
        jax_get_config(a)), seed=13) for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_bucketed_q8_prefill_equals_unpadded_bitwise(arch, params_np):
    """Each prompt is compared at its slot in a batch of the engine's slot
    count: the CPU's elementwise kernels vectorize by position, so equal
    numbers need equal positions; within that, freezing a dead step must
    change nothing."""
    cfg = _q8_cfg(get_config(arch), "cuda_fused_q8")
    params = gru_lm.prepare_params(to_torch(params_np[arch]), cfg, "cpu")
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
    # the fully masked slot keeps the zero state
    assert all(torch.count_nonzero(h[-1]) == 0 for h in bcache["h"])


def _workload(seed=0, n=6):
    """Ragged prompts (1..8 vectors), mixed budgets, two requests with
    streamed decode features."""
    rng = np.random.default_rng(seed)
    return [(_f32(rng, int(rng.integers(1, 9)), X), int(rng.integers(2, 6)),
             _f32(rng, 4, X) if i % 3 == 0 else None) for i in range(n)]


def _jax_q8_stream(arch, params, prompt, n, stream):
    """One request's classes: JAX's prefill at the pallas_fused_q8 pin
    (interpret mode), then per step ``gru_stack_decode_q8_ref`` and the
    head, feeding the stream or else the last prompt vector."""
    cfg = jax_get_config(arch)
    cfg = dataclasses.replace(cfg, gru=dataclasses.replace(
        cfg.gru, backend="pallas_fused_q8"))
    jp = to_jax(params)
    _, cache = jax_gru_lm.prefill(jp, cfg, {"features": _j(prompt[None])})
    cells = jgru.stack_cell_params(jp, cfg.gru)
    st = jquantize_gru_cells(cells).stacked
    h = jnp.stack(cache["h"], 0)
    out = []
    for s in range(n):
        x = stream[s] if stream is not None and s < len(stream) else prompt[-1]
        h = jref.gru_stack_decode_q8_ref(
            h, _j(x[None]) @ cells[0]["w"], *(st[k] for k in Q8_KEYS),
            variant=cfg.gru.variant)
        logits = h[-1] @ jp["head"]["w"] + jp["head"]["b"]
        out.append(int(jnp.argmax(logits[0])))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_q8_class_streams_equal_jax_q8_loop(arch, params_np):
    work = _workload()
    want = [_jax_q8_stream(arch, params_np[arch], p, n, s)
            for p, n, s in work]
    cfg = _q8_cfg(get_config(arch), "cuda_fused_q8")
    K.reset_launch_counts()
    eng = ServeEngine(cfg, to_torch(params_np[arch]), max_batch=3,
                      device="cpu")
    done = eng.generate([Request(prompt=p, max_new_tokens=n, stream=s)
                         for p, n, s in work])
    assert [r.out for r in done] == want
    stats = eng.latency_stats()
    assert set(eng.prefill_backends) == {"cuda_fused_q8"}
    assert stats["decode_backend_steps"] == {"cuda_fused_q8": stats["steps"]}
    assert stats["served_dtype"] == "int8"
    assert "quant_cells" in eng.params
    # on CPU tensors the wrappers ran their plain versions
    assert [k.launches for k in K.KERNELS + K.Q8_KERNELS] == [0] * 5
