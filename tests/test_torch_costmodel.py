"""The port's measured dispatch (``repro_torch.core.runtime``): the
CostModel, cost epochs, ``compile(mode=...)``, ``NoCapableBackend``,
``describe()`` and the deprecated shims, held against the JAX runtime.

Every cost table of JAX's ``tests/test_gru_compile.py`` is installed in
both runtimes (JAX backend names in JAX's, the port's names in the port's,
``_torch_parity.NAME_MAP``) and must pick the mapped backend, with the same
``cost_source``, at every shape the JAX test checks. The shims must warn
once, equal the executor bit for bit inside the port, and match JAX's
shims within rtol = atol = 1e-5 (fp32; JAX's ``xla`` backend is the
oracle, its fused Pallas decode does not run here).
"""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GRUConfig as JGRUConfig
from repro.core import gru as jgru
from repro.core import rowparallel as jrowparallel
from repro.core import runtime as jrt
from repro_torch.configs.base import GRUConfig
from repro_torch.core import gru as tgru
from repro_torch.core import rowparallel
from repro_torch.core import runtime as rt
from repro_torch.distributed.mesh import local_mesh

from _torch_parity import (NAME_MAP, close, hermetic_runtimes, numpy_params,
                           port_rows, to_jax, to_torch)


@pytest.fixture(autouse=True)
def _hermetic():
    hermetic_runtimes()
    yield
    hermetic_runtimes()


def _cfgs(depth=3, *, hidden=16, backend="auto", family="gru", hetero=False,
          **kw):
    """The same stack as a JAX and a port config (backend names mapped)."""
    shape = (dict(layer_dims=(16, 8, 12)[:depth]) if hetero
             else dict(hidden_dim=hidden, num_layers=depth))
    common = dict(input_dim=5, family=family, **shape, **kw)
    return (JGRUConfig(backend=backend, **common),
            GRUConfig(backend=NAME_MAP.get(backend, backend), **common))


def _calib(depth, H, costs, batch=1, op="decode", family=None):
    rows = [{"backend": b, "op": op, "depth": depth, "batch": batch,
             "hidden_dim": H, "p50_us": us} for b, us in costs.items()]
    if family is not None:
        rows = [dict(r, family=family) for r in rows]
    return rows


def _install(entries):
    jrt.set_cost_model(jrt.CostModel.from_entries(entries))
    rt.set_cost_model(rt.CostModel.from_entries(port_rows(entries)))


def _both(depth=3, *, batch, seq=None, mode, mask=False, **kw):
    """compile() in both runtimes -> (JAX executable, port executable)."""
    jc, tc = _cfgs(depth, **kw)
    return (jrt.compile(jc, batch=batch, seq=seq, mode=mode, mask=mask),
            rt.compile(tc, batch=batch, seq=seq, mode=mode, mask=mask))


def _same_choice(je, te):
    for attr in ("sequence_backend", "decode_backend"):
        j = getattr(je, attr)
        assert getattr(te, attr) == NAME_MAP.get(j, j), (attr, je, te)
    assert te.cost_source == je.cost_source
    return te


# ---------------------------------------------------------------------------
# CostModel: lookup / batch_points / merged / load
# ---------------------------------------------------------------------------

_ROWS = (_calib(1, 16, {"xla": 100.0, "pallas_fused": 20.0}, batch=2)
         + _calib(1, 16, {"xla": 300.0, "pallas_fused": 60.0}, batch=6)
         + _calib(1, 16, {"xla": 900.0}, batch=6, op="sequence")
         + _calib(2, 16, {"xla": 50.0}, batch=4, family="slstm"))


def test_lookup_and_batch_points_equal_jax():
    jm = jrt.CostModel.from_entries(_ROWS, source="rows")
    tm = rt.CostModel.from_entries(port_rows(_ROWS), source="rows")
    assert len(tm) == len(jm) == 6
    for b in (0, 1, 2, 3, 4, 5, 6, 7, 64):
        for name, op, depth, fam in (("xla", "decode", 1, "gru"),
                                     ("pallas_fused", "decode", 1, "gru"),
                                     ("xla", "sequence", 1, "gru"),
                                     ("pallas_fused", "sequence", 1, "gru"),
                                     ("xla", "decode", 2, "slstm"),
                                     ("xla", "decode", 2, "gru")):
            want = jm.lookup(name, op, depth=depth, batch=b, hidden=16,
                             family=fam)
            got = tm.lookup(NAME_MAP[name], op, depth=depth, batch=b,
                            hidden=16, family=fam)
            assert got == want, (name, op, depth, fam, b)
    assert tm.lookup("eager", "decode", depth=1, batch=4, hidden=16) == 200.0
    for name in ("xla", "pallas_fused"):
        assert (tm.batch_points(NAME_MAP[name], depth=1, hidden=16)
                == jm.batch_points(name, depth=1, hidden=16))
    assert tm.batch_points("eager", depth=2, hidden=16, family="slstm") \
        == [(4, 50.0)]


def test_legacy_four_item_keys_are_gru_rows():
    table = {("xla", "decode", 1, 12): [(1, 7.0), (4, 10.0)]}
    jm = jrt.CostModel(table)
    tm = rt.CostModel({("eager",) + k[1:]: v for k, v in table.items()})
    for b in (1, 2, 4, 9):
        assert (tm.lookup("eager", "decode", depth=1, batch=b, hidden=12)
                == jm.lookup("xla", "decode", depth=1, batch=b, hidden=12))
    assert tm.batch_points("eager", depth=1, hidden=12, family="gru") \
        == [(1, 7.0), (4, 10.0)]
    assert tm.lookup("eager", "decode", depth=1, batch=1, hidden=12,
                     family="slstm") is None


_MERGE = [
    {"backend": "xla", "op": "decode", "depth": 1, "hidden_dim": 12,
     "batch": 1, "p50_us": 50.0},                       # replaces
    {"backend": "xla", "op": "decode", "depth": 1, "hidden_dim": 12,
     "batch": 4, "p50_us": 120.0},                      # extends
    {"backend": "xla"},                                 # missing keys
    {"backend": "xla", "op": "decode", "depth": 1, "hidden_dim": 12,
     "batch": 0, "p50_us": 5.0},                        # batch < 1
    {"backend": "xla", "op": "decode", "depth": 1, "hidden_dim": 12,
     "batch": 8, "p50_us": 0.0},                        # ManualClock dt
    {"backend": "xla", "op": "decode", "depth": 1, "hidden_dim": 12,
     "batch": 8, "p50_us": float("nan")},
    {"backend": "xla", "op": "decode", "depth": 1, "hidden_dim": 12,
     "batch": 8, "p50_us": float("inf")},
    {"backend": "xla", "op": "decode", "depth": 1, "hidden_dim": 12,
     "batch": 8, "p50_us": -3.0},
    {"backend": "xla", "op": "decode", "depth": "one", "hidden_dim": 12,
     "batch": 8, "p50_us": 3.0},                        # not an int
    {"family": "slstm", "backend": "xla", "depth": 1, "hidden_dim": 12,
     "batch": 2, "p50_us": 9.0},                        # no op: decode
]


def test_merged_equals_jax_and_is_pure():
    base = _calib(1, 12, {"xla": 100.0}, batch=1) + _calib(
        1, 12, {"xla": 200.0}, batch=8)
    jb = jrt.CostModel.from_entries(base, source="base")
    tb = rt.CostModel.from_entries(port_rows(base), source="base")
    jm, tm = jb.merged(_MERGE), tb.merged(port_rows(_MERGE))
    assert tm.batch_points("eager", depth=1, hidden=12) == jm.batch_points(
        "xla", depth=1, hidden=12) == [(1, 50.0), (4, 120.0), (8, 200.0)]
    assert tm.batch_points("eager", depth=1, hidden=12, family="slstm") \
        == jm.batch_points("xla", depth=1, hidden=12, family="slstm") \
        == [(2, 9.0)]
    assert len(tm) == len(jm) == 4
    assert tm.source == jm.source == "base+online"
    assert tb.batch_points("eager", depth=1, hidden=12) == [(1, 100.0),
                                                            (8, 200.0)]
    assert rt.CostModel({}).merged([]).source == "<online>"


def test_tolerant_load_gives_empty_models(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"bench": "something_else", "entries": []}))
    keyless = tmp_path / "keyless.json"
    keyless.write_text(json.dumps({"bench": "gru_backend_costs",
                                   "entries": [{"backend": "x"}]}))
    for path in (tmp_path / "nope.json", bad, other, keyless):
        jm, tm = jrt.CostModel.load(path), rt.CostModel.load(path)
        assert len(tm) == len(jm) == 0
        assert (tm.error is None) == (jm.error is None) == False  # noqa: E712
        assert tm.source == str(path)


# ---------------------------------------------------------------------------
# dispatch: JAX test_gru_compile.py's tables, in both runtimes
# ---------------------------------------------------------------------------

# (JAX rows, [(depth, batch, seq, mode, extra cfg)]): every shape the JAX
# test checks, and the static shapes beside them
TABLES = {
    "epoch_flip": (
        _calib(3, 16, {"xla": 10.0, "pallas_fused": 90.0,
                       "pallas_chain": 95.0}),
        [(3, 1, None, "decode", {})]),
    "inverted_per_batch": (
        _calib(3, 16, {"xla": 40.0, "pallas_fused": 200.0,
                       "pallas_chain": 250.0}, batch=1)
        + _calib(3, 16, {"xla": 400.0, "pallas_fused": 80.0,
                         "pallas_chain": 90.0}, batch=8),
        [(3, 1, None, "decode", {}), (3, 8, None, "decode", {}),
         (3, 4, None, "decode", {}), (3, 64, None, "decode", {}),
         (2, 1, None, "decode", {}), (3, 1, 12, "prefill", {})]),
    "sequence_flip_per_batch": (
        _calib(3, 16, {"xla": 40.0, "pallas_fused": 200.0,
                       "pallas_chain": 250.0}, batch=1, op="sequence")
        + _calib(3, 16, {"xla": 400.0, "pallas_fused": 80.0,
                         "pallas_chain": 90.0}, batch=8, op="sequence"),
        [(3, 1, 12, "prefill", {}), (3, 8, 12, "prefill", {}),
         (3, 1, None, "decode", {}), (3, 8, 12, "sequence", {})]),
    "decode_only": (
        _calib(3, 16, {"xla": 1.0, "pallas_fused": 50.0,
                       "pallas_chain": 60.0}),
        [(3, 1, 8, "prefill", {}), (3, 1, None, "decode", {}),
         (3, 1, 8, "serve", {})]),
    "partial": (
        _calib(3, 16, {"xla": 1.0, "pallas_fused": 2.0}),
        [(3, 1, None, "decode", {})]),
    "interpolated": (
        _calib(3, 16, {"xla": 100.0, "pallas_fused": 20.0,
                       "pallas_chain": 10.0}, batch=2)
        + _calib(3, 16, {"xla": 300.0, "pallas_fused": 60.0,
                         "pallas_chain": 120.0}, batch=6),
        [(3, b, None, "decode", {}) for b in (1, 2, 3, 4, 5, 6, 7, 64)]),
    "mask_and_hetero": (
        _calib(3, 16, {"xla": 1.0, "pallas_fused": 50.0,
                       "pallas_chain": 60.0}, op="sequence"),
        [(3, 1, 8, "prefill", {"mask": True}),
         (3, 1, 8, "prefill", {"hetero": True})]),
    "preference_beats_cost": (
        _calib(3, 16, {"xla": 1.0, "pallas_fused": 50.0,
                       "pallas_chain": 40.0}),
        [(3, 1, None, "decode", {"backend": "pallas"}),
         (3, 1, None, "decode", {"backend": "xla"}),
         (3, 1, None, "decode", {"backend": "pallas_fused"})]),
    "slstm_inverted": (
        _calib(1, 16, {"xla": 5.0, "pallas_fused": 50.0}, family="slstm")
        + _calib(1, 16, {"xla": 500.0, "pallas_fused": 50.0}, batch=8,
                 family="slstm"),
        [(1, 1, None, "decode", {"family": "slstm"}),
         (1, 8, None, "decode", {"family": "slstm"}),
         (1, 1, 8, "prefill", {"family": "slstm"})]),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_cost_tables_pick_the_mapped_backend(name):
    entries, queries = TABLES[name]
    for measured in (False, True):
        if measured:
            _install(entries)
        for depth, batch, seq, mode, extra in queries:
            extra = dict(extra)
            mask = extra.pop("mask", False)
            je, te = _both(depth, batch=batch, seq=seq, mode=mode,
                           mask=mask, **extra)
            _same_choice(je, te)


def test_calibration_inverts_static_order_per_shape():
    """JAX's acceptance case, in the port's names."""
    _install(TABLES["inverted_per_batch"][0])
    _, tc = _cfgs(3)
    e1 = rt.compile(tc, batch=1, mode="decode")
    e8 = rt.compile(tc, batch=8, mode="decode")
    assert (e1.decode_backend, e8.decode_backend) == ("eager", "cuda_fused")
    assert e1.cost_source == e8.cost_source == "measured"
    other = rt.compile(_cfgs(2)[1], batch=1, mode="decode")
    assert (other.decode_backend, other.cost_source) == ("cuda_fused",
                                                         "static")


def test_decode_only_table_keeps_the_per_op_split():
    _install(TABLES["decode_only"][0])
    _, tc = _cfgs(3)
    es = rt.compile(tc, batch=1, seq=8, mode="prefill")
    ed = rt.compile(tc, batch=1, mode="decode")
    eb = rt.compile(tc, batch=1, seq=8, mode="serve")
    assert (es.sequence_backend, es.cost_source) == ("cuda_fused", "static")
    assert (ed.decode_backend, ed.cost_source) == ("eager", "measured")
    assert (eb.sequence_backend, eb.decode_backend) == ("cuda_fused", "eager")
    assert eb.cost_source == "measured"


def test_preference_ranks_before_measured_cost():
    """Under "cuda" a table chooses among the cuda* backends only: eager
    at 1 us never beats them; under "auto" it does."""
    _install(TABLES["preference_beats_cost"][0])
    pick = {b: rt.compile(_cfgs(3, backend=b)[1], batch=1,
                          mode="decode").decode_backend
            for b in ("pallas", "auto", "pallas_fused")}
    assert pick == {"pallas": "cuda_chain", "auto": "eager",
                    "pallas_fused": "cuda_fused"}


def test_measured_row_never_admits_a_stack_that_does_not_fit():
    """F2: a measured row prices cuda_fused cheapest for a stack too wide
    for its kernel at the compiled tile (L=3, H=64); it stays illegal."""
    rows = _calib(3, 64, {"pallas_fused": 1.0, "pallas_chain": 50.0,
                          "xla": 60.0}, batch=8)
    rt.set_cost_model(rt.CostModel.from_entries(port_rows(rows)))
    for backend in ("auto", "pallas", "pallas_fused"):
        tc = _cfgs(3, hidden=64, backend=backend)[1]
        exe = rt.compile(tc, batch=8, seq=8, mode="serve")
        assert exe.decode_backend == exe.sequence_backend == "cuda_chain"
        assert exe.cost_source == "measured"


def test_measured_only_q8_backends_when_the_gate_opens():
    """With the q8 gate open and quant="int8", a table that leaves the q8
    backends unmeasured still prices the rest (they lose), and one that
    measures cuda_fused_q8 fastest picks it, in both runtimes."""
    passed = {"bench": "gru_quant_accuracy", "passed": True}
    jrt.set_quant_accuracy(jrt.QuantAccuracy(passed))
    rt.set_quant_accuracy(rt.QuantAccuracy(passed))
    base = {"xla": 30.0, "pallas_fused": 20.0, "pallas_chain": 10.0}
    for costs, want in ((base, "cuda_chain"),
                        (dict(base, pallas_fused_q8=5.0), "cuda_fused_q8")):
        _install(_calib(3, 16, costs))
        je, te = _both(3, batch=1, mode="decode", quant="int8")
        assert _same_choice(je, te).decode_backend == want
        assert te.cost_source == "measured"


def test_port_reads_its_own_costs_file_not_jax(tmp_path, monkeypatch):
    """The lazy default load reads $REPRO_TORCH_GRU_COSTS; the JAX
    package's $REPRO_GRU_COSTS (a table from another machine) is never
    read by the port."""
    jax_file = tmp_path / "BENCH_backend_costs.json"
    jax_file.write_text(json.dumps({
        "bench": "gru_backend_costs", "schema": 1,
        "entries": _calib(3, 16, {"xla": 5.0, "pallas_fused": 50.0,
                                  "pallas_chain": 60.0})}))
    monkeypatch.setenv("REPRO_GRU_COSTS", str(jax_file))
    monkeypatch.delenv(rt.COSTS_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    rt.set_cost_model(None)
    exe = rt.compile(_cfgs(3)[1], batch=1, mode="decode")
    assert (exe.decode_backend, exe.cost_source) == ("cuda_fused", "static")
    assert rt.cost_model().source == rt.COSTS_FILE
    port_file = tmp_path / "costs_torch.json"
    port_file.write_text(json.dumps({
        "bench": "gru_backend_costs", "schema": 1,
        "entries": port_rows(_calib(3, 16, {"xla": 5.0, "pallas_fused": 50.0,
                                            "pallas_chain": 60.0}))}))
    monkeypatch.setenv(rt.COSTS_ENV, str(port_file))
    rt.set_cost_model(None)
    exe = rt.compile(_cfgs(3)[1], batch=1, mode="decode")
    assert (exe.decode_backend, exe.cost_source) == ("eager", "measured")
    assert rt.cost_model().source == str(port_file)
    # a corrupt port file degrades to static, never raises
    port_file.write_text("{not json")
    rt.set_cost_model(None)
    assert rt.compile(_cfgs(3)[1], batch=1,
                      mode="decode").decode_backend == "cuda_fused"
    assert rt.cost_model().error is not None


# ---------------------------------------------------------------------------
# cost epochs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bump", ("cost_model", "quant_accuracy"))
def test_epoch_bump_evicts_memoized_executables(bump):
    tc = _cfgs(3)[1]
    old = rt.compile(tc, batch=1, mode="decode")
    assert rt.compile(tc, batch=1, mode="decode") is old
    epoch = rt.cost_epoch()
    if bump == "cost_model":
        rt.set_cost_model(rt.cost_model().merged(port_rows(_calib(
            3, 16, {"xla": 7.0}))))
    else:
        rt.set_quant_accuracy(rt.QuantAccuracy({}, source="<closed>"))
    assert rt.cost_epoch() == epoch + 1
    assert rt._EXEC_CACHE == {}
    new = rt.compile(tc, batch=1, mode="decode")
    assert new is not old
    assert rt.compile(tc, batch=1, mode="decode") is new
    assert all(k[-1] == rt.cost_epoch() for k in rt._EXEC_CACHE)


def test_cache_key_has_mode_and_epoch():
    tc = _cfgs(2)[1]
    a = rt.compile(tc, batch=4, seq=8, mode="serve")
    assert rt.compile(tc, batch=4, seq=8, mode="serve") is a
    assert rt.compile(tc, batch=4, seq=8, mode="prefill") is not a
    assert rt.compile(tc, batch=8, seq=8, mode="serve") is not a
    assert rt.compile(tc, batch=4, seq=8, mask=True, mode="serve") is not a
    assert (tc, 4, 8, False, rt.HOST, "serve", rt.cost_epoch()) \
        in rt._EXEC_CACHE


# ---------------------------------------------------------------------------
# compile(mode=...), NoCapableBackend, describe()
# ---------------------------------------------------------------------------

def _without_decode(registry):
    return {k: dataclasses.replace(s, decode_fn=None) for k, s in
            registry.items()}


@pytest.mark.parametrize("mode", ("serve", "prefill", "sequence", "decode"))
def test_modes_need_their_backends(mode, monkeypatch):
    """With every GRU decode backend taken away, "decode" and "serve"
    raise NoCapableBackend and "prefill"/"sequence" still compile, in both
    runtimes; the executable then has no decode."""
    jrt._ensure_backends()
    rt._ensure_backends()
    monkeypatch.setattr(jrt, "_REGISTRY", _without_decode(jrt._REGISTRY))
    monkeypatch.setattr(rt, "_REGISTRY", _without_decode(rt._REGISTRY))
    jc, tc = _cfgs(2)
    needs_decode = mode in ("serve", "decode")
    for r, c in ((jrt, jc), (rt, tc)):
        if needs_decode:
            with pytest.raises(r.NoCapableBackend):
                r.compile(c, batch=2, seq=6, mode=mode)
        else:
            exe = r.compile(c, batch=2, seq=6, mode=mode)
            assert exe.decode is None and exe.decode_backend is None
    assert issubclass(rt.NoCapableBackend, ValueError)


def test_no_sequence_backend_raises_for_sequence_modes(monkeypatch):
    rt._ensure_backends()
    monkeypatch.setattr(rt, "_REGISTRY", {
        k: dataclasses.replace(s, sequence_fn=None)
        for k, s in rt._REGISTRY.items()})
    tc = _cfgs(2)[1]
    for mode in ("serve", "prefill", "sequence"):
        with pytest.raises(rt.NoCapableBackend):
            rt.compile(tc, batch=2, seq=6, mode=mode)
    exe = rt.compile(tc, batch=2, mode="decode")
    assert exe.sequence_backend is None and exe.decode_backend == "cuda_fused"
    with pytest.raises(rt.NoCapableBackend):
        exe.sequence(None, (), torch.zeros(2, 6, 5))
    with pytest.raises(ValueError):
        rt.compile(tc, batch=2, mode="train")


@pytest.mark.parametrize("mode", ("serve", "prefill", "decode"))
@pytest.mark.parametrize("table", (False, True))
def test_describe_matches_jax(mode, table):
    if table:
        _install(TABLES["decode_only"][0])
    je, te = _both(3, batch=1, seq=8, mode=mode, mask=True)
    jd, td = je.describe(), te.describe()
    for k in ("masked", "mesh", "mode", "batch", "seq", "cost_source"):
        assert td[k] == jd[k], k
    for k in ("sequence_backend", "decode_backend"):
        assert td[k] == NAME_MAP[jd[k]]
    assert te.mode == mode


# ---------------------------------------------------------------------------
# the deprecated shims
# ---------------------------------------------------------------------------

def _stack_data(depth, hetero, B=2, T=6, seed=0):
    jc, tc = _cfgs(depth, backend="xla", hetero=hetero)
    p = numpy_params(jgru.gru_stack_specs(jc), seed=seed)
    xs = np.random.default_rng(seed + 7).normal(
        size=(B, T, 5)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[0, :2] = False
    return jc, tc, p, xs, mask


def _fresh_warnings(names):
    for n in names:
        tgru._DEPRECATION_WARNED.discard(n)
        jgru._DEPRECATION_WARNED.discard(n)


SHIMS = ("gru_sequence", "gru_stack_sequence", "gru_stack_decode_step",
         "gru_decode_step", "gru_stack_sequence_sharded",
         "gru_stack_sequence_sharded_impl", "gru_stack_decode_sharded_impl",
         "runtime.plan", "runtime.ExecPlan")


def _call_port_shims(tc, tp, xs, mask):
    """Call every port shim once; returns their outputs by name."""
    h0s = tgru.stack_h0(tc, xs.shape[0])
    mesh = local_mesh("cpu")
    out = {
        "gru_sequence": tgru.gru_sequence(tp[0], h0s[0], xs, cfg=tc,
                                          mask=mask),
        "gru_stack_sequence": tgru.gru_stack_sequence(tp, h0s, xs, cfg=tc,
                                                      mask=mask),
        "gru_stack_decode_step": tgru.gru_stack_decode_step(
            tp, h0s, xs[:, 0], cfg=tc),
        "gru_decode_step": tgru.gru_decode_step(tp[0], h0s[0], xs[:, 0],
                                                cfg=tc),
        "gru_stack_sequence_sharded": rowparallel.gru_stack_sequence_sharded(
            tp, h0s, xs, mesh=mesh, cfg=tc, mask=mask),
        "gru_stack_sequence_sharded_impl":
            rowparallel.gru_stack_sequence_sharded_impl(
                tp, h0s, xs, mesh=mesh, cfg=tc, return_all=True),
        "gru_stack_decode_sharded_impl":
            rowparallel.gru_stack_decode_sharded_impl(
                tp, h0s, xs[:, 0], mesh=mesh, cfg=tc),
        "runtime.plan": rt.plan(tc, batch=2, seq=6, mode="serve"),
        "runtime.ExecPlan": rt.ExecPlan,
    }
    return out


def test_shims_warn_once_each():
    _, tc, p, xs, mask = _stack_data(2, False)
    tp, txs = to_torch(p), torch.from_numpy(xs)
    tmask = torch.from_numpy(mask)
    _fresh_warnings(SHIMS)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _call_port_shims(tc, tp, txs, tmask)
        _call_port_shims(tc, tp, txs, tmask)          # no second warning
    deps = [str(x.message) for x in w
            if issubclass(x.category, DeprecationWarning)]
    assert len(deps) == len(SHIMS), deps
    for name in SHIMS:
        assert sum(m.startswith(name + " ") for m in deps) == 1, name
    assert all("compile" in m for m in deps)
    assert rt.ExecPlan is rt.GRUExecutable
    tc2 = dataclasses.replace(tc, backend="cuda")
    assert rt.plan(tc2, batch=2, seq=6) is rt.compile(tc2, batch=2, seq=6)
    with warnings.catch_warnings(record=True) as w:    # not deprecated
        warnings.simplefilter("always")
        rt.sequence(tp, tgru.stack_h0(tc, 2), txs, cfg=tc)
        rt.decode(tp, tgru.stack_h0(tc, 2), txs[:, 0], cfg=tc)
    assert not [x for x in w if issubclass(x.category, DeprecationWarning)]


def _eq(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif a is None:
        assert b is None
    else:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)


@pytest.mark.parametrize("backend", ("eager", "cuda"))
@pytest.mark.parametrize("depth,hetero", [(1, False), (3, False), (3, True)])
def test_shims_equal_the_executor_bitwise(depth, hetero, backend):
    _, tc, p, xs, mask = _stack_data(depth, hetero)
    tc = dataclasses.replace(tc, backend=backend)
    tp, txs = to_torch(p), torch.from_numpy(xs)
    tmask = torch.from_numpy(mask)
    h0s = tgru.stack_h0(tc, 2)
    mesh = local_mesh("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        seq = rt.compile(tc, batch=2, seq=6, mask=True, mode="sequence")
        _eq(tgru.gru_stack_sequence(tp, h0s, txs, cfg=tc, mask=tmask),
            seq.sequence(tp, h0s, txs, mask=tmask))
        dec = rt.compile(tc, batch=2, mode="decode")
        _eq(tgru.gru_stack_decode_step(tp, h0s, txs[:, 0], cfg=tc),
            dec.decode(tp, h0s, txs[:, 0]))
        eager = tgru.gru_stack_decode_step(tp, h0s, txs[:, 0], cfg=tc,
                                           impl="eager")
        _eq(eager, rt.compile(dataclasses.replace(tc, backend="eager"),
                              batch=2, mode="decode").decode(tp, h0s,
                                                             txs[:, 0]))
        l0 = dataclasses.replace(tgru.layer_config(tc, 0), backend=backend)
        one = rt.compile(l0, batch=2, seq=6, mask=True, mode="sequence")
        f, s = tgru.gru_sequence(tp[0], h0s[0], txs, cfg=tc, mask=tmask,
                                 return_all=True)
        f1, s1 = one.sequence((tp[0],), (h0s[0],), txs, mask=tmask,
                              return_all=True)
        _eq((f, s), (f1[0], s1))
        _eq(tgru.gru_decode_step({"cell": tp[0]}, h0s[0], txs[:, 0], cfg=tc),
            rt.compile(l0, batch=2, mode="decode").decode(
                (tp[0],), (h0s[0],), txs[:, 0])[0])
        sh = dataclasses.replace(tc, backend="sharded")
        ex = rt.compile(sh, batch=2, seq=6, mask=True, placement=mesh,
                        mode="sequence")
        assert ex.sequence_backend == "sharded"
        _eq(rowparallel.gru_stack_sequence_sharded(tp, h0s, txs, mesh=mesh,
                                                   cfg=tc, mask=tmask),
            ex.sequence(tp, h0s, txs, mask=tmask)[0])
        _eq(rowparallel.gru_stack_sequence_sharded_impl(
                tp, h0s, txs, mesh=mesh, cfg=tc, mask=tmask,
                return_all=True),
            ex.sequence(tp, h0s, txs, mask=tmask, return_all=True))
        sd = rt.compile(dataclasses.replace(tc, backend="sharded_decode"),
                        batch=2, placement=mesh, mode="decode")
        assert sd.decode_backend == "sharded_decode"
        _eq(rowparallel.gru_stack_decode_sharded_impl(tp, h0s, txs[:, 0],
                                                      mesh=mesh, cfg=tc),
            sd.decode(tp, h0s, txs[:, 0]))


@pytest.mark.parametrize("depth,hetero", [(1, False), (3, False), (3, True)])
def test_shims_match_jax_shims(depth, hetero):
    """Each port shim against JAX's on the same seeded inputs (JAX's xla
    backend; the port's cuda preference runs the kernels' plain versions
    here), within 1e-5; the sharded shims on one-rank meshes."""
    from jax.sharding import Mesh
    jc, tc, p, xs, mask = _stack_data(depth, hetero)
    tc = dataclasses.replace(tc, backend="cuda")
    jp, tp = to_jax(p), to_torch(p)
    jxs, txs = jnp.asarray(xs), torch.from_numpy(xs)
    jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)
    jh0, th0 = jgru.stack_h0(jc, 2), tgru.stack_h0(tc, 2)
    jmesh = Mesh(np.array(jax.devices()[:1]), ("model",))
    tmesh = local_mesh("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        pairs = [
            (jgru.gru_stack_sequence(jp, jh0, jxs, cfg=jc, mask=jmask,
                                     return_all=True),
             tgru.gru_stack_sequence(tp, th0, txs, cfg=tc, mask=tmask,
                                     return_all=True)),
            (jgru.gru_stack_decode_step(jp, jh0, jxs[:, 0], cfg=jc),
             tgru.gru_stack_decode_step(tp, th0, txs[:, 0], cfg=tc)),
            (jgru.gru_sequence(jp[0], jh0[0], jxs, cfg=jc, mask=jmask),
             tgru.gru_sequence(tp[0], th0[0], txs, cfg=tc, mask=tmask)),
            (jgru.gru_decode_step(jp[0], jh0[0], jxs[:, 0], cfg=jc),
             tgru.gru_decode_step(tp[0], th0[0], txs[:, 0], cfg=tc)),
            (jrowparallel.gru_stack_sequence_sharded(
                jp, jh0, jxs, mesh=jmesh, cfg=jc, mask=jmask),
             rowparallel.gru_stack_sequence_sharded(
                 tp, th0, txs, mesh=tmesh, cfg=tc, mask=tmask)),
            (jrowparallel.gru_stack_sequence_sharded_impl(
                jp, jh0, jxs, mesh=jmesh, cfg=jc, return_all=True),
             rowparallel.gru_stack_sequence_sharded_impl(
                 tp, th0, txs, mesh=tmesh, cfg=tc, return_all=True)),
            (jrowparallel.gru_stack_decode_sharded_impl(
                jp, jh0, jxs[:, 0], mesh=jmesh, cfg=jc),
             rowparallel.gru_stack_decode_sharded_impl(
                 tp, th0, txs[:, 0], mesh=tmesh, cfg=tc)),
        ]
    for want, got in pairs:
        flat_w, flat_g = jax.tree.leaves(want), []

        def walk(t):
            if isinstance(t, torch.Tensor):
                flat_g.append(t)
            elif t is not None:
                for x in t:
                    walk(x)
        walk(got)
        assert len(flat_w) == len(flat_g)
        for w, g in zip(flat_w, flat_g):
            close(g, w)
