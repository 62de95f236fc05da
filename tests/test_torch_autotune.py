"""The port's online autotuner (``repro_torch.serve.autotune``) against the
JAX package's (``repro.serve.autotune``), test for test with
``tests/test_autotune.py``.

Both engines serve the same seeded requests with the same parameters
under deterministic clocks (a plain ManualClock measures dt == 0, which
the tuner must ignore; an auto-advancing one gives nonzero timings), with
the same measured curves installed in both runtimes (JAX's ``xla`` rows
are the port's ``eager`` rows). The decision records must agree in
``kind``, ``from``, ``to`` and ``measurement["rule"]``, and the class
streams must equal an untuned engine's and JAX's. The port's
recalibration property is written with a valid hypothesis strategy (the
JAX test's combines ``allow_nan`` with bounds, caveat R4).
"""
import dataclasses
import math

import numpy as np
import pytest

from _hyp import given, settings, st
from repro.configs.base import get_config as jax_get_config
from repro.core import runtime as jrt
from repro.distributed.fault_tolerance import ManualClock as JManualClock
from repro.distributed.sharding import ShardCtx
from repro.models import api as jax_api
from repro.serve.autotune import AutoTuneConfig as JAutoTuneConfig
from repro.serve.autotune import AutoTuner as JAutoTuner
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import GRUConfig, get_config
from repro_torch.core import runtime as rt
from repro_torch.serve.autotune import AutoTuneConfig, AutoTuner
from repro_torch.serve.clock import ManualClock
from repro_torch.serve.engine import Request, ServeEngine, bucket_len

from _torch_parity import (NAME_MAP, hermetic_runtimes, numpy_params,
                           port_rows, to_jax, to_torch)


@pytest.fixture(autouse=True)
def _hermetic():
    hermetic_runtimes()
    yield
    hermetic_runtimes()


def _setup(hidden=12, num_layers=1, backend="xla", arch="gru-jet", seed=0):
    """(JAX cfg, port cfg, numpy params): ``arch``'s model at test size."""
    kw = dict(input_dim=5, hidden_dim=hidden, num_classes=5,
              num_layers=num_layers)
    jbase, tbase = jax_get_config(arch), get_config(arch)
    jcfg = jbase.replace(gru=dataclasses.replace(jbase.gru, backend=backend,
                                                 **kw))
    tcfg = tbase.replace(gru=dataclasses.replace(
        tbase.gru, backend=NAME_MAP[backend], **kw))
    specs = jax_api.get_api(jcfg).specs(jcfg)
    return jcfg, tcfg, numpy_params(specs, seed=seed)


def _requests(lens, seed=0, max_new=4, jax_side=False):
    rng = np.random.default_rng(seed)
    R = JRequest if jax_side else Request
    return [R(prompt=rng.normal(size=(int(L), 5)).astype(np.float32),
              max_new_tokens=max_new) for L in lens]


class _AutoClock(ManualClock):
    """A ManualClock that advances ``dt_s`` per now() call: nonzero,
    deterministic step timings."""

    def __init__(self, dt_s: float = 1e-4):
        super().__init__()
        self._dt_s = dt_s

    def now(self) -> float:
        t = super().now()
        self.advance(self._dt_s)
        return t


class _JAutoClock(JManualClock):
    def __init__(self, dt_s: float = 1e-4):
        super().__init__()
        self._dt_s = dt_s

    def now(self) -> float:
        t = super().now()
        self.advance(self._dt_s)
        return t


def _install_curve(points, *, depth=1, hidden=12, family="gru",
                   backend="xla"):
    entries = [{"family": family, "backend": backend, "op": "decode",
                "depth": depth, "hidden_dim": hidden, "batch": b,
                "p50_us": us} for b, us in points]
    jrt.set_cost_model(jrt.CostModel.from_entries(entries, source="<curve>"))
    rt.set_cost_model(rt.CostModel.from_entries(port_rows(entries),
                                                source="<curve>"))


def _engines(jcfg, tcfg, p, *, max_batch, clock, jclock, config=None):
    """An engine of each package over the same params, with a tuner of
    ``config`` (None: untuned)."""
    jt = None if config is None else JAutoTuner(JAutoTuneConfig(**config))
    tt = None if config is None else AutoTuner(AutoTuneConfig(**config))
    je = JServeEngine(jcfg, to_jax(p), ShardCtx(), max_batch=max_batch,
                      clock=jclock, tuner=jt)
    te = ServeEngine(tcfg, to_torch(p), max_batch=max_batch, clock=clock,
                     device="cpu", tuner=tt)
    return je, te


def _trail(decisions):
    """(kind, from, to, rule) per decision; a recalibration's from/to are
    cost epochs, whose counts differ between the two runtimes, so only
    their step is kept."""
    return [(d["kind"], *((None, d["to"] - d["from"])
                          if d["kind"] == "recalibrate"
                          else (d["from"], d["to"])),
             d["measurement"]["rule"]) for d in decisions]


# ---------------------------------------------------------------------------
# the runtime half of the loop
# ---------------------------------------------------------------------------

def test_cost_model_merged_replaces_and_extends():
    rows = [{"backend": "eager", "op": "decode", "depth": 1,
             "hidden_dim": 12, "batch": b, "p50_us": us}
            for b, us in ((1, 100.0), (8, 200.0))]
    base = rt.CostModel.from_entries(rows)
    out = base.merged([dict(rows[0], p50_us=50.0),
                       dict(rows[0], batch=4, p50_us=120.0)])
    assert out.batch_points("eager", "decode", depth=1, hidden=12) == \
        [(1, 50.0), (4, 120.0), (8, 200.0)]
    assert base.batch_points("eager", "decode", depth=1, hidden=12) == \
        [(1, 100.0), (8, 200.0)]


def test_cost_model_merged_skips_malformed_rows():
    row = {"backend": "eager", "op": "decode", "depth": 1,
           "hidden_dim": 12, "batch": 2, "p50_us": 10.0}
    out = rt.CostModel.from_entries([row]).merged([
        {"backend": "eager"}, dict(row, batch=0, p50_us=5.0),
        dict(row, p50_us=0.0), dict(row, p50_us=float("nan")),
        dict(row, p50_us=float("inf")), dict(row, p50_us=-3.0)])
    assert out.batch_points("eager", "decode", depth=1, hidden=12) == \
        [(2, 10.0)]


# ---------------------------------------------------------------------------
# dimension 1: wave size from the measured batch-latency curve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("points,config,want", [
    # step(1)=10us, the curve kinks after B=3: marginal cap 5us
    ([(1, 10.0), (2, 11.0), (3, 12.0), (4, 30.0), (8, 100.0)],
     dict(marginal_frac=0.5, wave_cap=8), 3),
    # smooth marginals, but an absolute budget of 12us per step
    ([(1, 10.0), (2, 11.0), (3, 12.0), (4, 13.0), (8, 17.0)],
     dict(marginal_frac=1.0, wave_cap=8, step_budget_us=12.0), 3),
    # one measured point: no curve, the static size stands
    ([(1, 10.0)], {}, 8),
])
def test_wave_size_rule_equals_jax(points, config, want):
    jcfg, tcfg, p = _setup()
    _install_curve(points)
    je, te = _engines(jcfg, tcfg, p, max_batch=8, clock=ManualClock(),
                      jclock=JManualClock(),
                      config=dict(tune_buckets=False, recalibrate=False,
                                  **config))
    for e in (je, te):
        e.gru_wave_begin(())             # a wave boundary: retune runs
        e.gru_wave_begin(())             # idempotent: no second decision
    assert te.max_batch == je.max_batch == want
    assert _trail(te.tuner.decisions) == _trail(je.tuner.decisions)
    assert len(te.tuner.decisions) == (want != 8)
    for jd, td in zip(je.tuner.decisions, te.tuner.decisions):
        jm, tm = jd["measurement"], td["measurement"]
        assert tm["backend"] == NAME_MAP[jm["backend"]] == "eager"
        assert tm["curve_us"] == jm["curve_us"]
        assert tm["solo_us"] == jm["solo_us"] == 10.0


# ---------------------------------------------------------------------------
# dimension 2: bucket ladder from the observed prompt lengths
# ---------------------------------------------------------------------------

def test_bucket_ladder_from_skewed_prompt_distribution():
    jcfg, tcfg, p = _setup()
    je, te = _engines(jcfg, tcfg, p, max_batch=2, clock=ManualClock(),
                      jclock=JManualClock(),
                      config=dict(tune_wave_size=False, recalibrate=False,
                                  ladder_min_prompts=8))
    for e in (je, te):
        for L in [3] * 51 + [5] * 30 + [9] * 15 + [16] * 5:
            e.tuner.observe_prompt(L)
        e.gru_wave_begin(())
    assert te.bucket_ladder == je.bucket_ladder == (3, 5, 9, 16)
    assert _trail(te.tuner.decisions) == _trail(je.tuner.decisions)
    (d,) = te.tuner.decisions
    assert d["from"] == "pow2(min=8)" and d["measurement"]["prompts"] == 101
    for S in (1, 3, 4, 6, 16, 17, 40):
        assert te._bucket_for(S) == je._bucket_for(S)
    assert te._bucket_for(3) == 3 != bucket_len(3, te.bucket_min)
    assert te._bucket_for(17) == 32      # doubles from the top rung
    # too few observations -> no decision
    t2 = AutoTuner(AutoTuneConfig(ladder_min_prompts=8))
    e2 = ServeEngine(tcfg, to_torch(p), clock=ManualClock(), device="cpu",
                     tuner=t2)
    for L in (3, 4, 5):
        t2.observe_prompt(L)
    e2.gru_wave_begin(())
    assert e2.bucket_ladder is None and t2.decisions == []


def test_bucket_min_sets_the_pow2_ladder():
    jcfg, tcfg, p = _setup()
    je = JServeEngine(jcfg, to_jax(p), ShardCtx(), max_batch=2, bucket_min=4)
    te = ServeEngine(tcfg, to_torch(p), max_batch=2, device="cpu",
                     bucket_min=4)
    for S in (1, 3, 4, 5, 9):
        assert te._bucket_for(S) == je._bucket_for(S) == bucket_len(S, 4)
    outs = []
    for e, side in ((je, True), (te, False)):
        reqs = e.generate(_requests([3, 5, 2], seed=4, jax_side=side))
        outs.append([r.out for r in reqs])
        assert len(e.prefill_times) == 2       # cohorts [3, 5] and [2]
    assert outs[0] == outs[1]
    assert sorted(te._prefill_exes) == sorted(je._prefill_jit) == [4, 8]
    assert te.bucket_warm(2) and te.bucket_warm(5)
    assert not te.bucket_warm(9)


# ---------------------------------------------------------------------------
# dimension 3: online recalibration
# ---------------------------------------------------------------------------

def test_recalibration_folds_steps_and_bumps_epoch_without_rebuild():
    """Served warm steps become CostModel rows (epoch bump); a table that
    confirms the frozen backend drops nothing (the same executables live
    on), as JAX keeps its jits."""
    jcfg, tcfg, p = _setup()
    je, te = _engines(jcfg, tcfg, p, max_batch=2, clock=_AutoClock(1e-4),
                      jclock=_JAutoClock(1e-4),
                      config=dict(tune_wave_size=False, tune_buckets=False,
                                  recal_min_steps=4))
    for e, side in ((je, True), (te, False)):
        e.generate(_requests([3, 3], max_new=6, jax_side=side))
    assert _trail(te.tuner.decisions) == _trail(je.tuner.decisions)
    (d,) = [d for d in te.tuner.decisions if d["kind"] == "recalibrate"]
    assert d["to"] > d["from"] and d["rebuilt_jits"] is False
    assert te._jit_gen == 0
    gen0, exes0 = te._jit_gen, dict(te._decode_exes)
    te.generate(_requests([3, 3], max_new=6))
    assert te._jit_gen == gen0
    assert all(te._decode_exes[k] is v for k, v in exes0.items())
    entries = d["measurement"]["entries"]
    assert entries and all(e["backend"] == "eager" and e["p50_us"] > 0
                           for e in entries)
    assert rt.cost_model().batch_points("eager", "decode", depth=1,
                                        hidden=12)


def test_recalibration_ignores_manualclock_zero_timings():
    jcfg, tcfg, p = _setup()
    snap = rt.cost_model()
    t = AutoTuner(AutoTuneConfig(tune_wave_size=False, tune_buckets=False,
                                 recal_min_steps=1))
    e = ServeEngine(tcfg, to_torch(p), max_batch=2, clock=ManualClock(),
                    device="cpu", tuner=t)
    e.generate(_requests([3, 3], max_new=6))
    e.generate(_requests([3, 3], max_new=6))
    assert [d for d in t.decisions if d["kind"] == "recalibrate"] == []
    assert rt.cost_model() is snap and t.stats()["fresh_steps"] == 0


# ---------------------------------------------------------------------------
# compile-step exclusion after a retune
# ---------------------------------------------------------------------------

def test_post_retune_prefill_first_call_excluded():
    jcfg, tcfg, p = _setup()
    je, te = _engines(jcfg, tcfg, p, max_batch=2, clock=ManualClock(),
                      jclock=JManualClock())
    counts = []
    for e, side in ((je, True), (te, False)):
        seen = []
        e.generate(_requests([3, 3], max_new=2, jax_side=side))
        seen.append(len(e.prefill_times))        # first ever: included
        e.apply_bucket_ladder((3, 16))
        e.generate(_requests([3, 3], max_new=2, jax_side=side))
        seen.append(len(e.prefill_times))        # post-retune: excluded
        e.generate(_requests([3, 3], max_new=2, jax_side=side))
        seen.append(len(e.prefill_times))        # warm reuse: recorded
        counts.append(seen)
    assert counts[1] == counts[0] == [1, 1, 2]


def test_post_retune_decode_first_step_excluded_again():
    jcfg, tcfg, p = _setup()
    je, te = _engines(jcfg, tcfg, p, max_batch=2, clock=ManualClock(),
                      jclock=JManualClock())
    counts = []
    for e, side in ((je, True), (te, False)):
        e.generate(_requests([3, 3], max_new=3, jax_side=side))
        seen = [len(e.step_times)]
        e._invalidate_jits()
        e.generate(_requests([3, 3], max_new=3, jax_side=side))
        seen += [len(e.step_times), len(e.prefill_times)]
        e.generate(_requests([3, 3], max_new=3, jax_side=side))
        seen.append(len(e.prefill_times))
        counts.append(seen)
    assert te._decode_exes and te._prefill_exes
    te._invalidate_jits()
    assert te._decode_exes == {} and te._decode_warm == set()
    assert counts[1] == counts[0] == [2, 4, 1, 2]


# ---------------------------------------------------------------------------
# acceptance: the whole loop on a skewed workload
# ---------------------------------------------------------------------------

LENS = [3, 3, 3, 5, 3, 3, 5, 9, 3, 5, 3, 16, 3, 5, 3, 3]


def _serve_waves(engine, jax_side):
    outs = []
    for i in range(0, len(LENS), 4):
        reqs = _requests(LENS[i:i + 4], seed=i, max_new=4, jax_side=jax_side)
        engine.generate(reqs)
        outs.extend(r.out for r in reqs)
    return outs


def test_autotuned_engine_acceptance_skewed_workload(monkeypatch):
    """JAX's acceptance case on both packages: the same ordered decision
    trail (wave size 4 -> 2 and the same bucket ladder), every decision
    justified, no retune under a live wave, no compile miss for a key
    already compiled, and class streams equal to an untuned engine's and
    to JAX's."""
    jcfg, tcfg, p = _setup()
    _install_curve([(1, 10.0), (2, 11.0), (4, 40.0), (8, 90.0)])
    cfg = dict(ladder_min_prompts=8, recalibrate=False, marginal_frac=0.5,
               wave_cap=8)
    je, te = _engines(jcfg, tcfg, p, max_batch=4, clock=_AutoClock(1e-4),
                      jclock=_JAutoClock(1e-4), config=cfg)
    violations = []
    real = te.tuner.maybe_retune

    def guarded(eng):
        if eng._wave is not None and eng.gru_wave_active() > 0:
            violations.append(eng.gru_wave_active())
        return real(eng)
    te.tuner.maybe_retune = guarded
    misses = {}
    compile_ = rt.compile

    def counting(cfg_, **kw):
        before = len(rt._EXEC_CACHE)
        exe = compile_(cfg_, **kw)
        if len(rt._EXEC_CACHE) > before:
            key = (kw.get("batch"), kw.get("seq"), kw.get("mode"))
            misses[key] = misses.get(key, 0) + 1
        return exe
    monkeypatch.setattr(rt, "compile", counting)
    outs_jax = _serve_waves(je, True)
    outs_tuned = _serve_waves(te, False)

    assert violations == []
    assert misses and max(misses.values()) == 1, misses
    assert _trail(te.tuner.decisions) == _trail(je.tuner.decisions)
    assert te.max_batch == je.max_batch == 2
    assert te.bucket_ladder == je.bucket_ladder is not None
    assert set(te.bucket_ladder) != {bucket_len(L, 8) for L in LENS}
    at = te.latency_stats()["autotune"]
    assert at["enabled"] and at["wave_size"] == 2
    assert at["bucket_ladder"] == list(te.bucket_ladder)
    assert {"wave_size", "bucket_ladder"} <= {d["kind"]
                                              for d in at["decisions"]}
    for d in at["decisions"]:
        assert d["measurement"] and "rule" in d["measurement"]
        assert d["t"] >= 0.0
    assert at["retunes"] == je.latency_stats()["autotune"]["retunes"]
    untuned = ServeEngine(tcfg, to_torch(p), max_batch=4,
                          clock=_AutoClock(1e-4), device="cpu")
    assert outs_tuned == _serve_waves(untuned, False) == outs_jax


def test_untuned_engine_reports_autotune_disabled():
    _, tcfg, p = _setup()
    e = ServeEngine(tcfg, to_torch(p), max_batch=2, device="cpu")
    e.generate(_requests([3], max_new=2))
    assert e.latency_stats()["autotune"] == {
        "enabled": False, "wave_size": 2, "bucket_ladder": None}


def test_slstm_tuned_waves_equal_jax():
    """slstm-jet's family through the whole loop (recalibration on, an
    auto-advancing clock): the same decision trail and streams as JAX's
    tuned engine, and the streams of an untuned port engine."""
    jcfg, tcfg, p = _setup(hidden=8, arch="slstm-jet")
    cfg = dict(ladder_min_prompts=4, recal_min_steps=4, wave_cap=4)
    je, te = _engines(jcfg, tcfg, p, max_batch=4, clock=_AutoClock(1e-4),
                      jclock=_JAutoClock(1e-4), config=cfg)
    outs_jax = _serve_waves(je, True)
    outs = _serve_waves(te, False)
    assert _trail(te.tuner.decisions) == _trail(je.tuner.decisions)
    assert {d["kind"] for d in te.tuner.decisions} >= {"recalibrate",
                                                       "bucket_ladder"}
    for d in te.tuner.decisions:
        if d["kind"] == "recalibrate":
            assert {e["family"] for e in d["measurement"]["entries"]} \
                == {"slstm"}
    untuned = ServeEngine(tcfg, to_torch(p), max_batch=4, device="cpu")
    assert outs == _serve_waves(untuned, False) == outs_jax


# ---------------------------------------------------------------------------
# recalibration safety (property)
# ---------------------------------------------------------------------------

_BACKENDS = ["eager", "cuda_fused", "cuda_chain", "bogus_backend",
             "sharded_decode", "cuda_fused_q8"]


def _legal_decode_set(cfg):
    rt._ensure_backends()
    return {name for (fam, name), s in rt._REGISTRY.items()
            if rt._legal(s, cfg, op="decode", masked=False, batch=2,
                         mesh=None)}


@settings(max_examples=25, deadline=None, derandomize=True)
@given(entries=st.lists(st.fixed_dictionaries({
    "backend": st.sampled_from(_BACKENDS),
    "op": st.sampled_from(["decode", "sequence"]),
    "depth": st.integers(min_value=1, max_value=2),
    "hidden_dim": st.sampled_from([12, 32]),
    "batch": st.integers(min_value=-2, max_value=16),
    "p50_us": st.one_of(
        st.floats(min_value=-1e6, max_value=1e6, width=32),
        st.sampled_from([math.nan, math.inf, -math.inf, 0.0])),
}), max_size=12))
def test_prop_recalibration_never_escapes_legal_set(entries):
    """Arbitrary folded rows (junk backends, absurd batches, nan/inf and
    negative latencies) never make dispatch leave the legal set, never
    override an exact pin, and leave no older epoch in the cache."""
    hermetic_runtimes()
    auto = GRUConfig(input_dim=5, hidden_dim=12, num_layers=1,
                     backend="auto")
    pin = GRUConfig(input_dim=5, hidden_dim=12, num_layers=1,
                    backend="cuda_chain")
    rt.set_cost_model(rt.cost_model().merged(entries, source="<prop>"))
    assert rt._EXEC_CACHE == {}
    epoch = rt.cost_epoch()
    exe = rt.compile(auto, batch=2, mode="decode")
    assert exe.decode_backend in _legal_decode_set(auto)
    assert exe.decode_backend != "bogus_backend"
    assert not exe.decode_backend.endswith("_q8")     # the gate is closed
    assert rt.compile(pin, batch=2, mode="decode").decode_backend \
        == "cuda_chain"
    assert rt._EXEC_CACHE and all(k[-1] == epoch for k in rt._EXEC_CACHE)
    assert all(math.isfinite(c) and c > 0 for pts in
               rt.cost_model()._table.values() for _, c in pts)


def test_recalibration_epoch_evicts_stale_executables():
    cfg = GRUConfig(input_dim=5, hidden_dim=12, num_layers=1, backend="auto")
    old = rt.compile(cfg, batch=1, mode="decode")
    rt.set_cost_model(rt.cost_model().merged(
        [{"backend": "eager", "op": "decode", "depth": 1, "hidden_dim": 12,
          "batch": 1, "p50_us": 7.0}]))
    assert old not in rt._EXEC_CACHE.values()
    new = rt.compile(cfg, batch=1, mode="decode")
    assert new is not old and rt.compile(cfg, batch=1, mode="decode") is new
