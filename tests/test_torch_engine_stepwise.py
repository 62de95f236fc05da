"""The port engine's stepwise and tuning surface
(``repro_torch.serve.engine``) against the JAX engine on the CPU.

Same parameters (JAX ``init_params`` as numpy), same seeded feature
prompts, driven one decode step at a time: requests enqueued into a live
wave and lanes cancelled while queued or mid-decode must give the JAX
engine's class streams, finished lists and work counts. A stub tuner
records the engine's hooks in both packages (the same calls, backend names
mapped). Then the port's own rules: a cost model installed mid-wave moves
neither the live wave's backend nor its attribution and compiles nothing
for a live key, a tuned engine serves the new choice from its next wave
boundary (an untuned one keeps its executables), and a flip to a backend
whose weight views the prepared params lack rebuilds them once, at the
boundary, never per step.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs.base import get_config as jax_get_config
from repro.distributed.fault_tolerance import ManualClock as JManualClock
from repro.distributed.sharding import ShardCtx as JShardCtx
from repro.models import api as jax_api
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_config
from repro_torch.core import cells as cell_families
from repro_torch.core import runtime as rt
from repro_torch.distributed.mesh import local_mesh
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.serve.autotune import AutoTuneConfig, AutoTuner
from repro_torch.serve.clock import ManualClock
from repro_torch.serve.engine import Request, ServeEngine

from _torch_parity import (NAME_MAP, hermetic_runtimes, numpy_params,
                           port_rows, to_jax, to_torch)

ARCHS = ("gru-jet", "gru-jet-deep", "slstm-jet")


@pytest.fixture(autouse=True)
def _hermetic():
    hermetic_runtimes()
    yield
    hermetic_runtimes()


@pytest.fixture(scope="module")
def params_np():
    return {a: numpy_params(jax_api.get_api(jax_get_config(a)).specs(
        jax_get_config(a)), seed=5) for a in ARCHS}


def _cfgs(arch, backend="xla"):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    return (jcfg.replace(gru=dataclasses.replace(jcfg.gru, backend=backend)),
            tcfg.replace(gru=dataclasses.replace(tcfg.gru,
                                                 backend=NAME_MAP[backend])))


def _requests(n, seed, jax_side, lo=1, hi=12):
    rng = np.random.default_rng(seed)
    R = JRequest if jax_side else Request
    out = []
    for i in range(n):
        S = int(rng.integers(lo, hi + 1))
        prompt = rng.normal(size=(S, 5)).astype(np.float32)
        stream = (rng.normal(size=(6, 5)).astype(np.float32)
                  if i % 3 == 0 else None)
        out.append(R(prompt=prompt, max_new_tokens=int(rng.integers(2, 7)),
                     stream=stream))
    return out


class _StubTuner:
    """Records the engine's tuner hooks; retunes nothing."""

    def __init__(self):
        self.calls = []

    def observe_prompt(self, length):
        self.calls.append(("prompt", int(length)))

    def observe_step(self, dt_s, *, batch, backend, depth, hidden,
                     family="gru"):
        self.calls.append(("step", batch, NAME_MAP.get(backend, backend),
                           depth, hidden, family))

    def maybe_retune(self, engine):
        self.calls.append(("retune", engine.gru_wave_active()))
        return []

    def stats(self):
        return {"retunes": 0, "stub_calls": len(self.calls)}


def _pair(arch, params_np, *, slots=3, backend="xla", tuner=False):
    jcfg, tcfg = _cfgs(arch, backend)
    jt, tt = (_StubTuner(), _StubTuner()) if tuner else (None, None)
    je = JServeEngine(jcfg, to_jax(params_np[arch]), JShardCtx(),
                      max_batch=slots, clock=JManualClock(), tuner=jt)
    te = ServeEngine(tcfg, to_torch(params_np[arch]), max_batch=slots,
                     clock=ManualClock(), device="cpu", tuner=tt)
    return je, te


def _drive(engine, script):
    """Run ``script`` (a list of ("begin"|"enqueue", reqs), ("step", n),
    ("cancel", req), ("drain",)) on ``engine``; returns what each action
    returned (finished counts, cancel results, work counts)."""
    log = []
    for action, *args in script:
        if action == "begin":
            engine.gru_wave_begin(args[0])
        elif action == "enqueue":
            engine.gru_wave_enqueue(args[0])
        elif action == "step":
            for _ in range(args[0]):
                log.append(len(engine.gru_wave_step()))
                log.append(engine.gru_work_remaining())
        elif action == "cancel":
            log.append(engine.gru_wave_cancel(args[0]))
        elif action == "drain":
            while engine.gru_wave_active():
                log.append(len(engine.gru_wave_step()))
    return log


@pytest.mark.parametrize("arch", ARCHS)
def test_mid_wave_enqueue_streams_equal_jax(arch, params_np):
    je, te = _pair(arch, params_np, tuner=True)
    logs, outs = [], []
    for e, side in ((je, True), (te, False)):
        a, b = _requests(2, 1, side), _requests(4, 2, side)
        c = _requests(2, 3, side)
        logs.append(_drive(e, [("begin", a), ("step", 2), ("enqueue", b),
                               ("step", 1), ("enqueue", c), ("drain",)]))
        outs.append([r.out for r in a + b + c])
        assert all(r.done for r in a + b + c)
        assert e.gru_work_remaining() == (0, 0)
    assert outs[1] == outs[0]
    assert logs[1] == logs[0]
    assert te.tuner.calls == je.tuner.calls
    assert [c[0] for c in te.tuner.calls].count("prompt") == 8
    assert len(te.prefill_times) == len(je.prefill_times)
    assert len(te.step_times) == len(je.step_times)
    st = te.latency_stats()
    assert st["autotune"]["enabled"] and st["autotune"]["stub_calls"] == \
        len(te.tuner.calls)


@pytest.mark.parametrize("arch", ARCHS)
def test_cancel_queued_and_live_lanes_equal_jax(arch, params_np):
    je, te = _pair(arch, params_np, slots=2)
    logs, outs = [], []
    for e, side in ((je, True), (te, False)):
        reqs = _requests(6, 4, side)
        for r in reqs:
            r.max_new_tokens = 6           # nobody finishes before cancels
        stranger = _requests(1, 9, side)[0]
        logs.append(_drive(e, [
            ("begin", reqs), ("step", 2),
            ("cancel", reqs[0]),            # live lane
            ("cancel", reqs[4]),            # queued
            ("cancel", stranger),           # not in the wave
            ("step", 1), ("cancel", reqs[0]),   # already gone
            ("drain",)]))
        outs.append([(r.out, r.done) for r in reqs])
        assert e.gru_wave_cancel(reqs[1]) is False    # finished
    assert logs[1] == logs[0]
    assert logs[0][4:7] == [True, True, False]
    assert outs[1] == outs[0]
    assert outs[0][4] == ([], False) and len(outs[0][0][0]) == 2
    e = ServeEngine(_cfgs(arch)[1], to_torch(params_np[arch]), device="cpu")
    assert e.gru_wave_cancel(_requests(1, 0, False)[0]) is False
    assert e.gru_work_remaining() == (0, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_bucket_warm_and_enqueue_starts_a_wave(arch, params_np):
    je, te = _pair(arch, params_np)
    for e, side in ((je, True), (te, False)):
        assert not e.bucket_warm(3)
        e.gru_wave_enqueue(_requests(2, 6, side, lo=3, hi=3))
        assert e.gru_wave_active() == 2
        while e.gru_wave_active():
            e.gru_wave_step()
        assert [e.bucket_warm(S) for S in (1, 3, 8, 9)] == [True] * 3 + [False]


# ---------------------------------------------------------------------------
# the port's frozen executables: cost flips and weight views
# ---------------------------------------------------------------------------

def _table(cfg, costs, batch, op="decode"):
    g = cfg.gru
    return rt.CostModel.from_entries(port_rows([
        {"family": g.family, "backend": b, "op": op,
         "depth": g.resolved_num_layers,
         "hidden_dim": g.resolved_layer_dims[0],
         "batch": batch, "p50_us": us} for b, us in costs.items()]))


class _Misses:
    """Counts runtime.compile cache misses by (batch, seq, mode)."""

    def __init__(self, monkeypatch):
        self.by_key = {}
        real = rt.compile

        def counting(cfg, **kw):
            before = len(rt._EXEC_CACHE)
            exe = real(cfg, **kw)
            if len(rt._EXEC_CACHE) > before:
                k = (kw.get("batch"), kw.get("seq"), kw.get("mode"))
                self.by_key[k] = self.by_key.get(k, 0) + 1
            return exe
        monkeypatch.setattr(rt, "compile", counting)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tuned", (True, False))
def test_cost_flip_mid_wave_waits_for_the_boundary(arch, tuned, params_np,
                                                   monkeypatch):
    """Under "auto" (static: cuda_fused), a table pricing eager fastest is
    installed mid-wave: the live wave keeps cuda_fused for every step and
    every attribution, and nothing compiles for its keys. Nothing
    re-resolves on its own, tuner or not (recalibration off): after the
    drain the frozen executables still name cuda_fused, and the caller's
    ``refresh_executables`` at the boundary flips the next wave to eager.
    Streams equal an untuned eager engine's."""
    _, tcfg = _cfgs(arch, "auto")
    slots = 3
    tuner = (AutoTuner(AutoTuneConfig(tune_wave_size=False,
                                      tune_buckets=False, recalibrate=False))
             if tuned else None)
    eng = ServeEngine(tcfg, to_torch(params_np[arch]), max_batch=slots,
                      clock=ManualClock(), device="cpu", tuner=tuner)
    misses = _Misses(monkeypatch)
    wave1 = _requests(5, 7, False)
    eng.gru_wave_begin(wave1)
    for _ in range(3):
        eng.gru_wave_step()
    live = dict(misses.by_key)
    rt.set_cost_model(_table(tcfg, {"xla": 1.0, "pallas_fused": 50.0,
                                    "pallas_chain": 60.0}, slots))
    while eng.gru_wave_active():
        eng.gru_wave_step()
    eng._wave = None
    assert {k: misses.by_key[k] for k in live} == live   # no live key compiled
    assert {e.decode_backend for e in eng._decode_exes.values()} == {
        "cuda_fused"}                          # no refresh of its own
    assert eng.refresh_executables()           # the boundary: a flip
    assert not eng._decode_exes and not eng._prefill_exes
    steps1 = dict(eng.latency_stats()["decode_backend_steps"])
    assert steps1 == {"cuda_fused": len(eng.step_times)}
    assert set(eng.prefill_backends) == {"cuda_fused"}
    wave2 = _requests(4, 8, False)
    eng.generate(wave2)
    after = "eager"
    steps2 = eng.latency_stats()["decode_backend_steps"]
    n2 = len(eng.step_times) - sum(steps1.values())
    assert n2 > 0 and eng.decode_backend == after
    assert steps2.get(after, 0) - steps1.get(after, 0) == n2
    assert eng.param_rebuilds == 0               # host params hold all views
    ref = ServeEngine(_cfgs(arch, "xla")[1], to_torch(params_np[arch]),
                      max_batch=slots, clock=ManualClock(), device="cpu")
    r1, r2 = _requests(5, 7, False), _requests(4, 8, False)
    ref.generate(r1)
    ref.generate(r2)
    assert [r.out for r in wave1 + wave2] == [r.out for r in r1 + r2]


def test_flip_to_missing_views_rebuilds_once_at_the_boundary(params_np,
                                                             monkeypatch):
    """On a one-rank mesh, a table that makes sharded_decode the decode
    backend at the engine's batch gives params without the fused stacks
    (mesh backends read only the placed views). A later table flips decode
    to cuda_fused: ``refresh_executables`` at the boundary rebuilds the
    tuned engine's params once, and no step of the next wave builds a
    stack."""
    arch = "gru-jet-deep"
    _, tcfg = _cfgs(arch, "auto")
    slots = 3
    rt.set_cost_model(_table(tcfg, {"xla": 70.0, "pallas_fused": 50.0,
                                    "pallas_chain": 60.0,
                                    "sharded_decode": 1.0}, slots))
    fam = cell_families.get_family("gru")
    built = []

    def counting(cells):
        built.append(len(cells))
        return fam.stacked_views(cells)
    monkeypatch.setitem(cell_families._FAMILIES, "gru",
                        dataclasses.replace(fam, stacked_views=counting))
    tuner = AutoTuner(AutoTuneConfig(tune_wave_size=False,
                                     tune_buckets=False, recalibrate=False))
    eng = ServeEngine(tcfg, to_torch(params_np[arch]), max_batch=slots,
                      clock=ManualClock(), device="cpu",
                      ctx=ShardCtx(local_mesh("cpu")), tuner=tuner)
    assert "stacked_cells" not in eng.params and "placed_cells" in eng.params
    wave1 = _requests(4, 11, False)
    eng.generate(wave1)
    assert eng.decode_backend == "sharded_decode"
    assert set(eng.prefill_backends) == {"cuda_sharded"}
    assert built == [] and eng.param_rebuilds == 0
    rt.set_cost_model(_table(tcfg, {"xla": 70.0, "pallas_fused": 5.0,
                                    "pallas_chain": 60.0,
                                    "sharded_decode": 100.0}, slots))
    n1 = len(eng.step_times)
    assert eng.param_rebuilds == 0             # nothing moves on its own
    assert eng.refresh_executables()           # the boundary: flip + rebuild
    assert eng.param_rebuilds == 1 and built == [3]
    wave2 = _requests(4, 12, False)
    eng.gru_wave_begin(wave2)
    assert "stacked_cells" in eng.params and "placed_cells" in eng.params
    while eng.gru_wave_active():
        eng.gru_wave_step()
    assert built == [3] and eng.param_rebuilds == 1   # none per step
    assert eng.decode_backends[n1:] == ["cuda_fused"] * (
        len(eng.step_times) - n1)
    ref = ServeEngine(_cfgs(arch, "xla")[1], to_torch(params_np[arch]),
                      max_batch=slots, device="cpu")
    r1, r2 = _requests(4, 11, False), _requests(4, 12, False)
    ref.generate(r1)
    ref.generate(r2)
    assert [r.out for r in wave1 + wave2] == [r.out for r in r1 + r2]


def test_missing_views_names_what_an_executable_reads(params_np):
    _, tcfg = _cfgs("gru-jet-deep", "pallas")
    raw = to_torch(params_np["gru-jet-deep"])
    exe = rt.compile(tcfg.gru, batch=2, mode="decode")
    assert exe.decode_backend == "cuda_fused"
    assert exe.missing_views(raw, device="cpu") == ("stacked",)
    assert exe.missing_views(exe.prepare(raw, device="cpu"),
                             device="cpu") == ()
    mesh = local_mesh("cpu")
    sh = rt.compile(dataclasses.replace(tcfg.gru, backend="cuda_sharded"),
                    batch=2, placement=mesh, mode="decode")
    assert sh.missing_views(raw, device="cpu") == ("placed",)
    assert sh.missing_views(sh.prepare(raw, device="cpu"),
                            device="cpu") == ()
