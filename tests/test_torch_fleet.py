"""The port's serving fleet (``repro_torch.serve.fleet``) against JAX's
``repro.serve.fleet`` on the CPU, across the failure matrix.

Each scenario is a counterpart of a test in ``tests/test_serve_fleet.py``
and runs twice, once on each package's ``FleetRouter``, with the same numpy
parameters, the same seeded prompts, the same ``FaultEvent`` schedule and a
``ManualClock`` on both sides; the JAX test's own asserts hold on both.
Then the two runs must be equal: every ``request.out`` (class streams are
integers, held equal), ``stats()`` (its counters, ``shed`` and ``ticks``,
the per-replica accounting; NaN where both report NaN), the virtual clock,
and each ticket's ``(status, reason, retries, hedged, replicas)``. The
port's streams are also held against one port engine serving each request
alone. Then the port's own rules: seeded schedules equal JAX's, a measured
CostModel (installed in both runtimes, names mapped) routes alike, a fleet
over one-rank meshes, only ``NoCapableBackend`` falls back to the nominal
step time, a restart rebuilds the engine and no kernel library, and the CLI
and the examples.
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest

from repro.distributed.fault_tolerance import ManualClock as JManualClock
from repro.distributed.sharding import ShardCtx as JShardCtx
from repro.serve import fleet as jfleet
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core import runtime as rt
from repro_torch.core.params import init_params
from repro_torch.distributed.mesh import local_mesh
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.launch import serve as cli
from repro_torch.models import api as mapi
from repro_torch.serve import fleet
from repro_torch.serve.clock import ManualClock
from repro_torch.serve.engine import Request, ServeEngine

from _torch_fleet import both, oracle, plain, record, side
from _torch_parity import hermetic_runtimes, port_rows


@pytest.fixture(autouse=True)
def _hermetic():
    hermetic_runtimes()
    yield
    hermetic_runtimes()


@pytest.fixture(scope="module")
def sides():
    return side(True), side(False)


# ---------------------------------------------------------------------------
# the one-call surface, no faults (test_serve_fleet.py:66, :80)
# ---------------------------------------------------------------------------

def _serves(P):
    cfg, params = P.setup()
    reqs = P.requests(6, seed=1)
    router = P.fleet(cfg, params)
    done = router.generate(reqs)
    assert all(r.done for r in done)
    oracle(P, cfg, params, reqs)
    s = router.stats()
    assert s["submitted"] == s["completed"] == 6
    assert s["failed"] == 0 and s["shed"] == {}
    assert all(v["steps"] > 0 for v in s["replicas"].values())
    return record(router, reqs)


def test_fleet_serves_and_matches_single_engine(sides):
    both(sides, _serves)


def _depth_routing(P):
    cfg, params = P.setup()
    router = P.fleet(cfg, params, config=P.Config(
        heartbeat_timeout_s=0.05, tick_s=0.01, bucket_penalty_s=0.0))
    heavy = P.requests(1, seed=2, max_new=32)[0]
    t_heavy = router.submit(heavy)
    router.tick()
    loaded = router._by_name[t_heavy.replicas[0]]
    other = next(r for r in router.replicas if r is not loaded)
    light = P.requests(1, seed=3)[0]
    t2 = router.submit(light)
    router.tick()
    assert t2.replicas[0] == other.name
    router.run_until_done()
    assert heavy.done and t2.request.done
    return record(router, [heavy, light])


def test_fleet_depth_routing_prefers_idle_replica(sides):
    both(sides, _depth_routing)


# ---------------------------------------------------------------------------
# the failure matrix (test_serve_fleet.py:105-286)
# ---------------------------------------------------------------------------

def _kill_mid_wave(P):
    cfg, params = P.setup()
    reqs = P.requests(6, seed=4, max_new=6)
    inj = P.Injector([P.Event(t=0.06, kind="kill", replica="replica0")])
    router = P.fleet(cfg, params, injector=inj)
    done = router.generate(reqs)
    s = router.stats()
    assert s["kills"] == 1
    assert s["completed"] == s["submitted"] == 6 and s["failed"] == 0
    assert all(r.done for r in done) and s["retries"] >= 1
    oracle(P, cfg, params, reqs)
    return record(router, reqs)


def test_fleet_replica_kill_mid_wave_completes_all(sides):
    both(sides, _kill_mid_wave)


def _kill_during_prefill(P):
    cfg, params = P.setup()
    reqs = P.requests(4, seed=5, max_new=4)
    inj = P.Injector([
        P.Event(t=0.0, kind="slow", replica="replica0", factor=50.0),
        P.Event(t=0.03, kind="kill", replica="replica0")])
    router = P.fleet(cfg, params, config=P.Config(
        heartbeat_timeout_s=0.05, backoff_base_s=0.02, tick_s=0.01,
        hedge=False), injector=inj)
    done = router.generate(reqs)
    s = router.stats()
    assert s["kills"] == 1 and s["failed"] == 0 and s["completed"] == 4
    assert all(r.done for r in done)
    assert router._by_name["replica0"].alive is False
    oracle(P, cfg, params, reqs)
    return record(router, reqs)


def test_fleet_kill_during_prefill_retries(sides):
    both(sides, _kill_during_prefill)


def _straggler(P):
    cfg, params = P.setup()
    reqs = P.requests(4, seed=6, max_new=8)
    inj = P.Injector([P.Event(t=0.0, kind="slow", replica="replica0",
                              factor=10.0)])
    router = P.fleet(cfg, params, replicas=3, injector=inj,
                     config=P.Config(heartbeat_timeout_s=0.5,
                                     straggler_factor=3.0, tick_s=0.01))
    done = router.generate(reqs)
    s = router.stats()
    assert s["completed"] == 4 and s["failed"] == 0
    assert s["hedges"] >= 1 and s["hedges_cancelled"] >= 1, s
    assert all(len(r.out) == 8 for r in done)
    oracle(P, cfg, params, reqs)
    hedged = [t for t in router.tickets if t.hedged]
    assert hedged and all(len(t.replicas) >= 2 for t in hedged)
    return record(router, reqs)


def test_fleet_straggler_hedged_first_wins(sides):
    both(sides, _straggler)


def _queue_overflow(P):
    cfg, params = P.setup()
    router = P.fleet(cfg, params, config=P.Config(
        queue_limit=2, heartbeat_timeout_s=0.05, tick_s=0.01))
    reqs = P.requests(3, seed=7)
    router.submit(reqs[0])
    router.submit(reqs[1])
    with pytest.raises(P.Rejected) as ei:
        router.submit(reqs[2])
    assert ei.value.reason == "queue_full"
    assert router.stats()["shed"] == {"queue_full": 1}
    router.run_until_done()
    assert reqs[0].done and reqs[1].done and not reqs[2].done
    return record(router, reqs)


def test_fleet_queue_overflow_sheds_typed(sides):
    both(sides, _queue_overflow)


def _deadline_shedding(P):
    cfg, params = P.setup()
    router = P.fleet(cfg, params, config=P.Config(
        queue_limit=64, heartbeat_timeout_s=10.0, tick_s=0.01,
        nominal_step_s=0.01))
    with pytest.raises(P.Rejected) as ei:
        router.submit(P.requests(1, max_new=100)[0], deadline_s=1e-9)
    assert ei.value.reason == "deadline_infeasible"
    inj = P.Injector([
        P.Event(t=0.0, kind="kill", replica="replica0"),
        P.Event(t=0.0, kind="kill", replica="replica1"),
        P.Event(t=0.5, kind="restore", replica="replica0")])
    router2 = P.fleet(cfg, params, injector=inj, clock=P.ManualClock(),
                      config=P.Config(heartbeat_timeout_s=0.05, tick_s=0.01,
                                      nominal_step_s=1e-4))
    req = P.requests(1, max_new=2)[0]
    t = router2.submit(req, deadline_s=0.1)
    router2.run_until_done()
    assert t.status == "shed" and t.reason == "deadline"
    assert router2.stats()["shed"]["deadline"] == 1
    return [record(router, []), record(router2, [req])]


def test_fleet_deadline_shedding(sides):
    both(sides, _deadline_shedding)


def _recovered(P):
    cfg, params = P.setup()
    inj = P.Injector([P.Event(t=0.02, kind="kill", replica="replica0"),
                      P.Event(t=0.10, kind="restore", replica="replica0")])
    router = P.fleet(cfg, params, injector=inj, config=P.Config(
        heartbeat_timeout_s=0.05, backoff_base_s=0.02, tick_s=0.01,
        bucket_penalty_s=0.0))
    first = P.requests(4, seed=8, max_new=4)
    assert all(r.done for r in router.generate(first))
    rep0 = router._by_name["replica0"]
    assert rep0.restarts == 1 and rep0.alive
    # the restart prepared the weights again: the fused stacks are there
    assert "stacked_cells" in rep0.engine.params
    steps_before = rep0.steps
    second = P.requests(4, seed=9, max_new=4)
    assert all(r.done for r in router.generate(second))
    assert rep0.steps > steps_before
    oracle(P, cfg, params, second)
    return record(router, first + second)


def test_fleet_recovered_replica_serves_again_warm(sides):
    both(sides, _recovered)


def _seeded(P):
    cfg, params = P.setup(hidden=10)
    inj = P.Injector.seeded(11, ["replica0", "replica1", "replica2"],
                            horizon_s=0.6, kill_prob=0.7, slow_prob=0.5)
    assert len(inj) > 0
    reqs_f = P.requests(10, seed=12, max_new=5)
    router = P.fleet(cfg, params, replicas=3, injector=inj)
    done_f = router.generate(reqs_f)
    s = router.stats()
    assert s["completed"] == s["submitted"] == 10
    assert s["failed"] == 0 and s["shed"] == {}
    reqs_c = P.requests(10, seed=12, max_new=5)
    clean = P.fleet(cfg, params, replicas=3)
    done_c = clean.generate(reqs_c)
    assert [r.out for r in done_f] == [r.out for r in done_c]
    oracle(P, cfg, params, reqs_c)
    return [record(router, reqs_f), record(clean, reqs_c)]


def test_fleet_seeded_schedule_zero_drops_and_stream_parity(sides):
    rec = both(sides, _seeded)
    assert rec[0]["stats"]["kills"] >= 1       # the seed really killed


def _routing_ab(P):
    recs = []
    cfg, params = P.setup()
    for routing in ("depth", "static"):
        reqs = P.requests(5, seed=13)
        router = P.fleet(cfg, params, config=P.Config(
            routing=routing, heartbeat_timeout_s=0.05, tick_s=0.01))
        done = router.generate(reqs)
        assert all(r.done for r in done)
        assert router.stats()["routing"] == routing
        if routing == "static":
            assert [t.replicas[0] for t in router.tickets[:2]] == [
                "replica0", "replica1"]
        recs.append(record(router, reqs))
    return recs


def test_fleet_static_vs_depth_routing_ab(sides):
    both(sides, _routing_ab)


# ---------------------------------------------------------------------------
# cancellation (test_serve_fleet.py:352-447)
# ---------------------------------------------------------------------------

def _cancel_queued_and_inflight(P):
    cfg, params = P.setup()
    reqs = P.requests(5, seed=20, max_new=6)
    router = P.fleet(cfg, params)
    tickets = [router.submit(r) for r in reqs]
    assert router.cancel(tickets[4].id) is True
    assert tickets[4].status == "cancelled"
    assert tickets[4].reason == "client_disconnect"
    assert tickets[4] in router._queue             # a tombstone
    router.tick()
    assert tickets[4] not in router._queue
    assert tickets[4].replicas == []
    assert router.cancel(tickets[4]) is False
    while not tickets[0].flights:
        router.tick()
    fl = tickets[0].flights[0]
    lane_req, rep = fl.clone, fl.replica
    assert router.cancel(tickets[0]) is True
    assert tickets[0].status == "cancelled" and not tickets[0].flights
    assert fl not in rep.flights
    assert rep.engine.gru_wave_cancel(lane_req) is False
    router.run_until_done()
    s = router.stats()
    assert s["cancelled"] == 2 and s["completed"] == 3 and s["failed"] == 0
    assert not reqs[0].done and not reqs[4].done
    done = [reqs[1], reqs[2], reqs[3]]
    assert all(r.done for r in done)
    oracle(P, cfg, params, done)
    done_ticket = next(t for t in tickets if t.status == "done")
    assert router.cancel(done_ticket) is False
    assert router.cancel(done_ticket.request) is False
    assert router.stats()["cancelled"] == 2
    return record(router, reqs)


def test_fleet_cancel_queued_and_inflight(sides):
    both(sides, _cancel_queued_and_inflight)


def _cancel_unknown(P):
    cfg, params = P.setup()
    router = P.fleet(cfg, params)
    assert router.cancel(12345) is False
    assert router.cancel(P.Request(prompt=np.zeros((3, 5), np.float32))) \
        is False
    assert router.stats()["cancelled"] == 0
    return record(router, [])


def test_fleet_cancel_unknown_handle_is_noop(sides):
    both(sides, _cancel_unknown)


def _cancel_hedged(P):
    cfg, params = P.setup()
    reqs = P.requests(4, seed=21, max_new=8)
    inj = P.Injector([P.Event(t=0.0, kind="slow", replica="replica0",
                              factor=10.0)])
    router = P.fleet(cfg, params, replicas=3, injector=inj,
                     config=P.Config(heartbeat_timeout_s=0.5,
                                     straggler_factor=3.0, tick_s=0.01))
    tickets = [router.submit(r) for r in reqs]
    n = 0
    while not any(len(t.flights) >= 2 for t in tickets):
        router.tick()
        n += 1
        assert n < 10_000, "straggler hedge never fired"
    t = next(t for t in tickets if len(t.flights) >= 2)
    lanes = [(fl.replica, fl.clone) for fl in t.flights]
    assert any(fl.hedge for fl in t.flights)
    before = router.stats()["hedges_cancelled"]
    assert router.cancel(t) is True
    assert t.status == "cancelled" and not t.flights
    assert router.stats()["hedges_cancelled"] == before + 1
    for rep, clone in lanes:
        assert all(fl.clone is not clone for fl in rep.flights)
        assert rep.engine.gru_wave_cancel(clone) is False
    router.run_until_done()
    s = router.stats()
    assert s["cancelled"] == 1 and s["failed"] == 0 and s["completed"] == 3
    assert not t.request.done
    others = [r for r in reqs if r is not t.request]
    assert all(r.done for r in others)
    oracle(P, cfg, params, others)
    return record(router, reqs)


def test_fleet_cancel_kills_hedged_duplicate_under_faults(sides):
    both(sides, _cancel_hedged)


# ---------------------------------------------------------------------------
# per-replica autotuning (test_serve_fleet.py:454)
# ---------------------------------------------------------------------------

def _autotune(P):
    cfg, params = P.setup()
    model_before = P.runtime.cost_model()
    tuned = P.fleet(cfg, params, autotune=True,
                    tuner_config=P.AutoTuneConfig(ladder_min_prompts=4))
    reqs_t = P.requests(12, seed=22, max_new=4)
    assert all(r.done for r in tuned.generate(reqs_t))
    s = tuned.stats()
    assert s["autotune"] is True
    assert s["completed"] == 12 and s["failed"] == 0
    tuned_reps = [v for v in s["replicas"].values()
                  if v["bucket_ladder"] is not None]
    assert tuned_reps and all(v["retunes"] >= 1 for v in tuned_reps)
    # every measured step is 0.0 under a ManualClock: recalibration stays
    # inert and the shared model is untouched
    assert P.runtime.cost_model() is model_before
    decisions = []
    for rep in tuned.replicas:
        at = rep.engine.latency_stats()["autotune"]
        assert at["enabled"] is True
        for d in at["decisions"]:
            assert d["measurement"] and "rule" in d["measurement"]
        decisions.append([(d["kind"], d["from"], d["to"])
                          for d in at["decisions"]])
    static = P.fleet(cfg, params)
    reqs_s = P.requests(12, seed=22, max_new=4)
    static.generate(reqs_s)
    assert static.stats()["autotune"] is False
    assert [r.out for r in reqs_t] == [r.out for r in reqs_s]
    return [record(tuned, reqs_t), record(static, reqs_s), decisions]


def test_fleet_autotune_per_replica_tuners_ab_parity(sides):
    both(sides, _autotune)


# ---------------------------------------------------------------------------
# virtual time, deadlines, stats, tombstones (test_serve_fleet.py:520-654)
# ---------------------------------------------------------------------------

def _tick_frozen(P):
    cfg, params = P.setup()
    clock = P.ManualClock()
    router = P.fleet(cfg, params, clock=clock)
    req = P.requests(1, seed=30)[0]
    router.submit(req)
    stepped = router.tick(advance_time=False)
    assert clock.now() == 0.0 and stepped > 0
    router.tick()
    assert clock.now() == pytest.approx(router.config.tick_s)
    router.run_until_done()
    assert router.stats()["completed"] == 1
    return [stepped, record(router, [req])]


def test_tick_advance_time_false_freezes_virtual_time(sides):
    both(sides, _tick_frozen)


def _pump_frozen(P):
    cfg, params = P.setup()
    clock = P.ManualClock()
    small = P.Config(heartbeat_timeout_s=10.0, backoff_base_s=0.02,
                     tick_s=0.01, queue_limit=2)
    router = P.fleet(cfg, params, clock=clock, config=small)
    reqs = P.requests(8, seed=31, max_new=6)
    done = router.generate(reqs, deadline_s=0.5)
    assert all(r.done for r in done)
    s = router.stats()
    assert s["completed"] == 8 and s["shed"] == {}
    assert clock.now() < router.ticks * router.config.tick_s
    oracle(P, cfg, params, reqs)
    return record(router, reqs)


def test_generate_admission_pump_does_not_age_virtual_time(sides):
    both(sides, _pump_frozen)


def _pump_advances(P):
    cfg, params = P.setup()
    clock = P.ManualClock()
    inj = P.Injector([P.Event(t=0.0, kind="kill", replica="replica0"),
                      P.Event(t=0.0, kind="kill", replica="replica1"),
                      P.Event(t=0.06, kind="restore", replica="replica0")])
    small = P.Config(heartbeat_timeout_s=10.0, backoff_base_s=0.02,
                     tick_s=0.01, queue_limit=2)
    router = P.fleet(cfg, params, injector=inj, clock=clock, config=small)
    reqs = P.requests(4, seed=32, max_new=4)
    assert all(r.done for r in router.generate(reqs))
    s = router.stats()
    assert s["kills"] == 2 and s["restores"] == 1
    assert s["completed"] == 4 and s["failed"] == 0
    assert clock.now() >= 0.06
    return record(router, reqs)


def test_generate_pump_advances_time_when_fleet_cannot_step(sides):
    both(sides, _pump_advances)


def _deadline_inflight(P):
    cfg, params = P.setup()
    router = P.fleet(cfg, params, clock=P.ManualClock())
    long_req = P.requests(1, seed=33, max_new=60)[0]
    shorts = P.requests(3, seed=34, max_new=4)
    t_long = router.submit(long_req, deadline_s=0.2)
    for r in shorts:
        router.submit(r)
    while not t_long.flights:
        router.tick()
    router.run_until_done()
    assert t_long.status == "shed" and t_long.reason == "deadline"
    assert router.sheds["deadline"] == 1
    assert t_long.flights == [] and not long_req.done
    assert t_long.t_first_dispatch is not None
    assert t_long.t_done - t_long.t_submit <= 0.2 + 2 * router.config.tick_s
    assert all(r.done for r in shorts)
    oracle(P, cfg, params, shorts)
    return record(router, [long_req] + shorts)


def test_deadline_sheds_inflight_ticket_and_frees_lane(sides):
    both(sides, _deadline_inflight)


def _empty_history(P):
    cfg, params = P.setup()
    router = P.fleet(cfg, params)
    s = router.stats()
    for k in ("e2e_mean_s", "e2e_p50_s", "e2e_p99_s", "queue_wait_p50_s",
              "queue_wait_p99_s"):
        assert np.isnan(s[k]), k
    assert not (s["e2e_p99_s"] <= 1.1 * 0.005)
    ls = router.replicas[0].engine.latency_stats()
    for k in ("mean_s", "p50_s", "p90_s", "p99_s", "max_s",
              "prefill_mean_s", "queue_wait_p99_s", "e2e_p50_s"):
        assert np.isnan(ls[k]), k
    empty = record(router, [])
    reqs = P.requests(2, seed=35)
    router.generate(reqs)
    s2 = router.stats()
    assert s2["e2e_p99_s"] > 0.0 and not np.isnan(s2["e2e_mean_s"])
    return [empty, record(router, reqs)]


def test_empty_history_stats_are_nan_not_zero(sides):
    both(sides, _empty_history)


def _tombstones(P):
    cfg, params = P.setup()
    router = P.fleet(cfg, params)
    reqs = P.requests(10, seed=36, max_new=4)
    tickets = [router.submit(r) for r in reqs]
    for t in tickets[::2]:
        assert router.cancel(t) is True
    assert len(router._queue) == 10
    router.tick()
    assert all(t.status == "cancelled" and t.replicas == []
               for t in tickets[::2])
    router.run_until_done()
    s = router.stats()
    assert s["cancelled"] == 5 and s["completed"] == 5
    live = [r for i, r in enumerate(reqs) if i % 2 == 1]
    assert all(r.done for r in live)
    oracle(P, cfg, params, live)
    return record(router, reqs)


def test_cancelled_queue_entries_tombstoned_and_never_dispatch(sides):
    both(sides, _tombstones)


# ---------------------------------------------------------------------------
# engine surface the router drives (test_serve_fleet.py:292, :326), against
# the JAX engine
# ---------------------------------------------------------------------------

def _engines(P, cfg, params, max_batch=2):
    if P.name == "jax":
        return JServeEngine(cfg, params, JShardCtx(), max_batch=max_batch,
                            clock=JManualClock())
    return ServeEngine(cfg, params, max_batch=max_batch, clock=ManualClock(),
                       device="cpu")


def _stepwise_vs_generate(P):
    cfg, params = P.setup()
    reqs_a = P.requests(5, seed=14, max_new=3)
    reqs_b = P.requests(5, seed=14, max_new=3)
    _engines(P, cfg, params).generate(reqs_a)
    e2 = _engines(P, cfg, params)
    e2.gru_wave_begin(reqs_b)
    n = 0
    while e2.gru_wave_active():
        e2.gru_wave_step()
        n += 1
        assert n < 1000
    assert [r.out for r in reqs_a] == [r.out for r in reqs_b]
    assert all(r.done for r in reqs_b)
    return [[r.out for r in reqs_b], n]


def test_engine_stepwise_wave_matches_generate(sides):
    both(sides, _stepwise_vs_generate)


def _engine_stats(P):
    cfg, params = P.setup()
    reqs = P.requests(5, seed=16, max_new=3)
    engine = _engines(P, cfg, params)
    engine.generate(reqs)
    s = engine.latency_stats()
    assert s["requests"] == 5
    assert len(engine.queue_waits) == 5 and len(engine.e2e_times) == 5
    assert all(q >= 0 for q in engine.queue_waits)
    assert s["e2e_p99_s"] >= s["e2e_p50_s"] >= 0.0
    assert s["queue_wait_p99_s"] >= s["queue_wait_p50_s"] >= 0.0
    for r in reqs:
        assert r.t_finish - r.t_submit >= r.t_admit - r.t_submit >= 0.0
    return plain([{k: s[k] for k in ("requests", "steps", "prefills",
                                      "e2e_p99_s", "queue_wait_p99_s")},
                   [r.out for r in reqs]])


def test_engine_latency_stats_queue_wait_and_e2e(sides):
    both(sides, _engine_stats)


# ---------------------------------------------------------------------------
# the port's own tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", (0, 1, 7, 11, 23))
def test_seeded_schedule_equals_jax(seed):
    names = ["replica0", "replica1", "replica2"]
    for kw in ({}, {"kill_prob": 0.7, "slow_prob": 0.5, "t0": 1.5}):
        ours = fleet.FaultInjector.seeded(seed, names, 0.6, **kw)
        theirs = jfleet.FaultInjector.seeded(seed, names, 0.6, **kw)
        assert [dataclasses.astuple(e) for e in ours.events] == [
            dataclasses.astuple(e) for e in theirs._events]
        assert len(ours) == len(theirs)


def _costed_routing(P, p50_us):
    """Depth routing under a measured decode row of ``p50_us`` per step
    (None: the static table): a loaded warm replica against an idle cold
    one, and a deadline that the measured step makes infeasible."""
    cfg, params = P.setup()
    if p50_us is not None:
        rows = [{"family": "gru", "backend": "xla", "op": "decode",
                 "depth": 1, "hidden_dim": 12, "batch": 2,
                 "p50_us": p50_us}]
        if P.name == "port":
            rows = port_rows(rows)
        P.runtime.set_cost_model(P.runtime.CostModel.from_entries(rows))
    router = P.fleet(cfg, params)
    reqs = P.requests(6, seed=40, max_new=6)
    for r in reqs[:3]:
        router.submit(r)
        router.tick()
    rejected = None
    try:
        router.submit(P.requests(1, seed=41, max_new=8)[0], deadline_s=0.5)
    except P.Rejected as e:
        rejected = e.reason
    for r in reqs[3:]:
        router.submit(r)
    router.run_until_done()
    oracle(P, cfg, params, reqs)
    return [rejected, record(router, reqs)]


def test_measured_cost_model_routes_like_jax(sides):
    static = both(sides, lambda P: _costed_routing(P, None))
    hermetic_runtimes()
    measured = both(sides, lambda P: _costed_routing(P, 1e5))
    assert static[0] is None and measured[0] == "deadline_infeasible"
    # the measured step moved routing: the table really was read
    routes = [[t[4] for t in rec["tickets"]] for rec in (static[1],
                                                         measured[1])]
    assert routes[0] != routes[1]


def test_fleet_over_one_rank_meshes(sides):
    """Replicas on one-rank ``local_mesh("cpu")`` contexts, pinned to
    ``cuda_sharded`` (the plain shard versions here), through a kill and a
    restore: the rebuilt replica is placed on its mesh again and serves the
    next wave; the streams equal JAX's fleet without a mesh."""
    J, P = sides
    cfg, params = P.setup()
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru, backend="cuda_sharded"))
    router = P.fleet(cfg, params, ctxs=[ShardCtx(local_mesh("cpu"))] * 2,
                     config=P.Config(heartbeat_timeout_s=0.05, tick_s=0.01,
                                     bucket_penalty_s=0.0),
                     injector=P.Injector([
                         P.Event(t=0.05, kind="kill", replica="replica0"),
                         P.Event(t=0.12, kind="restore",
                                 replica="replica0")]))
    reqs = P.requests(6, seed=42, max_new=5) + P.requests(4, seed=44)
    router.generate(reqs[:6])
    assert router.replicas[0].restarts == 1
    router.generate(reqs[6:])
    s = router.stats()
    assert s["completed"] == 10 and s["kills"] == 1 and s["restores"] == 1
    for rep in router.replicas:
        assert rep.engine.ctx.mesh is not None
        assert "placed_cells" in rep.engine.params
        assert set(rep.engine.prefill_backends) == {"cuda_sharded"}
        assert set(rep.engine.latency_stats()["decode_backend_steps"]) == {
            "cuda_sharded"}
    jcfg, jparams = J.setup()
    jreqs = J.requests(6, seed=42, max_new=5) + J.requests(4, seed=44)
    J.fleet(jcfg, jparams).generate(jreqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_step_cost_falls_back_only_on_no_capable_backend(sides, monkeypatch):
    _, P = sides
    cfg, params = P.setup()
    router = P.fleet(cfg, params, config=P.Config(nominal_step_s=0.01))
    calls = []

    def no_backend(*a, **kw):
        calls.append(kw.get("mode"))
        raise rt.NoCapableBackend("no decode backend at this shape")
    monkeypatch.setattr(rt, "compile", no_backend)
    # no measured step, no legal backend: the nominal step, 8 tokens of it
    est = router._estimated_service_s(Request(
        prompt=np.zeros((3, 5), np.float32), max_new_tokens=8))
    # each replica prices its queue and the request's own tokens
    assert est == pytest.approx(8 * 0.01) and calls == ["decode"] * 4

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(rt, "compile", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        router.submit(Request(prompt=np.zeros((3, 5), np.float32)),
                      deadline_s=1.0)
    router.submit(Request(prompt=np.zeros((3, 5), np.float32)))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        router.tick()                        # depth routing prices replicas


def test_restart_rebuilds_the_engine_and_no_kernel_library(sides,
                                                           monkeypatch):
    _, P = sides
    from repro_torch.kernels import _build
    cfg, params = P.setup()
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru, backend="cuda"))
    from repro_torch.models import gru_lm
    prepared, builds = [], []
    real_prepare = gru_lm.prepare_params
    monkeypatch.setattr(gru_lm, "prepare_params",
                        lambda *a, **kw: prepared.append(1)
                        or real_prepare(*a, **kw))
    monkeypatch.setattr(_build, "build", lambda *a, **kw: builds.append(a))
    monkeypatch.setattr(_build, "load", lambda *a, **kw: builds.append(a))
    router = P.fleet(cfg, params, injector=P.Injector([
        P.Event(t=0.04, kind="kill", replica="replica0"),
        P.Event(t=0.10, kind="restore", replica="replica0")]))
    assert len(prepared) == 2
    rep0 = router.replicas[0]
    old = weakref.ref(rep0.engine)
    reqs = P.requests(6, seed=43, max_new=6)
    router.generate(reqs)
    assert rep0.restarts == 1 and len(prepared) == 3
    gc.collect()
    assert old() is None                 # nothing holds the dropped engine
    assert rep0.engine.params is not None and builds == []
    assert {b for r in router.replicas
            for b in r.engine.prefill_backends} == {"cuda_fused"}
    oracle(P, cfg, params, reqs)


def test_fleet_defaults_to_the_card_and_refuses_lm_families():
    cfg = get_config("gru-jet")
    params = init_params(mapi.get_api(cfg).specs(cfg), 0, device="cpu")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            fleet.FleetRouter(cfg, params)
    lm = get_smoke_config("qwen3-0.6b")
    with pytest.raises(NotImplementedError, match="'gru', 'slstm'"):
        fleet.FleetRouter(lm, {}, device="cpu")


# ---------------------------------------------------------------------------
# the CLI and the examples on the CPU
# ---------------------------------------------------------------------------

def _cli_reference(arch, argv_extra, n, max_new, seed=0):
    cfg = get_config(arch)
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru, backend="cuda"))
    params = init_params(mapi.get_api(cfg).specs(cfg), seed, cfg.param_dtype,
                         device="cpu")
    reqs = cli.make_requests(cfg, n, 12, True, max_new, seed)
    eng = ServeEngine(cfg, params, max_batch=1, device="cpu")
    return [r.out for r in eng.generate(reqs)]


@pytest.mark.parametrize("seed", (0, 3))
def test_cli_fleet_prints_jax_schedule_and_single_engine_streams(seed,
                                                                 capsys):
    argv = ["--arch", "gru-jet-deep", "--gru-backend", "cuda", "--replicas",
            "2", "--inject-faults", "--requests", "8", "--vary-prompt",
            "--max-new", "5", "--seed", str(seed), "--device", "cpu"]
    done = cli.main(argv)
    out = capsys.readouterr().out
    names = ["replica0", "replica1"]
    jinj = jfleet.FaultInjector.seeded(seed, names, horizon_s=0.6)
    want = ("fault schedule (seed %d): " % seed) + "; ".join(
        f"t={e.t:.3f} {e.kind} {e.replica}"
        + (f" x{e.factor:g}" if e.kind == "slow" else "")
        for e in jinj._events)
    assert out.splitlines()[0] == want
    assert "completed=8/8 failed=0" in out
    ref = _cli_reference("gru-jet-deep", (), 8, 5, seed)
    assert [r.out for r in done] == ref
    done_async = cli.main(argv + ["--async"])
    assert [r.out for r in done_async] == ref
    assert "async front end: 8 concurrent client coroutines" in \
        capsys.readouterr().out


def test_examples_run_to_their_asserts(capsys):
    from repro_torch.examples import serve_async, serve_fleet
    router, done = serve_fleet.main(["--device", "cpu"])
    assert router.stats()["restores"] == 1
    arouter, streamed, sync_reqs = serve_async.main(["--device", "cpu"])
    assert streamed[1:] == [r.out for r in sync_reqs[1:]]
    out = capsys.readouterr().out
    assert "survived: completed=8/8" in out and "async fleet:" in out


def test_restore_before_the_heartbeat_timeout_requeues_the_flights(sides):
    """A replica killed and restored within ``heartbeat_timeout_s`` was
    never declared dead, but its rebuilt engine holds none of its lanes:
    the port requeues those flights at the restore and every request
    completes with the single engine's streams. (JAX's router keeps them on
    the rebuilt replica and never finishes them: its run_until_done raises;
    where the heartbeats detect the death first, as in every scenario
    above, the two routers agree.)"""
    J, P = sides
    cfg, params = P.setup()
    reqs = P.requests(6, seed=45, max_new=12)
    schedule = [(0.05, "kill"), (0.10, "restore")]
    router = P.fleet(cfg, params, config=P.Config(heartbeat_timeout_s=0.25),
                     injector=P.Injector([
                         P.Event(t=t, kind=k, replica="replica0")
                         for t, k in schedule]))
    router.generate(reqs)
    s = router.stats()
    assert s["kills"] == s["restores"] == 1 and s["retries"] >= 1
    assert s["completed"] == 6 and s["failed"] == 0
    oracle(P, cfg, params, reqs)
    jcfg, jparams = J.setup()
    jrouter = J.fleet(jcfg, jparams, config=J.Config(heartbeat_timeout_s=0.25),
                      injector=J.Injector([
                          J.Event(t=t, kind=k, replica="replica0")
                          for t, k in schedule]))
    for r in J.requests(6, seed=45, max_new=12):
        jrouter.submit(r)
    with pytest.raises(RuntimeError, match="did not converge"):
        jrouter.run_until_done(max_ticks=500)
