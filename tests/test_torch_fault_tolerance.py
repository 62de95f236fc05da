"""The port's fault-tolerance module
(``repro_torch.distributed.fault_tolerance``) against JAX's
``repro.distributed.fault_tolerance`` on the same inputs: the heartbeat and
straggler monitors under one ``ManualClock`` each, the elastic mesh policy
and its manager, and the training ``Supervisor`` under injected failures,
with an in-memory save and restore in place of JAX's ``CheckpointManager``.
The port defines no clock of its own there: its ``ManualClock`` is the
serving engine's."""
import pytest

from repro.distributed import fault_tolerance as jft
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.serve import clock as serve_clock

from _torch_parity import hermetic_runtimes


@pytest.fixture(autouse=True)
def _hermetic():
    hermetic_runtimes()
    yield
    hermetic_runtimes()


def test_one_manual_clock_class():
    assert ft.ManualClock is serve_clock.ManualClock
    assert ft.SystemClock is serve_clock.SystemClock
    assert ft.Clock is serve_clock.Clock
    from repro_torch.serve import async_frontend, fleet
    assert fleet.ManualClock is async_frontend.ManualClock is ft.ManualClock


def _monitors(M):
    """tests/test_checkpoint_ft.py:76, returning what was observed."""
    clk = M.ManualClock()
    seen = []
    hb = M.HeartbeatMonitor(timeout_s=1.0, clock=clk)
    hb.beat("a")
    hb.beat("b")
    clk.advance(0.5)
    seen.append(hb.dead_hosts())
    clk.advance(1.5)
    hb.beat("a")
    clk.advance(0.1)
    seen += [hb.dead_hosts(), hb.alive_hosts()]
    assert seen[1:] == [["b"], ["a"]]
    sm = M.StragglerMonitor(factor=2.0, clock=clk)
    for h, t in [("a", 1.0), ("b", 1.0), ("c", 5.0)]:
        for _ in range(4):
            sm.record(h, t)
    seen += [sm.stragglers(), sm.medians()]
    sm2 = M.StragglerMonitor(factor=2.0, max_age_s=10.0, clock=clk)
    for h, t in [("a", 1.0), ("b", 1.0), ("c", 5.0)]:
        for _ in range(4):
            sm2.record(h, t)
    seen.append(sm2.stragglers())
    clk.advance(20.0)
    for _ in range(4):
        sm2.record("c", 1.0)
        sm2.record("a", 1.0)
        sm2.record("b", 1.0)
    seen += [sm2.stragglers(), sm2.medians()]
    # the window keeps the newest samples only
    sm3 = M.StragglerMonitor(factor=3.0, window=3, clock=clk)
    for v in (9.0, 9.0, 9.0, 1.0, 1.0, 1.0):
        sm3.record("x", v)
    sm3.record("y", 1.0)
    seen += [sm3.medians(), sm3.stragglers()]
    return seen


def test_monitors_equal_jax():
    ours, theirs = _monitors(ft), _monitors(jft)
    assert ours == theirs
    assert ours[3] == ["c"] and ours[6] == []


@pytest.mark.parametrize("n,mp,pods", [(512, 16, 2), (256, 16, 1),
                                       (8, 2, 1), (24, 4, 3), (12, 4, 3),
                                       (7, 7, 1), (30, 2, 5)])
def test_largest_feasible_mesh_equals_jax(n, mp, pods):
    assert ft.largest_feasible_mesh(n, mp, pods) == \
        jft.largest_feasible_mesh(n, mp, pods)


def test_largest_feasible_mesh_refuses_too_few_devices():
    with pytest.raises(ValueError):
        ft.largest_feasible_mesh(3, 4)


def _elastic(M):
    seen = []
    m = M.ElasticMeshManager(total_devices=512, model_parallel=16, pods=2)
    seen.append(m.current_shape())
    m.fail(range(16))
    seen += [m.survivors(), m.current_shape()]
    m.heal(range(8))
    seen += [m.survivors(), m.current_shape()]
    m2 = M.ElasticMeshManager(total_devices=8, model_parallel=2)
    m2.fail([0, 1, 2])
    seen.append(m2.current_shape())
    m2.fail([3, 4, 5, 6])
    with pytest.raises(RuntimeError):
        m2.current_shape()
    return seen


def test_elastic_mesh_manager_equals_jax():
    ours = _elastic(ft)
    assert ours == _elastic(jft)
    assert ours[2] in ((2, 15, 16), (31, 16)) and ours[-1] == (2, 2)


def _supervised(M, inject, max_restarts=8):
    """tests/test_checkpoint_ft.py:107 with an in-memory checkpoint store:
    a scalar quadratic model, crashes at the injected steps."""
    store = {}
    mesh_mgr = M.ElasticMeshManager(total_devices=8, model_parallel=2)
    builds = []

    def build(mesh_shape):
        builds.append(mesh_shape)

        def step_fn(state, step):
            w = state["w"]
            w2 = w - 0.1 * 2 * (w - 3.0)
            return {"w": w2, "step": state["step"] + 1}, {
                "loss": (w2 - 3.0) ** 2}

        def save_fn(state, step):
            store[step] = dict(state)

        def restore_fn(like):
            if not store:
                return like, 0
            step = max(store)
            return dict(store[step]), step
        return step_fn, {"w": 0.0, "step": 0}, save_fn, restore_fn

    sup = M.Supervisor(mesh_mgr, build, checkpoint_every=5,
                       max_restarts=max_restarts, clock=M.ManualClock())
    state, step, history = sup.run(20, inject=inject)
    return state, step, history, builds, sup.restarts, sorted(store)


def test_supervisor_survives_injected_failures_like_jax():
    ours = _supervised(ft, {7: [0], 13: [1]})
    assert ours == _supervised(jft, {7: [0], 13: [1]})
    state, step, history, builds, restarts, saved = ours
    assert step == 20 and restarts == 2
    assert builds == [(4, 2), (3, 2), (3, 2)]
    assert history[-1][1]["loss"] < history[0][1]["loss"]
    assert saved == [5, 10, 15, 20]
    # steps 5-6 and 10-12 ran twice: restored from the last checkpoint
    assert [s for s, _ in history].count(5) == 2


def test_supervisor_gives_up_past_its_restart_budget():
    with pytest.raises(RuntimeError, match="injected node failure"):
        _supervised(ft, {2: [0], 4: [1]}, max_restarts=1)
