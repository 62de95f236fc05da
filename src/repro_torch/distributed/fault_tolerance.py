"""Fault tolerance (counterpart of ``repro.distributed.fault_tolerance``):
heartbeats, straggler detection, elastic re-meshing and a supervised
training loop.

The signals of a real deployment come from its cluster manager (missed
heartbeats, link errors); here the control logic is the whole of it, and
tests drive it with injected failures. It is host-side Python and needs no
card.

All timing flows through one injectable :class:`Clock`: the monitors, the
training :class:`Supervisor` and the serving fleet
(``repro_torch.serve.fleet``) share one time source, so tests drive every
failure path with a :class:`ManualClock`. The clocks are those of
``repro_torch.serve.clock``, re-exported, never defined twice: the fleet and
its asyncio front end branch on ``isinstance(clock, ManualClock)``, and a
second class of that name would send a virtual-time fleet down the
real-clock branches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.clock import Clock, ManualClock, SystemClock

__all__ = ["Clock", "SystemClock", "ManualClock", "HeartbeatMonitor",
           "StragglerMonitor", "largest_feasible_mesh", "ElasticMeshManager",
           "Supervisor"]


@dataclass
class HeartbeatMonitor:
    """Tracks per-host heartbeats; a host is dead after ``timeout_s``.

    Timestamps come from the injected ``clock``, so beats and liveness
    checks always share one time base."""
    timeout_s: float = 60.0
    clock: Clock = field(default_factory=SystemClock)
    _last: Dict[str, float] = field(default_factory=dict)

    def beat(self, host: str) -> None:
        self._last[host] = self.clock.now()

    def dead_hosts(self) -> List[str]:
        now = self.clock.now()
        return [h for h, t in self._last.items() if now - t > self.timeout_s]

    def alive_hosts(self) -> List[str]:
        now = self.clock.now()
        return [h for h, t in self._last.items() if now - t <= self.timeout_s]


@dataclass
class StragglerMonitor:
    """Flags hosts whose median step time exceeds ``factor`` x the median of
    the hosts' medians.

    Samples are stamped with the injected ``clock``; ``max_age_s > 0`` also
    drops samples older than that horizon, so a host that was slow long ago
    is not flagged for ever. The serving fleet hedges a straggler's
    in-flight requests; a training supervisor may drop it from the mesh."""
    factor: float = 2.0
    window: int = 16
    max_age_s: float = 0.0           # 0 = keep the last `window` regardless
    clock: Clock = field(default_factory=SystemClock)
    _times: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)

    def record(self, host: str, step_time_s: float) -> None:
        self._times.setdefault(host, []).append(
            (self.clock.now(), float(step_time_s)))
        self._times[host] = self._times[host][-self.window:]

    def medians(self) -> Dict[str, float]:
        horizon = (self.clock.now() - self.max_age_s
                   if self.max_age_s > 0 else -np.inf)
        out = {}
        for h, samples in self._times.items():
            vals = [v for t, v in samples if t >= horizon]
            if vals:
                out[h] = float(np.median(vals))
        return out

    def stragglers(self) -> List[str]:
        med = self.medians()
        if len(med) < 2:
            return []
        fleet = float(np.median(list(med.values())))
        return [h for h, m in med.items() if m > self.factor * fleet]


def largest_feasible_mesh(n_devices: int, model_parallel: int,
                          prefer_pods: int = 1) -> Tuple[int, ...]:
    """Elastic re-mesh policy: keep the model axis whole (the parameter
    layout survives) and shrink data (and pod) parallelism to the largest
    multiple the survivors support. Returns (pod, data, model) or (data,
    model)."""
    if n_devices < model_parallel:
        raise ValueError(f"{n_devices} devices cannot keep a model axis of "
                         f"{model_parallel}")
    rest = n_devices // model_parallel
    if prefer_pods > 1 and rest % prefer_pods == 0 and rest >= 2 * prefer_pods:
        return (prefer_pods, rest // prefer_pods, model_parallel)
    return (rest, model_parallel)


@dataclass
class ElasticMeshManager:
    """Owns the current mesh shape; on failure, computes the next one."""
    total_devices: int
    model_parallel: int
    pods: int = 1
    failed: set = field(default_factory=set)

    def survivors(self) -> int:
        return self.total_devices - len(self.failed)

    def fail(self, device_ids: Sequence[int]) -> None:
        self.failed.update(device_ids)

    def heal(self, device_ids: Sequence[int]) -> None:
        self.failed.difference_update(device_ids)

    def current_shape(self) -> Tuple[int, ...]:
        """The largest data multiple of the model axis the survivors allow."""
        n = self.survivors()
        usable = (n // self.model_parallel) * self.model_parallel
        if usable == 0:
            raise RuntimeError("not enough survivors to keep the model axis")
        return largest_feasible_mesh(usable, self.model_parallel, self.pods)


class Supervisor:
    """Run a training loop with checkpoint and restart on failures.

    ``build_fn(mesh_shape) -> (step_fn, state, save_fn, restore_fn)``
    rebuilds the step for a shrunken mesh. An exception from ``step_fn`` is
    a node failure: the supervisor re-meshes over the survivors, restores
    the last committed checkpoint (``restore_fn(state) -> (state, step)``)
    and resumes, up to ``max_restarts`` times; past that the failure
    propagates. ``inject={step: device_ids}`` marks devices failed and
    raises at that step (tests)."""

    def __init__(self, mesh_mgr: ElasticMeshManager, build_fn: Callable,
                 checkpoint_every: int = 10, max_restarts: int = 8,
                 clock: Optional[Clock] = None):
        self.mesh_mgr = mesh_mgr
        self.build_fn = build_fn
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts
        self.restarts = 0
        self.clock = clock or SystemClock()
        self.stragglers = StragglerMonitor(clock=self.clock)
        self.heartbeats = HeartbeatMonitor(clock=self.clock)

    def run(self, total_steps: int,
            inject: Optional[Dict[int, Sequence[int]]] = None):
        """Train ``total_steps`` steps; returns (state, step, history), the
        history a list of (step, metrics)."""
        inject = dict(inject or {})
        shape = self.mesh_mgr.current_shape()
        step_fn, state, save_fn, restore_fn = self.build_fn(shape)
        step = 0
        history = []
        while step < total_steps:
            try:
                if step in inject:
                    self.mesh_mgr.fail(inject.pop(step))
                    raise RuntimeError("injected node failure")
                t0 = self.clock.now()
                state, metrics = step_fn(state, step)
                self.stragglers.record("host0", self.clock.now() - t0)
                history.append((step, metrics))
                step += 1
                if step % self.checkpoint_every == 0:
                    save_fn(state, step)
            except Exception:
                # the boundary that must keep training: any step failure is
                # a node failure, retried on a rebuilt mesh up to the budget
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                shape = self.mesh_mgr.current_shape()   # shrunken mesh
                step_fn, state, save_fn, restore_fn = self.build_fn(shape)
                state, step = restore_fn(state)
        return state, step, history
