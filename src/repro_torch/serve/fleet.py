"""Fault-tolerant serving fleet (counterpart of ``repro.serve.fleet``): a
router over N engine replicas with bounded admission, retries, hedging and
deterministic fault injection.

The paper's contract is a per-request latency budget on the sequential
recurrent decode path. One :class:`~repro_torch.serve.engine.ServeEngine`
keeps that budget per kernel; this module keeps it per request while
replicas crash, straggle and recover. A :class:`FleetRouter` owns N engine
replicas behind one ``submit()``/``generate()`` surface; the replica is
chosen per request at run time.

One cooperative scheduler, no wall-clock sleeps:

* **Bounded admission**: ``submit`` raises a typed :class:`FleetRejected`
  (``reason="queue_full"`` or ``"deadline_infeasible"``) instead of
  queueing without bound.
* **Routing**: per request, by prompt bucket and measured queue depth: the
  expected drain time is the decode tokens a replica still owes times its
  expected step time (its own recent measured steps, else the CostModel's
  measured row for its resolved decode backend, else a nominal constant),
  plus a penalty where the prompt's prefill bucket is cold on that replica.
  ``routing="static"`` (round robin) is the A/B arm.
* **Supervision**: every ``tick()`` the live replicas beat a
  :class:`~repro_torch.distributed.fault_tolerance.HeartbeatMonitor`; a
  replica that misses ``heartbeat_timeout_s`` of beats is dead, and its
  in-flight requests are requeued with exponential backoff under a retry
  budget, dispatched again from scratch (greedy decode is deterministic, so
  a retried stream equals the fault-free one). Step times feed a
  :class:`~repro_torch.distributed.fault_tolerance.StragglerMonitor`; a
  straggler's in-flight requests get a hedged duplicate on the fastest
  other replica, the first finisher wins and the loser's lane is cancelled.
  A restored replica re-enters the rotation with a rebuilt engine
  (:meth:`FleetReplica.restart`), its weights prepared on the device again.
* **Cancellation**: :meth:`FleetRouter.cancel` propagates a client
  disconnect: the ticket is tombstoned in the queue (an O(1) status flip;
  ``_dispatch_queued`` drops non-queued entries as it pops them), every
  live flight's lane is freed (``gru_wave_cancel``), hedges included, and
  the ticket ends ``"cancelled"`` (``reason="client_disconnect"``), never
  counted as completed or failed.
* **Deadlines**, end to end: a queued ticket whose deadline lapses is shed
  before dispatch, and an in-flight one is shed mid-decode with its lanes
  (hedges included) cancelled. Both count a ``"deadline"`` shed.
* **Async transport**: :class:`repro_torch.serve.async_frontend.
  AsyncFleetClient` wraps the router in an asyncio front end whose one
  worker thread runs every router call, so the router stays a
  single-threaded scheduler.
* **Autotuning** (``autotune=True``): one
  :class:`~repro_torch.serve.autotune.AutoTuner` per replica; its
  recalibration folds served timings into the shared CostModel, which the
  routing prior (``_step_cost_s``) reads live.
* **Fault injection**: a :class:`FaultInjector` holds a schedule of kill,
  restore, slow and delay events against the router's clock. Under a
  ``ManualClock`` the router advances virtual time ``tick_s`` a tick, so
  every failure path runs deterministically in the tests; under a
  ``SystemClock`` the same schedule drives a live run.

Virtual time (``ManualClock``): a replica with ``slow_factor=f`` runs one
decode step every f ticks and records ``tick_s * f`` as its step time.
Under a real clock the fleet is one process, so ``slow`` and ``delay``
inflate the recorded step signal only (detection and mitigation are real,
the slowdown simulated). Virtual time advances ``tick_s`` per service tick
only: ``generate()``'s backpressure pump runs ``tick(advance_time=False)``,
so waiting for a queue slot never ages queued tickets' deadlines or retry
backoffs (the clock still moves when a pump tick can make no progress,
e.g. every replica dead awaiting a scheduled restore).

No handler surrounds a replica's step: a kernel or launch failure inside
``tick()`` propagates to the caller. The only kill is the injector's.

Differences from the JAX module:

* the router takes ``device`` (the card unless the caller asks for the
  CPU), builds each replica with the port's ``ServeEngine`` signature, and
  ``ctxs`` default to ``NO_SHARD``;
* ``_step_cost_s`` lets only ``runtime.NoCapableBackend`` fall back to the
  nominal step time, so a CUDA or build error met while routing surfaces;
* a replica restored before its heartbeats declared it dead has its
  in-flight requests requeued at the restore (JAX's router leaves them on
  the rebuilt engine, which does not hold them, and never finishes them).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import cells
from repro_torch.core import runtime
from repro_torch.distributed.fault_tolerance import (Clock, HeartbeatMonitor,
                                                     ManualClock,
                                                     StragglerMonitor,
                                                     SystemClock)
from repro_torch.distributed.sharding import NO_SHARD, ShardCtx
from repro_torch.serve.autotune import AutoTuneConfig, AutoTuner
from repro_torch.serve.engine import Request, ServeEngine, _mean, _pct


class FleetRejected(RuntimeError):
    """Typed admission rejection: load is shed with a reason, never by
    silent unbounded queueing. ``reason`` is one of ``"queue_full"``,
    ``"deadline_infeasible"``, ``"deadline"`` (and ``"shutdown"`` from the
    async front end)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


@dataclass
class FaultEvent:
    """One scheduled fault: fires when the router clock reaches ``t``."""
    t: float
    kind: str                        # "kill" | "restore" | "slow" | "delay"
    replica: str
    factor: float = 1.0              # slow: service-time multiplier
    delay_s: float = 0.0             # delay: one-off added service time


class FaultInjector:
    """Deterministic fault schedule, drained against the router's clock.

    An event applies at the first tick whose clock time reaches
    ``event.t``; under a ``ManualClock`` that instant is exact and
    reproducible."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self._events = sorted(events, key=lambda e: (e.t, e.replica, e.kind))
        self._i = 0
        self.applied: List[FaultEvent] = []

    def __len__(self) -> int:
        return len(self._events) - self._i

    @property
    def events(self) -> List[FaultEvent]:
        """The whole schedule, in firing order."""
        return list(self._events)

    def due(self, now: float) -> List[FaultEvent]:
        out = []
        while self._i < len(self._events) and self._events[self._i].t <= now:
            out.append(self._events[self._i])
            self._i += 1
        self.applied.extend(out)
        return out

    @classmethod
    def seeded(cls, seed: int, replica_names: Sequence[str],
               horizon_s: float, kill_prob: float = 0.6,
               slow_prob: float = 0.4, slow_factor: float = 6.0,
               t0: float = 0.0) -> "FaultInjector":
        """A reproducible random schedule (numpy's ``default_rng(seed)``,
        drawn in JAX's order, so the two packages give the same events):
        each replica independently gets a kill->restore window (prob
        ``kill_prob``) and/or a slow window (prob ``slow_prob``) inside the
        horizon. Every kill is paired with a restore, so a seeded schedule
        can stall the fleet but never strand it."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for name in replica_names:
            if rng.random() < kill_prob:
                t_kill = t0 + horizon_s * rng.uniform(0.1, 0.5)
                t_back = t_kill + horizon_s * rng.uniform(0.15, 0.4)
                events.append(FaultEvent(t=t_kill, kind="kill", replica=name))
                events.append(FaultEvent(t=t_back, kind="restore",
                                         replica=name))
            if rng.random() < slow_prob:
                t_slow = t0 + horizon_s * rng.uniform(0.1, 0.6)
                t_fast = t_slow + horizon_s * rng.uniform(0.1, 0.3)
                events.append(FaultEvent(t=t_slow, kind="slow", replica=name,
                                         factor=slow_factor))
                events.append(FaultEvent(t=t_fast, kind="slow", replica=name,
                                         factor=1.0))
        return cls(events)


@dataclass
class FleetConfig:
    """Router policy knobs (all times in clock seconds)."""
    queue_limit: int = 64            # bound on outstanding (queued+in-flight)
    retry_budget: int = 3            # re-dispatches after replica death
    backoff_base_s: float = 0.02     # retry n waits base * 2^(n-1)
    heartbeat_timeout_s: float = 0.25
    straggler_factor: float = 3.0
    straggler_window: int = 8
    hedge: bool = True               # duplicate-dispatch straggler requests
    routing: str = "depth"           # "depth" (measured) | "static" (RR)
    tick_s: float = 0.01             # virtual seconds per tick (ManualClock)
    nominal_step_s: float = 1e-3     # expected step time with no signal
    bucket_penalty_s: float = 0.05   # routing cost of a cold prefill bucket


# identity semantics: tickets live in queues and lists searched with
# ``in``/``remove``, and field-wise eq would compare the numpy prompts
@dataclass(eq=False)
class FleetTicket:
    """One admitted request's lifecycle in the fleet. ``id`` is the
    router-assigned request id, the handle a client passes back to
    :meth:`FleetRouter.cancel` on disconnect."""
    request: Request
    t_submit: float
    id: int = -1
    deadline_s: Optional[float] = None    # relative to t_submit
    status: str = "queued"   # queued|inflight|done|shed|failed|cancelled
    reason: Optional[str] = None
    retries: int = 0
    hedged: bool = False
    not_before: float = 0.0          # backoff gate (clock time)
    t_first_dispatch: Optional[float] = None
    t_done: Optional[float] = None
    replicas: List[str] = field(default_factory=list)   # dispatch history
    flights: List["_Flight"] = field(default_factory=list)

    @property
    def outstanding(self) -> bool:
        return self.status in ("queued", "inflight")


@dataclass(eq=False)                     # identity, as FleetTicket
class _Flight:
    """One dispatch attempt: a fresh clone of the ticket's request served
    by one replica (retries and hedges each get their own, so a half-decoded
    attempt never leaks partial output into the result)."""
    ticket: FleetTicket
    replica: "FleetReplica"
    clone: Request
    hedge: bool = False


class FleetReplica:
    """One supervised engine replica. ``build_engine`` builds it anew on
    restart: ``ServeEngine.__init__`` prepares the weights on the device
    again, so a recovered replica re-enters the rotation with its weights
    placed, not on the request path. The kernel libraries are loaded once
    per process and are not built again; the dropped engine (its params
    and wave cache) is referenced by nothing once replaced."""

    def __init__(self, name: str, build_engine: Callable[[], ServeEngine]):
        self.name = name
        self._build = build_engine
        self.engine = build_engine()
        self.alive = True
        self.slow_factor = 1.0
        self.pending_delay_s = 0.0
        self.restarts = 0
        self.steps = 0
        self.flights: List[_Flight] = []
        self._sim_credit = 0.0       # ManualClock: fractional step budget

    def kill(self) -> None:
        """Simulated crash: stops beating and stepping; its wave state is
        lost (the rebuilt engine starts empty, like a restarted process)."""
        self.alive = False

    def restart(self) -> None:
        """Re-enter the rotation: a fresh engine, weights prepared again."""
        self.engine = None           # drop the old engine's tensors first
        self.engine = self._build()
        self.alive = True
        self.slow_factor = 1.0
        self.pending_delay_s = 0.0
        self._sim_credit = 0.0
        self.flights = []
        self.restarts += 1


class FleetRouter:
    """Front door for N ServeEngine replicas: bounded admission, depth-aware
    routing, retry and hedging, fault supervision.

    ``submit()`` enqueues and returns a :class:`FleetTicket` at once (or
    raises :class:`FleetRejected`); ``tick()`` advances the whole fleet one
    scheduler round; ``run_until_done()`` pumps ticks until nothing is
    outstanding; ``generate(requests)`` does all of it in one call.
    ``device`` is where every replica runs (the card unless the caller asks
    for the CPU); ``ctxs`` one :class:`ShardCtx` per replica (``NO_SHARD``
    by default)."""

    def __init__(self, cfg, params, *, replicas: int = 2,
                 ctxs: Optional[Sequence[ShardCtx]] = None,
                 max_batch: int = 4, bucket_min: int = 8,
                 clock: Optional[Clock] = None,
                 config: FleetConfig = FleetConfig(),
                 injector: Optional[FaultInjector] = None,
                 autotune: bool = False,
                 tuner_config: Optional[AutoTuneConfig] = None,
                 device="cuda"):
        if not cells.is_cell_family(cfg.family):
            raise NotImplementedError("the fleet serves registered cell "
                                      "families (stepwise waves: "
                                      f"{sorted(cells.families())}); "
                                      "use ServeEngine directly for LM "
                                      "batches")
        self.cfg = cfg
        self.config = config
        self.device = resolve_device(device)
        self.clock = clock or SystemClock()
        self.injector = injector
        self.max_batch = max_batch
        # autotune=True attaches one AutoTuner per replica (each engine
        # tunes to its own traffic; recalibration feeds the shared
        # CostModel, which _step_cost_s reads live). A restarted replica
        # gets a fresh tuner, as its executables are fresh.
        self.autotune = bool(autotune)
        ctxs = list(ctxs) if ctxs is not None else [NO_SHARD] * replicas
        if len(ctxs) != replicas:
            raise ValueError(f"{len(ctxs)} ctxs for {replicas} replicas")

        def _builder(ctx):
            def build():
                tuner = (AutoTuner(tuner_config or AutoTuneConfig())
                         if self.autotune else None)
                return ServeEngine(cfg, params, max_batch=max_batch,
                                   clock=self.clock, device=self.device,
                                   ctx=ctx, bucket_min=bucket_min,
                                   tuner=tuner)
            return build

        self.replicas = [FleetReplica(f"replica{i}", _builder(ctx))
                         for i, ctx in enumerate(ctxs)]
        self._by_name = {r.name: r for r in self.replicas}
        self.heartbeats = HeartbeatMonitor(
            timeout_s=config.heartbeat_timeout_s, clock=self.clock)
        self.stragglers = StragglerMonitor(
            factor=config.straggler_factor, window=config.straggler_window,
            clock=self.clock)
        for r in self.replicas:
            self.heartbeats.beat(r.name)
        self.tickets: List[FleetTicket] = []
        self._by_id: Dict[int, FleetTicket] = {}
        self._next_id = 0
        self._queue: deque = deque()
        self._deadlined: List[FleetTicket] = []  # outstanding w/ deadline_s
        self._outstanding = 0
        self._rr = -1                # static round-robin cursor
        self.ticks = 0
        self.counters: Dict[str, int] = {
            "submitted": 0, "completed": 0, "failed": 0, "retries": 0,
            "cancelled": 0, "hedges": 0, "hedges_cancelled": 0, "kills": 0,
            "restores": 0}
        self.sheds: Dict[str, int] = {}
        self._e2e: List[float] = []
        self._queue_waits: List[float] = []

    # -- admission -----------------------------------------------------------

    def submit(self, request: Request,
               deadline_s: Optional[float] = None) -> FleetTicket:
        """Admit one request (non-blocking). Raises :class:`FleetRejected`
        when the outstanding set is at ``queue_limit`` or a requested
        deadline cannot be met even on the least-loaded replica."""
        now = self.clock.now()
        if self._outstanding >= self.config.queue_limit:
            self.sheds["queue_full"] = self.sheds.get("queue_full", 0) + 1
            raise FleetRejected("queue_full",
                                f"{self._outstanding} outstanding >= "
                                f"limit {self.config.queue_limit}")
        if deadline_s is not None:
            est = self._estimated_service_s(request)
            if est > deadline_s:
                self.sheds["deadline_infeasible"] = (
                    self.sheds.get("deadline_infeasible", 0) + 1)
                raise FleetRejected(
                    "deadline_infeasible",
                    f"estimated {est:.4f}s > deadline {deadline_s:.4f}s")
        if request.t_submit is None:
            request.t_submit = now
        t = FleetTicket(request=request, t_submit=now, id=self._next_id,
                        deadline_s=deadline_s)
        self._next_id += 1
        self._by_id[t.id] = t
        self.tickets.append(t)
        self._queue.append(t)
        if deadline_s is not None:
            self._deadlined.append(t)
        self._outstanding += 1
        self.counters["submitted"] += 1
        return t

    def cancel(self, handle) -> bool:
        """Client-disconnect propagation: drop an outstanding request
        everywhere it lives: the queue, the owning replica's wave lane
        (:meth:`ServeEngine.gru_wave_cancel`) and any hedged duplicate on
        another replica. ``handle`` may be the :class:`FleetTicket`, its
        integer ``id`` or the original :class:`Request`. Returns False when
        the ticket is not outstanding (a disconnect after completion is a
        no-op: the result is already in ``request.out``).

        A queued ticket is tombstoned, not removed: the status flip is O(1)
        and ``_dispatch_queued`` drops the stale entry on its next pass."""
        t = self._find_ticket(handle)
        if t is None or not t.outstanding:
            return False
        self._release_flights(t)
        t.status = "cancelled"
        t.reason = "client_disconnect"
        t.t_done = self.clock.now()
        self._outstanding -= 1
        self.counters["cancelled"] += 1
        return True

    def _release_flights(self, t: FleetTicket) -> None:
        """Free every live lane a ticket holds (cancel and deadline shed);
        a dead replica's engine is rebuilt on restore anyway, so a missed
        wave cancel there is harmless. Cancelled hedges are counted."""
        for fl in list(t.flights):
            fl.replica.engine.gru_wave_cancel(fl.clone)
            if fl in fl.replica.flights:
                fl.replica.flights.remove(fl)
            t.flights.remove(fl)
            if fl.hedge:
                self.counters["hedges_cancelled"] += 1

    def _find_ticket(self, handle) -> Optional[FleetTicket]:
        if isinstance(handle, FleetTicket):
            return handle
        if isinstance(handle, (int, np.integer)):
            return self._by_id.get(int(handle))
        for t in reversed(self.tickets):     # a Request: newest wins
            if t.request is handle:
                return t
        return None

    def generate(self, requests: Sequence[Request],
                 deadline_s: Optional[float] = None) -> List[Request]:
        """Admit everything (pumping ticks while the bounded queue is full:
        backpressure, not rejection) and serve to completion. Results land
        in ``request.out``, as with a single engine."""
        for r in requests:
            pumped = 0
            # waiting for admission is not service time: these ticks do not
            # advance virtual time, unless a round performed no decode step
            # at all (every replica dead or gated), when time must move for
            # scheduled restores and backoffs to fire
            while self._outstanding >= self.config.queue_limit:
                if self.tick(advance_time=False) == 0 and isinstance(
                        self.clock, ManualClock):
                    self.clock.advance(self.config.tick_s)
                pumped += 1
                if pumped > 200_000:
                    raise RuntimeError(
                        "fleet queue never drained during generate()")
            self.submit(r, deadline_s=deadline_s)
        self.run_until_done()
        return list(requests)

    # -- scheduler -----------------------------------------------------------

    def run_until_done(self, max_ticks: int = 200_000) -> None:
        """Pump ``tick()`` until no ticket is outstanding. ``max_ticks``
        bounds broken schedules (a kill with no restore and no survivor)
        with a loud error instead of a hang."""
        n = 0
        while any(t.outstanding for t in self.tickets):
            self.tick()
            n += 1
            if n > max_ticks:
                raise RuntimeError(
                    f"fleet did not converge in {max_ticks} ticks: "
                    f"{sum(t.outstanding for t in self.tickets)} outstanding,"
                    f" alive={[r.name for r in self.replicas if r.alive]}")

    def tick(self, advance_time: bool = True) -> int:
        """One scheduler round: advance virtual time, apply due faults,
        beat, detect and requeue, shed lapsed deadlines, dispatch, step
        every live replica one decode step, hedge stragglers. Returns the
        number of decode steps performed.

        ``advance_time=False`` (``generate()``'s admission pump) runs the
        full round without consuming ManualClock time; under a SystemClock
        the flag is inert."""
        self.ticks += 1
        if advance_time and isinstance(self.clock, ManualClock):
            self.clock.advance(self.config.tick_s)
        now = self.clock.now()
        if self.injector is not None:
            for ev in self.injector.due(now):
                self._apply_event(ev, now)
        for rep in self.replicas:
            if rep.alive:
                self.heartbeats.beat(rep.name)
        dead = set(self.heartbeats.dead_hosts())
        for rep in self.replicas:
            if rep.name in dead and rep.flights:
                self._on_replica_down(rep, now)
        self._shed_lapsed(now)
        self._dispatch_queued(now)
        stepped = 0
        for rep in self.replicas:
            stepped += self._step_replica(rep)
        if self.config.hedge:
            self._hedge_stragglers(now)
        return stepped

    def _apply_event(self, ev: FaultEvent, now: float) -> None:
        rep = self._by_name[ev.replica]
        if ev.kind == "kill":
            if rep.alive:
                rep.kill()
                self.counters["kills"] += 1
        elif ev.kind == "restore":
            if not rep.alive:
                # restored before the heartbeats declared it dead: the
                # rebuilt engine has none of its lanes, so its flights are
                # requeued now (JAX's router drops them and never finishes
                # those tickets)
                if rep.flights:
                    self._on_replica_down(rep, now)
                rep.restart()
                self.heartbeats.beat(rep.name)   # back in the rotation
                self.counters["restores"] += 1
        elif ev.kind == "slow":
            rep.slow_factor = float(ev.factor)
        elif ev.kind == "delay":
            rep.pending_delay_s += float(ev.delay_s)
        else:
            raise ValueError(f"unknown fault kind: {ev.kind!r}")

    def _on_replica_down(self, rep: FleetReplica, now: float) -> None:
        """Requeue a dead replica's in-flight requests: each ticket re-enters
        the queue from scratch with exponential backoff, up to the retry
        budget. A ticket whose hedge still runs on another replica just
        loses this flight."""
        for fl in rep.flights:
            t = fl.ticket
            if fl in t.flights:
                t.flights.remove(fl)
            if t.status != "inflight":
                continue
            if any(f.replica.alive for f in t.flights):
                continue                         # hedge still racing
            t.retries += 1
            if t.retries > self.config.retry_budget:
                t.status = "failed"
                t.reason = "retry_budget"
                self._outstanding -= 1
                self.counters["failed"] += 1
                continue
            t.status = "queued"
            t.not_before = now + (self.config.backoff_base_s
                                  * 2 ** (t.retries - 1))
            self._queue.append(t)
            self.counters["retries"] += 1
        rep.flights = []

    def _shed_lapsed(self, now: float) -> None:
        """End-to-end deadlines: shed every outstanding ticket whose age
        exceeds its deadline; queued ones are tombstoned, in-flight ones
        have their lanes (hedges included) cancelled. Only tickets with a
        deadline live on ``_deadlined``, so this scans neither the queue
        nor the history."""
        if not self._deadlined:
            return
        still: List[FleetTicket] = []
        for t in self._deadlined:
            if not t.outstanding:
                continue                     # resolved some other way
            if now - t.t_submit > t.deadline_s:
                self._release_flights(t)     # no-op for queued tickets
                t.status = "shed"
                t.reason = "deadline"
                t.t_done = now
                self._outstanding -= 1
                self.sheds["deadline"] = self.sheds.get("deadline", 0) + 1
            else:
                still.append(t)
        self._deadlined = still

    def _dispatch_queued(self, now: float) -> None:
        alive = [r for r in self.replicas if r.alive]
        if not alive:
            return
        held = []
        while self._queue:
            t = self._queue.popleft()
            if t.status != "queued":
                continue                     # a tombstone, dropped here
            if t.not_before > now:
                held.append(t)               # backoff not elapsed
                continue
            self._dispatch(t, self._route(t, alive), now)
        self._queue.extend(held)

    def _dispatch(self, t: FleetTicket, rep: FleetReplica, now: float,
                  hedge: bool = False) -> None:
        r = t.request
        clone = Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                        eos_id=r.eos_id, stream=r.stream)
        fl = _Flight(ticket=t, replica=rep, clone=clone, hedge=hedge)
        t.flights.append(fl)
        rep.flights.append(fl)
        t.status = "inflight"
        t.replicas.append(rep.name)
        if t.t_first_dispatch is None:
            t.t_first_dispatch = now
            self._queue_waits.append(now - t.t_submit)
        rep.engine.gru_wave_enqueue([clone])

    def _step_replica(self, rep: FleetReplica) -> int:
        """Advance one replica one decode step; 1 if it stepped (the tick's
        progress signal), else 0. The step's errors propagate."""
        if not rep.alive or rep.engine.gru_wave_active() == 0:
            return 0
        sim = isinstance(self.clock, ManualClock)
        if sim and rep.slow_factor > 1.0:
            # a straggler runs fewer steps per unit of virtual time
            rep._sim_credit += 1.0 / rep.slow_factor
            if rep._sim_credit < 1.0:
                return 0
            rep._sim_credit -= 1.0
        t0 = self.clock.now()
        finished = rep.engine.gru_wave_step()
        measured = self.clock.now() - t0
        if sim:
            dt = self.config.tick_s * rep.slow_factor + rep.pending_delay_s
        else:
            dt = measured * rep.slow_factor + rep.pending_delay_s
        rep.pending_delay_s = 0.0
        rep.steps += 1
        self.stragglers.record(rep.name, dt)
        for clone in finished:
            for fl in list(rep.flights):
                if fl.clone is clone:
                    self._resolve(fl)
                    break
        return 1

    def _resolve(self, fl: _Flight) -> None:
        """The first finisher wins the ticket: copy the clone's stream into
        the user's request and cancel every other flight (hedge losers)."""
        t = fl.ticket
        fl.replica.flights.remove(fl)
        if fl in t.flights:
            t.flights.remove(fl)
        if t.status != "inflight":
            return                               # already resolved or shed
        t.request.out = list(fl.clone.out)
        t.request.done = True
        t.request.t_finish = fl.clone.t_finish
        t.status = "done"
        t.t_done = self.clock.now()
        self._outstanding -= 1
        self.counters["completed"] += 1
        self._e2e.append(t.t_done - t.t_submit)
        for other in list(t.flights):
            other.replica.engine.gru_wave_cancel(other.clone)
            if other in other.replica.flights:
                other.replica.flights.remove(other)
            t.flights.remove(other)
            self.counters["hedges_cancelled"] += 1

    def _hedge_stragglers(self, now: float) -> None:
        strag = set(self.stragglers.stragglers())
        if not strag:
            return
        fast = [r for r in self.replicas
                if r.alive and r.name not in strag]
        if not fast:
            return
        for rep in self.replicas:
            if rep.name not in strag:
                continue
            for fl in list(rep.flights):
                t = fl.ticket
                if t.hedged or t.status != "inflight" or len(t.flights) > 1:
                    continue
                target = min(fast, key=lambda r: self._expected_wait_s(r))
                t.hedged = True
                self.counters["hedges"] += 1
                self._dispatch(t, target, now, hedge=True)

    # -- routing -------------------------------------------------------------

    def _route(self, t: FleetTicket, alive: List[FleetReplica]
               ) -> FleetReplica:
        if self.config.routing == "static":
            self._rr = (self._rr + 1) % len(alive)
            return alive[self._rr]
        S = int(np.asarray(t.request.prompt).reshape(
            -1, self.cfg.gru.input_dim).shape[0])

        def score(rep: FleetReplica) -> float:
            s = self._expected_wait_s(rep)
            if not rep.engine.bucket_warm(S):
                s += self.config.bucket_penalty_s
            return s

        return min(alive, key=score)

    def _expected_wait_s(self, rep: FleetReplica) -> float:
        """Expected time for this replica to drain its outstanding work:
        decode tokens owed x expected step time / slots."""
        _, tokens = rep.engine.gru_work_remaining()
        return (tokens / max(1, self.max_batch)) * self._step_cost_s(rep)

    def _step_cost_s(self, rep: FleetReplica) -> float:
        """The replica's expected decode step: the median of its recent
        measured steps, else the CostModel's measured row for the decode
        backend it resolves to, else ``nominal_step_s``; times its slow
        factor. Only ``NoCapableBackend`` (no decode backend at this shape)
        falls back to the nominal time: any other error propagates."""
        recent = rep.engine.step_times[-self.config.straggler_window:]
        med = float(np.median(recent)) if recent else 0.0
        if med > 0.0:
            return med * rep.slow_factor
        step = self.config.nominal_step_s
        g = self.cfg.gru
        try:
            exe = runtime.compile(g, batch=self.max_batch, mode="decode",
                                  placement=rep.engine.ctx.mesh)
        except runtime.NoCapableBackend:
            return step * rep.slow_factor
        us = runtime.cost_model().lookup(
            exe.decode_backend, "decode", depth=g.num_layers,
            batch=self.max_batch, hidden=g.hidden_dim,
            family=cells.cfg_family(g))
        if us is not None:
            step = us * 1e-6
        return step * rep.slow_factor

    def _estimated_service_s(self, request: Request) -> float:
        """Admission-time completion estimate on the least-loaded replica
        (queue drain + the request's own decode tokens)."""
        alive = [r for r in self.replicas if r.alive]
        if not alive:
            return float("inf")
        return min(self._expected_wait_s(r)
                   + max(1, request.max_new_tokens) * self._step_cost_s(r)
                   for r in alive)

    # -- stats ---------------------------------------------------------------

    def stats(self) -> dict:
        """Fleet accounting and per-replica engine latency stats. The e2e
        percentiles include fleet queueing, retries and hedging: the
        per-request numbers the paper's deadline is judged by. A fleet that
        completed nothing reports NaN percentiles, never 0.0: check
        ``completed`` before trusting the tails."""
        per_replica = {}
        for rep in self.replicas:
            ls = rep.engine.latency_stats()
            at = ls["autotune"]
            per_replica[rep.name] = {
                "alive": rep.alive, "restarts": rep.restarts,
                "steps": rep.steps, "slow_factor": rep.slow_factor,
                "decode_p50_s": ls["p50_s"], "decode_p99_s": ls["p99_s"],
                "queue_wait_p99_s": ls["queue_wait_p99_s"],
                "requests": ls["requests"],
                # the tuned shape (the decision records stay on the engine:
                # latency_stats()["autotune"]["decisions"])
                "wave_size": at["wave_size"],
                "bucket_ladder": at["bucket_ladder"],
                "retunes": at.get("retunes", 0)}
        return {**self.counters,
                "shed": dict(self.sheds),
                "outstanding": self._outstanding,
                "ticks": self.ticks,
                "routing": self.config.routing,
                "autotune": self.autotune,
                "e2e_mean_s": _mean(self._e2e),
                "e2e_p50_s": _pct(self._e2e, 50),
                "e2e_p99_s": _pct(self._e2e, 99),
                "queue_wait_p50_s": _pct(self._queue_waits, 50),
                "queue_wait_p99_s": _pct(self._queue_waits, 99),
                "replicas": per_replica}
