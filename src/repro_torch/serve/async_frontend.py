"""Asyncio front end for the serving fleet (counterpart of
``repro.serve.async_frontend``): concurrent clients over the cooperative
:class:`~repro_torch.serve.fleet.FleetRouter` scheduler.

The router is a single-threaded scheduler (``submit()`` enqueues, ``tick()``
advances the whole fleet one round). :class:`AsyncFleetClient` owns its tick
loop in one background asyncio task and gives clients coroutines:

* **``submit()`` / ``generate()``**: any number of client coroutines submit
  concurrently; ``FleetRejected`` raises into the awaiting client, and with
  ``wait=True`` a full queue becomes async backpressure instead.
* **Per-token streaming**: ``async for tok in handle`` yields tokens as the
  fleet decodes them. Mid-flight tokens are read from the ticket's live
  flights; greedy decode is deterministic, so every flight (retries and
  hedges included) makes the same prefix, and the stream follows the one
  furthest ahead without emitting a token the result will not hold.
* **One worker thread for the blocking step**: each ``tick()`` runs the
  engines' decode steps (kernel launches, then a synchronize of the card)
  on a single worker thread (``run_in_executor``), so the event loop never
  waits on the card. Every router call (submit, cancel, tick) goes through
  that one worker: the router stays single-threaded and takes no locks. On
  the card the worker starts with the router's device as its current CUDA
  device (the wrappers launch on the current stream of the tensors'
  device, and check that it is the current one).
* **Client-disconnect propagation**: cancelling the consuming task (or
  abandoning the stream) routes into :meth:`FleetRouter.cancel`: the
  ticket leaves the queue, its lanes and hedges are freed and
  ``cancelled`` counts it.
* **Graceful drain and shutdown**: ``async with`` (or ``aclose()``) stops
  accepting work, pumps the scheduler until nothing is outstanding, then
  stops the tick task and joins the worker thread.

The front end adds no timing of its own: all fleet timing flows through the
router's Clock. Under a ``ManualClock`` the scheduler ticks back to back
with ``asyncio.sleep(0)`` yields only (no wall-clock sleep); under a
``SystemClock``, ``tick_interval_s`` may pace the loop. With no work
outstanding the scheduler waits on an event until a submit, a disconnect
or a close wakes it.

Token streams equal the synchronous path's: the router's mechanics are
unchanged, and a request's greedy decode does not depend on how admissions
interleave.
"""
from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from typing import AsyncIterator, List, Optional, Sequence

import torch

from repro_torch.distributed.fault_tolerance import ManualClock
from repro_torch.serve.engine import Request
from repro_torch.serve.fleet import FleetRejected, FleetRouter, FleetTicket

_DONE = object()                     # end-of-stream sentinel


class AsyncTicket:
    """One client's handle on an admitted request: the underlying
    :class:`FleetTicket` and an async token stream. Single consumer: iterate
    it (``async for tok in handle``) or ``await handle.result()``. Dropping
    the iterator mid-stream (task cancelled, ``break`` and close) is a
    client disconnect and cancels the request fleet-wide."""

    def __init__(self, client: "AsyncFleetClient", ticket: FleetTicket):
        self._client = client
        self.ticket = ticket
        self.request = ticket.request
        self._q: asyncio.Queue = asyncio.Queue()
        self._emitted = 0            # tokens already pushed to the stream

    @property
    def id(self) -> int:
        return self.ticket.id

    @property
    def status(self) -> str:
        return self.ticket.status

    def __aiter__(self) -> AsyncIterator[int]:
        return self._tokens()

    async def _tokens(self) -> AsyncIterator[int]:
        try:
            while True:
                item = await self._q.get()
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        except (asyncio.CancelledError, GeneratorExit):
            # the consumer went away mid-stream: a client disconnect. No
            # awaits while unwinding a cancelled frame: hand the ticket to
            # the scheduler task, which cancels it before its next tick
            self._client._abandon(self)
            raise

    async def result(self) -> Request:
        """Drain the stream and return the completed request (tokens in
        ``request.out``). Raises :class:`FleetRejected` if the ticket was
        shed (lapsed deadline) or failed (retry budget) mid-flight."""
        async for _ in self:
            pass
        return self.request


def _bind_device(index: int) -> None:
    torch.cuda.set_device(index)


class AsyncFleetClient:
    """Asyncio transport over one :class:`FleetRouter`. Use as an async
    context manager::

        async with AsyncFleetClient(router) as client:
            handle = await client.submit(req)          # or client.generate
            async for tok in handle: ...

    ``tick_interval_s`` paces the scheduler under a real clock (ignored
    under ``ManualClock``, where ticks are virtual time and run back to
    back). ``max_stall_ticks`` bounds a fleet that stops making progress (a
    kill with no restore and no survivor) with an error into every live
    stream instead of a hang: the counterpart of
    ``run_until_done(max_ticks=...)``."""

    def __init__(self, router: FleetRouter, *, tick_interval_s: float = 0.0,
                 max_stall_ticks: int = 200_000):
        self.router = router
        self.tick_interval_s = float(tick_interval_s)
        self.max_stall_ticks = int(max_stall_ticks)
        # one worker: every router call runs on this thread, which keeps
        # the lockless router sound under asyncio. On the card it takes the
        # router's device as its current device before its first call.
        init, args = None, ()
        dev = router.device
        if dev.type == "cuda":
            init = _bind_device
            args = (dev.index if dev.index is not None
                    else torch.cuda.current_device(),)
        self._exec = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="fleet-tick",
                                        initializer=init, initargs=args)
        self._streams: dict = {}             # ticket id -> AsyncTicket
        self._abandoned: List[FleetTicket] = []
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._idle: Optional[asyncio.Event] = None
        self._slot_free: Optional[asyncio.Event] = None
        self._accepting = True
        self._closed = False

    # -- lifecycle -----------------------------------------------------------

    async def __aenter__(self) -> "AsyncFleetClient":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose(drain=exc == (None, None, None))

    async def start(self) -> None:
        """Start the background scheduler task (idempotent)."""
        if self._task is not None:
            return
        self._wake = asyncio.Event()
        self._idle = asyncio.Event()
        self._idle.set()
        self._slot_free = asyncio.Event()
        self._task = asyncio.get_running_loop().create_task(
            self._scheduler(), name="fleet-scheduler")

    async def drain(self) -> None:
        """Wait until the fleet has nothing outstanding (queued or in
        flight). New submits are still accepted: a barrier, not a
        shutdown."""
        if self._task is None:
            return
        self._wake.set()
        await self._idle.wait()

    async def aclose(self, drain: bool = True) -> None:
        """Graceful shutdown: refuse new submits, optionally drain every
        outstanding request, then stop the scheduler task and join the
        worker thread. ``drain=False`` abandons outstanding work (their
        streams end with an error)."""
        self._accepting = False
        if self._task is None:
            self._exec.shutdown(wait=True)
            return
        if drain:
            await self.drain()
        self._closed = True
        self._wake.set()
        try:
            await self._task
        finally:
            self._task = None
            self._exec.shutdown(wait=True)
        if not drain:
            self._broadcast(FleetRejected(
                "shutdown", "client closed without draining"))

    # -- client surface ------------------------------------------------------

    async def submit(self, request: Request,
                     deadline_s: Optional[float] = None,
                     wait: bool = True) -> AsyncTicket:
        """Admit one request; returns its :class:`AsyncTicket`.
        ``FleetRejected`` raises into the caller as the synchronous
        ``submit`` does; with ``wait=True`` (default) a full queue is
        backpressure: the coroutine waits until a slot frees (completions
        and cancellations signal it) and tries again.
        ``deadline_infeasible`` always raises."""
        if not self._accepting:
            raise RuntimeError("AsyncFleetClient is closing")
        await self.start()
        loop = asyncio.get_running_loop()
        while True:
            fut = loop.run_in_executor(
                self._exec, self.router.submit, request, deadline_s)
            try:
                ticket = await asyncio.shield(fut)
                break
            except asyncio.CancelledError:
                # the client disconnected during admission: the executor
                # call cannot be recalled, so if it landed, the scheduler
                # cancels the ticket (no request served without a consumer)
                def _cleanup(f):
                    if not f.cancelled() and f.exception() is None:
                        self._abandoned.append(f.result())
                        if self._wake is not None:
                            self._wake.set()
                fut.add_done_callback(_cleanup)
                raise
            except FleetRejected as e:
                if not wait or e.reason != "queue_full":
                    raise
                self._slot_free.clear()
                self._wake.set()         # keep the scheduler serving
                await self._slot_free.wait()
        handle = AsyncTicket(self, ticket)
        self._streams[ticket.id] = handle
        self._idle.clear()
        self._wake.set()
        return handle

    async def generate(self, request: Request,
                       deadline_s: Optional[float] = None) -> Request:
        """Submit and drain: returns the completed request. Cancelling the
        awaiting task mid-stream is a client disconnect."""
        handle = await self.submit(request, deadline_s=deadline_s)
        return await handle.result()

    async def cancel(self, handle: AsyncTicket) -> bool:
        """Cancel an outstanding request (the programmatic disconnect): the
        handle's stream ends early; returns what
        :meth:`FleetRouter.cancel` returned."""
        loop = asyncio.get_running_loop()
        ok = await loop.run_in_executor(
            self._exec, self.router.cancel, handle.ticket)
        self._wake.set()
        return bool(ok)

    def _abandon(self, handle: AsyncTicket) -> None:
        """A consumer disappeared mid-stream. Synchronous on purpose (called
        while a cancelled frame unwinds): the scheduler task calls
        ``router.cancel`` before its next tick."""
        self._streams.pop(handle.ticket.id, None)
        self._abandoned.append(handle.ticket)
        if self._wake is not None:
            self._wake.set()

    # -- the scheduler task --------------------------------------------------

    def _progress_sig(self) -> tuple:
        c = self.router.counters
        return (c["completed"], c["failed"], c["cancelled"],
                sum(self.router.sheds.values()), self.router._outstanding)

    async def _scheduler(self) -> None:
        """The one owner of the router's tick loop. Each round: pass pending
        disconnects to ``router.cancel``, run one ``tick()`` on the worker
        thread, publish new tokens to every live stream, signal freed queue
        slots, then yield. Waits on an event while nothing is
        outstanding."""
        loop = asyncio.get_running_loop()
        manual = isinstance(self.router.clock, ManualClock)
        sig, stalled = self._progress_sig(), 0
        while True:
            while self._abandoned:
                t = self._abandoned.pop()
                await loop.run_in_executor(self._exec, self.router.cancel, t)
            if self.router._outstanding == 0:
                self._idle.set()
                self._slot_free.set()
                if self._closed:
                    return
                self._wake.clear()
                await self._wake.wait()
                continue
            self._idle.clear()
            await loop.run_in_executor(self._exec, self.router.tick)
            self._publish()
            if self.router._outstanding < self.router.config.queue_limit:
                self._slot_free.set()
            now_sig = self._progress_sig()
            stalled = 0 if now_sig != sig else stalled + 1
            sig = now_sig
            if stalled > self.max_stall_ticks:
                err = RuntimeError(
                    f"fleet made no progress in {self.max_stall_ticks} "
                    f"ticks: {self.router._outstanding} outstanding, alive="
                    f"{[r.name for r in self.router.replicas if r.alive]}")
                self._broadcast(err)
                self._idle.set()
                raise err
            if self.tick_interval_s > 0.0 and not manual:
                await asyncio.sleep(self.tick_interval_s)
            else:
                # let clients submit and consume between ticks; never a
                # wall-clock sleep under a ManualClock
                await asyncio.sleep(0)

    def _publish(self) -> None:
        """Move new tokens into each live stream. Runs on the event loop
        between executor calls, so it never races a tick. In-flight tokens
        come from the ticket's furthest-ahead flight; a final status pushes
        the end sentinel or a typed error."""
        finished = []
        for tid, handle in self._streams.items():
            t = handle.ticket
            if t.status == "done":
                out = t.request.out
                for tok in out[handle._emitted:]:
                    handle._q.put_nowait(tok)
                handle._emitted = len(out)
                handle._q.put_nowait(_DONE)
                finished.append(tid)
            elif t.status in ("shed", "failed"):
                handle._q.put_nowait(FleetRejected(
                    t.reason or t.status,
                    f"request {tid} {t.status} mid-flight"))
                finished.append(tid)
            elif t.status == "cancelled":
                # a disconnect or an explicit cancel: end the stream
                # quietly; the status says why
                handle._q.put_nowait(_DONE)
                finished.append(tid)
            elif t.flights:
                best = max((fl.clone.out for fl in t.flights), key=len)
                if len(best) > handle._emitted:
                    for tok in best[handle._emitted:]:
                        handle._q.put_nowait(tok)
                    handle._emitted = len(best)
        for tid in finished:
            self._streams.pop(tid, None)

    def _broadcast(self, err: BaseException) -> None:
        for handle in self._streams.values():
            handle._q.put_nowait(err)
        self._streams.clear()


def run_clients(router: FleetRouter, requests: Sequence[Request],
                deadline_s: Optional[float] = None) -> List[Request]:
    """Serve ``requests`` through the async front end as N concurrent client
    coroutines (one per request) and return them completed: the async twin
    of ``FleetRouter.generate``, used by ``launch/serve.py --async``. Must
    not be called from inside a running event loop (it owns
    ``asyncio.run``)."""
    async def _main():
        async with AsyncFleetClient(router) as client:
            await asyncio.gather(
                *(client.generate(r, deadline_s=deadline_s)
                  for r in requests))

    asyncio.run(_main())
    return list(requests)
