"""The port's asyncio front end (``repro_torch.serve.async_frontend``)
against JAX's ``repro.serve.async_frontend`` on the CPU.

Each scenario is a counterpart of a test in ``tests/test_serve_async.py``
and runs on both packages' ``AsyncFleetClient`` over a ``ManualClock``'d
``FleetRouter`` with the same numpy parameters and prompts; the JAX test's
own asserts hold on both sides. ``asyncio.run`` hosts the event loop;
under a ManualClock the scheduler ticks back to back with
``asyncio.sleep(0)`` yields only, so no test sleeps on the wall clock and
the fault schedule fires at fixed virtual times. Where an admission
lands between two ticks still follows the worker thread's timing, so the
two runs must agree on what no interleaving can change: the streamed
classes, each ``request.out``, each ticket's final status and
``stats()``'s outcome counters (tick counts, retries and dispatch
histories are not compared). The streams also equal JAX's synchronous
path (``FleetRouter.generate``) and JAX's ``run_clients``.
"""
import asyncio

import pytest

from _torch_fleet import async_record, both, oracle, side
from _torch_parity import hermetic_runtimes


@pytest.fixture(autouse=True)
def _hermetic():
    hermetic_runtimes()
    yield
    hermetic_runtimes()


@pytest.fixture(scope="module")
def sides():
    return side(True), side(False)


def _requests(P, n, seed=0, max_new=4):
    return P.requests(n, seed=seed, max_new=max_new)


# ---------------------------------------------------------------------------
# N concurrent client coroutines against the synchronous path
# ---------------------------------------------------------------------------

def _streams_match_sync(P):
    cfg, params = P.setup()
    reqs = _requests(P, 8, seed=50, max_new=6)
    streamed = {}

    async def client_coro(client, i, req):
        handle = await client.submit(req)
        toks = []
        async for tok in handle:
            toks.append(tok)
        streamed[i] = toks

    async def main():
        router = P.fleet(cfg, params)
        async with P.A.AsyncFleetClient(router) as client:
            await asyncio.gather(*(client_coro(client, i, r)
                                   for i, r in enumerate(reqs)))
        return router

    router = asyncio.run(main())
    sync_reqs = _requests(P, 8, seed=50, max_new=6)
    P.fleet(cfg, params).generate(sync_reqs)
    for i, r in enumerate(reqs):
        assert r.done
        assert streamed[i] == r.out
        assert r.out == sync_reqs[i].out
    oracle(P, cfg, params, reqs)
    s = router.stats()
    assert s["completed"] == s["submitted"] == 8
    assert s["failed"] == 0 and s["cancelled"] == 0
    return [async_record(router, reqs), [streamed[i] for i in range(8)],
            [r.out for r in sync_reqs]]


def test_async_streams_bitwise_match_sync_path(sides):
    rec = both(sides, _streams_match_sync)
    # the port's async streams == JAX's synchronous fleet's (both() held
    # them equal to JAX's async streams already)
    assert rec[1] == rec[2]


def _mid_flight(P):
    cfg, params = P.setup()
    req = _requests(P, 1, seed=51, max_new=16)[0]
    statuses = []

    async def main():
        router = P.fleet(cfg, params)
        async with P.A.AsyncFleetClient(router) as client:
            handle = await client.submit(req)
            async for _ in handle:
                statuses.append(handle.status)
        return router

    router = asyncio.run(main())
    assert req.done and len(req.out) == len(statuses)
    assert "inflight" in statuses and statuses[-1] == "done"
    return async_record(router, [req])


def test_async_stream_yields_tokens_mid_flight(sides):
    both(sides, _mid_flight)


# ---------------------------------------------------------------------------
# client disconnect -> FleetRouter.cancel
# ---------------------------------------------------------------------------

def _disconnect(P):
    cfg, params = P.setup()
    reqs = _requests(P, 4, seed=52, max_new=10)

    async def consumer(client, req, first_token):
        handle = await client.submit(req)
        async for _ in handle:
            first_token.set()
        return handle

    async def main():
        router = P.fleet(cfg, params)
        async with P.A.AsyncFleetClient(router) as client:
            first_token = asyncio.Event()
            victim = asyncio.create_task(consumer(client, reqs[0],
                                                  first_token))
            others = [asyncio.create_task(client.generate(r))
                      for r in reqs[1:]]
            await first_token.wait()
            victim.cancel()
            res = await asyncio.gather(victim, *others,
                                       return_exceptions=True)
            assert isinstance(res[0], asyncio.CancelledError)
        return router

    router = asyncio.run(main())
    s = router.stats()
    assert s["cancelled"] == 1 and s["completed"] == 3 and s["failed"] == 0
    t = router.tickets[0]
    assert t.status == "cancelled" and t.reason == "client_disconnect"
    assert t.flights == [] and not reqs[0].done
    assert all(r.done for r in reqs[1:])
    oracle(P, cfg, params, reqs[1:])
    return async_record(router, reqs)


def test_async_disconnect_cancels_without_stalling_others(sides):
    both(sides, _disconnect)


def _explicit_cancel(P):
    cfg, params = P.setup()
    req = _requests(P, 1, seed=53, max_new=32)[0]
    toks = []

    async def main():
        router = P.fleet(cfg, params)
        async with P.A.AsyncFleetClient(router) as client:
            handle = await client.submit(req)
            async for tok in handle:
                toks.append(tok)
                if len(toks) == 2:
                    assert await client.cancel(handle) is True
            assert handle.status == "cancelled"
            assert len(toks) < req.max_new_tokens
        return router

    router = asyncio.run(main())
    assert router.stats()["cancelled"] == 1 and not req.done
    return async_record(router, [req])


def test_async_explicit_cancel_ends_stream(sides):
    both(sides, _explicit_cancel)


def _cancel_in_admission(P):
    cfg, params = P.setup()
    reqs = _requests(P, 2, seed=57, max_new=6)

    async def main():
        router = P.fleet(cfg, params)
        async with P.A.AsyncFleetClient(router) as client:
            task = asyncio.create_task(client.generate(reqs[0]))
            await asyncio.sleep(0)           # the task is inside submit()
            task.cancel()
            res = await asyncio.gather(task, return_exceptions=True)
            assert isinstance(res[0], asyncio.CancelledError)
            await client.generate(reqs[1])
        return router

    router = asyncio.run(main())
    s = router.stats()
    assert s["cancelled"] == 1 and not reqs[0].done
    assert s["completed"] == 1 and reqs[1].done
    return async_record(router, reqs)


def test_async_cancel_during_admission_leaves_no_ghost(sides):
    both(sides, _cancel_in_admission)


# ---------------------------------------------------------------------------
# admission: typed rejection and async backpressure
# ---------------------------------------------------------------------------

def _backpressure(P):
    cfg, params = P.setup()
    small = P.Config(heartbeat_timeout_s=10.0, backoff_base_s=0.02,
                     tick_s=0.01, queue_limit=2)
    reqs = _requests(P, 6, seed=54, max_new=4)

    async def main():
        router = P.fleet(cfg, params, config=small)
        async with P.A.AsyncFleetClient(router) as client:
            h0 = await client.submit(reqs[0])
            h1 = await client.submit(reqs[1])
            with pytest.raises(P.Rejected) as ei:
                await client.submit(reqs[2], wait=False)
            assert ei.value.reason == "queue_full"
            await asyncio.gather(
                h0.result(), h1.result(),
                *(client.generate(r) for r in reqs[2:]))
        return router

    router = asyncio.run(main())
    assert all(r.done for r in reqs)
    assert router.stats()["completed"] == 6
    oracle(P, cfg, params, reqs)
    return async_record(router, reqs)


def test_async_queue_full_backpressure_and_reject(sides):
    both(sides, _backpressure)


# ---------------------------------------------------------------------------
# the fault matrix under the async loop
# ---------------------------------------------------------------------------

def _kill_restore(P):
    cfg, params = P.setup()
    reqs = _requests(P, 8, seed=55, max_new=6)
    inj = P.Injector([P.Event(t=0.05, kind="kill", replica="replica0"),
                      P.Event(t=0.15, kind="restore", replica="replica0")])
    router = P.fleet(cfg, params, injector=inj)
    done = P.A.run_clients(router, reqs)
    s = router.stats()
    assert s["kills"] == 1 and s["restores"] == 1
    assert s["completed"] == s["submitted"] == 8
    assert s["failed"] == 0 and s["cancelled"] == 0 and s["shed"] == {}
    assert all(r.done for r in done)
    oracle(P, cfg, params, reqs)
    sync_reqs = _requests(P, 8, seed=55, max_new=6)
    P.fleet(cfg, params).generate(sync_reqs)
    return [async_record(router, reqs), [r.out for r in sync_reqs]]


def test_async_kill_restore_schedule_zero_drops(sides):
    rec = both(sides, _kill_restore)
    # run_clients under faults == the fault-free synchronous fleet
    assert rec[0]["outs"] == rec[1]


# ---------------------------------------------------------------------------
# lifecycle: drain, shutdown, reuse guards
# ---------------------------------------------------------------------------

def _drain_and_close(P):
    cfg, params = P.setup()
    reqs = _requests(P, 3, seed=56, max_new=4)
    replayed = []

    async def main():
        router = P.fleet(cfg, params)
        client = P.A.AsyncFleetClient(router)
        await client.start()
        handles = [await client.submit(r) for r in reqs]
        await client.drain()
        assert router._outstanding == 0
        assert all(h.status == "done" for h in handles)
        for h, r in zip(handles, reqs):
            toks = [t async for t in h]
            assert toks == r.out
            replayed.append(toks)
        await client.aclose()
        with pytest.raises(RuntimeError):
            await client.submit(reqs[0])
        return router

    router = asyncio.run(main())
    assert router.stats()["completed"] == 3
    return [replayed, async_record(router, reqs)]


def test_async_drain_and_close_semantics(sides):
    both(sides, _drain_and_close)


def test_worker_thread_takes_the_routers_device(sides):
    """On the CPU the tick worker binds no CUDA device; every router call
    runs on the one ``fleet-tick`` thread."""
    import threading
    _, P = sides
    cfg, params = P.setup()
    router = P.fleet(cfg, params)
    seen = set()
    tick = router.tick

    def recording_tick(*a, **kw):
        seen.add(threading.current_thread().name)
        return tick(*a, **kw)
    router.tick = recording_tick
    client = P.A.AsyncFleetClient(router)
    assert client._exec._initializer is None
    reqs = _requests(P, 3, seed=58)
    P.A.run_clients(router, reqs)
    assert len(seen) == 1 and next(iter(seen)).startswith("fleet-tick")
    client._exec.shutdown(wait=True)


def test_many_clients_under_a_short_switch_interval(sides):
    """Stress: 32 client coroutines (more than this machine's cores) with
    the interpreter switching threads every microsecond, so the event
    loop's reads of the router (``_publish``) interleave with the worker's
    ticks and admissions as finely as they can; every request completes
    once, with the single engine's stream, and nothing stays outstanding."""
    import sys
    _, P = sides
    cfg, params = P.setup()
    reqs = _requests(P, 32, seed=59, max_new=4)
    router = P.fleet(cfg, params, config=P.Config(
        heartbeat_timeout_s=10.0, tick_s=0.01, queue_limit=8))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        done = asyncio.run(asyncio.wait_for(
            asyncio.to_thread(P.A.run_clients, router, reqs), timeout=120))
    finally:
        sys.setswitchinterval(old)
    s = router.stats()
    assert s["completed"] == s["submitted"] == 32 and s["failed"] == 0
    assert router._outstanding == 0 and all(r.done for r in done)
    assert all(len(r.out) == 4 for r in done)
    oracle(P, cfg, params, reqs)
