"""Concurrent clients on the serving fleet: the asyncio front end
(counterpart of the JAX package's ``examples/serve_async.py``).

Eight client coroutines each ``await client.submit(...)`` and stream their
classes with ``async for``, over the same fault-tolerant ``FleetRouter`` as
``repro_torch.examples.serve_fleet``, scripted replica kill and restore
included. One client disconnects mid-stream (its task is cancelled), which
propagates into ``FleetRouter.cancel``: the request leaves its wave lane and
the other seven clients finish unharmed, with streams equal to the
synchronous fleet path's. Everything runs in virtual time
(``ManualClock``): deterministic, no sleeps; the asserts make this a smoke
test of the front end::

    PYTHONPATH=src python -m repro_torch.examples.serve_async
    PYTHONPATH=src python -m repro_torch.examples.serve_async --device cpu
"""
import argparse
import asyncio

from repro_torch import resolve_device
from repro_torch.distributed.fault_tolerance import ManualClock
from repro_torch.examples.serve_fleet import build, make_requests
from repro_torch.serve.async_frontend import AsyncFleetClient
from repro_torch.serve.fleet import (FaultEvent, FaultInjector, FleetConfig,
                                     FleetRouter)

N_CLIENTS = 8


def make_router(cfg, params, device):
    # the sync example's scripted fault: kill replica0 mid-wave, restore it
    # while the fleet is still serving
    injector = FaultInjector([
        FaultEvent(t=0.05, kind="kill", replica="replica0"),
        FaultEvent(t=0.15, kind="restore", replica="replica0")])
    return FleetRouter(
        cfg, params, replicas=2, max_batch=2, clock=ManualClock(),
        config=FleetConfig(heartbeat_timeout_s=0.05, tick_s=0.01),
        injector=injector, device=device)


async def serve(router, reqs):
    """N concurrent client coroutines; client 0 disconnects mid-stream."""
    streamed = [None] * len(reqs)

    async def client_coro(client, i, req, first_token):
        handle = await client.submit(req)
        toks = []
        async for tok in handle:
            toks.append(tok)
            first_token.set()
        streamed[i] = toks

    async with AsyncFleetClient(router) as client:
        first_token = asyncio.Event()
        victim = asyncio.create_task(
            client_coro(client, 0, reqs[0], first_token))
        others = [asyncio.create_task(
            client_coro(client, i, reqs[i], first_token))
            for i in range(1, len(reqs))]
        await first_token.wait()             # someone is mid-stream
        victim.cancel()                      # client 0 hangs up
        await asyncio.gather(victim, *others, return_exceptions=True)
    return streamed


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg, params = build(device)
    reqs = make_requests(cfg, N_CLIENTS)
    router = make_router(cfg, params, device)
    streamed = asyncio.run(serve(router, reqs))

    # the synchronous path on the same seeds: the streams must be equal
    sync_reqs = make_requests(cfg, N_CLIENTS)
    make_router(cfg, params, device).generate(sync_reqs)

    s = router.stats()
    survivors = list(range(1, N_CLIENTS))
    for i in survivors:
        print(f"client{i}: {streamed[i]}")
        assert reqs[i].done and streamed[i] == reqs[i].out
        assert streamed[i] == sync_reqs[i].out, "async != sync stream"
    # the disconnect propagated without stalling anyone
    assert s["cancelled"] == 1 and not reqs[0].done
    assert router.tickets[0].status == "cancelled"
    assert router.tickets[0].flights == []
    # every still-connected admitted request completed under faults
    assert s["completed"] == len(survivors) and s["failed"] == 0
    assert s["kills"] == 1 and s["restores"] == 1
    print(f"\nasync fleet: {N_CLIENTS} concurrent clients, "
          f"completed={s['completed']} cancelled={s['cancelled']} "
          f"(mid-stream disconnect) retries={s['retries']} "
          f"kills={s['kills']} restores={s['restores']}; "
          f"streams equal to the synchronous path ({device})")
    return router, streamed, sync_reqs


if __name__ == "__main__":
    main()
