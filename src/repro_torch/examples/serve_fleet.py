"""Serve a GRU wave through the fault-tolerant fleet, and survive a scripted
replica kill mid-load (counterpart of the JAX package's
``examples/serve_fleet.py``).

The fleet is one call: build a ``FleetRouter`` over N ``ServeEngine``
replicas, ``generate(requests)``, read ``request.out``, as with a single
engine. Here replica0 is killed while it holds in-flight requests and
restored later; the router detects the death by heartbeat timeout, retries
the lost requests on the survivor (the class streams are unchanged: greedy
decode is deterministic and retries start from scratch), and the restored
replica re-enters the rotation with its engine rebuilt. Everything runs in
virtual time (``ManualClock``): deterministic, no sleeps. The stack serves
through ``backend="cuda"``: the fused CUDA kernels on the card, their plain
versions with ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.examples.serve_fleet
    PYTHONPATH=src python -m repro_torch.examples.serve_fleet --device cpu
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import GRUConfig, get_smoke_config
from repro_torch.core.params import init_params
from repro_torch.distributed.fault_tolerance import ManualClock
from repro_torch.models import api as mapi
from repro_torch.serve.engine import Request
from repro_torch.serve.fleet import (FaultEvent, FaultInjector, FleetConfig,
                                     FleetRouter)


def build(device):
    """The example's two-layer GRU (H=16) and its parameters from seed 0."""
    cfg = get_smoke_config("gru-jet").replace(
        gru=GRUConfig(input_dim=5, hidden_dim=16, num_classes=5,
                      num_layers=2, backend="cuda"))
    api = mapi.get_api(cfg)
    params = init_params(api.specs(cfg), 0, cfg.param_dtype, device=device)
    return cfg, params


def make_requests(cfg, n):
    rng = np.random.default_rng(7)
    return [Request(prompt=rng.normal(size=(4 + i % 3, cfg.gru.input_dim))
                    .astype(np.float32), max_new_tokens=8)
            for i in range(n)]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg, params = build(device)
    reqs = make_requests(cfg, 8)

    # kill replica0 at t=0.05 (mid-wave), bring it back at t=0.30
    injector = FaultInjector([
        FaultEvent(t=0.05, kind="kill", replica="replica0"),
        FaultEvent(t=0.30, kind="restore", replica="replica0"),
    ])
    router = FleetRouter(
        cfg, params, replicas=2, max_batch=2, clock=ManualClock(),
        config=FleetConfig(heartbeat_timeout_s=0.05, tick_s=0.01),
        injector=injector, device=device)

    done = router.generate(reqs)          # the whole fleet behind one call
    for i, r in enumerate(done):
        print(f"req{i}: {r.out}")
    s = router.stats()
    assert s["completed"] == s["submitted"] == len(reqs), s
    assert s["failed"] == 0 and s["kills"] == 1 and s["restores"] == 1
    print(f"\nsurvived: completed={s['completed']}/{s['submitted']} "
          f"retries={s['retries']} kills={s['kills']} "
          f"restores={s['restores']} "
          f"(replica0 restarts={s['replicas']['replica0']['restarts']}; "
          f"{device})")
    return router, done


if __name__ == "__main__":
    main()
