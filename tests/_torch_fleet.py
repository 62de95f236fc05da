"""Helpers of the fleet and front-end parity tests (``test_torch_fleet.py``,
``test_torch_async.py``): each package's serving surface behind one
namespace, so one scenario drives JAX's ``FleetRouter`` and the port's with
the same numpy parameters, prompts, schedules and ``ManualClock``s, and the
record both runs must agree on."""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np

from repro.configs.base import GRUConfig as JGRUConfig
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import runtime as jrt
from repro.distributed.fault_tolerance import ManualClock as JManualClock
from repro.models import api as jax_api
from repro.serve import async_frontend as jasync
from repro.serve import fleet as jfleet
from repro.serve.autotune import AutoTuneConfig as JAutoTuneConfig
from repro.serve.engine import Request as JRequest
from repro_torch.configs.base import GRUConfig, get_smoke_config
from repro_torch.core import runtime as rt
from repro_torch.serve import async_frontend
from repro_torch.serve import fleet
from repro_torch.serve.autotune import AutoTuneConfig
from repro_torch.serve.clock import ManualClock
from repro_torch.serve.engine import Request, ServeEngine

from _torch_parity import numpy_params, to_jax, to_torch

_NP_PARAMS = {}


def np_params(hidden, layers):
    key = (hidden, layers)
    if key not in _NP_PARAMS:
        jcfg = jax_cfg(hidden, layers)
        _NP_PARAMS[key] = numpy_params(jax_api.get_api(jcfg).specs(jcfg),
                                       seed=0)
    return _NP_PARAMS[key]


def jax_cfg(hidden, layers):
    return jax_smoke_config("gru-jet").replace(
        gru=JGRUConfig(input_dim=5, hidden_dim=hidden, num_classes=5,
                       seq_len=20, num_layers=layers))


def port_cfg(hidden, layers):
    return get_smoke_config("gru-jet").replace(
        gru=GRUConfig(input_dim=5, hidden_dim=hidden, num_classes=5,
                      num_layers=layers))


def side(jax_side: bool):
    """One package's fleet surface: its classes, configs and parameters,
    and ``fleet(...)``, which builds its router as the JAX tests do."""
    if jax_side:
        ns = SimpleNamespace(
            name="jax", F=jfleet, A=jasync, Request=JRequest,
            ManualClock=JManualClock,
            runtime=jrt, AutoTuneConfig=JAutoTuneConfig, make_cfg=jax_cfg,
            carry=to_jax, extra={})
    else:
        ns = SimpleNamespace(
            name="port", F=fleet, A=async_frontend, Request=Request,
            ManualClock=ManualClock,
            runtime=rt, AutoTuneConfig=AutoTuneConfig, make_cfg=port_cfg,
            carry=to_torch, extra={"device": "cpu"})
    cache = {}

    def setup(hidden=12, num_layers=1):
        key = (hidden, num_layers)
        if key not in cache:
            cache[key] = (ns.make_cfg(hidden, num_layers),
                          ns.carry(np_params(hidden, num_layers)))
        return cache[key]

    def requests(n, seed=0, max_new=4, vary=True):
        rng = np.random.default_rng(seed)
        return [ns.Request(prompt=rng.normal(size=(3 + (i % 4 if vary else 0),
                                                   5)).astype(np.float32),
                           max_new_tokens=max_new) for i in range(n)]

    def make_fleet(cfg, params, *, replicas=2, injector=None, clock=None,
                   config=None, max_batch=2, **kw):
        return ns.F.FleetRouter(
            cfg, params, replicas=replicas, max_batch=max_batch,
            clock=clock or ns.ManualClock(),
            config=config or ns.F.FleetConfig(
                heartbeat_timeout_s=0.05, backoff_base_s=0.02, tick_s=0.01),
            injector=injector, **kw, **ns.extra)

    ns.setup, ns.requests, ns.fleet = setup, requests, make_fleet
    ns.Event, ns.Injector, ns.Config = (ns.F.FaultEvent, ns.F.FaultInjector,
                                        ns.F.FleetConfig)
    ns.Rejected = ns.F.FleetRejected
    return ns


def plain(x):
    """``x`` with NaN floats as the string "nan", so records compare with
    ``==`` and a NaN on one side only still differs."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def record(router, reqs):
    """What both packages' runs must agree on."""
    return plain({
        "outs": [list(r.out) for r in reqs],
        "done": [bool(r.done) for r in reqs],
        "stats": router.stats(),
        "now": router.clock.now(),
        "tickets": [(t.status, t.reason, t.retries, t.hedged,
                     list(t.replicas)) for t in router.tickets]})


def async_record(router, reqs):
    """What both packages' front-end runs must agree on whatever the
    interleaving: under a ManualClock the ticks are virtual, but where an
    admission lands between ticks follows the worker thread's timing, so
    tick counts, retries, rejected retries and dispatch histories may
    differ from run to run; streams, final statuses and the outcome
    counters may not."""
    s = router.stats()
    return {"outs": [list(r.out) for r in reqs],
            "done": [bool(r.done) for r in reqs],
            "status": [(t.status, t.reason) for t in router.tickets],
            "counts": {k: s[k] for k in ("submitted", "completed", "failed",
                                         "cancelled", "outstanding")}}


def reference_outs(P, cfg, params, requests):
    """Fault-free single-engine oracle for the same prompts (port side)."""
    assert P.name == "port"
    solo = ServeEngine(cfg, params, max_batch=1, device="cpu")
    outs = []
    for r in requests:
        ref = Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                      eos_id=r.eos_id, stream=r.stream)
        solo.generate([ref])
        outs.append(ref.out)
    return outs


def oracle(P, cfg, params, reqs):
    """The port's streams against its single engine; JAX's own suite holds
    JAX's, and the records hold the two fleets equal."""
    if P.name == "port":
        assert [r.out for r in reqs] == reference_outs(P, cfg, params, reqs)


def both(sides, scenario):
    rj = scenario(sides[0])
    rp = scenario(sides[1])
    assert rp == rj
    return rp
