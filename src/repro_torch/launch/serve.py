"""Serving driver (counterpart of ``repro.launch.serve``): a wave of
requests through the port's ServeEngine, its autotuner included, or, with
``--replicas N`` (N > 1) or ``--async``, through the fault-tolerant
``FleetRouter`` (``repro_torch.serve.fleet``; cell families only):
feature-vector requests for the cell families, token prompts for the
LMs (dense, MoE, the xLSTM and hymba).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gru-jet \\
        --gru-backend cuda --requests 12 --slots 8 --vary-prompt

Give more requests than ``--slots`` to exercise mid-wave admit and retire.
``--gru-backend`` sets the executor preference: ``eager`` (plain PyTorch),
``cuda`` (the fused CUDA kernels, one launch per prefill and per decode
step; the per-layer chain for heterogeneous ``layer_dims``), ``auto``
(cheapest legal backend), or an exact backend name: ``cuda_fused``,
``cuda_chain`` (one depth-1 kernel launch per layer), or ``cuda_fused_q8``
and ``cuda_chain_q8`` (the int8 datapath, fused or per layer; a pin serves
it whatever the accuracy gate says)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gru-jet-deep \
        --gru-backend cuda_fused_q8 --requests 12 --slots 8 --vary-prompt

The mesh backends (``sharded``, ``cuda_sharded``, ``sharded_decode``)
need a mesh of ranks, which this single-process CLI does not make (nor
does JAX's): pinned here they fall through to the cheapest legal backend,
``cuda_fused``. A sharded server runs ``ServeEngine(..., ctx=ShardCtx(
mesh))`` on every rank (``repro_torch.distributed``).

``--arch slstm-jet`` serves the sLSTM family the same way: ``cuda`` and
``cuda_fused`` run its fused kernels (one launch per prefill and per
decode step), ``eager`` plain PyTorch; it has no chain or int8 backend, so
those pins fall through to ``cuda_fused``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch slstm-jet \
        --gru-backend cuda --requests 12 --slots 8 --vary-prompt

``--arch qwen3-0.6b`` serves the dense LM: ``--requests`` random token
prompts of ``--prompt-len`` tokens from ``--seed`` (one aligned wave, so
``--slots`` must not be below ``--requests``), random weights from the
same seed, greedy decoding of ``--max-new`` tokens; attention runs the
CUDA kernels (flash attention for prefill, flash decode per step).
``--smoke`` takes the config's reduced same-family ``SMOKE`` size (the
cell configs are already small)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --requests 4 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --smoke --device cpu

The other transformer configs serve the same way: the dense
``qwen2.5-3b``, ``phi4-mini-3.8b`` and ``command-r-35b`` (layernorm, a
parallel attention || MLP block), and the MoE family ``qwen2-moe-a2.7b``
(60 experts padded to 64, top-4, a shared expert) and
``qwen3-moe-235b-a22b`` (128 experts, top-8; 235 B parameters, far
beyond one card: serve its ``--smoke`` size). A transformer's weights
are built leaf by leaf, already cast to the compute dtype and on the
device (``init_prepared``; qwen2-moe-a2.7b's are 30.3 GB in bf16, 60.6
in fp32)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
        --requests 4 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
        --smoke --device cpu

The recurrent LMs serve the same way: ``xlstm-125m`` (mLSTM/sLSTM block
pairs, no attention and no kernel: plain PyTorch recurrences) and
``hymba-1.5b`` (attention and SSM heads in parallel in every layer;
attention through the two CUDA kernels, a window of 1024 on 29 of its 32
layers)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --smoke --device cpu

``--bucket-min`` sets the shortest prompt bucket (8 by default).
``--autotune`` attaches an ``AutoTuner`` (``repro_torch.serve.autotune``;
cell families): wave size from the measured batch-latency curve, the
bucket ladder from the observed prompt lengths, served step timings folded
back into the CostModel, all applied at wave boundaries (here: before the
one wave and after it drains), and the applied decisions are printed::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gru-jet-deep \
        --gru-backend cuda --autotune --bucket-min 4 --requests 12 \
        --slots 4 --vary-prompt --max-new 4

Fleet mode (cell families): ``--replicas N`` serves through a
``FleetRouter`` of N engine replicas (bounded admission, depth routing,
retries and hedging; ``--slots`` is each replica's slot count, by default
half of ``--requests`` and at least 2); ``--routing`` picks depth-aware or
static round-robin dispatch; ``--inject-faults`` runs a seeded
kill/restore and slow schedule (``FaultInjector.seeded(seed, names,
0.6)``, printed as the JAX CLI prints it) under a deterministic
``ManualClock`` and prints the fleet's fault accounting. ``--async`` serves
through the asyncio front end (``repro_torch.serve.async_frontend``): one
client coroutine per request over the router, one replica or several, with
the synchronous path's class streams::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gru-jet-deep \
        --gru-backend cuda --replicas 2 --inject-faults --requests 16 \
        --vary-prompt
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gru-jet-deep \
        --gru-backend cuda --replicas 2 --inject-faults --requests 16 \
        --vary-prompt --async

The run is on the card unless ``--device cpu`` is given. Prints each
request's class or token stream, the decode latency statistics, the
served dtype and, for the cell families, the backends that served prefill
and decode.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.core import cells as cell_families
from repro_torch.core.params import init_params
from repro_torch.models import api as mapi
from repro_torch.serve.engine import Request, ServeEngine


def make_requests(cfg, n: int, prompt_len: int, vary: bool, max_new: int,
                  seed: int):
    """``n`` seeded requests. Cell families: feature-vector prompts,
    ``vary`` draws each prompt's length uniformly from 1..prompt_len. The
    dense LM: token prompts of ``prompt_len`` tokens in ``[0, vocab)``
    (``vary`` ignored, as in the JAX CLI)."""
    rng = np.random.default_rng(seed)
    if not cell_families.is_cell_family(cfg.family):
        return [Request(prompt=rng.integers(0, cfg.vocab_size,
                                            size=prompt_len).astype(np.int32),
                        max_new_tokens=max_new) for _ in range(n)]
    reqs = []
    for _ in range(n):
        S = int(rng.integers(1, prompt_len + 1)) if vary else prompt_len
        reqs.append(Request(
            prompt=rng.normal(size=(S, cfg.gru.input_dim)).astype(np.float32),
            max_new_tokens=max_new))
    return reqs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=ALL_ARCHS)
    p.add_argument("--smoke", action="store_true",
                   help="the config's reduced SMOKE size")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--slots", type=int, default=0,
                   help="decode batch slots (0 = --requests); requests "
                        "beyond this queue and admit as slots free up")
    p.add_argument("--prompt-len", type=int, default=12)
    p.add_argument("--vary-prompt", action="store_true",
                   help="ragged prompt lengths (exercises buckets + mask)")
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--gru-backend",
                   choices=("eager", "cuda", "auto", "cuda_fused",
                            "cuda_chain", "sharded", "cuda_sharded",
                            "sharded_decode", "cuda_fused_q8",
                            "cuda_chain_q8"),
                   default=None,
                   help="executor backend preference (default: the "
                        "config's, eager); an exact name pins that "
                        "backend: the mesh-requiring ones [sharded, "
                        "cuda_sharded, sharded_decode] need a sharded "
                        "launch (ServeEngine(..., ctx=ShardCtx(mesh)) on "
                        "every rank) and fall through here, and the "
                        "cuda_fused_q8 and cuda_chain_q8 pins serve the "
                        "int8 datapath whatever the accuracy gate says")
    p.add_argument("--bucket-min", type=int, default=8,
                   help="shortest prompt bucket (prompts pad to the next "
                        "power of two at or above it)")
    p.add_argument("--autotune", action="store_true",
                   help="cell families: attach an online AutoTuner (wave "
                        "size from the measured batch-latency curve, "
                        "bucket ladder from observed prompt-length "
                        "quantiles, served step timings folded back into "
                        "the CostModel; retuned only at wave boundaries) "
                        "and print the applied decisions")
    p.add_argument("--replicas", type=int, default=1,
                   help="cell families: serve through a FleetRouter with "
                        "this many engine replicas (admission control, "
                        "depth routing, retries and hedging)")
    p.add_argument("--inject-faults", action="store_true",
                   help="fleet: run a seeded kill/restore and slow schedule "
                        "under a deterministic virtual clock and print the "
                        "fault accounting (with --replicas > 1)")
    p.add_argument("--routing", choices=("depth", "static"), default="depth",
                   help="fleet dispatch: measured queue-depth scoring or "
                        "static round robin")
    p.add_argument("--async", dest="use_async", action="store_true",
                   help="serve through the asyncio front end: one client "
                        "coroutine per request over a FleetRouter (one "
                        "replica or --replicas); the class streams equal "
                        "the synchronous path's (cell families only)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    is_cell = cell_families.is_cell_family(cfg.family)
    if args.gru_backend and is_cell:
        cfg = cfg.replace(gru=dataclasses.replace(cfg.gru,
                                                  backend=args.gru_backend))
    api = mapi.get_api(cfg)
    if is_cell:
        params = init_params(api.specs(cfg), args.seed, cfg.param_dtype,
                             device=device)
    else:
        params = api.init_prepared(cfg, args.seed, device)
    reqs = make_requests(cfg, args.requests, args.prompt_len,
                         args.vary_prompt, args.max_new, args.seed)
    if args.replicas > 1 or args.use_async:
        if not is_cell:
            p.error("--async and --replicas > 1 serve through the "
                    "FleetRouter, which serves the cell families only")
        return _serve_fleet(cfg, params, reqs, args, device)
    tuner = None
    if args.autotune:
        if not is_cell:
            p.error("--autotune tunes the cell families' waves")
        from repro_torch.serve.autotune import AutoTuner
        tuner = AutoTuner()
    engine = ServeEngine(cfg, params, max_batch=args.slots or args.requests,
                         device=device, bucket_min=args.bucket_min,
                         tuner=tuner)
    done = engine.generate(reqs)
    for i, r in enumerate(done):
        if is_cell:
            print(f"req{i}: prompt {len(r.prompt)} -> {len(r.out)} classes "
                  f"{r.out}")
        else:
            print(f"req{i}: prompt {len(r.prompt)} -> {len(r.out)} tokens "
                  f"{r.out[:8]}...")
    stats = engine.latency_stats()
    print(f"decode latency ({stats['device']}): "
          f"mean={stats['mean_s'] * 1e3:.4f}ms "
          f"p50={stats['p50_s'] * 1e3:.4f}ms "
          f"p90={stats['p90_s'] * 1e3:.4f}ms "
          f"p99={stats['p99_s'] * 1e3:.4f}ms ({stats['steps']} steps, "
          f"{stats['served_dtype']}); "
          f"prefill mean={stats['prefill_mean_s'] * 1e3:.4f}ms "
          f"({stats['prefills']} prefills, "
          f"{len(engine._prefill_exes)} buckets)")
    if not is_cell:
        print(lm_line(cfg))
        return done
    steps = stats["decode_backend_steps"]
    attributed = ",".join(f"{k}:{v}" for k, v in sorted(steps.items()))
    print(f"executor: prefill={'/'.join(sorted(set(engine.prefill_backends)))} "
          f"decode={engine.decode_backend} "
          f"decode_steps=[{attributed or '-'}]")
    if tuner is not None:
        print_autotune(stats["autotune"])
    return done


def lm_line(cfg) -> str:
    """What serves an LM's layers: its attention path, or the xLSTM's
    blocks (no attention), and hymba's windows and SSM heads."""
    shape = (f"{cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
             f"{cfg.vocab_size}")
    if cfg.family == "ssm":
        return f"xLSTM blocks ({shape}; mLSTM/sLSTM pairs, no attention)"
    if cfg.family == "hybrid":
        from repro_torch.models.hymba import _group_sizes
        n = _group_sizes(cfg)
        return (f"attention: {cfg.attn_impl} ({shape}; window "
                f"{cfg.sliding_window} on {n['swa_a'] + n['swa_b']} layers) "
                f"beside SSM heads (state {cfg.ssm.state_dim})")
    return f"attention: {cfg.attn_impl} ({shape})"


def print_autotune(at: dict) -> None:
    """The tuned shape and every applied decision, as JAX's CLI prints
    them."""
    ladder = at.get("bucket_ladder")
    print(f"autotune: wave_size={at['wave_size']} "
          f"bucket_ladder={ladder or 'pow2'} "
          f"retunes={at.get('retunes', 0)} "
          f"prompts_observed={at.get('prompts_observed', 0)}")
    for d in at.get("decisions", ()):
        print(f"  [{d['kind']}] {d['from']} -> {d['to']} "
              f"({d['measurement'].get('rule', '')})")


def _serve_fleet(cfg, params, reqs, args, device):
    """Fleet mode: N supervised replicas behind one ``generate()`` call (or
    the asyncio front end with ``--async``). ``--inject-faults`` runs in
    deterministic virtual time (``ManualClock``) against a seeded
    kill/restore and slow schedule."""
    from repro_torch.distributed.fault_tolerance import ManualClock
    from repro_torch.serve.fleet import (FaultInjector, FleetConfig,
                                         FleetRouter)

    names = [f"replica{i}" for i in range(args.replicas)]
    clock = injector = None
    if args.inject_faults:
        clock = ManualClock()
        injector = FaultInjector.seeded(args.seed, names, horizon_s=0.6)
        print(f"fault schedule (seed {args.seed}): "
              + "; ".join(f"t={e.t:.3f} {e.kind} {e.replica}"
                          + (f" x{e.factor:g}" if e.kind == "slow" else "")
                          for e in injector.events))
    router = FleetRouter(cfg, params, replicas=args.replicas,
                         max_batch=args.slots or max(2, args.requests // 2),
                         bucket_min=args.bucket_min, clock=clock,
                         config=FleetConfig(routing=args.routing),
                         injector=injector, autotune=args.autotune,
                         device=device)
    if args.use_async:
        from repro_torch.serve.async_frontend import run_clients
        done = run_clients(router, reqs)
        print(f"async front end: {len(reqs)} concurrent client coroutines "
              f"over {args.replicas} replica(s)")
    else:
        done = router.generate(reqs)
    for i, r in enumerate(done):
        print(f"req{i}: prompt {len(r.prompt)} -> {len(r.out)} classes "
              f"{r.out}")
    s = router.stats()
    print(f"fleet ({router.device}): {args.replicas} replicas "
          f"routing={s['routing']} "
          f"completed={s['completed']}/{s['submitted']} "
          f"failed={s['failed']} shed={s['shed'] or '{}'} "
          f"retries={s['retries']} hedges={s['hedges']} "
          f"kills={s['kills']} restores={s['restores']}; "
          f"e2e p50={s['e2e_p50_s'] * 1e3:.4f}ms "
          f"p99={s['e2e_p99_s'] * 1e3:.4f}ms "
          f"queue wait p99={s['queue_wait_p99_s'] * 1e3:.4f}ms")
    for rep in router.replicas:
        rs = s["replicas"][rep.name]
        steps = rep.engine.latency_stats()["decode_backend_steps"]
        prefill = "/".join(sorted(set(rep.engine.prefill_backends))) or "-"
        line = (f"  {rep.name}: alive={rs['alive']} "
                f"restarts={rs['restarts']} steps={rs['steps']} "
                f"requests={rs['requests']} "
                f"decode p50={rs['decode_p50_s'] * 1e3:.4f}ms "
                f"p99={rs['decode_p99_s'] * 1e3:.4f}ms "
                f"prefill={prefill} decode_steps={steps}")
        if args.autotune:
            line += (f" wave_size={rs['wave_size']} "
                     f"bucket_ladder={rs['bucket_ladder'] or 'pow2'} "
                     f"retunes={rs['retunes']}")
        print(line)
    return done


if __name__ == "__main__":
    main()
