#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result lines):

1. the device: name, count, ``nvidia-smi`` name and power limit; TF32 off;
2. build the CUDA kernels with ``nvcc`` and print ``-Xptxas -v``'s report;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (gru-jet L=1 H=20, gru-jet-deep L=3 H=32; B in
   {1, 8, 64}; T in {8, 16, 32}; v1 and v3; masked and not): largest
   absolute error at most 1e-5;
4. serve gru-jet and gru-jet-deep through ``ServeEngine`` with
   ``backend="cuda"`` (12 requests over 8 slots, ragged prompts of 1-20
   vectors, 16 decode steps each): every prefill and decode step must be
   attributed to ``cuda_fused``, the launch counters (zeroed just before)
   must rise by the prefills and steps served, the class streams must
   equal the ``eager`` engine's on the card, and the prefill logits must
   be finite and agree with the dense reference on a small batch;
5. time each kernel and its plain version with CUDA events, on the device
   (calls captured in a CUDA graph and replayed, so the host's per-call
   cost is left out) and per call from Python; the bound is the bytes over
   3.35 TB/s or the operations over 67 TFLOP/s fp32, whichever is larger.
   The engine's decode-step p50/p99 come from phase 4 (host clock).

Then it prints one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi``
line, and as the last line ``{"ok": true, "device": {...}}``. Without a
card, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOP_PER_S = 67e12            # H100 SXM fp32 outside the tensor cores
TOL = 1e-5
SLOTS, REQUESTS, MAX_PROMPT, MAX_NEW = 8, 12, 20, 16
KERNEL_SOURCE = "src/repro_torch/csrc/gru_sequence.cu"
REPLACES = {
    "gru_sequence_kernel": "src/repro/kernels/gru_sequence/kernel.py:125",
    "gru_stack_sequence_kernel": "src/repro/kernels/gru_sequence/kernel.py:211",
    "gru_stack_decode_kernel": "src/repro/kernels/gru_sequence/kernel.py:291",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def device_info(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {kind} (count {count}); torch {torch.__version__} "
          f"cuda {torch.version.cuda}; tf32 off", flush=True)
    return kind, count, smi_line


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def build_kernels():
    from repro_torch.kernels import _build
    from repro_torch.kernels.gru_sequence import kernel as K
    t0 = time.monotonic()
    paths = _build.build()
    print(f"built {sorted(paths)} in {time.monotonic() - t0:.1f} s",
          flush=True)
    for name in paths:
        for line in _build.build_log(name).splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling",
                                       "smem")):
                print(f"  ptxas[{name}]: {line.strip()}")
    # all shared memory is dynamic, so ptxas does not report it
    for cfg_name, L, H in (("gru-jet", 1, 20), ("gru-jet-deep", 3, 32)):
        print(f"  dynamic shared memory per block, {cfg_name} (L={L} H={H}, "
              f"{K.DEFAULT_BATCH_BLOCK}-row tile): "
              f"{K.smem_bytes(L, H, K.DEFAULT_BATCH_BLOCK)} bytes "
              f"(limit {K.SMEM_LIMIT})")


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def make_inputs(torch, L, H, B, T, seed, dev):
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev)
    mask = torch.ones(T, B)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    for i in range(B):                      # left padding, as the engine
        mask[: T - int(lens[i]), i] = 0.0
    return dict(
        h0=rand(L, B, H, scale=0.5), xp=rand(T, B, 3 * H),
        u=rand(L, H, 3 * H, scale=H ** -0.5),
        wd=(rand(L - 1, H, 3 * H, scale=H ** -0.5) if L > 1
            else torch.zeros(1, 1, 3 * H, device=dev)),
        b=rand(L, 3 * H, scale=0.3), mask=mask.to(dev))


def run_kernel(K, ref, name, a, variant, masked, plain):
    m = a["mask"] if masked else None
    if name == "gru_sequence_kernel":
        args = (a["h0"][0], a["xp"], a["u"][0], a["b"][0], m)
        if plain:
            return (ref.gru_sequence_ref(*args, variant),)
        return (K.gru_sequence_kernel(*args, variant=variant),)
    if name == "gru_stack_sequence_kernel":
        args = (a["h0"], a["xp"], a["u"], a["wd"], a["b"], m)
        if plain:
            return ref.gru_stack_sequence_ref(*args, variant)
        return K.gru_stack_sequence_kernel(*args, variant=variant)
    args = (a["h0"], a["xp"][0], a["u"], a["wd"], a["b"])
    if plain:
        return (ref.gru_stack_decode_ref(*args, variant),)
    return (K.gru_stack_decode_kernel(*args, variant=variant),)


MAIN_SHAPES = {                    # kernel -> (L, H) on the main path
    "gru_sequence_kernel": (1, 20),              # gru-jet prefill
    "gru_stack_sequence_kernel": (3, 32),        # gru-jet-deep prefill
    "gru_stack_decode_kernel": None,             # both configs' decode
}


def check_kernels(torch, dev):
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.gru_sequence import ref
    err = {n: 0.0 for n in REPLACES}
    checks = 0
    for name, LH in MAIN_SHAPES.items():
        shapes = [LH] if LH else [(1, 20), (3, 32)]
        Ts = (8, 16, 32) if LH else (1,)
        for (L, H) in shapes:
            for B in (1, 8, 64):
                for T in Ts:
                    a = make_inputs(torch, L, H, B, T, seed=B * 100 + T,
                                    dev=dev)
                    for variant in ("v1", "v3"):
                        for masked in ((False, True) if LH else (False,)):
                            got = run_kernel(K, ref, name, a, variant,
                                             masked, plain=False)
                            want = run_kernel(K, ref, name, a, variant,
                                              masked, plain=True)
                            torch.cuda.synchronize()
                            for g_, w_ in zip(got, want):
                                check(bool(torch.isfinite(g_).all()),
                                      f"{name}: non-finite output")
                                e = (g_ - w_).abs().max().item()
                                err[name] = max(err[name], e)
                                check(e <= TOL, f"{name} L={L} H={H} B={B} "
                                      f"T={T} {variant} masked={masked}: "
                                      f"max |err| {e:.3g} > {TOL}")
                            checks += 1
    for n, e in err.items():
        print(f"  {n}: max |kernel - plain| = {e:.3g} (<= {TOL})")
    print(f"  {checks} kernel/plain comparisons passed", flush=True)
    return err


# ---------------------------------------------------------------------------
# 4. the main path: serve both configs through the kernels
# ---------------------------------------------------------------------------

def serve(cfg, params, backend, dev):
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru, backend=backend))
    eng = ServeEngine(cfg, params, max_batch=SLOTS, device=dev)
    reqs = make_requests(cfg, REQUESTS, MAX_PROMPT, True, MAX_NEW, seed=3)
    done = eng.generate(reqs)
    return eng, [r.out for r in done]


def run_main_path(torch, dev):
    from repro_torch.configs.base import get_config
    from repro_torch.core import gru as gru_core
    from repro_torch.core.params import init_params
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.models import gru_lm

    archs = ("gru-jet", "gru-jet-deep")
    cfgs = {a: get_config(a) for a in archs}
    params = {a: init_params(gru_lm.lm_specs(cfgs[a]), seed=0, device=dev)
              for a in archs}
    K.reset_launch_counts()
    engines, streams, per_arch = {}, {}, {}
    before = [0, 0, 0]
    for a in archs:                                   # the main path
        engines[a], streams[a] = serve(cfgs[a], params[a], "cuda", dev)
        after = [k.launches for k in K.KERNELS]
        per_arch[a] = [x - y for x, y in zip(after, before)]
        before = after
    launches = dict(zip((k.__name__ for k in K.KERNELS), before))
    print(f"  main-path launches: {launches}", flush=True)

    report = {}
    for a in archs:
        eng = engines[a]
        st = eng.latency_stats()
        prefills = len(eng.prefill_backends)
        steps_run = st["steps"] + 1     # the wave's one decode key: its
                                        # first step is not recorded
        check(set(eng.prefill_backends) == {"cuda_fused"},
              f"{a}: prefill backends {set(eng.prefill_backends)}")
        check(st["decode_backend_steps"] == {"cuda_fused": st["steps"]},
              f"{a}: decode steps {st['decode_backend_steps']}")
        seq_i = 0 if cfgs[a].gru.resolved_num_layers == 1 else 1
        want = [0, 0, steps_run]
        want[seq_i] = prefills
        check(per_arch[a] == want,
              f"{a}: launches {per_arch[a]} != prefills/steps {want}")
        _, eager_streams = serve(cfgs[a], params[a], "eager", dev)
        check(streams[a] == eager_streams,
              f"{a}: class streams differ from the eager engine")
        check(all(len(s) == MAX_NEW for s in streams[a]),
              f"{a}: stream lengths {[len(s) for s in streams[a]]}")
        # repo's own means: finite logits of the right shape that agree
        # with the dense reference on a small batch
        g = torch.Generator().manual_seed(5)
        xs = torch.randn(3, 7, cfgs[a].gru.input_dim, generator=g).to(dev)
        cfg_c = cfgs[a].replace(gru=dataclasses.replace(cfgs[a].gru,
                                                        backend="cuda"))
        logits, _ = gru_lm.prefill(eng.params, cfg_c, {"features": xs})
        h0s = gru_core.stack_h0(cfgs[a].gru, 3, device=dev)
        finals, _ = gru_core.gru_stack_reference(
            gru_core.stack_cell_params(params[a]), h0s, xs)
        want_logits = (finals[-1] @ params[a]["head"]["w"]
                       + params[a]["head"]["b"])
        check(tuple(logits.shape) == (3, cfgs[a].gru.num_classes)
              and bool(torch.isfinite(logits).all()), f"{a}: bad logits")
        e = (logits - want_logits).abs().max().item()
        check(e <= TOL, f"{a}: prefill logits vs reference {e:.3g}")
        report[a] = {"prefills": prefills, "decode_steps": steps_run,
                     "decode_p50_ms": st["p50_s"] * 1e3,
                     "decode_p99_ms": st["p99_s"] * 1e3,
                     "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
                     "logits_err_vs_reference": e,
                     "streams_equal_eager": True}
        print(f"  {a}: {prefills} prefills, {steps_run} decode steps, all "
              f"cuda_fused; decode p50 {st['p50_s'] * 1e3:.4f} ms p99 "
              f"{st['p99_s'] * 1e3:.4f} ms (host clock, synchronized); "
              f"streams == eager; logits vs reference {e:.3g}", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    return launches, report


# ---------------------------------------------------------------------------
# 5. timing
# ---------------------------------------------------------------------------

def call_time_ms(torch, fn, iters: int, warmup: int = 5) -> float:
    """Per call, launched from Python one after another: CUDA events around
    the loop. Includes the host's cost of each call (checks, ctypes,
    allocation) wherever that exceeds the device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_time_ms(torch, fn, per_graph: int, replays: int = 5) -> float:
    """Device time per call: ``per_graph`` calls captured in one CUDA graph
    (measurement only; the port launches eagerly), CUDA events around
    ``replays`` replays, so the host's per-call cost is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * per_graph)


def bound_ms(name, a):
    """Least time for the same work: every input read once and every output
    written once over 3.35 TB/s, or the operations the live (unmasked)
    steps need over 67 TFLOP/s, whichever is larger."""
    L, B, H = a["h0"].shape
    T = a["xp"].shape[0] if name != "gru_stack_decode_kernel" else 1
    masked = name != "gru_stack_decode_kernel"
    n_in = (L * B * H + T * B * 3 * H + L * H * 3 * H + (L - 1) * H * 3 * H
            + L * 3 * H + (T * B if masked else 0))
    n_out = {"gru_sequence_kernel": T * B * H,
             "gru_stack_sequence_kernel": T * B * H + L * B * H,
             "gru_stack_decode_kernel": L * B * H}[name]
    nbytes = 4 * (n_in + n_out)
    live = float(a["mask"].sum().item()) if masked else B
    # per live (row, step, layer): U matvec 2*H*3H (v1: 2H*2H + 2H*H), the
    # next layer's W matvec 2*H*3H below the top, 14*H elementwise
    per_row_step = L * (6 * H * H + 14 * H) + (L - 1) * 6 * H * H
    flops = live * per_row_step
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(torch, dev, err, launches):
    """Kernel, plain-version and bound times at the main path's shapes;
    the JSON rows are the 8-slot shapes (gru-jet prefill, gru-jet-deep
    prefill and decode)."""
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.gru_sequence import ref
    rows = []
    # main-path shapes: 8 slots, a 16-step bucket, v1 (the configs' variant)
    for name, (L, H) in (("gru_sequence_kernel", (1, 20)),
                         ("gru_stack_sequence_kernel", (3, 32)),
                         ("gru_stack_decode_kernel", (3, 32)),
                         ("gru_stack_decode_kernel", (1, 20))):
        for B in (1, SLOTS, 64):
            T = 1 if name == "gru_stack_decode_kernel" else 16
            a = make_inputs(torch, L, H, B, T, seed=7, dev=dev)
            masked = name != "gru_stack_decode_kernel"

            def kern():
                return run_kernel(K, ref, name, a, "v1", masked, plain=False)

            def plain_fn():
                return run_kernel(K, ref, name, a, "v1", masked, plain=True)
            ms = device_time_ms(torch, kern, per_graph=200)
            plain = device_time_ms(torch, plain_fn, per_graph=4 if T > 1
                                   else 50)
            call = call_time_ms(torch, kern, iters=300)
            plain_call = call_time_ms(torch, plain_fn, iters=10)
            bms, by = bound_ms(name, a)
            print(f"  {name:26s} L={L} H={H} B={B:2d} T={T:2d}: device "
                  f"{ms * 1e3:8.2f} us (per call {call * 1e3:7.2f})  plain "
                  f"{plain * 1e3:9.2f} us (per call {plain_call * 1e3:9.2f})"
                  f"  bound {bms * 1e6:7.2f} ns ({by})", flush=True)
            if B == SLOTS and (name != "gru_stack_decode_kernel" or L == 3):
                rows.append({
                    "name": name, "route": "cuda", "source": KERNEL_SOURCE,
                    "replaces": REPLACES[name],
                    "launches": launches[name], "max_abs_err": err[name],
                    "ms": ms, "plain_ms": plain, "bound_ms": bms,
                    "bound_by": by, "library_ms": None,
                    "call_ms": call, "plain_call_ms": plain_call,
                    "shape": {"L": L, "H": H, "B": B, "T": T,
                              "variant": "v1"}})
    print("  library_ms: null -- no single PyTorch call computes the v1 "
          "(paper) GRU recurrence these kernels run", flush=True)
    return rows


def profile_decode(torch, dev):
    """Device busy share of the served decode step: ``torch.profiler`` over
    20 warm steps of a full 8-slot gru-jet-deep wave through cuda_fused;
    busy = the kernels' summed device time over the steps' wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.core.params import init_params
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import gru_lm
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("gru-jet-deep")
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru, backend="cuda"))
    params = init_params(gru_lm.lm_specs(cfg), seed=0, device=dev)
    eng = ServeEngine(cfg, params, max_batch=SLOTS, device=dev)
    eng.gru_wave_begin(make_requests(cfg, SLOTS, 10, False, 64, seed=1))
    for _ in range(10):
        eng.gru_wave_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(20):
            eng.gru_wave_step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0:
            kernels[e.key] = us
    busy = sum(kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    if not kernels:
        print("  profiler: no device time recorded -> busy share not "
              "measured", flush=True)
        return None
    print(f"  decode step (gru-jet-deep, {SLOTS} slots, 20 steps): wall "
          f"{wall / 20 * 1e3:.4f} ms/step, device busy "
          f"{busy / 20 * 1e3:.4f} ms/step = {busy / wall:.3%} (idle "
          f"{1 - busy / wall:.3%})", flush=True)
    for k, us in top:
        print(f"    {us / 20:9.2f} us/step  {k[:90]}")
    return {"wall_ms_per_step": wall / 20 * 1e3,
            "device_busy_ms_per_step": busy / 20 * 1e3,
            "device_idle_share": 1 - busy / wall}


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    phase("1. device")
    kind, count, smi_line = device_info(torch)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not here ({e}); run from the repository root")
    dev = torch.device("cuda", 0)
    phase("2. build")
    build_kernels()
    phase("3. kernels vs plain versions")
    err = check_kernels(torch, dev)
    phase("4. main path: serve gru-jet and gru-jet-deep through cuda_fused")
    launches, report = run_main_path(torch, dev)
    phase("5. timing (CUDA events: device via graph replay, and per call)")
    rows = time_kernels(torch, dev, err, launches)
    report["profile_gru_jet_deep_decode"] = profile_decode(torch, dev)
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the JAX package was imported")
    print(json.dumps({"serve": report}))
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
