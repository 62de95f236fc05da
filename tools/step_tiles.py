#!/usr/bin/env python3
"""Route and knob sweep of the single GRU step on one CUDA card
(``gru_step_fused`` and ``gru_step_blocked``, ``csrc/gru_cell.cu``).

Forces each route through the C entry points, with explicit plans
(``kernel.warp_step_plan``, ``wide_step_plan``, ``tile_step_plan``,
launched by ``chip_smoke.step_route_fn``):

* the warp route (H <= 32) at 1, 2, 4 and 8 warps a block; H 32 and 20
  (compiled as constants)
  and 7 and 31 (any H), B 1, 8 and 64, v1 and v3, fp32 and bf16 u;
* the wide route (v1) at every column width of ``WIDE_COLS`` whose grid
  fits one block an SM, z/r stages of 64 to 2048 rows (multiples of
  ``kernel.wide_kc_unit``, up to one pass), the ring as deep as a block's
  shared memory holds or cut to about half of it; H 1000, 1024 and 2048 (the
  shapes JAX's rule sends to each kernel), bf16 at 2048 and 1024, H 40-512
  (where the fused v1 step leaves the column tile), a ragged H and
  a misaligned u (element copies), B 1, 8 and 64;
* beside each, the column-tile route the wrappers launched before
  (``chip_smoke.step_old_route``).

Each forced launch is held against the plain version and the old route
(largest absolute error at most 1e-5 for fp32 u, 1e-2 for bf16, as
``chip_smoke.py`` phase 11) and against a second launch of itself (the
same bits) before it is timed. Device time per call comes from
``chip_smoke.device_time_ms`` (50 calls captured in a CUDA graph, CUDA
events around 5 replays); where stream capture refuses a launch, from
CUDA events around 200 eager calls instead, marked "events". Each shape's
lines mark the wrapper's plan (``kernel.step_plan``) and the old route,
and end with the fastest launch of each route, so the plans' knobs can be
read off the table. ``--check-only`` holds every launch and times none.
It prints ``-Xptxas -v``'s lines for the step's functions first and fails
on a spill in the warp or wide routes. The table also goes to ``--out``.

Run from the repository root on a machine with a card::

    python3 tools/step_tiles.py [--out build/step_tiles.txt] [--check-only]
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
WARPS = (1, 2, 4, 8)
KCS = (64, 128, 256, 512, 1024, 2048)
HALF_SM = 113 * 1024          # the ring cut to about half of its room


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/step_tiles.txt",
                    help="file for the sweep's lines")
    ap.add_argument("--check-only", action="store_true",
                    help="hold every launch against plain, time none")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.gru_cell import kernel as CK
    from repro_torch.kernels.gru_cell import ref as cref
    if not torch.cuda.is_available():
        sys.exit("step_tiles: no CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = CK.sm_count(dev)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip() + f", {sms} SMs")
    _build.build(["gru_cell"])
    log = _build.build_log("gru_cell").splitlines()
    spills = []
    for i, line in enumerate(log):        # ptxas: the function, then its use
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            use = " | ".join(x.strip() for x in log[i + 1:i + 4]
                             if "registers" in x or "spill" in x)
            say(f"ptxas: {fn}: {use}")
            if (("gru_step_warp_k" in fn or "gru_step_wide_k" in fn)
                    and not cs.no_spill(use)):
                spills.append(fn)
    if spills:
        sys.exit(f"step_tiles: ptxas reports spills in {spills}")

    def timed(call):
        """(device ms per call, how it was timed)."""
        try:
            return cs.device_time_ms(torch, call, per_graph=50), "graph"
        except RuntimeError as e:
            torch.cuda.synchronize()
            say(f"  graph capture refused: {type(e).__name__}: "
                f"{str(e).splitlines()[0][:120]}")
            return cs.call_time_ms(torch, call, iters=200), "events"

    def inputs(B, H, dtype, seed, skew=0):
        h, xp, u, b = cs.step_inputs(torch, B, H, dtype, seed, dev)
        if skew:                          # a view skew elements in
            flat = torch.zeros(u.numel() + skew, device=dev, dtype=u.dtype)
            flat[skew:] = u.reshape(-1)
            u = flat[skew:].view(H, 3 * H)
        return h, xp, u, b

    def sweep(B, H, variant, dtype, kernel, plans, skew=0):
        """Hold and time every plan of ``plans`` on one shape."""
        step = inputs(B, H, dtype, 31 * H + B + skew, skew)
        u = step[2]
        blocked = kernel == "gru_step_blocked"
        head = (f"{kernel[9:]:7s} B={B:2d} H={H:4d} {variant} {dtype:8s}"
                f"{f' skew={skew}' if skew else ''}")
        want = cref.gru_step_ref(*step, variant)
        old = cs.step_old_route(B, H, variant, u.dtype, kernel)
        old_call = cs.step_route_fn(torch, step, variant, old, blocked)
        old_out = old_call().clone()
        plan = CK.step_plan(B, H, variant, u.dtype, kernel, sms)
        tol = TOL[dtype]
        best = {}
        for p in dict.fromkeys([old] + plans):
            call = cs.step_route_fn(torch, step, variant, p, blocked)
            got = call().clone()
            again = call()
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            e_old = (got - old_out).abs().max().item()
            if not (e <= tol and e_old <= tol):
                sys.exit(f"step_tiles: {head} {p}: max |err| {e:.3g}, "
                         f"against the old route {e_old:.3g} (tol {tol})")
            if not torch.equal(got, again):
                sys.exit(f"step_tiles: {head} {p}: two launches differ")
            if p.route == "warp":
                knobs = f"warp warps={p.warps}"
            elif p.route == "wide":
                knobs = f"wide cw={p.ct} kc={p.kc} st={p.stages} bt={p.rows}"
            else:
                knobs = f"tile ct={p.ct} bt={p.rows}"
            mark = "  <- the wrapper's plan" if p == plan else ""
            if p == old:
                mark += "  <- the old route"
            if args.check_only:
                say(f"{head} {knobs:40s} max |err| {e:.3g} (old route "
                    f"{e_old:.3g}){mark}")
                continue
            t, how = timed(call)
            say(f"{head} {knobs:40s} {t * 1e3:8.2f} us ({how}; max |err| "
                f"{e:.2g}){mark}")
            if t < best.get(p.route, (1e9,))[0]:
                best[p.route] = (t, knobs)
        for route, (t, knobs) in sorted(best.items()):
            say(f"{head} fastest {route}: {knobs} {t * 1e3:.2f} us")

    # the warp route: every knob
    def warp_plans(B):
        return [CK.warp_step_plan(B, w) for w in WARPS]
    for H in (32, 20):
        for B in (8, 1, 64):
            for variant in ("v1", "v3"):
                for dtype in ("float32", "bfloat16"):
                    sweep(B, H, variant, dtype, "gru_step_fused",
                          warp_plans(B))
    for H in (7, 31):
        for dtype in ("float32", "bfloat16"):
            sweep(8, H, "v1", dtype, "gru_step_fused", warp_plans(8))

    # the wide route: every knob
    def wide_plans(B, H, dtype):
        dt = getattr(torch, dtype)
        plans = []
        for cw in CK.WIDE_COLS:
            if -(-H // cw) > sms:
                continue
            for kc in KCS:
                unit = CK.wide_kc_unit(cw)
                if kc % unit or kc > unit * -(-H // unit):
                    continue
                p = CK.wide_step_plan(B, H, dt, cw=cw, kc=kc, sms=sms)
                if p is None:
                    continue
                plans.append(p)
                if p.smem > HALF_SM:      # the ring cut to about half
                    per = CK.wide_smem(H, p.rows, cw, kc, 1, dt) - \
                        CK.wide_smem(H, p.rows, cw, kc, 0, dt)
                    st = (HALF_SM - CK.wide_smem(H, p.rows, cw, kc, 0,
                                                 dt)) // per
                    if st >= 2:
                        plans.append(CK.wide_step_plan(
                            B, H, dt, cw=cw, kc=kc, stages=st, sms=sms))
        return plans
    for B in (1, 8):
        for H, dtype, kernel in ((1000, "float32", "gru_step_fused"),
                                 (1024, "float32", "gru_step_blocked"),
                                 (2048, "float32", "gru_step_blocked"),
                                 (2048, "bfloat16", "gru_step_blocked"),
                                 (1024, "bfloat16", "gru_step_fused")):
            sweep(B, H, "v1", dtype, kernel, wide_plans(B, H, dtype))
    for H in (40, 64, 128, 256, 512):
        sweep(8, H, "v1", "float32", "gru_step_fused",
              wide_plans(8, H, "float32"))
    sweep(64, 1024, "v1", "float32", "gru_step_blocked",
          [CK.wide_step_plan(64, 1024, torch.float32, sms=sms)])
    sweep(3, 1001, "v1", "float32", "gru_step_fused",
          [CK.wide_step_plan(3, 1001, torch.float32, sms=sms)])
    for dtype in ("float32", "bfloat16"):
        sweep(8, 1024, "v1", dtype, "gru_step_blocked",
              [CK.wide_step_plan(8, 1024, getattr(torch, dtype), sms=sms)],
              skew=1)
    out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
