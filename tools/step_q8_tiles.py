#!/usr/bin/env python3
"""Route and knob sweep of the q8 step kernel on one CUDA card
(``gru_step_q8``, ``csrc/gru_cell_q8.cu``): the q8 chain's decode layer.

Forces each route through the C entry points, with explicit arguments:
the warp route at 1, 2, 4 and 8 warps a block (U's rows as whole 4-byte
words where H % 4 == 0, and through the aligned words that cover them),
and the block route at batch tiles 1, 2, 4 and 8. Shapes: the served ones
(8 slots, H 20 and 32) and B 1 and 64, v1 and v3, and H 1, 5 and 31
(cover loads only). Each forced launch is held
against the plain version (largest absolute error at most 1e-5) and the
warp route against the block route (bit for bit) before it is timed.
Device time per call comes from ``chip_smoke.device_time_ms`` (50 calls
captured in a CUDA graph, CUDA events around 5 replays). Each shape's
lines mark the wrapper's plan (``kernel.step_q8_plan``) and the block
route at the tile the wrapper gave it before the warp route, and end with
the fastest launch of each route, so the plan's knob can be read off the
table.

Then the served ``cuda_chain_q8`` decode step of gru-jet-deep (three
launches of the kernel a step) with the wrapper's plans and with the
block route forced, in turns old, new, new, old
(``chip_smoke.steps_both_ways``, which also times the v3 ``cuda_sharded``
step both ways). It prints ``-Xptxas -v``'s lines for the kernel's
functions first. The table also goes to ``--out``.

Run from the repository root on a machine with a card::

    python3 tools/step_q8_tiles.py [--out build/step_q8_tiles.txt]
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
WARPS = (1, 2, 4, 8)
BLOCK_TILES = (1, 2, 4, 8)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/step_q8_tiles.txt",
                    help="file for the sweep's lines")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.gru_cell import kernel as CK
    from repro_torch.kernels.gru_cell import ref as cref
    if not torch.cuda.is_available():
        sys.exit("step_q8_tiles: no CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    _build.build(["gru_cell_q8"])
    log = _build.build_log("gru_cell_q8").splitlines()
    for i, line in enumerate(log):        # ptxas: the function, then its use
        if "Compiling entry function" in line and "gru_step_q8" in line:
            fn = line.split("'")[1]
            use = " | ".join(x.strip() for x in log[i + 1:i + 4]
                             if "registers" in x or "spill" in x)
            say(f"ptxas: {fn}: {use}")

    def sweep(H, B, variant):
        a = cs.make_inputs(torch, 1, H, B, 1, seed=13 * H + B, dev=dev)
        step = cs.q8_step_args(a)
        u_q = step[2]
        want = cref.gru_step_q8_ref(*step, variant)
        head = f"H={H:2d} B={B:2d} {variant}"
        plan = CK.step_q8_plan(B, H, variant)
        old = cs.step_q8_block_route(B, H)
        ref_bits = cs.step_q8_route_fn(torch, step, variant, old)().clone()
        best = {}

        def one(p, vec):
            call = cs.step_q8_route_fn(torch, step, variant, p, vec)
            call().fill_(float("nan"))
            got = call()
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            if not e <= TOL:
                sys.exit(f"step_q8_tiles: {head} {p}: max |err| {e:.3g} > "
                         f"{TOL}")
            if not torch.equal(got, ref_bits):
                sys.exit(f"step_q8_tiles: {head} {p} vec={vec}: differs "
                         f"from the block route")
            t = cs.device_time_ms(torch, call, per_graph=50)
            knobs = (f"warp warps={p.warps} {'words' if vec else 'cover'}"
                     if p.route == "warp" else f"block bt={p.rows}")
            mark = ("  <- the wrapper's plan" if p == plan and (
                p.route == "block" or vec == CK.q8_words(H, u_q)) else "")
            if p == old:
                mark += "  <- the block route before"
            say(f"{head} {knobs:26s} {t * 1e3:8.2f} us{mark}")
            if t < best.get(p.route, (1e9,))[0]:
                best[p.route] = (t, knobs)
        if H <= CK.STEP_Q8_WARP_MAX_H:
            for warps in WARPS:
                for vec in ((1, 0) if CK.q8_words(H, u_q) else (0,)):
                    one(CK.step_q8_warp_plan(B, warps), vec)
        for bt in BLOCK_TILES:
            if bt <= max(B, 1):
                one(CK.step_q8_block_plan(B, H, bt), 0)
        for route, (t, knobs) in sorted(best.items()):
            say(f"{head} fastest {route}: {knobs} {t * 1e3:.2f} us")
        say(f"{head} plan: {plan}")

    for H in (32, 20):
        for B in (cs.SLOTS, 1, 64):
            for variant in ("v1", "v3"):
                sweep(H, B, variant)
    for H in (1, 5, 31):
        sweep(H, cs.SLOTS, "v1")

    # the served steps, the old routes forced against the plans
    for step, runs in cs.steps_both_ways(torch, dev).items():
        for which, pr in runs:
            if pr is None:
                continue
            say(f"served step gru-jet-deep {step} ({cs.SLOTS} slots) "
                f"{which}: wall {pr['wall_ms_per_step']:.4f} ms/step, device "
                f"busy {pr['device_busy_ms_per_step']:.4f} ms/step (idle "
                f"{pr['device_idle_share']:.3%})")
    out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
