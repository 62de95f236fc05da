#!/usr/bin/env python3
"""Route and knob sweep of the depth-1 GRU sequence kernel on one CUDA card
(``gru_sequence_kernel``, ``csrc/gru_sequence.cu``).

Forces every route and knob through the C entry points, with explicit
arguments: the warp route at each count of rows a warp, warps a block and
prefetch depth (``kernel.WARP_ROW_CHOICES``, 1-8 warps,
``kernel.WARP_DEPTHS``), and the block route (``run_stack``) at batch
tiles 1, 2, 4 and 8. Shapes: the served ones (8 slots: the fp32 chain's
decode layers at T=1, H 20 and 32, unmasked; the T=32 prefill bucket, H 20
and 32, masked; ``chip_smoke.py``'s T=16 H=20 row), the chain's decode
layer at B 1 and 64, and a grid of H 20-64 by T 1-64 (masked past T=1),
v1; v3 at the T=32 H=32 prefill. Each forced launch is held against the
plain version (largest absolute error at most 1e-5) before it is timed.
Device time per call comes from ``chip_smoke.device_time_ms`` (50 calls
captured in a CUDA graph, CUDA events around 5 replays). Each shape's
lines mark the wrapper's plan (``kernel.seq_plan``) and the block route at
the tile the wrapper gave it before the warp route, and end with the
fastest launch of each route, so the plan's knobs can be read off the
table.

Then the served ``cuda_chain`` decode step of gru-jet-deep (three
launches of the kernel a step) under ``chip_smoke.profile_decode``, with
the wrapper's plans and with the block route forced, in turns block,
plan, plan, block; and ``torch.nn.GRU`` (cuDNN) on the same v3 unmasked
work at T=32 B=8 H=32 (``chip_smoke.cudnn_gru_ms``). It prints
``-Xptxas -v``'s lines for row 1's kernels first. The table also goes to
``--out``.

Run from the repository root on a machine with a card::

    python3 tools/seq_tiles.py [--out build/seq_tiles.txt]
"""
from __future__ import annotations

import argparse
import itertools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
WARPS = (1, 2, 4, 8)
BLOCK_TILES = (1, 2, 4, 8)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/seq_tiles.txt",
                    help="file for the sweep's lines")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.gru_sequence import ref
    if not torch.cuda.is_available():
        sys.exit("seq_tiles: no CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    _build.build(["gru_sequence"])
    log = _build.build_log("gru_sequence").splitlines()
    for i, line in enumerate(log):        # ptxas: the function, then its use
        if "Compiling entry function" in line and "gru_sequence" in line and (
                "warp_k" in line or "14gru_sequence_k" in line):
            fn = line.split("'")[1]
            use = " | ".join(x.strip() for x in log[i + 1:i + 4]
                             if "registers" in x or "spill" in x)
            say(f"ptxas: {fn}: {use}")

    def sweep(H, B, T, variant, masked):
        a = cs.make_inputs(torch, 1, H, B, T, seed=13 * H + T + B, dev=dev)
        want = ref.gru_sequence_ref(a["h0"][0], a["xp"], a["u"][0],
                                    a["b"][0], a["mask"] if masked else None,
                                    variant)
        head = (f"H={H:2d} B={B:2d} T={T:2d} {variant} "
                f"{'masked' if masked else 'live  '}")
        plan = K.seq_plan(B, T, H, variant)
        old = cs.block_route(K, B, H)
        best = {}

        def one(p):
            call = cs.seq_route_fn(torch, a, variant, masked, p)
            call().fill_(float("nan"))
            got = call()
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            if not e <= TOL:
                sys.exit(f"seq_tiles: {head} {p}: max |err| {e:.3g} > {TOL}")
            t = cs.device_time_ms(torch, call, per_graph=50)
            knobs = (f"warp rows={p.rows} warps={p.warps} depth={p.depth}"
                     if p.route == "warp" else f"block bt={p.rows}")
            mark = "  <- the wrapper's plan" if p == plan else ""
            if p == old:
                mark += "  <- the block route before"
            say(f"{head} {knobs:32s} {t * 1e3:8.2f} us{mark}")
            if t < best.get(p.route, (1e9,))[0]:
                best[p.route] = (t, knobs)
        if H <= K.WARP_MAX_H:
            for rows, warps, depth in itertools.product(
                    K.WARP_ROW_CHOICES, WARPS, K.WARP_DEPTHS):
                one(K.warp_plan(B, rows, warps, depth))
        for bt in BLOCK_TILES:
            if bt <= max(B, 1) and K.smem_bytes(1, H, bt) <= K.SMEM_LIMIT:
                one(K.block_plan(B, H, bt))
        for route, (t, knobs) in sorted(best.items()):
            say(f"{head} fastest {route}: {knobs} {t * 1e3:.2f} us")
        say(f"{head} plan: {plan}")

    S = cs.SLOTS
    served = [(20, S, 1, False), (32, S, 1, False), (20, S, 32, True),
              (32, S, 32, True), (20, S, 16, True), (32, 1, 1, False),
              (32, 64, 1, False), (20, 1, 32, True), (32, 64, 32, True)]
    grid = [(H, S, T, T > 1) for H in (20, 24, 32, 48, 64)
            for T in (1, 8, 16, 32, 64)]
    for H, B, T, masked in served + [g for g in grid if g not in served]:
        sweep(H, B, T, "v1", masked)
    sweep(32, S, 32, "v3", True)

    # the served chain decode step: the plans against the block route
    planner = K.seq_plan

    def block_plan(B, T, H, variant):
        return cs.block_route(K, B, H)
    for which in ("block", "plan", "plan", "block"):
        K.seq_plan = block_plan if which == "block" else planner
        try:
            pr = cs.profile_decode(torch, dev, "cuda_chain")
        finally:
            K.seq_plan = planner
        say(f"served step gru-jet-deep (cuda_chain, {cs.SLOTS} slots) with "
            f"{which:5s}: wall {pr['wall_ms_per_step']:.4f} ms/step, device "
            f"busy {pr['device_busy_ms_per_step']:.4f} ms/step (idle "
            f"{pr['device_idle_share']:.3%})")
    say(f"torch.nn.GRU (cuDNN), v3 T=32 B={cs.SLOTS} H=32, weights mapped: "
        f"{cs.cudnn_gru_ms(torch, dev) * 1e3:.2f} us")
    out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
