#!/usr/bin/env python3
"""Route and knob sweep of the fused decode kernels on one CUDA card
(``gru_stack_decode_kernel``, ``csrc/gru_sequence.cu``, and
``gru_stack_decode_q8_kernel``, ``csrc/gru_sequence_q8.cu``): one token
through all L layers.

Forces each route through the C entry points, with explicit arguments:
the warp route at 1, 2, 4 and 8 warps a block (q8: the int8 rows as
whole 4-byte words where H % 4 == 0, and through the aligned words that
cover them), and the block route at batch tiles 1, 2, 4 and 8. Shapes: the served ones (8 slots, gru-jet L=1 H=20 and
gru-jet-deep L=3 H=32) and B 1 and 64, v1 and v3, every knob; then H 1,
5, 20, 31 and 32 by L 1-4, 8 slots, v1 and v3, the plan against the old
block route (the q8 warp route ends at L=3, so L=4 is the block route
alone there). Each forced launch is held against the plain version
(largest absolute error at most 1e-5) and the warp route against the
block route (bit for bit) before it is timed. Device time per call comes
from ``chip_smoke.device_time_ms`` (50 calls captured in a CUDA graph,
CUDA events around 5 replays). Each shape's lines mark the wrapper's plan
(``kernel.decode_plan`` / ``kernel.decode_q8_plan``) and the block route
at the tile the wrapper gave it before the warp route, and end with the
fastest launch of each route, so the plan's knobs can be read off the
table.

Then the served gru-jet-deep ``cuda`` (``cuda_fused``) and
``cuda_fused_q8`` decode steps with the plans and with both block routes
forced, in turns old, new, new, old (``chip_smoke.decode_steps_both_ways``).
It prints ``-Xptxas -v``'s lines for the decode kernels first. The table
also goes to ``--out``; ``--check-only`` holds every launch against the
plain version and the block route and times nothing.

Run from the repository root on a machine with a card::

    python3 tools/decode_tiles.py [--out build/decode_tiles.txt] [--check-only]
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
    ap.add_argument("--out", default="build/decode_tiles.txt",
                    help="file for the sweep's lines")
    ap.add_argument("--check-only", action="store_true",
                    help="check every launch, time nothing")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.gru_sequence import ref
    if not torch.cuda.is_available():
        sys.exit("decode_tiles: no CUDA card")
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
    _build.build(["gru_sequence", "gru_sequence_q8"])
    for lib in ("gru_sequence", "gru_sequence_q8"):
        log = _build.build_log(lib).splitlines()
        for i, line in enumerate(log):    # ptxas: the function, then its use
            if "Compiling entry function" in line and "decode" in line:
                fn = line.split("'")[1]
                use = " | ".join(x.strip() for x in log[i + 1:i + 4]
                                 if "registers" in x or "spill" in x)
                say(f"ptxas: {fn}: {use}")

    def sweep(q8, L, H, B, variant, knobs=True):
        a = cs.make_inputs(torch, L, H, B, 1, seed=17 * H + 5 * L + B,
                           dev=dev)
        args_ = ((a["h0"], a["xp"][0], *a["q8"]) if q8 else
                 (a["h0"], a["xp"][0], a["u"], a["wd"], a["b"]))
        want = (ref.gru_stack_decode_q8_ref if q8
                else ref.gru_stack_decode_ref)(*args_, variant)
        name = "q8" if q8 else "fp32"
        head = f"{name} L={L} H={H:2d} B={B:2d} {variant}"
        plan = (K.decode_q8_plan if q8 else K.decode_plan)(B, H, L, variant)
        old = cs.decode_block_route(K, B, H, L, q8)
        ref_bits = cs.decode_route_fn(torch, a, variant, old, q8)().clone()
        words = K.decode_q8_words(H, a["q8"][0], a["q8"][2]) if q8 else 0
        best = {}

        def one(p, vec=None):
            call = cs.decode_route_fn(torch, a, variant, p, q8, vec)
            call().fill_(float("nan"))
            got = call()
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            if not e <= TOL:
                sys.exit(f"decode_tiles: {head} {p} vec={vec}: max |err| "
                         f"{e:.3g} > {TOL}")
            if not torch.equal(got, ref_bits):
                d = (got - ref_bits).abs().max().item()
                sys.exit(f"decode_tiles: {head} {p} vec={vec}: differs "
                         f"from the block route (max {d:.3g})")
            if p.route == "warp":
                kn = f"warp warps={p.warps}" + (
                    (" words" if vec else " cover") if q8 else "")
            else:
                kn = f"block bt={p.rows}"
            mark = ("  <- the wrapper's plan" if p == plan and (
                not q8 or p.route == "block" or vec == words) else "")
            if p == old:
                mark += "  <- the block route before"
            if args.check_only:
                say(f"{head} {kn:28s} ok (err {e:.3g}, == block){mark}")
                return
            t = cs.device_time_ms(torch, call, per_graph=50)
            say(f"{head} {kn:28s} {t * 1e3:8.2f} us{mark}")
            if t < best.get(p.route, (1e9,))[0]:
                best[p.route] = (t, kn)
        warp_ok = H <= K.WARP_MAX_H and L <= (
            K.DECODE_Q8_WARP_MAX_L if q8 else K.DECODE_WARP_MAX_L)
        if warp_ok:
            for warps in (WARPS if knobs else (plan.warps,)):
                for vec in (((1, 0) if words else (0,)) if q8 else (None,)):
                    one(K.decode_warp_plan(B, warps), vec)
        for bt in (BLOCK_TILES if knobs else (old.rows,)):
            if bt <= max(B, 1):
                one(K.decode_block_plan(B, H, L, bt, q8))
        for route, (t, kn) in sorted(best.items()):
            say(f"{head} fastest {route}: {kn} {t * 1e3:.2f} us")
        say(f"{head} plan: {plan}")

    for q8 in (False, True):
        for L, H in ((3, 32), (1, 20)):
            for B in (cs.SLOTS, 1, 64):
                for variant in ("v1", "v3"):
                    sweep(q8, L, H, B, variant)
    for q8 in (False, True):
        for H in (1, 5, 20, 31, 32):
            for L in (1, 2, 3, 4):
                for variant in ("v1", "v3"):
                    sweep(q8, L, H, cs.SLOTS, variant, knobs=False)
    if not args.check_only:
        for backend, runs in cs.decode_steps_both_ways(torch, dev).items():
            for which, pr in runs:
                if pr is None:
                    continue
                say(f"served step gru-jet-deep {backend} ({cs.SLOTS} slots) "
                    f"{which}: wall {pr['wall_ms_per_step']:.4f} ms/step, "
                    f"device busy {pr['device_busy_ms_per_step']:.4f} ms/step "
                    f"(idle {pr['device_idle_share']:.3%})")
    out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
