#!/usr/bin/env python3
"""Route and knob sweep of the fused prefill on one CUDA card
(``gru_stack_sequence_kernel``, ``csrc/gru_sequence.cu``): L layers over
T steps in one launch.

Forces each route through the C entry points, with explicit arguments:
the warp route (a block a batch row, on a wavefront skewed by layer: a
gate warp per layer, a projection warp between two layers) and the block
route at batch tiles 1, 2, 4 and 8. Shapes: gru-jet-deep's (L=3 H=32) at
8 slots and B 1 and 64, T 8, 16, 32 and 64, v1 and v3, masked and not at
T=16, every tile; L 1 and 2 (H=32, 8 slots, T 16 and 32), every tile;
then L 1-4 by H 1, 5, 20, 31 and 32, B 1 and 8, T 1, 17 and 64, v1 and
v3, masked, the plan against the old block route. Each forced launch is held against the plain version
(largest absolute error at most 1e-5) and the warp route against the
block route (bit for bit) before it is timed. Device time per call comes
from ``chip_smoke.device_time_ms`` (graph replay). Each shape's lines
mark the wrapper's plan (``kernel.stack_seq_plan``) and the block route
at the tile the wrapper gave it before the warp route, and end with the
fastest launch of each route; ``torch.nn.GRU`` (cuDNN,
``chip_smoke.cudnn_gru_ms``) is timed beside gru-jet-deep's v3 unmasked
shapes at 8 slots.

It prints ``-Xptxas -v``'s lines for the route's instances first. The
table also goes to ``--out``; ``--check-only`` holds every launch against
the plain version and the block route and times nothing.

Run from the repository root on a machine with a card::

    python3 tools/stack_seq_tiles.py [--out build/stack_seq_tiles.txt]
        [--check-only]
"""
from __future__ import annotations

import argparse
import itertools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
BLOCK_TILES = (1, 2, 4, 8)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/stack_seq_tiles.txt",
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
        sys.exit("stack_seq_tiles: no CUDA card")
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
        if "Compiling entry function" in line and "stack_sequence" in line:
            fn = line.split("'")[1]
            use = " | ".join(x.strip() for x in log[i + 1:i + 4]
                             if "registers" in x or "spill" in x)
            say(f"ptxas: {fn}: {use}")

    def sweep(L, H, B, T, variant, masked, tiles=True):
        a = cs.make_inputs(torch, L, H, B, T, seed=17 * H + 5 * L + B + T,
                           dev=dev)
        m = a["mask"] if masked else None
        want = ref.gru_stack_sequence_ref(a["h0"], a["xp"], a["u"], a["wd"],
                                          a["b"], m, variant)
        head = (f"L={L} H={H:2d} B={B:2d} T={T:2d} {variant} "
                f"{'masked' if masked else 'dense '}")
        plan = K.stack_seq_plan(B, T, H, L, variant)
        old = cs.stack_block_route(K, B, H, L)
        ref_bits = [x.clone() for x in cs.stack_route_fn(
            torch, a, variant, masked, old)()]
        best = {}

        def one(p):
            call = cs.stack_route_fn(torch, a, variant, masked, p)
            for x in call():
                x.fill_(float("nan"))
            got = call()
            torch.cuda.synchronize()
            e = max((g - w).abs().max().item() for g, w in zip(got, want))
            if not e <= TOL:
                sys.exit(f"stack_seq_tiles: {head} {p}: max |err| {e:.3g} "
                         f"> {TOL}")
            if not all(torch.equal(g, r) for g, r in zip(got, ref_bits)):
                d = max((g - r).abs().max().item()
                        for g, r in zip(got, ref_bits))
                sys.exit(f"stack_seq_tiles: {head} {p}: differs from the "
                         f"block route (max {d:.3g})")
            kn = "warp" if p.route == "warp" else f"block bt={p.rows}"
            mark = "  <- the wrapper's plan" if p == plan else ""
            if p == old:
                mark += "  <- the block route before"
            if args.check_only:
                say(f"{head} {kn:32s} ok (err {e:.3g}, == block){mark}")
                return
            t = cs.device_time_ms(torch, call, per_graph=20)
            say(f"{head} {kn:32s} {t * 1e3:8.2f} us{mark}")
            if t < best.get(p.route, (1e9,))[0]:
                best[p.route] = (t, kn)
        if H <= K.WARP_MAX_H and L <= K.STACK_WARP_MAX_L:
            one(K.stack_seq_warp_plan(B, L))
        for bt in (BLOCK_TILES if tiles else (old.rows,)):
            if bt <= max(B, 1):
                one(K.stack_seq_block_plan(B, H, L, bt))
        for route, (t, kn) in sorted(best.items()):
            say(f"{head} fastest {route}: {kn} {t * 1e3:.2f} us")
        if (not args.check_only and L == 3 and H == 32 and B == cs.SLOTS
                and variant == "v3" and not masked):
            lib = cs.cudnn_gru_ms(torch, dev, T=T, H=H, L=L)
            say(f"{head} torch.nn.GRU (cuDNN)    {lib * 1e3:8.2f} us")
        say(f"{head} plan: {plan}")

    for B in (cs.SLOTS, 1, 64):
        for T in (16, 32, 8, 64):
            for variant in ("v1", "v3"):
                for masked in ((False, True) if T == 16 else (False,)):
                    if B != cs.SLOTS and (T not in (16, 32) or masked):
                        continue
                    sweep(3, 32, B, T, variant, masked)
    for L, T, variant in itertools.product((1, 2), (16, 32), ("v1", "v3")):
        sweep(L, 32, cs.SLOTS, T, variant, True)
    for L, H in itertools.product((1, 2, 3, 4), (1, 5, 20, 31, 32)):
        for B, T, variant in itertools.product((1, 8), (1, 17, 64),
                                               ("v1", "v3")):
            sweep(L, H, B, T, variant, True, tiles=False)
    out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
