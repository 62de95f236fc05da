#!/usr/bin/env python3
"""Route sweep of the fused sLSTM kernels on one CUDA card
(``slstm_stack_decode_kernel`` and ``slstm_stack_sequence_kernel``,
``csrc/slstm_cell.cu``).

Forces each route through the C entry points (``kernel.launch_decode``
and ``kernel.launch_sequence`` at explicit plans): the warp route (its one
launch, either kernel: a block of 2L - 1 warps a batch row; the decode
its T = 1) and both kernels' block route at batch tiles 1, 2, 4 and 8.
Shapes: the served ones (slstm-jet L=1 H=20 and the L=3 H=32 stack) at 8
slots and B 1 and 64, the prefill at T 8, 16, 32 and 64 masked and at
T=16 unmasked, every tile; then H 1, 5, 20, 31 and 32 by L 1-4 at B 1 and
8 (the prefill at T 1, 17 and 64, masked), the plan against the old
block route. Each forced launch is held against the plain version
(largest absolute error at most 1e-5) and the warp route against the
block route (bit for bit) before it is timed. Device time per call comes
from ``chip_smoke.device_time_ms`` (calls captured in a CUDA graph, CUDA
events around the replays). Each shape's lines mark the wrapper's plan
(``slstm_decode_plan`` / ``slstm_stack_seq_plan``) and the block route at
the tile the wrapper gave it before the warp route, and end with the
fastest launch of each route.

Then the served slstm-jet and L=3 H=32 decode steps with the decode's
block route forced and with the plan, in turns old, new, new, old
(``chip_smoke.slstm_steps_both_ways``). It prints ``-Xptxas -v``'s lines
for the sLSTM kernels first. The table also goes to ``--out``;
``--check-only`` holds every launch against the plain version and the
block route and times nothing.

Run from the repository root on a machine with a card::

    python3 tools/slstm_tiles.py [--out build/slstm_tiles.txt] [--check-only]
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
BLOCK_TILES = (1, 2, 4, 8)
DECODE = "slstm_stack_decode_kernel"
SEQUENCE = "slstm_stack_sequence_kernel"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/slstm_tiles.txt",
                    help="file for the sweep's lines")
    ap.add_argument("--check-only", action="store_true",
                    help="check every launch, time nothing")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, _launch
    from repro_torch.kernels.slstm_cell import kernel as SK
    if not torch.cuda.is_available():
        sys.exit("slstm_tiles: no CUDA card")
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
    _build.build(["slstm_cell"])
    log = _build.build_log("slstm_cell").splitlines()
    for i, line in enumerate(log):    # ptxas: the function, then its use
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            use = " | ".join(x.strip() for x in log[i + 1:i + 4]
                             if "registers" in x or "spill" in x)
            say(f"ptxas: {fn}: {use}")

    def sweep(name, L, H, B, T, masked, knobs=True):
        a = cs.make_slstm_inputs(torch, L, H, B, T,
                                 seed=17 * H + 5 * L + B + T, dev=dev)
        want = cs.run_slstm_kernel(name, a, masked, plain=True)
        decode = name == DECODE
        head = f"{'decode' if decode else 'prefill'} L={L} H={H:2d} B={B:2d}"
        if not decode:
            head += f" T={T:2d} {'masked' if masked else 'dense'}"
        plan, old_call = cs.slstm_routes(torch, name, a, masked)
        old = SK.block_plan(B, H, L, min(B, _launch.DEFAULT_BATCH_BLOCK))
        ref_bits = [x.clone() for x in old_call()]
        best = {}

        def one(p):
            call = cs.slstm_route_fn(torch, name, a, masked, p)
            got = call()
            torch.cuda.synchronize()
            e = max((g - w).abs().max().item() for g, w in zip(got, want))
            if not e <= TOL:
                sys.exit(f"slstm_tiles: {head} {p}: max |err| {e:.3g} > "
                         f"{TOL}")
            if not all(torch.equal(g, r) for g, r in zip(got, ref_bits)):
                d = max((g - r).abs().max().item()
                        for g, r in zip(got, ref_bits))
                sys.exit(f"slstm_tiles: {head} {p}: differs from the block "
                         f"route (max {d:.3g})")
            kn = "warp" if p.route == "warp" else f"block bt={p.rows}"
            mark = "  <- the wrapper's plan" if p == plan else ""
            if p == old:
                mark += "  <- the block route before"
            if args.check_only:
                say(f"{head} {kn:28s} ok (err {e:.3g}, == block){mark}")
                return
            t = cs.device_time_ms(torch, call, per_graph=200 if decode
                                  else 50)
            say(f"{head} {kn:28s} {t * 1e3:8.2f} us{mark}")
            if t < best.get(p.route, (1e9,))[0]:
                best[p.route] = (t, kn)
        if H <= SK.WARP_MAX_H and L <= SK.WARP_MAX_L:
            one(SK.warp_plan(B, L))
        for bt in (BLOCK_TILES if knobs else (old.rows,)):
            if bt <= max(B, 1) and SK.smem_bytes(L, H, bt) <= \
                    _launch.SMEM_LIMIT:
                one(SK.block_plan(B, H, L, bt))
        for route, (t, kn) in sorted(best.items()):
            say(f"{head} fastest {route}: {kn} {t * 1e3:.2f} us")
        say(f"{head} plan: {plan}")

    for L, H in ((3, 32), (1, 20)):
        for B in (cs.SLOTS, 1, 64):
            sweep(DECODE, L, H, B, 1, False)
            for T, masked in ((8, True), (16, True), (16, False), (32, True),
                              (64, True)):
                sweep(SEQUENCE, L, H, B, T, masked)
    for H in (1, 5, 20, 31, 32):
        for L in (1, 2, 3, 4):
            for B in (1, cs.SLOTS):
                sweep(DECODE, L, H, B, 1, False, knobs=False)
                for T in (1, 17, 64):
                    sweep(SEQUENCE, L, H, B, T, True, knobs=False)
    if not args.check_only:
        for arch, runs in cs.slstm_steps_both_ways(torch, dev).items():
            for which, pr in runs:
                if pr is None:
                    continue
                say(f"served step {arch} cuda_fused ({cs.SLOTS} slots) "
                    f"{which}: wall {pr['wall_ms_per_step']:.4f} ms/step, "
                    f"device busy {pr['device_busy_ms_per_step']:.4f} ms/step "
                    f"(idle {pr['device_idle_share']:.3%}), aten::stack "
                    f"{pr['stack_ops_per_step']:g} and aten::cat "
                    f"{pr['cat_ops_per_step']:g} a step")
    out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
