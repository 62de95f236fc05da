#!/usr/bin/env python3
"""Route and knob sweep of the two q8 prefill kernels on one CUDA card
(``csrc/gru_sequence_q8.cu``): ``gru_sequence_q8_kernel`` (row 6, the q8
chain's layer) and ``gru_stack_sequence_q8_kernel`` (row 4, the fused q8
prefill).

Forces each route through the C entry points, with explicit arguments.
Row 6: the warp route at 1, 2, 4 and 8 warps a block, U's rows as whole
4-byte words where H % 4 == 0 and through the aligned words that cover
them; the block route at batch tiles 1, 2, 4 and 8. Row 4: the warp route
(a block a batch row on the layer-skewed wavefront), word and cover
loads; the block route at the same tiles.
Shapes: the served widths (row 6 H 32 and 20; row 4 L=3 H=32 and L=1
H=20) at 8 slots, T 16 and the served 32, v1 and v3, masked and not; B 1
and 64; more T at 8 slots; row 4 at L 2 and 4; then every H of 1, 5, 20,
31 and 32 by L 1-4 (row 6: L = 1), B 1 and 8, T 1, 17 and 64, v1 and v3,
masked, the plan against the old block route only; and misaligned int8
rows (views 1-3 bytes past a word boundary), which take the cover loads.
Each forced launch is held against the plain version (largest absolute
error at most 1e-5) and against the block route at the tile the wrapper
gave it before the warp route (bit for bit) before it is timed. Device
time per call comes from ``chip_smoke.device_time_ms`` (graph replay).
Each shape's lines mark the wrapper's plan (``kernel.seq_q8_plan``,
``kernel.stack_seq_q8_plan``) and the old block route, and end with the
fastest launch of each route; the last lines rank each warp-route
setting by its time over the fastest setting of its shape (geometric
mean over the timed shapes), which is how the plans' settings are read.

It prints ``-Xptxas -v``'s lines for the q8 prefill kernels first. The
table also goes to ``--out``; ``--check-only`` holds every launch against
the plain version and the block route and times nothing.

Run from the repository root on a machine with a card::

    python3 tools/seq_q8_tiles.py [--out build/seq_q8_tiles.txt]
        [--check-only]
"""
from __future__ import annotations

import argparse
import itertools
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
WARPS = (1, 2, 4, 8)
BLOCK_TILES = (1, 2, 4, 8)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/seq_q8_tiles.txt",
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
        sys.exit("seq_q8_tiles: no CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    ratios = {}              # (row, setting) -> [time / shape's fastest]

    def say(line):
        print(line, flush=True)
        lines.append(line)
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    _build.build(["gru_sequence_q8"])
    log = _build.build_log("gru_sequence_q8").splitlines()
    for i, line in enumerate(log):        # ptxas: the function, then its use
        if "Compiling entry function" in line and "sequence_q8" in line:
            fn = line.split("'")[1]
            use = " | ".join(x.strip() for x in log[i + 1:i + 4]
                             if "registers" in x or "spill" in x)
            say(f"ptxas: {fn}: {use}")

    def skewed(a, skew):
        """``a`` with its int8 rows (u_q and wd_q) moved ``skew`` bytes past
        a 4-byte boundary, among foreign bytes."""
        q = list(a["q8"])
        for i in (0, 2):
            flat = torch.randint(-127, 128, (skew + q[i].numel() + 8,),
                                 dtype=torch.int8, device=dev)
            v = flat[skew:skew + q[i].numel()].view_as(q[i])
            v.copy_(q[i])
            q[i] = v
        return dict(a, q8=tuple(q))

    def sweep(row, L, H, B, T, variant, masked, knobs=True, skew=0):
        a = cs.make_inputs(torch, L, H, B, T,
                           seed=17 * H + 5 * L + B + T + skew, dev=dev)
        if skew:
            a = skewed(a, skew)
        m = a["mask"] if masked else None
        name = ("gru_sequence_q8_kernel" if row == 6
                else "gru_stack_sequence_q8_kernel")
        if row == 6:
            u_q, u_eff, _, _, b = (x[0] for x in a["q8"])
            want = (ref.gru_sequence_q8_ref(a["h0"][0], a["xp"], u_q, u_eff,
                                            b, m, variant),)
            words = K.q8_words(H, u_q)
        else:
            want = ref.gru_stack_sequence_q8_ref(a["h0"], a["xp"], *a["q8"],
                                                 m, variant)
            words = K.decode_q8_words(H, a["q8"][0], a["q8"][2])
        head = (f"row {row} L={L} H={H:2d} B={B:2d} T={T:2d} {variant} "
                f"{'masked' if masked else 'dense '}"
                + (f" skew {skew}" if skew else ""))
        plan, old_call = cs.prefill_routes(torch, K, name, a, variant,
                                           masked)
        ref_bits = [x.clone() for x in old_call()]
        old = (cs.seq_q8_block_route(K, B, H) if row == 6
               else cs.stack_q8_block_route(K, B, H, L))
        best, times = {}, {}

        def one(p, setting, **kw):
            if row == 6:
                f = cs.seq_q8_route_fn(torch, a, variant, masked, p, **kw)

                def call():
                    return (f(),)
            else:
                call = cs.stack_q8_route_fn(torch, a, variant, masked, p,
                                            **kw)
            for x in call():
                x.fill_(float("nan"))
            got = call()
            torch.cuda.synchronize()
            e = max((g - w).abs().max().item() for g, w in zip(got, want))
            if not e <= TOL:
                sys.exit(f"seq_q8_tiles: {head} {setting}: max |err| "
                         f"{e:.3g} > {TOL}")
            if not all(torch.equal(g, r) for g, r in zip(got, ref_bits)):
                d = max((g - r).abs().max().item()
                        for g, r in zip(got, ref_bits))
                sys.exit(f"seq_q8_tiles: {head} {setting}: differs from the "
                         f"block route (max {d:.3g})")
            mark = ""
            if p == plan and (p.route == "block" or kw.get("vec") == words):
                mark = "  <- the wrapper's plan"
            if p == old:
                mark += "  <- the block route before"
            if args.check_only:
                say(f"{head} {setting:34s} ok (err {e:.3g}, == block){mark}")
                return
            t = cs.device_time_ms(torch, call, per_graph=20)
            say(f"{head} {setting:34s} {t * 1e3:8.2f} us{mark}")
            times[setting] = (p.route, t)
            if t < best.get(p.route, (1e9,))[0]:
                best[p.route] = (t, setting)

        warp_ok = H <= K.WARP_MAX_H and (
            row == 6 or L <= K.STACK_Q8_WARP_MAX_L)
        vecs = (1, 0) if words else (0,)
        if warp_ok and row == 6:
            settings = (itertools.product(WARPS, vecs) if knobs else
                        [(plan.warps, words)])
            for warps, vec in settings:
                one(K.warp_plan(B, 1, warps, K.SEQ_Q8_DEPTH),
                    f"warp warps={warps} {'words' if vec else 'cover'}",
                    vec=vec)
        if warp_ok and row == 4:
            for vec in (vecs if knobs else (words,)):
                one(K.stack_seq_warp_plan(B, L),
                    f"warp {'words' if vec else 'cover'}", vec=vec)
        for bt in (BLOCK_TILES if knobs else (old.rows,)):
            if bt <= max(B, 1):
                p = (K.block_plan(B, H, bt, q8=True) if row == 6 else
                     K.stack_seq_block_plan(B, H, L, bt, q8=True))
                one(p, f"block bt={bt}")
        for route, (t, setting) in sorted(best.items()):
            say(f"{head} fastest {route}: {setting} {t * 1e3:.2f} us")
        if knobs and "warp" in best:
            fastest = best["warp"][0]
            for setting, (route, t) in times.items():
                if route == "warp":
                    ratios.setdefault((row, setting), []).append(t / fastest)
        say(f"{head} plan: {plan}")

    # row 6: the served widths, then more T, then B 1 and 64
    for H in (32, 20):
        for T, variant, masked in itertools.product(
                (16, 32), ("v1", "v3"), (True, False)):
            sweep(6, 1, H, cs.SLOTS, T, variant, masked)
        for T in (1, 8, 64):
            sweep(6, 1, H, cs.SLOTS, T, "v1", True)
        for B, T in itertools.product((1, 64), (16, 32)):
            sweep(6, 1, H, B, T, "v1", True)
    # row 4: gru-jet-deep's and gru-jet's fused q8 prefills, then L 2 and 4
    for L, H in ((3, 32), (1, 20)):
        for T, variant, masked in itertools.product(
                (16, 32), ("v1", "v3"), (True, False)):
            sweep(4, L, H, cs.SLOTS, T, variant, masked)
        for B, T in itertools.product((1, 64), (16, 32)):
            sweep(4, L, H, B, T, "v1", True)
    for L, T in itertools.product((2, 4), (16, 32)):
        sweep(4, L, 32, cs.SLOTS, T, "v1", True)
    # every width to a warp, every depth to the bound: the plan only
    for H, B, T, variant in itertools.product((1, 5, 20, 31, 32), (1, 8),
                                              (1, 17, 64), ("v1", "v3")):
        sweep(6, 1, H, B, T, variant, True, knobs=False)
        for L in range(1, K.STACK_Q8_WARP_MAX_L + 1):
            sweep(4, L, H, B, T, variant, True, knobs=False)
    # misaligned int8 rows: the cover loads, bit for bit
    for H, skew, variant in itertools.product((20, 32), (1, 2, 3),
                                              ("v1", "v3")):
        sweep(6, 1, H, cs.SLOTS, 16, variant, True, knobs=False, skew=skew)
        sweep(4, 3, H, cs.SLOTS, 16, variant, True, knobs=False, skew=skew)
    for (row, setting), rs in sorted(
            ratios.items(), key=lambda kv: (kv[0][0], math.prod(kv[1])
                                            ** (1 / len(kv[1])))):
        gm = math.prod(rs) ** (1 / len(rs))
        say(f"row {row} {setting:34s} x{gm:.3f} of the fastest setting "
            f"(geometric mean over {len(rs)} shapes; worst x{max(rs):.3f})")
    out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
