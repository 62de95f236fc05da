#!/usr/bin/env python3
"""Tile sweep of the port's row-wise kernels on one CUDA card.

Times ``rowwise_matvec.cu``'s launchers (the C entry points, with explicit
arguments) at the matmul shapes ``chip_smoke.py``'s phase 12 times, over
the knobs of the redesigned mainloop: the column tile ``ct``, the consumer
warps, each warp's stages, the stage rows ``kc`` and the copy path (TMA
or plain loads); each shape also at the plan the wrapper picks
(``kernel.plan``), so the wrapper's rule can be read off measured numbers.
Device time per call comes from ``chip_smoke.device_time_ms`` (50 calls
captured in a CUDA graph, CUDA events around 5 replays). It also measures
the host time of one launcher call on each path (the TMA path encodes its
two tensor maps, or finds them in its cache). It sweeps ``gru_cell.cu``'s
batch and column tiles as well; with ``--sass DIR`` it writes
``cuobjdump -sass`` of both libraries into DIR. The table also goes to
``--out``.

Run from the repository root on a machine with a card::

    python3 tools/rowwise_tiles.py [--sass build/sass]
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PER_WARP = (1, 2, 3, 4, 8, 12)      # stages of each consumer warp
KCS = {"bfloat16": (32, 64), "float32": (32, 64, 128, 256)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", help="directory for cuobjdump -sass output")
    ap.add_argument("--out", default="build/rowwise_tiles.txt",
                    help="file for the sweep's lines")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, _launch
    from repro_torch.kernels.gru_cell import kernel as CK
    from repro_torch.kernels.rowwise_matvec import kernel as MK
    from repro_torch.kernels.rowwise_matvec import ops as mops
    if not torch.cuda.is_available():
        sys.exit("rowwise_tiles: no CUDA card")
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
    _build.build(["gru_cell", "rowwise_matvec"])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def timed(label, call):        # call() reads the current stream: the
        if call() != 0:            # graph capture's, when device_time_ms runs
            sys.exit(f"rowwise_tiles: {label}: launch refused")
        t = cs.device_time_ms(torch, call, per_graph=50)
        say(f"{label}: {t * 1e3:8.2f} us")
        return t

    def step(B, H, dtype, kind, bt, ct):
        h, xp, u, b = cs.step_inputs(torch, B, H, dtype, 1, dev)
        out_, zs, rhs = (torch.empty(B, H, device=dev) for _ in range(3))
        bf16 = int(u.dtype == torch.bfloat16)
        if kind == "blocked":
            fn = _launch.launcher("gru_cell", "gru_step_blocked_launch",
                                  CK._BLOCKED_ARGS)
            ptrs = [t.data_ptr() for t in (h, xp, u, b, zs, rhs, out_)]

            def call():
                return fn(*ptrs, B, H, bf16, bt, ct, 1, _launch.stream(dev))
        else:
            fn = _launch.launcher("gru_cell", "gru_step_fused_launch",
                                  CK._FUSED_ARGS)
            ptrs = [t.data_ptr() for t in (h, xp, u, b, out_)]

            def call():
                return fn(*ptrs, B, H, int(kind == "v3"), bf16, bt, ct, 1,
                          _launch.stream(dev))
        timed(f"{kind:8s} B={B} H={H} {dtype:8s} bt={bt} ct={ct:2d}", call)

    def matmul_call(kind, x, w, y, bk, ct, kc, stages, warps, route):
        B, K = x.shape
        N = w.shape[1]
        bf16 = int(x.dtype == torch.bfloat16)
        ptrs = [t.data_ptr() for t in (x, w, y)]
        if kind == "rowwise":
            fn = _launch.launcher("rowwise_matvec", "rowwise_matmul_launch",
                                  MK._ROWWISE_ARGS)
            return lambda: fn(*ptrs, B, K, N, bf16, ct, kc, stages, warps,
                              route, _launch.stream(dev))
        fn = _launch.launcher("rowwise_matvec", "cascade_matmul_launch",
                              MK._CASCADE_ARGS)
        return lambda: fn(*ptrs, B, K, N, bk, bf16, ct, kc, stages, warps,
                          route, _launch.stream(dev))

    def sweep(kind, B, K, N, dtype):
        x, w = cs.mm_inputs(torch, B, K, N, dtype, 1, dev)
        y = torch.empty(B, N, device=dev, dtype=(
            x.dtype if kind == "rowwise" else torch.float32))
        bk = (K if kind == "rowwise"
              else mops.auto_blocks(B, K, N, x.element_size())[2])
        p = MK.plan(x, w, bk, sms)
        head = f"{kind:8s} B={B} K={K:4d} N={N:4d} {dtype:8s}"

        def one(ct, kc, per, warps, route, tag=""):
            """Time ct, kc, `per` stages for each of `warps` consumers."""
            nchunks = (K // bk) * -(-bk // kc)
            if MK.ROUTES[route] == "direct" and (nchunks > 1
                                                 or dtype != "float32"):
                return None                # one fp32 chunk only
            per = min(per, -(-nchunks // warps))
            smem = MK.smem_bytes(x.dtype, B, K, bk, ct, kc, per * warps,
                                 warps)
            if smem > _launch.SMEM_LIMIT:
                return None
            return timed(f"{head} ct={ct:2d} kc={kc:3d} stages={per:2d}x"
                         f"{warps} {MK.ROUTES[route]:8s}{tag}",
                         matmul_call(kind, x, w, y, bk, ct, kc, per * warps,
                                     warps, route))
        rc = MK.ROUTES.index(p.route)
        one(p.ct, p.kc, p.stages // p.warps, p.warps, rc,
            "  <- the wrapper's plan")
        best = {}
        for route in sorted({rc, MK.ROUTES.index("tma")}):
            for ct in MK.COLUMN_TILES:
                for warps in (1, 2, 4, 8, 12, 16):
                    t = one(ct, p.kc, 64, warps, route)
                    if t is not None:
                        best[(route, ct, warps)] = t
        route, ct, warps = min(best, key=best.get)
        for per in PER_WARP:
            one(ct, p.kc, per, warps, route)
        for kc in KCS[dtype]:
            if kc != p.kc and kc <= bk:
                one(ct, kc, 64, warps, route)
        for other in range(len(MK.ROUTES)):
            if other != route:
                one(ct, p.kc, 64, warps, other)
        say(f"{head} fastest: {MK.ROUTES[route]} ct={ct} warps={warps} "
            f"{best[(route, ct, warps)] * 1e3:.2f} us")
        if p.route != "plain":     # host time of one launcher call per path
            for path in range(len(MK.ROUTES)):
                call = matmul_call(kind, x, w, y, bk, p.ct, p.kc, p.stages,
                                   p.warps, path)
                if call() != 0:            # a route the shape does not take
                    continue
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(500):
                    call()
                host = (time.perf_counter() - t0) / 500
                torch.cuda.synchronize()
                say(f"{head} host time per launcher call "
                    f"({MK.ROUTES[path]}): {host * 1e6:.2f} us")

    for name, shape in cs.ROWWISE_TIMED:
        if name.endswith("matmul"):
            B, K, N, _, dtype = shape
            sweep(name.split("_")[0], B, K, N, dtype)
    for bt in (1, 2, 4, 8):
        step(8, 1024, "float32", "blocked", bt, 8)
    step(1, 1024, "float32", "blocked", 1, 8)
    for ct in (16, 32):
        step(8, 1024, "float32", "blocked", 8, ct)
        step(1, 1024, "float32", "blocked", 1, ct)
    for bt in (1, 2, 4, 8):
        step(8, 2048, "float32", "blocked", bt, 8)
    for bt in (1, 2, 4, 8):
        step(8, 1024, "float32", "v3", bt, 8)
    step(1, 1024, "float32", "v3", 1, 8)
    for bt in (1, 8):
        step(8, 32, "float32", "v1", bt, 32)
        step(8, 32, "float32", "v3", bt, 32)
    step(1, 32, "float32", "v1", 1, 32)
    step(1, 1000, "float32", "v1", 1, 32)
    step(1, 1000, "float32", "v1", 1, 8)
    out.write_text("\n".join(lines) + "\n")
    if args.sass:
        out_dir = Path(args.sass)
        out_dir.mkdir(parents=True, exist_ok=True)
        for name in ("gru_cell", "rowwise_matvec"):
            sass = subprocess.run(
                [str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
                 str(_build.library_path(name))], capture_output=True,
                text=True)
            (out_dir / f"{name}.sass").write_text(sass.stdout + sass.stderr)
            print(f"sass of {name}: {out_dir / f'{name}.sass'}", flush=True)


if __name__ == "__main__":
    main()
