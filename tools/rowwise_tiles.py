#!/usr/bin/env python3
"""Tile sweep of the port's row-wise kernels on one CUDA card.

Times ``gru_cell.cu``'s and ``rowwise_matvec.cu``'s launchers at forced
batch tiles (``bt``, rows per block) and column tiles (``ct``), at the
shapes ``chip_smoke.py``'s row-wise phase drives, so a tile rule in the
wrappers can be read off measured numbers. Device time per call comes
from ``chip_smoke.device_time_ms`` (50 calls captured in a CUDA graph,
CUDA events around 5 replays). With ``--sass DIR`` it also writes
``cuobjdump -sass`` of both libraries into DIR.

Run from the repository root on a machine with a card::

    python3 tools/rowwise_tiles.py [--sass build/sass]
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", help="directory for cuobjdump -sass output")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, _launch
    from repro_torch.kernels.gru_cell import kernel as CK
    from repro_torch.kernels.rowwise_matvec import kernel as MK
    if not torch.cuda.is_available():
        sys.exit("rowwise_tiles: no CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.build(["gru_cell", "rowwise_matvec"])

    def timed(label, call):        # call() reads the current stream: the
        if call() != 0:            # graph capture's, when device_time_ms runs
            sys.exit(f"rowwise_tiles: {label}: launch refused")
        t = cs.device_time_ms(torch, call, per_graph=50)
        print(f"{label}: {t * 1e3:8.2f} us", flush=True)

    def step(B, H, dtype, kind, bt, ct):
        h, xp, u, b = cs.step_inputs(torch, B, H, dtype, 1, dev)
        out, zs, rhs = (torch.empty(B, H, device=dev) for _ in range(3))
        bf16 = int(u.dtype == torch.bfloat16)
        if kind == "blocked":
            fn = _launch.launcher("gru_cell", "gru_step_blocked_launch",
                                  CK._BLOCKED_ARGS)
            ptrs = [t.data_ptr() for t in (h, xp, u, b, zs, rhs, out)]

            def call():
                return fn(*ptrs, B, H, bf16, bt, ct, 1, _launch.stream(dev))
        else:
            fn = _launch.launcher("gru_cell", "gru_step_fused_launch",
                                  CK._FUSED_ARGS)
            ptrs = [t.data_ptr() for t in (h, xp, u, b, out)]

            def call():
                return fn(*ptrs, B, H, int(kind == "v3"), bf16, bt, ct, 1,
                          _launch.stream(dev))
        timed(f"{kind:8s} B={B} H={H} {dtype:8s} bt={bt} ct={ct:2d}", call)

    def matmul(B, K, N, dtype, kind, bt, ct):
        x, w = cs.mm_inputs(torch, B, K, N, dtype, 1, dev)
        y = torch.empty(B, N, device=dev, dtype=(
            x.dtype if kind == "rowwise" else torch.float32))
        bf16 = int(x.dtype == torch.bfloat16)
        ptrs = [t.data_ptr() for t in (x, w, y)]
        if kind == "rowwise":
            fn = _launch.launcher("rowwise_matvec", "rowwise_matmul_launch",
                                  MK._ROWWISE_ARGS)

            def call():
                return fn(*ptrs, B, K, N, bf16, bt, ct, min(K, MK.MAX_CHUNK),
                          1, _launch.stream(dev))
        else:
            fn = _launch.launcher("rowwise_matvec", "cascade_matmul_launch",
                                  MK._CASCADE_ARGS)

            def call():       # auto_blocks' block_k at these shapes: 512
                return fn(*ptrs, B, K, N, 512, bf16, bt, ct, 512, 1,
                          _launch.stream(dev))
        timed(f"{kind:8s} B={B} K={K} N={N} {dtype:8s} bt={bt} ct={ct:2d}",
              call)

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
    for dtype in ("bfloat16", "float32"):
        cts = (16, 32) if dtype == "bfloat16" else (8, 16, 32)
        ct0 = cts[0]
        for K, N in ((1024, 3072), (3072, 1024)):
            for bt in (1, 2, 4):
                for ct in cts:
                    matmul(4, K, N, dtype, "rowwise", bt, ct)
            matmul(1, K, N, dtype, "rowwise", 1, ct0)
            for bt in (4, 2, 1):
                matmul(4, K, N, dtype, "cascade", bt, ct0)
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
