#!/usr/bin/env python3
"""Split sweep of the port's flash-decode kernel on one CUDA card.

Times ``decode_attn.cu`` through its wrapper at forced split counts (the
``splits`` that ``kernels/decode_attn/kernel.py::num_splits`` picks, and
others), at qwen3-0.6b's heads and the caches ``chip_smoke.py`` times
(the served C = 76 and 192 at 4 requests, C = 2112 at 1 and 4), bf16 and
fp32, so the split rule can be read off measured numbers. Each row also
holds the largest difference from the plain version. Device time per call
comes from ``chip_smoke.device_time_ms`` (50 calls captured in a CUDA
graph, CUDA events around 5 replays).

Run from the repository root on a machine with a card::

    python3 tools/decode_splits.py
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHES = ((4, 76, (0, 12), 12), (4, 192, (0, 128), 128),
          (1, 2112, (0, 2048), 2048), (4, 2112, (0, 2048), 2048))


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.decode_attn import ref as dref
    if not torch.cuda.is_available():
        sys.exit("decode_splits: no CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rule = DK.num_splits
    try:
        for B, C, written, pos in CACHES:
            tiles = -(-C // DK.BLOCK_C)
            picked = rule(B, cs.HKV, C, DK.sm_count(dev))
            for dtype in (torch.bfloat16, torch.float32):
                q, kc, vc, mask = cs.decode_inputs(torch, B, C, written, pos,
                                                   0, dtype, 11, dev)
                want = dref.flash_decode_plain(q, kc, vc, mask)
                for sp in sorted({1, picked, min(tiles, 4), min(tiles, 8),
                                  min(tiles, 16), tiles}):
                    DK.num_splits = lambda *_, sp=sp: sp
                    got = DK.flash_decode(q, kc, vc, mask)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    t = cs.device_time_ms(
                        torch, lambda: DK.flash_decode(q, kc, vc, mask),
                        per_graph=50)
                    mark = "  <- num_splits" if sp == picked else ""
                    print(f"{str(dtype)[6:]:8s} B={B} C={C:4d} splits={sp:2d}"
                          f" ({B * cs.HKV * sp:3d} blocks): {t * 1e3:7.2f} us"
                          f"  max |kernel - plain| {err:.3g}{mark}",
                          flush=True)
    finally:
        DK.num_splits = rule


if __name__ == "__main__":
    main()
