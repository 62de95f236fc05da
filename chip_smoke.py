#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result lines):

1. the device: name, count, ``nvidia-smi`` name and power limit; TF32 off;
2. build the CUDA kernels (``gru_sequence``, ``gru_sequence_q8``,
   ``gru_cell_q8``, ``slstm_cell``, ``flash_attn``, ``decode_attn``,
   ``gru_cell`` and ``rowwise_matvec``, one ``nvcc`` each, started
   together) and print ``-Xptxas -v``'s report and each kernel's dynamic
   shared memory (the attention and row-wise kernels' as the wrappers
   compute it and as the CUDA sources do, which must agree);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (gru-jet L=1 H=20, gru-jet-deep L=3 H=32, and the
   chain's depth-1 layers of H=20 and H=32; B in {1, 8, 64}; T in {8, 16,
   32}; v1 and v3; masked and not): largest absolute error at most 1e-5,
   for the three fp32 kernels, the two fused q8 kernels, the q8 chain's
   two kernels (int8 weight rows quantized on the card) and the two sLSTM
   kernels (slstm-jet L=1 H=20 and L=3 H=32; a fully masked row, whose
   leaves, ``m = M_INIT`` included, must come out bit for bit);
4. serve gru-jet and gru-jet-deep through ``ServeEngine`` with
   ``backend="cuda"`` (12 requests over 8 slots, ragged prompts of 1-20
   vectors, 16 decode steps each): every prefill and decode step must be
   attributed to ``cuda_fused``, the launch counters (zeroed just before)
   must rise by the prefills and steps served, no plain version may run,
   the class streams must equal the ``eager`` engine's on the card, and
   the prefill logits must be finite and agree with the dense reference on
   a small batch;
5. serve both configs again, pinned to ``cuda_fused_q8`` (the int8
   datapath), with the counters zeroed just before: both q8 kernels must
   launch once per prefill and per step, no fp32 kernel and no plain
   version may run, the class streams and prefill logits must equal the
   CPU run of the same pin; the share of tokens on which the q8 and fp32
   streams agree is reported only;
6. serve both configs and a heterogeneous stack (gru-jet-deep with
   ``layer_dims=(32, 32, 20)``) through the per-layer chain, with the
   counters zeroed just before: the two configs pinned to ``cuda_chain``,
   the heterogeneous stack under ``backend="cuda"``; every prefill and
   step must be attributed to ``cuda_chain``, ``gru_sequence_kernel`` must
   launch L times per prefill and L times per step, no other kernel and no
   plain version may run, and the class streams must equal the ``eager``
   engine's on the card;
7. the same three pinned to ``cuda_chain_q8``: ``gru_sequence_q8_kernel``
   must launch L times per prefill and ``gru_step_q8`` L times per step,
   no other kernel and no plain version may run, and the class streams and
   prefill logits must equal the CPU run of the same pin;
8. serve the sLSTM family: slstm-jet and slstm-jet with ``num_layers=3,
   hidden_dim=32`` through ``ServeEngine`` with ``backend="cuda"``, with
   the counters zeroed just before: every prefill and step attributed to
   ``cuda_fused``, the sequence kernel launched once per prefill and the
   decode kernel once per step, no GRU kernel and no plain version run,
   class streams equal to the ``eager`` engine's on the card, prefill
   logits within 1e-5 of the dense reference; every GRU phase above
   counts the sLSTM and attention kernels among its other kernels (none
   may run);
9. hold the dense LM's attention kernels against their plain versions on
   the card, in fp32 (at most 1e-5) and bf16 (flash attention, whose
   output is bf16: within rtol = atol = 2**-7, one bf16 ulp; flash decode,
   whose output is fp32: at most 1e-5): qwen3-0.6b's heads (Hq 16, Hkv 8,
   D 128) at S = 12, 128 and 2048, a window, Sq and Sk off the tiles,
   rows with no valid key (exactly 0); decode with C = S + 64, a wrapped
   ring, a window, empty slots and a fully masked cache (exactly 0);
10. serve qwen3-0.6b at full width (28 layers, d_model 1024, vocab
   151,936; fp32 params from seed 0, bf16 compute, ``attn_impl="cuda"``)
   through ``ServeEngine.generate``: two waves of 4 requests (prompt
   lengths 12, and 128 and 12), 16 new tokens each, with the counters
   zeroed just before: flash attention must launch 28 times per prefill
   and flash decode 28 times per decode step, no plain version and no
   recurrent kernel may run; then the same waves in fp32 through
   ``attn_impl="chunked"``: logits along the served tokens within
   ``LM_LOGIT_TOL`` of the bf16 run, and the token streams equal or,
   where they part, the fp32 run's two top logits within that tolerance;
11. the paper's row-wise primitives through their entry points, with the
   counters zeroed just before: ``gru_step_cuda`` at gru-jet's H=20 and
   gru-jet-deep's H=32 (B 1 and 8, v1 and v3, fp32 and bf16 u), at
   H=1024 and 2048 v1 (fp32; bf16 at 2048), at H=1024 v3 and H=1000 v1;
   ``rowwise`` and ``cascade`` at JAX's test shapes, the paper's matvec
   (B=8, K=32, N=96; also a 1-D x) and qwen3-0.6b's MLP matvecs (B=4, K
   1024 -> N 3072 and 3072 -> 1024), fp32 and bf16. Each call must launch
   exactly the kernel JAX's dispatch rule names (``gru_step_fused`` or
   ``gru_step_blocked``; ``rowwise_matmul``, ``cascade_matmul``), no plain
   version and no other kernel may run; then each output is held against
   its plain version on the card (step: fp32 1e-5, bf16 u 1e-2; matmuls
   rtol = atol 2e-4 fp32, 2e-2 bf16);
12. time each kernel and its plain version with CUDA events, on the device
   (calls captured in a CUDA graph and replayed, so the host's per-call
   cost is left out) and per call from Python; the bound is the bytes over
   3.35 TB/s or the operations over their type's peak (67 TFLOP/s fp32,
   989 TFLOP/s bf16, 1,979 TOP/s int8), whichever is larger; the attention
   kernels beside one ``scaled_dot_product_attention`` call on the same
   inputs and the matmuls beside one ``torch.matmul`` (TF32 off) where it
   computes the same function (timed only; the port never calls either);
   and profile a served
   decode step of gru-jet-deep through ``cuda_fused``, ``cuda_fused_q8``,
   ``cuda_chain`` and ``cuda_chain_q8``, of slstm-jet through
   ``cuda_fused``, and of qwen3-0.6b through ``attn_impl="cuda"``. The
   engine's decode-step p50/p99 come from phases 4-8 and 10 (host clock).

Then it prints one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi``
line, and as the last line ``{"ok": true, "device": {...}}``. Without a
card, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOP_PER_S = 67e12            # H100 SXM fp32 outside the tensor cores
INT8_OP_PER_S = 1979e12            # H100 SXM int8, dense (tensor cores)
BF16_FLOP_PER_S = 989e12           # H100 SXM bf16, dense (tensor cores)
TOL = 1e-5
BF16_TOL = 2.0 ** -7               # one bf16 ulp of an output near 1
SLOTS, REQUESTS, MAX_PROMPT, MAX_NEW = 8, 12, 20, 16
KERNEL_SOURCE = {
    "gru_sequence_kernel": "src/repro_torch/csrc/gru_sequence.cu",
    "gru_stack_sequence_kernel": "src/repro_torch/csrc/gru_sequence.cu",
    "gru_stack_decode_kernel": "src/repro_torch/csrc/gru_sequence.cu",
    "gru_stack_sequence_q8_kernel": "src/repro_torch/csrc/gru_sequence_q8.cu",
    "gru_stack_decode_q8_kernel": "src/repro_torch/csrc/gru_sequence_q8.cu",
    "gru_sequence_q8_kernel": "src/repro_torch/csrc/gru_sequence_q8.cu",
    "gru_step_q8": "src/repro_torch/csrc/gru_cell_q8.cu",
    "slstm_stack_sequence_kernel": "src/repro_torch/csrc/slstm_cell.cu",
    "slstm_stack_decode_kernel": "src/repro_torch/csrc/slstm_cell.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attn.cu",
    "flash_decode": "src/repro_torch/csrc/decode_attn.cu",
    "gru_step_fused": "src/repro_torch/csrc/gru_cell.cu",
    "gru_step_blocked": "src/repro_torch/csrc/gru_cell.cu",
    "rowwise_matmul": "src/repro_torch/csrc/rowwise_matvec.cu",
    "cascade_matmul": "src/repro_torch/csrc/rowwise_matvec.cu",
}
REPLACES = {
    "gru_sequence_kernel": "src/repro/kernels/gru_sequence/kernel.py:125",
    "gru_stack_sequence_kernel": "src/repro/kernels/gru_sequence/kernel.py:211",
    "gru_stack_decode_kernel": "src/repro/kernels/gru_sequence/kernel.py:291",
    "gru_stack_sequence_q8_kernel":
        "src/repro/kernels/gru_sequence/kernel.py:505",
    "gru_stack_decode_q8_kernel":
        "src/repro/kernels/gru_sequence/kernel.py:575",
    "gru_sequence_q8_kernel": "src/repro/kernels/gru_sequence/kernel.py:420",
    "gru_step_q8": "src/repro/kernels/gru_cell/kernel.py:179",
    "slstm_stack_sequence_kernel":
        "src/repro/kernels/slstm_cell/kernel.py:130",
    "slstm_stack_decode_kernel": "src/repro/kernels/slstm_cell/kernel.py:215",
    "flash_attention": "src/repro/kernels/flash_attn/kernel.py:81",
    "flash_decode": "src/repro/kernels/decode_attn/kernel.py:59",
    "gru_step_fused": "src/repro/kernels/gru_cell/kernel.py:58",
    "gru_step_blocked": "src/repro/kernels/gru_cell/kernel.py:105",
    "rowwise_matmul": "src/repro/kernels/rowwise_matvec/kernel.py:37",
    "cascade_matmul": "src/repro/kernels/rowwise_matvec/kernel.py:74",
}
Q8 = ("gru_stack_sequence_q8_kernel", "gru_stack_decode_q8_kernel",
      "gru_sequence_q8_kernel", "gru_step_q8")
DECODE = ("gru_stack_decode_kernel", "gru_stack_decode_q8_kernel",
          "gru_step_q8", "slstm_stack_decode_kernel")
STEP_TOO = ("gru_sequence_kernel",)  # also at T=1 unmasked: chain decode
CHAIN_Q8 = ("gru_sequence_q8_kernel", "gru_step_q8")
SLSTM = ("slstm_stack_sequence_kernel", "slstm_stack_decode_kernel")
ATTN = ("flash_attention", "flash_decode")
ROWWISE = ("gru_step_fused", "gru_step_blocked", "rowwise_matmul",
           "cascade_matmul")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def device_info(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {kind} (count {count}); torch {torch.__version__} "
          f"cuda {torch.version.cuda}; tf32 off", flush=True)
    return kind, count, smi_line


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def build_kernels():
    from repro_torch.kernels import _build
    from repro_torch.kernels.gru_sequence import kernel as K
    t0 = time.monotonic()
    paths = _build.build()
    print(f"built {sorted(paths)} in {time.monotonic() - t0:.1f} s",
          flush=True)
    for name in paths:
        for line in _build.build_log(name).splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling",
                                       "smem")):
                print(f"  ptxas[{name}]: {line.strip()}")
    # all shared memory is dynamic, so ptxas does not report it
    from repro_torch.kernels.gru_cell import kernel as CK
    from repro_torch.kernels.slstm_cell import kernel as SK
    bt = K.DEFAULT_BATCH_BLOCK
    for cfg_name, L, H in (("gru-jet", 1, 20), ("gru-jet-deep", 3, 32)):
        print(f"  dynamic shared memory per block, {cfg_name} (L={L} H={H}, "
              f"{bt}-row tile): {K.smem_bytes(L, H, bt)} bytes fp32, "
              f"{K.smem_bytes_q8(L, H, bt)} bytes q8; one chain layer: "
              f"{K.smem_bytes(1, H, bt)} fp32, "
              f"{K.smem_bytes_seq_q8(H, bt)} q8 sequence, "
              f"{CK.smem_bytes_step_q8(H, bt)} q8 step "
              f"(limit {K.SMEM_LIMIT})")
    for cfg_name, L, H in (("slstm-jet", 1, 20), ("slstm L=3 H=32", 3, 32)):
        print(f"  dynamic shared memory per block, {cfg_name} ({bt}-row "
              f"tile): {SK.smem_bytes(L, H, bt)} bytes, both sLSTM kernels "
              f"(limit {K.SMEM_LIMIT})")
    import ctypes
    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.flash_attn import kernel as FK
    fa = _build.load("flash_attn").flash_attention_smem_bytes
    fd = _build.load("decode_attn").flash_decode_smem_bytes
    fa.argtypes, fd.argtypes = [ctypes.c_int], [ctypes.c_int, ctypes.c_int]
    for D in (16, 64, 128):
        check(fa(D) == FK.smem_bytes(D), f"flash_attention smem D={D}: "
              f"CUDA {fa(D)} != wrapper {FK.smem_bytes(D)}")
        for G in (1, 2, 16):
            check(fd(G, D) == DK.smem_bytes(G, D), f"flash_decode smem G={G} "
                  f"D={D}: CUDA {fd(G, D)} != wrapper {DK.smem_bytes(G, D)}")
    print(f"  dynamic shared memory per block, qwen3-0.6b heads (D=128, "
          f"G=2): flash_attention {FK.smem_bytes(128)} bytes (32 query rows,"
          f" 64 keys), flash_decode {DK.smem_bytes(2, 128)} bytes (64 slots)"
          f" (limit {K.SMEM_LIMIT}); CUDA sources agree")
    from repro_torch.kernels.rowwise_matvec import kernel as MK
    gs = _build.load("gru_cell").gru_cell_smem_bytes
    ms = _build.load("rowwise_matvec").rowwise_smem_bytes
    gs.argtypes, ms.argtypes = [ctypes.c_int] * 4, [ctypes.c_int] * 3
    gs.restype = ms.restype = ctypes.c_size_t
    for code, kind in enumerate(("v1", "v3", "blocked")):
        for H in (20, 32, 1000, 1024, 2048):
            for bt in (1, 2, 4, 8):
                for ct in (8, 16, 32):
                    want = CK.smem_bytes_step(kind, H, bt, ct)
                    check(gs(code, H, bt, ct) == want, f"gru_cell smem "
                          f"{kind} H={H} bt={bt} ct={ct}: CUDA "
                          f"{gs(code, H, bt, ct)} != wrapper {want}")
    for kc in (32, 1024, 2048):
        for bt in (1, 4, 8):
            for ct in (8, 16):
                check(ms(kc, bt, ct) == MK.smem_bytes(kc, bt, ct),
                      f"rowwise_matvec smem kc={kc} bt={bt} ct={ct}")
    print(f"  dynamic shared memory per block, gru_step_fused v1 H=32 8 rows:"
          f" {CK.smem_bytes_step('v1', 32, 8, 32)} bytes; "
          f"gru_step_blocked H=2048 8 rows: "
          f"{CK.smem_bytes_step('blocked', 2048, 8, 8)} bytes; "
          f"rowwise/cascade K=3072 4 rows bf16: "
          f"{MK.smem_bytes(2048, 4, 16)} bytes; CUDA sources agree")


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def make_inputs(torch, L, H, B, T, seed, dev):
    from repro_torch.core.params import quantize_gru_cells
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev)
    mask = torch.ones(T, B)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    for i in range(B):                      # left padding, as the engine
        mask[: T - int(lens[i]), i] = 0.0
    a = dict(
        h0=rand(L, B, H, scale=0.5), xp=rand(T, B, 3 * H),
        u=rand(L, H, 3 * H, scale=H ** -0.5),
        wd=(rand(L - 1, H, 3 * H, scale=H ** -0.5) if L > 1
            else torch.zeros(1, 1, 3 * H, device=dev)),
        b=rand(L, 3 * H, scale=0.3), mask=mask.to(dev))
    # the q8 kernels' int8 views of the same weights, quantized on the card
    st = quantize_gru_cells(
        [{"w": a["wd"][max(l - 1, 0)], "u": a["u"][l], "b": a["b"][l]}
         for l in range(L)]).stacked
    a["q8"] = tuple(st[k] for k in ("u_q", "u_eff", "wd_q", "wd_eff", "b"))
    return a


def make_slstm_inputs(torch, L, H, B, T, seed, dev):
    """The sLSTM kernels' operands: a mid-sequence state (n > 0) with row
    0 at the engine's initial state (c = n = h = 0, m = M_INIT), and a
    ragged left-padded (T,B) mask whose row 0 is fully masked when B > 1
    (an empty slot), so its leaves must come out bit for bit."""
    from repro_torch.core.slstm import M_INIT
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g)
    leaves = [rand(L, B, H, scale=0.5), rand(L, B, H).abs() + 0.5,
              rand(L, B, H), rand(L, B, H, scale=0.5)]
    for k, v in enumerate((0.0, 0.0, M_INIT, 0.0)):
        leaves[k][:, 0] = v
    mask = torch.ones(T, B)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    for i in range(B):
        mask[: T - int(lens[i]), i] = 0.0
    if B > 1:
        mask[:, 0] = 0.0
    leaves = [x.to(dev) for x in leaves]
    return dict(leaves=leaves, h0=leaves[3], xp=rand(T, B, 4 * H).to(dev),
                u=rand(L, H, 4 * H, scale=H ** -0.5).to(dev),
                wd=(rand(L - 1, H, 4 * H, scale=H ** -0.5) if L > 1
                    else torch.zeros(1, 1, 4 * H)).to(dev),
                b=rand(L, 4 * H, scale=0.3).to(dev), mask=mask.to(dev))


def run_slstm_kernel(name, a, masked, plain):
    from repro_torch.kernels.slstm_cell import kernel as SK
    from repro_torch.kernels.slstm_cell import ref as sref
    w = (a["u"], a["wd"], a["b"])
    if name == "slstm_stack_decode_kernel":
        args = (*a["leaves"], a["xp"][0], *w)
        if plain:
            return sref.slstm_stack_decode_ref(*args)
        return SK.slstm_stack_decode_kernel(*args)
    args = (*a["leaves"], a["xp"], *w, a["mask"] if masked else None)
    if plain:
        return sref.slstm_stack_sequence_ref(*args)
    return SK.slstm_stack_sequence_kernel(*args)


def run_kernel(K, ref, name, a, variant, masked, plain):
    from repro_torch.kernels.gru_cell import kernel as CK
    from repro_torch.kernels.gru_cell import ref as cref
    if name in SLSTM:
        return run_slstm_kernel(name, a, masked, plain)
    m = a["mask"] if masked else None
    if name in CHAIN_Q8:              # one layer's own int8 rows (L = 1)
        u_q, u_eff, _, _, b = (x[0] for x in a["q8"])
        if name == "gru_step_q8":
            args = (a["h0"][0], a["xp"][0], u_q, u_eff, b)
            if plain:
                return (cref.gru_step_q8_ref(*args, variant),)
            return (CK.gru_step_q8(*args, variant=variant),)
        args = (a["h0"][0], a["xp"], u_q, u_eff, b, m)
        if plain:
            return (ref.gru_sequence_q8_ref(*args, variant),)
        return (K.gru_sequence_q8_kernel(*args, variant=variant),)
    if name == "gru_sequence_kernel":
        args = (a["h0"][0], a["xp"], a["u"][0], a["b"][0], m)
        if plain:
            return (ref.gru_sequence_ref(*args, variant),)
        return (K.gru_sequence_kernel(*args, variant=variant),)
    if name == "gru_stack_sequence_kernel":
        args = (a["h0"], a["xp"], a["u"], a["wd"], a["b"], m)
        if plain:
            return ref.gru_stack_sequence_ref(*args, variant)
        return K.gru_stack_sequence_kernel(*args, variant=variant)
    if name == "gru_stack_sequence_q8_kernel":
        args = (a["h0"], a["xp"], *a["q8"], m)
        if plain:
            return ref.gru_stack_sequence_q8_ref(*args, variant)
        return K.gru_stack_sequence_q8_kernel(*args, variant=variant)
    if name == "gru_stack_decode_q8_kernel":
        args = (a["h0"], a["xp"][0], *a["q8"])
        if plain:
            return (ref.gru_stack_decode_q8_ref(*args, variant),)
        return (K.gru_stack_decode_q8_kernel(*args, variant=variant),)
    args = (a["h0"], a["xp"][0], a["u"], a["wd"], a["b"])
    if plain:
        return (ref.gru_stack_decode_ref(*args, variant),)
    return (K.gru_stack_decode_kernel(*args, variant=variant),)


BOTH = [(1, 20), (3, 32)]
MAIN_SHAPES = {                    # kernel -> (L, H) on the main path
    "gru_sequence_kernel": [(1, 20), (1, 32)],   # gru-jet; chain layers
    "gru_stack_sequence_kernel": [(3, 32)],      # gru-jet-deep prefill
    "gru_stack_decode_kernel": BOTH,             # both configs' decode
    "gru_stack_sequence_q8_kernel": BOTH,        # both configs' q8 prefill
    "gru_stack_decode_q8_kernel": BOTH,          # both configs' q8 decode
    "gru_sequence_q8_kernel": [(1, 20), (1, 32)],  # q8 chain prefill layers
    "gru_step_q8": [(1, 20), (1, 32)],             # q8 chain decode layers
    "slstm_stack_sequence_kernel": BOTH,         # slstm-jet; L=3 H=32
    "slstm_stack_decode_kernel": BOTH,
}


def inputs_for(torch, name, L, H, B, T, seed, dev):
    if name in SLSTM:
        return make_slstm_inputs(torch, L, H, B, T, seed, dev)
    return make_inputs(torch, L, H, B, T, seed, dev)


def check_kernels(torch, dev):
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.gru_sequence import ref
    err = {n: 0.0 for n in MAIN_SHAPES}
    checks = {n: 0 for n in MAIN_SHAPES}
    err_step = {n: 0.0 for n in STEP_TOO}    # the T=1 unmasked cases alone
    frozen_rows = {n: 0 for n in SLSTM}      # fully masked rows held bitwise
    for name, shapes in MAIN_SHAPES.items():
        Ts = ((1,) if name in DECODE else (8, 16, 32))
        if name in STEP_TOO:
            Ts = (1,) + Ts
        for (L, H) in shapes:
            for B in (1, 8, 64):
                for T in Ts:
                    a = inputs_for(torch, name, L, H, B, T, B * 100 + T,
                                   dev)
                    for variant in ((None,) if name in SLSTM
                                    else ("v1", "v3")):
                        for masked in ((False,) if T == 1 else (False, True)):
                            got = run_kernel(K, ref, name, a, variant,
                                             masked, plain=False)
                            want = run_kernel(K, ref, name, a, variant,
                                              masked, plain=True)
                            torch.cuda.synchronize()
                            for g_, w_ in zip(got, want):
                                check(bool(torch.isfinite(g_).all()),
                                      f"{name}: non-finite output")
                                e = (g_ - w_).abs().max().item()
                                err[name] = max(err[name], e)
                                if name in STEP_TOO and T == 1:
                                    err_step[name] = max(err_step[name], e)
                                check(e <= TOL, f"{name} L={L} H={H} B={B} "
                                      f"T={T} {variant} masked={masked}: "
                                      f"max |err| {e:.3g} > {TOL}")
                            if name in SLSTM and masked and B > 1:
                                frozen_rows[name] += 1
                                for k, leaf in enumerate(a["leaves"]):
                                    check(torch.equal(got[1 + k][:, 0],
                                                      leaf[:, 0]),
                                          f"{name} L={L} H={H} B={B} T={T}:"
                                          f" the fully masked row's leaf {k}"
                                          f" moved")
                            checks[name] += 1
    for n, e in err.items():
        print(f"  {n}: max |kernel - plain| = {e:.3g} (<= {TOL}) over "
              f"{checks[n]} comparisons")
    for n, e in err_step.items():
        print(f"  {n} at T=1 unmasked (the fp32 chain's decode layer): "
              f"max |kernel - plain| = {e:.3g} (<= {TOL})")
    print(f"  slstm_stack_sequence_kernel: the fully masked row (m = M_INIT)"
          f" kept all four leaves bit for bit in "
          f"{frozen_rows['slstm_stack_sequence_kernel']} masked comparisons")
    print(f"  {sum(checks.values())} kernel/plain comparisons passed",
          flush=True)
    return err


# ---------------------------------------------------------------------------
# 4. the main path: serve both configs through the kernels
# ---------------------------------------------------------------------------

ARCHS = ("gru-jet", "gru-jet-deep")
HETERO = "gru-jet-deep (32, 32, 20)"     # heterogeneous stack of phases 6-7
PLAIN = {                  # module of plain versions -> names the wrappers call
    "repro_torch.kernels.gru_sequence.ref": (
        "gru_sequence_ref", "gru_stack_sequence_ref", "gru_stack_decode_ref",
        "gru_stack_sequence_q8_ref", "gru_stack_decode_q8_ref",
        "gru_sequence_q8_ref"),
    "repro_torch.kernels.gru_cell.ref": ("gru_step_q8_ref", "gru_step_ref"),
    "repro_torch.kernels.rowwise_matvec.ref": ("rowwise_matmul_ref",
                                               "cascade_matmul_ref"),
    "repro_torch.kernels.slstm_cell.ref": ("slstm_stack_sequence_ref",
                                           "slstm_stack_decode_ref"),
    "repro_torch.kernels.flash_attn.ref": ("flash_attention_plain",),
    "repro_torch.kernels.decode_attn.ref": ("flash_decode_plain",),
}


@contextlib.contextmanager
def plain_calls():
    """Count calls of the kernels' plain versions while the block runs (the
    wrappers reach them through their ``ref`` modules), so a run can show
    that none replaced a kernel."""
    import importlib
    counts, saved = {}, []
    for mod_name, names in PLAIN.items():
        mod = importlib.import_module(mod_name)
        for n in names:
            counts[n] = 0
            saved.append((mod, n, getattr(mod, n)))

    def counting(n, fn):
        def wrapped(*args, **kw):
            counts[n] += 1
            return fn(*args, **kw)
        return wrapped
    for mod, n, fn in saved:
        setattr(mod, n, counting(n, fn))
    try:
        yield counts
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def serve(cfg, params, backend, dev):
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru, backend=backend))
    eng = ServeEngine(cfg, params, max_batch=SLOTS, device=dev)
    reqs = make_requests(cfg, REQUESTS, MAX_PROMPT, True, MAX_NEW, seed=3)
    done = eng.generate(reqs)
    return eng, [r.out for r in done]


def serve_all(K, cfgs, params, backend, dev, kernels, backends=None):
    """Serve every config of ``cfgs`` through ``backend`` (or
    ``backends[name]``) with all launch counters set to 0 just before;
    returns engines, streams, the launches of ``kernels`` per config and in
    all, every other kernel's launches, and the plain versions' calls."""
    K.reset_launch_counts()
    engines, streams, per_arch = {}, {}, {}
    before = [0] * len(kernels)
    with plain_calls() as plain:
        for a in cfgs:
            b = (backends or {}).get(a, backend)
            engines[a], streams[a] = serve(cfgs[a], params[a], b, dev)
            after = [k.launches for k in kernels]
            per_arch[a] = [x - y for x, y in zip(after, before)]
            before = after
    from repro_torch.kernels.slstm_cell import kernel as SK
    launches = dict(zip((k.__name__ for k in kernels), before))
    others = {k.__name__: k.launches
              for k in (K.KERNELS + K.Q8_KERNELS + K.CHAIN_Q8_KERNELS
                        + SK.SLSTM_KERNELS + K.ATTN_KERNELS
                        + K.ROWWISE_KERNELS)
              if k not in kernels}
    print(f"  launches: {launches}; other kernels {others}; "
          f"plain versions {plain}", flush=True)
    check(not any(others.values()), f"{backend}: other kernels ran {others}")
    check(not any(plain.values()), f"{backend}: plain versions ran {plain}")
    return engines, streams, per_arch, launches


def check_served(a, eng, backend, per_arch, want):
    """Every prefill and recorded step on ``backend``; the launches equal
    ``want(prefills, steps run)``."""
    st = eng.latency_stats()
    prefills = len(eng.prefill_backends)
    steps_run = st["steps"] + 1     # the wave's one decode key: its
                                    # first step is not recorded
    check(set(eng.prefill_backends) == {backend},
          f"{a}: prefill backends {set(eng.prefill_backends)}")
    check(st["decode_backend_steps"] == {backend: st["steps"]},
          f"{a}: decode steps {st['decode_backend_steps']}")
    w = want(prefills, steps_run)
    check(per_arch == w, f"{a}: launches {per_arch} != {w} "
          f"({prefills} prefills, {steps_run} steps)")
    return st, prefills, steps_run


def run_main_path(torch, dev):
    from repro_torch.configs.base import get_config
    from repro_torch.core import gru as gru_core
    from repro_torch.core.params import init_params
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.models import gru_lm

    cfgs = {a: get_config(a) for a in ARCHS}
    params = {a: init_params(gru_lm.lm_specs(cfgs[a]), seed=0, device=dev)
              for a in ARCHS}
    engines, streams, per_arch, launches = serve_all(        # the main path
        K, cfgs, params, "cuda", dev, K.KERNELS)

    report = {}
    for a in ARCHS:
        eng = engines[a]
        seq_i = 0 if cfgs[a].gru.resolved_num_layers == 1 else 1

        def want(prefills, steps):
            w = [0, 0, steps]
            w[seq_i] = prefills
            return w
        st, prefills, steps_run = check_served(a, eng, "cuda_fused",
                                               per_arch[a], want)
        _, eager_streams = serve(cfgs[a], params[a], "eager", dev)
        check(streams[a] == eager_streams,
              f"{a}: class streams differ from the eager engine")
        check(all(len(s) == MAX_NEW for s in streams[a]),
              f"{a}: stream lengths {[len(s) for s in streams[a]]}")
        # repo's own means: finite logits of the right shape that agree
        # with the dense reference on a small batch
        g = torch.Generator().manual_seed(5)
        xs = torch.randn(3, 7, cfgs[a].gru.input_dim, generator=g).to(dev)
        cfg_c = cfgs[a].replace(gru=dataclasses.replace(cfgs[a].gru,
                                                        backend="cuda"))
        logits, _ = gru_lm.prefill(eng.params, cfg_c, {"features": xs})
        h0s = gru_core.stack_h0(cfgs[a].gru, 3, device=dev)
        finals, _ = gru_core.gru_stack_reference(
            gru_core.stack_cell_params(params[a]), h0s, xs)
        want_logits = (finals[-1] @ params[a]["head"]["w"]
                       + params[a]["head"]["b"])
        check(tuple(logits.shape) == (3, cfgs[a].gru.num_classes)
              and bool(torch.isfinite(logits).all()), f"{a}: bad logits")
        e = (logits - want_logits).abs().max().item()
        check(e <= TOL, f"{a}: prefill logits vs reference {e:.3g}")
        report[a] = {"prefills": prefills, "decode_steps": steps_run,
                     "decode_p50_ms": st["p50_s"] * 1e3,
                     "decode_p99_ms": st["p99_s"] * 1e3,
                     "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
                     "logits_err_vs_reference": e,
                     "streams_equal_eager": True}
        print(f"  {a}: {prefills} prefills, {steps_run} decode steps, all "
              f"cuda_fused; decode p50 {st['p50_s'] * 1e3:.4f} ms p99 "
              f"{st['p99_s'] * 1e3:.4f} ms (host clock, synchronized); "
              f"streams == eager; logits vs reference {e:.3g}", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    return launches, report, cfgs, params, streams


# ---------------------------------------------------------------------------
# 5. the int8 path: serve both configs through cuda_fused_q8
# ---------------------------------------------------------------------------

def to_device(tree, dev):
    """A copy of a nested dict/tuple of tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, dev) for v in tree)
    return tree.to(dev)


def run_q8_path(torch, dev, cfgs, params, fp32_streams):
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.models import gru_lm

    engines, streams, per_arch, launches = serve_all(        # the q8 path
        K, cfgs, params, "cuda_fused_q8", dev, K.Q8_KERNELS)
    cpu = torch.device("cpu")
    report = {}
    for a in ARCHS:
        eng = engines[a]
        st, prefills, steps_run = check_served(
            a, eng, "cuda_fused_q8", per_arch[a], lambda p, s: [p, s])
        check(st["served_dtype"] == "int8", f"{a}: {st['served_dtype']}")
        cpu_eng, cpu_streams = serve(cfgs[a], to_device(params[a], cpu),
                                     "cuda_fused_q8", cpu)
        check(streams[a] == cpu_streams,
              f"{a}: q8 class streams on the card differ from the CPU run")
        # finite logits of the right shape, equal to the plain versions'
        # on the CPU for the same prepared weights
        g = torch.Generator().manual_seed(5)
        xs = torch.randn(3, 7, cfgs[a].gru.input_dim, generator=g)
        cfg_q = cfgs[a].replace(gru=dataclasses.replace(
            cfgs[a].gru, backend="cuda_fused_q8"))
        logits, _ = gru_lm.prefill(eng.params, cfg_q, {"features": xs.to(dev)})
        want, _ = gru_lm.prefill(cpu_eng.params, cfg_q, {"features": xs})
        check(tuple(logits.shape) == (3, cfgs[a].gru.num_classes)
              and bool(torch.isfinite(logits).all()), f"{a}: bad q8 logits")
        e = (logits.cpu() - want).abs().max().item()
        check(e <= TOL, f"{a}: q8 prefill logits vs the CPU run {e:.3g}")
        tokens = [(x, y) for s, f in zip(streams[a], fp32_streams[a])
                  for x, y in zip(s, f)]
        agree = sum(x == y for x, y in tokens) / len(tokens)
        report[a] = {"prefills": prefills, "decode_steps": steps_run,
                     "decode_p50_ms": st["p50_s"] * 1e3,
                     "decode_p99_ms": st["p99_s"] * 1e3,
                     "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
                     "logits_err_vs_cpu": e, "streams_equal_cpu": True,
                     "token_agreement_with_fp32": agree}
        print(f"  {a}: {prefills} prefills, {steps_run} decode steps, all "
              f"cuda_fused_q8 (int8); decode p50 {st['p50_s'] * 1e3:.4f} ms "
              f"p99 {st['p99_s'] * 1e3:.4f} ms (host clock, synchronized); "
              f"streams == CPU run; logits vs CPU run {e:.3g}; tokens equal "
              f"to fp32 cuda_fused: {agree:.4f} (report only)", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the q8 path never launched: {launches}")
    return launches, report


# ---------------------------------------------------------------------------
# 6-7. the per-layer chains: cuda_chain and cuda_chain_q8
# ---------------------------------------------------------------------------

def chain_configs(torch, dev, cfgs, params):
    """Both configs plus gru-jet-deep with heterogeneous ``layer_dims``
    (three layers keep its three ``layer_matvec_modes`` valid), random
    weights from seed 0."""
    from repro_torch.core.params import init_params
    from repro_torch.models import gru_lm
    deep = cfgs["gru-jet-deep"]
    het = deep.replace(gru=dataclasses.replace(deep.gru,
                                               layer_dims=(32, 32, 20)))
    ccfgs = dict(cfgs, **{HETERO: het})
    cparams = dict(params, **{HETERO: init_params(gru_lm.lm_specs(het),
                                                  seed=0, device=dev)})
    return ccfgs, cparams


def run_chain_path(torch, dev, cfgs, params):
    """The fp32 chain: the two configs pinned to ``cuda_chain``, the
    heterogeneous stack under the ``cuda`` preference (which must resolve
    to the chain)."""
    from repro_torch.kernels.gru_sequence import kernel as K
    backends = {HETERO: "cuda"}
    engines, streams, per_arch, launches = serve_all(
        K, cfgs, params, "cuda_chain", dev, (K.gru_sequence_kernel,),
        backends)
    report = {}
    for a in cfgs:
        L = cfgs[a].gru.resolved_num_layers
        st, prefills, steps_run = check_served(
            a, engines[a], "cuda_chain", per_arch[a],
            lambda p, s: [L * (p + s)])
        _, eager_streams = serve(cfgs[a], params[a], "eager", dev)
        check(streams[a] == eager_streams,
              f"{a}: cuda_chain class streams differ from the eager engine")
        report[a] = {"backend_asked": backends.get(a, "cuda_chain"),
                     "prefills": prefills, "decode_steps": steps_run,
                     "launches": per_arch[a][0],
                     "decode_p50_ms": st["p50_s"] * 1e3,
                     "decode_p99_ms": st["p99_s"] * 1e3,
                     "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
                     "streams_equal_eager": True}
        print(f"  {a}: {prefills} prefills, {steps_run} decode steps, all "
              f"cuda_chain; gru_sequence_kernel launches {per_arch[a][0]} "
              f"= {L} x ({prefills} + {steps_run}); decode p50 "
              f"{st['p50_s'] * 1e3:.4f} ms p99 {st['p99_s'] * 1e3:.4f} ms "
              f"(host clock, synchronized); streams == eager", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the chain never launched: {launches}")
    return launches, report


def run_chain_q8_path(torch, dev, cfgs, params):
    """The q8 chain: all three configs pinned to ``cuda_chain_q8``; class
    streams and prefill logits held against the CPU run of the same pin."""
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.models import gru_lm
    engines, streams, per_arch, launches = serve_all(
        K, cfgs, params, "cuda_chain_q8", dev, K.CHAIN_Q8_KERNELS)
    cpu = torch.device("cpu")
    report = {}
    for a in cfgs:
        L = cfgs[a].gru.resolved_num_layers
        eng = engines[a]
        st, prefills, steps_run = check_served(
            a, eng, "cuda_chain_q8", per_arch[a],
            lambda p, s: [L * p, L * s])
        check(st["served_dtype"] == "int8", f"{a}: {st['served_dtype']}")
        cpu_eng, cpu_streams = serve(cfgs[a], to_device(params[a], cpu),
                                     "cuda_chain_q8", cpu)
        same = [x == y for x, y in zip(streams[a], cpu_streams)]
        check(all(same), f"{a}: cuda_chain_q8 class streams on the card "
              f"differ from the CPU run in requests "
              f"{[i for i, ok in enumerate(same) if not ok]}")
        g = torch.Generator().manual_seed(5)
        xs = torch.randn(3, 7, cfgs[a].gru.input_dim, generator=g)
        cfg_q = cfgs[a].replace(gru=dataclasses.replace(
            cfgs[a].gru, backend="cuda_chain_q8"))
        logits, _ = gru_lm.prefill(eng.params, cfg_q, {"features": xs.to(dev)})
        want, _ = gru_lm.prefill(cpu_eng.params, cfg_q, {"features": xs})
        check(tuple(logits.shape) == (3, cfgs[a].gru.num_classes)
              and bool(torch.isfinite(logits).all()), f"{a}: bad q8 logits")
        e = (logits.cpu() - want).abs().max().item()
        check(e <= TOL, f"{a}: q8 chain prefill logits vs the CPU run {e:.3g}")
        report[a] = {"prefills": prefills, "decode_steps": steps_run,
                     "launches": per_arch[a],
                     "decode_p50_ms": st["p50_s"] * 1e3,
                     "decode_p99_ms": st["p99_s"] * 1e3,
                     "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
                     "logits_err_vs_cpu": e, "streams_equal_cpu": True}
        print(f"  {a}: {prefills} prefills, {steps_run} decode steps, all "
              f"cuda_chain_q8 (int8); launches {per_arch[a]} = {L} x "
              f"({prefills}, {steps_run}); decode p50 "
              f"{st['p50_s'] * 1e3:.4f} ms p99 {st['p99_s'] * 1e3:.4f} ms "
              f"(host clock, synchronized); streams == CPU run; logits vs "
              f"CPU run {e:.3g}", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the q8 chain never launched: {launches}")
    return launches, report


# ---------------------------------------------------------------------------
# 8. the sLSTM family: serve slstm-jet and a deep stack through cuda_fused
# ---------------------------------------------------------------------------

SLSTM_ARCHS = ("slstm-jet", "slstm-jet L=3 H=32")


def run_slstm_path(torch, dev):
    """slstm-jet and its uniform deep stack (``num_layers=3,
    hidden_dim=32``) under ``backend="cuda"``: one sequence launch per
    prefill, one decode launch per step, class streams equal to the eager
    engine's, prefill logits against the dense reference."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import slstm as slstm_core
    from repro_torch.core.params import init_params
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.slstm_cell import kernel as SK
    from repro_torch.models import slstm_lm
    base = get_config("slstm-jet")
    cfgs = {SLSTM_ARCHS[0]: base,
            SLSTM_ARCHS[1]: base.replace(gru=dataclasses.replace(
                base.gru, num_layers=3, hidden_dim=32))}
    params = {a: init_params(slstm_lm.lm_specs(c), seed=0, device=dev)
              for a, c in cfgs.items()}
    engines, streams, per_arch, launches = serve_all(
        K, cfgs, params, "cuda", dev, SK.SLSTM_KERNELS)
    report = {}
    for a, cfg in cfgs.items():
        st, prefills, steps_run = check_served(
            a, engines[a], "cuda_fused", per_arch[a], lambda p, s: [p, s])
        _, eager_streams = serve(cfg, params[a], "eager", dev)
        check(streams[a] == eager_streams,
              f"{a}: class streams differ from the eager engine")
        check(all(len(x) == MAX_NEW for x in streams[a]),
              f"{a}: stream lengths {[len(x) for x in streams[a]]}")
        g = torch.Generator().manual_seed(5)
        xs = torch.randn(3, 7, cfg.gru.input_dim, generator=g).to(dev)
        cfg_c = cfg.replace(gru=dataclasses.replace(cfg.gru, backend="cuda"))
        logits, _ = slstm_lm.prefill(engines[a].params, cfg_c,
                                     {"features": xs})
        finals, _ = slstm_core.slstm_stack_reference(
            params[a]["cells"],
            slstm_core.stack_state0(cfg.gru, 3, device=dev), xs)
        want_logits = (finals[-1] @ params[a]["head"]["w"]
                       + params[a]["head"]["b"])
        check(tuple(logits.shape) == (3, cfg.gru.num_classes)
              and bool(torch.isfinite(logits).all()), f"{a}: bad logits")
        e = (logits - want_logits).abs().max().item()
        check(e <= TOL, f"{a}: prefill logits vs reference {e:.3g}")
        report[a] = {"prefills": prefills, "decode_steps": steps_run,
                     "launches": per_arch[a],
                     "decode_p50_ms": st["p50_s"] * 1e3,
                     "decode_p99_ms": st["p99_s"] * 1e3,
                     "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
                     "logits_err_vs_reference": e,
                     "streams_equal_eager": True}
        print(f"  {a}: {prefills} prefills, {steps_run} decode steps, all "
              f"cuda_fused; launches {per_arch[a]} = ({prefills}, "
              f"{steps_run}); decode p50 {st['p50_s'] * 1e3:.4f} ms p99 "
              f"{st['p99_s'] * 1e3:.4f} ms (host clock, synchronized); "
              f"streams == eager; logits vs reference {e:.3g}", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the sLSTM path never launched: {launches}")
    return launches, report


# ---------------------------------------------------------------------------
# 9. the dense LM's attention kernels against their plain versions
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-0.6b"
LM_SLOTS, LM_NEW = 4, 16
LM_WAVES = ((12, 12, 12, 12), (128, 12, 128, 12))   # prompt lengths
LM_LOGIT_TOL = 0.25       # |bf16 cuda - fp32 chunked| logits, 28 layers
HQ, HKV, HD = 16, 8, 128                            # qwen3-0.6b's heads
# (B, Sq, Sk, causal, window): the served prefills (S = 12, 128), S = 2048,
# a window, Sq and Sk off the 32-row / 64-key tiles, Sq > Sk under a
# window (rows with no valid key)
FLASH_CHECKS = ((4, 12, 12, True, 0), (4, 128, 128, True, 0),
                (1, 2048, 2048, True, 0), (2, 200, 200, True, 64),
                (2, 77, 45, False, 0), (1, 300, 40, True, 16))
# (B, C, written positions (first, last) or None, pos, window): the
# served caches (C = S + 64 after prefill and the first decode write), S =
# 2048, a wrapped ring, a window over it, empty slots, a fully masked
# cache
DECODE_CHECKS = ((4, 76, (0, 12), 12, 0), (4, 192, (0, 128), 128, 0),
                 (1, 2112, (0, 2048), 2048, 0), (4, 192, (100, 400), 400, 0),
                 (4, 192, (100, 400), 400, 100), (4, 192, (0, 50), 50, 0),
                 (2, 76, None, 0, 0))


def attn_inputs(torch, B, Sq, Sk, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(*shape, generator=g).to(dev).to(dtype)
                 for shape in ((B, HQ, Sq, HD), (B, HKV, Sk, HD),
                               (B, HKV, Sk, HD)))


def decode_inputs(torch, B, C, written, pos, window, dtype, seed, dev):
    from repro_torch.kernels.decode_attn.ops import valid_slots
    g = torch.Generator().manual_seed(seed)
    q, kc, vc = (torch.randn(*shape, generator=g).to(dev).to(dtype)
                 for shape in ((B, HKV, HQ // HKV, HD), (B, HKV, C, HD),
                               (B, HKV, C, HD)))
    slot_pos = torch.full((C,), -1, dtype=torch.int32)
    if written is not None:
        for p in range(written[0], written[1] + 1):
            slot_pos[p % C] = p
    return q, kc, vc, valid_slots(slot_pos.to(dev), pos, window)


def check_attention_kernels(torch, dev):
    """Both attention kernels against their plain versions on the card, in
    fp32 and bf16; returns {kernel: {dtype name: max |err|}}."""
    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.decode_attn import ref as dref
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import ref as fref
    err = {n: {"float32": 0.0, "bfloat16": 0.0} for n in ATTN}
    n_checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        tol = TOL if dtype == torch.float32 else BF16_TOL
        for (B, Sq, Sk, causal, window) in FLASH_CHECKS:
            q, k, v = attn_inputs(torch, B, Sq, Sk, dtype, Sq + Sk, dev)
            got = FK.flash_attention(q, k, v, causal=causal, window=window)
            want = fref.flash_attention_plain(q, k, v, causal, window)
            torch.cuda.synchronize()
            check(got.dtype == dtype and bool(torch.isfinite(got).all()),
                  f"flash_attention {dn} S={Sq}/{Sk}: bad output")
            e = (got.float() - want.float()).abs().max().item()
            err["flash_attention"][dn] = max(err["flash_attention"][dn], e)
            check(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol),
                  f"flash_attention {dn} B={B} Sq={Sq} Sk={Sk} causal="
                  f"{causal} window={window}: max |err| {e:.3g} (tol {tol})")
            no_key = ~fref._mask(Sq, 0, Sk, causal, window, dev).any(-1)
            check(int(torch.count_nonzero(got[:, :, no_key])) == 0,
                  f"flash_attention S={Sq}/{Sk}: a row with no valid key "
                  f"is not 0")
            print(f"  flash_attention {dn:8s} B={B} Hq={HQ} Hkv={HKV} D={HD}"
                  f" Sq={Sq:4d} Sk={Sk:4d} causal={causal!s:5} window="
                  f"{window:3d}: max |kernel - plain| {e:.3g} (rows without "
                  f"a key: {int(no_key.sum())}, exactly 0)", flush=True)
            n_checks += 1
        for (B, C, written, pos, window) in DECODE_CHECKS:
            q, kc, vc, mask = decode_inputs(torch, B, C, written, pos, window,
                                            dtype, C + pos, dev)
            got = DK.flash_decode(q, kc, vc, mask)
            want = dref.flash_decode_plain(q, kc, vc, mask)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            err["flash_decode"][dn] = max(err["flash_decode"][dn], e)
            check(got.dtype == torch.float32 and e <= TOL,
                  f"flash_decode {dn} B={B} C={C} written={written} pos="
                  f"{pos} window={window}: max |err| {e:.3g} (tol {TOL})")
            if written is None:
                check(int(torch.count_nonzero(got)) == 0,
                      "flash_decode: a fully masked cache is not 0")
            print(f"  flash_decode    {dn:8s} B={B} Hkv={HKV} G={HQ // HKV} "
                  f"D={HD} C={C:4d} valid={int(mask.sum()):4d} window="
                  f"{window:3d}: max |kernel - plain| {e:.3g}", flush=True)
            n_checks += 1
    print(f"  {n_checks} attention kernel/plain comparisons passed; fp32 "
          f"tol {TOL}, bf16 tol {BF16_TOL:.4g} (flash_attention, bf16 "
          f"output) and {TOL} (flash_decode, fp32 output)", flush=True)
    return err


# ---------------------------------------------------------------------------
# 10. the dense LM: serve qwen3-0.6b at full width
# ---------------------------------------------------------------------------

def lm_requests(cfg, wave: int):
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(100 + wave)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=LM_NEW)
            for n in LM_WAVES[wave]]


def record_logits(eng):
    """Route ``eng``'s model calls through recorders: returns the list that
    collects each prefill's and decode step's fp32 logits, in call order."""
    from types import SimpleNamespace
    log = []
    api = eng.api

    def prefill(p, cfg, batch):
        out = api.prefill(p, cfg, batch)
        log.append(out[0].float().clone())
        return out

    def decode_step(p, cfg, cache, tok):
        out = api.decode_step(p, cfg, cache, tok)
        log.append(out[0].float().clone())
        return out
    eng.api = SimpleNamespace(**dict(vars(api), prefill=prefill,
                                     decode_step=decode_step))
    return log


def serve_lm(eng, cfg):
    """Both waves through one engine; returns streams per wave."""
    return [[r.out for r in eng.generate(lm_requests(cfg, w))]
            for w in range(len(LM_WAVES))]


def compare_lm_runs(streams_a, logs_a, streams_b, logs_b):
    """Hold run a (bf16, cuda) against run b (fp32, chunked) per request:
    the logits that chose each token while both streams agree (index t of
    a wave's log chose token t), and at the first token where they part,
    run b's top-2 gap. Returns (max |logit diff|, parted list)."""
    worst, parted = 0.0, []
    for w in range(len(LM_WAVES)):
        wave_logs_a = logs_a[w * (LM_NEW + 1):(w + 1) * (LM_NEW + 1)]
        wave_logs_b = logs_b[w * (LM_NEW + 1):(w + 1) * (LM_NEW + 1)]
        for i, (sa, sb) in enumerate(zip(streams_a[w], streams_b[w])):
            d = next((t for t, (x, y) in enumerate(zip(sa, sb)) if x != y),
                     None)
            last = len(sa) - 1 if d is None else d
            for t in range(last + 1):
                e = (wave_logs_a[t][i] - wave_logs_b[t][i]).abs().max().item()
                worst = max(worst, e)
            if d is not None:
                top2 = wave_logs_b[d][i].topk(2).values
                gap = (top2[0] - top2[1]).item()
                parted.append({"wave": w, "request": i, "token": d,
                               "fp32_top2_gap": gap})
    return worst, parted


def run_lm_path(torch, dev, cfg=None):
    """qwen3-0.6b at full width through ``ServeEngine.generate`` (``cfg``:
    a smaller same-family config for a CPU rehearsal)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.params import init_params
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg or get_config(LM_ARCH)
    check(cfg.attn_impl == "cuda" and cfg.dtype == "bfloat16"
          and cfg.param_dtype == "float32", f"{LM_ARCH}: config {cfg}")
    L = cfg.num_layers
    t0 = time.monotonic()
    params = init_params(transformer.lm_specs(cfg), seed=0, device=dev)
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"  {cfg.name}: {L} layers, d_model {cfg.d_model}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads}x{cfg.resolved_head_dim}, "
          f"vocab {cfg.vocab_size}: {n_params} parameters (fp32) made from "
          f"seed 0 in {time.monotonic() - t0:.1f} s", flush=True)
    eng = ServeEngine(cfg, params, max_batch=LM_SLOTS, device=dev)
    K.reset_launch_counts()                                  # the LM path
    with plain_calls() as plain:
        streams = serve_lm(eng, cfg)
    launches = {k.__name__: k.launches for k in K.ATTN_KERNELS}
    from repro_torch.kernels.slstm_cell import kernel as SK
    others = {k.__name__: k.launches for k in
              K.KERNELS + K.Q8_KERNELS + K.CHAIN_Q8_KERNELS
              + SK.SLSTM_KERNELS + K.ROWWISE_KERNELS}
    st = eng.latency_stats()
    prefills, steps_run = st["prefills"], st["steps"] + 1   # one decode key
    print(f"  launches: {launches}; other kernels {others}; plain versions "
          f"{plain}", flush=True)
    check(not any(plain.values()), f"{LM_ARCH}: plain versions ran {plain}")
    check(not any(others.values()), f"{LM_ARCH}: other kernels ran {others}")
    check(launches == {"flash_attention": L * prefills,
                       "flash_decode": L * steps_run},
          f"{LM_ARCH}: launches {launches} != {L} x ({prefills} prefills, "
          f"{steps_run} steps)")
    check(all(len(s) == LM_NEW for w in streams for s in w),
          f"{LM_ARCH}: stream lengths {[[len(s) for s in w] for w in streams]}")
    check(st["served_dtype"] == "bfloat16", f"served {st['served_dtype']}")
    print(f"  {LM_ARCH}: {prefills} prefills (S = "
          f"{[max(w) for w in LM_WAVES]}, {LM_SLOTS} requests each), "
          f"{steps_run} decode steps; flash_attention {L} per prefill, "
          f"flash_decode {L} per step; prefill mean "
          f"{st['prefill_mean_s'] * 1e3:.4f} ms, decode p50 "
          f"{st['p50_s'] * 1e3:.4f} ms p99 {st['p99_s'] * 1e3:.4f} ms "
          f"(host clock, synchronized)", flush=True)
    # the same waves, recorded, in bf16 through the kernels and in fp32
    # through the plain chunked attention
    log_a = record_logits(eng)
    again = serve_lm(eng, cfg)
    check(again == streams, f"{LM_ARCH}: a second bf16 run gave other "
          f"streams")
    cfg32 = cfg.replace(dtype="float32", attn_impl="chunked")
    eng32 = ServeEngine(cfg32, params, max_batch=LM_SLOTS, device=dev)
    log_b = record_logits(eng32)
    streams32 = serve_lm(eng32, cfg32)
    for log in (log_a, log_b):
        check(all(bool(torch.isfinite(x).all()) and
                  tuple(x.shape) == (LM_SLOTS, cfg.vocab_size) for x in log),
              f"{LM_ARCH}: non-finite or misshapen logits")
    worst, parted = compare_lm_runs(streams, log_a, streams32, log_b)
    check(worst <= LM_LOGIT_TOL, f"{LM_ARCH}: bf16 cuda logits differ from "
          f"fp32 chunked by {worst:.4g} > {LM_LOGIT_TOL}")
    check(all(p["fp32_top2_gap"] <= LM_LOGIT_TOL for p in parted),
          f"{LM_ARCH}: streams part where fp32's top two logits are more "
          f"than {LM_LOGIT_TOL} apart: {parted}")
    equal = not parted
    print(f"  bf16 cuda vs fp32 chunked: logits along the served tokens "
          f"within {worst:.4g} (tol {LM_LOGIT_TOL}); token streams "
          + ("equal" if equal else
             f"part in {len(parted)} of {LM_SLOTS * len(LM_WAVES)} requests,"
             f" each where fp32's top two logits are within "
             f"{max(p['fp32_top2_gap'] for p in parted):.4g}: {parted}"),
          flush=True)
    report = {"arch": LM_ARCH, "layers": L, "d_model": cfg.d_model,
              "vocab": cfg.vocab_size, "params": n_params,
              "prefills": prefills, "decode_steps": steps_run,
              "launches": launches,
              "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
              "decode_p50_ms": st["p50_s"] * 1e3,
              "decode_p99_ms": st["p99_s"] * 1e3,
              "logits_vs_fp32_chunked": worst, "streams_equal": equal,
              "parted": parted}
    return launches, report, params


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# 11. the paper's row-wise primitives through their entry points
# ---------------------------------------------------------------------------

STEP_BF16_TOL = 1e-2    # bf16 u: r*h may round to the other bf16 neighbour
MM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# (B, H, variant, u dtype, the kernel JAX's dispatch rule names): the
# paper's configs (gru-jet H=20, gru-jet-deep H=32), the widths JAX's
# 12 MiB rule sends to the blocked kernel, v3 and an H that block_n = 256
# does not divide (fused at any width)
STEP_SHAPES = (
    [(B, H, v, dt, "gru_step_fused") for B in (1, 8) for H in (20, 32)
     for v in ("v1", "v3") for dt in ("float32", "bfloat16")]
    + [(B, H, "v1", "float32", "gru_step_blocked") for B in (1, 8)
       for H in (1024, 2048)]
    + [(B, 2048, "v1", "bfloat16", "gru_step_blocked") for B in (1, 8)]
    + [(B, 1024, "v3", "float32", "gru_step_fused") for B in (1, 8)]
    + [(B, 1000, "v1", "float32", "gru_step_fused") for B in (1, 8)])
# (B, K, N, dtype, 1-D x): JAX's test shapes, the paper's matvec (also as
# a 1-D x), qwen3-0.6b's MLP up and down matvecs at 4 requests
MATMUL_SHAPES = (
    [(B, K_, N, dt, False) for (B, K_, N) in ((1, 16, 32), (4, 96, 256),
                                              (8, 128, 128), (2, 64, 512))
     for dt in ("float32", "bfloat16")]
    + [(8, 32, 96, "float32", False), (1, 32, 96, "float32", True)]
    + [(4, K_, N, dt, False) for (K_, N) in ((1024, 3072), (3072, 1024))
       for dt in ("bfloat16", "float32")])


def step_inputs(torch, B, H, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, H, generator=g).to(dev),
            torch.randn(B, 3 * H, generator=g).to(dev),
            (torch.randn(H, 3 * H, generator=g) * H ** -0.5).to(dev)
            .to(getattr(torch, dtype)),
            (0.1 * torch.randn(3 * H, generator=g)).to(dev))


def mm_inputs(torch, B, K_, N, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    return (torch.randn(B, K_, generator=g).to(dev).to(dt),
            (torch.randn(K_, N, generator=g) * K_ ** -0.5).to(dev).to(dt))


def run_rowwise_path(torch, dev):
    """Every shape through ``gru_step_cuda``, ``rowwise`` and ``cascade``
    with the counters zeroed just before: each call must raise exactly its
    kernel's counter by one (the kernel JAX's rule names), no plain version
    and no other kernel may run; then every output is held against its
    plain version on the card. Returns the launches and {kernel: {dtype:
    max |err|}}."""
    from repro_torch.kernels.gru_cell import ops as cops
    from repro_torch.kernels.gru_cell import ref as cref
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.rowwise_matvec import ops as mops
    from repro_torch.kernels.rowwise_matvec import ref as mref
    from repro_torch.kernels.slstm_cell import kernel as SK
    steps = [(c, step_inputs(torch, c[0], c[1], c[3], i, dev))
             for i, c in enumerate(STEP_SHAPES)]
    mms = []
    for i, c in enumerate(MATMUL_SHAPES):
        x, w = mm_inputs(torch, c[0], c[1], c[2], c[3], 100 + i, dev)
        mms.append((c, (x[0] if c[4] else x, w)))
    counters = {k.__name__: k for k in K.ROWWISE_KERNELS}

    def call(fn, want):
        before = {n: k.launches for n, k in counters.items()}
        out = fn()
        delta = {n: k.launches - before[n] for n, k in counters.items()}
        check(delta == {n: int(n == want) for n in counters},
              f"{want}: launches {delta}")
        return out
    K.reset_launch_counts()                          # the row-wise path
    got = []
    with plain_calls() as plain:
        for (B, H, v, dt, kern), a in steps:
            got.append(call(lambda: cops.gru_step_cuda(*a, v), kern))
        for c, (x, w) in mms:
            got.append((call(lambda: mops.rowwise(x, w), "rowwise_matmul"),
                        call(lambda: mops.cascade(x, w), "cascade_matmul")))
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in counters.items()}
    others = {k.__name__: k.launches
              for k in (K.KERNELS + K.Q8_KERNELS + K.CHAIN_Q8_KERNELS
                        + SK.SLSTM_KERNELS + K.ATTN_KERNELS)}
    print(f"  launches: {launches}; other kernels {others}; plain versions "
          f"{plain}", flush=True)
    check(not any(plain.values()), f"row-wise path: plain versions ran "
          f"{plain}")
    check(not any(others.values()), f"row-wise path: other kernels ran "
          f"{others}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the row-wise path never launched: {launches}")
    err = {n: {"float32": 0.0, "bfloat16": 0.0} for n in ROWWISE}
    for ((B, H, v, dt, kern), a), y in zip(steps, got):
        want = cref.gru_step_ref(*a, v)
        tol = TOL if dt == "float32" else STEP_BF16_TOL
        e = (y - want).abs().max().item()
        err[kern][dt] = max(err[kern][dt], e)
        check(y.dtype == torch.float32 and bool(torch.isfinite(y).all())
              and torch.allclose(y, want, rtol=tol, atol=tol),
              f"{kern} B={B} H={H} {v} u {dt}: max |err| {e:.3g} (tol {tol})")
        print(f"  gru_step_cuda B={B} H={H:4d} {v} u {dt:8s} -> {kern}: max "
              f"|kernel - plain| {e:.3g}", flush=True)
    for ((B, K_, N, dt, vec), (x, w)), (yr, yc) in zip(mms, got[len(steps):]):
        x2 = x[None] if vec else x
        bk = mops.auto_blocks(x2.shape[0], K_, N, x2.element_size())[2]
        es = []
        for name, y, want in (
                ("rowwise_matmul", yr, mref.rowwise_matmul_ref(x2, w)),
                ("cascade_matmul", yc,
                 mref.cascade_matmul_ref(x2, w, bk).to(x.dtype))):
            y = y[None] if vec else y
            e = (y.float() - want.float()).abs().max().item()
            err[name][dt] = max(err[name][dt], e)
            es.append(e)
            check(y.dtype == x.dtype and bool(torch.isfinite(y.float()).all())
                  and torch.allclose(y.float(), want.float(),
                                     rtol=MM_TOL[dt], atol=MM_TOL[dt]),
                  f"{name} B={B} K={K_} N={N} {dt}: max |err| {e:.3g}")
        print(f"  rowwise / cascade B={B} K={K_:4d} N={N:4d} {dt:8s}"
              f"{' (1-D x)' if vec else ''}: max |kernel - plain| "
              f"{es[0]:.3g} / {es[1]:.3g}", flush=True)
    print(f"  {len(steps)} steps and {len(mms)} x 2 matmuls, each on the "
          f"kernel JAX's rule names, within tolerance of its plain version "
          f"(step fp32 {TOL}, bf16 u {STEP_BF16_TOL}; matmuls {MM_TOL})",
          flush=True)
    return launches, err


# ---------------------------------------------------------------------------
# 12. timing
# ---------------------------------------------------------------------------

def call_time_ms(torch, fn, iters: int, warmup: int = 5) -> float:
    """Per call, launched from Python one after another: CUDA events around
    the loop. Includes the host's cost of each call (checks, ctypes,
    allocation) wherever that exceeds the device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_time_ms(torch, fn, per_graph: int, replays: int = 5) -> float:
    """Device time per call: ``per_graph`` calls captured in one CUDA graph
    (measurement only; the port launches eagerly), CUDA events around
    ``replays`` replays, so the host's per-call cost is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * per_graph)


def bound_ms(name, a, masked=None):
    """Least time for the same work: every input read once and every output
    written once over 3.35 TB/s, or the operations the live (unmasked)
    steps need over their type's peak (fp32 67 TFLOP/s, int8 1,979 TOP/s),
    whichever is larger. Decode kernels and ``masked=False`` calls read no
    mask."""
    L, B, H = a["h0"].shape
    decode = name in DECODE
    T = 1 if decode else a["xp"].shape[0]
    masked = not decode if masked is None else masked
    # gate columns, state leaves per layer, elementwise flops per unit
    G, S, E = (4 * H, 4, 32) if name in SLSTM else (3 * H, 1, 14)
    live = float(a["mask"].sum().item()) if masked else B
    # weights, scales and bias: fp32 U, W_deep, b; q8 int8 rows + f32 eff
    w_bytes = (4 * (L * H * G + (L - 1) * H * G + L * G)
               if name not in Q8 else
               (L * G * H + (L - 1) * G * H) + 4 * (L * G + (L - 1) * G
                                                    + L * G))
    n_in = S * L * B * H + T * B * G + (T * B if masked else 0)
    n_out = {"gru_sequence_kernel": T * B * H,
             "gru_sequence_q8_kernel": T * B * H}.get(
        name, S * L * B * H if decode else T * B * H + S * L * B * H)
    nbytes = w_bytes + 4 * (n_in + n_out)
    # per live (row, step): the U matvecs 2*H*G per layer and the next
    # layer's W matvec 2*H*G below the top; elementwise E*H per layer (GRU
    # 14, sLSTM 32 counting each exp, log1p, tanh and division as one; q8
    # adds the dequant 6H, two activation quantizations 8H per layer and
    # the deep projection's 3H + 4H)
    mac_ops = live * (L * 2 * H * G + (L - 1) * 2 * H * G)
    if name in Q8:
        f32_ops = live * (L * 28 * H + (L - 1) * 7 * H)
        t_ops = (mac_ops / INT8_OP_PER_S + f32_ops / FP32_FLOP_PER_S) * 1e3
    else:
        t_ops = (mac_ops + live * L * E * H) / FP32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


TIMED = (("gru_sequence_kernel", (1, 20)),
         ("gru_stack_sequence_kernel", (3, 32)),
         ("gru_stack_decode_kernel", (3, 32)),
         ("gru_stack_decode_kernel", (1, 20)),
         ("gru_stack_sequence_q8_kernel", (3, 32)),
         ("gru_stack_sequence_q8_kernel", (1, 20)),
         ("gru_stack_decode_q8_kernel", (3, 32)),
         ("gru_stack_decode_q8_kernel", (1, 20)),
         ("gru_sequence_q8_kernel", (1, 32)),
         ("gru_sequence_q8_kernel", (1, 20)),
         ("gru_step_q8", (1, 32)),
         ("gru_step_q8", (1, 20)),
         ("slstm_stack_sequence_kernel", (1, 20)),
         ("slstm_stack_sequence_kernel", (3, 32)),
         ("slstm_stack_decode_kernel", (1, 20)),
         ("slstm_stack_decode_kernel", (3, 32)))


def time_kernels(torch, dev, err, launches):
    """Kernel, plain-version and bound times at the main path's shapes;
    the JSON rows are the 8-slot shapes (gru-jet fp32 prefill, gru-jet-deep
    for the others: L=3 for the fused kernels, one H=32 layer for the q8
    chain's; slstm-jet, L=1 H=20, for the sLSTM kernels)."""
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.gru_sequence import ref
    rows = []
    # main-path shapes: 8 slots, a 16-step bucket, v1 (the configs' variant)
    for name, (L, H) in TIMED:
        for B in (1, SLOTS, 64):
            decode = name in DECODE
            T = 1 if decode else 16
            a = inputs_for(torch, name, L, H, B, T, 7, dev)

            def kern():
                return run_kernel(K, ref, name, a, "v1", not decode,
                                  plain=False)

            def plain_fn():
                return run_kernel(K, ref, name, a, "v1", not decode,
                                  plain=True)
            ms = device_time_ms(torch, kern, per_graph=200)
            plain = device_time_ms(torch, plain_fn, per_graph=4 if T > 1
                                   else 50)
            call = call_time_ms(torch, kern, iters=300)
            plain_call = call_time_ms(torch, plain_fn, iters=10)
            bms, by = bound_ms(name, a)
            print(f"  {name:28s} L={L} H={H} B={B:2d} T={T:2d}: device "
                  f"{ms * 1e3:8.2f} us (per call {call * 1e3:7.2f})  plain "
                  f"{plain * 1e3:9.2f} us (per call {plain_call * 1e3:9.2f})"
                  f"  bound {bms * 1e6:7.2f} ns ({by})", flush=True)
            if B == SLOTS and (
                    (name in SLSTM and L == 1) or (name not in SLSTM and (
                        name == "gru_sequence_kernel" or L == 3
                        or (name in CHAIN_Q8 and H == 32)))):
                rows.append({
                    "name": name, "route": "cuda",
                    "source": KERNEL_SOURCE[name],
                    "replaces": REPLACES[name],
                    "launches": launches[name], "max_abs_err": err[name],
                    "ms": ms, "plain_ms": plain, "bound_ms": bms,
                    "bound_by": by, "library_ms": None,
                    "call_ms": call, "plain_call_ms": plain_call,
                    "shape": {"L": L, "H": H, "B": B, "T": T,
                              "variant": None if name in SLSTM else "v1"}})
    # the fp32 chain's decode layer: the depth-1 sequence kernel at T=1,
    # unmasked (a row of PERF.md, not of the JSON line)
    for H in (32, 20):
        for B in (1, SLOTS, 64):
            a = make_inputs(torch, 1, H, B, 1, seed=7, dev=dev)

            def step(plain):
                return run_kernel(K, ref, "gru_sequence_kernel", a, "v1",
                                  False, plain=plain)
            ms = device_time_ms(torch, lambda: step(False), per_graph=200)
            plain = device_time_ms(torch, lambda: step(True), per_graph=50)
            call = call_time_ms(torch, lambda: step(False), iters=300)
            bms, by = bound_ms("gru_sequence_kernel", a, masked=False)
            print(f"  {'gru_sequence_kernel (chain decode)':28s} L=1 H={H} "
                  f"B={B:2d} T= 1: device {ms * 1e3:8.2f} us (per call "
                  f"{call * 1e3:7.2f})  plain {plain * 1e3:9.2f} us  bound "
                  f"{bms * 1e6:7.2f} ns ({by})", flush=True)
    print("  library_ms: null -- no single PyTorch call computes the v1 "
          "(paper) GRU recurrence or step these kernels run, in fp32 or on "
          "int8 weight rows; nor the exponential-gated sLSTM (torch.nn.LSTM "
          "has neither its exponential gates nor its stabilizer)",
          flush=True)
    return rows


# the attention kernels' timing rows: (B, Sq/Sk or C, ...) at the served
# shapes (S = 12 and 128, 4 requests) and at S = 2048, bf16 (the served
# compute dtype); the JSON row is the S = 128 wave's
ATTN_TIMED = (("flash_attention", (4, 12, 12, True, 0)),
              ("flash_attention", (4, 128, 128, True, 0)),
              ("flash_attention", (1, 2048, 2048, True, 0)),
              ("flash_decode", (4, 76, (0, 12), 12, 0)),
              ("flash_decode", (4, 192, (0, 128), 128, 0)),
              ("flash_decode", (1, 2112, (0, 2048), 2048, 0)))
ATTN_ROW = {"flash_attention": (4, 128, 128, True, 0),
            "flash_decode": (4, 192, (0, 128), 128, 0)}


def attn_bound_ms(name, shape, itemsize, valid=None):
    """Least time: q, k, v read once and the output written once over
    3.35 TB/s, or 4*D flops per valid (query, key) pair and head over the
    peak of the inputs' type (bf16 989, fp32 67 TFLOP/s), the larger.
    Flash decode counts only the valid slots' K and V (what this cache's
    data needs), its byte mask and its fp32 output."""
    from repro_torch.kernels.flash_attn import ref as fref
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    if name == "flash_attention":
        B, Sq, Sk, causal, window = shape
        pairs = int(fref._mask(Sq, 0, Sk, causal, window, "cpu").sum())
        flops = 4 * HD * pairs * B * HQ
        nbytes = itemsize * (2 * B * HQ * Sq * HD + 2 * B * HKV * Sk * HD)
    else:
        B, C = shape[:2]
        flops = 4 * HD * valid * B * HQ
        nbytes = (itemsize * (B * HQ * HD + 2 * B * HKV * valid * HD) + C
                  + 4 * B * HQ * HD)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_attention(torch, dev, err, launches):
    """Kernel, plain-version, library and bound times of the two attention
    kernels; returns the two JSON rows."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.decode_attn import ref as dref
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import ref as fref
    rows = []
    for name, shape in ATTN_TIMED:
        dtype = torch.bfloat16
        if name == "flash_attention":
            B, Sq, Sk, causal, window = shape
            q, k, v = attn_inputs(torch, B, Sq, Sk, dtype, 11, dev)
            valid = None

            def kern():
                return FK.flash_attention(q, k, v, causal=causal,
                                          window=window)

            def plain_fn():
                return fref.flash_attention_plain(q, k, v, causal, window)

            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
            label = f"B={B} Sq={Sq:4d} Sk={Sk:4d}"
        else:
            B, C, written, pos, window = shape
            q, kc, vc, mask = decode_inputs(torch, B, C, written, pos, window,
                                            dtype, 11, dev)
            valid = int(mask.sum())
            qh = q.reshape(B, HQ, 1, HD)
            amask = mask[None, None, None, :]

            def kern():
                return DK.flash_decode(q, kc, vc, mask)

            def plain_fn():
                return dref.flash_decode_plain(q, kc, vc, mask)

            def library():
                return F.scaled_dot_product_attention(
                    qh, kc, vc, attn_mask=amask, enable_gqa=True)
            label = f"B={B} C={C:4d} valid={valid:4d}"
        lib_out, want = library(), plain_fn()
        lib_err = (lib_out.float().reshape(want.shape)
                   - want.float()).abs().max().item()
        ms = device_time_ms(torch, kern, per_graph=50)
        plain = device_time_ms(torch, plain_fn, per_graph=2)
        lib = device_time_ms(torch, library, per_graph=50)
        call = call_time_ms(torch, kern, iters=200)
        bms, by = attn_bound_ms(name, shape, 2, valid)
        print(f"  {name:15s} bf16 {label}: device {ms * 1e3:9.2f} us (per "
              f"call {call * 1e3:8.2f})  plain {plain * 1e3:10.2f} us  "
              f"sdpa {lib * 1e3:8.2f} us (|sdpa - plain| {lib_err:.3g})  "
              f"bound {bms * 1e3:8.3f} us ({by})", flush=True)
        if shape == ATTN_ROW[name]:
            rows.append({
                "name": name, "route": "cuda",
                "source": KERNEL_SOURCE[name], "replaces": REPLACES[name],
                "launches": launches[name],
                "max_abs_err": err[name]["float32"],
                "max_abs_err_bf16": err[name]["bfloat16"],
                "ms": ms, "plain_ms": plain, "bound_ms": bms,
                "bound_by": by, "library_ms": lib, "call_ms": call,
                "shape": {"heads": [HQ, HKV, HD], "shape": list(shape),
                          "dtype": "bfloat16"}})
    print("  library_ms: torch.nn.functional.scaled_dot_product_attention "
          "(enable_gqa; is_causal for prefill, the validity mask for "
          "decode) on the same inputs, timed only", flush=True)
    return rows


# the row-wise primitives' timing rows: (kernel, (B, H or K, N or None,
# variant or None, dtype)); the JSON rows are marked
ROWWISE_TIMED = (
    ("gru_step_fused", (8, 20, None, "v1", "float32")),
    ("gru_step_fused", (8, 32, None, "v1", "float32")),     # JSON row
    ("gru_step_fused", (8, 32, None, "v3", "float32")),
    ("gru_step_fused", (8, 32, None, "v1", "bfloat16")),
    ("gru_step_fused", (1, 1000, None, "v1", "float32")),
    ("gru_step_fused", (8, 1024, None, "v3", "float32")),
    ("gru_step_blocked", (1, 1024, None, "v1", "float32")),
    ("gru_step_blocked", (8, 1024, None, "v1", "float32")),  # JSON row
    ("gru_step_blocked", (8, 2048, None, "v1", "float32")),
    ("gru_step_blocked", (8, 2048, None, "v1", "bfloat16")),
    ("rowwise_matmul", (8, 32, 96, None, "float32")),
    ("rowwise_matmul", (4, 1024, 3072, None, "bfloat16")),   # JSON row
    ("rowwise_matmul", (4, 1024, 3072, None, "float32")),
    ("rowwise_matmul", (4, 3072, 1024, None, "bfloat16")),
    ("rowwise_matmul", (4, 3072, 1024, None, "float32")),
    ("cascade_matmul", (8, 32, 96, None, "float32")),
    ("cascade_matmul", (4, 1024, 3072, None, "float32")),    # JSON row
    ("cascade_matmul", (4, 1024, 3072, None, "bfloat16")),
    ("cascade_matmul", (4, 3072, 1024, None, "float32")),
    ("cascade_matmul", (4, 3072, 1024, None, "bfloat16")))
ROWWISE_ROW = {"gru_step_fused": (8, 32, None, "v1", "float32"),
               "gru_step_blocked": (8, 1024, None, "v1", "float32"),
               "rowwise_matmul": (4, 1024, 3072, None, "bfloat16"),
               "cascade_matmul": (4, 1024, 3072, None, "float32")}


def rowwise_bound_ms(name, shape):
    """Least time: every input read once and the output written once over
    3.35 TB/s, or the products over the peak of the weights' type (bf16's
    989 TFLOP/s on the tensor cores, fp32's 67) plus the step's 14
    elementwise flops per unit at 67 TFLOP/s, whichever is larger."""
    B, n, N, _, dtype = shape
    item = 2 if dtype == "bfloat16" else 4
    peak = BF16_FLOP_PER_S if item == 2 else FP32_FLOP_PER_S
    if name in ("gru_step_fused", "gru_step_blocked"):
        H = n                  # u (H,3H); h, x_proj, b and out float32
        nbytes = item * 3 * H * H + 4 * (B * H + 3 * B * H + 3 * H + B * H)
        t_ops = (2 * B * 3 * H * H / peak + 14 * B * H / FP32_FLOP_PER_S)
    else:
        K_ = n                 # x (B,K), w (K,N); rowwise out in x's dtype
        out_item = item if name == "rowwise_matmul" else 4
        nbytes = item * (B * K_ + K_ * N) + out_item * B * N
        t_ops = 2 * B * K_ * N / peak
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops *= 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_rowwise(torch, dev, err, launches):
    """Kernel, plain-version, library and bound times of the four row-wise
    primitives, each kernel called through its wrapper with the blocks its
    entry point picks; returns the four JSON rows."""
    from repro_torch.kernels.gru_cell import kernel as CK
    from repro_torch.kernels.gru_cell import ref as cref
    from repro_torch.kernels.rowwise_matvec import kernel as MK
    from repro_torch.kernels.rowwise_matvec import ops as mops
    from repro_torch.kernels.rowwise_matvec import ref as mref
    rows = []
    for name, shape in ROWWISE_TIMED:
        B, n, N, v, dtype = shape
        library = None
        if name.startswith("gru_step"):
            h, xp, u, b = step_inputs(torch, B, n, dtype, 13, dev)
            if name == "gru_step_fused":
                def kern():
                    return CK.gru_step_fused(h, xp, u, b, variant=v)
            else:
                def kern():
                    return CK.gru_step_blocked(h, xp, u, b, block_n=256)

            def plain_fn():
                return cref.gru_step_ref(h, xp, u, b, v)
            label = f"B={B} H={n:4d} {v} u {dtype}"
        else:
            x, w = mm_inputs(torch, B, n, N, dtype, 13, dev)
            bb, bn, bk = mops.auto_blocks(B, n, N, x.element_size())
            if name == "rowwise_matmul":
                def kern():
                    return MK.rowwise_matmul(x, w, block_b=bb, block_n=bn)

                def plain_fn():
                    return mref.rowwise_matmul_ref(x, w)
            else:
                def kern():
                    return MK.cascade_matmul(x, w, block_b=bb, block_n=bn,
                                             block_k=bk)

                def plain_fn():
                    return mref.cascade_matmul_ref(x, w, bk)
            # one torch.matmul computes the same function, except for the
            # bf16 cascade (fp32 output; a bf16 matmul rounds to bf16)
            if name == "rowwise_matmul" or dtype == "float32":
                def library():
                    return torch.matmul(x, w)
            label = f"B={B} K={n:4d} N={N:4d} {dtype}"
        ms = device_time_ms(torch, kern, per_graph=50)
        plain = device_time_ms(torch, plain_fn, per_graph=10)
        lib = (device_time_ms(torch, library, per_graph=50)
               if library is not None else None)
        call = call_time_ms(torch, kern, iters=200)
        bms, by = rowwise_bound_ms(name, shape)
        lib_s = f"{lib * 1e3:8.2f} us" if lib is not None else "    n/a"
        print(f"  {name:16s} {label}: device {ms * 1e3:9.2f} us (per call "
              f"{call * 1e3:8.2f})  plain {plain * 1e3:9.2f} us  matmul "
              f"{lib_s}  bound {bms * 1e3:8.4f} us ({by})", flush=True)
        if shape == ROWWISE_ROW[name]:
            rows.append({
                "name": name, "route": "cuda",
                "source": KERNEL_SOURCE[name], "replaces": REPLACES[name],
                "launches": launches[name],
                "max_abs_err": err[name]["float32"],
                "max_abs_err_bf16": err[name]["bfloat16"],
                "ms": ms, "plain_ms": plain, "bound_ms": bms,
                "bound_by": by, "library_ms": lib, "call_ms": call,
                "shape": {"B": B, ("H" if N is None else "K"): n, "N": N,
                          "variant": v, "dtype": dtype}})
    print("  library_ms: torch.matmul on the same inputs (TF32 off) where it "
          "computes the same function (rowwise; fp32 cascade); null for the "
          "GRU steps -- torch.nn.GRUCell computes neither v1 nor JAX's v3 "
          "from a given x_proj", flush=True)
    return rows


def device_kernels(prof) -> dict:
    """Device time (us) by name of what ran on the card (kernels, copies),
    from a profile: only the device entries, since a host op's entry
    carries the device time of the kernels it launched too."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and getattr(e, "device_type", None) == DeviceType.CUDA:
            out[e.key] = us
    return out


def profile_lm_decode(torch, dev, params):
    """Device busy share of a served qwen3-0.6b decode step: two profiled
    waves of 4 requests (12-token prompts) through ``attn_impl="cuda"``,
    one with 1 new token and one with 41, so their difference is 40
    decode steps (the prefill cancels); busy = the kernels' summed device
    time, over the host wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config(LM_ARCH)
    eng = ServeEngine(cfg, params, max_batch=LM_SLOTS, device=dev)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=12).astype(np.int32)
               for _ in range(LM_SLOTS)]

    def wave(new):
        return [Request(prompt=p, max_new_tokens=new) for p in prompts]
    eng.generate(wave(4))                        # warm
    torch.cuda.synchronize()
    runs = {}
    for new in (1, 41):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            eng.generate(wave(new))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        kernels = device_kernels(prof)
        runs[new] = (wall, sum(kernels.values()) / 1e6, kernels)
    if not runs[41][2]:
        print("  profiler: no device time recorded -> busy share not "
              "measured", flush=True)
        return None
    steps = 40
    wall = (runs[41][0] - runs[1][0]) / steps
    busy = (runs[41][1] - runs[1][1]) / steps
    print(f"  decode step ({LM_ARCH}, cuda, {LM_SLOTS} requests, 40 steps "
          f"by difference): wall {wall * 1e3:.4f} ms/step, device busy "
          f"{busy * 1e3:.4f} ms/step = {busy / wall:.3%} (idle "
          f"{1 - busy / wall:.3%})", flush=True)
    k41, k1 = runs[41][2], runs[1][2]
    diff = {k: (us - k1.get(k, 0.0)) / steps for k, us in k41.items()}
    for k, us in sorted(diff.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us:9.2f} us/step  {k[:90]}")
    return {"wall_ms_per_step": wall * 1e3,
            "device_busy_ms_per_step": busy * 1e3,
            "device_idle_share": 1 - busy / wall}


def profile_decode(torch, dev, backend, arch="gru-jet-deep"):
    """Device busy share of the served decode step: ``torch.profiler`` over
    20 warm steps of a full 8-slot ``arch`` wave through ``backend``;
    busy = the kernels' summed device time over the steps' wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.core.params import init_params
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config(arch)
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru, backend=backend))
    params = init_params(api.get_api(cfg).specs(cfg), seed=0, device=dev)
    eng = ServeEngine(cfg, params, max_batch=SLOTS, device=dev)
    eng.gru_wave_begin(make_requests(cfg, SLOTS, 10, False, 64, seed=1))
    for _ in range(10):
        eng.gru_wave_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(20):
            eng.gru_wave_step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = device_kernels(prof)
    busy = sum(kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    if not kernels:
        print("  profiler: no device time recorded -> busy share not "
              "measured", flush=True)
        return None
    every_key = sum(getattr(e, "self_device_time_total", 0.0)
                    for e in prof.key_averages()) / 1e6
    print(f"  (summing every profiler key, the host ops' device time "
          f"beside their kernels' as PRs 11-15 did: {every_key / 20 * 1e3:.4f}"
          f" ms/step)", flush=True)
    print(f"  decode step ({arch}, {backend}, {SLOTS} slots, 20 "
          f"steps): wall {wall / 20 * 1e3:.4f} ms/step, device busy "
          f"{busy / 20 * 1e3:.4f} ms/step = {busy / wall:.3%} (idle "
          f"{1 - busy / wall:.3%})", flush=True)
    for k, us in top:
        print(f"    {us / 20:9.2f} us/step  {k[:90]}")
    return {"wall_ms_per_step": wall / 20 * 1e3,
            "device_busy_ms_per_step": busy / 20 * 1e3,
            "device_idle_share": 1 - busy / wall}


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    phase("1. device")
    kind, count, smi_line = device_info(torch)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not here ({e}); run from the repository root")
    dev = torch.device("cuda", 0)
    phase("2. build")
    build_kernels()
    phase("3. kernels vs plain versions")
    err = check_kernels(torch, dev)
    phase("4. main path: serve gru-jet and gru-jet-deep through cuda_fused")
    launches, report, cfgs, params, streams = run_main_path(torch, dev)
    phase("5. int8 path: serve gru-jet and gru-jet-deep through "
          "cuda_fused_q8")
    q8_launches, q8_report = run_q8_path(torch, dev, cfgs, params, streams)
    launches.update(q8_launches)
    ccfgs, cparams = chain_configs(torch, dev, cfgs, params)
    phase("6. per-layer chain: serve both configs and a heterogeneous stack "
          "through cuda_chain")
    chain_launches, chain_report = run_chain_path(torch, dev, ccfgs, cparams)
    phase("7. int8 per-layer chain: the same through cuda_chain_q8")
    cq8_launches, cq8_report = run_chain_q8_path(torch, dev, ccfgs, cparams)
    for k, n in list(chain_launches.items()) + list(cq8_launches.items()):
        launches[k] = launches.get(k, 0) + n
    phase("8. sLSTM: serve slstm-jet and an L=3 H=32 stack through "
          "cuda_fused")
    slstm_launches, slstm_report = run_slstm_path(torch, dev)
    launches.update(slstm_launches)
    phase("9. attention kernels vs plain versions (qwen3-0.6b heads)")
    attn_err = check_attention_kernels(torch, dev)
    phase("10. dense LM: serve qwen3-0.6b at full width through the "
          "attention kernels")
    lm_launches, lm_report, lm_params = run_lm_path(torch, dev)
    launches.update(lm_launches)
    phase("11. the paper's row-wise primitives through gru_step_cuda, "
          "rowwise and cascade")
    rw_launches, rw_err = run_rowwise_path(torch, dev)
    launches.update(rw_launches)
    phase("12. timing (CUDA events: device via graph replay, and per call)")
    rows = time_kernels(torch, dev, err, launches)
    rows += time_attention(torch, dev, attn_err, launches)
    rows += time_rowwise(torch, dev, rw_err, launches)
    for rep, backend in ((report, "cuda"), (q8_report, "cuda_fused_q8"),
                         (chain_report, "cuda_chain"),
                         (cq8_report, "cuda_chain_q8")):
        rep["profile_gru_jet_deep_decode"] = profile_decode(torch, dev,
                                                            backend)
    slstm_report["profile_slstm_jet_decode"] = profile_decode(
        torch, dev, "cuda_fused", "slstm-jet")
    lm_report["profile_decode"] = profile_lm_decode(torch, dev, lm_params)
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the JAX package was imported")
    print(json.dumps({"serve": report, "serve_q8": q8_report,
                      "serve_chain": chain_report,
                      "serve_chain_q8": cq8_report,
                      "serve_slstm": slstm_report, "serve_lm": lm_report,
                      "rowwise_launches": rw_launches}))
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
