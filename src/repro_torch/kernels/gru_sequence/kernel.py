"""Wrappers of the GRU sequence kernels (``repro_torch/csrc/gru_sequence.cu``,
and the int8 ones in ``repro_torch/csrc/gru_sequence_q8.cu``).

Same names and array interface as the Pallas kernels in
``repro.kernels.gru_sequence.kernel``:

* :func:`gru_sequence_kernel` — depth-1 sequence, h0 (B,H), x_proj
  (T,B,3H), u (H,3H), b (3H,), optional mask (T,B) -> (T,B,H);
* :func:`gru_stack_sequence_kernel` — fused depth-L sequence, h0 (L,B,H),
  u (L,H,3H), w_deep (L-1,H,3H) ((1,1,3H) for L=1, unused), b (L,3H)
  -> ((T,B,H) last layer, (L,B,H) finals);
* :func:`gru_stack_decode_kernel` — one token through L layers, h (L,B,H),
  x_proj (B,3H) -> (L,B,H);
* :func:`gru_stack_sequence_q8_kernel` / :func:`gru_stack_decode_q8_kernel`
  — their q8 twins: int8 weight rows u_q (L,3H,H) with u_eff (L,3H),
  wd_q (L-1,3H,H) with wd_eff (L-1,3H) ((1,3H,1) and (1,3H) for L=1,
  unused), b (L,3H); states and x_proj stay float32;
* :func:`gru_sequence_q8_kernel` — the depth-1 q8 sequence of one chain
  layer: h0 (B,H), x_proj (T,B,3H), u_q (3H,H) int8, u_eff (3H,), b (3H,),
  optional mask (T,B) -> (T,B,H).

Every wrapper checks device, dtype (float32; int8 weight rows for q8),
shapes and contiguity and raises on anything the kernel does not take
(:mod:`repro_torch.kernels._launch`). For CPU tensors it returns the plain
PyTorch version (``ref.py``); for CUDA tensors it allocates the outputs
with ``torch.empty``, launches the kernel on the current stream, raises if
the launch was refused, and adds one to its ``launches`` counter. Nothing
falls back from the card to the plain version.

Launch counters come in three tuples: :data:`KERNELS` (the three fp32
kernels), :data:`Q8_KERNELS` (the fused q8 pair) and
:data:`CHAIN_Q8_KERNELS` (the q8 chain's pair: :func:`gru_sequence_q8_kernel`
and ``repro_torch.kernels.gru_cell.kernel.gru_step_q8``);
:func:`reset_launch_counts` zeroes all three, the sLSTM's
``SLSTM_KERNELS`` (``repro_torch.kernels.slstm_cell.kernel``) and the dense
LM's attention kernels, :data:`ATTN_KERNELS` (``flash_attention`` and
``flash_decode`` of ``repro_torch.kernels.flash_attn`` and
``repro_torch.kernels.decode_attn``).

A thread block takes a tile of :data:`DEFAULT_BATCH_BLOCK` batch rows
(the decode kernel's ``batch_block`` sets it, as in the JAX signature);
the grid is ``ceil(B / tile)`` blocks. U, the deep layers' W, b and the
per-layer h of one tile must fit the 227 KB of shared memory a Hopper
block may use.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels._launch import (DEFAULT_BATCH_BLOCK,  # noqa: F401
                                         SMEM_LIMIT, I, P)
from repro_torch.kernels._launch import check as _check
from repro_torch.kernels._launch import ptr as _ptr
from repro_torch.kernels._launch import raise_on as _raise_on
from repro_torch.kernels._launch import stream as _stream
from repro_torch.kernels.gru_cell.kernel import gru_step_q8
from repro_torch.kernels.gru_cell.ref import check_q8_width
from repro_torch.kernels.gru_sequence import ref
from repro_torch.kernels.decode_attn.kernel import flash_decode
from repro_torch.kernels.flash_attn.kernel import flash_attention
from repro_torch.kernels.slstm_cell.kernel import SLSTM_KERNELS

_SIGNATURES = {        # launcher -> (library, argtypes)
    # h0, xp, u, b, mask, out, T, B, H, v3, bt, stream
    "gru_sequence_launch": ("gru_sequence", [P] * 6 + [I] * 5 + [P]),
    # h0, xp, u, wd, b, mask, out, finals, T, B, H, L, v3, bt, stream
    "gru_stack_sequence_launch": ("gru_sequence", [P] * 8 + [I] * 6 + [P]),
    # h, xp, u, wd, b, out, B, H, L, v3, bt, stream
    "gru_stack_decode_launch": ("gru_sequence", [P] * 6 + [I] * 5 + [P]),
    # h0, xp, u_q, u_eff, wd_q, wd_eff, b, mask, out, finals,
    # T, B, H, L, v3, bt, stream
    "gru_stack_sequence_q8_launch": ("gru_sequence_q8",
                                     [P] * 10 + [I] * 6 + [P]),
    # h, xp, u_q, u_eff, wd_q, wd_eff, b, out, B, H, L, v3, bt, stream
    "gru_stack_decode_q8_launch": ("gru_sequence_q8",
                                   [P] * 8 + [I] * 5 + [P]),
    # h0, xp, u_q, u_eff, b, mask, out, T, B, H, v3, bt, stream
    "gru_sequence_q8_launch": ("gru_sequence_q8", [P] * 7 + [I] * 5 + [P]),
}


def _launcher(name: str):
    library, argtypes = _SIGNATURES[name]
    return _launch.launcher(library, name, argtypes)


def smem_bytes(L: int, H: int, bt: int) -> int:
    """Dynamic shared memory of one block (mirrors ``smem_bytes`` in the
    CUDA source): U, deep W, b, per-layer h, two gate buffers, r*h and the
    double-buffered step mask."""
    H3 = 3 * H
    floats = (L * H * H3 + (L - 1) * H * H3 + L * H3 + L * bt * H
              + 2 * bt * H3 + bt * H + 2 * bt)
    return 4 * floats


def smem_bytes_q8(L: int, H: int, bt: int) -> int:
    """Dynamic shared memory of one q8 block (mirrors ``smem_bytes_q8`` in
    the CUDA source): int8 U and deep W rows padded to an odd number of
    4-byte words, their scales, b, per-layer h, the v1 z gate, the deep
    input projection, two quantized activation rows and the step mask."""
    H3 = 3 * H
    nw = (H + 3) // 4
    ld = nw | 1
    words = ((2 * L - 1) * H3 * ld + (3 * L - 1) * H3 + L * bt * H + bt * H
             + bt * H3 + 2 * bt * nw + 2 * bt)
    return 4 * words


def _w_deep_shape(L: int, H: int) -> tuple:
    """(L-1,H,3H); a depth-1 stack passes the unused (1,1,3H) placeholder."""
    return (L - 1, H, 3 * H) if L > 1 else (1, 1, 3 * H)


def gru_sequence_kernel(h0: torch.Tensor, x_proj: torch.Tensor,
                        u: torch.Tensor, b: torch.Tensor,
                        mask: Optional[torch.Tensor] = None, *,
                        variant: str = "v1") -> torch.Tensor:
    """Depth-1 GRU over T steps -> all hidden states (T,B,H)."""
    if x_proj.dim() != 3:
        raise ValueError(f"x_proj: expected (T,B,3H), got {tuple(x_proj.shape)}")
    T, B, H3 = x_proj.shape
    H = H3 // 3
    dev = x_proj.device
    bt = _launch.batch_tile(variant, B, T, H, 1, 0, dev, smem_bytes)
    _check("h0", h0, (B, H), dev)
    _check("x_proj", x_proj, (T, B, 3 * H), dev)
    _check("u", u, (H, 3 * H), dev)
    _check("b", b, (3 * H,), dev)
    if mask is not None:
        _check("mask", mask, (T, B), dev)
    if dev.type == "cpu":
        return ref.gru_sequence_ref(h0, x_proj, u, b, mask, variant)
    out = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    err = _launcher("gru_sequence_launch")(
        _ptr(h0), _ptr(x_proj), _ptr(u), _ptr(b), _ptr(mask), _ptr(out),
        T, B, H, int(variant == "v3"), bt, _stream(dev))
    _raise_on(err, "gru_sequence_kernel")
    gru_sequence_kernel.launches += 1
    return out


def gru_stack_sequence_kernel(h0: torch.Tensor, x_proj: torch.Tensor,
                              u: torch.Tensor, w_deep: torch.Tensor,
                              b: torch.Tensor,
                              mask: Optional[torch.Tensor] = None, *,
                              variant: str = "v1"):
    """Fused depth-L GRU over T steps -> ((T,B,H) last layer's states,
    (L,B,H) per-layer finals)."""
    if x_proj.dim() != 3 or h0.dim() != 3:
        raise ValueError("x_proj (T,B,3H) and h0 (L,B,H) expected, got "
                         f"{tuple(x_proj.shape)} and {tuple(h0.shape)}")
    T, B, H3 = x_proj.shape
    H = H3 // 3
    L = h0.shape[0]
    dev = x_proj.device
    bt = _launch.batch_tile(variant, B, T, H, L, 0, dev, smem_bytes)
    _check("h0", h0, (L, B, H), dev)
    _check("x_proj", x_proj, (T, B, 3 * H), dev)
    _check("u", u, (L, H, 3 * H), dev)
    _check("w_deep", w_deep, _w_deep_shape(L, H), dev)
    _check("b", b, (L, 3 * H), dev)
    if mask is not None:
        _check("mask", mask, (T, B), dev)
    if dev.type == "cpu":
        return ref.gru_stack_sequence_ref(h0, x_proj, u, w_deep, b, mask,
                                          variant)
    out = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    finals = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    err = _launcher("gru_stack_sequence_launch")(
        _ptr(h0), _ptr(x_proj), _ptr(u), _ptr(w_deep), _ptr(b), _ptr(mask),
        _ptr(out), _ptr(finals), T, B, H, L, int(variant == "v3"), bt,
        _stream(dev))
    _raise_on(err, "gru_stack_sequence_kernel")
    gru_stack_sequence_kernel.launches += 1
    return out, finals


def gru_stack_decode_kernel(h: torch.Tensor, x_proj: torch.Tensor,
                            u: torch.Tensor, w_deep: torch.Tensor,
                            b: torch.Tensor, *, variant: str = "v1",
                            batch_block: int = 0) -> torch.Tensor:
    """One token through all L layers -> new per-layer states (L,B,H)."""
    if h.dim() != 3 or x_proj.dim() != 2:
        raise ValueError("h (L,B,H) and x_proj (B,3H) expected, got "
                         f"{tuple(h.shape)} and {tuple(x_proj.shape)}")
    L, B, H = h.shape
    dev = h.device
    bt = _launch.batch_tile(variant, B, 1, H, L, batch_block, dev,
                             smem_bytes)
    _check("h", h, (L, B, H), dev)
    _check("x_proj", x_proj, (B, 3 * H), dev)
    _check("u", u, (L, H, 3 * H), dev)
    _check("w_deep", w_deep, _w_deep_shape(L, H), dev)
    _check("b", b, (L, 3 * H), dev)
    if dev.type == "cpu":
        return ref.gru_stack_decode_ref(h, x_proj, u, w_deep, b, variant)
    out = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    err = _launcher("gru_stack_decode_launch")(
        _ptr(h), _ptr(x_proj), _ptr(u), _ptr(w_deep), _ptr(b), _ptr(out),
        B, H, L, int(variant == "v3"), bt, _stream(dev))
    _raise_on(err, "gru_stack_decode_kernel")
    gru_stack_decode_kernel.launches += 1
    return out


def _q8_common(variant: str, B: int, T: int, H: int, L: int,
               batch_block: int, dev: torch.device, u_q, u_eff, wd_q, wd_eff,
               b) -> int:
    """Checks shared by the q8 wrappers; returns the batch tile."""
    check_q8_width(H, dev)
    bt = _launch.batch_tile(variant, B, T, H, L, batch_block, dev,
                             smem_bytes_q8)
    _check("u_q", u_q, (L, 3 * H, H), dev, torch.int8)
    _check("u_eff", u_eff, (L, 3 * H), dev)
    _check("wd_q", wd_q, (L - 1, 3 * H, H) if L > 1 else (1, 3 * H, 1), dev,
           torch.int8)
    _check("wd_eff", wd_eff, (max(L - 1, 1), 3 * H), dev)
    _check("b", b, (L, 3 * H), dev)
    return bt


def gru_stack_sequence_q8_kernel(h0: torch.Tensor, x_proj: torch.Tensor,
                                 u_q: torch.Tensor, u_eff: torch.Tensor,
                                 wd_q: torch.Tensor, wd_eff: torch.Tensor,
                                 b: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None, *,
                                 variant: str = "v1"):
    """Fused q8 depth-L GRU over T steps (any L, including 1) -> ((T,B,H)
    last layer's states, (L,B,H) per-layer finals)."""
    if x_proj.dim() != 3 or h0.dim() != 3:
        raise ValueError("x_proj (T,B,3H) and h0 (L,B,H) expected, got "
                         f"{tuple(x_proj.shape)} and {tuple(h0.shape)}")
    T, B, H3 = x_proj.shape
    H = H3 // 3
    L = h0.shape[0]
    dev = x_proj.device
    bt = _q8_common(variant, B, T, H, L, 0, dev, u_q, u_eff, wd_q, wd_eff, b)
    _check("h0", h0, (L, B, H), dev)
    _check("x_proj", x_proj, (T, B, 3 * H), dev)
    if mask is not None:
        _check("mask", mask, (T, B), dev)
    if dev.type == "cpu":
        return ref.gru_stack_sequence_q8_ref(h0, x_proj, u_q, u_eff, wd_q,
                                             wd_eff, b, mask, variant)
    out = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    finals = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    err = _launcher("gru_stack_sequence_q8_launch")(
        _ptr(h0), _ptr(x_proj), _ptr(u_q), _ptr(u_eff), _ptr(wd_q),
        _ptr(wd_eff), _ptr(b), _ptr(mask), _ptr(out), _ptr(finals), T, B, H,
        L, int(variant == "v3"), bt, _stream(dev))
    _raise_on(err, "gru_stack_sequence_q8_kernel")
    gru_stack_sequence_q8_kernel.launches += 1
    return out, finals


def gru_stack_decode_q8_kernel(h: torch.Tensor, x_proj: torch.Tensor,
                               u_q: torch.Tensor, u_eff: torch.Tensor,
                               wd_q: torch.Tensor, wd_eff: torch.Tensor,
                               b: torch.Tensor, *, variant: str = "v1",
                               batch_block: int = 0) -> torch.Tensor:
    """One token through all L layers on int8 weight rows -> new per-layer
    states (L,B,H) float32."""
    if h.dim() != 3 or x_proj.dim() != 2:
        raise ValueError("h (L,B,H) and x_proj (B,3H) expected, got "
                         f"{tuple(h.shape)} and {tuple(x_proj.shape)}")
    L, B, H = h.shape
    dev = h.device
    bt = _q8_common(variant, B, 1, H, L, batch_block, dev, u_q, u_eff, wd_q,
                    wd_eff, b)
    _check("h", h, (L, B, H), dev)
    _check("x_proj", x_proj, (B, 3 * H), dev)
    if dev.type == "cpu":
        return ref.gru_stack_decode_q8_ref(h, x_proj, u_q, u_eff, wd_q,
                                           wd_eff, b, variant)
    out = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    err = _launcher("gru_stack_decode_q8_launch")(
        _ptr(h), _ptr(x_proj), _ptr(u_q), _ptr(u_eff), _ptr(wd_q),
        _ptr(wd_eff), _ptr(b), _ptr(out), B, H, L, int(variant == "v3"), bt,
        _stream(dev))
    _raise_on(err, "gru_stack_decode_q8_kernel")
    gru_stack_decode_q8_kernel.launches += 1
    return out


def smem_bytes_seq_q8(H: int, bt: int) -> int:
    """Dynamic shared memory of one block of the depth-1 q8 sequence kernel
    (mirrors ``smem_bytes_seq_q8`` in the CUDA source): the layer's int8
    rows padded to an odd number of words, scales, b, h, the v1 z gate, two
    quantized activation rows and the step mask."""
    H3 = 3 * H
    nw = (H + 3) // 4
    return 4 * (H3 * (nw | 1) + 2 * H3 + 2 * bt * H + 2 * bt * nw + 2 * bt)


def gru_sequence_q8_kernel(h0: torch.Tensor, x_proj: torch.Tensor,
                           u_q: torch.Tensor, u_eff: torch.Tensor,
                           b: torch.Tensor,
                           mask: Optional[torch.Tensor] = None, *,
                           variant: str = "v1") -> torch.Tensor:
    """Depth-1 q8 GRU over T steps on one layer's int8 weight rows -> all
    hidden states (T,B,H) float32."""
    if x_proj.dim() != 3:
        raise ValueError(f"x_proj: expected (T,B,3H), got {tuple(x_proj.shape)}")
    T, B, H3 = x_proj.shape
    H = H3 // 3
    dev = x_proj.device
    check_q8_width(H, dev)
    bt = _launch.batch_tile(variant, B, T, H, 1, 0, dev,
                            lambda _L, H, bt: smem_bytes_seq_q8(H, bt))
    _check("h0", h0, (B, H), dev)
    _check("x_proj", x_proj, (T, B, 3 * H), dev)
    _check("u_q", u_q, (3 * H, H), dev, torch.int8)
    _check("u_eff", u_eff, (3 * H,), dev)
    _check("b", b, (3 * H,), dev)
    if mask is not None:
        _check("mask", mask, (T, B), dev)
    if dev.type == "cpu":
        return ref.gru_sequence_q8_ref(h0, x_proj, u_q, u_eff, b, mask,
                                       variant)
    out = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    err = _launcher("gru_sequence_q8_launch")(
        _ptr(h0), _ptr(x_proj), _ptr(u_q), _ptr(u_eff), _ptr(b), _ptr(mask),
        _ptr(out), T, B, H, int(variant == "v3"), bt, _stream(dev))
    _raise_on(err, "gru_sequence_q8_kernel")
    gru_sequence_q8_kernel.launches += 1
    return out


KERNELS = (gru_sequence_kernel, gru_stack_sequence_kernel,
           gru_stack_decode_kernel)
Q8_KERNELS = (gru_stack_sequence_q8_kernel, gru_stack_decode_q8_kernel)
CHAIN_Q8_KERNELS = (gru_sequence_q8_kernel, gru_step_q8)
ATTN_KERNELS = (flash_attention, flash_decode)


def reset_launch_counts() -> None:
    """Set every wrapper's ``launches`` counter (fp32, fused q8, chain q8,
    the sLSTM's :data:`SLSTM_KERNELS` and the dense LM's
    :data:`ATTN_KERNELS`) to 0."""
    for fn in (KERNELS + Q8_KERNELS + CHAIN_Q8_KERNELS + SLSTM_KERNELS
               + ATTN_KERNELS):
        fn.launches = 0


reset_launch_counts()
