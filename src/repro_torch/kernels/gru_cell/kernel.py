"""Wrapper of the q8 single-step kernel (``repro_torch/csrc/gru_cell_q8.cu``).

Same name and array interface as the Pallas kernel in
``repro.kernels.gru_cell.kernel``:

* :func:`gru_step_q8` — one q8 cell update, h (B,H) float32, x_proj (B,3H)
  float32, u_q (3H,H) int8 weight rows, u_eff (3H,) per-row dequant
  scales, b (3H,) -> (B,H) float32; v1 or v3.

It checks device, dtype, shapes and contiguity and raises on anything the
kernel does not take (:mod:`repro_torch.kernels._launch`). For CPU tensors
it returns the plain PyTorch version (``ref.py``); for CUDA tensors it
allocates the output with ``torch.empty``, launches the kernel on the
current stream, raises if the launch was refused, and adds one to its
``launches`` counter (zeroed by
``repro_torch.kernels.gru_sequence.kernel.reset_launch_counts``, whose
``CHAIN_Q8_KERNELS`` it belongs to). A thread block takes a tile of
:data:`~repro_torch.kernels._launch.DEFAULT_BATCH_BLOCK` rows; the grid is
``ceil(B / tile)`` blocks.

The fp32 single-step kernels of the JAX package (``gru_step_fused``,
``gru_step_blocked``) are not ported: no executor backend reaches them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels._launch import I, P
from repro_torch.kernels.gru_cell import ref

# h, xp, u_q, u_eff, b, out, B, H, v3, bt, stream
_ARGTYPES = [P] * 6 + [I] * 4 + [P]


def smem_bytes_step_q8(H: int, bt: int) -> int:
    """Dynamic shared memory of one block (mirrors ``smem_bytes_step_q8`` in
    the CUDA source): the int8 rows padded to an odd number of 4-byte
    words, scales, b, h, the v1 z gate, two quantized activation rows and
    the rows' liveness."""
    H3 = 3 * H
    nw = (H + 3) // 4
    return 4 * (H3 * (nw | 1) + 2 * H3 + 2 * bt * H + 2 * bt * nw + bt)


def gru_step_q8(h: torch.Tensor, x_proj: torch.Tensor, u_q: torch.Tensor,
                u_eff: torch.Tensor, b: torch.Tensor, *,
                variant: str = "v1") -> torch.Tensor:
    """One q8 GRU step with everything resident -> new state (B,H)."""
    if h.dim() != 2:
        raise ValueError(f"h: expected (B,H), got {tuple(h.shape)}")
    B, H = h.shape
    dev = h.device
    ref.check_q8_width(H, dev)
    bt = _launch.batch_tile(variant, B, 1, H, 1, 0, dev,
                            lambda _L, H, bt: smem_bytes_step_q8(H, bt))
    _launch.check("h", h, (B, H), dev)
    _launch.check("x_proj", x_proj, (B, 3 * H), dev)
    _launch.check("u_q", u_q, (3 * H, H), dev, torch.int8)
    _launch.check("u_eff", u_eff, (3 * H,), dev)
    _launch.check("b", b, (3 * H,), dev)
    if dev.type == "cpu":
        return ref.gru_step_q8_ref(h, x_proj, u_q, u_eff, b, variant)
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    err = _launch.launcher("gru_cell_q8", "gru_step_q8_launch", _ARGTYPES)(
        _launch.ptr(h), _launch.ptr(x_proj), _launch.ptr(u_q),
        _launch.ptr(u_eff), _launch.ptr(b), _launch.ptr(out), B, H,
        int(variant == "v3"), bt, _launch.stream(dev))
    _launch.raise_on(err, "gru_step_q8")
    gru_step_q8.launches += 1
    return out


gru_step_q8.launches = 0
