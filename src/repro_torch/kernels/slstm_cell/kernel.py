"""Wrappers of the fused sLSTM kernels (``repro_torch/csrc/slstm_cell.cu``).

Same names and array interface as the Pallas kernels in
``repro.kernels.slstm_cell.kernel`` (fp32, gate order [z, i, f, o]):

* :func:`slstm_stack_sequence_kernel` — fused depth-L masked prefill:
  ``c0, n0, m0, h0`` (L,B,H), ``x_proj`` (T,B,4H), ``u`` (L,H,4H),
  ``w_deep`` (L-1,H,4H) ((1,1,4H) for L=1, unused), ``b`` (L,4H),
  optional ``mask`` (T,B) -> ``hs`` (T,B,H) (the last layer's h after
  every step), then ``cT, nT, mT, hT``, each (L,B,H);
* :func:`slstm_stack_decode_kernel` — one token through L layers:
  the four (L,B,H) leaves and ``x_proj`` (B,4H) -> the four new leaves;
  ``batch_block`` rows per block (0 = auto).

Every wrapper checks device, dtype, shapes and contiguity and raises on
anything the kernel does not take (:mod:`repro_torch.kernels._launch`).
For CPU tensors it returns the plain PyTorch version (``ref.py``); for
CUDA tensors it allocates the outputs with ``torch.empty``, launches the
kernel on the current stream, raises if the launch was refused, and adds
one to its ``launches`` counter. Nothing falls back from the card to the
plain version.

The counters form :data:`SLSTM_KERNELS`;
``repro_torch.kernels.gru_sequence.kernel.reset_launch_counts`` zeroes
them with the GRU kernels'. A block takes a tile of
``DEFAULT_BATCH_BLOCK`` rows (at most 256); U, the deep layers' W, b, the
tile's four leaves and two steps of its ``x_proj`` must fit the 227 KB of
shared memory a Hopper block may use.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels._launch import I, P
from repro_torch.kernels._launch import check as _check
from repro_torch.kernels._launch import ptr as _ptr
from repro_torch.kernels._launch import raise_on as _raise_on
from repro_torch.kernels._launch import stream as _stream
from repro_torch.kernels.slstm_cell import ref

_LIBRARY = "slstm_cell"
# c0, n0, m0, h0, xp, u, wd, b, mask, out, cT, nT, mT, hT, T, B, H, L, bt,
# stream
_SEQ_ARGS = [P] * 14 + [I] * 5 + [P]
# c, n, m, h, xp, u, wd, b, co, no, mo, ho, B, H, L, bt, stream
_DEC_ARGS = [P] * 12 + [I] * 4 + [P]
_LEAVES = ("c", "n", "m", "h")


def smem_bytes(L: int, H: int, bt: int) -> int:
    """Dynamic shared memory of one block (mirrors ``smem_bytes`` in the
    CUDA source): U, deep W, b, two steps of the tile's ``x_proj``, h at an
    odd word stride for two step parities, c, n and m, and the
    double-buffered step liveness."""
    H4 = 4 * H
    floats = (L * H * H4 + (L - 1) * H * H4 + L * H4 + 2 * bt * H4
              + 2 * L * bt * (H | 1) + 3 * L * bt * H + 2 * bt)
    return 4 * floats


def _w_deep_shape(L: int, H: int) -> tuple:
    """(L-1,H,4H); a depth-1 stack passes the unused (1,1,4H) placeholder."""
    return (L - 1, H, 4 * H) if L > 1 else (1, 1, 4 * H)


def _check_operands(leaves, u, w_deep, b, L, B, H, dev) -> None:
    for name, leaf in zip(_LEAVES, leaves):
        _check(name, leaf, (L, B, H), dev)
    _check("u", u, (L, H, 4 * H), dev)
    _check("w_deep", w_deep, _w_deep_shape(L, H), dev)
    _check("b", b, (L, 4 * H), dev)


def _empty_leaves(L: int, B: int, H: int, dev) -> tuple:
    return tuple(torch.empty((L, B, H), dtype=torch.float32, device=dev)
                 for _ in _LEAVES)


def slstm_stack_sequence_kernel(c0: torch.Tensor, n0: torch.Tensor,
                                m0: torch.Tensor, h0: torch.Tensor,
                                x_proj: torch.Tensor, u: torch.Tensor,
                                w_deep: torch.Tensor, b: torch.Tensor,
                                mask: Optional[torch.Tensor] = None):
    """Fused depth-L sLSTM over T steps -> (hs (T,B,H), cT, nT, mT, hT);
    False steps of ``mask`` freeze all four leaves of every layer."""
    if x_proj.dim() != 3 or h0.dim() != 3:
        raise ValueError("x_proj (T,B,4H) and h0 (L,B,H) expected, got "
                         f"{tuple(x_proj.shape)} and {tuple(h0.shape)}")
    T, B, _ = x_proj.shape
    L, _, H = h0.shape
    dev = x_proj.device
    bt = _launch.batch_tile(None, B, T, H, L, 0, dev, smem_bytes)
    _check_operands((c0, n0, m0, h0), u, w_deep, b, L, B, H, dev)
    _check("x_proj", x_proj, (T, B, 4 * H), dev)
    if mask is not None:
        _check("mask", mask, (T, B), dev)
    if dev.type == "cpu":
        return ref.slstm_stack_sequence_ref(c0, n0, m0, h0, x_proj, u,
                                            w_deep, b, mask)
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    fin = _empty_leaves(L, B, H, dev)
    err = _launch.launcher(_LIBRARY, "slstm_stack_sequence_launch",
                           _SEQ_ARGS)(
        _ptr(c0), _ptr(n0), _ptr(m0), _ptr(h0), _ptr(x_proj), _ptr(u),
        _ptr(w_deep), _ptr(b), _ptr(mask), _ptr(hs), *map(_ptr, fin), T, B,
        H, L, bt, _stream(dev))
    _raise_on(err, "slstm_stack_sequence_kernel")
    slstm_stack_sequence_kernel.launches += 1
    return (hs,) + fin


def slstm_stack_decode_kernel(c: torch.Tensor, n: torch.Tensor,
                              m: torch.Tensor, h: torch.Tensor,
                              x_proj: torch.Tensor, u: torch.Tensor,
                              w_deep: torch.Tensor, b: torch.Tensor, *,
                              batch_block: int = 0) -> tuple:
    """One token through all L layers -> the four new leaves (L,B,H)."""
    if h.dim() != 3 or x_proj.dim() != 2:
        raise ValueError("h (L,B,H) and x_proj (B,4H) expected, got "
                         f"{tuple(h.shape)} and {tuple(x_proj.shape)}")
    L, B, H = h.shape
    dev = h.device
    bt = _launch.batch_tile(None, B, 1, H, L, batch_block, dev, smem_bytes)
    _check_operands((c, n, m, h), u, w_deep, b, L, B, H, dev)
    _check("x_proj", x_proj, (B, 4 * H), dev)
    if dev.type == "cpu":
        return ref.slstm_stack_decode_ref(c, n, m, h, x_proj, u, w_deep, b)
    out = _empty_leaves(L, B, H, dev)
    err = _launch.launcher(_LIBRARY, "slstm_stack_decode_launch", _DEC_ARGS)(
        _ptr(c), _ptr(n), _ptr(m), _ptr(h), _ptr(x_proj), _ptr(u),
        _ptr(w_deep), _ptr(b), *map(_ptr, out), B, H, L, bt, _stream(dev))
    _raise_on(err, "slstm_stack_decode_kernel")
    slstm_stack_decode_kernel.launches += 1
    return out


SLSTM_KERNELS = (slstm_stack_sequence_kernel, slstm_stack_decode_kernel)
for _fn in SLSTM_KERNELS:
    _fn.launches = 0
