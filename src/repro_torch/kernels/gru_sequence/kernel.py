"""Wrappers of the fused GRU kernels (``repro_torch/csrc/gru_sequence.cu``,
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
  unused), b (L,3H); states and x_proj stay float32.

Every wrapper checks device, dtype (float32; int8 weight rows for q8),
shapes and contiguity and raises on anything the kernel does not take. For CPU tensors it returns
the plain PyTorch version (``ref.py``); for CUDA tensors it allocates the
outputs with ``torch.empty``, launches the kernel on the current stream,
raises if the launch was refused, and adds one to its ``launches``
counter. Nothing falls back from the card to the plain version.

A thread block takes a tile of :data:`DEFAULT_BATCH_BLOCK` batch rows
(the decode kernel's ``batch_block`` sets it, as in the JAX signature);
the grid is ``ceil(B / tile)`` blocks. U, the deep layers' W, b and the
per-layer h of one tile must fit the 227 KB of shared memory a Hopper
block may use.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gru_sequence import ref

SMEM_LIMIT = 232448           # bytes of shared memory one H100 block may use
DEFAULT_BATCH_BLOCK = 4
VARIANTS = ("v1", "v3")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {        # library -> launcher -> argtypes
    "gru_sequence": {
        # h0, xp, u, b, mask, out, T, B, H, v3, bt, stream
        "gru_sequence_launch": [_P] * 6 + [_I] * 5 + [_P],
        # h0, xp, u, wd, b, mask, out, finals, T, B, H, L, v3, bt, stream
        "gru_stack_sequence_launch": [_P] * 8 + [_I] * 6 + [_P],
        # h, xp, u, wd, b, out, B, H, L, v3, bt, stream
        "gru_stack_decode_launch": [_P] * 6 + [_I] * 5 + [_P],
    },
    "gru_sequence_q8": {
        # h0, xp, u_q, u_eff, wd_q, wd_eff, b, mask, out, finals,
        # T, B, H, L, v3, bt, stream
        "gru_stack_sequence_q8_launch": [_P] * 10 + [_I] * 6 + [_P],
        # h, xp, u_q, u_eff, wd_q, wd_eff, b, out, B, H, L, v3, bt, stream
        "gru_stack_decode_q8_launch": [_P] * 8 + [_I] * 5 + [_P],
    },
}
_BOUND = {}


def _bind(library: str) -> None:
    """Load ``library`` (built at first use) and bind its launchers."""
    signatures = _SIGNATURES[library]
    if all(name in _BOUND for name in signatures):
        return
    lib = _build.load(library)
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _BOUND[name] = fn


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


def _check(name: str, t, shape: tuple, device: torch.device,
           dtype: torch.dtype = torch.float32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _common(variant: str, B: int, T: int, H: int, L: int,
            batch_block: int, device: torch.device, smem=smem_bytes) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if B < 1 or T < 1 or H < 1 or L < 1:
        raise ValueError(f"empty problem: B={B} T={T} H={H} L={L}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    bt = batch_block or min(B, DEFAULT_BATCH_BLOCK)
    if bt < 1:
        raise ValueError(f"batch_block {batch_block} < 1")
    need = smem(L, H, bt)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"L={L} H={H} batch_block={bt} needs {need} bytes of shared "
            f"memory per block; a Hopper block has {SMEM_LIMIT}")
    return bt


def _w_deep_shape(L: int, H: int) -> tuple:
    """(L-1,H,3H); a depth-1 stack passes the unused (1,1,3H) placeholder."""
    return (L - 1, H, 3 * H) if L > 1 else (1, 1, 3 * H)


def _stream(device: torch.device) -> int:
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {device} but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


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
    bt = _common(variant, B, T, H, 1, 0, dev)
    _check("h0", h0, (B, H), dev)
    _check("x_proj", x_proj, (T, B, 3 * H), dev)
    _check("u", u, (H, 3 * H), dev)
    _check("b", b, (3 * H,), dev)
    if mask is not None:
        _check("mask", mask, (T, B), dev)
    if dev.type == "cpu":
        return ref.gru_sequence_ref(h0, x_proj, u, b, mask, variant)
    _bind("gru_sequence")
    out = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    err = _BOUND["gru_sequence_launch"](
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
    bt = _common(variant, B, T, H, L, 0, dev)
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
    _bind("gru_sequence")
    out = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    finals = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    err = _BOUND["gru_stack_sequence_launch"](
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
    bt = _common(variant, B, 1, H, L, batch_block, dev)
    _check("h", h, (L, B, H), dev)
    _check("x_proj", x_proj, (B, 3 * H), dev)
    _check("u", u, (L, H, 3 * H), dev)
    _check("w_deep", w_deep, _w_deep_shape(L, H), dev)
    _check("b", b, (L, 3 * H), dev)
    if dev.type == "cpu":
        return ref.gru_stack_decode_ref(h, x_proj, u, w_deep, b, variant)
    _bind("gru_sequence")
    out = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    err = _BOUND["gru_stack_decode_launch"](
        _ptr(h), _ptr(x_proj), _ptr(u), _ptr(w_deep), _ptr(b), _ptr(out),
        B, H, L, int(variant == "v3"), bt, _stream(dev))
    _raise_on(err, "gru_stack_decode_kernel")
    gru_stack_decode_kernel.launches += 1
    return out


def _q8_common(variant: str, B: int, T: int, H: int, L: int,
               batch_block: int, dev: torch.device, u_q, u_eff, wd_q, wd_eff,
               b) -> int:
    """Checks shared by the q8 wrappers; returns the batch tile."""
    if dev.type == "cpu" and H > ref.Q8_EXACT_MAX_H:
        raise ValueError(
            f"H={H}: the plain q8 version sums int8 products in float32, "
            f"exact only for H <= {ref.Q8_EXACT_MAX_H}")
    bt = _common(variant, B, T, H, L, batch_block, dev, smem=smem_bytes_q8)
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
    _bind("gru_sequence_q8")
    out = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    finals = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    err = _BOUND["gru_stack_sequence_q8_launch"](
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
    _bind("gru_sequence_q8")
    out = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    err = _BOUND["gru_stack_decode_q8_launch"](
        _ptr(h), _ptr(x_proj), _ptr(u_q), _ptr(u_eff), _ptr(wd_q),
        _ptr(wd_eff), _ptr(b), _ptr(out), B, H, L, int(variant == "v3"), bt,
        _stream(dev))
    _raise_on(err, "gru_stack_decode_q8_kernel")
    gru_stack_decode_q8_kernel.launches += 1
    return out


KERNELS = (gru_sequence_kernel, gru_stack_sequence_kernel,
           gru_stack_decode_kernel)
Q8_KERNELS = (gru_stack_sequence_q8_kernel, gru_stack_decode_q8_kernel)


def reset_launch_counts() -> None:
    """Set every wrapper's ``launches`` counter (fp32 and q8) to 0."""
    for fn in KERNELS + Q8_KERNELS:
        fn.launches = 0


reset_launch_counts()
