"""Wrapper of the flash-decode kernel (``repro_torch/csrc/decode_attn.cu``).

Same name and array interface as the Pallas kernel
``repro.kernels.decode_attn.kernel.flash_decode``: q ``(B, Hkv, G, D)``
and the caches ``(B, Hkv, C, D)``, float32 or bfloat16 (all three alike),
contiguous, ``G <= 16``, ``D <= 128``, any C; ``mask`` ``(C,)`` bool or
uint8 (nonzero = valid slot), read by the kernel as bytes. Returns
``(B, Hkv, G, D)`` float32 (the TPU wrapper casts its kernel's output to
float32). The TPU kernel's ``block_c`` is TPU tiling; the CUDA kernel
sweeps the cache in tiles of 64 slots.

It checks device, dtype, shape and contiguity and raises on anything the
kernel does not take, and checks the block's shared memory
(:func:`smem_bytes`) against the 232,448 bytes a Hopper block may use. For
CPU tensors it returns the plain version (``ref.flash_decode_plain``); for
CUDA tensors it allocates the output with ``torch.empty``, launches the
kernel on the current stream, raises if the launch was refused, and adds
one to ``flash_decode.launches``. Nothing falls back from the card to the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels._launch import I, P, SMEM_LIMIT
from repro_torch.kernels._launch import raise_on as _raise_on
from repro_torch.kernels._launch import stream as _stream
from repro_torch.kernels.decode_attn import ref

MAX_D, MAX_G = 128, 16
BLOCK_C = 64                        # kBC in the CUDA source
DTYPES = (torch.float32, torch.bfloat16)
# q, k, v, mask, out, B, Hkv, G, C, D, scale, bf16, stream
_ARGS = [P] * 5 + [I] * 5 + [ctypes.c_float, I, P]


def smem_bytes(G: int, D: int) -> int:
    """Dynamic shared memory of one block (mirrors the CUDA source): the
    scaled queries, the k tile at D+1 words a row, the v tile, the
    score/P tile and three words of running state per query."""
    return 4 * (G * D + BLOCK_C * (D + 1) + BLOCK_C * D + G * BLOCK_C + 3 * G)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One query group per (b, kv-head) against the cache -> (B,Hkv,G,D)
    float32; a fully masked cache gives 0."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("mask", mask)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError(f"q (B,Hkv,G,D) and caches (B,Hkv,C,D) expected, "
                         f"got {tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, Hkv, G, D = q.shape
    C = k_cache.shape[2]
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes "
                            f"float32 or bfloat16, all three alike")
    if (tuple(k_cache.shape) != (B, Hkv, C, D)
            or tuple(v_cache.shape) != (B, Hkv, C, D)):
        raise ValueError(f"caches {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)} must be (B, Hkv, C, D) with "
                         f"q {tuple(q.shape)}")
    if mask.dtype not in (torch.bool, torch.uint8) or tuple(mask.shape) != (C,):
        raise ValueError(f"mask: expected ({C},) bool or uint8, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if min(B, Hkv, G, D, C) < 1 or G > MAX_G or D > MAX_D:
        raise ValueError(f"G={G} D={D} C={C}: the kernel takes 1 <= G <= "
                         f"{MAX_G}, 1 <= D <= {MAX_D}, C >= 1")
    if smem_bytes(G, D) > SMEM_LIMIT:
        raise ValueError(f"G={G} D={D} needs {smem_bytes(G, D)} bytes of "
                         f"shared memory per block; a Hopper block has "
                         f"{SMEM_LIMIT}")
    if q.device.type == "cpu":
        return ref.flash_decode_plain(q, k_cache, v_cache, mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = torch.empty((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    err = _launch.launcher("decode_attn", "flash_decode_launch", _ARGS)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        mask.data_ptr(), out.data_ptr(), B, Hkv, G, C, D, 1.0 / (D ** 0.5),
        int(q.dtype == torch.bfloat16), _stream(q.device))
    _raise_on(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
