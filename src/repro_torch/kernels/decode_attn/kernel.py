"""Wrapper of the flash-decode kernel (``repro_torch/csrc/decode_attn.cu``).

Same name and array interface as the Pallas kernel
``repro.kernels.decode_attn.kernel.flash_decode``: q ``(B, Hkv, G, D)``
and the caches ``(B, Hkv, C, D)``, float32 or bfloat16 (all three alike),
contiguous, ``G <= 16``, ``D <= 128``, any C; ``mask`` ``(C,)`` bool or
uint8 (nonzero = valid slot), read by the kernel as bytes. Returns
``(B, Hkv, G, D)`` float32 (the TPU wrapper casts its kernel's output to
float32). The TPU kernel's ``block_c`` is TPU tiling; the CUDA kernel
sweeps the cache in tiles of 64 slots, split over :func:`num_splits`
blocks per (b, kv-head) by the SM count of the card it runs on.

It checks device, dtype, shape and contiguity and raises on anything the
kernel does not take, and checks the block's shared memory
(:func:`smem_bytes`) against the 232,448 bytes a Hopper block may use. For
CPU tensors it returns the plain version (``ref.flash_decode_plain``); for
CUDA tensors it allocates the output (and, with more than one split, the
partials' scratch with ``torch.empty`` and the zeroed per-(b, kv-head)
ticket counters the last split's merge needs), launches the kernel on the
current stream, raises if the launch was refused, and adds one to
``flash_decode.launches``. Nothing falls back from the
card to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels._launch import I, P, SMEM_LIMIT
from repro_torch.kernels._launch import raise_on as _raise_on
from repro_torch.kernels._launch import sm_count
from repro_torch.kernels._launch import stream as _stream
from repro_torch.kernels.decode_attn import ref

MAX_D, MAX_G = 128, 16
BLOCK_C = 64                        # kBC in the CUDA source
STAGES = 3                          # tiles in flight (kStages)
MAX_SPLITS = 64                     # the merge's (m, l) fit shared memory
SM_COUNT = 132                      # streaming multiprocessors of an H100 SXM
DTYPES = (torch.float32, torch.bfloat16)
# q, k, v, mask, out, part, ticket, B, Hkv, G, C, D, splits, scale, bf16,
# stream
_ARGS = [P] * 7 + [I] * 6 + [ctypes.c_float, I, P]


def num_splits(B: int, Hkv: int, C: int, sms: int = SM_COUNT) -> int:
    """Blocks per (b, kv-head) on a card of ``sms`` streaming
    multiprocessors. A cache of at most ``STAGES`` tiles of ``BLOCK_C``
    slots stays in one block, which copies all of it at once (a split
    would add a merge and save no wait). A longer one is split into as
    many runs as fill the SMs once (``B * Hkv * splits <= sms``: a block's
    registers hold one block to an SM, and a second wave of blocks costs
    more than the shorter runs save), never into more splits than tiles
    (every split gets at least one) nor more than ``MAX_SPLITS``."""
    tiles = -(-C // BLOCK_C)
    if tiles <= STAGES:
        return 1
    return max(1, min(tiles, MAX_SPLITS, sms // (B * Hkv)))


def smem_bytes(D: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block (mirrors the CUDA source): a ring
    of three stages of K and V tiles of 64 slots in the input type, rows of
    Dp + V values (V values per 16 bytes, Dp = D rounded up to V); after
    the sweep the same bytes hold the warps' partials."""
    size = dtype.itemsize
    vec = 16 // size
    Dp = -(-D // vec) * vec
    return STAGES * 2 * BLOCK_C * (Dp + vec) * size


@_launch.forward_only
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
    need = smem_bytes(D, q.dtype)
    if need > SMEM_LIMIT:
        raise ValueError(f"D={D} needs {need} bytes of shared memory per "
                         f"block; a Hopper block has {SMEM_LIMIT}")
    if q.device.type == "cpu":
        return ref.flash_decode_plain(q, k_cache, v_cache, mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = torch.empty((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    splits = num_splits(B, Hkv, C, sm_count(q.device))
    part = ticket = None
    if splits > 1:
        part = torch.empty(B * Hkv * splits * G * (D + 2),
                           dtype=torch.float32, device=q.device)
        ticket = torch.zeros(B * Hkv, dtype=torch.int32, device=q.device)
    err = _launch.launcher("decode_attn", "flash_decode_launch", _ARGS)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        mask.data_ptr(), out.data_ptr(), _launch.ptr(part),
        _launch.ptr(ticket), B, Hkv, G, C, D, splits, 1.0 / (D ** 0.5),
        int(q.dtype == torch.bfloat16), _stream(q.device))
    _raise_on(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
