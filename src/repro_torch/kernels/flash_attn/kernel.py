"""Wrapper of the flash-attention kernel (``repro_torch/csrc/flash_attn.cu``).

Same name and array interface as the Pallas kernel
``repro.kernels.flash_attn.kernel.flash_attention``: q ``(B, Hq, Sq, D)``,
k and v ``(B, Hkv, Sk, D)``, float32 or bfloat16 (all three alike),
contiguous, ``Hq % Hkv == 0``, ``D <= 128``; Sq and Sk take any length.
Returns ``(B, Hq, Sq, D)`` in q's dtype, with fp32 sums. The TPU
kernel's ``block_q``/``block_k`` are TPU tiling; the CUDA source picks its
own tiles: bfloat16 runs on the tensor cores (64 query rows, 64 keys),
float32 on the CUDA cores (32 query rows, 64 keys).

It checks device, dtype, shape and contiguity and raises on anything the
kernel does not take, and checks the block's shared memory
(:func:`smem_bytes`) against the 232,448 bytes a Hopper block may use. For
CPU tensors it returns the plain version
(``ref.flash_attention_plain``); for CUDA tensors it allocates the output
with ``torch.empty``, launches the kernel on the current stream, raises if
the launch was refused, and adds one to ``flash_attention.launches``.
Nothing falls back from the card to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels._launch import I, P, SMEM_LIMIT
from repro_torch.kernels._launch import raise_on as _raise_on
from repro_torch.kernels._launch import stream as _stream
from repro_torch.kernels.flash_attn import ref

MAX_D = 128
BLOCK_Q, BLOCK_K = 32, 64           # the fp32 kernel's kBQ, kBK
DTYPES = (torch.float32, torch.bfloat16)
# q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal, window, scale, bf16, stream
_ARGS = [P] * 4 + [I] * 8 + [ctypes.c_float, I, P]


def smem_bytes(D: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block (mirrors the CUDA source).
    bfloat16: the q tile and a ring of two K and V tiles, each 64 rows of
    64 (D <= 64) or 128 values, and 1024 bytes to align them. float32: the
    scaled q tile and the k tile at Dp + 4 words a row (Dp = D rounded up
    to 4), the v tile at Dp, and the score/P tile at 72 words a row."""
    if dtype == torch.bfloat16:
        return 1024 + 5 * 64 * (64 if D <= 64 else 128) * 2
    Dp = (D + 3) // 4 * 4
    return 4 * ((BLOCK_Q + BLOCK_K) * (Dp + 4) + BLOCK_K * Dp
                + BLOCK_Q * (BLOCK_K + 8))


def check_attention(q, k, v) -> None:
    """Raise on operands the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected 4 dims, got {tuple(t.shape)}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes "
                            f"float32 or bfloat16, all three alike")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if tuple(k.shape) != (B, Hkv, Sk, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, Hkv, Sk, D) with q {tuple(q.shape)}")
    if min(B, Hq, Sq, D, Hkv, Sk) < 1 or Hq % Hkv:
        raise ValueError(f"empty problem or Hq={Hq} not a multiple of "
                         f"Hkv={Hkv}")
    if D > MAX_D:
        raise ValueError(f"head dim {D} > {MAX_D}: the kernel takes at most "
                         f"{MAX_D}")
    need = smem_bytes(D, q.dtype)
    if need > SMEM_LIMIT:
        raise ValueError(f"D={D} needs {need} bytes of shared memory per "
                         f"block; a Hopper block has {SMEM_LIMIT}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


@_launch.forward_only
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Blocked attention with an online softmax -> (B, Hq, Sq, D), q's
    dtype. ``window`` > 0: keys within [i - window + 1, i] of row i (and
    at most i when ``causal``)."""
    check_attention(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_plain(q, k, v, causal, window)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = _launch.launcher("flash_attn", "flash_attention_launch", _ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
        Hkv, Sq, Sk, D, int(bool(causal)), int(window), 1.0 / (D ** 0.5),
        int(q.dtype == torch.bfloat16), _stream(q.device))
    _raise_on(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
