"""Plain PyTorch versions of the flash-attention kernel (counterpart of
``repro.kernels.flash_attn.ref``).

* :func:`attention_ref` — the naive fp32 oracle, copied from JAX: the
  whole score matrix, GQA by repeating the kv heads; a row with no valid
  key gives 0.
* :func:`flash_attention_plain` — the kernel's plain version: the online
  softmax of ``repro.kernels.flash_attn.kernel._attn_kernel`` over blocks
  of keys, with its masks (kv position ``< Sk``; causal ``q >= k``; window
  ``q - k < window``), fp32 running max, denominator and accumulator, and
  the same 0 for a row with no valid key (the ``l == 0 -> 1`` guard).
  The wrapper in ``kernel.py`` runs it for CPU tensors; the tests and
  ``chip_smoke.py`` hold the CUDA kernel against it.

q is ``(B, Hq, Sq, D)``, k and v ``(B, Hkv, Sk, D)`` with ``Hq % Hkv ==
0`` (q-head h reads kv-head ``h // (Hq // Hkv)``); positions count from 0
on both axes, as in the Pallas kernel.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(Sq: int, k0: int, k1: int, causal: bool, window: int,
          device) -> torch.Tensor:
    """(Sq, k1 - k0) validity of the keys k0..k1-1 (all < Sk)."""
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(k0, k1, device=device)[None, :]
    mask = torch.ones((Sq, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window > 0:
        mask = mask & (q_pos - k_pos < window)
    return mask


def attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """q: (B,Hq,Sq,D), k/v: (B,Hkv,Sk,D) -> (B,Hq,Sq,D) fp32, GQA-aware."""
    q, k, v = q.float(), k.float(), v.float()
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    k = k.repeat_interleave(Hq // Hkv, dim=1)
    v = v.repeat_interleave(Hq // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / (D ** 0.5)
    mask = _mask(Sq, 0, Sk, causal, window, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(mask.any(-1, keepdim=True), p, torch.zeros_like(p))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0,
                          block_k: int = 64):
    """The online softmax over blocks of ``block_k`` keys; returns q's
    dtype (fp32 inside)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Hkv, G, Sq, D) * (1.0 / (D ** 0.5))
    kf, vf = k.float(), v.float()
    m = torch.full((B, Hkv, G, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq, 1), device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, D), device=q.device)
    for k0 in range(0, Sk, block_k):
        k1 = min(k0 + block_k, Sk)
        mask = _mask(Sq, k0, k1, causal, window, q.device)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf[:, :, k0:k1])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                         vf[:, :, k0:k1])
        m = m_new
    o = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.reshape(B, Hq, Sq, D).to(q.dtype)

