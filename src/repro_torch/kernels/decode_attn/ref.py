"""Plain PyTorch versions of the flash-decode kernel (counterpart of
``repro.kernels.decode_attn.ref``).

* :func:`flash_decode_ref` — the naive oracle, copied from JAX: a softmax
  over the whole cache with invalid slots at -1e30. On a fully masked
  cache it gives the uniform mean of v (the TPU kernel gives 0 there).
* :func:`flash_decode_plain` — the kernel's plain version: the online
  softmax of ``repro.kernels.decode_attn.kernel._kernel`` over blocks of
  cache slots, fp32 running stats, and 0 for a fully masked cache. The
  wrapper in ``kernel.py`` runs it for CPU tensors; the tests and
  ``chip_smoke.py`` hold the CUDA kernel against it.

q is ``(B, Hkv, G, D)``, the caches ``(B, Hkv, C, D)``, the mask ``(C,)``
(nonzero = valid slot).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_decode_ref(q, k_cache, v_cache, mask):
    """q: (B,Hkv,G,D); cache: (B,Hkv,C,D); mask: (C,) -> (B,Hkv,G,D) fp32."""
    D = q.shape[-1]
    s = torch.einsum("bhgd,bhcd->bhgc", q.float(), k_cache.float()) / (D ** 0.5)
    s = torch.where(mask[None, None, None, :] != 0, s,
                    torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgc,bhcd->bhgd", w, v_cache.float())


def flash_decode_plain(q, k_cache, v_cache, mask, block_c: int = 64):
    """The online softmax over blocks of ``block_c`` slots -> (B,Hkv,G,D)
    fp32."""
    B, Hkv, G, D = q.shape
    C = k_cache.shape[2]
    qf = q.float() * (1.0 / (D ** 0.5))
    valid = mask != 0
    m = torch.full((B, Hkv, G, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, 1), device=q.device)
    acc = torch.zeros((B, Hkv, G, D), device=q.device)
    for c0 in range(0, C, block_c):
        c1 = min(c0 + block_c, C)
        ok = valid[c0:c1]
        s = torch.einsum("bhgd,bhcd->bhgc", qf, k_cache[:, :, c0:c1].float())
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(ok, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgc,bhcd->bhgd", p,
                                         v_cache[:, :, c0:c1].float())
        m = m_new
    return acc / torch.where(l == 0.0, torch.ones_like(l), l)
