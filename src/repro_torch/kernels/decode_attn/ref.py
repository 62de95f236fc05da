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
* :func:`flash_decode_split_plain` — the CUDA kernel's algorithm: the
  cache cut into runs of whole tiles (:func:`split_bounds`), a partial
  online softmax per run, the partials merged in split order.

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


def _sweep(qf, k_cache, v_cache, valid, c0: int, c1: int, block_c: int):
    """The online softmax over slots [c0, c1) in blocks of ``block_c``:
    (m, l, acc), fp32; m = -1e30 and l = acc = 0 where no slot is valid."""
    B, Hkv, G, D = qf.shape
    m = torch.full((B, Hkv, G, 1), NEG_INF, device=qf.device)
    l = torch.zeros((B, Hkv, G, 1), device=qf.device)
    acc = torch.zeros((B, Hkv, G, D), device=qf.device)
    for b0 in range(c0, c1, block_c):
        b1 = min(b0 + block_c, c1)
        ok = valid[b0:b1]
        s = torch.einsum("bhgd,bhcd->bhgc", qf, k_cache[:, :, b0:b1].float())
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(ok, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgc,bhcd->bhgd", p,
                                         v_cache[:, :, b0:b1].float())
        m = m_new
    return m, l, acc


def flash_decode_plain(q, k_cache, v_cache, mask, block_c: int = 64):
    """The online softmax over blocks of ``block_c`` slots -> (B,Hkv,G,D)
    fp32."""
    qf = q.float() * (1.0 / (q.shape[-1] ** 0.5))
    _, l, acc = _sweep(qf, k_cache, v_cache, mask != 0, 0,
                       k_cache.shape[2], block_c)
    return acc / torch.where(l == 0.0, torch.ones_like(l), l)


def split_bounds(C: int, splits: int, block_c: int = 64):
    """The slot range [c0, c1) of each split: split s takes tiles
    [s*n // splits, (s+1)*n // splits) of the n tiles of ``block_c`` slots
    (at least one each when ``splits`` <= n), as the CUDA kernel does."""
    n = -(-C // block_c)
    if not 1 <= splits <= n:
        raise ValueError(f"splits={splits}: 1 to {n} tiles of {block_c}")
    return [(s * n // splits * block_c,
             min((s + 1) * n // splits * block_c, C)) for s in range(splits)]


def flash_decode_split_plain(q, k_cache, v_cache, mask, splits: int,
                             block_c: int = 64):
    """The split-cache algorithm of the CUDA kernel: each split's online
    softmax over its slots (:func:`split_bounds`) gives a partial (m, l,
    acc); the partials merge in split order,
    ``o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s`` with ``M`` the
    largest m_s. A split without a valid slot merges as nothing; a fully
    masked cache gives 0. -> (B,Hkv,G,D) fp32."""
    qf = q.float() * (1.0 / (q.shape[-1] ** 0.5))
    valid = mask != 0
    parts = [_sweep(qf, k_cache, v_cache, valid, c0, c1, block_c)
             for c0, c1 in split_bounds(k_cache.shape[2], splits, block_c)]
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - M)
        L = L + w * l
        A = A + w * acc
    return A / torch.where(L == 0.0, torch.ones_like(L), L)
