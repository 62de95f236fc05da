"""Attention of the dense LM: GQA + RoPE + qk-norm + sliding window, three
implementations (counterpart of ``repro.models.attention``):

* ``naive``   — the dense score matrix (the oracle; small shapes only);
* ``chunked`` — the chunked online softmax over KV blocks (JAX's
  ``xla_flash``), plain PyTorch, fp32 running stats, probabilities
  rounded to the compute dtype before the P.V product as in JAX; a
  sliding-window layer whose S is a multiple of the window and at least
  two windows takes the banded path instead (``_banded_attention``, JAX's
  rule);
* ``cuda``    — the CUDA kernels: flash attention for prefill
  (``repro_torch.kernels.flash_attn``) and flash decode for the decode
  step (``repro_torch.kernels.decode_attn``); on CPU tensors their plain
  versions.

``attention`` takes JAX's ``causal`` (the encoder's and the
cross-attention's ``causal=False``) and ``kv`` (cross-attention: the
encoder's K/V in place of the sequence's own, Sq != Sk); the banded path
serves only causal self-attention, as in JAX.

Decode-step attention runs against a ring-buffer KV cache. Under ``naive``
and ``chunked`` it is JAX's einsum path (fp32 scores from the cache's
dtype, probabilities rounded to the cache's dtype). ``cross=True`` reads a
cache it does not write (the encoder's K/V, projected once at prefill):
every slot with ``slot_pos >= 0`` is valid whatever the position. Under
``cuda`` both modes run the flash-decode kernel on the mask built here.

Not here: the scan-over-layers ``decode_attention`` (JAX uses it only
above 48 layers; the port's decode loops write the ring in place and call
:func:`decode_attend`, which computes its numbers).
``ShardCtx`` and ``constrain`` are the identity on one device; they are
left out of the signatures until the multi-GPU work brings them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.params import Spec
from repro_torch.distributed.sharding import NO_SHARD, ShardCtx, constrain
from repro_torch.models import layers
from repro_torch.models.layers import dense_apply, dense_specs, head_rmsnorm

NEG_INF = -1e30


def attn_specs(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    s = {"wq": dense_specs(d, cfg.num_heads * hd, ("embed", "heads"),
                           cfg.qkv_bias),
         "wk": dense_specs(d, cfg.num_kv_heads * hd, ("embed", "kv_heads"),
                           cfg.qkv_bias),
         "wv": dense_specs(d, cfg.num_kv_heads * hd, ("embed", "kv_heads"),
                           cfg.qkv_bias),
         "wo": dense_specs(cfg.num_heads * hd, d, ("heads", "embed"),
                           cfg.out_bias)}
    if cfg.qk_norm:
        s["q_norm"] = Spec((hd,), ("head_dim",), init="ones")
        s["k_norm"] = Spec((hd,), ("head_dim",), init="ones")
    return s


def project_q(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, rope: bool = True) -> torch.Tensor:
    """x: (B,S,D) -> q (B,S,Hq,Dh), qk-normed and rotated as in JAX."""
    B, S, _ = x.shape
    q = dense_apply(p["wq"], x).reshape(B, S, cfg.num_heads,
                                        cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = head_rmsnorm(p["q_norm"], q)
    if rope and cfg.rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
    return q


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> q (B,S,Hq,Dh), k/v (B,S,Hkv,Dh)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = project_q(p, cfg, x, positions)
    k = dense_apply(p["wk"], x).reshape(B, S, cfg.num_kv_heads, hd)
    v = dense_apply(p["wv"], x).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        k = head_rmsnorm(p["k_norm"], k)
    if cfg.rope:
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# full-sequence attention (prefill)
# ---------------------------------------------------------------------------

def _heads_major(*xs):
    """(B,S,H,D) -> (B,H,S,D) contiguous."""
    return tuple(x.transpose(1, 2).contiguous() for x in xs)


def _naive_attention(q, k, v, causal: bool, window: int) -> torch.Tensor:
    """(B,S,Hq,Dh) layout in, dense scores (oracle path)."""
    from repro_torch.kernels.flash_attn.ref import attention_ref
    o = attention_ref(*_heads_major(q, k, v), causal=causal, window=window)
    return o.transpose(1, 2).to(q.dtype)


def _chunked_attention(q, k, v, causal: bool, window: int,
                       chunk: int) -> torch.Tensor:
    """Chunked online softmax over KV; (B,S,H,D) layout; fp32 running
    stats (JAX's ``_xla_flash``)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    ck = min(chunk, Sk)
    qf = q.reshape(B, Sq, Hkv, G, D).float() * (1.0 / (D ** 0.5))
    # probabilities materialize in the compute dtype, as in JAX
    pdt = q.dtype
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, Sq, Hkv, G), NEG_INF, device=q.device)
    l = torch.zeros((B, Sq, Hkv, G), device=q.device)
    acc = torch.zeros((B, Sq, Hkv, G, D), device=q.device)
    for k0 in range(0, Sk, ck):
        kb, vb = k[:, k0:k0 + ck], v[:, k0:k0 + ck]
        k_pos = torch.arange(k0, k0 + kb.shape[1], device=q.device)[None, :]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb.float())
        mask = torch.ones((Sq, kb.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window > 0:
            mask = mask & (q_pos - k_pos < window)
        mask = mask[None, :, None, None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, torch.zeros_like(p))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        # bf16 x bf16 products are exact in fp32: fp32 accumulation of the
        # rounded operands, as preferred_element_type=float32 in JAX
        acc = acc * alpha[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(pdt).float(), vb.to(pdt).float())
        m = m_new
    o = acc / l[..., None].clamp_min(1e-30)
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def _banded_attention(q, k, v, window: int) -> torch.Tensor:
    """Exact sliding-window attention in O(S * 2W) (JAX's
    ``_banded_attention``): q blocks of width W attend only kv blocks
    (i-1, i), the 2W band that holds every in-window key. (B,S,H,D)
    layout; S a multiple of W."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    W = window
    nb = S // W
    scale = 1.0 / (D ** 0.5)
    qb = q.reshape(B, nb, W, Hkv, G, D)
    kb = k.reshape(B, nb, W, Hkv, D)
    vb = v.reshape(B, nb, W, Hkv, D)
    z = torch.zeros_like(kb[:, :1])
    k2 = torch.cat([torch.cat([z, kb[:, :-1]], 1), kb], 2)   # (B,nb,2W,Hkv,D)
    v2 = torch.cat([torch.cat([z, vb[:, :-1]], 1), vb], 2)
    s = torch.einsum("bnqhgd,bnkhd->bnhgqk", qb.float() * scale,
                     k2.float())                           # (B,nb,Hkv,G,W,2W)
    dev = q.device
    q_pos = torch.arange(W, device=dev)[:, None] + W       # band coordinates
    k_pos = torch.arange(2 * W, device=dev)[None, :]
    band = (q_pos >= k_pos) & (q_pos - k_pos < W)
    blk = torch.arange(nb, device=dev)
    first = (blk == 0)[:, None, None] & (k_pos[None] < W)  # block 0: no left
    mask = band[None] & ~first                             # (nb, W, 2W)
    s = torch.where(mask[None, :, None, None], s, torch.full_like(s, NEG_INF))
    # probabilities rounded to the compute dtype, summed in fp32 (JAX's
    # einsum of the rounded operands)
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    o = torch.einsum("bnhgqk,bnkhd->bnqhgd", p, v2.to(q.dtype).float())
    return o.reshape(B, S, Hq, D).to(q.dtype)


def _cuda_attention(q, k, v, causal: bool, window: int) -> torch.Tensor:
    from repro_torch.kernels.flash_attn import ops as fa_ops
    o = fa_ops.attention(*_heads_major(q, k, v), causal=causal,
                         window=window)
    return o.transpose(1, 2)


def attention(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              ctx: ShardCtx = NO_SHARD, window: int = 0, causal: bool = True,
              positions: Optional[torch.Tensor] = None,
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Full-sequence attention. Returns (out (B,S,D), (k, v) for caching,
    each (B,Sk,Hkv,Dh)). ``kv`` (B,Sk,Hkv,Dh) each replaces the
    sequence's own K/V (cross-attention: only q is projected, without
    RoPE, as JAX's ``rope=kv is None``)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if kv is None:
        q, k, v = _project_qkv(p, cfg, x, positions)
    else:
        q, (k, v) = project_q(p, cfg, x, positions, rope=False), kv
    # TP placement (JAX's): heads over the model axis when they divide it,
    # else the sequence (q rows) over it
    m = ctx.axis_size("model")
    seq_ax = "act_seq" if cfg.num_heads % max(m, 1) == 0 else "act_seq_tp"
    q = constrain(q, ("batch", seq_ax, "act_heads", None), ctx)
    k = constrain(k, ("batch", "act_seq", "act_kv_heads", None), ctx)
    impl = cfg.attn_impl
    if impl == "naive":
        o = _naive_attention(q, k, v, causal, window)
    elif impl == "cuda":
        o = _cuda_attention(q, k, v, causal, window)
    elif impl == "chunked":
        if (window > 0 and causal and kv is None and S % window == 0
                and S >= 2 * window):
            o = _banded_attention(q, k, v, window)         # O(S*2W) exact SWA
        else:
            o = _chunked_attention(q, k, v, causal, window, cfg.attn_chunk)
    else:
        raise ValueError(f"attn_impl {impl!r}: the port's names are "
                         f"'cuda', 'chunked' and 'naive'")
    return dense_apply(p["wo"], o.reshape(B, S, -1)), (k, v)


# ---------------------------------------------------------------------------
# decode-step attention vs a ring-buffer cache
# ---------------------------------------------------------------------------

def init_cache_specs(cfg: ModelConfig, batch: int, capacity: int,
                     layers_axis: int = 0) -> dict:
    """KV ring buffer spec for one layer group. ``slot_pos`` holds the
    absolute position written into each slot (-1 = empty, set by
    ``init_cache``), shared across the batch."""
    hd = cfg.resolved_head_dim
    shape_kv = (batch, cfg.num_kv_heads, capacity, hd)
    axes_kv = ("batch", "kv_heads", "act_kv_seq", None)
    slot = Spec((capacity,), (None,), init="zeros", dtype="int32")
    if layers_axis:
        shape_kv = (layers_axis,) + shape_kv
        axes_kv = ("layers",) + axes_kv
        slot = Spec((layers_axis, capacity), ("layers", None), init="zeros",
                    dtype="int32")
    return {"k": Spec(shape_kv, axes_kv, init="zeros", dtype=cfg.dtype),
            "v": Spec(shape_kv, axes_kv, init="zeros", dtype=cfg.dtype),
            "slot_pos": slot}


def decode_attend(p: dict, cfg: ModelConfig, q: torch.Tensor, k_cache,
                  v_cache, slot_pos, pos, *, window: int = 0,
                  cross: bool = False) -> torch.Tensor:
    """Attend one query token (B, Hq*Dh or (B,Hq,Dh)) against a
    (B,Hkv,C,Dh) cache slice; returns (B,1,D). ``cross``: every written
    slot is valid, whatever ``pos`` (JAX's ``decode_attention(cross=True)``).

    ``attn_impl="cuda"`` runs the flash-decode kernel (scores and
    probabilities never leave the block); the others JAX's einsum path."""
    B = q.shape[0]
    hd = cfg.resolved_head_dim
    G = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(B, cfg.num_kv_heads, G, hd)
    if cfg.attn_impl == "cuda":
        from repro_torch.kernels.decode_attn import ops as da_ops
        o = da_ops.decode_attend_cuda(qg.to(k_cache.dtype), k_cache,
                                      v_cache, slot_pos, pos, window, cross)
        return dense_apply(p["wo"], o.reshape(B, 1, cfg.num_heads * hd)
                           .to(q.dtype))
    from repro_torch.kernels.decode_attn.ops import valid_slots
    valid = valid_slots(slot_pos, pos, window, cross)
    s = torch.einsum("bhgd,bhcd->bhgc", qg.to(k_cache.dtype).float(),
                     k_cache.float()) / (hd ** 0.5)
    s = torch.where(valid[None, None, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgc,bhcd->bhgd", w.to(v_cache.dtype).float(),
                     v_cache.float())
    return dense_apply(p["wo"], o.reshape(B, 1, cfg.num_heads * hd)
                       .to(q.dtype))
