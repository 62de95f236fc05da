"""Decoder-only transformer LM: dense and MoE blocks, GQA attention
(counterpart of ``repro.models.transformer``). ``loss_fn`` is the fused
chunked CE (``chunked_ce``: logits one sequence chunk at a time, each
chunk recomputed in the backward pass, so (B, S, V) never materializes)
plus the MoE blocks' load-balance aux, summed over the layers; it trains
on ``attn_impl="chunked"`` or ``"naive"`` (the attention kernels have no
backward).

Blocks are stacked ``(L, ...)`` as in JAX and run as a Python loop over
the layer index; ``cfg.scan_layers`` and ``cfg.remat`` are XLA compile
knobs, accepted and without effect here. The decode step runs the same
loop at every depth: JAX scans it over the layers above 48
(``_decode_step_scanned``), which computes the same numbers. The KV
cache keeps JAX's layout: ``{"layers": {"k", "v": (L, B, Hkv, C, hd),
"slot_pos": (L, C)}, "pos": ()}``, with ``headroom`` empty slots after
the prompt. ``decode_step`` writes the new token's K/V and position into
slot ``pos % C`` IN PLACE (``index_copy_`` on the cache's own storage, no
restacking), so the cache passed in is the cache returned, updated.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.params import Spec, init_params, stack_specs
from repro_torch.distributed.sharding import NO_SHARD, ShardCtx, constrain
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import cdtype


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def block_specs(cfg: ModelConfig) -> dict:
    s = {"ln1": layers.norm_specs(cfg.d_model, cfg.norm),
         "attn": attn_mod.attn_specs(cfg)}
    if not cfg.parallel_block:
        s["ln2"] = layers.norm_specs(cfg.d_model, cfg.norm)
    if cfg.moe is not None:
        s["moe"] = moe_mod.moe_specs(cfg)
    else:
        s["mlp"] = layers.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp,
                                    cfg.mlp_bias)
    return s


def lm_specs(cfg: ModelConfig) -> dict:
    s = {"embed": layers.embed_specs(cfg.vocab_size, cfg.d_model),
         "blocks": stack_specs(block_specs(cfg), cfg.num_layers),
         "final_norm": layers.norm_specs(cfg.d_model, cfg.norm)}
    if not cfg.tie_embeddings:
        s["lm_head"] = Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                            init="fan_in")
    return s


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i``'s view of the stacked ``(L, ...)`` block tree."""
    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    return blocks[i]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _ffn(p: dict, cfg: ModelConfig, h, ctx: ShardCtx):
    """The block's MLP or MoE on h -> (out, aux); aux 0 without experts."""
    if cfg.moe is not None:
        return moe_mod.moe_apply(p["moe"], cfg, h, ctx=ctx)
    return (layers.mlp_apply(p["mlp"], h, cfg.mlp),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _mlp_residual(p: dict, cfg: ModelConfig, x, h, a, ctx: ShardCtx):
    """The block after attention: parallel (x + a + ffn(h)) or sequential
    (x + a, then + ffn(norm(x + a))). Returns (x, aux)."""
    if cfg.parallel_block:
        m, aux = _ffn(p, cfg, h, ctx)
        return x + a + m, aux
    x = x + a
    m, aux = _ffn(p, cfg, layers.norm_apply(p["ln2"], x, cfg.norm), ctx)
    return x + m, aux


def block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, ctx: ShardCtx = NO_SHARD,
                collect_kv: bool = False):
    """One transformer block. Returns (x, aux, kv-or-None)."""
    h = layers.norm_apply(p["ln1"], x, cfg.norm)
    a, kv = attn_mod.attention(p["attn"], cfg, h, ctx=ctx,
                               window=cfg.sliding_window, positions=positions)
    x, aux = _mlp_residual(p, cfg, x, h, a, ctx)
    x = constrain(x, ("batch", "act_seq", "act_embed"), ctx)
    return x, aux, (kv if collect_kv else None)


def hidden_states(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                  ctx: ShardCtx = NO_SHARD, collect_kv: bool = False,
                  inputs_embeds: Optional[torch.Tensor] = None):
    """tokens (B,S) -> (h (B,S,D), aux summed over the layers (fp32
    scalar), per-layer [(k, v)] or None); k and v (B,S,Hkv,hd) in the
    compute dtype, after RoPE. ``inputs_embeds`` (B,S,D) replaces the
    token embedding (the vision-language model's merged patches and
    text)."""
    B, S = tokens.shape
    x = (inputs_embeds if inputs_embeds is not None
         else layers.embed_apply(params["embed"], tokens, cdtype(cfg)))
    x = constrain(x, ("batch", "act_seq", "act_embed"), ctx)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = []
    for i in range(cfg.num_layers):
        x, a, kv = block_apply(layer_params(params["blocks"], i), cfg, x,
                               positions, ctx=ctx, collect_kv=collect_kv)
        aux = aux + a
        kvs.append(kv)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm)
    return x, aux, (kvs if collect_kv else None)


def _unembed_table(params: dict, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"], True
    return params["lm_head"], False


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Full logits (B,S,V) in fp32: smoke tests and small vocabularies."""
    h, _, _ = hidden_states(params, cfg, tokens, ctx=ctx)
    table, tied = _unembed_table(params, cfg)
    return layers.unembed_apply(table, h, tied)


# ---------------------------------------------------------------------------
# loss (fused chunked CE: never materializes (B,S,V))
# ---------------------------------------------------------------------------

def _pick_chunk(S: int, target: int = 512) -> int:
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def _ce_chunk(hb, table, tb, mb, tied: bool):
    """One chunk's (nll sum, mask sum): logits (B,c,V) in fp32, live only
    inside this call."""
    w = table.to(hb.dtype)
    logits = (hb @ w.T if tied else hb @ w).float()
    return (layers.nll(logits, tb) * mb).sum(), mb.sum()


def chunked_ce(h: torch.Tensor, table: torch.Tensor, targets: torch.Tensor,
               mask: Optional[torch.Tensor], tied: bool, chunk: int = 512):
    """Mean CE from final hidden states; logits per sequence chunk,
    rematerialized in the backward pass (``torch.utils.checkpoint``, JAX's
    ``jax.checkpoint`` over its ``lax.scan`` body); the sums accumulate
    chunk by chunk in fp32, in JAX's order."""
    B, S, _ = h.shape
    c = _pick_chunk(S, chunk)
    mf = (mask.float() if mask is not None
          else torch.ones((B, S), dtype=torch.float32, device=h.device))
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    m_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = torch.is_grad_enabled() and (h.requires_grad
                                        or table.requires_grad)
    for i in range(0, S, c):
        args = (h[:, i:i + c], table, targets[:, i:i + c], mf[:, i:i + c],
                tied)
        n, m = (checkpoint(_ce_chunk, *args, use_reentrant=False) if remat
                else _ce_chunk(*args))
        nll_sum = nll_sum + n
        m_sum = m_sum + m
    return nll_sum / torch.clamp(m_sum, min=1.0)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            ctx: ShardCtx = NO_SHARD):
    """batch: {tokens (B,S), targets (B,S), mask optional} -> (ce + aux,
    {"ce", "aux"}); ``aux`` is the MoE layers' load-balance loss summed
    over the layers (0 without experts)."""
    h, aux, _ = hidden_states(params, cfg, batch["tokens"], ctx=ctx)
    table, tied = _unembed_table(params, cfg)
    ce = chunked_ce(h, table, batch["targets"], batch.get("mask"), tied)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

_CAST = ("w", "b", "embed", "lm_head", "wg", "wu", "wd")


def _prepare_leaf(path: tuple, x: torch.Tensor, ct: torch.dtype,
                  dev: torch.device, cfg: ModelConfig,
                  ctx: ShardCtx) -> torch.Tensor:
    """One leaf of :func:`prepare_params`: the weights a dense layer or an
    expert product reads cast to ``ct``, every other leaf kept in its
    dtype; on ``dev`` (``layers.served_leaf``). Under a mesh an expert
    leaf (``moe/wg``, ``wu``, ``wd``) is cut to this rank's block first
    (a copy: the whole leaf is not kept)."""
    if (ctx.mesh is not None and len(path) > 1 and path[-2] == "moe"
            and path[-1] in moe_mod.EXPERT_AXES):
        part = moe_mod.local_experts(path[-1], x, cfg, ctx)
        if part is not x:
            x = part.clone(memory_format=torch.contiguous_format)
    return layers.served_leaf(x, path[-1] in _CAST, ct, dev)


def prepare_params(params: dict, cfg: ModelConfig, device="cuda", *,
                   ctx: ShardCtx = NO_SHARD) -> dict:
    """One-time serving prep: every weight a dense layer reads (``w``,
    ``b``, the embedding table, ``lm_head``) and the experts' ``wg``,
    ``wu``, ``wd`` cast to the compute dtype and put on ``device``; norm
    scales, the router and the shared expert's gate keep the param dtype
    (the norms and the router compute in fp32 from them). Numerically what
    the per-call casts of ``dense_apply`` and the expert products do, done
    once. Under a mesh (``ctx``) each rank keeps only its block of the
    experts (``moe.local_experts``: experts over ``data``, their hidden
    dim over ``model``, JAX's in-specs); every other leaf stays whole."""
    from repro_torch import resolve_device
    from repro_torch.core.params import _map_tree
    dev = resolve_device(device)
    ct = cdtype(cfg)
    return _map_tree(lambda path, x: _prepare_leaf(path, x, ct, dev, cfg,
                                                   ctx), params)


def init_prepared(cfg: ModelConfig, seed: int = 0, device="cuda", *,
                  specs: Optional[dict] = None,
                  ctx: ShardCtx = NO_SHARD) -> dict:
    """``prepare_params(init_params(specs, seed, cfg.param_dtype), cfg,
    device)`` value for value (``specs`` defaults to ``lm_specs(cfg)``),
    built leaf by leaf on the CPU
    (:func:`~repro_torch.core.params.init_params_each`, as many leaves at
    a time as half the host's available memory holds), so neither the host
    nor the card holds the param-dtype tree (qwen2-moe-a2.7b: 60.6 GB in
    fp32, 30.3 GB served in bf16). Under a mesh (``ctx``) the experts are
    cut to this rank's block as each is drawn, as :func:`prepare_params`
    cuts them."""
    from repro_torch import resolve_device
    from repro_torch.core.params import draw_workers, init_params_each
    dev = resolve_device(device)
    ct = cdtype(cfg)
    specs = lm_specs(cfg) if specs is None else specs
    return init_params_each(
        specs, lambda path, x: _prepare_leaf(path, x, ct, dev, cfg, ctx),
        seed, cfg.param_dtype, draw_workers(specs, cfg.param_dtype))


def cache_specs(cfg: ModelConfig, batch: int, capacity: int) -> dict:
    return {"layers": attn_mod.init_cache_specs(cfg, batch, capacity,
                                                layers_axis=cfg.num_layers),
            "pos": Spec((), (), init="zeros", dtype="int32")}


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device="cuda") -> dict:
    """An empty cache: slots marked -1, ``pos = -1`` so the first decode
    writes position 0."""
    c = init_params(cache_specs(cfg, batch, capacity), device=device)
    c["layers"]["slot_pos"] -= 1
    c["pos"] -= 1
    return c


def stack_kv(kvs, C: int):
    """Per-layer (k, v), each (B,S,Hkv,hd), -> the cache's k, v
    (L,B,Hkv,C,hd): the first S slots filled, the rest zero."""
    k0 = kvs[0][0]
    B, S, Hkv, hd = k0.shape
    shape = (len(kvs), B, Hkv, C, hd)
    k = torch.zeros(shape, dtype=k0.dtype, device=k0.device)
    v = torch.zeros(shape, dtype=k0.dtype, device=k0.device)
    for i, (ki, vi) in enumerate(kvs):
        k[i, :, :, :S] = ki.transpose(1, 2)
        v[i, :, :, :S] = vi.transpose(1, 2)
    return k, v


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            ctx: ShardCtx = NO_SHARD,
            inputs_embeds: Optional[torch.Tensor] = None,
            headroom: int = 64):
    """tokens (B,S) -> (last-token logits (B,V) fp32, filled cache).

    ``headroom`` empty slots follow the prompt so decode steps never wrap
    onto it (full-attention semantics); ``inputs_embeds`` as in
    :func:`hidden_states`."""
    B, S = tokens.shape
    h, _, kvs = hidden_states(params, cfg, tokens, ctx=ctx, collect_kv=True,
                              inputs_embeds=inputs_embeds)
    table, tied = _unembed_table(params, cfg)
    logits = layers.unembed_apply(table, h[:, -1], tied)
    L, C, dev = cfg.num_layers, S + headroom, h.device
    cache_k, cache_v = stack_kv(kvs, C)
    slot = torch.full((C,), -1, dtype=torch.int32, device=dev)
    slot[:S] = torch.arange(S, dtype=torch.int32, device=dev)
    cache = {"layers": {"k": cache_k, "v": cache_v,
                        "slot_pos": slot[None].repeat(L, 1)},
             "pos": torch.tensor(S - 1, dtype=torch.int32, device=dev)}
    return logits, cache


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, *, ctx: ShardCtx = NO_SHARD):
    """One decode step, a loop over the layers at every depth (JAX unrolls
    up to 48 layers and scans above; both compute these numbers). tokens
    (B,) -> (logits (B,V) fp32, the cache updated in place)."""
    B = tokens.shape[0]
    pos = cache["pos"] + 1
    x = layers.embed_apply(params["embed"], tokens[:, None], cdtype(cfg))
    lc = cache["layers"]
    positions = pos.reshape(1, 1).expand(B, 1)
    C = lc["k"].shape[3]
    slot = (pos % C).long().reshape(1)
    pos1 = pos.reshape(1)
    for i in range(cfg.num_layers):
        p = layer_params(params["blocks"], i)
        h = layers.norm_apply(p["ln1"], x, cfg.norm)
        q, k_new, v_new = attn_mod._project_qkv(p["attn"], cfg, h, positions)
        k_l, v_l, sp_l = lc["k"][i], lc["v"][i], lc["slot_pos"][i]
        k_l.index_copy_(2, slot, k_new.transpose(1, 2).to(k_l.dtype))
        v_l.index_copy_(2, slot, v_new.transpose(1, 2).to(v_l.dtype))
        sp_l.index_copy_(0, slot, pos1)
        a = attn_mod.decode_attend(p["attn"], cfg, q[:, 0], k_l, v_l, sp_l,
                                   pos, window=cfg.sliding_window)
        x, _ = _mlp_residual(p, cfg, x, h, a, ctx)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm)
    table, tied = _unembed_table(params, cfg)
    logits = layers.unembed_apply(table, x[:, 0], tied)
    return logits, {"layers": lc, "pos": pos}
