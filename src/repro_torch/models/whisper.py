"""Whisper-style encoder-decoder (counterpart of ``repro.models.whisper``;
family ``"audio"``, config ``whisper-large-v3``). The conv front end is a
stub, as in the JAX package: the inputs are precomputed frame embeddings
(B, F, D), and everything after the convs is here: sinusoidal positions
on both stacks, LayerNorm, GELU, a non-causal encoder and a causal decoder
whose every layer cross-attends to the encoder's output, the tied
embedding as the unembedding.

The cross-attention's K/V are projected once per layer at prefill and read
by every decode step (the encoder-decoder form of the paper's decoupled
``W.x``: input-dependent work hoisted off the sequential decode path).
Blocks are stacked ``(L, ...)`` as in JAX (``enc_blocks``, ``dec_blocks``)
and run as a Python loop over the layer index.

Attention: under ``attn_impl="cuda"`` the encoder's self-attention, the
decoder's causal self-attention and the cross-attention (Sq != Sk) run the
flash-attention kernel at prefill (3 launches a layer pair), and decode's
self- and cross-attention the flash-decode kernel (2 a decoder layer);
under ``"chunked"`` JAX's ``xla_flash`` numbers and its einsum decode.

Serving. The cache is JAX's layout: ``{"self": {"k", "v": (L, B, Hkv, C,
hd), "slot_pos": (L, C)}, "cross": {"k", "v": (L, B, Hkv, F, hd),
"slot_pos": (L, F) = arange(F)}, "pos": ()}``. ``decode_step`` writes the
new token's self K/V into slot ``pos % C`` IN PLACE and reads the cross
cache without writing it. One repair over JAX: ``prefill`` gives the
self ring 64 empty slots after the prompt (``slot_pos = -1``), as
``transformer.prefill`` does. JAX's whisper prefill keeps exactly S slots,
so its first decode step writes slot ``S % S = 0`` over position 0, which
is still inside the causal window, and every later step has lost the
first token: its decode departs from its own teacher-forced ``forward``.
The cross cache is JAX's exactly.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.params import Spec, init_params, stack_specs
from repro_torch.distributed.sharding import NO_SHARD, ShardCtx, constrain
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models.layers import cdtype, dense_apply
from repro_torch.models.transformer import chunked_ce, layer_params, stack_kv

HEADROOM = 64           # empty self-attention slots after the prompt


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(..., S) int -> (..., S, D) float32 sinusoidal embedding, formed in
    float32 as JAX forms it: ``exp(-log(10000) * arange(D/2) / (D/2 - 1))``
    as the frequencies, ``[sin, cos]`` of position times frequency."""
    half = d // 2
    dev = positions.device
    log10k = torch.tensor(math.log(10000.0), dtype=torch.float32, device=dev)
    freqs = torch.exp(-log10k * torch.arange(half, dtype=torch.float32,
                                             device=dev) / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --- specs ----------------------------------------------------------------

def enc_block_specs(cfg: ModelConfig) -> dict:
    return {"ln1": layers.norm_specs(cfg.d_model, cfg.norm),
            "attn": attn_mod.attn_specs(cfg),
            "ln2": layers.norm_specs(cfg.d_model, cfg.norm),
            "mlp": layers.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp)}


def dec_block_specs(cfg: ModelConfig) -> dict:
    return {"ln1": layers.norm_specs(cfg.d_model, cfg.norm),
            "self_attn": attn_mod.attn_specs(cfg),
            "ln_c": layers.norm_specs(cfg.d_model, cfg.norm),
            "cross_attn": attn_mod.attn_specs(cfg),
            "ln2": layers.norm_specs(cfg.d_model, cfg.norm),
            "mlp": layers.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp)}


def lm_specs(cfg: ModelConfig) -> dict:
    return {"embed": layers.embed_specs(cfg.vocab_size, cfg.d_model),  # tied
            "enc_blocks": stack_specs(enc_block_specs(cfg),
                                      cfg.encoder.num_layers),
            "enc_norm": layers.norm_specs(cfg.d_model, cfg.norm),
            "dec_blocks": stack_specs(dec_block_specs(cfg), cfg.num_layers),
            "final_norm": layers.norm_specs(cfg.d_model, cfg.norm)}


# --- forward --------------------------------------------------------------

def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


def _mlp_residual(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x + mlp(norm(x)): the second half of every block."""
    return x + layers.mlp_apply(p["mlp"],
                                layers.norm_apply(p["ln2"], x, cfg.norm),
                                cfg.mlp)


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor, *,
           ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """frames (B,F,D) precomputed post-conv embeddings -> (B,F,D)."""
    B, F, _ = frames.shape
    ct = cdtype(cfg)
    x = frames.to(ct) + sinusoid(torch.arange(F, device=frames.device),
                                 cfg.d_model)[None].to(ct)
    x = constrain(x, ("batch", "act_seq", "act_embed"), ctx)
    positions = _positions(B, F, x.device)
    for i in range(cfg.encoder.num_layers):
        p = layer_params(params["enc_blocks"], i)
        a, _ = attn_mod.attention(p["attn"], cfg,
                                  layers.norm_apply(p["ln1"], x, cfg.norm),
                                  ctx=ctx, causal=False, positions=positions)
        x = constrain(_mlp_residual(p, cfg, x + a), ("batch", "act_seq", "act_embed"), ctx)
    return layers.norm_apply(params["enc_norm"], x, cfg.norm)


def _cross_kv(p_attn: dict, cfg: ModelConfig, enc_out: torch.Tensor):
    """The encoder output projected to one layer's cross K/V, each
    (B,F,Hkv,hd): once per prefill (the decoupled path)."""
    B, F, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = dense_apply(p_attn["wk"], enc_out).reshape(B, F, cfg.num_kv_heads, hd)
    v = dense_apply(p_attn["wv"], enc_out).reshape(B, F, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        k = layers.head_rmsnorm(p_attn["k_norm"], k)
    return k, v


def dec_block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    enc_out: torch.Tensor, positions: torch.Tensor, *,
                    ctx: ShardCtx = NO_SHARD):
    """One decoder block -> (x, self (k, v), cross (k, v))."""
    a, kv = attn_mod.attention(p["self_attn"], cfg,
                               layers.norm_apply(p["ln1"], x, cfg.norm),
                               ctx=ctx, causal=True, positions=positions)
    x = x + a
    ckv = _cross_kv(p["cross_attn"], cfg, enc_out)
    c, _ = attn_mod.attention(p["cross_attn"], cfg,
                              layers.norm_apply(p["ln_c"], x, cfg.norm),
                              ctx=ctx, causal=False, positions=positions,
                              kv=ckv)
    x = constrain(_mlp_residual(p, cfg, x + c), ("batch", "act_seq", "act_embed"), ctx)
    return x, kv, ckv


def decode_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  enc_out: torch.Tensor, *, ctx: ShardCtx = NO_SHARD):
    """tokens (B,S) against the encoder's output -> (h (B,S,D), per-layer
    self [(k, v)], per-layer cross [(k, v)])."""
    B, S = tokens.shape
    x = layers.embed_apply(params["embed"], tokens, cdtype(cfg))
    x = x + sinusoid(torch.arange(S, device=x.device),
                     cfg.d_model)[None].to(x.dtype)
    positions = _positions(B, S, x.device)
    kvs, ckvs = [], []
    for i in range(cfg.num_layers):
        x, kv, ckv = dec_block_apply(layer_params(params["dec_blocks"], i),
                                     cfg, x, enc_out, positions, ctx=ctx)
        kvs.append(kv)
        ckvs.append(ckv)
    return layers.norm_apply(params["final_norm"], x, cfg.norm), kvs, ckvs


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """batch {frames (B,F,D), tokens (B,S)} -> logits (B,S,V) fp32
    (teacher-forced)."""
    enc_out = encode(params, cfg, batch["frames"], ctx=ctx)
    h, _, _ = decode_hidden(params, cfg, batch["tokens"], enc_out, ctx=ctx)
    return layers.unembed_apply(params["embed"], h, tied=True)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            ctx: ShardCtx = NO_SHARD):
    """batch {frames, tokens, targets, mask optional} -> (ce, {"ce",
    "aux" = 0}); the tied embedding unembeds (``chunked_ce``)."""
    enc_out = encode(params, cfg, batch["frames"], ctx=ctx)
    h, _, _ = decode_hidden(params, cfg, batch["tokens"], enc_out, ctx=ctx)
    ce = chunked_ce(h, params["embed"], batch["targets"], batch.get("mask"),
                    tied=True)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                              device=ce.device)}


prepare_params = layers.prepare_dense_params   # dense weights, embed cast


def init_prepared(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """The served tree: ``layers.prepare_dense_params(init_params(
    lm_specs(cfg), seed, cfg.param_dtype), cfg, device)`` value for value
    (the dense weights and ``embed`` in the compute dtype, the LayerNorms
    in the param dtype), built leaf by leaf."""
    return layers.init_prepared_dense(lm_specs(cfg), cfg, seed, device)


# --- serving ----------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, capacity: int) -> dict:
    F = cfg.encoder.num_frames
    L = cfg.num_layers
    kv = (L, batch, cfg.num_kv_heads, F, cfg.resolved_head_dim)
    kv_axes = ("layers", "batch", "kv_heads", None, None)
    return {"self": attn_mod.init_cache_specs(cfg, batch, capacity,
                                              layers_axis=L),
            "cross": {"k": Spec(kv, kv_axes, init="zeros", dtype=cfg.dtype),
                      "v": Spec(kv, kv_axes, init="zeros", dtype=cfg.dtype),
                      "slot_pos": Spec((L, F), ("layers", None), init="zeros",
                                       dtype="int32")},
            "pos": Spec((), (), init="zeros", dtype="int32")}


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device="cuda") -> dict:
    """An empty cache, JAX's: self slots -1, the cross slots numbered 0..F-1
    (every frame valid), ``pos`` 0."""
    c = init_params(cache_specs(cfg, batch, capacity), device=device)
    c["self"]["slot_pos"] -= 1
    c["cross"]["slot_pos"] += torch.arange(
        cfg.encoder.num_frames, dtype=torch.int32,
        device=c["cross"]["slot_pos"].device)
    return c


def prefill(params: dict, cfg: ModelConfig, batch: dict, *,
            ctx: ShardCtx = NO_SHARD):
    """batch {frames (B,F,D), tokens (B,S)} -> (last-token logits (B,V)
    fp32, cache). The self ring holds the prompt and ``HEADROOM`` empty
    slots (the repair over JAX, see the module docstring); the cross
    cache holds every layer's encoder K/V."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    F, L = cfg.encoder.num_frames, cfg.num_layers
    enc_out = encode(params, cfg, batch["frames"], ctx=ctx)
    h, kvs, ckvs = decode_hidden(params, cfg, tokens, enc_out, ctx=ctx)
    logits = layers.unembed_apply(params["embed"], h[:, -1], tied=True)
    dev = h.device
    k, v = stack_kv(kvs, S + HEADROOM)
    slot = torch.full((S + HEADROOM,), -1, dtype=torch.int32, device=dev)
    slot[:S] = torch.arange(S, dtype=torch.int32, device=dev)
    ck, cv = stack_kv(ckvs, F)
    cross_slot = torch.arange(F, dtype=torch.int32, device=dev)
    cache = {"self": {"k": k, "v": v, "slot_pos": slot[None].repeat(L, 1)},
             "cross": {"k": ck, "v": cv,
                       "slot_pos": cross_slot[None].repeat(L, 1)},
             "pos": torch.tensor(S - 1, dtype=torch.int32, device=dev)}
    return logits, cache


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, *, ctx: ShardCtx = NO_SHARD):
    """tokens (B,) -> (logits (B,V) fp32, the cache: its self ring updated
    in place, its cross part as it was)."""
    B = tokens.shape[0]
    pos = cache["pos"] + 1
    x = layers.embed_apply(params["embed"], tokens[:, None], cdtype(cfg))
    x = x + sinusoid(pos.reshape(1, 1), cfg.d_model).to(x.dtype)
    positions = pos.reshape(1, 1).expand(B, 1)
    sc, cc = cache["self"], cache["cross"]
    slot = (pos % sc["k"].shape[3]).long().reshape(1)
    for i in range(cfg.num_layers):
        p = layer_params(params["dec_blocks"], i)
        h = layers.norm_apply(p["ln1"], x, cfg.norm)
        q, k_new, v_new = attn_mod._project_qkv(p["self_attn"], cfg, h,
                                                positions)
        k_l, v_l, sp_l = sc["k"][i], sc["v"][i], sc["slot_pos"][i]
        k_l.index_copy_(2, slot, k_new.transpose(1, 2).to(k_l.dtype))
        v_l.index_copy_(2, slot, v_new.transpose(1, 2).to(v_l.dtype))
        sp_l.index_copy_(0, slot, pos.reshape(1).to(torch.int32))
        x = x + attn_mod.decode_attend(p["self_attn"], cfg, q[:, 0], k_l,
                                       v_l, sp_l, pos)
        qc = attn_mod.project_q(p["cross_attn"], cfg,
                                layers.norm_apply(p["ln_c"], x, cfg.norm),
                                positions, rope=False)
        x = x + attn_mod.decode_attend(p["cross_attn"], cfg, qc[:, 0],
                                       cc["k"][i], cc["v"][i],
                                       cc["slot_pos"][i], pos, cross=True)
        x = _mlp_residual(p, cfg, x)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm)
    logits = layers.unembed_apply(params["embed"], x[:, 0], tied=True)
    return logits, {"self": sc, "cross": cc, "pos": pos}
