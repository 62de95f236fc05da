"""Hymba: hybrid-head blocks, attention and Mamba SSM heads in PARALLEL
within every layer (arXiv:2411.13676), most layers sliding-window, three
global-attention layers (counterpart of ``repro.models.hymba``; family
``"hybrid"``, config ``hymba-1.5b``).

Simplifications as in the JAX package: meta-tokens are omitted; the two
paths are fused as the mean of per-path RMS-normed outputs.

Layer layout: groups ``g0``, ``swa_a``, ``g1``, ``swa_b``, ``g2`` (for 32
layers [g0][swa x14][g15][swa x15][g31]); the sizes come from the layer
count (``_group_sizes``), not from ``cfg.global_attn_layers``, as in JAX.
Sliding-window groups are stacked ``(n, ...)``; global layers are single
blocks. Under ``attn_impl="cuda"`` prefill runs the flash-attention kernel
with the layer's window and decode the flash-decode kernel against the
layer's ring; under ``"chunked"`` JAX's ``xla_flash`` numbers (the banded
path where its rule applies) and its einsum decode.

Serving. A global layer's KV cache holds the prompt plus 64 empty slots;
a sliding-window layer's is a ring where absolute position p lives in
slot ``p % cap``. ``decode_step`` writes the new token's K/V (and every
layer's SSM state) into the cache IN PLACE and attends through
``attention.decode_attend``. One repair over JAX: a window ring holds
``min(window, S + 64)`` slots after a prompt of S tokens (JAX holds
``min(window, S)``, so after a prompt shorter than the window each
decode step overwrites a key still inside the window, and its decode
departs from its own teacher-forced ``forward``). At S >= window the
ring is JAX's in values and layout. Like the global layers' headroom,
a ring shorter than the window wraps onto the prompt after 64 steps.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.params import Spec, init_params, stack_specs
from repro_torch.distributed.sharding import NO_SHARD, ShardCtx, constrain
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import cdtype
from repro_torch.models.transformer import chunked_ce, layer_params

_GROUPS = ("g0", "swa_a", "g1", "swa_b", "g2")
HEADROOM = 64           # empty KV slots after the prompt (JAX's global layers)


def _group_sizes(cfg: ModelConfig) -> dict:
    L = cfg.num_layers
    mid = L // 2 - 1                        # 15 for 32 layers
    return {"g0": 1, "swa_a": mid - 1, "g1": 1, "swa_b": L - mid - 2, "g2": 1}


def _is_swa(g: str) -> bool:
    return g.startswith("swa")


def block_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "ln1": layers.norm_specs(d, cfg.norm),
        "attn": attn_mod.attn_specs(cfg),
        "ssm": ssm_mod.ssm_specs(cfg),
        "norm_a": layers.norm_specs(d, "rmsnorm"),
        "norm_s": layers.norm_specs(d, "rmsnorm"),
        "ln2": layers.norm_specs(d, cfg.norm),
        "mlp": layers.mlp_specs(d, cfg.d_ff, cfg.mlp),
    }


def lm_specs(cfg: ModelConfig) -> dict:
    sizes = _group_sizes(cfg)
    blocks = {}
    for g in _GROUPS:
        b = block_specs(cfg)
        blocks[g] = stack_specs(b, sizes[g]) if _is_swa(g) else b
    return {
        "embed": layers.embed_specs(cfg.vocab_size, cfg.d_model),
        "blocks": blocks,
        "final_norm": layers.norm_specs(cfg.d_model, cfg.norm),
        "lm_head": Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                        init="fan_in"),
    }


def _layers(params: dict, cfg: ModelConfig):
    """Every layer in order: (group, index in the group or None for a
    global layer, its params, its window)."""
    sizes = _group_sizes(cfg)
    for g in _GROUPS:
        p_g = params["blocks"][g]
        if _is_swa(g):
            for i in range(sizes[g]):
                yield g, i, layer_params(p_g, i), cfg.sliding_window
        else:
            yield g, None, p_g, 0


def _fuse_mlp(p: dict, cfg: ModelConfig, x, a, s):
    x = x + 0.5 * (layers.norm_apply(p["norm_a"], a, "rmsnorm")
                   + layers.norm_apply(p["norm_s"], s, "rmsnorm"))
    return x + layers.mlp_apply(p["mlp"],
                                layers.norm_apply(p["ln2"], x, cfg.norm),
                                cfg.mlp)


def ring(k: torch.Tensor, v: torch.Tensor, window: int, headroom: int = HEADROOM):
    """A layer's decode cache from its prompt K/V (B,S,Hkv,hd): {k, v
    (B,Hkv,C,hd), slot_pos (C,) int32, -1 = empty}. Global (``window``
    0): positions 0..S-1 in slots 0..S-1 and ``headroom`` empty slots.
    Window: C = min(window, S + headroom), the last min(window, S)
    positions p in slot ``p % C``."""
    B, S, Hkv, hd = k.shape
    dev = k.device
    if not window:
        C, keep = S + headroom, S
    else:
        C, keep = min(window, S + headroom), min(window, S)
    pos = torch.arange(S - keep, S, device=dev)
    slots = pos % C
    kc = torch.zeros((B, Hkv, C, hd), dtype=k.dtype, device=dev)
    vc = torch.zeros_like(kc)
    kc[:, :, slots] = k[:, S - keep:].transpose(1, 2)
    vc[:, :, slots] = v[:, S - keep:].transpose(1, 2)
    slot_pos = torch.full((C,), -1, dtype=torch.int32, device=dev)
    slot_pos[slots] = pos.to(torch.int32)
    return {"k": kc, "v": vc, "slot_pos": slot_pos}


def block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, positions, *,
                window: int, ctx: ShardCtx = NO_SHARD,
                collect_cache: bool = False):
    """One hybrid block. Returns x, or (x, this layer's decode cache) with
    ``collect_cache``."""
    h = layers.norm_apply(p["ln1"], x, cfg.norm)
    a, (k, v) = attn_mod.attention(p["attn"], cfg, h, ctx=ctx, window=window,
                                   positions=positions)
    if collect_cache:
        s, ssm_state = ssm_mod.ssm_apply(p["ssm"], cfg, h, return_state=True)
    else:
        s = ssm_mod.ssm_apply(p["ssm"], cfg, h)
    x = constrain(_fuse_mlp(p, cfg, x, a, s), ("batch", "act_seq", "act_embed"), ctx)
    if not collect_cache:
        return x
    return x, {"attn": ring(k, v, window), "ssm": ssm_state}


def hidden_states(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                  ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    B, S = tokens.shape
    x = layers.embed_apply(params["embed"], tokens, cdtype(cfg))
    x = constrain(x, ("batch", "act_seq", "act_embed"), ctx)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    for _g, _i, p, window in _layers(params, cfg):
        x = block_apply(p, cfg, x, positions, window=window, ctx=ctx)
    return layers.norm_apply(params["final_norm"], x, cfg.norm)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Full logits (B,S,V) in fp32 (teacher-forced)."""
    h = hidden_states(params, cfg, tokens, ctx=ctx)
    return layers.unembed_apply(params["lm_head"], h, tied=False)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            ctx: ShardCtx = NO_SHARD):
    """batch: {tokens, targets, mask optional} -> (ce, {"ce", "aux" = 0})."""
    h = hidden_states(params, cfg, batch["tokens"], ctx=ctx)
    ce = chunked_ce(h, params["lm_head"], batch["targets"], batch.get("mask"),
                    tied=False)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                              device=ce.device)}


def init_prepared(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """The served tree: ``layers.prepare_dense_params(init_params(
    lm_specs(cfg), seed, cfg.param_dtype), cfg, device)`` value for value
    (the dense weights, ``embed`` and ``lm_head`` in the compute dtype,
    every other leaf in the param dtype, as the model reads it), built
    leaf by leaf."""
    return layers.init_prepared_dense(lm_specs(cfg), cfg, seed, device)


# --- serving ------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, capacity: int) -> dict:
    """Global layers: ``capacity`` KV slots; window layers: a ring of
    min(window, capacity). Every layer also carries its SSM conv buffer and
    state (O(1) in context)."""
    sizes = _group_sizes(cfg)
    win_cap = min(cfg.sliding_window, capacity)
    out = {}
    for g in _GROUPS:
        cap = win_cap if _is_swa(g) else capacity
        lead = sizes[g] if _is_swa(g) else 0
        out[g] = {"attn": attn_mod.init_cache_specs(cfg, batch, cap,
                                                    layers_axis=lead),
                  "ssm": ssm_mod.ssm_cache_specs(cfg, batch,
                                                 layers_axis=lead)}
    out["pos"] = Spec((), (), init="zeros", dtype="int32")
    return out


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device="cuda") -> dict:
    """An empty cache (JAX's: every slot -1, ``pos`` 0)."""
    c = init_params(cache_specs(cfg, batch, capacity), device=device)
    for g in _GROUPS:
        c[g]["attn"]["slot_pos"] -= 1
    return c


def _layer_cache(cache_g: dict, i):
    """Layer ``i``'s views of a group's cache (the group itself for a
    global layer)."""
    if i is None:
        return cache_g
    return {part: {k: v[i] for k, v in leaves.items()}
            for part, leaves in cache_g.items()}


def _block_decode(p, cfg, x, c, pos, positions, window):
    """One block on one token against its cache views ``c`` (written in
    place: the ring slot ``pos % C`` and the SSM state)."""
    B = x.shape[0]
    h = layers.norm_apply(p["ln1"], x, cfg.norm)
    q, k_new, v_new = attn_mod._project_qkv(p["attn"], cfg, h, positions)
    ca = c["attn"]
    slot = (pos % ca["k"].shape[2]).long().reshape(1)
    ca["k"].index_copy_(2, slot, k_new.transpose(1, 2).to(ca["k"].dtype))
    ca["v"].index_copy_(2, slot, v_new.transpose(1, 2).to(ca["v"].dtype))
    ca["slot_pos"].index_copy_(0, slot, pos.reshape(1).to(torch.int32))
    a = attn_mod.decode_attend(p["attn"], cfg, q[:, 0], ca["k"], ca["v"],
                               ca["slot_pos"], pos, window=window)
    s, ssm_new = ssm_mod.ssm_decode_step(p["ssm"], cfg, h, c["ssm"])
    for key, val in ssm_new.items():
        c["ssm"][key].copy_(val)
    return _fuse_mlp(p, cfg, x, a, s)


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, *, ctx: ShardCtx = NO_SHARD):
    """tokens (B,) -> (logits (B,V) fp32, the cache updated in place)."""
    B = tokens.shape[0]
    pos = cache["pos"] + 1
    positions = pos.reshape(1, 1).expand(B, 1)
    x = layers.embed_apply(params["embed"], tokens[:, None], cdtype(cfg))
    for g, i, p, window in _layers(params, cfg):
        x = _block_decode(p, cfg, x, _layer_cache(cache[g], i), pos,
                          positions, window)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm)
    logits = layers.unembed_apply(params["lm_head"], x[:, 0], tied=False)
    cache["pos"] = pos
    return logits, cache


def _stack_caches(caches):
    return {part: {k: torch.stack([c[part][k] for c in caches], 0)
                   for k in caches[0][part]}
            for part in caches[0]}


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            ctx: ShardCtx = NO_SHARD):
    """Parallel prefill: one full forward that keeps each layer's KV ring
    (:func:`ring`) and SSM state. tokens (B,S) -> (last-token logits (B,V)
    fp32, cache)."""
    B, S = tokens.shape
    x = layers.embed_apply(params["embed"], tokens, cdtype(cfg))
    x = constrain(x, ("batch", "act_seq", "act_embed"), ctx)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    per_group = {g: [] for g in _GROUPS}
    for g, _i, p, window in _layers(params, cfg):
        x, c = block_apply(p, cfg, x, positions, window=window, ctx=ctx,
                           collect_cache=True)
        per_group[g].append(c)
    cache = {g: (_stack_caches(cs) if _is_swa(g) else cs[0])
             for g, cs in per_group.items()}
    cache["pos"] = torch.tensor(S - 1, dtype=torch.int32, device=x.device)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm)
    logits = layers.unembed_apply(params["lm_head"], x[:, -1], tied=False)
    return logits, cache


def prefill_sequential(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                       *, ctx: ShardCtx = NO_SHARD):
    """Baseline per-token prefill through decode steps on a cache of
    capacity S (JAX's: its global layers would wrap onto the prompt at the
    next step, so only its logits are a reference)."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, S, device=tokens.device)
    cache["pos"] -= 1
    for t in range(S):
        logits, cache = decode_step(params, cfg, cache, tokens[:, t],
                                    ctx=ctx)
    return logits, cache
