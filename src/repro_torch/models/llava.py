"""LLaVA-NeXT-style vision-language model (counterpart of
``repro.models.llava``; family ``"vlm"``, config
``llava-next-mistral-7b``): the mistral-7b transformer with a 2-layer GELU
projector. The vision tower and its anyres tiling are a stub, as in the
JAX package: the inputs are precomputed patch embeddings (B, P, vis_dim).
The projected patches take the FIRST P positions of the sequence (and are
masked out of the loss), so a prompt of S tokens keeps its length S, of
which the first P token ids are placeholders.

Prefill runs ``transformer.prefill`` on the merged embeddings (under
``attn_impl="cuda"`` flash attention, one launch a layer); the images
matter only there, so the decode step, the cache and its specs are the
transformer's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import NO_SHARD, ShardCtx
from repro_torch.models import layers, transformer
from repro_torch.models.layers import cdtype, dense_apply, dense_specs
from repro_torch.models.transformer import _unembed_table, chunked_ce


def lm_specs(cfg: ModelConfig) -> dict:
    s = transformer.lm_specs(cfg)
    s["projector"] = {"w1": dense_specs(cfg.vision.embed_dim, cfg.d_model,
                                        ("vis_embed", "embed"), bias=True),
                      "w2": dense_specs(cfg.d_model, cfg.d_model,
                                        ("embed", "embed"), bias=True)}
    return s


def _merged_embeds(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   patches: torch.Tensor) -> torch.Tensor:
    """tokens (B,S) + patches (B,P,vis) -> (B,S,D): the projected patches
    (``w2(gelu(w1(patches)))``, JAX's tanh GELU) in place of the first P
    token positions."""
    S, P = tokens.shape[1], patches.shape[1]
    if S < P:
        raise ValueError(f"llava: a sequence of {S} tokens cannot hold the "
                         f"{P} image patches that replace its first "
                         f"positions (S must be at least P)")
    ct = cdtype(cfg)
    pp = params["projector"]
    proj = dense_apply(pp["w2"], torch.nn.functional.gelu(
        dense_apply(pp["w1"], patches.to(ct)), approximate="tanh"))
    tok = layers.embed_apply(params["embed"], tokens[:, P:], ct)
    return torch.cat([proj, tok], dim=1)


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """batch {tokens (B,S), patches (B,P,vis)} -> logits (B,S,V) fp32."""
    x = _merged_embeds(params, cfg, batch["tokens"], batch["patches"])
    h, _, _ = transformer.hidden_states(params, cfg, batch["tokens"],
                                        ctx=ctx, inputs_embeds=x)
    table, tied = _unembed_table(params, cfg)
    return layers.unembed_apply(table, h, tied)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            ctx: ShardCtx = NO_SHARD):
    """batch {tokens, patches, targets, mask optional} -> (ce + aux, {"ce",
    "aux"}); the image positions are masked out of the CE."""
    tokens, P = batch["tokens"], batch["patches"].shape[1]
    x = _merged_embeds(params, cfg, tokens, batch["patches"])
    h, aux, _ = transformer.hidden_states(params, cfg, tokens, ctx=ctx,
                                          inputs_embeds=x)
    B, S = tokens.shape
    text = (torch.arange(S, device=h.device) >= P).float()[None].expand(B, S)
    mask = batch.get("mask")
    mask = text if mask is None else mask * text
    table, tied = _unembed_table(params, cfg)
    ce = chunked_ce(h, table, batch["targets"], mask, tied)
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(params: dict, cfg: ModelConfig, batch: dict, *,
            ctx: ShardCtx = NO_SHARD):
    """batch {tokens (B,S), patches} -> (last-token logits (B,V) fp32,
    the transformer's cache, with its 64 empty slots after the prompt)."""
    x = _merged_embeds(params, cfg, batch["tokens"], batch["patches"])
    return transformer.prefill(params, cfg, batch["tokens"], ctx=ctx,
                               inputs_embeds=x)


def init_prepared(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """``transformer.prepare_params(init_params(lm_specs(cfg), seed,
    cfg.param_dtype), cfg, device)`` value for value (the projector's
    weights and biases cast with the rest), built leaf by leaf: the fp32
    tree (29 GB at full width) never exists whole."""
    return transformer.init_prepared(cfg, seed, device, specs=lm_specs(cfg))


prepare_params = transformer.prepare_params   # the projector cast too
cache_specs = transformer.cache_specs
init_cache = transformer.init_cache
decode_step = transformer.decode_step      # images only matter at prefill
