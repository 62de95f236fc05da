"""The sLSTM family (``slstm-jet``) behind the model API (counterpart of
``repro.models.slstm_lm``).

The jet-tagging classifier of ``gru_lm`` with the cell family switched to
the exponential-gated sLSTM (``repro_torch.core.slstm``): recurrent stack
plus linear head, served by bucketed masked prefill and fixed-slot decode,
all through the executor with ``cfg.gru.family == "slstm"``. The cache
carries the family's flat state under ``"h"``: four (B, H) leaves per
layer, layer-major ``(c0, n0, m0, h0, c1, ...)``, so the engine's slot
scatter works leaf by leaf as for the GRU's one leaf. The readout is the
last leaf (layer L-1's ``h``). ``loss_fn`` is the GRU classifier's CE.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import runtime
from repro_torch.core import slstm as slstm_core
from repro_torch.core.gru import stack_cell_params
from repro_torch.core.params import Spec
from repro_torch.distributed.sharding import NO_SHARD, ShardCtx, constrain
# family-generic (runtime.prepare and runtime.compile dispatch on
# cfg.gru.family), so the GRU's serve as they are
from repro_torch.models.gru_lm import (_placement, classifier_loss,
                                       prepare_params,  # noqa: F401
                                       serve_executable)


def lm_specs(cfg: ModelConfig) -> dict:
    """sLSTM stack + linear classifier head over the last layer's h."""
    return {
        "cells": slstm_core.slstm_stack_specs(cfg.gru),
        "head": {
            "w": Spec((cfg.gru.resolved_layer_dims[-1], cfg.gru.num_classes),
                      ("hidden", None)),
            "b": Spec((cfg.gru.num_classes,), (None,), init="zeros"),
        },
    }


def _logits(params: dict, h: torch.Tensor) -> torch.Tensor:
    return (h @ params["head"]["w"] + params["head"]["b"]).float()


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """batch: {features (B,T,X)} -> class logits (B,C)."""
    xs = batch["features"]
    state0 = slstm_core.stack_state0(cfg.gru, xs.shape[0], xs.dtype,
                                     xs.device)
    exe = runtime.compile(cfg.gru, batch=xs.shape[0], seq=xs.shape[1],
                          mode="sequence")
    finals, _ = exe.sequence(stack_cell_params(params, cfg.gru), state0, xs)
    return _logits(params, finals[-1])


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            ctx: ShardCtx = NO_SHARD):
    """batch: {features (B,T,X), labels (B,)} -> softmax CE. The forward
    runs whole on every rank (``ctx`` places nothing in it)."""
    return classifier_loss(forward(params, cfg, batch), batch["labels"])


def cache_specs(cfg: ModelConfig, batch: int) -> dict:
    """Recurrent cache: four (B, H) leaves per layer (c, n, m, h) and the
    position. The ``m`` leaf starts at ``slstm.M_INIT``, not zero: build a
    cache with :func:`init_cache` (or ``prefill``), not from these specs."""
    return {
        "h": tuple(Spec((batch, h), ("batch", "act_gates"), init="zeros",
                        dtype="float32")
                   for h in cfg.gru.resolved_layer_dims
                   for _ in range(slstm_core.STATE_LEAVES)),
        "pos": Spec((), (), init="zeros", dtype="int32"),
    }


def init_cache(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    dev = resolve_device(device)
    return {"h": slstm_core.stack_state0(cfg.gru, batch, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                x: torch.Tensor, *, ctx: ShardCtx = NO_SHARD, exe=None):
    """One recurrent step through the stack: x (B,X) features ->
    (class logits, new cache); all four leaves of every layer advance.
    The family has no mesh backend: under a mesh it runs replicated.
    ``exe``: a decode executable to call through (None: ``compile``)."""
    exe = exe or runtime.compile(cfg.gru, batch=x.shape[0], mode="decode",
                                 placement=_placement(ctx))
    state = tuple(constrain(h, ("batch", "act_gates"), ctx)
                  for h in exe.decode(params, cache["h"], x))
    return _logits(params, state[-1]), {"h": state, "pos": cache["pos"] + 1}


def prefill(params: dict, cfg: ModelConfig, batch: dict, *,
            ctx: ShardCtx = NO_SHARD, exe=None):
    """Run the full sequence; return (logits, flat recurrent state).

    ``batch["mask"]`` (B, T) bool, optional: False steps freeze all four
    leaves, stabilizer included, so left-padded bucketed prompts give the
    state of their unpadded originals. ``exe``: a prefill executable to
    call through (None: ``compile``)."""
    xs = batch["features"]
    B = xs.shape[0]
    mask = batch.get("mask")
    state0 = slstm_core.stack_state0(cfg.gru, B, xs.dtype, xs.device)
    exe = exe or runtime.compile(cfg.gru, batch=B, seq=xs.shape[1],
                                 mask=mask is not None, mode="prefill",
                                 placement=_placement(ctx))
    finals = exe.prefill(params, state0, xs, mask=mask)
    cache = {"h": tuple(s.float() for s in finals),
             "pos": torch.tensor(xs.shape[1] - 1, dtype=torch.int32,
                                 device=xs.device)}
    return _logits(params, finals[-1]), cache
