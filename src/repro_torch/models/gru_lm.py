"""The jet-tagging GRU (``gru-jet``, ``gru-jet-deep``) behind the model API
(counterpart of ``repro.models.gru_lm``).

Forward = the sequence classifier (GRU stack + linear head), and
``loss_fn`` its softmax CE, which trains through autograd on the
``eager`` backend (the kernel backends have no backward). Serving =
one recurrent step through the whole stack per feature vector, the
paper's latency path; the cache carries one hidden state per layer. All
GRU execution goes through the executor (``repro_torch.core.runtime``):
``prefill``/``decode_step`` ask ``compile()`` for the memoized executable
unless the caller passes one (``exe``), and ``serve_executable`` exposes it
so the engine can freeze it, call through it and record which backend
ran. Under a mesh (``ctx=ShardCtx(mesh)``) the mesh becomes the
executable's ``Placement``: every rank serves the same requests SPMD, and
prefill runs the row-wise/cascade split (``cuda_sharded`` under
``"cuda"``) unless pinned otherwise. JAX's sharding constraint on the
states (``constrain``) stands at JAX's point and changes nothing: the
states come back replicated from the split.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import gru as gru_core
from repro_torch.core import runtime
from repro_torch.core.params import Spec, init_params
from repro_torch.distributed.sharding import NO_SHARD, ShardCtx, constrain
from repro_torch.models.layers import nll


def lm_specs(cfg: ModelConfig) -> dict:
    return gru_core.gru_classifier_specs(cfg.gru)


def _logits(params: dict, h: torch.Tensor) -> torch.Tensor:
    return (h @ params["head"]["w"] + params["head"]["b"]).float()


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """batch: {features (B,T,X)} -> class logits (B,C)."""
    return gru_core.gru_classify(params, batch["features"], cfg=cfg.gru)


def classifier_loss(logits: torch.Tensor, labels: torch.Tensor):
    """Softmax CE of class logits (B, C) against labels (B,) -> (loss,
    {"ce", "acc", "aux"}), JAX's metrics of a cell family."""
    logits = logits.float()
    loss = nll(logits, labels).mean()
    acc = (logits.argmax(-1) == labels.long()).float().mean()
    return loss, {"ce": loss, "acc": acc,
                  "aux": torch.zeros((), device=logits.device)}


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            ctx: ShardCtx = NO_SHARD):
    """batch: {features (B,T,X), labels (B,)} -> softmax CE. The forward
    runs whole on every rank (``ctx`` places nothing in it)."""
    return classifier_loss(forward(params, cfg, batch), batch["labels"])


def _placement(ctx: ShardCtx) -> runtime.Placement:
    """The ctx's mesh as an executor Placement (the host if none)."""
    return runtime._as_placement(ctx.mesh)


def prepare_params(params: dict, cfg: ModelConfig, device="cuda", *,
                   ctx: ShardCtx = NO_SHARD, batch: int = None,
                   executables=()) -> dict:
    """One-time serving prep: the cells on ``device`` plus the fused
    kernels' weight stacks (``"stacked_cells"``), so no step restacks, and
    when the config asks for the q8 datapath (``cfg.gru.quant`` or a
    ``*_q8`` pin) the int8 weight views (``"quant_cells"``), so no step
    quantizes weights. Under a mesh, what the serving executable at
    ``batch`` reads (its backends may be priced by a measured table):
    this rank's part of every layer on the mesh's device
    (``"placed_cells"``, with its ``"placement"``) for a mesh backend, the
    full cells on ``device`` only for a replicated one (``cfg.gru.backend
    = "cuda"`` decodes on ``cuda_fused``). ``executables``: also build
    what these executables read (the engine passes the ones a retune
    resolved to, whose backends may read views ``params`` lacks); views
    ``params`` already carries are kept."""
    pl = _placement(ctx)
    if executables:
        sp = params
        for exe in executables:
            sp = exe.prepare(sp, device=device)
    elif pl.is_host:
        sp = runtime.prepare(params, cfg.gru, device=device)
    else:
        sp = runtime.compile(cfg.gru, batch=batch, mask=True,
                             placement=pl).prepare(params, device=device)
    out = {"cells": sp.cells,
           "head": {k: v.to(resolve_device(device))
                    for k, v in params["head"].items()}}
    if sp.stacked is not None:
        out["stacked_cells"] = sp.stacked
    if sp.quant is not None:
        out["quant_cells"] = sp.quant
    if sp.placed is not None:
        out["placed_cells"] = sp.placed
        out["placement"] = sp.placement
    return out


def serve_executable(cfg: ModelConfig, *, batch: int, seq: int = None,
                     masked: bool = False, mode: str = "serve",
                     mesh=None) -> runtime.GRUExecutable:
    """The executable a serving call with these shapes uses (the same
    memoized object ``prefill``/``decode_step`` resolve; the engine
    freezes it and passes it back as ``exe``)."""
    return runtime.compile(cfg.gru, batch=batch, seq=seq, mask=masked,
                           placement=mesh, mode=mode)


def cache_specs(cfg: ModelConfig, batch: int) -> dict:
    """Recurrent cache: one hidden state per layer, plus the position."""
    return {
        "h": tuple(Spec((batch, h), ("batch", "act_gates"), init="zeros",
                        dtype="float32")
                   for h in cfg.gru.resolved_layer_dims),
        "pos": Spec((), (), init="zeros", dtype="int32"),
    }


def init_cache(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    return init_params(cache_specs(cfg, batch), device=device)


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                x: torch.Tensor, *, ctx: ShardCtx = NO_SHARD, exe=None):
    """One recurrent step through the stack: x (B,X) features ->
    (class logits, new cache). ``exe``: a decode executable to call
    through (an engine's frozen one); None resolves it through
    ``compile``."""
    exe = exe or runtime.compile(cfg.gru, batch=x.shape[0], mode="decode",
                                 placement=_placement(ctx))
    hs = exe.decode(params, cache["h"], x)
    hs = tuple(constrain(h, ("batch", "act_gates"), ctx) for h in hs)
    return _logits(params, hs[-1]), {"h": hs, "pos": cache["pos"] + 1}


def prefill(params: dict, cfg: ModelConfig, batch: dict, *,
            ctx: ShardCtx = NO_SHARD, exe=None):
    """Run the full sequence; return (logits, per-layer cache).

    ``batch["mask"]`` (B, T) bool, optional: False steps freeze the
    recurrence, so left-padded bucketed prompts give the state of their
    unpadded originals. ``exe``: a prefill executable to call through (an
    engine's frozen one); None resolves it through ``compile``."""
    xs = batch["features"]
    B = xs.shape[0]
    mask = batch.get("mask")
    h0s = gru_core.stack_h0(cfg.gru, B, xs.dtype, xs.device)
    exe = exe or runtime.compile(cfg.gru, batch=B, seq=xs.shape[1],
                                 mask=mask is not None, mode="prefill",
                                 placement=_placement(ctx))
    finals = exe.prefill(params, h0s, xs, mask=mask)
    cache = {"h": tuple(h.float() for h in finals),
             "pos": torch.tensor(xs.shape[1] - 1, dtype=torch.int32,
                                 device=xs.device)}
    return _logits(params, finals[-1]), cache
