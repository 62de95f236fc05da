"""Uniform model API (counterpart of ``repro.models.api``): downstream code
(the serving engine, the trainer, the CLIs) talks to models only through
:func:`get_api`, and builds input batches with :func:`input_specs` and
:func:`concrete_batch`. Families: the recurrent cells (``gru``, ``slstm``),
the transformer LM, dense (``dense``) and mixture-of-experts (``moe``), the
recurrent LMs, the xLSTM (``ssm``) and hymba (``hybrid``), the
encoder-decoder whisper (``audio``) and the vision-language llava
(``vlm``): every family of the JAX package. Whisper's and llava's
``forward`` and ``prefill`` read the whole batch (``frames``, ``patches``
beside the tokens); the serving engine serves neither, as in JAX, so they
are driven through ``prefill`` and ``decode_step``. Each family's
``forward``, ``prefill``, ``decode_step`` and ``loss_fn`` take the
``ctx`` keyword (JAX's ``ShardCtx`` argument), ``NO_SHARD`` by default."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.cells import UnknownCellFamily, is_cell_family
from repro_torch.core.params import Spec, _map_tree, is_spec, torch_dtype
from repro_torch.distributed.sharding import NO_SHARD
from repro_torch.models import (gru_lm, hymba, layers, llava, slstm_lm,
                                transformer, whisper, xlstm)


def _cell_api(mod) -> SimpleNamespace:
    return SimpleNamespace(
        specs=mod.lm_specs,
        prepare_params=mod.prepare_params,         # one-time serving prep
        executable=mod.serve_executable,           # compiled-plan introspection
        forward=mod.forward,
        loss_fn=mod.loss_fn,
        prefill=mod.prefill,
        decode_step=mod.decode_step,
        cache_specs=mod.cache_specs,
        init_cache=mod.init_cache,
    )


def _lm_api(mod, prepare_params, *, tokens: bool) -> SimpleNamespace:
    """An LM family's interface over its module. ``tokens``: the module's
    ``forward`` and ``prefill`` take the token array, so the namespace's
    take the batch and pass ``batch["tokens"]`` (the transformer, the
    xLSTM, hymba); whisper's and llava's take the whole batch (``frames``
    or ``patches`` beside the tokens)."""
    forward, prefill = mod.forward, mod.prefill
    if tokens:
        def forward(p, cfg, batch, *, ctx=NO_SHARD):
            return mod.forward(p, cfg, batch["tokens"], ctx=ctx)

        def prefill(p, cfg, batch, *, ctx=NO_SHARD):
            return mod.prefill(p, cfg, batch["tokens"], ctx=ctx)
    return SimpleNamespace(
        specs=mod.lm_specs,
        prepare_params=prepare_params,              # cast to cdtype once
        init_prepared=mod.init_prepared,            # the same, leaf by leaf
        forward=forward,
        loss_fn=mod.loss_fn,
        prefill=prefill,
        decode_step=mod.decode_step,
        cache_specs=mod.cache_specs,
        init_cache=mod.init_cache,
    )


_FAMS = {"gru": lambda: _cell_api(gru_lm),
         "slstm": lambda: _cell_api(slstm_lm),
         "dense": lambda: _lm_api(transformer, transformer.prepare_params,
                                  tokens=True),
         "moe": lambda: _lm_api(transformer, transformer.prepare_params,
                                tokens=True),
         "ssm": lambda: _lm_api(xlstm, layers.prepare_dense_params,
                                tokens=True),
         "hybrid": lambda: _lm_api(hymba, layers.prepare_dense_params,
                                   tokens=True),
         "audio": lambda: _lm_api(whisper, whisper.prepare_params,
                                  tokens=False),
         "vlm": lambda: _lm_api(llava, llava.prepare_params, tokens=False)}


def get_api(cfg: ModelConfig) -> SimpleNamespace:
    """The family's API; an unknown ``cfg.family`` raises
    :class:`UnknownCellFamily`."""
    if cfg.family not in _FAMS:
        raise UnknownCellFamily(cfg.family, known=set(_FAMS))
    return _FAMS[cfg.family]()


# ---------------------------------------------------------------------------
# input specs and concrete batches
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Spec tree of the model inputs of one (arch x shape) cell.
    kind="train"/"prefill": the full batch; kind="decode": only the new
    token(s) or feature vector (the cache comes from ``cache_specs``)."""
    B, S = shape.global_batch, shape.seq_len
    if is_cell_family(cfg.family):
        g = cfg.gru
        if shape.kind == "decode":
            return {"x": Spec((B, g.input_dim), ("batch", None),
                              dtype=cfg.dtype)}
        return {"features": Spec((B, S, g.input_dim),
                                 ("batch", "act_seq", None), dtype=cfg.dtype),
                "labels": Spec((B,), ("batch",), dtype="int32")}
    get_api(cfg)        # an unknown family raises here
    if shape.kind == "decode":
        return {"tokens": Spec((B,), ("batch",), dtype="int32")}
    batch = {"tokens": Spec((B, S), ("batch", "act_seq"), dtype="int32")}
    if shape.kind == "train":
        batch["targets"] = Spec((B, S), ("batch", "act_seq"), dtype="int32")
    if cfg.family == "audio":
        batch["frames"] = Spec((B, cfg.encoder.num_frames, cfg.d_model),
                               ("batch", None, None), dtype=cfg.dtype)
    if cfg.family == "vlm":
        batch["patches"] = Spec((B, cfg.vision.num_patches,
                                 cfg.vision.embed_dim), ("batch", None, None),
                                dtype=cfg.dtype)
    return batch


def concrete_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                   device="cuda") -> dict:
    """Small deterministic batch on ``device``: the JAX package's numpy
    draws in its order, so both packages get the same values."""
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)

    def make(_path, s):
        if not is_spec(s):
            return s
        dt = torch_dtype(s.dtype or "float32")
        if not dt.is_floating_point:
            hi = (cfg.gru.num_classes if is_cell_family(cfg.family)
                  else cfg.vocab_size)
            return torch.from_numpy(
                rng.integers(0, hi, size=s.shape).astype(np.int32)).to(dev)
        x = torch.from_numpy(rng.normal(size=s.shape).astype(np.float32))
        return x.to(device=dev, dtype=dt)
    return _map_tree(make, _sorted(input_specs(cfg, shape)))


def _sorted(tree: dict) -> dict:
    """The dict with its keys in sorted order: the order JAX's tree_map
    draws the leaves in."""
    return {k: tree[k] for k in sorted(tree)}
