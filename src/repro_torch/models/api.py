"""Uniform model API (counterpart of ``repro.models.api``): downstream code
(the serving engine, the CLI) talks to models only through
:func:`get_api`. Families: the recurrent cells (``gru``, ``slstm``) and the
dense transformer LM (``dense``). The other LM families of the JAX package
(``moe``, ``ssm``, ``hybrid``, ``audio``, ``vlm``) raise
``NotImplementedError``; they are ported with the LM zoo (ROADMAP queue 1,
item 8)."""
from __future__ import annotations

from types import SimpleNamespace

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cells import UnknownCellFamily
from repro_torch.models import gru_lm, slstm_lm, transformer


def _cell_api(mod) -> SimpleNamespace:
    return SimpleNamespace(
        specs=mod.lm_specs,
        prepare_params=mod.prepare_params,         # one-time serving prep
        executable=mod.serve_executable,           # compiled-plan introspection
        forward=mod.forward,
        prefill=mod.prefill,
        decode_step=mod.decode_step,
        cache_specs=mod.cache_specs,
        init_cache=mod.init_cache,
    )


def _transformer_api() -> SimpleNamespace:
    return SimpleNamespace(
        specs=transformer.lm_specs,
        prepare_params=transformer.prepare_params,  # cast to cdtype once
        forward=lambda p, cfg, batch: transformer.forward(
            p, cfg, batch["tokens"]),
        prefill=lambda p, cfg, batch: transformer.prefill(
            p, cfg, batch["tokens"]),
        decode_step=transformer.decode_step,
        cache_specs=transformer.cache_specs,
        init_cache=transformer.init_cache,
    )


_FAMS = {"gru": lambda: _cell_api(gru_lm),
         "slstm": lambda: _cell_api(slstm_lm),
         "dense": _transformer_api}
_NOT_PORTED = ("moe", "ssm", "hybrid", "audio", "vlm")


def get_api(cfg: ModelConfig) -> SimpleNamespace:
    """The family's API. A JAX LM family not ported yet raises
    ``NotImplementedError``; an unknown ``cfg.family`` raises
    :class:`UnknownCellFamily`."""
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
            f"item 8: the LM zoo); the port serves {sorted(_FAMS)}")
    if cfg.family not in _FAMS:
        raise UnknownCellFamily(cfg.family, known=set(_FAMS))
    return _FAMS[cfg.family]()
