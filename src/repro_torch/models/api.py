"""Uniform model API (the cell-family part of ``repro.models.api``):
downstream code (the serving engine, the CLI) talks to models only through
:func:`get_api`."""
from __future__ import annotations

from types import SimpleNamespace

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cells import UnknownCellFamily
from repro_torch.models import gru_lm


def _gru_api() -> SimpleNamespace:
    return SimpleNamespace(
        specs=gru_lm.lm_specs,
        prepare_params=gru_lm.prepare_params,      # one-time serving prep
        executable=gru_lm.serve_executable,        # compiled-plan introspection
        forward=gru_lm.forward,
        prefill=gru_lm.prefill,
        decode_step=gru_lm.decode_step,
        cache_specs=gru_lm.cache_specs,
        init_cache=gru_lm.init_cache,
    )


_FAMS = {"gru": _gru_api}


def get_api(cfg: ModelConfig) -> SimpleNamespace:
    """The family's API; an unknown ``cfg.family`` raises
    :class:`UnknownCellFamily`."""
    if cfg.family not in _FAMS:
        raise UnknownCellFamily(cfg.family, known=set(_FAMS))
    return _FAMS[cfg.family]()
