"""Uniform model API (the cell-family part of ``repro.models.api``, for the
GRU and the sLSTM): downstream code (the serving engine, the CLI) talks to
models only through :func:`get_api`."""
from __future__ import annotations

from types import SimpleNamespace

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cells import UnknownCellFamily
from repro_torch.models import gru_lm, slstm_lm


def _api(mod) -> SimpleNamespace:
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


_FAMS = {"gru": gru_lm, "slstm": slstm_lm}


def get_api(cfg: ModelConfig) -> SimpleNamespace:
    """The family's API; an unknown ``cfg.family`` raises
    :class:`UnknownCellFamily`."""
    if cfg.family not in _FAMS:
        raise UnknownCellFamily(cfg.family, known=set(_FAMS))
    return _api(_FAMS[cfg.family])
