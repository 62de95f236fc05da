"""Config system for the port: the recurrent stack config and the
recurrent part of the model config, copied from ``repro.configs.base``
(the port imports nothing of ``repro``). One config type serves both cell
families, the GRU and the sLSTM.

Backend preferences are the port's names (see ``repro_torch.core.runtime``):
``"eager"`` (default, the JAX ``"xla"``), ``"cuda"`` (the JAX ``"pallas"``),
an exact backend name such as ``"cuda_fused"`` or ``"cuda_fused_q8"``, or
``"auto"``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class GRUConfig:
    """A depth-L recurrent stack: the paper's GRU, or another cell family.

    Layer 0 consumes ``input_dim``; layer ``l`` consumes the previous
    layer's hidden size. ``layer_matvec_modes`` optionally overrides
    ``matvec_mode`` per layer (GRU). ``family`` names the cell recurrence
    (``repro_torch.core.cells``): ``"gru"`` or ``"slstm"``.
    """
    input_dim: int = 5
    hidden_dim: int = 20
    num_classes: int = 5
    matvec_mode: str = "rowwise"     # "rowwise" | "cascade" | "dense"
    fused_gates: bool = True         # hybrid fused aggregation vs unfused
    decoupled_wx: bool = True        # hoist W.x out of the recurrence
    variant: str = "v1"              # "v1" (paper/Cho) | "v3" (fused-U)
    backend: str = "eager"           # "eager" | "cuda" | "auto" | exact name
    row_block: int = 0               # rows per block (0 = auto)
    num_layers: int = 1              # stack depth (ignored if layer_dims set)
    layer_dims: Tuple[int, ...] = ()     # per-layer hidden sizes; () -> uniform
    layer_matvec_modes: Tuple[str, ...] = ()  # per-layer matvec_mode overrides
    family: str = "gru"
    quant: str = ""                  # "" (f32) | "int8": makes the q8
                                     # backends (cuda_fused_q8,
                                     # cuda_chain_q8) candidates,
                                     # chosen without a pin only when the
                                     # quant accuracy gate is open

    @property
    def resolved_num_layers(self) -> int:
        return len(self.layer_dims) if self.layer_dims else self.num_layers

    @property
    def resolved_layer_dims(self) -> Tuple[int, ...]:
        """Hidden size of every layer, layer 0 first."""
        if self.layer_dims:
            return tuple(self.layer_dims)
        return (self.hidden_dim,) * self.num_layers

    def layer_input_dim(self, layer: int) -> int:
        """Input width of ``layer``: raw features for layer 0, previous
        hidden size above it."""
        if layer == 0:
            return self.input_dim
        return self.resolved_layer_dims[layer - 1]

    def layer_matvec_mode(self, layer: int) -> str:
        if self.layer_matvec_modes:
            return self.layer_matvec_modes[layer]
        return self.matvec_mode


@dataclass(frozen=True)
class ModelConfig:
    """The recurrent-model fields of ``repro.configs.base.ModelConfig``."""
    name: str
    family: str                      # "gru" | "slstm"
    gru: Optional[GRUConfig] = None
    param_dtype: str = "float32"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY = {
    "gru-jet": "gru_jet",
    "gru-jet-deep": "gru_jet_deep",
    "slstm-jet": "slstm_jet",
}

ALL_ARCHS = list(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")
    return mod.CONFIG
