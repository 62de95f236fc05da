"""Input-shape cells, their skip rule and the (arch x shape) matrix
(counterpart of ``repro.configs.shapes``)."""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

from repro_torch.configs.base import (ASSIGNED_ARCHS, ModelConfig,
                                      ShapeConfig, get_config)

SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}

# The paper's own model gets its own cells (not part of the assigned ones).
GRU_SHAPES = {
    "jet_t20": ShapeConfig("jet_t20", seq_len=20, global_batch=1, kind="decode"),
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "long_500k": SHAPES["long_500k"],
}


def shape_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Assignment rules: long_500k only for sub-quadratic archs; decode only
    for archs with a decode step (all ported archs have one)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return "full-attention arch: 500k decode is quadratic-cost; skipped per assignment"
    return None


def cells(include_gru: bool = True
          ) -> Iterator[Tuple[str, ShapeConfig, Optional[str]]]:
    """Yield (arch, shape, skip_reason) for the full assigned matrix, in
    JAX's order: the assigned archs by every shape, then gru-jet's cells."""
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            yield arch, shape, shape_skip_reason(cfg, shape)
    if include_gru:
        for shape in GRU_SHAPES.values():
            yield "gru-jet", shape, None
