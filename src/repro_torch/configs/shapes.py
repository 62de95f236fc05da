"""Input-shape cells and their skip rule (counterpart of
``repro.configs.shapes``). ``cells()``, the (arch x shape) matrix of the
JAX package, iterates the LM zoo's configs, which the port does not have
yet: it comes with them (ROADMAP queue 1, item 8)."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig

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
