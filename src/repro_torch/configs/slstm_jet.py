"""sLSTM twin of the paper's jet-tagging model (``slstm-jet``: H=20, X=5,
5 classes).

Same shapes and serving regime as ``gru-jet``, with the cell family
switched to the exponential-gated sLSTM (``repro_torch.core.slstm``): the
per-layer weights are ``(X, 4H)`` / ``(H, 4H)`` instead of the GRU's 3H
gate columns, and each layer carries four state leaves.
"""
from repro_torch.configs.base import GRUConfig, ModelConfig

CONFIG = ModelConfig(
    name="slstm-jet",
    family="slstm",
    gru=GRUConfig(family="slstm", input_dim=5, hidden_dim=20, num_classes=5,
                  matvec_mode="rowwise", fused_gates=True, decoupled_wx=True),
    vocab_size=5,             # JAX's value: it seeds the data stream
    dtype="float32",
    param_dtype="float32",
)


def scaled(hidden: int = 32, input_dim: int = 32, **kw) -> ModelConfig:
    """A wider sLSTM stack of the same family (the latency sweeps' variant)."""
    return CONFIG.replace(gru=GRUConfig(
        family="slstm", input_dim=input_dim, hidden_dim=hidden,
        num_classes=5, **kw))


SMOKE = CONFIG  # already CPU-sized
