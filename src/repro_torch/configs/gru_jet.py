"""The paper's own model: jet-tagging GRU (H=20, X=5, 5 classes, T=20).

The numerically validated configuration of the paper, fp32 end to end,
batch 1 at serve time: the latency-measurement regime.
"""
from repro_torch.configs.base import GRUConfig, ModelConfig

CONFIG = ModelConfig(
    name="gru-jet",
    family="gru",
    gru=GRUConfig(input_dim=5, hidden_dim=20, num_classes=5,
                  matvec_mode="rowwise", fused_gates=True, decoupled_wx=True),
    vocab_size=5,             # JAX's value: it seeds the data stream
    dtype="float32",
    param_dtype="float32",
)

SMOKE = CONFIG  # already CPU-sized
