"""Deep jet-tagging stack (``gru-jet-deep``): three GRU layers of H=32 over
the paper's 5-feature input, with mixed per-layer matvec modes (row-wise,
cascade, row-wise)."""
from repro_torch.configs.base import GRUConfig, ModelConfig

CONFIG = ModelConfig(
    name="gru-jet-deep",
    family="gru",
    gru=GRUConfig(input_dim=5, hidden_dim=32, num_classes=5, num_layers=3,
                  layer_matvec_modes=("rowwise", "cascade", "rowwise"),
                  fused_gates=True, decoupled_wx=True),
    vocab_size=5,             # JAX's value: it seeds the data stream
    dtype="float32",
    param_dtype="float32",
)

SMOKE = CONFIG  # already CPU-sized
