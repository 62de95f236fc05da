"""qwen3-0.6b [dense]: 28L d_model=1024 16H (kv=8) d_ff=3072 vocab=151936,
qk-norm, head_dim 128, tied embeddings [hf:Qwen/Qwen3 family; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, head_dim=16, vocab_size=256, remat=False)
