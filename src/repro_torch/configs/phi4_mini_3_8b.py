"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA, tied embeddings [arXiv:2412.08905; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=256, remat=False)
