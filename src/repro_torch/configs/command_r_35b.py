"""command-r-35b [dense]: 40L d_model=8192 64H (kv=8) d_ff=22528
vocab=256000 — parallel attn||mlp blocks, LayerNorm, no biases, tied
embeddings [hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    norm="layernorm",
    parallel_block=True,
    tie_embeddings=True,
    rope_theta=7_500_000.0,
)

SMOKE = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=160, vocab_size=256, remat=False)
