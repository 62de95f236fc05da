"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — PARALLEL attention + Mamba heads per layer, sliding-window
attention except 3 global layers (first/middle/last) [arXiv:2411.13676; hf].
Meta-tokens omitted, as in the JAX package. Head dim 64, a group of 5
query heads per kv head, a window of 1024 on 29 of the 32 layers."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=1),
)

SMOKE = CONFIG.replace(num_layers=6, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=256, sliding_window=8,
                       global_attn_layers=(0, 2, 5),
                       ssm=SSMConfig(state_dim=4, conv_width=4, expand=1),
                       remat=False)
