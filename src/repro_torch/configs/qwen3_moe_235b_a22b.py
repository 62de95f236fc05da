"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (kv=4) d_ff=1536
vocab=151936, 128 routed experts top-8, qk-norm, head_dim 128
[hf:Qwen/Qwen3-30B-A3B family; hf]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536,
                  norm_topk_prob=True),
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
    head_dim=16, vocab_size=256,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=48, norm_topk_prob=True),
    remat=False)
