"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) d_ff=1408
vocab=151936, 60 routed experts top-4 + 4 shared (shared ffn 5632)
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. The spec tree pads the experts 60->64
(``models.moe.padded_experts``, as the JAX package does for its expert
mesh axis); the padding experts are masked out of the router."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408, shared_d_ff=5632,
                  norm_topk_prob=False),
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=96,
    vocab_size=256,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, shared_d_ff=64,
                  norm_topk_prob=False),
    remat=False)
