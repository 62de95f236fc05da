"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (kv=8) d_ff=14336
vocab=32000 — mistral-7b backbone; anyres vision tiling STUB (input_specs
provides precomputed patch embeddings, base tile 576 x 1024)
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]. Head dim 128, a group
of 4 query heads per kv head; a 2-layer GELU projector maps the patches
into the first 576 positions."""
from repro_torch.configs.base import ModelConfig, VisionStubConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    vision=VisionStubConfig(num_patches=576, embed_dim=1024),
)

SMOKE = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=256,
                       vision=VisionStubConfig(num_patches=8, embed_dim=32),
                       remat=False)
