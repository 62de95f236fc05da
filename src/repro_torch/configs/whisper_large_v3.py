"""whisper-large-v3 [audio]: 32L(dec)+32L(enc) d_model=1280 20H (MHA kv=20)
d_ff=5120 vocab=51866 — enc-dec, conv frontend STUB (input_specs provides
precomputed frame embeddings, 1500 frames = 30 s) [arXiv:2212.04356;
unverified]. LayerNorm, GELU, sinusoidal positions, no RoPE. Head dim 64;
the decoder's tied embedding is the unembedding."""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    norm="layernorm",
    mlp="gelu",
    rope=False,
    tie_embeddings=True,
    encoder=EncoderConfig(num_layers=32, num_frames=1500),
)

SMOKE = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                       d_ff=128, vocab_size=256,
                       encoder=EncoderConfig(num_layers=2, num_frames=16),
                       remat=False)
