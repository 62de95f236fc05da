"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks [arXiv:2405.04517; unverified]. Alternating m/s pairs (1:1 ratio so
both cell types are exercised; the xLSTM paper sweeps ratios). The blocks
run no attention, so ``attn_impl`` changes nothing here."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                      # blocks integrate their own projections
    vocab_size=50304,
    norm="rmsnorm",
    rope=False,
    xlstm=XLSTMConfig(slstm_layers=(1, 3, 5, 7, 9, 11), proj_factor=2.0,
                      conv_width=4),
)

SMOKE = CONFIG.replace(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, vocab_size=128,
    remat=False)
