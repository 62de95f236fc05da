"""Public wrapper of the flash-attention kernel (counterpart of
``repro.kernels.flash_attn.ops``): what the dense LM's prefill calls under
``attn_impl="cuda"``."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn.kernel import flash_attention


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D) -> (B,Hq,Sq,D) in q's dtype; the
    kernel on the card, its plain version on CPU tensors."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window)
