"""Public entry of the q8 single-step kernel (counterpart of
``repro.kernels.gru_cell.ops.gru_step_q8_pallas``): one whole-state
resident step on int8 weight rows. At int8 the (3H,H) rows of the
serving widths fit one block's shared memory many times over, so there
is no blocked variant. The chain backend ``cuda_chain_q8`` runs it once
per layer and decode step."""
from __future__ import annotations

import torch

from repro_torch.kernels.gru_cell.kernel import gru_step_q8


def gru_step_q8_cuda(h: torch.Tensor, x_proj: torch.Tensor,
                     u_q: torch.Tensor, u_eff: torch.Tensor, b: torch.Tensor,
                     variant: str = "v1") -> torch.Tensor:
    """h (B,H), x_proj (B,3H) float32, u_q (3H,H) int8, u_eff (3H,), b
    (3H,) -> the new state (B,H)."""
    return gru_step_q8(h.contiguous(), x_proj.contiguous(), u_q, u_eff,
                       b.contiguous(), variant=variant)
