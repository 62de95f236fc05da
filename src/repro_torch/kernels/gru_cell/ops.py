"""Public entries of the single-step kernels (counterparts of
``repro.kernels.gru_cell.ops``).

:func:`gru_step_cuda` (``gru_step_pallas``) picks ``gru_step_fused`` or
``gru_step_blocked`` by JAX's rule, kept verbatim so that the same shapes
reach the same kernel in both packages: the working set (3H^2 + 7BH) times
u's itemsize against JAX's single-block VMEM budget of 12 MiB (a TPU
figure, kept as the dispatch rule; the CUDA fused kernel streams u and
takes any width), the blocked kernel only where ``block_n`` divides H, and
v3 always fused.

:func:`gru_step_q8_cuda` (``gru_step_q8_pallas``): one whole-state
resident step on int8 weight rows. At int8 the (3H,H) rows of the
serving widths fit one block's shared memory many times over, so there
is no blocked variant. The chain backend ``cuda_chain_q8`` runs it once
per layer and decode step."""
from __future__ import annotations

import torch

from repro_torch.kernels.gru_cell.kernel import (gru_step_blocked,
                                                 gru_step_fused, gru_step_q8)

# JAX's single-block path budget (repro.kernels.gru_cell.ops)
_FUSED_VMEM_BUDGET = 12 * 1024 * 1024


def gru_step_cuda(h: torch.Tensor, x_proj: torch.Tensor, u: torch.Tensor,
                  b: torch.Tensor, variant: str = "v1",
                  block_n: int = 256) -> torch.Tensor:
    """h (B,H), x_proj (B,3H) float32, u (H,3H) float32 or bfloat16, b
    (3H,) -> the new state (B,H) float32."""
    h, x_proj, b = h.contiguous(), x_proj.contiguous(), b.contiguous()
    B, H = h.shape
    working = (3 * H * H + 4 * B * H + 3 * B * H) * u.element_size()
    if working <= _FUSED_VMEM_BUDGET or H % block_n:
        return gru_step_fused(h, x_proj, u, b, variant=variant)
    if variant == "v3":
        # v3's single stacked matvec has no cross-phase dependency; the
        # blocked kernel runs only the paper's math -> fused, as in JAX.
        return gru_step_fused(h, x_proj, u, b, variant=variant)
    return gru_step_blocked(h, x_proj, u, b, block_n=block_n)


def gru_step_q8_cuda(h: torch.Tensor, x_proj: torch.Tensor,
                     u_q: torch.Tensor, u_eff: torch.Tensor, b: torch.Tensor,
                     variant: str = "v1") -> torch.Tensor:
    """h (B,H), x_proj (B,3H) float32, u_q (3H,H) int8, u_eff (3H,), b
    (3H,) -> the new state (B,H)."""
    return gru_step_q8(h.contiguous(), x_proj.contiguous(), u_q, u_eff,
                       b.contiguous(), variant=variant)
