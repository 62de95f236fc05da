"""Plain PyTorch versions of the row-wise and cascade matmuls (counterparts
of ``repro.kernels.rowwise_matvec.ref``): x (B,K) and w (K,N), float32 or
bfloat16; products and sums in float32 (bf16 inputs widen exactly)."""
from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 dense reference: y = x @ w."""
    return x.to(torch.float32) @ w.to(torch.float32)


def rowwise_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The row-wise kernel's function: fp32 x @ w, rounded once to x's
    dtype."""
    return matmul_ref(x, w).to(x.dtype)


def cascade_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       block_k: int) -> torch.Tensor:
    """The cascade kernel's function: each block of ``block_k`` contraction
    rows gives a finished fp32 partial product, added to an fp32
    accumulator in k order -> (B,N) float32."""
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    y = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                    device=x.device)
    for k0 in range(0, x.shape[1], block_k):
        y = y + xf[:, k0:k0 + block_k] @ wf[k0:k0 + block_k]
    return y
