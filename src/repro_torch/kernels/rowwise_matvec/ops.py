"""Public entries of the row-wise and cascade matmuls (counterparts of
``repro.kernels.rowwise_matvec.ops``): :func:`rowwise` and :func:`cascade`
take a 1-D x as one row, and pick their blocks with :func:`auto_blocks`,
JAX's rule kept verbatim (the divisibility contract depends on its
numbers; the CUDA kernels pick their own tiles inside)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.rowwise_matvec.kernel import (cascade_matmul,
                                                       rowwise_matmul)


def auto_blocks(B: int, K: int, N: int, itemsize: int = 4,
                vmem_budget: int = 8 * 1024 * 1024) -> Tuple[int, int, int]:
    """(block_b, block_n, block_k): multiples of 128 where the dim allows,
    sized so the x, w and out blocks fit JAX's 8 MiB VMEM budget."""
    def _align(n):
        for c in (512, 256, 128, 64, 32, 16, 8):
            if n % c == 0 and c <= n:
                return c
        return n
    bn = _align(N)
    bk = _align(K)
    bb = B
    while bb > 8 and (bb * K + K * bn + bb * bn) * itemsize > vmem_budget:
        bb //= 2
    while bn > 128 and (bb * K + K * bn + bb * bn) * itemsize > vmem_budget:
        bn //= 2
    return bb, bn, bk


def rowwise(x: torch.Tensor, w: torch.Tensor, block_n: int = 0) -> torch.Tensor:
    """Output-stationary y = x @ w (the paper's row-wise scheme), in x's
    dtype."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    B, K = x.shape
    _, N = w.shape
    bb, bn, _ = auto_blocks(B, K, N, x.element_size())
    y = rowwise_matmul(x.contiguous(), w.contiguous(), block_b=bb,
                       block_n=block_n or bn)
    return y[0] if squeeze else y


def cascade(x: torch.Tensor, w: torch.Tensor, block_k: int = 0) -> torch.Tensor:
    """Contraction-blocked sequential-accumulation baseline, cast back to
    x's dtype."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    B, K = x.shape
    _, N = w.shape
    bb, bn, bk = auto_blocks(B, K, N, x.element_size())
    y = cascade_matmul(x.contiguous(), w.contiguous(), block_b=bb,
                       block_n=bn, block_k=block_k or bk).to(x.dtype)
    return y[0] if squeeze else y
