"""PyTorch port of the recurrent serving path (the paper's GRU and the
sLSTM cell family) and its training path, for one NVIDIA H100.

The package mirrors ``repro`` (the JAX reference) module for module:
``configs/``, ``core/``, ``kernels/``, ``models/``, ``serve/``,
``launch/``, ``data/``, ``optim/``, ``train/``, ``checkpoint/``,
``quant/``, ``distributed/``. It imports ``torch`` and never ``jax``,
and nothing of ``repro``. Its recurrent kernels are hand-written CUDA
C++ for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use.

Entry points default to ``device="cuda"`` and raise when there is no
card; pass ``device="cpu"`` to run the plain PyTorch versions instead.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``"cuda"`` (the default of every entry point) requires a card: with
    none present this raises instead of quietly running on the CPU. The
    CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
