"""Public wrapper of the flash-decode kernel (counterpart of
``repro.kernels.decode_attn.ops``): the shapes the dense LM's
``decode_attend`` uses under ``attn_impl="cuda"``."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn.kernel import flash_decode


def valid_slots(slot_pos: torch.Tensor, pos, window: int = 0,
                cross: bool = False) -> torch.Tensor:
    """(C,) bool: slots written (``slot_pos >= 0``), not after ``pos``, and
    within the window when ``window > 0``; with ``cross`` (a cache the
    step reads and does not write: the encoder's K/V) every written slot,
    whatever ``pos``."""
    valid = slot_pos >= 0
    if cross:
        return valid
    if window > 0:
        valid = valid & (slot_pos > pos - window)
    return valid & (slot_pos <= pos)


def decode_attend_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, slot_pos: torch.Tensor, pos,
                       window: int = 0, cross: bool = False) -> torch.Tensor:
    """q: (B, Hkv, G, D); caches (B, Hkv, C, D); slot_pos (C,) absolute
    positions (-1 empty) -> (B, Hkv, G, D) fp32. The validity mask
    (:func:`valid_slots`) is built here, on the tensors' device, before
    the kernel."""
    return flash_decode(q.contiguous(), k_cache, v_cache,
                        valid_slots(slot_pos, pos, window, cross))
