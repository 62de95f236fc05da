"""Plain PyTorch versions of the fused sLSTM kernels, with the kernels'
raw-array interface (fp32, counterpart of ``repro.kernels.slstm_cell.ref``):

* state leaves ``c, n, m, h`` each (L, B, H);
* ``x_proj`` time-major (T, B, 4H) (decode: (B, 4H)), the layer-0 ``W.x``;
* ``u`` (L, H, 4H), ``w_deep`` (L-1, H, 4H) ((1, 1, 4H) for L=1, unused),
  ``b`` (L, 4H); gate order [z, i, f, o];
* ``mask`` (T, B) float, optional, nonzero = live step (the sequence
  only; JAX's ref takes none): a dead step keeps all four leaves of every
  layer, and the next layer consumes the frozen h, as the masked Pallas
  kernel does.

The wrappers in ``kernel.py`` call these for CPU tensors; the tests and
``chip_smoke.py`` hold the CUDA kernels against them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.slstm import slstm_gate_math


def _step(state: list, xp: torch.Tensor, u, w_deep, b,
          keep: Optional[torch.Tensor]) -> None:
    """Advance all L layers one step, in place. ``state``: [c, n, m, h]
    per layer; ``xp`` (B,4H) the layer-0 ``W.x``; ``keep`` (B,1) bool or
    None."""
    L = len(state)
    for l in range(L):
        new = slstm_gate_math(*state[l], xp, u[l], b[l])
        if keep is not None:
            new = tuple(torch.where(keep, a, o) for a, o in zip(new, state[l]))
        state[l] = list(new)
        if l + 1 < L:
            xp = new[3] @ w_deep[l]


def _init(c0, n0, m0, h0) -> list:
    return [[leaf[l] for leaf in (c0, n0, m0, h0)] for l in range(c0.shape[0])]


def _leaves(state: list) -> tuple:
    return tuple(torch.stack([layer[k] for layer in state], 0)
                 for k in range(4))


def slstm_stack_sequence_ref(c0, n0, m0, h0, x_proj, u, w_deep, b,
                             mask: Optional[torch.Tensor] = None):
    """-> (last layer's h after every step (T,B,H), then the four
    per-layer final leaves cT, nT, mT, hT, each (L,B,H))."""
    state = _init(c0, n0, m0, h0)
    out = []
    for t in range(x_proj.shape[0]):
        keep = None if mask is None else (mask[t] != 0)[:, None]
        _step(state, x_proj[t], u, w_deep, b, keep)
        out.append(state[-1][3])
    return (torch.stack(out, 0),) + _leaves(state)


def slstm_stack_decode_ref(c, n, m, h, x_proj, u, w_deep, b):
    """One token: (L,B,H) leaves and x_proj (B,4H) -> the four new
    (L,B,H) leaves."""
    return _leaves(slstm_stack_decode_layers_ref(_init(c, n, m, h), x_proj,
                                                 u, w_deep, b))


def slstm_stack_decode_layers_ref(layers, x_proj, u, w_deep, b) -> tuple:
    """One token on per-layer leaves: L tuples (c, n, m, h) of (B,H) ->
    L tuples of the new ones (the same values as
    :func:`slstm_stack_decode_ref`, without the stacks)."""
    state = [list(layer) for layer in layers]
    _step(state, x_proj, u, w_deep, b, None)
    return tuple(tuple(layer) for layer in state)
