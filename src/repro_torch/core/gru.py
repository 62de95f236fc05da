"""The paper's GRU in eager PyTorch: row-wise vs cascade matvec, decoupled
Wx, fused vs unfused gate aggregation. Counterpart of ``repro.core.gru``;
the eager functions here are the port's ``eager`` backend (the JAX
``xla`` backend).

Gate math (paper eq. 1, "v1"/Cho variant)::

    z = sigmoid(Wz x + Uz h + bz)
    r = sigmoid(Wr x + Ur h + br)
    h~ = tanh(Wh x + Uh (r*h) + bh)
    h' = (1-z)*h + z*h~

``variant="v3"`` is the cuDNN-style ``h~ = tanh(Wh x + r*(Uh h + bh))``,
one stacked U matvec per step. ``matvec_mode`` picks the structural
decomposition of every matvec (``rowwise``: output-stationary blocks of
whole output columns; ``cascade``: contraction blocks accumulated in
sequence; ``dense``: plain ``x @ w``); all three are numerically the dense
product up to summation order.

Masks are (B, T) bool: False steps leave the hidden state untouched
(left-padded, bucketed prompts give the unpadded result). Backend dispatch
lives in ``repro_torch.core.runtime``. The historical entry points
(``gru_sequence``, ``gru_stack_sequence``, ``gru_stack_decode_step``,
``gru_decode_step``) remain as deprecated shims over the executor, as in
the JAX package: equal to it bit for bit, each warning once per process.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import GRUConfig
from repro_torch.core.params import Spec


# ---------------------------------------------------------------------------
# deprecation bookkeeping for the legacy entry points (executor shims)
# ---------------------------------------------------------------------------

_DEPRECATION_WARNED: set = set()


def _warn_deprecated(old: str) -> None:
    """One DeprecationWarning per legacy entry point per process."""
    if old in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(old)
    warnings.warn(
        f"{old} is a deprecated entry point; use "
        "repro_torch.core.runtime.compile() -> GRUExecutable (the "
        "capability-dispatched executor, compile then execute) instead.",
        DeprecationWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def gru_cell_specs(input_dim: int, hidden_dim: int) -> dict:
    """One GRU layer. Gate stacking order along the last axis: [z, r, h]."""
    return {
        "w": Spec((input_dim, 3 * hidden_dim), ("rnn_in", "gates")),
        "u": Spec((hidden_dim, 3 * hidden_dim), ("hidden", "gates"),
                  init="recurrent"),
        "b": Spec((3 * hidden_dim,), ("gates",), init="zeros"),
    }


def gru_stack_specs(cfg: GRUConfig) -> tuple:
    """Per-layer cell specs for a depth-L stack, layer 0 first."""
    return tuple(gru_cell_specs(cfg.layer_input_dim(l), h)
                 for l, h in enumerate(cfg.resolved_layer_dims))


def layer_config(cfg: GRUConfig, layer: int) -> GRUConfig:
    """Specialize a stack config to one layer (depth-1 view)."""
    return dataclasses.replace(
        cfg,
        input_dim=cfg.layer_input_dim(layer),
        hidden_dim=cfg.resolved_layer_dims[layer],
        matvec_mode=cfg.layer_matvec_mode(layer),
        num_layers=1, layer_dims=(), layer_matvec_modes=())


def stack_cell_params(params, cfg: Optional[GRUConfig] = None) -> tuple:
    """Normalize any accepted param layout to a tuple of per-layer cells:
    ``{"cells": (...)}``, ``{"cell": {...}}``, a bare cell dict, or a
    sequence of cells."""
    if isinstance(params, dict):
        if "cells" in params:
            return tuple(params["cells"])
        if "cell" in params:
            return (params["cell"],)
        return (params,)
    return tuple(params)


def gru_classifier_specs(cfg: GRUConfig) -> dict:
    """The jet-tagging model: GRU stack + linear classifier head. Depth 1
    uses ``{"cell": ...}``, deeper stacks ``{"cells": (...)}``."""
    head_in = cfg.resolved_layer_dims[-1]
    head = {
        "w": Spec((head_in, cfg.num_classes), ("hidden", None)),
        "b": Spec((cfg.num_classes,), (None,), init="zeros"),
    }
    if cfg.resolved_num_layers == 1:
        return {"cell": gru_cell_specs(cfg.input_dim, head_in), "head": head}
    return {"cells": gru_stack_specs(cfg), "head": head}


# ---------------------------------------------------------------------------
# structural matvec modes
# ---------------------------------------------------------------------------

def matvec(x: torch.Tensor, w: torch.Tensor, mode: str = "dense",
           block: int = 0) -> torch.Tensor:
    """``x @ w`` with an explicit structural decomposition.

    x: (..., K), w: (K, N) -> (..., N). ``block`` = output columns per
    block (rowwise) or contraction chunk (cascade); 0 picks N//4 or K//4
    (at least 1), shrunk to a divisor."""
    K, N = w.shape
    if mode == "dense":
        return x @ w
    if mode == "rowwise":
        blk = block or max(N // 4, 1)
        while N % blk:
            blk -= 1
        # every block sees the whole vector and emits finished outputs
        return torch.cat([x @ w[:, i:i + blk] for i in range(0, N, blk)],
                         dim=-1)
    if mode == "cascade":
        blk = block or max(K // 4, 1)
        while K % blk:
            blk -= 1
        # partial sums accumulate in sequence across contraction blocks
        out = torch.zeros((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
        for i in range(0, K, blk):
            out = out + x[..., i:i + blk] @ w[i:i + blk]
        return out
    raise ValueError(f"unknown matvec mode {mode!r}")


# ---------------------------------------------------------------------------
# single step
# ---------------------------------------------------------------------------

def input_projection(params: dict, xs: torch.Tensor,
                     cfg: GRUConfig) -> torch.Tensor:
    """The decoupled ``W.x`` path: one GEMM over all given timesteps."""
    return matvec(xs, params["w"], cfg.matvec_mode, cfg.row_block)


def gru_step(params: dict, h: torch.Tensor, x: Optional[torch.Tensor] = None,
             x_proj: Optional[torch.Tensor] = None, *,
             cfg: GRUConfig) -> torch.Tensor:
    """One recurrent step. Pass ``x_proj`` (precomputed Wx, (..., 3H)) when
    decoupled, else raw ``x``."""
    H = params["u"].shape[0]
    if x_proj is None:
        x_proj = input_projection(params, x, cfg)
    u, b = params["u"], params["b"]
    mode, blk = cfg.matvec_mode, cfg.row_block
    xz, xr, xh = x_proj[..., :H], x_proj[..., H:2 * H], x_proj[..., 2 * H:]

    if cfg.variant == "v3":
        uh_all = matvec(h, u, mode, blk) + b
        z = torch.sigmoid(xz + uh_all[..., :H])
        r = torch.sigmoid(xr + uh_all[..., H:2 * H])
        h_tilde = torch.tanh(xh + r * uh_all[..., 2 * H:])
    elif cfg.fused_gates:
        # phase 1 fuses z,r (one (H,2H) matvec), phase 2 the candidate
        zr = matvec(h, u[:, :2 * H], mode, blk) + b[:2 * H]
        z = torch.sigmoid(xz + zr[..., :H])
        r = torch.sigmoid(xr + zr[..., H:])
        h_tilde = torch.tanh(xh + matvec(r * h, u[:, 2 * H:], mode, blk)
                             + b[2 * H:])
    else:
        # unfused baseline: three separate matvecs
        z = torch.sigmoid(xz + matvec(h, u[:, :H], mode, blk) + b[:H])
        r = torch.sigmoid(xr + matvec(h, u[:, H:2 * H], mode, blk)
                          + b[H:2 * H])
        h_tilde = torch.tanh(xh + matvec(r * h, u[:, 2 * H:], mode, blk)
                             + b[2 * H:])
    return (1.0 - z) * h + z * h_tilde


# ---------------------------------------------------------------------------
# sequence
# ---------------------------------------------------------------------------

def _gated(h: torch.Tensor, h2: torch.Tensor,
           mt: Optional[torch.Tensor]) -> torch.Tensor:
    return h2 if mt is None else torch.where(mt[..., None], h2, h)


def gru_sequence_eager(params: dict, h0: torch.Tensor, xs: torch.Tensor, *,
                       cfg: GRUConfig, return_all: bool = False,
                       mask: Optional[torch.Tensor] = None):
    """Run one cell over ``xs`` (..., T, X), time axis -2. Returns
    ``(h_T, all states (..., T, H) | None)``. ``mask`` (..., T) bool:
    False steps leave h untouched."""
    T = xs.shape[-2]
    if cfg.decoupled_wx:
        xp = input_projection(params, xs, cfg)            # one GEMM, all T
    h, hs = h0, []
    for t in range(T):
        mt = None if mask is None else mask[..., t]
        if cfg.decoupled_wx:
            h2 = gru_step(params, h, x_proj=xp[..., t, :], cfg=cfg)
        else:
            h2 = gru_step(params, h, x=xs[..., t, :], cfg=cfg)
        h = _gated(h, h2, mt)
        if return_all:
            hs.append(h)
    return h, (torch.stack(hs, dim=-2) if return_all else None)


def gru_sequence(params: dict, h0: torch.Tensor, xs: torch.Tensor, *,
                 cfg: GRUConfig, return_all: bool = False,
                 mask: Optional[torch.Tensor] = None):
    """DEPRECATED single-cell entry point: a shim over the executor
    (``runtime.compile(..., mode="sequence")``)."""
    _warn_deprecated("gru_sequence")
    from repro_torch.core import runtime
    lcfg = cfg if cfg.resolved_num_layers == 1 else layer_config(cfg, 0)
    finals, states = runtime.sequence((params,), (h0,), xs, cfg=lcfg,
                                      return_all=return_all, mask=mask)
    return finals[0], states


# ---------------------------------------------------------------------------
# deep stacks
# ---------------------------------------------------------------------------

def stack_h0(cfg: GRUConfig, batch: int, dtype=torch.float32,
             device="cpu") -> tuple:
    """Zero initial hidden state per layer."""
    return tuple(torch.zeros((batch, h), dtype=dtype, device=device)
                 for h in cfg.resolved_layer_dims)


def gru_stack_sequence_eager(params: Sequence[dict],
                             h0s: Sequence[torch.Tensor], xs: torch.Tensor, *,
                             cfg: GRUConfig, return_all: bool = False,
                             mask: Optional[torch.Tensor] = None):
    """Run a depth-L stack over ``xs`` (..., T, X) layer by layer. Returns
    ``(per-layer finals, last layer's states | None)``. One shared mask
    freezes every layer."""
    params = stack_cell_params(params, cfg)
    L = len(params)
    finals, cur, hs = [], xs, None
    for l in range(L):
        last = l == L - 1
        hT, hs = gru_sequence_eager(params[l], h0s[l], cur,
                                    cfg=layer_config(cfg, l),
                                    return_all=(not last) or return_all,
                                    mask=mask)
        finals.append(hT)
        if not last:
            cur = hs
    return tuple(finals), (hs if return_all else None)


def gru_stack_sequence(params: Sequence[dict], h0s: Sequence[torch.Tensor],
                       xs: torch.Tensor, *, cfg: GRUConfig,
                       return_all: bool = False,
                       mask: Optional[torch.Tensor] = None):
    """DEPRECATED stack entry point: a shim over the executor."""
    _warn_deprecated("gru_stack_sequence")
    from repro_torch.core import runtime
    return runtime.sequence(params, tuple(h0s), xs, cfg=cfg,
                            return_all=return_all, mask=mask)


def gru_stack_decode_eager(params: Sequence[dict],
                           hs: Sequence[torch.Tensor], x: torch.Tensor, *,
                           cfg: GRUConfig) -> tuple:
    """One serve step through the whole stack; layer ``l`` consumes layer
    ``l-1``'s new state. Returns the per-layer new states."""
    params = stack_cell_params(params, cfg)
    new_hs, cur = [], x
    for l in range(len(params)):
        h2 = gru_step(params[l], hs[l], x=cur, cfg=layer_config(cfg, l))
        new_hs.append(h2)
        cur = h2
    return tuple(new_hs)


def gru_stack_decode_step(params: Sequence[dict],
                          hs: Sequence[torch.Tensor], x: torch.Tensor, *,
                          cfg: GRUConfig, impl: Optional[str] = None) -> tuple:
    """DEPRECATED decode entry point: a shim over the executor. ``impl``
    (``"cuda"``, ``"eager"`` or a backend name) overrides ``cfg.backend``
    as the preference; None follows ``cfg.backend``."""
    _warn_deprecated("gru_stack_decode_step")
    from repro_torch.core import runtime
    if impl is not None and impl != cfg.backend:
        cfg = dataclasses.replace(cfg, backend=impl)
    return runtime.decode(params, tuple(hs), x, cfg=cfg)


def gru_decode_step(params: dict, h: torch.Tensor, x: torch.Tensor, *,
                    cfg: GRUConfig) -> torch.Tensor:
    """DEPRECATED single-cell serve step: a shim over the executor."""
    _warn_deprecated("gru_decode_step")
    from repro_torch.core import runtime
    cell = params["cell"] if "cell" in params else params
    lcfg = cfg if cfg.resolved_num_layers == 1 else layer_config(cfg, 0)
    return runtime.decode((cell,), (h,), x, cfg=lcfg)[0]


def gru_stack_reference(params: Sequence[dict], h0s: Sequence[torch.Tensor],
                        xs: torch.Tensor, return_all: bool = False,
                        mask: Optional[torch.Tensor] = None):
    """Dense fp32 layer-by-layer oracle for the stack."""
    params = stack_cell_params(params)
    finals, cur, hs = [], xs, None
    for l, p in enumerate(params):
        last = l == len(params) - 1
        hT, hs = gru_reference(p, h0s[l], cur,
                               return_all=(not last) or return_all,
                               mask=mask)
        finals.append(hT)
        if not last:
            cur = hs
    return tuple(finals), (hs if return_all else None)


def gru_classify(params: dict, xs: torch.Tensor, *,
                 cfg: GRUConfig) -> torch.Tensor:
    """Jet-tagging forward pass: xs (B, T, X) -> logits (B, C), through the
    executor (``repro_torch.core.runtime``)."""
    from repro_torch.core import runtime
    B = xs.shape[0]
    cells = stack_cell_params(params, cfg)
    h0s = stack_h0(cfg, B, xs.dtype, xs.device)
    finals, _ = runtime.sequence(cells, h0s, xs, cfg=cfg)
    return finals[-1] @ params["head"]["w"] + params["head"]["b"]


def gru_reference(params: dict, h0: torch.Tensor, xs: torch.Tensor,
                  return_all: bool = False,
                  mask: Optional[torch.Tensor] = None):
    """Dense, unfused, fp32 oracle. ``mask`` (..., T): False steps leave h
    untouched."""
    w = params["w"].float()
    u = params["u"].float()
    b = params["b"].float()
    H = u.shape[0]
    h = h0.float()
    out = []
    for t in range(xs.shape[-2]):
        x = xs[..., t, :].float()
        z = torch.sigmoid(x @ w[:, :H] + h @ u[:, :H] + b[:H])
        r = torch.sigmoid(x @ w[:, H:2 * H] + h @ u[:, H:2 * H] + b[H:2 * H])
        ht = torch.tanh(x @ w[:, 2 * H:] + (r * h) @ u[:, 2 * H:] + b[2 * H:])
        h2 = (1 - z) * h + z * ht
        h = _gated(h, h2, None if mask is None else mask[..., t])
        if return_all:
            out.append(h)
    return h, (torch.stack(out, dim=-2) if return_all else None)
