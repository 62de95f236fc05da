"""The sLSTM cell family in eager PyTorch (counterpart of
``repro.core.slstm``): scalar-gated recurrence with exponential gates and
a per-step stabilizer (xLSTM, Beck et al. 2024).

The cell keeps the GRU's dense per-layer layout, ``w`` ``(X, 4H)``, ``u``
``(H, 4H)``, ``b`` ``(4H,)``, gate order ``[z, i, f, o]``, so the same
stacking and normalization helpers apply. Gate math (fp32, every backend
and the oracle)::

    z, i, f, o = split(W x + U h + b, 4)
    logf  = log_sigmoid(f)
    m'    = max(logf + m, i)                     # stabilizer state
    c'    = exp(logf + m - m') * c + exp(i - m') * tanh(z)
    n'    = exp(logf + m - m') * n + exp(i - m')
    h'    = sigmoid(o) * c' / max(n', 1e-6)

Per-layer state is four ``(B, H)`` leaves ``(c, n, m, h)``; a depth-L
stack's flat runtime state is ``(c0, n0, m0, h0, c1, ...)``. ``m`` starts
at :data:`M_INIT`, so the first step's forget term ``exp(logf + m - m')``
is exactly 0. Masks are (B, T) bool: False steps freeze all four leaves.

This module owns the family registration, the parameter specs, the eager
backend ``(slstm, eager)`` (the JAX ``xla`` backend) and the dense fp32
oracle. The fused CUDA backend registers from
``repro_torch.kernels.slstm_cell.ops``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GRUConfig
from repro_torch.core import cells as cell_families
from repro_torch.core.gru import stack_cell_params
from repro_torch.core.params import Spec

STATE_LEAVES = 4                      # (c, n, m, h) per layer
M_INIT = -1e30                        # stabilizer init: first step's f_ = 0


# ---------------------------------------------------------------------------
# parameter specs + state layout
# ---------------------------------------------------------------------------

def slstm_cell_specs(input_dim: int, hidden_dim: int) -> dict:
    """One sLSTM layer. Gate stacking order along the last axis:
    [z, i, f, o]."""
    return {
        "w": Spec((input_dim, 4 * hidden_dim), ("rnn_in", "gates")),
        "u": Spec((hidden_dim, 4 * hidden_dim), ("hidden", "gates"),
                  init="recurrent"),
        "b": Spec((4 * hidden_dim,), ("gates",), init="zeros"),
    }


def slstm_stack_specs(cfg: GRUConfig) -> tuple:
    """Per-layer cell specs for a depth-L stack, layer 0 first."""
    return tuple(slstm_cell_specs(cfg.layer_input_dim(l), h)
                 for l, h in enumerate(cfg.resolved_layer_dims))


def stack_state0(cfg: GRUConfig, batch: int, dtype=torch.float32,
                 device="cpu") -> tuple:
    """Flat initial state, layer-major: (c, n, m, h) per layer, ``m`` at
    :data:`M_INIT`."""
    out = []
    for h in cfg.resolved_layer_dims:
        zeros = [torch.zeros((batch, h), dtype=dtype, device=device)
                 for _ in range(3)]
        out += [zeros[0], zeros[1],
                torch.full((batch, h), M_INIT, dtype=dtype, device=device),
                zeros[2]]
    return tuple(out)


def group_states(state: Sequence[torch.Tensor], num_layers: int) -> tuple:
    """Flat (4L,) tuple -> per-layer ((c, n, m, h), ...) groups."""
    state = tuple(state)
    if len(state) != STATE_LEAVES * num_layers:
        raise ValueError(f"{len(state)} state leaves for {num_layers} "
                         f"layers; the sLSTM has {STATE_LEAVES} per layer")
    return tuple(state[STATE_LEAVES * l:STATE_LEAVES * (l + 1)]
                 for l in range(num_layers))


def flatten_states(groups) -> tuple:
    """Per-layer ((c, n, m, h), ...) groups -> flat (4L,) tuple."""
    return tuple(leaf for g in groups for leaf in g)


# ---------------------------------------------------------------------------
# gate math (fp32)
# ---------------------------------------------------------------------------

def slstm_gate_math(c, n, m, h, xp, u, b):
    """One cell update. c/n/m/h: (B,H); xp: (B,4H) precomputed W.x;
    u: (H,4H); b broadcastable (4H,). Returns the new (c, n, m, h)."""
    H = h.shape[-1]
    g = xp + h @ u + b                                   # (B, 4H) fused gates
    z, i = g[..., :H], g[..., H:2 * H]
    f, o = g[..., 2 * H:3 * H], g[..., 3 * H:]
    logf = F.logsigmoid(f)
    m_new = torch.maximum(logf + m, i)
    i_ = torch.exp(i - m_new)
    f_ = torch.exp(logf + m - m_new)
    c_new = f_ * c + i_ * torch.tanh(z)
    n_new = f_ * n + i_
    h_new = torch.sigmoid(o) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, m_new, h_new


def _f32_cell(cell: dict) -> tuple:
    return cell["w"].float(), cell["u"].float(), cell["b"].float()


def _freeze(new: tuple, old: tuple, keep: Optional[torch.Tensor]) -> tuple:
    """Select the update on live rows, the old leaves on frozen ones."""
    if keep is None:
        return new
    return tuple(torch.where(keep, a, o) for a, o in zip(new, old))


# ---------------------------------------------------------------------------
# the eager backend (the family's fallback, serves any shape)
# ---------------------------------------------------------------------------

def _layer_sequence_eager(cell: dict, group: tuple, xs: torch.Tensor, *,
                          return_all: bool, mask: Optional[torch.Tensor]):
    """One layer over xs (B, T, X): decoupled ``W.x`` GEMM over all steps,
    then the recurrent path step by step. Returns ((c,n,m,h) finals,
    (B,T,H) h states | None). ``mask`` (B,T): False steps freeze all four
    leaves (select, so live steps equal the unpadded arithmetic)."""
    w, u, b = _f32_cell(cell)
    xp = xs.float() @ w                                  # (B,T,4H)
    state = tuple(leaf.float() for leaf in group)
    hs = []
    for t in range(xs.shape[-2]):
        keep = None if mask is None else (mask[..., t] != 0)[..., None]
        state = _freeze(slstm_gate_math(*state, xp[..., t, :], u, b), state,
                        keep)
        if return_all:
            hs.append(state[3])
    return state, (torch.stack(hs, dim=-2) if return_all else None)


def slstm_stack_sequence_eager(params, state0: Sequence[torch.Tensor],
                               xs: torch.Tensor, *, cfg: GRUConfig,
                               return_all: bool = False,
                               mask: Optional[torch.Tensor] = None):
    """Depth-L sLSTM stack over xs (B,T,X), layer by layer (each layer
    hoists its input GEMM over the lower layer's whole hidden sequence).
    ``state0``: flat (4L,) tuple. Returns (flat finals, last layer's
    (B,T,H) h sequence | None). One shared mask freezes every layer."""
    cells = stack_cell_params(params, cfg)
    L = len(cells)
    groups = group_states(state0, L)
    finals, cur, hs = [], xs, None
    for l in range(L):
        last = l == L - 1
        fin, hs = _layer_sequence_eager(cells[l], groups[l], cur,
                                        return_all=(not last) or return_all,
                                        mask=mask)
        finals.append(fin)
        if not last:
            cur = hs
    return flatten_states(finals), (hs if return_all else None)


def slstm_stack_decode_eager(params, state: Sequence[torch.Tensor],
                             x: torch.Tensor, *, cfg: GRUConfig) -> tuple:
    """One serve step through the stack: layer ``l`` consumes layer
    ``l-1``'s new h. ``state``: flat (4L,); returns the flat new state."""
    cells = stack_cell_params(params, cfg)
    out, cur = [], x
    for cell, group in zip(cells, group_states(state, len(cells))):
        w, u, b = _f32_cell(cell)
        new = slstm_gate_math(*(leaf.float() for leaf in group),
                              cur.float() @ w, u, b)
        out.append(new)
        cur = new[3]
    return flatten_states(out)


def slstm_stack_reference(params, state0: Sequence[torch.Tensor],
                          xs: torch.Tensor, return_all: bool = False,
                          mask: Optional[torch.Tensor] = None):
    """Dense fp32 step-by-step oracle (time loop outside, no decoupled
    GEMM). Returns (flat finals, last layer's (B,T,H) | None)."""
    cells = stack_cell_params(params)
    L = len(cells)
    wub = [_f32_cell(c) for c in cells]
    states = [tuple(leaf.float() for leaf in g)
              for g in group_states(state0, L)]
    out = []
    for t in range(xs.shape[-2]):
        cur = xs[..., t, :].float()
        keep = None if mask is None else (mask[..., t] != 0)[..., None]
        for l in range(L):
            w, u, b = wub[l]
            states[l] = _freeze(slstm_gate_math(*states[l], cur @ w, u, b),
                                states[l], keep)
            cur = states[l][3]
        if return_all:
            out.append(states[-1][3])
    hs = torch.stack(out, dim=-2) if return_all else None
    return flatten_states(states), hs


# ---------------------------------------------------------------------------
# registration: the family + its eager backend
# ---------------------------------------------------------------------------

def _slstm_family() -> cell_families.CellFamily:
    def stacked_views(cells):
        from repro_torch.kernels.slstm_cell import ops as slstm_ops
        return slstm_ops.prepare_stacked_cells(cells)

    return cell_families.CellFamily(
        name="slstm", gates=4, state_leaves=STATE_LEAVES,
        state_names=("c", "n", "m", "h"), h_leaf=3,
        normalize=stack_cell_params, init_state=stack_state0,
        stacked_views=stacked_views,
        supports_quant=False)          # no int8 views for the exp-gate path


cell_families.register_family(_slstm_family())


def register_runtime_backends() -> None:
    """Register ``(slstm, eager)`` with the executor (idempotent): mask
    and heterogeneous stacks, cost 30, as JAX's ``(slstm, xla)``."""
    from repro_torch.core import runtime

    def eager_seq(sp, state0, xs, *, cfg, return_all, mask):
        return slstm_stack_sequence_eager(sp.cells, state0, xs, cfg=cfg,
                                          return_all=return_all, mask=mask)

    def eager_dec(sp, state, x, *, cfg):
        return slstm_stack_decode_eager(sp.cells, state, x, cfg=cfg)

    runtime.register_backend(runtime.BackendSpec(
        name="eager", family="slstm",
        caps=runtime.Capabilities(supports_mask=True,
                                  supports_hetero_dims=True),
        cost=30, sequence_fn=eager_seq, decode_fn=eager_dec))
