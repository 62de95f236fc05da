"""The ``(slstm, cuda_fused)`` executor backend: the fused sLSTM kernels
behind the runtime's backend interface (counterpart of
``repro.kernels.slstm_cell.ops``).

Same split as the GRU's ``cuda_fused``: the layer-0 input projection
``x @ W`` stays one ``torch.matmul`` outside the kernels; one kernel launch
owns the recurrent path of the whole stack, all four state leaves of every
layer, per prefill and per decode step. A (B, T) bool length mask is
turned time-major (T, B) float and streamed through the kernel. The flat
runtime state ``(c0, n0, m0, h0, c1, ...)`` goes to the decode as it is,
per layer (its warp route reads and writes the leaves in place through a
table of per-layer pointers, no stacking copies); the prefill stacks it
into four (L,B,H) leaves on the way in and unstacks the finals on the way
out. Uniform hidden sizes only; ``(slstm, eager)`` serves the rest.
"""
from __future__ import annotations

import torch

from repro_torch.core.slstm import STATE_LEAVES, flatten_states, group_states
# prepare_stacked_cells: the GRU's weight stacks serve as they are, with
# 4H gate columns (re-exported for the family's stacked views)
from repro_torch.kernels.gru_sequence.ops import (  # noqa: F401
    prepare_stacked_cells, time_major_mask)
from repro_torch.kernels._launch import fits_smem
from repro_torch.kernels.slstm_cell.kernel import (slstm_stack_decode_layers,
                                                   slstm_stack_sequence_kernel,
                                                   smem_bytes)


def _leaf_stacks(state: tuple, L: int) -> tuple:
    """Flat (4L,) state -> four (L,B,H) leaf stacks (c, n, m, h)."""
    groups = group_states(state, L)
    return tuple(torch.stack([g[k] for g in groups], 0)
                 for k in range(STATE_LEAVES))


def _unstack_leaves(leaves, L: int) -> tuple:
    """Four (L,B,H) leaf stacks -> flat (4L,) state, layer-major."""
    return flatten_states(tuple(tuple(leaf[l] for leaf in leaves)
                                for l in range(L)))


def slstm_stack_sequence_cuda(params: tuple, state0: tuple, xs: torch.Tensor,
                              *, stacked: dict, return_all: bool = False,
                              mask=None):
    """Fused depth-L sLSTM stack over xs (B,T,X): one launch. ``stacked``
    is :func:`prepare_stacked_cells`' output. Returns (flat finals,
    optionally the last layer's (B,T,H) h sequence)."""
    L = len(params)
    xp = (xs @ params[0]["w"]).transpose(0, 1).contiguous()  # (T,B,4H)
    hs, *fin = slstm_stack_sequence_kernel(
        *_leaf_stacks(tuple(state0), L), xp, stacked["u"],
        stacked["w_deep"], stacked["b"], time_major_mask(mask))
    return (_unstack_leaves(fin, L),
            hs.transpose(0, 1) if return_all else None)


def slstm_stack_decode_cuda(params: tuple, state: tuple, x: torch.Tensor, *,
                            stacked: dict) -> tuple:
    """One token through the whole stack in one launch, on the flat state's
    own leaves; returns the flat new state (fresh leaves)."""
    xp = (x @ params[0]["w"]).contiguous()                    # (B,4H)
    return flatten_states(slstm_stack_decode_layers(
        group_states(tuple(state), len(params)), xp, stacked["u"],
        stacked["w_deep"], stacked["b"]))


def register_runtime_backends() -> None:
    """Register ``(slstm, cuda_fused)`` with the executor (idempotent):
    mask yes, heterogeneous stacks no, cost 10, as JAX's
    ``(slstm, pallas_fused)``; it takes the stacks whose weights and state
    fit one block's shared memory (``fits``)."""
    from repro_torch.core import runtime

    def fused_seq(sp, state0, xs, *, cfg, return_all, mask):
        return slstm_stack_sequence_cuda(sp.cells, state0, xs,
                                         stacked=sp.stacked,
                                         return_all=return_all, mask=mask)

    def fused_dec(sp, state, x, *, cfg):
        return slstm_stack_decode_cuda(sp.cells, state, x,
                                       stacked=sp.stacked)

    runtime.register_backend(runtime.BackendSpec(
        name="cuda_fused", family="slstm",
        caps=runtime.Capabilities(supports_mask=True,
                                  supports_hetero_dims=False),
        cost=10, sequence_fn=fused_seq, decode_fn=fused_dec,
        views="stacked",
        fits=lambda cfg, batch, op: fits_smem(
            smem_bytes, cfg.resolved_num_layers,
            max(cfg.resolved_layer_dims), batch)))
