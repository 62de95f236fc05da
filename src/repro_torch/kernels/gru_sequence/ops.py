"""The ``cuda_fused``, ``cuda_chain``, ``cuda_fused_q8`` and
``cuda_chain_q8`` executor backends: the GRU kernels behind the runtime's
backend interface (counterpart of ``repro.kernels.gru_sequence.ops``).

The layer-0 input projection ``x @ W`` stays one ``torch.matmul`` outside
the kernels; each kernel owns the recurrent path. A (B, T) bool length
mask is turned time-major (T, B) float and streamed through the kernels.

* ``cuda_fused``: a depth-1 stack goes to the depth-1 sequence kernel, a
  deeper uniform stack to the fused stack kernel; the decode step is one
  launch through all layers.
* ``cuda_chain``: one depth-1 sequence kernel per layer, so it also serves
  heterogeneous ``layer_dims``. Layer ``l+1``'s input projection is a
  float32 ``torch.matmul`` of layer ``l``'s whole hidden sequence; the
  mask streams into every layer. The decode step runs the same kernel at
  T=1 once per layer.
* ``cuda_fused_q8`` runs the fused structure on the int8 weight rows that
  ``runtime.prepare`` quantizes once (the q8 views); it has no depth-1
  special case: every depth goes to the q8 stack kernel.
* ``cuda_chain_q8`` is the chain on each layer's own int8 rows
  (``QuantStackParams.cells``, built for heterogeneous stacks too): the
  depth-1 q8 sequence kernel per layer for prefill, the q8 step kernel
  per layer for decode. Its inter-layer projections stay float32, unlike
  ``cuda_fused_q8``'s.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels._launch import fits_smem
from repro_torch.kernels.gru_cell.kernel import smem_bytes_step_q8
from repro_torch.kernels.gru_cell.ops import gru_step_q8_cuda
from repro_torch.kernels.gru_sequence.kernel import (
    gru_sequence_kernel, gru_sequence_q8_kernel, gru_stack_decode_kernel,
    gru_stack_decode_q8_kernel, gru_stack_sequence_kernel,
    gru_stack_sequence_q8_kernel, smem_bytes, smem_bytes_q8,
    smem_bytes_seq_q8)


def time_major_mask(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, T) bool/float -> (T, B) float32, contiguous."""
    if mask is None:
        return None
    return mask.transpose(0, 1).to(torch.float32).contiguous()


def prepare_stacked_cells(cells) -> dict:
    """The fused kernels' weight stacks, built once: ``{"u" (L,H,G),
    "w_deep" (L-1,H,G) or (1,1,G) zeros for L=1, "b" (L,G)}``, G the gate
    columns (3H for the GRU, 4H for the sLSTM)."""
    cells = tuple(cells)
    u = torch.stack([c["u"] for c in cells], 0).contiguous()
    if len(cells) > 1:
        w_deep = torch.stack([c["w"] for c in cells[1:]], 0).contiguous()
    else:
        w_deep = torch.zeros((1, 1, u.shape[-1]), dtype=u.dtype,
                             device=u.device)
    b = torch.stack([c["b"] for c in cells], 0).contiguous()
    return {"u": u, "w_deep": w_deep, "b": b}


def gru_sequence_cuda(params: dict, h0: torch.Tensor, xs: torch.Tensor, *,
                      cfg, return_all: bool = False, mask=None):
    """One cell over xs (B,T,X) -> (h_T, optionally (B,T,H))."""
    xp = (xs @ params["w"]).transpose(0, 1).contiguous()     # (T,B,3H)
    hs = gru_sequence_kernel(h0.contiguous(), xp, params["u"].contiguous(),
                             params["b"].contiguous(), time_major_mask(mask),
                             variant=cfg.variant)
    return hs[-1], (hs.transpose(0, 1) if return_all else None)


def gru_stack_sequence_cuda(params: tuple, h0s: tuple, xs: torch.Tensor, *,
                            cfg, stacked: dict, return_all: bool = False,
                            mask=None):
    """Fused depth-L stack (uniform hidden sizes): one launch. ``stacked``
    is :func:`prepare_stacked_cells`' output. Returns (per-layer finals,
    optionally the last layer's (B,T,H))."""
    if len(params) == 1:
        hT, hs = gru_sequence_cuda(params[0], h0s[0], xs, cfg=cfg,
                                   return_all=return_all, mask=mask)
        return (hT,), hs
    xp = (xs @ params[0]["w"]).transpose(0, 1).contiguous()  # (T,B,3H)
    h0 = torch.stack(tuple(h0s), 0)                          # (L,B,H)
    hs, hT = gru_stack_sequence_kernel(h0, xp, stacked["u"],
                                       stacked["w_deep"], stacked["b"],
                                       time_major_mask(mask),
                                       variant=cfg.variant)
    return tuple(hT.unbind(0)), (hs.transpose(0, 1) if return_all else None)


def gru_stack_decode_cuda(params: tuple, hs: tuple, x: torch.Tensor, *, cfg,
                          stacked: dict) -> tuple:
    """One token through the whole stack in one launch; returns the
    per-layer new states."""
    xp = (x @ params[0]["w"]).contiguous()                   # (B,3H)
    h = torch.stack(tuple(hs), 0)                            # (L,B,H)
    h2 = gru_stack_decode_kernel(h, xp, stacked["u"], stacked["w_deep"],
                                 stacked["b"], variant=cfg.variant)
    return tuple(h2.unbind(0))


def gru_stack_sequence_cuda_q8(params: tuple, h0s: tuple, xs: torch.Tensor,
                               *, cfg, quant, return_all: bool = False,
                               mask=None):
    """Fused q8 depth-L stack (uniform hidden sizes, any depth): one
    launch on int8 weight rows. The layer-0 ``x @ W`` stays a float32
    matmul. ``quant`` is ``runtime.prepare``'s ``QuantStackParams``.
    Returns (per-layer finals, optionally the last layer's (B,T,H))."""
    st = quant.stacked
    xp = (xs @ params[0]["w"]).transpose(0, 1).contiguous()  # (T,B,3H)
    h0 = torch.stack(tuple(h0s), 0)                          # (L,B,H)
    hs, hT = gru_stack_sequence_q8_kernel(
        h0, xp, st["u_q"], st["u_eff"], st["wd_q"], st["wd_eff"], st["b"],
        time_major_mask(mask), variant=cfg.variant)
    return tuple(hT.unbind(0)), (hs.transpose(0, 1) if return_all else None)


def gru_stack_decode_cuda_q8(params: tuple, hs: tuple, x: torch.Tensor, *,
                             cfg, quant) -> tuple:
    """One token through the whole stack on int8 weight rows, one launch;
    returns the per-layer new states."""
    st = quant.stacked
    xp = (x @ params[0]["w"]).contiguous()                   # (B,3H)
    h = torch.stack(tuple(hs), 0)                            # (L,B,H)
    h2 = gru_stack_decode_q8_kernel(h, xp, st["u_q"], st["u_eff"],
                                    st["wd_q"], st["wd_eff"], st["b"],
                                    variant=cfg.variant)
    return tuple(h2.unbind(0))


def gru_sequence_cuda_q8(params: dict, qcell: dict, h0: torch.Tensor,
                         xs: torch.Tensor, *, cfg, return_all: bool = False,
                         mask=None):
    """One q8 cell over xs (B,T,X): float32 ``x @ W`` plus the int8-row
    recurrent kernel (counterpart of ``gru_sequence_pallas_q8``; the chain
    backend runs the same kernel on its time-major projections). ``qcell``:
    {"u_q" (3H,H) int8, "u_eff" (3H,)} of this layer. Returns (h_T,
    optionally (B,T,H))."""
    xp = (xs @ params["w"]).transpose(0, 1).contiguous()     # (T,B,3H)
    hs = gru_sequence_q8_kernel(h0.contiguous(), xp, qcell["u_q"],
                                qcell["u_eff"], params["b"].contiguous(),
                                time_major_mask(mask), variant=cfg.variant)
    return hs[-1], (hs.transpose(0, 1) if return_all else None)


def _chain_sequence(params: tuple, h0s: tuple, xs: torch.Tensor,
                    layer: Callable, return_all: bool, mask):
    """The per-layer chain over a whole sequence: ``layer(l, h0, xp, m)``
    runs layer ``l``'s depth-1 kernel on its time-major input projection
    ``xp`` (T,B,3H) -> (T,B,H); the next layer's ``xp`` is that sequence
    times its ``W``, kept time-major: one matmul over T*B contiguous rows,
    whose rows round alike at any T, so a masked bucketed prefill stays
    bitwise equal to the unpadded prompt (a transposed (B,T,H) view broke
    that on the CPU). Returns (per-layer finals, optionally (B,T,H))."""
    m = time_major_mask(mask)
    xp = (xs @ params[0]["w"]).transpose(0, 1).contiguous()  # (T,B,3H)
    finals = []
    for l in range(len(params)):
        hs = layer(l, h0s[l].contiguous(), xp, m)
        finals.append(hs[-1])
        if l + 1 < len(params):
            xp = hs @ params[l + 1]["w"]                     # (T,B,3H)
    return tuple(finals), (hs.transpose(0, 1) if return_all else None)


def _chain_decode(params: tuple, hs: tuple, x: torch.Tensor,
                  step: Callable) -> tuple:
    """One token through the chain: ``step(l, h, xp)`` advances layer ``l``
    from its state and input projection (B,3H); the new state feeds the
    next layer's float32 projection."""
    cur, out = x, []
    for l, p in enumerate(params):
        cur = step(l, hs[l].contiguous(), cur @ p["w"])      # (B,H)
        out.append(cur)
    return tuple(out)


def gru_stack_sequence_cuda_chain(params: tuple, h0s: tuple,
                                  xs: torch.Tensor, *, cfg,
                                  return_all: bool = False, mask=None):
    """Per-layer chain (any ``layer_dims``): one depth-1 sequence kernel
    launch per layer, the mask streamed into every layer. Returns
    (per-layer finals, optionally the last layer's (B,T,H))."""
    def layer(l, h0, xp, m):
        return gru_sequence_kernel(h0, xp, params[l]["u"].contiguous(),
                                   params[l]["b"].contiguous(), m,
                                   variant=cfg.variant)
    return _chain_sequence(params, h0s, xs, layer, return_all, mask)


def gru_stack_decode_cuda_chain(params: tuple, hs: tuple, x: torch.Tensor,
                                *, cfg) -> tuple:
    """One token through the chain: per layer, ``x @ W`` then the depth-1
    sequence kernel at T=1 (no mask)."""
    def step(l, h, xp):
        return gru_sequence_kernel(h, xp[None], params[l]["u"].contiguous(),
                                   params[l]["b"].contiguous(),
                                   variant=cfg.variant)[0]
    return _chain_decode(params, hs, x, step)


def gru_stack_sequence_cuda_chain_q8(params: tuple, h0s: tuple,
                                     xs: torch.Tensor, *, cfg, quant,
                                     return_all: bool = False, mask=None):
    """Per-layer q8 chain (any ``layer_dims``): one depth-1 q8 sequence
    kernel launch per layer on ``quant.cells[l]``; float32 inter-layer
    projections."""
    def layer(l, h0, xp, m):
        q = quant.cells[l]
        return gru_sequence_q8_kernel(h0, xp, q["u_q"], q["u_eff"],
                                      params[l]["b"].contiguous(), m,
                                      variant=cfg.variant)
    return _chain_sequence(params, h0s, xs, layer, return_all, mask)


def gru_stack_decode_cuda_chain_q8(params: tuple, hs: tuple,
                                   x: torch.Tensor, *, cfg, quant) -> tuple:
    """One token through the q8 chain: per layer, float32 ``x @ W`` then
    the q8 step kernel on that layer's int8 rows."""
    def step(l, h, xp):
        q = quant.cells[l]
        return gru_step_q8_cuda(h, xp, q["u_q"], q["u_eff"], params[l]["b"],
                                variant=cfg.variant)
    return _chain_decode(params, hs, x, step)


def _fused_fits(smem):
    """``fits`` of a fused backend: the whole uniform stack in one block."""
    def fits(cfg, batch, op):
        dims = cfg.resolved_layer_dims
        return fits_smem(smem, len(dims), max(dims), batch)
    return fits


def _chain_fits(seq_smem, step_smem):
    """``fits`` of a chain backend: every layer alone in one block, with
    the sequence kernel's (prefill) or the step kernel's (decode) shared
    memory."""
    def fits(cfg, batch, op):
        smem = seq_smem if op == "sequence" else step_smem
        return all(fits_smem(smem, 1, H, batch)
                   for H in cfg.resolved_layer_dims)
    return fits


def register_runtime_backends() -> None:
    """Register ``cuda_fused``, ``cuda_chain``, ``cuda_fused_q8`` and
    ``cuda_chain_q8`` with the GRU executor (idempotent), each with the
    shapes its kernels take (``fits``, from the wrappers' shared-memory
    sizes)."""
    from repro_torch.core import runtime

    def fused_seq(sp, h0s, xs, *, cfg, return_all, mask):
        return gru_stack_sequence_cuda(sp.cells, tuple(h0s), xs, cfg=cfg,
                                       return_all=return_all, mask=mask,
                                       stacked=sp.stacked)

    def fused_dec(sp, hs, x, *, cfg):
        return gru_stack_decode_cuda(sp.cells, tuple(hs), x, cfg=cfg,
                                     stacked=sp.stacked)

    def fused_seq_q8(sp, h0s, xs, *, cfg, return_all, mask):
        return gru_stack_sequence_cuda_q8(sp.cells, tuple(h0s), xs, cfg=cfg,
                                          return_all=return_all, mask=mask,
                                          quant=sp.quant)

    def fused_dec_q8(sp, hs, x, *, cfg):
        return gru_stack_decode_cuda_q8(sp.cells, tuple(hs), x, cfg=cfg,
                                        quant=sp.quant)

    def chain_seq(sp, h0s, xs, *, cfg, return_all, mask):
        return gru_stack_sequence_cuda_chain(sp.cells, tuple(h0s), xs,
                                             cfg=cfg, return_all=return_all,
                                             mask=mask)

    def chain_dec(sp, hs, x, *, cfg):
        return gru_stack_decode_cuda_chain(sp.cells, tuple(hs), x, cfg=cfg)

    def chain_seq_q8(sp, h0s, xs, *, cfg, return_all, mask):
        return gru_stack_sequence_cuda_chain_q8(
            sp.cells, tuple(h0s), xs, cfg=cfg, return_all=return_all,
            mask=mask, quant=sp.quant)

    def chain_dec_q8(sp, hs, x, *, cfg):
        return gru_stack_decode_cuda_chain_q8(sp.cells, tuple(hs), x,
                                              cfg=cfg, quant=sp.quant)

    runtime.register_backend(runtime.BackendSpec(
        name="cuda_fused",
        caps=runtime.Capabilities(supports_mask=True,
                                  supports_hetero_dims=False),
        cost=10,
        sequence_fn=fused_seq, decode_fn=fused_dec, views="stacked",
        fits=_fused_fits(smem_bytes)))
    runtime.register_backend(runtime.BackendSpec(
        name="cuda_chain",
        caps=runtime.Capabilities(supports_mask=True,
                                  supports_hetero_dims=True),
        cost=20,
        sequence_fn=chain_seq, decode_fn=chain_dec,
        fits=_chain_fits(smem_bytes, smem_bytes)))
    # costs 150 and 160, as in the JAX table: under the static costs the
    # q8 datapath never wins dispatch, it runs under an exact-name pin
    runtime.register_backend(runtime.BackendSpec(
        name="cuda_fused_q8",
        caps=runtime.Capabilities(supports_mask=True,
                                  supports_hetero_dims=False),
        cost=150,
        sequence_fn=fused_seq_q8, decode_fn=fused_dec_q8, views="quant",
        fits=_fused_fits(smem_bytes_q8)))
    runtime.register_backend(runtime.BackendSpec(
        name="cuda_chain_q8",
        caps=runtime.Capabilities(supports_mask=True,
                                  supports_hetero_dims=True),
        cost=160,
        sequence_fn=chain_seq_q8, decode_fn=chain_dec_q8, views="quant",
        fits=_chain_fits(lambda _L, H, bt: smem_bytes_seq_q8(H, bt),
                         lambda _L, H, bt: smem_bytes_step_q8(H, bt))))
