"""Plain PyTorch versions of the GRU sequence kernels, with the kernels'
raw-array interface (fp32 unless ``_q8``):

* ``x_proj`` time-major (T, B, 3H) (decode: (B, 3H)), the layer-0 ``W.x``;
* ``u`` (L, H, 3H), ``w_deep`` (L-1, H, 3H), ``b`` (L, 3H); depth-1
  ``gru_sequence_ref`` takes ``u`` (H, 3H) and ``b`` (3H,);
* ``mask`` (T, B) float, nonzero = live step; a dead step keeps every
  layer's pre-step h, and the next layer consumes that gated output.

The wrappers in ``kernel.py`` call these for CPU tensors; the tests and
``chip_smoke.py`` hold the CUDA kernels against them. The gate arithmetic
follows the kernels' order of additions (``x + (U.h + b)``, and for the v1
candidate ``(x + U.(r*h)) + b``).

The ``*_q8`` versions are the plain versions of the q8 kernels: the fused
stack kernels (int8 weight rows ``u_q`` (L,3H,H) with per-row scales
``u_eff``, deep layers' ``wd_q``/``wd_eff`` likewise, fixed activation
scale 127; see ``repro_torch.core.params.quantize_rows_int8``) and the
chain's depth-1 ``gru_sequence_q8_ref`` (one layer's ``u_q`` (3H,H), its
input projection float32). All are built on the q8 step of
``repro_torch.kernels.gru_cell.ref``: integer-valued float32 activations,
exact sums while ``H * 127 * 127 < 2**24`` (its ``Q8_EXACT_MAX_H``), and
every other operation a separate, rounded float32 op in the order of
``_gate_math_q8`` in the JAX kernels (``x + (acc * eff + b)``), which the
CUDA kernels repeat without contracting any multiply-add.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gru_cell.ref import _q8_act, _q8_dot, gru_step_q8_ref


def gru_step_ref(h: torch.Tensor, xp: torch.Tensor, u: torch.Tensor,
                 b: torch.Tensor, variant: str = "v1") -> torch.Tensor:
    """One cell update: h (B,H), xp (B,3H), u (H,3H), b (3H,) -> (B,H)."""
    H = h.shape[-1]
    xz, xr, xh = xp[..., :H], xp[..., H:2 * H], xp[..., 2 * H:]
    if variant == "v3":
        ua = h @ u + b
        z = torch.sigmoid(xz + ua[..., :H])
        r = torch.sigmoid(xr + ua[..., H:2 * H])
        ht = torch.tanh(xh + r * ua[..., 2 * H:])
    else:
        zr = h @ u[:, :2 * H] + b[:2 * H]
        z = torch.sigmoid(xz + zr[..., :H])
        r = torch.sigmoid(xr + zr[..., H:])
        ht = torch.tanh(xh + (r * h) @ u[:, 2 * H:] + b[2 * H:])
    return (1.0 - z) * h + z * ht


def _live(mask: Optional[torch.Tensor], t: int):
    return None if mask is None else (mask[t] != 0)[:, None]


def gru_sequence_ref(h0: torch.Tensor, x_proj: torch.Tensor, u: torch.Tensor,
                     b: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     variant: str = "v1") -> torch.Tensor:
    """h0 (B,H), x_proj (T,B,3H) -> all states (T,B,H)."""
    h, out = h0, []
    for t in range(x_proj.shape[0]):
        h2 = gru_step_ref(h, x_proj[t], u, b, variant)
        live = _live(mask, t)
        h = h2 if live is None else torch.where(live, h2, h)
        out.append(h)
    return torch.stack(out, dim=0)


def gru_stack_sequence_ref(h0: torch.Tensor, x_proj: torch.Tensor,
                           u: torch.Tensor, w_deep: torch.Tensor,
                           b: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           variant: str = "v1"):
    """h0 (L,B,H), x_proj (T,B,3H) -> (last layer's states (T,B,H),
    per-layer finals (L,B,H))."""
    L = h0.shape[0]
    hs = [h0[l] for l in range(L)]
    out = []
    for t in range(x_proj.shape[0]):
        xp = x_proj[t]
        live = _live(mask, t)
        for l in range(L):
            h2 = gru_step_ref(hs[l], xp, u[l], b[l], variant)
            hs[l] = h2 if live is None else torch.where(live, h2, hs[l])
            if l + 1 < L:
                xp = hs[l] @ w_deep[l]
        out.append(hs[-1])
    return torch.stack(out, dim=0), torch.stack(hs, dim=0)


def gru_stack_decode_ref(h: torch.Tensor, x_proj: torch.Tensor,
                         u: torch.Tensor, w_deep: torch.Tensor,
                         b: torch.Tensor, variant: str = "v1") -> torch.Tensor:
    """h (L,B,H), x_proj (B,3H) of ONE token -> new states (L,B,H)."""
    L = h.shape[0]
    xp, out = x_proj, []
    for l in range(L):
        h_new = gru_step_ref(h[l], xp, u[l], b[l], variant)
        out.append(h_new)
        if l + 1 < L:
            xp = h_new @ w_deep[l]
    return torch.stack(out, dim=0)


# ---------------------------------------------------------------------------
# q8: int8 weight rows, fixed-scale activations (the step's plain version
# lives in repro_torch.kernels.gru_cell.ref)
# ---------------------------------------------------------------------------

def gru_sequence_q8_ref(h0: torch.Tensor, x_proj: torch.Tensor,
                        u_q: torch.Tensor, u_eff: torch.Tensor,
                        b: torch.Tensor, mask: Optional[torch.Tensor] = None,
                        variant: str = "v1") -> torch.Tensor:
    """Depth-1 q8 sequence: h0 (B,H), x_proj (T,B,3H) float32, u_q (3H,H)
    int8 rows, u_eff (3H,), b (3H,) -> all states (T,B,H). A dead step
    keeps the row's pre-step h."""
    h, out = h0, []
    for t in range(x_proj.shape[0]):
        h2 = gru_step_q8_ref(h, x_proj[t], u_q, u_eff, b, variant)
        live = _live(mask, t)
        h = h2 if live is None else torch.where(live, h2, h)
        out.append(h)
    return torch.stack(out, dim=0)


def _deep_xp_q8(h: torch.Tensor, wd_q: torch.Tensor,
                wd_eff: torch.Tensor) -> torch.Tensor:
    """Deep-layer q8 input projection: quantized h against int8 W rows."""
    return _q8_dot(_q8_act(h), wd_q) * wd_eff


def gru_stack_sequence_q8_ref(h0: torch.Tensor, x_proj: torch.Tensor,
                              u_q: torch.Tensor, u_eff: torch.Tensor,
                              wd_q: torch.Tensor, wd_eff: torch.Tensor,
                              b: torch.Tensor,
                              mask: Optional[torch.Tensor] = None,
                              variant: str = "v1"):
    """h0 (L,B,H), x_proj (T,B,3H) float32 layer-0 Wx -> (last layer's
    states (T,B,H), per-layer finals (L,B,H)). A dead step keeps every
    layer's pre-step h; the next layer consumes that gated output."""
    L = h0.shape[0]
    hs = [h0[l] for l in range(L)]
    out = []
    for t in range(x_proj.shape[0]):
        xp = x_proj[t]
        live = _live(mask, t)
        for l in range(L):
            h2 = gru_step_q8_ref(hs[l], xp, u_q[l], u_eff[l], b[l], variant)
            hs[l] = h2 if live is None else torch.where(live, h2, hs[l])
            if l + 1 < L:
                xp = _deep_xp_q8(hs[l], wd_q[l], wd_eff[l])
        out.append(hs[-1])
    return torch.stack(out, dim=0), torch.stack(hs, dim=0)


def gru_stack_decode_q8_ref(h: torch.Tensor, x_proj: torch.Tensor,
                            u_q: torch.Tensor, u_eff: torch.Tensor,
                            wd_q: torch.Tensor, wd_eff: torch.Tensor,
                            b: torch.Tensor,
                            variant: str = "v1") -> torch.Tensor:
    """h (L,B,H), x_proj (B,3H) float32 of ONE token -> new states
    (L,B,H)."""
    L = h.shape[0]
    xp, out = x_proj, []
    for l in range(L):
        h_new = gru_step_q8_ref(h[l], xp, u_q[l], u_eff[l], b[l], variant)
        out.append(h_new)
        if l + 1 < L:
            xp = _deep_xp_q8(h_new, wd_q[l], wd_eff[l])
    return torch.stack(out, dim=0)


# ---------------------------------------------------------------------------
# shard-shaped step kernels (the cuda_sharded backend's per-shard compute):
# each body repeats the expressions of the JAX Pallas body and of the
# port's eager shard step (``repro_torch.core.rowparallel``) op for op, so
# on the CPU ``cuda_sharded`` equals ``sharded`` bit for bit. B batch rows,
# H the full width, Hl = H / n a shard's rows; gate-major slices.
# ---------------------------------------------------------------------------

def gru_rowwise_shard_step_ref(h_full: torch.Tensor, h_local: torch.Tensor,
                               xp: torch.Tensor, u: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """v3 row-wise step of one shard: h_full (B,H), h_local (B,Hl), xp
    (B,3Hl), u (H,3Hl), b (3Hl,) -> new local rows (B,Hl)."""
    Hl = h_local.shape[-1]
    z = torch.sigmoid(xp[:, :Hl] + h_full @ u[:, :Hl] + b[:Hl])
    r = torch.sigmoid(xp[:, Hl:2 * Hl] + h_full @ u[:, Hl:2 * Hl]
                      + b[Hl:2 * Hl])
    ht = torch.tanh(xp[:, 2 * Hl:] + r * (h_full @ u[:, 2 * Hl:]
                                          + b[2 * Hl:]))
    return (1 - z) * h_local + z * ht


def gru_rowwise_shard_zr_ref(h_full: torch.Tensor, h_local: torch.Tensor,
                             xp_zr: torch.Tensor, u_zr: torch.Tensor,
                             b_zr: torch.Tensor):
    """v1 row-wise phase 1: xp_zr (B,2Hl), u_zr (H,2Hl), b_zr (2Hl,) ->
    (z (B,Hl), r*h_local (B,Hl))."""
    Hl = h_local.shape[-1]
    z = torch.sigmoid(xp_zr[:, :Hl] + h_full @ u_zr[:, :Hl] + b_zr[:Hl])
    r = torch.sigmoid(xp_zr[:, Hl:] + h_full @ u_zr[:, Hl:] + b_zr[Hl:])
    return z, r * h_local


def gru_rowwise_shard_candidate_ref(rh_full: torch.Tensor,
                                    h_local: torch.Tensor, z: torch.Tensor,
                                    xp_h: torch.Tensor, u_h: torch.Tensor,
                                    b_h: torch.Tensor) -> torch.Tensor:
    """v1 row-wise phase 2: the gathered rh_full (B,H), xp_h (B,Hl), u_h
    (H,Hl), b_h (Hl,) -> new local rows (B,Hl)."""
    ht = torch.tanh(xp_h + rh_full @ u_h + b_h)
    return (1 - z) * h_local + z * ht


def gru_shard_matvec_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The cascade's partial product: x (B,Hl) @ w (Hl,N) -> (B,N)."""
    return x @ w


def gru_cascade_shard_gates_ref(g: torch.Tensor, xp: torch.Tensor,
                                h: torch.Tensor,
                                b: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """v3 cascade epilogue on local gate slices: g, xp (B,3Hl) or (B,3,Hl)
    gate views, h (B,Hl), optional b (3Hl,) or (3,Hl) added to g first ->
    new h shard (B,Hl). The slices are taken whole before the gate math,
    as the mesh step's copies took them."""
    B, Hl = h.shape
    g = g.reshape(B, 3, Hl)
    if b is not None:
        g = g + b.reshape(3, Hl)
    g, xp = g.reshape(B, 3 * Hl), xp.reshape(B, 3 * Hl)
    z = torch.sigmoid(xp[:, :Hl] + g[:, :Hl])
    r = torch.sigmoid(xp[:, Hl:2 * Hl] + g[:, Hl:2 * Hl])
    ht = torch.tanh(xp[:, 2 * Hl:] + r * g[:, 2 * Hl:])
    return (1 - z) * h + z * ht


def gru_cascade_shard_zr_ref(zr: torch.Tensor, xp: torch.Tensor,
                             h: torch.Tensor, u_h_rows: torch.Tensor):
    """v1 cascade middle phase: zr, xp (B,2Hl) local slices, h (B,Hl),
    u_h_rows (Hl,H) -> (z (B,Hl), (r*h) @ u_h_rows (B,H))."""
    Hl = h.shape[-1]
    z = torch.sigmoid(xp[:, :Hl] + zr[:, :Hl])
    r = torch.sigmoid(xp[:, Hl:] + zr[:, Hl:])
    return z, (r * h) @ u_h_rows


def gru_cascade_shard_update_ref(z: torch.Tensor, ht_in: torch.Tensor,
                                 h: torch.Tensor,
                                 xp_h: Optional[torch.Tensor] = None,
                                 b_h: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """v1 cascade epilogue: (1-z) h + z tanh(ht_in), all (B,Hl); where
    given, xp_h (B,Hl) and b_h (Hl,) are added to ht_in first, as JAX
    adds them: (xp + psum) + b."""
    if xp_h is not None:
        ht_in = xp_h + ht_in
    if b_h is not None:
        ht_in = ht_in + b_h
    return (1 - z) * h + z * torch.tanh(ht_in)
