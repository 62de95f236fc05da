"""Plain PyTorch version of the q8 single-step kernel (counterpart of
``repro.kernels.gru_cell.ref``'s ``gru_step_q8_ref``), with the kernel's
raw-array interface: h (B,H) float32 state, xp (B,3H) float32 input
projection, u_q (3H,H) int8 weight rows with per-row dequant scales u_eff
(3H,) (activation scale folded in; see
``repro_torch.core.params.quantize_rows_int8``), b (3H,).

Quantized activations stay integer-valued float32, so float32 products sum
the kernel's int32 dot products exactly while ``H * 127 * 127 < 2**24``
(:data:`Q8_EXACT_MAX_H`). Every other operation is a separate, rounded
float32 op in the order of the JAX kernels' q8 gate math (``acc * eff +
b``; ``r * h`` before ``* 127``; ``(1 - z) * h + z * ht``), which the CUDA
kernels repeat without contracting any multiply-add. The fused and chain
q8 plain versions in ``repro_torch.kernels.gru_sequence.ref`` are built on
this step.
"""
from __future__ import annotations

import torch

Q8_EXACT_MAX_H = 1039    # H * 127 * 127 < 2**24: float32 sums stay exact


def check_q8_width(H: int, device: torch.device) -> None:
    """The plain q8 versions sum int8 products in float32: exact only up to
    :data:`Q8_EXACT_MAX_H`, so the CPU path refuses wider states."""
    if device.type == "cpu" and H > Q8_EXACT_MAX_H:
        raise ValueError(
            f"H={H}: the plain q8 version sums int8 products in float32, "
            f"exact only for H <= {Q8_EXACT_MAX_H}")


def _q8_act(a: torch.Tensor) -> torch.Tensor:
    """Fixed-scale activation quantization kept in float32: round half to
    even, then clip to [-127, 127] (integer-valued result)."""
    return torch.clamp(torch.round(a * 127.0), -127.0, 127.0)


def _q8_dot(aq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """aq (B,K) integer-valued float32 against int8 rows wq (N,K) -> (B,N),
    exact in float32 at K <= Q8_EXACT_MAX_H."""
    return aq @ wq.to(torch.float32).t()


def gru_step_q8_ref(h: torch.Tensor, xp: torch.Tensor, u_q: torch.Tensor,
                    u_eff: torch.Tensor, b: torch.Tensor,
                    variant: str = "v1") -> torch.Tensor:
    """One q8 cell update: h (B,H) float32 state, xp (B,3H) float32, u_q
    (3H,H) int8 rows, u_eff (3H,), b (3H,) -> (B,H) float32."""
    H = h.shape[-1]
    xz, xr, xh = xp[..., :H], xp[..., H:2 * H], xp[..., 2 * H:]
    hq = _q8_act(h)
    if variant == "v3":
        ua = _q8_dot(hq, u_q) * u_eff + b
        z = torch.sigmoid(xz + ua[..., :H])
        r = torch.sigmoid(xr + ua[..., H:2 * H])
        ht = torch.tanh(xh + r * ua[..., 2 * H:])
    else:
        zr = _q8_dot(hq, u_q[:2 * H]) * u_eff[:2 * H] + b[:2 * H]
        z = torch.sigmoid(xz + zr[..., :H])
        r = torch.sigmoid(xr + zr[..., H:])
        cand = (_q8_dot(_q8_act(r * h), u_q[2 * H:]) * u_eff[2 * H:]
                + b[2 * H:])
        ht = torch.tanh(xh + cand)
    return (1.0 - z) * h + z * ht
