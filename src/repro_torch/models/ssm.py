"""Selective SSM (Mamba-style) mixer: hymba's parallel-head SSM path
(counterpart of ``repro.models.ssm``).

The decode step ``h' = A_bar * h + B_bar * x`` is the paper's latency
regime: the input-dependent projections (delta, B, C: the analogue of the
decoupled ``W.x``) are computed off the recurrent path, and the state
update is an elementwise and small-matvec recurrence over the inner
dimension.

The full-sequence mixer runs the state recurrence as a plain PyTorch loop
over time (JAX's ``lax.scan``; the JAX package has no kernel for it, so
none is ported), after every input-dependent projection ran as one
sequence-level product; the decays of a chunk of steps are formed at
once, so the loop is one ``addcmul`` a step (``_scan``). Dtypes follow
JAX's promotion: the state, ``dt`` and ``A`` are float32, the
activations the compute dtype.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.params import Spec
from repro_torch.models.layers import dense_apply, dense_specs


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_inner, dt_rank, s.state_dim


def ssm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, dtr, n = _dims(cfg)
    w = cfg.ssm.conv_width
    return {
        "in_proj": dense_specs(d, 2 * di, ("embed", "gates")),  # x and z
        "conv": Spec((w, di), ("conv", "gates"), init="fan_in"),
        "conv_b": Spec((di,), ("gates",), init="zeros"),
        "x_proj": dense_specs(di, dtr + 2 * n, ("gates", "dt")),
        "dt_proj": dense_specs(dtr, di, ("dt", "gates"), init="fan_in"),
        "dt_bias": Spec((di,), ("gates",), init="zeros"),
        "a_log": Spec((di, n), ("gates", "state"),
                      init="zeros"),                         # A = -exp(a_log)-1
        "d_skip": Spec((di,), ("gates",), init="ones"),
        "out_proj": dense_specs(di, d, ("gates", "embed")),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,Di), kernel: (W,Di) -> (B,S,Di), in
    x's dtype, the taps summed in JAX's order."""
    W = kernel.shape[0]
    kernel = kernel.to(x.dtype)
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for w in range(W):
        out = out + xp[:, w:w + x.shape[1], :] * kernel[w][None, None, :]
    return out + bias.to(x.dtype)[None, None, :]


def _ssm_params(p: dict, xc: torch.Tensor, cfg: ModelConfig):
    """Input-dependent (decoupled) projections. xc: (...,Di) -> dt (...,Di)
    float32, A (Di,N) float32, B and C (...,N) in xc's dtype."""
    di, dtr, n = _dims(cfg)
    proj = dense_apply(p["x_proj"], xc)
    dt_in, B, C = torch.split(proj, [dtr, n, n], dim=-1)
    # the float32 dt_bias promotes the sum to float32, as in JAX
    dt = F.softplus(dense_apply(p["dt_proj"], dt_in) + p["dt_bias"])
    A = -torch.exp(p["a_log"].float()) - 1.0                # (Di,N), stable
    return dt, A, B, C


SCAN_CHUNK = 256        # time steps whose decays are formed at once


def _state_step(h, xct, dtt, Bt, Ct, A):
    """One step of the state recurrence: (B,Di,N) state -> (state, y
    (B,Di) float32)."""
    dA = torch.exp(dtt[..., None].float() * A[None])                 # (B,Di,N)
    dBx = (dtt * xct)[..., None].float() * Bt[:, None, :]
    h = dA * h + dBx
    y = torch.einsum("bdn,bn->bd", h, Ct.float())
    return h, y


def _scan(xc, dt, Bm, Cm, A, h):
    """The state recurrence over a sequence: xc, dt (B,S,Di), B/C (B,S,N),
    h (B,Di,N) float32 -> (y (B,S,Di) float32, the last state). The same
    products as :func:`_state_step`, step by step, but the decays and
    inputs of ``SCAN_CHUNK`` steps are formed at once, so a step is one
    ``addcmul`` (``dBx + dA * h``) and the readout one product a chunk."""
    B_, S, di = xc.shape
    ys = []
    for t0 in range(0, S, SCAN_CHUNK):
        t1 = min(t0 + SCAN_CHUNK, S)
        dtc = dt[:, t0:t1]
        dA = torch.exp(dtc[..., None].float() * A)                  # (B,T,Di,N)
        dBx = (dtc * xc[:, t0:t1])[..., None].float() * Bm[:, t0:t1, None, :]
        hs = torch.empty_like(dA)
        for t in range(t1 - t0):
            h = torch.addcmul(dBx[:, t], dA[:, t], h, out=hs[:, t])
        ys.append(torch.einsum("btdn,btn->btd", hs, Cm[:, t0:t1].float()))
        h = hs[:, -1].clone()
    return torch.cat(ys, 1), h


def ssm_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              return_state: bool = False):
    """Full-sequence mixer: x (B,S,D) -> (B,S,D).

    ``return_state=True`` also returns the decode cache after the last
    position ({conv_buf (B,W-1,Di), state (B,Di,N) float32}): the last W-1
    inputs of the conv, zero-padded in front when S < W-1."""
    B_, S, _ = x.shape
    di, dtr, n = _dims(cfg)
    xz = dense_apply(p["in_proj"], x)
    xi, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(_causal_conv(xi, p["conv"], p["conv_b"]))
    dt, A, Bm, Cm = _ssm_params(p, xc, cfg)    # dt (B,S,Di), B/C (B,S,N)
    h0 = torch.zeros((B_, di, n), dtype=torch.float32, device=x.device)
    ys, h = _scan(xc, dt, Bm, Cm, A, h0)
    y = ys.to(x.dtype) + xc * p["d_skip"].to(x.dtype)[None, None, :]
    y = y * F.silu(z)
    out = dense_apply(p["out_proj"], y)
    if not return_state:
        return out
    return out, {"conv_buf": conv_tail(xi, cfg.ssm.conv_width), "state": h}


def conv_tail(xi: torch.Tensor, w: int) -> torch.Tensor:
    """The conv's decode buffer after a prompt: the last ``w - 1`` inputs
    of xi (B,S,Di), zero-padded in front when S < w - 1."""
    S = xi.shape[1]
    pad = max(w - 1 - S, 0)
    tail = xi[:, S - (w - 1 - pad):, :]
    return F.pad(tail, (0, 0, pad, 0)) if pad else tail


# --- decode -----------------------------------------------------------------

def ssm_cache_specs(cfg: ModelConfig, batch: int, layers_axis: int = 0) -> dict:
    di, _, n = _dims(cfg)
    w = cfg.ssm.conv_width
    lead = (layers_axis,) if layers_axis else ()
    lax_ = ("layers",) if layers_axis else ()
    return {
        "conv_buf": Spec(lead + (batch, w - 1, di),
                         lax_ + ("batch", None, "gates"), init="zeros",
                         dtype=cfg.dtype),
        "state": Spec(lead + (batch, di, n), lax_ + ("batch", "gates", "state"),
                      init="zeros", dtype="float32"),
    }


def conv_step(buf: torch.Tensor, x_t: torch.Tensor, kernel: torch.Tensor,
              bias: torch.Tensor):
    """One token through the causal conv from its buffer: buf (B,W-1,Di),
    x_t (B,Di) -> (conv (B,Di) in buf's dtype, the window (B,W,Di))."""
    window = torch.cat([buf, x_t[:, None, :].to(buf.dtype)], dim=1)
    conv = ((window * kernel.to(buf.dtype)[None]).sum(1)
            + bias.to(buf.dtype))
    return conv, window


def ssm_decode_step(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """One token: x (B,1,D) -> (y (B,1,D), new cache). The recurrent state
    update is the paper's latency regime (row-parallel over Di)."""
    xz = dense_apply(p["in_proj"], x[:, 0])                  # (B,2Di)
    xi, z = torch.chunk(xz, 2, dim=-1)
    conv, window = conv_step(cache["conv_buf"], xi, p["conv"], p["conv_b"])
    xc = F.silu(conv)
    dt, A, Bm, Cm = _ssm_params(p, xc, cfg)   # (B,Di),(Di,N),(B,N),(B,N)
    h, y = _state_step(cache["state"], xc, dt, Bm, Cm, A)
    y = y.to(x.dtype) + xc * p["d_skip"].to(x.dtype)[None, :]
    y = y * F.silu(z)
    out = dense_apply(p["out_proj"], y)[:, None, :]
    return out, {"conv_buf": window[:, 1:], "state": h}
