"""Mixture-of-Experts: sort-based capacity dispatch (counterpart of
``repro.models.moe``, its one-device path).

Tokens are sorted by expert id (stable, so each expert keeps its tokens in
token order), scattered into a static ``(E, C, D)`` capacity buffer (a
token past its expert's C slots is dropped), run through every expert's
SwiGLU as three batched products in the compute dtype, gathered back and
combined with the router weights. At decode this is the paper's latency
regime: per-expert matvecs at tiny token counts; the batched products read
every expert's weights whether or not a token chose it, as JAX's einsum
does.

JAX's expert-parallel and tensor-parallel mesh path (``all_to_all`` over
the data axis, the expert hidden dim over the model axis) is not ported:
``moe_apply`` under a mesh raises (ROADMAP queue 1, item 3). Routing,
sort and scatter are XLA ops in JAX and plain torch ops here; so are the
expert products (einsums in JAX, outside any Pallas kernel).

``moe_ref`` routes without capacity (a loop over experts, fp32): the
oracle the capacity path is held to with a factor high enough to drop
nothing.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.params import Spec
from repro_torch.distributed.sharding import NO_SHARD, ShardCtx
from repro_torch.models import layers

NEG_INF = -1e30


def padded_experts(m: MoEConfig, multiple: int = 16) -> int:
    """Pad the expert count to a multiple of ``multiple`` (JAX pads it so
    it divides any expert-parallel axis up to 16; the port keeps the tree
    JAX's)."""
    return -(-m.num_experts // multiple) * multiple


def moe_specs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    E = padded_experts(m)
    s = {"router": Spec((d, E), init="fan_in", scale=0.1),
         "wg": Spec((E, d, m.d_expert)),
         "wu": Spec((E, d, m.d_expert)),
         "wd": Spec((E, m.d_expert, d))}
    if m.shared_d_ff:
        s["shared"] = layers.mlp_specs(d, m.shared_d_ff, "swiglu")
        s["shared_gate"] = Spec((d, 1), init="fan_in")
    return s


def _capacity(tokens_local: int, top_k: int, E: int, factor: float) -> int:
    return max(1, math.ceil(tokens_local * top_k / E * factor))


def _dispatch_compute_combine(x, probs, eidx, wg, wu, wd, *, E: int, C: int,
                              compute_dtype) -> torch.Tensor:
    """One device's MoE: x (T,D) -> (T,D) in ``compute_dtype``.

    The (token, choice) pairs are sorted stably by expert; a pair's slot
    is e*C + its position among the expert's pairs, and a pair at position
    C or beyond is dropped. The buffer has a spare row ``E*C`` that takes
    the dropped pairs (JAX's ``mode="drop"``) and is cut off before the
    products; a dropped pair gathers 0 (JAX's ``mode="fill"``)."""
    T, D = x.shape
    k = eidx.shape[-1]
    N = T * k
    flat_e = eidx.reshape(N)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // k                                    # token of each pair
    sp = probs.reshape(N)[order]
    seg_start = torch.searchsorted(
        se, torch.arange(E, dtype=se.dtype, device=se.device))
    pos = torch.arange(N, device=se.device) - seg_start[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, torch.full_like(se, E * C))

    buf = torch.zeros((E * C + 1, D), dtype=compute_dtype, device=x.device)
    buf.index_copy_(0, slot, x[st].to(compute_dtype))
    buf = buf[:E * C].reshape(E, C, D)
    g = torch.bmm(buf, wg.to(compute_dtype))
    u = torch.bmm(buf, wu.to(compute_dtype))
    y = torch.bmm(F.silu(g) * u, wd.to(compute_dtype))
    gathered = y.reshape(E * C, D)[torch.where(keep, slot, 0)]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=compute_dtype,
                                       device=x.device))
    out = torch.zeros((T, D), dtype=compute_dtype, device=x.device)
    return out.index_add_(0, st, gathered * sp[:, None].to(compute_dtype))


def route(p: dict, m: MoEConfig, xf: torch.Tensor):
    """Router of the tokens xf (T,D): fp32 logits with the padding experts
    masked, softmax, top-k (renormalized where ``norm_topk_prob``).
    Returns (probs_full (T,E), top_p (T,k), top_i (T,k))."""
    E = padded_experts(m)
    logits = xf.float() @ p["router"].float()
    if E > m.num_experts:
        pad = torch.arange(E, device=xf.device) < m.num_experts
        logits = torch.where(pad[None, :], logits,
                             torch.full_like(logits, NEG_INF))
    probs_full = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs_full, m.top_k, dim=-1)
    if m.norm_topk_prob:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs_full, top_p, top_i


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              ctx: ShardCtx = NO_SHARD) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (out (B,S,D), the aux load-balance loss, an fp32
    scalar). One device only: under a mesh it raises."""
    if ctx.mesh is not None:
        raise NotImplementedError(
            "moe_apply under a mesh: the expert-parallel path is not ported "
            "(ROADMAP queue 1, item 3)")
    m = cfg.moe
    B, S, D = x.shape
    E = padded_experts(m)
    xf = x.reshape(B * S, D)
    probs_full, top_p, top_i = route(p, m, xf)

    # load-balance aux (Switch): E * sum_e f_e * P_e
    occupancy = torch.zeros(E, dtype=torch.float32, device=x.device)
    occupancy.index_add_(0, top_i.reshape(-1),
                         torch.ones(top_i.numel(), device=x.device))
    f_e = occupancy / (B * S * m.top_k)
    P_e = probs_full.mean(0)
    aux = m.num_experts * torch.sum(f_e * P_e) * m.router_aux_coef

    C = _capacity(B * S, m.top_k, E, m.capacity_factor)
    out = _dispatch_compute_combine(xf, top_p, top_i, p["wg"], p["wu"],
                                    p["wd"], E=E, C=C,
                                    compute_dtype=layers.cdtype(cfg))
    out = out.to(x.dtype)
    if m.shared_d_ff:
        gate = torch.sigmoid(xf.float() @ p["shared_gate"].float())
        shared = layers.mlp_apply(p["shared"], x, "swiglu")
        out = out + shared.reshape(B * S, D) * gate.to(x.dtype)
    return out.reshape(B, S, D), aux


# --- oracle ------------------------------------------------------------------

def moe_ref(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """No-capacity fp32 reference: loop over experts, mask-select tokens."""
    m = cfg.moe
    B, S, D = x.shape
    xf = x.reshape(-1, D).float()
    _, top_p, top_i = route(p, m, xf)
    out = torch.zeros_like(xf)
    for e in range(m.num_experts):
        w = torch.where(top_i == e, top_p, torch.zeros_like(top_p)).sum(-1)
        g = F.silu(xf @ p["wg"][e].float())
        u = xf @ p["wu"][e].float()
        y = (g * u) @ p["wd"][e].float()
        out = out + y * w[:, None]
    if m.shared_d_ff:
        gate = torch.sigmoid(xf @ p["shared_gate"].float())
        shared = layers.mlp_apply(p["shared"], x.float(), "swiglu")
        out = out + shared.reshape(-1, D) * gate
    return out.reshape(B, S, D).to(x.dtype)
