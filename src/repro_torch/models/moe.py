"""Mixture-of-Experts: sort-based capacity dispatch + expert parallelism
(counterpart of ``repro.models.moe``).

Tokens are sorted by expert id (stable, so each expert keeps its tokens in
token order), scattered into a static ``(E, C, D)`` capacity buffer (a
token past its expert's C slots is dropped), run through every expert's
SwiGLU as three batched products in the compute dtype, gathered back and
combined with the router weights. At decode this is the paper's latency
regime: per-expert matvecs at tiny token counts; the batched products read
every expert's weights whether or not a token chose it, as JAX's einsum
does.

Under a mesh (``ctx=ShardCtx(mesh)``) each rank runs JAX's ``shard_map``
body on its block: its tokens by ``resolve_pspec(("batch", None))``
(over ``pod`` and ``data``, plus ``model`` under the ``sp`` profile), its
experts over ``data`` and its slice of the expert hidden dim over
``model``. The capacity buffer goes to the experts' owners and back by an
``all_to_all`` over ``data``; the expert TP over ``model`` closes by a
``psum`` (``tp_mode="psum"``), or gathers the F-slices of the rank's
experts and splits the tokens instead (``"gather"``; ``"gather_sp"``
under ``sp``, where the tokens come split). An all-gather over the token
axes gives every rank the whole output, as ``out_specs`` does. The mesh
path serves; it refuses autograd. Routing, sort and scatter are XLA ops
in JAX and plain torch ops here; so are the expert products (einsums in
JAX, outside any Pallas kernel).

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
from repro_torch.distributed.sharding import (NO_SHARD, ShardCtx, block,
                                              block_index, entry_axes,
                                              resolve_pspec)
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
    s = {"router": Spec((d, E), ("embed", "experts"), init="fan_in",
                        scale=0.1),
         "wg": Spec((E, d, m.d_expert), ("experts", "embed", "expert_mlp")),
         "wu": Spec((E, d, m.d_expert), ("experts", "embed", "expert_mlp")),
         "wd": Spec((E, m.d_expert, d), ("experts", "expert_mlp", "embed"))}
    if m.shared_d_ff:
        s["shared"] = layers.mlp_specs(d, m.shared_d_ff, "swiglu")
        s["shared_gate"] = Spec((d, 1), ("embed", None), init="fan_in")
    return s


def _capacity(tokens_local: int, top_k: int, E: int, factor: float) -> int:
    return max(1, math.ceil(tokens_local * top_k / E * factor))


def _dispatch_compute_combine(x, probs, eidx, wg, wu, wd, *, E: int, C: int,
                              compute_dtype, mesh=None, ep_axis=None,
                              tp_axis=None, ep_size: int = 1,
                              tp_mode: str = "psum", tp_size: int = 1
                              ) -> torch.Tensor:
    """One rank's MoE: x (T,D) -> (T,D) in ``compute_dtype`` (JAX's
    ``shard_map`` body, or the whole layer without a mesh).

    The (token, choice) pairs are sorted stably by expert; a pair's slot
    is e*C + its position among the expert's pairs, and a pair at position
    C or beyond is dropped; each token sums its pairs' outputs in
    ascending expert order. The buffer has a spare row ``E*C`` that takes
    the dropped pairs (JAX's ``mode="drop"``) and is cut off before the
    products; a dropped pair gathers 0 (JAX's ``mode="fill"``).

    ``ep_axis``: the buffer goes to the experts' owners over this mesh axis
    and back (``wg``, ``wu``, ``wd`` hold this rank's ``E/ep_size``
    experts). ``tp_axis``: the weights hold a slice of the expert hidden
    dim over this axis, and ``tp_mode`` says how the slices meet:
    ``"psum"`` -- every rank of the axis runs all its tokens on its slice
    and the outputs are summed; ``"gather"`` -- the tokens are split over
    the axis, the slices gathered, the capacity cut to ``C // tp_size``
    and the outputs gathered (where the tokens do not split evenly it
    falls through to ``"psum"``, as in JAX); ``"gather_sp"`` -- the tokens
    come split already, so only the slices are gathered."""
    def whole_experts(axis):       # the rank's experts whole on ``axis``
        return (mesh.all_gather(wg, 2, axis), mesh.all_gather(wu, 2, axis),
                mesh.all_gather(wd, 1, axis))

    if tp_mode == "gather_sp" and tp_axis is not None and tp_size > 1:
        wg, wu, wd = whole_experts(tp_axis)
        return _dispatch_compute_combine(
            x, probs, eidx, wg, wu, wd, E=E, C=C, compute_dtype=compute_dtype,
            mesh=mesh, ep_axis=ep_axis, tp_axis=None, ep_size=ep_size)
    if (tp_mode == "gather" and tp_axis is not None and tp_size > 1
            and x.shape[0] % tp_size == 0):
        n = tp_size
        i = mesh.axis_index(tp_axis)
        Tm = x.shape[0] // n
        x, probs, eidx = (t[i * Tm:(i + 1) * Tm] for t in (x, probs, eidx))
        wg, wu, wd = whole_experts(tp_axis)
        out = _dispatch_compute_combine(
            x, probs, eidx, wg, wu, wd, E=E, C=max(1, C // n),
            compute_dtype=compute_dtype, mesh=mesh, ep_axis=ep_axis,
            tp_axis=None, ep_size=ep_size)
        return mesh.all_gather(out, 0, tp_axis)

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
    if ep_axis is not None and ep_size > 1:
        # every rank keeps its E/ep experts and receives every rank's
        # capacity slices for them: (E/ep, C*ep, D)
        buf = mesh.all_to_all(buf, 0, 1, ep_axis)
    g = torch.bmm(buf, wg.to(compute_dtype))
    u = torch.bmm(buf, wu.to(compute_dtype))
    y = torch.bmm(F.silu(g) * u, wd.to(compute_dtype))
    if tp_axis is not None:
        y = mesh.psum(y, tp_axis)                      # close the TP slices
    if ep_axis is not None and ep_size > 1:
        y = mesh.all_to_all(y, 1, 0, ep_axis)          # (E, C, D)
    gathered = y.reshape(E * C, D)[torch.where(keep, slot, 0)]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=compute_dtype,
                                       device=x.device))
    # combine: each token's pairs summed in ascending expert order from 0,
    # the order of JAX's scatter-add over the sorted pairs, in k adds (no
    # atomics, so every rank that combines the same tokens gets the same
    # bits)
    pairs = torch.empty((N, D), dtype=compute_dtype, device=x.device)
    pairs[order] = gathered * sp[:, None].to(compute_dtype)
    pairs = pairs.view(T, k, D)
    by_expert = eidx.argsort(dim=-1, stable=True)
    rows = torch.arange(T, device=x.device)
    out = torch.zeros((T, D), dtype=compute_dtype, device=x.device)
    for j in range(k):
        out = out + pairs[rows, by_expert[:, j]]
    return out


EXPERT_AXES = {"wg": ("experts", "embed", "expert_mlp"),
               "wu": ("experts", "embed", "expert_mlp"),
               "wd": ("experts", "expert_mlp", "embed")}


def expert_shapes(cfg: ModelConfig) -> dict:
    """The whole (unstacked) shapes of ``wg``, ``wu`` and ``wd``."""
    E, D, Fx = padded_experts(cfg.moe), cfg.d_model, cfg.moe.d_expert
    return {"wg": (E, D, Fx), "wu": (E, D, Fx), "wd": (E, Fx, D)}


def local_experts(key: str, x: torch.Tensor, cfg: ModelConfig,
                  ctx: ShardCtx) -> torch.Tensor:
    """This rank's block of expert leaf ``key`` (``wg``, ``wu`` or ``wd``,
    one layer's or stacked ``(L, ...)``) by the specs of JAX's in-specs;
    a leaf that is already a block passes through."""
    whole = expert_shapes(cfg)[key]
    lead = tuple(x.shape[:x.dim() - 3])
    if tuple(x.shape[-3:]) != whole:
        return x
    ps = resolve_pspec((None,) * len(lead) + EXPERT_AXES[key], lead + whole,
                       ctx)
    return block(x, ps, ctx.mesh)


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
    scalar). Under a mesh every rank passes the same x and gets the whole
    output; ``p``'s experts may be whole or this rank's blocks
    (:func:`local_experts`)."""
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

    ep_size = ctx.axis_size("data")
    tp_size = ctx.axis_size("model")
    T_local = (B * S) // (ctx.axis_size("pod") * max(ep_size, 1))
    # sp profile: the sequence axis is model-sharded end to end, so the MoE
    # sees pre-sliced tokens and never exchanges token buffers on "model"
    sp_tokens = (ctx.profile == "sp" and m.tp_mode == "gather"
                 and tp_size > 1 and T_local % tp_size == 0)
    if sp_tokens:
        T_local //= tp_size
    C = _capacity(T_local, m.top_k, E, m.capacity_factor)
    compute = layers.cdtype(cfg)

    if ctx.mesh is None:
        out = _dispatch_compute_combine(xf, top_p, top_i, p["wg"], p["wu"],
                                        p["wd"], E=E, C=C,
                                        compute_dtype=compute)
    else:
        _refuse_autograd(p, x)
        mesh = ctx.mesh
        tok_spec = resolve_pspec(("batch", None), (B * S, D), ctx)
        tok_axes = entry_axes(tok_spec[0] if len(tok_spec) else None)
        if sp_tokens:
            tok_axes = (*tok_axes, "model")
        i, n = block_index(mesh, tok_axes)
        Tl = (B * S) // n
        rows = slice(i * Tl, (i + 1) * Tl)
        w = {k: local_experts(k, p[k], cfg, ctx) for k in EXPERT_AXES}
        out = _dispatch_compute_combine(
            xf[rows], top_p[rows], top_i[rows], w["wg"], w["wu"], w["wd"],
            E=E, C=C, compute_dtype=compute, mesh=mesh,
            ep_axis="data" if ep_size > 1 else None,
            tp_axis="model" if tp_size > 1 else None, ep_size=ep_size,
            tp_mode="gather_sp" if sp_tokens else m.tp_mode,
            tp_size=tp_size)
        for ax in reversed(tok_axes):     # out_specs=tok_spec: minor first
            out = mesh.all_gather(out, 0, ax)
    out = out.to(x.dtype)
    if m.shared_d_ff:
        gate = torch.sigmoid(xf.float() @ p["shared_gate"].float())
        shared = layers.mlp_apply(p["shared"], x, "swiglu")
        out = out + shared.reshape(B * S, D) * gate.to(x.dtype)
    return out.reshape(B, S, D), aux


def _refuse_autograd(p: dict, x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in (p["router"], p["wg"], p["wu"],
                                      p["wd"]))):
        raise NotImplementedError(
            "moe_apply under a mesh serves and has no backward: training "
            "under a multi-axis mesh is ROADMAP queue 1, item 4")


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
