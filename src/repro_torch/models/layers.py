"""Shared building blocks of the dense LM: norms, dense, RoPE, MLPs,
embeddings (counterpart of ``repro.models.layers``).

Everything is functional: ``*_specs`` returns a Spec tree; ``*_apply``
consumes the matching params. Compute dtype discipline, as in JAX: params
may be fp32 masters; activations run in ``cfg.dtype``; norms accumulate in
fp32; logits are fp32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.params import Spec, torch_dtype


def cdtype(cfg) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# --- norms -----------------------------------------------------------------

def norm_specs(d: int, kind: str = "rmsnorm") -> dict:
    s = {"scale": Spec((d,), ("embed",), init="ones")}
    if kind == "layernorm":
        s["bias"] = Spec((d,), ("embed",), init="zeros")
    return s


def norm_apply(p: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    if kind == "layernorm":
        y = y + p["bias"].float()
    return y.to(x.dtype)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Per-head qk-norm (qwen3): x (..., D_head), scale (D_head,)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# --- dense -----------------------------------------------------------------

def dense_specs(d_in: int, d_out: int,
                axes: Tuple[Optional[str], Optional[str]],
                bias: bool = False, init: str = "fan_in",
                scale: float = 1.0) -> dict:
    s = {"w": Spec((d_in, d_out), axes, init=init, scale=scale)}
    if bias:
        s["b"] = Spec((d_out,), (axes[1],), init="zeros")
    return s


def dense_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)`` in x's dtype (a no-op cast once ``prepare_params``
    has cast the weights to the compute dtype)."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# --- rotary embeddings ------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) int. The
    split-half convention: the first and second halves of D rotate as one
    complex pair per frequency."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                   # (D/2,)
    ang = positions[..., None].float() * freqs                # (..., S, D/2)
    if x.dim() == ang.dim() + 1:                              # head axis
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- MLP --------------------------------------------------------------------

def mlp_specs(d_model: int, d_ff: int, kind: str = "swiglu",
              bias: bool = False) -> dict:
    if kind == "swiglu":
        return {"wg": dense_specs(d_model, d_ff, ("embed", "mlp"), bias),
                "wu": dense_specs(d_model, d_ff, ("embed", "mlp"), bias),
                "wd": dense_specs(d_ff, d_model, ("mlp", "embed"), bias)}
    return {"w1": dense_specs(d_model, d_ff, ("embed", "mlp"), bias),
            "w2": dense_specs(d_ff, d_model, ("mlp", "embed"), bias)}


def mlp_apply(p: dict, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        h = torch.nn.functional.silu(dense_apply(p["wg"], x)) \
            * dense_apply(p["wu"], x)
        return dense_apply(p["wd"], h)
    # jax.nn.gelu defaults to the tanh approximation
    return dense_apply(p["w2"], torch.nn.functional.gelu(
        dense_apply(p["w1"], x), approximate="tanh"))


# --- embedding / unembedding -------------------------------------------------

def embed_specs(vocab: int, d_model: int) -> Spec:
    return Spec((vocab, d_model), ("vocab", "embed"), init="embed",
                scale=0.02)


def embed_apply(table: torch.Tensor, tokens: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return table[tokens.long()].to(dtype)


def unembed_apply(table_or_w: torch.Tensor, x: torch.Tensor,
                  tied: bool) -> torch.Tensor:
    """Logits in fp32."""
    w = table_or_w.to(x.dtype)
    return (x @ w.t() if tied else x @ w).float()


# --- one-time serving prep ---------------------------------------------------

def served_leaf(x: torch.Tensor, cast: bool, ct: torch.dtype,
                dev: torch.device) -> torch.Tensor:
    """One leaf of a serving prep: cast to ``ct`` where ``cast``, else kept
    in its dtype; on ``dev``. A cast that also changes the device goes a
    block of about 64 MiB of the first axis at a time, so no cast copy of
    a whole stacked leaf forms on the host (the values are the cast's)."""
    if not cast or x.dtype == ct:
        return x.to(dev)
    if x.device.type == dev.type or x.dim() < 2:
        return x.to(device=dev, dtype=ct)
    out = torch.empty(x.shape, dtype=ct, device=dev)
    rows = max(1, (64 << 20) // (x[0].numel() * x.element_size()))
    for i in range(0, x.shape[0], rows):
        out[i:i + rows].copy_(x[i:i + rows])
    return out


def _is_dense(d) -> bool:
    """A dense layer's dict (``dense_specs``' tree): ``w`` and an optional
    ``b``, both leaves."""
    return (isinstance(d, dict) and "w" in d and set(d) <= {"w", "b"}
            and not isinstance(d["w"], dict))


def dense_cast_paths(tree, path=()) -> set:
    """The leaf paths (key tuples) a serving prep casts to the compute
    dtype: ``w`` and ``b`` of every dense dict (what :func:`dense_apply`
    reads), the embedding table and ``lm_head``. A raw leaf that happens to
    be named ``b`` (the sLSTM gate bias) is not a dense dict's and is kept
    in the param dtype, as the model reads it."""
    out = set()
    if not isinstance(tree, dict):
        return out
    if _is_dense(tree):
        return {path + (k,) for k in tree}
    for k, v in tree.items():
        if not path and k in ("embed", "lm_head") and not isinstance(v, dict):
            out.add((k,))
        else:
            out |= dense_cast_paths(v, path + (k,))
    return out


def prepare_dense_params(params: dict, cfg, device="cuda", *,
                         ctx=None) -> dict:
    """One-time serving prep of a recurrent LM (xLSTM, hymba): the leaves
    of :func:`dense_cast_paths` cast to the compute dtype, every other leaf
    (norm scales, conv taps, the SSM's ``a_log``/``dt_bias``/``d_skip``,
    the sLSTM's ``r`` and ``b``, ...) kept in the param dtype, all on
    ``device``. Numerically what the per-call casts do, done once. Under a
    mesh (``ctx``) every leaf stays whole on every rank: the dense blocks
    have no tensor-parallel split in the port."""
    from repro_torch import resolve_device
    from repro_torch.core.params import _map_tree
    dev = resolve_device(device)
    ct = cdtype(cfg)
    cast = dense_cast_paths(params)
    return _map_tree(lambda path, x: served_leaf(x, path in cast, ct, dev),
                     params)


def init_prepared_dense(specs: dict, cfg, seed: int = 0,
                        device="cuda") -> dict:
    """``prepare_dense_params(init_params(specs, seed, cfg.param_dtype),
    cfg, device)`` value for value, built leaf by leaf on the CPU
    (``init_params_each``), so the param-dtype tree never exists whole."""
    from repro_torch import resolve_device
    from repro_torch.core.params import draw_workers, init_params_each
    dev = resolve_device(device)
    ct = cdtype(cfg)
    cast = dense_cast_paths(specs)
    return init_params_each(
        specs, lambda path, x: served_leaf(x, tuple(path) in cast, ct, dev),
        seed, cfg.param_dtype, draw_workers(specs, cfg.param_dtype))


# --- losses ------------------------------------------------------------------

def nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position CE ``logsumexp(logits) - logits[target]`` in fp32.
    logits (..., V), targets (...) integer."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return lse - ll


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE. logits (..., V) fp32, targets (...) int32."""
    out = nll(logits, targets)
    if mask is not None:
        m = mask.float()
        return (out * m).sum() / torch.clamp(m.sum(), min=1.0)
    return out.mean()
