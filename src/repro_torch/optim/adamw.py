"""AdamW by hand (counterpart of ``repro.optim.adamw``): decoupled weight
decay, global-norm clipping, warmup then cosine to 0.1 x lr, optional
low-precision moments.

The arithmetic and its order are JAX's, leaf by leaf in JAX's leaf order
(``repro_torch.core.params.flatten``): clip first, then the schedule, the
bias corrections ``1 - b**(step + 1)``, the moments in float32 stored in
``opt_dtype``, and ``p - lr * (step + wd * p)`` on every leaf. The state
is JAX's ``{"mu", "nu"}`` trees, so a checkpoint of either package
restores in the other. ``torch.optim.AdamW`` is not used: its state
layout and its update order differ. Everything runs on the params'
device; ``lr`` and ``grad_norm`` come back as 0-dim float32 tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.params import (Spec, _map_tree, flatten, is_spec,
                                     leaves, map_trees, torch_dtype,
                                     unflatten)


def opt_specs(param_specs, dtype: str = "float32") -> dict:
    """Mirrored Spec trees for the Adam moments."""
    def f(_path, s):
        return (Spec(tuple(s.shape), s.axes, init="zeros", dtype=dtype)
                if is_spec(s) else s)
    return {"mu": _map_tree(f, param_specs), "nu": _map_tree(f, param_specs)}


def init_opt_state(params, dtype: str = "float32") -> dict:
    dt = torch_dtype(dtype)

    def z(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"mu": map_trees(z, params), "nu": map_trees(z, params)}


def lr_schedule(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.1 * cfg.learning_rate + 0.9 * cfg.learning_rate * 0.5 * (
        1.0 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return map_trees(lambda g: g * scale.to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(params, grads, opt_state, step: torch.Tensor,
                 cfg: TrainConfig):
    """One AdamW step. Returns (params', opt_state', metrics): new tensors,
    the inputs untouched; a param leaf that required grad comes back as a
    fresh leaf that requires grad."""
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip)
    lr = lr_schedule(step, cfg)
    b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
    t = step.to(torch.float32) + 1.0
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=t.device), t)

    def upd(p, g, mu, nu):
        g32 = g.to(torch.float32)
        mu32 = mu.to(torch.float32) * b1 + (1 - b1) * g32
        nu32 = nu.to(torch.float32) * b2 + (1 - b2) * g32 * g32
        step_ = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + eps)
        p32 = p.detach().to(torch.float32)
        p_new = (p32 - lr * (step_ + cfg.weight_decay * p32)).to(p.dtype)
        return (p_new.requires_grad_(p.requires_grad), mu32.to(mu.dtype),
                nu32.to(nu.dtype))

    fp, fg = flatten(params), flatten(grads)
    fmu, fnu = flatten(opt_state["mu"]), flatten(opt_state["nu"])
    out = {k: upd(fp[k], fg[k], fmu[k], fnu[k]) for k in fp}

    def pick(i):
        return unflatten(params, {k: o[i] for k, o in out.items()})
    return pick(0), {"mu": pick(1), "nu": pick(2)}, {"lr": lr,
                                                     "grad_norm": gn}
