"""Training loop core (counterpart of ``repro.train.trainer``): the train
step with microbatch accumulation and AdamW, and the explicit
data-parallel step with a compressed gradient exchange.

The step is eager PyTorch with autograd, as JAX's is XLA with
``value_and_grad``; JAX's ``jit_train_step`` has no counterpart beyond the
step function itself. Two step builders:

* :func:`make_train_step` — one process, the whole batch;
* :func:`make_pod_train_step` — one rank of a
  :class:`~repro_torch.distributed.mesh.Mesh` a pod: each rank computes
  the gradients of its own batch rows, exchanges them through
  ``repro_torch.distributed.compression`` (int8 + error feedback, bf16, or
  fp32), and runs the same replicated AdamW update.

State is JAX's plain dict, so checkpoints are the same trees:
``{"params", "opt": {"mu", "nu"}, "step", optional "ef"}``; the ``ef``
leaves keep JAX's ``(n_pods, ...)`` layout, and each rank keeps its own
row current (the other rows are the other ranks').

Training differentiates the plain PyTorch paths: ``backend="eager"`` for
the cell families and ``attn_impl="chunked"`` (or ``"naive"``) for the
dense LM. The CUDA kernels have no backward, so a config that routes
through them raises at :func:`make_train_step`, and every kernel wrapper
raises if it is reached under autograd anyway. Every parameter leaf must
receive a gradient: one that does not raises (JAX's ``value_and_grad``
cannot drop one, and the port does not drop one silently).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.cells import is_cell_family
from repro_torch.core.params import (Spec, _map_tree, flatten, init_params,
                                     is_spec, map_trees, unflatten)
from repro_torch.distributed import compression
from repro_torch.distributed.sharding import NO_SHARD, ShardCtx
from repro_torch.kernels._launch import no_backward_error
from repro_torch.models import api as mapi
from repro_torch.optim import adamw


def state_specs(model_cfg: ModelConfig, train_cfg: TrainConfig,
                with_ef: bool = False, n_pods: int = 1) -> dict:
    pspecs = mapi.get_api(model_cfg).specs(model_cfg)
    s = {"params": pspecs,
         "opt": adamw.opt_specs(pspecs, train_cfg.opt_dtype),
         "step": Spec((), (), init="zeros", dtype="int32")}
    if with_ef:
        s["ef"] = _map_tree(
            lambda _p, sp: Spec((n_pods,) + tuple(sp.shape),
                                ("podwise",) + tuple(sp.axes), init="zeros",
                                dtype="float32") if is_spec(sp) else sp,
            pspecs)
    return s


def _trainable(params):
    """The params as leaves that require grad (floating leaves only)."""
    return map_trees(lambda p: p if p.requires_grad or not
                     p.is_floating_point() else
                     p.detach().requires_grad_(True), params)


def init_state(model_cfg: ModelConfig, train_cfg: TrainConfig, seed: int = 0,
               with_ef: bool = False, n_pods: int = 1, *,
               device="cuda") -> dict:
    """A fresh train state on ``device`` (the card unless asked), seeded
    per path; params are leaf tensors that require grad."""
    st = init_params(state_specs(model_cfg, train_cfg, with_ef, n_pods),
                     seed, model_cfg.param_dtype, device=device)
    st["params"] = _trainable(st["params"])
    return st


def check_trainable(model_cfg: ModelConfig) -> None:
    """Raise where ``model_cfg`` would train through a CUDA kernel (which
    has no backward): a cell family on any backend but ``"eager"``, a
    dense LM on ``attn_impl="cuda"``."""
    if is_cell_family(model_cfg.family):
        if model_cfg.gru.backend != "eager":
            raise no_backward_error(f"backend={model_cfg.gru.backend!r}")
    elif model_cfg.attn_impl == "cuda":
        raise no_backward_error("attn_impl='cuda'")


def _grads(loss_fn, params, batch):
    """(grads, loss, metrics) of one batch; raises unless every parameter
    leaf received a gradient."""
    loss, metrics = loss_fn(params, batch)
    flat = flatten(params)
    names = [k for k, p in flat.items() if p.is_floating_point()]
    if not loss.requires_grad:
        missing = names
        gs = ()
    else:
        gs = torch.autograd.grad(loss, [flat[k] for k in names],
                                 allow_unused=True)
        missing = [k for k, g in zip(names, gs) if g is None]
    if missing:
        raise RuntimeError(f"no gradient reached the parameter leaves "
                           f"{missing}: a path cut autograd")
    return (dict(zip(names, gs)), loss.detach(),
            {k: v.detach() for k, v in metrics.items()})


def _micro_grads(loss_fn, params, batch, micro: int):
    """Gradient accumulation over ``micro`` microbatches: the batch split
    along its first dimension, the float32 gradients summed in order and
    divided by ``micro``, the losses and metrics averaged (JAX's
    ``lax.scan`` over the split, in the same order)."""
    params = _trainable(params)
    if micro <= 1:
        g, loss, metrics = _grads(loss_fn, params, batch)
        return unflatten(params, g), loss, metrics

    def part(x, i):
        n = x.shape[0] // micro
        return x[i * n:(i + 1) * n]
    acc, losses, metricses = None, [], []
    for i in range(micro):
        g, loss, metrics = _grads(loss_fn, params,
                                  {k: part(v, i) for k, v in batch.items()})
        g = {k: v.to(torch.float32) for k, v in g.items()}
        acc = g if acc is None else {k: acc[k] + v for k, v in g.items()}
        losses.append(loss)
        metricses.append(metrics)
    grads = unflatten(params, {k: (v / micro).to(torch.float32)
                               for k, v in acc.items()})
    metrics = {k: torch.stack([m[k] for m in metricses]).mean()
               for k in metricses[0]}
    return grads, torch.stack(losses).mean(), metrics


def _loss_fn(model_cfg: ModelConfig):
    A = mapi.get_api(model_cfg)

    def loss_fn(params, batch):
        return A.loss_fn(params, model_cfg, batch)
    return loss_fn


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    ctx: ShardCtx = NO_SHARD):
    """(state, batch) -> (state', metrics): the batch's gradients (over
    ``train_cfg.microbatches``), then AdamW. ``ctx`` is JAX's signature;
    the step runs on the state's device. Raises for a config whose
    forward runs a CUDA kernel (:func:`check_trainable`)."""
    check_trainable(model_cfg)
    loss_fn = _loss_fn(model_cfg)

    def step_fn(state, batch):
        grads, loss, metrics = _micro_grads(loss_fn, state["params"], batch,
                                            train_cfg.microbatches)
        params2, opt2, om = adamw.adamw_update(
            state["params"], grads, state["opt"], state["step"], train_cfg)
        new_state = {"params": params2, "opt": opt2,
                     "step": state["step"] + 1}
        return new_state, dict(metrics, loss=loss, **om)

    return step_fn


def make_pod_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                        mesh):
    """Explicit data parallelism over the ranks of ``mesh``, one a pod,
    with the compressed gradient exchange of
    ``train_cfg.grad_compression``: (state, this rank's batch rows) ->
    (state', metrics), the loss and metrics averaged over the ranks.
    Every rank holds the whole replicated state; with ``int8_ef`` the
    state's ``ef`` leaves are ``(mesh.size, ...)`` and this rank reads and
    writes row ``mesh.rank``. Build the rank's rows with
    ``repro_torch.data.pipeline.shard_batch(batch, mesh)``."""
    check_trainable(model_cfg)
    loss_fn = _loss_fn(model_cfg)
    method = train_cfg.grad_compression
    use_ef = method == "int8_ef"
    n = mesh.size

    def step_fn(state, batch):
        ef = (map_trees(lambda e: e[mesh.rank], state["ef"]) if use_ef
              else None)
        grads, loss, metrics = _micro_grads(loss_fn, state["params"], batch,
                                            train_cfg.microbatches)
        grads, ef2 = compression.pod_allreduce_mean(grads, method, mesh, ef)
        loss = mesh.psum(loss) / n
        metrics = {k: mesh.psum(v) / n for k, v in metrics.items()}
        params2, opt2, om = adamw.adamw_update(
            state["params"], grads, state["opt"], state["step"], train_cfg)
        new_state = {"params": params2, "opt": opt2,
                     "step": state["step"] + 1}
        if use_ef:
            def put(e, row):
                e = e.clone()
                e[mesh.rank] = row
                return e
            new_state["ef"] = map_trees(put, state["ef"], ef2)
        return new_state, dict(metrics, loss=loss, **om)

    return step_fn
