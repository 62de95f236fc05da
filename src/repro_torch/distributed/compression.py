"""Gradient compression for slow (cross-pod) links, with error feedback
(counterpart of ``repro.distributed.compression``).

Used by the trainer's explicit data-parallel step
(``repro_torch.train.trainer.make_pod_train_step``): one rank of a
:class:`~repro_torch.distributed.mesh.Mesh` a pod, each computing the
gradients of its own batch rows, exchanged with a quantized all-reduce:

* ``int8_ef`` — int8 codes on the wire (4x fewer bytes than fp32): the
  scale is agreed FIRST with a ``pmax`` of the ranks' max-abs (one scalar
  per leaf), every rank quantizes with that shared scale, the sum runs on
  int32, and the quantization residual feeds back into the next step's
  gradient (error feedback keeps the compression unbiased over time);
* ``bf16`` — round to bf16, reduce in fp32 (JAX's choice, kept);
* ``none`` — plain fp32 sum.

The arithmetic is JAX's, op for op, so the codes are JAX's codes bit for
bit on the same gradients.
"""
from __future__ import annotations

import torch

from repro_torch.core.params import flatten, unflatten


def int8_scale(gc: torch.Tensor, mesh) -> torch.Tensor:
    """The scale every rank quantizes leaf ``gc`` with: the max over the
    ranks of ``max(max|gc|, 1e-12) / 127``."""
    scale = torch.clamp(gc.abs().max(), min=1e-12) / 127.0
    return mesh.pmax(scale)


def int8_codes(gc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(gc / scale), -127, 127)`` as int8 (round half to even,
    as ``jnp.round``)."""
    return torch.clamp(torch.round(gc / scale), -127, 127).to(torch.int8)


def pod_allreduce_mean(grads, method: str, mesh, ef=None):
    """All-reduce-mean a gradient tree across the ranks of ``mesh``.

    Returns (mean_grads, new_error_feedback). ``ef`` (this rank's residual
    tree, zeros at the first step) is required by ``int8_ef`` and returned
    as it is by the other methods."""
    n = mesh.size
    fg = flatten(grads)

    if method in ("none", "bf16"):
        def red(g):
            if method == "bf16":
                g = g.to(torch.bfloat16).to(g.dtype)
            return mesh.psum(g) / n
        return unflatten(grads, {k: red(g) for k, g in fg.items()}), ef

    if method == "int8_ef":
        if ef is None:
            raise ValueError("int8_ef needs an error-feedback tree")
        fe = flatten(ef)
        means, efs = {}, {}
        for k, g in fg.items():
            gc = g + fe[k]                                # apply EF residual
            scale = int8_scale(gc, mesh)                  # agree on the scale
            q = int8_codes(gc, scale)
            efs[k] = gc - q.to(g.dtype) * scale           # residual stays local
            means[k] = (mesh.psum(q.to(torch.int32)).to(g.dtype) * scale / n)
        return unflatten(grads, means), unflatten(grads, efs)

    raise ValueError(f"unknown compression method {method!r}")


def compressed_bytes_per_param(method: str) -> float:
    """Wire bytes per gradient element (roofline accounting)."""
    return {"none": 4.0, "bf16": 2.0, "int8_ef": 1.0}[method]
