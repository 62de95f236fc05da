"""The recurrent-stack executor: compile/execute over capability-dispatched
backends keyed by ``(cell family, backend)`` (counterpart of
``repro.core.runtime``).

* ``compile(cfg, batch=..., seq=..., mask=...) -> GRUExecutable``
  resolves which backend serves each op; executables are memoized, so the
  same key returns the same object.
* ``prepare(params, cfg, device=...) -> StackParams`` normalizes any
  accepted parameter layout, puts it on the device and builds the fused
  kernels' weight stacks once, so no execute call restacks weights.
* ``executable.sequence / prefill / decode`` run against those params.

Backend names map from the JAX package as follows:

=================  ===============  ========================================
JAX name           port name        what runs
=================  ===============  ========================================
``xla``            ``eager``        eager PyTorch (``repro_torch.core.gru``)
``pallas`` (pref)  ``cuda`` (pref)  the ``cuda*`` backends
``pallas_fused``   ``cuda_fused``   the fused CUDA kernels (one launch per
                                    prefill, one per decode step)
=================  ===============  ========================================

Capability table for ``family="gru"`` (``cost`` is the static preference,
lower = preferred)::

    backend     mask  hetero  cost
    cuda_fused  yes   no      10
    eager       yes   yes     30

Both serve sequences (prefill) and decode steps, with ``return_all``.

``cfg.backend`` is a preference: ``"eager"`` (the default, as ``"xla"`` is
in the JAX config) and ``"cuda"`` pin their family when legal, an exact
backend name pins that backend, and ``"auto"`` picks the cheapest legal
one. An illegal preference falls through to the cheapest legal backend.
The measured CostModel, the int8 gate, mesh placements and the sharded and
chain backends are not ported yet. On CPU tensors ``cuda_fused`` runs the
kernels' plain PyTorch versions (see ``repro_torch.kernels.gru_sequence``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import GRUConfig
from repro_torch.core import cells as cell_families
from repro_torch.core import gru as gru_core
from repro_torch.core.cells import UnknownCellFamily  # noqa: F401 (re-export)


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a backend can legally execute (checked by ``compile()``)."""
    supports_mask: bool = False          # (B,T) length mask streams through
    supports_hetero_dims: bool = False   # per-layer hidden sizes may differ


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One registered execution strategy.

    ``sequence_fn(sp, h0s, xs, *, cfg, return_all, mask)`` returns
    ``(per-layer finals, last layer's states | None)``;
    ``decode_fn(sp, hs, x, *, cfg)`` returns the per-layer new states."""
    name: str
    caps: Capabilities
    cost: int
    sequence_fn: Callable
    decode_fn: Callable
    family: str = "gru"


_REGISTRY: Dict[Tuple[str, str], BackendSpec] = {}


def register_backend(spec: BackendSpec) -> None:
    _REGISTRY[(spec.family, spec.name)] = spec


def _ensure_backends() -> None:
    if ("gru", "cuda_fused") not in _REGISTRY:
        from repro_torch.kernels.gru_sequence import ops as seq_ops
        seq_ops.register_runtime_backends()


def _eager_sequence(sp, h0s, xs, *, cfg, return_all, mask):
    return gru_core.gru_stack_sequence_eager(sp.cells, h0s, xs, cfg=cfg,
                                             return_all=return_all, mask=mask)


def _eager_decode(sp, hs, x, *, cfg):
    return gru_core.gru_stack_decode_eager(sp.cells, hs, x, cfg=cfg)


register_backend(BackendSpec(
    name="eager",
    caps=Capabilities(supports_mask=True, supports_hetero_dims=True),
    cost=30, sequence_fn=_eager_sequence, decode_fn=_eager_decode))


# ---------------------------------------------------------------------------
# canonical params: StackParams + prepare()
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StackParams:
    """``cells``: per-layer ``{"w","u","b"}`` dicts, layer 0 first.
    ``stacked``: the fused kernels' weight stacks (``{"u","w_deep","b"}``),
    present for uniform hidden sizes once requested."""
    cells: tuple
    stacked: Optional[dict] = None

    @property
    def dims(self) -> Tuple[int, ...]:
        return tuple(c["u"].shape[0] for c in self.cells)

    @property
    def device(self) -> torch.device:
        return self.cells[0]["u"].device


def _stack_params(params, cfg: GRUConfig, want_stacked: bool) -> StackParams:
    """Normalize a layout to StackParams where its tensors already live,
    building the weight stacks if wanted and missing (uniform stacks)."""
    family = cell_families.get_family(cell_families.cfg_family(cfg))
    if isinstance(params, StackParams):
        sp = params
    else:
        sp = StackParams(cells=family.normalize(params, cfg),
                         stacked=(params.get("stacked_cells")
                                  if isinstance(params, dict) else None))
    dims = sp.dims
    if (want_stacked and sp.stacked is None
            and family.stacked_views is not None
            and all(d == dims[0] for d in dims)):
        sp = StackParams(cells=sp.cells,
                         stacked=family.stacked_views(sp.cells))
    return sp


def prepare(params, cfg: GRUConfig, *, device="cuda",
            want_stacked: bool = True) -> StackParams:
    """Normalize any accepted layout (``StackParams``, ``{"cells": ...}``,
    ``{"cell": ...}``, a bare cell, a sequence of cells; a dict may carry
    precomputed ``"stacked_cells"``), place it on ``device`` and build the
    fused kernels' weight stacks once (uniform stacks only)."""
    dev = resolve_device(device)
    sp = _stack_params(params, cfg, want_stacked=False)
    cells = tuple({k: v.to(dev) for k, v in c.items()} for c in sp.cells)
    stacked = (None if sp.stacked is None
               else {k: v.to(dev) for k, v in sp.stacked.items()})
    return _stack_params(StackParams(cells=cells, stacked=stacked), cfg,
                         want_stacked)


# ---------------------------------------------------------------------------
# compile(): capability filtering + preference + static cost
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class GRUExecutable:
    """A compiled GRU workload: resolved backends + stable callables.

    ``sequence(params, h0s, xs, *, return_all=False, mask=None)`` returns
    ``(per-layer finals, last layer's states | None)``; ``prefill`` is its
    finals-only view; ``decode(params, hs, x)`` returns the per-layer new
    states. ``params`` may be any layout ``prepare`` accepts; pass
    ``prepare``'s output on hot paths so no call restacks weights."""
    cfg: GRUConfig
    batch: Optional[int]
    seq: Optional[int]
    masked: bool
    sequence_backend: str
    decode_backend: str
    sequence: Callable = dataclasses.field(repr=False, default=None)
    prefill: Callable = dataclasses.field(repr=False, default=None)
    decode: Callable = dataclasses.field(repr=False, default=None)


def _hetero(cfg: GRUConfig) -> bool:
    dims = cfg.resolved_layer_dims
    return any(d != dims[0] for d in dims)


def _rank(spec: BackendSpec, cfg: GRUConfig) -> tuple:
    """Selection key, lexicographic: ``cfg.backend`` preference (family or
    exact name) > static cost > name (determinism)."""
    pref = getattr(cfg, "backend", "eager")
    fam = 1
    if pref == spec.name:
        fam = 0                          # exact backend-name pin
    elif pref == "cuda" and spec.name.startswith("cuda"):
        fam = 0
    return (fam, spec.cost, spec.name)


def _select(cfg: GRUConfig, *, masked: bool) -> BackendSpec:
    """The preferred legal backend of ``cfg``'s family (``eager`` serves
    every call, so there always is one)."""
    hetero = _hetero(cfg)
    fam = cell_families.cfg_family(cfg)
    legal = [s for s in _REGISTRY.values()
             if s.family == fam
             and (s.caps.supports_mask or not masked)
             and (s.caps.supports_hetero_dims or not hetero)]
    return min(legal, key=lambda s: _rank(s, cfg))


_EXEC_CACHE: Dict[tuple, GRUExecutable] = {}


def compile(cfg: GRUConfig, *, batch: Optional[int] = None,
            seq: Optional[int] = None, mask: bool = False) -> GRUExecutable:
    """Resolve the backends for a GRU workload at these shapes. ``mask``
    declares whether sequence calls carry a (B, T) length mask (decode
    steps carry none). Memoized on (cfg, shapes, mask): the same key
    returns the same object. An unregistered ``cfg.family`` raises
    ``UnknownCellFamily``."""
    _ensure_backends()
    cell_families.get_family(cell_families.cfg_family(cfg))
    masked = bool(mask)
    key = (cfg, batch, seq, masked)
    hit = _EXEC_CACHE.get(key)
    if hit is not None:
        return hit
    seq_spec = _select(cfg, masked=masked)
    dec_spec = _select(cfg, masked=False)

    def run_sequence(params, h0s, xs, *, return_all=False, mask=None):
        if mask is not None and not masked:
            raise ValueError("executable was compiled with mask=False; "
                             "re-compile with mask=True to pass a mask")
        sp = _stack_params(params, cfg, seq_spec.name == "cuda_fused")
        return seq_spec.sequence_fn(sp, tuple(h0s), xs, cfg=cfg,
                                    return_all=return_all, mask=mask)

    def run_prefill(params, h0s, xs, *, mask=None):
        return run_sequence(params, h0s, xs, mask=mask)[0]

    def run_decode(params, hs, x):
        sp = _stack_params(params, cfg, dec_spec.name == "cuda_fused")
        return dec_spec.decode_fn(sp, tuple(hs), x, cfg=cfg)

    exe = GRUExecutable(
        cfg=cfg, batch=batch, seq=seq, masked=masked,
        sequence_backend=seq_spec.name, decode_backend=dec_spec.name,
        sequence=run_sequence, prefill=run_prefill, decode=run_decode)
    _EXEC_CACHE[key] = exe
    return exe
