"""The recurrent-stack executor: compile/execute over capability-dispatched
backends keyed by ``(cell family, backend)`` (counterpart of
``repro.core.runtime``); families ``gru`` and ``slstm``.

* ``compile(cfg, batch=..., seq=..., mask=..., placement=...) ->
  GRUExecutable`` resolves where the stack runs (a :class:`Placement`: the
  host, or a mesh of ranks) and which backend serves each op;
  executables are memoized, so the same key returns the same object.
* ``prepare(params, cfg, placement, device=...) -> StackParams``
  normalizes any accepted parameter layout, puts it on the device and
  builds the fused kernels' weight stacks once; under a mesh it also
  slices each layer to this rank's part and places it on the rank's
  device (``StackParams.placed``), so no execute call restacks or moves
  weights. ``GRUExecutable.prepare`` builds only what its backends read.
* ``executable.sequence / prefill / decode`` run against those params.

Backend names map from the JAX package as follows:

===================  =================  ======================================
JAX name             port name          what runs
===================  =================  ======================================
``xla``              ``eager``          eager PyTorch (``repro_torch.core.gru``)
``pallas`` (pref)    ``cuda`` (pref)    the ``cuda*`` backends
``pallas_fused``     ``cuda_fused``     the fused CUDA kernels (one launch
                                        per prefill, one per decode step)
``pallas_chain``     ``cuda_chain``     the depth-1 CUDA sequence kernel
                                        once per layer, prefill and decode
                                        (T=1); any ``layer_dims``
``pallas_fused_q8``  ``cuda_fused_q8``  the fused int8 CUDA kernels, on the
                                        weight rows ``prepare`` quantizes
                                        once
``pallas_chain_q8``  ``cuda_chain_q8``  per layer: the depth-1 int8
                                        sequence kernel (prefill) or the
                                        int8 step kernel (decode); float32
                                        inter-layer projections
``sharded``          ``sharded``        the row-wise/cascade split across
                                        the mesh's ranks, eager per-rank
                                        steps (``core/rowparallel.py``)
``pallas_sharded``   ``cuda_sharded``   the same split with the per-rank
                                        steps in the shard kernels
``sharded_decode``   ``sharded_decode`` the split's decode step, eager
===================  =================  ======================================

Capability table for ``family="gru"`` (``cost`` is the static preference,
lower = preferred; the costs are the JAX table's)::

    backend         mask  hetero  mesh  decode  sequence  cost
    cuda_fused      yes   no      no    yes     yes       10
    cuda_chain      yes   yes     no    yes     yes       20
    eager           yes   yes     no    yes     yes       30
    sharded         yes   yes     REQ   no      yes       5
    cuda_sharded    yes   yes     REQ   yes     yes       4 / 190 (decode)
    sharded_decode  n/a   yes     REQ   yes     no        200
    cuda_fused_q8   yes   no      no    yes     yes       150
    cuda_chain_q8   yes   yes     no    yes     yes       160

All sequence backends serve ``return_all``.

Capability table for ``family="slstm"`` (JAX: ``xla`` and
``pallas_fused``; no q8, chain or mesh backends, so a ``*_q8``, chain or
mesh pin falls through to the cheapest legal one, and under a mesh the
family runs replicated, as in JAX)::

    backend        mask  hetero  cost
    cuda_fused     yes   no      10
    eager          yes   yes     30

``cfg.backend`` is a preference: ``"eager"`` (the default, as ``"xla"`` is
in the JAX config) and ``"cuda"`` pin their family when legal, an exact
backend name pins that backend, and ``"auto"`` picks the cheapest legal
one: by measured cost (:class:`CostModel`) when the model covers the
call, else by the static table. An illegal preference falls through to
the cheapest legal backend.
So heterogeneous ``layer_dims`` under ``"cuda"``, or under a ``cuda_fused``
or ``cuda_fused_q8`` pin, run ``cuda_chain``, as the JAX runtime falls to
``pallas_chain``.

Mesh (``REQ``: the backend requires a mesh placement; without one it is
illegal, so a pin falls through). A mesh is an explicit request to use it
for sequence work: the mesh backends win prefill before the preference is
read (``cuda_sharded`` by its cost 4 unless a pin says otherwise). Decode
is latency-bound and ranks by preference and cost alone, so under
``"cuda"`` it stays on the replicated ``cuda_fused`` statically
(``cuda_sharded``'s decode cost is 190) unless a measured table prices
``cuda_sharded`` lower; the exact names ``cuda_sharded`` and
``sharded_decode`` pin the split's decode.

Shape is part of legality: each kernel backend declares (``fits``, from
its wrappers' ``smem_bytes*``) which stacks its kernels take at the
compiled batch's tile (``min(batch, 4)`` rows; 4 when the batch is not
given): weights and state must fit the 232,448 bytes of shared memory a
Hopper block may use. A stack too wide for a kernel makes its backend
illegal for that op, so it falls through like any illegal preference
(``cuda_fused`` -> ``cuda_chain`` -> ``eager``, the same on the CPU and on
the card), where JAX's Pallas backends serve it. The thread-block-cluster
row split that would keep such stacks on the kernels is not ported yet.

The q8 backends (names ending ``_q8``) change the numerics, so they are
gated as in the JAX runtime: one is a candidate only under an exact-name
pin, or when ``cfg.quant == "int8"`` and the recorded accuracy artifact
of the port's own harness (``repro_torch.quant.accuracy``:
``./BENCH_quant_accuracy_torch.json``, or ``$REPRO_TORCH_GRU_QUANT_ACC``;
see :func:`load_quant_accuracy`) passed. The JAX package's artifact
(``BENCH_quant_accuracy.json``, ``$REPRO_GRU_QUANT_ACC``) measured JAX's
Pallas q8 kernels, not the port's CUDA kernels, and never opens this gate. Its static cost keeps ``auto`` off it
even then, unless a measured row shows it faster. On CPU tensors the
``cuda*`` backends run the kernels' plain PyTorch versions (see
``repro_torch.kernels.gru_sequence`` and ``repro_torch.kernels.gru_cell``).

Measured dispatch. A :class:`CostModel` holds measured latencies per
``(family, backend, op, depth, hidden)``, interpolated over the batch
(the JAX package's schema: ``"bench": "gru_backend_costs"``, rows
``family, backend, op, depth, hidden_dim, batch, p50_us``; rows without
``family`` are the GRU's). Within one preference rank the measured cost
replaces the static one when the model covers every legal candidate (a
candidate whose static cost is at least :data:`UNCALIBRATED_GATE_COST`
may go unmeasured: it then loses). The order stays mesh request >
preference > cost > name, so under ``"cuda"`` a table chooses among the
``cuda*`` backends and never puts ``eager`` ahead of them; only
``"auto"`` compares every legal backend. Shape is checked first: a
measured row never makes a kernel backend legal for a stack its
``fits`` rejects. A ``p50_us`` is the engine's served step, the host
clock around a step that ends in ``torch.cuda.synchronize()`` (what
``ServeEngine.latency_stats`` reports), not device time; a table written
on one card prices backends on that card only.

The port's table is its own: :func:`cost_model` loads
``$REPRO_TORCH_GRU_COSTS`` (default ``./BENCH_backend_costs_torch.json``),
never the JAX package's ``$REPRO_GRU_COSTS`` /
``./BENCH_backend_costs.json``. ``sharded`` and ``sharded_decode`` are
backend names in both packages, so a JAX table would price the port's
mesh backends with times taken on another machine. A missing or corrupt
file gives an empty model: static dispatch, as before calibration.

Recalibration and cost epochs. :func:`set_cost_model` and
:func:`set_quant_accuracy` bump the cost epoch (:func:`cost_epoch`), which
is part of every executable's cache key, and empty the cache: an
executable priced under an older table or gate is never returned again.
An executable already handed out keeps its backends: the serving engine
freezes one per decode key and one per prefill bucket and calls through
it, so a table installed mid-wave changes nothing until
``ServeEngine.refresh_executables`` runs at a wave boundary (the tuner
calls it after a recalibration, any other caller itself), where it
re-resolves and drops its executables only if a backend changed. That is
the port's counterpart of JAX's jit caches, which embed the backend of
their trace.

``compile(..., mode=...)`` states which ops the caller needs:
``"prefill"`` and ``"sequence"`` a sequence backend, ``"decode"`` a
decode backend, ``"serve"`` (the default) both; when none is legal it
raises :class:`NoCapableBackend`. The deprecated one-shot surface
(:func:`plan`, the ``ExecPlan`` name, and the legacy entry points of
``core/gru.py`` and ``core/rowparallel.py``) shims onto ``compile`` and
warns once per process.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import GRUConfig
from repro_torch.core import cells as cell_families
from repro_torch.core import gru as gru_core
from repro_torch.core.cells import UnknownCellFamily  # noqa: F401 (re-export)
from repro_torch.core.params import QuantStackParams, quantize_gru_cells


# ---------------------------------------------------------------------------
# placement: where a stack runs (resolved at compile/prepare time)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Placement:
    """Where weights live and execution happens.

    ``mesh=None`` is the host placement (one process, replicated). With a
    :class:`~repro_torch.distributed.mesh.Mesh`, the sharded backends split
    each layer over its ranks (U's output rows for a row-wise layer, its
    contraction for a cascade layer; the rule is per layer,
    ``cfg.layer_matvec_modes``). Hashable: it is part of the executable
    cache key."""
    mesh: object = None

    @property
    def is_host(self) -> bool:
        return self.mesh is None


HOST = Placement()


def _as_placement(p) -> Placement:
    """None | Mesh | Placement -> Placement. A multi-axis mesh places the
    stack on its ``model`` axis (JAX's ``Placement(axis="model")``): the
    sharded backends split over that axis's ranks and every other axis
    holds a replica; without a ``model`` axis each rank holds the whole
    stack (a one-rank mesh on its device)."""
    if p is None:
        return HOST
    if isinstance(p, Placement):
        return p
    if getattr(p, "subs", ()):
        from repro_torch.distributed.mesh import Mesh
        p = (p.sub("model") if "model" in p.axis_names else
             Mesh(group=None, size=1, rank=0, device=p.device))
    return Placement(mesh=p)


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a backend can legally execute (checked by ``compile()``)."""
    supports_mask: bool = False          # (B,T) length mask streams through
    supports_hetero_dims: bool = False   # per-layer hidden sizes may differ
    supports_mesh: bool = False          # True: REQUIRES a mesh placement


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One registered execution strategy.

    ``sequence_fn(sp, state0, xs, *, cfg, return_all, mask)`` returns
    ``(flat finals, last layer's h sequence | None)``;
    ``decode_fn(sp, state, x, *, cfg)`` returns the flat new state; None
    where the backend does not serve that op. A state is the family's flat
    tuple of per-layer leaves (GRU: one ``h`` per layer; sLSTM: ``c, n, m,
    h`` per layer). A mesh backend finds its placement and this rank's
    weights in ``sp.placement`` and ``sp.placed``. ``decode_cost``
    overrides ``cost`` for decode (a backend may be the right default for a
    sequence and the wrong one for one latency-bound step).
    ``views`` names the weight views the backend reads besides the cells:
    ``"stacked"`` (``StackParams.stacked``), ``"quant"``
    (``StackParams.quant``), ``"placed"`` (``StackParams.placed``; a mesh
    backend reads nothing else) or ``""``. ``fits(cfg, batch, op)`` says
    whether the backend's kernels take this stack for ``op``
    (``"sequence"`` or ``"decode"``) at this batch (None: any shape)."""
    name: str
    caps: Capabilities
    cost: int
    sequence_fn: Optional[Callable]
    decode_fn: Optional[Callable]
    family: str = "gru"
    views: str = ""
    fits: Optional[Callable] = None
    decode_cost: Optional[int] = None

    def static_cost(self, op: str) -> int:
        if op == "decode" and self.decode_cost is not None:
            return self.decode_cost
        return self.cost

    def serves(self, op: str) -> bool:
        return (self.sequence_fn if op == "sequence"
                else self.decode_fn) is not None


_REGISTRY: Dict[Tuple[str, str], BackendSpec] = {}


def register_backend(spec: BackendSpec) -> None:
    _REGISTRY[(spec.family, spec.name)] = spec


def _ensure_backends() -> None:
    """Register every family's backends on first use, whatever was
    imported before."""
    if ("gru", "cuda_fused") not in _REGISTRY:
        from repro_torch.kernels.gru_sequence import ops as seq_ops
        seq_ops.register_runtime_backends()
    if ("slstm", "eager") not in _REGISTRY:
        from repro_torch.core import slstm as slstm_core
        slstm_core.register_runtime_backends()
    if ("slstm", "cuda_fused") not in _REGISTRY:
        from repro_torch.kernels.slstm_cell import ops as slstm_ops
        slstm_ops.register_runtime_backends()


def _eager_sequence(sp, state0, xs, *, cfg, return_all, mask):
    return gru_core.gru_stack_sequence_eager(sp.cells, state0, xs, cfg=cfg,
                                             return_all=return_all, mask=mask)


def _eager_decode(sp, state, x, *, cfg):
    return gru_core.gru_stack_decode_eager(sp.cells, state, x, cfg=cfg)


register_backend(BackendSpec(
    name="eager",
    caps=Capabilities(supports_mask=True, supports_hetero_dims=True),
    cost=30, sequence_fn=_eager_sequence, decode_fn=_eager_decode))


def _sharded_sequence(sp, state0, xs, *, cfg, return_all, mask,
                      step_impl: str = "eager"):
    """The split across the ranks of ``sp.placement``'s mesh;
    ``step_impl="cuda"`` is ``cuda_sharded``: the same placed views and
    collectives, the per-rank steps in the shard kernels."""
    from repro_torch.core import rowparallel
    out = rowparallel.gru_stack_sequence_sharded_prepared(
        sp.placed, state0, xs, mesh=sp.placement.mesh, cfg=cfg,
        return_all=return_all, mask=mask, step_impl=step_impl)
    return out if return_all else (out, None)


def _sharded_decode(sp, state, x, *, cfg, step_impl: str = "eager"):
    from repro_torch.core import rowparallel
    return rowparallel.gru_stack_decode_sharded_prepared(
        sp.placed, state, x, mesh=sp.placement.mesh, cfg=cfg,
        step_impl=step_impl)


_MESH = Capabilities(supports_mask=True, supports_hetero_dims=True,
                     supports_mesh=True)
register_backend(BackendSpec(
    name="sharded", caps=_MESH, cost=5, views="placed",
    sequence_fn=_sharded_sequence, decode_fn=None))
# statically the preferred mesh sequence backend (4 < sharded's 5): the
# per-rank compute runs in the shard kernels between the same collectives.
# Its decode is dispreferred (190), as sharded_decode's is: one step is
# latency-bound and its collectives usually dominate, so decode stays
# replicated unless pinned.
register_backend(BackendSpec(
    name="cuda_sharded", caps=_MESH, cost=4, decode_cost=190,
    views="placed",
    sequence_fn=functools.partial(_sharded_sequence, step_impl="cuda"),
    decode_fn=functools.partial(_sharded_decode, step_impl="cuda")))
register_backend(BackendSpec(
    name="sharded_decode", caps=_MESH, cost=200, views="placed",
    sequence_fn=None, decode_fn=_sharded_decode))


# ---------------------------------------------------------------------------
# canonical params: StackParams + prepare()
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StackParams:
    """``cells``: per-layer ``{"w","u","b"}`` dicts, layer 0 first.
    ``stacked``: the fused kernels' weight stacks (``{"u","w_deep","b"}``),
    present for uniform hidden sizes once requested. ``quant``: the q8
    backends' int8 weight views (:class:`QuantStackParams`), present once
    requested. ``placed``: the mesh backends' per-layer views of this
    rank's part (``rowparallel.prepare_sharded_layers``), on the mesh
    device, present for a mesh ``placement`` once requested."""
    cells: tuple
    stacked: Optional[dict] = None
    quant: Optional[QuantStackParams] = None
    placed: Optional[tuple] = None
    placement: Placement = HOST

    @property
    def dims(self) -> Tuple[int, ...]:
        return tuple(c["u"].shape[0] for c in self.cells)


def _cfg_wants_quant(cfg) -> bool:
    """Whether this config may route through a q8 backend (the quant flag
    or an exact ``*_q8`` pin): then ``prepare`` builds the int8 views."""
    return cfg.quant == "int8" or cfg.backend.endswith("_q8")


def _stack_params(params, cfg: GRUConfig, want_stacked: bool,
                  want_quant: bool = False,
                  placement: Placement = HOST) -> StackParams:
    """Normalize a layout to StackParams where its tensors already live,
    building the weight stacks (uniform stacks), the int8 views and, for a
    mesh ``placement``, this rank's placed views, if wanted and missing
    (views placed on another mesh are placed again)."""
    family = cell_families.get_family(cell_families.cfg_family(cfg))
    if isinstance(params, StackParams):
        sp = params
    else:
        get = params.get if isinstance(params, dict) else (lambda _k: None)
        sp = StackParams(cells=family.normalize(params, cfg),
                         stacked=get("stacked_cells"),
                         quant=get("quant_cells"),
                         placed=get("placed_cells"),
                         placement=get("placement") or HOST)
    dims = sp.dims
    if (want_stacked and sp.stacked is None
            and family.stacked_views is not None
            and all(d == dims[0] for d in dims)):
        sp = dataclasses.replace(sp, stacked=family.stacked_views(sp.cells))
    if want_quant and sp.quant is None and family.supports_quant:
        sp = dataclasses.replace(sp, quant=quantize_gru_cells(sp.cells))
    if (not placement.is_host and family.supports_placement
            and (sp.placed is None or sp.placement != placement)):
        sp = dataclasses.replace(sp, placed=_place_layers(sp.cells, cfg,
                                                          placement),
                                 placement=placement)
    return sp


def _place_layers(cells, cfg: GRUConfig, placement: Placement) -> tuple:
    from repro_torch.core import rowparallel
    return rowparallel.prepare_sharded_layers(cells, cfg,
                                              mesh=placement.mesh)


def prepare(params, cfg: GRUConfig, placement=None, *, device="cuda",
            want_stacked: bool = True, want_cells: bool = True
            ) -> StackParams:
    """Normalize any accepted layout (``StackParams``, ``{"cells": ...}``,
    ``{"cell": ...}``, a bare cell, a sequence of cells; a dict may carry
    precomputed ``"stacked_cells"``, ``"quant_cells"`` and
    ``"placed_cells"`` with their ``"placement"``), place it on ``device``
    and build the fused kernels' weight stacks once (uniform stacks only).
    When ``cfg`` asks for the q8 datapath (``quant="int8"`` or a ``*_q8``
    pin) and its family has one (the GRU), the int8 weight views are built
    here too, on ``device``, so no execute call quantizes weights.

    ``placement`` (a :class:`Placement`, a mesh, or None = host): with a
    mesh, each layer is sliced to this rank's part where the caller's
    tensors live and only that part is copied to the mesh's device
    (``StackParams.placed``); a family without mesh backends (the sLSTM)
    ignores it. ``want_cells=False`` leaves the full cells (and builds no
    weight stacks or int8 views) where the caller has them: what an
    executable whose backends all read ``placed`` asks for, so no rank
    holds another rank's rows of U on its device."""
    pl_ = _as_placement(placement)
    family = cell_families.get_family(cell_families.cfg_family(cfg))
    if not family.supports_placement:
        pl_ = HOST
    sp = _stack_params(params, cfg, want_stacked=False, placement=pl_)
    if not want_cells:
        return sp
    dev = resolve_device(device)
    cells = tuple({k: v.to(dev) for k, v in c.items()} for c in sp.cells)
    stacked = (None if sp.stacked is None
               else {k: v.to(dev) for k, v in sp.stacked.items()})
    quant = None if sp.quant is None else sp.quant.to(dev)
    return _stack_params(dataclasses.replace(sp, cells=cells, stacked=stacked,
                                             quant=quant), cfg, want_stacked,
                         _cfg_wants_quant(cfg))


# ---------------------------------------------------------------------------
# measured cost model (static table fallback)
# ---------------------------------------------------------------------------

def _cost_key(e) -> tuple:
    """A calibration row's curve key; rows without ``family`` or ``op``
    are GRU decode rows."""
    return (str(e.get("family", "gru")), str(e["backend"]),
            str(e.get("op", "decode")), int(e["depth"]), int(e["hidden_dim"]))


class CostModel:
    """Measured per-backend latency, keyed (family, backend, op, depth,
    hidden), linearly interpolated over the batch.

    Loaded from a ``gru_backend_costs`` file (see the module docstring for
    the schema and the units). Keys of 4 items (backend, op, depth,
    hidden) are the GRU's, as are rows without ``family``. Lookups outside
    the measured batches clamp to the nearest one; ``lookup`` is None for a
    curve with no point, and selection trusts the model only where it
    covers every legal candidate (µs and static preference numbers are not
    comparable)."""

    def __init__(self, table: Dict[tuple, List[tuple]], source: str = "",
                 error: Optional[str] = None):
        self._table = {(k if len(k) == 5 else ("gru", *k)): v
                       for k, v in table.items()}
        self.source = source
        self.error = error

    def __len__(self) -> int:
        return sum(len(v) for v in self._table.values())

    @classmethod
    def from_entries(cls, entries, source: str = "") -> "CostModel":
        table: Dict[tuple, List[tuple]] = {}
        for e in entries:
            table.setdefault(_cost_key(e), []).append(
                (int(e["batch"]), float(e["p50_us"])))
        for v in table.values():
            v.sort()
        return cls(table, source=source)

    @classmethod
    def load(cls, path) -> "CostModel":
        """Tolerant load: a missing, unreadable or schema-mismatched file
        gives an EMPTY model (every lookup misses: static dispatch)."""
        try:
            with open(path) as f:
                data = json.load(f)
            if data.get("bench") != "gru_backend_costs":
                raise ValueError("not a gru_backend_costs artifact")
            return cls.from_entries(data["entries"], source=str(path))
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError) as e:
            return cls({}, source=str(path),
                       error=f"{type(e).__name__}: {e}")

    def merged(self, entries, source: str = "") -> "CostModel":
        """A NEW model: this table with ``entries`` folded in (the online
        recalibration of ``repro_torch.serve.autotune``). A row replaces
        the measured point at its (family, backend, op, depth, hidden,
        batch), or extends the curve at a new batch. Malformed rows and
        non-finite or non-positive latencies are skipped: a ManualClock run
        measures dt == 0, which must never price a backend as free. Pure:
        install the result with :func:`set_cost_model`."""
        table = {k: list(v) for k, v in self._table.items()}
        for e in entries:
            try:
                key = _cost_key(e)
                batch = int(e["batch"])
                us = float(e["p50_us"])
            except (KeyError, TypeError, ValueError):
                continue
            if batch < 1 or not math.isfinite(us) or us <= 0.0:
                continue
            pts = table.setdefault(key, [])
            pts[:] = [(b, c) for (b, c) in pts if b != batch]
            pts.append((batch, us))
            pts.sort()
        return CostModel(table,
                         source=source or (f"{self.source}+online"
                                           if self.source else "<online>"))

    def batch_points(self, backend: str, op: str = "decode", *, depth: int,
                     hidden: int, family: str = "gru") -> List[tuple]:
        """The measured ``(batch, p50_us)`` points of one curve, sorted by
        batch: the autotuner's view, which must know where the
        measurements end (``lookup`` clamps and interpolates)."""
        return list(self._table.get((str(family), str(backend), str(op),
                                     int(depth), int(hidden)), ()))

    def lookup(self, backend: str, op: str, *, depth: int, batch: int,
               hidden: int, family: str = "gru") -> Optional[float]:
        pts = self._table.get((str(family), backend, op, int(depth),
                               int(hidden)))
        if not pts:
            return None
        if batch <= pts[0][0]:
            return pts[0][1]
        if batch >= pts[-1][0]:
            return pts[-1][1]
        for (b0, c0), (b1, c1) in zip(pts, pts[1:]):
            if b0 <= batch <= b1:
                return c0 + (batch - b0) / (b1 - b0) * (c1 - c0)
        return None  # pragma: no cover - unreachable on a sorted table


COSTS_ENV = "REPRO_TORCH_GRU_COSTS"
COSTS_FILE = "BENCH_backend_costs_torch.json"
_COST_MODEL: Optional[CostModel] = None
_COST_EPOCH = 0     # part of the executable cache key: new model, new plans


def set_cost_model(model: Optional[CostModel]) -> None:
    """Install a calibration model (None re-arms the lazy default load).
    Bumps the cost epoch and empties the executable cache: executables
    priced under the old table are never returned again."""
    global _COST_MODEL, _COST_EPOCH
    _COST_MODEL = model
    _COST_EPOCH += 1
    _EXEC_CACHE.clear()


def load_cost_model(path) -> CostModel:
    """Load ``path`` (tolerantly) and install it. Returns the model."""
    model = CostModel.load(path)
    set_cost_model(model)
    return model


def cost_epoch() -> int:
    """The current cost/gate epoch, bumped by :func:`set_cost_model` and
    :func:`set_quant_accuracy`."""
    return _COST_EPOCH


def cost_model() -> CostModel:
    """The active calibration model. On first use, loads
    ``$REPRO_TORCH_GRU_COSTS`` (default
    ``./BENCH_backend_costs_torch.json``) if present; otherwise an empty
    model (static dispatch)."""
    global _COST_MODEL
    if _COST_MODEL is None:
        path = os.environ.get(COSTS_ENV, COSTS_FILE)
        _COST_MODEL = (CostModel.load(path) if os.path.exists(path)
                       else CostModel({}, source=path))
    return _COST_MODEL


# ---------------------------------------------------------------------------
# quant accuracy gate (the q8 backends' dispatch-eligibility record)
# ---------------------------------------------------------------------------

QUANT_ACC_ENV = "REPRO_TORCH_GRU_QUANT_ACC"
QUANT_ACC_FILE = "BENCH_quant_accuracy_torch.json"


class QuantAccuracy:
    """The recorded result of the port's q8 accuracy harness
    (``BENCH_quant_accuracy_torch.json``, the JAX package's schema:
    ``"bench": "gru_quant_accuracy"``, ``"passed"``). Only a loaded, error-free
    artifact with ``passed: true`` opens the gate; a missing, corrupt or
    failing one keeps the q8 backends pin-only."""

    def __init__(self, data: Optional[dict] = None, source: str = "",
                 error: Optional[str] = None):
        self.data = dict(data or {})
        self.source = source
        self.error = error

    @property
    def passed(self) -> bool:
        return self.error is None and bool(self.data.get("passed"))

    @classmethod
    def load(cls, path) -> "QuantAccuracy":
        """Tolerant load: a missing, unreadable or schema-mismatched file
        gives a closed gate, never an exception."""
        try:
            with open(path) as f:
                data = json.load(f)
            if data.get("bench") != "gru_quant_accuracy":
                raise ValueError("not a gru_quant_accuracy artifact")
            return cls(data, source=str(path))
        except (OSError, ValueError, AttributeError) as e:
            return cls({}, source=str(path), error=f"{type(e).__name__}: {e}")


_QUANT_ACC: Optional[QuantAccuracy] = None


def set_quant_accuracy(report: Optional[QuantAccuracy]) -> None:
    """Install an accuracy report (None re-arms the lazy default load).
    Gate flips change which backends are legal, so this bumps the cost
    epoch and empties the executable cache, as :func:`set_cost_model`
    does."""
    global _QUANT_ACC, _COST_EPOCH
    _QUANT_ACC = report
    _COST_EPOCH += 1
    _EXEC_CACHE.clear()


def load_quant_accuracy(path) -> QuantAccuracy:
    """Load ``path`` (tolerantly) and install it. Returns the report."""
    report = QuantAccuracy.load(path)
    set_quant_accuracy(report)
    return report


def quant_accuracy() -> QuantAccuracy:
    """The active accuracy report. On first use, loads
    ``$REPRO_TORCH_GRU_QUANT_ACC`` (default
    ``./BENCH_quant_accuracy_torch.json``) if present; otherwise a closed
    gate. The JAX package's env var and file are never read."""
    global _QUANT_ACC
    if _QUANT_ACC is None:
        path = os.environ.get(QUANT_ACC_ENV, QUANT_ACC_FILE)
        _QUANT_ACC = (QuantAccuracy.load(path) if os.path.exists(path)
                      else QuantAccuracy({}, source=path,
                                         error="missing artifact"))
    return _QUANT_ACC


def quant_gate_open() -> bool:
    """True when the recorded accuracy artifact admits q8 dispatch."""
    return quant_accuracy().passed


def backend_dtype(name: Optional[str]) -> str:
    """The numeric format a backend's recurrent matvecs run in: what a
    server reports as its served dtype."""
    return "int8" if name and name.endswith("_q8") else "float32"




# ---------------------------------------------------------------------------
# compile(): capability filtering + preference + (measured | static) cost
# ---------------------------------------------------------------------------

class NoCapableBackend(ValueError):
    """No registered backend can legally serve the requested call."""


MODES = ("serve", "prefill", "sequence", "decode")


def _on(t, device) -> bool:
    """Whether tensor ``t`` lives on ``device`` (no index: any of its
    type)."""
    device = torch.device(device)
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


@dataclasses.dataclass(frozen=True, eq=False)
class GRUExecutable:
    """A compiled recurrent workload: resolved placement, backends and
    stable callables.

    ``sequence(params, state0, xs, *, return_all=False, mask=None)``
    returns ``(flat finals, last layer's h sequence | None)``; ``prefill``
    is its finals-only view; ``decode(params, state, x)`` returns the flat
    new state (None where no decode backend is legal). A state is the
    family's flat tuple of per-layer leaves (GRU: ``h`` per layer; sLSTM:
    ``c, n, m, h`` per layer); under a mesh every rank passes and gets the
    same, replicated. ``params`` may be any layout ``prepare`` accepts;
    pass :meth:`prepare`'s output on hot paths so no call restacks or
    places weights. ``cost_source`` says whether the backends of ``mode``
    were chosen by measured cost (``"measured"``) or by the static table
    (``"static"``)."""
    cfg: GRUConfig
    batch: Optional[int]
    seq: Optional[int]
    masked: bool
    placement: Placement
    mode: str
    sequence_backend: Optional[str]
    decode_backend: Optional[str]
    cost_source: str = "static"
    sequence: Callable = dataclasses.field(repr=False, default=None)
    prefill: Callable = dataclasses.field(repr=False, default=None)
    decode: Callable = dataclasses.field(repr=False, default=None)

    @property
    def mesh(self):
        return self.placement.mesh

    def _specs(self) -> tuple:
        fam = cell_families.cfg_family(self.cfg)
        return tuple(_REGISTRY[(fam, n)] for n in (self.sequence_backend,
                                                   self.decode_backend)
                     if n is not None)

    def prepare(self, params, *, device="cuda") -> StackParams:
        """Params for THIS executable's backends, placed once: this rank's
        views on the mesh only when a mesh backend was chosen, and the full
        cells on ``device`` (with the fused stacks or int8 views its
        kernels read) only when a replicated backend was chosen."""
        specs = self._specs()
        mesh = any(s.caps.supports_mesh for s in specs)
        return prepare(params, self.cfg, self.placement if mesh else None,
                       device=device,
                       want_stacked=any(s.views == "stacked" for s in specs),
                       want_cells=not all(s.caps.supports_mesh
                                          for s in specs))

    def missing_views(self, params, *, device="cuda") -> tuple:
        """The weight views this executable's backends read that ``params``
        (a prepared dict or :class:`StackParams`) lacks: ``"cells"`` (the
        full cells on ``device``, for a replicated backend), ``"stacked"``,
        ``"quant"`` or ``"placed"`` (this placement's). A call on params
        that lack one builds it again on every call."""
        family = cell_families.get_family(cell_families.cfg_family(self.cfg))
        sp = _stack_params(params, self.cfg, want_stacked=False)
        uniform = len(set(sp.dims)) == 1
        missing = []
        for s in self._specs():
            if s.caps.supports_mesh:
                if sp.placed is None or sp.placement != self.placement:
                    missing.append("placed")
                continue
            if not _on(sp.cells[0]["u"], device):
                missing.append("cells")
            if (s.views == "stacked" and sp.stacked is None and uniform
                    and family.stacked_views is not None):
                missing.append("stacked")
            if s.views == "quant" and sp.quant is None:
                missing.append("quant")
        return tuple(dict.fromkeys(missing))

    def describe(self) -> dict:
        return {"sequence_backend": self.sequence_backend,
                "decode_backend": self.decode_backend,
                "masked": self.masked, "mesh": self.mesh is not None,
                "mode": self.mode, "batch": self.batch, "seq": self.seq,
                "cost_source": self.cost_source}


def _hetero(cfg: GRUConfig) -> bool:
    dims = cfg.resolved_layer_dims
    return any(d != dims[0] for d in dims)


def _q8_allowed(spec: BackendSpec, cfg: GRUConfig) -> bool:
    """A ``*_q8`` backend is a candidate only under its exact-name pin, or
    under ``quant="int8"`` with the accuracy gate open."""
    if not spec.name.endswith("_q8") or cfg.backend == spec.name:
        return True
    return cfg.quant == "int8" and quant_gate_open()


# Static costs at or above this line mark a backend "measured-only": it is
# defined to lose unless a calibration measures it faster, so a cost model
# that does not cover it (a q8 calibration of the decode op alone, say)
# does not send the whole selection back to the static table. Candidates
# below the line are all-or-nothing: measured µs and static preference
# numbers are not comparable units.
UNCALIBRATED_GATE_COST = 100


def _measured_costs(legal, cfg: GRUConfig, *, op: str,
                    batch: Optional[int]) -> Optional[Dict[str, float]]:
    """Measured µs per candidate, or None where the model cannot cover the
    call (no batch, heterogeneous dims, or an unmeasured candidate below
    :data:`UNCALIBRATED_GATE_COST`; one at or above it is priced at
    infinity and loses)."""
    if batch is None or _hetero(cfg):
        return None
    model = cost_model()
    if not len(model):
        return None
    dims = cfg.resolved_layer_dims
    fam = cell_families.cfg_family(cfg)
    out, covered = {}, 0
    for s in legal:
        us = model.lookup(s.name, op, depth=len(dims), batch=batch,
                          hidden=dims[0], family=fam)
        if us is None:
            if s.static_cost(op) >= UNCALIBRATED_GATE_COST:
                out[s.name] = float("inf")
                continue
            return None
        covered += 1
        out[s.name] = us
    return out if covered else None


def _rank(spec: BackendSpec, cfg: GRUConfig, *, op: str, mesh,
          measured: Optional[float] = None) -> tuple:
    """Selection key, lexicographic: mesh request (sequence ops: a mesh
    is an explicit ask for the split) > ``cfg.backend`` preference (family
    or exact name) > cost of ``op`` (measured µs when the model covers the
    call, else the static table) > name (determinism). JAX's first term,
    a platform check that keeps its Pallas backends off platforms they
    cannot lower on, has no counterpart: on CPU tensors the ``cuda*``
    backends run their plain versions."""
    mesh_rank = 0
    if mesh is not None and op != "decode":
        mesh_rank = 0 if spec.caps.supports_mesh else 1
    pref = getattr(cfg, "backend", "eager")
    fam = 1
    if pref == spec.name:
        fam = 0                          # exact backend-name pin
    elif pref == "cuda" and spec.name.startswith("cuda"):
        fam = 0
    cost = float(spec.static_cost(op)) if measured is None else measured
    return (mesh_rank, fam, cost, spec.name)


def _legal(spec: BackendSpec, cfg: GRUConfig, *, op: str, masked: bool,
           batch: Optional[int], mesh) -> bool:
    """Whether ``spec`` may serve ``op`` of ``cfg``: its family, the op,
    the mask, heterogeneous dims, a mesh where it needs one, the q8 gate,
    and its kernels' shape fit at this batch."""
    return (spec.family == cell_families.cfg_family(cfg) and spec.serves(op)
            and (spec.caps.supports_mask or not masked)
            and (spec.caps.supports_hetero_dims or not _hetero(cfg))
            and (mesh is not None or not spec.caps.supports_mesh)
            and _q8_allowed(spec, cfg)
            and (spec.fits is None or spec.fits(cfg, batch, op)))


def _select(cfg: GRUConfig, *, masked: bool, batch: Optional[int] = None,
            op: str = "sequence", placement: Placement = HOST) -> tuple:
    """-> (the preferred legal backend of ``cfg``'s family for ``op`` at
    this batch on this placement, or None; ``"measured"`` or
    ``"static"``). A mesh backend is legal only on a mesh, and a kernel
    backend only for stacks its ``fits`` takes, whatever a measured row
    says."""
    mesh = placement.mesh
    legal = [s for s in _REGISTRY.values()
             if _legal(s, cfg, op=op, masked=masked, batch=batch, mesh=mesh)]
    if not legal:
        return None, "static"
    measured = _measured_costs(legal, cfg, op=op, batch=batch)
    spec = min(legal, key=lambda s: _rank(
        s, cfg, op=op, mesh=mesh,
        measured=None if measured is None else measured[s.name]))
    return spec, ("measured" if measured is not None else "static")


_EXEC_CACHE: Dict[tuple, GRUExecutable] = {}


def compile(cfg: GRUConfig, *, batch: Optional[int] = None,
            seq: Optional[int] = None, mask: bool = False,
            placement=None, mode: str = "serve") -> GRUExecutable:
    """Resolve the backends for a recurrent workload of ``cfg.family`` at
    these shapes on ``placement`` (a :class:`Placement`, a mesh, or None =
    host). ``mask`` declares whether sequence calls carry a (B, T) length
    mask (decode steps carry none). ``mode``: ``"prefill"`` and
    ``"sequence"`` need a sequence backend, ``"decode"`` a decode backend,
    ``"serve"`` both; :class:`NoCapableBackend` where one is missing.
    Memoized on (cfg, shapes, mask, placement, mode, cost epoch): the same
    key returns the same object. An unregistered ``cfg.family`` raises
    ``UnknownCellFamily``."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    _ensure_backends()
    fam = cell_families.cfg_family(cfg)
    cell_families.get_family(fam)
    pl_ = _as_placement(placement)
    masked = bool(mask)
    key = (cfg, batch, seq, masked, pl_, mode, _COST_EPOCH)
    hit = _EXEC_CACHE.get(key)
    if hit is not None:
        return hit
    seq_spec, seq_src = _select(cfg, masked=masked, batch=batch,
                                op="sequence", placement=pl_)
    dec_spec, dec_src = _select(cfg, masked=False, batch=batch, op="decode",
                                placement=pl_)
    if mode != "decode" and seq_spec is None:
        raise NoCapableBackend(
            f"no sequence backend for family={fam!r} "
            f"cfg.backend={cfg.backend!r} mask={masked} "
            f"dims={cfg.resolved_layer_dims} mesh={pl_.mesh}")
    if mode in ("decode", "serve") and dec_spec is None:
        raise NoCapableBackend(
            f"no decode backend for family={fam!r} "
            f"cfg.backend={cfg.backend!r} dims={cfg.resolved_layer_dims} "
            f"mesh={pl_.mesh}")

    def stack_params(spec, params):
        return _stack_params(params, cfg, spec.views == "stacked",
                             spec.views == "quant",
                             pl_ if spec.caps.supports_mesh else HOST)

    def run_sequence(params, state0, xs, *, return_all=False, mask=None):
        if mask is not None and not masked:
            raise ValueError("executable was compiled with mask=False; "
                             "re-compile with mask=True to pass a mask")
        if seq_spec is None:
            raise NoCapableBackend(f"no sequence backend for family="
                                   f"{fam!r} cfg.backend={cfg.backend!r}")
        return seq_spec.sequence_fn(stack_params(seq_spec, params),
                                    tuple(state0), xs, cfg=cfg,
                                    return_all=return_all, mask=mask)

    def run_prefill(params, state0, xs, *, mask=None):
        return run_sequence(params, state0, xs, mask=mask)[0]

    def run_decode(params, state, x):
        return dec_spec.decode_fn(stack_params(dec_spec, params),
                                  tuple(state), x, cfg=cfg)

    relevant = ([seq_src] if mode in ("prefill", "sequence") else
                [dec_src] if mode == "decode" else [seq_src, dec_src])
    exe = GRUExecutable(
        cfg=cfg, batch=batch, seq=seq, masked=masked, placement=pl_,
        mode=mode, sequence_backend=seq_spec.name if seq_spec else None,
        decode_backend=dec_spec.name if dec_spec else None,
        cost_source="measured" if "measured" in relevant else "static",
        sequence=run_sequence, prefill=run_prefill,
        decode=run_decode if dec_spec else None)
    _EXEC_CACHE[key] = exe
    return exe


# ---------------------------------------------------------------------------
# compile-and-run conveniences (the legacy entry points shim onto these)
# ---------------------------------------------------------------------------

def sequence(params, state0, xs, *, cfg: GRUConfig, return_all: bool = False,
             mask=None, mesh=None):
    """Run a depth-L stack over xs (B,T,X) with the compiled backend.
    Returns (flat finals, last layer's states | None)."""
    exe = compile(cfg, batch=xs.shape[0] if xs.dim() >= 3 else None,
                  seq=xs.shape[-2], placement=mesh, mask=mask is not None,
                  mode="sequence")
    return exe.sequence(params, state0, xs, return_all=return_all, mask=mask)


def decode(params, state, x, *, cfg: GRUConfig, mesh=None):
    """One serve step through the stack with the compiled backend.
    Returns the flat new state."""
    exe = compile(cfg, batch=x.shape[0], placement=mesh, mode="decode")
    return exe.decode(params, state, x)


# ---------------------------------------------------------------------------
# deprecated one-shot surface: plan() / ExecPlan
# ---------------------------------------------------------------------------

def plan(cfg: GRUConfig, *, batch: Optional[int] = None,
         seq: Optional[int] = None, mesh=None, mask: bool = False,
         mode: str = "serve") -> GRUExecutable:
    """DEPRECATED one-shot resolve: returns the SAME memoized executable
    :func:`compile` would; warns once per process."""
    gru_core._warn_deprecated("runtime.plan")
    return compile(cfg, batch=batch, seq=seq, placement=mesh, mask=mask,
                   mode=mode)


def __getattr__(name: str):
    if name == "ExecPlan":
        # the deprecated class name: plans are executables now
        gru_core._warn_deprecated("runtime.ExecPlan")
        return GRUExecutable
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
