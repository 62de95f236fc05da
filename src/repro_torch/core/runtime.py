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
one. An illegal preference falls through to the cheapest legal backend.
So heterogeneous ``layer_dims`` under ``"cuda"``, or under a ``cuda_fused``
or ``cuda_fused_q8`` pin, run ``cuda_chain``, as the JAX runtime falls to
``pallas_chain``.

Mesh (``REQ``: the backend requires a mesh placement; without one it is
illegal, so a pin falls through). A mesh is an explicit request to use it
for sequence work: the mesh backends win prefill before the preference is
read (``cuda_sharded`` by its cost 4 unless a pin says otherwise). Decode
is latency-bound and ranks by preference and static cost alone, so under
``"cuda"`` it stays on the replicated ``cuda_fused`` (``cuda_sharded``'s
decode cost is 190); the exact names ``cuda_sharded`` and
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
(``BENCH_quant_accuracy.json``, or ``$REPRO_GRU_QUANT_ACC``; see
:func:`load_quant_accuracy`) passed. Its static cost keeps ``auto`` off it
even then. The measured CostModel is not ported yet. On CPU tensors the
``cuda*`` backends run the kernels' plain PyTorch versions (see
``repro_torch.kernels.gru_sequence`` and ``repro_torch.kernels.gru_cell``).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Callable, Dict, Optional, Tuple

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
    """None | Mesh | Placement -> Placement."""
    if p is None:
        return HOST
    if isinstance(p, Placement):
        return p
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
# quant accuracy gate (the q8 backends' dispatch-eligibility record)
# ---------------------------------------------------------------------------

class QuantAccuracy:
    """The recorded result of the q8 accuracy harness
    (``BENCH_quant_accuracy.json``, the JAX package's schema: ``"bench":
    "gru_quant_accuracy"``, ``"passed"``). Only a loaded, error-free
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
    Gate flips change which backends are legal, so the memoized
    executables are dropped."""
    global _QUANT_ACC
    _QUANT_ACC = report
    _EXEC_CACHE.clear()


def load_quant_accuracy(path) -> QuantAccuracy:
    """Load ``path`` (tolerantly) and install it. Returns the report."""
    report = QuantAccuracy.load(path)
    set_quant_accuracy(report)
    return report


def quant_accuracy() -> QuantAccuracy:
    """The active accuracy report. On first use, loads
    ``$REPRO_GRU_QUANT_ACC`` (default ``./BENCH_quant_accuracy.json``) if
    present; otherwise a closed gate."""
    global _QUANT_ACC
    if _QUANT_ACC is None:
        path = os.environ.get("REPRO_GRU_QUANT_ACC",
                              "BENCH_quant_accuracy.json")
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
# compile(): capability filtering + preference + static cost
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class GRUExecutable:
    """A compiled recurrent workload: resolved placement, backends and
    stable callables.

    ``sequence(params, state0, xs, *, return_all=False, mask=None)``
    returns ``(flat finals, last layer's h sequence | None)``; ``prefill``
    is its finals-only view; ``decode(params, state, x)`` returns the flat
    new state. A state is the family's flat tuple of per-layer leaves
    (GRU: ``h`` per layer; sLSTM: ``c, n, m, h`` per layer); under a mesh
    every rank passes and gets the same, replicated. ``params`` may be any
    layout ``prepare`` accepts; pass :meth:`prepare`'s output on hot paths
    so no call restacks or places weights."""
    cfg: GRUConfig
    batch: Optional[int]
    seq: Optional[int]
    masked: bool
    sequence_backend: str
    decode_backend: str
    placement: Placement = HOST
    sequence: Callable = dataclasses.field(repr=False, default=None)
    prefill: Callable = dataclasses.field(repr=False, default=None)
    decode: Callable = dataclasses.field(repr=False, default=None)

    @property
    def mesh(self):
        return self.placement.mesh

    def _specs(self) -> tuple:
        fam = cell_families.cfg_family(self.cfg)
        return (_REGISTRY[(fam, self.sequence_backend)],
                _REGISTRY[(fam, self.decode_backend)])

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


def _hetero(cfg: GRUConfig) -> bool:
    dims = cfg.resolved_layer_dims
    return any(d != dims[0] for d in dims)


def _rank(spec: BackendSpec, cfg: GRUConfig, *, op: str, mesh) -> tuple:
    """Selection key, lexicographic: mesh request (sequence ops: a mesh
    is an explicit ask for the split) > ``cfg.backend`` preference (family
    or exact name) > static cost of ``op`` > name (determinism)."""
    mesh_rank = 0
    if mesh is not None and op != "decode":
        mesh_rank = 0 if spec.caps.supports_mesh else 1
    pref = getattr(cfg, "backend", "eager")
    fam = 1
    if pref == spec.name:
        fam = 0                          # exact backend-name pin
    elif pref == "cuda" and spec.name.startswith("cuda"):
        fam = 0
    return (mesh_rank, fam, spec.static_cost(op), spec.name)


def _q8_allowed(spec: BackendSpec, cfg: GRUConfig) -> bool:
    """A ``*_q8`` backend is a candidate only under its exact-name pin, or
    under ``quant="int8"`` with the accuracy gate open."""
    if not spec.name.endswith("_q8") or cfg.backend == spec.name:
        return True
    return cfg.quant == "int8" and quant_gate_open()


def _select(cfg: GRUConfig, *, masked: bool, batch: Optional[int] = None,
            op: str = "sequence", placement: Placement = HOST
            ) -> BackendSpec:
    """The preferred legal backend of ``cfg``'s family for ``op`` at this
    batch on this placement (``eager`` serves every call, so there always
    is one). A mesh backend is legal only on a mesh."""
    hetero = _hetero(cfg)
    fam = cell_families.cfg_family(cfg)
    mesh = placement.mesh
    legal = [s for s in _REGISTRY.values()
             if s.family == fam and s.serves(op)
             and (s.caps.supports_mask or not masked)
             and (s.caps.supports_hetero_dims or not hetero)
             and (mesh is not None or not s.caps.supports_mesh)
             and _q8_allowed(s, cfg)
             and (s.fits is None or s.fits(cfg, batch, op))]
    return min(legal, key=lambda s: _rank(s, cfg, op=op, mesh=mesh))


_EXEC_CACHE: Dict[tuple, GRUExecutable] = {}


def compile(cfg: GRUConfig, *, batch: Optional[int] = None,
            seq: Optional[int] = None, mask: bool = False,
            placement=None) -> GRUExecutable:
    """Resolve the backends for a recurrent workload of ``cfg.family`` at
    these shapes on ``placement`` (a :class:`Placement`, a mesh, or None =
    host). ``mask`` declares whether sequence calls carry a (B, T) length
    mask (decode steps carry none). Memoized on (cfg, shapes, mask,
    placement): the same key returns the same object. An unregistered
    ``cfg.family`` raises ``UnknownCellFamily``."""
    _ensure_backends()
    cell_families.get_family(cell_families.cfg_family(cfg))
    pl_ = _as_placement(placement)
    masked = bool(mask)
    key = (cfg, batch, seq, masked, pl_)
    hit = _EXEC_CACHE.get(key)
    if hit is not None:
        return hit
    seq_spec = _select(cfg, masked=masked, batch=batch, op="sequence",
                       placement=pl_)
    dec_spec = _select(cfg, masked=False, batch=batch, op="decode",
                       placement=pl_)

    def stack_params(spec, params):
        return _stack_params(params, cfg, spec.views == "stacked",
                             spec.views == "quant",
                             pl_ if spec.caps.supports_mesh else HOST)

    def run_sequence(params, state0, xs, *, return_all=False, mask=None):
        if mask is not None and not masked:
            raise ValueError("executable was compiled with mask=False; "
                             "re-compile with mask=True to pass a mask")
        return seq_spec.sequence_fn(stack_params(seq_spec, params),
                                    tuple(state0), xs, cfg=cfg,
                                    return_all=return_all, mask=mask)

    def run_prefill(params, state0, xs, *, mask=None):
        return run_sequence(params, state0, xs, mask=mask)[0]

    def run_decode(params, state, x):
        return dec_spec.decode_fn(stack_params(dec_spec, params),
                                  tuple(state), x, cfg=cfg)

    exe = GRUExecutable(
        cfg=cfg, batch=batch, seq=seq, masked=masked,
        sequence_backend=seq_spec.name, decode_backend=dec_spec.name,
        placement=pl_, sequence=run_sequence, prefill=run_prefill,
        decode=run_decode)
    _EXEC_CACHE[key] = exe
    return exe
