"""The paper's parallelization study across the ranks of a mesh
(counterpart of ``repro.core.rowparallel``).

Row-wise (the paper's scheme, output-stationary): U's OUTPUT rows are
split across the ranks. Every rank receives the full vector, finishes the
outputs of its own rows, and the next step's full vector is reassembled
by an ALL-GATHER (the paper's interface-tile aggregation); there is no
partial-sum reduction.

Cascade (the paper's baseline, contraction-stationary): U's CONTRACTION
dim is split; every rank multiplies its slice of the vector by its rows
of U and the partial sums are combined by a PSUM (the AIE cascade
stream).

GRU specifics: with the paper's gate math (v1) the candidate needs the
full ``r * h``, so a row-wise step gathers twice (after z, r and after
h'); the ``v3`` variant fuses the U products and gathers once.

Deep stacks: every layer's rows are split over the same axis, and a
row-wise step's trailing gather of ``h'`` is exactly the replicated input
the next layer's input projection needs, so layer boundaries add no
collective. A cascade layer keeps its state split through the sequence
and gathers its output sequence once, for the layer above.

JAX runs one ``shard_map`` program over a mesh of devices; here every rank
is a process that runs the functions below on its own slice of the
weights (``prepare_sharded_layers``), and the collectives are
:class:`repro_torch.distributed.mesh.Mesh`'s ``all_gather`` and ``psum``.
Inputs and outputs are replicated: each rank passes the same ``xs`` and
``h0s`` and gets the same results. Sequences run time-major (T, B, .), so
an input projection is one matmul over T*B contiguous rows and a masked,
left-padded prompt keeps the bits of its unpadded original.

The per-shard step is a parameter (``_STEP_IMPLS``): ``"eager"`` runs
plain ops (the ``sharded`` and ``sharded_decode`` backends); ``"cuda"``
runs the shard kernels of ``repro_torch.kernels.gru_sequence`` between the
same collectives (the ``cuda_sharded`` backend, JAX's ``pallas_sharded``).
The JAX package's per-call entry points (``gru_stack_sequence_sharded``,
``gru_stack_sequence_sharded_impl``, ``gru_stack_decode_sharded_impl``)
remain as deprecated shims over the executor, pinned to ``sharded`` and
``sharded_decode``: each places this rank's part on every call and warns
once per process.
The kernels' plain versions repeat the eager step's expressions, so on the
CPU the two are equal bit for bit. The cascade step applies its gate
nonlinearities to this rank's gate slices only; JAX's XLA step computes
full-width gates and then slices (the same function), but PyTorch's CPU
sigmoid and tanh round by position in a vector, so slicing first is what
keeps the two steps bitwise equal.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch

from repro_torch.configs.base import GRUConfig
from repro_torch.distributed.mesh import Mesh


# ---------------------------------------------------------------------------
# plain matvecs (the benchmark's building blocks)
# ---------------------------------------------------------------------------

def rowparallel_matmul(x: torch.Tensor, w_shard: torch.Tensor,
                       mesh: Mesh) -> torch.Tensor:
    """y = x @ w with w's OUTPUT columns split over the ranks (``w_shard``
    this rank's columns); an all-gather of the finished outputs."""
    return mesh.all_gather(x @ w_shard, x.dim() - 1)


def colparallel_matmul(x_shard: torch.Tensor, w_shard: torch.Tensor,
                       mesh: Mesh) -> torch.Tensor:
    """y = x @ w with the CONTRACTION split (``x_shard`` this rank's
    columns of x, ``w_shard`` its rows of w); a psum of partial sums."""
    return mesh.psum(x_shard @ w_shard)


# ---------------------------------------------------------------------------
# one step of one layer, per rank
# ---------------------------------------------------------------------------

def _local(a: torch.Tensor, start: int, Hl: int) -> torch.Tensor:
    return a[:, start:start + Hl]


def _local_gates(a: torch.Tensor, gates: int, H: int, idx: int,
                 Hl: int) -> torch.Tensor:
    """This rank's (B, gates*Hl) slice of stacked (B, gates*H) gates."""
    return torch.cat([_local(a, g * H + idx * Hl, Hl) for g in range(gates)],
                     dim=1)


def _gate_view(a: torch.Tensor, gates: int, H: int, idx: int,
               Hl: int) -> torch.Tensor:
    """This rank's gates of stacked (..., gates*H) gates as a (..., gates,
    Hl) view, no copy."""
    return a.unflatten(-1, (gates, H))[..., idx * Hl:(idx + 1) * Hl]


def _rowwise_step(h_full, xp_shard, u_shard, b_shard, idx, *, mesh: Mesh,
                  variant: str):
    """One GRU step on one rank. h_full (B,H) replicated; u_shard (H,3Hl)
    this rank's output rows of all three gates; xp_shard (B,3Hl) and
    b_shard (3Hl,) to match. Returns the all-gathered h' (B,H)."""
    H = h_full.shape[1]
    Hl = H // mesh.size
    h32 = h_full.float()
    xz, xr, xh = (xp_shard[:, :Hl], xp_shard[:, Hl:2 * Hl],
                  xp_shard[:, 2 * Hl:])
    uz, ur, uh = u_shard[:, :Hl], u_shard[:, Hl:2 * Hl], u_shard[:, 2 * Hl:]
    bz, br, bh = b_shard[:Hl], b_shard[Hl:2 * Hl], b_shard[2 * Hl:]
    h_local = _local(h32, idx * Hl, Hl)
    if variant == "v3":
        # one U product, no mid-step gather
        z = torch.sigmoid(xz + h32 @ uz + bz)
        r = torch.sigmoid(xr + h32 @ ur + br)
        ht = torch.tanh(xh + r * (h32 @ uh + bh))
        return mesh.all_gather((1 - z) * h_local + z * ht, 1)
    # paper math: phase 1 -> gather r*h -> phase 2 -> gather h'
    z = torch.sigmoid(xz + h32 @ uz + bz)
    r = torch.sigmoid(xr + h32 @ ur + br)
    rh_full = mesh.all_gather(r * h_local, 1)                 # gather 1
    ht = torch.tanh(xh + rh_full @ uh + bh)
    return mesh.all_gather((1 - z) * h_local + z * ht, 1)     # gather 2


def _rowwise_step_cuda(h_full, xp_shard, u_shard, b_shard, idx, *,
                       mesh: Mesh, variant: str):
    """``_rowwise_step`` with the per-rank compute in the shard kernels (the
    ``cuda_sharded`` step): the same collectives in the same places; v3 is
    one kernel then the trailing gather, v1 the z/r kernel and the
    candidate kernel around the gather of r*h."""
    from repro_torch.kernels.gru_sequence import kernel as K
    H = h_full.shape[1]
    Hl = H // mesh.size
    h32 = h_full.float()
    h_local = _local(h32, idx * Hl, Hl)
    if variant == "v3":
        return mesh.all_gather(K.gru_rowwise_shard_step(
            h32, h_local, xp_shard, u_shard, b_shard), 1)
    z, rh_local = K.gru_rowwise_shard_zr(
        h32, h_local, xp_shard[:, :2 * Hl], u_shard[:, :2 * Hl],
        b_shard[:2 * Hl])
    rh_full = mesh.all_gather(rh_local, 1)                    # gather 1
    return mesh.all_gather(K.gru_rowwise_shard_candidate(     # gather 2
        rh_full, h_local, z, xp_shard[:, 2 * Hl:], u_shard[:, 2 * Hl:],
        b_shard[2 * Hl:]), 1)


def _cascade_step(h_shard, xp_full, u_rows, b_full, idx, *, mesh: Mesh,
                  variant: str):
    """Contraction-parallel step: h_shard (B,Hl) this rank's part of h,
    u_rows (Hl,3H) its rows of U; partial products psum'd; returns the new
    h shard (B,Hl). The gates are computed on this rank's slices."""
    Hl = h_shard.shape[1]
    H = xp_full.shape[-1] // 3
    h32 = h_shard.float()
    if variant == "v3":
        g = mesh.psum(h32 @ u_rows) + b_full                  # psum 1
        gl = _local_gates(g, 3, H, idx, Hl)
        xl = _local_gates(xp_full, 3, H, idx, Hl)
        z = torch.sigmoid(xl[:, :Hl] + gl[:, :Hl])
        r = torch.sigmoid(xl[:, Hl:2 * Hl] + gl[:, Hl:2 * Hl])
        ht = torch.tanh(xl[:, 2 * Hl:] + r * gl[:, 2 * Hl:])
        return (1 - z) * h32 + z * ht
    zr = mesh.psum(h32 @ u_rows[:, :2 * H]) + b_full[:2 * H]  # psum 1
    zl = _local_gates(zr, 2, H, idx, Hl)
    xl = _local_gates(xp_full, 2, H, idx, Hl)
    z = torch.sigmoid(xl[:, :Hl] + zl[:, :Hl])
    r = torch.sigmoid(xl[:, Hl:] + zl[:, Hl:])
    ht_p = mesh.psum((r * h32) @ u_rows[:, 2 * H:])           # psum 2
    return (1 - z) * h32 + z * torch.tanh(_ht_in(xp_full, ht_p, b_full, H,
                                                 idx, Hl))


def _ht_in(xp_full, ht_p, b_full, H: int, idx: int, Hl: int):
    """The local candidate pre-activation, added as JAX adds it:
    xp + psum + b."""
    s = idx * Hl
    return (_local(xp_full, 2 * H + s, Hl) + _local(ht_p, s, Hl)
            + b_full[2 * H + s:2 * H + s + Hl])


def _cascade_step_cuda(h_shard, xp_full, u_rows, b_full, idx, *, mesh: Mesh,
                       variant: str):
    """``_cascade_step`` with the per-rank compute in the shard kernels: the
    partial products and the gate epilogues run in kernels, the psums
    between them stay where the eager step has them. Each epilogue reads
    this rank's columns of the psum, of xp and of b in place and adds them
    itself, one launch after the psum: v3's gates, v1's candidate
    pre-activation ((xp + psum) + b, as ``_ht_in`` adds it)."""
    from repro_torch.kernels.gru_sequence import kernel as K
    Hl = h_shard.shape[1]
    H = xp_full.shape[-1] // 3
    h32 = h_shard.float()
    if variant == "v3":
        g = mesh.psum(K.gru_shard_matvec(h32, u_rows))            # psum 1
        return K.gru_cascade_shard_gates(
            _gate_view(g, 3, H, idx, Hl), _gate_view(xp_full, 3, H, idx, Hl),
            h32, _gate_view(b_full, 3, H, idx, Hl))
    zr = (mesh.psum(K.gru_shard_matvec(h32, u_rows[:, :2 * H]))  # psum 1
          + b_full[:2 * H])
    z, ht_p = K.gru_cascade_shard_zr(
        _local_gates(zr, 2, H, idx, Hl), _local_gates(xp_full, 2, H, idx, Hl),
        h32, u_rows[:, 2 * H:])
    ht_p = mesh.psum(ht_p)                                        # psum 2
    s = 2 * H + idx * Hl
    return K.gru_cascade_shard_update(z, _local(ht_p, idx * Hl, Hl), h32,
                                      _local(xp_full, s, Hl),
                                      b_full[s:s + Hl])


# step_impl -> (row-wise step, cascade step): "eager" for `sharded` and
# `sharded_decode`, "cuda" for `cuda_sharded`
_STEP_IMPLS = {"eager": (_rowwise_step, _cascade_step),
               "cuda": (_rowwise_step_cuda, _cascade_step_cuda)}


# ---------------------------------------------------------------------------
# one layer over a whole sequence (depth 1)
# ---------------------------------------------------------------------------

def gru_sequence_sharded(params: dict, h0: torch.Tensor, xs: torch.Tensor, *,
                         mesh: Mesh, cfg: GRUConfig) -> torch.Tensor:
    """One cell over xs (B,T,X) with the paper's scheme
    (``cfg.matvec_mode``) across the mesh; returns the final h (B,H),
    replicated. ``params`` is the full cell: this rank slices its part
    here (per call; the executor's backends slice once, in ``prepare``).
    Requires H % mesh.size == 0."""
    layer = prepare_sharded_layers((params,), cfg, mesh=mesh)
    finals = gru_stack_sequence_sharded_prepared(layer, (h0,), xs, mesh=mesh,
                                                 cfg=cfg)
    return finals[0]


# ---------------------------------------------------------------------------
# deep stacks: per-layer split with collective reuse
# ---------------------------------------------------------------------------

def _layer_view(cell: dict, mode: str) -> dict:
    """One layer's weight views before slicing: gate-major reshapes for a
    row-wise layer (so a rank owns rows of all three gates), the raw cell
    for a cascade layer."""
    H = cell["u"].shape[0]
    if mode == "rowwise":
        Xl = cell["w"].shape[0]
        return {"w3": cell["w"].reshape(Xl, 3, H),
                "u3": cell["u"].reshape(H, 3, H),
                "b3": cell["b"].reshape(3, H)}
    return {"w": cell["w"], "u": cell["u"], "b": cell["b"]}


def _layer_spec(mode: str) -> dict:
    """Which dim of each view is split over the ranks (None: replicated),
    the counterpart of JAX's PartitionSpecs."""
    if mode == "rowwise":
        return {"w3": 2, "u3": 2, "b3": 1}
    return {"w": None, "u": 0, "b": None}


def _check_width(H: int, n: int) -> None:
    if H % n:
        raise ValueError(f"H={H} does not split over {n} ranks "
                         f"(H % ranks must be 0)")


def prepare_sharded_layers(cells, cfg: GRUConfig, *, mesh: Mesh) -> tuple:
    """One-time placement for the sharded backends: per layer, the
    gate-major views sliced to this rank's part and copied to
    ``mesh.device``. Each slice is a tensor of its own, so no rank holds
    another rank's rows of U on its device. This is what
    ``runtime.prepare(params, cfg, placement)`` calls for a mesh."""
    placed = []
    for l, c in enumerate(tuple(cells)):
        H = c["u"].shape[0]
        _check_width(H, mesh.size)
        Hl = H // mesh.size
        lo = mesh.rank * Hl
        view = _layer_view(c, cfg.layer_matvec_mode(l))
        spec = _layer_spec(cfg.layer_matvec_mode(l))
        placed.append({
            k: (v if spec[k] is None else v.narrow(spec[k], lo, Hl))
            .contiguous().to(mesh.device, copy=True)
            for k, v in view.items()})
    return tuple(placed)


def _layer_dims(layer_args) -> list:
    """Hidden size per layer, read off the placed views."""
    return [(a["u3"].shape[0] if "u3" in a else a["w"].shape[1] // 3)
            for a in layer_args]


def _stepper(layer_args, cfg: GRUConfig, mesh: Mesh, step_impl: str):
    L = len(layer_args)
    dims = _layer_dims(layer_args)
    for H in dims:
        _check_width(H, mesh.size)
    modes = [cfg.layer_matvec_mode(l) for l in range(L)]
    rowwise_step, cascade_step = _STEP_IMPLS[step_impl]
    kw = dict(mesh=mesh, variant=cfg.variant)
    return (dims, modes, functools.partial(rowwise_step, **kw),
            functools.partial(cascade_step, **kw))


def _flat(a: dict, key: str) -> torch.Tensor:
    """A placed gate-major view, flattened to its kernel layout."""
    t = a[key]
    return t.reshape(t.shape[0], -1) if t.dim() == 3 else t.reshape(-1)


def gru_stack_sequence_sharded_prepared(layer_args, h0s: Sequence,
                                        xs: torch.Tensor, *, mesh: Mesh,
                                        cfg: GRUConfig,
                                        return_all: bool = False, mask=None,
                                        step_impl: str = "eager"):
    """The execute stage of the sharded sequence backends, on this rank's
    placed views (``prepare_sharded_layers``; ``StackParams.placed``).

    Returns the per-layer finals (B,H), replicated; with ``return_all``,
    ``(finals, last layer's states (B,T,H))``. ``mask`` (B,T), optional:
    False steps keep every layer's state. A row-wise layer gates after the
    step's trailing gather (its carry is the full h); a cascade layer gates
    its local carry: no collective is added, and the ranks stay in step.
    ``step_impl``: ``"eager"`` (``sharded``) or ``"cuda"``
    (``cuda_sharded``)."""
    B, T, _ = xs.shape
    dims, modes, rowwise_step, cascade_step = _stepper(layer_args, cfg, mesh,
                                                       step_impl)
    L = len(layer_args)
    idx, n = mesh.rank, mesh.size
    cur = xs.float().transpose(0, 1).contiguous()            # (T,B,X)
    live = None if mask is None else (mask != 0).transpose(0, 1)  # (T,B)
    finals, states = [], None
    for l in range(L):
        H, a = dims[l], layer_args[l]
        emit = l < L - 1 or return_all
        if modes[l] == "rowwise":
            xp = cur @ _flat(a, "w3")                          # (T,B,3Hl)
            u, b = _flat(a, "u3"), _flat(a, "b3")
            h = h0s[l].float()

            def step(h, t, u=u, b=b, xp=xp):
                return rowwise_step(h, xp[t], u, b, idx)
        else:
            Hl = H // n
            xp = cur @ a["w"].float()                          # (T,B,3H)
            h = _local(h0s[l].float(), idx * Hl, Hl).contiguous()

            def step(h, t, a=a, xp=xp):
                return cascade_step(h, xp[t], a["u"], a["b"], idx)
        seq = []
        for t in range(T):
            h2 = step(h, t)
            h = h2 if live is None else torch.where(live[t][:, None], h2, h)
            if emit:
                seq.append(h)
        if modes[l] == "rowwise":
            # the carry is already the full h, gathered by the step
            out = torch.stack(seq) if emit else None
            hT = h
        elif emit:
            # one gather republishes the whole output sequence
            out = mesh.all_gather(torch.stack(seq), 2)         # (T,B,H)
            hT = out[-1]
        else:
            out, hT = None, mesh.all_gather(h, 1)
        finals.append(hT)
        if l < L - 1:
            cur = out
        else:
            states = out
    if return_all:
        return tuple(finals), states.transpose(0, 1)
    return tuple(finals)


def gru_stack_decode_sharded_prepared(layer_args, hs: Sequence,
                                      x: torch.Tensor, *, mesh: Mesh,
                                      cfg: GRUConfig,
                                      step_impl: str = "eager") -> tuple:
    """One serve step through the whole stack on this rank's placed views
    (the ``sharded_decode`` backend; ``step_impl="cuda"`` is
    ``cuda_sharded``'s decode). ``hs``: per-layer (B,H) replicated
    states; ``x`` (B,X). Returns the per-layer new states, replicated:
    the cache layout of the replicated decode backends, so a server can
    switch backends without converting state. A row-wise layer's trailing
    gather is the next layer's input; a cascade layer gathers its new
    state once."""
    dims, modes, rowwise_step, cascade_step = _stepper(layer_args, cfg, mesh,
                                                       step_impl)
    idx, n = mesh.rank, mesh.size
    cur = x.float()
    outs = []
    for l, (H, a) in enumerate(zip(dims, layer_args)):
        if modes[l] == "rowwise":
            h2 = rowwise_step(hs[l].float(), cur @ _flat(a, "w3"),
                              _flat(a, "u3"), _flat(a, "b3"), idx)
        else:
            Hl = H // n
            h_shard = _local(hs[l].float(), idx * Hl, Hl).contiguous()
            h2 = mesh.all_gather(cascade_step(h_shard, cur @ a["w"].float(),
                                              a["u"], a["b"], idx), 1)
        outs.append(h2)
        cur = h2
    return tuple(outs)


# ---------------------------------------------------------------------------
# deprecated per-call entry points (executor shims)
# ---------------------------------------------------------------------------

def _sharded_sequence_shim(params, h0s, xs, *, mesh: Mesh, cfg: GRUConfig,
                           return_all: bool, mask):
    from repro_torch.core import runtime
    exe = runtime.compile(dataclasses.replace(cfg, backend="sharded"),
                          batch=xs.shape[0], seq=xs.shape[1],
                          mask=mask is not None, placement=mesh,
                          mode="sequence")
    finals, states = exe.sequence(params, h0s, xs, return_all=return_all,
                                  mask=mask)
    return (finals, states) if return_all else finals


def gru_stack_sequence_sharded(params, h0s, xs, *, mesh: Mesh,
                               cfg: GRUConfig, return_all: bool = False,
                               mask=None):
    """DEPRECATED: use ``runtime.compile(cfg, placement=mesh)``, which
    sends sequence work to the split whenever a mesh is given. A shim over
    the executor's ``sharded`` backend (full cells in ``params``; this
    rank's part placed per call). Returns the per-layer finals, or
    ``(finals, last layer's states)`` with ``return_all``."""
    from repro_torch.core.gru import _warn_deprecated
    _warn_deprecated("gru_stack_sequence_sharded")
    return _sharded_sequence_shim(params, h0s, xs, mesh=mesh, cfg=cfg,
                                  return_all=return_all, mask=mask)


def gru_stack_sequence_sharded_impl(params, h0s, xs, *, mesh: Mesh,
                                    cfg: GRUConfig, return_all: bool = False,
                                    mask=None):
    """DEPRECATED per-call form of the ``sharded`` backend: the same shim
    as :func:`gru_stack_sequence_sharded`."""
    from repro_torch.core.gru import _warn_deprecated
    _warn_deprecated("gru_stack_sequence_sharded_impl")
    return _sharded_sequence_shim(params, h0s, xs, mesh=mesh, cfg=cfg,
                                  return_all=return_all, mask=mask)


def gru_stack_decode_sharded_impl(params, hs, x, *, mesh: Mesh,
                                  cfg: GRUConfig) -> tuple:
    """DEPRECATED per-call decode of the split: a shim over the executor's
    ``sharded_decode`` backend (this rank's part placed per call)."""
    from repro_torch.core import runtime
    from repro_torch.core.gru import _warn_deprecated
    _warn_deprecated("gru_stack_decode_sharded_impl")
    exe = runtime.compile(dataclasses.replace(cfg, backend="sharded_decode"),
                          batch=x.shape[0], placement=mesh, mode="decode")
    return exe.decode(params, hs, x)
