"""Wrappers of the fused sLSTM kernels (``repro_torch/csrc/slstm_cell.cu``).

Same names and array interface as the Pallas kernels in
``repro.kernels.slstm_cell.kernel`` (fp32, gate order [z, i, f, o]):

* :func:`slstm_stack_sequence_kernel` — fused depth-L masked prefill:
  ``c0, n0, m0, h0`` (L,B,H), ``x_proj`` (T,B,4H), ``u`` (L,H,4H),
  ``w_deep`` (L-1,H,4H) ((1,1,4H) for L=1, unused), ``b`` (L,4H),
  optional ``mask`` (T,B) -> ``hs`` (T,B,H) (the last layer's h after
  every step), then ``cT, nT, mT, hT``, each (L,B,H); it launches the
  route :func:`slstm_stack_seq_plan` picks and keeps it as ``last_plan``;
* :func:`slstm_stack_decode_kernel` — one token through L layers:
  the four (L,B,H) leaves and ``x_proj`` (B,4H) -> the four new leaves;
  it launches the route :func:`slstm_decode_plan` picks and keeps it as
  ``last_plan``;
* :func:`slstm_stack_decode_layers` — the same launch on the served
  model's per-layer leaves (L tuples of four (B,H) tensors), returning
  fresh per-layer leaves.

Both kernels have one warp route (where H <= 32 and L <= 4; the decode is
its T = 1): a block a batch row on a wavefront skewed by layer, which
reads and writes the leaves in place through a table of per-layer
pointers, so the served decode's state is never stacked. Past those
bounds, and for a nonzero ``batch_block`` of the decode (its tile), the
block route serves; it reads (L,B,H) stacks.

Every wrapper checks device, dtype, shapes and contiguity and raises on
anything the kernel does not take (:mod:`repro_torch.kernels._launch`).
For CPU tensors it returns the plain PyTorch version (``ref.py``); for
CUDA tensors it allocates the outputs with ``torch.empty``, launches the
kernel on the current stream, raises if the launch was refused, and adds
one to its kernel's ``launches`` counter. Nothing falls back from the card
to the plain version. :func:`launch_decode` and :func:`launch_sequence`
launch any plan (the sweep and the card's tests force routes with them).

The counters form :data:`SLSTM_KERNELS`;
``repro_torch.kernels.gru_sequence.kernel.reset_launch_counts`` zeroes
them with the GRU kernels'. A block route's block takes a tile of
``DEFAULT_BATCH_BLOCK`` rows (at most 256); U, the deep layers' W, b, the
tile's four leaves and two steps of its ``x_proj`` must fit the 227 KB of
shared memory a Hopper block may use.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels._launch import I, P
from repro_torch.kernels._launch import check as _check
from repro_torch.kernels._launch import ptr as _ptr
from repro_torch.kernels._launch import raise_on as _raise_on
from repro_torch.kernels._launch import stream as _stream
from repro_torch.kernels.slstm_cell import ref

_LIBRARY = "slstm_cell"
_SIGNATURES = {
    # c0, n0, m0, h0, xp, u, wd, b, mask, out, cT, nT, mT, hT, T, B, H, L,
    # bt, stream
    "slstm_stack_sequence_launch": [P] * 14 + [I] * 5 + [P],
    # c, n, m, h, xp, u, wd, b, co, no, mo, ho, B, H, L, bt, stream
    "slstm_stack_decode_launch": [P] * 12 + [I] * 4 + [P],
    # leaves (8L pointers), xp, u, wd, b, mask, out, T, B, H, L, stream
    "slstm_stack_warp_launch": [P] * 7 + [I] * 4 + [P],
}
_LEAVES = ("c", "n", "m", "h")


def _launcher(name: str):
    return _launch.launcher(_LIBRARY, name, _SIGNATURES[name])


def smem_bytes(L: int, H: int, bt: int) -> int:
    """Dynamic shared memory of one block-route block (mirrors
    ``smem_bytes`` in the CUDA source): U, deep W, b, two steps of the
    tile's ``x_proj``, h at an odd word stride for two step parities, c, n
    and m, and the double-buffered step liveness."""
    H4 = 4 * H
    floats = (L * H * H4 + (L - 1) * H * H4 + L * H4 + 2 * bt * H4
              + 2 * L * bt * (H | 1) + 3 * L * bt * H + 2 * bt)
    return 4 * floats


def block_threads(H: int, bt: int) -> int:
    """Threads of a block-route block (``block_threads`` in the CUDA
    source): one per (row, unit) of the tile in whole warps, 128 to
    256."""
    return min(max(-(-bt * H // 32) * 32, 128), _launch.THREADS)


# The warp route (rows 9 and 8): a block of 2L - 1 warps a batch row, lane
# c of a warp owning unit c of the four gates. At most WARP_MAX_L layers
# (kMaxLayers: the deepest stack swept on the card by tools/slstm_tiles.py
# and held there against the block route), only where H <= WARP_MAX_H.
WARP_MAX_H = 32
WARP_MAX_L = 4


@dataclasses.dataclass(frozen=True)
class SlstmPlan:
    """One launch of an sLSTM kernel: ``route`` "warp" (a batch row a
    block of 2L - 1 warps) or "block" (``run_stack``: ``rows`` the batch
    tile of a block). ``grid`` blocks, ``threads`` per block, ``smem``
    dynamic bytes (none on the warp route, whose shared memory is
    static)."""
    route: str
    rows: int
    grid: int
    threads: int
    smem: int


def warp_plan(B: int, L: int) -> SlstmPlan:
    """The warp route's launch, either kernel: B blocks of 2L - 1 warps."""
    return SlstmPlan("warp", 1, B, 32 * (2 * L - 1), 0)


def block_plan(B: int, H: int, L: int, bt: int) -> SlstmPlan:
    """The block-route launch (``run_stack``, either kernel) at batch tile
    ``bt``."""
    return SlstmPlan("block", bt, -(-B // bt), block_threads(H, bt),
                     smem_bytes(L, H, bt))


def _block_or_none(B, T, H, L, batch_block) -> Optional[SlstmPlan]:
    _launch.check_problem(None, B, T, H, L)
    if batch_block or H > WARP_MAX_H or L > WARP_MAX_L:
        return block_plan(B, H, L, _launch.batch_tile(
            None, B, T, H, L, batch_block, None, smem_bytes))
    return None


@functools.lru_cache(maxsize=512)
def slstm_decode_plan(B: int, H: int, L: int,
                      batch_block: int = 0) -> SlstmPlan:
    """The launch of :func:`slstm_stack_decode_kernel`: the warp route
    where H <= :data:`WARP_MAX_H` and L <= :data:`WARP_MAX_L`, else, or
    where ``batch_block`` is nonzero (JAX's block tile), the block route at
    :func:`_launch.batch_tile`'s tile (which raises where one block's
    shared memory does not fit)."""
    blk = _block_or_none(B, 1, H, L, batch_block)
    return warp_plan(B, L) if blk is None else blk


@functools.lru_cache(maxsize=512)
def slstm_stack_seq_plan(B: int, T: int, H: int, L: int) -> SlstmPlan:
    """The launch of :func:`slstm_stack_sequence_kernel`: the warp route
    where H <= :data:`WARP_MAX_H` and L <= :data:`WARP_MAX_L`, else the
    block route at :func:`_launch.batch_tile`'s tile."""
    blk = _block_or_none(B, T, H, L, 0)
    return warp_plan(B, L) if blk is None else blk


def _w_deep_shape(L: int, H: int) -> tuple:
    """(L-1,H,4H); a depth-1 stack passes the unused (1,1,4H) placeholder."""
    return (L - 1, H, 4 * H) if L > 1 else (1, 1, 4 * H)


def _check_weights(u, w_deep, b, L, H, dev) -> None:
    _check("u", u, (L, H, 4 * H), dev)
    _check("w_deep", w_deep, _w_deep_shape(L, H), dev)
    _check("b", b, (L, 4 * H), dev)


def _check_operands(leaves, u, w_deep, b, L, B, H, dev) -> None:
    for name, leaf in zip(_LEAVES, leaves):
        _check(name, leaf, (L, B, H), dev)
    _check_weights(u, w_deep, b, L, H, dev)


def _empty_leaves(L: int, B: int, H: int, dev) -> tuple:
    return tuple(torch.empty((L, B, H), dtype=torch.float32, device=dev)
                 for _ in _LEAVES)


def _layers(stacks) -> tuple:
    """Four (L,B,H) leaf stacks -> L tuples of four (B,H) views."""
    return tuple(tuple(leaf[l] for leaf in stacks)
                 for l in range(stacks[0].shape[0]))


def _warp(ins: Sequence, outs: Sequence, x_proj, u, w_deep, b, mask, hs,
          T: int) -> int:
    """Launch the warp route on per-layer leaves ``ins`` into ``outs`` (L
    tuples of four (B,H) tensors each), through the C entry's table of
    per-layer pointers, the top layer's h after every step into ``hs``
    (T,B,H). Returns the C entry's error code."""
    L = len(ins)
    B, H = ins[0][3].shape
    table = (ctypes.c_void_p * (8 * L))(
        *(leaf.data_ptr() for layer in ins for leaf in layer),
        *(leaf.data_ptr() for layer in outs for leaf in layer))
    return _launcher("slstm_stack_warp_launch")(
        table, _ptr(x_proj), _ptr(u), _ptr(w_deep), _ptr(b), _ptr(mask),
        _ptr(hs), T, B, H, L, _stream(x_proj.device))


def _launch_decode(p: SlstmPlan, layers: Sequence, stacks, x_proj, u,
                   w_deep, b) -> torch.Tensor:
    """Launch the decode at plan ``p`` on per-layer leaves ``layers`` ->
    the new leaves as one fresh (4,L,B,H) tensor, whose four (L,B,H) leaf
    stacks and L per-layer tuples are views. The warp route reads the
    leaves in place, and writes its one step's h sequence to a row of the
    same allocation past them, dropped; the block route reads (L,B,H)
    stacks: ``stacks`` where the caller has them, else stacked here (four
    copies)."""
    L = len(layers)
    B, H = layers[0][3].shape
    n = len(_LEAVES) * L * B * H
    buf = torch.empty(n + B * H, dtype=torch.float32, device=x_proj.device)
    new = buf[:n].view(len(_LEAVES), L, B, H)
    if p.route == "warp":
        err = _warp(layers, _layers(new.unbind(0)), x_proj, u, w_deep, b,
                    None, buf[n:].view(1, B, H), 1)
    else:
        if stacks is None:
            stacks = tuple(torch.stack([layer[k] for layer in layers])
                           for k in range(len(_LEAVES)))
        err = _launcher("slstm_stack_decode_launch")(
            *map(_ptr, stacks), _ptr(x_proj), _ptr(u), _ptr(w_deep),
            _ptr(b), *map(_ptr, new.unbind(0)), B, H, L, p.rows,
            _stream(x_proj.device))
    _raise_on(err, "slstm_stack_decode_kernel")
    return new


def launch_decode(p: SlstmPlan, c, n, m, h, x_proj, u, w_deep, b) -> tuple:
    """Launch the decode at plan ``p`` on (L,B,H) leaf stacks of the card
    -> four fresh (L,B,H) leaves; no checks and no count (the wrapper's
    job): the sweep and the card's tests force either route with it."""
    stacks = (c, n, m, h)
    return _launch_decode(p, _layers(stacks), stacks, x_proj, u, w_deep,
                          b).unbind(0)


def launch_sequence(p: SlstmPlan, c0, n0, m0, h0, x_proj, u, w_deep, b,
                    mask=None) -> tuple:
    """Launch the prefill at plan ``p`` on tensors of the card -> (hs,
    cT, nT, mT, hT), fresh; no checks and no count, as
    :func:`launch_decode`."""
    T, B, _ = x_proj.shape
    L, _, H = h0.shape
    dev = x_proj.device
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    fin = _empty_leaves(L, B, H, dev)
    if p.route == "warp":
        err = _warp(_layers((c0, n0, m0, h0)), _layers(fin), x_proj, u,
                    w_deep, b, mask, hs, T)
    else:
        err = _launcher("slstm_stack_sequence_launch")(
            _ptr(c0), _ptr(n0), _ptr(m0), _ptr(h0), _ptr(x_proj), _ptr(u),
            _ptr(w_deep), _ptr(b), _ptr(mask), _ptr(hs), *map(_ptr, fin),
            T, B, H, L, p.rows, _stream(dev))
    _raise_on(err, "slstm_stack_sequence_kernel")
    return (hs,) + fin


@_launch.forward_only
def slstm_stack_sequence_kernel(c0: torch.Tensor, n0: torch.Tensor,
                                m0: torch.Tensor, h0: torch.Tensor,
                                x_proj: torch.Tensor, u: torch.Tensor,
                                w_deep: torch.Tensor, b: torch.Tensor,
                                mask: Optional[torch.Tensor] = None):
    """Fused depth-L sLSTM over T steps -> (hs (T,B,H), cT, nT, mT, hT);
    False steps of ``mask`` freeze all four leaves of every layer.
    Launches :func:`slstm_stack_seq_plan`'s route and keeps the plan as
    ``last_plan``."""
    if x_proj.dim() != 3 or h0.dim() != 3:
        raise ValueError("x_proj (T,B,4H) and h0 (L,B,H) expected, got "
                         f"{tuple(x_proj.shape)} and {tuple(h0.shape)}")
    T, B, _ = x_proj.shape
    L, _, H = h0.shape
    dev = x_proj.device
    _launch.check_device(dev)
    p = slstm_stack_seq_plan(B, T, H, L)
    _check_operands((c0, n0, m0, h0), u, w_deep, b, L, B, H, dev)
    _check("x_proj", x_proj, (T, B, 4 * H), dev)
    if mask is not None:
        _check("mask", mask, (T, B), dev)
    if dev.type == "cpu":
        return ref.slstm_stack_sequence_ref(c0, n0, m0, h0, x_proj, u,
                                            w_deep, b, mask)
    out = launch_sequence(p, c0, n0, m0, h0, x_proj, u, w_deep, b, mask)
    slstm_stack_sequence_kernel.launches += 1
    slstm_stack_sequence_kernel.last_plan = p
    return out


def _decode(layers: tuple, stacks, x_proj, u, w_deep, b,
            batch_block: int) -> torch.Tensor:
    """Both decode wrappers' work on per-layer leaves (``stacks`` the
    (L,B,H) stacks they are views of, or None): check every leaf, plan,
    the plain version for CPU tensors, else launch, count and keep the
    plan. Returns the new leaves as one (4,L,B,H) tensor."""
    L = len(layers)
    if L < 1:
        raise ValueError("empty problem: L=0")
    B, H = layers[0][3].shape
    dev = layers[0][3].device
    _launch.check_device(dev)
    p = slstm_decode_plan(B, H, L, batch_block)
    for l, layer in enumerate(layers):
        for name, leaf in zip(_LEAVES, layer):
            _check(f"{name}{l}", leaf, (B, H), dev)
    _check_weights(u, w_deep, b, L, H, dev)
    _check("x_proj", x_proj, (B, 4 * H), dev)
    if dev.type == "cpu":
        new = ref.slstm_stack_decode_layers_ref(layers, x_proj, u, w_deep, b)
        return torch.stack([torch.stack([layer[k] for layer in new])
                            for k in range(len(_LEAVES))])
    out = _launch_decode(p, layers, stacks, x_proj, u, w_deep, b)
    slstm_stack_decode_kernel.launches += 1
    slstm_stack_decode_kernel.last_plan = p
    return out


@_launch.forward_only
def slstm_stack_decode_kernel(c: torch.Tensor, n: torch.Tensor,
                              m: torch.Tensor, h: torch.Tensor,
                              x_proj: torch.Tensor, u: torch.Tensor,
                              w_deep: torch.Tensor, b: torch.Tensor, *,
                              batch_block: int = 0) -> tuple:
    """One token through all L layers -> the four new leaves (L,B,H).
    Launches :func:`slstm_decode_plan`'s route and keeps the plan as
    ``last_plan``; a nonzero ``batch_block`` names the block route's
    tile."""
    if h.dim() != 3 or x_proj.dim() != 2:
        raise ValueError("h (L,B,H) and x_proj (B,4H) expected, got "
                         f"{tuple(h.shape)} and {tuple(x_proj.shape)}")
    stacks = (c, n, m, h)
    _launch.check_device(h.device)
    for name, leaf in zip(_LEAVES, stacks):
        _check(name, leaf, tuple(h.shape), h.device)
    return _decode(_layers(stacks), stacks, x_proj, u, w_deep, b,
                   batch_block).unbind(0)


@_launch.forward_only
def slstm_stack_decode_layers(layers: Sequence, x_proj: torch.Tensor,
                              u: torch.Tensor, w_deep: torch.Tensor,
                              b: torch.Tensor) -> tuple:
    """:func:`slstm_stack_decode_kernel` on per-layer leaves: ``layers``
    is L tuples (c, n, m, h) of (B,H) tensors (the served model's state);
    returns L tuples of fresh (B,H) leaves, the same values bit for bit.
    The warp route reads and writes them in place; the block route stacks
    them first (four copies). Counts a launch of
    :func:`slstm_stack_decode_kernel` and keeps its ``last_plan``."""
    layers = tuple(tuple(layer) for layer in layers)
    if not layers or any(len(layer) != len(_LEAVES) for layer in layers):
        raise ValueError(f"expected L >= 1 tuples of four leaves, got "
                         f"{[len(layer) for layer in layers]}")
    if layers[0][3].dim() != 2 or x_proj.dim() != 2:
        raise ValueError("h (B,H) leaves and x_proj (B,4H) expected, got "
                         f"{tuple(layers[0][3].shape)} and "
                         f"{tuple(x_proj.shape)}")
    return _layers(_decode(layers, None, x_proj, u, w_deep, b,
                           0).unbind(0))


SLSTM_KERNELS = (slstm_stack_sequence_kernel, slstm_stack_decode_kernel)
for _fn in SLSTM_KERNELS:
    _fn.launches = 0
    _fn.last_plan = None
