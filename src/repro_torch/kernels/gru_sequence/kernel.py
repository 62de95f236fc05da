"""Wrappers of the GRU sequence kernels (``repro_torch/csrc/gru_sequence.cu``,
and the int8 ones in ``repro_torch/csrc/gru_sequence_q8.cu``).

Same names and array interface as the Pallas kernels in
``repro.kernels.gru_sequence.kernel``:

* :func:`gru_sequence_kernel` — depth-1 sequence, h0 (B,H), x_proj
  (T,B,3H), u (H,3H), b (3H,), optional mask (T,B) -> (T,B,H); it
  launches the route :func:`seq_plan` picks (one warp per batch row where
  H <= 32, else the block route of the other two) and keeps it as
  ``last_plan``;
* :func:`gru_stack_sequence_kernel` — fused depth-L sequence, h0 (L,B,H),
  u (L,H,3H), w_deep (L-1,H,3H) ((1,1,3H) for L=1, unused), b (L,3H)
  -> ((T,B,H) last layer, (L,B,H) finals); it launches the route
  :func:`stack_seq_plan` picks (a block per batch row: a warp per layer,
  and one between two layers, on a wavefront skewed by layer, where H <=
  32 and L <= 4; else the block route) and keeps it as ``last_plan``;
* :func:`gru_stack_decode_kernel` — one token through L layers, h (L,B,H),
  x_proj (B,3H) -> (L,B,H); it launches the route :func:`decode_plan`
  picks (one warp per batch row where H <= 32 and L <= 4, else the block
  route) and keeps it as ``last_plan``;
* :func:`gru_stack_sequence_q8_kernel` / :func:`gru_stack_decode_q8_kernel`
  — their q8 twins: int8 weight rows u_q (L,3H,H) with u_eff (L,3H),
  wd_q (L-1,3H,H) with wd_eff (L-1,3H) ((1,3H,1) and (1,3H) for L=1,
  unused), b (L,3H); states and x_proj stay float32; the prefill launches
  :func:`stack_seq_q8_plan`'s route (row 2's wavefront on int8 rows where
  H <= 32 and L <= 4), the decode :func:`decode_q8_plan`'s (one warp per
  batch row where H <= 32 and L <= 3), each kept as ``last_plan``;
* :func:`gru_sequence_q8_kernel` — the depth-1 q8 sequence of one chain
  layer: h0 (B,H), x_proj (T,B,3H), u_q (3H,H) int8, u_eff (3H,), b (3H,),
  optional mask (T,B) -> (T,B,H); it launches :func:`seq_q8_plan`'s route
  (one warp per batch row where H <= 32) and keeps it as ``last_plan``.
* the seven shard kernels (``repro_torch/csrc/gru_shard.cu``), one
  rank's compute between two collectives of the row-wise/cascade split
  (``repro_torch.core.rowparallel``), fp32, B rows, H the full width, Hl
  = H / ranks: :func:`gru_rowwise_shard_step` (v3), :func:`gru_rowwise_
  shard_zr` and :func:`gru_rowwise_shard_candidate` (v1, around the
  gather of r*h), :func:`gru_shard_matvec` (the cascade's partial
  product), :func:`gru_cascade_shard_gates` (v3), :func:`gru_cascade_
  shard_zr` and :func:`gru_cascade_shard_update` (v1). Their gate-slice
  operands may be row-strided views (unit-stride columns). The three
  row-wise kernels, the matvec and the cascade's middle phase launch the
  route :func:`shard_plan` picks by kernel and shape (the direct route
  where the contraction is short, else the column tile) and keep it as
  ``last_plan``.

Every wrapper checks device, dtype (float32; int8 weight rows for q8),
shapes and contiguity and raises on anything the kernel does not take
(:mod:`repro_torch.kernels._launch`). For CPU tensors it returns the plain
PyTorch version (``ref.py``); for CUDA tensors it allocates the outputs
with ``torch.empty``, launches the kernel on the current stream, raises if
the launch was refused, and adds one to its ``launches`` counter. Nothing
falls back from the card to the plain version.

Launch counters come in tuples: :data:`KERNELS` (the three fp32
kernels), :data:`Q8_KERNELS` (the fused q8 pair) and
:data:`CHAIN_Q8_KERNELS` (the q8 chain's pair: :func:`gru_sequence_q8_kernel`
and ``repro_torch.kernels.gru_cell.kernel.gru_step_q8``);
:func:`reset_launch_counts` zeroes all three, the sLSTM's
``SLSTM_KERNELS`` (``repro_torch.kernels.slstm_cell.kernel``), the dense
LM's attention kernels, :data:`ATTN_KERNELS` (``flash_attention`` and
``flash_decode`` of ``repro_torch.kernels.flash_attn`` and
``repro_torch.kernels.decode_attn``), and the paper's row-wise primitives,
:data:`ROWWISE_KERNELS` (``gru_step_fused`` and ``gru_step_blocked`` of
``repro_torch.kernels.gru_cell.kernel``, ``rowwise_matmul`` and
``cascade_matmul`` of ``repro_torch.kernels.rowwise_matvec.kernel``),
and the shard kernels, :data:`SHARD_KERNELS`.

A block of the fused kernels' block routes (and of the depth-1 kernel's)
takes a tile of :data:`DEFAULT_BATCH_BLOCK` batch rows (a nonzero
``batch_block`` of the decode kernels, as in the JAX signature, or of
the fp32 stack sequence sets it and selects the block route); the grid
is
``ceil(B / tile)`` blocks. U, the deep layers' W, b and the per-layer h of
one tile must fit the 227 KB of shared memory a Hopper block may use.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels._launch import (DEFAULT_BATCH_BLOCK,  # noqa: F401
                                         SMEM_LIMIT, I, P)
from repro_torch.kernels._launch import check as _check
from repro_torch.kernels._launch import ptr as _ptr
from repro_torch.kernels._launch import raise_on as _raise_on
from repro_torch.kernels._launch import stream as _stream
from repro_torch.kernels.gru_cell.kernel import (STEP_KERNELS, gru_step_q8,
                                                q8_words)
from repro_torch.kernels.gru_cell.ref import check_q8_width
from repro_torch.kernels.gru_sequence import ref
from repro_torch.kernels.decode_attn.kernel import flash_decode
from repro_torch.kernels.flash_attn.kernel import flash_attention
from repro_torch.kernels.rowwise_matvec.kernel import MATVEC_KERNELS
from repro_torch.kernels.slstm_cell.kernel import SLSTM_KERNELS

_SIGNATURES = {        # launcher -> (library, argtypes)
    # h0, xp, u, b, mask, out, T, B, H, v3, bt, stream
    "gru_sequence_launch": ("gru_sequence", [P] * 6 + [I] * 5 + [P]),
    # h0, xp, u, b, mask, out, T, B, H, v3, rows, warps, depth, stream
    "gru_sequence_warp_launch": ("gru_sequence", [P] * 6 + [I] * 7 + [P]),
    # h0, xp, u, wd, b, mask, out, finals, T, B, H, L, v3, bt, stream
    "gru_stack_sequence_launch": ("gru_sequence", [P] * 8 + [I] * 6 + [P]),
    # h0, xp, u, wd, b, mask, out, finals, T, B, H, L, v3, stream
    "gru_stack_sequence_warp_launch": ("gru_sequence",
                                       [P] * 8 + [I] * 5 + [P]),
    # h, xp, u, wd, b, out, B, H, L, v3, bt, stream
    "gru_stack_decode_launch": ("gru_sequence", [P] * 6 + [I] * 5 + [P]),
    # h, xp, u, wd, b, out, B, H, L, v3, warps, stream
    "gru_stack_decode_warp_launch": ("gru_sequence", [P] * 6 + [I] * 5 + [P]),
    # h0, xp, u_q, u_eff, wd_q, wd_eff, b, mask, out, finals,
    # T, B, H, L, v3, bt, stream
    "gru_stack_sequence_q8_launch": ("gru_sequence_q8",
                                     [P] * 10 + [I] * 6 + [P]),
    # h, xp, u_q, u_eff, wd_q, wd_eff, b, out, B, H, L, v3, bt, stream
    "gru_stack_decode_q8_launch": ("gru_sequence_q8",
                                   [P] * 8 + [I] * 5 + [P]),
    # h, xp, u_q, u_eff, wd_q, wd_eff, b, out, B, H, L, v3, warps, vec,
    # stream
    "gru_stack_decode_q8_warp_launch": ("gru_sequence_q8",
                                        [P] * 8 + [I] * 6 + [P]),
    # h0, xp, u_q, u_eff, wd_q, wd_eff, b, mask, out, finals,
    # T, B, H, L, v3, vec, stream
    "gru_stack_sequence_q8_warp_launch": ("gru_sequence_q8",
                                          [P] * 10 + [I] * 6 + [P]),
    # h0, xp, u_q, u_eff, b, mask, out, T, B, H, v3, bt, stream
    "gru_sequence_q8_launch": ("gru_sequence_q8", [P] * 7 + [I] * 5 + [P]),
    # h0, xp, u_q, u_eff, b, mask, out, T, B, H, v3, warps, vec, stream
    "gru_sequence_q8_warp_launch": ("gru_sequence_q8",
                                    [P] * 7 + [I] * 6 + [P]),
}


def _launcher(name: str):
    library, argtypes = _SIGNATURES[name]
    return _launch.launcher(library, name, argtypes)


def smem_bytes(L: int, H: int, bt: int) -> int:
    """Dynamic shared memory of one block (mirrors ``smem_bytes`` in the
    CUDA source): U, deep W, b, per-layer h, two gate buffers, r*h and the
    double-buffered step mask."""
    H3 = 3 * H
    floats = (L * H * H3 + (L - 1) * H * H3 + L * H3 + L * bt * H
              + 2 * bt * H3 + bt * H + 2 * bt)
    return 4 * floats


def smem_bytes_q8(L: int, H: int, bt: int) -> int:
    """Dynamic shared memory of one q8 block (mirrors ``smem_bytes_q8`` in
    the CUDA source): int8 U and deep W rows padded to an odd number of
    4-byte words, their scales, b, per-layer h, the v1 z gate, the deep
    input projection, two quantized activation rows and the step mask."""
    H3 = 3 * H
    nw = (H + 3) // 4
    ld = nw | 1
    words = ((2 * L - 1) * H3 * ld + (3 * L - 1) * H3 + L * bt * H + bt * H
             + bt * H3 + 2 * bt * nw + 2 * bt)
    return 4 * words


def _w_deep_shape(L: int, H: int) -> tuple:
    """(L-1,H,3H); a depth-1 stack passes the unused (1,1,3H) placeholder."""
    return (L - 1, H, 3 * H) if L > 1 else (1, 1, 3 * H)


# The warp route's knobs, read off tools/seq_tiles.py on an H100 (PERF.md's
# findings): one row a warp (two rows a lane took 1.2-1.75x as
# long: one warp's issue slots run both rows' shuffles and fmas); 1-4
# warps a block within 1 % of each other, 8 slower by 15-20 %; xp and the
# mask 4 steps ahead, 4-10 % faster than 1-2 ahead at T >= 16, the same
# at T=1. The block route past WARP_MAX_H.
WARP_MAX_H = 32              # one output column a lane (kWarpMaxH)
WARP_ROW_CHOICES = (1, 2)    # rows a warp the C entry takes
WARP_DEPTHS = (1, 2, 4, 8)   # prefetch depths the C entry takes
WARP_ROWS = 1
WARP_WARPS = 2
WARP_DEPTH = 4


@dataclasses.dataclass(frozen=True)
class SeqPlan:
    """One launch of :func:`gru_sequence_kernel`: ``route`` "warp" (one warp
    per ``rows`` batch rows, ``warps`` warps a block, xp and the mask
    ``depth`` steps ahead) or "block" (``rows`` the batch tile of a block of
    :data:`THREADS` threads, ``depth`` 0). ``grid`` blocks, ``threads`` per
    block, ``smem`` dynamic bytes."""
    route: str
    rows: int
    warps: int
    depth: int
    grid: int
    threads: int
    smem: int


def warp_plan(B: int, rows: int, warps: int, depth: int) -> SeqPlan:
    """The warp-route launch at explicit knobs."""
    nwarps = -(-B // rows)
    return SeqPlan("warp", rows, warps, depth, -(-nwarps // warps), 32 * warps,
                   0)


def block_plan(B: int, H: int, bt: int, q8: bool = False) -> SeqPlan:
    """The block-route launch (``run_stack``; q8: ``gru_sequence_q8_k``) at
    batch tile ``bt``."""
    smem = smem_bytes_seq_q8(H, bt) if q8 else smem_bytes(1, H, bt)
    return SeqPlan("block", bt, _launch.THREADS // 32, 0, -(-B // bt),
                   _launch.THREADS, smem)


@functools.lru_cache(maxsize=512)
def seq_plan(B: int, T: int, H: int, variant: str) -> SeqPlan:
    """The launch of the depth-1 sequence kernel: the warp route where H <=
    :data:`WARP_MAX_H` (:data:`WARP_ROWS` rows a warp, at most
    :data:`WARP_WARPS` warps a block, no more than the rows need; xp
    :data:`WARP_DEPTH` steps ahead), else the block route at
    :func:`_launch.batch_tile`'s tile (which raises where one block's
    shared memory does not fit)."""
    _launch.check_problem(variant, B, T, H, 1)
    if H > WARP_MAX_H:
        return block_plan(B, H, _launch.batch_tile(
            variant, B, T, H, 1, 0, None, smem_bytes))
    nwarps = -(-B // WARP_ROWS)
    return warp_plan(B, WARP_ROWS, min(WARP_WARPS, _pow2(nwarps)),
                     WARP_DEPTH)


@_launch.forward_only
def gru_sequence_kernel(h0: torch.Tensor, x_proj: torch.Tensor,
                        u: torch.Tensor, b: torch.Tensor,
                        mask: Optional[torch.Tensor] = None, *,
                        variant: str = "v1") -> torch.Tensor:
    """Depth-1 GRU over T steps -> all hidden states (T,B,H). Launches
    :func:`seq_plan`'s route and keeps the plan as ``last_plan``."""
    if x_proj.dim() != 3:
        raise ValueError(f"x_proj: expected (T,B,3H), got {tuple(x_proj.shape)}")
    T, B, H3 = x_proj.shape
    H = H3 // 3
    dev = x_proj.device
    _launch.check_device(dev)
    p = seq_plan(B, T, H, variant)
    _check("h0", h0, (B, H), dev)
    _check("x_proj", x_proj, (T, B, 3 * H), dev)
    _check("u", u, (H, 3 * H), dev)
    _check("b", b, (3 * H,), dev)
    if mask is not None:
        _check("mask", mask, (T, B), dev)
    if dev.type == "cpu":
        return ref.gru_sequence_ref(h0, x_proj, u, b, mask, variant)
    out = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    head = (_ptr(h0), _ptr(x_proj), _ptr(u), _ptr(b), _ptr(mask), _ptr(out),
            T, B, H, int(variant == "v3"))
    if p.route == "warp":
        err = _launcher("gru_sequence_warp_launch")(
            *head, p.rows, p.warps, p.depth, _stream(dev))
    else:
        err = _launcher("gru_sequence_launch")(*head, p.rows, _stream(dev))
    _raise_on(err, "gru_sequence_kernel")
    gru_sequence_kernel.launches += 1
    gru_sequence_kernel.last_plan = p
    return out


# The fused prefill's warp route (row 2): a block a batch row, on a
# wavefront skewed by layer: a gate warp per layer with its U in registers
# and a projection warp between two layers with its W in registers, layer
# l+1 one step behind layer l, each hand-over through shared memory within
# one block barrier a tick. At most STACK_WARP_MAX_L layers
# (kSeqMaxLayers: the deepest swept on the card and held there against
# the block route), only where H <= WARP_MAX_H.
STACK_WARP_MAX_L = 4


@dataclasses.dataclass(frozen=True)
class StackSeqPlan:
    """One launch of :func:`gru_stack_sequence_kernel`: ``route`` "warp"
    (one batch row a block, 2L - 1 warps; its shared memory static) or
    "block" (``run_stack``: ``rows`` the batch tile of a block of
    :data:`THREADS` threads). ``rows`` batch rows a block, ``warps`` a
    block, ``grid`` blocks, ``threads`` per block, ``smem`` dynamic
    bytes."""
    route: str
    rows: int
    warps: int
    grid: int
    threads: int
    smem: int


def stack_warps(L: int) -> int:
    """Warps of a warp-route block (its wavefront's positions): L gate
    warps and L - 1 projection warps."""
    return 2 * L - 1


def stack_seq_warp_plan(B: int, L: int) -> StackSeqPlan:
    """The warp-route launch: B blocks of :func:`stack_warps` warps."""
    return StackSeqPlan("warp", 1, stack_warps(L), B, 32 * stack_warps(L),
                        0)


def stack_seq_block_plan(B: int, H: int, L: int, bt: int,
                         q8: bool = False) -> StackSeqPlan:
    """The block-route launch (``run_stack``; q8: ``run_stack_q8``) at batch
    tile ``bt``."""
    smem = smem_bytes_q8 if q8 else smem_bytes
    return StackSeqPlan("block", bt, _launch.THREADS // 32, -(-B // bt),
                        _launch.THREADS, smem(L, H, bt))


@functools.lru_cache(maxsize=512)
def stack_seq_plan(B: int, T: int, H: int, L: int, variant: str,
                   batch_block: int = 0) -> StackSeqPlan:
    """The launch of :func:`gru_stack_sequence_kernel`: the warp route
    where H <= :data:`WARP_MAX_H` and L <= :data:`STACK_WARP_MAX_L`, else,
    or where ``batch_block`` is nonzero, the block route at
    :func:`_launch.batch_tile`'s tile (which raises where one block's
    shared memory does not fit)."""
    _launch.check_problem(variant, B, T, H, L)
    if batch_block or H > WARP_MAX_H or L > STACK_WARP_MAX_L:
        return stack_seq_block_plan(B, H, L, _launch.batch_tile(
            variant, B, T, H, L, batch_block, None, smem_bytes))
    return stack_seq_warp_plan(B, L)


@_launch.forward_only
def gru_stack_sequence_kernel(h0: torch.Tensor, x_proj: torch.Tensor,
                              u: torch.Tensor, w_deep: torch.Tensor,
                              b: torch.Tensor,
                              mask: Optional[torch.Tensor] = None, *,
                              variant: str = "v1", batch_block: int = 0):
    """Fused depth-L GRU over T steps -> ((T,B,H) last layer's states,
    (L,B,H) per-layer finals). Launches :func:`stack_seq_plan`'s route and
    keeps the plan as ``last_plan``; a nonzero ``batch_block`` names the
    block route's tile."""
    if x_proj.dim() != 3 or h0.dim() != 3:
        raise ValueError("x_proj (T,B,3H) and h0 (L,B,H) expected, got "
                         f"{tuple(x_proj.shape)} and {tuple(h0.shape)}")
    T, B, H3 = x_proj.shape
    H = H3 // 3
    L = h0.shape[0]
    dev = x_proj.device
    _launch.check_device(dev)
    p = stack_seq_plan(B, T, H, L, variant, batch_block)
    _check("h0", h0, (L, B, H), dev)
    _check("x_proj", x_proj, (T, B, 3 * H), dev)
    _check("u", u, (L, H, 3 * H), dev)
    _check("w_deep", w_deep, _w_deep_shape(L, H), dev)
    _check("b", b, (L, 3 * H), dev)
    if mask is not None:
        _check("mask", mask, (T, B), dev)
    if dev.type == "cpu":
        return ref.gru_stack_sequence_ref(h0, x_proj, u, w_deep, b, mask,
                                          variant)
    out = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    finals = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    head = (_ptr(h0), _ptr(x_proj), _ptr(u), _ptr(w_deep), _ptr(b),
            _ptr(mask), _ptr(out), _ptr(finals), T, B, H, L,
            int(variant == "v3"))
    if p.route == "warp":
        err = _launcher("gru_stack_sequence_warp_launch")(*head,
                                                          _stream(dev))
    else:
        err = _launcher("gru_stack_sequence_launch")(*head, p.rows,
                                                     _stream(dev))
    _raise_on(err, "gru_stack_sequence_kernel")
    gru_stack_sequence_kernel.launches += 1
    gru_stack_sequence_kernel.last_plan = p
    return out, finals


# The fused decode's warp routes (rows 3 and 5): one warp a batch row,
# lane c owning column c of every gate in every layer, the layers chained
# in registers. fp32 reads each layer's U and the deep W from device memory
# in one burst a pass, for at most DECODE_WARP_MAX_L layers
# (kDecodeMaxLayers: the deepest swept on the card by tools/decode_tiles.py
# and held there against the block route); q8 holds every layer's int8
# rows in registers, so at most DECODE_Q8_WARP_MAX_L layers
# (kQ8DecodeMaxLayers). Both only where H <= WARP_MAX_H, 1 warp a block,
# read off tools/decode_tiles.py on an H100 (PERF.md's findings: 2-4
# within 3 %, 8 slower by 20 % at L=3); the C entries take 1-8 for the
# sweep.
DECODE_WARP_MAX_L = 4
DECODE_Q8_WARP_MAX_L = 3
DECODE_WARPS = 1
DECODE_Q8_WARPS = 1


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """One launch of a fused decode kernel: ``route`` "warp" (one warp a
    batch row, ``warps`` warps a block) or "block"
    (``run_stack``/``run_stack_q8``: ``rows`` the batch tile of a block of
    :data:`THREADS` threads). ``grid`` blocks, ``threads`` per block,
    ``smem`` dynamic bytes (none on the warp routes)."""
    route: str
    rows: int
    warps: int
    grid: int
    threads: int
    smem: int


def decode_warp_plan(B: int, warps: int) -> DecodePlan:
    """The warp-route launch at ``warps`` warps a block (fp32 and q8 alike;
    no dynamic shared memory)."""
    return DecodePlan("warp", 1, warps, -(-B // warps), 32 * warps, 0)


def decode_block_plan(B: int, H: int, L: int, bt: int,
                      q8: bool = False) -> DecodePlan:
    """The block-route launch at batch tile ``bt``."""
    smem = smem_bytes_q8 if q8 else smem_bytes
    return DecodePlan("block", bt, _launch.THREADS // 32, -(-B // bt),
                      _launch.THREADS, smem(L, H, bt))


def _decode_plan(B, H, L, variant, batch_block, q8):
    smem = smem_bytes_q8 if q8 else smem_bytes
    max_l = DECODE_Q8_WARP_MAX_L if q8 else DECODE_WARP_MAX_L
    _launch.check_problem(variant, B, 1, H, L)
    if batch_block or H > WARP_MAX_H or L > max_l:
        return decode_block_plan(B, H, L, _launch.batch_tile(
            variant, B, 1, H, L, batch_block, None, smem), q8)
    warps = DECODE_Q8_WARPS if q8 else DECODE_WARPS
    return decode_warp_plan(B, min(warps, _pow2(B)))


@functools.lru_cache(maxsize=512)
def decode_plan(B: int, H: int, L: int, variant: str,
                batch_block: int = 0) -> DecodePlan:
    """The launch of :func:`gru_stack_decode_kernel`: the warp route where H
    <= :data:`WARP_MAX_H` and L <= :data:`DECODE_WARP_MAX_L` (at most
    :data:`DECODE_WARPS` warps a block, no more than the rows need), else,
    or where ``batch_block`` is nonzero (JAX's block tile), the block route
    at :func:`_launch.batch_tile`'s tile (which raises where one block's
    shared memory does not fit)."""
    return _decode_plan(B, H, L, variant, batch_block, False)


@functools.lru_cache(maxsize=512)
def decode_q8_plan(B: int, H: int, L: int, variant: str,
                   batch_block: int = 0) -> DecodePlan:
    """The launch of :func:`gru_stack_decode_q8_kernel`: the warp route
    where H <= :data:`WARP_MAX_H` and L <= :data:`DECODE_Q8_WARP_MAX_L`
    (the layers a lane holds in registers; at most
    :data:`DECODE_Q8_WARPS` warps a block), else, or where ``batch_block``
    is nonzero, the block route at :func:`_launch.batch_tile`'s tile."""
    return _decode_plan(B, H, L, variant, batch_block, True)


def decode_q8_words(H: int, u_q: torch.Tensor, wd_q: torch.Tensor) -> int:
    """Whether the q8 warp route loads the int8 rows as 4-byte words."""
    return int(H % 4 == 0 and u_q.data_ptr() % 4 == 0
               and wd_q.data_ptr() % 4 == 0)


@_launch.forward_only
def gru_stack_decode_kernel(h: torch.Tensor, x_proj: torch.Tensor,
                            u: torch.Tensor, w_deep: torch.Tensor,
                            b: torch.Tensor, *, variant: str = "v1",
                            batch_block: int = 0) -> torch.Tensor:
    """One token through all L layers -> new per-layer states (L,B,H).
    Launches :func:`decode_plan`'s route and keeps the plan as
    ``last_plan``; a nonzero ``batch_block`` names the block route's
    tile."""
    if h.dim() != 3 or x_proj.dim() != 2:
        raise ValueError("h (L,B,H) and x_proj (B,3H) expected, got "
                         f"{tuple(h.shape)} and {tuple(x_proj.shape)}")
    L, B, H = h.shape
    dev = h.device
    _launch.check_device(dev)
    p = decode_plan(B, H, L, variant, batch_block)
    _check("h", h, (L, B, H), dev)
    _check("x_proj", x_proj, (B, 3 * H), dev)
    _check("u", u, (L, H, 3 * H), dev)
    _check("w_deep", w_deep, _w_deep_shape(L, H), dev)
    _check("b", b, (L, 3 * H), dev)
    if dev.type == "cpu":
        return ref.gru_stack_decode_ref(h, x_proj, u, w_deep, b, variant)
    out = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    head = (_ptr(h), _ptr(x_proj), _ptr(u), _ptr(w_deep), _ptr(b), _ptr(out),
            B, H, L, int(variant == "v3"))
    if p.route == "warp":
        err = _launcher("gru_stack_decode_warp_launch")(
            *head, p.warps, _stream(dev))
    else:
        err = _launcher("gru_stack_decode_launch")(*head, p.rows,
                                                   _stream(dev))
    _raise_on(err, "gru_stack_decode_kernel")
    gru_stack_decode_kernel.launches += 1
    gru_stack_decode_kernel.last_plan = p
    return out


def _q8_common(variant: str, B: int, T: int, H: int, L: int,
               batch_block: int, dev: torch.device, u_q, u_eff, wd_q, wd_eff,
               b) -> int:
    """Checks shared by the q8 wrappers; returns the batch tile."""
    check_q8_width(H, dev)
    bt = _launch.batch_tile(variant, B, T, H, L, batch_block, dev,
                            smem_bytes_q8)
    _check("u_q", u_q, (L, 3 * H, H), dev, torch.int8)
    _check("u_eff", u_eff, (L, 3 * H), dev)
    _check("wd_q", wd_q, (L - 1, 3 * H, H) if L > 1 else (1, 3 * H, 1), dev,
           torch.int8)
    _check("wd_eff", wd_eff, (max(L - 1, 1), 3 * H), dev)
    _check("b", b, (L, 3 * H), dev)
    return bt


# The q8 prefills' warp routes (rows 6 and 4): row 1's and row 2's
# schedules on int8 rows held in registers as words (row 7's q8 step), only
# where H <= WARP_MAX_H. The depth-1 sequence takes one warp a batch row,
# SEQ_Q8_WARPS warps a block, and loads xp one step ahead (SEQ_Q8_DEPTH,
# fixed in the kernel); read off tools/seq_q8_tiles.py on an H100
# (PERF.md's findings): 1, 2 and 4 warps a block within 2 % of each other,
# 8 slower by 10 %; xp 2, 4 or 8 steps ahead slower than 1. The
# fused prefill takes a block a batch row on the layer-skewed wavefront,
# for at most STACK_Q8_WARP_MAX_L layers (kQ8SeqMaxLayers: the deepest
# swept on the card, as row 2's).
SEQ_Q8_WARPS = 2
SEQ_Q8_DEPTH = 1
STACK_Q8_WARP_MAX_L = 4


@functools.lru_cache(maxsize=512)
def stack_seq_q8_plan(B: int, T: int, H: int, L: int,
                      variant: str) -> StackSeqPlan:
    """The launch of :func:`gru_stack_sequence_q8_kernel`: the warp route
    where H <= :data:`WARP_MAX_H` and L <= :data:`STACK_Q8_WARP_MAX_L`,
    else the block route at :func:`_launch.batch_tile`'s tile (which raises
    where one block's shared memory does not fit)."""
    _launch.check_problem(variant, B, T, H, L)
    if H > WARP_MAX_H or L > STACK_Q8_WARP_MAX_L:
        return stack_seq_block_plan(B, H, L, _launch.batch_tile(
            variant, B, T, H, L, 0, None, smem_bytes_q8), q8=True)
    return stack_seq_warp_plan(B, L)


@_launch.forward_only
def gru_stack_sequence_q8_kernel(h0: torch.Tensor, x_proj: torch.Tensor,
                                 u_q: torch.Tensor, u_eff: torch.Tensor,
                                 wd_q: torch.Tensor, wd_eff: torch.Tensor,
                                 b: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None, *,
                                 variant: str = "v1"):
    """Fused q8 depth-L GRU over T steps (any L, including 1) -> ((T,B,H)
    last layer's states, (L,B,H) per-layer finals). Launches
    :func:`stack_seq_q8_plan`'s route and keeps the plan as
    ``last_plan``."""
    if x_proj.dim() != 3 or h0.dim() != 3:
        raise ValueError("x_proj (T,B,3H) and h0 (L,B,H) expected, got "
                         f"{tuple(x_proj.shape)} and {tuple(h0.shape)}")
    T, B, H3 = x_proj.shape
    H = H3 // 3
    L = h0.shape[0]
    dev = x_proj.device
    _q8_common(variant, B, T, H, L, 0, dev, u_q, u_eff, wd_q, wd_eff, b)
    p = stack_seq_q8_plan(B, T, H, L, variant)
    _check("h0", h0, (L, B, H), dev)
    _check("x_proj", x_proj, (T, B, 3 * H), dev)
    if mask is not None:
        _check("mask", mask, (T, B), dev)
    if dev.type == "cpu":
        return ref.gru_stack_sequence_q8_ref(h0, x_proj, u_q, u_eff, wd_q,
                                             wd_eff, b, mask, variant)
    out = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    finals = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    head = (_ptr(h0), _ptr(x_proj), _ptr(u_q), _ptr(u_eff), _ptr(wd_q),
            _ptr(wd_eff), _ptr(b), _ptr(mask), _ptr(out), _ptr(finals), T, B,
            H, L, int(variant == "v3"))
    if p.route == "warp":
        err = _launcher("gru_stack_sequence_q8_warp_launch")(
            *head, decode_q8_words(H, u_q, wd_q), _stream(dev))
    else:
        err = _launcher("gru_stack_sequence_q8_launch")(*head, p.rows,
                                                        _stream(dev))
    _raise_on(err, "gru_stack_sequence_q8_kernel")
    gru_stack_sequence_q8_kernel.launches += 1
    gru_stack_sequence_q8_kernel.last_plan = p
    return out, finals


@_launch.forward_only
def gru_stack_decode_q8_kernel(h: torch.Tensor, x_proj: torch.Tensor,
                               u_q: torch.Tensor, u_eff: torch.Tensor,
                               wd_q: torch.Tensor, wd_eff: torch.Tensor,
                               b: torch.Tensor, *, variant: str = "v1",
                               batch_block: int = 0) -> torch.Tensor:
    """One token through all L layers on int8 weight rows -> new per-layer
    states (L,B,H) float32. Launches :func:`decode_q8_plan`'s route and
    keeps the plan as ``last_plan``; a nonzero ``batch_block`` names the
    block route's tile."""
    if h.dim() != 3 or x_proj.dim() != 2:
        raise ValueError("h (L,B,H) and x_proj (B,3H) expected, got "
                         f"{tuple(h.shape)} and {tuple(x_proj.shape)}")
    L, B, H = h.shape
    dev = h.device
    _q8_common(variant, B, 1, H, L, batch_block, dev, u_q, u_eff, wd_q,
               wd_eff, b)
    p = decode_q8_plan(B, H, L, variant, batch_block)
    _check("h", h, (L, B, H), dev)
    _check("x_proj", x_proj, (B, 3 * H), dev)
    if dev.type == "cpu":
        return ref.gru_stack_decode_q8_ref(h, x_proj, u_q, u_eff, wd_q,
                                           wd_eff, b, variant)
    out = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    head = (_ptr(h), _ptr(x_proj), _ptr(u_q), _ptr(u_eff), _ptr(wd_q),
            _ptr(wd_eff), _ptr(b), _ptr(out), B, H, L, int(variant == "v3"))
    if p.route == "warp":
        err = _launcher("gru_stack_decode_q8_warp_launch")(
            *head, p.warps, decode_q8_words(H, u_q, wd_q), _stream(dev))
    else:
        err = _launcher("gru_stack_decode_q8_launch")(*head, p.rows,
                                                      _stream(dev))
    _raise_on(err, "gru_stack_decode_q8_kernel")
    gru_stack_decode_q8_kernel.launches += 1
    gru_stack_decode_q8_kernel.last_plan = p
    return out


def smem_bytes_seq_q8(H: int, bt: int) -> int:
    """Dynamic shared memory of one block of the depth-1 q8 sequence kernel
    (mirrors ``smem_bytes_seq_q8`` in the CUDA source): the layer's int8
    rows padded to an odd number of words, scales, b, h, the v1 z gate, two
    quantized activation rows and the step mask."""
    H3 = 3 * H
    nw = (H + 3) // 4
    return 4 * (H3 * (nw | 1) + 2 * H3 + 2 * bt * H + 2 * bt * nw + 2 * bt)


@functools.lru_cache(maxsize=512)
def seq_q8_plan(B: int, T: int, H: int, variant: str) -> SeqPlan:
    """The launch of :func:`gru_sequence_q8_kernel`: the warp route where H
    <= :data:`WARP_MAX_H` (one row a warp, at most :data:`SEQ_Q8_WARPS`
    warps a block, no more than the rows need; xp :data:`SEQ_Q8_DEPTH`
    step ahead), else the block route at :func:`_launch.batch_tile`'s
    tile (which raises where one block's shared memory does not fit)."""
    _launch.check_problem(variant, B, T, H, 1)
    if H > WARP_MAX_H:
        return block_plan(B, H, _launch.batch_tile(
            variant, B, T, H, 1, 0, None,
            lambda _L, H, bt: smem_bytes_seq_q8(H, bt)), q8=True)
    return warp_plan(B, 1, min(SEQ_Q8_WARPS, _pow2(B)), SEQ_Q8_DEPTH)


@_launch.forward_only
def gru_sequence_q8_kernel(h0: torch.Tensor, x_proj: torch.Tensor,
                           u_q: torch.Tensor, u_eff: torch.Tensor,
                           b: torch.Tensor,
                           mask: Optional[torch.Tensor] = None, *,
                           variant: str = "v1") -> torch.Tensor:
    """Depth-1 q8 GRU over T steps on one layer's int8 weight rows -> all
    hidden states (T,B,H) float32. Launches :func:`seq_q8_plan`'s route and
    keeps the plan as ``last_plan``."""
    if x_proj.dim() != 3:
        raise ValueError(f"x_proj: expected (T,B,3H), got {tuple(x_proj.shape)}")
    T, B, H3 = x_proj.shape
    H = H3 // 3
    dev = x_proj.device
    _launch.check_device(dev)
    check_q8_width(H, dev)
    p = seq_q8_plan(B, T, H, variant)
    _check("h0", h0, (B, H), dev)
    _check("x_proj", x_proj, (T, B, 3 * H), dev)
    _check("u_q", u_q, (3 * H, H), dev, torch.int8)
    _check("u_eff", u_eff, (3 * H,), dev)
    _check("b", b, (3 * H,), dev)
    if mask is not None:
        _check("mask", mask, (T, B), dev)
    if dev.type == "cpu":
        return ref.gru_sequence_q8_ref(h0, x_proj, u_q, u_eff, b, mask,
                                       variant)
    out = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    head = (_ptr(h0), _ptr(x_proj), _ptr(u_q), _ptr(u_eff), _ptr(b),
            _ptr(mask), _ptr(out), T, B, H, int(variant == "v3"))
    if p.route == "warp":
        err = _launcher("gru_sequence_q8_warp_launch")(
            *head, p.warps, q8_words(H, u_q), _stream(dev))
    else:
        err = _launcher("gru_sequence_q8_launch")(*head, p.rows,
                                                  _stream(dev))
    _raise_on(err, "gru_sequence_q8_kernel")
    gru_sequence_q8_kernel.launches += 1
    gru_sequence_q8_kernel.last_plan = p
    return out


# ---------------------------------------------------------------------------
# shard-shaped step kernels (csrc/gru_shard.cu): the cuda_sharded backend's
# per-shard compute between two collectives
# ---------------------------------------------------------------------------

# mode, x, hl, ldhl, zin, xp, ldxp, u, ldu, b, out0, out1, B, H, Hl, bt, ct,
# vec, stream (the direct route's: ..., Hl, slices, rows, warps, stream)
_ROWWISE_ARGS = [I, P, P, I, P, P, I, P, I, P, P, P] + [I] * 6 + [P]
# x, ldx, w, ldw, out, B, K, N, bt, ct, vec, stream (the direct route's:
# ..., N, slices, rows, warps, stream)
_MATVEC_ARGS = [P, I, P, I, P] + [I] * 6 + [P]
# zr, xp, h, u, ldu, z, p, B, Hl, N, bt, ct, vec, stream (the direct
# route's: ..., N, slices, rows, warps, stream)
_CZR_ARGS = [P] * 4 + [I, P, P] + [I] * 6 + [P]
# in, in, in, out, B, Hl, stream
# z, ht, ldt, xp, ldx, b, h, out, B, Hl, stream
_UPDATE_ARGS = [P, P, I, P, I, P, P, P, I, I, P]
# g, ldg, gsg, xp, ldx, gsx, b, gsb, h, out, B, Hl, stream
_GATES_ARGS = [P, I, I, P, I, I, P, I, P, P, I, I, P]
SHARD_MAX_ROWS = 8           # rows of one block's batch tile


def _shard_launcher(name: str, argtypes):
    return _launch.launcher("gru_shard", name, argtypes)


def smem_bytes_shard(K: int, bt: int, G: int, ct: int) -> int:
    """Dynamic shared memory of one shard matvec block (mirrors
    ``gru_shard_smem_bytes`` in the CUDA source): the (K, bt) operand and
    the warps' sums of G gates at ct columns."""
    return 4 * (K * bt + (_launch.THREADS // 32) * G * bt * ct)


def shard_tiles(B: int, K: int, G: int, ncols: int):
    """(batch tile, column tile) of a shard matvec: the narrowest column
    tile of 4, 8, 16 or 32 that covers ``ncols`` output columns per gate
    (32 beyond), and the smallest power of two >= B rows, at most
    :data:`SHARD_MAX_ROWS`, halved until the block's shared memory fits;
    raises if one row does not fit."""
    ct = next(c for c in (4, 8, 16, 32) if c >= min(ncols, 32))
    bt = min(SHARD_MAX_ROWS, 1 << max(B - 1, 0).bit_length())
    while bt > 1 and smem_bytes_shard(K, bt, G, ct) > SMEM_LIMIT:
        bt //= 2
    need = smem_bytes_shard(K, bt, G, ct)
    if need > SMEM_LIMIT:
        raise ValueError(f"K={K}: a shard matvec needs {need} bytes of "
                         f"shared memory for one row; a Hopper block has "
                         f"{SMEM_LIMIT}")
    return bt, ct


# The rule below was read off tools/shard_tiles.py on an H100 (PERF.md's
# findings): the direct route's fastest launches give each lane about
# SLICE_K of K's k's, at most MAX_SLICES lanes to a column (more leave a
# warp one or two columns, whose loads do not coalesce), a few rows a
# thread and blocks of a few warps, both set per kernel; past the kernel's
# DIRECT_MAX_K the column tile is faster, at a tile whose grid nearly fills
# the SMs once. A kernel is its "kind": "matvec" (gru_shard_matvec, one
# gate, K = Hl), "step" (the v3 row-wise step, three gates), "zr" and
# "candidate" (the v1 pair: two gates, and one gate with the update), the
# last three at K = H and N = Hl; "cascade_zr" (gru_cascade_shard_zr, the
# v1 cascade's middle phase: one gate, K = Hl, N = H, z's Hl columns
# beside it), whose lanes make a sigmoid for each of their k's: it is
# fastest at 2 k's a lane, one row a thread and 4 warps, and on the
# column tile from K = 128.
SLICES = (1, 2, 4, 8, 16, 32)   # lanes that split K (the C entry takes)
DIRECT_ROWS = (1, 2, 4)      # batch rows of a direct-route thread (same)
DIRECT_MAX_WARPS = _launch.THREADS // 32
SLICE_K = 4                  # k's of one lane's slice the rule aims for,
# by kind: the cascade's middle phase forms its operand (a sigmoid each k)
# in the lane, one after another, so it gains from 2 k's a lane
DIRECT_SLICE_K = {"matvec": SLICE_K, "step": SLICE_K, "zr": SLICE_K,
                  "candidate": SLICE_K, "cascade_zr": 2}
MAX_SLICES = 16
KIND_GATES = {"matvec": 1, "step": 3, "zr": 2, "candidate": 1,
              "cascade_zr": 1}
# kind -> the longest K on the direct route
DIRECT_MAX_K = {"matvec": 128, "step": 256, "zr": 256, "candidate": 256,
                "cascade_zr": 64}
# kind -> warps of a direct-route block, and batch rows of its thread (the
# one-gate kernels: more warps of one row; the two- and three-gate ones:
# fewer warps of two rows)
DIRECT_WARPS = {"matvec": 4, "step": 2, "zr": 2, "candidate": 4,
                "cascade_zr": 4}
THREAD_ROWS = {"matvec": 1, "step": 2, "zr": 2, "candidate": 1,
               "cascade_zr": 1}
WIDE_N = 512                 # a matvec this wide takes 4 rows a thread
TILE_COLUMNS = (16, 8)       # the tile route's column tiles, widest first
SHARD_SMS = 132              # an H100's SMs: one wave of the tile's grid


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One launch of a redesigned shard kernel (:func:`gru_shard_matvec`,
    the three row-wise ones and :func:`gru_cascade_shard_zr`): ``route``
    "direct" or "tile". Direct:
    ``slices`` lanes split K, each thread owns one column of ``rows``
    batch rows, ``warps`` warps a block. Tile: ``rows`` is the batch tile,
    ``ct`` the column tile, 8 warps a block, ``vec`` whether u loads as
    16-byte vectors. ``grid`` (x, y), ``threads`` per block, ``smem``
    dynamic bytes."""
    route: str
    slices: int
    rows: int
    warps: int
    ct: int
    vec: int
    grid: tuple
    threads: int
    smem: int


def _pow2(n: int) -> int:
    """The smallest power of two >= n (>= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def direct_slices(K: int, slice_k: int = SLICE_K) -> int:
    """Lanes that split a contraction of K on the direct route: the fewest
    (a power of two) that leave each about ``slice_k`` k's, at most
    :data:`MAX_SLICES`."""
    return min(MAX_SLICES, _pow2(-(-K // slice_k)))


def direct_plan(B: int, N: int, slices: int, rows: int,
                warps: int) -> ShardPlan:
    """The direct-route launch at explicit knobs (``N`` columns a gate)."""
    cols = warps * (32 // slices)
    return ShardPlan("direct", slices, rows, warps, 0, 0,
                     (-(-N // cols), -(-B // rows)), 32 * warps, 0)


def tile_plan(B: int, K: int, G: int, N: int, vec: int, bt: int,
              ct: int) -> ShardPlan:
    """The column-tile launch at explicit knobs."""
    return ShardPlan("tile", 0, bt, _launch.THREADS // 32, ct, vec,
                     (-(-N // ct), -(-B // bt)), _launch.THREADS,
                     smem_bytes_shard(K, bt, G, ct))


def shard_kind(G: int, kind: str = None) -> str:
    """``kind``, or the kind G gates name when it is None: "matvec" (1),
    "zr" (2), "step" (3); the candidate is one gate too, so it is named."""
    kind = kind or {1: "matvec", 2: "zr", 3: "step"}[G]
    if KIND_GATES[kind] != G:
        raise ValueError(f"a {kind} shard kernel has {KIND_GATES[kind]} "
                         f"gates, not {G}")
    return kind


@functools.lru_cache(maxsize=512)
def shard_plan(B: int, K: int, G: int, N: int, vec: int,
               kind: str = None) -> ShardPlan:
    """The launch of a shard matvec of B rows, a contraction of K and G
    gates of N columns each, for kernel ``kind`` (:func:`shard_kind`: the
    matvec G = 1; the row-wise "step" G = 3, "zr" G = 2 and "candidate" G
    = 1, each at N = Hl; "cascade_zr" G = 1, K = Hl, whose direct grid
    covers max(N, K) columns, since its lanes of columns j < K store z);
    ``vec``: u loads as aligned 16-byte vectors (the
    tile route only). The direct route where K <= :data:`DIRECT_MAX_K`
    [kind], with :func:`direct_slices` at :data:`DIRECT_SLICE_K` [kind]
    k's a lane, :data:`THREAD_ROWS` [kind] rows a
    thread (four for a matvec of at least :data:`WIDE_N` columns) and
    :data:`DIRECT_WARPS` [kind] warps a block. Else the column tile: of
    :data:`TILE_COLUMNS` and batch tiles 1-8, the largest grid within
    :data:`SHARD_SMS` blocks whose shared memory fits (the fewest blocks
    if none is that small); :func:`shard_tiles`'s tile, which raises where
    one row does not fit a block, if neither column tile fits."""
    kind = shard_kind(G, kind)
    if K <= DIRECT_MAX_K[kind]:
        slices = direct_slices(K, DIRECT_SLICE_K[kind])
        rows = 4 if kind == "matvec" and N >= WIDE_N else THREAD_ROWS[kind]
        ncols = max(N, K) if kind == "cascade_zr" else N
        col_warps = -(-ncols // (32 // slices))
        return direct_plan(B, ncols, slices, min(rows, _pow2(B)),
                           min(DIRECT_WARPS[kind], _pow2(col_warps)))
    fits = [tile_plan(B, K, G, N, vec, bt, ct) for ct in TILE_COLUMNS
            for bt in (1, 2, 4, SHARD_MAX_ROWS)
            if bt <= _pow2(B) and smem_bytes_shard(K, bt, G, ct)
            <= SMEM_LIMIT]
    if not fits:
        return tile_plan(B, K, G, N, vec, *shard_tiles(B, K, G, N))
    blocks = [p.grid[0] * p.grid[1] for p in fits]
    one_wave = [b for b in blocks if b <= SHARD_SMS]
    return fits[blocks.index(max(one_wave) if one_wave else min(blocks))]


def _rows(name: str, t, shape: tuple, dev: torch.device) -> int:
    """Check a float32 2-D operand whose rows may be strided (a gate slice)
    but whose columns are unit-stride and whose rows do not overlap;
    returns its row stride."""
    if not isinstance(t, torch.Tensor) or t.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D tensor {shape}, got "
                         f"{getattr(t, 'shape', type(t))}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes "
                        f"torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: columns must be unit-stride")
    if shape[0] == 1:
        return shape[1]
    if t.stride(0) < shape[1]:
        raise ValueError(f"{name}: row stride {t.stride(0)} is less than "
                         f"the row width {shape[1]} (an expanded or "
                         f"overlapping view)")
    return t.stride(0)


def _vector(t: torch.Tensor, ld: int, gate_cols: int) -> int:
    """Whether four neighbouring columns of every gate of ``t`` load as one
    aligned 16-byte vector."""
    return int(ld % 4 == 0 and gate_cols % 4 == 0 and t.data_ptr() % 16 == 0)


def _shard_dims(h_full, h_local):
    if (not isinstance(h_full, torch.Tensor) or h_full.dim() != 2
            or not isinstance(h_local, torch.Tensor) or h_local.dim() != 2):
        raise ValueError("h_full (B,H) and h_local (B,Hl) expected")
    B, H = h_full.shape
    Hl = h_local.shape[1]
    if B < 1 or H < 1 or Hl < 1:
        raise ValueError(f"empty problem: B={B} H={H} Hl={Hl}")
    return B, H, Hl, h_full.device


def _rowwise_checks(x_name: str, x, h_local, z, xp, u, b, G: int) -> tuple:
    """Check a row-wise shard kernel's operands (x the replicated (B,H)
    operand, G gates of Hl local columns); returns (B, H, Hl, device,
    ldhl, ldxp, ldu)."""
    B, H, Hl, dev = _shard_dims(x, h_local)
    _check(x_name, x, (B, H), dev)
    ldhl = _rows("h_local", h_local, (B, Hl), dev)
    ldxp = _rows("xp", xp, (B, G * Hl), dev)
    ldu = _rows("u", u, (H, G * Hl), dev)
    _check("b", b, (G * Hl,), dev)
    if z is not None:
        _check("z_local", z, (B, Hl), dev)
    return B, H, Hl, dev, ldhl, ldxp, ldu


# the row-wise kernels: their C entries' mode and their kind
_ROWWISE_MODES = {"gru_rowwise_shard_step": (0, "step"),
                  "gru_rowwise_shard_zr": (1, "zr"),
                  "gru_rowwise_shard_candidate": (2, "candidate")}


def _rowwise_run(fn, x_name: str, x, h_local, z, xp, u, b):
    """The row-wise shard kernel ``fn`` (one of :data:`_ROWWISE_MODES`) on
    checked operands: its plain version on the CPU; on the card the launch
    :func:`shard_plan` names, kept as ``fn.last_plan``, with ``fn``'s
    counter raised. Returns (out0, out1); out1 (r*h) only for zr."""
    mode, kind = _ROWWISE_MODES[fn.__name__]
    G = KIND_GATES[kind]
    B, H, Hl, dev, ldhl, ldxp, ldu = _rowwise_checks(x_name, x, h_local, z,
                                                     xp, u, b, G)
    vec = _vector(u, ldu, Hl)
    p = shard_plan(B, H, G, Hl, vec, kind)
    if dev.type == "cpu":
        plain = getattr(ref, fn.__name__ + "_ref")
        out = plain(x, h_local, *(() if z is None else (z,)), xp, u, b)
        return out if isinstance(out, tuple) else (out, None)
    out0 = torch.empty((B, Hl), dtype=torch.float32, device=dev)
    out1 = (torch.empty((B, Hl), dtype=torch.float32, device=dev)
            if mode == 1 else None)
    head = (mode, _ptr(x), _ptr(h_local), ldhl, _ptr(z), _ptr(xp), ldxp,
            _ptr(u), ldu, _ptr(b), _ptr(out0), _ptr(out1), B, H, Hl)
    if p.route == "tile":
        err = _shard_launcher("gru_rowwise_shard_launch", _ROWWISE_ARGS)(
            *head, p.rows, p.ct, vec, _stream(dev))
    else:
        err = _shard_launcher("gru_rowwise_shard_direct_launch",
                              _ROWWISE_ARGS)(
            *head, p.slices, p.rows, p.warps, _stream(dev))
    _raise_on(err, fn.__name__)
    fn.launches += 1
    fn.last_plan = p
    return out0, out1


@_launch.forward_only
def gru_rowwise_shard_step(h_full: torch.Tensor, h_local: torch.Tensor,
                           xp: torch.Tensor, u: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """v3 row-wise shard step: h_full (B,H) replicated, h_local (B,Hl) this
    shard's rows, xp (B,3Hl) / u (H,3Hl) / b (3Hl,) this shard's gate-major
    slices -> new local rows (B,Hl). Launches :func:`shard_plan`'s route
    and keeps the plan as ``last_plan``."""
    return _rowwise_run(gru_rowwise_shard_step, "h_full", h_full, h_local,
                        None, xp, u, b)[0]


@_launch.forward_only
def gru_rowwise_shard_zr(h_full: torch.Tensor, h_local: torch.Tensor,
                         xp_zr: torch.Tensor, u_zr: torch.Tensor,
                         b_zr: torch.Tensor):
    """v1 row-wise phase 1: xp_zr (B,2Hl), u_zr (H,2Hl), b_zr (2Hl,) ->
    (z_local (B,Hl), r*h_local (B,Hl)). Launches :func:`shard_plan`'s
    route and keeps the plan as ``last_plan``."""
    return _rowwise_run(gru_rowwise_shard_zr, "h_full", h_full, h_local,
                        None, xp_zr, u_zr, b_zr)


@_launch.forward_only
def gru_rowwise_shard_candidate(rh_full: torch.Tensor, h_local: torch.Tensor,
                                z_local: torch.Tensor, xp_h: torch.Tensor,
                                u_h: torch.Tensor,
                                b_h: torch.Tensor) -> torch.Tensor:
    """v1 row-wise phase 2: the gathered rh_full (B,H), z_local (B,Hl), xp_h
    (B,Hl), u_h (H,Hl), b_h (Hl,) -> new local rows (B,Hl). Launches
    :func:`shard_plan`'s route and keeps the plan as ``last_plan``."""
    return _rowwise_run(gru_rowwise_shard_candidate, "rh_full", rh_full,
                        h_local, z_local, xp_h, u_h, b_h)[0]


@_launch.forward_only
def gru_shard_matvec(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Cascade partial product: x (B,Hl) @ w (Hl,N) -> (B,N) float32."""
    if (not isinstance(x, torch.Tensor) or x.dim() != 2
            or not isinstance(w, torch.Tensor) or w.dim() != 2):
        raise ValueError("x (B,K) and w (K,N) expected")
    B, K = x.shape
    N = w.shape[1]
    dev = x.device
    ldx = _rows("x", x, (B, K), dev)
    ldw = _rows("w", w, (K, N), dev)
    if B < 1 or K < 1 or N < 1:
        raise ValueError(f"empty problem: B={B} K={K} N={N}")
    p = shard_plan(B, K, 1, N, _vector(w, ldw, N), "matvec")
    if dev.type == "cpu":
        return ref.gru_shard_matvec_ref(x, w)
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    if p.route == "tile":
        err = _shard_launcher("gru_shard_matvec_launch", _MATVEC_ARGS)(
            _ptr(x), ldx, _ptr(w), ldw, _ptr(out), B, K, N, p.rows, p.ct,
            p.vec, _stream(dev))
    else:
        err = _shard_launcher("gru_shard_matvec_direct_launch",
                              _MATVEC_ARGS)(
            _ptr(x), ldx, _ptr(w), ldw, _ptr(out), B, K, N, p.slices, p.rows,
            p.warps, _stream(dev))
    _raise_on(err, "gru_shard_matvec")
    gru_shard_matvec.launches += 1
    gru_shard_matvec.last_plan = p
    return out


def _cascade_dims(h_shard):
    if not isinstance(h_shard, torch.Tensor) or h_shard.dim() != 2:
        raise ValueError("h_shard (B,Hl) expected")
    B, Hl = h_shard.shape
    if B < 1 or Hl < 1:
        raise ValueError(f"empty problem: B={B} Hl={Hl}")
    return B, Hl, h_shard.device


def _gate_strides(name: str, t, B: int, G: int, Hl: int,
                  dev: torch.device) -> tuple:
    """Check G gates of Hl float32 columns for each of B rows (B None: one
    row, the bias), given as local slices ((B, G*Hl), or (G*Hl,) for the
    bias; rows may be strided) or as gate views ((B, G, Hl), or (G, Hl):
    gate g of a rank's slice of stacked (B, G*H) gates, ``a.unflatten(-1,
    (G, H))[..., s:s + Hl]``); columns unit-stride, gates apart. Returns
    (row stride, gate stride) in elements."""
    lead = () if B is None else (B,)
    if not isinstance(t, torch.Tensor) or t.dim() not in (len(lead) + 1,
                                                          len(lead) + 2):
        raise ValueError(f"{name}: expected {lead + (G * Hl,)} slices or "
                         f"{lead + (G, Hl)} gate views, got "
                         f"{getattr(t, 'shape', type(t))}")
    if t.dim() == len(lead) + 1:
        if tuple(t.shape) != lead + (G * Hl,):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{lead + (G * Hl,)}")
        t = t.unflatten(-1, (G, Hl))
    if tuple(t.shape) != lead + (G, Hl):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{lead + (G, Hl)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes "
                        f"torch.float32")
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if Hl > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: columns must be unit-stride")
    gs = t.stride(-2)
    ld = t.stride(0) if B is not None and B > 1 else G * gs
    if gs < Hl or ld < (G - 1) * gs + Hl:
        raise ValueError(f"{name}: gate stride {gs}, row stride {ld}: gates "
                         f"or rows overlap (an expanded view)")
    if (B or 1) * ld >= 2 ** 31:
        raise ValueError(f"{name}: {B} rows of stride {ld} exceed the "
                         f"kernel's 32-bit indices")
    return ld, gs


@_launch.forward_only
def gru_cascade_shard_gates(g_local: torch.Tensor, xp_local: torch.Tensor,
                            h_shard: torch.Tensor,
                            b_local: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """v3 cascade epilogue -> new h shard (B,Hl). g_local and xp_local: the
    local (B,3Hl) gate slices, as JAX's kernel takes them, or (B,3,Hl)
    gate views of the psum'd and projected (B,3H) arrays, read in place;
    b_local (optional): (3Hl,) or a (3,Hl) gate view of the full bias,
    added to g first (JAX's ``psum(...) + b``, then ``xp + g``)."""
    B, Hl, dev = _cascade_dims(h_shard)
    ldg, gsg = _gate_strides("g_local", g_local, B, 3, Hl, dev)
    ldx, gsx = _gate_strides("xp_local", xp_local, B, 3, Hl, dev)
    gsb = (0 if b_local is None else
           _gate_strides("b_local", b_local, None, 3, Hl, dev)[1])
    _check("h_shard", h_shard, (B, Hl), dev)
    if dev.type == "cpu":
        return ref.gru_cascade_shard_gates_ref(g_local, xp_local, h_shard,
                                               b_local)
    out = torch.empty((B, Hl), dtype=torch.float32, device=dev)
    err = _shard_launcher("gru_cascade_shard_gates_launch", _GATES_ARGS)(
        _ptr(g_local), ldg, gsg, _ptr(xp_local), ldx, gsx, _ptr(b_local),
        gsb, _ptr(h_shard), _ptr(out), B, Hl, _stream(dev))
    _raise_on(err, "gru_cascade_shard_gates")
    gru_cascade_shard_gates.launches += 1
    return out


@_launch.forward_only
def gru_cascade_shard_zr(zr_local: torch.Tensor, xp_local: torch.Tensor,
                         h_shard: torch.Tensor, u_h_rows: torch.Tensor):
    """v1 cascade middle phase -> (z_local (B,Hl), ht_partial (B,H)):
    u_h_rows (Hl,H) is this shard's rows of the candidate's U (row-strided
    view allowed). Launches :func:`shard_plan`'s route (kind "cascade_zr")
    and keeps the plan as ``last_plan``."""
    B, Hl, dev = _cascade_dims(h_shard)
    _check("zr_local", zr_local, (B, 2 * Hl), dev)
    _check("xp_local", xp_local, (B, 2 * Hl), dev)
    _check("h_shard", h_shard, (B, Hl), dev)
    if not isinstance(u_h_rows, torch.Tensor) or u_h_rows.dim() != 2:
        raise ValueError("u_h_rows (Hl,H) expected")
    N = u_h_rows.shape[1]
    ldu = _rows("u_h_rows", u_h_rows, (Hl, N), dev)
    vec = _vector(u_h_rows, ldu, N)
    p = shard_plan(B, Hl, 1, N, vec, "cascade_zr")
    if dev.type == "cpu":
        return ref.gru_cascade_shard_zr_ref(zr_local, xp_local, h_shard,
                                            u_h_rows)
    z = torch.empty((B, Hl), dtype=torch.float32, device=dev)
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    head = (_ptr(zr_local), _ptr(xp_local), _ptr(h_shard), _ptr(u_h_rows),
            ldu, _ptr(z), _ptr(out), B, Hl, N)
    if p.route == "tile":
        err = _shard_launcher("gru_cascade_shard_zr_launch", _CZR_ARGS)(
            *head, p.rows, p.ct, vec, _stream(dev))
    else:
        err = _shard_launcher("gru_cascade_shard_zr_direct_launch",
                              _CZR_ARGS)(
            *head, p.slices, p.rows, p.warps, _stream(dev))
    _raise_on(err, "gru_cascade_shard_zr")
    gru_cascade_shard_zr.launches += 1
    gru_cascade_shard_zr.last_plan = p
    return z, out


@_launch.forward_only
def gru_cascade_shard_update(z_local: torch.Tensor, ht_in_local: torch.Tensor,
                             h_shard: torch.Tensor,
                             xp_h: Optional[torch.Tensor] = None,
                             b_h: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """v1 cascade epilogue -> new h shard (B,Hl): z_local and h_shard
    (B,Hl) contiguous; ht_in_local (B,Hl), the finished local candidate
    pre-activation (JAX's form), or the rank's column slice of the psum'd
    partial (a row-strided view of the (B,H) psum), with its addends read
    in place where given: xp_h (B,Hl), the rank's columns of xp's
    candidate gate (a view of the (B,3H) projection), and b_h (Hl,), of
    b's; added as JAX adds them, (xp + psum) + b."""
    B, Hl, dev = _cascade_dims(h_shard)
    _check("z_local", z_local, (B, Hl), dev)
    _check("h_shard", h_shard, (B, Hl), dev)
    ldt = _gate_strides("ht_in_local", ht_in_local, B, 1, Hl, dev)[0]
    ldx = (0 if xp_h is None else
           _gate_strides("xp_h", xp_h, B, 1, Hl, dev)[0])
    if b_h is not None:
        _gate_strides("b_h", b_h, None, 1, Hl, dev)
    if dev.type == "cpu":
        return ref.gru_cascade_shard_update_ref(z_local, ht_in_local,
                                                h_shard, xp_h, b_h)
    out = torch.empty((B, Hl), dtype=torch.float32, device=dev)
    err = _shard_launcher("gru_cascade_shard_update_launch", _UPDATE_ARGS)(
        _ptr(z_local), _ptr(ht_in_local), ldt, _ptr(xp_h), ldx, _ptr(b_h),
        _ptr(h_shard), _ptr(out), B, Hl, _stream(dev))
    _raise_on(err, "gru_cascade_shard_update")
    gru_cascade_shard_update.launches += 1
    return out


SHARD_KERNELS = (gru_rowwise_shard_step, gru_rowwise_shard_zr,
                 gru_rowwise_shard_candidate, gru_shard_matvec,
                 gru_cascade_shard_gates, gru_cascade_shard_zr,
                 gru_cascade_shard_update)

KERNELS = (gru_sequence_kernel, gru_stack_sequence_kernel,
           gru_stack_decode_kernel)
Q8_KERNELS = (gru_stack_sequence_q8_kernel, gru_stack_decode_q8_kernel)
CHAIN_Q8_KERNELS = (gru_sequence_q8_kernel, gru_step_q8)
ATTN_KERNELS = (flash_attention, flash_decode)
ROWWISE_KERNELS = STEP_KERNELS + MATVEC_KERNELS


def reset_launch_counts() -> None:
    """Set every wrapper's ``launches`` counter (fp32, fused q8, chain q8,
    the sLSTM's :data:`SLSTM_KERNELS`, the dense LM's :data:`ATTN_KERNELS`,
    :data:`ROWWISE_KERNELS` and the shard kernels, :data:`SHARD_KERNELS`)
    to 0."""
    for fn in (KERNELS + Q8_KERNELS + CHAIN_Q8_KERNELS + SLSTM_KERNELS
               + ATTN_KERNELS + ROWWISE_KERNELS + SHARD_KERNELS):
        fn.launches = 0


reset_launch_counts()
for _fn in (gru_sequence_kernel, gru_stack_sequence_kernel,
            gru_stack_decode_kernel, gru_stack_sequence_q8_kernel,
            gru_stack_decode_q8_kernel, gru_sequence_q8_kernel,
            gru_rowwise_shard_step,
            gru_rowwise_shard_zr, gru_rowwise_shard_candidate,
            gru_shard_matvec, gru_cascade_shard_zr):
    _fn.last_plan = None
del _fn
