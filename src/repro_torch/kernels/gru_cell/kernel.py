"""Wrappers of the single-step kernels (``repro_torch/csrc/gru_cell.cu``
and ``repro_torch/csrc/gru_cell_q8.cu``).

Same names and array interfaces as the Pallas kernels in
``repro.kernels.gru_cell.kernel``:

* :func:`gru_step_fused` — one GRU step, h (B,H) float32, x_proj (B,3H)
  float32, u (H,3H) float32 or bfloat16 (gate columns [z | r | h]), b
  (3H,) float32 -> (B,H) float32; v1 or v3. h and r*h are rounded to u's
  dtype before each product; sums are fp32.
* :func:`gru_step_blocked` — the same step, v1, spread over many thread
  blocks for large H; ``block_n`` is JAX's row block and must divide H
  (``min(block_n, H)``, as there); the CUDA kernels pick their own tiles.
* :func:`gru_step_q8` — one q8 cell update, h (B,H) float32, x_proj (B,3H)
  float32, u_q (3H,H) int8 weight rows, u_eff (3H,) per-row dequant
  scales, b (3H,) -> (B,H) float32; v1 or v3.

Each checks device, dtype, shapes and contiguity and raises on anything
its kernel does not take (:mod:`repro_torch.kernels._launch`). For CPU
tensors it returns the plain PyTorch version (``ref.py``); for CUDA tensors
it allocates the output (and the wide and blocked routes' z and r*h
scratch) with ``torch.empty``, launches on the current stream, raises if
a launch was refused, and adds one to its ``launches`` counter (zeroed by
``repro_torch.kernels.gru_sequence.kernel.reset_launch_counts``).
``gru_step_q8`` belongs to its ``CHAIN_Q8_KERNELS``; the fp32/bf16 pair is
:data:`STEP_KERNELS`. A call counts once whatever its CUDA launches (the
old blocked route and the wide route's dependent-launch pair are two).

:func:`gru_step_fused` and :func:`gru_step_blocked` launch the route
:func:`step_plan` picks and keep it as ``last_plan``: "warp" (one warp a
batch row, lane c owning column c of every gate; the fused step at H <=
:data:`STEP_WARP_MAX_H`, the paper's widths), "wide" (v1: one step spread
over the whole card, ceil(H / cw) blocks streaming their column slices of
U through a ring of shared memory, z and r*h through global scratch and
one grid barrier; v1 past the warp route) or "tile" (the column tile of
``col_tile.cuh`` that both launched before: v3 past the warp route, and
v1 where the wide route's grid does not fit the card). :func:`launch_step`
launches any plan,
so tests and tools can force a route (``tile_step_plan`` is the route
each step took before). The column tile takes at most 8 rows a block (the
smallest power of two that holds B, halved until the block's shared
memory fits) and raises beyond what one block holds.

:func:`gru_step_q8` launches the route :func:`step_q8_plan` picks (one
warp per batch row where H <= :data:`STEP_Q8_WARP_MAX_H`, every served
width; else a block of a batch tile of
:data:`~repro_torch.kernels._launch.DEFAULT_BATCH_BLOCK` rows) and keeps
it as ``last_plan``.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels._launch import I, P, SMEM_LIMIT
from repro_torch.kernels.gru_cell import ref

# h, xp, u_q, u_eff, b, out, B, H, v3, bt, stream (the warp route's: ...,
# v3, warps, vec, stream)
_ARGTYPES = [P] * 6 + [I] * 4 + [P]
_WARP_ARGS = [P] * 6 + [I] * 5 + [P]
# h, xp, u, b, out, B, H, v3, bf16, bt, ct, vec, stream
_FUSED_ARGS = [P] * 5 + [I] * 7 + [P]
# h, xp, u, b, zs, rhs, out, B, H, bf16, bt, ct, vec, stream
_BLOCKED_ARGS = [P] * 7 + [I] * 6 + [P]
# h, xp, u, b, out, B, H, v3, bf16, warps, stream
_WARP_STEP_ARGS = [P] * 5 + [I] * 5 + [P]
# h, xp, u, b, zs, rhs, out, B, H, bf16, bt, cw, kc, stages, vec, blk,
# stream
_WIDE_ARGS = [P] * 7 + [I] * 9 + [P]
WEIGHT_DTYPES = (torch.float32, torch.bfloat16)
MAX_ROWS = 8                 # rows of one block's batch tile (BT)
NARROW_H = 64                # widest state the v3 fused step tiles by 32
WARPS = _launch.THREADS // 32


def column_tile(u_dtype: torch.dtype, wide: bool) -> int:
    """Output columns of one tile: 32 when ``wide`` (one block walks every
    tile, as the v1 fused step does, or the state is narrow: fewer tiles,
    and two butterfly rounds per partial sum instead of four), else one
    32-byte sector of each row of u (8 fp32, 16 bf16 columns), so the grid
    spreads H / tile blocks over the card."""
    if wide:
        return 32
    return 16 if u_dtype == torch.bfloat16 else 8


def smem_bytes_step(kind: str, H: int, bt: int, ct: int) -> int:
    """Dynamic shared memory of one block (mirrors ``gru_cell_smem_bytes``
    in the CUDA source). kind ``v1``/``v3``: the fused step; ``blocked``:
    the larger of the blocked step's two kernels. The (H, bt) operand, the
    warps' partial sums (8 x gates x bt x ct) and, for v1, r*h and z."""
    hb = H * bt
    if kind == "blocked":
        return 4 * (hb + WARPS * 2 * bt * ct)
    if kind == "v3":
        return 4 * (hb + WARPS * 3 * bt * ct)
    return 4 * (3 * hb + WARPS * 2 * bt * ct)


def step_tile(kind: str, B: int, H: int, ct: int) -> int:
    """Rows of one block: the smallest power of two >= B, at most
    :data:`MAX_ROWS`, halved until the block's shared memory fits; raises
    if one row does not fit."""
    bt = min(MAX_ROWS, 1 << max(B - 1, 0).bit_length())
    while bt > 1 and smem_bytes_step(kind, H, bt, ct) > SMEM_LIMIT:
        bt //= 2
    need = smem_bytes_step(kind, H, bt, ct)
    if need > SMEM_LIMIT:
        raise ValueError(f"H={H}: the {kind} step needs {need} bytes of "
                         f"shared memory for one row; a Hopper block has "
                         f"{SMEM_LIMIT}")
    return bt


def _check_step(h, x_proj, u, b):
    """Check the step's operands; returns (B, H, device)."""
    if not isinstance(h, torch.Tensor) or h.dim() != 2:
        raise ValueError(f"h: expected a (B,H) tensor, got "
                         f"{getattr(h, 'shape', type(h))}")
    B, H = h.shape
    if B < 1 or H < 1:
        raise ValueError(f"empty problem: B={B} H={H}")
    dev = h.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if not isinstance(u, torch.Tensor) or u.dtype not in WEIGHT_DTYPES:
        raise TypeError(f"u: dtype {getattr(u, 'dtype', type(u))}; the "
                        f"kernels take {WEIGHT_DTYPES}")
    _launch.check("h", h, (B, H), dev)
    _launch.check("x_proj", x_proj, (B, 3 * H), dev)
    _launch.check("u", u, (H, 3 * H), dev, u.dtype)
    _launch.check("b", b, (3 * H,), dev)
    return B, H, dev


def _vec(H: int, u: torch.Tensor) -> int:
    """Whether four neighbouring columns of u load as one aligned vector."""
    return int(H % 4 == 0 and u.data_ptr() % (4 * u.element_size()) == 0)


# The warp route (one warp a batch row, lane c owning column c; kWarpMaxH
# in csrc/gru_cell.cu) and its warps a block, read off tools/step_tiles.py
# on an H100 (PERF.md's findings).
STEP_WARP_MAX_H = 32
STEP_WARPS = 2
# The wide route (v1, one step over the whole card, one cooperative
# launch): columns a gate a block (the narrowest whose grid fits one block
# an SM), the stages a streaming ring keeps room for, the most stages a
# block holds (kWideMaxStages). Every v1 step past the warp route takes it
# (tools/step_tiles.py timed it faster than the column tile from H = 40
# on).
WIDE_COLS = (4, 8, 16)
WIDE_STAGES = 3
WIDE_MAX_STAGES = 32
SMS = 132                    # an H100 SXM's SMs; wrappers pass the card's
WIDE_ROWS = 8                # batch rows of one pass of a wide block
WIDE_THREADS = 256           # threads of a wide block (kWideThreads)


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """One launch of :func:`gru_step_fused` or :func:`gru_step_blocked`:
    ``route`` "warp" (one warp a batch row, ``warps`` a block), "wide"
    (``grid`` blocks of ``ct`` columns a gate, ``rows`` batch rows a pass,
    ``kc`` z/r rows a stage, ``stages`` in the ring; one cooperative
    launch) or "tile" (the column tile: ``ct`` columns a tile, ``rows``
    the batch tile; the blocked step's two launches). ``grid`` blocks a
    launch, ``threads`` a block, ``smem`` dynamic bytes a block."""
    route: str
    grid: int
    threads: int
    smem: int
    rows: int
    warps: int = 0
    ct: int = 0
    kc: int = 0
    stages: int = 0


def warp_step_plan(B: int, warps: int = STEP_WARPS) -> StepPlan:
    """The warp route at ``warps`` warps a block (no more than B needs)."""
    warps = min(warps, 1 << max(B - 1, 0).bit_length())
    return StepPlan("warp", -(-B // warps), 32 * warps, 0, 1, warps=warps)


def tile_step_plan(kind: str, B: int, H: int,
                   u_dtype: torch.dtype) -> StepPlan:
    """The column-tile route as the wrappers launched it before the warp
    and wide routes: kind ``v1``/``v3`` (the fused step) or ``blocked``."""
    ct = column_tile(u_dtype, kind == "v1" or (kind == "v3"
                                               and H <= NARROW_H))
    bt = step_tile(kind, B, H, ct)
    cols = 1 if kind == "v1" else -(-H // ct)
    return StepPlan("tile", cols * -(-B // bt), _launch.THREADS,
                    smem_bytes_step(kind, H, bt, ct), bt, ct=ct)


def wide_smem(H: int, bt: int, cw: int, kc: int, stages: int,
              u_dtype: torch.dtype) -> int:
    """Dynamic shared memory of one wide block (mirrors ``wide_smem`` in
    the CUDA source): the (H, bt) operand rounded up to 16 bytes, the ring
    of ``stages`` stages of 2*kc*cw weights, the warps' sums."""
    item = 2 if u_dtype == torch.bfloat16 else 4
    return (4 * (-(-H * bt // 4) * 4) + stages * 2 * kc * cw * item
            + 4 * (WIDE_THREADS // 32) * bt * 32)


def wide_chunks(B: int, H: int, bt: int, kc: int) -> int:
    """Chunks one wide block streams: per batch tile ceil(H / kc) of z/r
    rows and ceil(H / 2kc) of candidate rows."""
    return -(-B // bt) * (-(-H // kc) + -(-H // (2 * kc)))


def wide_kc_unit(cw: int) -> int:
    """The wide route's z/r rows a stage come in multiples of 2 *
    :data:`WIDE_THREADS` / cw: every span is then a multiple of both
    passes' k-slices (a thread owns 4 columns, so 4 * WIDE_THREADS / Q
    slices for a pass over Q columns; the C entry refuses other kc)."""
    return 4 * WIDE_THREADS // (2 * cw)


def wide_step_plan(B: int, H: int, u_dtype: torch.dtype, *,
                   cw: int = 0, kc: int = 0, stages: int = 0,
                   sms: int = SMS):
    """The wide route's launch: ``cw`` 0 picks the narrowest of
    :data:`WIDE_COLS` whose grid fits one block an SM; ``kc`` 0 one pass's
    rows (H, rounded up to :func:`wide_kc_unit`) where two stages of them
    fit, else the largest of the unit's power-of-two multiples with which
    :data:`WIDE_STAGES` stages fit (fewer, larger chunks were faster at
    every shape the sweep timed, as long as a streaming ring kept three
    stages); ``stages`` 0 as many as the chunks need and a block's
    shared memory holds (at most :data:`WIDE_MAX_STAGES`). The batch rows
    of a pass: the smallest power of two >= B, at most :data:`WIDE_ROWS`,
    halved until two stages of one unit fit. None where the grid does not
    fit one block an SM (the cooperative launch's residency) or not even
    one row and two such stages fit."""
    if not cw:
        cw = next((c for c in WIDE_COLS if -(-H // c) <= sms), WIDE_COLS[-1])
    grid = -(-H // cw)
    if grid > sms:
        return None
    unit = wide_kc_unit(cw)

    def smem(bt, kc, n):
        return wide_smem(H, bt, cw, kc, n, u_dtype)
    bt = min(WIDE_ROWS, 1 << max(B - 1, 0).bit_length())
    while bt > 1 and smem(bt, kc or unit, 2) > SMEM_LIMIT:
        bt //= 2
    if smem(bt, kc or unit, 2) > SMEM_LIMIT:
        return None
    if not kc:
        whole = -(-H // unit) * unit
        kc = unit
        while kc * 2 < whole and smem(bt, kc * 2, WIDE_STAGES) <= SMEM_LIMIT:
            kc *= 2
        if smem(bt, whole, 2) <= SMEM_LIMIT:
            kc = whole
    if not stages:
        per = smem(bt, kc, 1) - smem(bt, kc, 0)
        stages = min(WIDE_MAX_STAGES, max(2, wide_chunks(B, H, bt, kc)),
                     (SMEM_LIMIT - smem(bt, kc, 0)) // per)
    return StepPlan("wide", grid, WIDE_THREADS, smem(bt, kc, stages), bt,
                    ct=cw, kc=kc, stages=stages)


@functools.lru_cache(maxsize=1024)
def step_plan(B: int, H: int, variant: str, u_dtype: torch.dtype,
              kernel: str = "gru_step_fused", sms: int = SMS) -> StepPlan:
    """The launch of ``kernel``: the fused step takes the warp route where
    H <= :data:`STEP_WARP_MAX_H`; past it (and the blocked step always) v1
    takes the wide route and v3 the column tile; v1 takes the column tile
    only where the wide route does not fit (a grid past ``sms`` blocks: H
    > 16 * sms). Raises where nothing fits one block's shared memory."""
    _launch.check_problem(variant, B, 1, H, 1)
    if kernel == "gru_step_fused" and H <= STEP_WARP_MAX_H:
        return warp_step_plan(B)
    if variant == "v1":
        p = wide_step_plan(B, H, u_dtype, sms=sms)
        if p is not None:
            return p
    return tile_step_plan("blocked" if kernel == "gru_step_blocked"
                          else variant, B, H, u_dtype)


def sm_count(device: torch.device) -> int:
    """The SMs a cooperative grid may span: the card's, :data:`SMS` for a
    plan made on the CPU."""
    return _launch.sm_count(device) if device.type == "cuda" else SMS


def launch_step(p: StepPlan, h, x_proj, u, b, variant: str,
                blocked: bool) -> torch.Tensor:
    """Launch plan ``p`` on CUDA tensors (checked by the caller) into a new
    (B, H) output; ``blocked``: the blocked step's order of additions on
    the wide route and its two kernels on the tile route. The wrappers'
    launch, and how tests and tools force a route."""
    B, H = h.shape
    dev = h.device
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    bf16 = int(u.dtype == torch.bfloat16)
    head = (_launch.ptr(h), _launch.ptr(x_proj), _launch.ptr(u),
            _launch.ptr(b))
    if p.route == "warp":
        err = _launch.launcher("gru_cell", "gru_step_warp_launch",
                               _WARP_STEP_ARGS)(
            *head, _launch.ptr(out), B, H, int(variant == "v3"), bf16,
            p.warps, _launch.stream(dev))
    elif p.route == "tile" and not blocked:
        err = _launch.launcher("gru_cell", "gru_step_fused_launch",
                               _FUSED_ARGS)(
            *head, _launch.ptr(out), B, H, int(variant == "v3"), bf16,
            p.rows, p.ct, _vec(H, u), _launch.stream(dev))
    else:
        # z (B, H); r*h (B, H), on the wide route tile-major (tiles, H, rows)
        zs = torch.empty((B, H), dtype=torch.float32, device=dev)
        rhs = torch.empty((-(-B // p.rows) * p.rows, H), dtype=torch.float32,
                          device=dev)
        scratch = (_launch.ptr(zs), _launch.ptr(rhs), _launch.ptr(out))
        if p.route == "tile":
            err = _launch.launcher("gru_cell", "gru_step_blocked_launch",
                                   _BLOCKED_ARGS)(
                *head, *scratch, B, H, bf16, p.rows, p.ct, _vec(H, u),
                _launch.stream(dev))
        else:
            err = _launch.launcher("gru_cell", "gru_step_wide_launch",
                                   _WIDE_ARGS)(
                *head, *scratch, B, H, bf16, p.rows, p.ct, p.kc, p.stages,
                _vec(H, u) * int(h.data_ptr() % 16 == 0), int(blocked),
                _launch.stream(dev))
    _launch.raise_on(err, "gru_step_blocked" if blocked else "gru_step_fused")
    return out


@_launch.forward_only
def gru_step_fused(h: torch.Tensor, x_proj: torch.Tensor, u: torch.Tensor,
                   b: torch.Tensor, *, variant: str = "v1") -> torch.Tensor:
    """h' for one step -> (B,H) float32. Launches :func:`step_plan`'s route
    and keeps the plan as ``last_plan``."""
    if variant not in _launch.VARIANTS:
        raise ValueError(f"variant {variant!r} not in {_launch.VARIANTS}")
    B, H, dev = _check_step(h, x_proj, u, b)
    p = step_plan(B, H, variant, u.dtype, "gru_step_fused", sm_count(dev))
    if dev.type == "cpu":
        return ref.gru_step_ref(h, x_proj, u, b, variant)
    out = launch_step(p, h, x_proj, u, b, variant, False)
    gru_step_fused.launches += 1
    gru_step_fused.last_plan = p
    return out


@_launch.forward_only
def gru_step_blocked(h: torch.Tensor, x_proj: torch.Tensor, u: torch.Tensor,
                     b: torch.Tensor, *, block_n: int = 256) -> torch.Tensor:
    """The v1 step for large H, z and r*h of every column before any
    candidate -> (B,H) float32. ``min(block_n, H)`` must divide H, as JAX
    asserts. Launches :func:`step_plan`'s route (the wide route; z and r*h
    through (B, H) scratch) and keeps the plan as ``last_plan``."""
    B, H, dev = _check_step(h, x_proj, u, b)
    bn = min(block_n, H)
    if H % bn:
        raise ValueError(f"H={H} is not a multiple of block_n={bn}")
    p = step_plan(B, H, "v1", u.dtype, "gru_step_blocked", sm_count(dev))
    if dev.type == "cpu":
        return ref.gru_step_ref(h, x_proj, u, b, "v1")
    out = launch_step(p, h, x_proj, u, b, "v1", True)
    gru_step_blocked.launches += 1
    gru_step_blocked.last_plan = p
    return out


gru_step_fused.launches = 0
gru_step_blocked.launches = 0
gru_step_fused.last_plan = None
gru_step_blocked.last_plan = None
STEP_KERNELS = (gru_step_fused, gru_step_blocked)


def smem_bytes_step_q8(H: int, bt: int) -> int:
    """Dynamic shared memory of one block (mirrors ``smem_bytes_step_q8`` in
    the CUDA source): the int8 rows padded to an odd number of 4-byte
    words, scales, b, h, the v1 z gate, two quantized activation rows and
    the rows' liveness."""
    H3 = 3 * H
    nw = (H + 3) // 4
    return 4 * (H3 * (nw | 1) + 2 * H3 + 2 * bt * H + 2 * bt * nw + bt)


# The warp route's width and knob: one output column a lane (kWarpMaxH in
# csrc/gru_cell_q8.cu); warps a block read off tools/step_q8_tiles.py on
# an H100 (PERF.md's findings): one warp a block, so B rows spread over B
# SMs, was the fastest at the served H=32, 8 rows (2, 4 and 8 warps 11-48 %
# slower) and within 7 % of the best at H=20 and at 1 and 64 rows. The
# block route past STEP_Q8_WARP_MAX_H.
STEP_Q8_WARP_MAX_H = 32
STEP_Q8_WARPS = 1


@dataclasses.dataclass(frozen=True)
class StepQ8Plan:
    """One launch of :func:`gru_step_q8`: ``route`` "warp" (one warp a batch
    row, ``warps`` warps a block, ``rows`` 1) or "block" (``rows`` the
    batch tile of a block of :data:`~repro_torch.kernels._launch.THREADS`
    threads). ``grid`` blocks, ``threads`` per block, ``smem`` dynamic
    bytes."""
    route: str
    rows: int
    warps: int
    grid: int
    threads: int
    smem: int


def step_q8_warp_plan(B: int, warps: int) -> StepQ8Plan:
    """The warp-route launch at ``warps`` warps a block."""
    return StepQ8Plan("warp", 1, warps, -(-B // warps), 32 * warps, 0)


def step_q8_block_plan(B: int, H: int, bt: int) -> StepQ8Plan:
    """The block-route launch at batch tile ``bt``."""
    return StepQ8Plan("block", bt, _launch.THREADS // 32, -(-B // bt),
                      _launch.THREADS, smem_bytes_step_q8(H, bt))


@functools.lru_cache(maxsize=512)
def step_q8_plan(B: int, H: int, variant: str) -> StepQ8Plan:
    """The launch of the q8 step: the warp route where H <=
    :data:`STEP_Q8_WARP_MAX_H` (at most :data:`STEP_Q8_WARPS` warps a
    block, no more than the rows need), else the block route at
    :func:`_launch.batch_tile`'s tile (which raises where one block's
    shared memory does not fit)."""
    _launch.check_problem(variant, B, 1, H, 1)
    if H > STEP_Q8_WARP_MAX_H:
        return step_q8_block_plan(B, H, _launch.batch_tile(
            variant, B, 1, H, 1, 0, None,
            lambda _L, H, bt: smem_bytes_step_q8(H, bt)))
    return step_q8_warp_plan(B, min(STEP_Q8_WARPS,
                                    1 << max(B - 1, 0).bit_length()))


def q8_words(H: int, u_q: torch.Tensor) -> int:
    """Whether the warp route loads u_q's rows as 4-byte words."""
    return int(H % 4 == 0 and u_q.data_ptr() % 4 == 0)


@_launch.forward_only
def gru_step_q8(h: torch.Tensor, x_proj: torch.Tensor, u_q: torch.Tensor,
                u_eff: torch.Tensor, b: torch.Tensor, *,
                variant: str = "v1") -> torch.Tensor:
    """One q8 GRU step with everything resident -> new state (B,H).
    Launches :func:`step_q8_plan`'s route and keeps the plan as
    ``last_plan``."""
    if h.dim() != 2:
        raise ValueError(f"h: expected (B,H), got {tuple(h.shape)}")
    B, H = h.shape
    dev = h.device
    ref.check_q8_width(H, dev)
    _launch.check_device(dev)
    p = step_q8_plan(B, H, variant)
    _launch.check("h", h, (B, H), dev)
    _launch.check("x_proj", x_proj, (B, 3 * H), dev)
    _launch.check("u_q", u_q, (3 * H, H), dev, torch.int8)
    _launch.check("u_eff", u_eff, (3 * H,), dev)
    _launch.check("b", b, (3 * H,), dev)
    if dev.type == "cpu":
        return ref.gru_step_q8_ref(h, x_proj, u_q, u_eff, b, variant)
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    head = (_launch.ptr(h), _launch.ptr(x_proj), _launch.ptr(u_q),
            _launch.ptr(u_eff), _launch.ptr(b), _launch.ptr(out), B, H,
            int(variant == "v3"))
    if p.route == "warp":
        err = _launch.launcher("gru_cell_q8", "gru_step_q8_warp_launch",
                               _WARP_ARGS)(
            *head, p.warps, q8_words(H, u_q), _launch.stream(dev))
    else:
        err = _launch.launcher("gru_cell_q8", "gru_step_q8_launch",
                               _ARGTYPES)(*head, p.rows, _launch.stream(dev))
    _launch.raise_on(err, "gru_step_q8")
    gru_step_q8.launches += 1
    gru_step_q8.last_plan = p
    return out


gru_step_q8.launches = 0
gru_step_q8.last_plan = None
