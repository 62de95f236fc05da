"""Wrappers of the single-step kernels (``repro_torch/csrc/gru_cell.cu``
and ``repro_torch/csrc/gru_cell_q8.cu``).

Same names and array interfaces as the Pallas kernels in
``repro.kernels.gru_cell.kernel``:

* :func:`gru_step_fused` — one GRU step, h (B,H) float32, x_proj (B,3H)
  float32, u (H,3H) float32 or bfloat16 (gate columns [z | r | h]), b
  (3H,) float32 -> (B,H) float32; v1 or v3. h and r*h are rounded to u's
  dtype before each product; sums are fp32.
* :func:`gru_step_blocked` — the same step, v1, split over column tiles of
  many thread blocks for large H; ``block_n`` is JAX's row block and must
  divide H (``min(block_n, H)``, as there); the CUDA kernels pick their
  own tiles.
* :func:`gru_step_q8` — one q8 cell update, h (B,H) float32, x_proj (B,3H)
  float32, u_q (3H,H) int8 weight rows, u_eff (3H,) per-row dequant
  scales, b (3H,) -> (B,H) float32; v1 or v3.

Each checks device, dtype, shapes and contiguity and raises on anything
its kernel does not take (:mod:`repro_torch.kernels._launch`). For CPU
tensors it returns the plain PyTorch version (``ref.py``); for CUDA tensors
it allocates the output (and the blocked step's z and r*h scratch) with
``torch.empty``, launches on the current stream, raises if a launch was
refused, and adds one to its ``launches`` counter (zeroed by
``repro_torch.kernels.gru_sequence.kernel.reset_launch_counts``).
``gru_step_q8`` belongs to its ``CHAIN_Q8_KERNELS``; the fp32/bf16 pair is
:data:`STEP_KERNELS`. ``gru_step_blocked`` is two CUDA launches on the
stream (gates, then candidate) and counts once per call.

:func:`gru_step_q8` launches the route :func:`step_q8_plan` picks (one
warp per batch row where H <= :data:`STEP_Q8_WARP_MAX_H`, every served
width; else a block of a batch tile of
:data:`~repro_torch.kernels._launch.DEFAULT_BATCH_BLOCK` rows) and keeps
it as ``last_plan``. The fp32/bf16 kernels take at most 8 rows (the
smallest power of two that holds B, halved until the block's shared
memory fits); the grid runs over batch tiles and, for the v3 fused step
and the blocked step, over column tiles. The v1 fused step keeps h, z and
r*h of its tile in shared memory (12 bytes per row and unit of H) and
raises beyond what one block holds (H of about 19,000 at one row).
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


def gru_step_fused(h: torch.Tensor, x_proj: torch.Tensor, u: torch.Tensor,
                   b: torch.Tensor, *, variant: str = "v1") -> torch.Tensor:
    """h' for one step, the whole state of a batch tile in one block (v1)
    or column tiles over blocks (v3) -> (B,H) float32."""
    if variant not in _launch.VARIANTS:
        raise ValueError(f"variant {variant!r} not in {_launch.VARIANTS}")
    B, H, dev = _check_step(h, x_proj, u, b)
    ct = column_tile(u.dtype, variant == "v1" or H <= NARROW_H)
    bt = step_tile(variant, B, H, ct)
    if dev.type == "cpu":
        return ref.gru_step_ref(h, x_proj, u, b, variant)
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    err = _launch.launcher("gru_cell", "gru_step_fused_launch", _FUSED_ARGS)(
        _launch.ptr(h), _launch.ptr(x_proj), _launch.ptr(u), _launch.ptr(b),
        _launch.ptr(out), B, H, int(variant == "v3"),
        int(u.dtype == torch.bfloat16), bt, ct, _vec(H, u),
        _launch.stream(dev))
    _launch.raise_on(err, "gru_step_fused")
    gru_step_fused.launches += 1
    return out


def gru_step_blocked(h: torch.Tensor, x_proj: torch.Tensor, u: torch.Tensor,
                     b: torch.Tensor, *, block_n: int = 256) -> torch.Tensor:
    """The v1 step over column tiles of many blocks: z and r*h for every
    column first (into scratch), then the candidate and the update, as two
    launches on the current stream -> (B,H) float32. ``min(block_n, H)``
    must divide H, as JAX asserts."""
    B, H, dev = _check_step(h, x_proj, u, b)
    bn = min(block_n, H)
    if H % bn:
        raise ValueError(f"H={H} is not a multiple of block_n={bn}")
    ct = column_tile(u.dtype, False)
    bt = step_tile("blocked", B, H, ct)
    if dev.type == "cpu":
        return ref.gru_step_ref(h, x_proj, u, b, "v1")
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    zs = torch.empty((B, H), dtype=torch.float32, device=dev)
    rhs = torch.empty((B, H), dtype=torch.float32, device=dev)
    err = _launch.launcher("gru_cell", "gru_step_blocked_launch",
                           _BLOCKED_ARGS)(
        _launch.ptr(h), _launch.ptr(x_proj), _launch.ptr(u), _launch.ptr(b),
        _launch.ptr(zs), _launch.ptr(rhs), _launch.ptr(out), B, H,
        int(u.dtype == torch.bfloat16), bt, ct, _vec(H, u),
        _launch.stream(dev))
    _launch.raise_on(err, "gru_step_blocked")
    gru_step_blocked.launches += 1
    return out


gru_step_fused.launches = 0
gru_step_blocked.launches = 0
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
