"""Wrappers of the row-wise and cascade matmul kernels
(``repro_torch/csrc/rowwise_matvec.cu``).

Same names and array interfaces as the Pallas kernels in
``repro.kernels.rowwise_matvec.kernel``:

* :func:`rowwise_matmul` — y = x @ w, output-stationary (the paper's
  row-wise scheme): x (B,K), w (K,N) -> (B,N) in x's dtype;
* :func:`cascade_matmul` — y = x @ w with the contraction walked in blocks
  of ``block_k`` and each block's partial product added in k order (the
  cascade baseline) -> (B,N) float32.

x and w are both float32 or both bfloat16; sums are fp32. ``block_b`` and
``block_n`` (and ``block_k``) must divide B and N (and K) as JAX asserts
(``block_b`` 0 means B; ``block_n`` and ``block_k`` are capped at N and K);
the wrappers raise ``ValueError`` there. They are TPU tiling and do not
reach the CUDA kernels, which take their own :class:`Plan`
(:func:`plan`): ``ct`` output columns and all of the batch (up to 8 rows)
per block, chunks of ``kc`` contraction rows that each of ``warps``
consumer warps loads into its own shared-memory stages by TMA, or by
plain loads where w's or x's alignment or row stride rules TMA out
(:func:`aligned`); an fp32 problem of one chunk goes straight to
registers. ``block_k`` is the cascade's
summation structure and reaches the kernel.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything its kernel does not take. For CPU tensors it returns the plain
version (``ref.py``); for CUDA tensors it allocates the output with
``torch.empty``, launches on the current stream, raises if the launch was
refused, adds one to its ``launches`` counter (:data:`MATVEC_KERNELS`,
zeroed by ``repro_torch.kernels.gru_sequence.kernel.reset_launch_counts``)
and keeps the plan it launched as ``last_plan`` (``last_plan.route``
names the copy path). Nothing falls back from the card to the plain
version.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels._launch import I, P
from repro_torch.kernels.rowwise_matvec import ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_ROWS = 8                # batch rows of one block (mma's N)
COLUMN_TILES = (8, 16, 32, 64)
MAX_WARPS = 16              # consumer warps (kMaxWarps in the CUDA source)
SLOTS = 4                   # partial-sum slots (kSlots)
ALIGN = 1024                # stage alignment: the 128-byte swizzle's period
STAGE_ROWS = {torch.bfloat16: 64, torch.float32: 64}   # kc at most
RING_BYTES = 96 * 1024      # the stages' budget of shared memory
# the C `route` argument's codes: the copy path of each chunk into shared
# memory (plain loads, TMA), or fp32 registers straight from device memory
# for a problem of one chunk
ROUTES = ("plain", "tma", "direct")
ALIGNED_ROUTE = "tma"       # where TMA can read the operands
MAX_ROW_BYTES = 64          # widest column tile: bytes of one row of w
GRID_SHARE = 0.7            # least share of the SMs the grid should cover
CHUNKS_PER_WARP = 4         # chunks each consumer warp takes, at least
# x, w, y, B, K, N, bf16, ct, kc, stages, warps, route, stream
_ROWWISE_ARGS = [P] * 3 + [I] * 9 + [P]
# x, w, y, B, K, N, bk, bf16, ct, kc, stages, warps, route, stream
_CASCADE_ARGS = [P] * 3 + [I] * 10 + [P]


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the row-wise/cascade kernel: ``route`` one of
    :data:`ROUTES`, ``ct`` output columns and ``rows`` batch rows per
    block (x's box), ``kc`` contraction rows per chunk, ``stages`` stages
    (``stages / warps`` for each consumer warp, which loads its own
    chunks), ``warps`` consumer warps, ``bk`` the k-block (K for rowwise),
    ``chunks`` per block, ``smem`` dynamic shared memory per block
    (:func:`smem_bytes`) and ``grid``."""
    route: str
    ct: int
    rows: int
    kc: int
    stages: int
    warps: int
    bk: int
    chunks: int
    smem: int
    grid: tuple


def tile_rows(dtype: torch.dtype, B: int) -> int:
    """Batch rows of one block: 8 in bf16 (mma's N, padded with zeros),
    else the smallest power of two >= B, at most :data:`MAX_ROWS`."""
    if dtype == torch.bfloat16 or B >= MAX_ROWS:
        return MAX_ROWS
    return 1 << (B - 1).bit_length()


def stage_rows(dtype: torch.dtype, bk: int) -> int:
    """Contraction rows of a stage (kc): a power of two, :data:`STAGE_ROWS`
    or the smallest that holds a shorter k-block (a chunk never straddles
    a k-block), at least 16 in bf16 (the mma takes 16 rows; x's box row,
    kc * 2 bytes, is one swizzle span) and 4 in fp32 (16-byte rows)."""
    kc, least = STAGE_ROWS[dtype], 16 if dtype == torch.bfloat16 else 4
    while kc > least and kc // 2 >= bk:
        kc //= 2
    return kc


def smem_bytes(dtype: torch.dtype, B: int, K: int, bk: int, ct: int,
               kc: int, stages: int, warps: int) -> int:
    """Dynamic shared memory of one block (mirrors ``rowwise_smem_bytes``
    in the CUDA source): 1024 bytes of alignment slack; ``stages`` stages
    of w's (kc, ct) box and x's (rows, kc) box, each rounded up to 1024
    bytes; the partial-sum ring, slots of one fp32 (rows, ct) part per
    consumer taking part in a block (min(ceil(bk/kc), warps)), as many
    slots as the smallest multiple of ``warps`` >= SLOTS but at most K/bk;
    and 8 bytes per mbarrier (one per stage, two per slot)."""
    item = 2 if dtype == torch.bfloat16 else 4
    rows = tile_rows(dtype, B)
    nblk, cpb = K // bk, -(-bk // kc)
    nc, slots = min(cpb, warps), min(nblk, -(-SLOTS // warps) * warps)
    w_stage = -(-kc * ct * item // ALIGN) * ALIGN
    x_stage = -(-kc * rows * item // ALIGN) * ALIGN
    return (ALIGN + stages * (w_stage + x_stage) + slots * nc * rows * ct * 4
            + 8 * (stages + 2 * slots))


def aligned(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether TMA boxes (16-byte copies) can read the operands:
    w and x 16-byte aligned, w's row of N and, for more than one row, x's
    row of K a multiple of 16 bytes."""
    item = x.element_size()
    B, K = x.shape
    N = w.shape[1]
    return (w.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
            and N * item % 16 == 0 and (B == 1 or K * item % 16 == 0))


def column_tile(dtype: torch.dtype, B: int, N: int, sms: int) -> int:
    """Output columns of one block: the widest tile of at most
    :data:`MAX_ROW_BYTES` a row of w whose grid (N/ct column tiles times
    the batch tiles) still covers :data:`GRID_SHARE` of the card's SMs,
    else the narrowest. Read off ``tools/rowwise_tiles.py`` at qwen3-0.6b's
    shapes (PERF.md's findings)."""
    item = 2 if dtype == torch.bfloat16 else 4
    tiles = -(-B // tile_rows(dtype, B))
    fits = [ct for ct in COLUMN_TILES if ct * item <= MAX_ROW_BYTES
            and -(-N // ct) * tiles >= GRID_SHARE * sms]
    return max(fits) if fits else COLUMN_TILES[0]


def consumer_warps(chunks: int) -> int:
    """Consumer warps of one block: one for each :data:`CHUNKS_PER_WARP`
    chunks, at least one and at most :data:`MAX_WARPS` (each warp's chunks
    are a serial chain of wait, products and reload)."""
    return max(1, min(MAX_WARPS, chunks // CHUNKS_PER_WARP))


def plan(x: torch.Tensor, w: torch.Tensor, bk: int, sms: int) -> Plan:
    """The launch the wrappers make for x (B, K) @ w (K, N) with k-blocks
    of ``bk`` rows (K for rowwise) on a card of ``sms`` SMs. The route:
    "direct" for an fp32 problem of one chunk, else :data:`ALIGNED_ROUTE`
    where the operands are :func:`aligned`, else "plain"."""
    return _plan(*x.shape, w.shape[1], x.dtype, bk, sms, aligned(x, w))


@functools.lru_cache(maxsize=512)
def _plan(B: int, K: int, N: int, dtype: torch.dtype, bk: int, sms: int,
          is_aligned: bool) -> Plan:
    """:func:`plan` of the shapes (cached: the wrappers call it per launch)."""
    ct = column_tile(dtype, B, N, sms)
    kc = stage_rows(dtype, bk)
    chunks = (K // bk) * -(-bk // kc)
    rows = tile_rows(dtype, B)
    item = 2 if dtype == torch.bfloat16 else 4
    per_stage = (-(-kc * ct * item // ALIGN) + -(-kc * rows * item // ALIGN))
    # each consumer warp has its own stages: all of its chunks where they
    # fit the ring's budget
    warps = consumer_warps(chunks)
    per = max(1, min(-(-chunks // warps),
                     RING_BYTES // (per_stage * ALIGN * warps)))
    stages = per * warps
    way = ("direct" if dtype == torch.float32 and chunks == 1
           else ALIGNED_ROUTE if is_aligned else "plain")
    return Plan(way, ct, rows, kc, stages, warps, bk, chunks,
                smem_bytes(dtype, B, K, bk, ct, kc, stages, warps),
                (-(-N // ct), -(-B // rows)))


def _check(x, w, block_b: int, block_n: int, block_k=None):
    """Check the operands and JAX's divisibility; returns (B, K, N)."""
    for name, t in (("x", x), ("w", w)):
        if not isinstance(t, torch.Tensor) or t.dim() != 2:
            raise ValueError(f"{name}: expected a 2-D tensor, got "
                             f"{getattr(t, 'shape', type(t))}")
        if t.dtype not in DTYPES or t.dtype != x.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}; the kernels take "
                            f"float32 or bfloat16, x and w alike")
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    B, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"x (B,K)={tuple(x.shape)} and w (K,N)="
                         f"{tuple(w.shape)} do not contract")
    if min(B, K, N) < 1:
        raise ValueError(f"empty problem: B={B} K={K} N={N}")
    bb = block_b or B
    bn = min(block_n, N)
    if B % bb or N % bn:
        raise ValueError(f"block_b={bb} must divide B={B} and block_n={bn} "
                         f"N={N}")
    if block_k is not None and K % min(block_k, K):
        raise ValueError(f"block_k={min(block_k, K)} must divide K={K}")
    return B, K, N


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_plan(name, args, x, w, y, bk, extra):
    """Launch the plan for (x, w, bk) through the C entry ``name``."""
    p = plan(x, w, bk, _sms(x.device))
    if p.smem > _launch.SMEM_LIMIT:
        raise ValueError(f"{name}: {p} needs more shared memory than a "
                         f"Hopper block has ({_launch.SMEM_LIMIT})")
    B, K = x.shape
    err = _launch.launcher("rowwise_matvec", f"{name}_launch", args)(
        _launch.ptr(x), _launch.ptr(w), _launch.ptr(y), B, K, w.shape[1],
        *extra, int(x.dtype == torch.bfloat16), p.ct, p.kc, p.stages,
        p.warps, ROUTES.index(p.route), _launch.stream(x.device))
    _launch.raise_on(err, name)
    return p


@_launch.forward_only
def rowwise_matmul(x: torch.Tensor, w: torch.Tensor, *, block_b: int = 0,
                   block_n: int = 128) -> torch.Tensor:
    """y = x @ w, each block finishing its own output columns -> (B,N) in
    x's dtype."""
    B, K, N = _check(x, w, block_b, block_n)
    if x.device.type == "cpu":
        return ref.rowwise_matmul_ref(x, w)
    y = torch.empty((B, N), dtype=x.dtype, device=x.device)
    rowwise_matmul.last_plan = _launch_plan(
        "rowwise_matmul", _ROWWISE_ARGS, x, w, y, K, ())
    rowwise_matmul.launches += 1
    return y


@_launch.forward_only
def cascade_matmul(x: torch.Tensor, w: torch.Tensor, *, block_b: int = 0,
                   block_n: int = 128, block_k: int = 128) -> torch.Tensor:
    """y = x @ w, the contraction in blocks of ``min(block_k, K)`` whose
    partial products accumulate in k order -> (B,N) float32."""
    B, K, N = _check(x, w, block_b, block_n, block_k)
    bk = min(block_k, K)
    if x.device.type == "cpu":
        return ref.cascade_matmul_ref(x, w, bk)
    y = torch.empty((B, N), dtype=torch.float32, device=x.device)
    cascade_matmul.last_plan = _launch_plan(
        "cascade_matmul", _CASCADE_ARGS, x, w, y, bk, (bk,))
    cascade_matmul.launches += 1
    return y


rowwise_matmul.launches = 0
cascade_matmul.launches = 0
rowwise_matmul.last_plan = None
cascade_matmul.last_plan = None
MATVEC_KERNELS = (rowwise_matmul, cascade_matmul)
