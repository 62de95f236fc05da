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
reach the CUDA kernels, which pick their own tiles (8 fp32 or 16 bf16
columns and at most 8 rows a block, fewer rows where the grid would
leave SMs idle: :func:`batch_tile`); ``block_k`` is the cascade's
summation structure and does.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything its kernel does not take. For CPU tensors it returns the plain
version (``ref.py``); for CUDA tensors it allocates the output with
``torch.empty``, launches on the current stream, raises if the launch was
refused, and adds one to its ``launches`` counter (:data:`MATVEC_KERNELS`,
zeroed by ``repro_torch.kernels.gru_sequence.kernel.reset_launch_counts``).
Nothing falls back from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels._launch import I, P
from repro_torch.kernels.rowwise_matvec import ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_ROWS = 8                # rows of one block's batch tile
MAX_CHUNK = 2048            # k's of x one block stages in shared memory
# x, w, y, B, K, N, bf16, bt, ct, kc, vec, stream
_ROWWISE_ARGS = [P] * 3 + [I] * 8 + [P]
# x, w, y, B, K, N, bk, bf16, bt, ct, kc, vec, stream
_CASCADE_ARGS = [P] * 3 + [I] * 9 + [P]


def column_tile(dtype: torch.dtype) -> int:
    """Output columns of one block: one 32-byte sector of each row of w."""
    return 16 if dtype == torch.bfloat16 else 8


def smem_bytes(kc: int, bt: int, ct: int) -> int:
    """Dynamic shared memory of one block (mirrors ``rowwise_smem_bytes``
    in the CUDA source): the (kc, bt) chunk of x and the 8 warps' partial
    sums."""
    return 4 * (kc * bt + 8 * bt * ct)


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


def batch_tile(B: int, N: int, ct: int, sms: int) -> int:
    """Rows of one block: the smallest power of two >= B, at most
    :data:`MAX_ROWS`, halved while the grid (N/ct column tiles times the
    batch tiles) has fewer blocks than the card has SMs: a narrow w (N of
    1024 in bf16 gives 64 column tiles) then reads its weights from more
    SMs at once, the extra reads of w coming from L2."""
    bt = min(MAX_ROWS, 1 << (B - 1).bit_length())
    while bt > 1 and -(-N // ct) * -(-B // bt) < sms:
        bt //= 2
    return bt


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _vec(N: int, w: torch.Tensor) -> int:
    return int(N % 4 == 0 and w.data_ptr() % (4 * w.element_size()) == 0)


def rowwise_matmul(x: torch.Tensor, w: torch.Tensor, *, block_b: int = 0,
                   block_n: int = 128) -> torch.Tensor:
    """y = x @ w, each block finishing its own output columns -> (B,N) in
    x's dtype."""
    B, K, N = _check(x, w, block_b, block_n)
    if x.device.type == "cpu":
        return ref.rowwise_matmul_ref(x, w)
    ct = column_tile(x.dtype)
    bt = batch_tile(B, N, ct, _sms(x.device))
    y = torch.empty((B, N), dtype=x.dtype, device=x.device)
    err = _launch.launcher("rowwise_matvec", "rowwise_matmul_launch",
                           _ROWWISE_ARGS)(
        _launch.ptr(x), _launch.ptr(w), _launch.ptr(y), B, K, N,
        int(x.dtype == torch.bfloat16), bt, ct, min(K, MAX_CHUNK), _vec(N, w),
        _launch.stream(x.device))
    _launch.raise_on(err, "rowwise_matmul")
    rowwise_matmul.launches += 1
    return y


def cascade_matmul(x: torch.Tensor, w: torch.Tensor, *, block_b: int = 0,
                   block_n: int = 128, block_k: int = 128) -> torch.Tensor:
    """y = x @ w, the contraction in blocks of ``min(block_k, K)`` whose
    partial products accumulate in k order -> (B,N) float32."""
    B, K, N = _check(x, w, block_b, block_n, block_k)
    bk = min(block_k, K)
    if x.device.type == "cpu":
        return ref.cascade_matmul_ref(x, w, bk)
    ct = column_tile(x.dtype)
    bt = batch_tile(B, N, ct, _sms(x.device))
    y = torch.empty((B, N), dtype=torch.float32, device=x.device)
    err = _launch.launcher("rowwise_matvec", "cascade_matmul_launch",
                           _CASCADE_ARGS)(
        _launch.ptr(x), _launch.ptr(w), _launch.ptr(y), B, K, N, bk,
        int(x.dtype == torch.bfloat16), bt, ct, min(bk, MAX_CHUNK),
        _vec(N, w), _launch.stream(x.device))
    _launch.raise_on(err, "cascade_matmul")
    cascade_matmul.launches += 1
    return y


rowwise_matmul.launches = 0
cascade_matmul.launches = 0
MATVEC_KERNELS = (rowwise_matmul, cascade_matmul)
