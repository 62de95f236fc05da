"""What every kernel wrapper of the port shares: argument checks, the batch
tile and its shared-memory check, the current stream, binding a launcher
of a built library with ``ctypes``, raising on a refused launch, and
refusing autograd (:func:`forward_only`).

A wrapper checks device, dtype, shape and contiguity and raises on
anything its kernel does not take. For CPU tensors it returns the plain
PyTorch version; for CUDA tensors it launches on the current stream and
raises if the launch was refused. Nothing falls back from the card to the
plain version.

No kernel has a backward (none has one in JAX, which trains on XLA). A
launch writes through ``ctypes`` into a fresh tensor without a
``grad_fn``, so on the card autograd would stop there and leave the
weights without gradients, while on the CPU the plain version would be
differentiated: a training run would pass its CPU tests and be wrong on
the card. So every wrapper is :func:`forward_only`: called with grad mode
on and any input that requires grad, it raises, on both devices alike.
Training runs on ``backend="eager"`` and ``attn_impl="chunked"``;
evaluation on a kernel backend goes through ``torch.no_grad()`` or
detached tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.kernels import _build

SMEM_LIMIT = 232448           # bytes of shared memory one H100 block may use
THREADS = 256                 # threads per block (kThreads in csrc/)
DEFAULT_BATCH_BLOCK = 4
VARIANTS = ("v1", "v3")
P = ctypes.c_void_p           # a pointer or the stream
I = ctypes.c_int

_BOUND: Dict[str, Callable] = {}


def _needs_grad(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.requires_grad
    if isinstance(x, (tuple, list)):
        return any(_needs_grad(v) for v in x)
    if isinstance(x, dict):
        return any(_needs_grad(v) for v in x.values())
    return False


def no_backward_error(name: str) -> RuntimeError:
    return RuntimeError(f"{name} has no backward; train on backend='eager' "
                        f"/ attn_impl='chunked'")


def forward_only(fn: Callable) -> Callable:
    """Wrap a kernel wrapper so that, with grad mode on, an input that
    requires grad (a tensor, or one inside a tuple, list or dict
    argument) raises :func:`no_backward_error` before anything runs. The
    returned function keeps ``fn``'s name and attributes; its
    ``launches`` counter and ``last_plan`` live on it."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        if torch.is_grad_enabled() and (_needs_grad(args)
                                        or _needs_grad(kw)):
            raise no_backward_error(name)
        return fn(*args, **kw)
    return wrapper


def launcher(library: str, name: str, argtypes: Sequence) -> Callable:
    """The C entry point ``name`` of ``library`` (built and loaded at first
    use), returning the launch's CUDA error code."""
    fn = _BOUND.get(name)
    if fn is None:
        fn = getattr(_build.load(library), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _BOUND[name] = fn
    return fn


def check(name: str, t, shape: tuple, device: torch.device,
          dtype: torch.dtype = torch.float32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_problem(variant: Optional[str], B: int, T: int, H: int,
                  L: int) -> None:
    """Raise on a gate math other than :data:`VARIANTS` (None: a family
    with one gate math) or an empty problem."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if B < 1 or T < 1 or H < 1 or L < 1:
        raise ValueError(f"empty problem: B={B} T={T} H={H} L={L}")


def check_device(device: torch.device) -> None:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def batch_tile(variant: Optional[str], B: int, T: int, H: int, L: int,
               batch_block: int, device: Optional[torch.device],
               smem: Callable[[int, int, int], int]) -> int:
    """Check the problem and return the batch tile of one block; raises if
    the tile has more rows than the block has threads (each of the first
    ``tile`` threads writes its row's liveness) or the block's shared
    memory (``smem(L, H, tile)``) exceeds a Hopper block's. ``variant``
    is the GRU gate math (``v1``/``v3``); None for a family with one gate
    math, whose kernels take no variant. ``device`` None: a plan made
    from shapes alone, checked by its wrapper."""
    check_problem(variant, B, T, H, L)
    if device is not None:
        check_device(device)
    bt = batch_block or min(B, DEFAULT_BATCH_BLOCK)
    if not 1 <= bt <= THREADS:
        raise ValueError(f"batch_block {batch_block}: a tile takes 1 to "
                         f"{THREADS} rows")
    need = smem(L, H, bt)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"L={L} H={H} batch_block={bt} needs {need} bytes of shared "
            f"memory per block; a Hopper block has {SMEM_LIMIT}")
    return bt


def fits_smem(smem: Callable[[int, int, int], int], L: int, H: int,
              batch: Optional[int]) -> bool:
    """Whether a stack of depth ``L`` and width ``H`` fits one block's
    shared memory (``smem(L, H, tile)``) at the batch tile a wrapper picks
    for ``batch`` rows (``min(batch, DEFAULT_BATCH_BLOCK)``; the default
    tile when the batch is not known): what dispatch checks before it
    routes a stack to a kernel backend."""
    bt = min(batch or DEFAULT_BATCH_BLOCK, DEFAULT_BATCH_BLOCK)
    return smem(L, H, bt) <= SMEM_LIMIT


@functools.lru_cache(maxsize=None)
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA card ``device`` (read once per
    card)."""
    device = torch.device(device)
    index = device.index
    return _sms_of(torch.cuda.current_device() if index is None else index)


def stream(device: torch.device) -> int:
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {device} but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()
