"""Parameter specs: declare-once shapes and logical axes, materialized with
torch.

Counterpart of ``repro.core.params``: a model declares its parameters as a
nested dict/tuple of :class:`Spec` leaves, each with its shape and its
LOGICAL axes (names from :data:`PARAM_AXES`; :func:`logical_axes` gives the
tree of them, which ``repro_torch.distributed.sharding`` resolves against
a mesh), and :func:`init_params` turns that tree into tensors, seeded per path with a ``torch.Generator`` (the
numbers differ from ``jax.random``'s; tests that compare the two
frameworks carry the JAX tree over with :func:`params_from_numpy`, and a
whole train state with :func:`state_from_numpy`).
:func:`stack_specs` gives a block's specs a leading layer axis, as the
transformer stacks its blocks ``(L, ...)``. :func:`abstract_params` is
the dry-run stand-in (tensors on the ``meta`` device: shapes and dtypes,
no storage).

Trees are nested dicts, tuples and lists. :func:`flatten` names each leaf
by its path as the JAX package's ``jax.tree_util`` paths do (dict keys in
sorted order, sequence indices as numbers, joined by ``/``:
``params/cells/0/w``): the checkpoint manager's file names and the
optimizer's leaf order both follow it.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

_DTYPES = {"float32": torch.float32, "int32": torch.int32,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ...)."""
    return _DTYPES[{"bf16": "bfloat16", "fp32": "float32",
                    "fp16": "float16"}.get(name, name)]


# Logical axis vocabulary (a copy of JAX's ``PARAM_AXES``). Activations use
# the ``act_*`` names; the mapping to mesh axes lives in
# repro_torch.distributed.sharding.
PARAM_AXES = (
    "layers",      # stacked-layers axis (never sharded)
    "vocab", "embed", "heads", "kv_heads", "head_dim", "mlp",
    "experts", "expert_mlp",
    "hidden", "rnn_in", "gates",       # recurrent cells (the paper's rows)
    "state", "conv", "dt",             # SSM
    "frames", "patches", "vis_embed",  # modality stubs
    # activation/cache logical axes (inputs, KV caches, recurrent states)
    "batch", "act_seq", "act_embed", "act_heads", "act_kv_heads",
    "act_mlp", "act_experts", "act_gates", "act_hidden",
    "act_kv_seq",  # KV-cache capacity dim (flash-decode style sharding)
    "act_seq_tp",  # sequence dim force-sharded over model (SP attention
                   # fallback when head counts don't divide the TP axis)
    "podwise",     # per-pod local state (error-feedback residuals)
)


@dataclass(frozen=True)
class Spec:
    """Declaration of one parameter tensor: its shape and one logical axis
    name (or None) per dimension."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "fan_in"        # fan_in | recurrent | zeros | ones | embed
    scale: float = 1.0
    dtype: Optional[str] = None  # None -> model param_dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")
        for a in self.axes:
            if a is not None and a not in PARAM_AXES:
                raise ValueError(f"unknown logical axis {a!r}")


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def _path_seed(seed: int, path_s: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{path_s}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def _init_one(spec: Spec, seed: int, path_s: str, param_dtype: str,
              device: torch.device) -> torch.Tensor:
    dtype = torch_dtype(spec.dtype or param_dtype)
    shape = tuple(spec.shape)
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if spec.init == "embed":
        std = spec.scale
    elif spec.init == "fan_in":
        std = spec.scale / np.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
    elif spec.init == "recurrent":
        std = spec.scale / np.sqrt(shape[-1])
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    # drawn on the CPU generator so a seed gives the same weights on every
    # device, then moved
    gen = torch.Generator().manual_seed(_path_seed(seed, path_s))
    noise = torch.randn(shape, generator=gen, dtype=torch.float32)
    return noise.mul_(std).to(dtype=dtype, device=device)


def _map_tree(fn, tree, path=()):
    """Apply ``fn(path, leaf)`` over a nested dict/tuple/list tree."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _leaf_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaf_paths(tree[k], path + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree


def flatten(tree) -> dict:
    """``{path: leaf}`` in JAX's leaf order (dict keys sorted). ``None``
    is an empty subtree, as in ``jax.tree_util``."""
    return dict(_leaf_paths(tree))


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in _leaf_paths(tree)]


def map_trees(fn, tree, *rest):
    """``fn(leaf, *leaves)`` over trees of one structure (the first's)."""
    if isinstance(tree, dict):
        return {k: map_trees(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_trees(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def unflatten(like, flat: dict):
    """``like``'s structure with each leaf replaced by ``flat[path]``."""
    return _map_tree(lambda path, x: None if x is None
                     else flat["/".join(path)], like)


def stack_specs(spec_tree, n: int):
    """Prepend a ``layers`` axis of size ``n`` to every Spec in the tree."""
    return _map_tree(lambda _path, s: Spec((n,) + tuple(s.shape),
                                           ("layers",) + tuple(s.axes),
                                           init=s.init, scale=s.scale,
                                           dtype=s.dtype)
                     if is_spec(s) else s, spec_tree)


def logical_axes(specs):
    """The same tree with each Spec replaced by its tuple of logical axes."""
    return _map_tree(lambda _path, s: s.axes if is_spec(s) else s, specs)


def init_params(specs, seed: int = 0, param_dtype: str = "float32", *,
                device="cuda"):
    """Materialize a spec tree into tensors on ``device`` (deterministic per
    path: the same seed gives the same tensors on the CPU and the card)."""
    dev = resolve_device(device)
    return _map_tree(
        lambda path, s: _init_one(s, seed, "/".join(path), param_dtype, dev)
        if is_spec(s) else s, specs)


def mem_available() -> Optional[int]:
    """The host's ``MemAvailable`` in bytes (``/proc/meminfo``), or None
    where there is no such file."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def draw_workers(specs, param_dtype: str = "float32", cap: int = 4) -> int:
    """How many leaves :func:`init_params_each` may draw at a time: as
    many of the largest leaf (in the param dtype) as fit in half the
    host's available memory, at most ``cap`` and the CPU count, at least
    one."""
    import os
    avail = mem_available()
    largest = max(int(np.prod(s.shape)) * torch_dtype(s.dtype or
                                                      param_dtype).itemsize
                  for s in leaves(specs) if is_spec(s))
    if avail is None or largest == 0:
        return 1
    return max(1, min(cap, os.cpu_count() or 1, avail // 2 // largest))


def init_params_each(specs, prepare, seed: int = 0,
                     param_dtype: str = "float32", workers: int = 1):
    """``init_params(specs, seed, param_dtype, device="cpu")`` with
    ``prepare(path, leaf)`` applied to each leaf as soon as it is drawn
    (``path`` the tuple of keys), the drawn leaf then dropped: the tree
    never exists whole in the param dtype (a model too large for that
    on the host or the card is built this way, already cast and moved).
    ``workers`` leaves are drawn at a time, the largest first (a draw
    runs outside the GIL); each leaf's numbers are ``init_params``'s."""
    from concurrent.futures import ThreadPoolExecutor
    cpu = torch.device("cpu")
    jobs = []
    _map_tree(lambda path, s: jobs.append(path) if is_spec(s) else None,
              specs)
    spec_at = {path: _spec_at(specs, path) for path in jobs}
    jobs.sort(key=lambda path: -int(np.prod(spec_at[path].shape)))

    def one(path):
        leaf = _init_one(spec_at[path], seed, "/".join(path), param_dtype,
                         cpu)
        return prepare(path, leaf)
    with ThreadPoolExecutor(max(1, workers)) as ex:
        done = dict(zip(jobs, ex.map(one, jobs)))
    return _map_tree(lambda path, s: done[path] if is_spec(s) else s, specs)


def _spec_at(tree, path):
    for k in path:
        tree = tree[k] if isinstance(tree, dict) else tree[int(k)]
    return tree


def abstract_params(specs, param_dtype: str = "float32"):
    """The spec tree as tensors on the ``meta`` device: shapes and dtypes,
    no storage (the dry-run stand-in)."""
    return _map_tree(
        lambda _p, s: torch.empty(tuple(s.shape), device="meta",
                                  dtype=torch_dtype(s.dtype or param_dtype))
        if is_spec(s) else s, specs)


def param_bytes(specs, param_dtype: str = "float32") -> int:
    return sum(int(np.prod(s.shape)) * torch_dtype(s.dtype or param_dtype).itemsize
               for s in leaves(specs) if is_spec(s))


def param_count(specs) -> int:
    return sum(int(np.prod(s.shape)) for s in leaves(specs) if is_spec(s))


def cast_tree(tree, dtype):
    """Every floating-point leaf cast to ``dtype``; others as they are."""
    dt = torch_dtype(dtype) if isinstance(dtype, str) else dtype
    return map_trees(lambda x: x.to(dt) if x.is_floating_point() else x,
                     tree)


def params_from_numpy(tree, device="cuda"):
    """Carry a parameter (or cache) tree of numpy arrays into the port with
    the same layout: ``{"cell": ...}`` at depth 1, ``{"cells": (...)}``
    deeper, tuples stay tuples (a cache's per-layer ``h``); the LM tree as
    it is (``embed`` (V, D), blocks stacked ``(L, ...)``, the KV cache
    ``(L, B, Hkv, C, hd)``). bfloat16 arrays (numpy's ``ml_dtypes``
    extension type) arrive as ``torch.bfloat16`` bit for bit. Leaves that
    are not arrays (ints, strings, None) pass through."""
    dev = resolve_device(device)

    def leaf(_path, x):
        if isinstance(x, (np.ndarray, np.generic)):
            a = np.array(x)
            if a.dtype.name == "bfloat16":
                return torch.from_numpy(a.view(np.uint16)).view(
                    torch.bfloat16).to(dev)
            return torch.from_numpy(a).to(dev)
        return x
    return _map_tree(leaf, tree)


def state_from_numpy(state, device="cuda") -> dict:
    """Carry a whole train state of numpy arrays (JAX's ``{"params",
    "opt": {"mu", "nu"}, "step", optional "ef"}``) into the port with the
    same layout: every leaf a tensor on ``device``, the params leaf
    tensors that require grad (what the trainer differentiates)."""
    out = params_from_numpy(state, device=device)
    out["params"] = map_trees(
        lambda p: p.detach().requires_grad_(p.is_floating_point()),
        out["params"])
    return out


# ---------------------------------------------------------------------------
# int8 weight rows for the q8 datapath (copied from repro.core.params)
# ---------------------------------------------------------------------------
#
# The paper's AIE lanes MAC int8 weight ROWS against the activation vector.
# A (K, 3H) gate matrix is stored transposed, (3H, K) int8, one contiguous
# row per output element, quantized symmetrically per row
# (``scale_j = max|row_j| / 127``). Activations need no calibration: a GRU
# state is a convex mix of its initial state and tanh outputs, so with
# |h0| <= 1 every h (and r*h) stays in (-1, 1) and the fixed scale 127 is
# exact-range. An int32 sum ``acc = h_q . u_q_row`` stands for
# ``(h*127) . (row / scale_j)``, so ``acc * eff_j`` with
# ``eff_j = scale_j / 127`` dequantizes it; ``eff`` is computed here, once.

ACT_SCALE = 127.0   # fixed activation quantization scale (h in (-1,1))


def quantize_rows_int8(w: torch.Tensor):
    """Symmetric per-output-channel int8 quantization of a (K, N) matrix ->
    ``(q (N, K) int8, eff (N,) float32)``: ``q`` is the transposed matrix
    (one contiguous row per output channel), ``eff`` the dequant scale per
    row with the activation scale folded in (``max|row| / 127 / 127``).
    All-zero rows get scale 1. Rounds half to even, as ``jnp.round``."""
    wt = w.to(torch.float32).t()                             # (N, K)
    scale = wt.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(wt / scale).to(torch.int8).contiguous()
    return q, (scale[:, 0] / ACT_SCALE).to(torch.float32)


@dataclass
class QuantStackParams:
    """The q8 datapath's weight views, built once by ``runtime.prepare``.

    ``cells``: per-layer ``{"u_q" (3H,H) int8, "u_eff" (3H,)}``.
    ``stacked``: the fused q8 kernels' whole-stack views (``{"u_q"
    (L,3H,H), "u_eff" (L,3H), "wd_q" (L-1,3H,H), "wd_eff" (L-1,3H), "b"
    (L,3H)}``; for L=1 ``wd_q`` is the (1,3H,1) placeholder and ``wd_eff``
    (1,3H) zeros, never read), None for heterogeneous stacks."""
    cells: tuple
    stacked: Optional[dict] = None

    def to(self, device) -> "QuantStackParams":
        return QuantStackParams(
            cells=tuple({k: v.to(device) for k, v in c.items()}
                        for c in self.cells),
            stacked=(None if self.stacked is None else
                     {k: v.to(device) for k, v in self.stacked.items()}))


def quantize_gru_cells(cells) -> QuantStackParams:
    """One-time quantization of a GRU stack's recurrent weights, and for
    uniform stacks of the fused kernels' stacked views (the deep layers'
    input projections in int8 too), on the cells' device."""
    cells = tuple(cells)
    per_layer = []
    for c in cells:
        u_q, u_eff = quantize_rows_int8(c["u"])
        per_layer.append({"u_q": u_q, "u_eff": u_eff})
    dims = tuple(c["u"].shape[0] for c in cells)
    stacked = None
    if all(d == dims[0] for d in dims):
        L, H = len(cells), dims[0]
        dev = cells[0]["u"].device
        u_q = torch.stack([p["u_q"] for p in per_layer], 0)      # (L,3H,H)
        u_eff = torch.stack([p["u_eff"] for p in per_layer], 0)  # (L,3H)
        if L > 1:
            wd = [quantize_rows_int8(c["w"]) for c in cells[1:]]
            wd_q = torch.stack([q for q, _ in wd], 0)            # (L-1,3H,H)
            wd_eff = torch.stack([e for _, e in wd], 0)          # (L-1,3H)
        else:
            wd_q = torch.zeros((1, 3 * H, 1), dtype=torch.int8, device=dev)
            wd_eff = torch.zeros((1, 3 * H), dtype=torch.float32, device=dev)
        b = torch.stack([c["b"].to(torch.float32) for c in cells], 0)
        stacked = {"u_q": u_q, "u_eff": u_eff, "wd_q": wd_q,
                   "wd_eff": wd_eff, "b": b}
    return QuantStackParams(cells=tuple(per_layer), stacked=stacked)
