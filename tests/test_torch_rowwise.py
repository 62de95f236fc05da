"""The paper's row-wise primitives in the port, on the CPU, against the JAX
package: the single GRU step (``gru_step_fused``, ``gru_step_blocked`` and
the entry ``gru_step_cuda``) and the row-wise / cascade matmuls
(``rowwise_matmul``, ``cascade_matmul`` and the entries ``rowwise`` /
``cascade``).

* (a) the plain versions behind the step wrappers against JAX's Pallas
  kernels in interpret mode and its ``gru_step_ref``, at JAX's own test
  shapes and one H=1024 blocked step;
* (b) ``gru_step_cuda``'s choice of kernel equal to ``gru_step_pallas``'s
  over a grid that crosses the 12 MiB budget and the divisibility rule
  (JAX's choice recorded by replacing its two kernels in its ``ops``
  module, inside the test only);
* (c) ``rowwise`` / ``cascade`` against JAX's ``ops.rowwise`` /
  ``ops.cascade`` (interpret mode) and ``matmul_ref``, 2-D and 1-D x;
* (d) the port raises exactly where JAX asserts.

Tolerances: fp32 step rtol=atol=1e-5 and fp32 matmuls 2e-4 (different
summation orders and libm), as JAX's kernel tests. With bf16 u both
packages round h and r*h to bf16 before each product, so the bf16 step
is held to 1e-4 against JAX's kernels: tight enough to see a missing
rounding (about 1e-3), while a summation-order difference in r moves
r*h across a bf16 rounding boundary only if r*h lies within one fp32 ulp
of it (about 2**-16 per element; none at these shapes and seeds; the
card's larger shapes allow one such flip, 1e-2). Against JAX's fp32
``gru_step_ref``, which does not round h: 2e-2. bf16 matmuls: 2e-2, as
JAX's tests. Inputs are made from numpy seeds; no kernel launches on the
CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gru_cell import ops as jcops
from repro.kernels.gru_cell import ref as jcref
from repro.kernels.gru_cell.kernel import gru_step_blocked as jblocked
from repro.kernels.gru_cell.kernel import gru_step_fused as jfused
from repro.kernels.rowwise_matvec import kernel as jmk
from repro.kernels.rowwise_matvec import ops as jmops
from repro.kernels.rowwise_matvec import ref as jmref
from repro_torch.kernels.gru_cell import kernel as CK
from repro_torch.kernels.gru_cell import ops as cops
from repro_torch.kernels.gru_cell import ref as cref
from repro_torch.kernels.gru_sequence import kernel as K
from repro_torch.kernels.rowwise_matvec import kernel as MK
from repro_torch.kernels.rowwise_matvec import ops as mops
from repro_torch.kernels.rowwise_matvec import ref as mref

TOL = 1e-5
BF16_STEP_TOL = 1e-4
BF16_STEP_REF_TOL = 2e-2
MM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(actual, expected, tol):
    np.testing.assert_allclose(np.asarray(actual, np.float32),
                               np.asarray(expected, np.float32),
                               rtol=tol, atol=tol)


def _step_numpy(B, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H)).astype(np.float32),
            rng.normal(size=(B, 3 * H)).astype(np.float32),
            (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32),
            (0.1 * rng.normal(size=(3 * H,))).astype(np.float32))


def _both(arrays, dtype):
    """(torch, jax) operands; u (the third) in ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    t = [torch.from_numpy(a) for a in arrays]
    j = [jnp.asarray(a) for a in arrays]
    t[2], j[2] = t[2].to(tdt), j[2].astype(jdt)
    return t, j


def _step_tols(dtype):
    return ((TOL, TOL) if dtype == "float32"
            else (BF16_STEP_TOL, BF16_STEP_REF_TOL))


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launch_counts()
    yield
    assert [f.launches for f in K.ROWWISE_KERNELS] == [0, 0, 0, 0]


# (a) the step's plain versions against JAX's kernels and its oracle

@pytest.mark.parametrize("B,H", [(1, 20), (2, 64), (3, 32)])
@pytest.mark.parametrize("variant", ["v1", "v3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_step_matches_jax(B, H, variant, dtype):
    (h, xp, u, b), (jh, jxp, ju, jb) = _both(_step_numpy(B, H, B * H), dtype)
    out = CK.gru_step_fused(h, xp, u, b, variant=variant)
    assert out.dtype == torch.float32 and out.shape == (B, H)
    kern_tol, ref_tol = _step_tols(dtype)
    _close(out, jfused(jh, jxp, ju, jb, variant=variant, interpret=True),
           kern_tol)
    _close(out, jcref.gru_step_ref(jh, jxp, ju, jb, variant=variant), ref_tol)


@pytest.mark.parametrize("B,H,block", [(2, 64, 32), (2, 64, 16),
                                       (2, 128, 64), (1, 1024, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_step_matches_jax(B, H, block, dtype):
    (h, xp, u, b), (jh, jxp, ju, jb) = _both(_step_numpy(B, H, H + block),
                                             dtype)
    out = CK.gru_step_blocked(h, xp, u, b, block_n=block)
    kern_tol, ref_tol = _step_tols(dtype)
    _close(out, jblocked(jh, jxp, ju, jb, block_n=block, interpret=True),
           kern_tol)
    _close(out, jcref.gru_step_ref(jh, jxp, ju, jb), ref_tol)


def test_bf16_step_rounds_h_and_rh_like_the_kernels():
    """The plain version's bf16 roundings are part of the function: with
    bf16 u it differs from the unrounded fp32 math by more than the fp32
    tolerance, and equals it when u is fp32."""
    h, xp, u, b = (torch.from_numpy(a) for a in _step_numpy(4, 64, 5))
    ub = u.to(torch.bfloat16)
    rounded = cref.gru_step_ref(h, xp, ub, b, "v1")
    unrounded = cref.gru_step_ref(h, xp, ub.float(), b, "v1")
    assert (rounded - unrounded).abs().max().item() > TOL
    assert torch.equal(cref.gru_step_ref(h, xp, u, b, "v1"),
                       CK.gru_step_fused(h, xp, u, b, variant="v1"))


@pytest.mark.parametrize("B,H,variant,block_n", [
    (1, 20, "v1", 256), (8, 32, "v3", 256), (2, 64, "v1", 16),
    (1, 1024, "v1", 256), (1, 1024, "v3", 256)])
def test_gru_step_cuda_matches_gru_step_pallas(B, H, variant, block_n):
    (h, xp, u, b), (jh, jxp, ju, jb) = _both(_step_numpy(B, H, 7 * H),
                                             "float32")
    out = cops.gru_step_cuda(h, xp, u, b, variant, block_n)
    _close(out, jcops.gru_step_pallas(jh, jxp, ju, jb, variant, block_n),
           TOL)


# (b) dispatch: the same shapes reach the same kernel in both packages

DISPATCH_H = (20, 32, 768, 896, 1000, 1022, 1024, 1536, 2048)
DISPATCH_B = (1, 8, 128)
DISPATCH_BLOCK_N = (128, 256, 512)


def _record(monkeypatch, module, names, seen):
    for name in names:
        def rec(*args, _name=name, **kw):
            seen.append(_name)
        monkeypatch.setattr(module, name, rec)


def _choices(monkeypatch, H, variant, dtype):
    """[(JAX's kernel, the port's kernel)] over DISPATCH_B x
    DISPATCH_BLOCK_N; operands are never touched (lazily allocated)."""
    tdt, jdt = DTYPES[dtype]
    names = ("gru_step_fused", "gru_step_blocked")
    jax_seen, port_seen = [], []
    _record(monkeypatch, jcops, names, jax_seen)
    _record(monkeypatch, cops, names, port_seen)
    for B in DISPATCH_B:
        for bn in DISPATCH_BLOCK_N:
            jcops.gru_step_pallas(np.empty((B, H), np.float32),
                                  np.empty((B, 3 * H), np.float32),
                                  np.empty((H, 3 * H), jdt),
                                  np.empty((3 * H,), np.float32), variant, bn)
            cops.gru_step_cuda(torch.empty(B, H), torch.empty(B, 3 * H),
                               torch.empty(H, 3 * H, dtype=tdt),
                               torch.empty(3 * H), variant, bn)
    return list(zip(jax_seen, port_seen))


@pytest.mark.parametrize("H", DISPATCH_H)
@pytest.mark.parametrize("variant", ["v1", "v3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_matches_gru_step_pallas(monkeypatch, H, variant, dtype):
    pairs = _choices(monkeypatch, H, variant, dtype)
    assert len(pairs) == len(DISPATCH_B) * len(DISPATCH_BLOCK_N)
    assert all(j == p for j, p in pairs), pairs


def test_dispatch_grid_crosses_both_rules(monkeypatch):
    """The grid above reaches both kernels, and the fused kernel both under
    the budget and for an H that block_n does not divide."""
    fp32 = [c for H in DISPATCH_H
            for c in _choices(monkeypatch, H, "v1", "float32")]
    assert {j for j, _ in fp32} == {"gru_step_fused", "gru_step_blocked"}
    assert {j for j, _ in _choices(monkeypatch, 1000, "v1", "float32")} \
        == {"gru_step_fused"}
    assert {j for j, _ in _choices(monkeypatch, 2048, "v3", "float32")} \
        == {"gru_step_fused"}
    assert "gru_step_blocked" in {
        j for j, _ in _choices(monkeypatch, 2048, "v1", "bfloat16")}


# (c) the matmul pair against JAX's entries and oracle

MATMUL_SHAPES = [(1, 16, 32), (4, 96, 256), (8, 128, 128), (2, 64, 512)]


def _mm_numpy(B, K_, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, K_)).astype(np.float32),
            rng.normal(size=(K_, N)).astype(np.float32))


@pytest.mark.parametrize("B,K_,N", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vector", [False, True], ids=["2d", "1d"])
def test_rowwise_and_cascade_match_jax(B, K_, N, dtype, vector):
    tdt, jdt = DTYPES[dtype]
    x, w = _mm_numpy(B, K_, N, K_ + N)
    if vector:
        x = x[0]
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    ref = jmref.matmul_ref(jx, jw)
    tol = MM_TOL[dtype]
    for port, jax_fn in ((mops.rowwise, jmops.rowwise),
                         (mops.cascade, jmops.cascade)):
        got = port(tx, tw)
        assert got.dtype == tdt and got.shape == tuple(ref.shape)
        _close(got.float(), jax_fn(jx, jw).astype(jnp.float32), tol)
        _close(got.float(), ref, tol)
    _close(mref.matmul_ref(tx, tw), ref, TOL)


@pytest.mark.parametrize("block", [16, 32, 64])
def test_explicit_blocks_match_jax(block):
    x, w = _mm_numpy(4, 128, 256, block)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    _close(mops.rowwise(tx, tw, block_n=block),
           jmops.rowwise(jx, jw, block_n=block), MM_TOL["float32"])
    _close(mops.cascade(tx, tw, block_k=block),
           jmops.cascade(jx, jw, block_k=block), MM_TOL["float32"])
    assert MK.cascade_matmul(tx, tw, block_k=block).dtype == torch.float32


@pytest.mark.parametrize("B,K_,N", MATMUL_SHAPES + [(3, 40, 36), (12, 8, 24),
                                                   (64, 4096, 4096)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_auto_blocks_equal_jax(B, K_, N, itemsize):
    assert mops.auto_blocks(B, K_, N, itemsize) == \
        jmops.auto_blocks(B, K_, N, itemsize)


# (d) raise exactly where JAX asserts

def _x_w(B, K_, N, K2=None):
    x, w = _mm_numpy(B, K_, N, 0)
    if K2 is not None:
        w = np.random.default_rng(1).normal(size=(K2, N)).astype(np.float32)
    return x, w


RAISE_CASES = [
    # (kernel, B, K, N, K of w, kwargs, JAX asserts)
    ("rowwise", 4, 16, 32, None, {"block_b": 3}, True),
    ("rowwise", 4, 16, 32, 8, {}, True),
    ("rowwise", 2, 16, 48, None, {"block_n": 32}, True),
    ("rowwise", 2, 16, 48, None, {"block_n": 48, "block_b": 1}, False),
    ("rowwise", 2, 16, 32, None, {"block_n": 100}, False),
    ("cascade", 2, 48, 32, None, {"block_k": 32}, True),
    ("cascade", 2, 16, 48, None, {"block_n": 32}, True),
    ("cascade", 4, 16, 32, None, {"block_b": 3}, True),
    ("cascade", 4, 48, 32, None, {"block_k": 100, "block_b": 2}, False),
    ("cascade", 2, 16, 32, 24, {}, True),
]


@pytest.mark.parametrize("kind,B,K_,N,K2,kw,asserts", RAISE_CASES)
def test_matmul_raises_where_jax_asserts(kind, B, K_, N, K2, kw, asserts):
    x, w = _x_w(B, K_, N, K2)
    jfn = jmk.rowwise_matmul if kind == "rowwise" else jmk.cascade_matmul
    tfn = MK.rowwise_matmul if kind == "rowwise" else MK.cascade_matmul
    if asserts:
        with pytest.raises(AssertionError):
            jfn(jnp.asarray(x), jnp.asarray(w), interpret=True, **kw)
        with pytest.raises(ValueError):
            tfn(torch.from_numpy(x), torch.from_numpy(w), **kw)
    else:
        want = jfn(jnp.asarray(x), jnp.asarray(w), interpret=True, **kw)
        _close(tfn(torch.from_numpy(x), torch.from_numpy(w), **kw), want,
               MM_TOL["float32"])


@pytest.mark.parametrize("H,block,asserts", [(64, 48, True), (64, 128, False),
                                             (96, 64, True), (96, 32, False)])
def test_blocked_step_raises_where_jax_asserts(H, block, asserts):
    (h, xp, u, b), (jh, jxp, ju, jb) = _both(_step_numpy(2, H, 3), "float32")
    if asserts:
        with pytest.raises(AssertionError):
            jblocked(jh, jxp, ju, jb, block_n=block, interpret=True)
        with pytest.raises(ValueError):
            CK.gru_step_blocked(h, xp, u, b, block_n=block)
    else:
        _close(CK.gru_step_blocked(h, xp, u, b, block_n=block),
               jblocked(jh, jxp, ju, jb, block_n=block, interpret=True), TOL)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    h, xp, u, b = (torch.from_numpy(a) for a in _step_numpy(2, 32, 0))
    with pytest.raises(TypeError):
        CK.gru_step_fused(h, xp, u.to(torch.float16), b)
    with pytest.raises(TypeError):
        CK.gru_step_fused(h.to(torch.bfloat16), xp, u, b)
    with pytest.raises(ValueError):
        CK.gru_step_fused(h, xp, u, b, variant="v2")
    with pytest.raises(ValueError):
        CK.gru_step_blocked(h, xp[:, :64], u, b, block_n=16)
    with pytest.raises(ValueError):
        CK.gru_step_fused(h, xp, u.t().contiguous().t(), b)
    x, w = torch.randn(2, 16), torch.randn(16, 8)
    with pytest.raises(TypeError):
        MK.rowwise_matmul(x, w.to(torch.bfloat16))
    with pytest.raises(TypeError):
        MK.cascade_matmul(x.half(), w.half())
    with pytest.raises(ValueError):
        MK.rowwise_matmul(x, w.t().contiguous().t())
    with pytest.raises(ValueError):
        MK.rowwise_matmul(x[0], w)
