"""The single GRU step's new routes, on the CPU: the launch plan of
``gru_step_fused`` and ``gru_step_blocked``
(``repro_torch.kernels.gru_cell.kernel.step_plan``) and the arithmetic of
the warp and wide routes.

* Legality of the plan: every shape ``chip_smoke.py`` phase 11 drives and
  the shapes of ``test_torch_rowwise.py`` take the route the plan names
  (the warp route at H <= 32 for the fused step; past it, and for the
  blocked step always, the wide route for v1 and the column tile for
  v3); the warp route's grid and the wide route's blocks,
  threads and chunks, mirrored from the kernels' index arithmetic, cover
  every (row, column) and every k exactly once; a cooperative grid fits
  one block an SM; a block's shared memory stays within ``SMEM_LIMIT``.
* The orders of summation, emulated step by step in float32
  (:func:`warp_step`: each gate's sum over k in order by fma from 0;
  :func:`wide_step`: each thread's k-slice by fma from 0, the butterfly
  over the lanes of a column group, the warps in order), with each
  kernel's order of additions in the gate math and bf16 rounding of h and
  r*h, against JAX's Pallas ``gru_step_fused`` and ``gru_step_blocked`` in
  interpret mode within ``ORDER_TOL`` and the port's ``gru_step_ref``
  within ``REF_TOL``; v1 and v3, fp32 and bf16 u, ragged H.

No CUDA kernel runs here; the kernels themselves are held against the
plain version and the old column-tile route on the card
(``test_torch_gpu.py``, ``chip_smoke.py`` phase 11, ``tools/step_tiles.py``).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gru_cell.kernel import gru_step_blocked as jblocked
from repro.kernels.gru_cell.kernel import gru_step_fused as jfused
from repro_torch.kernels import _launch
from repro_torch.kernels.gru_cell import kernel as CK
from repro_torch.kernels.gru_cell import ops as cops
from repro_torch.kernels.gru_cell import ref as cref

ORDER_TOL = 1e-6
REF_TOL = 1e-5
# chip_smoke.py's STEP_SHAPES: (B, H, variant, u dtype, the kernel JAX's
# dispatch rule names)
STEP_SHAPES = (
    [(B, H, v, dt, "gru_step_fused") for B in (1, 8) for H in (20, 32)
     for v in ("v1", "v3") for dt in ("float32", "bfloat16")]
    + [(B, H, "v1", "float32", "gru_step_blocked") for B in (1, 8)
       for H in (1024, 2048)]
    + [(B, 2048, "v1", "bfloat16", "gru_step_blocked") for B in (1, 8)]
    + [(B, 1024, "v3", "float32", "gru_step_fused") for B in (1, 8)]
    + [(B, 1000, "v1", "float32", "gru_step_fused") for B in (1, 8)])
# test_torch_rowwise.py's and the card tests' widths and batches
WIDTHS = (7, 20, 31, 32, 33, 64, 100, 128, 1000, 1001, 1024, 2048)
BATCHES = (1, 2, 3, 8, 9, 64)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _expected_route(kernel, B, H, variant, dt):
    if kernel == "gru_step_fused" and H <= CK.STEP_WARP_MAX_H:
        return "warp"
    return "wide" if variant == "v1" else "tile"


def _kernel_for(B, H, variant, dt):
    """The kernel JAX's dispatch rule names (gru_step_cuda's rule)."""
    item = 2 if dt == torch.bfloat16 else 4
    working = (3 * H * H + 7 * B * H) * item
    if working <= 12 * 1024 * 1024 or H % 256 or variant == "v3":
        return "gru_step_fused"
    return "gru_step_blocked"


@pytest.mark.parametrize("B,H,variant,dtype,kernel", STEP_SHAPES)
def test_phase11_shapes_take_the_planned_route(B, H, variant, dtype,
                                               kernel):
    dt = DTYPES[dtype]
    assert _kernel_for(B, H, variant, dt) == kernel
    p = CK.step_plan(B, H, variant, dt, kernel)
    assert p.route == _expected_route(kernel, B, H, variant, dt)
    if H >= 1000 and variant == "v1":
        assert p.route == "wide"
    if H <= 32:
        assert p.route == "warp"


@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("B", BATCHES)
def test_plan_is_legal_at_every_width(B, H):
    for variant, dtype in itertools.product(_launch.VARIANTS, DTYPES):
        dt = DTYPES[dtype]
        for kernel in ("gru_step_fused", "gru_step_blocked"):
            if kernel == "gru_step_blocked" and variant == "v3":
                continue
            p = CK.step_plan(B, H, variant, dt, kernel)
            assert p.route == _expected_route(kernel, B, H, variant, dt)
            assert 0 <= p.smem <= _launch.SMEM_LIMIT
            assert 32 <= p.threads <= 1024 and p.threads % 32 == 0
            if p.route == "warp":
                assert p.smem == 0 and p.warps == min(
                    CK.STEP_WARPS, 1 << max(B - 1, 0).bit_length())
                assert p.threads == 32 * p.warps
                assert p.grid == -(-B // p.warps)
            elif p.route == "wide":
                _check_wide(p, B, H, dt)
            else:
                assert p == CK.tile_step_plan(
                    "blocked" if kernel == "gru_step_blocked" else variant,
                    B, H, dt)


def _check_wide(p, B, H, dt):
    assert p.ct in CK.WIDE_COLS and p.threads == CK.WIDE_THREADS
    assert p.grid == -(-H // p.ct)
    assert p.kc % CK.wide_kc_unit(p.ct) == 0 and p.kc > 0
    assert 2 <= p.stages <= CK.WIDE_MAX_STAGES
    assert p.rows in (1, 2, 4, 8)
    assert p.rows <= min(CK.WIDE_ROWS, 1 << max(B - 1, 0).bit_length())
    assert p.smem == CK.wide_smem(H, p.rows, p.ct, p.kc, p.stages, dt)
    # a thread finishes at most one output of a pass
    assert p.rows * 2 * p.ct <= p.threads
    # the cooperative grid fits one block an SM: the plan's occupancy
    assert p.grid <= CK.SMS and p.smem <= _launch.SMEM_LIMIT


def test_wide_plan_fits_one_wave_at_the_timed_widths():
    """H 1000, 1024 and 2048 spread over about one wave of 132 SMs: the
    narrowest column width whose grid fits, so every SM streams its share
    of U."""
    for H, dt in ((1000, torch.float32), (1024, torch.float32),
                  (2048, torch.float32), (2048, torch.bfloat16)):
        for B in (1, 8):
            p = CK.wide_step_plan(B, H, dt)
            assert 0.9 * CK.SMS <= p.grid <= CK.SMS
            assert p.ct == min(c for c in CK.WIDE_COLS
                               if -(-H // c) <= CK.SMS)


def test_wide_plan_beyond_one_wave_takes_the_column_tile():
    """A grid that cannot be resident at one block an SM (H > 16 * 132)
    has no wide plan, and the blocked step takes the column tile there."""
    assert CK.wide_step_plan(8, 2112, torch.float32) is not None
    assert CK.wide_step_plan(8, 2113, torch.float32) is None
    assert CK.step_plan(8, 4096, "v1", torch.float32, "gru_step_blocked") \
        == CK.tile_step_plan("blocked", 8, 4096, torch.float32)


def _wide_cover(p, B, H):
    """How often the wide route gives each (row, column) of each gate's
    output to a thread (each block's passes over its batch tiles, thread
    t < rows*Q finishing (t // Q, t % Q)), and each row k of U to a chunk
    of each pass (the cursor's walk)."""
    out = np.zeros((2, 3, B, H), dtype=np.int64)   # phase-1 gates z, r; cand
    krow = np.zeros((2, -(-B // p.rows), H), dtype=np.int64)
    cw = p.ct
    for blk in range(p.grid):
        j0 = blk * cw
        for phase, Q in ((1, 2 * cw), (2, cw)):
            for tile in range(-(-B // p.rows)):
                row0 = tile * p.rows
                nrow = min(p.rows, B - row0)
                for t in range(p.threads):
                    r, q = divmod(t, Q)
                    g, jj = divmod(q, cw)
                    if t < p.rows * Q and r < nrow and j0 + jj < H:
                        gate = g if phase == 1 else 2
                        out[phase - 1, gate, row0 + r, j0 + jj] += 1
                if blk == 0:
                    span = p.kc if phase == 1 else 2 * p.kc
                    for k0 in range(0, H, span):
                        krow[phase - 1, tile, k0:min(k0 + span, H)] += 1
    return out, krow


@pytest.mark.parametrize("B,H,dtype", [(1, 20, "float32"), (3, 64, "float32"),
                                       (9, 100, "bfloat16"),
                                       (8, 1000, "float32"),
                                       (2, 1001, "bfloat16"),
                                       (1, 2048, "float32")])
def test_wide_grid_covers_every_output_and_row_once(B, H, dtype):
    p = CK.wide_step_plan(B, H, DTYPES[dtype])
    out, krow = _wide_cover(p, B, H)
    assert (out[0, :2] == 1).all() and not out[0, 2].any()
    assert (out[1, 2] == 1).all() and not out[1, :2].any()
    assert (krow == 1).all()
    # every span is a whole multiple of its pass's slices, so each slice's
    # k's over the pass form one residue class (wide_sums' order)
    assert p.kc % (4 * p.threads // (2 * p.ct)) == 0
    assert (2 * p.kc) % (4 * p.threads // p.ct) == 0


@pytest.mark.parametrize("B", (1, 2, 3, 8, 9, 64, 100))
def test_warp_grid_covers_every_row_once(B):
    for warps in (1, 2, 4, 8):
        p = CK.warp_step_plan(B, warps)
        hits = np.zeros(B, dtype=np.int64)
        for blk, w in itertools.product(range(p.grid), range(p.warps)):
            row = blk * p.warps + w
            if row < B:
                hits[row] += 1
        assert (hits == 1).all()
        assert (p.grid - 1) * p.warps < B          # no block all idle


def test_plan_refuses_what_the_kernels_refuse():
    with pytest.raises(ValueError, match="variant"):
        CK.step_plan(8, 20, "v2", torch.float32)
    with pytest.raises(ValueError, match="empty"):
        CK.step_plan(0, 20, "v1", torch.float32)
    # v3 past the warp route keeps the column tile, which raises where one
    # row of h does not fit a block
    with pytest.raises(ValueError, match="shared"):
        CK.step_plan(1, 60000, "v3", torch.float32)


def test_vec_copies_need_aligned_u():
    u = torch.zeros(3 * 64 * 64 + 1)
    assert CK._vec(64, u[:3 * 64 * 64].view(64, 192)) == 1
    assert CK._vec(64, u[1:].view(64, 192)) == 0
    assert CK._vec(63, torch.zeros(63, 189)) == 0


# ---------------------------------------------------------------------------
# the orders of summation
# ---------------------------------------------------------------------------

def _f32(a):
    return np.asarray(a, dtype=np.float32)


def fma(a, b, c):
    """fmaf in float32: the product exact in float64, one rounding."""
    f64 = np.float64
    return _f32(np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64))


def sigmoid(x):
    x = _f32(x)
    return _f32(np.float32(1.0) / (np.float32(1.0) + np.exp(-x)))


def as_operand(a, dtype):
    t = torch.from_numpy(_f32(a))
    return t.to(DTYPES[dtype]).to(torch.float32).numpy()


def update(z, h, ht):
    """The kernels' fma(1 - z, h, z * ht)."""
    return fma(np.float32(1.0) - z, h, _f32(z * ht))


def warp_step(h, xp, u, b, variant, dtype):
    """The warp route (``gru_step_warp_k``): lane c's sums over k in order
    by fma from 0; z, r: x + (sum + b); v3's candidate x + r*(sum + b);
    v1's (x + sum) + b on r*h rounded to u's dtype."""
    B, H = h.shape
    w = as_operand(u, dtype)
    x_h = as_operand(h, dtype)
    acc = np.zeros((3, B, H), np.float32)
    for k in range(H):
        for g in range(3 if variant == "v3" else 2):
            acc[g] = fma(x_h[:, k:k + 1], w[k, g * H:(g + 1) * H], acc[g])
    z = sigmoid(xp[:, :H] + (acc[0] + b[:H]))
    r = sigmoid(xp[:, H:2 * H] + (acc[1] + b[H:2 * H]))
    if variant == "v3":
        ht = np.tanh(_f32(xp[:, 2 * H:] + _f32(r * (acc[2] + b[2 * H:]))))
    else:
        rh = as_operand(_f32(r * h), dtype)
        for k in range(H):
            acc[2] = fma(rh[:, k:k + 1], w[k, 2 * H:], acc[2])
        ht = np.tanh(_f32(_f32(xp[:, 2 * H:] + acc[2]) + b[2 * H:]))
    return update(z, h, _f32(ht))


def wide_sums(x, w, cw, threads=CK.WIDE_THREADS):
    """The wide route's sums of a pass over Q = w.shape[1] columns (x (B,
    H) operand, w (H, Q) the block's weights, cw columns a gate): thread t
    owns the 4 columns 4*(t % (Q/4)) and the slice s = t // (Q/4) of
    slices = 4*threads/Q, whose k's (s mod slices) it sums in order by fma
    from 0; the lanes of a column group in a warp (consecutive slices) add
    pairwise by the butterfly's rounds (slice bit 0 first); the warps'
    sums add in order from 0."""
    B, H = x.shape
    Q = w.shape[1]
    groups = Q // 4
    slices = 4 * threads // Q
    part = np.zeros((slices, B, Q), np.float32)
    for s in range(min(slices, H)):
        for k in range(s, H, slices):
            part[s] = fma(x[:, k:k + 1], w[k], part[s])
    per_warp = 32 // groups
    warps = threads // 32
    tot = np.zeros((B, Q), np.float32)
    for wp in range(warps):
        level = list(part[wp * per_warp:(wp + 1) * per_warp])
        while len(level) > 1:
            level = [_f32(level[i] + level[i + 1])
                     for i in range(0, len(level), 2)]
        tot = _f32(tot + level[0])
    return tot


def wide_step(h, xp, u, b, dtype, blocked, cw):
    """The wide route (``gru_step_wide_k``) block by block: z and r from
    the z/r pass (the fused step's x + (sum + b), the blocked step's (x +
    sum) + b), r*h rounded to u's dtype, the candidate (x + sum) + b."""
    B, H = h.shape
    w = as_operand(u, dtype)
    x_h = as_operand(h, dtype)
    z = np.zeros((B, H), np.float32)
    rh = np.zeros((B, H), np.float32)
    out = np.zeros((B, H), np.float32)
    for j0 in range(0, H, cw):
        cols = np.arange(j0, min(j0 + cw, H))
        pad = cw - len(cols)
        wz = np.pad(w[:, cols], ((0, 0), (0, pad)))
        wr = np.pad(w[:, H + cols], ((0, 0), (0, pad)))
        s = wide_sums(x_h, np.concatenate([wz, wr], 1), cw)
        for g, dst in ((0, z), (1, None)):
            sg = s[:, g * cw:g * cw + len(cols)]
            xg = xp[:, g * H + cols]
            bg = b[g * H + cols]
            v = sigmoid(_f32(_f32(xg + sg) + bg) if blocked
                        else _f32(xg + _f32(sg + bg)))
            if g == 0:
                z[:, cols] = v
            else:
                rh[:, cols] = as_operand(_f32(v * h[:, cols]), dtype)
    for j0 in range(0, H, cw):
        cols = np.arange(j0, min(j0 + cw, H))
        wh = np.pad(w[:, 2 * H + cols], ((0, 0), (0, cw - len(cols))))
        s = wide_sums(rh, wh, cw)[:, :len(cols)]
        ht = np.tanh(_f32(_f32(xp[:, 2 * H + cols] + s) + b[2 * H + cols]))
        out[:, cols] = update(z[:, cols], h[:, cols], _f32(ht))
    return out


def _step_numpy(B, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H)).astype(np.float32),
            rng.normal(size=(B, 3 * H)).astype(np.float32),
            (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32),
            (0.1 * rng.normal(size=(3 * H,))).astype(np.float32))


def _jax(arrays, dtype):
    j = [jnp.asarray(a) for a in arrays]
    j[2] = j[2].astype(jnp.float32 if dtype == "float32" else jnp.bfloat16)
    return j


def _ref(arrays, dtype, variant):
    t = [torch.from_numpy(a) for a in arrays]
    t[2] = t[2].to(DTYPES[dtype])
    return cref.gru_step_ref(*t, variant).numpy()


def _close(a, b, tol):
    np.testing.assert_allclose(_f32(a), _f32(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H", [(1, 20), (8, 32), (3, 7), (8, 31), (2, 20)])
@pytest.mark.parametrize("variant", ["v1", "v3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_order_matches_jax(B, H, variant, dtype):
    arrays = _step_numpy(B, H, 7 * H + B)
    got = warp_step(*arrays, variant, dtype)
    _close(got, jfused(*_jax(arrays, dtype), variant=variant,
                       interpret=True), ORDER_TOL)
    _close(got, _ref(arrays, dtype, variant), REF_TOL)


@pytest.mark.parametrize("B,H", [(1, 64), (8, 64), (3, 100), (2, 33),
                                 (1, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_order_matches_jax_fused(B, H, dtype):
    """The fused v1 step's wide route at the plan's column width."""
    arrays = _step_numpy(B, H, 11 * H + B)
    cw = CK.wide_step_plan(B, H, DTYPES[dtype]).ct
    got = wide_step(*arrays, dtype, False, cw)
    _close(got, jfused(*_jax(arrays, dtype), variant="v1", interpret=True),
           ORDER_TOL)
    _close(got, _ref(arrays, dtype, "v1"), REF_TOL)


@pytest.mark.parametrize("B,H,block", [(2, 64, 32), (3, 128, 64),
                                       (1, 256, 256), (8, 96, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_order_matches_jax_blocked(B, H, block, dtype):
    """The blocked step's wide route, with its (x + sum) + b."""
    arrays = _step_numpy(B, H, 13 * H + block)
    cw = CK.wide_step_plan(B, H, DTYPES[dtype]).ct
    got = wide_step(*arrays, dtype, True, cw)
    _close(got, jblocked(*_jax(arrays, dtype), block_n=block,
                         interpret=True), ORDER_TOL)
    _close(got, _ref(arrays, dtype, "v1"), REF_TOL)


@pytest.mark.parametrize("cw", CK.WIDE_COLS)
def test_wide_order_at_every_column_width(cw):
    """Each column width's slices and butterfly (the sweep's knob)."""
    arrays = _step_numpy(4, 48, cw)
    got = wide_step(*arrays, "float32", False, cw)
    _close(got, jfused(*_jax(arrays, "float32"), variant="v1",
                       interpret=True), ORDER_TOL)


def test_wide_sums_equal_the_plain_butterfly():
    """The reduce-scatter rounds build the plain butterfly's tree: the
    lanes of a group pair by slice bit 0, then bit 1, ... (a plain
    butterfly written out lane by lane gives the same bits)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 200)).astype(np.float32)
    w = rng.normal(size=(200, 16)).astype(np.float32)
    Q, groups = 16, 4
    slices = 4 * CK.WIDE_THREADS // Q
    part = np.zeros((slices, 2, Q), np.float32)
    for s in range(slices):
        for k in range(s, 200, slices):
            part[s] = fma(x[:, k:k + 1], w[k], part[s])
    lanes = {}
    tot = np.zeros((2, Q), np.float32)
    for wp in range(CK.WIDE_THREADS // 32):
        for lane in range(32):
            lanes[lane] = part[wp * 8 + lane // groups]
        off = groups
        while off < 32:
            lanes = {ln: _f32(v + lanes[ln ^ off]) for ln, v in lanes.items()}
            off *= 2
        tot = _f32(tot + lanes[0])
    assert np.array_equal(tot, wide_sums(x, w, 8))


def test_gru_step_cuda_on_the_cpu_is_the_plain_step():
    """On CPU tensors the entry returns the plain version whatever route
    the plan names (no kernel launches here)."""
    arrays = _step_numpy(2, 64, 5)
    t = [torch.from_numpy(a) for a in arrays]
    for variant in _launch.VARIANTS:
        assert torch.equal(cops.gru_step_cuda(*t, variant),
                           cref.gru_step_ref(*t, variant))
