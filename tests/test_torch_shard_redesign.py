"""The redesigned shard kernels' structure, on the CPU: the launch plan of
``gru_shard_matvec``, the three row-wise kernels,
``gru_rowwise_shard_step`` (v3), ``gru_rowwise_shard_zr`` and
``gru_rowwise_shard_candidate`` (the v1 pair), and the v1 cascade's middle
phase ``gru_cascade_shard_zr``
(``repro_torch.kernels.gru_sequence.kernel.shard_plan``), and the direct
route's summation order.

* Legality of the plan at every shape the card runs (``chip_smoke.py``
  phases 3b and 12, the ``gpu`` tests) and at H 64-512 over 1, 2 and 4
  ranks, B 1, 3, 8 and 64, the matvec at N = 2H and 3H: the grid and the
  kernels' index arithmetic (mirrored here) store every output exactly
  once, the slices of a direct-route column read every k exactly once, a
  block stays within 1024 threads and a Hopper block's shared memory, and
  the route is the direct one exactly where the rule says; the v1 pair's
  plans (K = H, N = Hl) likewise, z and r*h each stored once; the
  cascade's middle phase (K = Hl, N = H, and N < Hl) likewise, each z and
  each element of its product stored once.
* The direct route's order of summation, emulated in numpy
  (:func:`direct_matvec`: each slice's k's in order by fma from 0, then
  the fixed butterfly over the slices) and the three row-wise epilogues in
  the kernel's order, and the cascade's r*h formed as its lanes form it,
  against JAX's Pallas ``gru_shard_matvec``, ``gru_rowwise_shard_step``,
  ``gru_rowwise_shard_zr``, ``gru_rowwise_shard_candidate`` and
  ``gru_cascade_shard_zr`` in interpret mode within ``SHARD_TOL``,
  at every slice count. No CUDA kernel runs here: this is the one check of
  the new order that does not need the card.
* The v3 cascade epilogue ``gru_cascade_shard_gates``, which reads its
  gates in place: the wrapper fed gate views of the full (B,3H) arrays
  and the bias equals, bit for bit, the sequence the mesh step ran before
  (psum + b, ``_local_gates``'s copies, the contiguous call) on every rank
  of gru-jet's and gru-jet-deep's meshes, and JAX's kernel within
  ``SHARD_TOL``; the strides it passes the kernel reach each element of
  each view it takes, and it refuses views the kernel cannot read.
* The v1 cascade epilogue ``gru_cascade_shard_update``, which reads its
  candidate's three addends in place: the wrapper fed column slices of
  the psum'd partial, of xp and of b equals, bit for bit, the sequence the
  mesh step ran before (``_ht_in``'s two adds, the contiguous call) on
  every rank of gru-jet's and gru-jet-deep's meshes, and JAX's kernel
  within ``SHARD_TOL``; likewise its strides and the views it refuses.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close
from repro.kernels.gru_sequence import kernel as JK
from repro_torch.core import rowparallel
from repro_torch.kernels._launch import SMEM_LIMIT
from repro_torch.kernels.gru_sequence import kernel as K

SHARD_TOL = 1e-6
MAX_THREADS = 1024
RANKS = (1, 2, 4)
# (H, B) the card runs: phase 3b (B 1, 8), phase 12 (8 slots), the gpu
# tests (B 1, 8, 64; the wide shards at B 1 and 8; B = 3 at Hl = 5)
DRIVEN = ([(H, B) for H in (20, 32) for B in (1, 3, 8, 64)]
          + [(H, B) for H in (64, 256, 512) for B in (1, 8)])
WIDE = [(H, B) for H in (64, 128, 256, 512) for B in (1, 3, 8, 64)]


def _problems(H, n, B):
    """(B, K, G, N) of the two redesigned kernels on one rank of n: the
    matvec at v3's N = 3H and v1's 2H (K = Hl), the step (K = H, N = Hl)."""
    Hl = H // n
    return [(B, Hl, 1, 3 * H), (B, Hl, 1, 2 * H), (B, H, 3, Hl)]


SHAPES = sorted({p for H, B in DRIVEN + WIDE for n in RANKS
                 for p in _problems(H, n, B)})
# the v1 pair's (kind, gates, outputs a launch stores)
V1_KINDS = (("zr", 2, 2), ("candidate", 1, 1))
V1_SHAPES = sorted({(B, H, H // n) for H, B in DRIVEN + WIDE for n in RANKS})


def _stores(p, B, N, outputs=1):
    """How often the launch ``p`` stores each output (B, N) of one gate,
    from the kernels' index arithmetic; with ``outputs`` = 2 (the zr
    kernel's z and r*h, both stored where one is) an (outputs, B, N)
    count."""
    if outputs > 1:
        return np.stack([_stores(p, B, N) for _ in range(outputs)])
    hits = np.zeros((B, N), dtype=np.int64)
    gx, gy = p.grid
    if p.route == "direct":
        cw = 32 // p.slices
        lane = np.arange(32)
        for bx, by, warp in itertools.product(range(gx), range(gy),
                                              range(p.warps)):
            j = (bx * p.warps + warp) * cw + lane % cw
            j = j[(lane // cw == 0) & (j < N)]         # slice 0 stores
            for r in range(p.rows):
                if by * p.rows + r < B:
                    np.add.at(hits[by * p.rows + r], j, 1)
        return hits
    o = np.arange(p.rows * p.ct)                      # the epilogue's loop
    r, c = o // p.ct, o % p.ct
    for tile, by in itertools.product(range(gx), range(gy)):
        jj, row = tile * p.ct + c, by * p.rows + r
        keep = (row < B) & (jj < N)
        np.add.at(hits, (row[keep], jj[keep]), 1)
    return hits


@pytest.mark.parametrize("B,Kc,G,N", SHAPES)
def test_shard_plan_is_legal(B, Kc, G, N):
    for vec in (0, 1):
        p = K.shard_plan(B, Kc, G, N, vec)
        assert p.route == ("direct" if Kc <= K.DIRECT_MAX_K[K.shard_kind(G)]
                           else "tile")
        assert p.threads <= MAX_THREADS and p.smem <= SMEM_LIMIT
        assert (_stores(p, B, N) == 1).all()
        if p.route == "direct":
            assert p.slices in K.SLICES and p.rows in K.DIRECT_ROWS
            assert 1 <= p.warps <= K.DIRECT_MAX_WARPS
            assert p.threads == 32 * p.warps and p.smem == 0
            # every k read by exactly one slice; about SLICE_K k's a lane
            ks = np.concatenate([np.arange(s, Kc, p.slices)
                                 for s in range(p.slices)])
            assert sorted(ks) == list(range(Kc))
            assert p.slices == K.direct_slices(Kc) <= K.MAX_SLICES
            assert (-(-Kc // p.slices) <= K.SLICE_K
                    or p.slices == K.MAX_SLICES)
            assert p.rows == min(2 if G == 3 else 4 if N >= K.WIDE_N else 1,
                                 K._pow2(B))
        else:
            assert p.ct in K.TILE_COLUMNS and p.rows in (1, 2, 4, 8)
            assert p.smem == K.smem_bytes_shard(Kc, p.rows, G, p.ct)
            assert p.vec == vec
            # the largest grid within one wave of the SMs
            grids = [-(-N // ct) * -(-B // bt) for ct in K.TILE_COLUMNS
                     for bt in (1, 2, 4, 8) if bt <= K._pow2(B)
                     and K.smem_bytes_shard(Kc, bt, G, ct) <= SMEM_LIMIT]
            blocks = p.grid[0] * p.grid[1]
            wave = [g for g in grids if g <= K.SHARD_SMS]
            assert blocks == (max(wave) if wave else min(grids))


@pytest.mark.parametrize("kind,G,outputs", V1_KINDS)
@pytest.mark.parametrize("B,H,Hl", V1_SHAPES)
def test_v1_pair_plan_is_legal(kind, G, outputs, B, H, Hl):
    """The zr and candidate kernels' plans: K = H, N = Hl; the direct route
    exactly up to their own DIRECT_MAX_K, the kind's rows and warps."""
    for vec in (0, 1):
        p = K.shard_plan(B, H, G, Hl, vec, kind)
        assert p.route == ("direct" if H <= K.DIRECT_MAX_K[kind] else "tile")
        assert p.threads <= MAX_THREADS and p.smem <= SMEM_LIMIT
        assert (_stores(p, B, Hl, outputs) == 1).all()
        if p.route == "direct":
            assert p.slices == K.direct_slices(H) and p.smem == 0
            assert p.rows == min(K.THREAD_ROWS[kind], K._pow2(B))
            assert p.warps == min(K.DIRECT_WARPS[kind],
                                  K._pow2(-(-Hl // (32 // p.slices))))
            assert p.threads == 32 * p.warps
        else:
            assert p.smem == K.smem_bytes_shard(H, p.rows, G, p.ct)
            assert p.vec == vec


# the cascade's middle phase: (B, K = Hl, N = H) on one rank of n, and two
# shapes whose product is narrower than z (the grid must still cover z)
CZR_SHAPES = sorted({(B, H // n, H) for H, B in DRIVEN + WIDE for n in RANKS}
                    | {(8, 16, 3), (3, 5, 2), (64, 160, 7)})


def _czr_tile_z_stores(p, B, Hl):
    """How often the column tile stores each z: the blocks of column tile
    0 walk the Hl x bt elements of their batch tile."""
    hits = np.zeros((B, Hl), dtype=np.int64)
    for by in range(p.grid[1]):
        i = np.arange(Hl * p.rows)
        row, k = by * p.rows + i % p.rows, i // p.rows
        keep = row < B
        np.add.at(hits, (row[keep], k[keep]), 1)
    return hits


@pytest.mark.parametrize("B,Hl,N", CZR_SHAPES)
def test_cascade_zr_plan_is_legal(B, Hl, N):
    """The v1 cascade's middle phase: the direct route up to its own
    DIRECT_MAX_K over max(N, Hl) columns, z (Hl columns) and the product
    (N) each stored exactly once on either route."""
    for vec in (0, 1):
        p = K.shard_plan(B, Hl, 1, N, vec, "cascade_zr")
        assert p.route == ("direct" if Hl <= K.DIRECT_MAX_K["cascade_zr"]
                           else "tile")
        assert p.threads <= MAX_THREADS and p.smem <= SMEM_LIMIT
        assert (_stores(p, B, N) == 1).all()
        if p.route == "direct":
            assert (_stores(p, B, Hl) == 1).all()
            assert p.slices == K.direct_slices(
                Hl, K.DIRECT_SLICE_K["cascade_zr"]) and p.smem == 0
            assert p.rows == min(K.THREAD_ROWS["cascade_zr"], K._pow2(B))
            assert p.warps == min(K.DIRECT_WARPS["cascade_zr"], K._pow2(
                -(-max(N, Hl) // (32 // p.slices))))
        else:
            assert (_czr_tile_z_stores(p, B, Hl) == 1).all()
            assert p.smem == K.smem_bytes_shard(Hl, p.rows, 1, p.ct)
            assert p.vec == vec


def test_shard_plan_names_the_kind():
    """G alone names the matvec, zr and step kinds; the candidate (one gate,
    like the matvec) is named, and a kind with the wrong gates raises."""
    assert [K.shard_kind(G) for G in (1, 2, 3)] == ["matvec", "zr", "step"]
    assert K.shard_kind(1, "candidate") == "candidate"
    with pytest.raises(ValueError, match="gates"):
        K.shard_plan(8, 32, 3, 16, 0, "candidate")
    # K = 256: past the matvec's direct route, within the candidate's
    assert K.shard_plan(8, 256, 1, 64, 0).route == "tile"
    assert K.shard_plan(8, 256, 1, 64, 0, "candidate").route == "direct"


def test_shard_plan_spreads_the_paper_shapes_over_sms():
    """gru-jet-deep's 2-rank shard at 8 slots: the direct route with one
    block per (row, column group) or more, never one block for all."""
    for B, K_, G, N in _problems(32, 2, 8):
        p = K.shard_plan(B, K_, G, N, 0)
        assert p.route == "direct"
        assert p.grid[0] * p.grid[1] >= B
    for kind, G, _ in V1_KINDS:
        p = K.shard_plan(8, 32, G, 16, 0, kind)
        assert p.route == "direct"
        assert p.grid[0] * p.grid[1] >= 8


def test_shard_plan_raises_where_no_route_fits():
    with pytest.raises(ValueError, match="shared memory"):
        K.shard_plan(1, 100_000, 3, 64, 0)


# ---------------------------------------------------------------------------
# the direct route's summation order against JAX
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """fmaf of float32 arrays: the product is exact in float64, one
    rounding to float32 after the add (as close to a single rounding as
    numpy goes; a double rounding is off by one ulp at most, rarely)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def direct_matvec(x, w, slices):
    """x (B,K) @ w (K,N) summed as a direct-route column is: slice s takes
    k = s, s + S, ... in order by fma from 0; then the butterfly adds
    slice s and s ^ 1, then s ^ 2, ..., and slice 0's sum is stored."""
    B, K_ = x.shape
    part = []
    for s in range(slices):
        acc = np.zeros((B, w.shape[1]), dtype=np.float32)
        for k in range(s, K_, slices):
            acc = _fma(x[:, k:k + 1], w[k:k + 1], acc)
        part.append(acc)
    off = 1
    while off < slices:
        part = [part[s] + part[s ^ off] for s in range(slices)]
        off *= 2
    return part[0]


def _sigmoid(v):
    return np.float32(1) / (np.float32(1) + np.exp(-v))


def direct_step(h_full, h_local, xp, u, b, slices):
    """The v3 row-wise step as the direct kernel computes it: the three
    gate sums by :func:`direct_matvec`, then z, r and the candidate with
    the plain version's adds, (xp + sum) + b and xp + r (sum + b)."""
    Hl = h_local.shape[1]
    a = [direct_matvec(h_full, u[:, g * Hl:(g + 1) * Hl], slices)
         for g in range(3)]
    z = _sigmoid((xp[:, :Hl] + a[0]) + b[:Hl])
    r = _sigmoid((xp[:, Hl:2 * Hl] + a[1]) + b[Hl:2 * Hl])
    ht = np.tanh(xp[:, 2 * Hl:] + r * (a[2] + b[2 * Hl:]))
    return (np.float32(1) - z) * h_local + z * ht


def direct_zr(h_full, h_local, xp, u, b, slices):
    """The v1 phase 1 as the direct kernel computes it: z and r from
    (xp + sum) + b, then z and r * h_local."""
    Hl = h_local.shape[1]
    a = [direct_matvec(h_full, u[:, g * Hl:(g + 1) * Hl], slices)
         for g in range(2)]
    z = _sigmoid((xp[:, :Hl] + a[0]) + b[:Hl])
    r = _sigmoid((xp[:, Hl:] + a[1]) + b[Hl:])
    return z, r * h_local


def direct_candidate(rh_full, h_local, z, xp, u, b, slices):
    """The v1 phase 2 as the direct kernel computes it: tanh((xp + sum) +
    b), then the convex update."""
    ht = np.tanh((xp + direct_matvec(rh_full, u, slices)) + b)
    return (np.float32(1) - z) * h_local + z * ht


def _v1_args(a, Hl):
    """The v1 pair's operands as the mesh path passes them: [z | r] and [h]
    column slices of the shard's (B,3Hl) projection and (H,3Hl) U."""
    zr = (a["h_full"], a["h_local"], a["xp"][:, :2 * Hl], a["u"][:, :2 * Hl],
          a["b"][:2 * Hl])
    cand = (a["rh_full"], a["h_local"], a["z"], a["xp"][:, 2 * Hl:],
            a["u"][:, 2 * Hl:], a["b"][2 * Hl:])
    return zr, cand


def direct_cascade_zr(zr, xp, h, u, slices):
    """The v1 cascade's middle phase as the direct kernel computes it: z =
    sigmoid(xp + zr) of the z gate; each lane's operand r*h =
    sigmoid(xp + zr) * h of the r gate at its k's, summed by
    :func:`direct_matvec`."""
    Hl = h.shape[1]
    z = _sigmoid(xp[:, :Hl] + zr[:, :Hl])
    rh = _sigmoid(xp[:, Hl:] + zr[:, Hl:]) * h
    return z, direct_matvec(rh, u, slices)


def _close_cascade_zr(a, H, slices):
    """The cascade's middle phase's emulation against JAX's interpret-mode
    kernel, on the mesh path's (Hl, H) view of u's candidate rows."""
    args = (a["zr"], a["xp2"], a["h_shard"], a["u_rows"][:, 2 * H:])
    want = JK.gru_cascade_shard_zr(*map(jnp.asarray, args), interpret=True)
    for got, w in zip(direct_cascade_zr(*args, slices), want):
        close(got, w, tol=SHARD_TOL)


def _close_v1(a, Hl, slices):
    """Both v1 kernels' emulations against JAX's interpret-mode kernels."""
    zr, cand = _v1_args(a, Hl)
    want = JK.gru_rowwise_shard_zr(*map(jnp.asarray, zr), interpret=True)
    for got, w in zip(direct_zr(*zr, slices), want):
        close(got, w, tol=SHARD_TOL)
    close(direct_candidate(*cand, slices),
          JK.gru_rowwise_shard_candidate(*map(jnp.asarray, cand),
                                         interpret=True), tol=SHARD_TOL)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _operands(H, n, B, seed):
    """The last rank's operands (numpy), as the mesh path passes them."""
    rng = np.random.default_rng(seed)
    Hl = H // n
    h = _f32(rng, B, H, scale=0.5)
    return dict(h_full=h, h_local=h[:, (n - 1) * Hl:], xp=_f32(rng, B, 3 * Hl),
                u=_f32(rng, H, 3 * Hl, scale=H ** -0.5),
                b=_f32(rng, 3 * Hl, scale=0.3),
                h_shard=_f32(rng, B, Hl, scale=0.5),
                u_rows=_f32(rng, Hl, 3 * H, scale=H ** -0.5),
                rh_full=_f32(rng, B, H, scale=0.5),
                z=(1 / (1 + np.exp(-_f32(rng, B, Hl)))).astype(np.float32),
                zr=_f32(rng, B, 2 * Hl), xp2=_f32(rng, B, 2 * Hl))


# (H, ranks) on the direct route: the paper's widths and two wider ones
ORDER_SHAPES = tuple(itertools.product((20, 32, 64, 128), RANKS))


@pytest.mark.parametrize("H,n", ORDER_SHAPES)
@pytest.mark.parametrize("N", ("3H", "2H"))
def test_direct_matvec_order_matches_pallas(H, n, N):
    a = _operands(H, n, 8, seed=H * 10 + n)
    w = a["u_rows"][:, :3 * H if N == "3H" else 2 * H]
    p = K.shard_plan(8, H // n, 1, w.shape[1], 0)
    assert p.route == "direct"
    want = JK.gru_shard_matvec(jnp.asarray(a["h_shard"]), jnp.asarray(w),
                               interpret=True)
    close(direct_matvec(a["h_shard"], w, p.slices), want, tol=SHARD_TOL)


@pytest.mark.parametrize("H,n", ORDER_SHAPES)
def test_direct_step_order_matches_pallas(H, n):
    a = _operands(H, n, 8, seed=H * 10 + n + 1)
    args = (a["h_full"], a["h_local"], a["xp"], a["u"], a["b"])
    p = K.shard_plan(8, H, 3, H // n, 0)
    assert p.route == "direct"
    want = JK.gru_rowwise_shard_step(*map(jnp.asarray, args), interpret=True)
    close(direct_step(*args, p.slices), want, tol=SHARD_TOL)


@pytest.mark.parametrize("H,n", ORDER_SHAPES)
def test_direct_v1_pair_order_matches_pallas(H, n):
    a = _operands(H, n, 8, seed=H * 10 + n + 2)
    for kind, G, _ in V1_KINDS:
        p = K.shard_plan(8, H, G, H // n, 0, kind)
        assert p.route == "direct"
    _close_v1(a, H // n, K.direct_slices(H))


@pytest.mark.parametrize("H,n", ORDER_SHAPES)
def test_direct_cascade_zr_order_matches_pallas(H, n):
    """At the slices the plan gives the direct route (Hl = 128 plans the
    column tile; the sweep forces the direct route there too)."""
    a = _operands(H, n, 8, seed=H * 10 + n + 3)
    Hl = H // n
    p = K.shard_plan(8, Hl, 1, H, 0, "cascade_zr")
    assert p.route == ("direct" if Hl <= K.DIRECT_MAX_K["cascade_zr"]
                       else "tile")
    _close_cascade_zr(a, H, K.direct_slices(
        Hl, K.DIRECT_SLICE_K["cascade_zr"]))


@pytest.mark.parametrize("slices", K.SLICES)
def test_every_slice_count_sums_within_tolerance(slices):
    """Each slice count the sweep may force (tools/shard_tiles.py), at
    gru-jet-deep's widths, B = 3: the butterfly of 1 to 32 slices, for
    the matvec, the three row-wise kernels and the cascade's middle
    phase."""
    a = _operands(32, 2, 3, seed=slices)
    args = (a["h_full"], a["h_local"], a["xp"], a["u"], a["b"])
    close(direct_step(*args, slices),
          JK.gru_rowwise_shard_step(*map(jnp.asarray, args), interpret=True),
          tol=SHARD_TOL)
    w = a["u_rows"][:, :64]
    close(direct_matvec(a["h_shard"], w, slices),
          JK.gru_shard_matvec(jnp.asarray(a["h_shard"]), jnp.asarray(w),
                              interpret=True), tol=SHARD_TOL)
    _close_v1(a, 16, slices)
    _close_cascade_zr(a, 32, slices)


# ---------------------------------------------------------------------------
# row 16: the v3 cascade epilogue reads its gates in place
# ---------------------------------------------------------------------------

# (H, ranks, this rank, B): every rank of gru-jet's and gru-jet-deep's
# meshes, B 1, 3 and 8
GATES_SHAPES = tuple((H, n, idx, B) for H in (20, 32) for n in RANKS
                     for idx in range(n) for B in (1, 3, 8))


def _full_gates(H, B, seed):
    """The v3 cascade layer's full operands: the psum'd gates g (B,3H), the
    projection xp (B,3H), the bias b (3H,)."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(_f32(rng, B, 3 * H)),
            torch.from_numpy(_f32(rng, B, 3 * H)),
            torch.from_numpy(_f32(rng, 3 * H, scale=0.3)))


@pytest.mark.parametrize("H,n,idx,B", GATES_SHAPES)
def test_cascade_gates_in_place_equal_the_old_sequence(H, n, idx, B):
    """The wrapper on gate views of the full arrays and b's local view
    equals, bit for bit, the sequence the mesh step ran before: psum + b at
    full width, this rank's slices copied out (``_local_gates``), the
    contiguous call; and JAX's kernel on those slices within
    ``SHARD_TOL``."""
    g, xp, b = _full_gates(H, B, seed=100 * H + 10 * n + idx + B)
    Hl = H // n
    h = torch.from_numpy(_f32(np.random.default_rng(idx), B, Hl, scale=0.5))
    K.reset_launch_counts()
    got = K.gru_cascade_shard_gates(
        rowparallel._gate_view(g, 3, H, idx, Hl),
        rowparallel._gate_view(xp, 3, H, idx, Hl), h,
        rowparallel._gate_view(b, 3, H, idx, Hl))
    gl = rowparallel._local_gates(g + b, 3, H, idx, Hl)
    xl = rowparallel._local_gates(xp, 3, H, idx, Hl)
    assert torch.equal(got, K.gru_cascade_shard_gates(gl, xl, h))
    assert K.gru_cascade_shard_gates.launches == 0
    # the local slices and the bias as (3Hl,), the other form it takes
    bl = rowparallel._local_gates(b[None], 3, H, idx, Hl)[0]
    assert torch.equal(got, K.gru_cascade_shard_gates(
        rowparallel._local_gates(g, 3, H, idx, Hl), xl, h, bl))
    close(got, JK.gru_cascade_shard_gates(*map(jnp.asarray, (gl, xl, h)),
                                          interpret=True), tol=SHARD_TOL)


@pytest.mark.parametrize("H,n", tuple(itertools.product((20, 32), RANKS)))
def test_cascade_gates_strides_address_the_views(H, n):
    """The (row stride, gate stride) the wrapper passes the kernel, with
    the view's own offset (its data pointer), reach each element of the
    view: the kernel's g + row * ld + k * gs + c, mirrored here, for gate
    views of (B,3H) arrays, contiguous and row-strided local slices and
    both forms of the bias; and the kernel's one thread an element covers
    each output once."""
    B, Hl = 3, H // n
    g, _, b = _full_gates(H, B, seed=H + n)
    wide = torch.from_numpy(_f32(np.random.default_rng(n), B, 4 * Hl))
    for idx in range(n):
        views = [(rowparallel._gate_view(g, 3, H, idx, Hl), B),
                 (rowparallel._local_gates(g, 3, H, idx, Hl), B),
                 (wide[:, Hl:], B),
                 (rowparallel._gate_view(b, 3, H, idx, Hl), None),
                 (b[:3 * Hl], None)]
        for t, rows in views:
            ld, gs = K._gate_strides("t", t, rows, 3, Hl, t.device)
            flat = t.untyped_storage()
            base = torch.tensor([], dtype=torch.float32).set_(flat)
            r = torch.arange(rows or 1)[:, None, None]
            k = torch.arange(3)[None, :, None]
            c = torch.arange(Hl)[None, None, :]
            at = base[t.storage_offset() + r * ld + k * gs + c]
            want = t.reshape(rows or 1, 3, Hl)
            assert torch.equal(at, want)
    n_out = B * Hl
    threads = 128                                  # kGatesThreads
    i = np.arange(-(-n_out // threads) * threads)
    i = i[i < n_out]
    assert (np.bincount((i // Hl) * Hl + i % Hl, minlength=n_out) == 1).all()


def test_cascade_gates_refuse_what_the_kernel_does_not_take():
    g, xp, b = _full_gates(32, 3, seed=1)
    h = torch.zeros(3, 16)
    gv = rowparallel._gate_view(g, 3, 32, 1, 16)
    xv = rowparallel._gate_view(xp, 3, 32, 1, 16)
    with pytest.raises(ValueError, match="overlap"):    # an expanded row
        K.gru_cascade_shard_gates(gv[:1].expand(3, 3, 16), xv, h)
    with pytest.raises(ValueError, match="overlap"):    # gates overlap
        K.gru_cascade_shard_gates(g.as_strided((3, 3, 16), (96, 8, 1)),
                                  xv, h)
    with pytest.raises(ValueError, match="unit-stride"):
        K.gru_cascade_shard_gates(gv.transpose(1, 2).contiguous()
                                  .transpose(1, 2), xv, h)
    with pytest.raises(ValueError, match="shape"):      # another shard width
        K.gru_cascade_shard_gates(g[:, :40], xv, h)
    with pytest.raises(ValueError, match="shape"):
        K.gru_cascade_shard_gates(gv, xv, h, b[:40])
    with pytest.raises(TypeError):
        K.gru_cascade_shard_gates(gv.double(), xv, h)


# ---------------------------------------------------------------------------
# row 18: the v1 cascade epilogue reads its candidate in place
# ---------------------------------------------------------------------------

def _v1_update_operands(H, n, B, seed):
    """The v1 cascade layer's operands at full width: the psum'd partial
    ht_p (B,H), the projection xp (B,3H), the bias b (3H,); and one rank's
    z and h shard (B,Hl)."""
    rng = np.random.default_rng(seed)
    Hl = H // n
    t = [torch.from_numpy(_f32(rng, *shape, scale=sc)) for shape, sc in (
        ((B, H), 1.0), ((B, 3 * H), 1.0), ((3 * H,), 0.3), ((B, Hl), 1.0),
        ((B, Hl), 0.5))]
    return t[0], t[1], t[2], torch.sigmoid(t[3]), t[4]


def _in_place(ht_p, xp, b, H, idx, Hl):
    """The update's operands as the mesh step passes them: column slices
    of the psum, of xp's candidate gate and of b, no copy."""
    s = 2 * H + idx * Hl
    return (rowparallel._local(ht_p, idx * Hl, Hl),
            rowparallel._local(xp, s, Hl), b[s:s + Hl])


@pytest.mark.parametrize("H,n,idx,B", GATES_SHAPES)
def test_cascade_update_in_place_equals_the_old_sequence(H, n, idx, B):
    """The wrapper on column views of the psum, of xp and of b equals, bit
    for bit, the sequence the mesh step ran before (``_ht_in``'s two adds,
    then the contiguous call), and JAX's kernel on that pre-activation
    within ``SHARD_TOL``."""
    ht_p, xp, b, z, h = _v1_update_operands(H, n, B,
                                            seed=100 * H + 10 * n + idx + B)
    Hl = H // n
    ht_v, xp_v, b_v = _in_place(ht_p, xp, b, H, idx, Hl)
    K.reset_launch_counts()
    got = K.gru_cascade_shard_update(z, ht_v, h, xp_v, b_v)
    ht_in = rowparallel._ht_in(xp, ht_p, b, H, idx, Hl)
    assert torch.equal(got, K.gru_cascade_shard_update(z, ht_in, h))
    assert K.gru_cascade_shard_update.launches == 0
    close(got, JK.gru_cascade_shard_update(*map(jnp.asarray, (z, ht_in, h)),
                                           interpret=True), tol=SHARD_TOL)


@pytest.mark.parametrize("H,n", tuple(itertools.product((20, 32), RANKS)))
def test_cascade_update_strides_address_the_views(H, n):
    """The row stride the wrapper passes the kernel for each operand, with
    the view's own offset (its data pointer), reaches each element of the
    view: the kernel's ht + row * ldt + c (and xp's, b + c), mirrored
    here, for column slices of the (B,H) psum and of the (B,3H) projection,
    a contiguous pre-activation and the bias slice; and the kernel's grid
    (a grid row per batch row, the columns over blocks of whole warps)
    gives each output one thread."""
    B, Hl = 3, H // n
    ht_p, xp, b, _, _ = _v1_update_operands(H, n, B, seed=H + n)
    for idx in range(n):
        ht_v, xp_v, b_v = _in_place(ht_p, xp, b, H, idx, Hl)
        for t, rows in ((ht_v, B), (xp_v, B), (ht_v.contiguous(), B),
                        (b_v, None)):
            ld = K._gate_strides("t", t, rows, 1, Hl, t.device)[0]
            base = torch.tensor([], dtype=torch.float32).set_(
                t.untyped_storage())
            r = torch.arange(rows or 1)[:, None]
            c = torch.arange(Hl)[None, :]
            at = base[t.storage_offset() + r * ld + c]
            assert torch.equal(at, t.reshape(rows or 1, Hl))
    for Hl_ in (Hl, 1, 5, 31, 33, 128, 200, 512):
        threads = min(128, -(-Hl_ // 32) * 32)     # kGatesThreads at most
        assert threads % 32 == 0
        hits = np.zeros((B, Hl_), dtype=np.int64)
        for bx, row, tx in itertools.product(range(-(-Hl_ // threads)),
                                             range(B), range(threads)):
            c = bx * threads + tx
            if c < Hl_:
                hits[row, c] += 1
        assert (hits == 1).all()


def test_cascade_update_refuses_what_the_kernel_does_not_take():
    ht_p, xp, b, z, h = _v1_update_operands(32, 2, 3, seed=1)
    ht_v, xp_v, b_v = _in_place(ht_p, xp, b, 32, 1, 16)
    with pytest.raises(ValueError, match="overlap"):    # an expanded row
        K.gru_cascade_shard_update(z, ht_v[:1].expand(3, 16), h, xp_v, b_v)
    with pytest.raises(ValueError, match="overlap"):    # rows overlap
        K.gru_cascade_shard_update(z, ht_p.as_strided((3, 16), (8, 1)), h)
    with pytest.raises(ValueError, match="overlap"):
        K.gru_cascade_shard_update(z, ht_v, h, xp.as_strided((3, 16), (4, 1)))
    with pytest.raises(ValueError, match="unit-stride"):
        K.gru_cascade_shard_update(z, ht_p[:, :32:2], h)
    with pytest.raises(ValueError, match="unit-stride"):
        K.gru_cascade_shard_update(z, ht_v, h, xp_v, b[:32:2])
    with pytest.raises(ValueError, match="shape"):      # another shard width
        K.gru_cascade_shard_update(z, ht_p[:, :20], h)
    with pytest.raises(ValueError, match="shape"):
        K.gru_cascade_shard_update(z, ht_v, h, xp_v, b[:20])
    with pytest.raises(ValueError, match="shape"):
        K.gru_cascade_shard_update(z, ht_v, h, xp[:2, :16], b_v)
    with pytest.raises(TypeError):
        K.gru_cascade_shard_update(z, ht_v.double(), h)
    with pytest.raises(TypeError):
        K.gru_cascade_shard_update(z, ht_v, h, xp_v, b_v.double())
