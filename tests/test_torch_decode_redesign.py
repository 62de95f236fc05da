"""The fused decode kernels' two routes, on the CPU: the launch plans of
``gru_stack_decode_kernel`` and ``gru_stack_decode_q8_kernel``
(``repro_torch.kernels.gru_sequence.kernel.decode_plan`` and
``decode_q8_plan``) and the warp routes' arithmetic.

* Legality of the plans: every served shape (gru-jet's L=1 H=20,
  gru-jet-deep's L=3 H=32; B 1-64; v1 and v3) and every H <= 32 within
  the layer bound takes the warp route; wider H, L past the bound (fp32:
  the deepest stack measured on the card, q8: the layers a lane holds in
  registers) or a nonzero ``batch_block`` take the block route at the
  tile the wrapper gave it before; the warp grid (the kernel's index
  arithmetic, mirrored here) covers every batch row exactly once; a block
  stays within the kernels' launch bound of 256 threads; the warp routes
  ask for no dynamic shared memory (the fp32 route's broadcast slots, 32
  floats a warp, are 1 KB of static shared memory).
* The fp32 warp route's arithmetic, emulated in numpy
  (:func:`warp_decode`: each gate's sum over k in order by fma from 0, the
  deep projection the same way, the epilogues and the update in the
  kernel's order) against JAX's ``gru_stack_decode_ref`` and the ``xla``
  decode backend within ``DECODE_TOL``, and the port's plain version
  within the same.
* The q8 warp route's arithmetic (:func:`warp_decode_q8`: q8(h) packed by
  shuffles in ``load_rows``'s layout, each gate sum and each deep
  projection sum by ``__dp4a`` over the words): its int32 sums equal
  JAX's ``_doti`` on JAX's ``_q8_act`` bit for bit, layer by layer; its
  states equal the port's plain ``gru_stack_decode_q8_ref`` bit for bit
  and JAX's ``gru_stack_decode_q8_ref`` within ``TOL`` (torch's and XLA's
  sigmoid and tanh differ by an ulp or two).

JAX's fused Pallas decode kernels raise under this jax (ROADMAP caveat
R1), so they are not the oracle here. No CUDA kernel runs here; the
routes are held against each other and the plain versions on the card
(``test_torch_gpu.py``, ``chip_smoke.py``, ``tools/decode_tiles.py``).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, close
from repro.configs.base import GRUConfig as JCfg
from repro.core import gru as jgru
from repro.core.params import quantize_gru_cells as jquantize_gru_cells
from repro.kernels.gru_cell import kernel as JCK
from repro.kernels.gru_sequence import ref as jref
from repro_torch.kernels import _launch
from repro_torch.kernels.gru_sequence import kernel as K
from repro_torch.kernels.gru_sequence import ref
from test_torch_step_q8_redesign import (dp4a_dot, load_row_words, q8,
                                         shuffle_pack)

DECODE_TOL = 2e-6            # fp32 emulation vs JAX: libm and one rounding
LAUNCH_BOUND = 256           # __launch_bounds__ of the decode kernels
SERVED = (((1, 20), (3, 32)), range(1, 65), _launch.VARIANTS)
PLANS = {"fp32": (K.decode_plan, K.DECODE_WARP_MAX_L, False),
         "q8": (K.decode_q8_plan, K.DECODE_Q8_WARP_MAX_L, True)}


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("LH", SERVED[0])
def test_served_shapes_take_the_warp_route(kind, LH):
    planner, _, q8_ = PLANS[kind]
    L, H = LH
    for B, variant in itertools.product(SERVED[1], SERVED[2]):
        p = planner(B, H, L, variant)
        assert p.route == "warp" and p.rows == 1
        warps = K.DECODE_Q8_WARPS if q8_ else K.DECODE_WARPS
        assert p.warps == min(warps, K._pow2(B))
        assert p.threads == 32 * p.warps <= LAUNCH_BOUND
        assert p.grid == -(-B // p.warps)
        assert p.smem == 0


@pytest.mark.parametrize("kind", PLANS)
def test_every_width_and_depth_within_the_bound_takes_the_warp_route(kind):
    planner, max_l, _ = PLANS[kind]
    for H, L, B in itertools.product(range(1, K.WARP_MAX_H + 1),
                                     range(1, max_l + 1), (1, 3, 8)):
        assert planner(B, H, L, "v1").route == "warp"


def _block(B, H, L, bt, q8_):
    p = K.decode_block_plan(B, H, L, bt, q8_)
    assert p.route == "block" and p.threads == _launch.THREADS
    assert p.grid == -(-B // bt)
    smem = K.smem_bytes_q8 if q8_ else K.smem_bytes
    assert p.smem == smem(L, H, bt) <= _launch.SMEM_LIMIT
    return p


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("H", (33, 40, 64, 100))
def test_wide_h_takes_the_block_route_at_the_old_tile(kind, H):
    planner, _, q8_ = PLANS[kind]
    smem = K.smem_bytes_q8 if q8_ else K.smem_bytes
    for B, L in itertools.product((1, 3, 8, 64), (1, 3)):
        bt = min(B, K.DEFAULT_BATCH_BLOCK)
        if smem(L, H, bt) > _launch.SMEM_LIMIT:     # as the wrapper raised
            with pytest.raises(ValueError, match="shared"):
                planner(B, H, L, "v1")
            continue
        assert planner(B, H, L, "v1") == _block(B, H, L, bt, q8_)


@pytest.mark.parametrize("kind", PLANS)
def test_depth_past_the_bound_takes_the_block_route(kind):
    planner, max_l, q8_ = PLANS[kind]
    smem = K.smem_bytes_q8 if q8_ else K.smem_bytes
    for H, B, L in itertools.product((5, 20, 32), (1, 8, 64),
                                     (max_l + 1, max_l + 2)):
        bt = min(B, K.DEFAULT_BATCH_BLOCK)
        if smem(L, H, bt) > _launch.SMEM_LIMIT:     # as the wrapper raised
            with pytest.raises(ValueError, match="shared"):
                planner(B, H, L, "v3")
            continue
        assert planner(B, H, L, "v3") == _block(B, H, L, bt, q8_)


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("batch_block", (1, 2, 8, 64))
def test_a_nonzero_batch_block_selects_the_block_route(kind, batch_block):
    planner, _, q8_ = PLANS[kind]
    for (L, H), B in itertools.product(SERVED[0], (1, 8, 64)):
        assert planner(B, H, L, "v1", batch_block) == _block(
            B, H, L, batch_block, q8_)


def _rows_covered(p, B):
    """How often the warp route's grid gives each batch row to a warp (the
    kernels' row = blockIdx.x * warps + warp, below B)."""
    hits = np.zeros(B, dtype=np.int64)
    for blk, warp in itertools.product(range(p.grid), range(p.warps)):
        row = blk * p.warps + warp
        if row < B:
            hits[row] += 1
    return hits


@pytest.mark.parametrize("B", (1, 2, 3, 7, 8, 9, 33, 64, 100, 257))
def test_warp_grid_covers_every_row_once(B):
    for warps in (1, 2, 4, 8):
        p = K.decode_warp_plan(B, warps)
        assert (_rows_covered(p, B) == 1).all()
        assert (p.grid - 1) * p.warps < B          # no all-idle block
        assert p.threads <= LAUNCH_BOUND
    for planner in (K.decode_plan, K.decode_q8_plan):
        assert (_rows_covered(planner(B, 32, 3, "v1"), B) == 1).all()


def test_fp32_warp_route_shared_memory_fits_every_depth():
    """Neither warp route asks for dynamic shared memory at any width,
    depth or warp count within its bounds: the fp32 route's only shared
    memory is each warp's 32-float broadcast slot, 8 warps' worth (1 KB)
    declared static, and the q8 route uses none."""
    for H, L, warps in itertools.product(range(1, K.WARP_MAX_H + 1),
                                         range(1, K.DECODE_WARP_MAX_L + 1),
                                         (1, 2, 4, 8)):
        assert K.decode_warp_plan(8, warps).smem == 0
        assert K.decode_plan(8, H, L, "v1").smem == 0
        assert K.decode_q8_plan(8, H, min(L, K.DECODE_Q8_WARP_MAX_L),
                                "v1").smem == 0


def test_warp_depth_bounds_cover_the_served_and_swept_depths():
    """The fp32 warp route takes the depths swept and held bit for bit
    against the block route on the card (L 1-4, tools/decode_tiles.py and
    the gpu tests), no deeper; the q8 route the layers it holds in
    registers (L 1-3). Both cover every served depth (gru-jet's 1,
    gru-jet-deep's 3)."""
    assert K.DECODE_WARP_MAX_L == 4 and K.DECODE_Q8_WARP_MAX_L == 3
    for L in (1, 3):
        assert K.decode_plan(8, 32, L, "v1").route == "warp"
        assert K.decode_q8_plan(8, 32, L, "v1").route == "warp"
    assert K.decode_plan(8, 32, 5, "v1").route == "block"
    assert K.decode_q8_plan(8, 32, 4, "v1").route == "block"


def test_plans_raise_on_what_no_route_takes():
    for planner in (K.decode_plan, K.decode_q8_plan):
        with pytest.raises(ValueError, match="variant"):
            planner(8, 20, 1, "v2")
        with pytest.raises(ValueError, match="empty"):
            planner(0, 20, 1, "v1")
        with pytest.raises(ValueError, match="batch_block"):
            planner(8, 20, 1, "v1", 300)
    with pytest.raises(ValueError, match="shared"):
        K.decode_plan(8, 200, 3, "v1")
    with pytest.raises(ValueError, match="shared"):
        K.decode_q8_plan(8, 2048, 3, "v1")


# ---------------------------------------------------------------------------
# the fp32 warp route's arithmetic
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """fmaf of float32 arrays: the product exact in float64, one rounding
    to float32 after the add (a double rounding is off by one ulp at most,
    rarely)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _sigmoid(v):
    return np.float32(1) / (np.float32(1) + np.exp(-v))


def _lane_sum(v, w):
    """sum_k v[:, k] * w[k, :] as a lane of the warp route takes it: k in
    order by fma from 0 (v is what the shuffles broadcast)."""
    acc = np.zeros((v.shape[0], w.shape[1]), dtype=np.float32)
    for k in range(v.shape[1]):
        acc = _fma(v[:, k:k + 1], w[k:k + 1], acc)
    return acc


def warp_decode(h, xp, u, wd, b, variant):
    """The fp32 warp route's arithmetic, layer by layer: z and r (and v3's
    candidate) from :func:`_lane_sum` of h, then x + (sum + b); v1's
    candidate from the sum of r*h, (x + sum) + b; v3's x + r (sum + b);
    the update fma(1 - z, h, z*ht); the next layer's x the lane sum of the
    new h against W_l. Returns (L,B,H)."""
    L, _, H = h.shape
    x, out = xp.astype(np.float32), []
    for l in range(L):
        hl, ul, bl = h[l], u[l], b[l]
        zs, rs = _lane_sum(hl, ul[:, :H]), _lane_sum(hl, ul[:, H:2 * H])
        z = _sigmoid(x[:, :H] + (zs + bl[:H]))
        r = _sigmoid(x[:, H:2 * H] + (rs + bl[H:2 * H]))
        if variant == "v3":
            ht = np.tanh(x[:, 2 * H:] + r * (_lane_sum(hl, ul[:, 2 * H:])
                                             + bl[2 * H:]))
        else:
            ht = np.tanh((x[:, 2 * H:] + _lane_sum(r * hl, ul[:, 2 * H:]))
                         + bl[2 * H:])
        hn = _fma(np.float32(1) - z, hl, (z * ht).astype(np.float32))
        out.append(hn)
        if l + 1 < L:
            x = _lane_sum(hn, wd[l])
    return np.stack(out)


def _arrays(L, H, B, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(h=rng.normal(scale=0.5, size=(L, B, H)).astype(f),
                xp=rng.normal(size=(B, 3 * H)).astype(f),
                u=(rng.normal(size=(L, H, 3 * H)) / np.sqrt(H)).astype(f),
                wd=(rng.normal(size=(max(L - 1, 1), H, 3 * H))
                    / np.sqrt(H)).astype(f),
                b=rng.normal(scale=0.3, size=(L, 3 * H)).astype(f))


@pytest.mark.parametrize("L,H", ((1, 5), (1, 20), (2, 31), (3, 32),
                                 (4, 20)))
@pytest.mark.parametrize("B", (1, 3))
@pytest.mark.parametrize("variant", _launch.VARIANTS)
def test_fp32_warp_order_matches_jax_and_the_plain_version(L, H, B,
                                                           variant):
    a = _arrays(L, H, B, seed=100 * L + H + B)
    wd = a["wd"] if L > 1 else np.zeros((1, 1, 3 * H), np.float32)
    got = warp_decode(a["h"], a["xp"], a["u"], a["wd"], a["b"], variant)
    want = jref.gru_stack_decode_ref(*(jnp.asarray(v) for v in (
        a["h"], a["xp"], a["u"], wd, a["b"])), variant=variant)
    close(got, want, tol=DECODE_TOL)
    t = [torch.from_numpy(v) for v in (a["h"], a["xp"], a["u"], wd, a["b"])]
    close(got, ref.gru_stack_decode_ref(*t, variant), tol=DECODE_TOL)
    # the wrapper on CPU tensors is that plain version and launches nothing
    K.gru_stack_decode_kernel.launches = 0
    assert torch.equal(K.gru_stack_decode_kernel(*t, variant=variant),
                       ref.gru_stack_decode_ref(*t, variant))
    assert K.gru_stack_decode_kernel.launches == 0
    assert K.decode_plan(B, H, L, variant).route == "warp"


@pytest.mark.parametrize("L", (1, 3))
@pytest.mark.parametrize("variant", _launch.VARIANTS)
def test_fp32_warp_order_matches_the_xla_decode_backend(L, variant):
    """The same step from cells, through JAX's ``xla`` decode backend (each
    layer's x @ W by XLA): the stacked views' W_deep are the deep cells'
    w, layer 0's projection given."""
    H, X, B = 32, 5, 3
    a = _arrays(L, H, B, seed=7 + L)
    rng = np.random.default_rng(8)
    w0 = rng.normal(size=(X, 3 * H)).astype(np.float32)
    x = rng.normal(size=(B, X)).astype(np.float32)
    cells = tuple({"w": w0 if l == 0 else a["wd"][l - 1], "u": a["u"][l],
                   "b": a["b"][l]} for l in range(L))
    cfg = JCfg(input_dim=X, hidden_dim=H, num_layers=L, variant=variant)
    xla = jgru.gru_stack_decode_xla(
        tuple({k: jnp.asarray(v) for k, v in c.items()} for c in cells),
        tuple(jnp.asarray(h) for h in a["h"]), jnp.asarray(x), cfg=cfg)
    got = warp_decode(a["h"], x @ w0, a["u"], a["wd"], a["b"], variant)
    close(got, np.stack([np.asarray(h) for h in xla]), tol=TOL)


# ---------------------------------------------------------------------------
# the q8 warp route's arithmetic
# ---------------------------------------------------------------------------

def warp_decode_q8(h, xp, u_q, u_eff, wd_q, wd_eff, b, variant):
    """The q8 warp route, layer by layer as the kernel computes it: each
    layer is row 7's warp step (q8(h) packed by shuffles, dp4a gate sums
    over the lane's words of U_l, dequant acc * eff + b, z and r, v3's
    tanh(x + r gh), v1's q8(r * h) packed for the candidate, the update,
    each op rounded on its own); the next layer's x is q8(h') packed the
    same way, dp4a against the words of W_l, times its eff. Returns the
    states (L,B,H) and, per layer, the int32 sums: the gates' (B,3H; v1's
    candidate on q8(r*h)) and the deep projection's (B,3H)."""
    L, _, H = h.shape
    x, out, sums = xp, [], []
    for l in range(L):
        words = load_row_words(u_q[l].numpy(), vec=H % 4 == 0)
        hl = h[l]
        acc = dp4a_dot(shuffle_pack(q8(hl)), words)
        g = acc.to(torch.float32) * u_eff[l] + b[l]
        z = torch.sigmoid(x[:, :H] + g[:, :H])
        r = torch.sigmoid(x[:, H:2 * H] + g[:, H:2 * H])
        if variant == "v3":
            ht = torch.tanh(x[:, 2 * H:] + r * g[:, 2 * H:])
        else:
            cand = dp4a_dot(shuffle_pack(q8(r * hl)), words[2 * H:])
            acc = torch.cat([acc[:, :2 * H], cand], 1)
            ht = torch.tanh(x[:, 2 * H:] + (cand.to(torch.float32)
                                            * u_eff[l][2 * H:]
                                            + b[l][2 * H:]))
        hn = (1.0 - z) * hl + z * ht
        out.append(hn)
        deep = None
        if l + 1 < L:
            deep = dp4a_dot(shuffle_pack(q8(hn)),
                            load_row_words(wd_q[l].numpy(), vec=H % 4 == 0))
            x = deep.to(torch.float32) * wd_eff[l]
        sums.append((acc, deep))
    return torch.stack(out), sums


def _q8_operands(L, H, B, seed):
    """Float32 states and projection, and JAX-quantized int8 rows of random
    U and deep W with their scales (the fused q8 kernels' stacked views)."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)
    cells = tuple({"w": jnp.asarray(f32(H, 3 * H, scale=H ** -0.5)),
                   "u": jnp.asarray(f32(H, 3 * H, scale=H ** -0.5)),
                   "b": jnp.asarray(f32(3 * H, scale=0.3))}
                  for _ in range(L))
    st = jquantize_gru_cells(cells).stacked
    return (f32(L, B, H, scale=0.5), f32(B, 3 * H),
            *(np.array(st[k]) for k in ("u_q", "u_eff", "wd_q", "wd_eff",
                                        "b")))


@pytest.mark.parametrize("L,H", ((1, 1), (1, 20), (2, 5), (3, 31),
                                 (3, 32)))
@pytest.mark.parametrize("B", (1, 3, 8))
@pytest.mark.parametrize("variant", _launch.VARIANTS)
def test_q8_warp_route_matches_jax_and_the_plain_version(L, H, B, variant):
    args = _q8_operands(L, H, B, seed=10 * H + L + B)
    t = [torch.from_numpy(a) for a in args]
    got, sums = warp_decode_q8(*t, variant)
    h, _, u_q, _, wd_q, _, _ = args
    # the int32 sums bit for bit against JAX's integer dot on JAX's q8,
    # layer by layer, on the states the route computed
    for l, (acc, deep) in enumerate(sums):
        jacc = np.array(JCK._doti(JCK._q8_act(jnp.asarray(h[l])),
                                  jnp.asarray(u_q[l])))
        if variant == "v1":       # the candidate's sum on the same r * h
            x = t[1] if l == 0 else sums[l - 1][1].to(torch.float32) * t[5][
                l - 1]
            r = torch.sigmoid(x[:, H:2 * H] + (acc[:, H:2 * H].to(
                torch.float32) * t[3][l][H:2 * H] + t[6][l][H:2 * H]))
            jacc[:, 2 * H:] = np.asarray(JCK._doti(
                JCK._q8_act(jnp.asarray((r * t[0][l]).numpy())),
                jnp.asarray(u_q[l][2 * H:])))
        assert np.array_equal(acc.numpy(), jacc)
        if deep is not None:
            jdeep = JCK._doti(JCK._q8_act(jnp.asarray(got[l].numpy())),
                              jnp.asarray(wd_q[l]))
            assert np.array_equal(deep.numpy(), np.asarray(jdeep))
    # the states bit for bit against the port's plain version, within TOL
    # of JAX's oracle
    plain = ref.gru_stack_decode_q8_ref(*t, variant)
    assert torch.equal(got, plain)
    close(got, jref.gru_stack_decode_q8_ref(*map(jnp.asarray, args),
                                            variant=variant))
    # the wrapper on CPU tensors is that plain version and launches nothing
    K.gru_stack_decode_q8_kernel.launches = 0
    assert torch.equal(K.gru_stack_decode_q8_kernel(*t, variant=variant),
                       plain)
    assert K.gru_stack_decode_q8_kernel.launches == 0
    assert K.decode_q8_plan(B, H, L, variant).route == "warp"


def test_q8_word_loads_need_whole_aligned_rows():
    """The route loads the int8 rows as 4-byte words only where H % 4 == 0
    and both u_q and wd_q start on a 4-byte boundary; else through the
    aligned words that cover them (both give ``load_rows``'s layout:
    ``test_torch_step_q8_redesign``)."""
    u = torch.zeros(3 * 3 * 32 * 32 + 4, dtype=torch.int8)
    w = torch.zeros(2 * 3 * 32 * 32 + 4, dtype=torch.int8)
    assert K.decode_q8_words(32, u, w) == int(u.data_ptr() % 4 == 0
                                              and w.data_ptr() % 4 == 0)
    assert K.decode_q8_words(20, u[4:], w[4:]) == K.decode_q8_words(32, u,
                                                                   w)
    assert K.decode_q8_words(31, u, w) == 0
    assert K.decode_q8_words(32, u[1:], w) == 0
    assert K.decode_q8_words(32, u, w[2:]) == 0
