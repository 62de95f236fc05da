"""The q8 step kernel's two routes, on the CPU: the launch plan of
``gru_step_q8`` (``repro_torch.kernels.gru_cell.kernel.step_q8_plan``) and
the warp route's packing and arithmetic.

* Legality of the plan: every served width (gru-jet's H=20, gru-jet-deep's
  H=32; B 1-64, v1 and v3) and every H <= 32 takes the warp route, wider H
  the block route at the tile the wrapper gave it before; the warp
  route's grid (the kernel's index arithmetic, mirrored here) covers every
  batch row exactly once, and a block stays within the kernel's launch
  bound of 256 threads.
* The warp route's packing, emulated in torch (:func:`shuffle_pack`: each
  lane puts its byte in place, an OR over each group of 4 lanes, one
  broadcast per word): the words equal ``load_rows``'s layout of the same
  int8 vector (byte j of word k is element 4k + j, pad bytes 0), and U's
  rows load to the same words as whole 4-byte words and, at every skew of
  the matrix's start, through the aligned words that cover them.
* The warp route's arithmetic (:func:`warp_step_q8`: q8(h) packed by
  shuffles, each gate sum by ``__dp4a`` over the words, the float32 ops
  in ``gru_q8_math.cuh``'s order): its int32 gate sums equal JAX's
  ``_doti`` on JAX's ``_q8_act`` bit for bit, v1's candidate sum too (on
  the same r); its new state equals the port's plain ``gru_step_q8_ref``
  bit for bit and JAX's ``gru_step_q8`` in interpret mode within ``TOL``
  (torch's and XLA's sigmoid and tanh differ by an ulp or two here, so
  the float32 outputs across frameworks are compared within tolerance).

No CUDA kernel runs here; the kernel's two routes are held against each
other and the plain version on the card (``test_torch_gpu.py``,
``chip_smoke.py``).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close
from repro.core.params import quantize_gru_cells as jquantize_gru_cells
from repro.kernels.gru_cell import kernel as JCK
from repro_torch.kernels import _launch
from repro_torch.kernels.gru_cell import kernel as CK
from repro_torch.kernels.gru_cell import ref as cref

LAUNCH_BOUND = 256          # __launch_bounds__ of the q8 step kernels
LANES = 32
WORDS = CK.STEP_Q8_WARP_MAX_H // 4      # kWarpWords
PACK_H = (1, 5, 19, 20, 31, 32)


@pytest.mark.parametrize("H", (20, 32))
@pytest.mark.parametrize("variant", _launch.VARIANTS)
def test_served_widths_take_the_warp_route(H, variant):
    for B in range(1, 65):
        p = CK.step_q8_plan(B, H, variant)
        assert p.route == "warp" and p.smem == 0 and p.rows == 1
        assert p.warps == min(CK.STEP_Q8_WARPS, 1 << (B - 1).bit_length())
        assert p.threads == 32 * p.warps <= LAUNCH_BOUND
        assert p.grid == -(-B // p.warps)


def test_every_width_up_to_a_warp_takes_the_warp_route():
    for H, B in itertools.product(range(1, CK.STEP_Q8_WARP_MAX_H + 1),
                                  (1, 3, 8)):
        assert CK.step_q8_plan(B, H, "v1").route == "warp"


def _rows_covered(p, B):
    """How often the warp route's grid gives each batch row to a warp (the
    kernel's row = blockIdx.x * warps + warp, below B)."""
    hits = np.zeros(B, dtype=np.int64)
    for blk, warp in itertools.product(range(p.grid), range(p.warps)):
        row = blk * p.warps + warp
        if row < B:
            hits[row] += 1
    return hits


@pytest.mark.parametrize("B", (1, 2, 3, 7, 8, 9, 33, 64, 100, 257))
def test_warp_grid_covers_every_row_once(B):
    for warps in (1, 2, 4, 8):
        p = CK.step_q8_warp_plan(B, warps)
        assert (_rows_covered(p, B) == 1).all()
        assert (p.grid - 1) * p.warps < B          # no all-idle block
        assert p.threads <= LAUNCH_BOUND
    assert (_rows_covered(CK.step_q8_plan(B, 32, "v1"), B) == 1).all()


@pytest.mark.parametrize("H", (33, 40, 64, 100, 256))
def test_wide_h_takes_the_block_route(H):
    for B in (1, 3, 8, 64):
        p = CK.step_q8_plan(B, H, "v3")
        bt = min(B, _launch.DEFAULT_BATCH_BLOCK)
        assert p == CK.step_q8_block_plan(B, H, bt)
        assert p.route == "block" and p.threads == _launch.THREADS
        assert p.grid == -(-B // bt)
        assert p.smem == CK.smem_bytes_step_q8(H, bt) <= _launch.SMEM_LIMIT


def test_plan_raises_on_what_no_route_takes():
    with pytest.raises(ValueError, match="variant"):
        CK.step_q8_plan(8, 20, "v2")
    with pytest.raises(ValueError, match="empty"):
        CK.step_q8_plan(0, 20, "v1")
    with pytest.raises(ValueError, match="shared"):
        CK.step_q8_plan(8, 2048, "v1")


# ---------------------------------------------------------------------------
# the packing
# ---------------------------------------------------------------------------

def load_rows_words(q):
    """``load_rows``'s layout of int8 rows q (N, H): words(H) 4-byte words a
    row, byte j of word k element 4k + j, pad bytes 0 (little-endian)."""
    N, H = q.shape
    nw = -(-H // 4)
    padded = np.zeros((N, 4 * nw), dtype=np.int8)
    padded[:, :H] = q
    return padded.view("<i4")


def shuffle_pack(q):
    """The kernel's ``pack_words`` on each row of int8 q (B, H), one lane per
    element: lane l holds v = byte(q[l]) << 8 (l & 3) (0 past H); v |=
    lane l ^ 1's v, then v |= lane l ^ 2's; word k is lane 4k's v ->
    (B, WORDS) int32."""
    B, H = q.shape
    lane = torch.arange(LANES)
    byte = torch.zeros(B, LANES, dtype=torch.int64)
    byte[:, :H] = torch.as_tensor(q, dtype=torch.int64) & 0xFF
    v = byte << (8 * (lane & 3))
    v = v | v[:, lane ^ 1]
    v = v | v[:, lane ^ 2]
    w = v[:, 4 * torch.arange(WORDS)]
    return ((w + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)  # as int32


def load_row_words(u_q, vec, skew=0, seed=0):
    """The kernel's ``load_row_words`` for every row of u_q (3H, H), stored
    ``skew`` bytes past a 4-byte boundary among foreign bytes (random):
    whole 4-byte words (``vec``: skew 0, H % 4 == 0), or the aligned words
    that cover each row, word k of the row funnel-shifted out of cover
    words k and k + 1, bytes past H masked to 0 -> (3H, WORDS) int32."""
    N, H = u_q.shape
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, size=4 * (-(-(skew + N * H) // 4) + WORDS + 1),
                       dtype=np.uint8)
    buf[skew:skew + N * H] = np.ascontiguousarray(u_q).reshape(-1).view(
        np.uint8)
    cover = buf.view("<u4").astype(np.int64)
    out = np.zeros((N, WORDS), dtype=np.int64)
    for r in range(N):
        at = skew + r * H
        if vec:
            assert at % 4 == 0 and H % 4 == 0
            out[r, :H // 4] = cover[at // 4:at // 4 + H // 4]
            continue
        sk, base, last = at % 4, at // 4, (at % 4 + H - 1) // 4
        a = [cover[base + k] if k <= last else 0 for k in range(WORDS + 1)]
        for k in range(WORDS):
            v = ((a[k + 1] << 32) | a[k]) >> (8 * sk) & 0xFFFFFFFF
            left = H - 4 * k
            out[r, k] = (v if left >= 4 else v & ((1 << (8 * left)) - 1)
                         if left > 0 else 0)
    return torch.from_numpy((out + 2 ** 31) % 2 ** 32 - 2 ** 31).to(
        torch.int32)


def dp4a_dot(a, w):
    """Sum over words of ``__dp4a``: the signed bytes of a (B, WORDS) times
    those of w (N, WORDS) -> (B, N) int32 (exact: int64 here)."""
    def signed_bytes(x):
        x = x.to(torch.int64) & 0xFFFFFFFF
        return torch.stack([((x >> (8 * j)) & 0xFF) for j in range(4)],
                           -1).to(torch.int8).to(torch.int64).flatten(-2)
    return (signed_bytes(a) @ signed_bytes(w).t()).to(torch.int32)


def q8(a):
    """The kernel's ``q8_act``: rint(a * 127) clipped to [-127, 127]."""
    return torch.clamp(torch.round(a * 127.0), -127.0, 127.0).to(torch.int8)


@pytest.mark.parametrize("H", PACK_H)
def test_shuffle_packing_builds_load_rows_layout(H):
    rng = np.random.default_rng(H)
    q = rng.integers(-127, 128, size=(5, H)).astype(np.int8)
    got = shuffle_pack(q)
    nw = -(-H // 4)
    assert torch.equal(got[:, :nw], torch.from_numpy(load_rows_words(q)))
    assert not got[:, nw:].any()                  # pad words are 0


@pytest.mark.parametrize("H", PACK_H)
def test_row_words_equal_load_rows_layout_both_ways(H):
    """U's rows through the cover at every skew of the matrix's start, among
    foreign bytes, and (H % 4 == 0, aligned) as whole words: the layout
    ``load_rows`` gives the block route."""
    rng = np.random.default_rng(100 + H)
    u_q = rng.integers(-127, 128, size=(3 * H, H)).astype(np.int8)
    nw = -(-H // 4)
    want = torch.from_numpy(load_rows_words(u_q))
    for skew in range(4):
        got = load_row_words(u_q, vec=False, skew=skew, seed=skew)
        assert torch.equal(got[:, :nw], want) and not got[:, nw:].any()
    if H % 4 == 0:
        assert torch.equal(load_row_words(u_q, vec=True), got)


# ---------------------------------------------------------------------------
# the warp route's arithmetic
# ---------------------------------------------------------------------------

def warp_step_q8(h, xp, u_q, u_eff, b, variant):
    """The warp route's step, lane by lane as the kernel computes it: q8(h)
    packed by shuffles, each gate's sum by dp4a over the lane's words of U,
    dequant acc * eff + b, z and r from sigmoid(x + g), v3's tanh(x + r
    gh), v1's q8(r * h) packed the same way for the candidate sum, tanh(x
    + cand); the update (1 - z) h + z ht, each op rounded on its own.
    Returns (new state, the int32 gate sums (B, 3H))."""
    H = h.shape[1]
    words = load_row_words(u_q.numpy(), vec=H % 4 == 0)
    qh = shuffle_pack(q8(h))
    acc = dp4a_dot(qh, words)                     # (B, 3H): z, r, h rows
    g = acc.to(torch.float32) * u_eff + b
    xz, xr, xh = xp[:, :H], xp[:, H:2 * H], xp[:, 2 * H:]
    z = torch.sigmoid(xz + g[:, :H])
    r = torch.sigmoid(xr + g[:, H:2 * H])
    if variant == "v3":
        ht = torch.tanh(xh + r * g[:, 2 * H:])
    else:
        cand = dp4a_dot(shuffle_pack(q8(r * h)), words[2 * H:])
        acc = torch.cat([acc[:, :2 * H], cand], 1)
        ht = torch.tanh(xh + (cand.to(torch.float32) * u_eff[2 * H:]
                              + b[2 * H:]))
    return (1.0 - z) * h + z * ht, acc


def _layer(H, B, seed):
    """One layer's float32 state and projection, and JAX-quantized int8
    rows of a random U with their scales."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)
    cell = {"w": jnp.asarray(f32(H, 3 * H, scale=H ** -0.5)),
            "u": jnp.asarray(f32(H, 3 * H, scale=H ** -0.5)),
            "b": jnp.asarray(f32(3 * H, scale=0.3))}
    q = jquantize_gru_cells((cell,)).cells[0]
    return (f32(B, H, scale=0.5), f32(B, 3 * H), np.array(q["u_q"]),
            np.array(q["u_eff"]), np.array(cell["b"]))


@pytest.mark.parametrize("H,B,variant",
                         itertools.product(PACK_H, (1, 3, 8),
                                           _launch.VARIANTS))
def test_warp_step_matches_jax_and_the_plain_version(H, B, variant):
    args = _layer(H, B, seed=10 * H + B)
    t = [torch.from_numpy(a) for a in args]
    got, acc = warp_step_q8(*t, variant)
    h, _, u_q, _, _ = args
    # the int32 sums bit for bit against JAX's integer dot on JAX's q8(h)
    jacc = np.array(JCK._doti(JCK._q8_act(jnp.asarray(h)),
                              jnp.asarray(u_q)))
    if variant == "v1":           # the candidate's sum on the same r * h
        r = torch.sigmoid(t[1][:, H:2 * H] + (acc[:, H:2 * H].to(
            torch.float32) * t[3][H:2 * H] + t[4][H:2 * H]))
        jacc[:, 2 * H:] = np.asarray(JCK._doti(
            JCK._q8_act(jnp.asarray((r * t[0]).numpy())),
            jnp.asarray(u_q[2 * H:])))
    assert np.array_equal(acc.numpy(), jacc)
    # the new state bit for bit against the port's plain version, within
    # TOL of JAX's kernel in interpret mode
    assert torch.equal(got, cref.gru_step_q8_ref(*t, variant))
    close(got, JCK.gru_step_q8(*map(jnp.asarray, args), variant=variant,
                               interpret=True))
    # the wrapper on CPU tensors is that plain version and launches nothing
    CK.gru_step_q8.launches = 0
    assert torch.equal(CK.gru_step_q8(*t, variant=variant), got)
    assert CK.gru_step_q8.launches == 0
