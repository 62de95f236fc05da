"""The depth-1 sequence kernel's two routes, on the CPU: the launch plan of
``gru_sequence_kernel`` (``repro_torch.kernels.gru_sequence.kernel.
seq_plan``) and the warp route's arithmetic and prefetch schedule.

* Legality of the plan: every served shape (gru-jet's H=20, gru-jet-deep's
  H=32, the heterogeneous chain's 32/32/20; the engine's batch and prompt
  buckets) takes the warp route, wider H the block route at the tile the
  wrapper gave it before; the warp route's grid (the kernel's index
  arithmetic, mirrored here) covers every batch row exactly once; a block
  stays within 1024 threads; a lane's U columns and its prefetch ring fit
  a thread's registers.
* The warp route's order of summation, emulated in numpy
  (:func:`warp_sequence`: each gate's sum over k in order by fma from 0,
  the epilogues in the kernel's order, a dead step keeping h), against
  JAX's Pallas ``gru_sequence_kernel`` in interpret mode within
  ``SEQ_TOL``, v1 and v3, masked and not.
* The prefetch ring as a pure index model (:func:`ring_events`, the
  kernel's loop): each step's xp and mask slot is issued before it is read
  and is not overwritten before it is read, at every T and every depth the
  plan can choose.

No CUDA kernel runs here; the kernels themselves are held against the
plain version on the card (``test_torch_gpu.py``, ``chip_smoke.py``).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import close
from repro.kernels.gru_sequence.kernel import gru_sequence_kernel as jseq
from repro_torch.kernels import _launch
from repro_torch.kernels.gru_sequence import kernel as K

SEQ_TOL = 1e-6
MAX_THREADS = 1024
REGISTERS = 255             # a thread's most registers (sm_90)
# the engine's served shapes: widths of the three configs, batch up to the
# 8 slots (and the wide batches the tests drive), T = 1 for a decode layer
# and the prompt buckets
SERVED = list(itertools.product((20, 32), (1, 2, 3, 5, 8, 64),
                                (1, 2, 4, 8, 16, 32, 64)))


@pytest.mark.parametrize("H,B,T", SERVED)
def test_served_shapes_take_the_warp_route(H, B, T):
    for variant in _launch.VARIANTS:
        p = K.seq_plan(B, T, H, variant)
        assert p.route == "warp" and p.smem == 0
        assert p.rows in K.WARP_ROW_CHOICES and p.depth in K.WARP_DEPTHS
        assert 1 <= p.warps <= MAX_THREADS // 32
        assert p.threads == 32 * p.warps <= MAX_THREADS
        assert p.rows == K.WARP_ROWS
        assert p.depth == K.WARP_DEPTH
        assert p.warps == min(K.WARP_WARPS, K._pow2(-(-B // p.rows)))


def _rows_covered(p, B):
    """How often the warp route's grid gives each batch row to a warp (the
    kernel's row0 = (blockIdx.x * warps + warp) * rows, rows row0 ..
    row0 + rows - 1 below B)."""
    hits = np.zeros(B, dtype=np.int64)
    for blk, warp in itertools.product(range(p.grid), range(p.warps)):
        row0 = (blk * p.warps + warp) * p.rows
        for r in range(p.rows):
            if row0 + r < B:
                hits[row0 + r] += 1
    return hits


@pytest.mark.parametrize("B", (1, 2, 3, 7, 8, 9, 31, 64, 100, 257))
def test_warp_grid_covers_every_row_once(B):
    for rows, warps in itertools.product(K.WARP_ROW_CHOICES, (1, 2, 4, 8)):
        p = K.warp_plan(B, rows, warps, 1)
        assert (_rows_covered(p, B) == 1).all()
        # no block is all idle warps
        assert (p.grid - 1) * p.warps * p.rows < B
    assert (_rows_covered(K.seq_plan(B, 8, 32, "v1"), B) == 1).all()


@pytest.mark.parametrize("H", (33, 40, 64, 100, 133))
def test_wide_h_takes_the_block_route(H):
    for B, T in itertools.product((1, 3, 8, 64), (1, 32)):
        p = K.seq_plan(B, T, H, "v1")
        bt = min(B, K.DEFAULT_BATCH_BLOCK)
        assert p == K.block_plan(B, H, bt)
        assert p.route == "block" and p.depth == 0
        assert p.threads == _launch.THREADS and p.grid == -(-B // bt)
        assert p.smem == K.smem_bytes(1, H, bt) <= K.SMEM_LIMIT


def test_plan_raises_where_the_block_route_does_not_fit():
    with pytest.raises(ValueError, match="shared"):
        K.seq_plan(8, 1, 200, "v1")
    with pytest.raises(ValueError, match="variant"):
        K.seq_plan(8, 1, 20, "v2")
    with pytest.raises(ValueError, match="empty"):
        K.seq_plan(0, 1, 20, "v1")


def test_warp_registers_fit():
    """A lane keeps its 3H weights of U (H <= WARP_MAX_H), the gate biases,
    R states and accumulators and a ring of D steps of 3 xp columns and a
    mask per row in registers; at the largest knobs the C entry takes
    that stays well inside a thread's 255 (ptxas's spill report is the
    check on the card, chip_smoke.py phase 2)."""
    def regs(rows, depth):
        return (3 * K.WARP_MAX_H + 3 + rows * (1 + 3 + 4)
                + 4 * rows * depth)
    assert regs(K.WARP_ROWS, K.WARP_DEPTH) <= REGISTERS // 2
    assert regs(max(K.WARP_ROW_CHOICES), max(K.WARP_DEPTHS)) < REGISTERS


# ---------------------------------------------------------------------------
# the prefetch ring
# ---------------------------------------------------------------------------

def ring_events(T, D):
    """The kernel's loop as a list of events: ("issue", step, slot) and
    ("read", step, slot), in program order. Prologue: steps 0 .. D-1 into
    slots 0 .. D-1; then for t0 = 0, D, 2D, ...: for slot i, t = t0 + i
    (stop at T): read slot i, then refill it with step t + D if t + D <
    T."""
    ev = [("issue", i, i) for i in range(min(D, T))]
    for t0 in range(0, T, D):
        for i in range(D):
            t = t0 + i
            if t >= T:
                break
            ev.append(("read", t, i))
            if t + D < T:
                ev.append(("issue", t + D, i))
    return ev


@pytest.mark.parametrize("D", K.WARP_DEPTHS)
def test_every_step_is_issued_before_read_and_never_overwritten(D):
    for T in range(1, 70):
        slot_holds = {}               # slot -> step last issued into it
        issued, read = [], []
        for kind, t, slot in ring_events(T, D):
            assert 0 <= slot < D
            if kind == "issue":
                # the slot's previous step has been read already
                prev = slot_holds.get(slot)
                assert prev is None or prev in read
                slot_holds[slot] = t
                issued.append(t)
            else:
                assert slot_holds.get(slot) == t     # issued, not replaced
                read.append(t)
        assert read == list(range(T)) and sorted(issued) == list(range(T))
        # past the prologue, step t goes out right after step t - D is read
        ev = ring_events(T, D)
        for t in range(D, T):
            assert ev.index(("issue", t, t % D)) == ev.index(
                ("read", t - D, (t - D) % D)) + 1


def test_the_plans_depths_are_ones_the_kernel_takes():
    for T in range(1, 70):
        assert K.seq_plan(8, T, 32, "v1").depth in K.WARP_DEPTHS


# ---------------------------------------------------------------------------
# the warp route's summation order against JAX
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


def warp_sequence(h0, xp, u, b, mask, variant):
    """The warp route's arithmetic: per step, z and r (and v3's candidate)
    from :func:`_lane_sum` of h, then x + (sum + b); v1's candidate from
    the sum of r*h, (x + sum) + b; v3's x + r (sum + b); the update (1 - z)
    h + z ht; a dead step keeps h."""
    H = h0.shape[1]
    h, out = h0.astype(np.float32), []
    for t in range(xp.shape[0]):
        x = xp[t]
        zs, rs = _lane_sum(h, u[:, :H]), _lane_sum(h, u[:, H:2 * H])
        z = _sigmoid(x[:, :H] + (zs + b[:H]))
        r = _sigmoid(x[:, H:2 * H] + (rs + b[H:2 * H]))
        if variant == "v3":
            ht = np.tanh(x[:, 2 * H:] + r * (_lane_sum(h, u[:, 2 * H:])
                                             + b[2 * H:]))
        else:
            ht = np.tanh((x[:, 2 * H:] + _lane_sum(r * h, u[:, 2 * H:]))
                         + b[2 * H:])
        hn = (np.float32(1) - z) * h + z * ht
        if mask is not None:
            hn = np.where(mask[t][:, None] != 0, hn, h)
        h = hn.astype(np.float32)
        out.append(h)
    return np.stack(out)


def _operands(H, B, T, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(scale=0.5, size=(B, H)).astype(f),
            rng.normal(size=(T, B, 3 * H)).astype(f),
            (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(f),
            rng.normal(scale=0.3, size=(3 * H,)).astype(f),
            (rng.random((T, B)) > 0.3).astype(f))


@pytest.mark.parametrize("H", (5, 20, 32))
@pytest.mark.parametrize("T", (1, 8, 33))
@pytest.mark.parametrize("variant", ("v1", "v3"))
@pytest.mark.parametrize("masked", (False, True))
def test_warp_order_matches_pallas(H, T, variant, masked):
    h0, xp, u, b, mask = _operands(H, 3, T, seed=H * 100 + T)
    m = mask if masked else None
    got = warp_sequence(h0, xp, u, b, m, variant)
    want = jseq(jnp.asarray(h0), jnp.asarray(xp), jnp.asarray(u),
                jnp.asarray(b), None if m is None else jnp.asarray(m),
                variant=variant, interpret=True)
    close(got, want, tol=SEQ_TOL)
    assert K.seq_plan(3, T, H, variant).route == "warp"


def test_warp_order_keeps_dead_steps_bit_for_bit():
    """A left-padded row equals its unpadded run bit for bit: the dead
    steps keep h, the live ones run exactly the unmasked arithmetic."""
    h0, xp, u, b, _ = _operands(20, 3, 10, seed=3)
    pad = 4
    mask = np.ones((10, 3), dtype=np.float32)
    mask[:pad, 1] = 0.0
    padded = warp_sequence(h0, xp, u, b, mask, "v1")
    plain = warp_sequence(h0, xp[pad:], u, b, None, "v1")
    assert np.array_equal(padded[-1, 1], plain[-1, 1])
