"""The fused prefill's two routes, on the CPU: the launch plan of
``gru_stack_sequence_kernel`` (``repro_torch.kernels.gru_sequence.kernel.
stack_seq_plan``) and the warp route's schedule and arithmetic.

* Legality of the plan: every served shape (gru-jet-deep's L=3 H=32; B
  1-64; the engine's prompt buckets; v1 and v3) takes the warp route;
  wider H, L past the layer bound (the deepest stack measured on the
  card) or a nonzero ``batch_block`` take the block route at the tile the
  wrapper gave it before; the grid and the warps of a block (the kernel's
  index arithmetic, mirrored here) cover every (batch row, layer) exactly
  once, and every pair of neighbouring layers with one projection warp; a
  block stays within the kernel's launch bound of 256 threads and takes
  no dynamic shared memory (its slots are static).
* The wavefront as a discrete-event model (:func:`wavefront_events`, the
  kernel's loops): each tick's reads of the slots another warp left (a
  layer's h by step parity, a projection's columns) find the value of the
  step they expect, written in an earlier tick and not overwritten
  since, at every depth and T; the loads of xp and the mask a tick
  ahead deliver each tick's operands, issued before they are read and
  not replaced before, at every position of the wavefront.
* The route's arithmetic, emulated in numpy tick by tick through the same
  slots (:func:`wavefront_sequence`: each gate's sum over k in order by
  fma from 0, the deep projection the same way, the epilogues and the
  update in the kernel's order, a dead step keeping every layer's h),
  against JAX's Pallas ``gru_stack_sequence_kernel`` in interpret mode
  and the port's plain version within ``SEQ_TOL``, v1 and v3, masked and
  not; a left-padded row equal to its unpadded run bit for bit.

No CUDA kernel runs here; the two routes are held against each other bit
for bit and against the plain version on the card (``test_torch_gpu.py``,
``chip_smoke.py``, ``tools/stack_seq_tiles.py``).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close
from repro.kernels.gru_sequence.kernel import (
    gru_stack_sequence_kernel as jstack)
from repro_torch.kernels import _launch
from repro_torch.kernels.gru_sequence import kernel as K
from repro_torch.kernels.gru_sequence import ref

SEQ_TOL = 1e-6
LAUNCH_BOUND = 256           # __launch_bounds__ of the kernel
BUCKETS = (1, 2, 4, 8, 16, 32, 64)     # the engine's prompt buckets


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", BUCKETS)
@pytest.mark.parametrize("variant", _launch.VARIANTS)
def test_served_shapes_take_the_warp_route(T, variant):
    for B in range(1, 65):
        p = K.stack_seq_plan(B, T, 32, 3, variant)
        assert p.route == "warp" and p.rows == 1
        assert p.warps == K.stack_warps(3) == 5
        assert p.threads == 32 * p.warps <= LAUNCH_BOUND
        assert p.grid == B and p.smem == 0


@pytest.mark.parametrize("L", range(1, K.STACK_WARP_MAX_L + 1))
def test_every_width_within_the_bounds_takes_the_warp_route(L):
    for H, B in itertools.product(range(1, K.WARP_MAX_H + 1), (1, 3, 8)):
        assert K.stack_seq_plan(B, 5, H, L, "v1") == K.stack_seq_warp_plan(
            B, L)


def _block(B, H, L, bt):
    p = K.stack_seq_block_plan(B, H, L, bt)
    assert p.route == "block" and p.threads == _launch.THREADS
    assert p.grid == -(-B // bt)
    assert p.smem == K.smem_bytes(L, H, bt) <= _launch.SMEM_LIMIT
    return p


@pytest.mark.parametrize("H", (33, 40, 64))
def test_wide_h_takes_the_block_route_at_the_old_tile(H):
    for B, L in itertools.product((1, 3, 8, 64), (1, 2, 3)):
        bt = min(B, K.DEFAULT_BATCH_BLOCK)
        if K.smem_bytes(L, H, bt) > _launch.SMEM_LIMIT:   # as it raised
            with pytest.raises(ValueError, match="shared"):
                K.stack_seq_plan(B, 16, H, L, "v1")
            continue
        assert K.stack_seq_plan(B, 16, H, L, "v1") == _block(B, H, L, bt)


def test_depth_past_the_bound_takes_the_block_route():
    for H, B in itertools.product((5, 20, 32), (1, 8, 64)):
        for L in (K.STACK_WARP_MAX_L + 1, K.STACK_WARP_MAX_L + 2):
            bt = min(B, K.DEFAULT_BATCH_BLOCK)
            assert K.stack_seq_plan(B, 16, H, L, "v3") == _block(B, H, L,
                                                                 bt)


@pytest.mark.parametrize("batch_block", (1, 2, 8, 64))
def test_a_nonzero_batch_block_selects_the_block_route(batch_block):
    for B, T in itertools.product((1, 8, 64), (1, 32)):
        assert K.stack_seq_plan(B, T, 32, 3, "v1", batch_block) == _block(
            B, 32, 3, batch_block)


def test_the_layer_bound_covers_the_served_and_swept_depths():
    """The route takes the depths the sweep measures and holds bit for bit
    against the block route on the card (L 1-4, tools/stack_seq_tiles.py
    and the gpu tests), no deeper, and gru-jet-deep's 3."""
    assert K.STACK_WARP_MAX_L == 4
    assert K.stack_seq_plan(8, 32, 32, 3, "v1").route == "warp"
    assert K.stack_seq_plan(8, 32, 32, 5, "v1").route == "block"


def test_plan_raises_on_what_no_route_takes():
    with pytest.raises(ValueError, match="variant"):
        K.stack_seq_plan(8, 16, 32, 3, "v2")
    with pytest.raises(ValueError, match="empty"):
        K.stack_seq_plan(8, 0, 32, 3, "v1")
    with pytest.raises(ValueError, match="batch_block"):
        K.stack_seq_plan(8, 16, 32, 3, "v1", 300)
    with pytest.raises(ValueError, match="shared"):
        K.stack_seq_plan(8, 16, 200, 3, "v1")


def _roles(p, L, B):
    """The kernel's index arithmetic, mirrored: for each (block, warp) of
    the launch, (row, role, layer): the block is the row, the warp its
    position q, role "gate" (even positions) or "proj" (odd ones)."""
    return [(blk, "proj" if q & 1 else "gate", q >> 1)
            for blk, q in itertools.product(range(p.grid), range(p.warps))]


@pytest.mark.parametrize("B", (1, 2, 3, 7, 8, 9, 33, 64, 100))
@pytest.mark.parametrize("L", range(1, K.STACK_WARP_MAX_L + 1))
def test_grid_covers_every_row_and_layer_once(B, L):
    p = K.stack_seq_warp_plan(B, L)
    assert p.threads == 32 * p.warps <= LAUNCH_BOUND
    roles = _roles(p, L, B)
    gates = sorted((r, l) for r, role, l in roles if role == "gate")
    projs = sorted((r, l) for r, role, l in roles if role == "proj")
    assert gates == sorted(itertools.product(range(B), range(L)))
    assert projs == sorted(itertools.product(range(B), range(L - 1)))


# ---------------------------------------------------------------------------
# the wavefront as a discrete-event model
# ---------------------------------------------------------------------------

def _positions(L):
    """The wavefront's warps of one row, by position q: ("gate", l) or
    ("proj", l) (the projection of layer l's h into layer l+1's input)."""
    return [("proj" if q & 1 else "gate", q >> 1) for q in range(2 * L - 1)]


def wavefront_events(T, L):
    """The kernel's loops over ticks as events, tick by tick (a block
    barrier between two ticks): ("write", slot, step) and ("read", slot,
    step) on the shared slots, slot = (kind, layer, parity), kind "h"
    (a layer's new h) or "p" (a projection). Before the loop each gate
    warp stores its h0 as step -1 of its h slots (the first entry, read by
    the warp itself after a __syncwarp). A warp at position q runs step
    j - q at tick j: a gate warp of layer l reads its own h of step t - 1
    (its pass's broadcast) and, for l > 0, layer l-1's projection, then
    writes its h of step t; a projection warp reads layer l's h and writes
    its projection."""
    pos = _positions(L)
    ticks = [[("write", ("h", l, 1), -1) for role, l in pos
              if role == "gate"]]
    for j in range(T + len(pos) - 1):
        ev = []
        for q, (role, l) in enumerate(pos):
            t = j - q
            if not 0 <= t < T:
                continue
            if role == "proj":
                ev += [("read", ("h", l, t & 1), t),
                       ("write", ("p", l, t & 1), t)]
                continue
            ev.append(("read", ("h", l, (t - 1) & 1), t - 1))
            if l > 0:
                ev.append(("read", ("p", l - 1, t & 1), t))
            ev.append(("write", ("h", l, t & 1), t))
        ticks.append(ev)
    return ticks


@pytest.mark.parametrize("L", range(1, K.STACK_WARP_MAX_L + 1))
def test_every_slot_is_written_before_read_and_not_overwritten(L):
    """Each read finds the step it expects, written in an earlier tick (so
    a barrier lies between, or, for h0, the warp's own __syncwarp) and not
    overwritten since; no two warps write one slot in a tick; within a
    tick no slot is both read and written (the other parity is); every
    (layer, step) is produced once; each projection is read once, each h
    by the next layer's projection (below the top) and by its own layer's
    next step."""
    for T in range(1, 41):
        held = {}                       # slot -> (step, tick written)
        reads, writes = [], []
        for j, ev in enumerate(wavefront_events(T, L), start=-1):
            kinds = [(slot, kind) for kind, slot, _ in ev]
            for slot in {s_ for s_, _ in kinds}:
                assert len({k for s_, k in kinds if s_ == slot}) == 1
                assert sum(1 for s_, k in kinds
                           if s_ == slot and k == "write") <= 1
            for kind, slot, t in ev:
                if kind == "read":
                    assert held.get(slot, (None, j))[0] == t
                    assert held[slot][1] < j
                    reads.append((slot[:2], t))
            for kind, slot, t in ev:
                if kind == "write":
                    assert (slot[:2], t) not in writes
                    held[slot] = (t, j)
                    writes.append((slot[:2], t))
        assert len(writes) == (2 * L - 1) * T + L
        want = ([w for w in writes if w[0][0] == "p"]
                + [w for w in writes if w[0][0] == "h" and w[1] >= 0
                   and w[0][1] < L - 1]
                + [w for w in writes if w[0][0] == "h" and w[1] < T - 1])
        assert sorted(reads) == sorted(want)


def _prefetch_events(T, q):
    """The gate warp's loads a tick ahead, as the kernel runs them: tick
    0's before the loop (a tick outside the warp's steps issues nothing);
    then at each tick j the registers are read if step j - q is live, and
    refilled with tick j + 1's step."""
    def step(j):
        t = j - q
        return t if 0 <= t < T else None
    ev = [("issue", step(0))] if step(0) is not None else []
    for j in range(T + q):
        if step(j) is not None:
            ev.append(("read", step(j)))
        if step(j + 1) is not None:
            ev.append(("issue", step(j + 1)))
    return ev


@pytest.mark.parametrize("q", range(0, 2 * K.STACK_WARP_MAX_L - 1, 2))
def test_the_prefetch_delivers_every_step(q):
    for T in range(1, 41):
        held, read = None, []
        for kind, t in _prefetch_events(T, q):
            if kind == "issue":
                assert held is None or held in read
                held = t
            else:
                assert held == t
                read.append(t)
        assert read == list(range(T))


# ---------------------------------------------------------------------------
# the route's arithmetic, tick by tick
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
    """sum_k v[:, k] * w[k, :] as a lane takes it: k in order by fma from
    0 (v is what the slot or the shuffles broadcast)."""
    acc = np.zeros((v.shape[0], w.shape[1]), dtype=np.float32)
    for k in range(v.shape[1]):
        acc = _fma(v[:, k:k + 1], w[k:k + 1], acc)
    return acc


def _gate_step(x, h, u, b, variant):
    """warp_gru_step: z and r (and v3's candidate) from the lane sums of h,
    then x + (sum + b); v1's candidate from the sum of r*h, (x + sum) + b;
    v3's x + r (sum + b); the update fma(1 - z, h, z*ht)."""
    H = h.shape[1]
    z = _sigmoid(x[:, :H] + (_lane_sum(h, u[:, :H]) + b[:H]))
    r = _sigmoid(x[:, H:2 * H] + (_lane_sum(h, u[:, H:2 * H]) + b[H:2 * H]))
    if variant == "v3":
        ht = np.tanh(x[:, 2 * H:] + r * (_lane_sum(h, u[:, 2 * H:])
                                         + b[2 * H:]))
    else:
        ht = np.tanh((x[:, 2 * H:] + _lane_sum(r * h, u[:, 2 * H:]))
                     + b[2 * H:])
    return _fma(np.float32(1) - z, h, (z * ht).astype(np.float32))


def wavefront_sequence(h0, xp, u, wd, b, mask, variant):
    """The warp route's schedule and arithmetic: the ticks of
    :func:`wavefront_events`, each warp reading the slots the previous
    tick left and writing its own (the writes land after the tick's
    reads, as the barrier orders them). A gate warp's input is layer 0's
    xp or the projection warp's slot (the lane sums of layer l-1's h
    against W_{l-1}); a dead step keeps h. Returns the top layer's states
    (T,B,H) and the finals (L,B,H)."""
    L, _, H = h0.shape
    T = xp.shape[0]
    pos = _positions(L)
    h = [h0[l].astype(np.float32) for l in range(L)]
    slots, out = {}, []
    for j in range(T + len(pos) - 1):
        writes = {}
        for q, (role, l) in enumerate(pos):
            t = j - q
            if not 0 <= t < T:
                continue
            if role == "proj":
                writes[("p", l, t & 1)] = _lane_sum(slots[("h", l, t & 1)],
                                                    wd[l])
                continue
            x = xp[t] if l == 0 else slots[("p", l - 1, t & 1)]
            hn = _gate_step(x, h[l], u[l], b[l], variant)
            if mask is not None:
                hn = np.where(mask[t][:, None] != 0, hn, h[l])
            h[l] = hn.astype(np.float32)
            writes[("h", l, t & 1)] = h[l]
            if l == L - 1:
                out.append(h[l])
        slots.update(writes)
    return np.stack(out), np.stack(h)


def _operands(L, H, B, T, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(scale=0.5, size=(L, B, H)).astype(f),
            rng.normal(size=(T, B, 3 * H)).astype(f),
            (rng.normal(size=(L, H, 3 * H)) / np.sqrt(H)).astype(f),
            (rng.normal(size=(max(L - 1, 1), H if L > 1 else 1, 3 * H))
             / np.sqrt(H)).astype(f),
            rng.normal(scale=0.3, size=(L, 3 * H)).astype(f),
            (rng.random((T, B)) > 0.3).astype(f))


@pytest.mark.parametrize("L,H", ((1, 5), (2, 20), (3, 32), (4, 7)))
@pytest.mark.parametrize("T", (1, 6))
@pytest.mark.parametrize("variant", _launch.VARIANTS)
@pytest.mark.parametrize("masked", (False, True))
def test_wavefront_matches_pallas_and_the_plain_version(L, H, T, variant,
                                                        masked):
    h0, xp, u, wd, b, mask = _operands(L, H, 3, T, seed=100 * L + H + T)
    m = mask if masked else None
    got = wavefront_sequence(h0, xp, u, wd, b, m, variant)
    want = jstack(*(jnp.asarray(v) for v in (h0, xp, u, wd, b)),
                  None if m is None else jnp.asarray(m), variant=variant,
                  interpret=True)
    close(got[0], want[0], tol=SEQ_TOL)
    close(got[1], want[1], tol=SEQ_TOL)
    t = [torch.from_numpy(v) for v in (h0, xp, u, wd, b)]
    tm = None if m is None else torch.from_numpy(m)
    plain = ref.gru_stack_sequence_ref(*t, tm, variant)
    close(got[0], plain[0], tol=SEQ_TOL)
    close(got[1], plain[1], tol=SEQ_TOL)
    # the wrapper on CPU tensors is that plain version and launches nothing
    K.gru_stack_sequence_kernel.launches = 0
    wrapped = K.gru_stack_sequence_kernel(*t, tm, variant=variant)
    assert all(torch.equal(a, c) for a, c in zip(wrapped, plain))
    assert K.gru_stack_sequence_kernel.launches == 0
    assert K.stack_seq_plan(3, T, H, L, variant).route == "warp"


@pytest.mark.parametrize("variant", _launch.VARIANTS)
def test_wavefront_keeps_dead_steps_bit_for_bit(variant):
    """A left-padded row equals its unpadded run bit for bit, in every
    layer: the dead steps keep each layer's h (and the next layer consumes
    that gated output), the live ones run exactly the unmasked
    arithmetic."""
    h0, xp, u, wd, b, _ = _operands(3, 20, 3, 9, seed=3)
    pad = 4
    mask = np.ones((9, 3), dtype=np.float32)
    mask[:pad, 1] = 0.0
    out, fin = wavefront_sequence(h0, xp, u, wd, b, mask, variant)
    out1, fin1 = wavefront_sequence(h0, xp[pad:], u, wd, b, None, variant)
    assert np.array_equal(out[pad:, 1], out1[:, 1])
    assert np.array_equal(fin[:, 1], fin1[:, 1])
    assert np.array_equal(out[:pad, 1], np.repeat(h0[2, 1][None], pad, 0))
