"""The two q8 prefill kernels' warp routes, on the CPU: the launch plans of
``gru_sequence_q8_kernel`` (row 6, ``kernel.seq_q8_plan``) and
``gru_stack_sequence_q8_kernel`` (row 4, ``kernel.stack_seq_q8_plan``),
row 4's wavefront schedule, and both routes' arithmetic.

* Legality of the plans: every served shape (row 6: the q8 chain's layers
  of H 20 and 32; row 4: gru-jet's L=1 H=20 and gru-jet-deep's L=3 H=32;
  B 1-64; the engine's prompt buckets; v1 and v3) takes the warp route;
  every H <= 32 (and, for row 4, every depth to the bound) does; wider H,
  or deeper stacks, take the block route at the tile the wrapper gave it
  before; the grid and a block's warps (the kernels' index arithmetic,
  mirrored here) cover every batch row once (row 4: every (row, layer)
  and every pair of neighbouring layers); a block stays within 256
  threads and asks for no dynamic shared memory.
* Row 6's prefetch is row 1's register ring (``ring_events`` of
  ``test_torch_seq_redesign``) at the kernel's fixed depth of one step;
  row 4's wavefront as a
  discrete-event model (:func:`wavefront_q8_events`, the kernel's loops):
  every slot is written before it is read and not overwritten before that
  read; its gate warps' loads a tick ahead are row 2's
  (``_prefetch_events`` of ``test_torch_stack_seq_redesign``).
* The arithmetic, emulated step by step and tick by tick in torch with
  row 7's lane model (``warp_step_q8``, ``shuffle_pack``, ``dp4a_dot``,
  ``load_row_words`` of ``test_torch_step_q8_redesign``): the int32 gate
  sums (and the deep projection's) equal JAX's ``_doti`` on JAX's
  ``_q8_act`` bit for bit; the states equal the port's plain
  ``gru_sequence_q8_ref`` and ``gru_stack_sequence_q8_ref`` bit for bit,
  and JAX's Pallas ``gru_sequence_q8_kernel`` and
  ``gru_stack_sequence_q8_kernel`` in interpret mode within ``TOL``
  (torch's and XLA's sigmoid and tanh differ by an ulp or two), v1 and
  v3, masked and not; a left-padded row equals its unpadded run bit for
  bit.

No CUDA kernel runs here; the warp routes are held against their block
routes bit for bit and against the plain versions on the card
(``test_torch_gpu.py``, ``chip_smoke.py``, ``tools/seq_q8_tiles.py``).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, close
from repro.core.params import quantize_gru_cells as jquantize_gru_cells
from repro.kernels.gru_cell import kernel as JCK
from repro.kernels.gru_sequence import kernel as JK
from repro_torch.kernels import _launch
from repro_torch.kernels.gru_sequence import kernel as K
from repro_torch.kernels.gru_sequence import ref
from test_torch_seq_redesign import ring_events
from test_torch_stack_seq_redesign import _positions, _prefetch_events
from test_torch_step_q8_redesign import (dp4a_dot, load_row_words, q8,
                                         shuffle_pack, warp_step_q8)

LAUNCH_BOUND = 256           # __launch_bounds__ of the kernels
BUCKETS = (1, 2, 4, 8, 16, 32, 64)     # the engine's prompt buckets


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", BUCKETS)
@pytest.mark.parametrize("variant", _launch.VARIANTS)
def test_served_shapes_take_the_warp_routes(T, variant):
    for B, H in itertools.product(range(1, 65), (20, 32)):
        p = K.seq_q8_plan(B, T, H, variant)
        assert p.route == "warp" and p.rows == 1 and p.smem == 0
        assert p.warps == min(K.SEQ_Q8_WARPS, K._pow2(B))
        assert p.depth == K.SEQ_Q8_DEPTH
        assert p.threads == 32 * p.warps <= LAUNCH_BOUND
        assert p.grid == -(-B // p.warps)
    for B, (L, H) in itertools.product(range(1, 65), ((1, 20), (3, 32))):
        p = K.stack_seq_q8_plan(B, T, H, L, variant)
        assert p == K.stack_seq_warp_plan(B, L)
        assert p.route == "warp" and p.rows == 1 and p.smem == 0
        assert p.warps == K.stack_warps(L) == 2 * L - 1
        assert p.threads == 32 * p.warps <= LAUNCH_BOUND and p.grid == B


def test_every_width_within_the_bounds_takes_the_warp_routes():
    for H, B in itertools.product(range(1, K.WARP_MAX_H + 1), (1, 3, 8)):
        assert K.seq_q8_plan(B, 5, H, "v1").route == "warp"
        for L in range(1, K.STACK_Q8_WARP_MAX_L + 1):
            assert K.stack_seq_q8_plan(B, 5, H, L, "v3") == (
                K.stack_seq_warp_plan(B, L))


@pytest.mark.parametrize("H", (33, 40, 64, 100))
def test_wide_h_takes_the_block_routes_at_the_old_tile(H):
    for B in (1, 3, 8, 64):
        bt = min(B, K.DEFAULT_BATCH_BLOCK)
        p = K.seq_q8_plan(B, 16, H, "v1")
        assert p == K.block_plan(B, H, bt, q8=True)
        assert p.route == "block" and p.threads == _launch.THREADS
        assert p.grid == -(-B // bt) and p.depth == 0
        assert p.smem == K.smem_bytes_seq_q8(H, bt) <= _launch.SMEM_LIMIT
        for L in (1, 2, 3):
            if K.smem_bytes_q8(L, H, bt) > _launch.SMEM_LIMIT:   # as it raised
                with pytest.raises(ValueError, match="shared"):
                    K.stack_seq_q8_plan(B, 16, H, L, "v1")
                continue
            p = K.stack_seq_q8_plan(B, 16, H, L, "v1")
            assert p == K.stack_seq_block_plan(B, H, L, bt, q8=True)
            assert p.route == "block" and p.grid == -(-B // bt)
            assert p.smem == K.smem_bytes_q8(L, H, bt)


def test_depth_past_the_bound_takes_the_block_route():
    for H, B in itertools.product((5, 20, 32), (1, 8, 64)):
        for L in (K.STACK_Q8_WARP_MAX_L + 1, K.STACK_Q8_WARP_MAX_L + 2):
            bt = min(B, K.DEFAULT_BATCH_BLOCK)
            assert K.stack_seq_q8_plan(B, 16, H, L, "v3") == (
                K.stack_seq_block_plan(B, H, L, bt, q8=True))


def test_the_layer_bound_covers_the_served_and_swept_depths():
    """Row 4's route takes the depths the sweep measures and holds bit for
    bit against the block route on the card (L 1-4, as row 2's), the
    served 1 and 3 among them."""
    assert K.STACK_Q8_WARP_MAX_L == 4
    for L in (1, 3):
        assert K.stack_seq_q8_plan(8, 32, 32, L, "v1").route == "warp"
    assert K.stack_seq_q8_plan(8, 32, 32, 5, "v1").route == "block"


def test_plans_raise_on_what_no_route_takes():
    for plan in (lambda *a: K.seq_q8_plan(*a[:3], a[4]),
                 K.stack_seq_q8_plan):
        with pytest.raises(ValueError, match="variant"):
            plan(8, 16, 32, 3, "v2")
        with pytest.raises(ValueError, match="empty"):
            plan(8, 0, 32, 3, "v1")
        with pytest.raises(ValueError, match="shared"):
            plan(8, 16, 2048, 3, "v1")


def _rows_covered(p, B):
    """How often row 6's warp grid gives each batch row to a warp (the
    kernel's row = blockIdx.x * warps + warp, below B)."""
    hits = np.zeros(B, dtype=np.int64)
    for blk, warp in itertools.product(range(p.grid), range(p.warps)):
        row = blk * p.warps + warp
        if row < B:
            hits[row] += 1
    return hits


@pytest.mark.parametrize("B", (1, 2, 3, 7, 8, 9, 33, 64, 100, 257))
def test_grids_cover_every_row_and_layer_once(B):
    for warps in (1, 2, 4, 8):
        p = K.warp_plan(B, 1, warps, K.SEQ_Q8_DEPTH)
        assert (_rows_covered(p, B) == 1).all()
        assert (p.grid - 1) * p.warps < B          # no all-idle block
        assert p.threads <= LAUNCH_BOUND
    assert (_rows_covered(K.seq_q8_plan(B, 16, 32, "v1"), B) == 1).all()
    for L in range(1, K.STACK_Q8_WARP_MAX_L + 1):
        p = K.stack_seq_q8_plan(B, 16, 32, L, "v1")
        assert p.threads == 32 * p.warps <= LAUNCH_BOUND
        roles = [(blk, "proj" if q & 1 else "gate", q >> 1)
                 for blk, q in itertools.product(range(p.grid),
                                                 range(p.warps))]
        gates = sorted((r, l) for r, role, l in roles if role == "gate")
        projs = sorted((r, l) for r, role, l in roles if role == "proj")
        assert gates == sorted(itertools.product(range(B), range(L)))
        assert projs == sorted(itertools.product(range(B), range(L - 1)))


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

def test_row6_prefetch_is_row1s_ring_one_step_ahead():
    """The kernel loads step t + 1's operands while step t runs: row 1's
    ring (``ring_events``) at depth 1, which the plan reports; it delivers
    every step, issued before it is read and not replaced before."""
    assert K.SEQ_Q8_DEPTH == 1
    D = K.SEQ_Q8_DEPTH
    for T in range(1, 70):
        held, read = {}, []
        for kind, t, slot in ring_events(T, D):
            if kind == "issue":
                assert held.get(slot) is None or held[slot] in read
                held[slot] = t
            else:
                assert held.get(slot) == t
                read.append(t)
        assert read == list(range(T))


def wavefront_q8_events(T, L):
    """Row 4's loops over ticks as events, tick by tick (a block barrier
    between two ticks): ("write", slot, step) and ("read", slot, step),
    slot = (kind, layer, parity), kind "h" (layer l's new h for its
    projection warp, float32) or "p" (the projection into layer
    l+1's input). A warp at position q runs step j - q at tick j: a gate
    warp of layer l reads, for l > 0, layer l-1's projection and writes,
    below the top layer, its new h (it packs its own h for its next step
    in registers, so it reads no h slot); a projection warp reads layer
    l's h and writes its projection."""
    pos = _positions(L)
    ticks = []
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
            if l > 0:
                ev.append(("read", ("p", l - 1, t & 1), t))
            if l + 1 < L:
                ev.append(("write", ("h", l, t & 1), t))
        ticks.append(ev)
    return ticks


@pytest.mark.parametrize("L", range(1, K.STACK_Q8_WARP_MAX_L + 1))
def test_every_slot_is_written_before_read_and_not_overwritten(L):
    """Each read finds the step it expects, written in an earlier tick (a
    barrier between) and not overwritten since; no two warps write one
    slot in a tick, and no slot is both read and written in one (the
    other parity is); every hand-over is written once and read once."""
    for T in range(1, 41):
        held, reads, writes = {}, [], []
        for j, ev in enumerate(wavefront_q8_events(T, L)):
            for slot in {s for _, s, _ in ev}:
                kinds = [k for k, s, _ in ev if s == slot]
                assert len(set(kinds)) == 1 and kinds.count("write") <= 1
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
        assert len(writes) == 2 * (L - 1) * T
        assert sorted(reads) == sorted(writes)


@pytest.mark.parametrize("q", range(0, 2 * K.STACK_Q8_WARP_MAX_L - 1, 2))
def test_row4_prefetch_delivers_every_step(q):
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
# the arithmetic
# ---------------------------------------------------------------------------

def warp_sequence_q8(h0, xp, u_q, u_eff, b, mask, variant):
    """Row 6's warp route, step by step as a warp computes it: row 7's lane
    step (q8(h) packed by shuffles, dp4a gate sums, the float32 ops in
    gru_q8_math.cuh's order, v1's q8(r * h) packed for the candidate), the
    mask a select (a dead step keeps h). Returns the states (T,B,H) and
    each step's int32 gate sums (B,3H)."""
    h, out, sums = h0, [], []
    for t in range(xp.shape[0]):
        hn, acc = warp_step_q8(h, xp[t], u_q, u_eff, b, variant)
        if mask is not None:
            hn = torch.where(mask[t][:, None] != 0, hn, h)
        h = hn
        out.append(h)
        sums.append(acc)
    return torch.stack(out), sums


def wavefront_sequence_q8(h0, xp, u_q, u_eff, wd_q, wd_eff, b, mask,
                          variant):
    """Row 4's warp route: the ticks of :func:`wavefront_q8_events`, each
    warp reading the slots the previous tick left and writing its own (the
    writes land after the tick's reads, as the barrier orders them). A
    gate warp is row 7's lane step on layer 0's xp or on the projection
    slot, a dead step keeping h; its new h goes to the h slot as float32;
    the projection warp packs q8(h) by shuffles (shuffle_pack), sums the
    words by dp4a against W_l's words and scales each sum by wd_eff.
    Returns the top
    layer's states (T,B,H), the finals (L,B,H) and the int32 sums by
    (kind, layer, step): the gates' (B,3H) and the projections' (B,3H)."""
    L, _, H = h0.shape
    T = xp.shape[0]
    pos = _positions(L)
    vec = H % 4 == 0
    h = [h0[l] for l in range(L)]
    slots, out, sums = {}, [], {}
    for j in range(T + len(pos) - 1):
        writes = {}
        for q, (role, l) in enumerate(pos):
            t = j - q
            if not 0 <= t < T:
                continue
            if role == "proj":
                acc = dp4a_dot(shuffle_pack(q8(slots[("h", l, t & 1)])),
                               load_row_words(wd_q[l].numpy(), vec=vec))
                sums[("p", l, t)] = acc
                writes[("p", l, t & 1)] = acc.to(torch.float32) * wd_eff[l]
                continue
            x = xp[t] if l == 0 else slots[("p", l - 1, t & 1)]
            hn, acc = warp_step_q8(h[l], x, u_q[l], u_eff[l], b[l], variant)
            sums[("g", l, t)] = acc
            if mask is not None:
                hn = torch.where(mask[t][:, None] != 0, hn, h[l])
            h[l] = hn
            if l + 1 < L:
                writes[("h", l, t & 1)] = hn
            if l == L - 1:
                out.append(hn)
        slots.update(writes)
    return torch.stack(out), torch.stack(h), sums


def _cells(L, H, rng):
    """JAX-quantized int8 rows of L random cells (U, W and b), stacked."""
    def f32(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)
    cells = tuple({"w": jnp.asarray(f32(H, 3 * H, scale=H ** -0.5)),
                   "u": jnp.asarray(f32(H, 3 * H, scale=H ** -0.5)),
                   "b": jnp.asarray(f32(3 * H, scale=0.3))}
                  for _ in range(L))
    st = jquantize_gru_cells(cells).stacked
    return tuple(np.array(st[k]) for k in ("u_q", "u_eff", "wd_q", "wd_eff",
                                           "b"))


def _operands(L, H, B, T, seed):
    """h0 (L,B,H), xp (T,B,3H), a (T,B) mask with dead steps, and the q8
    stack (u_q, u_eff, wd_q, wd_eff, b)."""
    rng = np.random.default_rng(seed)
    h0 = (0.5 * rng.normal(size=(L, B, H))).astype(np.float32)
    xp = rng.normal(size=(T, B, 3 * H)).astype(np.float32)
    mask = (rng.random((T, B)) > 0.3).astype(np.float32)
    return h0, xp, mask, _cells(L, H, rng)


def _jdoti(a, w):
    return np.array(JCK._doti(JCK._q8_act(jnp.asarray(np.asarray(a))),
                                jnp.asarray(w)))


def _v1_candidate_sums(jacc, x, acc, h, u_q, u_eff, b):
    """JAX's int32 candidate sum on q8(r * h), r from the route's own gate
    sums (as the kernel's r), into columns 2H: of ``jacc``."""
    H = h.shape[1]
    r = torch.sigmoid(x[:, H:2 * H] + (acc[:, H:2 * H].to(torch.float32)
                                       * u_eff[H:2 * H] + b[H:2 * H]))
    jacc[:, 2 * H:] = _jdoti((r * h).numpy(), np.asarray(u_q)[2 * H:])
    return jacc


@pytest.mark.parametrize("H", (5, 20, 32))
@pytest.mark.parametrize("T", (1, 6))
@pytest.mark.parametrize("variant", _launch.VARIANTS)
@pytest.mark.parametrize("masked", (False, True))
def test_row6_matches_jax_and_the_plain_version(H, T, variant, masked):
    h0, xp, mask, (u_q, u_eff, _, _, b) = _operands(1, H, 3, T,
                                                    seed=10 * H + T)
    m = mask if masked else None
    t = [torch.from_numpy(v) for v in (h0[0], xp, u_q[0], u_eff[0], b[0])]
    tm = None if m is None else torch.from_numpy(m)
    got, sums = warp_sequence_q8(*t, tm, variant)
    # the int32 sums bit for bit against JAX's integer dot on JAX's q8 of
    # the state the step read
    for s, acc in enumerate(sums):
        hs = t[0] if s == 0 else got[s - 1]
        jacc = _jdoti(hs.numpy(), u_q[0])
        if variant == "v1":
            jacc = _v1_candidate_sums(jacc, t[1][s], acc, hs, *t[2:])
        assert np.array_equal(acc.numpy(), jacc)
    # the states bit for bit against the port's plain version, within TOL
    # of JAX's Pallas kernel in interpret mode
    plain = ref.gru_sequence_q8_ref(*t, tm, variant)
    assert torch.equal(got, plain)
    want = JK.gru_sequence_q8_kernel(
        *(jnp.asarray(v) for v in (h0[0], xp, u_q[0], u_eff[0], b[0])),
        None if m is None else jnp.asarray(m), variant=variant,
        interpret=True)
    close(got, want, tol=TOL)
    # the wrapper on CPU tensors is that plain version and launches nothing
    K.gru_sequence_q8_kernel.launches = 0
    assert torch.equal(K.gru_sequence_q8_kernel(*t, tm, variant=variant),
                       plain)
    assert K.gru_sequence_q8_kernel.launches == 0
    assert K.seq_q8_plan(3, T, H, variant).route == "warp"


@pytest.mark.parametrize("L,H", ((1, 20), (2, 5), (3, 32), (4, 7)))
@pytest.mark.parametrize("T", (1, 6))
@pytest.mark.parametrize("variant", _launch.VARIANTS)
@pytest.mark.parametrize("masked", (False, True))
def test_row4_wavefront_matches_jax_and_the_plain_version(L, H, T, variant,
                                                          masked):
    h0, xp, mask, q = _operands(L, H, 3, T, seed=100 * L + H + T)
    m = mask if masked else None
    t = [torch.from_numpy(v) for v in (h0, xp) + q]
    tm = None if m is None else torch.from_numpy(m)
    out, fin, sums = wavefront_sequence_q8(*t, tm, variant)
    # replay the states each sum read (the plain version, which the route
    # equals bit for bit below) and hold every int32 sum against JAX's
    hs = [t[0][l] for l in range(L)]
    x = t[1]
    for s in range(T):
        for l in range(L):
            acc = sums[("g", l, s)]
            jacc = _jdoti(hs[l].numpy(), q[0][l])
            if variant == "v1":
                jacc = _v1_candidate_sums(jacc, x[s] if l == 0 else xl, acc,
                                          hs[l], t[2][l], t[3][l], t[6][l])
            assert np.array_equal(acc.numpy(), jacc)
            hn = ref.gru_stack_sequence_q8_ref(
                hs[l][None], (x[s] if l == 0 else xl)[None], t[2][l:l + 1],
                t[3][l:l + 1], t[4][:1], t[5][:1], t[6][l:l + 1],
                None if tm is None else tm[s:s + 1], variant)[1][0]
            hs[l] = hn
            if l + 1 < L:
                deep = sums[("p", l, s)]
                assert np.array_equal(deep.numpy(),
                                      _jdoti(hn.numpy(), q[2][l]))
                xl = deep.to(torch.float32) * t[5][l]
    # the states bit for bit against the port's plain version, within TOL
    # of JAX's Pallas kernel in interpret mode
    plain = ref.gru_stack_sequence_q8_ref(*t, tm, variant)
    assert torch.equal(out, plain[0]) and torch.equal(fin, plain[1])
    want = JK.gru_stack_sequence_q8_kernel(
        *(jnp.asarray(v) for v in (h0, xp) + q),
        None if m is None else jnp.asarray(m), variant=variant,
        interpret=True)
    close(out, want[0], tol=TOL)
    close(fin, want[1], tol=TOL)
    # the wrapper on CPU tensors is that plain version and launches nothing
    K.gru_stack_sequence_q8_kernel.launches = 0
    wrapped = K.gru_stack_sequence_q8_kernel(*t, tm, variant=variant)
    assert all(torch.equal(a, c) for a, c in zip(wrapped, plain))
    assert K.gru_stack_sequence_q8_kernel.launches == 0
    assert K.stack_seq_q8_plan(3, T, H, L, variant).route == "warp"


@pytest.mark.parametrize("variant", _launch.VARIANTS)
def test_dead_steps_keep_h_bit_for_bit(variant):
    """A left-padded row equals its unpadded run bit for bit on both routes'
    models, in every layer: the dead steps keep each layer's h (and the
    next layer consumes that kept output), the live ones run exactly the
    unmasked arithmetic."""
    h0, xp, _, q = _operands(3, 20, 3, 9, seed=3)
    pad = 4
    mask = np.ones((9, 3), dtype=np.float32)
    mask[:pad, 1] = 0.0
    t = [torch.from_numpy(v) for v in (h0, xp) + q]
    tm = torch.from_numpy(mask)
    out, fin, _ = wavefront_sequence_q8(*t, tm, variant)
    out1, fin1, _ = wavefront_sequence_q8(t[0], t[1][pad:], *t[2:], None,
                                          variant)
    assert torch.equal(out[pad:, 1], out1[:, 1])
    assert torch.equal(fin[:, 1], fin1[:, 1])
    assert torch.equal(out[:pad, 1], t[0][2, 1].expand(pad, 20))
    one = (t[0][0], t[1], t[2][0], t[3][0], t[6][0])
    seq, _ = warp_sequence_q8(*one, tm, variant)
    seq1, _ = warp_sequence_q8(one[0], one[1][pad:], *one[2:], None, variant)
    assert torch.equal(seq[pad:, 1], seq1[:, 1])
    assert torch.equal(seq[:pad, 1], one[0][1].expand(pad, 20))
