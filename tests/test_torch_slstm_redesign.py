"""The sLSTM kernels' two routes, on the CPU: the launch plans of
``slstm_stack_decode_kernel`` and ``slstm_stack_sequence_kernel``
(``repro_torch.kernels.slstm_cell.kernel.slstm_decode_plan`` and
``slstm_stack_seq_plan``), the warp route's arithmetic and its table of
per-layer pointers.

* Legality of the plans: the served shapes (slstm-jet's L=1 H=20 and the
  L=3 H=32 stack; B 1-64; the engine's prompt buckets) and every H <= 32
  by L 1-4 take the warp route (the decode its T = 1); a wider H, L = 5
  or a nonzero ``batch_block`` (the decode's) take the block route at the
  tile the wrapper gave it before; the grids (the kernels' index
  arithmetic, mirrored here) cover every batch row once, and the warps
  every (row, layer) and every pair of neighbouring layers once; a block
  stays within 256 threads; static shared memory within 48 KB.
* The wavefront is row 2's (``test_torch_stack_seq_redesign``'s
  discrete-event models, run at the sLSTM route's bounds): every slot
  read finds the step it expects, and every gate warp's liveness and
  x_proj arrive a tick ahead for the step it runs at that tick.
* The route's arithmetic, emulated in float32 numpy
  (:func:`wavefront_sequence`, the decode :func:`warp_decode` at T = 1:
  each gate sum and each deep projection over k in order by fma from 0,
  the epilogue in ``slstm_update``'s order with c' and n' contracted as
  the CUDA source writes them, a dead step keeping all four leaves):
  against JAX's Pallas ``slstm_stack_sequence_kernel`` in interpret mode,
  masked and not, with a fully masked row (m stays M_INIT) and a row whose
  mask dies mid-sequence; against JAX's decode reference and ``xla``
  decode (JAX's fused Pallas decode raises under this jax, caveat R1); and
  against the port's plain versions; all within ``ROUTE_TOL``.
* The pointer table: the C entry's layout (layer l's c, n, m, h at 4l ..
  4l+3, its new ones at 4L + 4l ..) filled from (L,B,H) stacks as L views
  and from per-layer leaves as they are; ``slstm_stack_decode_cuda`` on
  the CPU gives the (L,B,H) wrapper's leaves bit for bit.

No CUDA kernel runs here; on the card the warp route is held bit for bit
against the block route and within tolerance of the plain version
(``test_torch_gpu.py``, ``chip_smoke.py``, ``tools/slstm_tiles.py``).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close
from repro.configs.base import GRUConfig as JCfg
from repro.core import slstm as jslstm
from repro.kernels.slstm_cell import ref as jsref
from repro.kernels.slstm_cell.kernel import \
    slstm_stack_sequence_kernel as jseq
from repro_torch.core.slstm import M_INIT
from repro_torch.kernels import _launch
from repro_torch.kernels.slstm_cell import kernel as SK
from repro_torch.kernels.slstm_cell import ops, ref
from test_torch_stack_seq_redesign import (_prefetch_events,
                                           wavefront_events)

ROUTE_TOL = 1e-6             # float32 emulation vs JAX/torch: libm, rounding
LAUNCH_BOUND = 256           # __launch_bounds__ of the kernels
STATIC_SMEM = 48 * 1024      # a block's static shared memory
SEQ_STATIC = 4 * (SK.WARP_MAX_L * 64 + (SK.WARP_MAX_L - 1) * 2 * 128)
SERVED = ((1, 20), (3, 32))  # slstm-jet; the uniform L=3 H=32 stack
BUCKETS = (1, 2, 4, 8, 16, 32, 64)


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("LH", SERVED)
def test_served_shapes_take_the_warp_routes(LH):
    L, H = LH
    for B in range(1, 65):
        p = SK.slstm_decode_plan(B, H, L)
        assert p == SK.warp_plan(B, L)
        assert p.route == "warp" and p.rows == 1 and p.smem == 0
        assert p.threads == 32 * (2 * L - 1) <= LAUNCH_BOUND
        assert p.grid == B
        for T in BUCKETS:
            assert SK.slstm_stack_seq_plan(B, T, H, L) == p


@pytest.mark.parametrize("L", range(1, SK.WARP_MAX_L + 1))
def test_every_width_within_the_bounds_takes_the_warp_routes(L):
    for H, B in itertools.product(range(1, SK.WARP_MAX_H + 1), (1, 3, 8)):
        assert SK.slstm_decode_plan(B, H, L) == SK.warp_plan(B, L)
        assert SK.slstm_stack_seq_plan(B, 5, H, L) == SK.warp_plan(B, L)


def _block(B, H, L, bt):
    p = SK.block_plan(B, H, L, bt)
    assert p.route == "block" and p.rows == bt
    assert p.threads == SK.block_threads(H, bt) <= LAUNCH_BOUND
    assert p.threads % 32 == 0 and p.threads >= min(128, LAUNCH_BOUND)
    assert p.grid == -(-B // bt)
    assert p.smem == SK.smem_bytes(L, H, bt) <= _launch.SMEM_LIMIT
    return p


@pytest.mark.parametrize("H", (33, 40, 64, 100))
def test_wide_h_takes_the_block_route_at_the_old_tile(H):
    for B, L in itertools.product((1, 3, 8, 64), (1, 2, 3)):
        bt = min(B, _launch.DEFAULT_BATCH_BLOCK)
        if SK.smem_bytes(L, H, bt) > _launch.SMEM_LIMIT:   # as it raised
            with pytest.raises(ValueError, match="shared"):
                SK.slstm_decode_plan(B, H, L)
            with pytest.raises(ValueError, match="shared"):
                SK.slstm_stack_seq_plan(B, 16, H, L)
            continue
        assert SK.slstm_decode_plan(B, H, L) == _block(B, H, L, bt)
        assert SK.slstm_stack_seq_plan(B, 16, H, L) == _block(B, H, L, bt)


def test_depth_past_the_bound_takes_the_block_route():
    for H, B in itertools.product((5, 20, 32), (1, 8, 64)):
        for L in (SK.WARP_MAX_L + 1, SK.WARP_MAX_L + 2):
            bt = min(B, _launch.DEFAULT_BATCH_BLOCK)
            assert SK.slstm_decode_plan(B, H, L) == _block(B, H, L, bt)
            assert SK.slstm_stack_seq_plan(B, 8, H, L) == _block(B, H, L, bt)


@pytest.mark.parametrize("batch_block", (1, 2, 8, 64))
def test_a_nonzero_batch_block_selects_the_decode_block_route(batch_block):
    for (L, H), B in itertools.product(SERVED, (1, 8, 64)):
        if SK.smem_bytes(L, H, batch_block) > _launch.SMEM_LIMIT:
            with pytest.raises(ValueError, match="shared"):
                SK.slstm_decode_plan(B, H, L, batch_block)
            continue
        assert SK.slstm_decode_plan(B, H, L, batch_block) == _block(
            B, H, L, batch_block)


def test_the_bounds_cover_the_served_and_swept_depths():
    """The warp routes take the depths swept and held bit for bit against
    the block route on the card (L 1-4), no deeper, and every served
    shape."""
    assert SK.WARP_MAX_L == 4 and SK.WARP_MAX_H == 32
    for L, H in SERVED:
        assert SK.slstm_decode_plan(8, H, L).route == "warp"
        assert SK.slstm_stack_seq_plan(8, 32, H, L).route == "warp"
    assert SK.slstm_decode_plan(8, 32, 5).route == "block"
    assert SK.slstm_stack_seq_plan(8, 32, 32, 5).route == "block"


def test_plans_raise_on_what_no_route_takes():
    with pytest.raises(ValueError, match="empty"):
        SK.slstm_decode_plan(0, 20, 1)
    with pytest.raises(ValueError, match="empty"):
        SK.slstm_stack_seq_plan(8, 0, 20, 1)
    with pytest.raises(ValueError, match="batch_block"):
        SK.slstm_decode_plan(8, 20, 1, 300)
    with pytest.raises(ValueError, match="shared"):
        SK.slstm_decode_plan(8, 200, 3)
    with pytest.raises(ValueError, match="shared"):
        SK.slstm_stack_seq_plan(8, 16, 200, 3)


def _roles(p):
    """Each warp of the warp route's grid as (batch row, role, layer): the
    block is the row, warp q its position, gate warps at even q (layer
    q/2), projection warps between two layers at odd q."""
    return [(blk, "proj" if q & 1 else "gate", q >> 1)
            for blk, q in itertools.product(range(p.grid),
                                            range(p.threads // 32))]


@pytest.mark.parametrize("B", (1, 2, 3, 7, 8, 9, 33, 64, 100, 257))
def test_decode_warp_grid_covers_every_row_once(B):
    """The decode's launch is the wavefront's at T = 1: each batch row one
    block, its gate warps each layer once."""
    for H, L in itertools.product((5, 20, 32), range(1, SK.WARP_MAX_L + 1)):
        p = SK.slstm_decode_plan(B, H, L)
        assert p.grid == B and p.threads <= LAUNCH_BOUND
        gates = sorted((r, l) for r, role, l in _roles(p) if role == "gate")
        assert gates == sorted(itertools.product(range(B), range(L)))


@pytest.mark.parametrize("B", (1, 2, 3, 8, 33, 64))
@pytest.mark.parametrize("L", range(1, SK.WARP_MAX_L + 1))
def test_prefill_grid_covers_every_row_and_layer_once(B, L):
    """The block is the row, warp q its position: gate warps at even q
    (layer q/2), projection warps between two layers at odd q."""
    p = SK.slstm_stack_seq_plan(B, 16, 20, L)
    assert p.threads == 32 * (2 * L - 1) <= LAUNCH_BOUND
    roles = _roles(p)
    gates = sorted((r, l) for r, role, l in roles if role == "gate")
    projs = sorted((r, l) for r, role, l in roles if role == "proj")
    assert gates == sorted(itertools.product(range(B), range(L)))
    assert projs == sorted(itertools.product(range(B), range(L - 1)))


def test_static_shared_memory_fits():
    """The warp route asks for no dynamic shared memory: its slots, the
    deepest stack's h and projections (4 KB), are static and within the
    48 KB a block may declare."""
    assert SEQ_STATIC == 4096 <= STATIC_SMEM
    for H, L in itertools.product(range(1, SK.WARP_MAX_H + 1),
                                  range(1, SK.WARP_MAX_L + 1)):
        assert SK.slstm_decode_plan(8, H, L).smem == 0
        assert SK.slstm_stack_seq_plan(8, 16, H, L).smem == 0


# ---------------------------------------------------------------------------
# the wavefront's schedule (row 2's, at the sLSTM route's bounds)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", range(1, SK.WARP_MAX_L + 1))
def test_every_slot_is_written_before_read(L):
    for T in (1, 2, 7, 16, 33):
        held = {}
        for j, ev in enumerate(wavefront_events(T, L), start=-1):
            for kind, slot, t in ev:
                if kind == "read":
                    assert held.get(slot, (None, j))[0] == t
                    assert held[slot][1] < j
            for kind, slot, t in ev:
                if kind == "write":
                    held[slot] = (t, j)


@pytest.mark.parametrize("q", range(0, 2 * SK.WARP_MAX_L - 1, 2))
def test_each_gate_warp_gets_its_steps_liveness_a_tick_ahead(q):
    for T in (1, 5, 16, 33):
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
# the routes' arithmetic
# ---------------------------------------------------------------------------

F32 = np.float32


def _fma(a, b, c):
    """fmaf of float32 arrays: the product exact in float64, one rounding
    to float32 after the add (a double rounding is off by one ulp at most,
    rarely)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(F32)


def _lane_sum(v, w):
    """sum_k v[:, k] * w[k, :] as a lane takes it: k in order by fma from
    0 (the k past H weigh 0 and leave the sum as it is)."""
    acc = np.zeros((v.shape[0], w.shape[1]), dtype=F32)
    for k in range(v.shape[1]):
        acc = _fma(v[:, k:k + 1], w[k:k + 1], acc)
    return acc


def _update(x, a, b, c, n, m, h):
    """``slstm_update``: (x + a) + b per gate; log_sigmoid as
    -(max(-f, 0) + log1p(exp(-|f|))); lm = logsig + m; m' = max(lm, i);
    i_ = exp(i - m'), f_ = exp(lm - m'); c' = fma(f_, c, i_ * tanh(z)),
    n' = fma(f_, n, i_); h' = (sigmoid(o) * c') / max(n', 1e-6)."""
    H = h.shape[1]
    g = [(x[:, k * H:(k + 1) * H] + a[:, k * H:(k + 1) * H])
         + b[k * H:(k + 1) * H] for k in range(4)]
    z, ig, f, o = g
    lm = -(np.maximum(-f, F32(0)) + np.log1p(np.exp(-np.abs(f)))) + m
    m_new = np.maximum(lm, ig)
    i_ = np.exp(ig - m_new)
    f_ = np.exp(lm - m_new)
    c_new = _fma(f_, c, (i_ * np.tanh(z)).astype(F32))
    n_new = _fma(f_, n, i_)
    sig = F32(1) / (F32(1) + np.exp(-o))
    h_new = (sig * c_new) / np.maximum(n_new, F32(1e-6))
    return c_new, n_new, m_new.astype(F32), h_new.astype(F32)


def wavefront_sequence(leaves, xp, u, wd, b, mask):
    """The prefill's warp route, tick by tick through the slots of
    :func:`wavefront_events` (the writes land after the tick's reads): a
    gate warp's x is layer 0's x_proj or the projection warp's slot, its
    sums run over its own h slot, a dead step (the liveness of the step
    the warp runs) keeps all four leaves. Returns the top layer's h after
    every step (T,B,H) and the four final (L,B,H) leaves."""
    L = leaves[0].shape[0]
    T = xp.shape[0]
    pos = [("proj" if q & 1 else "gate", q >> 1) for q in range(2 * L - 1)]
    st = [[leaf[l].astype(F32) for leaf in leaves] for l in range(L)]
    slots = {("h", l, 1): st[l][3] for l in range(L)}
    out = []
    with np.errstate(under="ignore"):
        for j in range(T + len(pos) - 1):
            writes = {}
            for q, (role, l) in enumerate(pos):
                t = j - q
                if not 0 <= t < T:
                    continue
                if role == "proj":
                    writes[("p", l, t & 1)] = _lane_sum(
                        slots[("h", l, t & 1)], wd[l])
                    continue
                x = xp[t] if l == 0 else slots[("p", l - 1, t & 1)]
                new = _update(x, _lane_sum(slots[("h", l, (t - 1) & 1)],
                                           u[l]), b[l], *st[l])
                live = (np.ones(xp.shape[1], bool) if mask is None
                        else mask[t] != 0)[:, None]
                st[l] = [np.where(live, a, o) for a, o in zip(new, st[l])]
                writes[("h", l, t & 1)] = st[l][3]
                if l == L - 1:
                    out.append(st[l][3])
            slots.update(writes)
    return (np.stack(out),) + tuple(np.stack([s[k] for s in st])
                                    for k in range(4))


def warp_decode(leaves, xp, u, wd, b):
    """The decode's warp route: :func:`wavefront_sequence` at T = 1 with
    no mask (layer by layer: the gate sums of h_l over U_l, the update,
    and below the top the projection warp's sums of the new h over W_l as
    the next layer's x). Returns the four new (L,B,H) leaves."""
    return wavefront_sequence(leaves, xp[None], u, wd, b, None)[1:]


def _operands(L, H, B, T, seed):
    """A mid-sequence state (n > 0) with row 0 at the engine's initial
    state (c = n = h = 0, m = M_INIT); weights as the served model's;
    a mask with row 0 fully masked, row 1 live for the first steps and
    dead after, row 2 left-padded."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(F32)
    leaves = [f(L, B, H, scale=0.5), np.abs(f(L, B, H)) + F32(0.5),
              f(L, B, H), f(L, B, H, scale=0.5)]
    for k, v in enumerate((0.0, 0.0, M_INIT, 0.0)):
        leaves[k][:, 0] = v
    mask = np.ones((T, B), F32)
    mask[:, 0] = 0.0
    if B > 1:
        mask[T // 2 + 1:, 1] = 0.0
    if B > 2:
        mask[:T // 2, 2] = 0.0
    wd = (f(L - 1, H, 4 * H, scale=H ** -0.5) if L > 1
          else np.zeros((1, 1, 4 * H), F32))
    return dict(leaves=tuple(leaves), xp=f(T, B, 4 * H),
                u=f(L, H, 4 * H, scale=H ** -0.5), wd=wd,
                b=f(L, 4 * H, scale=0.3), mask=mask)


def _closes(got, want, tol=ROUTE_TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w, tol=tol)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("L,H", ((1, 5), (1, 20), (2, 20), (3, 32),
                                 (4, 7)))
@pytest.mark.parametrize("T", (1, 6))
@pytest.mark.parametrize("masked", (False, True))
def test_wavefront_matches_pallas_and_the_plain_version(L, H, T, masked):
    a = _operands(L, H, 3, T, seed=100 * L + H + T)
    m = a["mask"] if masked else None
    w = (a["u"], a["wd"], a["b"])
    got = wavefront_sequence(a["leaves"], a["xp"], *w, m)
    want = jseq(*(jnp.asarray(v) for v in (*a["leaves"], a["xp"], *w)),
                None if m is None else jnp.asarray(m), interpret=True)
    _closes(got, [np.asarray(v) for v in want])
    args = tuple(_t(v) for v in (*a["leaves"], a["xp"], *w))
    plain = ref.slstm_stack_sequence_ref(*args, _t(m))
    _closes(got, plain)
    if masked:              # the fully masked row keeps all four leaves
        for k in range(4):
            assert np.array_equal(got[1 + k][:, 0], a["leaves"][k][:, 0])
        assert (got[3][:, 0] == F32(M_INIT)).all()
    # the wrapper on CPU tensors is that plain version and launches nothing
    SK.slstm_stack_sequence_kernel.launches = 0
    wrapped = SK.slstm_stack_sequence_kernel(*args, _t(m))
    assert all(torch.equal(x, y) for x, y in zip(wrapped, plain))
    assert SK.slstm_stack_sequence_kernel.launches == 0
    assert SK.slstm_stack_seq_plan(3, T, H, L).route == "warp"


def test_a_row_whose_mask_dies_mid_sequence_freezes_there():
    """Row 1 is live for the first steps and dead after: its leaves after
    the sequence equal the run over its live steps alone, bit for bit,
    and its top-layer h stops moving where the mask dies."""
    L, H, T = 3, 20, 8
    a = _operands(L, H, 3, T, seed=5)
    w = (a["u"], a["wd"], a["b"])
    live = int(a["mask"][:, 1].sum())
    full = wavefront_sequence(a["leaves"], a["xp"], *w, a["mask"])
    part = wavefront_sequence(a["leaves"], a["xp"][:live], *w, None)
    for k in range(4):
        assert np.array_equal(full[1 + k][:, 1], part[1 + k][:, 1])
    assert np.array_equal(full[0][:live, 1], part[0][:, 1])
    assert (full[0][live:, 1] == full[0][live - 1, 1]).all()


@pytest.mark.parametrize("L,H", ((1, 5), (1, 20), (2, 31), (3, 32),
                                 (4, 20)))
@pytest.mark.parametrize("B", (1, 3))
def test_decode_warp_order_matches_jax_and_the_plain_version(L, H, B):
    a = _operands(L, H, B, 1, seed=10 * L + H + B)
    w = (a["u"], a["wd"], a["b"])
    got = warp_decode(a["leaves"], a["xp"][0], *w)
    want = jsref.slstm_stack_decode_ref(*(jnp.asarray(v) for v in (
        *a["leaves"], a["xp"][0], *w)))
    _closes(got, [np.asarray(v) for v in want])
    args = tuple(_t(v) for v in (*a["leaves"], a["xp"][0], *w))
    plain = ref.slstm_stack_decode_ref(*args)
    _closes(got, plain)
    SK.slstm_stack_decode_kernel.launches = 0
    wrapped = SK.slstm_stack_decode_kernel(*args)
    assert all(torch.equal(x, y) for x, y in zip(wrapped, plain))
    assert SK.slstm_stack_decode_kernel.launches == 0
    assert SK.slstm_decode_plan(B, H, L).route == "warp"


@pytest.mark.parametrize("L", (1, 3))
def test_decode_warp_order_matches_the_xla_decode_backend(L):
    """The same step from cells, through JAX's ``xla`` decode backend
    (each layer's x @ W by XLA): the deep cells' w are the stacked
    W_deep; the emulation takes XLA's layer-0 projection."""
    H, X, B = 32, 5, 3
    a = _operands(L, H, B, 1, seed=7 + L)
    rng = np.random.default_rng(8)
    w0 = rng.normal(size=(X, 4 * H)).astype(F32)
    x = rng.normal(size=(B, X)).astype(F32)
    cells = tuple({"w": w0 if l == 0 else a["wd"][l - 1], "u": a["u"][l],
                   "b": a["b"][l]} for l in range(L))
    cfg = JCfg(input_dim=X, hidden_dim=H, num_layers=L, family="slstm")
    state = tuple(jnp.asarray(a["leaves"][k][l]) for l in range(L)
                  for k in range(4))
    flat = jslstm.slstm_stack_decode_xla(
        tuple({k: jnp.asarray(v) for k, v in c.items()} for c in cells),
        state, jnp.asarray(x), cfg=cfg)
    xp = np.asarray(jnp.asarray(x) @ jnp.asarray(w0))     # XLA's x @ W
    got = warp_decode(a["leaves"], xp, a["u"], a["wd"], a["b"])
    want = [np.stack([np.asarray(flat[4 * l + k]) for l in range(L)])
            for k in range(4)]
    _closes(got, want)


# ---------------------------------------------------------------------------
# the decode's table of per-layer pointers
# ---------------------------------------------------------------------------

def _recording(monkeypatch):
    """Replace the C entries by a recorder of their arguments (no card)."""
    calls = []

    def launcher(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn
    monkeypatch.setattr(SK, "_launcher", launcher)
    monkeypatch.setattr(SK, "_stream", lambda dev: 0)
    return calls


def _ptrs(table):
    return [int(v) for v in table]


@pytest.mark.parametrize("L", range(1, SK.WARP_MAX_L + 1))
def test_the_table_holds_layer_views_of_the_stacks(monkeypatch, L):
    """From (L,B,H) stacks (the public wrapper's form): entry 4l + k is
    leaf k of layer l, a view at offset l*B*H of its stack; entries 4L +
    4l + k the fresh outputs' views the same way; then x_proj, u, w_deep,
    b, no mask, the h sequence (a row past the outputs, in their
    allocation), and T = 1, B, H, L."""
    calls = _recording(monkeypatch)
    B, H = 3, 20
    a = _operands(L, H, B, 1, seed=L)
    stacks = tuple(_t(v) for v in a["leaves"])
    w = tuple(_t(v) for v in (a["u"], a["wd"], a["b"]))
    xp = _t(a["xp"][0])
    out = SK.launch_decode(SK.slstm_decode_plan(B, H, L), *stacks, xp, *w)
    (name, args), = calls
    assert name == "slstm_stack_warp_launch"
    step = B * H * 4
    want = ([s.data_ptr() + l * step for l in range(L) for s in stacks]
            + [o.data_ptr() + l * step for l in range(L) for o in out])
    assert _ptrs(args[0]) == want and len(want) == 8 * L
    assert args[1:5] == tuple(t.data_ptr() for t in (xp, *w))
    assert args[5] is None
    assert args[6] == out[0].data_ptr() + 4 * L * step
    assert args[7:11] == (1, B, H, L)
    assert all(o.shape == (L, B, H) and o.is_contiguous() for o in out)


def test_the_table_takes_per_layer_leaves_in_place(monkeypatch):
    """From the served model's per-layer leaves (``ops``'s form): the
    table holds their own pointers, no stacked copy, and the fresh outputs
    are L tuples of four contiguous (B,H) leaves."""
    calls = _recording(monkeypatch)
    L, B, H = 3, 4, 32
    a = _operands(L, H, B, 1, seed=2)
    layers = tuple(tuple(_t(a["leaves"][k][l]).clone() for k in range(4))
                   for l in range(L))
    w = tuple(_t(v) for v in (a["u"], a["wd"], a["b"]))
    new = SK._launch_decode(SK.slstm_decode_plan(B, H, L), layers, None,
                            _t(a["xp"][0]), *w)
    (name, args), = calls
    out = SK._layers(new.unbind(0))
    assert _ptrs(args[0]) == ([t.data_ptr() for lay in layers for t in lay]
                              + [t.data_ptr() for lay in out for t in lay])
    assert all(t.shape == (B, H) and t.is_contiguous()
               for lay in out for t in lay)


def test_the_prefill_launches_its_plans_route(monkeypatch):
    calls = _recording(monkeypatch)
    L, B, H, T = 2, 3, 20, 5
    a = _operands(L, H, B, T, seed=3)
    args = tuple(_t(v) for v in (*a["leaves"], a["xp"], a["u"], a["wd"],
                                 a["b"]))
    mask = _t(a["mask"])
    hs, *fin = SK.launch_sequence(SK.warp_plan(B, L), *args, mask)
    (got, cargs), = calls
    step = B * H * 4
    assert got == "slstm_stack_warp_launch"
    assert _ptrs(cargs[0]) == (
        [s.data_ptr() + l * step for l in range(L) for s in args[:4]]
        + [o.data_ptr() + l * step for l in range(L) for o in fin])
    assert cargs[1:7] == tuple(t.data_ptr() for t in (*args[4:], mask, hs))
    assert cargs[7:11] == (T, B, H, L)
    calls.clear()
    hs, *fin = SK.launch_sequence(SK.block_plan(B, H, L, 2), *args, mask)
    (got, cargs), = calls
    assert got == "slstm_stack_sequence_launch"
    assert cargs[:14] == tuple(t.data_ptr() for t in (*args, mask, hs,
                                                      *fin))
    assert cargs[14:19] == (T, B, H, L, 2)


@pytest.mark.parametrize("L,H", SERVED + ((2, 5),))
def test_ops_decode_on_per_layer_leaves_equals_the_stacked_wrapper(L, H):
    """``slstm_stack_decode_cuda`` hands the flat state's own leaves to
    the kernel; on the CPU its new state equals the (L,B,H) wrapper's
    leaves bit for bit, and nothing launches."""
    B, X = 3, 5
    a = _operands(L, H, B, 1, seed=L + H)
    rng = np.random.default_rng(4)
    w0 = _t(rng.normal(size=(X, 4 * H)).astype(F32))
    x = _t(rng.normal(size=(B, X)).astype(F32))
    params = tuple({"w": w0 if l == 0 else None} for l in range(L))
    stacked = {"u": _t(a["u"]), "w_deep": _t(a["wd"]), "b": _t(a["b"])}
    state = tuple(_t(a["leaves"][k][l]).clone() for l in range(L)
                  for k in range(4))
    SK.slstm_stack_decode_kernel.launches = 0
    new = ops.slstm_stack_decode_cuda(params, state, x, stacked=stacked)
    stacks = tuple(torch.stack([state[4 * l + k] for l in range(L)])
                   for k in range(4))
    want = SK.slstm_stack_decode_kernel(*stacks, (x @ w0).contiguous(),
                                        stacked["u"], stacked["w_deep"],
                                        stacked["b"])
    assert len(new) == 4 * L
    for l, k in itertools.product(range(L), range(4)):
        assert torch.equal(new[4 * l + k], want[k][l])
    assert SK.slstm_stack_decode_kernel.launches == 0


def test_per_layer_wrapper_raises_on_what_the_kernel_does_not_take():
    L, B, H = 2, 3, 8
    a = _operands(L, H, B, 1, seed=9)
    layers = [[_t(a["leaves"][k][l]).clone() for k in range(4)]
              for l in range(L)]
    w = tuple(_t(v) for v in (a["u"], a["wd"], a["b"]))
    xp = _t(a["xp"][0])
    with pytest.raises(ValueError, match="four leaves"):
        SK.slstm_stack_decode_layers([layers[0][:3], layers[1]], xp, *w)
    bad = [list(lay) for lay in layers]
    bad[1][2] = bad[1][2][:2]                       # another batch
    with pytest.raises(ValueError):
        SK.slstm_stack_decode_layers(bad, xp, *w)
    bad = [list(lay) for lay in layers]
    bad[0][3] = bad[0][3].t().contiguous().t()      # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        SK.slstm_stack_decode_layers(bad, xp, *w)
    bad = [list(lay) for lay in layers]
    bad[1][0] = bad[1][0].double()
    with pytest.raises(TypeError):
        SK.slstm_stack_decode_layers(bad, xp, *w)
    with pytest.raises(ValueError):                 # a GRU's 3H columns
        SK.slstm_stack_decode_layers(layers, xp[:, :3 * H], *w)


def test_the_decode_block_route_reads_stacks(monkeypatch):
    """The block route reads (L,B,H) stacks: the public wrapper's own, or,
    from per-layer leaves, stacks made of them; it writes the four
    (L,B,H) outputs, views of one fresh (4,L,B,H) tensor."""
    calls = _recording(monkeypatch)
    L, B, H = 2, 3, 8
    a = _operands(L, H, B, 1, seed=6)
    stacks = tuple(_t(v) for v in a["leaves"])
    w = tuple(_t(v) for v in (a["u"], a["wd"], a["b"]))
    xp = _t(a["xp"][0])
    p = SK.block_plan(B, H, L, 2)
    out = SK.launch_decode(p, *stacks, xp, *w)
    (name, args), = calls
    assert name == "slstm_stack_decode_launch"
    assert args[:12] == tuple(t.data_ptr() for t in (*stacks, xp, *w, *out))
    assert args[12:16] == (B, H, L, 2)
    calls.clear()
    layers = tuple(tuple(s[l].clone() for s in stacks) for l in range(L))
    new = SK._launch_decode(p, layers, None, xp, *w)
    (name, args), = calls
    assert name == "slstm_stack_decode_launch"
    assert new.shape == (4, L, B, H)
    assert args[:4] != tuple(s.data_ptr() for s in stacks)
    assert args[8:12] == tuple(t.data_ptr() for t in new.unbind(0))
