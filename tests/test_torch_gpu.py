"""The port's CUDA kernels on the card, held against their plain PyTorch
versions (same inputs; largest absolute error at most 1e-5, since both are
fp32 and differ only in summation order and libm; the q8 kernels' int8
sums are exact, and their float32 epilogues round op by op as the plain
versions do).

Every test here is marked ``gpu`` and skips, from a fixture, where there
is no card. The file imports no JAX, so it runs on a machine that has
only PyTorch; there, skip the JAX-based session fixtures of
``conftest.py``::

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.params import init_params, quantize_gru_cells
from repro_torch.kernels.gru_cell import kernel as CK
from repro_torch.kernels.gru_cell import ref as cref
from repro_torch.kernels.gru_sequence import kernel as K
from repro_torch.kernels.gru_sequence import ref
from repro_torch.kernels.slstm_cell import kernel as SK
from repro_torch.kernels.slstm_cell import ref as sref
from repro_torch.models import gru_lm, slstm_lm
from repro_torch.serve.engine import Request, ServeEngine

TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(L, H, B, T, dev, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev)
    return dict(h0=rand(L, B, H, scale=0.5), xp=rand(T, B, 3 * H),
                u=rand(L, H, 3 * H, scale=H ** -0.5),
                wd=(rand(L - 1, H, 3 * H, scale=H ** -0.5) if L > 1
                    else torch.zeros(1, 1, 3 * H, device=dev)),
                b=rand(L, 3 * H, scale=0.3),
                mask=(torch.rand(T, B, generator=g) > 0.3).float().to(dev))


def _max_err(pairs):
    torch.cuda.synchronize()
    return max((g - w).abs().max().item() for g, w in pairs)


CASES = list(itertools.product(((1, 20), (3, 32)), (1, 8, 64), (8, 32),
                               ("v1", "v3"), (False, True)))


@pytest.mark.gpu
@pytest.mark.parametrize("LH,B,T,variant,masked", CASES)
def test_sequence_kernels_match_plain(cuda_device, LH, B, T, variant,
                                      masked):
    L, H = LH
    a = _inputs(L, H, B, T, cuda_device, seed=B + T)
    m = a["mask"] if masked else None
    K.reset_launch_counts()
    if L == 1:
        got = (K.gru_sequence_kernel(a["h0"][0], a["xp"], a["u"][0],
                                     a["b"][0], m, variant=variant),)
        want = (ref.gru_sequence_ref(a["h0"][0], a["xp"], a["u"][0],
                                     a["b"][0], m, variant),)
    else:
        got = K.gru_stack_sequence_kernel(a["h0"], a["xp"], a["u"], a["wd"],
                                          a["b"], m, variant=variant)
        want = ref.gru_stack_sequence_ref(a["h0"], a["xp"], a["u"], a["wd"],
                                          a["b"], m, variant)
    assert _max_err(zip(got, want)) <= TOL
    assert [k.launches for k in K.KERNELS] == [int(L == 1), int(L > 1), 0]


# the depth-1 sequence kernel's warp route (H <= 32) and block route
SEQ_WARP_CASES = list(itertools.product((1, 5, 20, 31, 32), (1, 8, 64),
                                        (1, 8, 32, 33), ("v1", "v3"),
                                        (False, True)))


def _seq_forced(h0, xp, u, b, m, variant, plan):
    """The depth-1 sequence kernel's C entry at an explicit plan (the route
    forced, as chip_smoke.py and tools/seq_tiles.py force it)."""
    from repro_torch.kernels import _launch
    T, B, H = xp.shape[0], xp.shape[1], h0.shape[1]
    out = torch.empty(T, B, H, device=xp.device)
    head = (h0.data_ptr(), xp.data_ptr(), u.data_ptr(), b.data_ptr(),
            None if m is None else m.data_ptr(), out.data_ptr(), T, B, H,
            int(variant == "v3"))
    if plan.route == "warp":
        err = K._launcher("gru_sequence_warp_launch")(
            *head, plan.rows, plan.warps, plan.depth,
            _launch.stream(xp.device))
    else:
        err = K._launcher("gru_sequence_launch")(*head, plan.rows,
                                                 _launch.stream(xp.device))
    assert err == 0
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("H,B,T,variant,masked", SEQ_WARP_CASES)
def test_sequence_warp_route_matches_plain_and_block(cuda_device, H, B, T,
                                                     variant, masked):
    """The wrapper launches seq_plan's warp route at H <= 32; it agrees with
    the plain version and with the block route forced on the same
    inputs."""
    a = _inputs(1, H, B, T, cuda_device, seed=H * 1000 + B * 10 + T)
    args = (a["h0"][0], a["xp"], a["u"][0], a["b"][0],
            a["mask"] if masked else None)
    K.reset_launch_counts()
    got = K.gru_sequence_kernel(*args, variant=variant)
    assert K.gru_sequence_kernel.last_plan == K.seq_plan(B, T, H, variant)
    assert K.gru_sequence_kernel.last_plan.route == "warp"
    assert K.gru_sequence_kernel.launches == 1
    want = ref.gru_sequence_ref(*args, variant)
    blk = _seq_forced(*args, variant, K.block_plan(B, H, min(B, 4)))
    assert _max_err([(got, want), (blk, want), (got, blk)]) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("rows,warps,depth", ((2, 1, 1), (1, 8, 8),
                                              (2, 4, 2), (1, 1, 4)))
def test_sequence_warp_route_takes_every_knob(cuda_device, rows, warps,
                                              depth):
    """Knobs the plan does not pick today but the sweep forces: B = 13 and
    T = 9 leave a ragged last warp and a ragged ring."""
    a = _inputs(1, 20, 13, 9, cuda_device, seed=rows * 100 + warps + depth)
    for variant in ("v1", "v3"):
        args = (a["h0"][0], a["xp"], a["u"][0], a["b"][0], a["mask"])
        got = _seq_forced(*args, variant,
                          K.warp_plan(13, rows, warps, depth))
        assert _max_err([(got, ref.gru_sequence_ref(*args, variant))]) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("H", (20, 32))
@pytest.mark.parametrize("variant", ("v1", "v3"))
def test_sequence_warp_route_left_padding_is_bitwise(cuda_device, H,
                                                     variant):
    """A left-padded masked prefill (ragged prompts in a T=32 bucket) ends
    bit for bit where each row's unpadded prompt ends, on the warp
    route."""
    B, T = 8, 32
    a = _inputs(1, H, B, T, cuda_device, seed=H)
    lens = [1, 5, 9, 16, 20, 31, 32, 3]
    mask = torch.ones(T, B, device=cuda_device)
    for i, n in enumerate(lens):
        mask[:T - n, i] = 0.0
    h0, xp, u, b = a["h0"][0], a["xp"], a["u"][0], a["b"][0]
    padded = K.gru_sequence_kernel(h0, xp, u, b, mask, variant=variant)
    assert K.gru_sequence_kernel.last_plan.route == "warp"
    for i, n in enumerate(lens):
        alone = K.gru_sequence_kernel(h0, xp[T - n:].contiguous(), u, b,
                                      variant=variant)
        assert torch.equal(padded[-1, i], alone[-1, i])


@pytest.mark.gpu
@pytest.mark.parametrize("H", (33, 40, 64))
@pytest.mark.parametrize("B", (1, 8))
def test_sequence_block_route_past_warp_width(cuda_device, H, B):
    """Past WARP_MAX_H the wrapper launches the block route."""
    a = _inputs(1, H, B, 8, cuda_device, seed=H + B)
    for variant in ("v1", "v3"):
        args = (a["h0"][0], a["xp"], a["u"][0], a["b"][0], a["mask"])
        got = K.gru_sequence_kernel(*args, variant=variant)
        assert K.gru_sequence_kernel.last_plan.route == "block"
        assert _max_err([(got, ref.gru_sequence_ref(*args, variant))]) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("LH", ((1, 20), (3, 32)))
@pytest.mark.parametrize("B", (1, 5, 64))
@pytest.mark.parametrize("variant", ("v1", "v3"))
@pytest.mark.parametrize("batch_block", (0, 1, 8))
def test_decode_kernel_matches_plain(cuda_device, LH, B, variant,
                                     batch_block):
    L, H = LH
    a = _inputs(L, H, B, 1, cuda_device, seed=B)
    K.reset_launch_counts()
    got = K.gru_stack_decode_kernel(a["h0"], a["xp"][0], a["u"], a["wd"],
                                    a["b"], variant=variant,
                                    batch_block=batch_block)
    want = ref.gru_stack_decode_ref(a["h0"], a["xp"][0], a["u"], a["wd"],
                                    a["b"], variant)
    assert _max_err([(got, want)]) <= TOL
    assert K.gru_stack_decode_kernel.launches == 1


@pytest.mark.gpu
def test_wrappers_raise_on_cpu_cuda_mix(cuda_device):
    a = _inputs(3, 32, 2, 1, cuda_device)
    with pytest.raises(ValueError):
        K.gru_stack_decode_kernel(a["h0"], a["xp"][0].cpu(), a["u"], a["wd"],
                                  a["b"])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("gru-jet", "gru-jet-deep"))
def test_engine_streams_cuda_equal_eager(cuda_device, arch):
    cfg = get_config(arch)
    params = init_params(gru_lm.lm_specs(cfg), seed=0, device=cuda_device)
    rng = np.random.default_rng(1)
    prompts = [rng.normal(size=(int(rng.integers(1, 21)), 5))
               .astype(np.float32) for _ in range(6)]
    streams = {}
    for backend in ("eager", "cuda"):
        c = cfg.replace(gru=dataclasses.replace(cfg.gru, backend=backend))
        eng = ServeEngine(c, params, max_batch=4, device=cuda_device)
        streams[backend] = [r.out for r in eng.generate(
            [Request(prompt=p, max_new_tokens=5) for p in prompts])]
    assert streams["cuda"] == streams["eager"]


def _q8_views(a):
    """The q8 kernels' int8 views of ``_inputs``' float32 weights."""
    L = a["u"].shape[0]
    cells = [{"w": a["wd"][l - 1] if l else a["wd"][0], "u": a["u"][l],
              "b": a["b"][l]} for l in range(L)]
    st = quantize_gru_cells(cells).stacked
    return tuple(st[k] for k in ("u_q", "u_eff", "wd_q", "wd_eff", "b"))


@pytest.mark.gpu
@pytest.mark.parametrize("LH,B,T,variant,masked", CASES)
def test_q8_sequence_kernel_matches_plain(cuda_device, LH, B, T, variant,
                                          masked):
    L, H = LH
    a = _inputs(L, H, B, T, cuda_device, seed=B + T)
    q = _q8_views(a)
    m = a["mask"] if masked else None
    K.reset_launch_counts()
    got = K.gru_stack_sequence_q8_kernel(a["h0"], a["xp"], *q, m,
                                         variant=variant)
    want = ref.gru_stack_sequence_q8_ref(a["h0"], a["xp"], *q, m, variant)
    assert _max_err(zip(got, want)) <= TOL
    assert [k.launches for k in K.Q8_KERNELS] == [1, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("LH", ((1, 20), (3, 32)))
@pytest.mark.parametrize("B", (1, 5, 64))
@pytest.mark.parametrize("variant", ("v1", "v3"))
@pytest.mark.parametrize("batch_block", (0, 1, 8))
def test_q8_decode_kernel_matches_plain(cuda_device, LH, B, variant,
                                        batch_block):
    L, H = LH
    a = _inputs(L, H, B, 1, cuda_device, seed=B)
    q = _q8_views(a)
    K.reset_launch_counts()
    got = K.gru_stack_decode_q8_kernel(a["h0"], a["xp"][0], *q,
                                       variant=variant,
                                       batch_block=batch_block)
    want = ref.gru_stack_decode_q8_ref(a["h0"], a["xp"][0], *q, variant)
    assert _max_err([(got, want)]) <= TOL
    assert [k.launches for k in K.Q8_KERNELS] == [0, 1]


@pytest.mark.gpu
def test_q8_wrappers_raise_on_float_weights_and_device_mix(cuda_device):
    a = _inputs(3, 32, 2, 1, cuda_device)
    u_q, u_eff, wd_q, wd_eff, b = _q8_views(a)
    with pytest.raises(TypeError):
        K.gru_stack_decode_q8_kernel(a["h0"], a["xp"][0], u_q.float(), u_eff,
                                     wd_q, wd_eff, b)
    with pytest.raises(ValueError):
        K.gru_stack_decode_q8_kernel(a["h0"], a["xp"][0], u_q, u_eff,
                                     wd_q.cpu(), wd_eff, b)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("gru-jet", "gru-jet-deep"))
def test_engine_streams_q8_card_equal_cpu(cuda_device, arch):
    cfg = get_config(arch)
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru,
                                              backend="cuda_fused_q8"))
    params = init_params(gru_lm.lm_specs(cfg), seed=0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.normal(size=(int(rng.integers(1, 21)), 5))
               .astype(np.float32) for _ in range(6)]
    streams = {}
    K.reset_launch_counts()
    for dev in ("cpu", cuda_device):
        eng = ServeEngine(cfg, params, max_batch=4, device=dev)
        streams[str(dev)] = [r.out for r in eng.generate(
            [Request(prompt=p, max_new_tokens=5) for p in prompts])]
        assert eng.latency_stats()["served_dtype"] == "int8"
    assert streams["cuda"] == streams["cpu"]
    assert all(k.launches > 0 for k in K.Q8_KERNELS)
    assert all(k.launches == 0 for k in K.KERNELS)


CHAIN_CASES = list(itertools.product((20, 32), (1, 8, 64), (8, 32),
                                     ("v1", "v3"), (False, True)))


@pytest.mark.gpu
@pytest.mark.parametrize("H,B,T,variant,masked", CHAIN_CASES)
def test_chain_q8_sequence_kernel_matches_plain(cuda_device, H, B, T,
                                                variant, masked):
    a = _inputs(1, H, B, T, cuda_device, seed=B + T + H)
    u_q, u_eff, _, _, b = (x[0] for x in _q8_views(a))
    m = a["mask"] if masked else None
    K.reset_launch_counts()
    got = K.gru_sequence_q8_kernel(a["h0"][0], a["xp"], u_q, u_eff, b, m,
                                   variant=variant)
    want = ref.gru_sequence_q8_ref(a["h0"][0], a["xp"], u_q, u_eff, b, m,
                                   variant)
    assert _max_err([(got, want)]) <= TOL
    assert [k.launches for k in K.CHAIN_Q8_KERNELS] == [1, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("H", (20, 32))
@pytest.mark.parametrize("B", (1, 5, 64))
@pytest.mark.parametrize("variant", ("v1", "v3"))
def test_step_q8_kernel_matches_plain(cuda_device, H, B, variant):
    a = _inputs(1, H, B, 1, cuda_device, seed=B + H)
    u_q, u_eff, _, _, b = (x[0] for x in _q8_views(a))
    K.reset_launch_counts()
    got = CK.gru_step_q8(a["h0"][0], a["xp"][0], u_q, u_eff, b,
                         variant=variant)
    want = cref.gru_step_q8_ref(a["h0"][0], a["xp"][0], u_q, u_eff, b,
                                variant)
    assert _max_err([(got, want)]) <= TOL
    assert [k.launches for k in K.CHAIN_Q8_KERNELS] == [0, 1]


# the q8 step's warp route (H <= 32) and block route
STEP_Q8_CASES = list(itertools.product((1, 4, 5, 20, 31, 32), (1, 3, 8, 33),
                                       ("v1", "v3")))


def _step_q8_forced(args, variant, plan, vec=None):
    """The q8 step's C entry at an explicit plan (the route forced, as
    chip_smoke.py and tools/step_q8_tiles.py force it); ``vec`` None: the
    wrapper's choice of word loads."""
    from repro_torch.kernels import _launch
    h, xp, u_q, u_eff, b = args
    B, H = h.shape
    out = torch.empty(B, H, device=h.device)
    head = (h.data_ptr(), xp.data_ptr(), u_q.data_ptr(), u_eff.data_ptr(),
            b.data_ptr(), out.data_ptr(), B, H, int(variant == "v3"))
    if plan.route == "warp":
        vec = CK.q8_words(H, u_q) if vec is None else vec
        err = _launch.launcher("gru_cell_q8", "gru_step_q8_warp_launch",
                               CK._WARP_ARGS)(
            *head, plan.warps, vec, _launch.stream(h.device))
    else:
        err = _launch.launcher("gru_cell_q8", "gru_step_q8_launch",
                               CK._ARGTYPES)(*head, plan.rows,
                                             _launch.stream(h.device))
    assert err == 0
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("H,B,variant", STEP_Q8_CASES)
def test_step_q8_warp_route_matches_block_and_plain(cuda_device, H, B,
                                                    variant):
    """The wrapper launches step_q8_plan's warp route at H <= 32; it equals
    the block route forced on the same inputs bit for bit (exact int32
    sums, the same float32 ops) and the plain version within TOL; where H
    % 4 == 0 the byte loads of U give the word loads' bits."""
    a = _inputs(1, H, B, 1, cuda_device, seed=H * 100 + B)
    u_q, u_eff, _, _, b = (x[0] for x in _q8_views(a))
    args = (a["h0"][0], a["xp"][0], u_q, u_eff, b)
    K.reset_launch_counts()
    got = CK.gru_step_q8(*args, variant=variant)
    assert CK.gru_step_q8.last_plan == CK.step_q8_plan(B, H, variant)
    assert CK.gru_step_q8.last_plan.route == "warp"
    assert [k.launches for k in K.CHAIN_Q8_KERNELS] == [0, 1]
    blk = _step_q8_forced(args, variant,
                          CK.step_q8_block_plan(B, H, min(B, 4)))
    want = cref.gru_step_q8_ref(*args, variant)
    assert _max_err([(got, want), (blk, want)]) <= TOL
    assert torch.equal(got, blk)
    if H % 4 == 0:
        by_bytes = _step_q8_forced(args, variant,
                                   CK.step_q8_plan(B, H, variant), vec=0)
        torch.cuda.synchronize()
        assert torch.equal(by_bytes, got)


@pytest.mark.gpu
@pytest.mark.parametrize("H", (5, 20, 31, 32))
@pytest.mark.parametrize("skew", (1, 2, 3))
def test_step_q8_warp_route_reads_a_misaligned_u(cuda_device, H, skew):
    """u_q as a view ``skew`` bytes past a 4-byte boundary: the warp route
    reads its rows through the aligned words that cover them and equals
    the block route bit for bit."""
    a = _inputs(1, H, 8, 1, cuda_device, seed=H + skew)
    u_q, u_eff, _, _, b = (x[0] for x in _q8_views(a))
    flat = torch.randint(-127, 128, (skew + u_q.numel() + 8,),
                         dtype=torch.int8, device=cuda_device)
    view = flat[skew:skew + u_q.numel()].view_as(u_q)
    view.copy_(u_q)
    args = (a["h0"][0], a["xp"][0], view, u_eff, b)
    assert view.data_ptr() % 4 == skew and CK.q8_words(H, view) == 0
    for variant in ("v1", "v3"):
        got = CK.gru_step_q8(*args, variant=variant)
        assert CK.gru_step_q8.last_plan.route == "warp"
        blk = _step_q8_forced(args, variant,
                              CK.step_q8_block_plan(8, H, 4))
        torch.cuda.synchronize()
        assert torch.equal(got, blk)
        assert torch.equal(got, CK.gru_step_q8(a["h0"][0], a["xp"][0], u_q,
                                               u_eff, b, variant=variant))


@pytest.mark.gpu
@pytest.mark.parametrize("warps", (1, 2, 4, 8))
def test_step_q8_warp_route_takes_every_warp_count(cuda_device, warps):
    a = _inputs(1, 32, 33, 1, cuda_device, seed=warps)
    u_q, u_eff, _, _, b = (x[0] for x in _q8_views(a))
    args = (a["h0"][0], a["xp"][0], u_q, u_eff, b)
    for variant in ("v1", "v3"):
        got = _step_q8_forced(args, variant, CK.step_q8_warp_plan(33, warps))
        want = CK.gru_step_q8(*args, variant=variant)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("H", (33, 48))
def test_step_q8_block_route_past_warp_width(cuda_device, H):
    a = _inputs(1, H, 8, 1, cuda_device, seed=H)
    u_q, u_eff, _, _, b = (x[0] for x in _q8_views(a))
    args = (a["h0"][0], a["xp"][0], u_q, u_eff, b)
    for variant in ("v1", "v3"):
        got = CK.gru_step_q8(*args, variant=variant)
        assert CK.gru_step_q8.last_plan.route == "block"
        assert _max_err([(got, cref.gru_step_q8_ref(*args, variant))]) <= TOL


# the fused decode kernels' warp routes (rows 3 and 5, H <= 32) and block
# routes, at the sweep's shapes (tools/decode_tiles.py)
DECODE_WARP_CASES = list(itertools.product(
    ((1, 1), (1, 5), (1, 20), (2, 31), (3, 20), (3, 32), (4, 32)),
    (1, 8, 64), ("v1", "v3")))


def _decode_forced(args, variant, plan, q8, vec=None):
    """A fused decode kernel's C entry at an explicit plan (the route
    forced, as chip_smoke.py and tools/decode_tiles.py force it); ``args``
    the wrapper's (h, x_proj, weights...); ``vec`` None: the wrapper's
    choice of the q8 route's word loads."""
    from repro_torch.kernels import _launch
    h = args[0]
    L, B, H = h.shape
    out = torch.empty(L, B, H, device=h.device)
    head = (*(t.data_ptr() for t in args), out.data_ptr(), B, H, L,
            int(variant == "v3"))
    name = "gru_stack_decode_q8" if q8 else "gru_stack_decode"
    if plan.route == "warp":
        tail = (plan.warps,) + ((K.decode_q8_words(H, args[2], args[4])
                                 if vec is None else vec,) if q8 else ())
        err = K._launcher(f"{name}_warp_launch")(*head, *tail,
                                                   _launch.stream(h.device))
    else:
        err = K._launcher(f"{name}_launch")(*head, plan.rows,
                                            _launch.stream(h.device))
    assert err == 0
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("LH,B,variant", DECODE_WARP_CASES)
def test_decode_warp_route_matches_block_and_plain(cuda_device, LH, B,
                                                   variant):
    """Row 3: the wrapper launches decode_plan's warp route at H <= 32; it
    equals the block route forced on the same inputs bit for bit (k-order
    fma sums, the same epilogues) and the plain version within TOL."""
    L, H = LH
    a = _inputs(L, H, B, 1, cuda_device, seed=100 * L + H + B)
    args = (a["h0"], a["xp"][0], a["u"], a["wd"], a["b"])
    K.reset_launch_counts()
    got = K.gru_stack_decode_kernel(*args, variant=variant)
    assert K.gru_stack_decode_kernel.last_plan == K.decode_plan(B, H, L,
                                                                variant)
    assert K.gru_stack_decode_kernel.last_plan.route == "warp"
    assert [k.launches for k in K.KERNELS] == [0, 0, 1]
    blk = _decode_forced(args, variant,
                         K.decode_block_plan(B, H, L, min(B, 4)), False)
    want = ref.gru_stack_decode_ref(*args, variant)
    assert _max_err([(got, want), (blk, want)]) <= TOL
    assert torch.equal(got, blk)


@pytest.mark.gpu
@pytest.mark.parametrize("warps", (1, 2, 4, 8))
def test_decode_warp_route_takes_every_knob(cuda_device, warps):
    a = _inputs(3, 32, 33, 1, cuda_device, seed=warps)
    args = (a["h0"], a["xp"][0], a["u"], a["wd"], a["b"])
    for variant in ("v1", "v3"):
        got = _decode_forced(args, variant, K.decode_warp_plan(33, warps),
                             False)
        want = K.gru_stack_decode_kernel(*args, variant=variant)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


# the fused prefill's warp route (row 2, H <= 32, L <= 4) and block route,
# at the sweep's shapes (tools/stack_seq_tiles.py)
STACK_WARP_CASES = list(itertools.product(
    ((1, 5), (2, 31), (3, 20), (3, 32), (4, 32)), (1, 8, 64), (1, 16, 33),
    ("v1", "v3"), (False, True)))


def _stack_forced(args, variant, plan):
    """The fused prefill's C entry at an explicit plan (the route forced,
    as chip_smoke.py and tools/stack_seq_tiles.py force it); ``args`` the
    wrapper's (h0, x_proj, u, w_deep, b, mask)."""
    from repro_torch.kernels import _launch
    h0, xp = args[0], args[1]
    L, B, H = h0.shape
    T = xp.shape[0]
    out = torch.empty(T, B, H, device=xp.device)
    finals = torch.empty(L, B, H, device=xp.device)
    head = (*(None if t is None else t.data_ptr() for t in args),
            out.data_ptr(), finals.data_ptr(), T, B, H, L,
            int(variant == "v3"))
    if plan.route == "warp":
        err = K._launcher("gru_stack_sequence_warp_launch")(
            *head, _launch.stream(xp.device))
    else:
        err = K._launcher("gru_stack_sequence_launch")(
            *head, plan.rows, _launch.stream(xp.device))
    assert err == 0
    return out, finals


@pytest.mark.gpu
@pytest.mark.parametrize("LH,B,T,variant,masked", STACK_WARP_CASES)
def test_stack_sequence_warp_route_matches_block_and_plain(
        cuda_device, LH, B, T, variant, masked):
    """Row 2: the wrapper launches stack_seq_plan's warp route at H <= 32
    and L <= 4; it equals the block route forced on the same inputs bit
    for bit (the same sums and epilogues, only their schedule differs) and
    the plain version within TOL."""
    L, H = LH
    a = _inputs(L, H, B, T, cuda_device, seed=1000 * L + 10 * H + B + T)
    args = (a["h0"], a["xp"], a["u"], a["wd"], a["b"],
            a["mask"] if masked else None)
    K.reset_launch_counts()
    got = K.gru_stack_sequence_kernel(*args, variant=variant)
    p = K.gru_stack_sequence_kernel.last_plan
    assert p == K.stack_seq_plan(B, T, H, L, variant) and p.route == "warp"
    assert [k.launches for k in K.KERNELS] == [0, 1, 0]
    blk = _stack_forced(args, variant,
                        K.stack_seq_block_plan(B, H, L, min(B, 4)))
    want = ref.gru_stack_sequence_ref(*args, variant)
    assert _max_err(list(zip(got, want)) + list(zip(blk, want))) <= TOL
    assert all(torch.equal(g_, b_) for g_, b_ in zip(got, blk))


@pytest.mark.gpu
@pytest.mark.parametrize("bt", (1, 2, 4, 8))
@pytest.mark.parametrize("L", (1, 2, 3, 4))
def test_stack_sequence_warp_route_matches_every_block_tile(cuda_device, bt,
                                                            L):
    """The warp route gives the block route's bits at every batch tile
    (1, 2, 4 or 8 rows a block, a B the tile does not divide), v1 and
    v3, masked."""
    a = _inputs(L, 32, 7, 12, cuda_device, seed=L + 10 * bt)
    args = (a["h0"], a["xp"], a["u"], a["wd"], a["b"], a["mask"])
    for variant in ("v1", "v3"):
        got = _stack_forced(args, variant, K.stack_seq_warp_plan(7, L))
        blk = _stack_forced(args, variant,
                            K.stack_seq_block_plan(7, 32, L, bt))
        torch.cuda.synchronize()
        assert all(torch.equal(g_, b_) for g_, b_ in zip(got, blk))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ("v1", "v3"))
def test_stack_sequence_warp_route_left_padding_is_bitwise(cuda_device,
                                                           variant):
    """A left-padded row's outputs from its first live step on, and its
    finals, equal its unpadded run's bit for bit: the dead steps keep every
    layer's h, the live ones run exactly the unmasked arithmetic."""
    a = _inputs(3, 32, 3, 12, cuda_device, seed=5)
    pad = 5
    mask = torch.ones(12, 3, device=cuda_device)
    mask[:pad, 1] = 0.0
    w = (a["u"], a["wd"], a["b"])
    out, fin = K.gru_stack_sequence_kernel(a["h0"], a["xp"], *w, mask,
                                           variant=variant)
    out1, fin1 = K.gru_stack_sequence_kernel(
        a["h0"][:, 1:2].contiguous(), a["xp"][pad:, 1:2].contiguous(), *w,
        variant=variant)
    torch.cuda.synchronize()
    assert torch.equal(out[pad:, 1], out1[:, 0])
    assert torch.equal(fin[:, 1], fin1[:, 0])
    assert torch.equal(out[:pad, 1], a["h0"][2, 1].expand(pad, 32))


@pytest.mark.gpu
@pytest.mark.parametrize("LH", ((3, 33), (5, 32), (3, 32)))
@pytest.mark.parametrize("batch_block", (0, 1, 8))
def test_stack_sequence_block_route_past_the_bounds(cuda_device, LH,
                                                    batch_block):
    """Past H = 32 or the layer bound, or with a nonzero batch_block, the
    wrapper launches the block route at its tile."""
    L, H = LH
    a = _inputs(L, H, 8, 9, cuda_device, seed=L + H)
    args = (a["h0"], a["xp"], a["u"], a["wd"], a["b"], a["mask"])
    got = K.gru_stack_sequence_kernel(*args, variant="v1",
                                      batch_block=batch_block)
    p = K.gru_stack_sequence_kernel.last_plan
    warp = H <= 32 and L <= K.STACK_WARP_MAX_L and not batch_block
    assert p.route == ("warp" if warp else "block")
    if not warp:
        assert p.rows == (batch_block or 4)
    want = ref.gru_stack_sequence_ref(*args, "v1")
    assert _max_err(list(zip(got, want))) <= TOL


# the q8 prefills' warp routes (row 6, the q8 chain's layer, at H <= 32;
# row 4, the fused q8 prefill, at H <= 32 and L <= 4) and block routes, at
# the sweep's shapes (tools/seq_q8_tiles.py); H = 31 has rows that are not
# 4-byte aligned, which the warp routes read through their cover words
SEQ_Q8_WARP_CASES = list(itertools.product(
    (20, 32, 31), (1, 8, 64), (1, 8, 16, 32), ("v1", "v3"), (False, True)))
STACK_Q8_WARP_CASES = list(itertools.product(
    ((1, 20), (1, 31), (2, 32), (3, 20), (3, 32), (4, 32)), (1, 8, 64),
    (1, 8, 16, 32), ("v1", "v3"), (False, True)))


def _seq_q8_forced(args, variant, plan, vec=None):
    """The depth-1 q8 sequence's C entry at an explicit plan (the route
    forced, as chip_smoke.py and tools/seq_q8_tiles.py force it); ``args``
    the wrapper's (h0, x_proj, u_q, u_eff, b, mask); ``vec`` None: the
    wrapper's choice of word loads."""
    from repro_torch.kernels import _launch
    h0, xp, u_q = args[0], args[1], args[2]
    T, B, H = xp.shape[0], xp.shape[1], h0.shape[1]
    out = torch.empty(T, B, H, device=xp.device)
    head = (*(None if t is None else t.data_ptr() for t in args),
            out.data_ptr(), T, B, H, int(variant == "v3"))
    if plan.route == "warp":
        err = K._launcher("gru_sequence_q8_warp_launch")(
            *head, plan.warps, K.q8_words(H, u_q) if vec is None else vec,
            _launch.stream(xp.device))
    else:
        err = K._launcher("gru_sequence_q8_launch")(
            *head, plan.rows, _launch.stream(xp.device))
    assert err == 0
    return out


def _stack_q8_forced(args, variant, plan, vec=None):
    """The fused q8 prefill's C entry at an explicit plan (the route
    forced); ``args`` the wrapper's (h0, x_proj, u_q, u_eff, wd_q, wd_eff,
    b, mask); ``vec`` None: the wrapper's choice of word loads."""
    from repro_torch.kernels import _launch
    h0, xp = args[0], args[1]
    L, B, H = h0.shape
    T = xp.shape[0]
    out = torch.empty(T, B, H, device=xp.device)
    finals = torch.empty(L, B, H, device=xp.device)
    head = (*(None if t is None else t.data_ptr() for t in args),
            out.data_ptr(), finals.data_ptr(), T, B, H, L,
            int(variant == "v3"))
    if plan.route == "warp":
        err = K._launcher("gru_stack_sequence_q8_warp_launch")(
            *head, K.decode_q8_words(H, args[2], args[4]) if vec is None
            else vec, _launch.stream(xp.device))
    else:
        err = K._launcher("gru_stack_sequence_q8_launch")(
            *head, plan.rows, _launch.stream(xp.device))
    assert err == 0
    return out, finals


def _skewed(t, skew, dev):
    """A copy of int8 ``t`` as a view ``skew`` bytes past a 4-byte boundary,
    among foreign bytes."""
    flat = torch.randint(-127, 128, (skew + t.numel() + 8,), dtype=torch.int8,
                         device=dev)
    v = flat[skew:skew + t.numel()].view_as(t)
    v.copy_(t)
    return v


@pytest.mark.gpu
@pytest.mark.parametrize("H,B,T,variant,masked", SEQ_Q8_WARP_CASES)
def test_seq_q8_warp_route_matches_block_and_plain(cuda_device, H, B, T,
                                                   variant, masked):
    """Row 6: the wrapper launches seq_q8_plan's warp route at H <= 32; it
    equals the block route forced on the same inputs bit for bit (the same
    int32 sums and float32 ops, only their schedule differs) and the plain
    version within TOL; where H % 4 == 0 the cover loads give the word
    loads' bits."""
    a = _inputs(1, H, B, T, cuda_device, seed=10 * H + B + T)
    u_q, u_eff, _, _, b = (x[0] for x in _q8_views(a))
    args = (a["h0"][0], a["xp"], u_q, u_eff, b,
            a["mask"] if masked else None)
    K.reset_launch_counts()
    got = K.gru_sequence_q8_kernel(*args, variant=variant)
    p = K.gru_sequence_q8_kernel.last_plan
    assert p == K.seq_q8_plan(B, T, H, variant) and p.route == "warp"
    assert [k.launches for k in K.CHAIN_Q8_KERNELS] == [1, 0]
    blk = _seq_q8_forced(args, variant, K.block_plan(B, H, min(B, 4), True))
    want = ref.gru_sequence_q8_ref(*args, variant)
    assert _max_err([(got, want), (blk, want)]) <= TOL
    assert torch.equal(got, blk)
    if H % 4 == 0:
        cover = _seq_q8_forced(args, variant, p, vec=0)
        torch.cuda.synchronize()
        assert torch.equal(cover, got)


@pytest.mark.gpu
@pytest.mark.parametrize("H", (5, 20, 32))
@pytest.mark.parametrize("skew", (1, 2, 3))
def test_seq_q8_warp_route_reads_misaligned_rows(cuda_device, H, skew):
    """u_q as a view ``skew`` bytes past a 4-byte boundary: the warp route
    reads its rows through the aligned words that cover them and equals
    the block route bit for bit."""
    a = _inputs(1, H, 8, 12, cuda_device, seed=H + skew)
    u_q, u_eff, _, _, b = (x[0] for x in _q8_views(a))
    args = (a["h0"][0], a["xp"], _skewed(u_q, skew, cuda_device), u_eff, b,
            a["mask"])
    assert K.q8_words(H, args[2]) == 0
    for variant in ("v1", "v3"):
        got = K.gru_sequence_q8_kernel(*args, variant=variant)
        assert K.gru_sequence_q8_kernel.last_plan.route == "warp"
        blk = _seq_q8_forced(args, variant, K.block_plan(8, H, 4, True))
        torch.cuda.synchronize()
        assert torch.equal(got, blk)


@pytest.mark.gpu
@pytest.mark.parametrize("warps", (1, 2, 4, 8))
def test_seq_q8_warp_route_takes_every_warp_count(cuda_device, warps):
    """Every warps a block the C entry takes gives the plan's bits (a B
    that they do not divide)."""
    a = _inputs(1, 32, 13, 11, cuda_device, seed=warps)
    u_q, u_eff, _, _, b = (x[0] for x in _q8_views(a))
    args = (a["h0"][0], a["xp"], u_q, u_eff, b, a["mask"])
    for variant in ("v1", "v3"):
        got = _seq_q8_forced(args, variant,
                             K.warp_plan(13, 1, warps, K.SEQ_Q8_DEPTH))
        want = K.gru_sequence_q8_kernel(*args, variant=variant)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("LH,B,T,variant,masked", STACK_Q8_WARP_CASES)
def test_stack_q8_warp_route_matches_block_and_plain(cuda_device, LH, B, T,
                                                     variant, masked):
    """Row 4: the wrapper launches stack_seq_q8_plan's warp route at H <= 32
    and L <= 4; it equals the block route forced bit for bit and the plain
    version within TOL; where H % 4 == 0 the cover loads give the word
    loads' bits."""
    L, H = LH
    a = _inputs(L, H, B, T, cuda_device, seed=1000 * L + 10 * H + B + T)
    args = (a["h0"], a["xp"], *_q8_views(a), a["mask"] if masked else None)
    K.reset_launch_counts()
    got = K.gru_stack_sequence_q8_kernel(*args, variant=variant)
    p = K.gru_stack_sequence_q8_kernel.last_plan
    assert p == K.stack_seq_q8_plan(B, T, H, L, variant)
    assert p.route == "warp"
    assert [k.launches for k in K.Q8_KERNELS] == [1, 0]
    blk = _stack_q8_forced(args, variant, K.stack_seq_block_plan(
        B, H, L, min(B, 4), True))
    want = ref.gru_stack_sequence_q8_ref(*args, variant)
    assert _max_err(list(zip(got, want)) + list(zip(blk, want))) <= TOL
    assert all(torch.equal(g_, b_) for g_, b_ in zip(got, blk))
    if H % 4 == 0:
        cover = _stack_q8_forced(args, variant, p, vec=0)
        torch.cuda.synchronize()
        assert all(torch.equal(g_, b_) for g_, b_ in zip(got, cover))


@pytest.mark.gpu
@pytest.mark.parametrize("H", (5, 20, 32))
@pytest.mark.parametrize("skew", (1, 2, 3))
def test_stack_q8_warp_route_reads_misaligned_rows(cuda_device, H, skew):
    """u_q and wd_q as views ``skew`` bytes past a 4-byte boundary: the warp
    route reads their rows through the cover words and equals the block
    route bit for bit."""
    a = _inputs(3, H, 8, 12, cuda_device, seed=H + skew)
    u_q, u_eff, wd_q, wd_eff, b = _q8_views(a)
    args = (a["h0"], a["xp"], _skewed(u_q, skew, cuda_device), u_eff,
            _skewed(wd_q, skew, cuda_device), wd_eff, b, a["mask"])
    assert K.decode_q8_words(H, args[2], args[4]) == 0
    for variant in ("v1", "v3"):
        got = K.gru_stack_sequence_q8_kernel(*args, variant=variant)
        assert K.gru_stack_sequence_q8_kernel.last_plan.route == "warp"
        blk = _stack_q8_forced(args, variant,
                               K.stack_seq_block_plan(8, H, 3, 4, True))
        torch.cuda.synchronize()
        assert all(torch.equal(g_, b_) for g_, b_ in zip(got, blk))


@pytest.mark.gpu
@pytest.mark.parametrize("LH", ((3, 33), (5, 32), (1, 48)))
def test_q8_prefills_take_the_block_routes_past_the_bounds(cuda_device, LH):
    """Past H = 32, or (row 4) past the layer bound, the wrappers launch the
    block route at the old tile, within TOL of the plain version."""
    L, H = LH
    a = _inputs(L, H, 8, 9, cuda_device, seed=L + H)
    q = _q8_views(a)
    args = (a["h0"], a["xp"], *q, a["mask"])
    got = K.gru_stack_sequence_q8_kernel(*args, variant="v1")
    p = K.gru_stack_sequence_q8_kernel.last_plan
    assert p.route == "block" and p.rows == 4
    want = ref.gru_stack_sequence_q8_ref(*args, "v1")
    assert _max_err(list(zip(got, want))) <= TOL
    if H > 32:
        one = (a["h0"][0], a["xp"], q[0][0], q[1][0], q[4][0], a["mask"])
        got = K.gru_sequence_q8_kernel(*one, variant="v1")
        p = K.gru_sequence_q8_kernel.last_plan
        assert p.route == "block" and p.rows == 4
        want = ref.gru_sequence_q8_ref(*one, "v1")
        assert _max_err([(got, want)]) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ("v1", "v3"))
def test_q8_prefill_warp_routes_left_padding_is_bitwise(cuda_device,
                                                        variant):
    """A left-padded row's outputs from its first live step on, and its
    finals, equal its unpadded run's bit for bit on both warp routes."""
    a = _inputs(3, 32, 3, 12, cuda_device, seed=5)
    q = _q8_views(a)
    pad = 5
    mask = torch.ones(12, 3, device=cuda_device)
    mask[:pad, 1] = 0.0
    out, fin = K.gru_stack_sequence_q8_kernel(a["h0"], a["xp"], *q, mask,
                                              variant=variant)
    out1, fin1 = K.gru_stack_sequence_q8_kernel(
        a["h0"][:, 1:2].contiguous(), a["xp"][pad:, 1:2].contiguous(), *q,
        variant=variant)
    one = (q[0][0], q[1][0], q[4][0])
    seq = K.gru_sequence_q8_kernel(a["h0"][0], a["xp"], *one, mask,
                                   variant=variant)
    seq1 = K.gru_sequence_q8_kernel(a["h0"][0, 1:2].contiguous(),
                                    a["xp"][pad:, 1:2].contiguous(), *one,
                                    variant=variant)
    torch.cuda.synchronize()
    assert torch.equal(out[pad:, 1], out1[:, 0])
    assert torch.equal(fin[:, 1], fin1[:, 0])
    assert torch.equal(out[:pad, 1], a["h0"][2, 1].expand(pad, 32))
    assert torch.equal(seq[pad:, 1], seq1[:, 0])
    assert torch.equal(seq[:pad, 1], a["h0"][0, 1].expand(pad, 32))


@pytest.mark.gpu
@pytest.mark.parametrize("LH,B,variant", DECODE_WARP_CASES)
def test_q8_decode_warp_route_matches_block_and_plain(cuda_device, LH, B,
                                                      variant):
    """Row 5: decode_q8_plan's warp route at H <= 32 and L <= 3 (the block
    route at L = 4, past the layers a lane holds); it equals the block
    route forced bit for bit and the plain version within TOL; where H % 4
    == 0 the cover loads give the word loads' bits."""
    L, H = LH
    a = _inputs(L, H, B, 1, cuda_device, seed=100 * L + H + B)
    args = (a["h0"], a["xp"][0], *_q8_views(a))
    K.reset_launch_counts()
    got = K.gru_stack_decode_q8_kernel(*args, variant=variant)
    plan = K.gru_stack_decode_q8_kernel.last_plan
    assert plan == K.decode_q8_plan(B, H, L, variant)
    assert plan.route == ("warp" if L <= K.DECODE_Q8_WARP_MAX_L
                          else "block")
    assert [k.launches for k in K.Q8_KERNELS] == [0, 1]
    blk = _decode_forced(args, variant,
                         K.decode_block_plan(B, H, L, min(B, 4), True), True)
    want = ref.gru_stack_decode_q8_ref(*args, variant)
    assert _max_err([(got, want), (blk, want)]) <= TOL
    assert torch.equal(got, blk)
    if plan.route == "warp" and H % 4 == 0:
        cover = _decode_forced(args, variant, plan, True, vec=0)
        torch.cuda.synchronize()
        assert torch.equal(cover, got)


@pytest.mark.gpu
@pytest.mark.parametrize("H", (5, 20, 32))
@pytest.mark.parametrize("skew", (1, 2, 3))
def test_q8_decode_warp_route_reads_misaligned_rows(cuda_device, H, skew):
    """u_q and wd_q as views ``skew`` bytes past a 4-byte boundary: the warp
    route reads their rows through the aligned words that cover them and
    equals the block route bit for bit."""
    a = _inputs(3, H, 8, 1, cuda_device, seed=H + skew)
    u_q, u_eff, wd_q, wd_eff, b = _q8_views(a)
    views = []
    for t in (u_q, wd_q):
        flat = torch.randint(-127, 128, (skew + t.numel() + 8,),
                             dtype=torch.int8, device=cuda_device)
        v = flat[skew:skew + t.numel()].view_as(t)
        v.copy_(t)
        views.append(v)
    args = (a["h0"], a["xp"][0], views[0], u_eff, views[1], wd_eff, b)
    assert K.decode_q8_words(H, views[0], views[1]) == 0
    for variant in ("v1", "v3"):
        got = K.gru_stack_decode_q8_kernel(*args, variant=variant)
        assert K.gru_stack_decode_q8_kernel.last_plan.route == "warp"
        blk = _decode_forced(args, variant, K.decode_block_plan(8, H, 3, 4,
                                                                True), True)
        torch.cuda.synchronize()
        assert torch.equal(got, blk)


@pytest.mark.gpu
@pytest.mark.parametrize("warps", (1, 2, 4, 8))
def test_q8_decode_warp_route_takes_every_warp_count(cuda_device, warps):
    a = _inputs(3, 32, 33, 1, cuda_device, seed=warps)
    args = (a["h0"], a["xp"][0], *_q8_views(a))
    for variant in ("v1", "v3"):
        got = _decode_forced(args, variant,
                             K.decode_warp_plan(33, warps), True)
        want = K.gru_stack_decode_q8_kernel(*args, variant=variant)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("q8", (False, True))
def test_decode_batch_block_selects_the_block_route(cuda_device, q8):
    """A nonzero batch_block keeps its JAX meaning, the block route's tile;
    wider H takes the block route too."""
    for L, H, bb, route in ((3, 32, 2, "block"), (1, 20, 8, "block"),
                            (3, 32, 0, "warp"), (1, 40, 0, "block")):
        a = _inputs(L, H, 8, 1, cuda_device, seed=H + bb)
        if q8:
            args = (a["h0"], a["xp"][0], *_q8_views(a))
            got = K.gru_stack_decode_q8_kernel(*args, batch_block=bb)
            plan = K.gru_stack_decode_q8_kernel.last_plan
            want = ref.gru_stack_decode_q8_ref(*args)
        else:
            args = (a["h0"], a["xp"][0], a["u"], a["wd"], a["b"])
            got = K.gru_stack_decode_kernel(*args, batch_block=bb)
            plan = K.gru_stack_decode_kernel.last_plan
            want = ref.gru_stack_decode_ref(*args)
        assert plan.route == route and (not bb or plan.rows == bb)
        assert _max_err([(got, want)]) <= TOL


def _chain_cfg(arch, layer_dims, backend):
    cfg = get_config(arch)
    gru = dataclasses.replace(cfg.gru, backend=backend)
    if layer_dims:
        gru = dataclasses.replace(gru, layer_dims=layer_dims)
    return cfg.replace(gru=gru)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,layer_dims", (("gru-jet", ()),
                                             ("gru-jet-deep", ()),
                                             ("gru-jet-deep", (32, 32, 20))))
def test_chain_backends_launch_per_layer(cuda_device, arch, layer_dims):
    """Both chains on the card: L launches per prefill and per step, no
    other kernel; fp32 streams equal the eager engine's, q8 streams equal
    the CPU run of the same pin."""
    rng = np.random.default_rng(2)
    prompts = [rng.normal(size=(int(rng.integers(1, 21)), 5))
               .astype(np.float32) for _ in range(6)]
    streams = {}
    for backend in ("eager", "cuda_chain", "cuda_chain_q8"):
        cfg = _chain_cfg(arch, layer_dims, backend)
        L = cfg.gru.resolved_num_layers
        params = init_params(gru_lm.lm_specs(cfg), seed=0, device="cpu")
        for dev in ((cuda_device, "cpu") if backend == "cuda_chain_q8"
                    else (cuda_device,)):
            K.reset_launch_counts()
            eng = ServeEngine(cfg, params, max_batch=4, device=dev)
            streams[backend, str(dev)] = [r.out for r in eng.generate(
                [Request(prompt=p, max_new_tokens=5) for p in prompts])]
            if dev == "cpu" or backend == "eager":
                continue
            prefills = len(eng.prefill_backends)
            steps = eng.latency_stats()["steps"] + 1
            assert set(eng.prefill_backends) == {backend}
            counts = {k.__name__: k.launches
                      for k in K.KERNELS + K.Q8_KERNELS + K.CHAIN_Q8_KERNELS}
            want = dict.fromkeys(counts, 0)
            if backend == "cuda_chain":
                want["gru_sequence_kernel"] = L * (prefills + steps)
            else:
                want["gru_sequence_q8_kernel"] = L * prefills
                want["gru_step_q8"] = L * steps
            assert counts == want
    assert streams["cuda_chain", "cuda"] == streams["eager", "cuda"]
    assert streams["cuda_chain_q8", "cuda"] == streams["cuda_chain_q8", "cpu"]


# ---------------------------------------------------------------------------
# the fused sLSTM kernels
# ---------------------------------------------------------------------------

def _slstm_inputs(L, H, B, T, dev, seed=0):
    """A mid-sequence state (n > 0), and row 0 at the engine's initial
    state (c = n = h = 0, m = M_INIT); a ragged left-padded mask whose
    row 0 is fully masked when B > 1, so M_INIT is carried through."""
    from repro_torch.core.slstm import M_INIT
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g)
    leaves = [rand(L, B, H, scale=0.5), rand(L, B, H).abs() + 0.5,
              rand(L, B, H), rand(L, B, H, scale=0.5)]
    for k, v in enumerate((0.0, 0.0, M_INIT, 0.0)):
        leaves[k][:, 0] = v
    mask = torch.ones(T, B)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    for i in range(B):
        mask[:T - int(lens[i]), i] = 0.0
    if B > 1:
        mask[:, 0] = 0.0
    a = dict(leaves=[x.to(dev) for x in leaves],
             xp=rand(T, B, 4 * H).to(dev),
             u=rand(L, H, 4 * H, scale=H ** -0.5).to(dev),
             wd=(rand(L - 1, H, 4 * H, scale=H ** -0.5) if L > 1
                 else torch.zeros(1, 1, 4 * H)).to(dev),
             b=rand(L, 4 * H, scale=0.3).to(dev), mask=mask.to(dev))
    return a


SLSTM_CASES = list(itertools.product(((1, 20), (3, 32)), (1, 8, 64),
                                     (8, 32), (False, True)))


@pytest.mark.gpu
@pytest.mark.parametrize("LH,B,T,masked", SLSTM_CASES)
def test_slstm_sequence_kernel_matches_plain(cuda_device, LH, B, T, masked):
    L, H = LH
    a = _slstm_inputs(L, H, B, T, cuda_device, seed=B + T)
    m = a["mask"] if masked else None
    args = (*a["leaves"], a["xp"], a["u"], a["wd"], a["b"], m)
    K.reset_launch_counts()
    got = SK.slstm_stack_sequence_kernel(*args)
    want = sref.slstm_stack_sequence_ref(*args)
    assert _max_err(zip(got, want)) <= TOL
    if masked and B > 1:        # the fully masked row keeps all four leaves
        for k in range(4):
            assert torch.equal(got[1 + k][:, 0], a["leaves"][k][:, 0])
    assert [k.launches for k in SK.SLSTM_KERNELS] == [1, 0]
    assert all(k.launches == 0 for k in K.KERNELS + K.Q8_KERNELS
               + K.CHAIN_Q8_KERNELS)


@pytest.mark.gpu
@pytest.mark.parametrize("LH", ((1, 20), (3, 32)))
@pytest.mark.parametrize("B", (1, 5, 64))
@pytest.mark.parametrize("batch_block", (0, 1, 8))
def test_slstm_decode_kernel_matches_plain(cuda_device, LH, B, batch_block):
    L, H = LH
    a = _slstm_inputs(L, H, B, 1, cuda_device, seed=B)
    args = (*a["leaves"], a["xp"][0], a["u"], a["wd"], a["b"])
    K.reset_launch_counts()
    got = SK.slstm_stack_decode_kernel(*args, batch_block=batch_block)
    want = sref.slstm_stack_decode_ref(*args)
    assert _max_err(zip(got, want)) <= TOL
    assert [k.launches for k in SK.SLSTM_KERNELS] == [0, 1]


SLSTM_ROUTE_CASES = list(itertools.product((1, 5, 20, 31, 32), (1, 2, 3, 4),
                                           (1, 8, 64)))


def _same_bits(xs, ys):
    return all(torch.equal(x, y) for x, y in zip(xs, ys))


@pytest.mark.gpu
@pytest.mark.parametrize("H,L,B", SLSTM_ROUTE_CASES)
def test_slstm_decode_warp_route_equals_the_block_route(cuda_device, H, L,
                                                        B):
    """The decode's warp route (its plan at every H <= 32, L <= 4): within
    TOL of the plain version, bit for bit the block route forced at the
    tile the wrapper gave it before, the same bits on a second launch, and
    from per-layer leaves (the served form) the same bits again; the same
    bits as the prefill's warp route over the one step."""
    a = _slstm_inputs(L, H, B, 1, cuda_device, seed=H + 10 * L + B)
    args = (*a["leaves"], a["xp"][0], a["u"], a["wd"], a["b"])
    K.reset_launch_counts()
    got = SK.slstm_stack_decode_kernel(*args)
    plan = SK.slstm_stack_decode_kernel.last_plan
    assert plan == SK.slstm_decode_plan(B, H, L) and plan.route == "warp"
    again = SK.slstm_stack_decode_kernel(*args)
    layers = tuple(tuple(leaf[l] for leaf in a["leaves"]) for l in range(L))
    per = SK.slstm_stack_decode_layers(layers, *args[4:])
    blk = SK.launch_decode(SK.block_plan(B, H, L, min(B, 4)), *args)
    seq = SK.launch_sequence(plan, *a["leaves"], a["xp"][:1], *args[5:])
    want = sref.slstm_stack_decode_ref(*args)
    assert _max_err(zip(got, want)) <= TOL
    assert _same_bits(got, blk) and _same_bits(got, again)
    assert _same_bits(got, seq[1:])
    assert all(torch.equal(per[l][k], got[k][l])
               for l, k in itertools.product(range(L), range(4)))
    assert [k.launches for k in SK.SLSTM_KERNELS] == [0, 3]


@pytest.mark.gpu
@pytest.mark.parametrize("H,L,B", SLSTM_ROUTE_CASES)
@pytest.mark.parametrize("masked", (False, True))
def test_slstm_sequence_warp_route_equals_the_block_route(cuda_device, H, L,
                                                          B, masked):
    """The prefill's warp route (its plan at every H <= 32, L <= 4): within
    TOL of the plain version, bit for bit the block route forced beside
    it, the same bits on a second launch; a fully masked row keeps its
    leaves, m = M_INIT included."""
    T = 17
    a = _slstm_inputs(L, H, B, T, cuda_device, seed=H + 10 * L + B)
    m = a["mask"] if masked else None
    args = (*a["leaves"], a["xp"], a["u"], a["wd"], a["b"], m)
    K.reset_launch_counts()
    got = SK.slstm_stack_sequence_kernel(*args)
    plan = SK.slstm_stack_sequence_kernel.last_plan
    assert plan == SK.slstm_stack_seq_plan(B, T, H, L)
    assert plan.route == "warp"
    again = SK.slstm_stack_sequence_kernel(*args)
    blk = SK.launch_sequence(SK.block_plan(B, H, L, min(B, 4)), *args)
    want = sref.slstm_stack_sequence_ref(*args)
    assert _max_err(zip(got, want)) <= TOL
    assert _same_bits(got, blk) and _same_bits(got, again)
    if masked and B > 1:
        for k in range(4):
            assert torch.equal(got[1 + k][:, 0], a["leaves"][k][:, 0])
    assert [k.launches for k in SK.SLSTM_KERNELS] == [2, 0]


@pytest.mark.gpu
def test_slstm_wrappers_raise_on_device_mix(cuda_device):
    a = _slstm_inputs(3, 32, 2, 1, cuda_device)
    with pytest.raises(ValueError):
        SK.slstm_stack_decode_kernel(*a["leaves"], a["xp"][0].cpu(), a["u"],
                                     a["wd"], a["b"])


@pytest.mark.gpu
@pytest.mark.parametrize("layers", ((), (3, 32)), ids=("slstm-jet", "deep"))
def test_slstm_engine_launches_and_streams(cuda_device, layers):
    """``cuda`` on the card: one sequence launch per prefill, one decode
    launch per step, no GRU kernel; class streams equal the eager
    engine's on the card."""
    cfg = get_config("slstm-jet")
    if layers:
        cfg = cfg.replace(gru=dataclasses.replace(
            cfg.gru, num_layers=layers[0], hidden_dim=layers[1]))
    params = init_params(slstm_lm.lm_specs(cfg), seed=0, device=cuda_device)
    rng = np.random.default_rng(1)
    prompts = [rng.normal(size=(int(rng.integers(1, 21)), 5))
               .astype(np.float32) for _ in range(6)]
    streams = {}
    for backend in ("eager", "cuda"):
        c = cfg.replace(gru=dataclasses.replace(cfg.gru, backend=backend))
        K.reset_launch_counts()
        eng = ServeEngine(c, params, max_batch=4, device=cuda_device)
        streams[backend] = [r.out for r in eng.generate(
            [Request(prompt=p, max_new_tokens=5) for p in prompts])]
    prefills = len(eng.prefill_backends)
    steps = eng.latency_stats()["steps"] + 1
    assert set(eng.prefill_backends) == {"cuda_fused"}
    assert [k.launches for k in SK.SLSTM_KERNELS] == [prefills, steps]
    assert all(k.launches == 0 for k in K.KERNELS + K.Q8_KERNELS
               + K.CHAIN_Q8_KERNELS)
    assert streams["cuda"] == streams["eager"]


# ---------------------------------------------------------------------------
# the dense LM's attention kernels: flash attention (prefill), flash decode
# ---------------------------------------------------------------------------
#
# fp32: within 1e-5 of the plain versions (other summation orders). bf16
# inputs: both compute in fp32 from the same bf16 values; flash decode
# returns fp32 (within 1e-5 again), flash attention rounds its output to
# bf16, so the two may differ by one bf16 ulp (2**-8 relative): within
# rtol = atol = 2**-7.

from repro_torch.kernels.decode_attn import kernel as DK  # noqa: E402
from repro_torch.kernels.decode_attn import ref as dref  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attn import ref as fref  # noqa: E402

BF16_TOL = 2.0 ** -7
# (B, Hq, Hkv, Sq, Sk, D, causal, window): qwen3's heads at the served
# lengths, off-tile lengths, a window, causal off, Sq > Sk (rows with no
# valid key), GQA 4, small head dims
ATTN_CASES = [
    (4, 16, 8, 12, 12, 128, True, 0),
    (4, 16, 8, 128, 128, 128, True, 0),
    (1, 16, 8, 300, 300, 128, True, 0),
    (2, 16, 8, 200, 200, 128, True, 48),
    (1, 8, 2, 45, 77, 64, False, 0),
    (1, 4, 4, 40, 8, 16, True, 4),
    (2, 8, 2, 33, 33, 32, False, 7),
    (1, 4, 2, 50, 50, 18, True, 0),     # D off the 4- and 8-value vectors
    (1, 16, 8, 2048, 2048, 128, True, 0),     # long prefill, causal
    (1, 16, 8, 2048, 2048, 128, True, 256),   # long prefill, a window
]


def _rand(shape, g, dev, dtype):
    return torch.randn(*shape, generator=g).to(dev).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", ATTN_CASES)
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, B, Hq, Hkv,
                                              Sq, Sk, D, causal, window):
    g = torch.Generator().manual_seed(Sq + Sk + D)
    q = _rand((B, Hq, Sq, D), g, cuda_device, dtype)
    k = _rand((B, Hkv, Sk, D), g, cuda_device, dtype)
    v = _rand((B, Hkv, Sk, D), g, cuda_device, dtype)
    K.reset_launch_counts()
    got = FK.flash_attention(q, k, v, causal=causal, window=window)
    want = fref.flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and FK.flash_attention.launches == 1
    assert bool(torch.isfinite(got).all())
    tol = TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # rows with no valid key give exactly 0
    no_key = ~fref._mask(Sq, 0, Sk, causal, window, "cpu").any(-1)
    assert torch.count_nonzero(got[:, :, no_key.to(cuda_device)]) == 0


# (B, Hkv, G, C, D, written positions (from, to), pos, window)
DECODE_ATTN_CASES = [
    (4, 8, 2, 76, 128, (0, 12), 12, 0),          # served: S=12 + 64 slots
    (4, 8, 2, 192, 128, (0, 143), 143, 0),       # served: S=128 + 64
    (2, 8, 2, 100, 128, (30, 250), 250, 0),      # wrapped ring, full
    (2, 8, 2, 100, 128, (30, 250), 250, 37),     # wrapped ring, window
    (1, 2, 4, 50, 64, (0, 20), 20, 0),           # empty (-1) slots
    (1, 2, 2, 16, 16, None, 0, 0),               # fully masked cache
    (1, 2, 3, 70, 18, (0, 69), 69, 0),           # D off the vectors
    (1, 8, 2, 2112, 128, (0, 2048), 2048, 0),    # long cache, 16 splits
    (2, 8, 2, 65, 128, (0, 64), 64, 0),          # C just above one tile
    (1, 8, 2, 2112, 128, (1990, 2100), 2100, 0), # valid only in the last split
    (1, 2, 8, 130, 64, (0, 129), 129, 0),        # G = 8 (8 warps)
    (1, 1, 16, 300, 128, (0, 299), 299, 0),      # G = 16, split and merged
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("B,Hkv,G,C,D,written,pos,window", DECODE_ATTN_CASES)
def test_flash_decode_kernel_matches_plain(cuda_device, dtype, B, Hkv, G, C,
                                           D, written, pos, window):
    from repro_torch.kernels.decode_attn.ops import valid_slots
    g = torch.Generator().manual_seed(C + pos + D)
    q = _rand((B, Hkv, G, D), g, cuda_device, dtype)
    kc = _rand((B, Hkv, C, D), g, cuda_device, dtype)
    vc = _rand((B, Hkv, C, D), g, cuda_device, dtype)
    slot_pos = torch.full((C,), -1, dtype=torch.int32)
    if written is not None:
        for p in range(written[0], written[1] + 1):
            slot_pos[p % C] = p
    mask = valid_slots(slot_pos.to(cuda_device), pos, window)
    K.reset_launch_counts()
    got = DK.flash_decode(q, kc, vc, mask)
    want = dref.flash_decode_plain(q, kc, vc, mask)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and DK.flash_decode.launches == 1
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    if written is None:
        assert torch.count_nonzero(got) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_attention_kernels_are_deterministic(cuda_device, dtype):
    """Two launches on the same inputs give the same bits: no atomics, a
    fixed merge order over the decode splits."""
    g = torch.Generator().manual_seed(5)
    q = _rand((1, 16, 2048, 128), g, cuda_device, dtype)
    k = _rand((1, 8, 2048, 128), g, cuda_device, dtype)
    v = _rand((1, 8, 2048, 128), g, cuda_device, dtype)
    a = FK.flash_attention(q, k, v, causal=True)
    b = FK.flash_attention(q, k, v, causal=True)
    qd = _rand((1, 8, 2, 128), g, cuda_device, dtype)
    kc = _rand((1, 8, 2112, 128), g, cuda_device, dtype)
    vc = _rand((1, 8, 2112, 128), g, cuda_device, dtype)
    mask = torch.rand(2112, generator=g).to(cuda_device) < 0.9
    c = DK.flash_decode(qd, kc, vc, mask)
    d = DK.flash_decode(qd, kc, vc, mask)
    torch.cuda.synchronize()
    assert DK.num_splits(1, 8, 2112, DK.sm_count(cuda_device)) > 1
    assert torch.equal(a, b) and torch.equal(c, d)


@pytest.mark.gpu
def test_bf16_flash_attention_runs_on_the_tensor_cores(cuda_device):
    """The bf16 kernel of the built library issues wgmma (HGMMA in its
    SASS); the fp32 kernel stays on the CUDA cores."""
    from repro_torch.kernels import _build
    functions = _build.sass("flash_attn")
    tc = [body for name, body in functions.items()
          if "flash_attention_tc" in name]
    assert len(tc) == 2                          # D <= 64 and D <= 128
    assert all("HGMMA" in body for body in tc)
    assert not any("HGMMA" in body for name, body in functions.items()
                   if "flash_attention_k" in name)


@pytest.mark.gpu
def test_attention_wrappers_raise_on_device_mix(cuda_device):
    q = torch.zeros(1, 2, 4, 16, device=cuda_device)
    with pytest.raises(ValueError):
        FK.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError):
        DK.flash_decode(q, q, q, torch.ones(4, dtype=torch.bool))


@pytest.mark.gpu
def test_lm_engine_launches_and_streams(cuda_device):
    """qwen3-0.6b at SMOKE size in fp32 on the card: ``cuda`` launches
    flash attention once per layer and prefill and flash decode once per
    layer and step, and its token streams equal ``chunked``'s."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import transformer
    base = get_smoke_config("qwen3-0.6b").replace(dtype="float32")
    params = init_params(transformer.lm_specs(base), seed=0,
                         device=cuda_device)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, base.vocab_size, size=n).astype(np.int32)
               for n in (3, 9, 5)]
    streams = {}
    for impl in ("chunked", "cuda"):
        K.reset_launch_counts()
        eng = ServeEngine(base.replace(attn_impl=impl), params, max_batch=4,
                          device=cuda_device)
        streams[impl] = [r.out for r in eng.generate(
            [Request(prompt=p, max_new_tokens=6) for p in prompts])]
    steps = eng.latency_stats()["steps"] + 1
    L = base.num_layers
    assert [FK.flash_attention.launches, DK.flash_decode.launches] == \
        [L, L * steps]
    assert streams["cuda"] == streams["chunked"]


# the LM zoo's heads (Hq, Hkv, D): qwen2-moe-a2.7b (MHA, G = 1),
# qwen3-moe-235b-a22b (G = 16, the decode kernel's MAX_G), phi4-mini-3.8b
# (G = 3), qwen2.5-3b (G = 8), command-r-35b (G = 8)
ZOO_HEADS = ((16, 16, 128), (64, 4, 128), (24, 8, 128), (16, 2, 128),
             (64, 8, 128))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("Hq,Hkv,D", ZOO_HEADS)
def test_attention_kernels_at_the_zoo_heads(cuda_device, dtype, Hq, Hkv, D):
    """Both attention kernels against their plain versions at the served
    S = 128 wave's shapes (prefill causal, decode C = 192) of every
    transformer config's heads."""
    from repro_torch.kernels.decode_attn.ops import valid_slots
    g = torch.Generator().manual_seed(Hq * 7 + Hkv)
    q = _rand((4, Hq, 128, D), g, cuda_device, dtype)
    k = _rand((4, Hkv, 128, D), g, cuda_device, dtype)
    v = _rand((4, Hkv, 128, D), g, cuda_device, dtype)
    got = FK.flash_attention(q, k, v, causal=True)
    want = fref.flash_attention_plain(q, k, v, True, 0)
    tol = TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    qd = _rand((4, Hkv, Hq // Hkv, D), g, cuda_device, dtype)
    kc = _rand((4, Hkv, 192, D), g, cuda_device, dtype)
    vc = _rand((4, Hkv, 192, D), g, cuda_device, dtype)
    slot_pos = torch.full((192,), -1, dtype=torch.int32)
    slot_pos[:129] = torch.arange(129, dtype=torch.int32)
    mask = valid_slots(slot_pos.to(cuda_device), 128, 0)
    got = DK.flash_decode(qd, kc, vc, mask)
    torch.testing.assert_close(got, dref.flash_decode_plain(qd, kc, vc, mask),
                               rtol=TOL, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("qwen2-moe-a2.7b", "command-r-35b"))
def test_init_prepared_equals_prepare_params_on_the_card(cuda_device, arch):
    """The leaf-by-leaf build (cast on the way to the card in blocks of
    the first axis) gives ``prepare_params`` of the fp32 tree bit for
    bit."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.params import flatten
    from repro_torch.models import transformer
    cfg = get_smoke_config(arch)
    want = transformer.prepare_params(
        init_params(transformer.lm_specs(cfg), seed=3, device="cpu"), cfg,
        cuda_device)
    got = transformer.init_prepared(cfg, seed=3, device=cuda_device)
    fw, fg = flatten(want), flatten(got)
    assert list(fw) == list(fg)
    for k in fw:
        assert fg[k].device.type == "cuda" and fg[k].dtype == fw[k].dtype
        assert torch.equal(fg[k], fw[k]), k


@pytest.mark.gpu
def test_moe_engine_launches_and_streams(cuda_device):
    """qwen2-moe-a2.7b at SMOKE size in fp32 on the card: ``cuda`` launches
    flash attention once per layer and prefill and flash decode once per
    layer and step, no other kernel of the port, and its token streams
    equal ``chunked``'s."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import transformer
    base = get_smoke_config("qwen2-moe-a2.7b").replace(dtype="float32")
    params = transformer.init_prepared(base, seed=0, device=cuda_device)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, base.vocab_size, size=n).astype(np.int32)
               for n in (3, 9, 5, 12)]
    streams = {}
    for impl in ("chunked", "cuda"):
        K.reset_launch_counts()
        eng = ServeEngine(base.replace(attn_impl=impl), params, max_batch=4,
                          device=cuda_device)
        streams[impl] = [r.out for r in eng.generate(
            [Request(prompt=p, max_new_tokens=6) for p in prompts])]
    steps = eng.latency_stats()["steps"] + 1
    L = base.num_layers
    assert [FK.flash_attention.launches, DK.flash_decode.launches] == \
        [L, L * steps]
    others = K.KERNELS + K.Q8_KERNELS + K.CHAIN_Q8_KERNELS + \
        SK.SLSTM_KERNELS + K.ROWWISE_KERNELS + K.SHARD_KERNELS
    assert all(k.launches == 0 for k in others)
    assert streams["cuda"] == streams["chunked"]


# ---------------------------------------------------------------------------
# The paper's row-wise primitives: the single GRU step (fused and blocked)
# through gru_step_cuda, and the row-wise / cascade matmuls through
# rowwise / cascade, at the widths chip_smoke.py drives.
# Tolerances: fp32 1e-5 (step) and rtol=atol=2e-4 (matmuls), as the CPU
# parity tests; a bf16 u rounds h and r*h to bf16 before each product, and
# a summation-order difference in r can move r*h across a bf16 rounding
# boundary (one bf16 ulp of one operand), so the bf16 step is held to
# 1e-2; bf16 matmul outputs round to bf16: rtol=atol=2e-2.
# ---------------------------------------------------------------------------

from repro_torch.kernels.gru_cell import ops as cops  # noqa: E402
from repro_torch.kernels.rowwise_matvec import kernel as MK  # noqa: E402
from repro_torch.kernels.rowwise_matvec import ops as mops  # noqa: E402
from repro_torch.kernels.rowwise_matvec import ref as mref  # noqa: E402

STEP_BF16_TOL = 1e-2
# (B, H, variant, u dtype, the kernel JAX's dispatch rule picks)
STEP_CASES = (
    [(B, H, v, dt, "gru_step_fused") for B in (1, 8) for H in (20, 32)
     for v in ("v1", "v3") for dt in ("float32", "bfloat16")]
    + [(B, H, "v1", "float32", "gru_step_blocked") for B in (1, 8)
       for H in (1024, 2048)]
    + [(B, 2048, "v1", "bfloat16", "gru_step_blocked") for B in (1, 8)]
    + [(B, 1024, "v3", "float32", "gru_step_fused") for B in (1, 8)]
    + [(B, 1000, "v1", "float32", "gru_step_fused") for B in (1, 8)])


def _step_inputs(B, H, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, H, generator=g).to(dev),
            torch.randn(B, 3 * H, generator=g).to(dev),
            (torch.randn(H, 3 * H, generator=g) * H ** -0.5).to(dev)
            .to(dtype),
            (0.1 * torch.randn(3 * H, generator=g)).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,variant,dtype,kernel", STEP_CASES)
def test_step_kernels_match_plain(cuda_device, B, H, variant, dtype,
                                  kernel):
    h, xp, u, b = _step_inputs(B, H, getattr(torch, dtype), cuda_device,
                               B + H)
    K.reset_launch_counts()
    got = cops.gru_step_cuda(h, xp, u, b, variant)
    want = cref.gru_step_ref(h, xp, u, b, variant)
    torch.cuda.synchronize()
    assert {f.__name__: f.launches for f in CK.STEP_KERNELS} == {
        n: int(n == kernel) for n in ("gru_step_fused", "gru_step_blocked")}
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    tol = TOL if dtype == "float32" else STEP_BF16_TOL
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# The step's new routes (warp at H <= 32, wide for v1) against the column
# tile each kernel launched before, forced through the C entries
# (``kernel.launch_step`` with ``kernel.tile_step_plan``), and against the
# plain version: H 20 and 32 (the warp route's constant widths), 31 (any
# width, ragged), 1000, 1024 and 2048; B 1, 8 and 64; fp32 and bf16 u.
NEW_ROUTE_KINDS = (("gru_step_fused", "v1"), ("gru_step_fused", "v3"),
                   ("gru_step_blocked", "v1"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("B", (1, 8, 64))
@pytest.mark.parametrize("H", (20, 31, 32, 1000, 1024, 2048))
@pytest.mark.parametrize("kernel,variant", NEW_ROUTE_KINDS)
def test_step_new_routes_match_old_route_and_plain(cuda_device, kernel,
                                                   variant, H, B, dtype):
    dt = getattr(torch, dtype)
    h, xp, u, b = _step_inputs(B, H, dt, cuda_device, 3 * H + B)
    blocked = kernel == "gru_step_blocked"
    K.reset_launch_counts()
    if blocked:
        got = CK.gru_step_blocked(h, xp, u, b, block_n=256 if H % 256 == 0
                                  else H)
    else:
        got = CK.gru_step_fused(h, xp, u, b, variant=variant)
    fn = getattr(CK, kernel)
    assert fn.launches == 1
    p = fn.last_plan
    assert p == CK.step_plan(B, H, variant, dt, kernel,
                             CK.sm_count(cuda_device))
    want_route = ("warp" if not blocked and H <= CK.STEP_WARP_MAX_H
                  else "wide" if variant == "v1" else "tile")
    assert p.route == want_route
    old = CK.launch_step(CK.tile_step_plan("blocked" if blocked else variant,
                                           B, H, dt),
                         h, xp, u, b, variant, blocked)
    again = CK.launch_step(p, h, xp, u, b, variant, blocked)
    want = cref.gru_step_ref(h, xp, u, b, variant)
    torch.cuda.synchronize()
    tol = TOL if dtype == "float32" else STEP_BF16_TOL
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    torch.testing.assert_close(got, old, rtol=tol, atol=tol)
    assert torch.equal(got, again)
    assert fn.launches == 1                  # forced launches count nothing


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("skew", (1, 2, 3))
def test_wide_route_reads_a_misaligned_u(cuda_device, dtype, skew):
    """A view of u that starts ``skew`` elements into its storage: the
    wide route copies element by element, and agrees with the plain
    version and with the aligned u bit for bit (the same order)."""
    B, H = 8, 1024
    h, xp, u, b = _step_inputs(B, H, dtype, cuda_device, skew)
    flat = torch.zeros(u.numel() + skew, device=cuda_device, dtype=dtype)
    flat[skew:] = u.reshape(-1)
    uv = flat[skew:].view(H, 3 * H)
    assert uv.is_contiguous() and uv.data_ptr() % 16 != 0
    got = CK.gru_step_blocked(h, xp, uv, b, block_n=256)
    assert CK.gru_step_blocked.last_plan.route == "wide"
    aligned = CK.gru_step_blocked(h, xp, u, b, block_n=256)
    want = cref.gru_step_ref(h, xp, uv, b, "v1")
    torch.cuda.synchronize()
    tol = TOL if dtype == torch.float32 else STEP_BF16_TOL
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.equal(got, aligned)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("cw", (4, 8, 16))
def test_wide_route_takes_every_column_width(cuda_device, cw, dtype):
    """The sweep's knob: every column width, and a streaming ring (chunks of
    one unit, two stages), agree with the plain version."""
    B, H = 8, 512
    h, xp, u, b = _step_inputs(B, H, dtype, cuda_device, cw)
    want = cref.gru_step_ref(h, xp, u, b, "v1")
    tol = TOL if dtype == torch.float32 else STEP_BF16_TOL
    for p in (CK.wide_step_plan(B, H, dtype, cw=cw),
              CK.wide_step_plan(B, H, dtype, cw=cw,
                                kc=CK.wide_kc_unit(cw), stages=2)):
        got = CK.launch_step(p, h, xp, u, b, "v1", False)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# (B, K, N): JAX's test shapes, the paper's matvec, qwen3-0.6b's MLP, and
# ragged shapes: N = 20 and 100 (in bf16 rows of w that 16-byte copies
# cannot read: the plain-load route), K = 1000 and 3000 (auto_blocks'
# block_k of 8: a k-block shorter than a 16-row mma step), B = 1, 3, 5, 8
MATMUL_CASES = ((1, 16, 32), (4, 96, 256), (8, 128, 128), (2, 64, 512),
                (8, 32, 96), (4, 1024, 3072), (4, 3072, 1024),
                (1, 1000, 20), (3, 3000, 100), (5, 1000, 100),
                (8, 3000, 20))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("B,Kc,N", MATMUL_CASES)
@pytest.mark.parametrize("vector", (False, True), ids=("2d", "1d"))
def test_matmul_kernels_match_plain(cuda_device, dtype, B, Kc, N, vector):
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(Kc + N)
    x = torch.randn(B, Kc, generator=g).to(cuda_device).to(dt)
    w = (torch.randn(Kc, N, generator=g) * Kc ** -0.5).to(cuda_device).to(dt)
    if vector:
        x = x[0]
    K.reset_launch_counts()
    got_r = mops.rowwise(x, w)
    assert [f.launches for f in MK.MATVEC_KERNELS] == [1, 0]
    got_c = mops.cascade(x, w)
    x2 = x[None] if vector else x
    bk = mops.auto_blocks(x2.shape[0], Kc, N, x2.element_size())[2]
    want_r = mref.rowwise_matmul_ref(x2, w)
    want_c = mref.cascade_matmul_ref(x2, w, bk).to(dt)
    torch.cuda.synchronize()
    assert [f.launches for f in MK.MATVEC_KERNELS] == [1, 1]
    tol = 2e-4 if dtype == "float32" else 2e-2
    for got, want in ((got_r, want_r), (got_c, want_c)):
        got = got[None] if vector else got
        assert got.dtype == dt and bool(torch.isfinite(got.float()).all())
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def _mm_operands(B, Kc, N, dtype, dev, seed, w_offset=0):
    """x (B, Kc) and w (Kc, N) on the card; w a contiguous view that starts
    ``w_offset`` elements into its storage."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, Kc, generator=g).to(dev).to(dtype)
    flat = torch.zeros(Kc * N + w_offset, device=dev, dtype=dtype)
    flat[w_offset:] = (torch.randn(Kc * N, generator=g) * Kc ** -0.5).to(
        dev).to(dtype)
    return x, flat[w_offset:].view(Kc, N)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("block_k", (16, 32, 64, 96, 24))
def test_cascade_block_k_matches_plain(cuda_device, dtype, block_k):
    """Explicit k-blocks: 16, 32 and 64 rows, 96 (two stages in bf16 and
    fp32, the second half full) and 24 (a k-block that ends inside a
    16-row mma step and inside a stage)."""
    x, w = _mm_operands(4, 384, 256, dtype, cuda_device, block_k)
    K.reset_launch_counts()
    got = MK.cascade_matmul(x, w, block_k=block_k)
    want = mref.cascade_matmul_ref(x, w, block_k)
    torch.cuda.synchronize()
    assert MK.cascade_matmul.launches == 1
    assert got.dtype == torch.float32
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("B,Kc,N", ((4, 256, 128), (3, 1000, 100)))
def test_matmul_kernels_take_a_misaligned_w(cuda_device, dtype, B, Kc, N):
    """A view of w that starts one element into its storage: 16-byte copies
    cannot read it, so both kernels take the plain-load route, and agree
    with their plain versions."""
    x, w = _mm_operands(B, Kc, N, dtype, cuda_device, Kc, w_offset=1)
    assert w.is_contiguous() and w.data_ptr() % 16 != 0
    K.reset_launch_counts()
    got_r = MK.rowwise_matmul(x, w)
    got_c = MK.cascade_matmul(x, w, block_k=Kc)
    torch.cuda.synchronize()
    assert MK.rowwise_matmul.last_plan.route == "plain"
    assert MK.cascade_matmul.last_plan.route == "plain"
    assert [f.launches for f in MK.MATVEC_KERNELS] == [1, 1]
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got_r.float(),
                               mref.rowwise_matmul_ref(x, w).float(),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(got_c, mref.cascade_matmul_ref(x, w, Kc),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("B,Kc,N,block_k", ((4, 1024, 3072, 512),
                                            (4, 3072, 1024, 512),
                                            (8, 32, 96, 32),
                                            (3, 3000, 100, 8)))
def test_matmul_kernels_are_deterministic(cuda_device, dtype, B, Kc, N,
                                          block_k):
    """Two launches on the same inputs give the same bits (fixed warp,
    butterfly and k-block orders; no atomics), each raising its counter by
    exactly one."""
    x, w = _mm_operands(B, Kc, N, dtype, cuda_device, N)
    K.reset_launch_counts()
    r1 = MK.rowwise_matmul(x, w)
    r2 = MK.rowwise_matmul(x, w)
    c1 = MK.cascade_matmul(x, w, block_k=block_k)
    c2 = MK.cascade_matmul(x, w, block_k=block_k)
    torch.cuda.synchronize()
    assert [f.launches for f in MK.MATVEC_KERNELS] == [2, 2]
    assert torch.equal(r1, r2) and torch.equal(c1, c2)


@pytest.mark.gpu
def test_bf16_matmuls_run_on_the_tensor_cores(cuda_device):
    """Every bf16 instantiation of the row-wise/cascade kernel issues
    mma.sync (HMMA in its SASS); the fp32 ones stay on the CUDA cores."""
    from repro_torch.kernels import _build
    functions = {n: b for n, b in _build.sass("rowwise_matvec").items()
                 if "matmul_k" in n}
    bf16 = [b for n, b in functions.items() if "nv_bfloat16" in n]
    assert len(bf16) == 8                # rowwise and cascade, 4 tiles
    assert all("HMMA" in b for b in bf16)
    assert not any("HMMA" in b for n, b in functions.items()
                   if "nv_bfloat16" not in n)


@pytest.mark.gpu
def test_rowwise_wrappers_raise_on_device_mix(cuda_device):
    h, xp, u, b = _step_inputs(2, 32, torch.float32, cuda_device, 0)
    with pytest.raises(ValueError):
        CK.gru_step_fused(h, xp.cpu(), u, b)
    with pytest.raises(ValueError):
        CK.gru_step_blocked(h, xp, u, b.cpu(), block_n=16)
    x = torch.zeros(2, 32, device=cuda_device)
    with pytest.raises(ValueError):
        MK.rowwise_matmul(x, torch.zeros(32, 8))
    with pytest.raises(TypeError):
        MK.cascade_matmul(x, torch.zeros(32, 8, device=cuda_device,
                                         dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# the shard kernels (the cuda_sharded backend's per-rank steps)
# ---------------------------------------------------------------------------

def _shard_operands(H, n, B, dev, seed):
    """The last rank's operands, with the mesh path's row-strided gate
    slices of xp and u and a column slice of h as h_local."""
    g = torch.Generator().manual_seed(seed)
    Hl = H // n

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev)
    h = rand(B, H, scale=0.5)
    xp, u, b = rand(B, 3 * Hl), rand(H, 3 * Hl, scale=H ** -0.5), rand(3 * Hl)
    u_rows, h_shard = rand(Hl, 3 * H, scale=H ** -0.5), rand(B, Hl)
    z, xp2 = torch.sigmoid(rand(B, Hl)), rand(B, 2 * Hl)
    h_local = h[:, (n - 1) * Hl:]
    return {
        "gru_rowwise_shard_step": (h, h_local, xp, u, b),
        "gru_rowwise_shard_zr": (h, h_local, xp[:, :2 * Hl], u[:, :2 * Hl],
                                 b[:2 * Hl]),
        "gru_rowwise_shard_candidate": (rand(B, H), h_local, z,
                                        xp[:, 2 * Hl:], u[:, 2 * Hl:],
                                        b[2 * Hl:]),
        "gru_shard_matvec": (h_shard, u_rows[:, :2 * H]),
        "gru_cascade_shard_gates": (rand(B, 3 * Hl), xp, h_shard),
        "gru_cascade_shard_zr": (rand(B, 2 * Hl), xp2, h_shard,
                                 u_rows[:, 2 * H:]),
        "gru_cascade_shard_update": (z, rand(B, Hl), h_shard),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("H,n", tuple(itertools.product((20, 32),
                                                        (1, 2, 4))))
@pytest.mark.parametrize("B", (1, 8, 64))
def test_shard_kernels_match_plain(cuda_device, H, n, B):
    ops_ = _shard_operands(H, n, B, cuda_device, H * 100 + n * 10 + B)
    K.reset_launch_counts()
    pairs = []
    for fn in K.SHARD_KERNELS:
        args = ops_[fn.__name__]
        got, want = fn(*args), getattr(ref, fn.__name__ + "_ref")(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        pairs += list(zip(got, want))
    assert all(f.launches == 1 for f in K.SHARD_KERNELS)
    assert _max_err(pairs) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("H,n", tuple(itertools.product((20, 32),
                                                        (1, 2, 4))))
@pytest.mark.parametrize("B", (1, 8))
def test_cascade_gates_in_place_equal_the_old_sequence(cuda_device, H, n,
                                                       B):
    """The v3 cascade epilogue as the mesh step calls it (gate views of the
    psum'd gates and of xp, b's local view: one launch) equals, bit for
    bit, the sequence it replaced (psum + b at full width, this rank's
    slices copied out, the contiguous call), on every rank's slices."""
    from repro_torch.core import rowparallel as rp
    g = torch.Generator().manual_seed(H * 10 + n + B)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(cuda_device)
    Hl = H // n
    gf, xp, b, h = rand(B, 3 * H), rand(B, 3 * H), rand(3 * H), rand(B, Hl)
    for idx in range(n):
        K.reset_launch_counts()
        got = K.gru_cascade_shard_gates(
            rp._gate_view(gf, 3, H, idx, Hl), rp._gate_view(xp, 3, H, idx, Hl),
            h, rp._gate_view(b, 3, H, idx, Hl))
        assert K.gru_cascade_shard_gates.launches == 1
        old = K.gru_cascade_shard_gates(
            rp._local_gates(gf + b, 3, H, idx, Hl),
            rp._local_gates(xp, 3, H, idx, Hl), h)
        torch.cuda.synchronize()
        assert torch.equal(got, old)
        want = ref.gru_cascade_shard_gates_ref(
            rp._local_gates(gf + b, 3, H, idx, Hl),
            rp._local_gates(xp, 3, H, idx, Hl), h)
        assert _max_err([(got, want)]) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("H,n", tuple(itertools.product((20, 32),
                                                        (1, 2, 4))))
@pytest.mark.parametrize("B", (1, 3, 8))
def test_cascade_update_in_place_equals_the_old_sequence(cuda_device, H, n,
                                                         B):
    """Row 18: the v1 cascade epilogue as the mesh step calls it (column
    slices of the psum'd partial, of xp's candidate gate and of b: one
    launch) equals, bit for bit, the sequence it replaced (``_ht_in``'s two
    adds, the contiguous call), on every rank's slices."""
    from repro_torch.core import rowparallel as rp
    g = torch.Generator().manual_seed(H * 10 + n + B)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(cuda_device)
    Hl = H // n
    ht_p, xp, b = rand(B, H), rand(B, 3 * H), rand(3 * H, scale=0.3)
    z, h = torch.sigmoid(rand(B, Hl)), rand(B, Hl, scale=0.5)
    for idx in range(n):
        s = 2 * H + idx * Hl
        K.reset_launch_counts()
        got = K.gru_cascade_shard_update(z, rp._local(ht_p, idx * Hl, Hl), h,
                                         rp._local(xp, s, Hl), b[s:s + Hl])
        assert K.gru_cascade_shard_update.launches == 1
        ht_in = rp._ht_in(xp, ht_p, b, H, idx, Hl)
        old = K.gru_cascade_shard_update(z, ht_in, h)
        torch.cuda.synchronize()
        assert torch.equal(got, old)
        want = ref.gru_cascade_shard_update_ref(z, ht_in, h)
        assert _max_err([(got, want)]) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ("v1", "v3"))
def test_one_rank_mesh_runs_the_shard_kernels(cuda_device, variant):
    """gru-jet-deep on a one-rank mesh of the card (no process group):
    cuda_sharded prefill and decode launch the shard kernels and agree
    with the eager stack."""
    from repro_torch.core import gru as gru_core
    from repro_torch.core import runtime
    from repro_torch.distributed import local_mesh
    cfg = dataclasses.replace(get_config("gru-jet-deep").gru,
                              backend="cuda_sharded", variant=variant)
    params = init_params({"cells": gru_core.gru_stack_specs(cfg)}, seed=0,
                         device=cuda_device)
    g = torch.Generator().manual_seed(1)
    xs = torch.randn(8, 6, cfg.input_dim, generator=g).to(cuda_device)
    h0s = gru_core.stack_h0(cfg, 8, device=cuda_device)
    exe = runtime.compile(cfg, batch=8, seq=6,
                          placement=local_mesh(cuda_device))
    assert (exe.sequence_backend, exe.decode_backend) == ("cuda_sharded",
                                                          "cuda_sharded")
    sp = exe.prepare(params, device=cuda_device)
    K.reset_launch_counts()
    finals = exe.prefill(sp, h0s, xs)
    hs = exe.decode(sp, finals, xs[:, 0])
    torch.cuda.synchronize()
    assert sum(f.launches for f in K.SHARD_KERNELS) > 0
    assert all(f.launches == 0 for f in K.KERNELS)
    want = gru_core.gru_stack_sequence_eager(sp.cells, h0s, xs, cfg=cfg)[0]
    want_hs = gru_core.gru_stack_decode_eager(sp.cells, want, xs[:, 0],
                                              cfg=cfg)
    assert _max_err(list(zip(finals, want)) + list(zip(hs, want_hs))) <= TOL


# the redesigned kernels (rows 12-15 and 17): the direct route at the
# paper's widths, the column tile where the contraction is long
# (shard_plan)
REDESIGNED = ("gru_rowwise_shard_step", "gru_rowwise_shard_zr",
              "gru_rowwise_shard_candidate", "gru_shard_matvec",
              "gru_cascade_shard_zr")


def _planned(name, args):
    """The plan the CPU rule gives ``name`` on ``args``."""
    if name == "gru_shard_matvec":
        x, w = args
        return K.shard_plan(x.shape[0], x.shape[1], 1, w.shape[1],
                            K._vector(w, w.stride(0), w.shape[1]), "matvec")
    if name == "gru_cascade_shard_zr":
        h, u = args[2], args[3]
        return K.shard_plan(h.shape[0], h.shape[1], 1, u.shape[1],
                            K._vector(u, u.stride(0), u.shape[1]),
                            "cascade_zr")
    kind = K._ROWWISE_MODES[name][1]
    G = K.KIND_GATES[kind]
    x, h_local, u = args[0], args[1], args[-2]
    return K.shard_plan(x.shape[0], x.shape[1], G, h_local.shape[1],
                        K._vector(u, u.stride(0), h_local.shape[1]), kind)


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.gpu
@pytest.mark.parametrize("H,n", tuple(itertools.product((64, 256, 512),
                                                        (1, 2, 4))))
@pytest.mark.parametrize("B", (1, 8))
def test_wide_shard_kernels_match_plain(cuda_device, H, n, B):
    """Wide shards: the step's contraction of H = 512 and the matvec's of
    256 and 512 take the column tile, the rest the direct route; the
    matvec also at v3's N = 3H."""
    ops_ = _shard_operands(H, n, B, cuda_device, H * 100 + n * 10 + B)
    w3 = torch.randn(H // n, 3 * H, generator=torch.Generator().manual_seed(
        H + n + B)).to(cuda_device) * H ** -0.5
    ops_["gru_shard_matvec 3H"] = (ops_["gru_shard_matvec"][0], w3)
    pairs = []
    for key, args in ops_.items():
        name = key.split()[0]
        got = getattr(K, name)(*args)
        want = getattr(ref, name + "_ref")(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        pairs += list(zip(got, want))
        if name in REDESIGNED:
            assert getattr(K, name).last_plan == _planned(name, args)
    assert _max_err(pairs) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("B", (3, 8))
def test_redesigned_shard_kernels_take_misaligned_views(cuda_device, B):
    """Hl = 5 (gru-jet over 4 ranks): gate offsets off 16 bytes, and u and
    w as views one float into their storage (no 16-byte address); the v1
    pair's candidate slices (u_h, xp_h) 2Hl floats into the shard's
    columns, its zr slices of row stride 3Hl; the cascade's u_h_rows a
    view 2H + 1 floats into rows of 3H + 1."""
    H, n = 20, 4
    Hl = H // n
    g = torch.Generator().manual_seed(B)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(cuda_device)
    h = rand(B, H, scale=0.5)
    u = rand(H, 3 * Hl + 1, scale=H ** -0.5)[:, 1:]
    w = rand(Hl, 3 * H + 1, scale=H ** -0.5)[:, 1:2 * H + 1]
    x = rand(B, Hl + 3, scale=0.5)[:, 3:]
    xp, b = rand(B, 3 * Hl), rand(3 * Hl)
    uh_rows = rand(Hl, 3 * H + 1, scale=H ** -0.5)[:, 2 * H + 1:]
    assert u.data_ptr() % 16 and w.data_ptr() % 16 and x.data_ptr() % 16
    assert uh_rows.data_ptr() % 16
    assert u[:, 2 * Hl:].data_ptr() % 16 and xp[:, 2 * Hl:].data_ptr() % 16
    args = {"gru_rowwise_shard_step": (h, h[:, 3 * Hl:], xp, u, b),
            "gru_rowwise_shard_zr": (h, h[:, 3 * Hl:], xp[:, :2 * Hl],
                                     u[:, :2 * Hl], b[:2 * Hl]),
            "gru_rowwise_shard_candidate": (
                rand(B, H, scale=0.5), h[:, 3 * Hl:],
                torch.sigmoid(rand(B, Hl)), xp[:, 2 * Hl:], u[:, 2 * Hl:],
                b[2 * Hl:]),
            "gru_shard_matvec": (x, w),
            "gru_cascade_shard_zr": (rand(B, 2 * Hl), rand(B, 2 * Hl),
                                     x.contiguous(), uh_rows)}
    for name in REDESIGNED:
        got = _outs(getattr(K, name)(*args[name]))
        want = _outs(getattr(ref, name + "_ref")(*args[name]))
        assert getattr(K, name).last_plan == _planned(name, args[name])
        assert getattr(K, name).last_plan.route == "direct"
        assert _max_err(list(zip(got, want))) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("H,n,B", ((32, 2, 8), (20, 4, 3), (32, 1, 64),
                                   (512, 1, 8), (256, 4, 1)))
def test_redesigned_shard_kernels_are_deterministic(cuda_device, H, n, B):
    """Two calls on the same inputs give the same bits (no atomics), on
    either route; each call raises only its own counter, and ``last_plan``
    is the route the CPU rule names."""
    ops_ = _shard_operands(H, n, B, cuda_device, 7 * H + n + B)
    for name in REDESIGNED:
        fn, args = getattr(K, name), ops_[name]
        K.reset_launch_counts()
        first, second = _outs(fn(*args)), _outs(fn(*args))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        assert fn.launches == 2
        assert all(k.launches == 0 for k in K.SHARD_KERNELS if k is not fn)
        assert fn.last_plan == _planned(name, args)
    for name, kind, Kc in (("gru_rowwise_shard_step", "step", H),
                           ("gru_rowwise_shard_zr", "zr", H),
                           ("gru_rowwise_shard_candidate", "candidate", H),
                           ("gru_cascade_shard_zr", "cascade_zr", H // n)):
        assert getattr(K, name).last_plan.route == (
            "tile" if Kc > K.DIRECT_MAX_K[kind] else "direct")


# ---------------------------------------------------------------------------
# The serving fleet on the card: two replicas behind one router
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_fleet_on_the_card_gives_the_single_engines_streams(cuda_device):
    """gru-jet-deep through ``backend="cuda"`` on a two-replica
    ``FleetRouter`` (a ``ManualClock``, replica0 killed and restored while
    it serves): every request completes with the class streams of one
    engine on the card, every prefill and step on ``cuda_fused``, and the
    fused kernels launched once per prefill and per decode step the
    replicas ran."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.clock import ManualClock
    from repro_torch.serve.fleet import (FaultEvent, FaultInjector,
                                         FleetConfig, FleetRouter)
    cfg = get_config("gru-jet-deep")
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru, backend="cuda"))
    params = init_params(gru_lm.lm_specs(cfg), seed=0, device=cuda_device)
    reqs = make_requests(cfg, 12, 20, True, 8, seed=3)
    K.reset_launch_counts()
    router = FleetRouter(
        cfg, params, replicas=2, max_batch=4, clock=ManualClock(),
        config=FleetConfig(heartbeat_timeout_s=0.05, tick_s=0.01),
        injector=FaultInjector([
            FaultEvent(t=0.05, kind="kill", replica="replica0"),
            FaultEvent(t=0.15, kind="restore", replica="replica0")]),
        device=cuda_device)
    router.generate(reqs)
    s = router.stats()
    assert s["completed"] == 12 and s["failed"] == 0
    assert s["kills"] == 1 and s["restores"] == 1
    prefills = 0
    for rep in router.replicas:
        assert set(rep.engine.prefill_backends) <= {"cuda_fused"}
        assert set(rep.engine.decode_backends) <= {"cuda_fused"}
        prefills += len(rep.engine.prefill_backends)
    # the killed engine's prefills and steps count too: read the launches
    steps = sum(rep.steps for rep in router.replicas)
    _, seq, dec = (k.launches for k in K.KERNELS)
    assert seq >= prefills > 0 and dec == steps
    ref = make_requests(cfg, 12, 20, True, 8, seed=3)
    ServeEngine(cfg, params, max_batch=1, device=cuda_device).generate(ref)
    assert [r.out for r in reqs] == [r.out for r in ref]


# ---------------------------------------------------------------------------
# training on the card: eager autograd, checkpoints, the q8 harness
# ---------------------------------------------------------------------------

def _train_setup(arch, dev):
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.train import trainer
    cfg = get_config(arch)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=20)
    stream = SyntheticStream(cfg, ShapeConfig("t", cfg.gru.seq_len, 64,
                                              "train"))
    return cfg, tcfg, stream, trainer.init_state(cfg, tcfg, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("gru-jet", "gru-jet-deep", "slstm-jet"))
def test_train_step_on_the_card_matches_the_cpu(cuda_device, arch):
    """The same state and batch on the card and on the CPU: the gradients
    within rtol 1e-5 (fp32, summation order), one AdamW step's loss and
    metrics likewise; training launches no kernel."""
    from repro_torch.core.params import flatten, map_trees
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.train import trainer
    cfg, tcfg, stream, st = _train_setup(arch, cuda_device)
    cpu = torch.device("cpu")
    st_cpu = map_trees(lambda t: t.detach().to(cpu).requires_grad_(
        t.requires_grad), st)
    b = stream.batch_at(3)
    loss_fn = trainer._loss_fn(cfg)
    K.reset_launch_counts()
    g, loss, _ = trainer._micro_grads(loss_fn, st["params"],
                                      shard_batch(b, device=cuda_device), 1)
    gc, loss_c, _ = trainer._micro_grads(loss_fn, st_cpu["params"],
                                         shard_batch(b, device=cpu), 1)
    np.testing.assert_allclose(float(loss), float(loss_c), rtol=1e-5)
    fg, fc = flatten(g), flatten(gc)
    for k in fc:
        np.testing.assert_allclose(
            fg[k].cpu().numpy(), fc[k].numpy(), rtol=1e-5,
            atol=1e-5 * float(fc[k].abs().max()), err_msg=k)
    step = trainer.make_train_step(cfg, tcfg)
    _, m = step(st, shard_batch(b, device=cuda_device))
    _, mc = step(st_cpu, shard_batch(b, device=cpu))
    for k in mc:
        np.testing.assert_allclose(float(m[k]), float(mc[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert all(k.launches == 0 for k in K.KERNELS + K.Q8_KERNELS
               + K.CHAIN_Q8_KERNELS + SK.SLSTM_KERNELS)


@pytest.mark.gpu
def test_resumed_run_on_the_card_equals_the_run_that_never_stopped(
        cuda_device, tmp_path):
    """8 steps, a checkpoint at 5 through the async writer, a restore onto
    the card into a fresh state: steps 5-7 from disk equal those in
    memory within 1e-6."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.params import flatten
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.train import trainer
    cfg, tcfg, stream, st = _train_setup("gru-jet", cuda_device)
    step = trainer.make_train_step(cfg, tcfg)
    mgr = CheckpointManager(str(tmp_path))
    for s in range(8):
        st, _ = step(st, shard_batch(stream.batch_at(s), device=cuda_device))
        if s == 4:
            mgr.save_async(st, 5)
    mgr.wait()
    like = trainer.init_state(cfg, tcfg, seed=9, device=cuda_device)
    re = mgr.restore(like)
    assert int(re["step"]) == 5 and re["step"].is_cuda
    for s in range(5, 8):
        re, _ = step(re, shard_batch(stream.batch_at(s), device=cuda_device))
    fa, fb = flatten(st), flatten(re)
    for k in fa:
        assert fb[k].device == fa[k].device
        assert (fa[k].detach().float() - fb[k].detach().float()).abs().max(
        ).item() <= 1e-6, k


@pytest.mark.gpu
def test_kernel_wrappers_refuse_autograd_on_the_card(cuda_device):
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.models import api as mapi
    from repro_torch.train import trainer
    cfg = get_config("gru-jet")
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru, backend="cuda_fused"))
    st = trainer.init_state(cfg, TrainConfig(), device=cuda_device)
    batch = mapi.concrete_batch(cfg, ShapeConfig("t", 6, 4, "train"),
                                device=cuda_device)
    K.reset_launch_counts()
    with pytest.raises(RuntimeError, match="gru_sequence_kernel has no "
                       "backward; train on backend='eager'"):
        mapi.get_api(cfg).loss_fn(st["params"], cfg, batch)
    assert K.gru_sequence_kernel.launches == 0
    with torch.no_grad():
        logits = gru_lm.forward(st["params"], cfg, batch)
    assert K.gru_sequence_kernel.launches == 1 and logits.is_cuda


@pytest.mark.gpu
def test_q8_harness_on_the_card_launches_rows_4_and_6(cuda_device,
                                                        tmp_path):
    """The harness at smoke size on the card: rows 4 and 6 launched once
    per eval batch, each q8 pin's logits within 1e-5 of the CPU run of
    the same pin on the same trained params; the port's gate untouched."""
    from repro_torch.core import runtime
    from repro_torch.core.params import map_trees
    from repro_torch.quant import accuracy
    gate = runtime.quant_accuracy()
    K.reset_launch_counts()
    out, params = accuracy.run(arch="gru-jet", train_steps=20,
                               train_batch=32, eval_batches=2, eval_batch=32,
                               json_path=str(tmp_path / "a.json"), csv=False,
                               device=cuda_device, return_params=True)
    assert K.gru_stack_sequence_q8_kernel.launches == 2
    assert K.gru_sequence_q8_kernel.launches == 2
    assert runtime.quant_accuracy() is gate
    assert out["device"].startswith("cuda: ")
    assert set(out["backends"]) == set(accuracy.Q8_BACKENDS)
    cpu = torch.device("cpu")
    xs = torch.randn(16, 20, 5, generator=torch.Generator().manual_seed(1))
    pc = map_trees(lambda p: p.to(cpu), params)
    for b in accuracy.Q8_BACKENDS:
        g = dataclasses.replace(get_config("gru-jet").gru, backend=b)
        got = accuracy._eval_logits(params, g, xs.to(cuda_device))
        want = accuracy._eval_logits(pc, g, xs)
        assert np.abs(got - want).max() <= TOL, b


# ---------------------------------------------------------------------------
# The recurrent LMs: hymba-1.5b's heads (Hq 25, Hkv 5, D 64, a window of
# 1024) through rows 21 and 22, and hymba and xlstm-125m served at SMOKE
# size on the card against the CPU plain path (fp32: the same function in
# other summation orders, logits within 1e-4 after six layers and a scan;
# token streams equal).
# ---------------------------------------------------------------------------

HYMBA_HEADS = (25, 5, 64)
# (Sq = Sk, window): the served 1280-token prompt with its window and
# without (the global layers), and a window over a shorter prompt
HYMBA_FLASH = ((1280, 1024), (1280, 0), (300, 1024), (2100, 1024))
# (C, written positions (from, to), pos, window): a full window ring,
# wrapped; a global layer's cache (S + 64 slots); a ring that holds the
# prompt and its headroom below the window
HYMBA_DECODE = ((1024, (277, 1300), 1300, 1024), (1344, (0, 1290), 1290, 0),
                (1024, (0, 140), 140, 1024), (192, (0, 140), 140, 1024))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("S,window", HYMBA_FLASH)
def test_flash_attention_at_hymba_heads(cuda_device, dtype, S, window):
    Hq, Hkv, D = HYMBA_HEADS
    g = torch.Generator().manual_seed(S + window)
    q = _rand((2, Hq, S, D), g, cuda_device, dtype)
    k = _rand((2, Hkv, S, D), g, cuda_device, dtype)
    v = _rand((2, Hkv, S, D), g, cuda_device, dtype)
    K.reset_launch_counts()
    got = FK.flash_attention(q, k, v, causal=True, window=window)
    want = fref.flash_attention_plain(q, k, v, True, window)
    assert FK.flash_attention.launches == 1
    tol = TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("C,written,pos,window", HYMBA_DECODE)
def test_flash_decode_at_hymba_heads(cuda_device, dtype, C, written, pos,
                                     window):
    """G = 5: flash decode's 16-query register bucket."""
    from repro_torch.kernels.decode_attn.ops import valid_slots
    Hq, Hkv, D = HYMBA_HEADS
    g = torch.Generator().manual_seed(C + pos)
    q = _rand((4, Hkv, Hq // Hkv, D), g, cuda_device, dtype)
    kc = _rand((4, Hkv, C, D), g, cuda_device, dtype)
    vc = _rand((4, Hkv, C, D), g, cuda_device, dtype)
    slot_pos = torch.full((C,), -1, dtype=torch.int32)
    for p in range(written[0], written[1] + 1):
        slot_pos[p % C] = p
    mask = valid_slots(slot_pos.to(cuda_device), pos, window)
    K.reset_launch_counts()
    got = DK.flash_decode(q, kc, vc, mask)
    assert DK.flash_decode.launches == 1
    torch.testing.assert_close(got, dref.flash_decode_plain(q, kc, vc, mask),
                               rtol=TOL, atol=TOL)


def _recurrent_lm_streams(arch, dev, impl, prompts, new):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import api as mapi
    cfg = get_smoke_config(arch).replace(dtype="float32", attn_impl=impl)
    params = mapi.get_api(cfg).init_prepared(cfg, 0, dev)
    eng = ServeEngine(cfg, params, max_batch=len(prompts), device=dev)
    logs = []
    api = eng.api
    from types import SimpleNamespace

    def decode_step(p, c, cache, tok):
        out = api.decode_step(p, c, cache, tok)
        logs.append(out[0].float().cpu())
        return out
    eng.api = SimpleNamespace(**dict(vars(api), decode_step=decode_step))
    done = eng.generate([Request(prompt=p, max_new_tokens=new)
                         for p in prompts])
    return [r.out for r in done], logs, eng.latency_stats()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("hymba-1.5b", "xlstm-125m"))
def test_recurrent_lm_served_on_the_card_equals_cpu(cuda_device, arch):
    """SMOKE in fp32: hymba through ``cuda`` launches flash attention 6
    times per prefill and flash decode 6 per step, the xLSTM nothing; no
    other kernel of the port; streams equal the CPU run's, step logits
    within 1e-4 (prompts of 3-12 tokens, the wave padded to 12, past
    hymba's window of 8, so its rings wrap)."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 128, size=n).astype(np.int32)
               for n in (3, 11, 5, 12)]
    K.reset_launch_counts()
    got, logs, st = _recurrent_lm_streams(arch, cuda_device, "cuda",
                                          prompts, 6)
    counts = [FK.flash_attention.launches, DK.flash_decode.launches]
    others = K.KERNELS + K.Q8_KERNELS + K.CHAIN_Q8_KERNELS + \
        SK.SLSTM_KERNELS + K.ROWWISE_KERNELS + K.SHARD_KERNELS
    assert all(k.launches == 0 for k in others)
    steps = st["steps"] + 1
    if arch == "hymba-1.5b":
        assert counts == [6, 6 * steps]
    else:
        assert counts == [0, 0]
    want, wlogs, _ = _recurrent_lm_streams(arch, torch.device("cpu"),
                                           "cuda", prompts, 6)
    assert got == want
    for a, b in zip(logs, wlogs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("hymba-1.5b", "xlstm-125m"))
def test_recurrent_lm_init_prepared_on_the_card(cuda_device, arch):
    """The leaf-by-leaf build on the card equals ``prepare_params`` of the
    fp32 tree bit for bit; only the dense weights are bf16."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.params import flatten
    from repro_torch.models import api as mapi
    cfg = get_smoke_config(arch)
    api = mapi.get_api(cfg)
    want = api.prepare_params(init_params(api.specs(cfg), seed=3,
                                          device="cpu"), cfg, cuda_device)
    got = api.init_prepared(cfg, seed=3, device=cuda_device)
    fw, fg = flatten(want), flatten(got)
    assert list(fw) == list(fg)
    for k in fw:
        assert fg[k].device.type == "cuda" and fg[k].dtype == fw[k].dtype
        assert torch.equal(fg[k], fw[k]), k


# ---------------------------------------------------------------------------
# The encoder-decoder and vision-language families: whisper-large-v3's
# heads (20/20, D 64: the encoder's non-causal attention over 1500 frames,
# the cross-attention with Sq != Sk, the cross cache with every slot
# valid) and llava-next-mistral-7b's (32/8, D 128, G 4) through rows 21
# and 22; both models served at SMOKE size on the card through the model
# API against the CPU plain path (fp32: logits within 1e-4, streams
# equal) with their exact launch counts.
# ---------------------------------------------------------------------------

WHISPER_HEADS, LLAVA_HEADS = (20, 20, 64), (32, 8, 128)
# (heads, Sq, Sk, causal)
ENCDEC_FLASH = ((WHISPER_HEADS, 1500, 1500, False),
                (WHISPER_HEADS, 1500, 1500, True),
                (WHISPER_HEADS, 4, 1500, False),
                (WHISPER_HEADS, 64, 1500, False),
                (WHISPER_HEADS, 77, 300, False),
                (WHISPER_HEADS, 64, 64, True),
                (LLAVA_HEADS, 640, 640, True))
# (heads, C, written positions (from, to), pos or None for a cross cache)
ENCDEC_DECODE = ((WHISPER_HEADS, 1500, (0, 1499), None),
                 (WHISPER_HEADS, 1500, (0, 1499), 3),
                 (WHISPER_HEADS, 68, (0, 4), 4),
                 (WHISPER_HEADS, 128, (0, 79), 79),
                 (LLAVA_HEADS, 704, (0, 640), 640),
                 (LLAVA_HEADS, 704, (0, 655), 655))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("heads,Sq,Sk,causal", ENCDEC_FLASH)
def test_flash_attention_at_encdec_and_vlm_heads(cuda_device, dtype, heads,
                                                 Sq, Sk, causal):
    Hq, Hkv, D = heads
    g = torch.Generator().manual_seed(Sq + Sk)
    q = _rand((4, Hq, Sq, D), g, cuda_device, dtype)
    k = _rand((4, Hkv, Sk, D), g, cuda_device, dtype)
    v = _rand((4, Hkv, Sk, D), g, cuda_device, dtype)
    K.reset_launch_counts()
    got = FK.flash_attention(q, k, v, causal=causal)
    want = fref.flash_attention_plain(q, k, v, causal, 0)
    assert FK.flash_attention.launches == 1
    tol = TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("heads,C,written,pos", ENCDEC_DECODE)
def test_flash_decode_at_encdec_and_vlm_heads(cuda_device, dtype, heads, C,
                                              written, pos):
    """The cross cache (``pos`` None: every written slot valid; at pos 3 the
    self rule would leave only 4 of them) and the self rings, G = 1 and 4."""
    from repro_torch.kernels.decode_attn.ops import valid_slots
    Hq, Hkv, D = heads
    g = torch.Generator().manual_seed(C + (pos or 0))
    q = _rand((4, Hkv, Hq // Hkv, D), g, cuda_device, dtype)
    kc = _rand((4, Hkv, C, D), g, cuda_device, dtype)
    vc = _rand((4, Hkv, C, D), g, cuda_device, dtype)
    slot_pos = torch.full((C,), -1, dtype=torch.int32)
    for p in range(written[0], written[1] + 1):
        slot_pos[p % C] = p
    mask = valid_slots(slot_pos.to(cuda_device), pos, 0, cross=pos is None)
    if pos is None:
        assert bool(mask.all())
    K.reset_launch_counts()
    got = DK.flash_decode(q, kc, vc, mask)
    assert DK.flash_decode.launches == 1
    torch.testing.assert_close(got, dref.flash_decode_plain(q, kc, vc, mask),
                               rtol=TOL, atol=TOL)


def _api_streams(arch, dev, new):
    """SMOKE in fp32 through ``get_api(cfg).prefill`` and ``decode_step``
    (the engine serves neither family): streams and every call's logits."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import api as mapi
    cfg = get_smoke_config(arch).replace(dtype="float32")
    api = mapi.get_api(cfg)
    params = api.init_prepared(cfg, 0, dev)
    rng = np.random.default_rng(5)
    S = 12
    batch = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(3, S)).astype(np.int32)).to(dev)}
    if cfg.family == "audio":
        shape = (3, cfg.encoder.num_frames, cfg.d_model)
        batch["frames"] = torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(dev)
    else:
        shape = (3, cfg.vision.num_patches, cfg.vision.embed_dim)
        batch["patches"] = torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(dev)
    logs, toks = [], []
    with torch.no_grad():
        logits, cache = api.prefill(params, cfg, batch)
        for _ in range(new):
            logs.append(logits.float().cpu())
            toks.append(logits.argmax(-1))
            logits, cache = api.decode_step(params, cfg, cache, toks[-1])
    return torch.stack(toks, 1).cpu().tolist(), logs, cfg


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("whisper-large-v3", "llava-next-mistral-7b"))
def test_encdec_and_vlm_served_on_the_card_equal_cpu(cuda_device, arch):
    """whisper launches flash attention 6 times per prefill (2 encoder, 2
    decoder self, 2 cross layers) and flash decode 4 per step (self and
    cross); llava 2 and 2; no other kernel of the port; streams equal the
    CPU run's, logits within 1e-4."""
    K.reset_launch_counts()
    new = 6
    got, logs, cfg = _api_streams(arch, cuda_device, new)
    counts = [FK.flash_attention.launches, DK.flash_decode.launches]
    others = K.KERNELS + K.Q8_KERNELS + K.CHAIN_Q8_KERNELS + \
        SK.SLSTM_KERNELS + K.ROWWISE_KERNELS + K.SHARD_KERNELS
    assert all(k.launches == 0 for k in others)
    L = cfg.num_layers
    if arch == "whisper-large-v3":
        assert counts == [cfg.encoder.num_layers + 2 * L, 2 * L * new]
    else:
        assert counts == [L, L * new]
    want, wlogs, _ = _api_streams(arch, torch.device("cpu"), new)
    assert got == want
    for a, b in zip(logs, wlogs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("whisper-large-v3", "llava-next-mistral-7b"))
def test_encdec_and_vlm_init_prepared_on_the_card(cuda_device, arch):
    """The leaf-by-leaf build on the card equals ``prepare_params`` of the
    fp32 tree bit for bit (whisper: the LayerNorms stay fp32; llava: the
    projector is cast with the transformer's weights)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.params import flatten
    from repro_torch.models import api as mapi
    cfg = get_smoke_config(arch)
    api = mapi.get_api(cfg)
    want = api.prepare_params(init_params(api.specs(cfg), seed=3,
                                          device="cpu"), cfg, cuda_device)
    got = api.init_prepared(cfg, seed=3, device=cuda_device)
    fw, fg = flatten(want), flatten(got)
    assert list(fw) == list(fg)
    for k in fw:
        assert fg[k].device.type == "cuda" and fg[k].dtype == fw[k].dtype
        assert torch.equal(fg[k], fw[k]), k
