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


# (B, K, N): JAX's test shapes, the paper's matvec, qwen3-0.6b's MLP
MATMUL_CASES = ((1, 16, 32), (4, 96, 256), (8, 128, 128), (2, 64, 512),
                (8, 32, 96), (4, 1024, 3072), (4, 3072, 1024))


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
    got_r, got_c = mops.rowwise(x, w), mops.cascade(x, w)
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
