"""The fused GRU kernels of the port (``repro_torch.kernels.gru_sequence``).

On the CPU: the plain PyTorch versions against the JAX Pallas sequence
kernels in interpret mode, and the decode against ``gru_stack_decode_ref``
and ``gru_stack_decode_xla`` (the Pallas decode kernel does not run under
this jax); the wrappers take the plain path for CPU tensors, leave their
launch counters alone and raise on what the kernel does not take; the
``cuda_fused`` backend agrees with ``eager``. Tolerance rtol=atol=1e-5.
The CUDA kernels themselves are held against the plain versions on the
card by ``test_torch_gpu.py``.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gru as jgru
from repro.configs.base import GRUConfig as JCfg
from repro.kernels.gru_sequence import ref as jref
from repro.kernels.gru_sequence.kernel import (gru_sequence_kernel as jseq,
                                               gru_stack_sequence_kernel as
                                               jstack)
from repro_torch.configs.base import GRUConfig as TCfg
from repro_torch.core import gru as tgru
from repro_torch.core import runtime
from repro_torch.core.params import quantize_gru_cells
from repro_torch.kernels.gru_sequence import kernel as K
from repro_torch.kernels.gru_sequence import ops, ref

from _torch_parity import close, numpy_params, to_torch

T, B, H = 5, 3, 8
X_IN = 5


def _arrays(L, seed=0, T=T, B=B, H=H):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        h0=rng.normal(scale=0.5, size=(L, B, H)).astype(f),
        xp=rng.normal(size=(T, B, 3 * H)).astype(f),
        u=(rng.normal(size=(L, H, 3 * H)) / np.sqrt(H)).astype(f),
        wd=(rng.normal(size=(max(L - 1, 1), H, 3 * H)) / np.sqrt(H)).astype(f),
        b=rng.normal(scale=0.3, size=(L, 3 * H)).astype(f),
        mask=(rng.random((T, B)) > 0.3).astype(f))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


CASES = list(itertools.product(("v1", "v3"), (False, True)))


@pytest.mark.parametrize("variant,masked", CASES)
def test_sequence_plain_matches_pallas_interpret(variant, masked):
    a = _arrays(1)
    m = a["mask"] if masked else None
    want = jseq(jnp.asarray(a["h0"][0]), jnp.asarray(a["xp"]),
                jnp.asarray(a["u"][0]), jnp.asarray(a["b"][0]),
                None if m is None else jnp.asarray(m), variant=variant,
                interpret=True)
    got = ref.gru_sequence_ref(_t(a["h0"][0]), _t(a["xp"]), _t(a["u"][0]),
                               _t(a["b"][0]), None if m is None else _t(m),
                               variant)
    close(got, want)


@pytest.mark.parametrize("variant,masked", CASES)
def test_stack_plain_matches_pallas_interpret(variant, masked):
    L = 3
    a = _arrays(L, seed=1)
    m = a["mask"] if masked else None
    want_hs, want_hT = jstack(jnp.asarray(a["h0"]), jnp.asarray(a["xp"]),
                              jnp.asarray(a["u"]), jnp.asarray(a["wd"]),
                              jnp.asarray(a["b"]),
                              None if m is None else jnp.asarray(m),
                              variant=variant, interpret=True)
    got_hs, got_hT = ref.gru_stack_sequence_ref(
        _t(a["h0"]), _t(a["xp"]), _t(a["u"]), _t(a["wd"]), _t(a["b"]),
        None if m is None else _t(m), variant)
    close(got_hs, want_hs)
    close(got_hT, want_hT)


@pytest.mark.parametrize("variant", ("v1", "v3"))
@pytest.mark.parametrize("L", (1, 3))
def test_decode_plain_matches_ref_and_xla(variant, L):
    a = _arrays(L, seed=2)
    wd = a["wd"] if L > 1 else np.zeros((1, 1, 3 * H), np.float32)
    got = ref.gru_stack_decode_ref(_t(a["h0"]), _t(a["xp"][0]), _t(a["u"]),
                                   _t(wd), _t(a["b"]), variant)
    want = jref.gru_stack_decode_ref(jnp.asarray(a["h0"]),
                                     jnp.asarray(a["xp"][0]),
                                     jnp.asarray(a["u"]), jnp.asarray(wd),
                                     jnp.asarray(a["b"]), variant=variant)
    close(got, want)
    # the XLA decode backend, from cells whose stacked views are these arrays
    cfg = JCfg(input_dim=X_IN, hidden_dim=H, num_layers=L, variant=variant)
    rng = np.random.default_rng(3)
    w0 = rng.normal(size=(X_IN, 3 * H)).astype(np.float32)
    cells = tuple({"w": w0 if l == 0 else a["wd"][l - 1], "u": a["u"][l],
                   "b": a["b"][l]} for l in range(L))
    x = rng.normal(size=(B, X_IN)).astype(np.float32)
    xla = jgru.gru_stack_decode_xla(
        tuple({k: jnp.asarray(v) for k, v in c.items()} for c in cells),
        tuple(jnp.asarray(h) for h in a["h0"]), jnp.asarray(x), cfg=cfg)
    stacked = ops.prepare_stacked_cells(to_torch(cells))
    got = K.gru_stack_decode_kernel(_t(a["h0"]), _t(x @ w0), stacked["u"],
                                    stacked["w_deep"], stacked["b"],
                                    variant=variant)
    close(got, np.stack([np.asarray(h) for h in xla]))


def test_wrappers_take_plain_path_on_cpu_without_counting():
    K.reset_launch_counts()
    a = _arrays(3, seed=4)
    seq = K.gru_sequence_kernel(_t(a["h0"][0]), _t(a["xp"]), _t(a["u"][0]),
                                _t(a["b"][0]), _t(a["mask"]), variant="v3")
    assert torch.equal(seq, ref.gru_sequence_ref(
        _t(a["h0"][0]), _t(a["xp"]), _t(a["u"][0]), _t(a["b"][0]),
        _t(a["mask"]), "v3"))
    hs, hT = K.gru_stack_sequence_kernel(_t(a["h0"]), _t(a["xp"]), _t(a["u"]),
                                         _t(a["wd"]), _t(a["b"]),
                                         _t(a["mask"]))
    rhs, rhT = ref.gru_stack_sequence_ref(_t(a["h0"]), _t(a["xp"]),
                                          _t(a["u"]), _t(a["wd"]),
                                          _t(a["b"]), _t(a["mask"]))
    assert torch.equal(hs, rhs) and torch.equal(hT, rhT)
    dec = K.gru_stack_decode_kernel(_t(a["h0"]), _t(a["xp"][0]), _t(a["u"]),
                                    _t(a["wd"]), _t(a["b"]))
    assert torch.equal(dec, ref.gru_stack_decode_ref(
        _t(a["h0"]), _t(a["xp"][0]), _t(a["u"]), _t(a["wd"]), _t(a["b"])))
    assert [k.launches for k in K.KERNELS] == [0, 0, 0]


def test_wrappers_raise_on_what_the_kernel_does_not_take():
    a = _arrays(3, seed=5)
    h, xp, u, wd, b = (_t(a[k]) for k in ("h0", "xp", "u", "wd", "b"))
    with pytest.raises(TypeError):
        K.gru_stack_decode_kernel(h.double(), xp[0], u, wd, b)
    with pytest.raises(ValueError):
        K.gru_stack_decode_kernel(h, xp[0, :, :-1], u, wd, b)   # 3H mismatch
    with pytest.raises(ValueError):
        K.gru_stack_decode_kernel(h, xp[0], u, wd[:1], b)       # L-1 layers
    with pytest.raises(ValueError):
        K.gru_stack_sequence_kernel(h, xp, u.transpose(1, 2).contiguous()
                                    .transpose(1, 2), wd, b)    # strided
    with pytest.raises(ValueError):
        K.gru_sequence_kernel(h[0], xp, u[0], b[0], _t(a["mask"][:, :2]))
    with pytest.raises(ValueError):
        K.gru_sequence_kernel(h[0], xp, u[0], b[0], variant="v2")
    with pytest.raises(TypeError):
        K.gru_sequence_kernel(h[0], xp, u[0].numpy(), b[0])
    big = 128                        # 3 layers of H=128 exceed 227 KB
    with pytest.raises(ValueError, match="shared"):
        K.gru_stack_decode_kernel(torch.zeros(3, 1, big),
                                  torch.zeros(1, 3 * big),
                                  torch.zeros(3, big, 3 * big),
                                  torch.zeros(2, big, 3 * big),
                                  torch.zeros(3, 3 * big))
    # the q8 wrappers: int8 weight rows (3H,H), the L=1 placeholder
    q = quantize_gru_cells([{"w": _t(a["wd"][max(l - 1, 0)]),
                             "u": _t(a["u"][l]), "b": _t(a["b"][l])}
                            for l in range(3)]).stacked
    uq, ue, wq, we, qb = (q[k] for k in ("u_q", "u_eff", "wd_q", "wd_eff",
                                         "b"))
    with pytest.raises(TypeError):
        K.gru_stack_decode_q8_kernel(h, xp[0], uq.float(), ue, wq, we, qb)
    with pytest.raises(TypeError):
        K.gru_stack_sequence_q8_kernel(h, xp, uq, ue, wq.to(torch.int32),
                                       we, qb)
    with pytest.raises(ValueError):
        K.gru_stack_decode_q8_kernel(h, xp[0], uq.transpose(1, 2)
                                     .contiguous(), ue, wq, we, qb)
    with pytest.raises(ValueError):
        K.gru_stack_sequence_q8_kernel(h, xp, uq, ue, wq, we, qb,
                                       _t(a["mask"][:, :2]))
    with pytest.raises(ValueError):
        K.gru_stack_decode_q8_kernel(h[:1], xp[0], uq[:1], ue[:1], wq[:1],
                                     we[:1], qb[:1])   # L=1: (1,3H,1) only
    with pytest.raises(ValueError):
        K.gru_stack_decode_q8_kernel(h, xp[0], uq, ue, wq, we, qb,
                                     variant="v2")
    with pytest.raises(ValueError, match="shared"):
        K.gru_stack_decode_q8_kernel(
            torch.zeros(3, 1, 4 * big), torch.zeros(1, 12 * big),
            torch.zeros(3, 12 * big, 4 * big, dtype=torch.int8),
            torch.zeros(3, 12 * big), torch.zeros(2, 12 * big, 4 * big,
                                                  dtype=torch.int8),
            torch.zeros(2, 12 * big), torch.zeros(3, 12 * big))


def test_gru_jet_deep_weights_need_dynamic_shared_memory():
    # U 36,864 + w_deep 24,576 + b 1,152 bytes resident: over 48 KB
    weights = 4 * (3 * 32 * 96 + 2 * 32 * 96 + 3 * 96)
    assert weights == 62592
    assert 48 * 1024 < K.smem_bytes(3, 32, 4) <= K.SMEM_LIMIT
    assert K.smem_bytes(1, 20, 4) < 48 * 1024


def _backend_cfgs(L, variant, backend):
    return TCfg(input_dim=X_IN, hidden_dim=H, num_layers=L, variant=variant,
                backend=backend)


@pytest.mark.parametrize("variant", ("v1", "v3"))
@pytest.mark.parametrize("L", (1, 3))
def test_cuda_fused_backend_matches_eager_on_cpu(variant, L, monkeypatch):
    if L == 1:   # depth 1 must go to the depth-1 sequence kernel
        monkeypatch.setattr(ops, "gru_stack_sequence_kernel",
                            lambda *a, **k: pytest.fail("stack kernel at L=1"))
    jc = JCfg(input_dim=X_IN, hidden_dim=H, num_layers=L)
    cells = to_torch(numpy_params(jgru.gru_stack_specs(jc), seed=6))
    rng = np.random.default_rng(9)
    xs = torch.from_numpy(rng.normal(size=(B, T, X_IN)).astype(np.float32))
    mask = torch.from_numpy(rng.random((B, T)) > 0.3)
    h0s = tgru.stack_h0(_backend_cfgs(L, variant, "eager"), B)
    outs = {}
    for backend in ("eager", "cuda"):
        exe = runtime.compile(_backend_cfgs(L, variant, backend), batch=B,
                              seq=T, mask=True)
        assert exe.sequence_backend == exe.decode_backend == (
            "cuda_fused" if backend == "cuda" else "eager")
        finals, hs = exe.sequence(cells, h0s, xs, return_all=True, mask=mask)
        dec = exe.decode(cells, finals, xs[:, -1])
        outs[backend] = (finals, hs, dec)
    for a, b in zip(outs["cuda"], outs["eager"]):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            close(x, y)


def test_runtime_preference_rules():
    def pick(**kw):
        exe = runtime.compile(TCfg(**kw), batch=2)
        return exe.sequence_backend, exe.decode_backend
    assert pick() == ("eager", "eager")                   # default, as "xla"
    assert pick(backend="cuda") == ("cuda_fused", "cuda_fused")
    assert pick(backend="cuda_fused") == ("cuda_fused", "cuda_fused")
    assert pick(backend="auto") == ("cuda_fused", "cuda_fused")  # cost 10
    # heterogeneous dims: the fused kernels cannot serve, fall through to
    # the per-layer chain (JAX: pallas_chain)
    assert pick(backend="cuda", layer_dims=(8, 16)) == ("cuda_chain",
                                                        "cuda_chain")
    # the q8 datapath: only an exact pin serves it while the accuracy gate
    # is closed (no artifact); the quant flag alone never does
    assert pick(backend="cuda_fused_q8") == ("cuda_fused_q8",
                                             "cuda_fused_q8")
    assert pick(backend="auto", quant="int8") == ("cuda_fused", "cuda_fused")
    assert pick(backend="cuda", quant="int8") == ("cuda_fused", "cuda_fused")
    assert pick(backend="cuda_fused_q8", layer_dims=(8, 16)) == (
        "cuda_chain", "cuda_chain")
    assert runtime.compile(TCfg(), batch=2) is runtime.compile(TCfg(), batch=2)
    with pytest.raises(runtime.UnknownCellFamily):
        runtime.compile(TCfg(family="convgru"), batch=2)
