"""The plain versions of the port's attention kernels
(``repro_torch.kernels.flash_attn``, ``repro_torch.kernels.decode_attn``)
against the JAX package on the CPU, and their wrappers' checks.

Inputs from a numpy seed, fp32, rtol=atol=1e-5 (fp32 across frameworks:
other summation orders). Oracles: JAX's ``attention_ref`` and
``_xla_flash`` (the chunked online softmax), the Pallas
``flash_attention`` in interpret mode (block 16, S <= 32: interpret mode
is slow), JAX's ``flash_decode_ref`` and the Pallas ``flash_decode`` in
interpret mode. A fully masked cache is held against the Pallas kernel
only: it gives 0 there and in the port, while ``flash_decode_ref`` gives
the uniform mean.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.kernel import flash_decode as jax_flash_decode
from repro.kernels.decode_attn.ops import decode_attend_pallas
from repro.kernels.decode_attn.ref import flash_decode_ref as jax_decode_ref
from repro.kernels.flash_attn.kernel import flash_attention as jax_flash
from repro.kernels.flash_attn.ref import attention_ref as jax_attention_ref
from repro.models.attention import _xla_flash
from repro_torch.kernels.decode_attn import kernel as DK
from repro_torch.kernels.decode_attn import ops as dops
from repro_torch.kernels.decode_attn import ref as dref
from repro_torch.kernels.flash_attn import kernel as FK
from repro_torch.kernels.flash_attn import ref as fref
from repro_torch.kernels._launch import SMEM_LIMIT
from repro_torch.models.attention import _chunked_attention

from _torch_parity import close

TOL = 1e-5


def _qkv(B, Hq, Hkv, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32))


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _heads_minor(*xs):
    """(B,H,S,D) -> (B,S,H,D) for the models' layout."""
    return tuple(jnp.moveaxis(jnp.asarray(x), 1, 2) for x in xs)


# (B, Hq, Hkv, Sq, Sk, D, causal, window): GQA 2 and 4, windows, Sq and Sk
# off the kernel's tiles (32 rows, 64 keys), causal off, Sq > Sk, and
# (last) rows with no valid key: causal, window 4, Sq 40 over Sk 8
FLASH_CASES = [
    (2, 4, 2, 37, 37, 16, True, 0),
    (1, 8, 2, 70, 70, 32, True, 0),
    (2, 4, 1, 45, 45, 16, True, 9),
    (1, 4, 2, 19, 53, 16, False, 0),
    (1, 4, 2, 33, 21, 16, False, 5),
    (1, 2, 2, 40, 8, 16, True, 4),
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", FLASH_CASES)
def test_plain_flash_attention_matches_jax(B, Hq, Hkv, Sq, Sk, D, causal,
                                           window):
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, D, seed=Sq + Sk)
    got = fref.flash_attention_plain(*_t(q, k, v), causal, window)
    close(got, jax_attention_ref(q, k, v, causal=causal, window=window), TOL)
    close(fref.attention_ref(*_t(q, k, v), causal, window),
          jax_attention_ref(q, k, v, causal=causal, window=window), TOL)
    # the models' chunked path (JAX's _xla_flash), (B,S,H,D) layout
    want = np.moveaxis(np.asarray(_xla_flash(*_heads_minor(q, k, v), causal,
                                             window, 16)), 2, 1)
    close(got, want, TOL)
    mine = _chunked_attention(*(x.transpose(1, 2) for x in _t(q, k, v)),
                              causal, window, 16)
    close(mine.transpose(1, 2), want, TOL)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(FK.flash_attention(*_t(q, k, v), causal=causal,
                                          window=window), got)


def test_rows_without_a_valid_key_give_zero():
    q, k, v = _qkv(1, 2, 2, 40, 8, 16, seed=3)
    got = fref.flash_attention_plain(*_t(q, k, v), True, 4)
    # row i has keys (i-4, i] & [0, 8): none from row 11 on
    assert torch.count_nonzero(got[:, :, 11:]) == 0
    assert torch.count_nonzero(got[:, :, :11].abs().sum(-1)) == 2 * 11


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,causal,window", [
    (1, 4, 2, 29, 29, True, 0),      # GQA 2, Sq off the block of 16
    (1, 4, 1, 32, 32, True, 6),      # GQA 4, window, a skipped block
    (1, 2, 2, 24, 8, True, 3),       # rows with no valid key
])
def test_plain_flash_attention_matches_pallas_interpret(B, Hq, Hkv, Sq, Sk,
                                                        causal, window):
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, 16, seed=7 + Sq)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, block_q=16, block_k=16,
                     interpret=True)
    close(fref.flash_attention_plain(*_t(q, k, v), causal, window), want, TOL)


def _cache(B, Hkv, G, C, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hkv, G, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, C, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, C, D)).astype(np.float32))


def _ring(C, pos, written_from=0):
    """slot_pos of a ring of C slots after positions written_from..pos
    (-1 where never written)."""
    sp = np.full((C,), -1, np.int32)
    for p in range(written_from, pos + 1):
        sp[p % C] = p
    return sp


# (B, Hkv, G, C, D, slot_pos, pos, window)
DECODE_CASES = [
    (2, 2, 2, 24, 16, _ring(24, 14), 14, 0),           # empty (-1) slots
    (1, 2, 4, 24, 16, _ring(24, 40), 40, 0),           # ring-wrapped
    (2, 1, 2, 40, 16, _ring(40, 75, 20), 75, 9),       # wrapped + window
    (1, 2, 2, 70, 32, _ring(70, 69), 60, 0),           # slots after pos
    (1, 2, 2, 8, 16, _ring(8, 5), 5, 0),               # C under a tile
]


@pytest.mark.parametrize("B,Hkv,G,C,D,slot_pos,pos,window", DECODE_CASES)
def test_plain_flash_decode_matches_jax(B, Hkv, G, C, D, slot_pos, pos,
                                        window):
    q, kc, vc = _cache(B, Hkv, G, C, D, seed=C + pos)
    valid = slot_pos >= 0
    if window > 0:
        valid &= slot_pos > pos - window
    valid &= slot_pos <= pos
    assert valid.any()
    mask = torch.from_numpy(valid)
    got = dref.flash_decode_plain(*_t(q, kc, vc), mask)
    assert got.dtype == torch.float32
    close(got, jax_decode_ref(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(valid)), TOL)
    close(dref.flash_decode_ref(*_t(q, kc, vc), mask),
          jax_decode_ref(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                         jnp.asarray(valid)), TOL)
    # the ops wrapper builds the same mask from slot_pos and pos
    assert torch.equal(dops.valid_slots(torch.from_numpy(slot_pos), pos,
                                        window), mask)
    t_ops = dops.decode_attend_cuda(*_t(q, kc, vc), torch.from_numpy(slot_pos),
                                    pos, window)
    assert torch.equal(t_ops, got)
    if C in (24, 8):     # Pallas interpret mode: a few small cases only
        close(got, decode_attend_pallas(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(slot_pos), jnp.asarray(pos), window), TOL)


def test_fully_masked_cache_gives_zero_like_pallas():
    q, kc, vc = _cache(1, 2, 2, 16, 16, seed=9)
    none = np.zeros((16,), bool)
    got = dref.flash_decode_plain(*_t(q, kc, vc), torch.from_numpy(none))
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                            jnp.asarray(none), block_c=8, interpret=True)
    close(got, want, TOL)
    assert torch.count_nonzero(got) == 0
    # the naive oracle differs here: the uniform mean of v
    close(dref.flash_decode_ref(*_t(q, kc, vc), torch.from_numpy(none)),
          np.broadcast_to(vc.mean(2, keepdims=True), (1, 2, 2, 16)), TOL)


def test_wrappers_check_operands_and_launch_nothing_on_cpu():
    FK.flash_attention.launches = DK.flash_decode.launches = 0
    q, k, v = _t(*_qkv(1, 4, 2, 5, 5, 16, seed=1))
    with pytest.raises(ValueError, match="head dim"):
        FK.flash_attention(*_t(*_qkv(1, 2, 2, 3, 3, 160, seed=1)))
    with pytest.raises(TypeError, match="dtype"):
        FK.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="contiguous"):
        FK.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="multiple"):
        FK.flash_attention(q[:, :3].contiguous(), k, v)
    qd, kc, vc = _t(*_cache(1, 2, 2, 12, 16, seed=2))
    m = torch.ones(12, dtype=torch.bool)
    with pytest.raises(ValueError, match="mask"):
        DK.flash_decode(qd, kc, vc, torch.ones(11, dtype=torch.bool))
    with pytest.raises(ValueError, match="G="):
        DK.flash_decode(torch.zeros(1, 2, 17, 16), kc, vc, m)
    with pytest.raises(TypeError, match="dtype"):
        DK.flash_decode(qd.to(torch.bfloat16), kc, vc, m)
    # bf16 runs (plain version on the CPU): q's dtype out of prefill,
    # float32 out of decode
    b = FK.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert b.dtype == torch.bfloat16
    d = DK.flash_decode(qd.bfloat16(), kc.bfloat16(), vc.bfloat16(),
                        m.to(torch.uint8))
    assert d.dtype == torch.float32
    assert FK.flash_attention.launches == DK.flash_decode.launches == 0


def test_shared_memory_at_qwen3_head_dim():
    bf16, fp32 = torch.bfloat16, torch.float32
    # flash attention: bf16 on the tensor cores, the q tile and two stages
    # of K and V (64 rows of 128 bf16 each) and 1024 bytes of alignment;
    # fp32 keeps the CUDA-core kernel's layout
    assert FK.smem_bytes(128, bf16) == 82944 <= SMEM_LIMIT
    assert FK.smem_bytes(64, bf16) == 41984
    assert FK.smem_bytes(128, fp32) == 92672 <= SMEM_LIMIT
    # flash decode: a ring of three stages of K and V tiles of 64 slots in
    # the input type (rows padded by 16 bytes); queries and running state
    # live in registers, whatever G
    assert DK.smem_bytes(128, bf16) == 104448 <= SMEM_LIMIT
    assert DK.smem_bytes(128, fp32) == 202752 <= SMEM_LIMIT
    assert DK.smem_bytes(18, bf16) == 3 * 2 * 64 * 32 * 2
