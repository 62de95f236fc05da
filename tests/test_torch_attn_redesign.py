"""The structure of the redesigned attention kernels, on the CPU.

* ``num_splits``: how the flash-decode kernel cuts the cache over blocks
  (the grid is ``(B*Hkv, num_splits(B, Hkv, C))``).
* ``ref.flash_decode_split_plain``: the split-cache algorithm in plain
  PyTorch (partial online softmax per split, merge in split order),
  against JAX's ``flash_decode`` in interpret mode and its
  ``flash_decode_ref``, for every split count, within 1e-5 (fp32 across
  frameworks: other summation orders).
* ``bf16_tensor_core_plain`` (here): the bf16 tensor-core kernel's
  numerics (bf16 operands, fp32 sums, the scale after the product, P as
  hi + lo bf16) against JAX's ``flash_attention`` in interpret mode on the
  same bf16 inputs, within rtol = atol = 2**-7 (both round their output
  to bf16: one bf16 ulp of an output near 1).

Inputs from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.kernel import flash_decode as jax_flash_decode
from repro.kernels.decode_attn.ref import flash_decode_ref as jax_decode_ref
from repro.kernels.flash_attn.kernel import flash_attention as jax_flash
from repro_torch.kernels.decode_attn import kernel as DK
from repro_torch.kernels.decode_attn import ref as dref
from repro_torch.kernels.flash_attn import ref as fref

from _torch_parity import close

TOL = 1e-5
BF16_TOL = 2.0 ** -7


@pytest.mark.parametrize("B,Hkv,C", [
    (1, 8, 2112), (4, 8, 192), (4, 8, 76), (1, 8, 65), (1, 1, 64),
    (1, 2, 5000), (2, 4, 130), (17, 8, 2112), (4, 8, 2112), (1, 1, 1),
    (1, 1, 64 * 500),
])
@pytest.mark.parametrize("sms", [DK.SM_COUNT, 114])   # H100 SXM and PCIe
def test_num_splits_fills_the_sms_with_whole_tiles(B, Hkv, C, sms):
    tiles = -(-C // DK.BLOCK_C)
    s = DK.num_splits(B, Hkv, C, sms)
    assert 1 <= s <= min(tiles, DK.MAX_SPLITS)   # never more than C's tiles
    if tiles <= DK.STAGES:                       # one block copies it all
        assert s == 1
    else:                                        # one wave that fills the
        blocks = B * Hkv * s                     # SMs as far as whole
        assert blocks <= max(sms, B * Hkv)       # splits, the tiles and
        assert (blocks + B * Hkv > sms           # MAX_SPLITS allow
                or s == min(tiles, DK.MAX_SPLITS))
    bounds = dref.split_bounds(C, s)             # every split has a tile
    assert bounds[0][0] == 0 and bounds[-1][1] == C
    assert all(c1 > c0 for c0, c1 in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(c0 % DK.BLOCK_C == 0 for c0, _ in bounds)


def test_flash_decode_at_one_request_runs_more_blocks_than_heads():
    # qwen3-0.6b's 8 kv-heads at B = 1, C = 2112: 16 splits, 128 blocks;
    # the served caches (C = 76, 192 at B = 4) stay one block per head
    assert DK.num_splits(1, 8, 2112) == 16
    assert DK.num_splits(1, 8, 2112, sms=114) == 14     # one wave there too
    assert DK.num_splits(4, 8, 76) == DK.num_splits(4, 8, 192) == 1
    with pytest.raises(ValueError, match="splits"):
        dref.split_bounds(100, 3)                # 2 tiles of 64


def _ring(C, pos, written_from=0):
    sp = np.full((C,), -1, np.int32)
    for p in range(written_from, pos + 1):
        sp[p % C] = p
    return sp


def _valid(slot_pos, pos, window):
    valid = slot_pos >= 0
    if window > 0:
        valid &= slot_pos > pos - window
    return valid & (slot_pos <= pos)


# (B, Hkv, G, C, D, block_c, slot_pos, pos, window): splits that hold no
# valid slot, a wrapped ring, a window over a wrapped ring, C off the
# tile, the kernel's own tile of 64 slots, a fully masked cache
SPLIT_CASES = [
    (1, 2, 2, 40, 16, 8, _ring(40, 11), 11, 0),        # valid in split 0
    (2, 1, 3, 40, 16, 8, _ring(40, 75, 20), 75, 0),    # wrapped ring
    (1, 2, 2, 48, 16, 8, _ring(48, 90, 30), 90, 13),   # wrapped + window
    (1, 1, 2, 45, 16, 8, _ring(45, 44), 44, 0),        # C off the tile
    (1, 2, 2, 200, 16, 64, _ring(200, 180), 180, 0),   # 64-slot tiles
    (1, 2, 2, 24, 16, 8, None, 0, 0),                  # fully masked
]


@pytest.mark.parametrize("B,Hkv,G,C,D,block_c,slot_pos,pos,window",
                         SPLIT_CASES)
def test_split_plain_matches_jax_for_every_split_count(
        B, Hkv, G, C, D, block_c, slot_pos, pos, window):
    rng = np.random.default_rng(C + pos + block_c)
    q = rng.normal(size=(B, Hkv, G, D)).astype(np.float32)
    kc = rng.normal(size=(B, Hkv, C, D)).astype(np.float32)
    vc = rng.normal(size=(B, Hkv, C, D)).astype(np.float32)
    valid = (np.zeros((C,), bool) if slot_pos is None
             else _valid(slot_pos, pos, window))
    tq, tk, tv, tm = (torch.from_numpy(x) for x in (q, kc, vc, valid))
    # JAX's Pallas kernel (interpret mode) needs a block that divides C
    jb = next(b for b in range(min(block_c, C), 0, -1) if C % b == 0)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                            jnp.asarray(valid), block_c=jb, interpret=True)
    naive = jax_decode_ref(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                           jnp.asarray(valid))
    tiles = -(-C // block_c)
    for splits in range(1, tiles + 1):
        got = dref.flash_decode_split_plain(tq, tk, tv, tm, splits, block_c)
        assert got.dtype == torch.float32
        close(got, want, TOL)
        if valid.any():
            close(got, naive, TOL)
        else:                                    # JAX's naive oracle gives
            assert torch.count_nonzero(got) == 0  # the mean there, not 0
    # one split is the kernel's plain version, bit for bit
    assert torch.equal(dref.flash_decode_split_plain(tq, tk, tv, tm, 1,
                                                     block_c),
                       dref.flash_decode_plain(tq, tk, tv, tm, block_c))


def test_split_cases_hold_splits_without_a_valid_slot():
    B, Hkv, G, C, D, block_c, slot_pos, pos, window = SPLIT_CASES[0]
    valid = _valid(slot_pos, pos, window)
    bounds = dref.split_bounds(C, 5, block_c)
    assert [bool(valid[c0:c1].any()) for c0, c1 in bounds] == \
        [True, True, False, False, False]


LOG2E = 1.4426950408889634


def bf16_tensor_core_plain(q, k, v, causal: bool = True, window: int = 0,
                           block_k: int = 64):
    """The bf16 CUDA kernel's arithmetic over blocks of ``block_k`` keys:
    q, k, v rounded to bf16; S = q.k^T in fp32 (bf16 products are exact
    there); the row max taken on S, then ``c = scale * log2(e)`` (fp32)
    applied after the product, ``p = exp2(S * c - m)``; P split into hi =
    bf16(p) and lo = bf16(p - hi), each times bf16 V, summed into fp32
    acc. Returns bf16."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.bfloat16().float().reshape(B, Hkv, G, Sq, D)
    kf, vf = k.bfloat16().float(), v.bfloat16().float()
    c = (torch.tensor(1.0 / (D ** 0.5), dtype=torch.float32)
         * torch.tensor(LOG2E, dtype=torch.float32))
    m = torch.full((B, Hkv, G, Sq, 1), fref.NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq, 1), device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, D), device=q.device)
    for k0 in range(0, Sk, block_k):
        k1 = min(k0 + block_k, Sk)
        mask = fref._mask(Sq, k0, k1, causal, window, q.device)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf[:, :, k0:k1])
        mx = torch.where(mask, s, torch.full_like(s, fref.NEG_INF)).amax(
            -1, keepdim=True)
        mx = torch.where(mx == fref.NEG_INF, mx, mx * c)   # log2 units
        m_new = torch.maximum(m, mx)
        p = torch.where(mask, torch.exp2(s * c - m_new), torch.zeros_like(s))
        alpha = torch.exp2(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        vt = vf[:, :, k0:k1]
        acc = (acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", hi, vt)
               + torch.einsum("bhgqk,bhkd->bhgqd", lo, vt))
        m = m_new
    o = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.reshape(B, Hq, Sq, D).bfloat16()


# the small ATTN_CASES of the card tests (B, Hq, Hkv, Sq, Sk, D, causal,
# window): qwen3's heads at S = 12, Sq > Sk over a window (rows with no
# valid key), causal off with Sk off the tile, GQA 4, D off the vectors
TC_CASES = [
    (4, 16, 8, 12, 12, 128, True, 0),
    (1, 8, 2, 45, 77, 64, False, 0),
    (1, 4, 4, 40, 8, 16, True, 4),
    (2, 8, 2, 33, 33, 32, False, 7),
    (1, 4, 2, 50, 50, 18, True, 0),
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", TC_CASES)
def test_tensor_core_numerics_match_jax_flash_attention(B, Hq, Hkv, Sq, Sk,
                                                        D, causal, window):
    rng = np.random.default_rng(Sq + Sk + D)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .bfloat16() for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D),
                                     (B, Hkv, Sk, D)))
    got = bf16_tensor_core_plain(q, k, v, causal, window)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    want = jax_flash(jq, jk, jv, causal=causal, window=window,
                     interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    torch.testing.assert_close(got.float(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)
    # and the wrapper's CPU plain version, which the card kernel is held to
    torch.testing.assert_close(
        got.float(), fref.flash_attention_plain(q, k, v, causal,
                                                window).float(),
        rtol=BF16_TOL, atol=BF16_TOL)
    # rows with no valid key give exactly 0
    no_key = ~fref._mask(Sq, 0, Sk, causal, window, "cpu").any(-1)
    assert torch.count_nonzero(got[:, :, no_key]) == 0
