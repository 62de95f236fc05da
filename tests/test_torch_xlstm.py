"""The port's xLSTM LM (``repro_torch.models.xlstm``, family ``ssm``,
``xlstm-125m``) against JAX's ``repro.models.xlstm`` on the CPU, at
SMOKE size (4 layers = 2 mLSTM/sLSTM pairs, d_model 64) in fp32.

Same parameters (JAX ``init_params`` as numpy; the norm scales,
``out_norm``, ``skip`` and the conv biases perturbed off their init; the
dense biases and the sLSTM's raw gate bias ``b`` are noise), same tokens.
Tolerances: 1e-5 (rtol = atol) for the cells, the logits, the loss and
the cells' states (a few layers of fp32 products and exp-gated
recurrences in other summation orders); the LM's cache leaves and the
logits of prefill and the decode steps after it 3e-5 (the conv buffers hold
the residual stream after up to three blocks, |x| up to about 4, whose
fp32 rounding differences reach 1.2e-5 at S = 13 on elements near 0.1,
beyond rtol there; carried through the recurrent states they move the
logits by up to 1.7e-5 at S = 13); ``prefill`` against the port's own
``prefill_sequential`` at JAX's 3e-4 (chunkwise against recurrent sums);
greedy token streams equal.

Repair (b): JAX's prefill keeps a conv tail of S entries where S <
``conv_width - 1`` and its next decode step raises; the port pads the tail
with zeros, and its decode then equals JAX's teacher-forced ``forward``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import get_smoke_config as jax_get_smoke_config
from repro.distributed.sharding import ShardCtx
from repro.models import xlstm as jxlstm
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.params import flatten, init_params
from repro_torch.kernels.gru_sequence import kernel as K
from repro_torch.models import api as mapi
from repro_torch.models import xlstm
from repro_torch.serve.clock import ManualClock
from repro_torch.serve.engine import Request, ServeEngine

from _torch_lm import cfgs, params_np, tokens
from _torch_parity import close, to_jax, to_torch

ARCH = "xlstm-125m"
TOL = 1e-5
STATE_TOL = 3e-5        # the LM cache's leaves, decode logits (docstring)
CTX = ShardCtx()


@pytest.fixture(scope="module")
def both():
    cfg, jcfg = cfgs(ARCH)
    pn = params_np(jxlstm.lm_specs(jcfg))
    return cfg, jcfg, pn, to_torch(pn), to_jax(pn)


def _rand(shape, seed, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) + shift).astype(
        np.float32)


# --- configs and specs ------------------------------------------------------

def test_configs_are_jaxs_field_for_field():
    for mine, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         (get_smoke_config(ARCH), jax_get_smoke_config(ARCH))):
        for f in dataclasses.fields(mine):
            if f.name in ("attn_impl", "gru"):     # the port's names / cells
                continue
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            if f.name == "xlstm":
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, f.name
        assert mine.family == "ssm" and mine.attn_impl == "cuda"
        assert mine.is_recurrent and mine.supports_long_context
        assert mapi.get_api(mine).specs is xlstm.lm_specs


def test_spec_tree_is_jaxs_and_the_seed_fixes_it(both):
    cfg = get_smoke_config(ARCH)
    mine = flatten(init_params(xlstm.lm_specs(cfg), 0, device="cpu"))
    theirs = flatten(both[3])
    assert list(mine) == list(theirs)
    for k in mine:
        assert mine[k].shape == theirs[k].shape, k
    again = flatten(init_params(xlstm.lm_specs(cfg), 0, device="cpu"))
    assert all(torch.equal(mine[k], again[k]) for k in mine)
    # full width: 125 M-class (counted, never built)
    from repro_torch.core.params import param_count
    from repro.core.params import param_count as jparam_count
    assert param_count(xlstm.lm_specs(get_config(ARCH))) == \
        jparam_count(jxlstm.lm_specs(jax_get_config(ARCH)))


# --- the cells ------------------------------------------------------------------

def test_mlstm_recurrent_step_matches_jax():
    B, NH, DH = 2, 3, 8
    q, k, v = (_rand((B, NH, DH), s) for s in (1, 2, 3))
    ig, fg = _rand((B, NH), 4), _rand((B, NH), 5, 1.0)
    state = (_rand((B, NH, DH, DH), 6), _rand((B, NH, DH), 7),
             _rand((B, NH), 8))
    h, st = xlstm.mlstm_recurrent_step(
        *(torch.from_numpy(a) for a in (q, k, v, ig, fg)),
        tuple(torch.from_numpy(a) for a in state))
    jh, jst = jxlstm.mlstm_recurrent_step(
        *(jnp.asarray(a) for a in (q, k, v, ig, fg)),
        tuple(jnp.asarray(a) for a in state))
    close(h, jh, TOL)
    for a, b in zip(st, jst):
        close(a, b, TOL)


@pytest.mark.parametrize("S", [13, 64, 67, 128])
def test_mlstm_chunkwise_matches_jax(S):
    """The chunk is JAX's rule (the largest length <= 64 dividing S: one
    chunk of 13 at 13, 64 at 64 and 128, chunks of 1 at the prime 67),
    which sets the summation order."""
    assert xlstm.chunk_len(S) == {13: 13, 64: 64, 67: 1, 128: 64}[S]
    B, NH, DH = 2, 2, 8
    q, k, v = (_rand((B, NH, S, DH), s) for s in (11, 12, 13))
    ig, fg = _rand((B, NH, S), 14), _rand((B, NH, S), 15, 1.0)
    h, st = xlstm.mlstm_chunkwise(
        *(torch.from_numpy(a) for a in (q, k, v, ig, fg)),
        xlstm.mlstm_init_state(B, NH, DH))
    jh, jst = jxlstm.mlstm_chunkwise(
        *(jnp.asarray(a) for a in (q, k, v, ig, fg)),
        jxlstm.mlstm_init_state(B, NH, DH))
    close(h, jh, TOL)
    for a, b in zip(st, jst):
        close(a, b, TOL)


def test_slstm_step_matches_jax(both):
    cfg, jcfg, pn, tp, jp = both
    p, jps = (tp["pairs"]["s"], jp["pairs"]["s"])
    p = {k: v[0] for k, v in p.items() if not isinstance(v, dict)}
    jps = {k: v[0] for k, v in jps.items() if not hasattr(v, "keys")}
    B, d = 3, cfg.d_model
    xw = _rand((B, 4 * d), 21)
    state = (_rand((B, d), 22), np.abs(_rand((B, d), 23)) + 0.5,
             _rand((B, d), 24), _rand((B, d), 25))
    for _ in range(3):
        st, h = xlstm.slstm_step(p, cfg, tuple(torch.from_numpy(a)
                                               for a in state),
                                 torch.from_numpy(xw))
        jst, jh = jxlstm.slstm_step(jps, jcfg, tuple(jnp.asarray(a)
                                                     for a in state),
                                    jnp.asarray(xw))
        close(h, jh, TOL)
        for a, b in zip(st, jst):
            close(a, b, TOL)
        state = tuple(np.array(a) for a in jst)


# --- the LM ---------------------------------------------------------------------

def test_forward_and_loss_match_jax(both):
    cfg, jcfg, _, tp, jp = both
    toks = tokens((9, 5, 2), cfg.vocab_size, seed=3)
    close(xlstm.forward(tp, cfg, torch.from_numpy(toks)),
          jxlstm.forward(jp, jcfg, jnp.asarray(toks), ctx=CTX), TOL)
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
        np.int32), "targets": rng.integers(0, cfg.vocab_size, (2, 16))
        .astype(np.int32), "mask": (rng.random((2, 16)) > 0.2).astype(
        np.float32)}
    loss, m = xlstm.loss_fn(tp, cfg, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    jloss, jm = jxlstm.loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()}, ctx=CTX)
    close(loss, jloss, TOL)
    close(m["ce"], jm["ce"], TOL)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0


def _cache_close(tc, jc):
    for part in ("m", "s"):
        for k in tc[part]:
            close(tc[part][k], jc[part][k], STATE_TOL)


@pytest.mark.parametrize("S", [3, 8, 13])
def test_prefill_and_decode_match_jax(both, S):
    """S >= conv_width - 1 = 3, where JAX's prefill cache is well formed."""
    cfg, jcfg, _, tp, jp = both
    toks = tokens((S, S - 1), cfg.vocab_size, seed=S)
    tl, tc = xlstm.prefill(tp, cfg, torch.from_numpy(toks))
    jl, jc = jxlstm.prefill(jp, jcfg, jnp.asarray(toks), ctx=CTX)
    close(tl, jl, STATE_TOL)
    _cache_close(tc, jc)
    assert int(tc["pos"]) == int(jc["pos"]) == S - 1
    for t in range(4):
        nt = np.array([t + 1, 7 * t + 2], np.int32)
        tl, tc = xlstm.decode_step(tp, cfg, tc, torch.from_numpy(nt))
        jl, jc = jxlstm.decode_step(jp, jcfg, jc, jnp.asarray(nt), ctx=CTX)
        close(tl, jl, STATE_TOL)
    _cache_close(tc, jc)


def test_prefill_equals_prefill_sequential(both):
    """Inside the port: the chunkwise prefill against the per-token
    baseline, logits and the next decode step, at JAX's 3e-4."""
    cfg, _, _, tp, _ = both
    toks = torch.from_numpy(tokens((10, 10), cfg.vocab_size, seed=4))
    lp, cp = xlstm.prefill(tp, cfg, toks)
    ls, cs = xlstm.prefill_sequential(tp, cfg, toks)
    close(lp, ls.numpy(), 3e-4)
    nt = torch.zeros(2, dtype=torch.long)
    close(xlstm.decode_step(tp, cfg, cp, nt)[0],
          xlstm.decode_step(tp, cfg, cs, nt)[0].numpy(), 3e-4)


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompt_repair(both, S):
    """Repair (b): at S < conv_width - 1 the port's prefill + decode equals
    JAX's teacher-forced forward; JAX's own decode raises there."""
    cfg, jcfg, _, tp, jp = both
    toks = tokens((S, S), cfg.vocab_size, seed=20 + S)
    nxt = np.array([[5, 9, 11], [3, 4, 6]], np.int32)
    full = np.asarray(jxlstm.forward(
        jp, jcfg, jnp.asarray(np.concatenate([toks, nxt], 1)), ctx=CTX))
    tl, tc = xlstm.prefill(tp, cfg, torch.from_numpy(toks))
    assert tuple(tc["m"]["conv_buf"].shape[2:3]) == (cfg.xlstm.conv_width - 1,)
    close(tl, full[:, S - 1], TOL)
    for t in range(3):
        tl, tc = xlstm.decode_step(tp, cfg, tc, torch.from_numpy(nxt[:, t]))
        close(tl, full[:, S + t], TOL)
    _, jc = jxlstm.prefill(jp, jcfg, jnp.asarray(toks), ctx=CTX)
    assert jc["m"]["conv_buf"].shape[2] < cfg.xlstm.conv_width - 1
    with pytest.raises(TypeError, match="broadcast"):
        jxlstm.decode_step(jp, jcfg, jc, jnp.asarray(nxt[:, 0]), ctx=CTX)


def test_decode_writes_the_cache_in_place(both):
    cfg, _, _, tp, _ = both
    _, cache = xlstm.prefill(tp, cfg, torch.from_numpy(
        tokens((5, 5), cfg.vocab_size, seed=1)))
    C = cache["m"]["C"]
    before = C.clone()
    _, out = xlstm.decode_step(tp, cfg, cache, torch.tensor([1, 2]))
    assert out["m"]["C"] is C and not torch.equal(C, before)
    assert int(out["pos"]) == int(cache["pos"]) + 1


def test_init_cache_is_jaxs(both):
    cfg, jcfg, _, _, _ = both
    tc = xlstm.init_cache(cfg, 3, device="cpu")
    jc = jxlstm.init_cache(jcfg, 3)
    for part in ("m", "s"):
        for k in jc[part]:
            np.testing.assert_array_equal(tc[part][k].float().numpy(),
                                          np.asarray(jc[part][k], np.float32))
    assert int(tc["pos"]) == int(jc["pos"])


# --- serving prep ----------------------------------------------------------------

def test_prepare_params_casts_only_the_dense_weights():
    cfg = get_smoke_config(ARCH)                      # bfloat16 compute
    params = init_params(xlstm.lm_specs(cfg), seed=1, device="cpu")
    with torch.no_grad():
        for blk in params["pairs"].values():
            for k in ("conv_b", "b"):
                if k in blk and not isinstance(blk[k], dict):
                    blk[k].normal_(0.0, 0.3)
    prep = mapi.get_api(cfg).prepare_params(params, cfg, "cpu")
    bf16 = {k for k, v in flatten(prep).items() if v.dtype == torch.bfloat16}
    f32 = {k for k, v in flatten(prep).items() if v.dtype == torch.float32}
    assert "pairs/s/b" in f32 and "pairs/s/r" in f32      # the sLSTM's own
    for k in ("pairs/m/conv", "pairs/m/skip", "pairs/m/out_norm",
              "pairs/m/ln/scale", "final_norm/scale", "pairs/s/conv_b"):
        assert k in f32, k
    for k in ("embed", "lm_head", "pairs/s/w/w", "pairs/m/w_i/b",
              "pairs/m/w_i/w", "pairs/s/up/w"):
        assert k in bf16, k
    assert bf16 | f32 == set(flatten(prep))
    again = xlstm.init_prepared(cfg, 1, "cpu")
    for k, v in flatten(again).items():
        if k not in ("pairs/m/conv_b", "pairs/s/conv_b", "pairs/s/b"):
            assert v.dtype == flatten(prep)[k].dtype
            assert torch.equal(v, flatten(prep)[k]), k
    toks = torch.from_numpy(tokens((6, 3), cfg.vocab_size, seed=2))
    a, ca = xlstm.prefill(params, cfg, toks)
    b, cb = xlstm.prefill(prep, cfg, toks)
    assert torch.equal(a, b)
    nxt = torch.tensor([5, 7])
    for _ in range(3):
        a, ca = xlstm.decode_step(params, cfg, ca, nxt)
        b, cb = xlstm.decode_step(prep, cfg, cb, nxt)
        assert torch.equal(a, b)


# --- the engine and the CLI ---------------------------------------------------

PROMPT_LENS = (3, 7, 5, 11)


def _lm_requests(vocab):
    rng = np.random.default_rng(1)
    return [dict(prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                 max_new_tokens=8) for n in PROMPT_LENS]


def test_engine_streams_equal_jax(both):
    cfg, jcfg, pn, _, _ = both
    jeng = JServeEngine(jcfg, to_jax(pn), ShardCtx(), max_batch=4)
    want = [r.out for r in jeng.generate(
        [JRequest(**r) for r in _lm_requests(cfg.vocab_size)])]
    K.reset_launch_counts()
    eng = ServeEngine(cfg, to_torch(pn), max_batch=4, clock=ManualClock(),
                      device="cpu")
    done = eng.generate([Request(**r) for r in _lm_requests(cfg.vocab_size)])
    assert [r.out for r in done] == want
    assert all(len(s) == 8 for s in want)
    stats = eng.latency_stats()
    assert stats["prefills"] == 1 and stats["steps"] == 7
    assert stats["served_dtype"] == "float32"
    # no kernel of the port's on this path
    assert all(k.launches == 0 for k in K.ATTN_KERNELS + K.KERNELS)


def test_cli_serves_the_smoke_config_on_cpu(capsys):
    from repro_torch.launch import serve as cli
    done = cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--requests", "3", "--prompt-len", "6",
                     "--max-new", "4"])
    assert [len(r.out) for r in done] == [4, 4, 4]
    out = capsys.readouterr().out
    assert "bfloat16" in out and "xLSTM blocks (4 layers" in out
