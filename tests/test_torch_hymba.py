"""The port's hymba LM (``repro_torch.models.hymba``, family ``hybrid``,
``hymba-1.5b``) and its sliding-window attention against JAX's
``repro.models.hymba`` and ``repro.models.attention`` on the CPU, at
SMOKE size (6 layers, d_model 64, 4/2 heads, window 8, SSM state 4) in
fp32.

Same parameters (JAX ``init_params`` as numpy; the norm scales and the
SSM's ``a_log``, ``dt_bias``, ``conv_b`` and ``d_skip`` perturbed off
their init; the dense biases noise), same tokens. Port ``chunked`` = JAX
``xla_flash`` (with its banded path where S is a multiple of the window
and at least two windows); port ``cuda`` runs the kernels' plain versions
on CPU tensors. Tolerances: 1e-5 (rtol = atol) for the attention paths,
the logits, the loss and the caches (six layers of fp32 products and an
SSM scan in other summation orders); ``prefill`` against the port's own
``prefill_sequential`` at JAX's 3e-4; greedy token streams equal.

Repair (a): JAX's window ring holds min(window, S) slots after a prompt
of S tokens, so below the window each decode step overwrites a key still
in the window and JAX's decode departs from its own teacher-forced
``forward``; the port's ring holds min(window, S + 64) and its decode
equals that ``forward``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import get_smoke_config as jax_get_smoke_config
from repro.distributed.sharding import ShardCtx
from repro.models import attention as jattn
from repro.models import hymba as jhymba
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.params import flatten, init_params, param_count
from repro_torch.kernels.decode_attn import kernel as DK
from repro_torch.kernels.flash_attn import kernel as FK
from repro_torch.models import api as mapi
from repro_torch.models import attention, hymba
from repro_torch.serve.clock import ManualClock
from repro_torch.serve.engine import Request, ServeEngine

from _torch_lm import cfgs, params_np, tokens
from _torch_parity import close, to_jax, to_torch

ARCH = "hymba-1.5b"
TOL = 1e-5
CTX = ShardCtx()


@pytest.fixture(scope="module")
def both():
    cfg, jcfg = cfgs(ARCH)
    pn = params_np(jhymba.lm_specs(jcfg))
    return cfg, jcfg, pn, to_torch(pn), to_jax(pn)


# --- configs and specs ------------------------------------------------------

def test_configs_are_jaxs_field_for_field():
    for mine, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         (get_smoke_config(ARCH), jax_get_smoke_config(ARCH))):
        for f in dataclasses.fields(mine):
            if f.name in ("attn_impl", "gru"):     # the port's names / cells
                continue
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            if f.name == "ssm":
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, f.name
        assert mine.family == "hybrid" and mine.attn_impl == "cuda"
        assert mine.is_recurrent and mine.supports_long_context
        assert mapi.get_api(mine).specs is hymba.lm_specs
    full = get_config(ARCH)
    assert (full.num_heads, full.num_kv_heads, full.resolved_head_dim,
            full.sliding_window) == (25, 5, 64, 1024)


@pytest.mark.parametrize("arch_cfg", ["full", "smoke"])
def test_groups_are_jaxs(arch_cfg):
    """The groups come from the layer count, not ``global_attn_layers``:
    globals at 0, 15, 31 of 32 and at 0, 2, 5 of SMOKE's 6."""
    get = get_config if arch_cfg == "full" else get_smoke_config
    jget = jax_get_config if arch_cfg == "full" else jax_get_smoke_config
    cfg = get(ARCH)
    sizes = hymba._group_sizes(cfg)
    assert sizes == jhymba._group_sizes(jget(ARCH))
    order = [g for g in hymba._GROUPS for _ in range(sizes[g])]
    globals_ = [i for i, g in enumerate(order) if not g.startswith("swa")]
    assert globals_ == list(cfg.global_attn_layers)
    assert len(order) == cfg.num_layers


def test_spec_tree_is_jaxs_and_the_seed_fixes_it(both):
    cfg = get_smoke_config(ARCH)
    mine = flatten(init_params(hymba.lm_specs(cfg), 0, device="cpu"))
    theirs = flatten(both[3])
    assert list(mine) == list(theirs)
    for k in mine:
        assert mine[k].shape == theirs[k].shape, k
    again = flatten(init_params(hymba.lm_specs(cfg), 0, device="cpu"))
    assert all(torch.equal(mine[k], again[k]) for k in mine)
    from repro.core.params import param_count as jparam_count
    assert param_count(hymba.lm_specs(get_config(ARCH))) == \
        jparam_count(jhymba.lm_specs(jax_get_config(ARCH)))


# --- sliding-window attention -------------------------------------------------

def _qkv(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, S, h, D)).astype(np.float32)
                 for h in (Hq, Hkv, Hkv))


@pytest.mark.parametrize("S,W", [(16, 8), (64, 16), (24, 8)])
def test_banded_attention_matches_jax(S, W):
    q, k, v = _qkv(2, S, 4, 2, 16, S + W)
    close(attention._banded_attention(*(torch.from_numpy(a) for a in
                                        (q, k, v)), W),
          jattn._banded_attention(*(jnp.asarray(a) for a in (q, k, v)), W),
          TOL)


@pytest.mark.parametrize("S", [16, 24, 12, 9, 5])
def test_chunked_dispatch_matches_jax(both, S):
    """``attention`` under port ``chunked`` / JAX ``xla_flash`` at window
    8: banded at S = 16 and 24 (multiples of the window, at least two),
    the chunked sweep at 12, 9 and 5; both against JAX's own dispatch."""
    cfg, jcfg, _, tp, jp = both
    p = {k: {kk: vv[0] for kk, vv in v.items()}
         for k, v in tp["blocks"]["swa_a"]["attn"].items()}
    jax_p = {k: {kk: vv[0] for kk, vv in v.items()}
             for k, v in jp["blocks"]["swa_a"]["attn"].items()}
    banded = S % cfg.sliding_window == 0 and S >= 2 * cfg.sliding_window
    calls = []
    orig = attention._banded_attention
    attention._banded_attention = lambda *a: calls.append(1) or orig(*a)
    try:
        x = np.random.default_rng(S).normal(size=(2, S, cfg.d_model)).astype(
            np.float32)
        out, (k, v) = attention.attention(p, cfg, torch.from_numpy(x),
                                          window=cfg.sliding_window)
    finally:
        attention._banded_attention = orig
    jout, (jk, jv) = jattn.attention(jax_p, jcfg, jnp.asarray(x), ctx=CTX,
                                     window=jcfg.sliding_window)
    assert bool(calls) == banded
    close(out, jout, TOL)
    close(k, jk, TOL)
    close(v, jv, TOL)


# --- the LM ---------------------------------------------------------------------

@pytest.mark.parametrize("S", [12, 16])
def test_forward_and_loss_match_jax(both, S):
    cfg, jcfg, _, tp, jp = both
    toks = tokens((S, S - 4, 3), cfg.vocab_size, seed=S)
    close(hymba.forward(tp, cfg, torch.from_numpy(toks)),
          jhymba.forward(jp, jcfg, jnp.asarray(toks), ctx=CTX), TOL)
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, S)).astype(
        np.int32), "targets": rng.integers(0, cfg.vocab_size, (2, S))
        .astype(np.int32), "mask": (rng.random((2, S)) > 0.2).astype(
        np.float32)}
    loss, m = hymba.loss_fn(tp, cfg, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    jloss, jm = jhymba.loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()}, ctx=CTX)
    close(loss, jloss, TOL)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0


def _cache_close(tc, jc, exact_layout=True):
    for g in hymba._GROUPS:
        for k in ("k", "v"):
            close(tc[g]["attn"][k], jc[g]["attn"][k], TOL)
        np.testing.assert_array_equal(tc[g]["attn"]["slot_pos"].numpy(),
                                      np.asarray(jc[g]["attn"]["slot_pos"]))
        for k in ("conv_buf", "state"):
            close(tc[g]["ssm"][k], jc[g]["ssm"][k], TOL)


@pytest.mark.parametrize("S", [8, 12, 16])
def test_prefill_and_decode_match_jax(both, S):
    """S >= window (8): the port's cache is JAX's in values and layout
    (ring slot p % window), before and after the decode steps, which wrap
    the ring."""
    cfg, jcfg, _, tp, jp = both
    toks = tokens((S, S - 3), cfg.vocab_size, seed=30 + S)
    tl, tc = hymba.prefill(tp, cfg, torch.from_numpy(toks))
    jl, jc = jhymba.prefill(jp, jcfg, jnp.asarray(toks), ctx=CTX)
    close(tl, jl, TOL)
    _cache_close(tc, jc)
    for t in range(5):
        nt = np.array([t + 1, 5 * t + 2], np.int32)
        tl, tc = hymba.decode_step(tp, cfg, tc, torch.from_numpy(nt))
        jl, jc = jhymba.decode_step(jp, jcfg, jc, jnp.asarray(nt), ctx=CTX)
        close(tl, jl, TOL)
        assert int(tc["pos"]) == int(jc["pos"]) == S + t
    _cache_close(tc, jc)


def test_prefill_equals_prefill_sequential(both):
    cfg, _, _, tp, _ = both
    for S in (5, 11):
        toks = torch.from_numpy(tokens((S, S), cfg.vocab_size, seed=S))
        close(hymba.prefill(tp, cfg, toks)[0],
              hymba.prefill_sequential(tp, cfg, toks)[0].numpy(), 3e-4)


@pytest.mark.parametrize("S", [3, 5])
def test_short_prompt_ring_repair(both, S):
    """Repair (a): below the window the port's prefill + decode equals
    JAX's teacher-forced forward step by step, while JAX's own decode
    departs from it (its ring of S slots overwrites keys in the window)."""
    cfg, jcfg, _, tp, jp = both
    toks = tokens((S, S), cfg.vocab_size, seed=40 + S)
    nxt = np.random.default_rng(S).integers(1, cfg.vocab_size,
                                            (2, 4)).astype(np.int32)
    full = np.asarray(jhymba.forward(
        jp, jcfg, jnp.asarray(np.concatenate([toks, nxt], 1)), ctx=CTX))
    tl, tc = hymba.prefill(tp, cfg, torch.from_numpy(toks))
    jl, jc = jhymba.prefill(jp, jcfg, jnp.asarray(toks), ctx=CTX)
    assert tc["swa_a"]["attn"]["k"].shape[3] == min(cfg.sliding_window,
                                                    S + hymba.HEADROOM)
    assert jc["swa_a"]["attn"]["k"].shape[3] == S
    close(tl, full[:, S - 1], TOL)
    jax_err = 0.0
    for t in range(4):
        tl, tc = hymba.decode_step(tp, cfg, tc, torch.from_numpy(nxt[:, t]))
        jl, jc = jhymba.decode_step(jp, jcfg, jc, jnp.asarray(nxt[:, t]),
                                    ctx=CTX)
        close(tl, full[:, S + t], TOL)
        jax_err = max(jax_err, float(np.abs(np.asarray(jl)
                                            - full[:, S + t]).max()))
    assert jax_err > 0.1


def test_ring_keeps_the_last_window_in_slot_p_mod_c():
    k = torch.arange(2 * 11 * 1 * 2, dtype=torch.float32).reshape(2, 11, 1, 2)
    for window, S, C in ((8, 11, 8), (8, 3, 8), (100, 11, 75), (0, 11, 75)):
        r = hymba.ring(k[:, :S], k[:, :S], window)
        assert r["k"].shape == (2, 1, C, 2)
        keep = min(window, S) if window else S
        for p in range(S - keep, S):
            assert int(r["slot_pos"][p % C]) == p
            assert torch.equal(r["k"][:, :, p % C], k[:, p])
        assert int((r["slot_pos"] >= 0).sum()) == keep


def test_decode_writes_the_cache_in_place(both):
    cfg, _, _, tp, _ = both
    _, cache = hymba.prefill(tp, cfg, torch.from_numpy(
        tokens((9, 9), cfg.vocab_size, seed=1)))
    k, st = cache["swa_b"]["attn"]["k"], cache["g1"]["ssm"]["state"]
    k0, st0 = k.clone(), st.clone()
    _, out = hymba.decode_step(tp, cfg, cache, torch.tensor([1, 2]))
    assert out["swa_b"]["attn"]["k"] is k and not torch.equal(k, k0)
    assert out["g1"]["ssm"]["state"] is st and not torch.equal(st, st0)


def test_cuda_path_plain_versions_equal_chunked(both):
    """Port ``cuda`` on CPU tensors (the flash kernels' plain versions, the
    window in the kernel's mask) against ``chunked`` (= JAX's numbers):
    forward, prefill and decode."""
    cfg, _, _, tp, _ = both
    cfg_c = cfg.replace(attn_impl="cuda")
    for S in (5, 16):
        toks = torch.from_numpy(tokens((S, S - 2), cfg.vocab_size, seed=S))
        close(hymba.forward(tp, cfg_c, toks),
              hymba.forward(tp, cfg, toks).numpy(), TOL)
        a, ca = hymba.prefill(tp, cfg_c, toks)
        b, cb = hymba.prefill(tp, cfg, toks)
        close(a, b.numpy(), TOL)
        for t in range(3):
            nt = torch.tensor([t + 3, t + 9])
            a, ca = hymba.decode_step(tp, cfg_c, ca, nt)
            b, cb = hymba.decode_step(tp, cfg, cb, nt)
            close(a, b.numpy(), TOL)


# --- serving prep ----------------------------------------------------------------

def test_prepare_params_casts_only_the_dense_weights():
    cfg = get_smoke_config(ARCH).replace(attn_impl="chunked")   # bf16
    params = init_params(hymba.lm_specs(cfg), seed=1, device="cpu")
    with torch.no_grad():
        for g in hymba._GROUPS:
            for k in ("a_log", "dt_bias", "conv_b"):
                params["blocks"][g]["ssm"][k].normal_(0.0, 0.3)
    prep = mapi.get_api(cfg).prepare_params(params, cfg, "cpu")
    flat = flatten(prep)
    for path, v in flat.items():
        leaf = path.split("/")[-1]
        dense = leaf == "w" or path in ("embed", "lm_head")
        assert v.dtype == (torch.bfloat16 if dense else torch.float32), path
    assert flat["blocks/swa_a/ssm/a_log"].dtype == torch.float32
    assert flat["blocks/g0/ssm/dt_bias"].dtype == torch.float32
    again = flatten(hymba.init_prepared(cfg, 1, "cpu"))
    for k, v in again.items():
        assert v.dtype == flat[k].dtype
        if not k.endswith(("a_log", "dt_bias", "conv_b")):
            assert torch.equal(v, flat[k]), k
    toks = torch.from_numpy(tokens((10, 4), cfg.vocab_size, seed=2))
    a, ca = hymba.prefill(params, cfg, toks)
    b, cb = hymba.prefill(prep, cfg, toks)
    assert torch.equal(a, b)
    nxt = torch.tensor([5, 7])
    for _ in range(3):
        a, ca = hymba.decode_step(params, cfg, ca, nxt)
        b, cb = hymba.decode_step(prep, cfg, cb, nxt)
        assert torch.equal(a, b)


# --- the engine and the CLI ---------------------------------------------------

PROMPT_LENS = (3, 7, 5, 11)       # the wave pads to 11 >= the window


def _lm_requests(vocab):
    rng = np.random.default_rng(1)
    return [dict(prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                 max_new_tokens=8) for n in PROMPT_LENS]


def test_engine_streams_equal_jax(both):
    cfg, jcfg, pn, _, _ = both
    jeng = JServeEngine(jcfg, to_jax(pn), ShardCtx(), max_batch=4)
    want = [r.out for r in jeng.generate(
        [JRequest(**r) for r in _lm_requests(cfg.vocab_size)])]
    for impl in ("chunked", "cuda"):
        FK.flash_attention.launches = DK.flash_decode.launches = 0
        eng = ServeEngine(cfg.replace(attn_impl=impl), to_torch(pn),
                          max_batch=4, clock=ManualClock(), device="cpu")
        done = eng.generate([Request(**r)
                             for r in _lm_requests(cfg.vocab_size)])
        assert [r.out for r in done] == want, impl
        stats = eng.latency_stats()
        assert stats["prefills"] == 1 and stats["steps"] == 7
        # CPU tensors: the wrappers ran their plain versions
        assert FK.flash_attention.launches == DK.flash_decode.launches == 0
    assert all(len(s) == 8 for s in want)


def test_cli_serves_the_smoke_config_on_cpu(capsys):
    from repro_torch.launch import serve as cli
    done = cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--requests", "3", "--prompt-len", "10",
                     "--max-new", "4"])
    assert [len(r.out) for r in done] == [4, 4, 4]
    out = capsys.readouterr().out
    assert "bfloat16" in out
    assert "attention: cuda (6 layers, d_model 64, vocab 256; window 8 on " \
        "3 layers) beside SSM heads" in out
