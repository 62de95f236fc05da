"""The port's training path (``repro_torch.optim.adamw``,
``repro_torch.train.trainer``, the models' ``loss_fn``,
``repro_torch.launch.train``) against the JAX package on the CPU.

* AdamW (JAX's ``test_trainer_optim.py`` cases, and random trees at
  several steps): the port against JAX's functions on the same numpy
  inputs within 1e-6 (the arithmetic is JAX's, op for op);
* the gradients of ``loss_fn`` for gru-jet, gru-jet-deep, slstm-jet and
  the dense SMOKE LM (float32) on the same params and batch: rtol 1e-5;
* ``make_train_step`` over 20 steps from JAX's initial state on the same
  stream, microbatches 1 and 2: the loss trajectories within 1e-4 (raw
  params after many steps are not held: AdamW turns gradients at noise
  level into steps of +-lr in either framework);
* the train CLI's output lines;
* no backward through a kernel: every kernel wrapper raises under
  autograd on the CPU too, and ``make_train_step`` refuses a kernel
  backend; a parameter leaf without a gradient raises.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.configs.base import get_smoke_config as jsmoke
from repro.data.pipeline import SyntheticStream as JStream
from repro.distributed.sharding import ShardCtx
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.train import trainer as jtrainer
from repro_torch.configs.base import ShapeConfig, TrainConfig, get_smoke_config
from repro_torch.core.params import flatten, params_from_numpy, state_from_numpy
from repro_torch.data.pipeline import SyntheticStream, shard_batch
from repro_torch.kernels.gru_sequence import kernel as K
from repro_torch.kernels.slstm_cell import kernel as SK
from repro_torch.launch import train as train_cli
from repro_torch.models import api as mapi
from repro_torch.optim import adamw
from repro_torch.train import trainer

ARCHS = ("gru-jet", "gru-jet-deep", "slstm-jet", "qwen3-0.6b")
GRAD_TOL = 1e-5
TRAJ_TOL = 1e-4
ADAM_TOL = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return params_from_numpy(_np(tree), device="cpu")


def _close(a, b, tol):
    fa, fb = flatten(a), flatten(_t(b) if not isinstance(
        next(iter(flatten(b).values()), None), torch.Tensor) else b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_allclose(fa[k].detach().numpy(), fb[k].numpy(),
                                   rtol=tol, atol=tol, err_msg=k)


def _cfgs(arch):
    """(JAX config, port config, shape) of one arch at test size; the
    dense LM in float32 (JAX's own pod-training test does so) and on the
    port's ``chunked`` attention (JAX's ``xla_flash``)."""
    jc, tc = jsmoke(arch), get_smoke_config(arch)
    if arch == "qwen3-0.6b":
        jc = jc.replace(dtype="float32")
        tc = tc.replace(dtype="float32", attn_impl="chunked")
        return jc, tc, (16, 4)
    return jc, tc, (jc.gru.seq_len, 8)


def _jax_stream(jc, shape):
    # JAX's jet stream keys on family "gru"; the port's serves every cell
    # family, so slstm-jet's is JAX's stream under the GRU family
    fam = jc.replace(family="gru") if jc.family == "slstm" else jc
    return JStream(fam, JShape("t", shape[0], shape[1], "train"))


# ---------------------------------------------------------------------------
# AdamW: JAX's cases, then random trees
# ---------------------------------------------------------------------------

def test_adamw_matches_manual():
    kw = dict(learning_rate=1e-2, warmup_steps=0, total_steps=10,
              weight_decay=0.0, grad_clip=1e9)
    p, g = {"w": np.array([1.0, -2.0], np.float32)}, {
        "w": np.array([0.5, 0.5], np.float32)}
    p2, _, m = adamw.adamw_update(_t(p), _t(g), adamw.init_opt_state(_t(p)),
                                  torch.tensor(0, dtype=torch.int32),
                                  TrainConfig(**kw))
    lr0 = float(adamw.lr_schedule(torch.tensor(0), TrainConfig(**kw)))
    expect = np.array([1.0, -2.0]) - lr0 * np.array([1.0, 1.0])
    np.testing.assert_allclose(p2["w"].numpy(), expect, rtol=1e-4)
    jp2, _, jm = jadamw.adamw_update(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        jadamw.init_opt_state(jax.tree.map(jnp.asarray, p)), jnp.array(0),
        JTrain(**kw))
    _close(p2, _np(jp2), ADAM_TOL)
    assert abs(float(m["lr"]) - float(jm["lr"])) <= ADAM_TOL


def test_weight_decay_decoupled():
    kw = dict(learning_rate=1e-2, warmup_steps=0, weight_decay=0.1,
              grad_clip=1e9)
    p, g = {"w": np.array([1.0], np.float32)}, {"w": np.zeros(1, np.float32)}
    p2, _, _ = adamw.adamw_update(_t(p), _t(g), adamw.init_opt_state(_t(p)),
                                  torch.tensor(0), TrainConfig(**kw))
    lr0 = float(adamw.lr_schedule(torch.tensor(0), TrainConfig(**kw)))
    np.testing.assert_allclose(p2["w"].numpy(), 1.0 - lr0 * 0.1, rtol=1e-5)
    jp2, _, _ = jadamw.adamw_update(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        jadamw.init_opt_state(jax.tree.map(jnp.asarray, p)), jnp.array(0),
        JTrain(**kw))
    _close(p2, _np(jp2), ADAM_TOL)


def test_grad_clip():
    g = {"a": np.full((10,), 10.0, np.float32)}
    clipped, gn = adamw.clip_by_global_norm(_t(g), 1.0)
    np.testing.assert_allclose(float(adamw.global_norm(clipped)), 1.0,
                               rtol=1e-5)
    assert float(gn) > 30
    jc, jgn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    _close(clipped, _np(jc), ADAM_TOL)
    assert abs(float(gn) - float(jgn)) <= ADAM_TOL * float(jgn)


def test_lr_schedule_shape():
    cfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    jcfg = JTrain(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(adamw.lr_schedule(torch.tensor(s), cfg))
           for s in range(0, 100, 10)]
    assert lrs[0] < lrs[1]                      # warmup rises
    assert lrs[-1] < lrs[2]                     # cosine decays
    assert lrs[-1] >= 0.1 * 1e-3 - 1e-9         # floor at 10%
    for s in range(0, 130, 7):
        assert abs(float(adamw.lr_schedule(torch.tensor(s), cfg))
                   - float(jadamw.lr_schedule(jnp.array(s), jcfg))) <= 1e-9


@pytest.mark.parametrize("step", (0, 1, 37, 400))
@pytest.mark.parametrize("clip", (0.5, 1e9))
def test_adamw_update_matches_jax_on_the_same_grads(step, clip):
    rng = np.random.default_rng(step)

    def tree(scale=1.0, pos=False):
        def a(*s):
            x = rng.normal(size=s) * scale
            return (np.abs(x) if pos else x).astype(np.float32)
        return {"cells": ({"w": a(5, 9), "b": a(9)}, {"w": a(3, 9)}),
                "head": {"w": a(3, 2)}}
    p, g, mu, nu = tree(), tree(), tree(0.1), tree(0.01, pos=True)
    kw = dict(learning_rate=3e-3, warmup_steps=20, total_steps=300,
              grad_clip=clip)
    p2, o2, m = adamw.adamw_update(
        _t(p), _t(g), {"mu": _t(mu), "nu": _t(nu)},
        torch.tensor(step, dtype=torch.int32), TrainConfig(**kw))
    j = lambda t: jax.tree.map(jnp.asarray, t)   # noqa: E731
    jp2, jo2, jm = jadamw.adamw_update(
        j(p), j(g), {"mu": j(mu), "nu": j(nu)},
        jnp.array(step, jnp.int32), JTrain(**kw))
    _close(p2, _np(jp2), ADAM_TOL)
    _close(o2, _np(jo2), ADAM_TOL)
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=ADAM_TOL)


def test_opt_state_layout_is_jaxs():
    jc, tc, _ = _cfgs("gru-jet-deep")
    jst = jtrainer.init_state(jc, JTrain(), with_ef=True, n_pods=2)
    st = trainer.init_state(tc, TrainConfig(), with_ef=True, n_pods=2,
                            device="cpu")
    fj = {k: np.asarray(v) for k, v in
          ((("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path)), leaf) for path, leaf in
           jax.tree_util.tree_flatten_with_path(jst)[0])}
    ft = flatten(st)
    assert list(fj) == list(ft)
    for k in fj:
        assert fj[k].shape == tuple(ft[k].shape), k
        assert str(fj[k].dtype) == str(ft[k].dtype).replace("torch.", ""), k
    assert all(p.requires_grad for p in flatten(st["params"]).values())


# ---------------------------------------------------------------------------
# gradients of loss_fn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_match_jax(arch):
    jc, tc, shape = _cfgs(arch)
    jparams = jtrainer.init_state(jc, JTrain(), seed=3)["params"]
    b = _jax_stream(jc, shape).batch_at(2)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: japi.get_api(jc).loss_fn(p, jc, jax.tree.map(
            jnp.asarray, b), ShardCtx()), has_aux=True))(jparams)
    params = state_from_numpy({"params": _np(jparams)}, device="cpu")["params"]
    loss, metrics = mapi.get_api(tc).loss_fn(params, tc,
                                             shard_batch(b, device="cpu"))
    fp = flatten(params)
    grads = torch.autograd.grad(loss, list(fp.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=GRAD_TOL)
    assert set(metrics) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   rtol=GRAD_TOL, atol=1e-7)
    fj = flatten(_t(jg))
    for (k, g) in zip(fp, grads):
        np.testing.assert_allclose(g.numpy(), fj[k].numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL * float(fj[k].abs().max()),
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_grads_equal_whole_batch(arch):
    """JAX's microbatch equivalence, and the port's micro-1 gradients
    against JAX's ``_micro_grads``."""
    jc, tc, shape = _cfgs(arch)
    jparams = jtrainer.init_state(jc, JTrain())["params"]
    b = _jax_stream(jc, shape).batch_at(0)
    params = state_from_numpy({"params": _np(jparams)}, device="cpu")["params"]
    loss_fn = trainer._loss_fn(tc)
    tb = shard_batch(b, device="cpu")
    g1, l1, m1 = trainer._micro_grads(loss_fn, params, tb, 1)
    g2, l2, m2 = trainer._micro_grads(loss_fn, params, tb, 2)
    _close(g1, g2, 5e-5)
    jg, jl, _ = jax.jit(lambda p, x: jtrainer._micro_grads(
        lambda p_, x_: japi.get_api(jc).loss_fn(p_, jc, x_, ShardCtx()),
        p, x, 2))(jparams, jax.tree.map(jnp.asarray, b))
    fj, f2 = flatten(_t(jg)), flatten(g2)
    for k in fj:
        np.testing.assert_allclose(f2[k].numpy(), fj[k].numpy(),
                                   rtol=GRAD_TOL,
                                   atol=GRAD_TOL * float(fj[k].abs().max()),
                                   err_msg=k)
    np.testing.assert_allclose(float(l2), float(jl), rtol=GRAD_TOL)


# ---------------------------------------------------------------------------
# make_train_step trajectories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("micro", (1, 2))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_trajectory_matches_jax(arch, micro):
    jc, tc, shape = _cfgs(arch)
    kw = dict(learning_rate=3e-3, warmup_steps=3, total_steps=20,
              microbatches=micro)
    jst = jtrainer.init_state(jc, JTrain(**kw), seed=1)
    st = state_from_numpy(_np(jst), device="cpu")
    jstep = jax.jit(jtrainer.make_train_step(jc, JTrain(**kw), ShardCtx()))
    step = trainer.make_train_step(tc, TrainConfig(**kw))
    jstream = _jax_stream(jc, shape)
    stream = SyntheticStream(tc, ShapeConfig("t", shape[0], shape[1],
                                             "train"))
    jl, tl = [], []
    for s in range(20):
        b = stream.batch_at(s)
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, jstream.batch_at(s)))
        st, m = step(st, shard_batch(b, device="cpu"))
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
        assert set(m) == set(jm)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_TOL, atol=TRAJ_TOL)
    assert int(st["step"]) == int(jst["step"]) == 20


def test_loss_decreases_small_lm():
    cfg = get_smoke_config("qwen3-0.6b").replace(attn_impl="chunked")
    tcfg = TrainConfig(learning_rate=2e-3, warmup_steps=5, total_steps=60)
    state = trainer.init_state(cfg, tcfg, device="cpu")
    step = trainer.make_train_step(cfg, tcfg)
    stream = SyntheticStream(cfg, ShapeConfig("t", 32, 8, "train"))
    losses = []
    for s in range(40):
        state, m = step(state, shard_batch(stream.batch_at(s), device="cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, (losses[0], losses[-1])


def test_chunked_ce_equals_full_softmax_xent():
    from repro_torch.models import layers, transformer
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 12, 8, generator=g, requires_grad=True)
    table = torch.randn(11, 8, generator=g, requires_grad=True)
    tg = torch.randint(0, 11, (2, 12), generator=g)
    mask = torch.rand(2, 12, generator=g) > 0.3
    for tied in (True, False):
        w = table if tied else table.t()
        full = layers.softmax_xent((h @ (w.t() if tied else w)), tg, mask)
        got = transformer.chunked_ce(h, w, tg, mask, tied, chunk=4)
        np.testing.assert_allclose(float(got.detach()), float(full.detach()),
                                   rtol=1e-6)
        ga = torch.autograd.grad(got, (h, table))
        gb = torch.autograd.grad(full, (h, table))
        for a, b in zip(ga, gb):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

LINE = re.compile(r"^step +(\d+) loss=\d+\.\d{4} gnorm=\d+\.\d{3} "
                  r"lr=\d\.\d{2}e[+-]\d{2}( acc=\d\.\d{3})? \(\d+\.\d{2}s\)$")


def _lines(capsys, fn, argv):
    fn(argv)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("arch,extra", [
    ("gru-jet", ["--batch", "8"]),
    ("qwen3-0.6b", ["--smoke", "--batch", "4", "--seq", "16"])])
def test_train_cli_prints_jaxs_lines(capsys, tmp_path, arch, extra):
    from repro.launch import train as jcli
    argv = ["--arch", arch, "--steps", "12", "--log-every", "5"] + extra
    ck = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "5"]
    got = _lines(capsys, train_cli.main, argv + ck + ["--device", "cpu"])
    want = _lines(capsys, jcli.main, argv)
    steps = [int(LINE.match(ln).group(1)) for ln in got if LINE.match(ln)]
    assert steps == [int(LINE.match(ln).group(1)) for ln in want
                     if LINE.match(ln)] == [0, 5, 10, 11]
    for g, w in zip([ln for ln in got if LINE.match(ln)],
                    [ln for ln in want if LINE.match(ln)]):
        assert ("acc=" in g) == ("acc=" in w)
    assert re.match(r"^done: 12 steps in \d+\.\ds; final loss \d+\.\d{4}$",
                    got[-1]) and want[-1].startswith("done: 12 steps in ")
    assert (("attn_impl: cuda -> chunked (the attention kernels have no "
             "backward)" in got) == (arch == "qwen3-0.6b"))
    # resume from the last committed checkpoint (step 12)
    got = _lines(capsys, train_cli.main, argv[:3] + ["14"] + argv[4:] + ck
                 + ["--resume", "--device", "cpu"])
    assert "resumed from step 12" in got
    assert [int(LINE.match(ln).group(1)) for ln in got
            if LINE.match(ln)] == [13]
    assert got[-1].startswith("done: 2 steps in ")


def test_train_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_cli.main(["--arch", "gru-jet", "--steps", "1"])


# ---------------------------------------------------------------------------
# no backward through a kernel; every leaf gets a gradient
# ---------------------------------------------------------------------------

NO_BACKWARD = ("has no backward; train on backend='eager' / "
               "attn_impl='chunked'")
WRAPPERS = (K.KERNELS + K.Q8_KERNELS + K.CHAIN_Q8_KERNELS + SK.SLSTM_KERNELS
            + K.ATTN_KERNELS + K.ROWWISE_KERNELS + K.SHARD_KERNELS
            + (SK.slstm_stack_decode_layers,))


def test_every_kernel_wrapper_is_guarded():
    assert len(WRAPPERS) == 23 and len({w.__name__ for w in WRAPPERS}) == 23


@pytest.mark.parametrize("wrapper", WRAPPERS, ids=lambda w: w.__name__)
def test_kernel_wrapper_raises_under_autograd(wrapper):
    x = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match=re.escape(
            f"{wrapper.__name__} {NO_BACKWARD}")):
        wrapper(x)
    # nested in a sequence argument (the sLSTM decode's per-layer leaves)
    with pytest.raises(RuntimeError, match="has no backward"):
        wrapper(((torch.zeros(1), x),))
    with pytest.raises(RuntimeError, match="has no backward"):
        wrapper(torch.zeros(1), mask=x)


def test_guard_lets_inference_through():
    g = torch.Generator().manual_seed(0)
    h0, xp = torch.randn(2, 4, generator=g), torch.randn(5, 2, 12, generator=g)
    u = torch.randn(4, 12, generator=g, requires_grad=True)
    b = torch.randn(12, generator=g)
    with torch.no_grad():
        out = K.gru_sequence_kernel(h0, xp, u, b)
    assert out.shape == (5, 2, 4)
    assert torch.equal(K.gru_sequence_kernel(h0, xp, u.detach(), b), out)
    with pytest.raises(RuntimeError, match="gru_sequence_kernel has no"):
        K.gru_sequence_kernel(h0, xp, u, b)


@pytest.mark.parametrize("arch,change", [
    ("gru-jet", {"backend": "cuda_fused"}), ("gru-jet", {"backend": "cuda"}),
    ("gru-jet-deep", {"backend": "cuda_chain"}),
    ("gru-jet", {"backend": "cuda_fused_q8"}),
    ("slstm-jet", {"backend": "cuda"}), ("gru-jet", {"backend": "auto"}),
    ("qwen3-0.6b", {"attn_impl": "cuda"})])
def test_kernel_backends_refuse_to_train(arch, change):
    cfg = get_smoke_config(arch)
    if "attn_impl" in change:
        cfg = cfg.replace(**change)
    else:
        cfg = cfg.replace(gru=dataclasses.replace(cfg.gru, **change))
    with pytest.raises(RuntimeError, match=re.escape(NO_BACKWARD)):
        trainer.make_train_step(cfg, TrainConfig())
    if "auto" in change.values():
        return
    # past the step builder, the loss itself stops at the kernel wrapper
    st = trainer.init_state(cfg, TrainConfig(), device="cpu")
    batch = mapi.concrete_batch(cfg, ShapeConfig("t", 6, 2, "train"),
                                device="cpu")
    with pytest.raises(RuntimeError, match=re.escape(NO_BACKWARD)):
        mapi.get_api(cfg).loss_fn(st["params"], cfg, batch)


def test_a_leaf_without_a_gradient_raises(monkeypatch):
    cfg = get_smoke_config("gru-jet")
    st = trainer.init_state(cfg, TrainConfig(), device="cpu")
    batch = mapi.concrete_batch(cfg, ShapeConfig("t", 6, 4, "train"),
                                device="cpu")
    from repro_torch.models import gru_lm
    real = gru_lm.forward

    def cut(params, cfg_, batch_):
        p = dict(params, head={"w": params["head"]["w"],
                               "b": params["head"]["b"].detach()})
        return real(p, cfg_, batch_)
    monkeypatch.setattr(gru_lm, "forward", cut)
    step = trainer.make_train_step(cfg, TrainConfig())
    with pytest.raises(RuntimeError, match=r"no gradient reached the "
                       r"parameter leaves \['head/b'\]"):
        step(st, batch)
    monkeypatch.setattr(gru_lm, "forward", lambda *a: real(*a).detach())
    with pytest.raises(RuntimeError, match="no gradient reached"):
        step(st, batch)
    monkeypatch.setattr(gru_lm, "forward", real)
    st2, m = step(st, batch)
    assert int(st2["step"]) == 1 and np.isfinite(float(m["loss"]))
