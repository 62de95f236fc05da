"""The port's compressed data-parallel training
(``repro_torch.distributed.compression``,
``repro_torch.train.trainer.make_pod_train_step``) on a 2-rank gloo mesh
of CPU processes, against the JAX package's on 2 host devices.

* ``pod_allreduce_mean`` on the same per-rank gradients (and residuals):
  ``none`` and ``bf16`` means within 1e-6; ``int8_ef``'s agreed scale and
  every rank's int8 codes bit for bit (JAX's codes recovered from its
  residual, ``round((g + e - e') / scale)``), its means and residuals
  within 1e-6;
* ``make_pod_train_step`` for ``none``, ``bf16`` and ``int8_ef`` from
  JAX's initial state (the dense SMOKE LM in float32, batch 8 split over
  the two ranks/pods): the loss trajectory of 5 steps within 1e-4, and
  every rank's ``ef`` row after the first step within 1e-5 of JAX's on
  the gradients' scale (a residual carries the frameworks' gradient
  difference), but for elements on a rounding boundary, whose codes the
  difference rounds the other way (their residuals opposite; at most
  0.1 % of them);
* JAX's tracking assertion (``test_pod_compressed_training``): over 15
  steps ``none`` and ``int8_ef`` both train, and end within 0.5.

Each side runs once (the port's ranks through ``run_ranks``, JAX through
``run_multidev``), every case inside.
"""
import pickle

import jax
import numpy as np
import pytest

from repro.configs.base import TrainConfig as JTrain
from repro.configs.base import get_smoke_config as jsmoke
from repro.train import trainer as jtrainer

from _torch_parity import run_ranks

MEAN_TOL = 1e-6
GRAD_TOL = 1e-5
TRAJ_TOL = 1e-4
METHODS = ("none", "bf16", "int8_ef")
STEPS, TRACK_STEPS = 5, 15

RANK_BODY = r"""
import pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.configs.base import ShapeConfig, TrainConfig, get_smoke_config
from repro_torch.core.params import flatten, params_from_numpy, state_from_numpy
from repro_torch.data.pipeline import SyntheticStream, shard_batch
from repro_torch.distributed import compression, init_mesh
from repro_torch.train import trainer

n, rank, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
mesh = init_mesh(n, rank, init_file=store, device="cpu", backend="gloo",
                 timeout_s=120)
inp = pickle.load(open(work + "/inputs.pkl", "rb"))
out = {"allreduce": {}, "runs": {}}
g = params_from_numpy(inp["grads"][rank], device="cpu")
e = params_from_numpy(inp["ef"][rank], device="cpu")
for method in ("none", "bf16", "int8_ef"):
    means, ef2 = compression.pod_allreduce_mean(
        g, method, mesh, e if method == "int8_ef" else None)
    r = {"means": {k: v.numpy() for k, v in flatten(means).items()}}
    if method == "int8_ef":
        r["ef"] = {k: v.numpy() for k, v in flatten(ef2).items()}
        fg, fe = flatten(g), flatten(e)
        r["scale"], r["codes"] = {}, {}
        for k in fg:
            gc = fg[k] + fe[k]
            s = compression.int8_scale(gc, mesh)
            r["scale"][k] = s.numpy()
            r["codes"][k] = compression.int8_codes(gc, s).numpy()
    out["allreduce"][method] = r
cfg = get_smoke_config("qwen3-0.6b").replace(dtype="float32",
                                             attn_impl="chunked")
stream = SyntheticStream(cfg, ShapeConfig("t", 16, 8, "train"))
for method, steps in (("none", inp["track_steps"]), ("bf16", inp["steps"]),
                      ("int8_ef", inp["track_steps"])):
    tcfg = TrainConfig(**inp["tcfg"], grad_compression=method)
    st = state_from_numpy(inp["state"], device="cpu")
    if method != "int8_ef":
        del st["ef"]
    step = trainer.make_pod_train_step(cfg, tcfg, mesh)
    losses, ef1 = [], None
    for s in range(steps):
        st, m = step(st, shard_batch(stream.batch_at(s), mesh))
        losses.append(float(m["loss"]))
        if s == 0 and method == "int8_ef":
            ef1 = {k: v[rank].numpy() for k, v in flatten(st["ef"]).items()}
    out["runs"][method] = {"losses": losses, "ef1": ef1}
pickle.dump(out, open(f"{work}/rank{rank}.pkl", "wb"))
dist.destroy_process_group()
"""

JAX_BODY = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs.base import ShapeConfig, TrainConfig, get_smoke_config
from repro.data.pipeline import SyntheticStream
from repro.distributed.compression import pod_allreduce_mean
from repro.distributed.sharding import ShardCtx
from repro.train import trainer

work = WORK
inp = pickle.load(open(work + "/inputs.pkl", "rb"))
out = {"allreduce": {}, "runs": {}}
mesh = compat.make_mesh((2,), ("pod",))
stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
g, e = stack(inp["grads"]), stack(inp["ef"])
for method in ("none", "bf16", "int8_ef"):
    def f(g, e):
        gl = jax.tree.map(lambda x: x[0], g)
        el = jax.tree.map(lambda x: x[0], e)
        m, e2 = pod_allreduce_mean(gl, method, "pod",
                                   el if method == "int8_ef" else None)
        e2 = el if e2 is None else e2
        return (jax.tree.map(lambda x: x[None], m),
                jax.tree.map(lambda x: x[None], e2))
    m, e2 = jax.jit(compat.shard_map(
        f, mesh=mesh, axis_names={"pod"}, in_specs=(P("pod"), P("pod")),
        out_specs=(P("pod"), P("pod")), check_vma=False))(g, e)
    out["allreduce"][method] = {"means": jax.tree.map(np.asarray, m),
                                "ef": jax.tree.map(np.asarray, e2)}
cfg = get_smoke_config("qwen3-0.6b").replace(dtype="float32",
                                             param_dtype="float32")
ctx = ShardCtx(mesh=compat.make_mesh((2, 1), ("pod", "data")))
stream = SyntheticStream(cfg, ShapeConfig("t", 16, 8, "train"))
for method, steps in (("none", inp["track_steps"]), ("bf16", inp["steps"]),
                      ("int8_ef", inp["track_steps"])):
    tcfg = TrainConfig(**inp["tcfg"], grad_compression=method)
    st = jax.tree.map(jnp.asarray, inp["state"])
    if method != "int8_ef":
        del st["ef"]
    step = jax.jit(trainer.make_pod_train_step(cfg, tcfg, ctx))
    losses, ef1 = [], None
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in stream.batch_at(s).items()}
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
        if s == 0 and method == "int8_ef":
            ef1 = jax.tree.map(np.asarray, st["ef"])
    out["runs"][method] = {"losses": losses, "ef1": ef1}
pickle.dump(out, open(work + "/jax.pkl", "wb"))
print("PASS")
"""

TCFG = dict(learning_rate=2e-3, warmup_steps=2, total_steps=30)


def _tree(rng, scale=1.0):
    a = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)  # noqa
    return {"w": a(6, 9), "cells": ({"u": a(4, 12), "b": a(12)},),
            "tiny": a(5) * 1e-6}


@pytest.fixture(scope="module")
def results(tmp_path_factory, multidev):
    """Both sides' results, each run once: (inputs, the port's two ranks',
    JAX's)."""
    work = tmp_path_factory.mktemp("pod")
    rng = np.random.default_rng(0)
    state = jax.tree.map(np.asarray, jtrainer.init_state(
        jsmoke("qwen3-0.6b").replace(dtype="float32"), JTrain(**TCFG),
        seed=4, with_ef=True, n_pods=2))
    inp = {"grads": [_tree(rng) for _ in range(2)],
           "ef": [_tree(rng, 0.01) for _ in range(2)],
           "state": state, "tcfg": TCFG, "steps": STEPS,
           "track_steps": TRACK_STEPS}
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    run_ranks(RANK_BODY, 2, work, timeout=300)
    multidev(JAX_BODY.replace("WORK", repr(str(work))), n_devices=2,
             timeout=300)
    ranks = [pickle.load(open(work / f"rank{r}.pkl", "rb")) for r in (0, 1)]
    return inp, ranks, pickle.load(open(work / "jax.pkl", "rb"))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("method", METHODS)
def test_allreduce_means_match_jax(results, method):
    _, ranks, jx = results
    want = _flat(jx["allreduce"][method]["means"])
    for r, res in enumerate(ranks):
        got = res["allreduce"][method]["means"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k][r], rtol=MEAN_TOL,
                                       atol=MEAN_TOL * np.abs(want[k]).max(),
                                       err_msg=k)
        if method != "int8_ef":   # replicated means: every rank the same
            assert all(np.array_equal(got[k], ranks[0]["allreduce"][method]
                                      ["means"][k]) for k in got)


def test_int8_codes_are_jaxs_bit_for_bit(results):
    inp, ranks, jx = results
    jef = _flat(jx["allreduce"]["int8_ef"]["ef"])
    for r, res in enumerate(ranks):
        a = res["allreduce"]["int8_ef"]
        g, e = _flat(inp["grads"][r]), _flat(inp["ef"][r])
        for k, codes in a["codes"].items():
            scale = np.float32(a["scale"][k])
            # the agreed scale: the max over the ranks, computed as JAX does
            want_scale = max(np.float32(max(np.abs(
                _flat(inp["grads"][q])[k] + _flat(inp["ef"][q])[k]).max(),
                np.float32(1e-12))) / np.float32(127.0) for q in (0, 1))
            assert scale == want_scale, k
            gc = g[k] + e[k]
            jcodes = np.rint((gc - jef[k][r]) / scale)
            assert codes.dtype == np.int8
            assert np.array_equal(codes.astype(np.float32), jcodes), k
            np.testing.assert_allclose(a["ef"][k], jef[k][r], rtol=MEAN_TOL,
                                       atol=MEAN_TOL * np.abs(gc).max(),
                                       err_msg=k)
    # the rank-local codes sum to JAX's int32 psum
    jmean = _flat(jx["allreduce"]["int8_ef"]["means"])
    for k in jmean:
        summed = sum(res["allreduce"]["int8_ef"]["codes"][k].astype(np.int32)
                     for res in ranks)
        scale = np.float32(ranks[0]["allreduce"]["int8_ef"]["scale"][k])
        assert np.array_equal(summed, np.rint(jmean[k][0] * 2 / scale)), k


@pytest.mark.parametrize("method", METHODS)
def test_pod_train_step_matches_jax(results, method):
    _, ranks, jx = results
    want = jx["runs"][method]["losses"][:STEPS]
    for res in ranks:
        got = res["runs"][method]["losses"][:STEPS]
        np.testing.assert_allclose(got, want, rtol=TRAJ_TOL, atol=TRAJ_TOL)
    assert ranks[0]["runs"][method]["losses"] == \
        ranks[1]["runs"][method]["losses"]
    if method == "int8_ef":
        jef = _flat(jx["runs"][method]["ef1"])
        for r, res in enumerate(ranks):
            got = res["runs"][method]["ef1"]
            assert set(got) == set(jef)
            flips = total = 0
            for k in jef:
                # a residual is g + e minus its quantized value, so it
                # carries the two frameworks' gradient difference: held at
                # the gradients' tolerance on their scale, which is at
                # least 127 x 2 max|e'| (|e'| <= scale / 2). Where g + e
                # sits on a rounding boundary (half a step), that
                # difference rounds the code the other way: the residuals
                # are then +-scale/2, opposite. Such flips are counted.
                want_k, got_k = jef[k][r], got[k]
                tol = GRAD_TOL * 254 * np.abs(jef[k]).max()
                bad = ~np.isclose(got_k, want_k, rtol=GRAD_TOL, atol=tol)
                assert np.allclose(got_k[bad], -want_k[bad], rtol=GRAD_TOL,
                                   atol=tol), k
                flips += int(bad.sum())
                total += want_k.size
            assert flips <= 1e-3 * total, (flips, total)


def test_int8_ef_tracks_uncompressed_training(results):
    """JAX's ``test_pod_compressed_training`` assertion on the port."""
    _, ranks, jx = results
    for side in [r["runs"] for r in ranks] + [jx["runs"]]:
        none, q = side["none"]["losses"], side["int8_ef"]["losses"]
        assert none[-1] < none[0] - 0.05
        assert q[-1] < q[0] - 0.05
        assert abs(q[-1] - none[-1]) < 0.5, (none[-1], q[-1])


def test_compressed_bytes_per_param():
    from repro.distributed.compression import compressed_bytes_per_param as j
    from repro_torch.distributed.compression import compressed_bytes_per_param
    for m in METHODS:
        assert compressed_bytes_per_param(m) == j(m)
    with pytest.raises(ValueError, match="unknown compression"):
        from repro_torch.distributed import compression, local_mesh
        compression.pod_allreduce_mean({}, "fp8", local_mesh("cpu"))
