"""The port's data pipeline and checkpoints (``repro_torch.data.pipeline``,
``repro_torch.checkpoint.manager``) against the JAX package on the CPU.

* ``SyntheticStream.batch_at``: bit for bit JAX's numpy arrays for
  gru-jet, gru-jet-deep, slstm-jet and the dense LM at 5 steps (the
  sLSTM's stream is JAX's jet stream of the same shapes: JAX keys its jet
  stream on the GRU family alone, the port on every cell family);
* ``Prefetcher``: JAX's order, depth and ``seek``; ``shard_batch``'s rank
  slices;
* JAX's ``test_checkpoint_ft.py`` cases (round trip and GC, async save,
  corruption, partial writes, the supervisor over injected failures) on
  the port's manager;
* one disk format: a train state written by the port restores in JAX's
  manager, and one written by JAX in the port's, leaf for leaf equal;
* the port's ``Supervisor`` training through the port's manager
  (``repro_torch.examples.elastic_training``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.configs.base import get_smoke_config as jsmoke
from repro.data.pipeline import Prefetcher as JPrefetcher
from repro.data.pipeline import SyntheticStream as JStream
from repro.train import trainer as jtrainer
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ShapeConfig, TrainConfig, get_smoke_config
from repro_torch.core.params import flatten, map_trees, state_from_numpy
from repro_torch.data.pipeline import Prefetcher, SyntheticStream, shard_batch
from repro_torch.distributed.fault_tolerance import (ElasticMeshManager,
                                                     Supervisor)
from repro_torch.distributed.mesh import Mesh
from repro_torch.train import trainer

STREAMS = (("gru-jet", 20, 16), ("gru-jet-deep", 20, 8),
           ("slstm-jet", 20, 8), ("qwen3-0.6b", 32, 8))


def _streams(arch, S, B, seed=0):
    from repro.data.pipeline import PipelineConfig as JP
    from repro_torch.data.pipeline import PipelineConfig
    jc = jsmoke(arch)
    if jc.family == "slstm":
        jc = jc.replace(family="gru")
    return (JStream(jc, JShape("t", S, B, "train"), JP(seed=seed)),
            SyntheticStream(get_smoke_config(arch), ShapeConfig(
                "t", S, B, "train"), PipelineConfig(seed=seed)))


@pytest.mark.parametrize("seed", (0, 7))
@pytest.mark.parametrize("arch,S,B", STREAMS)
def test_batch_at_is_jaxs_bit_for_bit(arch, S, B, seed):
    js, ts = _streams(arch, S, B, seed)
    for step in (0, 1, 2, 3, 10_001):
        jb, tb = js.batch_at(step), ts.batch_at(step)
        assert set(jb) == set(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and jb[k].shape == tb[k].shape
            assert np.array_equal(jb[k], tb[k]), (arch, step, k)
    keys = {"gru": {"features", "labels"}, "slstm": {"features", "labels"},
            "dense": {"tokens", "targets"}}
    assert set(tb) == keys[ts.cfg.family]


def test_jax_slstm_stream_is_the_lm_stream():
    """Why the port's sLSTM stream follows the GRU family's: JAX's own
    ``slstm-jet`` stream yields LM tokens, which its sLSTM loss cannot
    read."""
    jb = JStream(jsmoke("slstm-jet"), JShape("t", 20, 4, "train")).batch_at(0)
    assert set(jb) == {"tokens", "targets"}


def test_prefetcher_order_depth_and_seek():
    js, ts = _streams("gru-jet", 20, 4)
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    jp = JPrefetcher(js, {"features": one, "labels": one}, start_step=3,
                     depth=2)
    tp = Prefetcher(ts, None, start_step=3, depth=2, device="cpu")

    def same(jb, tb):
        assert set(jb) == set(tb)
        for k in jb:
            assert np.array_equal(np.asarray(jb[k]), tb[k].numpy())
    for _ in range(3):
        same(jp.next(), tp.next())
    assert jp.step == tp.step == 6
    assert sorted(tp._buf) == sorted(jp._buf) == [6]
    jp.seek(1)
    tp.seek(1)
    assert tp._buf == {} and tp.step == 1
    for s in (1, 2):
        tb = tp.next()
        same(jp.next(), tb)
        same(ts.batch_at(s), tb)


def test_shard_batch_takes_the_ranks_rows():
    b = SyntheticStream(get_smoke_config("gru-jet"), ShapeConfig(
        "t", 20, 8, "train")).batch_at(0)
    whole = shard_batch(b, device="cpu")
    assert all(torch.equal(whole[k], torch.from_numpy(b[k])) for k in b)
    for rank in (0, 1):
        mesh = Mesh(group=object(), size=2, rank=rank, device="cpu")
        part = shard_batch(b, mesh)
        for k in b:
            assert torch.equal(part[k], torch.from_numpy(
                b[k][rank * 4:(rank + 1) * 4]))
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"x": np.zeros((3, 2))},
                    Mesh(group=object(), size=2, rank=0, device="cpu"))


# ---------------------------------------------------------------------------
# JAX's checkpoint cases on the port's manager
# ---------------------------------------------------------------------------

def _state(val=0.0):
    return {"params": {"w": torch.full((4, 4), val), "b": torch.zeros(4)},
            "step": torch.tensor(0, dtype=torch.int32)}


def test_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in [10, 20, 30]:
        mgr.save(_state(float(s)), s)
    assert mgr.all_steps() == [20, 30]          # keep-last-2
    restored = mgr.restore(_state(), step=30)
    np.testing.assert_allclose(restored["params"]["w"].numpy(), 30.0)
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000020", "step_00000020.COMMITTED", "step_00000030",
        "step_00000030.COMMITTED"]


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save_async(_state(1.0), 1)
    mgr.save_async(_state(2.0), 2)
    mgr.wait()
    assert mgr.latest_step() == 2
    st = _state(3.0)
    mgr.save_async(st, 3)
    st["params"]["w"].add_(100.0)        # the snapshot was taken at the call
    mgr.wait()
    assert float(mgr.restore(_state(), step=3)["params"]["w"][0, 0]) == 3.0


def test_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(_state(5.0), 5)
    d = os.path.join(str(tmp_path), "step_00000005")
    fn = max((f for f in os.listdir(d) if f.endswith(".npy")),
             key=lambda f: os.path.getsize(os.path.join(d, f)))
    path = os.path.join(d, fn)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size - 4)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(IOError, match="checksum"):
        mgr.restore(_state(), step=5)


def test_partial_write_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(_state(1.0), 1)
    os.makedirs(os.path.join(str(tmp_path), "step_00000002"))
    assert mgr.latest_step() == 1


def test_supervisor_survives_injected_failures(tmp_path):
    """JAX's case on the port: train, crash at steps 7 and 13, shrink the
    mesh, restore from the port's checkpoints, finish with the loss still
    falling."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mesh_mgr = ElasticMeshManager(total_devices=8, model_parallel=2)
    trace = {"builds": []}

    def build(mesh_shape):
        trace["builds"].append(mesh_shape)

        def step_fn(state, step):
            w = state["params"]["w"]
            w2 = w - 0.1 * (2 * (w - 3.0))
            return ({"params": {"w": w2}, "step": state["step"] + 1},
                    {"loss": float((w2 - 3.0) ** 2)})

        state = {"params": {"w": torch.tensor(0.0)},
                 "step": torch.tensor(0)}

        def restore_fn(like):
            step = mgr.latest_step() or 0
            return (mgr.restore(like, step=step) if step else like), step
        return step_fn, state, mgr.save, restore_fn

    sup = Supervisor(mesh_mgr, build, checkpoint_every=5)
    state, step, history = sup.run(20, inject={7: [0], 13: [1]})
    assert step == 20 and int(state["step"]) == 20
    assert sup.restarts == 2
    assert len(trace["builds"]) == 3
    assert trace["builds"][-1] == (3, 2)
    assert history[-1][1]["loss"] < history[0][1]["loss"]


# ---------------------------------------------------------------------------
# one disk format across the two packages
# ---------------------------------------------------------------------------

def _jax_state(arch, **kw):
    return jtrainer.init_state(jsmoke(arch), JTrain(), seed=2, **kw)


def _noisy(tree, seed):
    """``tree`` as numpy with every float leaf replaced by seeded noise
    (so a restore that read the wrong leaf could not pass)."""
    rng = np.random.default_rng(seed)

    def f(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return rng.normal(size=x.shape).astype(x.dtype)
        return x + 7
    return jax.tree.map(f, tree)


@pytest.mark.parametrize("arch,kw", [
    ("gru-jet-deep", {}), ("slstm-jet", {}),
    ("qwen3-0.6b", {"with_ef": True, "n_pods": 2})])
def test_port_checkpoint_restores_in_jax(tmp_path, arch, kw):
    like = _jax_state(arch, **kw)
    values = _noisy(like, 1)
    st = state_from_numpy(values, device="cpu")
    CheckpointManager(str(tmp_path)).save(st, 17)
    got = JManager(str(tmp_path)).restore(like)
    leaves_got = jax.tree_util.tree_leaves_with_path(got)
    leaves_want = jax.tree_util.tree_leaves_with_path(values)
    assert len(leaves_got) == len(leaves_want)
    for (pa, a), (pb, b) in zip(leaves_got, leaves_want):
        assert pa == pb
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b)), pa


@pytest.mark.parametrize("arch,kw", [
    ("gru-jet", {}), ("gru-jet-deep", {}),
    ("qwen3-0.6b", {"with_ef": True, "n_pods": 2})])
def test_jax_checkpoint_restores_in_the_port(tmp_path, arch, kw):
    values = _noisy(_jax_state(arch, **kw), 2)
    JManager(str(tmp_path)).save(jax.tree.map(jnp.asarray, values), 23)
    tkw = dict(kw)
    like = trainer.init_state(get_smoke_config(arch), TrainConfig(),
                              device="cpu", **tkw)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 23
    got = mgr.restore(like)
    fg, fw = flatten(got), flatten(state_from_numpy(values, device="cpu"))
    assert list(fg) == list(fw)
    for k in fg:
        assert fg[k].dtype == fw[k].dtype
        assert torch.equal(fg[k].detach(), fw[k].detach()), k
    assert all(p.requires_grad for p in flatten(got["params"]).values())
    assert int(got["step"]) == int(values["step"])


def test_resumed_training_equals_the_run_that_never_stopped(tmp_path):
    """A restore replays the exact stream: 6 steps, a checkpoint, 4 more
    from disk equal 10 in memory, bit for bit."""
    cfg = get_smoke_config("gru-jet")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=10)
    stream = SyntheticStream(cfg, ShapeConfig("t", 20, 8, "train"))
    step = trainer.make_train_step(cfg, tcfg)
    st = trainer.init_state(cfg, tcfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    for s in range(10):
        st, _ = step(st, shard_batch(stream.batch_at(s), device="cpu"))
        if s == 5:
            mgr.save(st, 6)
    re_st = mgr.restore(trainer.init_state(cfg, tcfg, seed=9, device="cpu"))
    for s in range(int(re_st["step"]), 10):
        re_st, _ = step(re_st, shard_batch(stream.batch_at(s), device="cpu"))
    for k, v in flatten(st).items():
        assert torch.equal(v.detach(), flatten(re_st)[k].detach()), k


def test_elastic_training_example_through_the_ports_manager():
    from repro_torch.examples import elastic_training
    step, restarts, losses = elastic_training.main(["--device", "cpu"])
    assert step == 40 and restarts == 2 and losses[-1] < losses[0]


def test_restore_places_leaves_on_the_like_states_device(tmp_path):
    st = map_trees(lambda x: x, _state(2.0))
    CheckpointManager(str(tmp_path)).save(st, 1)
    like = _state()
    like["params"]["w"].requires_grad_(True)
    got = CheckpointManager(str(tmp_path)).restore(like, device="cpu")
    assert got["params"]["w"].requires_grad
    assert not got["params"]["b"].requires_grad
    assert got["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# shapes, spec arithmetic and input batches against the JAX package
# ---------------------------------------------------------------------------

def test_shapes_and_skip_rule_are_jaxs():
    from repro.configs import shapes as jshapes
    from repro.configs.base import get_config as jget
    from repro_torch.configs import shapes
    from repro_torch.configs.base import ALL_ARCHS, get_config
    for table, jtable in ((shapes.SHAPES, jshapes.SHAPES),
                          (shapes.GRU_SHAPES, jshapes.GRU_SHAPES)):
        assert list(table) == list(jtable)
        for k in table:
            assert (table[k].name, table[k].seq_len, table[k].global_batch,
                    table[k].kind) == (jtable[k].name, jtable[k].seq_len,
                                       jtable[k].global_batch, jtable[k].kind)
    for arch in ALL_ARCHS:
        cfg, jcfg = get_config(arch), jget(arch)
        assert cfg.supports_long_context == jcfg.supports_long_context
        assert cfg.is_recurrent == jcfg.is_recurrent
        for sh in list(shapes.SHAPES.values()) + list(
                shapes.GRU_SHAPES.values()):
            j = jshapes.SHAPES.get(sh.name) or jshapes.GRU_SHAPES[sh.name]
            assert shapes.shape_skip_reason(cfg, sh) == \
                jshapes.shape_skip_reason(jcfg, j)


def test_train_config_is_jaxs_field_for_field():
    import dataclasses
    from repro.configs.base import ShapeConfig as JS
    assert [(f.name, f.default) for f in dataclasses.fields(TrainConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(JTrain)]
    assert [f.name for f in dataclasses.fields(ShapeConfig)] == \
        [f.name for f in dataclasses.fields(JS)]


@pytest.mark.parametrize("arch", ("gru-jet", "gru-jet-deep", "slstm-jet",
                                  "qwen3-0.6b"))
def test_param_counts_bytes_and_abstract_params_are_jaxs(arch):
    from repro.core import params as jp
    from repro.models import api as japi
    from repro_torch.core import params as tp
    from repro_torch.models import api as mapi
    jc, tc = jsmoke(arch), get_smoke_config(arch)
    js, ts = japi.get_api(jc).specs(jc), mapi.get_api(tc).specs(tc)
    assert tp.param_count(ts) == jp.param_count(js)
    for dt in ("float32", "bfloat16"):
        assert tp.param_bytes(ts, dt) == jp.param_bytes(js, dt)
    ab, jab = tp.abstract_params(ts, "bfloat16"), jp.abstract_params(
        js, "bfloat16")
    fa = flatten(ab)
    fj = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                   for p in path): leaf
          for path, leaf in jax.tree_util.tree_flatten_with_path(jab)[0]}
    assert list(fa) == list(fj)
    for k in fa:
        assert fa[k].device.type == "meta"
        assert tuple(fa[k].shape) == tuple(fj[k].shape), k
        assert str(fa[k].dtype).replace("torch.", "") == str(fj[k].dtype)
    st = trainer.init_state(tc, TrainConfig(), device="cpu")
    cast = tp.cast_tree(st, "bfloat16")
    for k, v in flatten(cast).items():
        want = torch.bfloat16 if flatten(st)[k].is_floating_point() else \
            flatten(st)[k].dtype
        assert v.dtype == want, k


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch", ("gru-jet", "slstm-jet", "qwen3-0.6b"))
def test_input_specs_and_concrete_batches_are_jaxs(arch, kind):
    from repro.models import api as japi
    from repro_torch.models import api as mapi
    jc, tc = jsmoke(arch), get_smoke_config(arch)
    jspec = japi.input_specs(jc, JShape("x", 8, 4, kind))
    spec = mapi.input_specs(tc, ShapeConfig("x", 8, 4, kind))
    assert set(spec) == set(jspec)
    for k in spec:
        assert tuple(spec[k].shape) == tuple(jspec[k].shape)
        assert spec[k].dtype == jspec[k].dtype
    jb = japi.concrete_batch(jc, JShape("x", 8, 4, kind), seed=3)
    tb = mapi.concrete_batch(tc, ShapeConfig("x", 8, 4, kind), seed=3,
                             device="cpu")
    for k in jb:
        a = np.asarray(jb[k].astype(jnp.float32)
                       if jb[k].dtype == jnp.bfloat16 else jb[k])
        b = tb[k].float().numpy() if tb[k].is_floating_point() else \
            tb[k].numpy()
        assert a.shape == b.shape and np.array_equal(a.astype(b.dtype), b)
