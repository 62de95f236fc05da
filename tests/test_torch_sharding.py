"""The port's sharding rules, its named multi-axis mesh and the GPipe
pipeline (``repro_torch.core.params`` axes, ``repro_torch.distributed``:
``sharding``, ``mesh``, ``pipeline``) against the JAX package, on the CPU.

* (a) for all 13 archs, SMOKE and full: every Spec tree's logical axes
  (params, ``input_specs`` of the three kinds, ``cache_specs``,
  ``trainer.state_specs`` with error-feedback leaves) equal JAX's leaf for
  leaf, and ``param_pspecs`` of each equals JAX's under every profile, on
  the meshes {data 16, model 16}, {pod 2, data 16, model 16}, {data 2,
  model 2} and {model 4}, with ``manual`` () and ("pod",), on stand-in
  meshes (shapes only, no processes, as JAX's ``_FakeMesh``); JAX's four
  rule tests, ported;
* (b) on 4 gloo ranks of CPU processes (one spawn for the file): every
  collective on each axis of a 2x2 mesh and of a 3-axis mesh against
  numpy, ``all_to_all``'s chunk order and 16-bit transport included, the
  ranks' coordinates row-major as ``jax.make_mesh`` lays out devices;
  ``param_shardings`` cuts each rank's blocks as JAX's in-specs do;
* (f) ``pipeline_apply`` over the 4-rank ``pod`` mesh within 1e-5 of
  JAX's ``pipeline_apply`` on 4 host devices (a subprocess) and of both
  packages' ``sequential_reference``, at JAX's test shapes (4 stages of
  16, 8 microbatches of 4) and at d = 64.
"""
import functools
import pickle

import jax
import numpy as np
import pytest
import torch

from _torch_parity import close, run_ranks
from repro.configs import base as jbase
from repro.core.params import is_spec as j_is_spec
from repro.distributed import sharding as jsh
from repro.models import api as japi
from repro.train import trainer as jtrainer
from repro_torch.configs import base as tbase
from repro_torch.core.params import Spec, flatten, logical_axes
from repro_torch.distributed import sharding as tsh
from repro_torch.models import api as tapi
from repro_torch.train import trainer as ttrainer

ARCHS = tuple(jbase.ASSIGNED_ARCHS)
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 2}, {"model": 4})
MANUAL = ((), ("pod",))
KINDS = ("train", "prefill", "decode")


class _FakeMesh:
    """Axis names and sizes only (JAX's ``_FakeMesh``)."""

    def __init__(self, shape):
        self._shape = dict(shape)

    @property
    def axis_names(self):
        return tuple(self._shape)

    @property
    def shape(self):
        return self._shape


def _ctx(mod, profile="default", manual=(), **mesh_shape):
    ctx = mod.ShardCtx.__new__(mod.ShardCtx)
    object.__setattr__(ctx, "mesh", _FakeMesh(mesh_shape or
                                              {"data": 16, "model": 16}))
    object.__setattr__(ctx, "profile", profile)
    object.__setattr__(ctx, "manual", manual)
    return ctx


def _jax_flat(tree):
    """{path: Spec} of a JAX Spec tree, paths as the port's ``flatten``."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=j_is_spec)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)] = leaf
    return out


def _at(tree, path: str):
    for k in path.split("/") if path else ():
        tree = tree[k] if isinstance(tree, dict) else tree[int(k)]
    return tree


def _trees(arch, smoke):
    """(name, JAX Spec tree, port Spec tree) of every tree the rules
    read: params, the inputs of each kind, the cache, the train state."""
    getc = "get_smoke_config" if smoke else "get_config"
    jc, tc = getattr(jbase, getc)(arch), getattr(tbase, getc)(arch)
    ja, ta = japi.get_api(jc), tapi.get_api(tc)
    out = [("params", ja.specs(jc), ta.specs(tc))]
    for kind in KINDS:
        out.append((f"inputs/{kind}",
                    japi.input_specs(jc, jbase.ShapeConfig(kind, 32, 8, kind)),
                    tapi.input_specs(tc, tbase.ShapeConfig(kind, 32, 8,
                                                           kind))))
    cell = jc.family in ("gru", "slstm")
    out.append(("cache", ja.cache_specs(jc, 8) if cell
                else ja.cache_specs(jc, 8, 64),
                ta.cache_specs(tc, 8) if cell else ta.cache_specs(tc, 8, 64)))
    out.append(("state", jtrainer.state_specs(jc, jbase.TrainConfig(),
                                              with_ef=True, n_pods=2),
                ttrainer.state_specs(tc, tbase.TrainConfig(), with_ef=True,
                                     n_pods=2)))
    return out


@functools.lru_cache(maxsize=None)
def _all_trees(arch):
    return [(smoke, name, _jax_flat(j), t, flatten(t))
            for smoke in (True, False) for name, j, t in _trees(arch, smoke)]


# ---------------------------------------------------------------------------
# (a) the rules against JAX's
# ---------------------------------------------------------------------------

def test_param_axes_are_jaxs():
    from repro.core.params import PARAM_AXES as J
    from repro_torch.core.params import PARAM_AXES as T
    assert T == J


def test_spec_checks_its_axes():
    with pytest.raises(ValueError, match="unknown logical axis"):
        Spec((4,), ("nope",))
    with pytest.raises(ValueError, match="rank"):
        Spec((4, 4), ("embed",))


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_are_jaxs(arch):
    """Every leaf of every tree: the same path, shape and logical axes, and
    ``logical_axes`` gives them."""
    for smoke, name, jflat, ttree, tflat in _all_trees(arch):
        assert list(tflat) == list(jflat), (arch, smoke, name)
        laxes = logical_axes(ttree)
        for path, js in jflat.items():
            ts = tflat[path]
            what = (arch, smoke, name, path)
            assert tuple(ts.shape) == tuple(js.shape), what
            assert tuple(ts.axes) == tuple(js.axes), what
            assert _at(laxes, path) == tuple(js.axes), what


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_are_jaxs(arch):
    """``param_pspecs`` leaf for leaf under every profile, mesh and manual
    set: each entry equal to JAX's ``PartitionSpec``'s."""
    n = 0
    for smoke, name, jflat, ttree, tflat in _all_trees(arch):
        jtree = {k: v for k, v in jflat.items()}
        for mesh in MESHES:
            for profile in jsh.PROFILES:
                for manual in MANUAL:
                    jctx = _ctx(jsh, profile, manual, **mesh)
                    tctx = _ctx(tsh, profile, manual, **mesh)
                    jps = jsh.param_pspecs(jtree, jctx)
                    tps = tsh.param_pspecs(ttree, tctx)
                    for path in jflat:
                        want = tuple(jps[path])
                        got = _at(tps, path)
                        assert isinstance(got, tsh.P)
                        assert tuple(got) == want, (arch, smoke, name, path,
                                                    mesh, profile, manual)
                        n += 1
    assert n > 0


def test_profiles_are_jaxs():
    assert list(tsh.PROFILES) == list(jsh.PROFILES)
    for k in jsh.PROFILES:
        assert tsh.PROFILES[k] == jsh.PROFILES[k], k


# JAX's four rule tests (tests/test_sharding_dist.py), on the port's rules

def test_divisibility_drop():
    ctx = _ctx(tsh)
    # kv_heads=8 cannot divide model=16 -> dropped; capacity picks model
    ps = tsh.resolve_pspec(("batch", "kv_heads", "act_kv_seq", None),
                           (128, 8, 32768, 128), ctx)
    assert ps[0] == ("data",) or ps[0] == "data"
    assert ps[1] is None
    assert ps[2] == "model"


def test_dedup_mesh_axes():
    ctx = _ctx(tsh)
    # both logical axes map to model; only the first wins
    ps = tsh.resolve_pspec(("heads", "mlp"), (32, 3200), ctx)
    assert ps[0] == "model" and (len(ps) < 2 or ps[1] is None)


def test_profiles_differ():
    d = dict(tsh.PROFILES["default"])
    sp = dict(tsh.PROFILES["sp"])
    ca = dict(tsh.PROFILES["cascade"])
    assert d["act_seq"] == () and sp["act_seq"] == ("model",)
    assert d["gates"] == ("model",) and ca["gates"] == ()
    assert ca["hidden"] == ("model",)


def test_multipod_batch_axes():
    ctx = _ctx(tsh, pod=2, data=16, model=16)
    ps = tsh.resolve_pspec(("batch", "act_seq"), (256, 4096), ctx)
    assert ps[0] == ("pod", "data")


@pytest.mark.parametrize("profile", tuple(jsh.PROFILES))
def test_resolve_pspec_matches_jax_on_every_logical_axis(profile):
    """Each logical axis alone and in pairs, on dims that every mesh axis
    divides and on dims none does."""
    from repro.core.params import PARAM_AXES
    for mesh in MESHES:
        for manual in MANUAL:
            jctx = _ctx(jsh, profile, manual, **mesh)
            tctx = _ctx(tsh, profile, manual, **mesh)
            for a in PARAM_AXES + (None,):
                for b in PARAM_AXES[::5] + (None,):
                    for shape in ((256, 512), (7, 512), (256, 9)):
                        want = jsh.resolve_pspec((a, b), shape, jctx)
                        got = tsh.resolve_pspec((a, b), shape, tctx)
                        assert tuple(got) == tuple(want), (a, b, shape, mesh)


def test_no_mesh_resolves_to_the_empty_spec():
    assert tsh.resolve_pspec(("batch", "embed"), (8, 8),
                             tsh.NO_SHARD) == tsh.P()
    assert tsh.NO_SHARD.axis_size("model") == 1
    x = torch.randn(3, 4)
    assert tsh.constrain(x, ("batch", None), _ctx(tsh)) is x


# ---------------------------------------------------------------------------
# (b) the named mesh and its collectives on 4 gloo ranks; (f) the pipeline
# ---------------------------------------------------------------------------

N = 4
STAGE_SHAPES = ((16, 8, 4), (64, 8, 4))       # (d, microbatches, mb)


def _rank_input(r, shape=(4, 6), seed=0, dtype=np.float32):
    return np.random.default_rng(seed * 100 + r).normal(
        size=shape).astype(dtype)


def _pipeline_inputs(d, M, mb):
    rng = np.random.default_rng(d)
    return {"w": (rng.normal(size=(N, d, d)) * 0.5).astype(np.float32),
            "b": rng.normal(size=(N, d)).astype(np.float32) * 0.1,
            "xs": rng.normal(size=(M, mb, d)).astype(np.float32)}


RANK_BODY = r"""
import pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.distributed import init_mesh, named_mesh
from repro_torch.distributed import pipeline as pp
from repro_torch.distributed import sharding as sh

n, rank, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
init_mesh(n, rank, init_file=store, device="cpu", backend="gloo",
          timeout_s=60)
inp = pickle.load(open(work + "/inputs.pkl", "rb"))
out = {}

def rank_input(seed, shape=(4, 6), dtype=torch.float32):
    x = np.random.default_rng(seed * 100 + rank).normal(size=shape)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)

for label, axes in (("2x2", {"data": 2, "model": 2}),
                    ("3ax", {"pod": 2, "data": 1, "model": 2})):
    mesh = named_mesh(axes, device="cpu")
    r = {"names": mesh.axis_names, "shape": dict(mesh.shape),
         "coords": {a: mesh.axis_index(a) for a in mesh.axis_names}}
    for a in mesh.axis_names:
        x = rank_input(1)
        n_a = mesh.shape[a]
        c = {"gather0": mesh.all_gather(x, 0, a),
             "gather1": mesh.all_gather(x, 1, a),
             "psum": mesh.psum(x, a), "pmax": mesh.pmax(x, a),
             "psum_bf16": mesh.psum(x.to(torch.bfloat16), a),
             "gather_bf16": mesh.all_gather(x.to(torch.bfloat16), 1, a),
             "shift": mesh.ppermute(x, [(i, (i + 1) % n_a)
                                        for i in range(n_a)], a),
             "partial": mesh.ppermute(x, [(0, n_a - 1)], a),
             "kept": x.clone()}
        if 4 % n_a == 0:
            y = rank_input(2, shape=(4, 2 * n_a, 3))
            c["a2a_01"] = mesh.all_to_all(y, 0, 1, a)
            c["a2a_10"] = mesh.all_to_all(y, 1, 0, a)
            c["a2a_bf16"] = mesh.all_to_all(y.to(torch.bfloat16), 0, 1, a)
            c["a2a_in"] = y
        r[a] = c
    # param_shardings: this rank's block of an expert tree
    ctx = sh.ShardCtx(mesh)
    from repro_torch.core.params import Spec
    specs = {"wg": Spec((16, 8, 6), ("experts", "embed", "expert_mlp")),
             "wd": Spec((16, 6, 8), ("experts", "expert_mlp", "embed")),
             "norm": Spec((8,), ("embed",))}
    whole = {k: torch.arange(np.prod(s.shape), dtype=torch.float32).reshape(
        s.shape) for k, s in specs.items()}
    r["blocks"] = sh.param_shardings(specs, ctx, whole)
    r["pspecs"] = {k: tuple(v) for k, v in
                   sh.param_pspecs(specs, ctx).items()}
    out[label] = r

# (f) the pipeline over a 4-rank pod mesh, each rank its stage's params
pod = named_mesh({"pod": 4}, device="cpu")
def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])
out["pipeline"] = {}
for key, a in inp["pipeline"].items():
    whole = {k: torch.from_numpy(a[k]) for k in ("w", "b")}
    mine = {k: v[pod.axis_index("pod")] for k, v in whole.items()}
    xs = torch.from_numpy(a["xs"])
    out["pipeline"][key] = {"pp": pp.pipeline_apply(stage_fn, mine, xs,
                                                    mesh=pod, axis="pod"),
                            "seq": pp.sequential_reference(stage_fn, whole,
                                                           xs)}
pickle.dump(out, open(f"{work}/rank{rank}.pkl", "wb"))
dist.destroy_process_group()
"""

JAX_PIPELINE = """
import numpy as np, jax, jax.numpy as jnp, pickle
from repro.distributed import pipeline as pp
inp = pickle.load(open({path!r}, "rb"))
def stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])
mesh = jax.make_mesh((4,), ("pod",))
out = {{}}
for key, a in inp.items():
    sp = {{"w": jnp.asarray(a["w"]), "b": jnp.asarray(a["b"])}}
    xs = jnp.asarray(a["xs"])
    out[key] = (np.asarray(pp.pipeline_apply(stage_fn, sp, xs, mesh=mesh,
                                             axis="pod")),
                np.asarray(pp.sequential_reference(stage_fn, sp, xs)))
pickle.dump(out, open({out!r}, "wb"))
print("PASS")
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh4")
    pipe = {f"d{d}": _pipeline_inputs(d, M, mb) for d, M, mb in STAGE_SHAPES}
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"pipeline": pipe}, f)
    run_ranks(RANK_BODY, N, work, timeout=240)
    return [pickle.load(open(work / f"rank{r}.pkl", "rb")) for r in range(N)]


@pytest.fixture(scope="module")
def jax_pipeline(tmp_path_factory, multidev):
    work = tmp_path_factory.mktemp("jaxpp")
    pipe = {f"d{d}": _pipeline_inputs(d, M, mb) for d, M, mb in STAGE_SHAPES}
    with open(work / "in.pkl", "wb") as f:
        pickle.dump(pipe, f)
    multidev(JAX_PIPELINE.format(path=str(work / "in.pkl"),
                                 out=str(work / "out.pkl")), n_devices=4)
    return pipe, pickle.load(open(work / "out.pkl", "rb"))


MESH_AXES = {"2x2": {"data": 2, "model": 2},
             "3ax": {"pod": 2, "data": 1, "model": 2}}


def _group(label, axis, r):
    """The ranks of r's group on ``axis`` (row-major coordinates), in axis
    order: as ``jax.make_mesh`` lays the devices out."""
    shape = MESH_AXES[label]
    dims = tuple(shape.values())
    grid = np.arange(N).reshape(dims)
    coord = list(np.unravel_index(r, dims))
    i = list(shape).index(axis)
    idx = tuple(slice(None) if j == i else coord[j] for j in range(len(dims)))
    return [int(x) for x in grid[idx]]


@pytest.mark.parametrize("label", tuple(MESH_AXES))
def test_rank_layout_is_row_major(ranks, label):
    """Rank r sits at ``np.unravel_index(r, dims)``: the last axis varies
    fastest, as ``jax.make_mesh`` lays out ``jax.devices()``."""
    dims = tuple(MESH_AXES[label].values())
    for r, out in enumerate(ranks):
        o = out[label]
        assert o["names"] == tuple(MESH_AXES[label])
        assert o["shape"] == MESH_AXES[label]
        coord = np.unravel_index(r, dims)
        assert tuple(o["coords"].values()) == tuple(int(c) for c in coord)


@pytest.mark.parametrize("label,axis", [(k, a) for k, v in MESH_AXES.items()
                                        for a in v])
def test_collectives_match_numpy(ranks, label, axis):
    for r, out in enumerate(ranks):
        c = out[label][axis]
        grp = _group(label, axis, r)
        xs = [_rank_input(g, seed=1) for g in grp]
        me = grp.index(r)
        n = len(grp)
        np.testing.assert_array_equal(c["gather0"].numpy(),
                                      np.concatenate(xs, 0))
        np.testing.assert_array_equal(c["gather1"].numpy(),
                                      np.concatenate(xs, 1))
        close(c["psum"], np.sum(xs, 0), 1e-6)
        np.testing.assert_array_equal(c["pmax"].numpy(), np.max(xs, 0))
        np.testing.assert_array_equal(c["kept"].numpy(), xs[me])
        # 16-bit: moved as its bits; summed in float32, rounded once
        bf = [torch.from_numpy(x).to(torch.bfloat16) for x in xs]
        assert c["gather_bf16"].dtype == torch.bfloat16
        assert torch.equal(c["gather_bf16"], torch.cat(bf, 1))
        want = torch.stack([b.float() for b in bf]).sum(0).to(torch.bfloat16)
        assert c["psum_bf16"].dtype == torch.bfloat16
        if n <= 2:       # one add: any order gives these bits
            assert torch.equal(c["psum_bf16"], want)
        np.testing.assert_array_equal(c["shift"].numpy(), xs[(me - 1) % n])
        want = xs[0] if me == n - 1 else np.zeros_like(xs[me])
        np.testing.assert_array_equal(c["partial"].numpy(), want)
        if "a2a_01" in c:
            ys = [_rank_input(g, shape=(4, 2 * n, 3), seed=2) for g in grp]
            np.testing.assert_array_equal(c["a2a_in"].numpy(), ys[me])
            # JAX's tiled all_to_all: chunk j of every sender to rank j,
            # the received chunks concatenated in the senders' order
            want01 = np.concatenate([np.split(y, n, 0)[me] for y in ys], 1)
            want10 = np.concatenate([np.split(y, n, 1)[me] for y in ys], 0)
            np.testing.assert_array_equal(c["a2a_01"].numpy(), want01)
            np.testing.assert_array_equal(c["a2a_10"].numpy(), want10)
            assert torch.equal(c["a2a_bf16"], torch.from_numpy(want01).to(
                torch.bfloat16))


@pytest.mark.parametrize("label", tuple(MESH_AXES))
def test_param_shardings_cut_jaxs_blocks(ranks, label):
    """Each rank's block of each leaf is the block JAX's NamedSharding
    puts on the device at its coordinates."""
    shape = MESH_AXES[label]
    dims = tuple(shape.values())
    jctx = _ctx(jsh, **shape)
    for r, out in enumerate(ranks):
        o = out[label]
        coord = dict(zip(shape, np.unravel_index(r, dims)))
        specs = {"wg": ((16, 8, 6), ("experts", "embed", "expert_mlp")),
                 "wd": ((16, 6, 8), ("experts", "expert_mlp", "embed")),
                 "norm": ((8,), ("embed",))}
        for k, (shp, axes) in specs.items():
            ps = jsh.resolve_pspec(axes, shp, jctx)
            assert o["pspecs"][k] == tuple(ps)
            whole = np.arange(np.prod(shp), dtype=np.float32).reshape(shp)
            idx = []
            for d, entry in enumerate(tuple(ps) + (None,) * len(shp)):
                if d >= len(shp):
                    break
                names = (() if entry is None else
                         entry if isinstance(entry, tuple) else (entry,))
                blk, nb = 0, 1
                for a in names:
                    blk, nb = blk * shape[a] + int(coord[a]), nb * shape[a]
                size = shp[d] // nb
                idx.append(slice(blk * size, (blk + 1) * size))
            np.testing.assert_array_equal(o["blocks"][k].numpy(),
                                          whole[tuple(idx)])


@pytest.mark.parametrize("key", [f"d{d}" for d, _, _ in STAGE_SHAPES])
def test_pipeline_matches_jax(ranks, jax_pipeline, key):
    pipe, jout = jax_pipeline
    jpp, jseq = jout[key]
    for r, out in enumerate(ranks):
        got = out["pipeline"][key]
        close(got["pp"], jpp, 1e-5)
        close(got["pp"], jseq, 1e-5)
        close(got["seq"], jseq, 1e-5)
        close(got["pp"], got["seq"].numpy(), 1e-5)
        # the last stage's outputs, replicated: every rank the same bits
        assert torch.equal(got["pp"], ranks[0]["pipeline"][key]["pp"])


def test_one_axis_mesh_keeps_its_face():
    """``local_mesh``'s one axis: names, shape, index and identity
    collectives, as before the named meshes."""
    from repro_torch.distributed import local_mesh
    m = local_mesh("cpu")
    assert m.axis_names == ("model",) and m.shape == {"model": 1}
    assert m.axis_index("model") == 0 and m.sub("model") is m
    x = torch.randn(2, 4)
    assert m.all_gather(x, 0) is x and m.psum(x) is x
    assert m.all_to_all(x, 1, 0) is x
    assert torch.equal(m.ppermute(x, [(0, 0)]), x)
    assert torch.equal(m.ppermute(x, []), torch.zeros_like(x))
    with pytest.raises(KeyError):
        m.sub("data")
