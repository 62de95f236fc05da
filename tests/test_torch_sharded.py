"""The port's mesh path on the CPU: the row-wise/cascade split across the
ranks of a gloo process group (``sharded``, ``cuda_sharded``,
``sharded_decode``), against the JAX package.

* (a) the seven shard kernels' plain versions against JAX's Pallas shard
  kernels in interpret mode, at gru-jet's (H=20) and gru-jet-deep's
  (H=32) shard widths over 1, 2 and 4 ranks, within 1e-6; the wrappers
  run them on CPU tensors and launch nothing;
* (b) the port's ``sharded`` and ``cuda_sharded`` on gloo meshes of 1, 2
  and 4 CPU ranks (each world size spawned once, every case inside; the
  v3 cases' cascade layers run the in-place gates epilogue): finals,
  ``return_all`` states, masked prefill and decode steps within 1e-5 of
  JAX's single-device ``xla`` backend (the cases of
  ``test_pallas_sharded.py``, gru-jet-deep v1 and v3, gru-jet);
* (c) inside the port, bit for bit: ``cuda_sharded`` equals ``sharded``,
  ``sharded_decode`` equals ``cuda_sharded``'s decode, masked bucketed
  prefill equals the unpadded prompt, and every rank holds the same
  results;
* (d) placement: ``StackParams.placed`` holds only this rank's slices,
  and an execute call with the full cells poisoned (NaN) gives the same
  bits, so it never reads them;
* (e) dispatch: the backends JAX picks under the name map, on a one-rank
  mesh and without one, across preference x hetero x mask x family (the
  sLSTM has no mesh backend and falls through), and on the n-rank meshes;
* (f) a served wave on the 1-, 2- and 4-rank meshes pinned to
  ``cuda_sharded``: every prefill and step attributed to it, streams equal
  on every rank and to the replicated ``eager`` engine's;
* (g) one case on 2 ranks against JAX's own ``sharded`` backend on 2 host
  devices (``run_multidev``), within 1e-5.

Tolerances: 1e-6 for the plain shard kernels against their Pallas bodies
(the same expressions, one product each), 1e-5 across frameworks
(summation order and libm over a whole stack).
"""
import functools
import itertools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, numpy_params, run_ranks, to_jax, to_torch
from repro.configs.base import GRUConfig as JCfg
from repro.configs.base import get_config as jax_get_config
from repro.core import cells as jcells
from repro.core import gru as jgru
from repro.core import runtime as jruntime
from repro.kernels.gru_sequence import kernel as JK
from repro_torch.configs.base import GRUConfig as TCfg
from repro_torch.core import runtime
from repro_torch.distributed import local_mesh
from repro_torch.kernels.gru_sequence import kernel as K
from repro_torch.kernels.gru_sequence import ref

B, T, P = 2, 7, 3
SHARD_TOL = 1e-6
# name -> (GRUConfig fields of both packages)
CASES = {
    "rc-v1": dict(input_dim=6, layer_dims=(16, 16),
                  layer_matvec_modes=("rowwise", "cascade"), variant="v1"),
    "cr-hetero": dict(input_dim=6, layer_dims=(16, 8),
                      layer_matvec_modes=("cascade", "rowwise"),
                      variant="v1"),
    "rc-v3": dict(input_dim=6, layer_dims=(16, 16),
                  layer_matvec_modes=("rowwise", "cascade"), variant="v3"),
    "r-depth1": dict(input_dim=6, layer_dims=(16,),
                     layer_matvec_modes=("rowwise",), variant="v1"),
    "gru-jet-deep": dict(input_dim=5, layer_dims=(32, 32, 32),
                         layer_matvec_modes=("rowwise", "cascade",
                                             "rowwise"), variant="v1"),
    "gru-jet-deep-v3": dict(input_dim=5, layer_dims=(32, 32, 32),
                            layer_matvec_modes=("rowwise", "cascade",
                                                "rowwise"), variant="v3"),
    "gru-jet": dict(input_dim=5, layer_dims=(20,),
                    layer_matvec_modes=("rowwise",), variant="v1"),
}
WORLDS = (1, 2, 4)
# JAX backend name -> the port's
PORT_NAME = {"xla": "eager", "pallas_fused": "cuda_fused",
             "pallas_chain": "cuda_chain", "sharded": "sharded",
             "pallas_sharded": "cuda_sharded",
             "sharded_decode": "sharded_decode"}
SHARD_NAMES = tuple(k.__name__ for k in K.SHARD_KERNELS)


def test_config_fields_match_the_served_configs():
    """The gru-jet cases are the served configs' stacks."""
    for name in ("gru-jet-deep", "gru-jet"):
        g = jax_get_config(name).gru
        c = CASES[name]
        assert g.resolved_layer_dims == c["layer_dims"]
        assert tuple(g.layer_matvec_mode(l) for l in range(len(
            c["layer_dims"]))) == c["layer_matvec_modes"]
        assert (g.input_dim, g.variant) == (c["input_dim"], "v1")


# ---------------------------------------------------------------------------
# (a) the plain shard kernels against JAX's Pallas shard kernels
# ---------------------------------------------------------------------------

def _f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _shard_operands(H, n, seed):
    """One rank's operands (the last rank's slice of h), numpy."""
    rng = np.random.default_rng(seed)
    Hl, Bk = H // n, 8
    h = _f32(rng, Bk, H, scale=0.5)
    return dict(H=H, Hl=Hl, h_full=h, h_local=h[:, (n - 1) * Hl:n * Hl],
                rh_full=_f32(rng, Bk, H, scale=0.5), xp=_f32(rng, Bk, 3 * Hl),
                u=_f32(rng, H, 3 * Hl, scale=H ** -0.5),
                b=_f32(rng, 3 * Hl, scale=0.3),
                z=1 / (1 + np.exp(-_f32(rng, Bk, Hl))),
                h_shard=_f32(rng, Bk, Hl, scale=0.5),
                u_rows=_f32(rng, Hl, 3 * H, scale=H ** -0.5),
                g=_f32(rng, Bk, 3 * Hl), zr=_f32(rng, Bk, 2 * Hl),
                xp2=_f32(rng, Bk, 2 * Hl), ht_in=_f32(rng, Bk, Hl))


def _args(name, a):
    Hl, H = a["Hl"], a["H"]
    return {
        "gru_rowwise_shard_step": (a["h_full"], a["h_local"], a["xp"],
                                   a["u"], a["b"]),
        "gru_rowwise_shard_zr": (a["h_full"], a["h_local"],
                                 a["xp"][:, :2 * Hl], a["u"][:, :2 * Hl],
                                 a["b"][:2 * Hl]),
        "gru_rowwise_shard_candidate": (a["rh_full"], a["h_local"], a["z"],
                                        a["xp"][:, 2 * Hl:],
                                        a["u"][:, 2 * Hl:], a["b"][2 * Hl:]),
        "gru_shard_matvec": (a["h_shard"], a["u_rows"][:, :2 * H]),
        "gru_cascade_shard_gates": (a["g"], a["xp"], a["h_shard"]),
        "gru_cascade_shard_zr": (a["zr"], a["xp2"], a["h_shard"],
                                 a["u_rows"][:, 2 * H:]),
        "gru_cascade_shard_update": (a["z"], a["ht_in"], a["h_shard"]),
    }[name]


def _torch_views(args):
    """numpy operands as torch tensors, keeping numpy's strides (a gate
    slice stays a row-strided view, as the mesh path passes it)."""
    return tuple(torch.from_numpy(a) for a in args)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("H,n", tuple(itertools.product((20, 32),
                                                        (1, 2, 4))))
@pytest.mark.parametrize("name", SHARD_NAMES)
def test_plain_shard_kernels_match_pallas(name, H, n):
    a = _shard_operands(H, n, seed=H * 10 + n)
    args = _args(name, a)
    got = _tuple(getattr(ref, name + "_ref")(*_torch_views(args)))
    want = _tuple(getattr(JK, name)(*map(jnp.asarray, args),
                                    interpret=True))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w, tol=SHARD_TOL)


@pytest.mark.parametrize("name", SHARD_NAMES)
def test_wrappers_on_cpu_run_the_plain_version(name):
    a = _shard_operands(32, 4, seed=7)
    args = _torch_views(_args(name, a))
    K.reset_launch_counts()
    got = _tuple(getattr(K, name)(*args))
    want = _tuple(getattr(ref, name + "_ref")(*args))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(k.launches == 0 for k in K.SHARD_KERNELS)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    a = _torch_views(_args("gru_rowwise_shard_step",
                           _shard_operands(32, 2, seed=3)))
    with pytest.raises(ValueError):          # a column-strided u
        K.gru_rowwise_shard_step(a[0], a[1], a[2], a[3].t().contiguous().t(),
                                 a[4])
    with pytest.raises(ValueError):          # u of another shard width
        K.gru_rowwise_shard_step(a[0], a[1], a[2], a[3][:, :12], a[4])
    with pytest.raises(TypeError):
        K.gru_shard_matvec(a[1].double(), a[3].double())


@pytest.mark.parametrize("operand", ("h_local", "xp", "x"))
def test_wrappers_refuse_rows_that_overlap(operand):
    """An expanded operand (row stride 0) has no row stride the kernel
    could read, so the wrapper raises even where the plain version would
    answer."""
    a = _torch_views(_args("gru_rowwise_shard_step",
                           _shard_operands(32, 2, seed=5)))
    h_full, h_local, xp, u, b = a
    if operand == "x":
        with pytest.raises(ValueError, match="row stride"):
            K.gru_shard_matvec(h_local[:1].expand_as(h_local), u[:16])
        return
    if operand == "h_local":
        h_local = h_local[:1].expand_as(h_local)
    else:
        xp = xp[:1].expand_as(xp)
    with pytest.raises(ValueError, match="row stride"):
        K.gru_rowwise_shard_step(h_full, h_local, xp, u, b)


# ---------------------------------------------------------------------------
# (b)-(d), (f): the port on n-rank CPU meshes (one spawn per world size)
# ---------------------------------------------------------------------------

RANK_BODY = r"""
import dataclasses, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.configs.base import GRUConfig, get_config
from repro_torch.core import gru as gru_core
from repro_torch.core import rowparallel, runtime
from repro_torch.core.params import init_params, params_from_numpy
from repro_torch.distributed import ShardCtx, init_mesh
from repro_torch.launch.serve import make_requests
from repro_torch.models import gru_lm
from repro_torch.serve.engine import ServeEngine

n, rank, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
mesh = init_mesh(n, rank, init_file=store, device="cpu",
                 backend="gloo", timeout_s=60)
inp = torch.load(work + "/inputs.pt", weights_only=False)
out = {}
for name, c in inp["cases"].items():
    params = params_from_numpy(c["params"], device="cpu")
    xs, xs_pad, mask = (torch.from_numpy(c[k]) for k in ("xs", "xs_pad", "mask"))
    B, T, _ = xs.shape
    r = {"prefill": {}, "decode": {}, "dispatch": {}}
    def cfg_of(b):
        return GRUConfig(**c["cfg"], backend=b)
    h0s = gru_core.stack_h0(cfg_of("eager"), B)
    for b in ("sharded", "cuda_sharded"):
        exe = runtime.compile(cfg_of(b), batch=B, seq=T, placement=mesh)
        sp = exe.prepare(params, device="cpu")
        f, st = exe.sequence(sp, h0s, xs, return_all=True)
        em = runtime.compile(cfg_of(b), batch=B, seq=T + inp["P"], mask=True,
                             placement=mesh)
        r["prefill"][b] = {"backend": exe.sequence_backend,
                           "masked_backend": em.sequence_backend,
                           "finals": f, "states": st,
                           "finals_only": exe.prefill(sp, h0s, xs),
                           "masked": em.prefill(sp, h0s, xs_pad, mask=mask)}
    for b in ("cuda_sharded", "sharded_decode"):
        exe = runtime.compile(cfg_of(b), batch=B, placement=mesh)
        sp = exe.prepare(params, device="cpu")
        hs, steps = h0s, []
        for t in range(T):
            hs = exe.decode(sp, hs, xs[:, t])
            steps.append(hs)
        r["decode"][b] = {"backend": exe.decode_backend, "steps": steps}
    for pref in ("auto", "cuda", "eager", "sharded"):
        exe = runtime.compile(cfg_of(pref), batch=B, seq=T, placement=mesh)
        r["dispatch"][pref] = (exe.sequence_backend, exe.decode_backend)
    # placement: this rank's slices only; an execute call reads no cells
    cfg = cfg_of("cuda_sharded")
    exe = runtime.compile(cfg, batch=B, seq=T, placement=mesh)
    sp = exe.prepare(params, device="cpu")
    r["placed"] = sp.placed
    poisoned = dataclasses.replace(sp, cells=tuple(
        {k: torch.full_like(v, float("nan")) for k, v in cell.items()}
        for cell in sp.cells))
    r["poisoned"] = (exe.prefill(poisoned, h0s, xs),
                     exe.decode(poisoned, h0s, xs[:, 0]))
    r["clean"] = (exe.prefill(sp, h0s, xs), exe.decode(sp, h0s, xs[:, 0]))
    out[name] = r
# the plain matvecs split both ways, and the one-layer entry point in
# both of the paper's modes
g = torch.Generator().manual_seed(5)
x, w = torch.randn(3, 16, generator=g), torch.randn(16, 24, generator=g)
kl, nl = 16 // n, 24 // n
out["matmul"] = {
    "rowwise": rowparallel.rowparallel_matmul(
        x, w[:, rank * nl:(rank + 1) * nl], mesh),
    "cascade": rowparallel.colparallel_matmul(
        x[:, rank * kl:(rank + 1) * kl], w[rank * kl:(rank + 1) * kl], mesh),
    "dense": x @ w}
c = inp["cases"]["r-depth1"]
cell = params_from_numpy(c["params"], device="cpu")[0]
xs = torch.from_numpy(c["xs"])
out["one_layer"] = {
    mode: rowparallel.gru_sequence_sharded(
        cell, torch.zeros(xs.shape[0], 16), xs, mesh=mesh,
        cfg=GRUConfig(input_dim=6, hidden_dim=16, matvec_mode=mode))
    for mode in ("rowwise", "cascade")}
# a served wave through the engine, pinned to cuda_sharded
mcfg = get_config("gru-jet-deep")
mcfg = mcfg.replace(gru=dataclasses.replace(mcfg.gru, backend="cuda_sharded"))
mparams = init_params(gru_lm.lm_specs(mcfg), seed=0, device="cpu")
eng = ServeEngine(mcfg, mparams, max_batch=4, device="cpu", ctx=ShardCtx(mesh))
done = eng.generate(make_requests(mcfg, 6, 9, True, 5, seed=3))
st = eng.latency_stats()
out["engine"] = {"streams": [q.out for q in done],
                 "prefill_backends": list(eng.prefill_backends),
                 "decode_steps": st["decode_backend_steps"],
                 "steps": st["steps"],
                 "placed_only": "placed_cells" in eng.params}
torch.save(out, f"{work}/rank{rank}.pt")
dist.destroy_process_group()
"""


@functools.lru_cache(maxsize=None)
def _case(name):
    """A case's parameters (JAX ``init_params`` + seeded biases, numpy),
    inputs, padded inputs and left-padding mask."""
    jcfg = JCfg(**CASES[name], backend="xla")
    params = numpy_params(jgru.gru_stack_specs(jcfg), seed=len(name))
    rng = np.random.default_rng(11 + len(name))
    xs = rng.normal(size=(B, T, CASES[name]["input_dim"])).astype(np.float32)
    xs_pad = np.pad(xs, ((0, 0), (P, 0), (0, 0)))
    mask = np.broadcast_to(np.arange(T + P)[None, :] >= P,
                           (B, T + P)).copy()
    return jcfg, params, xs, xs_pad, mask


@functools.lru_cache(maxsize=None)
def _jax_xla(name):
    """JAX's single-device xla backend: finals, return_all states, the
    masked padded prefill's finals and T decode steps."""
    jcfg, params, xs, xs_pad, mask = _case(name)
    jp = to_jax(params)
    h0s = jgru.stack_h0(jcfg, B)
    exe = jruntime.compile(jcfg, batch=B, seq=T)
    finals, states = exe.sequence(jp, h0s, jnp.asarray(xs), return_all=True)
    em = jruntime.compile(jcfg, batch=B, seq=T + P, mask=True)
    masked = em.sequence(jp, h0s, jnp.asarray(xs_pad),
                         mask=jnp.asarray(mask))[0]
    decode = jax.jit(exe.decode)       # one trace for the T steps
    hs, steps = h0s, []
    for t in range(T):
        hs = decode(jp, hs, jnp.asarray(xs[:, t]))
        steps.append(tuple(np.asarray(h) for h in hs))
    return ([np.asarray(f) for f in finals], np.asarray(states),
            [np.asarray(f) for f in masked], steps)


_MESH_RESULTS = {}


def _mesh_results(n, tmp_path_factory):
    """Every case on an n-rank gloo mesh of CPU processes, run once per
    world size: each rank's results."""
    if n not in _MESH_RESULTS:
        work = tmp_path_factory.mktemp(f"mesh{n}")
        torch.save({"P": P, "cases": {
            k: dict(cfg=CASES[k], params=_case(k)[1], xs=_case(k)[2],
                    xs_pad=_case(k)[3], mask=_case(k)[4]) for k in CASES}},
            work / "inputs.pt")
        run_ranks(RANK_BODY, n, work, timeout=240)
        _MESH_RESULTS[n] = [torch.load(work / f"rank{r}.pt",
                                       weights_only=False)
                            for r in range(n)]
    return _MESH_RESULTS[n]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"n{n}")
def ranks(request, tmp_path_factory):
    return request.param, _mesh_results(request.param, tmp_path_factory)


def _bitwise(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_bitwise(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("backend", ("sharded", "cuda_sharded"))
@pytest.mark.parametrize("case", tuple(CASES))
def test_sequence_matches_jax_xla(ranks, case, backend):
    n, results = ranks
    got = results[0][case]["prefill"][backend]
    assert got["backend"] == backend and got["masked_backend"] == backend
    finals, states, masked, _ = _jax_xla(case)
    for g, w in zip(got["finals"], finals):
        close(g, w)
    close(got["states"], states)
    for g, w in zip(got["masked"], masked):
        close(g, w)


@pytest.mark.parametrize("case", tuple(CASES))
def test_decode_matches_jax_xla(ranks, case):
    n, results = ranks
    got = results[0][case]["decode"]
    assert got["cuda_sharded"]["backend"] == "cuda_sharded"
    assert got["sharded_decode"]["backend"] == "sharded_decode"
    for g_step, w_step in zip(got["cuda_sharded"]["steps"], _jax_xla(case)[3]):
        for g, w in zip(g_step, w_step):
            close(g, w)


@pytest.mark.parametrize("case", tuple(CASES))
def test_cuda_sharded_bitwise_equals_sharded(ranks, case):
    n, results = ranks
    r = results[0][case]
    a, b = r["prefill"]["cuda_sharded"], r["prefill"]["sharded"]
    for k in ("finals", "states", "finals_only", "masked"):
        assert _bitwise(a[k], b[k]), k
    assert _bitwise(r["decode"]["cuda_sharded"]["steps"],
                    r["decode"]["sharded_decode"]["steps"])


@pytest.mark.parametrize("backend", ("sharded", "cuda_sharded"))
@pytest.mark.parametrize("case", tuple(CASES))
def test_masked_bucketed_prefill_bitwise_equals_unpadded(ranks, case,
                                                         backend):
    n, results = ranks
    got = results[0][case]["prefill"][backend]
    assert _bitwise(got["masked"], got["finals"])
    assert _bitwise(got["finals_only"], got["finals"])


@pytest.mark.parametrize("case", tuple(CASES))
def test_every_rank_holds_the_same_results(ranks, case):
    n, results = ranks
    for res in results[1:]:
        for part in ("prefill", "decode", "dispatch", "clean"):
            assert _same_tree(res[case][part], results[0][case][part]), part


def _same_tree(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
        return True
    assert a == b
    return True


@pytest.mark.parametrize("case", tuple(CASES))
def test_mesh_dispatch(ranks, case):
    """Under an n-rank mesh, sequence work goes to the split; decode stays
    replicated unless pinned (JAX's rule, names mapped)."""
    n, results = ranks
    hetero = len(set(CASES[case]["layer_dims"])) > 1
    fused = "cuda_chain" if hetero else "cuda_fused"
    assert results[0][case]["dispatch"] == {
        "auto": ("cuda_sharded", fused), "cuda": ("cuda_sharded", fused),
        "eager": ("cuda_sharded", "eager"), "sharded": ("sharded", fused)}


def test_placed_views_hold_only_this_ranks_slices(ranks):
    n, results = ranks
    for case, c in CASES.items():
        cells = _case(case)[1]
        for rank, res in enumerate(results):
            for l, (cell, placed) in enumerate(zip(cells,
                                                   res[case]["placed"])):
                H = cell["u"].shape[0]
                Hl, X = H // n, cell["w"].shape[0]
                sl = slice(rank * Hl, (rank + 1) * Hl)
                if c["layer_matvec_modes"][l] == "rowwise":
                    want = {"w3": cell["w"].reshape(X, 3, H)[..., sl],
                            "u3": cell["u"].reshape(H, 3, H)[..., sl],
                            "b3": cell["b"].reshape(3, H)[:, sl]}
                else:
                    want = {"w": cell["w"], "u": cell["u"][sl],
                            "b": cell["b"]}
                assert placed.keys() == want.keys()
                for k, v in want.items():
                    assert torch.equal(placed[k], torch.from_numpy(
                        np.array(v))), (case, rank, l, k)
                    # a tensor of its own: no other rank's rows behind it
                    assert placed[k].untyped_storage().nbytes() == v.nbytes


def test_execute_never_reads_the_full_cells(ranks):
    n, results = ranks
    for case in CASES:
        for res in results:
            assert _bitwise(res[case]["poisoned"], res[case]["clean"]), case


def test_split_matmuls_and_one_layer_entry(ranks):
    """``rowparallel_matmul`` / ``colparallel_matmul`` equal x @ w, and
    ``gru_sequence_sharded`` (one layer, row-wise and cascade) equals JAX's
    xla backend, on every rank."""
    n, results = ranks
    finals = _jax_xla("r-depth1")[0]
    for res in results:
        mm = res["matmul"]
        close(mm["rowwise"], mm["dense"].numpy())
        close(mm["cascade"], mm["dense"].numpy())
        for mode in ("rowwise", "cascade"):
            close(res["one_layer"][mode], finals[0])


def test_served_wave_on_the_mesh(ranks):
    """gru-jet-deep pinned to cuda_sharded through ServeEngine on every
    rank: every prefill and step on cuda_sharded, the engine holds only
    the placed views, and the streams equal on every rank and to the
    replicated eager engine's."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.params import init_params
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import gru_lm
    from repro_torch.serve.engine import ServeEngine
    n, results = ranks
    cfg = get_config("gru-jet-deep")
    params = init_params(gru_lm.lm_specs(cfg), seed=0, device="cpu")
    eng = ServeEngine(cfg, params, max_batch=4, device="cpu")
    want = [q.out for q in eng.generate(make_requests(cfg, 6, 9, True, 5,
                                                      seed=3))]
    for res in results:
        e = res["engine"]
        assert e["streams"] == want
        assert set(e["prefill_backends"]) == {"cuda_sharded"}
        assert e["decode_steps"] == {"cuda_sharded": e["steps"]}
        assert e["placed_only"]


# ---------------------------------------------------------------------------
# (e) dispatch parity with JAX on a one-rank mesh
# ---------------------------------------------------------------------------

PREFS = ((None, None), ("pallas", "cuda"), ("auto", "auto"),
         ("xla", "eager"), ("pallas_fused", "cuda_fused"),
         ("pallas_chain", "cuda_chain"), ("sharded", "sharded"),
         ("pallas_sharded", "cuda_sharded"),
         ("sharded_decode", "sharded_decode"))


@functools.lru_cache(maxsize=None)
def _jax_one_device_mesh():
    from jax.sharding import Mesh
    return jruntime.Placement(mesh=Mesh(np.array(jax.devices()[:1]),
                                        ("model",)))


@pytest.mark.parametrize("mesh_on", (True, False), ids=("mesh", "host"))
@pytest.mark.parametrize("family", ("gru", "slstm"))
@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("dims", ((), (8, 16)), ids=("uniform", "hetero"))
@pytest.mark.parametrize("pref", PREFS, ids=lambda p: p[1] or "default")
def test_dispatch_matches_jax_runtime(pref, dims, masked, family, mesh_on):
    jkw = {"backend": pref[0]} if pref[0] else {}
    tkw = {"backend": pref[1]} if pref[1] else {}
    shape = dict(input_dim=5, hidden_dim=8, num_layers=2, layer_dims=dims,
                 family=family)
    jexe = jruntime.compile(JCfg(**shape, **jkw), batch=B, mask=masked,
                            placement=(_jax_one_device_mesh() if mesh_on
                                       else None))
    texe = runtime.compile(TCfg(**shape, **tkw), batch=B, mask=masked,
                           placement=local_mesh("cpu") if mesh_on else None)
    assert (texe.sequence_backend, texe.decode_backend) == (
        PORT_NAME[jexe.sequence_backend], PORT_NAME[jexe.decode_backend])


def test_local_mesh_defaults_to_the_card(monkeypatch):
    """``local_mesh()`` runs on the card like every entry point: without
    one it raises; the CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        local_mesh()
    mesh = local_mesh("cpu")
    assert (mesh.device, mesh.size, mesh.rank, mesh.group) == (
        torch.device("cpu"), 1, 0, None)


def test_one_rank_mesh_matches_jax_xla():
    """On a one-rank mesh (no process group: the collectives are
    identities) the split runs in this process."""
    jcfg, params, xs, _, _ = _case("gru-jet-deep")
    finals, states, _, _ = _jax_xla("gru-jet-deep")
    cfg = TCfg(**CASES["gru-jet-deep"], backend="cuda_sharded")
    exe = runtime.compile(cfg, batch=B, seq=T, placement=local_mesh("cpu"))
    sp = exe.prepare(to_torch(params), device="cpu")
    from repro_torch.core import gru as tgru
    f, st = exe.sequence(sp, tgru.stack_h0(cfg, B), torch.from_numpy(xs),
                         return_all=True)
    for g, w in zip(f, finals):
        close(g, w)
    close(st, states)


def test_prepare_ignores_a_mesh_for_the_slstm():
    shape = dict(input_dim=5, hidden_dim=8, num_layers=2, family="slstm")
    specs = {"cells": jcells.get_family("slstm").stack_specs(JCfg(**shape))}
    sp = runtime.prepare(to_torch(numpy_params(specs)),
                         TCfg(**shape, backend="cuda"), local_mesh("cpu"),
                         device="cpu")
    assert sp.placed is None and sp.placement == runtime.HOST


# ---------------------------------------------------------------------------
# (g) one case on 2 ranks against JAX's sharded backend on 2 devices
# ---------------------------------------------------------------------------

JAX_SHARDED_BODY = """
import dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import GRUConfig
from repro.core import gru, runtime
with open({path!r}, "rb") as f:
    c = pickle.load(f)
cfg = GRUConfig(**c["cfg"], backend="sharded")
mesh = jax.make_mesh((2,), ("model",))
placement = runtime.Placement(mesh=mesh)
params = jax.tree.map(jnp.asarray, c["params"])
xs = jnp.asarray(c["xs"])
B, T, _ = xs.shape
h0s = gru.stack_h0(cfg, B)
exe = runtime.compile(cfg, batch=B, seq=T, placement=placement)
assert exe.sequence_backend == "sharded", exe.sequence_backend
finals, states = exe.sequence(exe.prepare(params), h0s, xs, return_all=True)
dcfg = dataclasses.replace(cfg, backend="sharded_decode")
dexe = runtime.compile(dcfg, batch=B, placement=placement)
assert dexe.decode_backend == "sharded_decode"
sp = dexe.prepare(params)
decode = jax.jit(dexe.decode)
hs = tuple(h0s)
for t in range(T):
    hs = decode(sp, hs, xs[:, t])
np.savez({out!r}, states=np.asarray(states),
         **{{f"f{{i}}": np.asarray(f) for i, f in enumerate(finals)}},
         **{{f"d{{i}}": np.asarray(h) for i, h in enumerate(hs)}})
print("PASS")
"""


def test_two_ranks_match_jax_sharded_backend(multidev, tmp_path,
                                            tmp_path_factory):
    results = _mesh_results(2, tmp_path_factory)
    case = "gru-jet-deep"
    jcfg, params, xs, _, _ = _case(case)
    path, out = tmp_path / "case.pkl", tmp_path / "jax.npz"
    with open(path, "wb") as f:
        pickle.dump({"cfg": CASES[case], "params": params, "xs": xs}, f)
    multidev(JAX_SHARDED_BODY.format(path=str(path), out=str(out)),
             n_devices=2, timeout=300)
    want = np.load(out)
    got = results[0][case]
    L = len(CASES[case]["layer_dims"])
    for i in range(L):
        close(got["prefill"]["cuda_sharded"]["finals"][i], want[f"f{i}"])
        close(got["decode"]["cuda_sharded"]["steps"][-1][i], want[f"d{i}"])
    close(got["prefill"]["cuda_sharded"]["states"], want["states"])
