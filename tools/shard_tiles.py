#!/usr/bin/env python3
"""Route and tile sweep of the port's five redesigned shard kernels on
one CUDA card, ``csrc/gru_shard.cu``: ``gru_shard_matvec`` (the cascade's
partial product), ``gru_rowwise_shard_step`` (the v3 row-wise step),
``gru_rowwise_shard_zr`` and ``gru_rowwise_shard_candidate`` (the v1
row-wise pair, around the gather of r*h), and ``gru_cascade_shard_zr``
(the v1 cascade's middle phase).

Forces every route and knob through the C entry points, with explicit
arguments: the direct route at each slice count S (lanes that split K),
rows a thread R and warps a block; the column tile at each batch tile and
column tile. Shapes: ``chip_smoke.py``'s ``SHARD_TIMED`` (gru-jet-deep
H=32 over 2, 4 and 1 ranks; gru-jet H=20 over 2 and 4) and wide shards (H
64, 128, 256, 512 over 1, 2 and 4 ranks), 8 slots; the paper's 2-rank
shard also at B 1 and 64. Each forced launch is held against the plain
version (largest absolute error at most 1e-5) before it is timed. Device
time per call comes from ``chip_smoke.device_time_ms`` (50 calls captured
in a CUDA graph, CUDA events around 5 replays); ``torch.matmul`` (TF32
off) is timed beside the matvec. Each shape's lines end with the fastest
launch of each route and the wrapper's plan (``kernel.shard_plan``), so
the plan's rule can be read off the table.

Then row 16, ``gru_cascade_shard_gates`` (the v3 cascade epilogue, one
thread an output, no knob): at the same shapes and B 1 and 64, the call as
the mesh step makes it (gate views of the psum'd gates, of xp and of b:
one launch) beside the epilogue it replaced (psum + b, two slice copies,
the kernel on contiguous slices), both held against the plain version
and against each other bit for bit. Then row 18,
``gru_cascade_shard_update`` (the v1 cascade epilogue, one thread an
output) likewise: the call as the mesh step makes it (column slices of the
psum'd partial, of xp's candidate gate and of b) beside ``_ht_in``'s two
adds and the contiguous call, on every rank; with ``--parent DIR`` (a
checkout of a commit before row 18 read its candidate in place) also that
commit's kernel, built from its source, on the contiguous pre-activation,
held bit for bit and timed.

Then the served ``cuda_sharded`` decode step of gru-jet-deep v1 and v3 on
a one-rank mesh without a group (``chip_smoke.profile_mesh_decode``),
once with the wrapper's plans and once with all five kernels forced to
the column tile at ``kernel.shard_tiles``'s tile (the device code they
ran before the direct route), in turns tile, plan, plan, tile. It prints
``-Xptxas -v``'s lines for the direct route's kernels first. The table
also goes to ``--out``.

Each shape's lines mark the wrapper's plan and the old tile (the launch
each kernel made before its redesign), so "before" and "after" come from
one run.

Run from the repository root on a machine with a card::

    python3 tools/shard_tiles.py [--out build/shard_tiles.txt] [--parent DIR]
        [--epilogues-only]
"""
from __future__ import annotations

import argparse
import itertools
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
CTS = (4, 8, 16, 32)
BTS = (1, 2, 4, 8)
WARPS = (1, 2, 4, 8)
WIDE = tuple(itertools.product((64, 128, 256, 512), (1, 2, 4)))


def parent_update_entry(parent: Path, build: Path):
    """The v1 cascade epilogue's C entry of an earlier checkout's
    ``gru_shard.cu``, built with the port's nvcc flags: the entry before
    row 18 read its candidate in place, (z, ht_in, h, out, B, Hl, stream)
    on a contiguous (B,Hl) pre-activation. Also writes that kernel's SASS
    beside the library."""
    import ctypes
    from repro_torch.kernels import _build
    src = parent / "src" / "repro_torch" / "csrc" / "gru_shard.cu"
    lib = build / "libgru_shard_parent.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    (build / "parent_cascade_update_k.sass").write_text("".join(
        part for part in sass.split("Function : ")
        if "cascade_update_k" in part.partition("\n")[0]))
    fn = ctypes.CDLL(str(lib)).gru_cascade_shard_update_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/shard_tiles.txt",
                    help="file for the sweep's lines")
    ap.add_argument("--parent", default=None,
                    help="a checkout of a commit before row 18 read its "
                         "candidate in place, whose row 18 kernel is built "
                         "and held beside this one")
    ap.add_argument("--epilogues-only", action="store_true",
                    help="rows 16 and 18's lines only")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, _launch
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.gru_sequence import ref
    if not torch.cuda.is_available():
        sys.exit("shard_tiles: no CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    _build.build(["gru_shard"])
    log = _build.build_log("gru_shard").splitlines()
    for i, line in enumerate(log):        # ptxas: the function, then its use
        fn = re.search(r"function '([^']*_direct_k[^']*)'", line)
        if fn and "Compiling" in line:
            use = " | ".join(x.strip() for x in log[i + 1:i + 4]
                             if "registers" in x or "spill" in x)
            say(f"ptxas: {fn.group(1)}: {use}")

    def launch(name, a, out_, knobs):
        """A C-entry call of ``name`` on ``a`` into the outputs ``out_`` (a
        tuple: the zr kernel's z and r*h, one for the others) at ``knobs``
        (("direct", S, R, warps) or ("tile", bt, ct)); reads the current
        stream at each call, so a graph capture records it."""
        route = knobs[0]
        if name == "gru_cascade_shard_zr":
            zr, xp2, h, u = a
            head = [zr.data_ptr(), xp2.data_ptr(), h.data_ptr(), u.data_ptr(),
                    u.stride(0), out_[0].data_ptr(), out_[1].data_ptr(),
                    h.shape[0], h.shape[1], u.shape[1]]
            if route == "direct":
                fn = _launch.launcher("gru_shard",
                                      "gru_cascade_shard_zr_direct_launch",
                                      K._CZR_ARGS)
                return lambda: fn(*head, *knobs[1:], _launch.stream(dev))
            fn = _launch.launcher("gru_shard", "gru_cascade_shard_zr_launch",
                                  K._CZR_ARGS)
            vec = K._vector(u, u.stride(0), u.shape[1])
            return lambda: fn(*head, *knobs[1:], vec, _launch.stream(dev))
        if name == "gru_shard_matvec":
            x, w = a
            ld = (x.stride(0), w.stride(0))
            head = [x.data_ptr(), ld[0], w.data_ptr(), ld[1],
                    out_[0].data_ptr(), x.shape[0], x.shape[1], w.shape[1]]
            if route == "direct":
                fn = _launch.launcher("gru_shard",
                                      "gru_shard_matvec_direct_launch",
                                      K._MATVEC_ARGS)
                return lambda: fn(*head, *knobs[1:], _launch.stream(dev))
            fn = _launch.launcher("gru_shard", "gru_shard_matvec_launch",
                                  K._MATVEC_ARGS)
            vec = K._vector(w, ld[1], w.shape[1])
            return lambda: fn(*head, *knobs[1:], vec, _launch.stream(dev))
        x, hl, xp, u, b = a[0], a[1], a[-3], a[-2], a[-1]
        z = a[2] if len(a) == 6 else None
        mode = K._ROWWISE_MODES[name][0]
        B, H, Hl = x.shape[0], x.shape[1], hl.shape[1]
        head = [mode, x.data_ptr(), hl.data_ptr(), hl.stride(0),
                None if z is None else z.data_ptr(), xp.data_ptr(),
                xp.stride(0), u.data_ptr(), u.stride(0), b.data_ptr(),
                out_[0].data_ptr(),
                out_[1].data_ptr() if len(out_) > 1 else None, B, H, Hl]
        if route == "direct":
            fn = _launch.launcher("gru_shard",
                                  "gru_rowwise_shard_direct_launch",
                                  K._ROWWISE_ARGS)
            return lambda: fn(*head, *knobs[1:], _launch.stream(dev))
        fn = _launch.launcher("gru_shard", "gru_rowwise_shard_launch",
                              K._ROWWISE_ARGS)
        vec = K._vector(u, u.stride(0), Hl)
        return lambda: fn(*head, *knobs[1:], vec, _launch.stream(dev))

    def sweep(name, H, n, B):
        a = cs.shard_inputs(torch, H, n, B, 11 * H + n + B, dev)
        args_ = cs.shard_args(name, a, 2 * H)
        want = getattr(ref, name + "_ref")(*args_)
        want = want if isinstance(want, tuple) else (want,)
        out_ = tuple(torch.empty_like(w) for w in want)
        Kc = args_[2 if name == "gru_cascade_shard_zr" else 0].shape[1]
        G = (1 if name in ("gru_shard_matvec", "gru_cascade_shard_zr")
             else K.KIND_GATES[K._ROWWISE_MODES[name][1]])
        N = want[-1].shape[1]     # the cascade's p, not its z
        head = (f"{name:27s} H={H:3d} ranks={n} B={B:2d} K={Kc:3d} "
                f"N={N:4d}")
        plan = cs.planned(K, name, args_)
        old = ("tile",) + K.shard_tiles(B, Kc, G, N)    # before the redesign
        best = {}

        def one(knobs):
            call = launch(name, args_, out_, knobs)
            for o in out_:
                o.fill_(float("nan"))
            if call() != 0:
                sys.exit(f"shard_tiles: {head} {knobs}: launch refused")
            torch.cuda.synchronize()
            e = max((o - w).abs().max().item() for o, w in zip(out_, want))
            if not e <= TOL:
                sys.exit(f"shard_tiles: {head} {knobs}: max |err| {e:.3g} "
                         f"> {TOL}")
            t = cs.device_time_ms(torch, call, per_graph=50)
            mark = ""
            if plan.route == knobs[0] and (
                    knobs[1:] == (plan.slices, plan.rows, plan.warps)
                    or knobs[1:] == (plan.rows, plan.ct)):
                mark = "  <- the wrapper's plan"
            if knobs == old:
                mark += "  <- the old tile"
            say(f"{head} {' '.join(map(str, knobs)):18s} {t * 1e3:7.2f} us"
                f"{mark}")
            if t < best.get(knobs[0], (1e9,))[0]:
                best[knobs[0]] = (t, knobs)
        for S, R, w in itertools.product(K.SLICES, K.DIRECT_ROWS, WARPS):
            if R == 1 or R <= B:
                one(("direct", S, R, w))
        for bt, ct in itertools.product(BTS, CTS):
            if K.smem_bytes_shard(Kc, bt, G, ct) <= K.SMEM_LIMIT:
                one(("tile", bt, ct))
        if name == "gru_shard_matvec":
            lib = cs.device_time_ms(torch, lambda: torch.matmul(*args_),
                                    per_graph=50)
            say(f"{head} torch.matmul       {lib * 1e3:7.2f} us")
        for route, (t, knobs) in sorted(best.items()):
            say(f"{head} fastest {route}: {knobs} {t * 1e3:.2f} us")
        say(f"{head} plan: {plan}")

    shapes = [(H, n, 8) for H, n in cs.SHARD_TIMED]
    shapes += [(32, 2, 1), (32, 2, 64)] + [(H, n, 8) for H, n in WIDE]
    if not args.epilogues_only:
        for H, n, B in shapes:
            for name in cs.REDESIGNED:
                sweep(name, H, n, B)

    # row 16: the call as the step makes it against the epilogue before
    from repro_torch.core import rowparallel as rp
    parent_update = (parent_update_entry(Path(args.parent).resolve(),
                                         ROOT / "build" / "parent_gru_shard")
                     if args.parent else None)
    name = "gru_cascade_shard_gates"
    for H, n, B in shapes[:len(cs.SHARD_TIMED) + 2]:
        a = cs.shard_inputs(torch, H, n, B, 17 * H + n + B, dev)
        args_ = cs.shard_args(name, a)
        h = a["h_shard"]
        head = f"{name:27s} H={H:3d} ranks={n} B={B:2d}"
        want = ref.gru_cascade_shard_gates_ref(*args_)
        got = K.gru_cascade_shard_gates(*args_)
        old = cs.old_gates_fn(a)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        if not (e <= TOL and torch.equal(got, old())):
            sys.exit(f"shard_tiles: {head}: max |err| {e:.3g}, or the "
                     f"in-place call differs from the old sequence")
        local = [t.reshape(B, -1).contiguous() for t in args_[:2]]
        t_new = cs.device_time_ms(
            torch, lambda: K.gru_cascade_shard_gates(*args_), per_graph=50)
        t_contig = cs.device_time_ms(
            torch, lambda: K.gru_cascade_shard_gates(*local, h),
            per_graph=50)
        t_old = cs.device_time_ms(torch, old, per_graph=50)
        line = (f"{head} in place (views + b) {t_new * 1e3:6.2f} us; "
                f"contiguous slices {t_contig * 1e3:6.2f} us; old epilogue "
                f"(+ b, 2 cats, kernel) {t_old * 1e3:6.2f} us")
        say(line)

    # row 18: the call as the step makes it against the epilogue before
    name = "gru_cascade_shard_update"
    for H, n, B in shapes[:len(cs.SHARD_TIMED) + 2]:
        a = cs.shard_inputs(torch, H, n, B, 19 * H + n + B, dev)
        Hl = a["Hl"]
        for idx in range(n):
            head = f"{name:27s} H={H:3d} ranks={n} rank={idx} B={B:2d}"
            views = cs.update_views(a, idx)
            old = cs.old_update_fn(a, idx)
            got = K.gru_cascade_shard_update(*views)
            want = ref.gru_cascade_shard_update_ref(*views)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            if not (e <= TOL and torch.equal(got, old())):
                sys.exit(f"shard_tiles: {head}: max |err| {e:.3g}, or the "
                         f"in-place call differs from the old sequence")
            ht_in = rp._ht_in(a["xp_full"], a["ht_full"], a["b_full"],
                              a["H"], idx, Hl)
            line = ""
            if parent_update is not None:
                out_p = torch.empty_like(got)

                def parent_kernel():
                    _launch.raise_on(parent_update(
                        a["z"].data_ptr(), ht_in.data_ptr(),
                        a["h_shard"].data_ptr(), out_p.data_ptr(), B, Hl,
                        _launch.stream(dev)), "the parent's update kernel")
                    return out_p
                parent_kernel()
                torch.cuda.synchronize()
                if not torch.equal(out_p, got):
                    sys.exit(f"shard_tiles: {head}: the in-place call "
                             f"differs from the parent's kernel (max "
                             f"{(out_p - got).abs().max().item():.3g})")
                line = " (== the parent's kernel bit for bit)"
            if idx != n - 1:
                say(f"{head} in place == old sequence{line}")
                continue
            t_new = cs.device_time_ms(
                torch, lambda: K.gru_cascade_shard_update(*views),
                per_graph=50)
            t_contig = cs.device_time_ms(
                torch, lambda: K.gru_cascade_shard_update(
                    a["z"], ht_in, a["h_shard"]), per_graph=50)
            t_old = cs.device_time_ms(torch, old, per_graph=50)
            line = (f"{head} in place (slices + adds) {t_new * 1e3:6.2f} us; "
                    f"contiguous pre-activation {t_contig * 1e3:6.2f} us; "
                    f"old epilogue (2 adds, kernel) {t_old * 1e3:6.2f} us"
                    f"{line}")
            if parent_update is not None:
                t_par = cs.device_time_ms(torch, parent_kernel,
                                          per_graph=50)
                line += f"; parent's kernel {t_par * 1e3:6.2f} us"
            say(line)
    if args.epilogues_only:
        out.write_text("\n".join(lines) + "\n")
        return

    # the served step, one rank: the wrapper's plans against the column tile
    from repro_torch.core.params import init_params
    from repro_torch.distributed import ShardCtx, local_mesh
    from repro_torch.models import gru_lm
    planner = K.shard_plan

    def tile_plan(B, Kc, G, N, vec, kind=None):
        """The launches before the direct route: the old tile."""
        return K.tile_plan(B, Kc, G, N, vec, *K.shard_tiles(B, Kc, G, N))
    for arch, cfg in cs.mesh_configs().items():
        params = init_params(gru_lm.lm_specs(cfg), seed=0,
                             device=torch.device("cpu"))
        for which in ("tile", "plan", "plan", "tile"):
            K.shard_plan = tile_plan if which == "tile" else planner
            try:
                pr = cs.profile_mesh_decode(torch, cfg, params, dev,
                                            ShardCtx(local_mesh(dev)))
            finally:
                K.shard_plan = planner
            say(f"served step {arch} (cuda_sharded, one rank, {cs.SLOTS} "
                f"slots, 20 steps) with {which:4s}: wall "
                f"{pr['wall_ms_per_step']:.4f} ms/step, shard kernels "
                f"{pr['shard_kernels_ms_per_step']:.4f} ms/step, device "
                f"busy {pr['device_busy_ms_per_step']:.4f} ms/step (idle "
                f"{pr['device_idle_share']:.3%})")
            for k, us in pr["top_device"]:
                say(f"    {us:9.2f} us/step  {k}")
    out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
