"""Training driver (counterpart of ``repro.launch.train``): the data
pipeline, the eager train step, async checkpoints and the straggler
monitor; ``--resume`` restarts from the latest committed checkpoint.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gru-jet --steps 300
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 50 --batch 8 --seq 64 --checkpoint-dir CK --resume

JAX's flags, plus ``--device`` (``cuda`` by default: it raises without a
card; ``cpu`` runs off the card). It prints JAX's lines: ``step ...
loss= gnorm= lr= [acc=]`` every ``--log-every`` steps and a ``done:``
line. Training is eager with autograd (JAX's is XLA with
``value_and_grad``), so it runs the plain PyTorch paths: the cell
families on ``backend="eager"``, and the dense family on
``attn_impl="chunked"`` (JAX's ``xla_flash``), which this driver sets, and
says so, since the port's dense default (``"cuda"``, the attention
kernels) has no backward.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import (ShapeConfig, TrainConfig, get_config,
                                      get_smoke_config)
from repro_torch.core.cells import is_cell_family
from repro_torch.data.pipeline import PipelineConfig, SyntheticStream, shard_batch
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.train import trainer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced same-family config (CPU-sized)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if is_cell_family(cfg.family):
        args.seq = cfg.gru.seq_len
    elif cfg.attn_impl != "chunked":
        print(f"attn_impl: {cfg.attn_impl} -> chunked (the attention "
              f"kernels have no backward)", flush=True)
        cfg = cfg.replace(attn_impl="chunked")
    tcfg = TrainConfig(learning_rate=args.lr,
                       warmup_steps=min(20, args.steps // 10 + 1),
                       total_steps=args.steps, microbatches=args.microbatches,
                       checkpoint_every=args.checkpoint_every, seed=args.seed)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    stream = SyntheticStream(cfg, shape, PipelineConfig(seed=args.seed))

    state = trainer.init_state(cfg, tcfg, seed=args.seed, device=device)
    step_fn = trainer.make_train_step(cfg, tcfg)

    mgr = None
    start = 0
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir, keep=3)
        if args.resume and mgr.latest_step() is not None:
            state = mgr.restore(state)
            start = int(state["step"])
            print(f"resumed from step {start}")

    strag = StragglerMonitor()
    t_begin = time.time()
    loss = float("nan")
    for s in range(start, args.steps):
        batch = shard_batch(stream.batch_at(s), device=device)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        strag.record("host0", time.time() - t0)
        if s % args.log_every == 0 or s == args.steps - 1:
            extra = ""
            if "acc" in metrics:
                extra = f" acc={float(metrics['acc']):.3f}"
            print(f"step {s:5d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e}{extra} "
                  f"({time.time()-t0:.2f}s)", flush=True)
        if mgr and (s + 1) % tcfg.checkpoint_every == 0:
            mgr.save_async(state, s + 1)
    if mgr:
        mgr.save(state, args.steps)
        mgr.wait()
    print(f"done: {args.steps - start} steps in {time.time()-t_begin:.1f}s; "
          f"final loss {loss:.4f}")
    return state


if __name__ == "__main__":
    main()
