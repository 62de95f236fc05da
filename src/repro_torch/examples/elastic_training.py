"""Fault-tolerant training: two node failures injected mid-run; the
supervisor shrinks the mesh, restores the last committed checkpoint and
finishes, the loss still falling across the restarts (counterpart of the
JAX package's ``examples/elastic_training.py``).

qwen3-0.6b at its SMOKE size trains 40 steps (batch 8, seq 32) under the
port's ``ElasticMeshManager`` and ``Supervisor``, saving through the
port's ``CheckpointManager`` every 10 steps; devices fail at steps 13 and
27. The step is eager on ``attn_impl="chunked"`` (the attention kernels
have no backward)::

    PYTHONPATH=src python -m repro_torch.examples.elastic_training
    PYTHONPATH=src python -m repro_torch.examples.elastic_training --device cpu
"""
import argparse
import tempfile

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ShapeConfig, TrainConfig, get_smoke_config
from repro_torch.data.pipeline import SyntheticStream, shard_batch
from repro_torch.distributed.fault_tolerance import (ElasticMeshManager,
                                                     Supervisor)
from repro_torch.train import trainer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config("qwen3-0.6b").replace(attn_impl="chunked")
    tcfg = TrainConfig(learning_rate=2e-3, warmup_steps=5, total_steps=60)
    stream = SyntheticStream(cfg, ShapeConfig("t", 32, 8, "train"))

    with tempfile.TemporaryDirectory() as ckdir:
        mgr = CheckpointManager(ckdir, keep=2)
        mesh_mgr = ElasticMeshManager(total_devices=8, model_parallel=2)

        def build(mesh_shape):
            print(f"[supervisor] (re)building for mesh shape {mesh_shape}")
            train_step = trainer.make_train_step(cfg, tcfg)

            def step_fn(state, step):
                batch = shard_batch(stream.batch_at(step), device=device)
                state, metrics = train_step(state, batch)
                return state, {"loss": float(metrics["loss"])}

            state = trainer.init_state(cfg, tcfg, device=device)

            def save_fn(state, step):
                mgr.save(state, step)

            def restore_fn(like):
                step = mgr.latest_step() or 0
                st = mgr.restore(like, step=step) if step else like
                print(f"[supervisor] restored checkpoint at step {step}")
                return st, step
            return step_fn, state, save_fn, restore_fn

        sup = Supervisor(mesh_mgr, build, checkpoint_every=10)
        state, step, history = sup.run(40, inject={13: [0], 27: [1]})
        losses = [m["loss"] for _, m in history]
        print(f"completed {step} steps with {sup.restarts} restarts; "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
        assert step == 40 and sup.restarts == 2
        assert losses[-1] < losses[0]
    return step, sup.restarts, losses


if __name__ == "__main__":
    main()
