"""Train the paper's jet-tagging GRU with checkpoints, restart it from the
last checkpoint, then classify a held-out batch (counterpart of the JAX
package's ``examples/train_jet_tagging.py``).

gru-jet trains for 300 steps (batch 64, lr 3e-3, a checkpoint every 100
steps), then a second run resumes from the last checkpoint and goes on to
step 320. The resumed model classifies ``batch_at(10_001)`` (256 rows,
never trained on) under ``torch.no_grad()``, through ``eager`` and, on the
card, through ``cuda_fused`` (the sequence kernel): the held-out accuracy
must pass 0.5 and the two must give the same classes::

    PYTHONPATH=src python -m repro_torch.examples.train_jet_tagging
    PYTHONPATH=src python -m repro_torch.examples.train_jet_tagging --device cpu
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import gru
from repro_torch.data.pipeline import SyntheticStream, shard_batch
from repro_torch.launch.train import main as train_main


def evaluate(params, backend: str, device, rows: int = 256):
    """(accuracy, logits) of ``params`` on ``batch_at(10_001)`` through
    ``backend``, without autograd."""
    cfg = get_config("gru-jet")
    gcfg = dataclasses.replace(cfg.gru, backend=backend)
    stream = SyntheticStream(cfg, ShapeConfig("t", cfg.gru.seq_len, rows,
                                              "train"))
    batch = shard_batch(stream.batch_at(10_001), device=device)
    with torch.no_grad():
        logits = gru.gru_classify(params, batch["features"], cfg=gcfg)
    acc = float((logits.argmax(-1) == batch["labels"].long()).float().mean())
    return acc, logits


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    common = ["--arch", "gru-jet", "--batch", "64", "--lr", "3e-3",
              "--device", str(device)]
    with tempfile.TemporaryDirectory() as ck:
        train_main(common + ["--steps", "300", "--checkpoint-dir", ck,
                             "--checkpoint-every", "100", "--log-every",
                             "50"])
        print("--- simulated restart ---")
        state = train_main(common + ["--steps", "320", "--checkpoint-dir", ck,
                                     "--resume", "--log-every", "10"])
    backends = ["eager"] + (["cuda_fused"] if device.type == "cuda" else [])
    accs, classes = {}, {}
    for b in backends:
        accs[b], logits = evaluate(state["params"], b, device)
        classes[b] = logits.argmax(-1)
        print(f"held-out accuracy after training ({b}): {accs[b]:.3f}")
    assert accs["eager"] > 0.5, "training did not learn the teacher"
    for b in backends[1:]:
        assert torch.equal(classes[b], classes["eager"]), b
    return state, accs


if __name__ == "__main__":
    main()
