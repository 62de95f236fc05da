"""Deterministic, seekable synthetic data pipeline (counterpart of
``repro.data.pipeline``).

Fault-tolerance contract: ``batch_at(step)`` is a pure function of (seed,
step, shape), so a restart from a checkpoint at step k replays the EXACT
stream: no data-loader state to checkpoint. The batches are numpy arrays,
drawn by the JAX package's code, copied: the same seed and step give the
same bits in both packages. :func:`shard_batch` moves a batch to the
device (given a :class:`~repro_torch.distributed.mesh.Mesh`, this rank's
slice along the batch dimension), and :class:`Prefetcher` keeps the next
``depth`` batches ready on the device.

The LM stream is a noisy deterministic bigram process (next = a*cur + c mod
V with probability 1-eps), so CE on it genuinely decreases during the
example runs. The jet stream's labels come from a fixed random linear
teacher over mean features, learnable for the jet-tagging example. The
audio and vision-language families' batches carry ``frames`` and
``patches`` beside the tokens, drawn after them from the same generator.

One deliberate difference: the jet stream serves every cell family (the
GRU and the sLSTM), whose loss reads ``features`` and ``labels``. JAX's
keys it on ``family == "gru"`` alone, so its ``slstm-jet`` stream yields
LM tokens that its own sLSTM ``loss_fn`` cannot read; the port's sLSTM
stream is JAX's stream of the same shapes under the GRU family, bit for
bit (the sLSTM config's ``vocab_size`` and ``gru`` fields seed it alike).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.cells import is_cell_family


@dataclass
class PipelineConfig:
    seed: int = 0
    bigram_eps: float = 0.25     # fraction of uniform-random next-tokens
    prefetch: int = 2


class SyntheticStream:
    """step -> batch dict of numpy arrays (global shapes)."""

    def __init__(self, model_cfg: ModelConfig, shape: ShapeConfig,
                 pcfg: PipelineConfig = PipelineConfig()):
        self.cfg = model_cfg
        self.shape = shape
        self.pcfg = pcfg
        self._jet = is_cell_family(model_cfg.family)
        v = max(model_cfg.vocab_size, 2)
        r = np.random.default_rng(pcfg.seed ^ 0x5EED)
        self._a = int(r.integers(1, v))
        self._c = int(r.integers(0, v))
        if self._jet:
            g = model_cfg.gru
            self._teacher = r.normal(size=(g.input_dim, g.num_classes))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg, shape = self.cfg, self.shape
        B, S = shape.global_batch, shape.seq_len
        rng = np.random.default_rng((self.pcfg.seed << 20) ^ step)
        if self._jet:
            g = cfg.gru
            feats = rng.normal(size=(B, S, g.input_dim)).astype(np.float32)
            # teacher weights recent timesteps (aligned with the recurrence)
            w_t = np.linspace(0.2, 1.0, S)[None, :, None]
            pooled = (feats * w_t).sum(1) / w_t.sum()
            labels = (pooled @ self._teacher).argmax(-1).astype(np.int32)
            return {"features": feats, "labels": labels}
        v = cfg.vocab_size
        first = rng.integers(0, v, size=(B, 1))
        noise = rng.random(size=(B, S)) < self.pcfg.bigram_eps
        rand = rng.integers(0, v, size=(B, S))
        seq = np.empty((B, S + 1), np.int64)
        seq[:, :1] = first
        for t in range(S):
            nxt = (seq[:, t] * self._a + self._c) % v
            seq[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        batch = {"tokens": seq[:, :S].astype(np.int32),
                 "targets": seq[:, 1:].astype(np.int32)}
        if cfg.family == "audio":
            batch["frames"] = rng.normal(
                size=(B, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            batch["patches"] = rng.normal(
                size=(B, cfg.vision.num_patches, cfg.vision.embed_dim)).astype(np.float32)
        return batch


def shard_batch(batch: Dict[str, np.ndarray], mesh=None,
                device=None) -> Dict[str, torch.Tensor]:
    """Host -> device. With a ``mesh`` (one rank a data shard), only this
    rank's rows are moved: the batch dimension split into ``mesh.size``
    equal parts in rank order, onto ``mesh.device``. Without one, the
    whole batch onto ``device`` (default the card)."""
    if mesh is not None:
        dev = mesh.device
    else:
        dev = resolve_device("cuda" if device is None else device)
    out = {}
    for k, x in batch.items():
        x = np.asarray(x)
        if mesh is not None and mesh.size > 1:
            if x.shape[0] % mesh.size:
                raise ValueError(f"{k}: batch {x.shape[0]} does not split "
                                 f"over {mesh.size} ranks")
            n = x.shape[0] // mesh.size
            x = x[mesh.rank * n:(mesh.rank + 1) * n]
        out[k] = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return out


class Prefetcher:
    """Keeps the next ``depth`` device batches ready: ``next()`` returns
    step ``self.step``'s batch and advances; ``seek(step)`` drops what is
    buffered and restarts the stream there (a restore)."""

    def __init__(self, stream: SyntheticStream, mesh=None,
                 start_step: int = 0, depth: int = 2, device=None):
        self.stream = stream
        self.mesh = mesh
        self.device = device
        self.step = start_step
        self.depth = depth
        self._buf: Dict[int, dict] = {}
        self._lock = threading.Lock()

    def _fill(self, upto: int):
        for s in range(self.step, upto):
            if s not in self._buf:
                self._buf[s] = shard_batch(self.stream.batch_at(s),
                                           self.mesh, self.device)

    def next(self) -> dict:
        with self._lock:
            self._fill(self.step + self.depth)
            b = self._buf.pop(self.step)
            self.step += 1
            return b

    def seek(self, step: int):
        with self._lock:
            self._buf.clear()
            self.step = step

