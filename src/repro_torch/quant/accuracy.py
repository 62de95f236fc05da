"""q8 accuracy gate: measure the port's int8 datapath against its float32
oracle (counterpart of ``repro.quant.accuracy``).

The q8 backends change the numerics, so they do not enter ``auto``
dispatch on speed alone: this harness measures the damage on the paper's
jet-tagging task and records it, and the written artifact
(``BENCH_quant_accuracy_torch.json``, the JAX package's schema) is what
opens the port's dispatch gate (``repro_torch.core.runtime
.quant_gate_open``). It measures the port's kernels (``cuda_fused_q8``,
``cuda_chain_q8``: JAX's ``Q8_BACKENDS`` under the port's names) against
``eager`` on the device it runs on; JAX's artifact measured JAX's Pallas
kernels and never opens the port's gate.

Protocol (JAX's): train the jet-tagging classifier (a short SGD run on the
synthetic stream, enough to open real logit margins; parity on an
untrained net is vacuous because near-tied logits flip argmax on noise),
then compare the class logits of every q8 backend with the oracle's on
held-out batches (``batch_at(10_000 + i)``):

* ``max_abs_logit_err`` / ``mean_abs_logit_err`` — logit error bounds,
* ``argmax_match`` — raw top-1 agreement over the whole eval set,
* ``argmax_match_confident`` — agreement over the examples whose float32
  top-2 logit gap is at least ``tie_eps`` (below it the oracle's own
  argmax is a coin flip under any perturbation); ties are counted
  (``ties``), never dropped silently,
* ``passed`` — confident parity 1.0 for every backend AND max logit error
  within ``--bound``.

Training is eager with autograd; every evaluation runs without it (the
kernels have no backward)::

    PYTHONPATH=src python -m repro_torch.quant.accuracy [--smoke] \\
        [--json BENCH_quant_accuracy_torch.json] [--bound 0.05] [--depth L] \\
        [--device cpu]

CSV: name,value,detail
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import gru as gru_core
from repro_torch.core.params import flatten, init_params, map_trees, unflatten
from repro_torch.core.runtime import QUANT_ACC_FILE
from repro_torch.data.pipeline import SyntheticStream, shard_batch
from repro_torch.models import gru_lm

Q8_BACKENDS = ("cuda_fused_q8", "cuda_chain_q8")
ORACLE = "eager"


def _train(mcfg, batch: int, steps: int, lr: float, seed: int = 0, *,
           device="cuda"):
    """Short SGD run on the synthetic jet stream (linear-teacher labels:
    learnable, so logit margins open within a few hundred steps), on
    ``eager``. Returns (params, last loss)."""
    dev = resolve_device(device)
    mcfg = mcfg.replace(gru=dataclasses.replace(mcfg.gru, backend=ORACLE))
    params = init_params(gru_lm.lm_specs(mcfg), seed, device=dev)
    params = {"head": params["head"],
              **{k: params[k] for k in ("cell", "cells") if k in params}}
    params = map_trees(lambda p: p.detach().requires_grad_(True), params)
    stream = SyntheticStream(mcfg, ShapeConfig(
        "quant_train", seq_len=mcfg.gru.seq_len, global_batch=batch,
        kind="train"))
    last = float("nan")
    for i in range(steps):
        b = shard_batch(stream.batch_at(i), device=dev)
        loss, _ = gru_lm.loss_fn(params, mcfg, b)
        flat = flatten(params)
        grads = torch.autograd.grad(loss, list(flat.values()))
        with torch.no_grad():
            params = unflatten(params, {
                k: (w - lr * g).requires_grad_(True)
                for (k, w), g in zip(flat.items(), grads)})
        last = float(loss.detach())
    return map_trees(lambda p: p.detach(), params), last


def _eval_logits(params, gcfg, xs) -> np.ndarray:
    """Class logits (B, C) under the datapath ``gcfg`` resolves to."""
    with torch.no_grad():
        return gru_core.gru_classify(params, xs, cfg=gcfg).cpu().numpy()


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"cuda: {torch.cuda.get_device_name(dev)}"
    return dev.type


def run(arch: str = "gru-jet", depth: int = None, hidden: int = None,
        train_steps: int = 300, train_batch: int = 64, lr: float = 0.05,
        eval_batches: int = 8, eval_batch: int = 64, bound: float = 0.05,
        tie_eps: float = 0.02, backends=Q8_BACKENDS,
        json_path: str = QUANT_ACC_FILE, csv: bool = True, *,
        device="cuda", return_params: bool = False):
    """Train, measure every backend of ``backends`` against ``eager`` and
    write the artifact to ``json_path``; returns it (with
    ``return_params``, also the trained params: ``(artifact, params)``)."""
    dev = resolve_device(device)
    mcfg = get_config(arch)
    gcfg = mcfg.gru
    if depth:
        gcfg = dataclasses.replace(gcfg, num_layers=depth)
    if hidden:
        gcfg = dataclasses.replace(gcfg, hidden_dim=hidden)
    mcfg = mcfg.replace(gru=gcfg)

    params, final_loss = _train(mcfg, train_batch, train_steps, lr,
                                device=dev)

    # held-out eval batches: steps the training never drew
    stream = SyntheticStream(mcfg, ShapeConfig(
        "quant_eval", seq_len=gcfg.seq_len, global_batch=eval_batch,
        kind="prefill"))
    feats = [shard_batch(stream.batch_at(10_000 + i), device=dev)["features"]
             for i in range(eval_batches)]

    f32_cfg = dataclasses.replace(gcfg, backend=ORACLE)
    oracle = [_eval_logits(params, f32_cfg, xs) for xs in feats]
    top2 = [np.sort(ref, axis=-1)[:, -2:] for ref in oracle]
    confident = [(t[:, 1] - t[:, 0]) >= tie_eps for t in top2]

    per_backend, all_pass = {}, True
    for name in backends:
        qcfg = dataclasses.replace(gcfg, backend=name)  # exact pin: legal
        errs, agree, agree_conf = [], [], []
        for xs, ref, conf in zip(feats, oracle, confident):
            got = _eval_logits(params, qcfg, xs)
            errs.append(np.abs(got - ref))
            same = got.argmax(-1) == ref.argmax(-1)
            agree.append(same)
            agree_conf.append(same[conf])
        err = np.concatenate([e.ravel() for e in errs])
        agree = np.concatenate(agree)
        agree_conf = np.concatenate(agree_conf)
        m = {"max_abs_logit_err": round(float(err.max()), 6),
             "mean_abs_logit_err": round(float(err.mean()), 6),
             "argmax_match": round(float(agree.mean()), 6),
             "argmax_match_confident": round(float(agree_conf.mean()), 6),
             "examples": int(agree.size),
             "ties": int(agree.size - agree_conf.size)}
        m["passed"] = (m["argmax_match_confident"] == 1.0
                       and m["max_abs_logit_err"] <= bound)
        all_pass = all_pass and m["passed"]
        per_backend[name] = m
        if csv:
            print(f"quant_acc_{name},{m['max_abs_logit_err']:.6f},"
                  f"argmax_match={m['argmax_match']:.4f};"
                  f"confident={m['argmax_match_confident']:.4f}"
                  f"({m['ties']}ties);"
                  f"mean={m['mean_abs_logit_err']:.6f}")

    out = {"bench": "gru_quant_accuracy", "schema": 1,
           "device": _device_name(dev), "arch": arch,
           "config": {"depth": gcfg.resolved_num_layers,
                      "hidden": gcfg.hidden_dim,
                      "input_dim": gcfg.input_dim,
                      "seq_len": gcfg.seq_len, "variant": gcfg.variant},
           "train_steps": train_steps, "final_loss": round(final_loss, 4),
           "bound": bound, "tie_eps": tie_eps,
           "backends": per_backend, "passed": all_pass}
    with open(json_path, "w") as f:
        json.dump(out, f, indent=2)
    if csv:
        print(f"quant_acc_passed,{int(all_pass)},"
              f"bound={bound};artifact={json_path}")
    return (out, params) if return_params else out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced run for CI (still writes the artifact)")
    ap.add_argument("--arch", default="gru-jet")
    ap.add_argument("--depth", type=int, default=None,
                    help="override stack depth (default: the arch's)")
    ap.add_argument("--hidden", type=int, default=None)
    ap.add_argument("--train-steps", type=int, default=None)
    ap.add_argument("--eval-batches", type=int, default=None)
    ap.add_argument("--bound", type=float, default=0.05,
                    help="max |logit error| allowed for passed=true")
    ap.add_argument("--tie-eps", type=float, default=0.02,
                    help="f32 top-2 logit gap under which an example "
                         "counts as a tie (reported, excluded from the "
                         "parity bar)")
    ap.add_argument("--json", default=QUANT_ACC_FILE)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    if args.smoke:
        run(arch=args.arch, depth=args.depth, hidden=args.hidden,
            train_steps=args.train_steps or 80, train_batch=32,
            eval_batches=args.eval_batches or 2, eval_batch=32,
            bound=args.bound, tie_eps=args.tie_eps, json_path=args.json,
            device=args.device)
    else:
        run(arch=args.arch, depth=args.depth, hidden=args.hidden,
            train_steps=args.train_steps or 300,
            eval_batches=args.eval_batches or 8,
            bound=args.bound, tie_eps=args.tie_eps, json_path=args.json,
            device=args.device)
