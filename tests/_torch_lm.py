"""Helpers shared by the LM parity tests (``test_torch_ssm``,
``test_torch_xlstm``, ``test_torch_hymba``, ``test_torch_whisper``,
``test_torch_llava``): JAX ``init_params`` trees as
numpy with the zero- and one-initialised leaves perturbed, the configs of
both packages at SMOKE size in fp32, and left-padded token batches."""
from __future__ import annotations

import numpy as np

from repro.configs.base import get_smoke_config as jax_get_smoke_config
from repro_torch.configs.base import get_smoke_config

from _torch_parity import numpy_params

ONES = ("scale", "out_norm", "skip", "d_skip")       # init ones
ZEROS = ("a_log", "dt_bias", "conv_b")               # init zeros


def perturb(tree, rng, zeros=ZEROS):
    """Ones-initialised leaves -> 1 + 0.1 N(0, 1), zeros-initialised ones
    (``zeros``) -> 0.1 N(0, 1), so every product and sum they enter is
    exercised (the dense biases and the sLSTM's raw ``b`` are already
    noise: ``numpy_params``)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ONES and not isinstance(v, dict):
                out[k] = (1.0 + 0.1 * rng.normal(size=v.shape)).astype(
                    np.float32)
            elif k in zeros and not isinstance(v, dict):
                out[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
            else:
                out[k] = perturb(v, rng, zeros)
        return out
    return tree


def params_np(specs, seed: int = 3, zeros=ZEROS):
    """``numpy_params`` with the ones and ``zeros`` leaves perturbed (pass
    ``ZEROS + ("bias",)`` to perturb the LayerNorm biases too)."""
    return perturb(numpy_params(specs, seed), np.random.default_rng(seed + 7),
                   zeros)


def cfgs(arch: str, **kw):
    """(port, JAX) SMOKE configs in fp32: port ``chunked`` = JAX
    ``xla_flash``."""
    return (get_smoke_config(arch).replace(dtype="float32",
                                           attn_impl="chunked", **kw),
            jax_get_smoke_config(arch).replace(dtype="float32",
                                               attn_impl="xla_flash", **kw))


def tokens(lens, vocab: int, seed: int) -> np.ndarray:
    """Left-padded (token 0) prompts of these lengths, as the engine pads."""
    rng = np.random.default_rng(seed)
    S = max(lens)
    toks = np.zeros((len(lens), S), np.int32)
    for i, n in enumerate(lens):
        toks[i, S - n:] = rng.integers(1, vocab, size=n)
    return toks
