"""The port's selective SSM mixer (``repro_torch.models.ssm``, hymba's
parallel SSM heads) against JAX's ``repro.models.ssm`` on the CPU, at
hymba-1.5b's SMOKE size in fp32.

Same parameters (JAX ``init_params`` as numpy; ``a_log``, ``dt_bias``,
``conv_b`` and ``d_skip`` perturbed off their zero/one init), same inputs.
Tolerance: 1e-5 (rtol = atol), one layer of fp32 products and a scan in
other summation orders. The prompt tail of the conv is exact (a slice).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.core.params import flatten, init_params
from repro_torch.models import ssm

from _torch_lm import cfgs, params_np
from _torch_parity import close, to_jax, to_torch

TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = cfgs("hymba-1.5b")
    pn = params_np(jssm.ssm_specs(jcfg), seed=11)
    return cfg, jcfg, to_torch(pn), to_jax(pn)


def _x(B, S, D, seed):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


def test_dims_and_specs_are_jaxs(setup):
    cfg, jcfg, _, _ = setup
    assert ssm._dims(cfg) == jssm._dims(jcfg)
    mine = flatten(init_params(ssm.ssm_specs(cfg), 0, device="cpu"))
    theirs = flatten(to_torch(params_np(jssm.ssm_specs(jcfg))))
    assert list(mine) == list(theirs)
    for k in mine:
        assert mine[k].shape == theirs[k].shape, k
    # dt_rank 0 -> ceil(d_model / 16), at full width too
    from repro.configs.base import get_config as jget
    from repro_torch.configs.base import get_config
    assert ssm._dims(get_config("hymba-1.5b")) == \
        jssm._dims(jget("hymba-1.5b")) == (1600, 100, 16)


def test_causal_conv_matches_jax(setup):
    _, _, tp, jp = setup
    x = _x(2, 7, tp["conv"].shape[1], 1)
    close(ssm._causal_conv(torch.from_numpy(x), tp["conv"], tp["conv_b"]),
          jssm._causal_conv(jnp.asarray(x), jp["conv"], jp["conv_b"]), TOL)


@pytest.mark.parametrize("S", [1, 2, 3, 9])
def test_mixer_with_state_then_decode_matches_jax(setup, S):
    """``ssm_apply(return_state=True)`` at S < w - 1 (the tail zero-padded
    in front, both packages) and S >= w - 1, then three decode steps from
    the returned cache."""
    cfg, jcfg, tp, jp = setup
    x = _x(2, S, cfg.d_model, S)
    out, st = ssm.ssm_apply(tp, cfg, torch.from_numpy(x), return_state=True)
    jout, jst = jssm.ssm_apply(jp, jcfg, jnp.asarray(x), return_state=True)
    close(out, jout, TOL)
    w = cfg.ssm.conv_width
    assert tuple(st["conv_buf"].shape) == (2, w - 1, ssm._dims(cfg)[0])
    np.testing.assert_array_equal(st["conv_buf"].numpy(),
                                  np.asarray(jst["conv_buf"]))
    close(st["state"], jst["state"], TOL)
    assert st["state"].dtype == torch.float32
    for t in range(3):
        xt = _x(2, 1, cfg.d_model, 100 + t)
        y, st = ssm.ssm_decode_step(tp, cfg, torch.from_numpy(xt), st)
        jy, jst = jssm.ssm_decode_step(jp, jcfg, jnp.asarray(xt), jst)
        close(y, jy, TOL)
        close(st["state"], jst["state"], TOL)
        close(st["conv_buf"], jst["conv_buf"], TOL)


def test_mixer_without_state_equals_with_state(setup):
    cfg, _, tp, _ = setup
    x = torch.from_numpy(_x(2, 6, cfg.d_model, 5))
    assert torch.equal(ssm.ssm_apply(tp, cfg, x),
                       ssm.ssm_apply(tp, cfg, x, return_state=True)[0])


def test_decode_chain_equals_the_mixer(setup):
    """Decoding token by token from an empty cache gives the mixer's
    outputs (the recurrence and the conv ring are the same function)."""
    cfg, _, tp, _ = setup
    x = torch.from_numpy(_x(2, 6, cfg.d_model, 6))
    full = ssm.ssm_apply(tp, cfg, x)
    cache = init_params(ssm.ssm_cache_specs(cfg.replace(dtype="float32"), 2),
                        device="cpu")
    for t in range(6):
        y, cache = ssm.ssm_decode_step(tp, cfg, x[:, t:t + 1], cache)
        close(y[:, 0], full[:, t], TOL)


def test_cache_specs_are_jaxs():
    cfg, jcfg = cfgs("hymba-1.5b")
    for lead in (0, 3):
        mine = ssm.ssm_cache_specs(cfg, 4, layers_axis=lead)
        theirs = jssm.ssm_cache_specs(jcfg, 4, layers_axis=lead)
        for k in ("conv_buf", "state"):
            assert tuple(mine[k].shape) == tuple(theirs[k].shape)
            assert mine[k].dtype == theirs[k].dtype
