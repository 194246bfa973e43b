"""The port's ancestral, pd and DPM-Solver++(2M) samplers and their grids
against the JAX package's.

A fixed toy denoiser, written once for each framework, drives both
samplers; JAX's own draws (the prior, and the per-step noise of the
ancestral chain) are injected into the port, so both run the same
function on the same numbers. Tolerance 1e-5 (float32 chains of up to
T = 60 steps); the grids are compared exactly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx import diffusion as jdiff
from ertdx_torch import diffusion
from torch_parity_common import t32

N, P = 6, 5
TEMPS = [1.0, 0.6, tuple(np.linspace(0.5, 1.5, P).tolist())]


def _denoisers():
    """The same toy eps-predictor in JAX and in torch."""
    w = np.linspace(-0.4, 0.4, P).astype(np.float32)

    def jfn(x, t):
        return 0.3 * x + jnp.sin(x * jnp.asarray(w)) * (
            t[:, None].astype(jnp.float32) * 0.01)

    def tfn(x, t):
        return 0.3 * x + torch.sin(x * t32(w)) * (
            t[:, None].to(torch.float32) * 0.01)

    return jfn, tfn


def _schedules(big_t, kind="linear"):
    """JAX's schedule and the port's holding the same float32 numbers."""
    js = jdiff.get_diffusion_schedule(big_t, kind=kind)
    ts = diffusion.DiffusionSchedule(*(t32(np.asarray(a)) for a in js))
    return js, ts


def _temp(temperature):
    return (jnp.asarray(temperature, jnp.float32),
            torch.as_tensor(temperature, dtype=torch.float32)
            if isinstance(temperature, tuple) else temperature)


@pytest.mark.parametrize("big_t,truncate", [(40, None), (60, 25), (1, None)])
@pytest.mark.parametrize("temperature", TEMPS)
def test_sample_ancestral_matches_jax(big_t, truncate, temperature):
    jfn, tfn = _denoisers()
    js, ts = _schedules(big_t)
    jt, tt = _temp(temperature)
    key = jax.random.key(7)
    want = jdiff.sample_ancestral(jfn, key, (N, P), js,
                                  truncate_steps=truncate, temperature=jt)
    steps = truncate or big_t
    k, init = jax.random.split(key)
    x_t = jax.random.normal(init, (N, P))
    noise = jnp.stack([jax.random.normal(sk, (N, P))
                       for sk in jax.random.split(k, steps)])
    got = diffusion.sample_ancestral(tfn, (N, P), ts, truncate, tt,
                                     x_T=t32(x_t), noise=t32(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_sample_ancestral_refuses_truncation_above_t():
    _, tfn = _denoisers()
    with pytest.raises(ValueError, match="truncate_steps"):
        diffusion.sample_ancestral(tfn, (N, P), _schedules(10)[1], 11)


@pytest.mark.parametrize("big_t,steps", [(50, 4), (50, 1), (64, 8),
                                         (20, 20)])
@pytest.mark.parametrize("temperature", TEMPS)
def test_sample_pd_matches_jax(big_t, steps, temperature):
    jfn, tfn = _denoisers()
    js, ts = _schedules(big_t)
    jt, tt = _temp(temperature)
    key = jax.random.key(11)
    want = jdiff.sample_pd(jfn, key, (N, P), js, steps, temperature=jt)
    x_t = jax.random.normal(key, (N, P))     # the raw prior draw
    got = diffusion.sample_pd(tfn, (N, P), ts, steps, tt, x_T=t32(x_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("big_t,steps,kind", [(60, 15, "linear"),
                                              (60, 2, "linear"),
                                              (60, 1, "linear"),
                                              (8, 8, "linear"),
                                              (500, 40, "linear"),
                                              (40, 12, "cosine")])
@pytest.mark.parametrize("temperature", TEMPS)
def test_sample_dpmpp_2m_matches_jax(big_t, steps, kind, temperature):
    jfn, tfn = _denoisers()
    js, ts = _schedules(big_t, kind)
    jt, tt = _temp(temperature)
    key = jax.random.key(13)
    want = jdiff.sample_dpmpp_2m(jfn, key, (N, P), js, steps,
                                 temperature=jt)
    x_t = jax.random.normal(key, (N, P))
    got = diffusion.sample_dpmpp_2m(tfn, (N, P), ts, steps, tt,
                                    x_T=t32(x_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_dpmpp_guards_a_duplicate_grid_point():
    """At a coarse grid nearest-t rounding repeats an index: the step is an
    identity (h = 0) and the next one drops to first order, in both."""
    jfn, tfn = _denoisers()
    js, ts = _schedules(10)
    grid = np.asarray(jdiff.lambda_timesteps(js, 10))
    assert len(set(grid.tolist())) < 10          # the case under test
    key = jax.random.key(3)
    want = jdiff.sample_dpmpp_2m(jfn, key, (N, P), js, 10)
    got = diffusion.sample_dpmpp_2m(tfn, (N, P), ts, 10,
                                    x_T=t32(jax.random.normal(key, (N, P))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("big_t", [1, 7, 64, 100, 500, 1000])
def test_pd_grid_matches_jax_and_nests_under_halving(big_t):
    every = range(1, big_t + 1)
    for n in every if big_t <= 100 else list(every[:64]) + list(
            every[big_t // 3::max(1, big_t // 40)]):
        got = diffusion.pd_grid(big_t, n)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jdiff.pd_grid(big_t, n)))
        if 2 * n <= big_t:
            fine = diffusion.pd_grid(big_t, 2 * n)
            assert torch.equal(fine[1::2], got)
    assert torch.equal(diffusion.pd_grid(big_t, big_t),
                       torch.arange(big_t))
    for bad in (0, big_t + 1):
        with pytest.raises(ValueError):
            diffusion.pd_grid(big_t, bad)


@pytest.mark.parametrize("big_t,kind", [(500, "linear"), (50, "linear"),
                                        (1000, "linear"), (100, "cosine"),
                                        (500, "cosine")])
def test_lambda_timesteps_match_jax(big_t, kind):
    js, ts = _schedules(big_t, kind)
    for n in (1, 2, 3, 5, 15, 16, 40, big_t // 2, big_t):
        np.testing.assert_array_equal(
            diffusion.lambda_timesteps(ts, n).numpy(),
            np.asarray(jdiff.lambda_timesteps(js, n)))
    with pytest.raises(ValueError):
        diffusion.lambda_timesteps(ts, big_t + 1)


def test_samplers_draw_from_a_generator():
    _, tfn = _denoisers()
    ts = _schedules(20)[1]
    for fn in (lambda g: diffusion.sample_ancestral(tfn, (N, P), ts,
                                                    generator=g),
               lambda g: diffusion.sample_pd(tfn, (N, P), ts, 2,
                                             generator=g),
               lambda g: diffusion.sample_dpmpp_2m(tfn, (N, P), ts, 5,
                                                   generator=g)):
        a, b = (fn(torch.Generator().manual_seed(4)) for _ in range(2))
        assert torch.equal(a, b) and torch.isfinite(a).all()
