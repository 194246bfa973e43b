"""The port's DDIM posterior ensemble and inverse pipeline against JAX's.

JAX's own prior draw (jax.random.split(key)[1], as ertdx/diffusion.py
draws it) and, for eta > 0, its per-step draws are injected into the
port, so both packages run the same function on the same numbers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx import diffusion as jdiff
from ertdx import sample as jsample
from ertdx import transforms as jtransforms
from ertdx.configs import SampleConfig as JaxSampleConfig
from ertdx_torch import diffusion, sample, transforms
from ertdx_torch.configs import SampleConfig
from ertdx_torch.params import ParameterSpace
from torch_parity_common import make_pair, t32

B, R, P, T, STEPS = 2, 8, 29, 20, 5


def _jax_draws(key, eta):
    """The prior draw and per-step noise jax's sample_ddim makes."""
    key, init = jax.random.split(key)
    x_t = jax.random.normal(init, (R * B, P))
    step_keys = jax.random.split(key, STEPS)
    noise = jnp.stack([jax.random.normal(k, (R * B, P)) for k in step_keys])
    return np.asarray(x_t), np.asarray(noise)


@pytest.mark.parametrize("eta,temperature,param", [
    (0.0, 1.0, "eps"),
    (0.5, 0.7, "eps"),
    (1.0, tuple(np.linspace(0.5, 1.5, P).tolist()), "eps"),
    (0.0, 1.0, "v"),
])
def test_posterior_ensemble_matches_jax(eta, temperature, param):
    fm, params, tm = make_pair(num_blocks=2, seed=21)
    fm = fm.clone(parameterization=param)
    tm.parameterization = param
    cond = np.random.default_rng(5).normal(size=(B, 96, 4)).astype(
        np.float32)
    key = jax.random.key(3)
    jcfg = JaxSampleConfig(sampler="ddim", ddim_steps=STEPS, ddim_eta=eta,
                           temperature=temperature, uncertainty_samples=R)
    want = jsample.posterior_ensemble(
        fm, params, jnp.asarray(cond), jdiff.get_diffusion_schedule(T), key,
        n_realizations=R, scfg=jcfg)
    x_t, noise = _jax_draws(key, eta)
    scfg = SampleConfig(sampler="ddim", ddim_steps=STEPS, ddim_eta=eta,
                        temperature=temperature, uncertainty_samples=R)
    got = sample.posterior_ensemble(
        tm, t32(cond), diffusion.get_diffusion_schedule(T), R, scfg,
        x_T=t32(x_t), noise=t32(noise) if eta else None, device="cpu")
    assert got.shape == (R, B, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("t_total,n", [(500, 50), (20, 5), (500, 200),
                                       (10, 10), (7, 1), (1000, 3)])
def test_ddim_timesteps_match_jax(t_total, n):
    np.testing.assert_array_equal(diffusion.ddim_timesteps(t_total,
                                                           n).numpy(),
                                  np.asarray(jdiff.ddim_timesteps(t_total,
                                                                  n)))


@pytest.mark.parametrize("kind", ["linear", "cosine"])
def test_schedule_matches_jax(kind):
    got = diffusion.get_diffusion_schedule(500, kind=kind)
    want = jdiff.get_diffusion_schedule(500, kind=kind)
    # cosine betas are 1 - (ratio of float32 cosines): their absolute
    # error is a few ulp of 1.0 (1.2e-7 each), whatever their size
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                   atol=5e-7)


def test_eps_from_v_matches_jax():
    rng = np.random.default_rng(0)
    v, x = (rng.normal(size=(4, 3)).astype(np.float32) for _ in range(2))
    ab = rng.uniform(0.01, 0.99, size=(4, 1)).astype(np.float32)
    np.testing.assert_allclose(
        diffusion.eps_from_v(t32(v), t32(x), t32(ab)).numpy(),
        np.asarray(jdiff.eps_from_v(*map(jnp.asarray, (v, x, ab)))),
        rtol=1e-6, atol=1e-6)


def _scaler_pair(rng):
    data = rng.uniform(-3, 5, size=(40, P))
    return (transforms.MinMaxScaler.fit(data),
            jtransforms.MinMaxScaler.fit(data))


def test_inverse_pipeline_and_mask_match_jax():
    rng = np.random.default_rng(1)
    space = ParameterSpace()
    lo, hi = space.lo, space.hi
    # a scaler over the physical box, widened so some draws fall outside
    data = np.stack([lo - 0.05 * (hi - lo), hi + 0.05 * (hi - lo)])
    ts, js = (transforms.MinMaxScaler.fit(data),
              jtransforms.MinMaxScaler.fit(data))
    u = (1.5 * rng.normal(size=(6, 5, P))).astype(np.float32)
    phys, mask = sample.inverse_pipeline(t32(u), ts, space=space)
    jphys, jmask = jsample.inverse_pipeline(jnp.asarray(u), js)
    np.testing.assert_allclose(phys, jphys, rtol=1e-5)
    np.testing.assert_array_equal(mask, jmask)
    assert 0 < mask.mean() < 1
    dphys, dmask = sample.device_inverse(t32(u), ts, space.plims)
    np.testing.assert_allclose(dphys.numpy(), phys, rtol=1e-6)
    np.testing.assert_array_equal(dmask.numpy(), mask)
    kept = sample.filter_valid(phys, mask)
    assert len(kept) == int(mask.any(axis=1).sum())
    assert sum(k.shape[0] for k in kept) == int(mask.sum())


def test_transforms_match_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.1, 1.1, size=(7, P))
    np.testing.assert_allclose(
        transforms.transform_to_unconstrained(torch.from_numpy(x)).numpy(),
        jtransforms.transform_to_unconstrained(x), rtol=1e-12)
    np.testing.assert_allclose(
        transforms.transform_to_unconstrained(x, 2.0, 5.0),
        jtransforms.transform_to_unconstrained(x, 2.0, 5.0), rtol=1e-12)
    u = 40.0 * rng.normal(size=(7, P))
    np.testing.assert_allclose(transforms.inverse_transform(u, 1.0, 3.0),
                               jtransforms.inverse_transform(u, 1.0, 3.0))
    np.testing.assert_allclose(
        transforms.inverse_transform(torch.from_numpy(u)).numpy(),
        jtransforms.inverse_transform(u), rtol=1e-12, atol=1e-300)
    ts, js = _scaler_pair(rng)
    y = rng.normal(size=(9, P))
    np.testing.assert_allclose(ts.transform(y), js.transform(y))
    np.testing.assert_allclose(ts.inverse(torch.from_numpy(y)).numpy(),
                               js.inverse(y), rtol=1e-12)
    limits = ParameterSpace().plims
    pm = rng.uniform(limits[:, 0] * 0.9, limits[:, 1] * 1.1, size=(12, P))
    np.testing.assert_array_equal(transforms.param_bounds_mask(pm, limits),
                                  jtransforms.param_bounds_mask(pm, limits))
    got = transforms.check_param_bounds(pm, limits, verbose=False)
    want = jtransforms.check_param_bounds(pm, limits, verbose=False)
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got, want)


def test_sampler_refusals():
    """The configurations JAX refuses raise the same ValueError in the
    port (ertdx/sample.py:104-174): an unknown sampler, truncate_steps
    off the ancestral chain, guidance on a model without the null
    context, a bad guidance interval, an interval with guidance_scale 1;
    and a temperature of the wrong length."""
    fm, params, tm = make_pair(num_blocks=1)
    sch = diffusion.get_diffusion_schedule(T)
    jsch = jdiff.get_diffusion_schedule(T)
    cond = np.zeros((1, 96, 4), np.float32)
    cases = [(dict(sampler="euler"), None, "unknown sampler"),
             (dict(sampler="ddim"), 5, "truncate_steps"),
             (dict(sampler="pd", guidance_scale=2.0), None, "uncond_prob"),
             (dict(sampler="ddim", guidance_interval=(0.2, 0.6)), None,
              "nothing to schedule")]
    for kw, trunc, match in cases:
        with pytest.raises(ValueError, match=match):
            jsample.posterior_ensemble(fm, params, jnp.asarray(cond), jsch,
                                       jax.random.key(0), 2,
                                       JaxSampleConfig(**kw),
                                       truncate_steps=trunc)
        with pytest.raises(ValueError, match=match):
            sample.posterior_ensemble(tm, t32(cond), sch, 2,
                                      SampleConfig(**kw),
                                      truncate_steps=trunc, device="cpu")
    gfm, gparams, gtm = make_pair(num_blocks=1, uncond_prob=0.1)
    for interval in ((0.5, 0.5), (-0.1, 0.5), (0.2, 1.5)):
        kw = dict(sampler="ddim", guidance_scale=2.0,
                  guidance_interval=interval)
        with pytest.raises(ValueError, match="guidance_interval"):
            jsample.posterior_ensemble(gfm, gparams, jnp.asarray(cond),
                                       jsch, jax.random.key(0), 2,
                                       JaxSampleConfig(**kw))
        with pytest.raises(ValueError, match="guidance_interval"):
            sample.posterior_ensemble(gtm, t32(cond), sch, 2,
                                      SampleConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        sample.posterior_ensemble(
            tm, t32(cond), sch, 2, SampleConfig(sampler="ddim",
                                                temperature=(1.0, 2.0)),
            device="cpu")


def test_posterior_ensemble_needs_a_card_or_cpu(monkeypatch):
    _, _, tm = make_pair(num_blocks=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample.posterior_ensemble(tm, torch.zeros(1, 96, 4),
                                  diffusion.get_diffusion_schedule(T), 2)


def test_generator_draws_are_reproducible():
    _, _, tm = make_pair(num_blocks=1)
    sch = diffusion.get_diffusion_schedule(T)
    cond = torch.zeros(1, 96, 4)
    scfg = SampleConfig(sampler="ddim", ddim_steps=3, ddim_eta=1.0)
    a, b = (sample.posterior_ensemble(
        tm, cond, sch, 3, scfg, generator=torch.Generator().manual_seed(9),
        device="cpu") for _ in range(2))
    assert torch.equal(a, b)
    assert torch.isfinite(a).all()
