"""The port's posterior ensemble for every sampler, with and without
classifier-free guidance, and its dataset drivers, against JAX's.

The JAX draws are injected into the port: for ancestral and DDIM the
prior from split(key)[1] and the per-step noise from split(key)[0]'s
step keys (ertdx/diffusion.py:229-232, 297-300); for pd and DPM++ the raw
prior normal(key) (:375, :468), which the port tempers itself. The
dataset drivers fold the key per batch (fold_in(key, i)) and the mixture
per member; the port takes the same draws per batch and per member.
Tolerance 1e-4, as the DDIM ensemble test.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx import configs as jconfigs
from ertdx import diffusion as jdiff
from ertdx import sample as jsample
from ertdx import train as jtrain
from ertdx import transforms as jtransforms
from ertdx.configs import SampleConfig as JaxSampleConfig
from ertdx.models import build_model as jbuild_model
from ertdx_torch import configs, diffusion, sample, train, transforms
from ertdx_torch.configs import SampleConfig
from ertdx_torch.params import ParameterSpace
from torch_parity_common import make_pair, t32

B, R, P, T = 2, 3, 29, 20
STEPS = {"ancestral": T, "ddim": 5, "pd": 4, "dpmpp": 6}
GUIDANCE = {"unguided": {},
            "guided": dict(guidance_scale=2.0),
            # round(2.5) = 2 and round(12.5) = 12: Python's half-to-even
            "interval": dict(guidance_scale=1.7,
                             guidance_interval=(0.125, 0.625))}
ROOT = Path(__file__).resolve().parents[1]
GUIDED = ROOT / "docs/results/flagship_fullscale/condunet-vcfg_s42/" \
    "students_guided"


def jax_draws(key, sampler, shape, steps):
    """The port's injected draws for JAX's `sampler` run from `key`."""
    if sampler in ("pd", "dpmpp"):
        return {"x_T": t32(jax.random.normal(key, shape))}
    k, init = jax.random.split(key)
    noise = jnp.stack([jax.random.normal(sk, shape)
                       for sk in jax.random.split(k, steps)])
    return {"x_T": t32(jax.random.normal(init, shape)),
            "noise": t32(noise)}


def sample_cfgs(sampler, mode, **extra):
    kw = dict(sampler=sampler, ddim_steps=STEPS["ddim"], ddim_eta=0.5,
              pd_steps=STEPS["pd"], dpmpp_steps=STEPS["dpmpp"],
              temperature=0.8, **GUIDANCE[mode], **extra)
    return JaxSampleConfig(**kw), SampleConfig(**kw)


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for param in ("eps", "v"):
        out[param] = make_pair(num_blocks=1, seed=31, uncond_prob=0.1,
                               parameterization=param, scale=0.1)
    return out


def _conditions(n, seed=5):
    return np.random.default_rng(seed).normal(size=(n, 96, 4)).astype(
        np.float32)


@pytest.mark.parametrize("mode", list(GUIDANCE))
@pytest.mark.parametrize("param", ["eps", "v"])
@pytest.mark.parametrize("sampler", ["ancestral", "ddim", "pd", "dpmpp"])
def test_posterior_ensemble_matches_jax(pairs, sampler, param, mode):
    fm, params, tm = pairs[param]
    cond = _conditions(B)
    jcfg, tcfg = sample_cfgs(sampler, mode)
    key = jax.random.key(17)
    want = jsample.posterior_ensemble(
        fm, params, jnp.asarray(cond), jdiff.get_diffusion_schedule(T), key,
        n_realizations=R, scfg=jcfg)
    got = sample.posterior_ensemble(
        tm, t32(cond), diffusion.get_diffusion_schedule(T), R, tcfg,
        device="cpu", **jax_draws(key, sampler, (R * B, P), STEPS[sampler]))
    assert got.shape == (R, B, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_default_sampler_is_ancestral(pairs):
    """Without an scfg both packages run the ancestral chain over all T
    steps (ertdx/sample.py:337, ertdx/configs.py:172)."""
    fm, params, tm = pairs["eps"]
    cond = _conditions(B, seed=6)
    key = jax.random.key(19)
    want = jsample.posterior_ensemble(fm, params, jnp.asarray(cond),
                                      jdiff.get_diffusion_schedule(T), key,
                                      n_realizations=R)
    got = sample.posterior_ensemble(
        tm, t32(cond), diffusion.get_diffusion_schedule(T), R, device="cpu",
        **jax_draws(key, "ancestral", (R * B, P), T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_guidance_interval_needs_guidance(pairs):
    """An interval with guidance_scale == 1 has nothing to schedule: a
    ValueError, as in JAX, not a silent unguided run."""
    _, _, tm = pairs["eps"]
    with pytest.raises(ValueError, match="nothing to schedule"):
        sample.posterior_ensemble(
            tm, torch.zeros(1, 96, 4), diffusion.get_diffusion_schedule(T),
            2, SampleConfig(sampler="pd", guidance_interval=(0.0, 0.5)),
            device="cpu")


@pytest.mark.parametrize("sampler,interval,calls", [
    ("ancestral", (0.125, 0.625), 20 + 10),    # t in [2, 12) guided
    ("ancestral", (0.0, 1.0), 40),
    ("pd", (0.5, 1.0), 4 + 2),                 # pd_grid(20, 4) = 4 9 14 19
    ("dpmpp", (0.0, 0.025), 6),      # round(0.5) = 0: no step guided
    ("dpmpp", (0.0, 0.075), 6 + 2),  # round(1.5) = 2: t = 1, 0 guided
])
def test_interval_skips_the_null_pass(pairs, monkeypatch, sampler, interval,
                                      calls):
    _, _, tm = pairs["eps"]
    count = []
    real = type(tm).denoise_ensemble

    def counted(self, *args, **kw):
        count.append(1)
        return real(self, *args, **kw)

    monkeypatch.setattr(type(tm), "denoise_ensemble", counted)
    _, tcfg = sample_cfgs(sampler, "guided", guidance_interval=interval)
    sample.posterior_ensemble(tm, torch.zeros(1, 96, 4),
                              diffusion.get_diffusion_schedule(T), 2, tcfg,
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
    assert len(count) == calls


def test_step_budgets_clamp_to_t(pairs):
    """A step budget above T means the full chain, in every sampler."""
    fm, params, tm = pairs["eps"]
    cond = _conditions(1, seed=8)
    small_t = 6
    for sampler in ("ddim", "pd", "dpmpp"):
        kw = dict(sampler=sampler, ddim_steps=50, pd_steps=50,
                  dpmpp_steps=50)
        key = jax.random.key(23)
        want = jsample.posterior_ensemble(
            fm, params, jnp.asarray(cond),
            jdiff.get_diffusion_schedule(small_t), key, n_realizations=2,
            scfg=JaxSampleConfig(**kw))
        got = sample.posterior_ensemble(
            tm, t32(cond), diffusion.get_diffusion_schedule(small_t), 2,
            SampleConfig(**kw), device="cpu",
            **jax_draws(key, sampler, (2, P), small_t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


def test_truncated_ancestral_matches_jax(pairs):
    fm, params, tm = pairs["v"]
    cond = _conditions(B, seed=9)
    key = jax.random.key(29)
    want = jsample.posterior_ensemble(
        fm, params, jnp.asarray(cond), jdiff.get_diffusion_schedule(T), key,
        n_realizations=R, truncate_steps=7)
    got = sample.posterior_ensemble(
        tm, t32(cond), diffusion.get_diffusion_schedule(T), R,
        truncate_steps=7, device="cpu",
        **jax_draws(key, "ancestral", (R * B, P), 7))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def _scalers():
    space = ParameterSpace()
    lo, hi = space.lo, space.hi
    data = np.stack([lo - 0.05 * (hi - lo), hi + 0.05 * (hi - lo)])
    return transforms.MinMaxScaler.fit(data), \
        jtransforms.MinMaxScaler.fit(data)


@pytest.mark.parametrize("device_inverse", [True, False])
def test_posterior_over_dataset_matches_jax(pairs, device_inverse):
    """5 conditions in batches of 2: a ragged last batch padded by
    repeating its last condition, then sliced off."""
    fm, params, tm = pairs["v"]
    n, bs, r = 5, 2, 3
    conds = _conditions(n, seed=10)
    ts, js = _scalers()
    jcfg, tcfg = sample_cfgs("pd", "guided")
    key = jax.random.key(31)
    want_phys, want_mask = jsample.posterior_over_dataset(
        fm, params, conds, jdiff.get_diffusion_schedule(T), key, js,
        n_realizations=r, batch_size=bs, scfg=jcfg,
        device_inverse=device_inverse)
    draws = [jax_draws(jax.random.fold_in(key, i), "pd", (r * bs, P), 4)
             for i in range(3)]
    phys, mask = sample.posterior_over_dataset(
        tm, conds, diffusion.get_diffusion_schedule(T), ts,
        n_realizations=r, batch_size=bs, scfg=tcfg,
        device_inverse=device_inverse, draws=draws, device="cpu")
    assert phys.shape == (r, n, P) and mask.shape == (r, n)
    np.testing.assert_allclose(phys, np.asarray(want_phys), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want_phys).max()))
    np.testing.assert_array_equal(mask, np.asarray(want_mask))


def test_posterior_over_dataset_mixture_matches_jax():
    """K = 2 members and an odd budget: 3 + 2 realizations, member i's
    batches drawn from fold_in(fold_in(key, i), batch)."""
    members = [make_pair(num_blocks=1, seed=s, scale=0.1) for s in (41, 42)]
    n, bs, r = 3, 2, 5
    conds = _conditions(n, seed=11)
    ts, js = _scalers()
    jcfg, tcfg = sample_cfgs("ddim", "unguided")
    key = jax.random.key(37)
    want_phys, want_mask = jsample.posterior_over_dataset_mixture(
        [(fm, params) for fm, params, _ in members], conds,
        jdiff.get_diffusion_schedule(T), key, js, n_realizations=r,
        batch_size=bs, scfg=jcfg)
    shares = (3, 2)
    draws = [[jax_draws(jax.random.fold_in(jax.random.fold_in(key, i), bi),
                        "ddim", (share * bs, P), STEPS["ddim"])
              for bi in range(2)] for i, share in enumerate(shares)]
    phys, mask = sample.posterior_over_dataset_mixture(
        [tm for _, _, tm in members], conds,
        diffusion.get_diffusion_schedule(T), ts, n_realizations=r,
        batch_size=bs, scfg=tcfg, draws=draws, device="cpu")
    assert phys.shape == (r, n, P)
    np.testing.assert_allclose(phys, np.asarray(want_phys), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want_phys).max()))
    np.testing.assert_array_equal(mask, np.asarray(want_mask))
    with pytest.raises(ValueError, match="empty"):
        sample.posterior_over_dataset_mixture([], conds, None, ts)


def test_guided_student_matches_jax():
    """The committed guided student (v-model, uncond_prob 0.1) restores in
    both packages from its own config echo, and pd-1 with guidance 1.5
    gives the same draws on 1 condition x 4 members."""
    state, meta, _ = train.load_best_model(str(GUIDED),
                                           configs.FULL_CONDITIONAL,
                                           device="cpu")
    model = state.model
    assert model.uncond_prob == 0.1 and model.parameterization == "v"
    assert meta["target_steps"] == 1
    jstate, _, _ = jtrain.load_best_model(str(GUIDED),
                                          jconfigs.FULL_CONDITIONAL)
    saved = jconfigs.experiment_from_dict(jtrain.saved_config(str(GUIDED)))
    fm = jbuild_model(saved.model)
    cond = np.random.default_rng(12).uniform(size=(1, 4693, 14)).astype(
        np.float32)
    kw = dict(sampler="pd", pd_steps=1, guidance_scale=1.5)
    key = jax.random.key(43)
    big_t = saved.diffusion.T
    want = jsample.posterior_ensemble(
        fm, jstate.params, jnp.asarray(cond),
        jdiff.get_diffusion_schedule(big_t), key, n_realizations=4,
        scfg=JaxSampleConfig(**kw))
    with torch.no_grad():
        got = sample.posterior_ensemble(
            model, t32(cond), diffusion.get_diffusion_schedule(big_t), 4,
            SampleConfig(**kw), device="cpu",
            **jax_draws(key, "pd", (4, P), 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_training_a_guided_model_moves_its_null_context(tmp_path):
    """The refusal is lifted: `train` now trains a guided model with
    condition dropout (ROADMAP.md's former queue 1 item 1), and its learned
    null context moves (from the third step on: the head and the output
    and AdaLN projections start at zero). Step parity with JAX's dropout
    is in tests/test_torch_train.py."""
    from ertdx_torch import data
    from ertdx_torch.doe import SurrogateDataGenerator
    from ertdx_torch.models import build_model

    n = 24
    params_phys = SurrogateDataGenerator(seed=1).generate_training_samples(
        n, "lhs")
    ert = np.random.default_rng(1).normal(50.0, 10.0, size=(n, 40, 4))
    ds = data.prepare_dataset(params_phys[..., None], ert)
    cfg = dataclasses.replace(
        configs.FULL_CONDITIONAL,
        diffusion=configs.DiffusionConfig(T=20),
        model=dataclasses.replace(
            configs.FULL_CONDITIONAL.model, uncond_prob=0.5, hidden_dim=16,
            cond_length=40, cond_channels=4, base_width=8, depth=2,
            num_heads=2, num_blocks=1),
        train=dataclasses.replace(configs.FULL_CONDITIONAL.train,
                                  num_epochs=2, batch_size=8, lr=1e-2))
    res = train.train(cfg, ds, checkpoint_dir=str(tmp_path), device="cpu")
    init = build_model(cfg.model, "cpu", generator=torch.Generator()
                       .manual_seed(train._seed(cfg.train.seed, 0)))
    assert np.isfinite(res.train_history).all()
    for name in ("null_token", "null_vec"):
        moved = getattr(res.state.model, name) - getattr(init, name)
        assert float(moved.detach().abs().max()) > 1e-3, name
