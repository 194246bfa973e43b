"""The port's calibration against the JAX package's.

The selection functions get the same records and must pick the same
values. The sweeps run both packages on one CondUNet (torch_parity_common)
with JAX's own draws injected into the port: JAX samples every arm from
one key, batch i from fold_in(key, i), and the port takes those prior
and per-step draws as its per-batch `draws`."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx import calibrate as jcal
from ertdx import diffusion as jdiff
from ertdx import transforms as jtransforms
from ertdx.configs import SampleConfig as JaxSampleConfig
from ertdx_torch import calibrate as cal
from ertdx_torch import diffusion, transforms
from ertdx_torch.configs import SampleConfig
from ertdx_torch.doe import SurrogateDataGenerator
from torch_parity_common import make_pair, t32

N, R, P, T, STEPS, BS = 6, 8, 29, 20, 5, 4
KEYS = ("accuracy", "precision", "goodness", "valid_fraction",
        "ensemble_sd_mean")


def _records(seed, temps):
    rng = np.random.default_rng(seed)
    recs = {}
    for t in temps:
        pp = {k: rng.uniform(size=P).round(2).tolist()
              for k in ("accuracy", "precision", "goodness")}
        recs[str(float(t))] = {k: round(float(rng.uniform()), 2)
                               for k in KEYS} | {"per_parameter": pp}
    return recs


@pytest.mark.parametrize("objective", ["goodness", "accuracy", "precision"])
@pytest.mark.parametrize("rule", [dict(), dict(tol=0.05),
                                  dict(target=0.5), dict(target=2.0)])
def test_pick_temperature_per_param_matches_jax(objective, rule):
    recs = _records(1, (2.0, 1.0, 3.0, 1.5))
    recs["vector"] = {"temperature": [1.0] * P}
    np.testing.assert_array_equal(
        cal.pick_temperature_per_param(recs, objective, **rule),
        jcal.pick_temperature_per_param(recs, objective, **rule))


def _grid_records(seed, gs, ts, nan_at=()):
    rng = np.random.default_rng(seed)
    recs = {}
    for g in gs:
        for t in ts:
            rec = {k: float(rng.integers(0, 3)) for k in KEYS}
            if (g, t) in nan_at:
                rec = {k: float("nan") for k in KEYS}
            recs[f"g{float(g)}_T{float(t)}"] = rec
    return recs


@pytest.mark.parametrize("seed", range(4))
def test_pick_from_records_matches_jax(seed):
    recs = _grid_records(seed, (0.5, 1.5, 1.0, 0.7), (3.0, 1.5, 1.0),
                         nan_at={(1.0, 1.0)})
    for objective in ("goodness", "accuracy", "precision"):
        assert cal.pick_from_records(recs, objective) == \
            jcal.pick_from_records(recs, objective)
    for key in ("g0.7_T1.5", "g1.0_T3.0", "g12.5_T0.25"):
        assert cal._parse_grid_key(key) == jcal._parse_grid_key(key)


def _raises_alike(fn_port, fn_jax):
    errs = []
    for fn in (fn_port, fn_jax):
        with pytest.raises(ValueError) as e:
            fn()
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_selection_refusals_match_jax():
    recs = _grid_records(0, (1.0,), (1.0, 2.0), nan_at={(1.0, 1.0),
                                                        (1.0, 2.0)})
    _raises_alike(lambda: cal.pick_from_records(recs, "goodness"),
                  lambda: jcal.pick_from_records(recs, "goodness"))
    _raises_alike(lambda: cal.pick_from_records(recs, "sharpness"),
                  lambda: jcal.pick_from_records(recs, "sharpness"))
    trecs = _records(2, (1.0, 2.0))
    for r in trecs.values():
        r["per_parameter"]["goodness"][3] = float("nan")
    _raises_alike(lambda: cal.pick_temperature_per_param(trecs, "goodness"),
                  lambda: jcal.pick_temperature_per_param(trecs, "goodness"))
    del trecs["1.0"]["per_parameter"]
    _raises_alike(lambda: cal.pick_temperature_per_param(trecs, "goodness"),
                  lambda: jcal.pick_temperature_per_param(trecs, "goodness"))
    _raises_alike(lambda: cal.pick_temperature_per_param({}, "goodness"),
                  lambda: jcal.pick_temperature_per_param({}, "goodness"))


def _fake_sweeps(monkeypatch, score):
    """tests/test_calibrate.py's stand-ins in both packages."""
    for mod in (cal, jcal):
        monkeypatch.setattr(mod, "posterior_over_dataset",
                            lambda *a, **k: (np.zeros((2, 3, 29)),
                                             np.ones((2, 3), bool)))
        monkeypatch.setattr(mod, "uq_scores", lambda pred, true: {
            "accuracy": score, "precision": score, "goodness": score})


def test_ties_and_nan_match_jax(monkeypatch):
    conds, true = np.zeros((3, 4, 2)), np.zeros((3, 29))
    _fake_sweeps(monkeypatch, 0.5)
    got = cal.calibrate_temperature(None, conds, true, None, None,
                                    temperatures=(3.0, 1.5, 2.0))
    want = jcal.calibrate_temperature(None, None, conds, true, None, None,
                                      None, temperatures=(3.0, 1.5, 2.0))
    assert got[0] == want[0] == 1.5 and got[1] == want[1]
    got = cal.calibrate_guidance(None, conds, true, None, None,
                                 temperatures=(3.0, 1.5),
                                 guidance_scales=(0.5, 1.5, 1.0))
    want = jcal.calibrate_guidance(None, None, conds, true, None, None,
                                   None, temperatures=(3.0, 1.5),
                                   guidance_scales=(0.5, 1.5, 1.0))
    assert got[0] == want[0] == (1.0, 1.5) and got[1] == want[1]
    _fake_sweeps(monkeypatch, float("nan"))
    _raises_alike(
        lambda: cal.calibrate_temperature(None, conds, true, None, None,
                                          temperatures=(1.0, 2.0)),
        lambda: jcal.calibrate_temperature(None, None, conds, true, None,
                                           None, None,
                                           temperatures=(1.0, 2.0)))
    _raises_alike(
        lambda: cal.calibrate_guidance(None, conds, true, None, None,
                                       temperatures=(1.0,),
                                       guidance_scales=(1.0,)),
        lambda: jcal.calibrate_guidance(None, None, conds, true, None, None,
                                        None, temperatures=(1.0,),
                                        guidance_scales=(1.0,)))
    _raises_alike(
        lambda: cal.calibrate_temperature(None, conds, true, None, None,
                                          objective="sharpness"),
        lambda: jcal.calibrate_temperature(None, None, conds, true, None,
                                           None, None,
                                           objective="sharpness"))
    # a mesh is ported (tests/test_torch_dp_sample.py); a non-mesh raises
    with pytest.raises(TypeError, match="make_mesh"):
        cal.calibrate_temperature(None, conds, true, None, None, mesh=1)


def _jax_batch_draws(key, n_batches):
    """Each batch's prior and per-step draws, as JAX's DDIM takes them
    from fold_in(key, batch)."""
    out = []
    for bi in range(n_batches):
        k, init = jax.random.split(jax.random.fold_in(key, bi))
        x_t = jax.random.normal(init, (R * BS, P))
        noise = jnp.stack([jax.random.normal(s, (R * BS, P))
                           for s in jax.random.split(k, STEPS)])
        out.append({"x_T": t32(x_t), "noise": t32(noise)})
    return out


@pytest.fixture(scope="module")
def sweep_setup():
    fm, params, tm = make_pair(num_blocks=2, seed=31, uncond_prob=0.2)
    rng = np.random.default_rng(8)
    cond = rng.uniform(size=(N, 96, 4)).astype(np.float32)
    design = SurrogateDataGenerator(seed=2).generate_training_samples(
        64, "lhs")
    true = design[:N]
    scalers = (jtransforms.MinMaxScaler.fit(design),
               transforms.MinMaxScaler.fit(design))
    key = jax.random.key(11)
    return fm, params, tm, cond, true, scalers, key


def _assert_records_match(got, want):
    assert set(got) == set(want)
    for k in want:
        for field in KEYS:
            np.testing.assert_allclose(got[k][field], want[k][field],
                                       rtol=1e-6, atol=1e-6)
        for obj in ("accuracy", "precision", "goodness"):
            np.testing.assert_allclose(got[k]["per_parameter"][obj],
                                       want[k]["per_parameter"][obj],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("per_parameter", [False, True])
def test_temperature_sweep_matches_jax(sweep_setup, per_parameter):
    fm, params, tm, cond, true, (jsc, tsc), key = sweep_setup
    temps = (1.0, 0.5, 1.5)
    kw = dict(temperatures=temps, n_realizations=R, batch_size=BS,
              per_parameter=per_parameter)
    want_best, want = jcal.calibrate_temperature(
        fm, params, jnp.asarray(cond), true, jdiff.get_diffusion_schedule(T),
        key, jsc, scfg=JaxSampleConfig(sampler="ddim", ddim_steps=STEPS,
                                       ddim_eta=0.8), **kw)
    got_best, got = cal.calibrate_temperature(
        tm, cond, true, diffusion.get_diffusion_schedule(T), tsc,
        scfg=SampleConfig(sampler="ddim", ddim_steps=STEPS, ddim_eta=0.8),
        draws=_jax_batch_draws(key, -(-N // BS)), device="cpu", **kw)
    assert got_best == want_best
    _assert_records_match(got, want)
    if per_parameter:
        assert got["vector"]["temperature"] == want["vector"]["temperature"]
    # the arms differ: temperature moves the posterior
    sds = [got[str(t)]["ensemble_sd_mean"] for t in temps]
    assert sds[1] < sds[0] < sds[2]


def test_guidance_sweep_matches_jax(sweep_setup):
    fm, params, tm, cond, true, (jsc, tsc), key = sweep_setup
    kw = dict(temperatures=(1.0, 1.5), guidance_scales=(1.0, 2.0),
              n_realizations=R, batch_size=BS, objective="accuracy")
    want_best, want = jcal.calibrate_guidance(
        fm, params, jnp.asarray(cond), true, jdiff.get_diffusion_schedule(T),
        key, jsc, scfg=JaxSampleConfig(sampler="ddim", ddim_steps=STEPS,
                                       ddim_eta=0.8,
                                       guidance_interval=(0.2, 0.8)), **kw)
    got_best, got = cal.calibrate_guidance(
        tm, cond, true, diffusion.get_diffusion_schedule(T), tsc,
        scfg=SampleConfig(sampler="ddim", ddim_steps=STEPS, ddim_eta=0.8,
                          guidance_interval=(0.2, 0.8)),
        draws=_jax_batch_draws(key, -(-N // BS)), device="cpu", **kw)
    assert got_best == want_best
    _assert_records_match(got, want)


def test_generator_arms_share_their_draws(sweep_setup):
    """From a generator every arm starts at the same state, as every arm
    of JAX's sweep samples from the same key: two equal temperatures give
    equal records, and the generator ends where one arm leaves it."""
    _, _, tm, cond, true, (_, tsc), _ = sweep_setup
    gen = torch.Generator().manual_seed(5)
    _, recs = cal.calibrate_temperature(
        tm, cond, true, diffusion.get_diffusion_schedule(T), tsc,
        temperatures=(1.0, 1.0 + 1e-9, 2.0), n_realizations=R,
        batch_size=BS, scfg=SampleConfig(sampler="ddim", ddim_steps=STEPS,
                                         ddim_eta=0.8),
        generator=gen, device="cpu")
    assert recs["1.0"] == recs[str(1.0 + 1e-9)] != recs["2.0"]
