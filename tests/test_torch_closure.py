"""The physics-loop closure (tests/test_closure.py) on both packages,
without training.

A small CondUNet, flax's init perturbed and carried over by
params_from_jax (tests/torch_parity_common.py), samples a posterior for
one condition in both packages, JAX's prior and per-step draws injected
into the port (the ensembles within 1e-5); both inverse pipelines; then
the generated parameter sets go through each package's
run_posterior_validation with tests/test_closure.py's stand-in PFLOTRAN,
are re-ingested with load_simulation_data and refold_ert_vector, and
scored with ensemble_statistics (the port's on the CPU) and
wsse_per_simulation.

Tolerances: the draws 1e-5 (float32 through the same network), the
physical parameters 1e-5 relative; the simulations from the same
parameters exactly, from each package's own within 1e-3 relative (the
writer's %12.4e carries ~1e-4, as tests/test_closure.py notes); the
statistics equal to 1e-12 but the KDE mode and what derives from it, one
step of the KDE grid.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ertdx import data as jdata
from ertdx import diffusion as jdiff
from ertdx import metrics as jmetrics
from ertdx import physics as jphysics
from ertdx import sample as jsample
from ertdx_torch import data as tdata
from ertdx_torch import diffusion, metrics, physics, sample
from ertdx_torch.doe import SurrogateDataGenerator
from test_closure import MEAS, N_SURVEYS, _fake_pflotran
from torch_parity_common import make_pair, t32

T, R, L, C = 10, 6, 96, 4
MODE_KEYS = ("mode", "diff_mode", "pct_error_mode", "wasserstein_mode",
             "mse_mode", "rmse_mode")


def _posterior():
    """Both packages' draws, physical parameters and masks."""
    params_phys = SurrogateDataGenerator(seed=5).generate_training_samples(
        64, "sobol")
    ert = np.random.default_rng(5).normal(50, 10, (64, L, C))
    jds = jdata.prepare_dataset(params_phys[..., None], ert)
    tds = tdata.prepare_dataset(params_phys[..., None], ert)
    np.testing.assert_array_equal(tds.conditions, jds.conditions)
    fm, params, tm = make_pair(p=29, d=32, cond_channels=C, cond_len=L,
                               num_blocks=2, seed=5)
    cond = jds.conditions[:1]
    key = jax.random.key(0)
    u_j = np.asarray(jsample.posterior_ensemble(
        fm, params, jnp.asarray(cond), jdiff.get_diffusion_schedule(T), key,
        n_realizations=R))
    # JAX's ancestral draws: the prior from split(key)[1], then one
    # normal a step from split(split(key)[0], T)
    k, init = jax.random.split(key)
    x_t = np.asarray(jax.random.normal(init, (R, 29)))
    noise = np.stack([np.asarray(jax.random.normal(sk, (R, 29)))
                      for sk in jax.random.split(k, T)])
    u_t = sample.posterior_ensemble(
        tm, t32(cond), diffusion.get_diffusion_schedule(T), R,
        x_T=t32(x_t), noise=t32(noise), device="cpu")
    # the draws on the host, as tests/test_closure.py hands them over:
    # both pipelines then compute in float64
    u_t = u_t.numpy()
    phys_j, mask_j = jsample.inverse_pipeline(u_j, jds.param_scaler)
    phys_t, mask_t = sample.inverse_pipeline(u_t, tds.param_scaler)
    return u_j, u_t, np.asarray(phys_j), phys_t, np.asarray(mask_j), mask_t


def _validate(mod, gen_params, root):
    """One package's closure loop: run_posterior_validation with the
    stand-in, then the re-ingest; (completed, (n, M, S) data, params)."""
    root.mkdir(parents=True)
    (root / "tpl.in").write_text("".join(f"line {i}\n" for i in range(170)))
    sim = mod.PflotranSimulator(str(root / "tpl.in"), "closure",
                                output_dir=str(root))
    fmt = {jphysics: jdata, physics: tdata}[mod].SrvFormat(skip_header=2,
                                                           usecols=5)
    runner = mod.ForwardModelRunner(
        sim, cfg=mod.RunnerConfig(
            pflotran_path=str(_fake_pflotran(root)), use_mpi=False,
            n_surveys=N_SURVEYS, measurements_per_survey=MEAS,
            srv_format=fmt),
        workdir=str(root))
    mgr = mod.SimulationManager(base_dir=str(root / "val"))
    completed = mod.run_posterior_validation(runner, mgr, gen_params,
                                             progress=lambda s: None)
    data = {jphysics: jdata, physics: tdata}[mod]
    flat, sim_params = data.load_simulation_data(root / "val",
                                                 len(gen_params),
                                                 verbose=False)
    folded = np.stack([data.refold_ert_vector(s.ravel(), N_SURVEYS)
                       for s in flat])
    return completed, folded, sim_params


def _scores(mod_metrics, sim_data, conditional, **kw):
    stats = mod_metrics.ensemble_statistics(sim_data, conditional, **kw)
    return stats, mod_metrics.wsse_per_simulation(sim_data, conditional)


def _check_scores(got, want, sim_data):
    (stats, wsse), (jstats, jwsse) = got, want
    np.testing.assert_allclose(wsse, jwsse, rtol=1e-12, atol=0)
    assert stats.keys() == jstats.keys()
    step = (sim_data.max() - sim_data.min()) / 4999
    for k in jstats:
        if k == "mode":
            np.testing.assert_allclose(stats[k], jstats[k], rtol=0,
                                       atol=step + 1e-6 *
                                       np.abs(sim_data).max())
        elif k not in MODE_KEYS:
            np.testing.assert_allclose(stats[k], jstats[k], rtol=1e-12,
                                       atol=0, err_msg=k)


def test_closure_loop_matches_jax(tmp_path):
    u_j, u_t, phys_j, phys_t, mask_j, mask_t = _posterior()
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(phys_t, phys_j, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(mask_t, mask_j)
    assert phys_t.dtype == phys_j.dtype == np.float64
    valid = np.nonzero(mask_j[:, 0])[0]
    assert valid.size >= 3, mask_j
    gen = {"jax": phys_j[valid, 0, :], "port": phys_t[valid, 0, :]}

    # the same parameter sets through both loops: the same files exactly
    out = {}
    for name, mod in (("jax", jphysics), ("port", physics)):
        out[name] = _validate(mod, gen["jax"], tmp_path / "same" / name)
    assert out["port"][0] == out["jax"][0] == list(range(valid.size))
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
    np.testing.assert_array_equal(out["port"][2], out["jax"][2])
    assert out["port"][2].dtype == gen["jax"].dtype
    sim_data = out["port"][1]
    assert sim_data.shape == (valid.size, MEAS, N_SURVEYS)
    # the stand-in's physics: the porosity the writer spliced, x 100
    np.testing.assert_allclose(sim_data[:, 0, 0], gen["jax"][:, 0] * 100,
                               rtol=1e-3)

    # each package's own parameter sets through its own loop
    own = {}
    for name, mod in (("jax", jphysics), ("port", physics)):
        own[name] = _validate(mod, gen[name], tmp_path / "own" / name)
    assert own["port"][0] == own["jax"][0]
    np.testing.assert_allclose(own["port"][1], own["jax"][1], rtol=1e-3,
                               atol=0)

    conditional = sim_data[0]
    got = _scores(metrics, sim_data, conditional, device="cpu")
    want = _scores(jmetrics, out["jax"][1], conditional)
    _check_scores(got, want, sim_data)
    assert np.allclose(got[1][0], 0.0)             # self-WSSE is zero
    assert np.isfinite(got[0]["rmse_mean"])
    assert got[0]["mode"].shape == (MEAS, N_SURVEYS)


@pytest.mark.parametrize("seed", [0, 1])
def test_closure_statistics_match_jax(seed):
    """ensemble_statistics and wsse_per_simulation on re-ingested
    ensembles of the closure's shape (and one with a constant pixel)."""
    rng = np.random.default_rng(seed)
    sim_data = 100 * rng.uniform(0.1, 0.4, (7, MEAS, N_SURVEYS)) + \
        np.arange(N_SURVEYS)
    if seed:
        sim_data[:, 1, 2] = 42.0
    conditional = sim_data[seed]
    got = _scores(metrics, sim_data, conditional, device="cpu")
    want = _scores(jmetrics, sim_data, conditional)
    _check_scores(got, want, sim_data)
    if seed:
        assert got[0]["mode"][1, 2] == 42.0
