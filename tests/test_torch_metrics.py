"""The port's metrics against the JAX package's on the same seeded numpy
inputs: every numpy definition exactly (or to 1e-12), the batched KDE
mode (PyTorch on the CPU here) within one step of the global grid of
JAX's jitted one, constant pixels included."""
from __future__ import annotations

import numpy as np
import pytest

from ertdx import metrics as J
from ertdx_torch import metrics as M


def _same(got, want, rtol=1e-12):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k], rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, rtol)
    elif isinstance(want, str):
        assert got == want
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=rtol,
                                   atol=0)


def _grid_step(sim, grid_points):
    """One step of the global grid, plus the float32 rounding of its
    points (a few ulps of the largest value)."""
    ulp = np.spacing(np.float32(np.abs(sim).max()))
    return (sim.max() - sim.min()) / (grid_points - 1) + 4 * ulp


def test_wsse_matches_jax():
    rng = np.random.default_rng(0)
    obs = rng.normal(1.0, 0.5, size=(40, 14))
    pred = obs + rng.normal(0.0, 0.1, size=obs.shape)
    _same(M.wsse_metric(0.1, 0.01, pred, obs),
          J.wsse_metric(0.1, 0.01, pred, obs))
    sims = obs[None] + rng.normal(0.0, 0.1, size=(5,) + obs.shape)
    _same(M.wsse_per_simulation(sims, obs), J.wsse_per_simulation(sims,
                                                                 obs))


@pytest.mark.parametrize("seed", [0, 1])
def test_mode_kde_and_wasserstein_match_jax(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0, 1, 300), rng.normal(4, 0.3, 400)])
    assert M.mode_kde_calculation(x) == J.mode_kde_calculation(x)
    assert M.mode_kde_calculation(np.full(5, 2.5)) == \
        J.mode_kde_calculation(np.full(5, 2.5))
    u, v = rng.normal(size=500), rng.normal(0.3, 2.0, size=300)
    assert M.wasserstein_1d(u, v) == J.wasserstein_1d(u, v)


def test_ensemble_statistics_match_jax():
    rng = np.random.default_rng(3)
    sim = rng.normal(5.0, 1.0, size=(30, 8, 4))
    cond = rng.normal(5.0, 1.0, size=(8, 4))
    mode = J.batched_kde_mode(sim)
    _same(M.ensemble_statistics(sim, cond, mode=mode),
          J.ensemble_statistics(sim, cond, mode=mode))
    _same(M.ensemble_statistics(sim, mode=mode),
          J.ensemble_statistics(sim, mode=mode))
    # without a mode the port computes it on the asked-for device
    got = M.ensemble_statistics(sim, cond, device="cpu")
    assert np.abs(got["mode"] - mode).max() <= _grid_step(sim, 5000)


@pytest.mark.parametrize("case", ["perfect", "zero", "gaussian", "tied"])
def test_uq_scores_match_jax(case):
    rng = np.random.default_rng(2)
    if case == "perfect":
        pred = rng.normal(0, 1, size=(401, 50))
        true = np.median(pred, axis=0)
    elif case == "zero":
        pred = rng.normal(0, 0.1, size=(200, 20))
        true = np.full(20, 100.0)
    elif case == "gaussian":
        pred = rng.normal(0, 1, size=(200, 60, 3))
        true = rng.normal(0, 1, size=(60, 3))
    else:                                   # integer-valued ties
        pred = rng.integers(0, 4, size=(50, 30)).astype(float)
        true = rng.integers(0, 4, size=30).astype(float)
    _same(M.uq_scores(pred, true), J.uq_scores(pred, true))
    probs = np.linspace(0.05, 0.95, 7)
    _same(M.uq_scores(pred, true, probs), J.uq_scores(pred, true, probs))
    _same(M.coverage_proportions(pred, true),
          J.coverage_proportions(pred, true))
    avg, p = J.coverage_proportions(pred, true)
    a_p = J.avg_prop_indicator_function(avg, p)
    np.testing.assert_array_equal(M.avg_prop_indicator_function(avg, p), a_p)
    acc = J.accuracy_score(a_p, p)
    assert M.accuracy_score(a_p, p) == acc
    assert M.precision_score(acc, avg, p, a_p) == \
        J.precision_score(acc, avg, p, a_p)
    assert M.goodness_score(a_p, avg, p) == J.goodness_score(a_p, avg, p)
    assert M.preccision_score is M.precision_score


def test_per_parameter_uq_matches_jax():
    rng = np.random.default_rng(4)
    pred = rng.normal(0, 1, size=(60, 20, 29))
    true = rng.normal(0, 1, size=(20, 29))
    _same(M.per_parameter_uq(pred, true), J.per_parameter_uq(pred, true))
    names = [f"p{j}" for j in range(3)]
    _same(M.per_parameter_uq(pred[..., :3], true[..., :3], names),
          J.per_parameter_uq(pred[..., :3], true[..., :3], names))


@pytest.mark.parametrize("fair", [True, False])
def test_crps_matches_jax(fair):
    rng = np.random.default_rng(5)
    pred = rng.normal(size=(7, 5, 3))
    true = rng.normal(size=(5, 3))
    _same(M.crps_ensemble(pred, true, fair=fair),
          J.crps_ensemble(pred, true, fair=fair))
    for mod in (M, J):
        with pytest.raises(ValueError, match="ensemble members"):
            mod.crps_ensemble(pred[:1], true)


def test_sbc_matches_jax():
    rng = np.random.default_rng(6)
    pred = rng.normal(size=(49, 300, 4))
    true = rng.normal(size=(300, 4))
    ranks = M.sbc_ranks(pred, true)
    np.testing.assert_array_equal(ranks, J.sbc_ranks(pred, true))
    _same(M.sbc_uniformity(ranks, 49), J.sbc_uniformity(ranks, 49))
    assert M.sbc_uniformity(ranks[:, 0], 49) == \
        J.sbc_uniformity(ranks[:, 0], 49)


@pytest.mark.parametrize("shape,grid_points,chunk", [
    ((40, 6, 3), 500, 4096),
    ((20, 30, 7), 256, 64),          # several pixel chunks, a ragged one
    ((50, 41, 14), 1000, 128),
])
def test_batched_kde_mode_matches_jax(shape, grid_points, chunk):
    rng = np.random.default_rng(7)
    sim = rng.normal(2.0, 0.5, size=shape)
    sim[:, 1, 0] = 2.25                       # a constant pixel
    sim[:, 2, 1] = rng.choice([1.0, 3.0], size=shape[0])   # two modes
    got = M.batched_kde_mode(sim, grid_points=grid_points, chunk=chunk,
                             device="cpu")
    want = J.batched_kde_mode(sim, grid_points=grid_points, chunk=chunk)
    assert got.shape == want.shape == shape[1:]
    # the grids agree to a float32 rounding, so a near-tie can take the
    # neighbouring point
    assert np.abs(got - want).max() <= _grid_step(sim, grid_points)
    assert got[1, 0] == np.float32(2.25) == want[1, 0]
    # most pixels take the same grid point
    assert np.mean(np.abs(got - want) <= 1e-6 * np.abs(want)) > 0.95


def test_batched_kde_mode_needs_the_card_or_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.batched_kde_mode(np.zeros((3, 2, 2)))
