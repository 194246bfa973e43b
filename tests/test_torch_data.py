"""The port's data, design and training-target helpers hold the JAX
package's values: numpy paths exactly, float32 tensor paths at
atol 1e-6 and rtol 1e-6 (a few float32 ulp of values near 1).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx import data as jdata
from ertdx import diffusion as jdiff
from ertdx import doe as jdoe
from ertdx import transforms as jtransforms
from ertdx_torch import data, diffusion, doe, transforms


@pytest.mark.parametrize("method", ["lhs", "sobol"])
def test_designs_match(method):
    ours = doe.SurrogateDataGenerator(seed=3).generate_training_samples(
        16, method)
    theirs = jdoe.SurrogateDataGenerator(seed=3).generate_training_samples(
        16, method)
    np.testing.assert_array_equal(ours, theirs)


def test_prepare_split_and_pad_match():
    rng = np.random.default_rng(0)
    params = doe.SurrogateDataGenerator(seed=1).generate_training_samples(
        32, "lhs")[..., None]
    ert = rng.normal(50.0, 10.0, size=(32, 20, 3))
    ours = data.prepare_dataset(params, ert)
    theirs = jdata.prepare_dataset(params, ert)
    np.testing.assert_array_equal(ours.params_u, theirs.params_u)
    np.testing.assert_array_equal(ours.conditions, theirs.conditions)
    for a, b in zip(data.split_dataset(32, 5), jdata.split_dataset(32, 5)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(data.pad_batch(ours.params_u[:5], ours.conditions[:5],
                                   8),
                    jdata.pad_batch(ours.params_u[:5], ours.conditions[:5],
                                    8)):
        np.testing.assert_array_equal(a, b)
    got = list(data.batch_iterator(ours.params_u, ours.conditions, 10,
                                   shuffle=True, seed=2, epoch=1))
    want = list(jdata.batch_iterator(ours.params_u, ours.conditions, 10,
                                     shuffle=True, seed=2, epoch=1))
    assert len(got) == len(want) == 4
    for (x, c), (xj, cj) in zip(got, want):
        np.testing.assert_array_equal(x, np.asarray(xj))
        np.testing.assert_array_equal(c, np.asarray(cj))


def test_scaler_state_round_trips_between_packages():
    x = np.random.default_rng(1).normal(size=(9, 4))
    ours = transforms.MinMaxScaler.fit(x, (0.0, 2.0))
    theirs = jtransforms.MinMaxScaler.from_state_dict(ours.state_dict())
    np.testing.assert_allclose(np.asarray(theirs.transform(x)),
                               ours.transform(x), rtol=1e-12)
    back = transforms.MinMaxScaler.from_state_dict(theirs.state_dict())
    assert back.feature_range == (0.0, 2.0)
    assert ours.state_dict().keys() == theirs.state_dict().keys()


@pytest.mark.parametrize("parameterization", ["eps", "v"])
def test_training_targets_match(parameterization):
    rng = np.random.default_rng(4)
    x0 = rng.normal(size=(6, 29)).astype(np.float32)
    noise = rng.normal(size=(6, 29)).astype(np.float32)
    t = np.array([0, 1, 77, 250, 498, 499])
    jab = jdiff.get_diffusion_schedule(500).alpha_bar
    tab = diffusion.get_diffusion_schedule(500).alpha_bar
    tt = torch.from_numpy(t)
    pairs = [
        (diffusion.q_sample(torch.from_numpy(x0), tt,
                            torch.from_numpy(noise), tab),
         jdiff.q_sample(jnp.asarray(x0), jnp.asarray(t),
                        jnp.asarray(noise), jab)),
        (diffusion.prediction_target(torch.from_numpy(x0),
                                     torch.from_numpy(noise), tt, tab,
                                     parameterization),
         jdiff.prediction_target(jnp.asarray(x0), jnp.asarray(noise),
                                 jnp.asarray(t), jab, parameterization)),
        (diffusion.min_snr_weight(tt, tab, parameterization, 5.0),
         jdiff.min_snr_weight(jnp.asarray(t), jab, parameterization, 5.0)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
