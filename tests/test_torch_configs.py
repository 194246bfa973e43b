"""The port's configs and parameter space hold the JAX package's values."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from ertdx import configs as jconfigs
from ertdx import params as jparams
from ertdx_torch import configs, params


@pytest.mark.parametrize("name", ["DiffusionConfig", "ModelConfig",
                                  "TrainConfig", "SampleConfig",
                                  "MeshConfig", "ExperimentConfig"])
def test_config_fields_and_defaults_match(name):
    ours, theirs = getattr(configs, name), getattr(jconfigs, name)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


@pytest.mark.parametrize("preset", ["FULL_CONDITIONAL", "DDIM_ENSEMBLE"])
def test_presets_match(preset):
    assert dataclasses.asdict(getattr(configs, preset)) == \
        dataclasses.asdict(getattr(jconfigs, preset))
    assert configs.PRESETS[getattr(configs, preset).name] is \
        getattr(configs, preset)


def test_parameter_space_matches():
    ours, theirs = params.ParameterSpace(), jparams.ParameterSpace()
    np.testing.assert_array_equal(ours.plims, theirs.plims)
    assert ours.logparms == theirs.logparms
    assert ours.names == theirs.names
    np.testing.assert_array_equal(ours.log_mask, theirs.log_mask)
    for a, b in zip(ours.effective_bounds(), theirs.effective_bounds()):
        np.testing.assert_array_equal(a, b)
    pm = np.random.default_rng(0).uniform(ours.lo, ours.hi, size=(5, 29))
    np.testing.assert_array_equal(ours.contains(pm), theirs.contains(pm))
