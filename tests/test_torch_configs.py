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


@pytest.mark.parametrize("preset", ["FULL_CONDITIONAL", "DDIM_ENSEMBLE",
                                    "V5E8_DP"])
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


def test_split_seed_and_config_echo_match():
    for kw in ({}, {"split_seed": 7}):
        assert configs.split_seed_of(configs.TrainConfig(**kw)) == \
            jconfigs.split_seed_of(jconfigs.TrainConfig(**kw))
    echo = {"model": {"name": "condunet", "attn_slab": True},
            "train": {"split": [0.7, 0.2], "lr_schedule": "cosine"},
            "sample": {"temperature": [1.0, 2.0]}, "name": "x"}
    assert dataclasses.asdict(configs.experiment_from_dict(echo)) == \
        dataclasses.asdict(jconfigs.experiment_from_dict(echo))
    base = configs.V5E8_DP
    assert configs.experiment_from_dict({}, base) == base
