"""Checkpoints move both ways between the port and the JAX package.

* `msgpack_lite` decodes the committed pd4 student's `state.msgpack`
  leaf for leaf as flax decodes it, and re-encodes it byte for byte.
* The port's v-model on those weights matches the flax model at the real
  4693 x 14 condition with batch 2 (atol 1e-4, rtol 1e-4, as the serving
  parity tests), and `load_best_model` restores the cosine-schedule Adam
  state flax wrote.
* A checkpoint written by the port's `train()` (cosine lr, EMA,
  attn_slab) is restored by `ertdx.train.load_best_model`; the flax model
  on the restored params gives the port model's outputs (atol 1e-4), and
  the optimizer state, step and EMA leaves arrive unchanged.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ertdx import configs as jconfigs
from ertdx import train as jtrain
from ertdx.models.condunet import CondUNet as FlaxCondUNet
from ertdx_torch import configs, data, train
from ertdx_torch.doe import SurrogateDataGenerator
from ertdx_torch.utils import checkpoint as ckpt
from ertdx_torch.utils import msgpack_lite
from ertdx_torch.utils.weights import params_to_jax
from torch_parity_common import t32

ROOT = Path(__file__).resolve().parents[1]
PD4 = ROOT / "docs/results/flagship_fullscale/condunet-v_s42/students/pd4"


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def pd4_raw():
    return (PD4 / "best" / "state.msgpack").read_bytes()


def test_msgpack_lite_reads_and_writes_the_flax_format(pd4_raw):
    ours = msgpack_lite.unpackb(pd4_raw)
    theirs = serialization.msgpack_restore(pd4_raw)
    a, b = _leaves(ours), _leaves(theirs)
    assert a.keys() == b.keys()
    for key in b:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])
    assert msgpack_lite.packb(ours) == pd4_raw
    tree = {"x": np.arange(6, dtype=np.float32).reshape(2, 3),
            "n": {"i": -70000, "f": 0.25, "s": "abc", "e": {},
                  "z": np.int32(5)}}
    back = serialization.msgpack_restore(msgpack_lite.packb(tree))
    assert np.array_equal(back["x"], tree["x"]) and back["n"]["i"] == -70000
    assert back["n"]["z"] == 5 and back["n"]["e"] == {}


def test_pd4_student_matches_flax(pd4_raw):
    state, meta, scalers = train.load_best_model(
        str(PD4), configs.FULL_CONDITIONAL, device="cpu")
    model = state.model
    assert model.parameterization == "v" and meta["target_steps"] == 4
    assert set(scalers) == {"param_scaler", "ert_scaler"}
    tree = msgpack_lite.unpackb(pd4_raw)
    assert state.step == int(tree["opt_state"]["0"]["count"])
    assert callable(state.lr)       # cosine: optax's "1" holds a count

    fm = FlaxCondUNet(parameterization="v")
    rng = np.random.default_rng(0)
    cond = rng.uniform(size=(2, 4693, 14)).astype(np.float32)
    x = rng.normal(size=(2, 29)).astype(np.float32)
    t = np.array([3, 411], np.int32)
    want = fm.apply({"params": tree["params"]}, jnp.asarray(x),
                    jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        got = model(t32(x), torch.from_numpy(t).long(), t32(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def _tiny_dataset(n=64, l=96, c=4):
    params_phys = SurrogateDataGenerator(seed=1).generate_training_samples(
        n, "sobol")
    ert = np.random.default_rng(1).normal(50.0, 10.0, size=(n, l, c))
    return data.prepare_dataset(params_phys[..., None], ert)


def test_port_checkpoint_restores_in_jax(tmp_path):
    ds = _tiny_dataset()
    model_cfg = dataclasses.replace(
        configs.ModelConfig(), name="condunet", hidden_dim=32,
        cond_length=96, cond_channels=4, base_width=16, depth=2,
        num_heads=2, num_blocks=2, attn_slab=True)
    cfg = configs.ExperimentConfig(
        diffusion=configs.DiffusionConfig(T=50), model=model_cfg,
        train=dataclasses.replace(configs.TrainConfig(), num_epochs=2,
                                  batch_size=8, lr_schedule="cosine",
                                  warmup_steps=2, ema_decay=0.9,
                                  log_every=1))
    logs = []
    res = train.train(cfg, ds, checkpoint_dir=str(tmp_path), device="cpu",
                      logger=logs.append)
    assert len(res.train_history) == 2 and len(logs) == 2
    assert np.isfinite(res.train_history).all()
    assert res.state.step == 2 * 7   # 51 train examples, ragged tail
    best = tmp_path / "best"
    assert {p.name for p in best.iterdir()} == {"state.msgpack",
                                                "meta.json", "scalers.npz"}

    jcfg = jconfigs.experiment_from_dict(dataclasses.asdict(cfg))
    jstate, meta, scalers = jtrain.load_best_model(
        str(tmp_path), jcfg, (ds.cond_shape, ds.param_dim))
    assert meta["epoch"] == res.best_epoch + 1
    np.testing.assert_array_equal(scalers["param_scaler"].data_min,
                                  ds.param_scaler.data_min)
    restored, _, _ = ckpt.restore_checkpoint(best)
    if res.best_epoch == 1:       # the best is the final state
        a, b = _leaves(params_to_jax(res.state.model)), _leaves(
            jstate.params)
        assert all(np.array_equal(a[k], b[k]) for k in b)
    assert int(jstate.step) == int(restored["step"])
    assert int(jstate.opt_state[1].count) == int(restored["step"])
    for key, val in _leaves(restored["ema_params"]).items():
        np.testing.assert_array_equal(_leaves(jstate.ema_params)[key], val)

    fm = FlaxCondUNet(param_dim=29, hidden_dim=32, cond_channels=4,
                      base_width=16, depth=2, num_heads=2, num_blocks=2,
                      attn_slab=True)
    pstate, _, _ = train.load_best_model(str(tmp_path), cfg, device="cpu")
    x, cond = ds.params_u[:3], ds.conditions[:3]
    t = np.array([0, 20, 49], np.int32)
    want = fm.apply({"params": jstate.params}, jnp.asarray(x),
                    jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        got = pstate.model(t32(x), torch.from_numpy(t).long(), t32(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert pstate.step == int(restored["step"])
    assert pstate.ema_params is not None
