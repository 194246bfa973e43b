"""`train(resume=True)` and checkpoints of the new layouts, against
ertdx.train on the CPU.

* Resume: a guided model (uncond_prob > 0) with EMA and the flat
  optimizer layout trained 2 epochs, then resumed to 4, equals 4 epochs
  straight, exactly (the same float32 operations in the same order on
  the CPU; every epoch's draws are seeded by the epoch), as
  tests/test_resume_parity.py pins for JAX; with no checkpoint it starts
  fresh.
* Checkpoints with flat_optimizer, with pallas_conv_min_width and of a
  bfloat16 model (its config echo says "bfloat16"; params and moments
  are float32 in both packages) move both ways: written by
  `ertdx.train.train` and read by the port's `load_best_model`, and
  written by the port's `train` and read by
  `ertdx.train.load_best_model`. Parameters and Adam moments arrive
  unchanged (exact); the flat moments unravel in
  `jax.flatten_util.ravel_pytree` order, which pins the port's
  `ravel_tree`. The flax model on the restored fused-conv params gives
  the port model's outputs (atol and rtol 1e-4; for the bf16 model the
  JAX package's bf16 band, 5e-2, tests/test_ops.py:568-571).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from ertdx import configs as jconfigs
from ertdx import data as jdata
from ertdx import train as jtrain
from ertdx.models.condunet import CondUNet as FlaxCondUNet
from ertdx_torch import configs, data, train
from ertdx_torch.doe import SurrogateDataGenerator
from ertdx_torch.utils.weights import (adam_state_to_jax, named_to_jax,
                                       params_to_jax)
from torch_parity_common import t32


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _dataset(n=48, l=96, c=4):
    params_phys = SurrogateDataGenerator(seed=1).generate_training_samples(
        n, "sobol")
    ert = np.random.default_rng(1).normal(50.0, 10.0, size=(n, l, c))
    return (data.prepare_dataset(params_phys[..., None], ert),
            jdata.prepare_dataset(params_phys[..., None], ert))


def _small_cfg(tmp, epochs, model_kw=None, **train_kw):
    model = dataclasses.replace(
        configs.ModelConfig(), name="condunet", hidden_dim=32,
        cond_length=96, cond_channels=4, base_width=16, depth=2,
        num_heads=2, num_blocks=1, **(model_kw or {}))
    return configs.ExperimentConfig(
        diffusion=configs.DiffusionConfig(T=50), model=model,
        train=dataclasses.replace(configs.TrainConfig(), num_epochs=epochs,
                                  batch_size=8, checkpoint_dir=str(tmp),
                                  log_every=1, **train_kw))


def test_resume_continues_the_straight_run(tmp_path):
    """A guided model with EMA and the flat optimizer layout: 2 epochs,
    then resumed to 4, equal 4 epochs straight; resume without a
    checkpoint starts fresh."""
    ds, _ = _dataset(n=24)
    kw = dict(model_kw={"uncond_prob": 0.3}, step_checkpoint_every=1,
              ema_decay=0.9, flat_optimizer=True)
    straight = train.train(_small_cfg(tmp_path / "straight", 4, **kw), ds,
                           device="cpu")
    part = train.train(_small_cfg(tmp_path / "ab", 2, **kw), ds,
                       device="cpu")
    logs = []
    resumed = train.train(_small_cfg(tmp_path / "ab", 4, **kw), ds,
                          device="cpu", resume=True, logger=logs.append)
    assert logs[0] == {"resumed_from_epoch": 2,
                       "best_val": part.best_val_loss}
    assert resumed.train_history[:2] == part.train_history
    assert resumed.train_history == straight.train_history
    assert resumed.val_history == straight.val_history
    assert (resumed.best_epoch, resumed.best_val_loss) == (
        straight.best_epoch, straight.best_val_loss)
    assert resumed.state.step == straight.state.step == 4 * 3
    for (name, a), (_, b) in zip(resumed.state.model.named_parameters(),
                                 straight.state.model.named_parameters()):
        assert torch.equal(a, b), name
        assert torch.equal(resumed.state.ema_params[name],
                           straight.state.ema_params[name]), name
        sa, sb = resumed.state.opt.state[a], straight.state.opt.state[b]
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"]), name

    fresh = train.train(_small_cfg(tmp_path / "fresh", 2, **kw), ds,
                        device="cpu", resume=True)
    assert fresh.train_history == part.train_history


@pytest.mark.parametrize("case", ["flat_optimizer", "pallas_conv_min_width",
                                  "bfloat16"])
def test_checkpoints_move_both_ways(tmp_path, case):
    ds, jds = _dataset()
    flat = case == "flat_optimizer"
    model_kw = {"flat_optimizer": None,
                "pallas_conv_min_width": {"pallas_conv_min_width": 64},
                "bfloat16": {"dtype": "bfloat16", "attn_slab": True}}[case]
    cfg = _small_cfg(tmp_path, 1, model_kw=model_kw, flat_optimizer=flat)
    bf16 = cfg.model.dtype == "bfloat16"
    jcfg = jconfigs.experiment_from_dict(dataclasses.asdict(cfg))
    shapes = (ds.cond_shape, ds.param_dim)

    def moments(state_mu, jparams):
        """JAX's mu as a tree (a flat mu unravelled in ravel_pytree
        order)."""
        return ravel_pytree(jparams)[1](state_mu) if flat else state_mu

    def same(port_state, jstate):
        model = port_state.model
        assert _leaves(params_to_jax(model)).keys() == _leaves(
            jstate.params).keys()
        for key, val in _leaves(jstate.params).items():
            np.testing.assert_array_equal(_leaves(params_to_jax(model))[key],
                                          val)
        adam = adam_state_to_jax(port_state.opt, model, schedule=False,
                                 flat=flat)
        jmu = jstate.opt_state[0].mu
        if flat:
            np.testing.assert_array_equal(adam["0"]["mu"], np.asarray(jmu))
        got = _leaves(named_to_jax(model, {
            n: port_state.opt.state[p]["exp_avg"]
            for n, p in model.named_parameters()}))
        for key, val in _leaves(moments(jmu, jstate.params)).items():
            np.testing.assert_array_equal(got[key], val)
        assert port_state.step == int(jstate.step) > 0

    # written by JAX, read by the port
    jdir = tmp_path / "jax"
    jtrain.train(dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, checkpoint_dir=str(jdir))), jds)
    jstate, _, _ = jtrain.load_best_model(str(jdir), jcfg, shapes)
    pstate, meta, _ = train.load_best_model(str(jdir), cfg, device="cpu")
    same(pstate, jstate)
    assert meta["config"]["model"]["dtype"] == cfg.model.dtype
    assert pstate.model.compute_dtype == (torch.bfloat16 if bf16
                                          else torch.float32)

    # written by the port, read by JAX
    pdir = tmp_path / "port"
    res = train.train(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(pdir))), ds, device="cpu")
    jstate, meta, _ = jtrain.load_best_model(str(pdir), jcfg, shapes)
    same(res.state, jstate)
    assert meta["config"]["model"]["dtype"] == cfg.model.dtype
    fm = FlaxCondUNet(param_dim=29, hidden_dim=32, cond_channels=4,
                      base_width=16, depth=2, num_heads=2, num_blocks=1,
                      pallas_conv_min_width=cfg.model.pallas_conv_min_width,
                      attn_slab=cfg.model.attn_slab,
                      dtype=jnp.dtype(cfg.model.dtype))
    x, cond = ds.params_u[:3], ds.conditions[:3]
    t = np.array([0, 20, 49], np.int32)
    want = fm.apply({"params": jstate.params}, jnp.asarray(x),
                    jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        got = res.state.model(t32(x), torch.from_numpy(t).long(), t32(cond))
    tol = 5e-2 if bf16 else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
