"""The port's data-parallel training on a 2-rank gloo world.

* One DP `train_step` (refmlp, JAX's init and its t and eps injected)
  against JAX's step sharded over `make_mesh(data=8)` on conftest's fake
  devices, at tests/test_sharding.py's tolerances (loss rtol 1e-5;
  params rtol 1e-4, atol 1e-6);
* three DP steps that draw t, eps and the CFG drop mask from a generator
  (v target, min-SNR, a padded w, EMA; two batches sharded, one of 7
  rows replicated) against the same steps in one process at 1e-6;
* `train(mesh=)` for 2 epochs against `train()` in one process
  (histories at rtol 1e-5, JAX's tolerance for its mesh loop); rank 0
  alone writes the checkpoints, and JAX's `load_best_model` restores
  the best one.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ertdx import configs as jconfigs
from ertdx import train as jtrain
from ertdx.diffusion import get_diffusion_schedule
from ertdx.models import build_model as jbuild_model
from ertdx.parallel.mesh import batch_sharding, make_mesh, replicated
from torch_mesh_common import World, load, out, save

T = 10
LR = 1e-3
TRAIN_CFG = {"diffusion": {"T": T},
             "model": {"name": "condunet", "hidden_dim": 32,
                       "cond_length": 96, "cond_channels": 4,
                       "base_width": 16, "depth": 2, "num_heads": 2,
                       "num_blocks": 2, "attn_slab": True},
             "train": {"num_epochs": 2, "batch_size": 8,
                       "step_checkpoint_every": 1, "log_every": 100}}


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_sharded_step(ds):
    """tests/test_sharding.py::test_sharded_train_step_equals_single_device
    on JAX's side: the port's inputs (JAX's init and draws), and a
    function that runs JAX's sharded step."""
    mcfg = dataclasses.replace(jconfigs.ModelConfig(), cond_length=96,
                               cond_channels=4)
    model = jbuild_model(mcfg)
    state = jtrain.create_train_state(model, jax.random.key(0), LR, 32,
                                      ds.cond_shape, ds.param_dim)
    x0, cond = ds.params_u[:32], ds.conditions[:32]
    w = np.ones(32, np.float32)
    key = jax.random.key(42)
    kt, kn = jax.random.split(key)
    t = jax.random.randint(kt, (32,), 0, T, dtype=jnp.int32)
    noise = jax.random.normal(kn, (32, ds.param_dim), jnp.float32)
    inputs = {"model": {"cond_length": 96, "cond_channels": 4},
              "tree": _numpy(state.params), "x0": x0, "cond": cond,
              "w": w, "t": np.asarray(t), "noise": np.asarray(noise),
              "T": T, "lr": LR}

    def run():
        step = jtrain.make_train_step(model.apply,
                                      get_diffusion_schedule(T),
                                      donate=False)
        mesh = make_mesh(data=8)
        sh = batch_sharding(mesh)
        after, loss = step(jax.device_put(state, replicated(mesh)),
                           jax.device_put(jnp.asarray(x0), sh),
                           jax.device_put(jnp.asarray(cond), sh),
                           jax.device_put(jnp.asarray(w), sh), key)
        return float(loss), _numpy(after.params)

    return inputs, run


@pytest.fixture(scope="module")
def world(tmp_path_factory, tiny_dataset):
    tmp = tmp_path_factory.mktemp("dp_train")
    inputs, jax_step = _jax_sharded_step(tiny_dataset)
    save(tmp, "dp_step_jax", inputs)
    save(tmp, "dp_train", {"cfg": TRAIN_CFG, "n": 40,
                           "dir": str(tmp / "ck")})
    with World(2, ["dp_step_jax", "dp_step_port", "dp_train"], tmp) as w:
        save(tmp, "jax_result", jax_step())
        w.wait()
    return tmp


def test_dp_train_step_matches_jax_sharded_step(world):
    loss, params = load(world, "jax_result")
    for rank in range(2):
        got = out(world, "dp_step_jax", rank)
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        want, have = _leaves(params), _leaves(got["params"])
        assert want.keys() == have.keys()
        for k in want:
            np.testing.assert_allclose(have[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_dp_steps_equal_the_single_process(world):
    for rank in range(2):
        got = out(world, "dp_step_port", rank)
        np.testing.assert_allclose(got["mesh"], got["single"], rtol=1e-6)
        for which in ("params", "ema"):
            single, mesh = got[f"{which}_single"], got[f"{which}_mesh"]
            for name in single:
                np.testing.assert_allclose(mesh[name], single[name],
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=(which, name))
        # every leaf carried gradient: the comparison is not empty
        assert all(np.abs(g).max() > 0
                   for g in got["grads_single"].values())


def test_train_on_mesh_matches_the_single_process(world):
    outs = [out(world, "dp_train", r) for r in range(2)]
    for got in outs:
        (tr, va), (tr1, va1) = got["mesh"], got["single"]
        np.testing.assert_allclose(tr, tr1, rtol=1e-5)
        np.testing.assert_allclose(va, va1, rtol=1e-5)
        assert got["steps"] == 2 * 4
    # rank 0 alone writes best and last, every epoch
    assert outs[1]["writes"] == []
    names = [w.rsplit("/", 1)[-1] for w in outs[0]["writes"]]
    assert names.count("last") == 2 and names.count("best") >= 1
    jcfg = jconfigs.experiment_from_dict(TRAIN_CFG)
    state, meta, _ = jtrain.load_best_model(str(world / "ck"), jcfg,
                                            ((96, 4), 29))
    want, have = _leaves(outs[0]["best"]), _leaves(_numpy(state.params))
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
