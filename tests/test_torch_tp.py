"""The port's tensor parallelism on a 4-rank gloo world, data=2 x model=2.

* tests/test_sharding.py::test_tp_sharded_train_step_equals_single_device
  (slow-marked there) with JAX's init and its t and eps injected: one
  DP+TP step with `tp_shard_params(min_dim=64)` against JAX's step on one
  device, at JAX's tolerances (loss rtol 1e-5; params rtol 1e-4, atol
  1e-6), the sharded leaves being JAX's;
* then __graft_entry__.dryrun_multichip's sequence on the same mesh,
  against one process: a DP+TP step with CFG dropout from non-zero
  weights (loss 1e-6 relative, gradients and parameters 1e-6 absolute),
  a posterior, and a guided (1.5), tempered (1.2) posterior from the
  same weights (1e-5); every rank returns the same draws.
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
from ertdx.parallel import mesh as jmesh
from torch_mesh_common import World, load, out, save

T = 10
LR = 1e-3
ARGS = dict(base_width=16, depth=2, num_blocks=2, num_heads=2, d=32)


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_step(ds):
    mcfg = dataclasses.replace(jconfigs.ModelConfig(), name="condunet",
                               cond_length=96, cond_channels=4,
                               base_width=16, depth=2, num_blocks=2,
                               num_heads=2, hidden_dim=32)
    model = jbuild_model(mcfg)
    state = jtrain.create_train_state(model, jax.random.key(0), LR, 16,
                                      ds.cond_shape, ds.param_dim)
    init = _numpy(state.params)
    x0, cond = ds.params_u[:16], ds.conditions[:16]
    w = np.ones(16, np.float32)
    key = jax.random.key(7)
    kt, kn = jax.random.split(key)
    t = jax.random.randint(kt, (16,), 0, T, dtype=jnp.int32)
    noise = jax.random.normal(kn, (16, ds.param_dim), jnp.float32)
    inputs = {"args": ARGS, "tree": init, "x0": x0, "cond": cond, "w": w,
              "t": np.asarray(t), "noise": np.asarray(noise), "T": T,
              "lr": LR}

    def run():
        step = jtrain.make_train_step(model.apply,
                                      get_diffusion_schedule(T),
                                      donate=False)
        after, loss = step(state, jnp.asarray(x0), jnp.asarray(cond),
                           jnp.asarray(w), key)
        sharded = jmesh.tp_shard_params(
            init, jmesh.make_mesh(data=2, model=2), min_dim=64)
        leaves = sorted(
            "/".join(str(getattr(k, "key", k)) for k in path)
            for path, leaf in jax.tree_util.tree_leaves_with_path(sharded)
            if jmesh.MODEL_AXIS in tuple(leaf.sharding.spec))
        return float(loss), _numpy(after.params), leaves

    return inputs, run


@pytest.fixture(scope="module")
def world(tmp_path_factory, tiny_dataset):
    tmp = tmp_path_factory.mktemp("tp")
    inputs, jax_step = _jax_step(tiny_dataset)
    save(tmp, "tp_step_jax", inputs)
    rng = np.random.default_rng(0)
    b = 16
    save(tmp, "tp_graft", {
        "args": {**ARGS, "uncond_prob": 0.1}, "T": 50,
        "x0": rng.normal(size=(b, 29)).astype(np.float32),
        "cond": rng.uniform(size=(b, 128, 4)).astype(np.float32),
        "w": np.ones(b, np.float32)})
    with World(4, ["tp_step_jax", "tp_graft"], tmp) as w:
        save(tmp, "jax_result", jax_step())
        w.wait()
    return tmp


def test_tp_step_matches_jax(world):
    loss, params, _ = load(world, "jax_result")
    want = _leaves(params)
    for rank in range(4):
        got = out(world, "tp_step_jax", rank)
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        have = _leaves(got["params"])
        assert have.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(have[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_tp_shards_jaxs_leaves(world):
    """The leaves the port sharded (torch names -> flax paths) are the
    ones JAX's rule shards on the same mesh."""
    from ertdx_torch.utils.weights import flax_path
    leaves = load(world, "jax_result")[2]
    for rank in range(4):
        got = out(world, "tp_step_jax", rank)["leaves"]
        assert sorted("/".join(flax_path(n, 2)) for n in got) == leaves
    assert len(leaves) > 10


def test_graft_step_on_the_mesh_equals_the_single_process(world):
    for rank in range(4):
        got = out(world, "tp_graft", rank)
        single, mesh = got["single"], got["mesh"]
        np.testing.assert_allclose(mesh["loss"], single["loss"], rtol=1e-6)
        for which in ("grads", "params"):
            want, have = _leaves(single[which]), _leaves(mesh[which])
            for k in want:
                np.testing.assert_allclose(have[k], want[k], rtol=1e-6,
                                           atol=1e-6, err_msg=(which, k))


def test_graft_posteriors_on_the_mesh_equal_the_single_process(world):
    first = out(world, "tp_graft", 0)["mesh"]
    for rank in range(4):
        got = out(world, "tp_graft", rank)
        single, mesh = got["single"], got["mesh"]
        for key in ("plain", "guided"):
            assert np.isfinite(mesh[key]).all()
            np.testing.assert_allclose(mesh[key], single[key], rtol=1e-5,
                                       atol=1e-5, err_msg=key)
            np.testing.assert_array_equal(mesh[key], first[key])
    assert not np.allclose(first["plain"], first["guided"])
