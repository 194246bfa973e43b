"""The port's mesh (ertdx_torch/parallel/) against ertdx/parallel/.

* `make_mesh` shapes in a world of one and in a 2-rank gloo world, and
  JAX's messages word for word: "{n} devices not divisible by model={m}"
  and "mesh {d}x{m} needs {d*m} devices, have {n}" (JAX's make_mesh on
  as many of conftest's fake devices as the world has ranks), and
  `global_batch`'s uneven-rows message;
* `pad_to_multiple` against JAX's;
* `global_batch` (process-major), `replicate_tree` (rank 0's values),
  `shard_batch` and `data.batch_iterator(mesh=)` in the 2-rank world;
* `tp_shard_params` picks exactly the leaves JAX's picks: at min_dim=64
  on a data=4 x model=2 fake mesh (JAX's choice read from each leaf's
  `sharding.spec`), plain and fused-conv trees, and at V5E8_DP's widths
  with min_dim=256 (34 leaves, 2,719,744 of 3,391,361 parameters);
* `mega_plan`'s mesh gate against JAX's (per-device chains; the batch
  must divide the data axis; no model axis).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx import configs as jconfigs
from ertdx.models import build_model as jbuild_model
from ertdx.models import mega as jmega
from ertdx.models.condunet import CondUNet as FlaxCondUNet
from ertdx.parallel import mesh as jmesh
from ertdx_torch import configs
from ertdx_torch.models import build_model
from ertdx_torch.models.condunet import CondUNet
from ertdx_torch.models.mega import mega_plan
from ertdx_torch.parallel import mesh
from torch_mesh_common import out, run_world
from torch_parity_common import make_pair


def _jax_message(**kw):
    with pytest.raises(ValueError) as e:
        jmesh.make_mesh(**kw)
    return str(e.value)


def test_make_mesh_in_a_world_of_one():
    m = mesh.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1}
    assert (m.rank, m.data_index, m.model_index) == (0, 0, 0)
    assert m.rows(8) is None and m.data_group is None
    devs = jax.devices()[:1]
    for kw in (dict(data=2), dict(data=1, model=2), dict(model=3, data=1)):
        with pytest.raises(ValueError) as e:
            mesh.make_mesh(device="cpu", **kw)
        assert str(e.value) == _jax_message(devices=devs, **kw)


@pytest.mark.parametrize("shape,multiple,axis", [
    ((10, 3), 8, 0), ((8, 3), 8, 0), ((3, 5), 4, 1), ((1,), 2, 0)])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 1
    got, n = mesh.pad_to_multiple(x, multiple, axis)
    want, jn = jmesh.pad_to_multiple(x, multiple, axis)
    assert n == jn
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    run_world(2, ["parallel_world"], tmp)
    return [out(tmp, "parallel", r) for r in range(2)]


def test_mesh_shapes_and_messages_in_a_2_rank_world(world):
    devs = jax.devices()[:2]
    for rank, got in enumerate(world):
        assert got["dp"] == ({"data": 2, "model": 1}, rank, 0,
                             slice(4 * rank, 4 * rank + 4), None)
        assert got["tp"] == ({"data": 1, "model": 2}, 0, rank, None)
        assert got["default"] == {"data": 2, "model": 1}
        assert got["errors"] == {
            "data4": _jax_message(data=4, devices=devs),
            "model3": _jax_message(model=3, devices=devs),
            "data1_model3": _jax_message(data=1, model=3, devices=devs)}
        assert got["uneven"] == (
            "global_batch: uneven per-process rows [3, 2]; pad local "
            "shards to a common size (data.pad_batch)")


def test_global_batch_replicate_tree_and_batch_rows(world):
    local = np.arange(6, dtype=np.float32).reshape(3, 2)
    for rank, got in enumerate(world):
        np.testing.assert_array_equal(got["global"],
                                      np.concatenate([local, local + 100]))
        a, b, weight = got["replicated"]
        np.testing.assert_array_equal(a, np.zeros(3, np.float32))
        np.testing.assert_array_equal(b, np.zeros(2, np.float32))
        np.testing.assert_array_equal(weight, np.ones((3, 2), np.float32))
        np.testing.assert_array_equal(got["shard"],
                                      np.arange(4 * rank, 4 * rank + 4))
        # batches of 4, 4 and a ragged 2: each divides the data axis
        want = [np.arange(s, s + 4)[2 * rank:2 * rank + 2] for s in (0, 4)]
        want.append(np.array([8 + rank]))
        for g, w in zip(got["batches"], want):
            np.testing.assert_array_equal(g, w)


def _jax_tp_leaves(params, data, model, min_dim):
    placed = jmesh.tp_shard_params(
        params, jmesh.make_mesh(data=data, model=model), min_dim=min_dim)
    return {tuple(str(getattr(k, "key", k)) for k in path)
            for path, leaf in jax.tree_util.tree_leaves_with_path(placed)
            if jmesh.MODEL_AXIS in tuple(leaf.sharding.spec)}


@pytest.mark.parametrize("knobs", [{}, {"pallas_conv": True,
                                        "uncond_prob": 0.1}])
def test_tp_leaves_match_jax_at_min_dim_64(knobs):
    _, params, tm = make_pair(**knobs)
    want = _jax_tp_leaves(params, 4, 2, 64)
    got = mesh.tp_leaves(tm, 2, 64)
    assert set(got.values()) == want
    assert want


def test_tp_leaves_match_jax_at_v5e8_widths():
    cfg = configs.V5E8_DP.model
    model = build_model(cfg, "cpu")
    got = mesh.tp_leaves(model, 2, 256)
    fm = jbuild_model(jconfigs.V5E8_DP.model)
    shapes = jax.eval_shape(
        fm.init, jax.random.key(0), jnp.zeros((1, cfg.param_dim)),
        jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, cfg.cond_length, cfg.cond_channels)))["params"]
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    want = _jax_tp_leaves(zeros, 4, 2, 256)
    assert set(got.values()) == want
    params = dict(model.named_parameters())
    assert len(got) == 34
    assert sum(params[n].numel() for n in got) == 2_719_744
    assert sum(p.numel() for p in model.parameters()) == 3_391_361


def _fake_mesh(data, model):
    return mesh.Mesh({"data": data, "model": model}, 0, 0, 0, None, None,
                     torch.device("cpu"))


def test_mega_plan_mesh_gate_matches_jax(monkeypatch):
    kw = dict(param_dim=29, hidden_dim=128, cond_channels=4, base_width=16,
              depth=2, num_blocks=2, num_heads=2, core_heads=1,
              ensemble_mega=True)
    fm = FlaxCondUNet(**kw)
    tm = CondUNet(**kw)
    monkeypatch.setattr(jmega.jax, "default_backend", lambda: "tpu")
    for (d, m), (r, b) in [((4, 1), (1000, 32)), ((4, 1), (1000, 30)),
                           ((4, 1), (64, 8)), ((4, 2), (1000, 32)),
                           ((2, 1), (1000, 8)), ((1, 1), (1000, 4))]:
        want = jmega.mega_plan(fm, r, b, jmesh.make_mesh(data=d, model=m))
        got = mega_plan(tm, r, b, device="cuda", mesh=_fake_mesh(d, m))
        assert (got is None) == (want is None), (d, m, r, b)
    # per-device chains: 8000 clear the gate in one process, 2000 a
    # device on a 4-way mesh do not
    assert mega_plan(tm, 1000, 8, device="cuda") is not None
    assert mega_plan(tm, 1000, 8, device="cuda",
                     mesh=_fake_mesh(4, 1)) is None


def test_check_mesh_refuses_a_non_mesh():
    with pytest.raises(TypeError, match="make_mesh"):
        mesh.check_mesh(object())
    assert mesh.check_mesh(None) is None
    m = _fake_mesh(1, 1)
    assert mesh.check_mesh(m) is m
    assert dataclasses.is_dataclass(m)
