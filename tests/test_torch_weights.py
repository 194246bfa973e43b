"""params_from_jax: every flax leaf lands in exactly one torch parameter."""
from __future__ import annotations

import copy

import jax
import numpy as np
import pytest

from ertdx_torch.utils.weights import flax_path, flax_shapes, params_from_jax
from torch_parity_common import make_pair


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield prefix + (key,), val


@pytest.mark.parametrize("depth", [2, 3])
def test_every_leaf_used_exactly_once(depth):
    _, params, tm = make_pair(depth=depth, num_blocks=3, seed=depth)
    leaves = dict(_flat(params))
    paths = [flax_path(n, tm.depth) for n, _ in tm.named_parameters()]
    assert len(paths) == len(set(paths)) == len(leaves)
    assert set(paths) == set(leaves)
    for name, param in tm.named_parameters():
        path = flax_path(name, tm.depth)
        leaf = np.asarray(leaves[path])
        if path[-1] == "kernel":
            leaf = leaf.transpose()
        np.testing.assert_array_equal(param.detach().numpy(), leaf)


def test_flax_shapes_is_the_flax_layout():
    _, params, tm = make_pair(depth=3, num_blocks=2)
    shapes = jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), params)
    assert flax_shapes(tm) == dict(shapes)


def test_missing_leaf_raises():
    _, params, tm = make_pair(num_blocks=1)
    bad = copy.deepcopy(dict(params))
    del bad["blocks_0"]["Dense_5"]["bias"]
    with pytest.raises(KeyError, match="blocks_0/Dense_5/bias"):
        params_from_jax(tm, bad)


def test_unused_leaf_raises():
    _, params, tm = make_pair(num_blocks=1)
    bad = copy.deepcopy(dict(params))
    bad["encoder"]["Dense_9"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="encoder/Dense_9/kernel"):
        params_from_jax(tm, bad)


def test_shape_mismatch_raises():
    _, params, tm = make_pair(num_blocks=1)
    bad = copy.deepcopy(dict(params))
    bad["lift"]["kernel"] = np.zeros((2, 32), np.float32)
    with pytest.raises(ValueError, match="lift/kernel"):
        params_from_jax(tm, bad)


def test_flax_paths_of_the_core_block():
    """Block names as ertdx/models/mega.py extracts them."""
    assert flax_path("blocks.2.ada3.proj.weight", 3) == (
        "blocks_2", "AdaLN_2", "Dense_0", "kernel")
    assert flax_path("blocks.0.cross_kv.weight", 3) == (
        "blocks_0", "Dense_3", "kernel")
    assert flax_path("blocks.1.mlp_out.bias", 3) == (
        "blocks_1", "Dense_6", "bias")
    assert flax_path("encoder.res_out.norm2.weight", 3) == (
        "encoder", "ResBlock1D_3", "GNSiLU_1", "scale")
    assert flax_path("encoder.attn.norm.bias", 3) == (
        "encoder", "SelfAttention1D_0", "LayerNorm_0", "bias")
    assert flax_path("encoder.downs.1.weight", 3) == (
        "encoder", "Conv_1", "kernel")
    assert flax_path("out_norm.weight", 3) == ("out_norm", "scale")
    assert flax_path("pos_emb", 3) == ("pos_emb",)
    with pytest.raises(KeyError):
        flax_path("encoder.nowhere.weight", 3)
