"""Shared set-up for the port's parity tests: one CondUNet, two packages.

A flax CondUNet is initialised, every parameter is perturbed (the
zero-initialised AdaLN projections, output projections and head would
otherwise make a comparison empty, as tests/test_ops.py notes), and the
same numbers are loaded into the torch CondUNet with `params_from_jax`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ertdx.models.condunet import CondUNet as FlaxCondUNet
from ertdx_torch.models.condunet import CondUNet as TorchCondUNet
from ertdx_torch.utils.weights import params_from_jax


def numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def make_pair(*, p=29, d=32, cond_channels=4, cond_len=96, base_width=16,
              depth=2, num_heads=2, num_blocks=2, seed=0, scale=0.05):
    """(flax model, numpy params, torch model on the CPU)."""
    fm = FlaxCondUNet(param_dim=p, hidden_dim=d, cond_channels=cond_channels,
                      base_width=base_width, depth=depth,
                      num_heads=num_heads, core_heads=1,
                      num_blocks=num_blocks)
    variables = fm.init(jax.random.key(seed), jnp.zeros((1, p)),
                        jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1, cond_len, cond_channels)))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(a.shape)
                   ).astype(np.float32), variables["params"])
    tm = TorchCondUNet(param_dim=p, hidden_dim=d,
                       cond_channels=cond_channels, base_width=base_width,
                       depth=depth, num_heads=num_heads, core_heads=1,
                       num_blocks=num_blocks)
    params_from_jax(tm, params)
    return fm, params, tm


def t32(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
