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
              depth=2, num_heads=2, num_blocks=2, seed=0, scale=0.05,
              attn_slab=False, parameterization="eps", uncond_prob=0.0,
              ensemble_pallas=False, ensemble_min_chains=1024,
              pallas_gn=False, pallas_conv=False, pallas_conv_min_width=0,
              use_pallas=True, flash_min_logits=0, dtype="float32"):
    """(flax model, numpy params, torch model on the CPU), both computing
    in `dtype` (float32 or bfloat16; the params are float32). With
    uncond_prob > 0 both carry the guidance null context (perturbed, so
    null_vec is non-zero); `pallas_conv` or `pallas_conv_min_width` give
    both the fused ResBlocks' parameter tree; `use_pallas` and
    `flash_min_logits` set the encoder attention's dispatch."""
    knobs = dict(attn_slab=attn_slab, parameterization=parameterization,
                 uncond_prob=uncond_prob, ensemble_pallas=ensemble_pallas,
                 ensemble_min_chains=ensemble_min_chains,
                 pallas_gn=pallas_gn, pallas_conv=pallas_conv,
                 pallas_conv_min_width=pallas_conv_min_width,
                 use_pallas=use_pallas, flash_min_logits=flash_min_logits)
    fm = FlaxCondUNet(param_dim=p, hidden_dim=d, cond_channels=cond_channels,
                      base_width=base_width, depth=depth,
                      num_heads=num_heads, core_heads=1,
                      num_blocks=num_blocks, dtype=jnp.dtype(dtype),
                      **knobs)
    # jitted: an eager flax init of the CondUNet takes about 4x as long
    variables = jax.jit(fm.init)(jax.random.key(seed), jnp.zeros((1, p)),
                                 jnp.zeros((1,), jnp.int32),
                                 jnp.zeros((1, cond_len, cond_channels)))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(a.shape)
                   ).astype(np.float32), variables["params"])
    tm = TorchCondUNet(param_dim=p, hidden_dim=d,
                       cond_channels=cond_channels, base_width=base_width,
                       depth=depth, num_heads=num_heads, core_heads=1,
                       num_blocks=num_blocks, dtype=dtype, **knobs)
    params_from_jax(tm, params)
    return fm, params, tm


def t32(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
