"""The fused-encoder arm of the CondUNet against the flax CondUNet.

`pallas_gn` leaves the parameter tree alone; `pallas_conv` and
`pallas_conv_min_width` make the ResBlocks they reach hold
FusedGNConv_{0,1} (gn_scale, gn_bias, kernel (3, C, Cout), bias) in
place of GNSiLU_{0,1} and Conv_{0,1} (ertdx/models/condunet.py:62-111,
211-238). For each combination the port's `flax_shapes` must equal the
tree of flax's `CondUNet.init`, a perturbed flax tree must load with
`params_from_jax`, and the forward and the gradient of a loss must agree
with JAX's to the tolerances of tests/test_torch_train.py (outputs atol
and rtol 1e-4; gradients 1e-4 x max(1, max|g|) per leaf). On the CPU
both packages run their plain versions of the GN and conv kernels.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx_torch.models.condunet import FusedGNConv, GNSiLU
from ertdx_torch.utils.weights import (fused_blocks, flax_shapes,
                                       named_to_jax, params_to_jax)
from torch_parity_common import make_pair, t32

# the small model: stem 32 wide, the stage and the post-attention block
# 64 wide, so min width 64 fuses two ResBlocks of three
CONV_MODES = {"unfused": {}, "min_width": {"pallas_conv_min_width": 64},
              "all": {"pallas_conv": True}}


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("mode", sorted(CONV_MODES))
@pytest.mark.parametrize("pallas_gn", [False, True])
def test_fused_encoder_matches_flax(mode, pallas_gn):
    knobs = dict(pallas_gn=pallas_gn, **CONV_MODES[mode])
    fm, params, tm = make_pair(seed=21, num_blocks=1, **knobs)
    # the parameter tree: the repair's check
    want_shapes = jax.tree_util.tree_map(lambda a: tuple(np.shape(a)),
                                         params)
    assert flax_shapes(tm) == want_shapes
    n_fused = sum(isinstance(m, FusedGNConv) for m in tm.modules())
    assert n_fused == {"unfused": 0, "min_width": 4, "all": 6}[mode]
    assert len(fused_blocks(tm)) == n_fused // 2
    assert all(m.use_pallas == pallas_gn for m in tm.modules()
               if isinstance(m, GNSiLU))
    got_tree = params_to_jax(tm)
    assert all(np.array_equal(a, _leaves(params)[k])
               for k, a in _leaves(got_tree).items())

    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 29)).astype(np.float32)
    t = np.array([0, 123, 499], np.int32)
    cond = rng.normal(size=(3, 96, 4)).astype(np.float32)

    def loss(p):
        out = fm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(cond))
        return jnp.mean(out ** 2), out

    (_, want), gwant = jax.value_and_grad(loss, has_aux=True)(params)
    out = tm(t32(x), torch.from_numpy(t).long(), t32(cond))
    torch.mean(out ** 2).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    got = _leaves(named_to_jax(tm, {n: p.grad for n, p in
                                    tm.named_parameters()}))
    for key, w in _leaves(gwant).items():
        tol = 1e-4 * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(got[key] - w).max()) <= tol, key


def test_fused_block_paths():
    """The flax paths of a fused ResBlock's leaves, and its skip conv
    (flax's only nn.Conv of the block, hence Conv_0)."""
    from ertdx_torch.models.condunet import ResBlock1D
    from ertdx_torch.utils.weights import flax_path

    fused = frozenset({"encoder.res.1"})
    assert flax_path("encoder.res.1.fused2.kernel", 2, fused) == (
        "encoder", "ResBlock1D_1", "FusedGNConv_1", "kernel")
    assert flax_path("encoder.res.1.fused1.gn_scale", 2, fused) == (
        "encoder", "ResBlock1D_1", "FusedGNConv_0", "gn_scale")
    assert flax_path("encoder.res.1.skip.weight", 2, fused) == (
        "encoder", "ResBlock1D_1", "Conv_0", "kernel")
    assert flax_path("encoder.res.1.skip.weight", 2) == (
        "encoder", "ResBlock1D_1", "Conv_2", "kernel")
    blk = ResBlock1D(16, 24, pallas_conv=True)
    assert [n for n, _ in blk.named_parameters()] == [
        "fused1.gn_scale", "fused1.gn_bias", "fused1.kernel", "fused1.bias",
        "fused2.gn_scale", "fused2.gn_bias", "fused2.kernel", "fused2.bias",
        "skip.weight", "skip.bias"]
    assert blk(torch.zeros(2, 5, 16)).shape == (2, 5, 24)
