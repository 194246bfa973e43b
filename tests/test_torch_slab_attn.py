"""The port's slab attention against the JAX package's Pallas kernels.

The same numpy slab goes through JAX's interpret-mode forward and
backward kernels (`slab_attention_interpret`,
`slab_attention_backward_interpret`, as tests/test_ops.py runs them) and
through the port's `slab_attention` on the CPU, which is its plain
version under autograd. Tolerances: 2e-5 for the forward, 2e-4 for the
backward (the interpret kernels' block-diagonal packing sums in another
order than the head-split version).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.ops.slab_attn import (slab_attention_backward_interpret,
                                 slab_attention_interpret)
from ertdx_torch.ops import slab_attn as sa


@pytest.mark.parametrize("b,l,c,nh", [
    (2, 147, 256, 4),     # the encoder's deepest stage (dh=64)
    (2, 40, 64, 1),       # one head, short length
    (2, 147, 256, 8),     # dh=32
])
def test_slab_attention_matches_the_pallas_kernels(b, l, c, nh):
    rng = np.random.default_rng(b * 1000 + l + nh)
    qkv = rng.normal(size=(b, l, 3 * c)).astype(np.float32)
    do = rng.normal(size=(b, l, c)).astype(np.float32)
    want = np.asarray(slab_attention_interpret(jnp.asarray(qkv), nh))
    dwant = np.asarray(slab_attention_backward_interpret(
        jnp.asarray(qkv), jnp.asarray(do), nh))

    z = torch.from_numpy(qkv).requires_grad_(True)
    got = sa.slab_attention(z, nh)
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(z.grad.numpy(), dwant, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        sa.reference_slab_attention_backward(
            torch.from_numpy(qkv), torch.from_numpy(do), nh).numpy(),
        dwant, rtol=2e-4, atol=2e-4)


def test_cpu_path_launches_nothing():
    sa.reset_launches()
    z = torch.randn(1, 16, 3 * 64, requires_grad=True)
    sa.slab_attention(z, 1).sum().backward()
    assert sa.launches == {"slab_attention_fwd": 0,
                           "slab_attention_bwd": 0}


@pytest.mark.parametrize("b,l,c,nh,ok", [
    (256, 147, 256, 4, True), (4, 147, 256, 8, True), (2, 256, 64, 1, True),
    (2, 257, 64, 1, False),   # longer than the kernels' shared-memory plan
    (2, 40, 96, 1, False),    # dh=96 is not a kernel head width
    (2, 40, 256, 3, False),   # heads do not split C
    (2, 40, 512, 4, False),   # dh=128
])
def test_gate(b, l, c, nh, ok):
    assert sa.slab_attention_ok(b, l, c, nh) is ok


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: they never compute the
    plain version themselves."""
    qkv = torch.randn(1, 8, 3 * 64)
    with pytest.raises(ValueError, match="CUDA"):
        sa.slab_attention_fwd(qkv, 1)
    with pytest.raises(ValueError, match="CUDA"):
        sa.slab_attention_bwd(qkv, torch.randn(1, 8, 64), 1)
