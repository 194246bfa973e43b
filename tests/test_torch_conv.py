"""The port's GroupNorm+SiLU+Conv1d(k=3) against the JAX package's TPU
kernels.

Inputs come from a seeded numpy generator. JAX runs its Pallas kernels in
interpret mode on the CPU (`gn_silu_conv3_interpret`,
`gn_silu_conv3_backward_interpret`); the port runs its CPU path, the
plain version (GN+SiLU then a SAME `F.conv1d`) under autograd, which is
also what its CUDA kernels are held against on the card. The shapes
include Cout != C and the edge rows at L=1 and L=2.

Tolerances: the output and dx at 1e-5 x max(1, max|ref|); dgamma, dbeta,
dW and db at 1e-4 x max(1, max|ref|), because each is a sum over B x L
products (dW of 3C x Cout of them).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.ops.conv import (gn_silu_conv3_backward_interpret,
                            gn_silu_conv3_interpret)
from ertdx_torch.ops import conv as cv
from torch_parity_common import t32


def _inputs(b, l, c, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    gamma = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.3 * rng.standard_normal(c)).astype(np.float32)
    w = (rng.standard_normal((3, c, cout)) / np.sqrt(3 * c)).astype(
        np.float32)
    bias = (0.3 * rng.standard_normal(cout)).astype(np.float32)
    g = rng.standard_normal((b, l, cout)).astype(np.float32)
    return x, gamma, beta, w, bias, g


def _close(got, want, rel):
    want = np.asarray(want)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("b,l,c,cout", [
    (2, 37, 16, 16), (2, 20, 16, 24), (3, 9, 32, 8), (2, 1, 8, 4),
    (2, 2, 16, 16), (1, 61, 64, 72)])
def test_gn_silu_conv3_matches_the_tpu_kernel(b, l, c, cout):
    x, gamma, beta, w, bias, g = _inputs(b, l, c, cout, seed=b + l + cout)
    jin = [jnp.asarray(a) for a in (x, gamma, beta, w, bias)]
    want = gn_silu_conv3_interpret(*jin, num_groups=8)
    wgrads = gn_silu_conv3_backward_interpret(*jin, jnp.asarray(g),
                                              num_groups=8)
    leaves = [t32(a).requires_grad_(True)
              for a in (x, gamma, beta, w, bias)]
    out = cv.gn_silu_conv3(*leaves, 8)
    out.backward(t32(g))
    assert out.shape == (b, l, cout)
    _close(out.detach().numpy(), want, 1e-5)
    for leaf, want_g, rel in zip(leaves, wgrads,
                                 (1e-5, 1e-4, 1e-4, 1e-4, 1e-4)):
        assert leaf.grad.shape == tuple(np.shape(want_g))
        _close(leaf.grad.numpy(), want_g, rel)


def test_plain_backward_is_autograd_of_the_plain_version():
    x, gamma, beta, w, bias, g = _inputs(2, 13, 16, 8, seed=3)
    args = [t32(a) for a in (x, gamma, beta, w, bias)]
    got = cv.reference_gn_silu_conv3_backward(*args, t32(g), 8)
    leaves = [a.clone().requires_grad_(True) for a in args]
    cv.gn_silu_conv3(*leaves, 8).backward(t32(g))
    for a, leaf in zip(got, leaves):
        assert torch.equal(a, leaf.grad)


def test_channels_not_divisible_by_the_groups_raise():
    x = torch.zeros(2, 5, 12)
    with pytest.raises(ValueError, match="not divisible"):
        cv.gn_silu_conv3(x, torch.ones(12), torch.zeros(12),
                         torch.zeros(3, 12, 4), torch.zeros(4), 8)


def test_dw_splits_fill_the_card_in_one_wave():
    # blocks of 64 x 128 output channels, one an SM
    assert cv.dw_splits(256, 256, 256, 132) == 16   # 8 tiles x 16 <= 132
    assert cv.dw_splits(256, 128, 128, 132) == 66   # 2 tiles x 66 = 132
    assert cv.dw_splits(256, 256, 64, 132) == 33    # 4 tiles x 33 = 132
    assert cv.dw_splits(3, 64, 72, 132) == 3        # one split a batch row
    assert cv.dw_splits(1, 1024, 1024, 132) == 1


def test_cpu_tensors_never_reach_the_kernel_wrappers():
    x, gamma, beta, w, bias, _ = _inputs(1, 4, 8, 4, seed=1)
    cv.reset_launches()
    cv.gn_silu_conv3(*(t32(a) for a in (x, gamma, beta, w, bias)), 8)
    assert cv.launches == {"gn_silu_conv3_fwd": 0, "gn_silu_conv3_bwd": 0}
    with pytest.raises(ValueError, match="CUDA"):
        cv.gn_silu_conv3_fwd(*(t32(a) for a in (x, gamma, beta, w, bias)),
                             8)
