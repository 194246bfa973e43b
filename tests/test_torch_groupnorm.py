"""The port's GroupNorm+SiLU against the JAX package's TPU kernels.

Inputs come from a seeded numpy generator. JAX runs its Pallas kernels in
interpret mode on the CPU (`groupnorm_silu_interpret`,
`groupnorm_silu_backward_interpret`, as tests/test_ops.py runs them);
the port runs its CPU path, the plain version under autograd, which is
also what its CUDA kernels are held against on the card.

Tolerances: the forward and dx at 1e-5 x max(1, max|ref|) (float32
reductions over L x C/G values in another order); dgamma and dbeta at
1e-4 relative to max(1, max|ref|), because each is a sum over B x L
products.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.ops.groupnorm import (groupnorm_silu_backward_interpret,
                                 groupnorm_silu_interpret)
from ertdx_torch.ops import groupnorm as gn
from torch_parity_common import t32


def _inputs(b, l, c, seed):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((b, l, c)) + 0.5).astype(np.float32)
    gamma = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.3 * rng.standard_normal(c)).astype(np.float32)
    g = rng.standard_normal((b, l, c)).astype(np.float32)
    return x, gamma, beta, g


def _close(got, want, rel):
    want = np.asarray(want)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("b,l,c", [(2, 37, 16), (3, 96, 64), (1, 1, 8),
                                   (2, 5, 72)])
def test_groupnorm_silu_matches_the_tpu_kernel(b, l, c):
    x, gamma, beta, g = _inputs(b, l, c, seed=b * l + c)
    want = groupnorm_silu_interpret(jnp.asarray(x), jnp.asarray(gamma),
                                    jnp.asarray(beta), num_groups=8)
    wdx, wdg, wdb = groupnorm_silu_backward_interpret(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
        jnp.asarray(g), num_groups=8)
    tx, tg, tb = (t32(a).requires_grad_(True) for a in (x, gamma, beta))
    out = gn.groupnorm_silu(tx, tg, tb, 8)
    out.backward(t32(g))
    _close(out.detach().numpy(), want, 1e-5)
    _close(tx.grad.numpy(), wdx, 1e-5)
    _close(tg.grad.numpy(), wdg, 1e-4)
    _close(tb.grad.numpy(), wdb, 1e-4)


def test_plain_backward_is_autograd_of_the_plain_version():
    x, gamma, beta, g = _inputs(2, 11, 24, seed=5)
    args = [t32(a) for a in (x, gamma, beta)]
    got = gn.reference_groupnorm_silu_backward(*args, t32(g), 8)
    leaves = [a.clone().requires_grad_(True) for a in args]
    gn.groupnorm_silu(*leaves, 8).backward(t32(g))
    for a, leaf in zip(got, leaves):
        assert torch.equal(a, leaf.grad)


def test_channels_not_divisible_by_the_groups_raise():
    x = torch.zeros(2, 5, 12)
    with pytest.raises(ValueError, match="not divisible"):
        gn.groupnorm_silu(x, torch.ones(12), torch.zeros(12), 8)
    with pytest.raises(ValueError, match="not divisible"):
        gn.reference_groupnorm_silu(x, torch.ones(12), torch.zeros(12), 8)


def test_cpu_tensors_never_reach_the_kernel_wrappers():
    """The wrappers take CUDA tensors only; the CPU path launches
    nothing."""
    x, gamma, beta, _ = _inputs(1, 4, 8, seed=1)
    gn.reset_launches()
    gn.groupnorm_silu(t32(x), t32(gamma), t32(beta), 8)
    assert gn.launches == {"groupnorm_silu_fwd": 0, "groupnorm_silu_bwd": 0}
    with pytest.raises(ValueError, match="CUDA"):
        gn.groupnorm_silu_fwd(t32(x), t32(gamma), t32(beta), 8)
