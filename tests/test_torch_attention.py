"""The port's flash attention against the JAX package's Pallas kernels.

The same numpy q, k, v, mask and dO go through JAX's interpret-mode
kernels (`flash_attention_interpret`, `flash_attention_backward_interpret`
and `_flash_forward(..., interpret=True)` for the logsumexp, as
tests/test_ops.py runs them) and through the port on the CPU:
`flash_attention` (its plain version under autograd there),
`reference_flash_forward` and `reference_flash_backward` (the CUDA
kernels' arithmetic from a saved (O, lse)). Cases: masked, several
blocks (L=256), Dh 64 and 128, and a batch row whose keys are all
masked. Tolerances: the forward 2e-5 (tests/test_models.py:296-297);
gradients 1e-4 x max(1, max|ref|).

A row with every key masked is where the functions part: the kernels
give the uniform mean of V and, in the backward, p = exp(s - lse) = 1
(lse rounds to -1e30), while autograd of the plain version gives p =
1/Lk. The port's kernel oracle follows the kernels; autograd is compared
only where each batch row has a valid key.
"""
from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.ops.attention import (_flash_forward,
                                 flash_attention_backward_interpret,
                                 flash_attention_interpret,
                                 flash_cross_attention_interpret)
from ertdx_torch.ops import attention as at

# (b, h, l, d, mask kind): "none", "tail" (the last keys of every row
# masked, as the encoder pads 147 -> 256), "row" (tail, and batch row 1
# with every key masked)
CASES = [(2, 2, 128, 64, "tail"), (1, 2, 256, 64, "none"),
         (2, 1, 256, 64, "tail"), (1, 2, 128, 128, "tail"),
         (2, 2, 128, 64, "row")]


def _inputs(b, h, l, d, kind, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, h, l, d)).astype(np.float32)
                   for _ in range(4))
    mask = None
    if kind != "none":
        mask = np.ones((b, l), np.float32)
        mask[:, int(0.6 * l):] = 0.0
        if kind == "row":
            mask[1] = 0.0
    return q, k, v, do, mask


def _close(got, want, rel):
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol, (err, tol)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("b,h,l,d,kind", CASES)
def test_forward_matches_the_pallas_kernel(b, h, l, d, kind):
    q, k, v, _, mask = _inputs(b, h, l, d, kind, seed=l + d + b)
    want = np.asarray(flash_attention_interpret(_j(q), _j(k), _j(v),
                                                _j(mask)))
    _, want_lse = _flash_forward(_j(q), _j(k), _j(v), _j(mask),
                                 interpret=True)
    got = at.flash_attention(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    out, lse = at.reference_flash_forward(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.reshape(b * h, l).numpy(),
                               np.asarray(want_lse), rtol=2e-5, atol=2e-5)
    if kind == "row":   # uniform mean of V over all keys, padded included
        np.testing.assert_allclose(out[1].numpy(),
                                   np.broadcast_to(v[1].mean(axis=1,
                                                             keepdims=True),
                                                   out[1].shape),
                                   rtol=2e-5, atol=2e-5)
        assert (lse[1] == -1e30).all()


@pytest.mark.parametrize("b,h,l,d,kind", CASES)
def test_backward_matches_the_pallas_kernels(b, h, l, d, kind):
    q, k, v, do, mask = _inputs(b, h, l, d, kind, seed=7 * l + d + b)
    want = flash_attention_backward_interpret(_j(q), _j(k), _j(v),
                                              _j(mask), _j(do))
    out, lse = at.reference_flash_forward(_t(q), _t(k), _t(v), _t(mask))
    got = at.reference_flash_backward(_t(q), _t(k), _t(v), _t(mask), out,
                                      lse, _t(do))
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-4)
    if kind == "row":
        return
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    at.flash_attention(*leaves, _t(mask)).backward(_t(do))
    for leaf, w in zip(leaves, want):
        _close(leaf.grad.numpy(), w, 1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention_matches_the_padded_kernel(masked):
    """Dh=40 pads to 64 (q pre-scaled), Lq=300 and Lk=147 pad to 384 and
    256; the port's padded call on the CPU and its public wrapper (the
    plain version there) against JAX's interpret-mode padded kernel."""
    rng = np.random.default_rng(3 + masked)
    q = rng.normal(size=(2, 2, 300, 40)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, 147, 40)).astype(np.float32)
            for _ in range(2))
    mask = None
    if masked:
        mask = np.ones((2, 147), np.float32)
        mask[0, 100:] = 0.0
    want = np.asarray(flash_cross_attention_interpret(_j(q), _j(k), _j(v),
                                                      _j(mask)))
    padded = at.flash_cross_padded(_t(q), _t(k), _t(v), _t(mask))
    public = at.flash_cross_attention(_t(q), _t(k), _t(v), _t(mask),
                                      min_q_len=1)
    assert padded.shape == public.shape == (2, 2, 300, 40)
    np.testing.assert_allclose(padded.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(public.numpy(), want, rtol=2e-5, atol=2e-5)


def test_cpu_calls_launch_nothing():
    at.reset_launches()
    q, k, v = (torch.randn(1, 2, 128, 64, requires_grad=True)
               for _ in range(3))
    at.flash_attention(q, k, v, torch.ones(1, 128)).sum().backward()
    at.flash_cross_padded(q.detach(), k.detach(), v.detach())
    assert at.launches == {"flash_attention_fwd": 0,
                           "flash_attention_bwd_dq": 0,
                           "flash_attention_bwd_dkv": 0}


def test_cpu_calls_at_refused_shapes_do_not_warn(recwarn):
    """The plain version is the CPU's path by design: only a CUDA call the
    kernels refuse warns."""
    q = torch.randn(1, 2, 147, 16)
    got = at.flash_attention(q, q, q)
    torch.testing.assert_close(got, at.reference_attention(q, q, q),
                               rtol=0, atol=0)
    assert not [w for w in recwarn if "flash_attention" in str(w.message)]


def test_warn_unaligned_warns_once_per_shape():
    q, k = torch.empty(1, 1, 256, 16), torch.empty(1, 1, 256, 16)
    at._warned.discard((256, 256, 16))
    with pytest.warns(UserWarning, match="Lq=256, Lk=256, Dh=16"):
        at.warn_unaligned(q, k)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        at.warn_unaligned(q, k)
    at._warned.discard((256, 256, 16))


@pytest.mark.parametrize("lq,lk,d,ok", [
    (256, 256, 64, True), (1024, 1024, 64, True), (128, 256, 128, True),
    (128, 128, 256, True), (147, 256, 64, False), (256, 200, 64, False),
    (128, 128, 32, False), (128, 128, 512, False)])
def test_aligned_is_jax_rule(lq, lk, d, ok):
    assert at.aligned(torch.empty(1, 1, lq, d),
                      torch.empty(1, 1, lk, d)) is ok


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: they never compute the
    plain version themselves."""
    q = torch.randn(1, 1, 128, 64)
    with pytest.raises(ValueError, match="CUDA"):
        at.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        at.flash_attention_bwd(q, q, q, None, q, torch.zeros(1, 1, 128), q)
