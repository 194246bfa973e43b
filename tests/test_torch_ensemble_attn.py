"""The port's ensemble attention (ops/ensemble_attn.py) against the JAX
package's TPU kernels run in interpret mode, and the CondUNet's fused
ensemble branch against the JAX model with those kernels patched in (as
tests/test_models.py does for JAX alone). Tolerance 2e-5, as there.

The CUDA kernels themselves run only on a card (tests/test_torch_gpu.py);
here the wrappers take the plain version because the tensors are on the
CPU, and the autograd Function is exercised with the plain version in
the kernel's place.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.models import condunet as jcu
from ertdx.ops.ensemble_attn import (block_self_attention_interpret,
                                     folded_cross_attention_interpret)
from ertdx_torch.ops import ensemble_attn as ea
from torch_parity_common import make_pair, t32


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("n,p,d", [(16, 29, 32), (8, 29, 128), (24, 5, 64)])
def test_block_self_attention_matches_the_tpu_kernel(n, p, d):
    rng = np.random.default_rng(n + p + d)
    q, k, v = (_rand(rng, n, p, d) for _ in range(3))
    want = block_self_attention_interpret(*map(jnp.asarray, (q, k, v)))
    ea.reset_launches()
    got = ea.block_self_attention(t32(q), t32(k), t32(v))
    assert ea.launches["block_self_attention"] == 0   # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("b,lq,lk,d", [(2, 8 * 29, 24, 32),
                                       (1, 16 * 29, 147, 128),
                                       (3, 40, 130, 64)])
def test_folded_cross_attention_matches_the_tpu_kernel(b, lq, lk, d):
    rng = np.random.default_rng(b + lq + lk)
    q = _rand(rng, b, lq, d)
    k, v = _rand(rng, b, lk, d), _rand(rng, b, lk, d)
    want = folded_cross_attention_interpret(*map(jnp.asarray, (q, k, v)))
    ea.reset_launches()
    got = ea.folded_cross_attention(t32(q), t32(k), t32(v))
    assert ea.launches["folded_cross_attention"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_condunet_ensemble_branch_matches_jax(monkeypatch):
    """CondUNet(ensemble_pallas=True, ensemble_min_chains=1): the port's
    fused branch against the JAX model on its interpret-mode kernels,
    through the whole denoise_ensemble (fold reshapes, strided q/k/v)."""
    fm, params, tm = make_pair(num_blocks=2, seed=51, scale=0.1,
                               ensemble_pallas=True, ensemble_min_chains=1)
    assert all(blk.ensemble_pallas for blk in tm.blocks)
    monkeypatch.setattr(jcu, "block_self_attention",
                        block_self_attention_interpret)
    monkeypatch.setattr(jcu, "folded_cross_attention",
                        folded_cross_attention_interpret)
    monkeypatch.setattr(jcu, "block_self_attention_ok", lambda *a: True)
    monkeypatch.setattr(jcu, "folded_cross_attention_ok", lambda *a: True)
    rng = np.random.default_rng(5)
    b, r, p = 4, 8, 29
    cond = rng.normal(size=(b, 96, 4)).astype(np.float32)
    x = rng.normal(size=(b * r, p)).astype(np.float32)
    t = rng.integers(0, 10, size=(b * r,)).astype(np.int32)
    v = {"params": params}
    ctx = fm.apply(v, jnp.asarray(cond), method=fm.encode_condition)
    want = fm.apply(v, jnp.asarray(x), jnp.asarray(t), ctx, r,
                    method=fm.denoise_ensemble)
    calls = []
    real = ea.reference_attention
    monkeypatch.setattr(ea, "reference_attention",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        tctx = tm.encode_condition(t32(cond))
        got = tm.denoise_ensemble(t32(x), torch.from_numpy(t).long(), tctx,
                                  r)
    assert len(calls) == 2 * 2     # both attentions of both blocks
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_branch_engages_as_in_jax(monkeypatch):
    """One head, fold > 1 and at least ensemble_min_chains chains; else
    the head-split path, whatever the knob says."""
    _, _, tm = make_pair(num_blocks=1, ensemble_pallas=True,
                         ensemble_min_chains=16)
    blk = tm.blocks[0]
    calls = []
    real = ea.reference_attention
    monkeypatch.setattr(ea, "reference_attention",
                        lambda *a: calls.append(1) or real(*a))
    d = tm.hidden_dim
    with torch.no_grad():
        for chains, fold, want in ((16, 4, 2), (15, 5, 0), (16, 1, 0)):
            calls.clear()
            blk(torch.randn(chains, 29, d), torch.randn(chains // fold, 7, d),
                torch.randn(chains, d), fold=fold)
            assert len(calls) == want, (chains, fold)


@pytest.mark.parametrize("which", ["self", "cross"])
def test_function_gradients_equal_the_plain_versions(which):
    """The autograd Function's backward (autograd of the plain version,
    recomputed from the saved inputs) gives the plain version's gradients,
    for strided q/k/v views as the model passes them."""
    g = torch.Generator().manual_seed(3)
    if which == "self":
        base = torch.randn(6, 29, 3 * 32, generator=g)
        parts = lambda z: z.chunk(3, dim=-1)
    else:
        qb = torch.randn(2, 3 * 29, 32, generator=g)
        kvb = torch.randn(2, 11, 64, generator=g)
        base = (qb, kvb)
        parts = lambda z: (z[0], *z[1].chunk(2, dim=-1))
    leaves = ([base.clone().requires_grad_(True) for _ in range(2)]
              if which == "self" else
              [tuple(t.clone().requires_grad_(True) for t in base)
               for _ in range(2)])
    do = None
    outs = []
    for i, leaf in enumerate(leaves):
        q, k, v = parts(leaf)
        if i == 0:
            out = ea._KernelAttention.apply(ea.reference_attention, q, k, v)
        else:
            out = ea.reference_attention(q, k, v)
        if do is None:
            do = torch.randn(out.shape, generator=g)
        out.backward(do)
        outs.append(out.detach())
    assert torch.equal(outs[0], outs[1])
    flat = [[leaf] if which == "self" else list(leaf) for leaf in leaves]
    for a, b in zip(*flat):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=1e-6)


def test_gates_and_layout_checks():
    assert ea.block_self_ok(2000, 29, 128) and ea.block_self_ok(1, 1, 64)
    assert not ea.block_self_ok(8, 33, 128)      # more than 32 keys
    assert not ea.block_self_ok(8, 29, 32)       # a width not built
    assert ea.folded_cross_ok(2, 29000, 147, 128)
    assert ea.folded_cross_ok(1, 1, 256, 64)
    assert ea.folded_cross_ok(1, 29 * 3, 173, 128)   # the edges the gate
    assert ea.folded_cross_ok(2, 40, 256, 64)        # must keep taking
    assert not ea.folded_cross_ok(2, 100, 257, 64)
    assert not ea.folded_cross_ok(2, 100, 250, 128)  # K, V exceed 227 KB
    qkv = torch.zeros(4, 29, 3 * 128)
    for part in qkv.chunk(3, dim=-1):
        assert ea._row_stride("q", part) == 3 * 128
    assert ea._row_stride("q", torch.zeros(2, 7, 128)) == 128
    with pytest.raises(ValueError, match="stride"):
        ea._row_stride("q", torch.zeros(4, 128, 29).transpose(1, 2))
    with pytest.raises(ValueError, match="stride"):
        ea._row_stride("q", qkv[:, ::2, :128])
    with pytest.raises(ValueError, match="CUDA"):
        ea.block_self_attention_fwd(*(torch.zeros(4, 29, 128),) * 3)
    with pytest.raises(ValueError, match="does not take"):
        ea.folded_cross_attention_fwd(torch.zeros(1, 8, 128),
                                      torch.zeros(1, 300, 128),
                                      torch.zeros(1, 300, 128))
