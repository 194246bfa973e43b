"""The port's CondUNet against the flax CondUNet, same weights and inputs.

Encoder and ensemble denoiser at small widths (atol 1e-4), one case at
the real 4693 x 14 condition length with narrow widths (pins the
stride-2 "SAME" padding at 587 and 294), and the pieces with contracts
of their own: SAME padding, GroupNorm+SiLU, the timestep embedding.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.models.common import get_timestep_embedding as jax_temb
from ertdx.ops.groupnorm import reference_groupnorm_silu
from ertdx_torch.models import build_model
from ertdx_torch.configs import DDIM_ENSEMBLE, ModelConfig
from ertdx_torch.models.common import get_timestep_embedding
from ertdx_torch.models.condunet import GNSiLU, same_pad
from torch_parity_common import make_pair, t32


def _compare(fm, params, tm, cond, n_real, atol=1e-4, seed=4):
    b = cond.shape[0]
    p = tm.param_dim
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b * n_real, p)).astype(np.float32)
    t = rng.integers(0, 500, size=(b * n_real,)).astype(np.int32)
    ctx = fm.apply({"params": params}, jnp.asarray(cond),
                   method=fm.encode_condition)
    want = fm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                    ctx, n_real, method=fm.denoise_ensemble)
    with torch.no_grad():
        tctx = tm.encode_condition(t32(cond))
        got = tm.denoise_ensemble(t32(x), torch.from_numpy(t).long(), tctx,
                                  n_real)
    for a, g in zip(ctx, tctx):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), atol=atol,
                                   rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=1e-4)


@pytest.mark.parametrize("depth,n_real", [(2, 1), (3, 4)])
def test_condunet_matches_flax(depth, n_real):
    fm, params, tm = make_pair(depth=depth, num_blocks=2, seed=depth)
    cond = np.random.default_rng(1).normal(size=(2, 96, 4)).astype(
        np.float32)
    _compare(fm, params, tm, cond, n_real)


def test_condunet_full_call_matches_flax():
    """__call__ (encode + denoise) at one chain per condition."""
    fm, params, tm = make_pair(num_blocks=1, seed=7)
    rng = np.random.default_rng(2)
    cond = rng.normal(size=(3, 50, 4)).astype(np.float32)   # 50 -> pad 56
    x = rng.normal(size=(3, 29)).astype(np.float32)
    t = np.array([0, 250, 499], np.int32)
    want = fm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                    jnp.asarray(cond))
    with torch.no_grad():
        got = tm(t32(x), torch.from_numpy(t).long(), t32(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_condunet_reference_length_matches_flax():
    """4693 x 14 condition: patchify pads to 4696 (587 patches), then
    stride-2 convs pad (1, 1) at 587 and (0, 1) at 294 -> 147 tokens."""
    fm, params, tm = make_pair(d=16, cond_channels=14, cond_len=4693,
                               base_width=8, depth=3, num_heads=2,
                               num_blocks=1, seed=11)
    cond = np.random.default_rng(3).normal(size=(1, 4693, 14)).astype(
        np.float32)
    with torch.no_grad():
        tokens, _ = tm.encode_condition(t32(cond))
    assert tokens.shape == (1, 147, 16)
    _compare(fm, params, tm, cond, n_real=2)


@pytest.mark.parametrize("length,stride,pads", [
    (587, 2, (1, 1)), (294, 2, (0, 1)), (147, 1, (1, 1)), (10, 2, (0, 1)),
])
def test_same_pad_matches_xla(length, stride, pads):
    x = torch.arange(length, dtype=torch.float32).reshape(1, 1, length)
    got = same_pad(x, 3, stride)
    assert got.shape[-1] == length + sum(pads)
    assert torch.equal(got[..., pads[0]:pads[0] + length], x)
    want = jax.lax.padtype_to_pads((length,), (3,), (stride,), "SAME")
    assert tuple(want[0]) == pads


def test_gn_silu_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 37, 32)).astype(np.float32)
    gamma = rng.normal(size=(32,)).astype(np.float32)
    beta = rng.normal(size=(32,)).astype(np.float32)
    gn = GNSiLU(32)
    with torch.no_grad():
        gn.weight.copy_(t32(gamma))
        gn.bias.copy_(t32(beta))
        got = gn(t32(x))
    want = reference_groupnorm_silu(jnp.asarray(x), jnp.asarray(gamma),
                                    jnp.asarray(beta), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        GNSiLU(30)


@pytest.mark.parametrize("dim", [128, 33])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0, 1, 17, 250, 499], np.int32)
    got = get_timestep_embedding(torch.from_numpy(t), dim)
    want = jax_temb(jnp.asarray(t), dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


def test_build_model_configs3_and_refusals():
    m = build_model(DDIM_ENSEMBLE.model, device="cpu")
    assert (m.param_dim, m.hidden_dim, m.num_blocks, m.core_heads) == \
        (29, 128, 4, 1)
    assert len(m.encoder.downs) == 2
    assert not hasattr(m, "null_token")
    # a guided model builds, with its null context and the ensemble knobs
    g = build_model(dataclasses.replace(
        DDIM_ENSEMBLE.model, uncond_prob=0.1, ensemble_pallas=True,
        ensemble_min_chains=64), device="cpu")
    assert g.uncond_prob == 0.1 and g.null_token.shape == (128,)
    assert float(g.null_token.detach().std()) > 0 and not g.null_vec.any()
    assert all(b.ensemble_pallas and b.ensemble_min_chains == 64
               for b in g.blocks)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(ModelConfig(name="refmlp"), device="cpu")
    # a bf16 model builds with float32 params, with the GN kernels too,
    # and with the ensemble kernels (bf16 operands go in as float32
    # copies)
    bf = build_model(ModelConfig(name="condunet", dtype="bfloat16",
                                 pallas_gn=True), device="cpu")
    assert bf.compute_dtype == torch.bfloat16
    assert {p.dtype for p in bf.parameters()} == {torch.float32}
    be = build_model(ModelConfig(name="condunet", dtype="bfloat16",
                                 ensemble_pallas=True), device="cpu")
    assert be.compute_dtype == torch.bfloat16
    assert all(b.ensemble_pallas for b in be.blocks)


def test_build_model_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(DDIM_ENSEMBLE.model)
