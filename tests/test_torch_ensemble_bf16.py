"""bfloat16 on the per-block ensemble attention, against the JAX package,
on the CPU.

* The port's plain ensemble attention (`reference_attention`) on bf16
  q, k, v against JAX's `_self_reference` and `_cross_reference` (what
  its custom VJPs and its off-TPU forwards run): logits accumulated and
  softmaxed in float32, the probabilities cast to v's dtype.
* A small bf16 `CondUNet(ensemble_pallas=True)` loaded with
  `params_from_jax` against flax's bf16 model with the same params, the
  chains above the gate (fold > 1, `ensemble_min_chains` lowered as the
  JAX tests lower it, the fused core off so the per-block path runs):
  one denoiser call and a DDIM posterior ensemble within the JAX
  package's bf16 band (rtol = atol = 5e-2, tests/test_ops.py:568-571),
  and the dtypes.

On the CPU the port's wrappers run the plain version because the
tensors lie on the CPU; the CUDA kernels on bf16 operands are held
against the plain version in tests/test_torch_gpu.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx import diffusion as jdiff
from ertdx import sample as jsample
from ertdx.configs import SampleConfig as JaxSampleConfig
from ertdx.models.condunet import CondUNet as FlaxCondUNet
from ertdx.ops.ensemble_attn import _cross_reference, _self_reference
from ertdx_torch import diffusion, sample
from ertdx_torch.configs import SampleConfig
from ertdx_torch.models.condunet import CondUNet
from ertdx_torch.ops import ensemble_attn as ea
from ertdx_torch.utils.weights import flax_shapes, params_from_jax

BF16 = torch.bfloat16
BAND = 5e-2               # the JAX package's bf16 band (tests/test_ops.py)
KW = dict(param_dim=29, hidden_dim=32, cond_channels=4, base_width=16,
          depth=2, num_heads=2, core_heads=1, num_blocks=2, attn_slab=True,
          ensemble_pallas=True, ensemble_min_chains=8, ensemble_mega=False)
B, R, P, T, STEPS = 2, 8, 29, 20, 5


def _bf16_inputs(seed, *shapes):
    """bf16-exact numpy arrays of `shapes`, as (jax bf16, torch bf16)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
        out.append((jnp.asarray(a), torch.from_numpy(
            a.astype(np.float32)).to(BF16)))
    return out


def _ulps(got: torch.Tensor, want) -> float:
    """max |got - want| in bf16 ulps of max |want|."""
    w = np.asarray(jnp.asarray(want, jnp.float32))
    err = float(np.abs(got.float().numpy() - w).max())
    top = float(np.abs(w).max())
    return err / 2.0 ** (np.floor(np.log2(max(top, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("n,p,d", [(16, 29, 32), (8, 29, 128), (5, 7, 64)])
def test_bf16_self_reference_matches_jax(n, p, d):
    (jq, q), (jk, k), (jv, v) = _bf16_inputs(n + p + d, *[(n, p, d)] * 3)
    want = _self_reference(jq, jk, jv)
    got = ea.reference_attention(q, k, v)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    # one rounding of the same float32 sum: an ulp at most
    assert _ulps(got, want) <= 1.0


@pytest.mark.parametrize("b,lq,lk,d", [(2, 8 * 29, 24, 32),
                                       (1, 16 * 29, 147, 128),
                                       (3, 40, 130, 64)])
def test_bf16_cross_reference_matches_jax(b, lq, lk, d):
    (jq, q), (jk, k), (jv, v) = _bf16_inputs(
        b + lq + lk, (b, lq, d), (b, lk, d), (b, lk, d))
    want = _cross_reference(jq, jk, jv)
    got = ea.reference_attention(q, k, v)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert _ulps(got, want) <= 1.0


def test_float32_reference_is_unchanged():
    """On float32 the plain version is the float32 function it was."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 29, 64)).astype(
        np.float32)) for _ in range(3))
    scale = 1.0 / 8.0
    want = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1) @ v
    assert torch.equal(ea.reference_attention(q, k, v), want)


def _random_params(shapes, rng) -> dict:
    out = {}
    for key, val in shapes.items():
        if isinstance(val, dict):
            out[key] = _random_params(val, rng)
        elif key == "kernel":
            out[key] = (rng.standard_normal(val)
                        / np.sqrt(np.prod(val[:-1]))).astype(np.float32)
        elif key == "scale":
            out[key] = (1 + 0.1 * rng.standard_normal(val)).astype(
                np.float32)
        else:
            out[key] = (0.1 * rng.standard_normal(val)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    """(flax bf16 model, numpy params, the port's bf16 model on the CPU),
    both with the ensemble attention on above 8 chains."""
    tm = CondUNet(dtype="bfloat16", **KW)
    params = _random_params(flax_shapes(tm), np.random.default_rng(17))
    params_from_jax(tm, params)
    fm = FlaxCondUNet(dtype=jnp.bfloat16, **KW)
    return fm, params, tm


def _count_plain_calls(monkeypatch) -> list:
    calls = []
    real = ea.reference_attention
    monkeypatch.setattr(ea, "reference_attention",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    return calls


def test_bf16_denoiser_call_on_the_ensemble_branch(pair, monkeypatch):
    fm, params, tm = pair
    rng = np.random.default_rng(5)
    cond = rng.normal(size=(B, 96, 4)).astype(np.float32)
    x = rng.normal(size=(B * R, P)).astype(np.float32)
    t = rng.integers(0, T, size=(B * R,)).astype(np.int32)
    v = {"params": params}
    ctx = fm.apply(v, jnp.asarray(cond), method=fm.encode_condition)
    want = fm.apply(v, jnp.asarray(x), jnp.asarray(t), ctx, R,
                    method=fm.denoise_ensemble)
    calls = _count_plain_calls(monkeypatch)
    with torch.no_grad():
        tctx = tm.encode_condition(torch.from_numpy(cond))
        got = tm.denoise_ensemble(torch.from_numpy(x),
                                  torch.from_numpy(t).long(), tctx, R)
    # both attentions of both blocks took the ensemble branch, on bf16
    assert calls == [BF16] * 4
    assert tctx[0].dtype == BF16 and ctx[0].dtype == jnp.bfloat16
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BAND,
                               atol=BAND)


def test_bf16_ddim_ensemble_on_the_ensemble_branch(pair, monkeypatch):
    fm, params, tm = pair
    cond = np.random.default_rng(6).normal(size=(B, 96, 4)).astype(
        np.float32)
    key = jax.random.key(4)
    jcfg = JaxSampleConfig(sampler="ddim", ddim_steps=STEPS,
                           uncertainty_samples=R)
    want = jsample.posterior_ensemble(
        fm, params, jnp.asarray(cond), jdiff.get_diffusion_schedule(T), key,
        n_realizations=R, scfg=jcfg)
    _, init = jax.random.split(key)
    x_t = np.array(jax.random.normal(init, (R * B, P)))
    calls = _count_plain_calls(monkeypatch)
    scfg = SampleConfig(sampler="ddim", ddim_steps=STEPS,
                        uncertainty_samples=R)
    got = sample.posterior_ensemble(
        tm, torch.from_numpy(cond), diffusion.get_diffusion_schedule(T), R,
        scfg, x_T=torch.from_numpy(x_t), device="cpu")
    assert calls == [BF16] * (4 * STEPS)
    assert got.shape == (R, B, P) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BAND,
                               atol=BAND)
