"""The flash-gated encoder attention of the CondUNet against flax's.

* `SelfAttention1D` (ertdx/models/condunet.py:146-174) with
  flash_min_logits 0, 1 and just above 3 x 4 x 256^2, on the same weights
  as the flax module, as tests/test_models.py:255-281 runs it: the gate
  pads L 147 -> 256, masks the pad keys and slices back; on the CPU
  `flash_attention` is the plain version on the padded operands, in JAX
  and in the port alike. Tolerance 2e-5 (the flash forward's). The gate
  decides whether `flash_attention` is called at all.
* `use_pallas=False` (the repair): neither `flash_attention` nor
  `slab_attention` is called, the plain attention runs on the raw length,
  and the output matches flax's.
* A small flash-arm CondUNet (attn_flash_min_logits=1): outputs and
  gradients against flax's (atol and rtol 1e-4; gradients 1e-4 x max(1,
  max|g|) per leaf), and one train step with JAX's draws against
  `ertdx.train.make_train_step` (the tolerances of
  tests/test_torch_train.py: loss rtol 1e-5, gradients as above,
  parameters within 2e-6 but for near-zero gradients).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ertdx import diffusion as jdiff
from ertdx import train as jtrain
from ertdx.models.condunet import SelfAttention1D as FlaxAttention
from ertdx_torch import diffusion, train
from ertdx_torch.models import condunet as cu
from ertdx_torch.utils.weights import named_to_jax
from test_torch_train import (LR, T, _batch, _close_per_leaf, _grads_of,
                              _jax_draws, _params_close)
from torch_parity_common import make_pair, t32

B, L, C, H = 3, 147, 256, 4
JUST_ABOVE = 3 * 4 * 256 * 256 + 1


def _load(tm, params):
    """Copy a flax SelfAttention1D's parameters into the port's."""
    with torch.no_grad():
        tm.norm.weight.copy_(t32(params["LayerNorm_0"]["scale"]))
        tm.norm.bias.copy_(t32(params["LayerNorm_0"]["bias"]))
        tm.qkv.weight.copy_(t32(params["Dense_0"]["kernel"]).T)
        tm.out.weight.copy_(t32(params["Dense_1"]["kernel"]).T)
        tm.out.bias.copy_(t32(params["Dense_1"]["bias"]))
    return tm


def _pair(seed=1, **knobs):
    """x, flax parameters with non-zero biases, and the port's module
    holding the same numbers."""
    x = np.asarray(jax.random.normal(jax.random.key(0), (B, L, C)))
    params = FlaxAttention(H).init(jax.random.key(seed),
                                   jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(lambda a: a + 0.1, params)
    return x, params, _load(cu.SelfAttention1D(C, H, **knobs), params)


class _Calls:
    def __init__(self, monkeypatch, *names):
        self.n = {name: 0 for name in names}
        for name in names:
            fn = getattr(cu, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                self.n[_name] += 1
                return _fn(*a, **kw)
            monkeypatch.setattr(cu, name, counted)


@pytest.mark.parametrize("flash_min_logits,engages", [
    (0, False), (1, True), (JUST_ABOVE, False)])
def test_flash_gate_matches_flax(monkeypatch, flash_min_logits, engages):
    x, params, tm = _pair(flash_min_logits=flash_min_logits)
    calls = _Calls(monkeypatch, "flash_attention", "reference_attention")
    want = FlaxAttention(H, flash_min_logits=flash_min_logits).apply(
        {"params": params}, jnp.asarray(x))
    got = tm(t32(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    assert calls.n == {"flash_attention": int(engages),
                       "reference_attention": int(not engages)}


def test_length_gate_engages_at_1024(monkeypatch):
    """lp >= FLASH_MIN_LEN engages the kernels without the batch gate."""
    x = np.random.default_rng(2).normal(size=(1, 1000, 64)).astype(
        np.float32)
    fm = FlaxAttention(2)
    params = fm.init(jax.random.key(3), jnp.asarray(x))["params"]
    tm = _load(cu.SelfAttention1D(64, 2), params)
    calls = _Calls(monkeypatch, "flash_attention")
    want = fm.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(tm(t32(x)).detach().numpy(),
                               np.asarray(want), rtol=2e-5, atol=2e-5)
    assert calls.n["flash_attention"] == 1


@pytest.mark.parametrize("slab", [False, True])
def test_use_pallas_false_takes_the_plain_path(monkeypatch, slab):
    x, params, tm = _pair(seed=5, slab=slab, use_pallas=False,
                          flash_min_logits=1)
    calls = _Calls(monkeypatch, "flash_attention", "slab_attention",
                   "reference_attention", "reference_slab_attention")
    seen = []
    real = cu.F.pad
    monkeypatch.setattr(cu.F, "pad", lambda *a, **k: seen.append(1)
                        or real(*a, **k))
    want = FlaxAttention(H, use_pallas=False, flash_min_logits=1,
                         slab=slab).apply({"params": params},
                                          jnp.asarray(x))
    got = tm(t32(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    assert calls.n["flash_attention"] == calls.n["slab_attention"] == 0
    assert calls.n["reference_slab_attention" if slab
                   else "reference_attention"] == 1
    assert not seen          # the raw length: nothing padded


def test_flash_arm_condunet_matches_flax():
    fm, params, tm = make_pair(seed=31, num_blocks=1, flash_min_logits=1)
    assert tm.encoder.attn.flash_min_logits == 1
    x0, cond = _batch(6, b=3)
    t = np.array([0, 250, 499], np.int32)

    def loss(p):
        out = fm.apply({"params": p}, jnp.asarray(x0), jnp.asarray(t),
                       jnp.asarray(cond))
        return jnp.mean(out ** 2), out

    (_, want), gwant = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    out = tm(t32(x0), torch.from_numpy(t).long(), t32(cond))
    torch.mean(out ** 2).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    _close_per_leaf(_grads_of(tm), gwant, 1e-4)


def test_flash_arm_train_step_matches_ertdx():
    fm, params, tm = make_pair(seed=33, num_blocks=1, flash_min_logits=1)
    jsch = jdiff.get_diffusion_schedule(T)
    jstep = jtrain.make_train_step(fm.apply, jsch, donate=False)
    state = jtrain.TrainState.create(
        apply_fn=fm.apply, params=jax.tree_util.tree_map(jnp.asarray,
                                                         params),
        tx=optax.adam(LR))
    x0, cond = _batch(300)
    key = jax.random.key(8)
    t, noise = _jax_draws(key, *x0.shape)

    def jloss(p):
        xn = jdiff.q_sample(jnp.asarray(x0), jnp.asarray(t),
                            jnp.asarray(noise), jsch.alpha_bar)
        out = fm.apply({"params": p}, xn, jnp.asarray(t), jnp.asarray(cond))
        return jnp.mean((out - jnp.asarray(noise)) ** 2)

    gwant = jax.jit(jax.grad(jloss))(state.params)
    state, jl = jstep(state, jnp.asarray(x0), jnp.asarray(cond), None, key)
    opt = train.create_optimizer(tm, LR)
    loss = train.train_step(
        tm, opt, t32(x0), t32(cond), torch.from_numpy(t).long(), t32(noise),
        alpha_bar=diffusion.get_diffusion_schedule(T).alpha_bar, lr=LR)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _close_per_leaf(_grads_of(tm), gwant, 1e-4)
    _params_close(named_to_jax(tm, dict(tm.named_parameters())),
                  state.params, gwant, 1)
