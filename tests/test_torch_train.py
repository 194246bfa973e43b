"""The port's training against ertdx.train on the CPU.

* CondUNet with attn_slab=True: forward and parameter gradients against
  the flax model on the same perturbed weights (atol 1e-4 on outputs;
  gradients at 1e-4 x max(1, max|g|) per leaf).
* Train steps against `ertdx.train.make_train_step(..., donate=False)`:
  JAX's t and eps are drawn from its key as `_make_batch_update` draws
  them and handed to the port's `train_step`. Loss rtol 1e-5; gradients
  as above; Adam moments mu at 1e-5 x max|mu| and nu at 1e-4 relative
  to max|nu|. Parameters: every entry within 2e-6 of JAX's, except
  entries whose gradient is below 1e-4 x max|g| of its leaf, at most
  0.1 % of them, which may differ by up to 2 lr per step: Adam's first
  update is lr x sign(g), so a near-zero gradient whose sign differs
  between two correct fp32 paths moves the parameter by 2 lr.
* `make_lr` against the optax schedules (rtol 1e-5: optax evaluates them
  in float32, the port in float64).
* `init_params` against flax's initialisers: the zero leaves are exactly
  zero, norm scales one, and each kernel's standard deviation within 5 %
  of lecun's.
* Guided (CFG) and EMA train steps against `make_train_step` with
  uncond_prob > 0 or ema_decay > 0: JAX's drop mask,
  bernoulli(fold_in(key, 13)), is handed to the port; loss, gradients
  and parameters as above, the EMA as the parameters.
  (tests/test_torch_resume.py has `train(resume=True)` and the
  flat-optimizer and fused-conv checkpoints.)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ertdx import configs as jconfigs
from ertdx import diffusion as jdiff
from ertdx import train as jtrain
from ertdx.models.condunet import CondUNet as FlaxCondUNet
from ertdx_torch import configs, diffusion, train
from ertdx_torch.models.condunet import CondUNet, init_params
from ertdx_torch.utils.weights import (adam_state_to_jax, flax_path,
                                       named_to_jax)
from torch_parity_common import make_pair, t32

T = 500
LR = 1e-4


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _close_per_leaf(got_tree, want_tree, rel):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert got.keys() == want.keys()
    for key in want:
        tol = rel * max(1.0, float(np.abs(want[key]).max()))
        err = float(np.abs(got[key] - want[key]).max())
        assert err <= tol, (key, err, tol)


def _batch(seed, b=4, l=96, c=4, p=29):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(b, p)).astype(np.float32)
    cond = rng.uniform(size=(b, l, c)).astype(np.float32)
    return x0, cond


def _jax_draws(key, b, p):
    """t and eps as ertdx.train._make_batch_update draws them."""
    kt, kn = jax.random.split(key)
    t = jax.random.randint(kt, (b,), 0, T, dtype=jnp.int32)
    noise = jax.random.normal(kn, (b, p), jnp.float32)
    return np.array(t), np.array(noise)


def _grads_of(model):
    return named_to_jax(model, {n: p.grad for n, p in
                                model.named_parameters()})


def test_slab_condunet_forward_and_gradients_match_flax():
    fm, params, tm = make_pair(attn_slab=True, seed=3)
    assert tm.encoder.attn.slab
    x0, cond = _batch(5)
    t = np.array([0, 17, 250, 499], np.int32)

    def loss(p):
        out = fm.apply({"params": p}, jnp.asarray(x0), jnp.asarray(t),
                       jnp.asarray(cond))
        return jnp.mean(out ** 2), out

    (_, want), gwant = jax.value_and_grad(loss, has_aux=True)(params)
    out = tm(t32(x0), torch.from_numpy(t).long(), t32(cond))
    torch.mean(out ** 2).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    _close_per_leaf(_grads_of(tm), gwant, 1e-4)


def _params_close(got_tree, want_tree, grads_tree, steps):
    got, want, grads = (_leaves(t) for t in (got_tree, want_tree,
                                             grads_tree))
    exempt = total = 0
    for key in want:
        diff = np.abs(got[key] - want[key])
        small = np.abs(grads[key]) <= 1e-4 * np.abs(grads[key]).max()
        assert (diff[~small] <= 2e-6).all(), (key, diff[~small].max())
        assert (diff[small] <= 2 * LR * steps + 2e-6).all(), key
        exempt += int((small & (diff > 2e-6)).sum())
        total += diff.size
    assert exempt <= 1e-3 * total, (exempt, total)


@pytest.mark.parametrize("parameterization,weighting,weighted,steps", [
    ("eps", "none", False, 1),
    ("eps", "none", False, 3),
    ("v", "min_snr", True, 1),
])
def test_train_steps_match_ertdx(parameterization, weighting, weighted,
                                 steps):
    fm, params, tm = make_pair(attn_slab=True, seed=11,
                               parameterization=parameterization)
    jsch = jdiff.get_diffusion_schedule(T)
    tsch = diffusion.get_diffusion_schedule(T)
    jstep = jtrain.make_train_step(fm.apply, jsch, donate=False,
                                   parameterization=parameterization,
                                   loss_weighting=weighting)
    state = jtrain.TrainState.create(
        apply_fn=fm.apply, params=jax.tree_util.tree_map(jnp.asarray,
                                                         params),
        tx=optax.adam(LR))
    opt = train.create_optimizer(tm, LR)
    for s in range(steps):
        x0, cond = _batch(100 + s)
        w = np.array([1, 1, 1, 0], np.float32) if weighted else None
        key = jax.random.key(s)
        t, noise = _jax_draws(key, *x0.shape)

        def jloss(p):
            ab = jsch.alpha_bar
            xn = jdiff.q_sample(jnp.asarray(x0), jnp.asarray(t),
                                jnp.asarray(noise), ab)
            tgt = jdiff.prediction_target(jnp.asarray(x0),
                                          jnp.asarray(noise),
                                          jnp.asarray(t), ab,
                                          parameterization)
            out = fm.apply({"params": p}, xn, jnp.asarray(t),
                           jnp.asarray(cond))
            per_ex = jnp.mean((out - tgt) ** 2, axis=-1)
            if weighting == "min_snr":
                per_ex = per_ex * jdiff.min_snr_weight(
                    jnp.asarray(t), ab, parameterization, 5.0)
            if w is None:
                return jnp.mean(per_ex)
            return jnp.sum(per_ex * w) / jnp.maximum(jnp.sum(w), 1.0)

        gwant = jax.grad(jloss)(state.params)
        state, jl = jstep(state, jnp.asarray(x0), jnp.asarray(cond),
                          None if w is None else jnp.asarray(w), key)
        loss = train.train_step(
            tm, opt, t32(x0), t32(cond), torch.from_numpy(t).long(),
            t32(noise), None if w is None else t32(w),
            alpha_bar=tsch.alpha_bar, lr=LR,
            parameterization=parameterization, loss_weighting=weighting)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        _close_per_leaf(_grads_of(tm), gwant, 1e-4)
        _params_close(named_to_jax(tm, dict(tm.named_parameters())),
                      state.params, gwant, s + 1)

    assert train.optimizer_steps(opt) == steps
    adam = adam_state_to_jax(opt, tm, schedule=False)
    jadam = state.opt_state[0]
    assert int(adam["0"]["count"]) == int(jadam.count) == steps
    assert adam["1"] == {}
    _close_per_leaf(adam["0"]["mu"], jadam.mu, 1e-5)
    nu_max = max(float(np.abs(v).max()) for v in _leaves(jadam.nu).values())
    for key, want in _leaves(jadam.nu).items():
        np.testing.assert_allclose(_leaves(adam["0"]["nu"])[key], want,
                                   atol=1e-4 * nu_max, rtol=1e-4)


@pytest.mark.parametrize("kw,total", [
    ({}, 50),
    ({"warmup_steps": 7}, 50),
    ({"lr_schedule": "cosine"}, 40),
    ({"lr_schedule": "cosine", "warmup_steps": 5,
      "lr_end_fraction": 0.1}, 30),
    ({"lr_schedule": "cosine", "warmup_steps": 10}, 5),   # horizon < warmup
])
def test_make_lr_matches_optax(kw, total):
    jcfg = jconfigs.TrainConfig(lr=3e-4, **kw)
    tcfg = configs.TrainConfig(lr=3e-4, **kw)
    want, got = jtrain.make_lr(jcfg, total), train.make_lr(tcfg, total)
    assert callable(got) == callable(want)
    for count in range(total + 12):
        w = float(want(count)) if callable(want) else want
        np.testing.assert_allclose(train.lr_at(got, count), w, rtol=1e-5,
                                   atol=1e-12)


def test_init_params_follow_flax():
    cfg = configs.DDIM_ENSEMBLE.model
    fm = FlaxCondUNet()
    fparams = fm.init(jax.random.key(0), jnp.zeros((1, 29)),
                      jnp.zeros((1,), jnp.int32),
                      jnp.zeros((1, cfg.cond_length, cfg.cond_channels)))
    flat = _leaves(fparams["params"])
    tm = CondUNet()
    init_params(tm, torch.Generator().manual_seed(3))
    n_zero = 0
    for name, param in tm.named_parameters():
        want = flat["/".join(flax_path(name, tm.depth))]
        got = param.detach().numpy()
        if not want.any():
            assert not got.any(), name
            n_zero += 1
        elif (want == 1).all():
            assert (got == 1).all(), name
        elif name == "pos_emb":
            assert abs(got.std() / 0.02 - 1) < 0.05
        else:
            fan_in = int(np.prod(want.shape[:-1]))
            std = float(np.sqrt(1.0 / fan_in))
            assert np.abs(got).max() <= 2 * std / 0.8796 + 1e-6, name
            if got.size >= 4096:
                assert abs(got.std() / std - 1) < 0.05, (name, got.std(),
                                                         std)
    # AdaLN x 3, self-out, cross-out and MLP-out kernels per block, every
    # bias, and the head
    assert n_zero > 6 * tm.num_blocks
    again = init_params(CondUNet(), torch.Generator().manual_seed(3))
    for (_, a), (_, b) in zip(tm.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b)


def _jax_cfg_loss(fm, jsch):
    """JAX's train loss with condition dropout (ertdx/train.py:129-140)
    on given draws; drop all False is the unguided loss."""
    def jloss(p, x0, cond, t, noise, drop):
        xn = jdiff.q_sample(x0, t, noise, jsch.alpha_bar)
        ctx = fm.apply({"params": p}, cond, method="encode_condition")
        if fm.uncond_prob > 0.0:
            ctx = fm.apply({"params": p}, ctx, drop,
                           method="drop_condition")
        out = fm.apply({"params": p}, xn, t, ctx, method="denoise")
        return jnp.mean((out - noise) ** 2)
    return jax.jit(jax.grad(jloss))


@pytest.mark.parametrize("uncond_prob,ema_decay", [(0.5, 0.0), (0.0, 0.9)])
def test_guided_and_ema_steps_match_ertdx(uncond_prob, ema_decay):
    """One step: JAX's make_train_step with its own draws (t, eps and,
    guided, the mask bernoulli(fold_in(key, 13))) against the port's
    train_step given the same draws."""
    fm, params, tm = make_pair(seed=13, num_blocks=1,
                               uncond_prob=uncond_prob)
    jsch = jdiff.get_diffusion_schedule(T)
    jstep = jtrain.make_train_step(fm.apply, jsch, donate=False,
                                   ema_decay=ema_decay,
                                   uncond_prob=uncond_prob)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = jtrain.TrainState.create(
        apply_fn=fm.apply, params=jparams, tx=optax.adam(LR),
        ema_params=jax.tree_util.tree_map(jnp.copy, jparams)
        if ema_decay else None)
    opt = train.create_optimizer(tm, LR)
    ema = ({n: p.detach().clone() for n, p in tm.named_parameters()}
           if ema_decay else None)
    x0, cond = _batch(200)
    key = jax.random.key(41)
    t, noise = _jax_draws(key, *x0.shape)
    drop = np.array(jax.random.bernoulli(jax.random.fold_in(key, 13),
                                         0.5, (x0.shape[0],)))
    if uncond_prob:      # both branches of the dropout are exercised
        assert 0 < drop.sum() < drop.size
    gwant = _jax_cfg_loss(fm, jsch)(
        state.params, *(jnp.asarray(a) for a in (x0, cond, t, noise, drop)))
    state, jl = jstep(state, jnp.asarray(x0), jnp.asarray(cond), None, key)
    loss = train.train_step(
        tm, opt, t32(x0), t32(cond), torch.from_numpy(t).long(), t32(noise),
        alpha_bar=diffusion.get_diffusion_schedule(T).alpha_bar, lr=LR,
        ema=ema, ema_decay=ema_decay,
        drop=torch.from_numpy(drop) if uncond_prob else None)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _close_per_leaf(_grads_of(tm), gwant, 1e-4)
    _params_close(named_to_jax(tm, dict(tm.named_parameters())),
                  state.params, gwant, 1)
    if ema_decay:
        _params_close(named_to_jax(tm, ema), state.ema_params, gwant, 1)


def test_drop_mask_needs_the_null_context():
    tm = CondUNet(cond_channels=4, base_width=16, depth=2, num_heads=2,
                  num_blocks=1)
    x0, cond = _batch(1)
    with pytest.raises(ValueError, match="uncond_prob"):
        train.train_step(tm, train.create_optimizer(tm, LR), t32(x0),
                         t32(cond), drop=torch.ones(4, dtype=torch.bool),
                         alpha_bar=diffusion.get_diffusion_schedule(
                             T).alpha_bar)
