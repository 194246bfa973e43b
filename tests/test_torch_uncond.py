"""The port's UncondMLP and synthetic fields (configs[1]) against ertdx's.

* forward, encode_condition and denoise against the flax model on the
  same perturbed weights, at a small width and at SYNTHETIC_GAUSSIAN's
  (P=256, H=256, 3 blocks): within 1e-5 x max(1, max|JAX|); the (B, 0)
  placeholder, and None refused as in JAX.
* `init_uncond`: flax's defaults (lecun-normal kernels within 2 sigma /
  0.8796 and their standard deviation within 5 % of sqrt(1/fan_in) for a
  large leaf, zero biases, a zero `out` kernel), three blocks whatever
  num_blocks says (as ertdx/models/__init__.py builds it).
* Train steps against `ertdx.train.make_train_step` on JAX's draws, eps
  and v, with tests/test_torch_train.py's tolerances.
* `posterior_ensemble` on the dummy condition against JAX's with JAX's
  draws injected, ancestral and DDIM (eta 0.5): atol = rtol = 1e-4; one
  condition with R=6, and three placeholder rows with R=2 (the
  realization-major order); guidance refused.
* `synthetic.py` byte for byte against `ertdx.synthetic`.
* The configs[1] acceptance check of tests/test_uncond.py:37-74 on the
  port, with its settings and tolerances.
* SYNTHETIC_GAUSSIAN through the CLI (generate-synthetic, train, sample)
  and its checkpoint restored by `ertdx.train.load_best_model`.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ertdx import configs as jconfigs
from ertdx import diffusion as jdiff
from ertdx import sample as jsample
from ertdx import synthetic as jsynthetic
from ertdx import train as jtrain
from ertdx.models import build_model as jbuild_model
from ertdx_torch import cli, configs, diffusion, sample, synthetic, train
from ertdx_torch.models import UncondMLP, build_model
from ertdx_torch.utils.weights import (flax_shapes, named_to_jax,
                                       params_to_jax)
from test_torch_train import LR, _close_per_leaf, _leaves, _params_close
from torch_mlp_common import jax_draws, uncond_pair
from torch_parity_common import t32

T = 100


def _close(got, want, what):
    want = np.asarray(want)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("p,h", [(64, 32), (256, 256)])
def test_forward_matches_flax(p, h):
    fm, params, tm = uncond_pair(p=p, h=h, seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, p)).astype(np.float32)
    t = rng.integers(0, T, size=(5,)).astype(np.int32)
    dummy = np.zeros((5, 1, 1), np.float32)
    v = {"params": params}
    with torch.no_grad():
        tt = torch.from_numpy(t).long()
        _close(tm(t32(x), tt, t32(dummy)), fm.apply(v, x, t, dummy),
               "forward")
        ctx = tm.encode_condition(t32(dummy))
        assert ctx.shape == (5, 0) and ctx.dtype == torch.float32
        assert fm.apply(v, dummy, method="encode_condition").shape == (5, 0)
        _close(tm.denoise(t32(x), tt, ctx),
               fm.apply(v, x, t, jnp.zeros((5, 0)), method="denoise"),
               "denoise")
    with pytest.raises(ValueError, match="placeholder"):
        tm.encode_condition(None)


def test_init_follows_flax():
    cfg = configs.SYNTHETIC_GAUSSIAN.model
    assert cfg.num_blocks == 4           # ignored: the model has 3 blocks
    tm = build_model(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    assert isinstance(tm, UncondMLP) and tm.num_blocks == 3
    jvars = jbuild_model(jconfigs.SYNTHETIC_GAUSSIAN.model).init(
        jax.random.key(0), jnp.zeros((1, 256)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 1, 1)))["params"]
    assert flax_shapes(tm) == jax.tree_util.tree_map(lambda a: a.shape,
                                                     jvars)
    want = _leaves(jvars)
    for key, got in _leaves(params_to_jax(tm)).items():
        if not want[key].any():
            assert not got.any(), key     # biases and the out kernel
            continue
        fan_in = got.shape[0]
        std = float(np.sqrt(1.0 / fan_in))
        assert np.abs(got).max() <= 2 * std / 0.8796 + 1e-6, key
        if got.size >= 4096:
            assert abs(got.std() / std - 1) < 0.05, (key, got.std(), std)
    assert not tm.out.weight.any() and not tm.out.bias.any()


@pytest.mark.parametrize("parameterization", ["eps", "v"])
def test_train_steps_match_ertdx(parameterization):
    fm, params, tm = uncond_pair(seed=4, parameterization=parameterization)
    jsch = jdiff.get_diffusion_schedule(T)
    jstep = jtrain.make_train_step(fm.apply, jsch, donate=False,
                                   parameterization=parameterization)
    state = jtrain.TrainState.create(
        apply_fn=fm.apply, params=jax.tree_util.tree_map(jnp.asarray,
                                                         params),
        tx=optax.adam(LR))
    opt = train.create_optimizer(tm, LR)

    @jax.jit
    def grad_fn(p, x0, cond, t, noise):
        def loss(p):
            xn = jdiff.q_sample(x0, t, noise, jsch.alpha_bar)
            tgt = jdiff.prediction_target(x0, noise, t, jsch.alpha_bar,
                                          parameterization)
            return jnp.mean((fm.apply({"params": p}, xn, t, cond)
                             - tgt) ** 2)
        return jax.grad(loss)(p)

    rng = np.random.default_rng(5)
    for s in range(2):
        x0 = rng.normal(size=(8, 64)).astype(np.float32)
        cond = np.zeros((8, 1, 1), np.float32)
        key = jax.random.key(30 + s)
        kt, kn = jax.random.split(key)
        t = np.array(jax.random.randint(kt, (8,), 0, T, dtype=jnp.int32))
        noise = np.array(jax.random.normal(kn, (8, 64), jnp.float32))
        gwant = grad_fn(state.params, *(jnp.asarray(a) for a in
                                        (x0, cond, t, noise)))
        state, jl = jstep(state, jnp.asarray(x0), jnp.asarray(cond), None,
                          key)
        loss = train.train_step(
            tm, opt, t32(x0), t32(cond), torch.from_numpy(t).long(),
            t32(noise), alpha_bar=diffusion.get_diffusion_schedule(
                T).alpha_bar, lr=LR, parameterization=parameterization)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        grads = named_to_jax(tm, {n: q.grad for n, q in
                                  tm.named_parameters()})
        _close_per_leaf(grads, gwant, 1e-4)
        _params_close(named_to_jax(tm, dict(tm.named_parameters())),
                      state.params, gwant, s + 1)


@pytest.mark.parametrize("sampler,steps", [("ancestral", 20),
                                           ("ddim", 5)])
@pytest.mark.parametrize("b,r", [(1, 6), (3, 2)])
def test_posterior_ensemble_matches_jax(sampler, steps, b, r):
    fm, params, tm = uncond_pair(seed=6)
    dummy = np.zeros((b, 1, 1), np.float32)
    kw = dict(sampler=sampler, ddim_steps=steps, ddim_eta=0.5,
              uncertainty_samples=r)
    key = jax.random.key(7)
    want = jsample.posterior_ensemble(
        fm, params, jnp.asarray(dummy), jdiff.get_diffusion_schedule(20),
        key, n_realizations=r, scfg=jconfigs.SampleConfig(**kw),
        param_dim=64)
    got = sample.posterior_ensemble(
        tm, t32(dummy), diffusion.get_diffusion_schedule(20), r,
        configs.SampleConfig(**kw), param_dim=64, device="cpu",
        **jax_draws(key, sampler, (r * b, 64), steps))
    assert got.shape == (r, b, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_guidance_is_refused():
    tm = build_model(dataclasses.replace(
        configs.SYNTHETIC_GAUSSIAN.model, param_dim=16, hidden_dim=8),
        device="cpu")
    with pytest.raises(ValueError, match="uncond_prob"):
        sample.posterior_ensemble(
            tm, torch.zeros(1, 1, 1), diffusion.get_diffusion_schedule(10),
            2, configs.SampleConfig(guidance_scale=2.0), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(n=64, grid=(8, 8), seed=1),
    dict(n=32, grid=(16, 12), length_scale=0.4, mean=2.0, std=0.5,
         seed=2),
    dict(n=16, grid=(8, 8), log_normal=True, seed=3),
    dict(n=8, seed=0),
])
def test_fields_are_byte_equal(kw):
    got = synthetic.gaussian_random_fields(**kw)
    want = jsynthetic.gaussian_random_fields(**kw)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_datasets_are_byte_equal():
    for a, b in zip(synthetic.make_unconditional_dataset(40, (8, 8), 0.3, 5),
                    jsynthetic.make_unconditional_dataset(40, (8, 8), 0.3,
                                                          5)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    ds = synthetic.make_unconditional_ertdataset(40, (8, 8), 0.3, 5)
    jds = jsynthetic.make_unconditional_ertdataset(40, (8, 8), 0.3, 5)
    assert ds.params_u.tobytes() == jds.params_u.tobytes()
    assert ds.conditions.tobytes() == jds.conditions.tobytes()
    assert ds.conditions.shape == (40, 1, 1)
    x = np.random.default_rng(0).normal(size=(3, 64))
    np.testing.assert_array_equal(ds.param_scaler.transform(x), x)
    np.testing.assert_array_equal(ds.ert_scaler.data_max, np.ones(1))


def test_unconditional_train_and_sample():
    """tests/test_uncond.py's configs[1] acceptance check on the port:
    8x8 fields, T=100, 40 epochs at batch 128 and lr 2e-3, then 512
    ancestral draws whose mean, standard deviation and neighbour
    correlation match the data's within its tolerances."""
    grid = (8, 8)
    d = grid[0] * grid[1]
    ds = synthetic.make_unconditional_ertdataset(n=1024, grid=grid,
                                                 length_scale=0.4, seed=0)
    cfg = configs.ExperimentConfig(
        diffusion=configs.DiffusionConfig(T=100),
        model=dataclasses.replace(configs.ModelConfig(), name="uncondmlp",
                                  param_dim=d, hidden_dim=128,
                                  cond_length=1, cond_channels=1),
        train=dataclasses.replace(configs.TrainConfig(), num_epochs=40,
                                  batch_size=128, lr=2e-3,
                                  checkpoint_dir="", log_every=1000))
    # one intra-op thread: hundreds of tiny steps slow down by two orders
    # of magnitude when every test worker's thread pool competes for the
    # cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = train.train(cfg, ds, device="cpu")
        samples = sample.posterior_ensemble(
            res.state.model, torch.zeros(1, 1, 1),
            diffusion.get_diffusion_schedule(cfg.diffusion.T), 512,
            param_dim=d, generator=torch.Generator().manual_seed(0),
            device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert res.train_history[-1] < 0.8 * res.train_history[0]
    x = samples.numpy().reshape(512, d)
    data = ds.params_u
    assert abs(x.mean() - data.mean()) < 0.15
    assert abs(x.std() - data.std()) < 0.25
    g = x.reshape(512, *grid)
    c_near = np.corrcoef(g[:, 4, 4], g[:, 4, 5])[0, 1]
    assert c_near > 0.2


def test_cli_synthetic_preset(tmp_path, monkeypatch):
    """generate-synthetic, then train and sample SYNTHETIC_GAUSSIAN
    through the CLI on the CPU; JAX restores the checkpoint."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["generate-synthetic", "--n", "48", "--seed", "3",
                     "--out", "f.npy"]) == 0
    fields, cond = jsynthetic.make_unconditional_dataset(48, (16, 16), 0.25,
                                                         3)
    assert np.load("f.npy").tobytes() == fields.tobytes()
    assert np.load("synthetic_cond.npy").tobytes() == cond.tobytes()
    c = ["--params", "f.npy", "--ert", "synthetic_cond.npy", "--preset",
         "synthetic_gaussian", "--device", "cpu"]
    assert cli.main(["train", *c, "--checkpoint-dir", "ck", "--epochs",
                     "2"]) == 0
    assert cli.main(["sample", *c, "--checkpoint-dir", "ck",
                     "--realizations", "3", "--sampler", "ddim", "--steps",
                     "5"]) == 0
    pred, valid = np.load("Uncertainty_params.npy"), np.load(
        "valid_mask.npy")
    assert pred.shape == (3, 6, 256) and np.isfinite(pred).all()
    assert valid.all()          # the fields have no parameter bounds
    jcfg = jconfigs.SYNTHETIC_GAUSSIAN
    jstate, meta, _ = jtrain.load_best_model("ck", jcfg, ((1, 1), 256))
    pstate, _, _ = train.load_best_model("ck", configs.SYNTHETIC_GAUSSIAN,
                                         device="cpu")
    assert meta["model"] == "uncondmlp"
    got, want = _leaves(params_to_jax(pstate.model)), _leaves(
        jstate.params)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
