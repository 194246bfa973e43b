"""The port's RefCondMLP (configs[0]) against ertdx's, on the CPU.

* REF_DEFAULT and SYNTHETIC_GAUSSIAN field for field against
  ertdx.configs, and the presets in JAX's order.
* forward, encode_condition, denoise and drop_condition against the flax
  model on the same perturbed weights (`params_from_jax`), at the
  reference's L=4693 with B=2 and at L=64: within
  1e-5 x max(1, max|JAX|).
* `init_refmlp`: PyTorch's default Linear / Conv1d statistics (|w| and
  |b| within 1/sqrt(fan_in), the standard deviation of a large leaf
  within 5 % of bound/sqrt(3)); a bfloat16 config builds float32.
* Train steps against `ertdx.train.make_train_step` on JAX's draws (t,
  eps and, with uncond_prob, the drop mask bernoulli(fold_in(key, 13))),
  eps and v: the tolerances of tests/test_torch_train.py (loss rtol
  1e-5, gradients 1e-4 x max(1, max|g|) a leaf, parameters 2e-6 but for
  near-zero gradients).
* `posterior_ensemble` against JAX's on JAX's draws injected, ancestral
  and DDIM (eta 0.5), unguided and guided (g = 2), with B=3 different
  conditions and R=4, so that JAX's realization-major chain order is
  checked: atol = rtol = 1e-4.
* Checkpoints: the port's `train()` read back by
  `ertdx.train.load_best_model` and JAX's `train()` by the port's,
  parameters and Adam moments bit for bit, with the Adam moments per
  leaf and flat (`flat_optimizer`).
* One distillation batch of a refmlp teacher (a halving, and a guided
  conversion) against `ertdx.distill`, and a tiny `distill()` end to end.
* The CLI's default preset (ref_default): train, calibrate --commit and
  sample on the CPU.
"""
from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from ertdx import configs as jconfigs
from ertdx import data as jdata
from ertdx import diffusion as jdiff
from ertdx import distill as jdistill
from ertdx import sample as jsample
from ertdx import train as jtrain
from ertdx.models import build_model as jbuild_model
from ertdx_torch import cli, configs, diffusion, distill, sample, train
from ertdx_torch.data import prepare_dataset
from ertdx_torch.doe import SurrogateDataGenerator
from ertdx_torch.models import RefCondMLP, build_model
from ertdx_torch.utils.weights import (adam_state_to_jax, flax_shapes,
                                       named_to_jax, params_to_jax)
from test_torch_distill import _jax_draws as distill_draws
from test_torch_train import LR, _close_per_leaf, _leaves, _params_close
from torch_mlp_common import jax_draws, refmlp_pair
from torch_parity_common import t32

T = 500


@pytest.mark.parametrize("preset", ["REF_DEFAULT", "SYNTHETIC_GAUSSIAN"])
def test_presets_match(preset):
    ours = getattr(configs, preset)
    assert dataclasses.asdict(ours) == dataclasses.asdict(
        getattr(jconfigs, preset))
    assert configs.PRESETS[ours.name] is ours


def test_presets_in_jax_order():
    assert list(configs.PRESETS) == list(jconfigs.PRESETS)
    assert configs.ExperimentConfig().model.name == "refmlp"


def _close(got, want, what):
    want = np.asarray(want)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("length,b,uncond_prob", [(4693, 2, 0.0),
                                                  (64, 5, 0.3)])
def test_forward_matches_flax(length, b, uncond_prob):
    fm, params, tm = refmlp_pair(cond_len=length, uncond_prob=uncond_prob,
                                 seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(b, 29)).astype(np.float32)
    t = rng.integers(0, T, size=(b,)).astype(np.int32)
    cond = rng.uniform(size=(b, length, 14)).astype(np.float32)
    v = {"params": params}
    tt = torch.from_numpy(t).long()
    with torch.no_grad():
        _close(tm(t32(x), tt, t32(cond)), fm.apply(v, x, t, cond),
               "forward")
        ctx = fm.apply(v, cond, method="encode_condition")
        tctx = tm.encode_condition(t32(cond))
        assert tctx.shape == (b, 32)
        _close(tctx, ctx, "encode_condition")
        _close(tm.denoise(t32(x), tt, t32(ctx)),
               fm.apply(v, x, t, ctx, method="denoise"), "denoise")
        if uncond_prob:
            drop = np.arange(b) % 2 == 0
            want = fm.apply(v, ctx, drop, method="drop_condition")
            got = tm.drop_condition(t32(ctx), torch.from_numpy(drop))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not hasattr(tm, "denoise_ensemble")


def test_init_follows_pytorch_defaults():
    cfg = configs.REF_DEFAULT.model
    tm = build_model(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(5))
    assert isinstance(tm, RefCondMLP) and not hasattr(tm, "null_vec")
    jshapes = jax.eval_shape(lambda: jbuild_model(
        jconfigs.REF_DEFAULT.model).init(
            jax.random.key(0), jnp.zeros((1, 29)),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 64, 14))))["params"]
    assert flax_shapes(tm) == jax.tree_util.tree_map(lambda a: a.shape,
                                                     jshapes)
    tree = params_to_jax(tm)
    for layer, sub in tree.items():
        inner = next(iter(sub.values()))
        fan_in = int(np.prod(inner["kernel"].shape[:-1]))
        bound = 1.0 / np.sqrt(fan_in)
        for leaf in ("kernel", "bias"):
            w = inner[leaf]
            assert np.abs(w).max() <= bound, (layer, leaf)
            if w.size >= 4096:
                assert abs(w.std() / (bound / np.sqrt(3.0)) - 1) < 0.05, \
                    (layer, w.std())
    again = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(5))
    other = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(6))
    for (_, a), (_, b), (_, c) in zip(tm.named_parameters(),
                                      again.named_parameters(),
                                      other.named_parameters()):
        assert torch.equal(a, b) and not torch.equal(a, c)
    # a bf16 config builds the float32 model, as JAX's build_model does
    bf = build_model(dataclasses.replace(cfg, dtype="bfloat16",
                                         uncond_prob=0.1), device="cpu")
    assert all(p.dtype == torch.float32 for p in bf.parameters())
    assert not bf.null_vec.any()
    out = bf(torch.zeros(2, 29), torch.zeros(2, dtype=torch.long),
             torch.zeros(2, 64, 14))
    assert out.dtype == torch.float32


def _jax_step_draws(key, b, p, uncond_prob):
    kt, kn = jax.random.split(key)
    t = np.array(jax.random.randint(kt, (b,), 0, T, dtype=jnp.int32))
    noise = np.array(jax.random.normal(kn, (b, p), jnp.float32))
    drop = (np.array(jax.random.bernoulli(jax.random.fold_in(key, 13),
                                          uncond_prob, (b,)))
            if uncond_prob else None)
    return t, noise, drop


def _jax_loss(fm, jsch, parameterization):
    def jloss(p, x0, cond, t, noise, drop):
        xn = jdiff.q_sample(x0, t, noise, jsch.alpha_bar)
        tgt = jdiff.prediction_target(x0, noise, t, jsch.alpha_bar,
                                      parameterization)
        ctx = fm.apply({"params": p}, cond, method="encode_condition")
        if drop is not None:
            ctx = fm.apply({"params": p}, ctx, drop,
                           method="drop_condition")
        out = fm.apply({"params": p}, xn, t, ctx, method="denoise")
        return jnp.mean((out - tgt) ** 2)
    return jax.jit(jax.grad(jloss))


def _grads(model):
    return named_to_jax(model, {n: torch.zeros_like(p) if p.grad is None
                                else p.grad
                                for n, p in model.named_parameters()})


@pytest.mark.parametrize("parameterization,uncond_prob,steps", [
    ("eps", 0.0, 2), ("v", 0.0, 1), ("eps", 0.5, 1), ("v", 0.5, 2)])
def test_train_steps_match_ertdx(parameterization, uncond_prob, steps):
    fm, params, tm = refmlp_pair(uncond_prob=uncond_prob, seed=7,
                                 parameterization=parameterization)
    jsch = jdiff.get_diffusion_schedule(T)
    jstep = jtrain.make_train_step(fm.apply, jsch, donate=False,
                                   uncond_prob=uncond_prob,
                                   parameterization=parameterization)
    state = jtrain.TrainState.create(
        apply_fn=fm.apply, params=jax.tree_util.tree_map(jnp.asarray,
                                                         params),
        tx=optax.adam(LR))
    opt = train.create_optimizer(tm, LR)
    grad_fn = _jax_loss(fm, jsch, parameterization)
    rng = np.random.default_rng(8)
    for s in range(steps):
        x0 = rng.normal(size=(6, 29)).astype(np.float32)
        cond = rng.uniform(size=(6, 64, 14)).astype(np.float32)
        key = jax.random.key(20 + s)
        t, noise, drop = _jax_step_draws(key, 6, 29, uncond_prob)
        if uncond_prob:
            assert 0 < drop.sum() < drop.size
        gwant = grad_fn(state.params, *(jnp.asarray(a) for a in
                                        (x0, cond, t, noise)),
                        None if drop is None else jnp.asarray(drop))
        state, jl = jstep(state, jnp.asarray(x0), jnp.asarray(cond), None,
                          key)
        loss = train.train_step(
            tm, opt, t32(x0), t32(cond), torch.from_numpy(t).long(),
            t32(noise), alpha_bar=diffusion.get_diffusion_schedule(
                T).alpha_bar, lr=LR, parameterization=parameterization,
            drop=None if drop is None else torch.from_numpy(drop))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        _close_per_leaf(_grads(tm), gwant, 1e-4)
        _params_close(named_to_jax(tm, dict(tm.named_parameters())),
                      state.params, gwant, s + 1)


B, R, TS = 3, 4, 20
STEPS = {"ancestral": TS, "ddim": 5}


@pytest.mark.parametrize("sampler", ["ancestral", "ddim"])
@pytest.mark.parametrize("guided", [False, True])
def test_posterior_ensemble_matches_jax(sampler, guided):
    fm, params, tm = refmlp_pair(uncond_prob=0.2 if guided else 0.0,
                                 seed=9)
    cond = np.random.default_rng(10).uniform(size=(B, 64, 14)).astype(
        np.float32)
    kw = dict(sampler=sampler, ddim_steps=STEPS["ddim"], ddim_eta=0.5,
              temperature=0.8, uncertainty_samples=R,
              guidance_scale=2.0 if guided else 1.0)
    key = jax.random.key(11)
    want = jsample.posterior_ensemble(
        fm, params, jnp.asarray(cond), jdiff.get_diffusion_schedule(TS),
        key, n_realizations=R, scfg=jconfigs.SampleConfig(**kw))
    got = sample.posterior_ensemble(
        tm, t32(cond), diffusion.get_diffusion_schedule(TS), R,
        configs.SampleConfig(**kw), device="cpu",
        **jax_draws(key, sampler, (R * B, 29), STEPS[sampler]))
    assert got.shape == (R, B, 29)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # the conditions differ, so a condition-major reading would not match
    wrong = np.asarray(want).reshape(B, R, 29).transpose(1, 0, 2)
    assert np.abs(got.numpy() - wrong).max() > 1e-2


def _arrays(n=40, length=64, seed=1):
    p = SurrogateDataGenerator(seed=seed).generate_training_samples(
        n, "lhs")[..., None]
    ert = np.random.default_rng(seed).normal(50.0, 10.0,
                                             size=(n, length, 14))
    return p, ert


SMALL = dict(name="refmlp", hidden_dim=32, cond_length=64)


def _small_cfg(**train_kw):
    return configs.ExperimentConfig(
        diffusion=configs.DiffusionConfig(T=50),
        model=dataclasses.replace(configs.ModelConfig(), uncond_prob=0.1,
                                  **SMALL),
        train=dataclasses.replace(configs.TrainConfig(), num_epochs=2,
                                  batch_size=8, **train_kw))


@pytest.mark.parametrize("flat", [False, True])
def test_checkpoints_move_both_ways(tmp_path, flat):
    p, ert = _arrays()
    cfg = _small_cfg(lr_schedule="cosine", ema_decay=0.9,
                     flat_optimizer=flat)
    jcfg = jconfigs.experiment_from_dict(dataclasses.asdict(cfg))
    ds, jds = prepare_dataset(p, ert), jdata.prepare_dataset(p, ert)
    shapes = (jds.cond_shape, jds.param_dim)

    def same(pstate, jstate):
        got, want = _leaves(params_to_jax(pstate.model)), _leaves(
            jstate.params)
        assert got.keys() == want.keys() and "null_vec" in want
        assert all(np.array_equal(got[k], want[k]) for k in want)
        mu = _leaves(named_to_jax(pstate.model, {
            n: pstate.opt.state[q]["exp_avg"]
            for n, q in pstate.model.named_parameters()}))
        jmu = jstate.opt_state[0].mu
        if flat:        # optax.flatten's one vector, in ravel_pytree order
            np.testing.assert_array_equal(adam_state_to_jax(
                pstate.opt, pstate.model, schedule=True, flat=True)["0"]["mu"],
                np.asarray(jmu))
            jmu = ravel_pytree(jstate.params)[1](jmu)
        jmu = _leaves(jmu)
        assert all(np.array_equal(mu[k], jmu[k]) for k in jmu)
        assert pstate.step == int(jstate.step) > 0
        assert pstate.ema_params is not None

    pdir = tmp_path / "port"
    train.train(cfg, ds, checkpoint_dir=str(pdir), device="cpu")
    jstate, meta, _ = jtrain.load_best_model(str(pdir), jcfg, shapes)
    pstate, _, _ = train.load_best_model(str(pdir), configs.REF_DEFAULT,
                                         device="cpu")
    assert meta["model"] == "refmlp" and isinstance(pstate.model,
                                                    RefCondMLP)
    same(pstate, jstate)

    jdir = tmp_path / "jax"
    jtrain.train(dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, checkpoint_dir=str(jdir))), jds)
    jstate, _, _ = jtrain.load_best_model(str(jdir), jcfg, shapes)
    pstate, _, _ = train.load_best_model(str(jdir), configs.REF_DEFAULT,
                                         device="cpu")
    same(pstate, jstate)
    x, cond = ds.params_u[:3], ds.conditions[:3]
    t = np.array([0, 20, 49], np.int32)
    want = jbuild_model(jcfg.model).apply({"params": jstate.params}, x, t,
                                          cond)
    with torch.no_grad():
        got = pstate.model(t32(x), torch.from_numpy(t).long(), t32(cond))
    _close(got, want, "restored forward")


@pytest.mark.parametrize("kind,guidance", [("halve", 1.0),
                                           ("convert", 2.0)])
def test_distill_batch_matches_ertdx(kind, guidance):
    n_student = 4
    fm, params, tm = refmlp_pair(uncond_prob=0.2 if guidance != 1 else 0.0,
                                 seed=12)
    jsch = jdiff.get_diffusion_schedule(T)
    tsch = diffusion.DiffusionSchedule(*(t32(a) for a in jsch))
    if kind == "halve":
        jfns = jdistill.make_distill_epoch(fm.apply, jsch, n_student, "eps",
                                           donate=False, guidance=guidance)
        fns = distill.make_distill_epoch(tsch, n_student, "eps",
                                         guidance=guidance)
        high = n_student
    else:
        jfns = jdistill.make_convert_epoch(fm.apply, jsch, "eps",
                                           donate=False, guidance=guidance)
        fns = distill.make_convert_epoch(tsch, "eps", guidance=guidance)
        high = T
    rng = np.random.default_rng(13)
    x0 = rng.normal(size=(4, 29)).astype(np.float32)
    cond = rng.uniform(size=(4, 64, 14)).astype(np.float32)
    teacher = copy.deepcopy(tm).requires_grad_(False)
    tparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = jtrain.TrainState.create(apply_fn=fm.apply, params=tparams,
                                     tx=optax.adam(LR))
    key = jax.random.key(14)
    bidx = np.arange(4, dtype=np.int32)[None]
    jstate, jl = jfns[0](state, tparams, jnp.asarray(x0), jnp.asarray(cond),
                         jnp.asarray(bidx), key)
    tstate = train.TrainState(tm, train.create_optimizer(tm, LR), LR)
    loss = fns.epoch(tstate, teacher, t32(x0), t32(cond),
                     torch.from_numpy(bidx).long(),
                     draws=[distill_draws(key, 4, 29, high)])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _params_close(named_to_jax(tm, dict(tm.named_parameters())),
                  jstate.params, _grads(tm), 1)


def test_distill_end_to_end(tmp_path):
    p, ert = _arrays(n=48)
    ds = prepare_dataset(p, ert)
    cfg = dataclasses.replace(_small_cfg(), diffusion=configs.DiffusionConfig(
        T=16))
    teacher = tmp_path / "teacher"
    train.train(cfg, ds, checkpoint_dir=str(teacher), device="cpu")
    res = distill.distill(
        configs.ExperimentConfig(),
        distill.DistillConfig(target_steps=2, start_steps=4,
                              epochs_per_stage=1, convert_epochs=1,
                              batch_size=16),
        ds, teacher_dir=str(teacher), out_dir=str(tmp_path / "pd2"),
        device="cpu")
    assert [s.kind for s in res.stages] == ["convert", "halve"]
    assert isinstance(res.state.model, RefCondMLP)
    saved = configs.experiment_from_dict(train.saved_config(
        str(tmp_path / "pd2")))
    assert (saved.model.name, saved.sample.sampler, saved.sample.pd_steps,
            saved.model.parameterization) == ("refmlp", "pd", 2, "v")
    state, _, _ = train.load_best_model(str(tmp_path / "pd2"), saved,
                                        device="cpu")
    u = sample.posterior_ensemble(
        state.model, t32(ds.conditions[:3]),
        diffusion.schedule_from_config(saved.diffusion), 5, saved.sample,
        generator=torch.Generator().manual_seed(0), device="cpu")
    assert u.shape == (5, 3, 29) and torch.isfinite(u).all()


def test_cli_default_preset_trains_and_samples(tmp_path, monkeypatch):
    """`ertdiff train` with no --preset (ref_default, the refmlp), then
    `calibrate --commit` and `sample` from its checkpoint, on the CPU."""
    monkeypatch.chdir(tmp_path)
    p, ert = _arrays(n=32)
    np.save("p.npy", p)
    np.save("e.npy", ert)
    c = ["--params", "p.npy", "--ert", "e.npy", "--device", "cpu"]
    assert cli.main(["train", *c, "--checkpoint-dir", "ck", "--epochs",
                     "2"]) == 0
    assert train.saved_config("ck")["model"]["name"] == "refmlp"
    assert cli.main(["calibrate", *c, "--checkpoint-dir", "ck", "--temps",
                     "1.0,1.5", "--realizations", "3", "--sampler", "ddim",
                     "--steps", "4", "--eta", "0.5", "--commit"]) == 0
    assert train.saved_config("ck")["sample"]["ddim_eta"] == 0.5
    assert cli.main(["sample", *c, "--checkpoint-dir", "ck",
                     "--realizations", "3", "--sampler", "ddim", "--steps",
                     "4"]) == 0
    pred = np.load("Uncertainty_params.npy")
    assert pred.shape[0] == 3 and pred.shape[2] == 29
    assert np.isfinite(pred).all()
