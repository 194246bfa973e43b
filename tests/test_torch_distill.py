"""The port's progressive distillation against ertdx.distill.

* `one_step_target`, `_snr_weight`, `_x0_from_out`, `_eps_from_out` and
  `_halvings` against JAX's (rtol 1e-6; the same error messages).
* One batch of `make_distill_epoch` and `make_convert_epoch`, and of the
  guided teacher (a CFG teacher at g=2, through the conversion): JAX's epoch runs on one batch with its
  own key, whose draws are reproduced as `distill.py:213-251` makes them
  (`split(key, 1)[0]`, then `split` into kt, kn, `randint` and `normal`)
  and injected into the port's epoch. The loss agrees to rtol 1e-5 and
  the parameters after the Adam step to the tolerances of
  tests/test_torch_train.py (2e-6, but for near-zero gradients). The
  validation pass is compared on a padded batch (w = 1, 1, 1, 0).
* A tiny `distill()` on the CPU end to end, on a flash-arm eps teacher
  with EMA: a conversion stage and one halving, `save_stages`, the
  student's echo and meta, JAX's `load_best_model` restoring the same
  weights without flags, and the port serving it with `sample_pd`.
* The refusals of tests/test_distill.py:283-352, and a `mesh`
  that is not one.
"""
from __future__ import annotations

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ertdx import configs as jconfigs
from ertdx import diffusion as jdiff
from ertdx import distill as jdistill
from ertdx import train as jtrain
from ertdx_torch import configs, diffusion, distill, sample, train
from ertdx_torch.data import prepare_dataset
from ertdx_torch.utils.weights import named_to_jax
from test_torch_train import LR, T, _batch, _leaves, _params_close
from torch_parity_common import make_pair, t32


def test_targets_and_weights_match_jax():
    rng = np.random.default_rng(0)
    x, x_dst, out = (rng.normal(size=(16, 5)).astype(np.float32)
                     for _ in range(3))
    ab_t = rng.uniform(0.01, 0.6, (16, 1)).astype(np.float32)
    ab_dst = rng.uniform(0.7, 0.999, (16, 1)).astype(np.float32)
    a, s = np.sqrt(ab_t), np.sqrt(1.0 - ab_t)
    pairs = [(distill.one_step_target(t32(x), t32(x_dst), t32(ab_t),
                                      t32(ab_dst)),
              jdistill.one_step_target(x, x_dst, ab_t, ab_dst)),
             (distill._snr_weight(t32(ab_dst)),
              jdistill._snr_weight(ab_dst))]
    for kind in ("eps", "v"):
        pairs += [(distill._x0_from_out(t32(out), t32(x), t32(a), t32(s),
                                        kind),
                   jdistill._x0_from_out(out, x, a, s, kind)),
                  (distill._eps_from_out(t32(out), t32(x), t32(a), t32(s),
                                         kind),
                   jdistill._eps_from_out(out, x, a, s, kind))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    for start, target in ((64, 4), (4, 4), (8, 2)):
        assert distill._halvings(start, target) == jdistill._halvings(
            start, target)
    for start, target in ((48, 4), (2, 4)):
        with pytest.raises(ValueError) as want:
            jdistill._halvings(start, target)
        with pytest.raises(ValueError, match=str(want.value)
                           .replace("*", "\\*")):
            distill._halvings(start, target)


def _jax_draws(key, b, p, high):
    """The grid index (or t) and the noise of the first batch of an epoch
    run with `key` (ertdx/distill.py:213-227, 276-282, 325)."""
    kt, kn = jax.random.split(jax.random.split(key, 1)[0])
    idx = jax.random.randint(kt, (b,), 0, high, dtype=jnp.int32)
    noise = jax.random.normal(kn, (b, p), jnp.float32)
    return torch.from_numpy(np.array(idx)).long(), t32(noise)


@pytest.mark.parametrize("kind,guidance", [
    ("halve", 1.0), ("convert", 1.0), ("convert", 2.0)])
def test_one_batch_matches_ertdx(kind, guidance):
    n_student = 4
    fm, params, tm = make_pair(seed=41, depth=1, num_blocks=1,
                               uncond_prob=0.2 if guidance != 1 else 0.0)
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
    x0, cond = _batch(500, b=4)
    teacher = copy.deepcopy(tm).requires_grad_(False)
    tparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = jtrain.TrainState.create(apply_fn=fm.apply, params=tparams,
                                     tx=optax.adam(LR))
    key = jax.random.key(7)
    bidx = np.arange(4, dtype=np.int32)[None]
    jstate, jl = jfns[0](state, tparams, jnp.asarray(x0), jnp.asarray(cond),
                         jnp.asarray(bidx), key)

    tstate = train.TrainState(tm, train.create_optimizer(tm, LR), LR)
    loss = fns.epoch(tstate, teacher, t32(x0), t32(cond),
                     torch.from_numpy(bidx).long(),
                     draws=[_jax_draws(key, 4, 29, high)])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    # the null context takes no gradient here (the student sees no drop)
    grads = named_to_jax(tm, {n: torch.zeros_like(p) if p.grad is None
                              else p.grad for n, p in tm.named_parameters()})
    _params_close(named_to_jax(tm, dict(tm.named_parameters())),
                  jstate.params, grads, 1)

    if (kind, guidance) == ("halve", 1.0):
        w = np.array([[1, 1, 1, 0]], np.float32)
        vkey = jax.random.key(9)
        want = jfns[1](tparams, tparams, jnp.asarray(x0), jnp.asarray(cond),
                       jnp.asarray(bidx), jnp.asarray(w), vkey)
        got = fns.val(teacher, teacher, t32(x0), t32(cond),
                      torch.from_numpy(bidx).long(), t32(w),
                      draws=[_jax_draws(vkey, 4, 29, high)])
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


TINY = dict(name="condunet", hidden_dim=32, cond_length=96, cond_channels=4,
            base_width=16, depth=1, num_heads=2, num_blocks=1)


def _dataset(n=48):
    rng = np.random.default_rng(0)
    return prepare_dataset(rng.uniform(0.1, 0.9, size=(n, 29, 1)),
                           rng.normal(50.0, 10.0, size=(n, 96, 4)))


@pytest.fixture(scope="module")
def teachers(tmp_path_factory):
    """Two tiny port-trained teacher checkpoints: a flash-arm eps teacher
    with EMA, and a v teacher; T=16, one epoch each."""
    ds = _dataset()
    out = {}
    for name, model_kw, train_kw in (
            ("eps", dict(attn_flash_min_logits=1), dict(ema_decay=0.9)),
            ("v", dict(parameterization="v"), {})):
        cfg = configs.ExperimentConfig(
            diffusion=configs.DiffusionConfig(T=16),
            model=dataclasses.replace(configs.ModelConfig(), **TINY,
                                      **model_kw),
            train=dataclasses.replace(configs.TrainConfig(), num_epochs=1,
                                      batch_size=16, seed=5, **train_kw))
        ckdir = str(tmp_path_factory.mktemp(f"teacher_{name}"))
        train.train(cfg, ds, checkpoint_dir=ckdir, device="cpu")
        out[name] = ckdir
    return ds, out


def test_distill_end_to_end(teachers, tmp_path):
    ds, dirs = teachers
    out = str(tmp_path / "student")
    dcfg = distill.DistillConfig(target_steps=2, start_steps=4,
                                 epochs_per_stage=1, convert_epochs=1,
                                 batch_size=16, seed=3, save_stages=True,
                                 use_ema_teacher=True)
    logs = []
    # a plain default cfg: the teacher's echo wins (model, T, seed)
    res = distill.distill(configs.ExperimentConfig(), dcfg, ds, dirs["eps"],
                          out_dir=out, logger=logs.append, device="cpu")
    assert [(s.kind, s.student_steps) for s in res.stages] == [
        ("convert", 4), ("halve", 2)]
    assert len(logs) == 2 and all(np.isfinite(s.losses + s.val_losses).all()
                                  for s in res.stages)
    assert res.state.model.encoder.attn.flash_min_logits == 1

    saved = train.saved_config(out)
    assert saved["sample"]["sampler"] == "pd"
    assert saved["sample"]["pd_steps"] == 2
    assert saved["sample"]["guidance_scale"] == 1.0
    assert tuple(saved["sample"]["guidance_interval"]) == (0.0, 1.0)
    assert saved["model"]["parameterization"] == "v"
    assert saved["diffusion"]["T"] == 16
    assert saved["train"]["seed"] == 5
    assert saved["train"]["lr_schedule"] == "cosine"
    assert saved["train"]["ema_decay"] == 0.0
    assert not saved["train"]["flat_optimizer"]
    assert train.saved_config(os.path.join(out, "pd2"))["sample"][
        "pd_steps"] == 2
    state, meta, _ = train.load_best_model(out, configs.ExperimentConfig(),
                                           device="cpu")
    assert {"distilled_from", "target_steps", "baked_guidance_scale",
            "stages", "best_val_loss", "epoch"} <= set(meta)
    assert meta["epoch"] == 2 and meta["target_steps"] == 2

    # JAX restores the port's student without flags: the same weights
    jstate, _, _ = jtrain.load_best_model(out, jconfigs.ExperimentConfig(),
                                          (ds.cond_shape, ds.param_dim))
    want = _leaves(named_to_jax(res.state.model,
                                dict(res.state.model.named_parameters())))
    got = _leaves(jstate.params)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)

    # and the port serves it with the echo's sampler (pd-2)
    scfg = configs.experiment_from_dict(saved).sample
    u = sample.posterior_ensemble(
        state.model, ds.conditions[:2], diffusion.schedule_from_config(
            configs.experiment_from_dict(saved).diffusion), 5, scfg,
        generator=torch.Generator().manual_seed(0), device="cpu")
    assert tuple(u.shape) == (5, 2, 29) and torch.isfinite(u).all()


def test_start_steps_clamp_and_refusals(teachers):
    ds, dirs = teachers
    base = dict(epochs_per_stage=1, batch_size=16)
    cfg = configs.ExperimentConfig()
    res = distill.distill(cfg, distill.DistillConfig(
        target_steps=4, start_steps=512, **base), ds, dirs["v"],
        device="cpu")
    assert [s.student_steps for s in res.stages] == [8, 4]
    with pytest.raises(ValueError, match="2\\*\\*k"):
        distill.distill(cfg, distill.DistillConfig(
            target_steps=4, start_steps=48, **base), ds, dirs["v"],
            device="cpu")
    with pytest.raises(ValueError, match="target_steps"):
        distill.distill(cfg, distill.DistillConfig(
            target_steps=32, start_steps=32, **base), ds, dirs["v"],
            device="cpu")
    with pytest.raises(ValueError, match="uncond_prob"):
        distill.distill(cfg, distill.DistillConfig(
            target_steps=4, start_steps=8, guidance_scale=2.0, **base), ds,
            dirs["v"], device="cpu")
    with pytest.raises(ValueError, match="nothing to distill"):
        distill.distill(cfg, distill.DistillConfig(
            target_steps=4, start_steps=4, convert_epochs=0, **base), ds,
            dirs["eps"], device="cpu")
    # a mesh is ported (tests/test_torch_dp_sample.py); a non-mesh raises
    with pytest.raises(TypeError, match="make_mesh"):
        distill.distill(cfg, distill.DistillConfig(**base), ds, dirs["v"],
                        mesh=object(), device="cpu")
