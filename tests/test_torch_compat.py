"""The reference's `.pth` weights on the port (ertdx_torch.compat).

tests/test_compat.py's cases on the port:

* a twin of the reference `ConditionalDiffusionModel` (channel-first,
  ERT_Conditional_Diffusion.py:121-164) and the port's RefCondMLP loaded
  from its state dict agree on the same inputs within
  2e-5 x max(1, max|twin|) (the same torch operations on transposed
  layouts); the flax tree equals `ertdx.compat.torch_reference_params`'s
  bit for bit, and the flax model on it agrees within 1e-5 x max(1,
  max|JAX|);
* a `.pth` file, and the dicts that wrap a state dict; a wrong dict
  raises JAX's KeyError; widths the config does not build raise;
* `python -m ertdx_torch.cli sample --torch-checkpoint ... --model
  refmlp` gives the draws of `posterior_over_dataset` in process from
  the same seed (bit for bit), and the CLI's refusals are JAX's;
* `PosteriorService.from_torch(...).posterior(...)` gives the draws of
  `posterior_ensemble` in process from the same seed (bit for bit).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from ertdx.compat import torch_reference_params
from ertdx.models import RefCondMLP as FlaxRefCondMLP
from ertdx_torch import cli, compat, configs, data, diffusion, sample, serve
from ertdx_torch.doe import SurrogateDataGenerator
from test_torch_train import _leaves
from torch_parity_common import t32

P, H, C, L, B = 29, 128, 14, 64, 5


class _TorchRef(nn.Module):
    """Independent rebuild of the reference architecture (the twin of
    tests/test_compat.py)."""

    def __init__(self, param_dim=P, hidden_dim=H):
        super().__init__()
        self.condition_encoder = nn.Sequential(
            nn.Conv1d(C, 32, 3, stride=2, padding=1), nn.ReLU(),
            nn.Conv1d(32, 64, 3, stride=2, padding=1), nn.ReLU(),
            nn.AdaptiveAvgPool1d(1), nn.Flatten(),
            nn.Linear(64, hidden_dim), nn.ReLU())
        self.time_embed = nn.Sequential(
            nn.Linear(hidden_dim, hidden_dim), nn.ReLU())
        self.mlp = nn.Sequential(
            nn.Linear(param_dim + 2 * hidden_dim, hidden_dim), nn.ReLU(),
            nn.Linear(hidden_dim, param_dim))

    def forward(self, x, t, condition):
        half = H // 2
        freqs = torch.exp(
            -torch.log(torch.tensor(10000.0))
            * torch.arange(half, dtype=torch.float32) / (half - 1))
        args = t.float()[:, None] * freqs[None]
        temb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
        temb = self.time_embed(temb)
        cemb = self.condition_encoder(condition)
        return self.mlp(torch.cat([x, temb, cemb], dim=1))


def _twin(seed):
    torch.manual_seed(seed)
    return _TorchRef().eval()


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, P)).astype(np.float32)
    t = rng.integers(0, 500, size=(B,))
    cond = rng.normal(size=(B, C, L)).astype(np.float32)
    return x, t, cond


def test_forward_matches_the_twin_and_flax():
    tm = _twin(7)
    x, t, cond = _inputs()
    with torch.no_grad():
        ref = tm(t32(x), torch.from_numpy(t), t32(cond)).numpy()
        model, tree = compat.load_reference_model(
            tm.state_dict(), configs.REF_DEFAULT.model, device="cpu")
        got = model(t32(x), torch.from_numpy(t).long(),
                    t32(cond.transpose(0, 2, 1))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-5 * max(1.0, np.abs(ref).max()))
    want = _leaves(torch_reference_params(tm.state_dict()))
    assert _leaves(tree).keys() == want.keys()
    assert all(np.array_equal(_leaves(tree)[k], want[k]) for k in want)
    fm = FlaxRefCondMLP(param_dim=P, hidden_dim=H, cond_channels=C)
    jout = np.asarray(fm.apply({"params": torch_reference_params(
        tm.state_dict())}, jnp.asarray(x), jnp.asarray(t, jnp.int32),
        jnp.asarray(cond.transpose(0, 2, 1))))
    np.testing.assert_allclose(got, jout, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(jout).max()))


def test_pth_files_and_wrapped_dicts(tmp_path):
    tm = _twin(8)
    path = tmp_path / "best_model.pth"
    torch.save(tm.state_dict(), path)
    tree = compat.reference_tree(str(path))
    assert tree["head2"]["Dense_0"]["kernel"].shape == (H, P)
    for wrapper in ("state_dict", "model"):
        wrapped = tmp_path / f"{wrapper}.pth"
        torch.save({wrapper: tm.state_dict(), "epoch": 3}, wrapped)
        other = compat.reference_tree(wrapped)
        assert all(np.array_equal(_leaves(other)[k], v)
                   for k, v in _leaves(tree).items())
    model, _ = compat.load_reference_model(
        path, configs.REF_DEFAULT.model, device="cpu")
    assert model.param_dim == P and not hasattr(model, "null_vec")


def test_wrong_dicts_and_widths_are_refused():
    bad = {"mlp.0.weight": np.zeros((1, 1))}
    with pytest.raises(KeyError) as want:
        torch_reference_params(bad)
    with pytest.raises(KeyError) as got:
        compat.reference_tree(bad)
    assert str(got.value) == str(want.value)
    state = _twin(9).state_dict()
    with pytest.raises(ValueError):        # hidden 128 into hidden 32
        compat.load_reference_model(state, dataclasses.replace(
            configs.REF_DEFAULT.model, hidden_dim=32), device="cpu")
    with pytest.raises(ValueError, match="refmlp"):
        compat.load_reference_model(state, configs.DDIM_ENSEMBLE.model,
                                    device="cpu")


def _files(tmp_path, seed):
    n = 32
    sim_param = SurrogateDataGenerator(seed=seed).generate_training_samples(
        n, "sobol")[..., None]
    ert = np.random.default_rng(seed).normal(50.0, 10.0,
                                             size=(n, L, C)).astype(
                                                 np.float32)
    np.save(tmp_path / "sim_param.npy", sim_param)
    np.save(tmp_path / "sim_ert.npy", ert)
    torch.save(_twin(seed + 10).state_dict(), tmp_path / "best_model.pth")
    return sim_param, ert


def test_cli_sample_with_torch_checkpoint(tmp_path):
    sim_param, ert = _files(tmp_path, 1)
    out = tmp_path / "u.npy"
    argv = ["sample", "--params", str(tmp_path / "sim_param.npy"),
            "--ert", str(tmp_path / "sim_ert.npy"), "--torch-checkpoint",
            str(tmp_path / "best_model.pth"), "--model", "refmlp",
            "--realizations", "4", "--seed", "5", "--sampler", "ddim",
            "--steps", "10", "--device", "cpu"]
    assert cli.main(argv + ["--out", str(out)]) == 0
    pred = np.load(out)
    assert pred.shape[0] == 4 and np.isfinite(pred).all()

    cfg = configs.REF_DEFAULT
    model, _ = compat.load_reference_model(tmp_path / "best_model.pth",
                                           cfg.model, device="cpu")
    ds = data.prepare_dataset(sim_param, ert)
    # without a checkpoint's echo, --seed is also the split's seed (JAX's
    # CLI too)
    _, _, test_idx = data.split_dataset(len(ds), 5, cfg.train.split)
    want, mask = sample.posterior_over_dataset(
        model.eval(), ds.conditions[test_idx],
        diffusion.schedule_from_config(cfg.diffusion), ds.param_scaler,
        n_realizations=4, batch_size=cfg.train.batch_size,
        scfg=dataclasses.replace(cfg.sample, sampler="ddim", ddim_steps=10,
                                 dpmpp_steps=10, pd_steps=10),
        generator=torch.Generator().manual_seed(5), device="cpu")
    np.testing.assert_array_equal(pred, want)
    np.testing.assert_array_equal(np.load(tmp_path / "valid_mask.npy"),
                                  mask)

    refusals = [(["--ema"], "--ema has no meaning for --torch-checkpoint"),
                (["--model", "condunet"], "--torch-checkpoint maps onto the "
                 "reference architecture: use --model refmlp")]
    for extra, message in refusals:
        with pytest.raises(SystemExit) as e:
            cli.main(argv + extra)
        assert str(e.value.code) == message
    with pytest.raises(SystemExit) as e:
        cli.main(["serve", "--torch-checkpoint", "w.pth", "--device",
                  "cpu"])
    assert str(e.value.code).startswith(
        "--torch-checkpoint needs --params/--ert")


def test_serve_from_torch_checkpoint(tmp_path):
    sim_param, ert = _files(tmp_path, 2)
    cfg = configs.ExperimentConfig(
        diffusion=configs.DiffusionConfig(T=20),
        model=dataclasses.replace(configs.ModelConfig(), name="refmlp",
                                  cond_length=L, cond_channels=C))
    svc = serve.PosteriorService.from_torch(
        tmp_path / "best_model.pth", cfg, sim_param, ert, max_batch=2,
        device="cpu")
    assert svc.meta == {"model": "refmlp (torch import)"}
    out = svc.posterior(ert[:2], n_realizations=3, seed=1,
                        return_draws=True)
    assert len(out["mean"]) == 2 and len(out["mean"][0]) == P
    assert np.isfinite(np.asarray(out["mean"])).all()
    assert out["n_realizations"] == 3

    ds = data.prepare_dataset(sim_param, ert)
    model, _ = compat.load_reference_model(tmp_path / "best_model.pth",
                                           cfg.model, device="cpu")
    cond = ds.ert_scaler.transform(ert[:2].reshape(2, -1)).reshape(
        2, L, C).astype(np.float32)
    u = sample.posterior_ensemble(
        model.eval(), t32(cond), diffusion.schedule_from_config(
            cfg.diffusion), 3, cfg.sample,
        generator=torch.Generator().manual_seed(1), device="cpu")
    phys, _ = sample.device_inverse(u, ds.param_scaler,
                                    svc.space.plims)
    np.testing.assert_array_equal(np.asarray(out["draws"], np.float32),
                                  phys.numpy())
    with pytest.raises(ValueError, match="refmlp"):
        serve.PosteriorService.from_torch(
            tmp_path / "best_model.pth", configs.DDIM_ENSEMBLE, sim_param,
            ert, device="cpu")
