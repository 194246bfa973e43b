"""The port's parameter layer against the JAX package's: ParameterScaler,
the parameter-name shims, ParameterSampler, x0_from_v and
commit_sample_config (whose meta.json JAX's saved_config reads back as
the port's does). The same seeded numpy inputs go through both."""
from __future__ import annotations

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx import diffusion as jdiff
from ertdx import doe as jdoe
from ertdx import params as jparams
from ertdx import sample as jsample
from ertdx import train as jtrain
from ertdx import transforms as jtransforms
from ertdx.utils import checkpoint as jckpt
from ertdx_torch import diffusion, doe, params, sample, train, transforms
from ertdx_torch.utils import checkpoint as tckpt


def _unit(seed, shape):
    return np.random.default_rng(seed).uniform(-0.2, 1.2, size=shape)


@pytest.mark.parametrize("shape", [(29,), (5, 29), (2, 3, 29)])
def test_parameter_scaler_matches_jax(shape):
    u = _unit(shape[0], shape)
    js, ts = jtransforms.ParameterScaler(), transforms.ParameterScaler()
    want = js.descale(u)
    np.testing.assert_array_equal(ts.descale(u), want)
    np.testing.assert_array_equal(ts.scale(want), js.scale(want))
    # torch tensors, float64 and float32, against JAX's arrays
    np.testing.assert_allclose(ts.descale(torch.from_numpy(u)).numpy(),
                               want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(ts.scale(torch.from_numpy(want)).numpy(),
                               js.scale(want), rtol=1e-12, atol=1e-15)
    u32 = u.astype(np.float32)
    np.testing.assert_allclose(
        ts.descale(torch.from_numpy(u32)).numpy(),
        np.asarray(js.descale(jnp.asarray(u32))), rtol=2e-6)


def test_parameter_scaler_warns_as_jax(capsys):
    u = _unit(9, (3, 29))
    jtransforms.ParameterScaler().descale(u, warn=True)
    want = capsys.readouterr().out
    transforms.ParameterScaler().descale(u, warn=True)
    assert capsys.readouterr().out == want and "Warning" in want


def test_parameter_names_and_limits():
    assert params.default_space().names == jparams.default_space().names
    np.testing.assert_array_equal(params.ParameterLimits().plims,
                                  jparams.ParameterLimits().plims)
    assert params.ParameterLimits().logparms == \
        jparams.ParameterLimits().logparms
    assert params.ParameterNames().names == jparams.ParameterNames().names


def test_parameter_sampler_matches_jax():
    js = jdoe.ParameterSampler(rng=np.random.default_rng(4))
    ts = doe.ParameterSampler(rng=np.random.default_rng(4))
    np.testing.assert_array_equal(ts.get_mean_parameters(),
                                  js.get_mean_parameters())
    for _ in range(3):
        np.testing.assert_array_equal(ts.sample(), js.sample())
    means = js.get_mean_parameters()
    for psd in (0.05 * means, np.linspace(0.01, 0.1, 29) * means):
        np.testing.assert_array_equal(ts.build_mod_in(means, psd, 7),
                                      js.build_mod_in(means, psd, 7))
    np.testing.assert_array_equal(ts.build_mod_in(means, 0.1, 1),
                                  js.build_mod_in(means, 0.1, 1))
    # a scalar sd (every parameter's own), as the reference passes it
    np.testing.assert_array_equal(ts.build_mod_in(means, 1e-9, 4),
                                  js.build_mod_in(means, 1e-9, 4))


def test_parameter_sampler_non_convergence_raises_as_jax():
    means = jdoe.ParameterSampler().get_mean_parameters()
    errs = []
    for mod in (jdoe, doe):
        with pytest.raises(RuntimeError) as e:
            mod.ParameterSampler(rng=np.random.default_rng(0)).build_mod_in(
                means, 1e6, 3, max_attempts=3)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("method", ["lhs", "sobol"])
def test_design_matches_jax_and_diagnostics_refuse(method, tmp_path):
    """The design equals JAX's; with plot_diagnostics=True (which the port
    refused before plots.py was ported) it writes JAX's two figures too,
    each from the same design (tests/test_torch_plots.py compares what
    the figures draw)."""
    want = jdoe.SurrogateDataGenerator(seed=5).generate_training_samples(
        64, method, output_dir=str(tmp_path))
    gen = doe.SurrogateDataGenerator(seed=5)
    np.testing.assert_array_equal(
        gen.generate_training_samples(64, method, output_dir=str(tmp_path)),
        want)
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    got = {
        "jax": jdoe.SurrogateDataGenerator(seed=5).generate_training_samples(
            8, method, plot_diagnostics=True, output_dir=str(dirs["jax"])),
        "port": gen.generate_training_samples(
            8, method, plot_diagnostics=True, output_dir=str(dirs["port"]))}
    np.testing.assert_array_equal(got["port"], got["jax"])
    names = {k: sorted(f.name for f in d.iterdir()) for k, d in dirs.items()}
    assert names["port"] == names["jax"] == [
        "parameter_correlations.png", "sampling_diagnostics.png"]
    for f in dirs["port"].iterdir():
        assert f.stat().st_size > 1000


def test_x0_from_v_matches_jax():
    rng = np.random.default_rng(2)
    v, x = rng.normal(size=(2, 6, 29)).astype(np.float32)
    ab = rng.uniform(0.01, 0.99, size=(6, 1)).astype(np.float32)
    got = diffusion.x0_from_v(*(torch.from_numpy(a) for a in (v, x, ab)))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jdiff.x0_from_v(v, x, ab)), rtol=1e-6,
        atol=1e-6)
    # the inverse of the v target
    x0, eps = (torch.from_numpy(a) for a in (v, x))
    abt = torch.from_numpy(ab)
    xt = torch.sqrt(abt) * x0 + torch.sqrt(1 - abt) * eps
    vt = diffusion.v_from_eps_x0(eps, x0, abt)
    torch.testing.assert_close(diffusion.x0_from_v(vt, xt, abt), x0,
                               rtol=1e-5, atol=1e-5)


def _checkpoint_tree(root, with_last):
    for name in ("best", "last") if with_last else ("best",):
        d = root / name
        d.mkdir(parents=True)
        (d / "meta.json").write_text(json.dumps({
            "epoch": 3, "best_val_loss": 0.5,
            "config": {"model": {"name": "condunet"},
                       "sample": {"sampler": "ancestral",
                                  "temperature": 1.0}}}))


@pytest.mark.parametrize("with_last", [False, True])
def test_commit_sample_config_matches_jax(tmp_path, with_last):
    fields = {"sampler": "ddim", "ddim_steps": 50,
              "temperature": (1.5, 2.0), "guidance_interval": (0.0, 1.0)}
    audit = {"objective": "goodness", "temps": [1.0, 1.5],
             "result": {"best_temperature": np.float64(1.5)}}
    roots = [tmp_path / "jax", tmp_path / "port"]
    for r in roots:
        _checkpoint_tree(r, with_last)
    wj = jckpt.commit_sample_config(roots[0], fields, calibration=audit)
    wt = tckpt.commit_sample_config(roots[1], fields, calibration=audit)
    assert [p.relative_to(roots[0]) for p in wj] == \
        [p.relative_to(roots[1]) for p in wt]
    for pj, pt in zip(wj, wt):
        assert pj.read_bytes() == pt.read_bytes()
    assert jtrain.saved_config(str(roots[1])) == \
        train.saved_config(str(roots[1])) == \
        jtrain.saved_config(str(roots[0]))
    assert train.saved_config(str(roots[1]))["sample"]["ddim_steps"] == 50
    shutil.rmtree(roots[1] / "best")
    if not with_last:
        for mod in (jckpt, tckpt):
            with pytest.raises(FileNotFoundError, match="checkpoint"):
                mod.commit_sample_config(roots[1], fields)


def test_parameter_scaler_takes_the_host_inverse(monkeypatch):
    """posterior_over_dataset sends any scaler that is not a MinMaxScaler
    to the host inverse pipeline, as JAX does; there a ParameterScaler
    (which has no `inverse`) fails as it fails in JAX."""
    seen = {}

    def host(u, scaler, a, b, space):
        seen["scaler"] = scaler
        return np.zeros(u.shape), np.ones(u.shape[:2], bool)

    monkeypatch.setattr(sample, "posterior_ensemble",
                        lambda *a, **k: torch.zeros(3, 2, 29))
    monkeypatch.setattr(sample, "inverse_pipeline", host)
    monkeypatch.setattr(sample, "_device_inverse",
                        lambda *a, **k: pytest.fail("device inverse"))
    ps = transforms.ParameterScaler()
    sample.posterior_over_dataset(None, np.zeros((2, 4, 1), np.float32),
                                  None, ps, n_realizations=3, device="cpu")
    assert seen["scaler"] is ps
    monkeypatch.undo()
    u = np.zeros((3, 2, 29))
    errs = []
    for fn, scaler in ((sample.inverse_pipeline, ps),
                       (jsample.inverse_pipeline,
                        jtransforms.ParameterScaler())):
        with pytest.raises(AttributeError) as e:
            fn(u, scaler)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
