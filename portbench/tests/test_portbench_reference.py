"""The plain reference against the port's CPU module path, from the same
weights, at a small size: the encoder, one denoiser call and the whole
DDIM posterior (the port in float32 on the CPU computes the float32
function, so the two agree to float32 rounding)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench import cells, weights
from portbench.reference import model as ref_model
from portbench.reference import sampler as ref
from portbench.tests.tiny import TINY_MODEL

from ertdx_torch import configs as port_configs
from ertdx_torch.diffusion import schedule_from_config
from ertdx_torch.models import build_model
from ertdx_torch.sample import posterior_ensemble

TOL = 2e-5


def _config(name: str, **model) -> dict:
    conf = json.loads((cells.ROOT / "configs" / f"{name}.json").read_text())
    conf["config"]["model"].update(model)
    return conf


def _port_model(conf: dict, w: dict):
    cfg = port_configs.experiment_from_dict(
        conf["config"], base=port_configs.PRESETS[conf["config"]["name"]])
    model = build_model(dataclasses.replace(cfg.model, dtype="float32"),
                        device="cpu")
    model.load_state_dict(w, strict=True)
    return model.eval(), cfg


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("name", ["ddim_ensemble", "v5e8_dp"])
def test_param_shapes_are_the_ports(name):
    conf = _config(name)
    model, _ = _port_model(conf, {
        k: torch.zeros(s) for k, s in
        ref_model.param_shapes(conf["config"]["model"]).items()})
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ref_model.param_shapes(conf["config"]["model"]) == want


@pytest.mark.parametrize("seed", [3, 2 ** 40 + 7])
def test_encoder_and_denoiser_match_the_port(seed):
    conf = _config("ddim_ensemble", **TINY_MODEL)
    m = conf["config"]["model"]
    w = weights.make_weights(m, seed, "cpu")
    model, _ = _port_model(conf, w)
    cond = torch.rand(2, m["cond_length"], m["cond_channels"],
                      generator=torch.Generator().manual_seed(1))
    r = 5
    x = torch.randn(2 * r, m["param_dim"],
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        tokens, pooled = model.encode_condition(cond)
        eps = model.denoise_ensemble(x, torch.full((2 * r,), 17), (tokens,
                                     pooled), r)
    rt, rp = ref_model.encode(cond, w, m)
    assert _rel(rt, tokens) < TOL and _rel(rp, pooled) < TOL
    reps = ref_model.denoise(x, 17, rp, ref_model.cross_kv(rt, w, m,
                             ref_model.matmul_fp32), w, m)
    assert _rel(reps, eps) < TOL


def test_posterior_matches_the_port():
    conf = _config("ddim_ensemble", **TINY_MODEL)
    conf["config"]["diffusion"]["T"] = 60
    m, steps, members = conf["config"]["model"], 6, 4
    w = weights.make_weights(m, 9, "cpu")
    model, cfg = _port_model(conf, w)
    raw = weights.make_surveys(3, m["cond_length"], m["cond_channels"],
                               9, 2, "cpu").numpy()
    train = weights.make_surveys(5, m["cond_length"], m["cond_channels"],
                                 9, 1, "cpu").numpy()
    x_t = torch.randn(3 * members, m["param_dim"],
                      generator=torch.Generator().manual_seed(4))
    cond = ref.scale_conditions(raw, train)
    u = posterior_ensemble(
        model, torch.from_numpy(cond), schedule_from_config(cfg.diffusion),
        members, dataclasses.replace(cfg.sample, ddim_steps=steps),
        x_T=x_t, device="cpu")
    want = ref.posterior_draws(raw, train, x_t, w, m,
                               conf["config"]["diffusion"], steps, members,
                               "cpu", block=2)
    assert _rel(u.numpy(), want) < TOL
    assert np.abs(want).max() > 0.1      # the draws are not degenerate


@pytest.mark.parametrize("name", ["ddim_ensemble", "v5e8_dp"])
def test_weights_keep_the_draws_off_the_sigmoid_ends(name):
    """At the configuration's widths and steps, the seed's weights give
    draws that the sigmoid does not saturate (a comparison would see
    nothing there) and that the core moves away from the prior draw."""
    conf = _config(name)
    m = conf["config"]["model"]
    w = weights.make_weights(m, 5, "cpu")
    raw = weights.make_surveys(1, m["cond_length"], m["cond_channels"],
                               5, 2, "cpu").numpy()
    x_t = torch.randn(16, m["param_dim"],
                      generator=torch.Generator().manual_seed(6))
    u = ref.posterior_draws(raw, raw, x_t, w, m, conf["config"]["diffusion"],
                            conf["config"]["sample"]["ddim_steps"], 16,
                            "cpu")[:, 0]
    assert np.mean(np.abs(u) > 6) < 0.02
    assert np.corrcoef(u.ravel(), x_t.numpy().ravel())[0, 1] < 0.97


def test_rounding_helpers():
    a = torch.tensor([1.0 + 2 ** -12, 1.0 + 3 * 2 ** -11, -300.0, 0.0])
    assert round_exact(ref_model.round_tf32(a)) == [1.0, 1.0 + 2 ** -9,
                                                     -300.0, 0.0]
    b = ref_model.round_fp8(torch.tensor([1.06, 3.0, 900.0]))
    assert round_exact(b) == [1.0, 3.0, 896.0]


def round_exact(t):
    return [float(v) for v in t]
