"""The port's posterior service against the JAX package's.

One checkpoint (trained by the port on the CPU at small widths) is
served by both packages. Fed JAX's draws for a request (the request
seed's key, used as-is, as JAX's service does), the port's service must
answer within 1e-4 relative of JAX's; the same good and bad requests
over loopback to both HTTP servers must give the same status codes and
keys."""
from __future__ import annotations

import dataclasses
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ertdx import configs as jconfigs
from ertdx import serve as jserve
from ertdx_torch import configs, data, serve, train
from ertdx_torch.doe import SurrogateDataGenerator
from torch_parity_common import t32

STEPS, MAX_BATCH, P = 3, 4, 29


def _small(mod):
    return mod.ExperimentConfig(
        diffusion=mod.DiffusionConfig(T=10),
        model=dataclasses.replace(
            mod.ModelConfig(), name="condunet", hidden_dim=32,
            cond_length=96, cond_channels=4, base_width=16, depth=2,
            num_heads=2, num_blocks=2),
        train=dataclasses.replace(mod.TrainConfig(), num_epochs=1,
                                  batch_size=16),
        sample=mod.SampleConfig(sampler="ddim", ddim_steps=STEPS,
                                ddim_eta=0.5))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("serve_ck") / "ck")
    design = SurrogateDataGenerator(seed=3).generate_training_samples(
        32, "sobol")
    ert = np.random.default_rng(3).normal(50.0, 10.0, size=(32, 96, 4))
    ds = data.prepare_dataset(design[..., None], ert)
    train.train(_small(configs), ds, checkpoint_dir=ck, device="cpu")
    port = serve.PosteriorService(ck, configs.V5E8_DP, max_batch=MAX_BATCH,
                                  device="cpu")
    ref = jserve.PosteriorService(ck, _small(jconfigs), max_batch=MAX_BATCH)
    return port, ref, ert.astype(np.float32)


def _jax_draws(seed, n_real):
    k, init = jax.random.split(jax.random.key(seed))
    shape = (n_real * MAX_BATCH, P)
    x_t = jax.random.normal(init, shape)
    noise = jnp.stack([jax.random.normal(s, shape)
                       for s in jax.random.split(k, STEPS)])
    return {"x_T": t32(x_t), "noise": t32(noise)}


def test_masked_posterior_stats_matches_jax():
    rng = np.random.default_rng(0)
    phys = rng.normal(0.0, 1.0, size=(40, 4, 3))
    phys[:20, 0] += 100.0
    mask = np.ones((40, 4), bool)
    mask[:20, 0] = False                       # half invalid
    mask[:, 2] = False                         # none valid
    mask[1:, 3] = False                        # one valid draw
    got = serve.masked_posterior_stats(phys, mask)
    want = jserve.masked_posterior_stats(phys, mask)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("req", [
    {}, {"conditions": [], "n_realizations": 8},
    {"sampler": "ddim"}, {"ddim_steps": 25}, {"ddim_eta": 1},
    {"dpmpp_steps": "8"}, {"pd_steps": 2}, {"guidance_scale": 2},
    {"guidance_interval": [0.2, 0.8]}, {"temperature": 1.5},
    {"temperature": [1.0, 2.5]}, {"sampler": 3},
    {"ddim_steps": "x"}, {"temperature": [1, "a"]},
    {"guidance_interval": 3}, {"guidance_scale": None},
])
def test_scfg_from_request_matches_jax(req):
    def run(fn):
        try:
            out = fn(req)
            return None if out is None else dataclasses.asdict(out)
        except Exception as e:  # noqa: BLE001 — compared below
            return (type(e), str(e))
    assert run(serve.scfg_from_request) == run(jserve.scfg_from_request)
    assert serve._temperature_cast([1, 2]) == \
        jserve._temperature_cast([1, 2])


@pytest.mark.parametrize("b,seed,scfg", [
    (2, 1, None),
    (4, 7, dict(temperature=1.5)),
    (1, 0, dict(temperature=tuple(np.linspace(0.5, 1.5, P).tolist()))),
])
def test_service_matches_jax_on_its_draws(served, b, seed, scfg):
    port, ref, ert = served
    n_real = 6
    kw = {}
    if scfg is not None:
        kw["scfg"] = dataclasses.replace(port.cfg.sample, **scfg)
    want = ref.posterior(ert[:b], n_realizations=n_real, seed=seed,
                         return_draws=True,
                         scfg=(jconfigs.SampleConfig(**dataclasses.asdict(
                             kw["scfg"])) if kw else None))
    got = port.posterior(ert[:b], n_realizations=n_real, seed=seed,
                         return_draws=True, draws=_jax_draws(seed, n_real),
                         **kw)
    assert set(got) == set(want)
    assert got["param_names"] == want["param_names"]
    assert got["n_realizations"] == want["n_realizations"] == n_real
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for k in ("mean", "std", "p25", "p50", "p75", "draws",
              "valid_fraction"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-12)


def test_service_adopts_the_echo_and_seeds(served):
    port, ref, ert = served
    assert port.cfg.model.hidden_dim == 32 and port.cfg.sample == \
        configs.SampleConfig(sampler="ddim", ddim_steps=STEPS, ddim_eta=0.5)
    assert port.meta == ref.meta and port.model.compute_dtype is not None
    a = port.posterior(ert[:2], n_realizations=4, seed=3, return_draws=True)
    b = port.posterior(ert[:2], n_realizations=4, seed=3, return_draws=True)
    c = port.posterior(ert[:2], n_realizations=4, seed=4, return_draws=True)
    assert a["draws"] == b["draws"] != c["draws"]
    # the .pth import maps onto refmlp only (tests/test_torch_compat.py)
    with pytest.raises(ValueError, match="'refmlp'"):
        serve.PosteriorService.from_torch("w.pth", port.cfg, None, None)
    # a mesh is ported (tests/test_torch_dp_sample.py); a non-mesh raises
    with pytest.raises(TypeError, match="make_mesh"):
        serve.PosteriorService("ck", port.cfg, mesh=object())


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    payload = body if isinstance(body, (bytes, type(None))) else \
        json.dumps(body).encode()
    conn.request(method, path, body=payload,
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    out = r.status, json.loads(r.read())
    conn.close()
    return out


def test_http_matches_jax(served):
    port, ref, ert = served
    servers = [serve.make_server(port, port=0),
               jserve.make_server(ref, port=0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    good = {"conditions": ert[:2].tolist(), "n_realizations": 4, "seed": 2}
    calls = [
        ("GET", "/healthz", None), ("GET", "/nope", None),
        ("POST", "/posterior", good),
        ("POST", "/posterior", {**good, "return_draws": True,
                                "temperature": 1.3}),
        ("POST", "/posterior", {**good, "sampler": "dpmpp",
                                "dpmpp_steps": 2}),
        ("POST", "/posterior", {"nope": 1}),
        ("POST", "/posterior", {**good, "conditions": ert[:5].tolist()}),
        ("POST", "/posterior", {**good, "conditions": ert[0].tolist()}),
        ("POST", "/posterior", {**good, "temperature": [1.0, 2.0]}),
        ("POST", "/posterior", {**good, "sampler": "bogus"}),
        ("POST", "/posterior", {**good, "guidance_scale": 2.0}),
        ("POST", "/posterior", b"{not json"),
        ("POST", "/other", good),
    ]
    try:
        for method, path, body in calls:
            (sg, og), (sw, ow) = (_http(s.server_port, method, path, body)
                                  for s in servers)
            assert sg == sw, (path, body if isinstance(body, bytes) else
                              sorted(body or {}), og, ow)
            assert set(og) == set(ow)
            assert sg != 500
        assert _http(servers[0].server_port, "GET", "/healthz")[1][
            "status"] == "ok"
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
