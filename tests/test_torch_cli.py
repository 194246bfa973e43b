"""The port's CLI against the JAX package's.

Parser parity (the same argv gives the same namespace, less `fn` and the
port's `--device`), byte-equal outputs of `generate-design`,
`gather-data` and `metrics`, one `train -> calibrate --commit -> sample
-> serve` run on --device cpu whose checkpoint the JAX package restores,
and the refusals, each naming its ROADMAP.md queue item. `simulate`,
`plot` and the figure flags are held against JAX's CLI in
tests/test_torch_physics.py and tests/test_torch_plots.py."""
from __future__ import annotations

import dataclasses
import http.client
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ertdx import cli as jcli
from ertdx import configs as jconfigs
from ertdx import train as jtrain
from ertdx_torch import cli, configs, sample, train
from ertdx_torch.diffusion import schedule_from_config
from ertdx_torch.doe import SurrogateDataGenerator
from ertdx_torch.utils.weights import params_to_jax

REPO = Path(__file__).resolve().parent.parent

ARGVS = [
    ["generate-design"],
    ["generate-design", "--n", "64", "--method", "lhs", "--seed", "3",
     "--out", "d.npy", "--diagnostics"],
    ["gather-data", "--results-dir", "r", "--n", "7", "--surveys", "3",
     "--out-ert", "e.npy", "--out-params", "p.npy"],
    ["train", "--params", "p", "--ert", "e"],
    ["train", "--params", "p", "--ert", "e", "--preset", "v5e8_dp",
     "--model", "condunet", "--dtype", "float32", "--lr-schedule",
     "cosine", "--warmup-steps", "5", "--loss-weighting", "min_snr",
     "--snr-gamma", "4", "--beta-schedule", "cosine", "--uncond-prob",
     "0.1", "--epochs", "3", "--batch-size", "8", "--seed", "1",
     "--split-seed", "2", "--checkpoint-dir", "ck", "--mesh-data", "2",
     "--log-file", "l", "--plot", "--resume", "--save-every", "1",
     "--ema-decay", "0.99", "--profile", "prof"],
    ["sample", "--params", "p", "--ert", "e"],
    ["sample", "--params", "p", "--ert", "e", "--checkpoint-dir", "ck",
     "--torch-checkpoint", "w.pth", "--preset", "ddim_ensemble", "--model",
     "condunet", "--realizations", "9", "--seed", "4", "--mesh-data", "1",
     "--ema", "--sampler", "dpmpp", "--steps", "6", "--eta", "0.3",
     "--temperature", "1.5,2", "--guidance", "1.5", "--guidance-interval",
     "0.1,0.9", "--uncond-prob", "0.2", "--out", "u.npy"],
    ["calibrate", "--params", "p", "--ert", "e", "--checkpoint-dir", "ck"],
    ["calibrate", "--params", "p", "--ert", "e", "--checkpoint-dir", "ck",
     "--preset", "v5e8_dp", "--model", "condunet", "--temps", "1,2",
     "--objective", "accuracy", "--per-parameter", "--pp-target", "0.9",
     "--pp-tol", "0.01", "--sampler", "ddim", "--steps", "5", "--eta",
     "0.1", "--guidance", "1.2", "--guidance-interval", "0,0.5",
     "--guidance-grid", "1,2", "--ema", "--realizations", "7",
     "--uncond-prob", "0.1", "--seed", "3", "--out", "c.json",
     "--commit"],
    ["distill", "--params", "p", "--ert", "e", "--checkpoint-dir", "ck",
     "--out-dir", "o"],
    ["distill", "--params", "p", "--ert", "e", "--checkpoint-dir", "ck",
     "--out-dir", "o", "--preset", "v5e8_dp", "--model", "condunet",
     "--target-steps", "2", "--start-steps", "8", "--epochs-per-stage",
     "3", "--convert-epochs", "0", "--lr", "0.001", "--constant-lr",
     "--batch-size", "4", "--seed", "1", "--ema", "--guidance", "2",
     "--mesh-data", "2", "--log-file", "l"],
    ["metrics", "--pred", "u", "--true", "t"],
    ["metrics", "--pred", "u", "--true", "t", "--out", "m.csv",
     "--plots-dir", "figs"],
    ["serve"],
    ["serve", "--checkpoint-dir", "ck", "--torch-checkpoint", "w",
     "--params", "p", "--ert", "e", "--preset", "v5e8_dp", "--model",
     "condunet", "--cond-length", "96", "--cond-channels", "4", "--host",
     "0.0.0.0", "--port", "0", "--max-batch", "2", "--realizations", "5",
     "--warmup"],
    ["simulate", "--template", "t", "--params", "p", "--no-mpi"],
    ["plot", "--sim", "s", "--conditional", "c"],
    ["generate-synthetic", "--n", "4"],
    ["bench"],
    ["simulate", "--params", "p", "--template", "t", "--prefix", "run",
     "--pflotran", "pf", "--workdir", "w", "--results-dir", "r", "--mode",
     "keywords", "--timeout", "5", "--concurrency", "2", "--max-retries",
     "1", "--surveys", "3", "--measurements", "4", "--srv-skip-header",
     "2", "--srv-usecols", "4"],
    ["plot", "--conditional", "c", "--sim", "s", "--out-dir", "figs"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: "_".join(a[:2]))
def test_parser_matches_jax(argv):
    def ns(parser, extra=()):
        d = vars(parser.parse_args(argv + list(extra)))
        d.pop("fn")
        d.pop("device", None)
        return d
    assert ns(cli.build_parser()) == ns(jcli.build_parser())
    if "device" in vars(cli.build_parser().parse_args(argv)):
        assert cli.build_parser().parse_args(argv).device == "cuda"
        assert cli.build_parser().parse_args(
            argv + ["--device", "cpu"]).device == "cpu"


def test_help_lists_the_subcommands():
    r = subprocess.run([sys.executable, "-m", "ertdx_torch.cli", "--help"],
                       capture_output=True, text=True, cwd=REPO,
                       env={**os.environ, "PYTHONPATH": str(REPO)},
                       timeout=120)
    assert r.returncode == 0
    for cmd in ("generate-design", "gather-data", "train", "sample",
                "calibrate", "distill", "metrics", "serve"):
        assert cmd in r.stdout


@pytest.mark.parametrize("method,n", [("sobol", 40), ("lhs", 32)])
def test_generate_design_writes_what_jax_writes(tmp_path, capsys, method,
                                                n):
    outs = [tmp_path / "jax.npy", tmp_path / "port.npy"]
    argv = ["generate-design", "--n", str(n), "--method", method, "--seed",
            "0"]
    assert jcli.main(argv + ["--out", str(outs[0])]) == 0
    assert cli.main(argv + ["--out", str(outs[1])]) == 0
    assert outs[0].read_bytes() == outs[1].read_bytes()
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].replace("jax.npy", "port.npy") == printed[1]


def test_gather_data_writes_what_jax_writes(tmp_path, capsys):
    rng = np.random.default_rng(1)
    res = tmp_path / "results"
    for i in range(6):
        if i == 4:
            continue                                   # missing
        d = res / f"simulation_{i:04d}"
        d.mkdir(parents=True)
        m = 5 if i != 2 else 4                        # one wrong shape
        np.save(d / "data.npy", rng.normal(size=(3 * m, 1)))
        np.save(d / "parameters.npy", rng.uniform(size=(29, 1)))
    outs = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        e, p = tmp_path / f"{name}_ert.npy", tmp_path / f"{name}_p.npy"
        assert main(["gather-data", "--results-dir", str(res), "--n", "6",
                     "--surveys", "3", "--out-ert", str(e), "--out-params",
                     str(p)]) == 0
        outs[name] = (e.read_bytes(), p.read_bytes(),
                      capsys.readouterr().out.replace(f"{name}_", "X_"))
    assert outs["jax"] == outs["port"]
    assert "Discarded simulations: 1" in outs["port"][2]


def test_metrics_writes_what_jax_writes(tmp_path, capsys):
    rng = np.random.default_rng(2)
    np.save(tmp_path / "u.npy", rng.normal(size=(20, 9, 29)))
    np.save(tmp_path / "t.npy", rng.normal(size=(9, 29)))
    outs = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        csv = tmp_path / f"{name}.csv"
        assert main(["metrics", "--pred", str(tmp_path / "u.npy"), "--true",
                     str(tmp_path / "t.npy"), "--out", str(csv)]) == 0
        outs[name] = (csv.read_bytes(),
                      capsys.readouterr().out.replace(f"{name}.csv", "X"))
    assert outs["jax"] == outs["port"]
    assert set(json.loads(outs["port"][1].rsplit("wrote", 1)[0])) == {
        "accuracy", "precision", "goodness", "crps_mean_normalized",
        "sbc_ks_mean"}


TINY = dataclasses.replace(
    configs.V5E8_DP, name="tiny_cli", diffusion=configs.DiffusionConfig(T=10),
    model=dataclasses.replace(configs.V5E8_DP.model, hidden_dim=32,
                              cond_length=64, cond_channels=4,
                              base_width=16, depth=2, num_heads=2,
                              num_blocks=2),
    train=dataclasses.replace(configs.V5E8_DP.train, num_epochs=2,
                              batch_size=8),
    sample=configs.SampleConfig(uncertainty_samples=4, sampler="ddim",
                                ddim_steps=3, ddim_eta=0.5))


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """train -> calibrate --commit -> sample on the CPU through the CLI."""
    tmp = tmp_path_factory.mktemp("cli")
    params = SurrogateDataGenerator(seed=0).generate_training_samples(
        40, "lhs")[..., None]
    np.save(tmp / "p.npy", params)
    np.save(tmp / "e.npy", np.random.default_rng(0).normal(
        50, 10, (40, 64, 4)))
    ck = tmp / "ck"
    common = ["--params", str(tmp / "p.npy"), "--ert", str(tmp / "e.npy"),
              "--preset", "tiny_cli", "--device", "cpu"]
    configs.PRESETS["tiny_cli"] = TINY
    try:
        assert cli.main(["train", *common, "--checkpoint-dir", str(ck),
                         "--log-file", str(tmp / "log.jsonl")]) == 0
        assert cli.main(["calibrate", *common, "--checkpoint-dir", str(ck),
                         "--temps", "1.0,1.5", "--realizations", "4",
                         "--out", str(tmp / "cal.json"), "--commit"]) == 0
        assert cli.main(["sample", *common, "--checkpoint-dir", str(ck),
                         "--realizations", "4", "--seed", "5",
                         "--out", str(tmp / "U.npy")]) == 0
    finally:
        configs.PRESETS.pop("tiny_cli")
    return tmp, ck


def test_pipeline_checkpoint_restores_in_jax(pipeline):
    tmp, ck = pipeline
    logged = [json.loads(line) for line in
              (tmp / "log.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in logged] == [1, 2]
    cal = json.loads((tmp / "cal.json").read_text())
    saved = train.saved_config(str(ck))
    assert saved == jtrain.saved_config(str(ck))
    assert saved["sample"]["temperature"] == cal["best_temperature"]
    assert saved["sample"]["sampler"] == "ddim"
    assert saved["model"]["dtype"] == "bfloat16"
    meta = json.loads((ck / "best" / "meta.json").read_text())
    assert meta["calibration"]["temps"] == [1.0, 1.5]
    jcfg = jconfigs.experiment_from_dict(saved)
    jstate, jmeta, jscalers = jtrain.load_best_model(str(ck), jcfg)
    state, _, _ = train.load_best_model(str(ck), TINY, device="cpu")
    mine = params_to_jax(state.model)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        else:
            yield prefix, np.asarray(tree)
    want = dict(leaves(jstate.params))
    got = dict(leaves(mine))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_sample_is_posterior_over_dataset(pipeline):
    """`sample` with no sampling flags runs the committed config: its
    draws equal posterior_over_dataset from the same seed."""
    tmp, ck = pipeline
    from ertdx_torch import data
    state, _, scalers = train.load_best_model(str(ck), TINY, device="cpu")
    cfg = configs.experiment_from_dict(train.saved_config(str(ck)), TINY)
    ds = data.prepare_dataset(np.load(tmp / "p.npy"), np.load(tmp / "e.npy"),
                              param_scaler=scalers["param_scaler"],
                              ert_scaler=scalers["ert_scaler"])
    _, _, test_idx = data.split_dataset(len(ds), cfg.train.seed,
                                        cfg.train.split)
    pred, mask = sample.posterior_over_dataset(
        state.model.eval(), ds.conditions[test_idx],
        schedule_from_config(cfg.diffusion), ds.param_scaler,
        n_realizations=4, batch_size=cfg.train.batch_size, scfg=cfg.sample,
        generator=torch.Generator().manual_seed(5), device="cpu")
    np.testing.assert_array_equal(np.load(tmp / "U.npy"), pred)
    np.testing.assert_array_equal(np.load(tmp / "valid_mask.npy"), mask)
    assert np.load(tmp / "true_params.npy").shape == pred.shape[1:]


def test_pipeline_serves_over_http(pipeline):
    """`python -m ertdx_torch.cli serve` on the checkpoint (the echo
    wins over --preset) answers /healthz and /posterior."""
    tmp, ck = pipeline
    proc = subprocess.Popen(
        [sys.executable, "-m", "ertdx_torch.cli", "serve", "--checkpoint-dir",
         str(ck), "--preset", "full_conditional", "--port", "0",
         "--max-batch", "2", "--device", "cpu", "--warmup",
         "--realizations", "3"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        while "http://" not in line:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, proc.stderr.read()
        port = int(line.split("http://")[1].split()[0].rsplit(":", 1)[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["status"] == "ok"
        ert = np.load(tmp / "e.npy")[:2].tolist()
        conn.request("POST", "/posterior", body=json.dumps(
            {"conditions": ert, "n_realizations": 3, "seed": 1}))
        r = conn.getresponse()
        out = json.loads(r.read())
        assert r.status == 200 and np.asarray(out["mean"]).shape == (2, 29)
        conn.request("POST", "/posterior", body=json.dumps(
            {"conditions": np.load(tmp / "e.npy")[:3].tolist()}))
        r = conn.getresponse()
        assert r.status == 400 and "max_batch" in json.loads(r.read())[
            "error"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# the ids are those the cases had when five more (simulate, plot and the
# figure flags, now ported: tests/test_torch_plots.py and
# tests/test_torch_physics.py) came first
@pytest.mark.parametrize("argv,item", [
    pytest.param(["sample", "--params", "p", "--ert", "e", "--preset",
                  "v5e8_dp", "--torch-checkpoint", "w.pth"],
                 "use --model refmlp", id="argv5-use --model refmlp"),
    pytest.param(["sample", "--params", "p", "--ert", "e",
                  "--torch-checkpoint", "w.pth", "--ema"],
                 "--ema has no meaning", id="argv6---ema has no meaning"),
    pytest.param(["serve", "--preset", "v5e8_dp", "--torch-checkpoint",
                  "w.pth"], "needs --params/--ert",
                 id="argv7-needs --params/--ert"),
    # --mesh-data is ported: in a world of one a larger mesh exits with
    # JAX's make_mesh message (the ids are the cases' old ones)
    pytest.param(["train", "--params", "p", "--ert", "e", "--preset",
                  "v5e8_dp", "--mesh-data", "8"],
                 "mesh 8x1 needs 8 devices, have 1", id="argv8-item 5"),
    pytest.param(["sample", "--params", "p", "--ert", "e", "--preset",
                  "v5e8_dp", "--checkpoint-dir", "ck", "--mesh-data", "2"],
                 "mesh 2x1 needs 2 devices, have 1", id="argv9-item 5"),
    pytest.param(["distill", "--params", "p", "--ert", "e",
                  "--checkpoint-dir", "ck", "--out-dir", "o", "--preset",
                  "v5e8_dp", "--mesh-data", "2"],
                 "mesh 2x1 needs 2 devices, have 1", id="argv10-item 5"),
    pytest.param(["bench"], "benchmark", id="argv11-benchmark"),
])
def test_refusals_name_their_queue_item(argv, item):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert item in str(e.value.code)


def test_jax_messages_kept(tmp_path):
    """The JAX parser's own SystemExit messages, word for word."""
    for argv in (["sample", "--params", "p", "--ert", "e", "--preset",
                  "v5e8_dp"],
                 ["serve", "--preset", "v5e8_dp"]):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert str(e.value.code) == \
            "one of --checkpoint-dir / --torch-checkpoint is required"
    with pytest.raises(KeyError):
        cli.main(["train", "--params", "p", "--ert", "e", "--preset",
                  "no_such_preset"])
