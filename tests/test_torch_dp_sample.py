"""The port's data-parallel sampling, distillation, calibration, service
and CLI on a 2-rank gloo world.

* `posterior_ensemble(mesh=)` against JAX's `posterior_ensemble(mesh=
  make_mesh(data=8))` with JAX's draws injected, at JAX's sampler
  tolerance (rtol 1e-4, atol 1e-5): the CondUNet with B divisible (4)
  and not divisible (3) by the data axis, refmlp realization-major
  (ancestral), and a guided model on an interval, tempered;
* the same with the draws from a generator, against one process at
  1e-6; and the batch gates read the global batch: with
  `ensemble_min_chains` and `flash_min_logits` set to the global batch's
  size, the mesh takes the ensemble and flash routes as often as one
  process does;
* `posterior_over_dataset(mesh=)` against JAX's (per-batch draws);
* `mega_denoise_ensemble_sharded` against JAX's `denoise_ensemble` (JAX's
  own test of its sharded kernel is slow-marked), at JAX's 2e-5, the
  fused core with accurate=True (JAX's bf16_3x, within 2e-5 of the
  float32 module path at these widths);
* `distill(mesh=)`, `calibrate_temperature` / `calibrate_guidance(mesh=)`
  and `PosteriorService(mesh=)` against one process at 1e-6;
* the CLI's `train` and `sample` under `python -m torch.distributed.run
  --nproc-per-node 2 ... --device cpu --mesh-data 2` against the
  single-process CLI.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ertdx import diffusion as jdiff
from ertdx import sample as jsample
from ertdx import transforms as jtransforms
from ertdx.configs import SampleConfig as JaxSampleConfig
from ertdx.parallel.mesh import make_mesh
from ertdx_torch import configs, train, transforms
from torch_mesh_common import World, out, save
from torch_mesh_jobs import _dataset
from torch_mlp_common import jax_draws, refmlp_pair
from torch_parity_common import make_pair

ROOT = Path(__file__).resolve().parent.parent
R = 4
GATE_B = 4


def _case(kind, args, params, cond, scfg, t_total, key=None, sampler=None,
          steps=None):
    case = {"kind": kind, "args": args, "tree": params, "cond": cond,
            "scfg": scfg, "T": t_total, "R": R, "draws": None}
    if key is not None:
        d = jax_draws(key, sampler, (R * cond.shape[0], 29), steps)
        case["draws"] = {k: v.numpy() for k, v in d.items()}
        if scfg.get("ddim_eta", 1.0) == 0.0 and sampler == "ddim":
            del case["draws"]["noise"]
    return case


def _jax_posterior(fm, params, case, key):
    scfg = JaxSampleConfig(uncertainty_samples=R, **case["scfg"])
    return np.asarray(jsample.posterior_ensemble(
        fm, params, jnp.asarray(case["cond"]),
        jdiff.get_diffusion_schedule(case["T"]), key, n_realizations=R,
        scfg=scfg, mesh=make_mesh(data=8)))


def _posterior_cases():
    """The cases, and the JAX references to compute (name -> thunk)."""
    rng = np.random.default_rng(5)
    cases, want = {}, {}
    ddim = {"sampler": "ddim", "ddim_steps": 5, "ddim_eta": 0.5,
            "temperature": 0.8}
    args = {"num_blocks": 2, "seed": 21}
    fm, params, _ = make_pair(**args)
    for b in (4, 3):
        cond = rng.normal(size=(b, 96, 4)).astype(np.float32)
        key = jax.random.key(b)
        case = _case("condunet", args, params, cond, ddim, 20, key, "ddim",
                     5)
        cases[f"condunet_b{b}"] = case
        want[f"condunet_b{b}"] = (fm, params, case, key)
    fr, rparams, _ = refmlp_pair(h=32, c=4)
    cond = rng.normal(size=(3, 96, 4)).astype(np.float32)
    key = jax.random.key(7)
    case = _case("refmlp", {"param_dim": 29, "hidden_dim": 32,
                            "cond_channels": 4}, rparams, cond,
                 {"sampler": "ancestral"}, 10, key, "ancestral", 10)
    cases["refmlp"] = case
    want["refmlp"] = (fr, rparams, case, key)
    gargs = {"uncond_prob": 0.2, "seed": 7}
    fg, gparams, _ = make_pair(**gargs)
    guided = {"sampler": "ddim", "ddim_steps": 5, "ddim_eta": 1.0,
              "temperature": 1.2, "guidance_scale": 2.0,
              "guidance_interval": (0.3, 0.8)}
    cond = rng.normal(size=(4, 96, 4)).astype(np.float32)
    key = jax.random.key(9)
    case = _case("condunet", gargs, gparams, cond, guided, 20, key, "ddim",
                 5)
    cases["guided"] = case
    want["guided"] = (fg, gparams, case, key)
    _, params3, _ = make_pair(seed=3)
    cases["random"] = _case("condunet", {"seed": 3}, params3,
                            rng.normal(size=(4, 96, 4)).astype(np.float32),
                            {"sampler": "ancestral"}, 10)
    # the gates at the global batch: 16 chains, 4 x 2 heads x 128^2 logits
    gate = {"ensemble_pallas": True, "ensemble_min_chains": GATE_B * R,
            "flash_min_logits": GATE_B * 2 * 128 * 128, "seed": 4}
    _, gparams4, _ = make_pair(**gate)
    cases["gates"] = _case(
        "condunet", gate, gparams4,
        rng.normal(size=(GATE_B, 96, 4)).astype(np.float32),
        {"sampler": "ddim", "ddim_steps": 3}, 10)
    return cases, want


def _over_dataset_inputs():
    fm, params, _ = make_pair(seed=13)
    rng = np.random.default_rng(8)
    conds = rng.normal(size=(6, 96, 4)).astype(np.float32)
    data = rng.uniform(-2, 3, size=(40, 29))
    scfg = {"sampler": "ddim", "ddim_steps": 5, "ddim_eta": 0.0}
    key = jax.random.key(11)
    draws = [np.asarray(jax.random.normal(
        jax.random.split(jax.random.fold_in(key, bi))[1], (3 * 4, 29)))
        for bi in range(2)]

    def want():
        return tuple(np.asarray(w) for w in jsample.posterior_over_dataset(
            fm, params, conds, jdiff.get_diffusion_schedule(20), key,
            jtransforms.MinMaxScaler.fit(data), n_realizations=3,
            batch_size=4,
            scfg=JaxSampleConfig(uncertainty_samples=3, **scfg),
            mesh=make_mesh(data=8)))

    return ({"args": {"seed": 13}, "tree": params, "conds": conds,
             "scaler_data": data, "scfg": scfg, "T": 20, "R": 3,
             "batch_size": 4, "draws": draws}, want)


def _mega_inputs():
    fm, params, _ = make_pair(seed=3)
    rng = np.random.default_rng(3)
    b, r = 4, 16
    cond = rng.normal(size=(b, 96, 4)).astype(np.float32)
    x = rng.normal(size=(b * r, 29)).astype(np.float32)
    t = np.full((b * r,), 5, np.int32)

    @jax.jit
    def denoise(params, cond, x, t):
        ctx = fm.apply({"params": params}, cond, method=fm.encode_condition)
        return fm.apply({"params": params}, x, t, ctx, r,
                        method=fm.denoise_ensemble)

    return ({"args": {"seed": 3}, "tree": params, "cond": cond, "x": x,
             "t": t.astype(np.int64), "R": r,
             "plan": dict(p=29, d=32, num_blocks=2, chunk=r,
                          accurate=True, stack=True)},
            lambda: np.asarray(denoise(params, jnp.asarray(cond),
                                       jnp.asarray(x), jnp.asarray(t))))


TEACHER_CFG = {"diffusion": {"T": 16},
               "model": {"name": "condunet", "hidden_dim": 32,
                         "cond_length": 96, "cond_channels": 4,
                         "base_width": 16, "depth": 2, "num_heads": 2,
                         "num_blocks": 2, "uncond_prob": 0.2},
               "train": {"num_epochs": 1, "batch_size": 8}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_sample")
    cases, want = _posterior_cases()
    save(tmp, "dp_posterior", cases)
    over, over_want = _over_dataset_inputs()
    save(tmp, "dp_over_dataset", over)
    mega, mega_want = _mega_inputs()
    save(tmp, "dp_mega", mega)
    # a CFG teacher for distill, calibrate and the service
    ds = _dataset(40)
    teacher = str(tmp / "teacher")
    train.train(configs.experiment_from_dict(TEACHER_CFG), ds,
                checkpoint_dir=teacher, device="cpu")
    save(tmp, "dp_distill", {"teacher": teacher, "n": 40,
                             "out": str(tmp / "student"),
                             "dcfg": dict(target_steps=2, start_steps=4,
                                          epochs_per_stage=1,
                                          convert_epochs=1, batch_size=8)})
    true = ds.param_scaler.inverse(transforms.inverse_transform(
        ds.params_u[:6].astype(np.float64), ds.a, ds.b))
    save(tmp, "dp_calibrate", {
        "teacher": teacher, "cfg": TEACHER_CFG,
        "conds": ds.conditions[:6], "true": np.asarray(true),
        "scfg": {"sampler": "ddim", "ddim_steps": 3, "ddim_eta": 0.5},
        "ert": np.random.default_rng(4).normal(
            50.0, 10.0, size=(3, 96, 4)).astype(np.float32)})
    with World(2, ["dp_posterior", "dp_over_dataset", "dp_mega",
                   "dp_distill", "dp_calibrate"], tmp) as w:
        want = {k: _jax_posterior(*v) for k, v in want.items()}
        over_want, mega_want = over_want(), mega_want()
        w.wait()
    return tmp, want, over_want, mega_want


@pytest.mark.parametrize("name", ["condunet_b4", "condunet_b3", "refmlp",
                                  "guided"])
def test_posterior_on_mesh_matches_jax(world, name):
    tmp, want, _, _ = world
    for rank in range(2):
        got = out(tmp, "dp_posterior", rank)[name]
        np.testing.assert_allclose(got["mesh"][0], want[name], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["single"][0], want[name], rtol=1e-4,
                                   atol=1e-5)


def test_posterior_on_mesh_draws_the_single_process_numbers(world):
    tmp = world[0]
    ranks = [out(tmp, "dp_posterior", r)["random"] for r in range(2)]
    for got in ranks:
        np.testing.assert_allclose(got["mesh"][0], got["single"][0],
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ranks[0]["mesh"][0], ranks[1]["mesh"][0])


def test_batch_gates_read_the_global_batch(world):
    tmp = world[0]
    for rank in range(2):
        got = out(tmp, "dp_posterior", rank)["gates"]
        (u, calls), (u1, calls1) = got["mesh"], got["single"]
        assert calls1["ensemble"] > 0 and calls1["flash"] > 0
        assert calls == calls1
        np.testing.assert_allclose(u, u1, rtol=1e-6, atol=1e-6)


def test_posterior_over_dataset_on_mesh_matches_jax(world):
    tmp, _, (pred, valid), _ = world
    for rank in range(2):
        got_pred, got_valid = out(tmp, "dp_over_dataset", rank)
        np.testing.assert_allclose(got_pred, pred, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got_valid, valid)


def test_sharded_mega_denoise_matches_jax(world):
    tmp, _, _, want = world
    for rank in range(2):
        np.testing.assert_allclose(out(tmp, "dp_mega", rank), want,
                                   rtol=2e-5, atol=2e-5)


def test_distill_on_mesh_equals_the_single_process(world):
    tmp = world[0]
    for rank in range(2):
        got = out(tmp, "dp_distill", rank)
        assert [k for k, _, _ in got["mesh"]] == ["convert", "halve"]
        for (_, loss, vloss), (_, loss1, vloss1) in zip(got["mesh"],
                                                        got["single"]):
            np.testing.assert_allclose(loss, loss1, rtol=1e-6)
            np.testing.assert_allclose(vloss, vloss1, rtol=1e-6)
        for name, p in got["params_single"].items():
            np.testing.assert_allclose(got["params_mesh"][name], p,
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    assert (tmp / "student" / "best" / "state.msgpack").exists()


def _close_records(a, b):
    assert a.keys() == b.keys()
    for key in a:
        for metric in ("accuracy", "precision", "goodness",
                       "valid_fraction", "ensemble_sd_mean"):
            np.testing.assert_allclose(a[key][metric], b[key][metric],
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=(key, metric))


def test_calibration_and_service_on_mesh_equal_the_single_process(world):
    tmp = world[0]
    for rank in range(2):
        got = out(tmp, "dp_calibrate", rank)
        mesh, single = got["mesh"], got["single"]
        assert mesh["temperature"][0] == single["temperature"][0]
        _close_records(mesh["temperature"][1], single["temperature"][1])
        assert mesh["guidance"][0] == single["guidance"][0]
        _close_records(mesh["guidance"][1], single["guidance"][1])
        for key in ("mean", "std", "draws"):
            np.testing.assert_allclose(mesh["serve"][key],
                                       single["serve"][key], rtol=1e-6,
                                       atol=1e-6, err_msg=key)
        assert mesh["serve"]["valid"] == single["serve"]["valid"]


def _torchrun(argv, cwd):
    """The port's CLI on 2 ranks under torch.distributed.run, on the CPU."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "ertdx_torch.cli", *argv,
         "--device", "cpu", "--mesh-data", "2"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _log(path):
    recs = [json.loads(line) for line in Path(path).read_text().splitlines()]
    return [(r["train_loss"], r["val_loss"]) for r in recs
            if "train_loss" in r]


def test_cli_on_a_mesh_matches_the_single_process_cli(tmp_path):
    from ertdx_torch import cli
    from ertdx_torch.doe import SurrogateDataGenerator
    np.save(tmp_path / "p.npy", SurrogateDataGenerator(seed=0)
            .generate_training_samples(40, "lhs")[..., None])
    np.save(tmp_path / "e.npy", np.random.default_rng(0).normal(
        50.0, 10.0, size=(40, 64, 14)))
    data = ["--params", str(tmp_path / "p.npy"), "--ert",
            str(tmp_path / "e.npy")]
    fit = [*data, "--epochs", "2", "--batch-size", "8"]
    cli.main(["train", *fit, "--checkpoint-dir", str(tmp_path / "ck1"),
              "--log-file", str(tmp_path / "l1.jsonl"), "--device", "cpu"])
    printed = _torchrun(["train", *fit, "--checkpoint-dir", "ck2",
                         "--log-file", "l2.jsonl"], tmp_path)
    assert printed.count("best val loss") == 1      # rank 0 alone prints
    np.testing.assert_allclose(_log(tmp_path / "l2.jsonl"),
                               _log(tmp_path / "l1.jsonl"), rtol=1e-5)
    draw = [*data, "--checkpoint-dir", str(tmp_path / "ck1"),
            "--realizations", "4", "--seed", "3"]
    cli.main(["sample", *draw, "--out", str(tmp_path / "u1.npy"),
              "--device", "cpu"])
    _torchrun(["sample", *draw, "--out", "u2.npy"], tmp_path)
    np.testing.assert_allclose(np.load(tmp_path / "u2.npy"),
                               np.load(tmp_path / "u1.npy"), rtol=1e-6,
                               atol=1e-6)
