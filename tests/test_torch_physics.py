"""The port's physics.py against the JAX package's, on the same inputs.

The input-file writer byte for byte in both modes, the runner's data from
the same stand-in PFLOTRAN (tests/test_physics.py's, run without mpirun)
exactly, its retry, timeout and Gaussian-ensemble paths, the
SimulationManager's files (timestamps aside), run_posterior_validation,
and `simulate` -> `gather-data` through both CLIs on the same argv.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from ertdx import cli as jcli
from ertdx import physics as jphysics
from ertdx.data import SrvFormat as JaxSrvFormat
from ertdx.doe import ParameterSampler as JaxParameterSampler
from ertdx_torch import cli, physics
from ertdx_torch.data import SrvFormat
from ertdx_torch.doe import ParameterSampler, SurrogateDataGenerator
from ertdx_torch.utils import srv_native
from test_physics import MEAS, N_SURVEYS, make_fake_pflotran, make_template

FIXTURE = Path(__file__).parent / "fixtures" / "pflotran_template.in"
PACKAGES = {"jax": (jphysics, JaxSrvFormat), "port": (physics, SrvFormat)}


def _params(kind: str) -> np.ndarray:
    if kind == "linspace":
        return np.linspace(0.11, 0.95, 29)
    return SurrogateDataGenerator(seed=3).generate_training_samples(
        4, "lhs")[2]


def _keyword_template(tmp_path) -> Path:
    """tests/test_physics.py::test_keyword_splice's template."""
    tpl = tmp_path / "kw.in"
    block = ("MATERIAL\n  ARCHIE_CEMENTATION_EXPONENT 0\n"
             "  ARCHIE_SATURATION_EXPONENT 0\n"
             "  ARCHIE_TORTUOSITY_CONSTANT 0\n  POROSITY 0\n"
             "  SURFACE_ELECTRICAL_CONDUCTIVITY 0\n"
             "  PERM\n    PERM_X 0\n    PERM_Y 0\n    PERM_Z 0\n  END\n")
    vg = ("SAT_FUNC\n    ALPHA 0\n    M 0\n"
          "    LIQUID_RESIDUAL_SATURATION 0\n"
          "  RPF\n    M 0\n    LIQUID_RESIDUAL_SATURATION 0\nEND\n")
    tpl.write_text("HEAD\n        WATER_CONDUCTIVITY 0\n"
                   + block * 3 + vg * 2)
    return tpl


@pytest.mark.parametrize("values", ["linspace", "design"])
@pytest.mark.parametrize("template,mode", [
    ("fixture", "lines"), ("fixture", "keywords"), ("lines170", "lines"),
    ("lines170", "keywords"), ("blocks", "keywords")])
def test_input_file_byte_identical(tmp_path, template, mode, values):
    tpl = {"fixture": lambda: FIXTURE,
           "lines170": lambda: make_template(tmp_path),
           "blocks": lambda: _keyword_template(tmp_path)}[template]()
    p = _params(values)
    files = {}
    for name, (mod, _) in PACKAGES.items():
        sim = mod.PflotranSimulator(str(tpl), "case", mode=mode,
                                    output_dir=str(tmp_path / name))
        files[name] = sim.create_input_file(p, 7)
        # the reference-compatible alias writes the same file
        assert sim._create_input_file(p, 8) == str(tmp_path / name
                                                   / "case_0008.in")
    assert files["port"].name == files["jax"].name == "case_0007.in"
    assert files["port"].read_bytes() == files["jax"].read_bytes()
    if template != "lines170" or mode == "lines":
        assert files["port"].read_bytes() != Path(tpl).read_bytes()


def _runner(mod, fmt_cls, tmp_path, mode="ok", **cfg_kw):
    """tests/test_physics.py::make_runner for either package."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    tpl = make_template(tmp_path)
    stub = make_fake_pflotran(tmp_path, mode)
    sim = mod.PflotranSimulator(str(tpl), "run", output_dir=str(tmp_path))
    kw = dict(pflotran_path=str(stub), use_mpi=False, max_concurrent=3,
              timeout_s=30.0, n_surveys=N_SURVEYS,
              measurements_per_survey=MEAS,
              srv_format=fmt_cls(skip_header=2, usecols=5,
                                 time_token_index=2))
    kw.update(cfg_kw)
    return mod.ForwardModelRunner(sim, cfg=mod.RunnerConfig(**kw),
                                  workdir=str(tmp_path))


def _both(tmp_path, mode="ok", **cfg_kw):
    return {name: _runner(mod, fmt, tmp_path / name, mode, **cfg_kw)
            for name, (mod, fmt) in PACKAGES.items()}


def test_run_one_and_batch_data_identical(tmp_path):
    runners = _both(tmp_path)
    p = np.linspace(0.01, 0.29, 29)
    before = dict(srv_native.reads)
    one = {k: r.run_one(p, 2) for k, r in runners.items()}
    assert one["port"].dtype == one["jax"].dtype == np.float64
    np.testing.assert_array_equal(one["port"], one["jax"])
    np.testing.assert_array_equal(one["port"][:MEAS],
                                  2000 + np.arange(MEAS))
    params = np.tile(p, (5, 1))
    out = {k: r.run_simulations_with_params(params, progress=lambda s: None)
           for k, r in runners.items()}
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
    assert out["port"][1].shape == (5, N_SURVEYS * MEAS)
    # every file of the 6 runs went through the C++ reader
    assert srv_native.reads["native"] - before["native"] == 6 * N_SURVEYS
    assert srv_native.reads["numpy"] == before["numpy"]


def test_retry_recovers_flaky(tmp_path):
    runners = _both(tmp_path, mode="flaky", max_retries=3)
    params = np.tile(np.linspace(0.01, 0.29, 29), (3, 1))
    logs = {k: [] for k in runners}
    out = {k: r.run_simulations_with_params(params, progress=logs[k].append)
           for k, r in runners.items()}
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
    assert (out["port"][1][:, 0] == [0, 1000, 2000]).all()
    # the pool finishes in any order: compare the progress lines as sets
    assert sorted(logs["port"]) == sorted(logs["jax"])


def test_bounded_retries_raise_as_jax(tmp_path):
    runners = _both(tmp_path, mode="fail", max_retries=1)
    params = np.tile(np.linspace(0.01, 0.29, 29), (2, 1))
    msgs = {}
    for k, r in runners.items():
        with pytest.raises(RuntimeError) as e:
            r.run_simulations_with_params(params, progress=lambda s: None)
        msgs[k] = str(e.value)
    assert msgs["port"] == msgs["jax"]


def test_timeout_raises_timeout_exception(tmp_path):
    runners = _both(tmp_path, mode="sleep", timeout_s=0.3)
    msgs = {}
    for k, r in runners.items():
        exc = {"jax": jphysics, "port": physics}[k].TimeoutException
        with pytest.raises(exc) as e:
            r.run_one(np.linspace(0.01, 0.29, 29), 0)
        msgs[k] = str(e.value)
    assert msgs["port"] == msgs["jax"]


def test_run_simulations_gaussian(tmp_path):
    runners = _both(tmp_path)
    samplers = {"jax": JaxParameterSampler(rng=np.random.default_rng(5)),
                "port": ParameterSampler(rng=np.random.default_rng(5))}
    out = {}
    for k, r in runners.items():
        r.parameter_sampler = samplers[k]
        pmean = samplers[k].get_mean_parameters()
        out[k] = r.run_simulations(pmean, 0.05 * pmean, 3,
                                   progress=lambda s: None)
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
    assert out["port"][0].shape == (3, 29)
    with pytest.raises(ValueError, match="parameter_sampler"):
        _runner(physics, SrvFormat, tmp_path / "none").run_simulations(
            np.ones(29), 0.1, 2)


def test_isolated_workdirs(tmp_path):
    runners = _both(tmp_path)
    for k, r in runners.items():
        d0 = r.run_one(np.linspace(0.01, 0.29, 29), 0)
        d1 = r.run_one(np.linspace(0.01, 0.29, 29), 1)
        assert d0[0] == 0 and d1[0] == 1000
    names = {k: sorted(str(f.relative_to(tmp_path / k))
                       for f in (tmp_path / k).rglob("*")
                       if "run_" in str(f))
             for k in runners}
    assert names["port"] == names["jax"]
    assert "run_0000" in names["port"] and "run_0001" in names["port"]


def _results(base: Path) -> dict:
    """Every file under `base`: .npy as bytes, JSON without timestamps."""
    out = {}
    for f in sorted(base.rglob("*")):
        if f.is_dir():
            continue
        key = str(f.relative_to(base))
        if f.suffix == ".json":
            doc = json.loads(f.read_text())
            for rec in doc if isinstance(doc, list) else [doc]:
                assert len(rec.pop("timestamp")) == len("20260101_000000")
            out[key] = doc
        else:
            out[key] = f.read_bytes()
    return out


def test_simulation_manager_files(tmp_path):
    for name, (mod, _) in PACKAGES.items():
        mgr = mod.SimulationManager(base_dir=str(tmp_path / name))
        mgr.save_simulation_result(3, np.arange(29.0), np.ones((4, 3)))
        mgr.save_simulation_result(5, np.linspace(0, 1, 29).astype(np.float32),
                                   np.arange(12.0))
        mgr.save_failed_simulation(4, np.arange(29.0), "Timeout")
        mgr.save_failed_simulation(6, np.ones(29), "pflotran exited 1")
        assert mgr.max_simulation_time == 3600
    got, want = _results(tmp_path / "port"), _results(tmp_path / "jax")
    assert got == want
    assert set(got) == {"simulation_0003/parameters.npy",
                        "simulation_0003/data.npy",
                        "simulation_0003/metadata.json",
                        "simulation_0005/parameters.npy",
                        "simulation_0005/data.npy",
                        "simulation_0005/metadata.json",
                        "failed_simulations.json"}


def test_run_posterior_validation(tmp_path):
    params = SurrogateDataGenerator(seed=1).generate_training_samples(
        4, "lhs")
    completed = {}
    for mode in ("ok", "flaky"):
        for name, (mod, fmt) in PACKAGES.items():
            runner = _runner(mod, fmt, tmp_path / mode / name, mode)
            mgr = mod.SimulationManager(
                base_dir=str(tmp_path / mode / name / "val"))
            completed[mode, name] = mod.run_posterior_validation(
                runner, mgr, params, progress=lambda s: None)
        assert completed[mode, "port"] == completed[mode, "jax"]
        assert _results(tmp_path / mode / "port" / "val") == \
            _results(tmp_path / mode / "jax" / "val")
    assert completed["ok", "port"] == [0, 1, 2, 3]
    # flaky: each run fails once, is recorded and not retried
    assert completed["flaky", "port"] == []
    failures = json.loads((tmp_path / "flaky" / "port" / "val"
                           / "failed_simulations.json").read_text())
    assert [f["simulation_index"] for f in failures] == [0, 1, 2, 3]


def test_simulate_gather_matches_jax_cli(tmp_path, capsys):
    """tests/test_cli.py::test_simulate_gather_pipeline's argv through both
    CLIs: the same results folders and the same gathered arrays."""
    design = SurrogateDataGenerator(seed=0).generate_training_samples(
        4, "lhs")[..., None]
    np.save(tmp_path / "design.npy", design)
    tpl = make_template(tmp_path)
    stub = make_fake_pflotran(tmp_path)
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        root = tmp_path / name
        assert main(["simulate", "--template", str(tpl),
                     "--params", str(tmp_path / "design.npy"),
                     "--pflotran", str(stub), "--no-mpi",
                     "--results-dir", str(root / "results"),
                     "--workdir", str(root / "runs"),
                     "--surveys", "3", "--measurements", "4",
                     "--srv-skip-header", "2", "--max-retries", "2"]) == 0
        assert main(["gather-data", "--results-dir", str(root / "results"),
                     "--n", "4", "--surveys", "3",
                     "--out-ert", str(root / "ert.npy"),
                     "--out-params", str(root / "p.npy")]) == 0
    printed = capsys.readouterr().out
    assert ".srv files read: 12 by the C++ reader, 0 by numpy" in printed
    assert _results(tmp_path / "port" / "results") == \
        _results(tmp_path / "jax" / "results")
    for f in ("ert.npy", "p.npy"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    ert = np.load(tmp_path / "port" / "ert.npy")
    assert ert.shape == (4, MEAS, N_SURVEYS) and ert[3, 0, 2] == 3200.0
    runs = {k: sorted(p.read_bytes() for p in
                      (tmp_path / k / "runs").rglob("*.in"))
            for k in ("jax", "port")}
    assert runs["port"] == runs["jax"] and len(runs["port"]) == 4
