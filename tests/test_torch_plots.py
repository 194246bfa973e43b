"""The port's plots.py against the JAX package's, on the same inputs.

Each of the eleven figure functions runs through both packages on
tests/test_plots.py's seeded inputs; what each figure draws is compared:
every Axes' line data, images, histogram bars, scatter offsets, texts,
titles, labels and legends (equal, or within 1e-12 where numbers are
drawn), and each saved file exists and is over 1000 bytes. The figure
flags and `plot` go through both CLIs. In a subprocess with matplotlib
blocked, ertdx_torch.plots, .cli and .doe import, and a drawing call
raises naming matplotlib.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.colors as mcolors  # noqa: E402
import matplotlib.figure  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from ertdx import cli as jcli  # noqa: E402
from ertdx import metrics as jmetrics  # noqa: E402
from ertdx import plots as jplots  # noqa: E402
from ertdx_torch import cli, plots  # noqa: E402
from ertdx_torch import metrics as tmetrics  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _arr(a):
    return np.asarray(np.ma.filled(np.asarray(a, dtype=float), np.nan))


def _color(c):
    return tuple(mcolors.to_rgba(c))


def describe(fig) -> dict:
    """What a figure draws, Axes by Axes."""
    axes = []
    for ax in fig.axes:
        legend = ax.get_legend()
        axes.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(),
            "ylabel": ax.get_ylabel(), "scales": (ax.get_xscale(),
                                                  ax.get_yscale()),
            "lines": [(_arr(ln.get_xydata()), _color(ln.get_color()),
                       ln.get_linestyle(), ln.get_label(),
                       ln.get_linewidth())
                      for ln in ax.get_lines()],
            "images": [(_arr(im.get_array()), tuple(im.get_clim()),
                        im.get_cmap().name) for im in ax.get_images()],
            "bars": [(p.get_x(), p.get_y(), p.get_width(), p.get_height(),
                      _color(p.get_facecolor()))
                     for p in ax.patches
                     if isinstance(p, matplotlib.patches.Rectangle)],
            "polygons": [_arr(p.get_xy()) for p in ax.patches
                         if isinstance(p, matplotlib.patches.Polygon)],
            "collections": [_arr(c.get_offsets()) for c in ax.collections],
            "texts": [(t.get_text(), tuple(t.get_position()))
                      for t in ax.texts],
            "legend": [t.get_text() for t in legend.get_texts()]
            if legend else None,
            "xticks": [t.get_text() for t in ax.get_xticklabels()],
        })
    sup = fig._suptitle.get_text() if fig._suptitle else None
    return {"suptitle": sup, "size": tuple(fig.get_size_inches()),
            "dpi": fig.dpi, "axes": axes}


def assert_same(got, want, path="fig"):
    """Equal structure; numbers within 1e-12 (NaN where NaN)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                   err_msg=path)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=0, abs=1e-12), path
    else:
        assert got == want, path


@pytest.fixture
def saved(monkeypatch):
    """Every figure saved, in order, with its path."""
    figs = []
    orig = matplotlib.figure.Figure.savefig

    def record(self, fname, *a, **k):
        figs.append((self, Path(fname)))
        return orig(self, fname, *a, **k)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", record)
    return figs


def _inputs():
    """tests/test_plots.py's inputs, from its rng fixture's seed."""
    rng = np.random.default_rng(42)
    sim = rng.normal(5.0, 1.0, size=(12, 20, 4))
    cond = rng.normal(5.0, 1.0, size=(20, 4))
    constrained = rng.uniform(size=(50, 29))
    unconstrained = rng.normal(size=(50, 29))
    reals = rng.normal(0.5, 0.1, size=(30, 8, 29))
    true = rng.normal(0.5, 0.1, size=(8, 29))
    pred = rng.normal(0, 1, size=(100, 40))
    ptrue = rng.normal(0, 1, size=40)
    design = rng.uniform(size=(64, 29))
    wsse = jmetrics.wsse_per_simulation(sim, cond)
    stats = jmetrics.ensemble_statistics(sim, cond)
    return dict(sim=sim, cond=cond, constrained=constrained,
                unconstrained=unconstrained, reals=reals, true=true,
                pred=pred, ptrue=ptrue, design=design, wsse=wsse,
                stats=stats)


CALLS = {
    "plot_loss_curves": lambda m, d, o: m.plot_loss_curves(
        [1.0, 0.5, 0.3], [1.1, 0.6, 0.4], path=str(o / "loss.png")),
    "plot_param_histograms": lambda m, d, o: m.plot_param_histograms(
        d["constrained"], d["unconstrained"], 0, path=str(o / "hist.png")),
    "plot_ert_heatmap": lambda m, d, o: m.plot_ert_heatmap(
        d["cond"], path=str(o / "ert.png")),
    "plot_posterior_param": lambda m, d, o: m.plot_posterior_param(
        d["reals"], d["true"], 0, sample_idx=(0, 5),
        path=str(o / "post.png")),
    "plot_wsse_per_survey": lambda m, d, o: m.plot_wsse_per_survey(
        d["wsse"], path=str(o / "wsse.png")),
    "plot_best_sim_panels": lambda m, d, o: m.plot_best_sim_panels(
        d["sim"], d["cond"], d["wsse"].sum(axis=1), best_n=2,
        path=str(o / "best.png")),
    "plot_ensemble_grid": lambda m, d, o: m.plot_ensemble_grid(
        d["stats"], d["cond"], path=str(o / "grid.png")),
    "plot_coverage": lambda m, d, o: m.plot_coverage(
        d["pred"], d["ptrue"], path=str(o / "cov.png")),
    "plot_sampling_diagnostics": lambda m, d, o: m.plot_sampling_diagnostics(
        d["design"], output_dir=str(o)),
    "plot_estimate_vs_conditional": lambda m, d, o: (
        m.plot_estimate_vs_conditional(d["stats"]["mean"], d["cond"],
                                       "Ensemble Mean",
                                       path=str(o / "mean_sc.png")),
        m.plot_estimate_vs_conditional(d["stats"]["mode"], d["cond"],
                                       "Ensemble Mode",
                                       path=str(o / "mode_sc.png"))),
    "plot_mse_distribution": lambda m, d, o: m.plot_mse_distribution(
        d["sim"], d["cond"], path=str(o / "mse_kde.png")),
}


def _run_both(call, saved, tmp_path):
    """`call(module, out_dir)` through JAX's and the port's plots; the
    figures each saved, by package."""
    figs = {}
    for name, mod in (("jax", jplots), ("port", plots)):
        start = len(saved)
        call(mod, tmp_path / name)
        figs[name] = saved[start:]
    return figs


def _check_pairs(figs, tmp_path):
    assert len(figs["port"]) == len(figs["jax"]) > 0
    for (fp, pp), (fj, pj) in zip(figs["port"], figs["jax"]):
        assert pp.relative_to(tmp_path / "port") == \
            pj.relative_to(tmp_path / "jax")
        assert_same(describe(fp), describe(fj), pp.name)
        assert pp.exists() and pp.stat().st_size > 1000, pp


@pytest.mark.parametrize("name", sorted(CALLS))
def test_figure_draws_what_jax_draws(name, saved, tmp_path):
    data = _inputs()
    figs = _run_both(lambda m, o: CALLS[name](m, data, o), saved, tmp_path)
    _check_pairs(figs, tmp_path)
    if name == "plot_estimate_vs_conditional":
        titles = [describe(f)["axes"][0]["title"] for f, _ in figs["port"]]
        assert titles == ["Ensemble Mean vs. Conditional ERT",
                          "Ensemble Modes vs. Conditional ERT"]


def test_figures_without_a_path_are_returned_open():
    data = _inputs()
    got = plots.plot_coverage(data["pred"], data["ptrue"])
    want = jplots.plot_coverage(data["pred"], data["ptrue"])
    assert_same(describe(got), describe(want))
    import matplotlib.pyplot as plt
    assert plt.fignum_exists(got.number)
    plt.close(got)
    plt.close(want)


def test_plot_command_matches_jax(tmp_path, saved, capsys):
    """`plot` through both CLIs (the port's statistics on --device cpu):
    the same six files; the figures drawn from the mode within one step of
    the KDE grid, the others as JAX's."""
    rng = np.random.default_rng(42)
    np.save(tmp_path / "sim.npy", rng.normal(5, 1, (6, 20, 4)))
    np.save(tmp_path / "cond.npy", rng.normal(5, 1, (20, 4)))
    argv = ["plot", "--sim", str(tmp_path / "sim.npy"),
            "--conditional", str(tmp_path / "cond.npy")]
    figs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        start = len(saved)
        assert main(argv + ["--out-dir", str(tmp_path / name)] + extra) == 0
        figs[name] = saved[start:]
    names = {k: sorted(p.name for _, p in v) for k, v in figs.items()}
    assert names["port"] == names["jax"] == sorted(
        ["ensemble_grid.png", "wsse.png", "best_sims.png",
         "mean_vs_cond.png", "mode_vs_cond.png", "mse_distribution.png"])
    sim = np.load(tmp_path / "sim.npy")
    stats = tmetrics.ensemble_statistics(sim, np.load(tmp_path / "cond.npy"),
                                         device="cpu")
    want = jmetrics.ensemble_statistics(sim, np.load(tmp_path / "cond.npy"))
    # one step of the 5000-point KDE grid, whose points are float32
    step = (sim.max() - sim.min()) / 4999
    np.testing.assert_allclose(stats["mode"], want["mode"], rtol=0,
                               atol=step + 1e-6 * np.abs(sim).max())
    for (fp, pp), (fj, _) in zip(figs["port"], figs["jax"]):
        assert pp.stat().st_size > 1000
        if pp.name in ("ensemble_grid.png", "mode_vs_cond.png"):
            continue
        assert_same(describe(fp), describe(fj), pp.name)
    assert "figures under" in capsys.readouterr().out


def test_train_plot_writes_loss_curves(tmp_path, saved):
    """`train --plot`: both CLIs write loss_curves.png into the checkpoint
    directory; the port's draws its own run's train and val losses (as
    its last checkpoint records them)."""
    import json

    from ertdx_torch.doe import SurrogateDataGenerator
    np.save(tmp_path / "p.npy", SurrogateDataGenerator(seed=0)
            .generate_training_samples(40, "lhs")[..., None])
    np.save(tmp_path / "e.npy",
            np.random.default_rng(0).normal(50, 10, (40, 32, 14)))
    argv = ["train", "--params", str(tmp_path / "p.npy"), "--ert",
            str(tmp_path / "e.npy"), "--epochs", "2", "--save-every", "1",
            "--plot"]
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        assert main(argv + ["--checkpoint-dir", str(tmp_path / name)]
                    + extra) == 0
    names = {k: sorted(p.name for p in (tmp_path / k).iterdir()
                       if p.suffix == ".png") for k in ("jax", "port")}
    assert names["port"] == names["jax"] == ["loss_curves.png"]
    fig, path = saved[-1]
    assert path == tmp_path / "port" / "loss_curves.png"
    assert path.stat().st_size > 1000
    meta = json.loads((tmp_path / "port" / "last" / "meta.json").read_text())
    lines = describe(fig)["axes"][0]["lines"]
    assert [ln[3] for ln in lines] == ["Train Loss", "Val Loss"]
    for ln, key in zip(lines, ("train_history", "val_history")):
        np.testing.assert_array_equal(ln[0][:, 0], [0, 1])
        np.testing.assert_array_equal(ln[0][:, 1], meta[key])


def test_metrics_plots_dir_matches_jax(tmp_path, saved, capsys):
    rng = np.random.default_rng(42)
    np.save(tmp_path / "pred.npy", rng.normal(0.5, 0.1, (30, 8, 4)))
    np.save(tmp_path / "true.npy", rng.normal(0.5, 0.1, (8, 4)))
    figs = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        start = len(saved)
        assert main(["metrics", "--pred", str(tmp_path / "pred.npy"),
                     "--true", str(tmp_path / "true.npy"),
                     "--out", str(tmp_path / f"{name}.csv"),
                     "--plots-dir", str(tmp_path / name)]) == 0
        figs[name] = saved[start:]
    assert [p.name for _, p in figs["port"]] == [
        "coverage_joint.png"] + [f"coverage_param_{j:02d}.png"
                                 for j in range(4)]
    _check_pairs(figs, tmp_path)
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()


def test_generate_design_diagnostics_matches_jax(tmp_path, saved):
    figs = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        start = len(saved)
        (tmp_path / name).mkdir()
        assert main(["generate-design", "--n", "64", "--method", "lhs",
                     "--seed", "1", "--out", str(tmp_path / name / "d.npy"),
                     "--diagnostics"]) == 0
        figs[name] = saved[start:]
    assert [p.name for _, p in figs["port"]] == [
        "sampling_diagnostics.png", "parameter_correlations.png"]
    _check_pairs(figs, tmp_path)
    assert (tmp_path / "port" / "d.npy").read_bytes() == \
        (tmp_path / "jax" / "d.npy").read_bytes()


BLOCKED = r"""
import sys
sys.modules["matplotlib"] = None
import numpy as np
import ertdx_torch.cli, ertdx_torch.doe, ertdx_torch.plots
from ertdx_torch import cli, doe, plots
try:
    plots.plot_loss_curves([1.0, 0.5], [1.1, 0.6])
except ModuleNotFoundError as e:
    assert e.name == "matplotlib" and "matplotlib" in str(e), e
    print("raised:", e)
else:
    raise SystemExit("no error without matplotlib")
try:
    doe.SurrogateDataGenerator(seed=0).generate_training_samples(
        8, "lhs", plot_diagnostics=True, output_dir=sys.argv[1])
except ModuleNotFoundError as e:
    assert e.name == "matplotlib", e
else:
    raise SystemExit("diagnostics drew without matplotlib")
np.save(sys.argv[1] + "/sim.npy", np.ones((3, 4, 2)))
np.save(sys.argv[1] + "/cond.npy", np.ones((4, 2)))
try:
    cli.main(["plot", "--sim", sys.argv[1] + "/sim.npy", "--conditional",
              sys.argv[1] + "/cond.npy", "--out-dir", sys.argv[1] + "/f",
              "--device", "cpu"])
except ModuleNotFoundError as e:
    assert e.name == "matplotlib", e
else:
    raise SystemExit("plot drew without matplotlib")
assert "matplotlib.pyplot" not in sys.modules
print("ok")
"""


def test_imports_and_raises_without_matplotlib(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", BLOCKED, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
    assert "raised: ertdx_torch.plots draws with matplotlib" in proc.stdout
    assert not (tmp_path / "f").exists()
