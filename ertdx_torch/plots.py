"""Figures: a copy of the JAX package's eleven figure families
(ertdx/plots.py) on the port's metrics and params.

Every function returns its matplotlib Figure (and saves it when `path` is
given) instead of calling plt.show(). matplotlib is imported inside the
functions that draw, with the Agg backend, so this module, the CLI and
doe.py import without it (the card's machine has none); a drawing call
without it raises ModuleNotFoundError naming matplotlib. Figure inventory
and reference locations (SURVEY.md §2 row 31):
  * parameter histograms constrained/unconstrained (:249-254)
  * loss curves (:359-365)
  * ERT heatmaps (:425-432, 591-598, 736-744)
  * per-parameter posterior KDE+hist vs truth (:601-631)
  * WSSE-per-survey lines with best-N highlight (:791-811)
  * best-sim panels: heatmap/scatter/KDE + Wasserstein (:829-863)
  * mean/mode-vs-conditional standalone identity scatters (:905-922)
  * per-sim MSE-distribution KDE (:927-938)
  * 3x3 mean/mode/diff/quantile grid (:952-1034)
  * coverage ("accuracy") plots with annotations (:1139-1183)
  * sampling diagnostics: histograms + correlation matrix
    (Generate_ERT_utils.py:522-554)
Host code: numpy in, no torch.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from .metrics import (accuracy_score, avg_prop_indicator_function,
                      coverage_proportions, goodness_score, precision_score,
                      wasserstein_1d)


def _pyplot():
    """matplotlib.pyplot on the Agg backend; raises ModuleNotFoundError
    naming matplotlib where it is not installed."""
    try:
        import matplotlib
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            "ertdx_torch.plots draws with matplotlib, which is not "
            "installed; install matplotlib to write the figures",
            name="matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _finish(fig, path: Optional[str]):
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(path, bbox_inches="tight")
        _pyplot().close(fig)
    return fig


def _gaussian_kde_curve(x: np.ndarray, grid_points: int = 256):
    x = np.asarray(x, float).ravel()
    h = x.std(ddof=1) * x.size ** (-0.2) if x.size > 1 else np.nan
    if not np.isfinite(h) or h <= 0:
        # single sample / zero variance: std(ddof=1) is NaN (or 0) and
        # the curve silently rendered as nothing — draw a narrow spike
        # at the value instead
        h = max(abs(x[0]) * 1e-3, 1e-6)
    lo, hi = x.min() - 3 * h, x.max() + 3 * h
    g = np.linspace(lo, hi, grid_points)
    z = (g[:, None] - x[None, :]) / h
    dens = np.exp(-0.5 * z * z).sum(axis=1) / (x.size * h * np.sqrt(2 * np.pi))
    return g, dens


def plot_loss_curves(train_history: Sequence[float],
                     val_history: Sequence[float],
                     path: Optional[str] = None):
    """Reference: ERT_Conditional_Diffusion.py:359-365."""
    plt = _pyplot()
    fig = plt.figure(figsize=(8, 4), dpi=150)
    plt.plot(train_history, label="Train Loss")
    plt.plot(val_history, label="Val Loss")
    plt.xlabel("Epoch")
    plt.ylabel("MSE Loss")
    plt.legend()
    return _finish(fig, path)


def plot_param_histograms(constrained: np.ndarray, unconstrained: np.ndarray,
                          param_idx: int, path: Optional[str] = None):
    """Reference: ERT_Conditional_Diffusion.py:249-254."""
    plt = _pyplot()
    fig, axs = plt.subplots(1, 2, figsize=(10, 4), dpi=150)
    axs[0].hist(constrained[:, param_idx], bins=100, density=True,
                alpha=0.5, color="red", label="Constrained")
    axs[0].legend()
    axs[1].hist(unconstrained[:, param_idx], bins=100, density=True,
                alpha=0.5, color="blue", label="Unconstrained")
    axs[1].legend()
    return _finish(fig, path)


def plot_ert_heatmap(ert: np.ndarray, title: str = "True ERT data",
                     cbar_label: str = "Transfer resistivity [Ω]",
                     path: Optional[str] = None):
    """Reference: ERT_Conditional_Diffusion.py:425-432 and :591-598."""
    plt = _pyplot()
    fig = plt.figure(figsize=(4, 4), dpi=150)
    plt.imshow(ert, aspect="auto", origin="lower", cmap="jet")
    cbar = plt.colorbar()
    cbar.set_label(cbar_label)
    plt.xlabel("ERT surveys")
    plt.ylabel("ERT measurements")
    plt.title(title)
    return _finish(fig, path)


def plot_posterior_param(params_realizations: np.ndarray,
                         true_params: np.ndarray, param_idx: int,
                         sample_idx: Sequence[int] = (0, 5),
                         names: Optional[Sequence[str]] = None,
                         path: Optional[str] = None):
    """Posterior histogram + KDE + truth lines per conditioning case.

    Reference: ERT_Conditional_Diffusion.py:601-631.
    params_realizations: (n_real, B, P); true_params: (B, P)."""
    plt = _pyplot()
    if names is None:
        from .params import ParameterSpace
        names = ParameterSpace().names
    fig = plt.figure(figsize=(6, 4), dpi=150)
    for i, s in enumerate(sample_idx):
        dist = params_realizations[:, s, param_idx]
        plt.hist(dist, bins=22, density=True, alpha=0.3, color=f"C{i}",
                 label=f"ERT Case: {i + 1}")
        g, dens = _gaussian_kde_curve(dist)
        plt.plot(g, dens, color=f"C{i}", alpha=0.7)
        plt.axvline(true_params[s, param_idx], linewidth=1.2,
                    linestyle="--", color=f"C{i}", label="True parameter")
    plt.xlabel(names[param_idx])
    plt.legend(bbox_to_anchor=(0.5, -0.2), loc="upper center",
               ncol=len(sample_idx))
    return _finish(fig, path)


def plot_wsse_per_survey(wsse_sim: np.ndarray, best_n: int = 3,
                         path: Optional[str] = None):
    """Reference: ERT_Conditional_Diffusion.py:791-811."""
    plt = _pyplot()
    wsse_sim = np.asarray(wsse_sim)
    order = np.argsort(wsse_sim.sum(axis=1))
    fig = plt.figure(figsize=(8, 5.5), dpi=150)
    for sim in range(wsse_sim.shape[0]):
        plt.plot(wsse_sim[sim], color="gray", alpha=0.7, linewidth=1)
    colors = plt.cm.viridis(np.linspace(0, 1, best_n))
    for i, idx in enumerate(order[:best_n]):
        plt.plot(wsse_sim[idx], color=colors[i], linewidth=1.5,
                 label=f"Sim {idx}")
    n_surveys = wsse_sim.shape[1]
    plt.xlabel("ERT Survey")
    plt.yscale("log")
    plt.ylabel("WSSE")
    plt.xticks(ticks=np.arange(n_surveys),
               labels=np.arange(1, n_surveys + 1))
    plt.legend(loc="upper center", bbox_to_anchor=(0.5, -0.15),
               ncol=best_n, frameon=True)
    plt.tight_layout()
    return _finish(fig, path)


def plot_best_sim_panels(sim_data: np.ndarray, conditional: np.ndarray,
                         wsse_total: np.ndarray, best_n: int = 3,
                         path: Optional[str] = None):
    """Heatmap / identity scatter / KDE comparison per best simulation.

    Reference: ERT_Conditional_Diffusion.py:829-863."""
    plt = _pyplot()
    order = np.argsort(wsse_total)
    fig, axs = plt.subplots(best_n, 3, figsize=(18, 5 * best_n), dpi=100,
                            squeeze=False)
    for row, idx in enumerate(order[:best_n]):
        im = axs[row, 0].imshow(sim_data[idx], aspect="auto",
                                origin="lower", cmap="jet")
        axs[row, 0].set_title(f"Sim {idx}")
        axs[row, 0].set_xlabel("ERT Surveys")
        axs[row, 0].set_ylabel("ERT Measurements")
        fig.colorbar(im, ax=axs[row, 0], fraction=0.046, pad=0.04)

        mn = min(sim_data[idx].min(), conditional.min())
        mx = max(sim_data[idx].max(), conditional.max())
        axs[row, 1].plot([mn, mx], [mn, mx], color="red", linestyle="--",
                         linewidth=1, label="Identity Line")
        axs[row, 1].scatter(sim_data[idx].ravel(), conditional.ravel(),
                            color="black", s=5)
        axs[row, 1].set_xlabel("Inverted ERT [Ω]")
        axs[row, 1].set_ylabel("Conditional ERT [Ω]")
        axs[row, 1].legend()
        axs[row, 1].set_aspect("equal", adjustable="box")

        for arr, c, lbl in ((sim_data[idx], "C1", "Inverted ERT"),
                            (conditional, "C0", "Conditional ERT")):
            g, dens = _gaussian_kde_curve(arr)
            axs[row, 2].plot(g, dens, color=c, label=lbl)
        w = wasserstein_1d(sim_data[idx], conditional)
        axs[row, 2].set_title(f"Wasserstein Distance: {w:.4f}")
        axs[row, 2].set_xlabel("Transfer resistance [Ω]")
        axs[row, 2].set_ylabel("Density")
        axs[row, 2].legend()
    plt.tight_layout()
    return _finish(fig, path)


def plot_ensemble_grid(stats: Dict[str, np.ndarray],
                       conditional: np.ndarray,
                       path: Optional[str] = None):
    """3x3 grid: conditional/mean/mode, diff KDE + diff maps, P25/P50/P75.

    Reference: ERT_Conditional_Diffusion.py:952-1034."""
    plt = _pyplot()
    fig, axs = plt.subplots(3, 3, figsize=(24, 21), dpi=80)
    v_min = min(stats["mean"].min(), conditional.min(),
                stats["mode"].min())
    v_max = max(stats["mean"].max(), conditional.max(),
                stats["mode"].max())
    for ax, arr, title in ((axs[0, 0], conditional, "Conditional ERT"),
                           (axs[0, 1], stats["mean"], "Ensemble Mean"),
                           (axs[0, 2], stats["mode"], "Ensemble Mode")):
        im = ax.imshow(arr, aspect="auto", origin="lower", cmap="jet",
                       vmin=v_min, vmax=v_max)
        ax.set_title(title)
        ax.set_xlabel("ERT Surveys")
        ax.set_ylabel("ERT Measurements")
        fig.colorbar(im, ax=ax, shrink=1.0, aspect=20)

    for arr, c, lbl in ((stats["diff_mode"], "blue", "Ensemble Mode"),
                        (stats["diff_mean"], "red", "Ensemble Mean")):
        g, dens = _gaussian_kde_curve(arr)
        axs[1, 0].plot(g, dens, color=c, label=lbl)
    axs[1, 0].set_title("Difference Distribution")
    axs[1, 0].legend()

    for ax, key, title in ((axs[1, 1], "diff_mean", "Difference (Mean)"),
                           (axs[1, 2], "diff_mode", "Difference (Mode)")):
        vmax = np.max(np.abs(stats[key]))
        im = ax.imshow(stats[key], aspect="auto", origin="lower",
                       cmap="seismic", vmin=-vmax, vmax=vmax)
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=1.0, aspect=20)

    qmin = min(stats["p25"].min(), stats["p50"].min(), stats["p75"].min())
    qmax = max(stats["p25"].max(), stats["p50"].max(), stats["p75"].max())
    for ax, key, title in ((axs[2, 0], "p25", "25th Percentile (P25)"),
                           (axs[2, 1], "p50", "50th Percentile (P50 - Median)"),
                           (axs[2, 2], "p75", "75th Percentile (P75)")):
        im = ax.imshow(stats[key], aspect="auto", origin="lower",
                       cmap="jet", vmin=qmin, vmax=qmax)
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=1.0, aspect=20)
    plt.tight_layout()
    return _finish(fig, path)


def plot_estimate_vs_conditional(estimate: np.ndarray,
                                 conditional: np.ndarray,
                                 label: str = "Ensemble Mean",
                                 path: Optional[str] = None):
    """Standalone identity scatter: ensemble mean (or mode) against the
    conditional ERT, with the red dashed identity line.

    Reference: ERT_Conditional_Diffusion.py:905-922 (two near-identical
    blocks for mean and mode — the reference titles the mode variant
    'Ensemble Modes vs. Conditional ERT')."""
    plt = _pyplot()
    estimate = np.asarray(estimate)
    conditional = np.asarray(conditional)
    fig = plt.figure(figsize=(6, 4), dpi=150)
    mn = min(estimate.min(), conditional.min())
    mx = max(estimate.max(), conditional.max())
    plt.plot([mn, mx], [mn, mx], color="red", linestyle="--", linewidth=1)
    plt.scatter(estimate.ravel(), conditional.ravel(), color="black", s=10)
    plt.xlabel(label)
    plt.ylabel("Conditional ERT")
    suffix = "s" if "mode" in label.lower() else ""
    plt.title(f"{label}{suffix} vs. Conditional ERT")
    return _finish(fig, path)


def plot_mse_distribution(sim_data: np.ndarray, conditional: np.ndarray,
                          path: Optional[str] = None):
    """KDE of the per-simulation MSE against the conditional ERT, with a
    dashed vertical guide at zero.

    Reference: ERT_Conditional_Diffusion.py:927-938."""
    plt = _pyplot()
    sim_data = np.asarray(sim_data)
    cond_flat = np.asarray(conditional, float).ravel()
    mse = np.mean(
        (sim_data.reshape(sim_data.shape[0], -1) - cond_flat[None, :]) ** 2,
        axis=1)
    fig = plt.figure(figsize=(6, 4), dpi=150)
    g, dens = _gaussian_kde_curve(mse)
    plt.plot(g, dens)
    plt.axvline(0, linewidth=1, linestyle="--", color="black")
    plt.xlabel("MSE")
    plt.ylabel("Density")
    plt.title("Distribution of MSE between ERT Simulations and "
              "Conditional ERT")
    return _finish(fig, path)


def plot_coverage(pred: np.ndarray, true: np.ndarray,
                  title: str = "Conditional Diffusion Model",
                  path: Optional[str] = None):
    """Coverage ('accuracy') plot with metric box and guide annotations.

    Reference: ERT_Conditional_Diffusion.py:1139-1183."""
    plt = _pyplot()
    avg, probs = coverage_proportions(pred, true)
    a_p = avg_prop_indicator_function(avg, probs)
    acc = accuracy_score(a_p, probs)
    prec = precision_score(acc, avg, probs, a_p)
    good = goodness_score(a_p, avg, probs)

    fig = plt.figure(figsize=(6, 4), dpi=150)
    plt.plot(probs, avg, color="black", linewidth=1)
    plt.scatter(probs, avg, color="black", s=10)
    plt.plot([0, 1], [0, 1], color="red", linestyle="--", linewidth=1)
    plt.xlabel("Probability interval, p")
    plt.ylabel(r"$\overline{\xi(p)}$")
    plt.title(f"{title}, Goodness Metric: {good:.2f}")
    for xy, xytext in (((0.25, 0.75), (0.5, 0.50)),
                       ((0.75, 0.25), (0.5, 0.50))):
        plt.annotate("", xy=xy, xytext=xytext, xycoords="axes fraction",
                     arrowprops=dict(facecolor="black", shrink=0.05,
                                     alpha=0.2, width=0.5, headwidth=3,
                                     headlength=4))
    ax = plt.gca()
    plt.text(0.02, 0.95, "Accurate but not precise", transform=ax.transAxes,
             fontsize=8)
    plt.text(0.98, 0.03, "Not accurate not precise", transform=ax.transAxes,
             fontsize=8, horizontalalignment="right")
    plt.text(0.5, 0.32, "Accurate and precise", transform=ax.transAxes,
             fontsize=8, horizontalalignment="center", rotation=36)
    plt.annotate(f"Accuracy: {acc:.2f}   Precision: {prec:.2f}   "
                 f"Goodness: {good:.2f}",
                 xy=(0.5, -0.2), xycoords="axes fraction",
                 bbox=dict(facecolor="white", edgecolor="black", alpha=0.8),
                 ha="center", va="center", fontsize=10)
    return _finish(fig, path)


def plot_sampling_diagnostics(parameters: np.ndarray,
                              output_dir: str = "."):
    """Histograms of the first 6 params + correlation heatmap.

    Reference: Generate_ERT_utils.py:522-554."""
    plt = _pyplot()
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    n_plots = min(6, parameters.shape[1])
    fig, axs = plt.subplots(2, 3, figsize=(15, 10))
    fig.suptitle("Parameter Sampling Diagnostic Plots")
    for i in range(n_plots):
        ax = axs[i // 3, i % 3]
        ax.hist(parameters[:, i], bins=30)
        ax.set_title(f"Parameter {i + 1}")
        ax.set_xlabel("Value")
        ax.set_ylabel("Count")
    plt.tight_layout()
    fig.savefig(out / "sampling_diagnostics.png")
    plt.close(fig)

    fig = plt.figure(figsize=(10, 10))
    corr = np.corrcoef(parameters.T)
    plt.imshow(corr, cmap="RdBu", vmin=-1, vmax=1)
    plt.colorbar()
    plt.title("Parameter Correlation Matrix")
    plt.xlabel("Parameter Index")
    plt.ylabel("Parameter Index")
    fig.savefig(out / "parameter_correlations.png")
    plt.close(fig)
