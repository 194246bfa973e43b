"""Evaluation and UQ metrics (ertdx/metrics.py on numpy and torch).

The definitions are the reference's, carried over as numpy:
  * WSSE: sd = A|obs| + B, WSE = (pred - obs)^2 / sd^2, WSSE = mean(WSE);
  * the KDE mode: a Gaussian KDE with Scott's factor, argmax on a
    linspace grid;
  * the 1-D Wasserstein distance and the ensemble statistics;
  * coverage accuracy / precision / goodness: trapezoid integrals of the
    indicator and the deviation of the empirical symmetric-interval
    coverage; per-parameter tables, the CRPS of an ensemble and the
    simulation-based-calibration ranks and their KS distance.

`batched_kde_mode` evaluates the ensemble mode of every pixel (4693 x 14
at the reference grid) in PyTorch on the card: per-pixel Scott
bandwidths on one global grid, the density accumulated realization by
realization in chunks of pixels. The JAX package computes it with a
jitted XLA function, not a Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import resolve_device
from .params import ParameterSpace


# ---------------------------------------------------------------------------
# WSSE
# ---------------------------------------------------------------------------

def wsse_metric(A: float, B: float, predictions: np.ndarray,
                observations: np.ndarray) -> Tuple[float, np.ndarray]:
    """Weighted sum of squared errors (reference WSSE_metric,
    ERT_Conditional_Diffusion.py:767-773; A=0.1, B=0.01 at :775-776)."""
    predictions = np.asarray(predictions)
    observations = np.asarray(observations)
    sd = A * np.abs(observations) + B
    wse = (predictions - observations) ** 2 / sd ** 2
    return float(np.average(wse)), wse


def wsse_per_simulation(sim_data: np.ndarray, conditional: np.ndarray,
                        A: float = 0.1, B: float = 0.01) -> np.ndarray:
    """(n_sim, M, S) vs (M, S) -> (n_sim, S) WSSE per sim per survey.

    Reference loop: ERT_Conditional_Diffusion.py:777-784."""
    sim_data = np.asarray(sim_data)
    conditional = np.asarray(conditional)
    sd = A * np.abs(conditional) + B
    wse = (sim_data - conditional[None]) ** 2 / sd[None] ** 2
    return wse.mean(axis=1)


# ---------------------------------------------------------------------------
# KDE modes
# ---------------------------------------------------------------------------

def _scott_bandwidth(x: np.ndarray) -> float:
    """scipy.stats.gaussian_kde default: factor n^(-1/5), bw = factor*std
    (ddof=1)."""
    n = x.shape[-1]
    return n ** (-1.0 / 5.0) * np.std(x, ddof=1, axis=-1)


def mode_kde_calculation(array: np.ndarray, grid_points: int = 1000) -> float:
    """Mode of a 1-D sample via Gaussian KDE argmax on a linspace grid.

    Matches the reference (ERT_Conditional_Diffusion.py:166-181), which uses
    scipy gaussian_kde with the Scott rule."""
    array = np.asarray(array, dtype=np.float64)
    grid = np.linspace(array.min(), array.max(), grid_points)
    h = _scott_bandwidth(array)
    if h == 0:
        return float(array[0])
    z = (grid[:, None] - array[None, :]) / h
    dens = np.exp(-0.5 * z * z).sum(axis=1)
    return float(grid[np.argmax(dens)])


def _kde_mode_chunk(points: torch.Tensor, grid: torch.Tensor,
                    h: torch.Tensor) -> torch.Tensor:
    """points: (P, N) pixel ensembles; grid: (G,); h: (P,) bandwidths,
    float32 on one device. Returns the (P,) gridpoint of largest density
    per pixel. The density accumulates one realization at a time, in
    realization order as JAX's scan adds them, so that peak memory stays
    (P, G): a (P, G, N) tensor would take about 4 GB at the reference's
    scale (65k pixels x 5k gridpoints x 50 realizations)."""
    inv_h = (1.0 / h)[:, None]
    dens = torch.zeros((points.shape[0], grid.shape[0]),
                       dtype=torch.float32, device=points.device)
    for col in points.T:             # (P,) one realization across pixels
        z = (grid[None, :] - col[:, None]) * inv_h
        dens.add_(torch.exp(-0.5 * z * z))
    return grid[torch.argmax(dens, dim=-1)]


def batched_kde_mode(samples: np.ndarray, grid_points: int = 5000,
                     chunk: int = 4096, device=None) -> np.ndarray:
    """Per-pixel ensemble KDE mode over a shared global grid, on `device`
    (CUDA unless "cpu" is asked for).

    samples: (n_real, M, S) -> (M, S) modes. The grid is the global
    linspace(min, max, grid_points) in float32 and each pixel has its own
    Scott bandwidth, as the reference's per-pixel loop; pixels go to the
    device `chunk` at a time. A pixel whose ensemble is constant has that
    constant as its mode (its clamped bandwidth would underflow every
    density to 0 and report the grid's minimum).
    """
    dev = resolve_device(device)
    samples = np.asarray(samples, dtype=np.float32)
    n, m, s = samples.shape
    pts = samples.reshape(n, m * s).T  # (P, N)
    grid = torch.linspace(float(samples.min()), float(samples.max()),
                          grid_points, dtype=torch.float32, device=dev)
    h_raw = _scott_bandwidth(pts.astype(np.float64))
    h = np.maximum(h_raw, 1e-12)
    out = np.empty(pts.shape[0], np.float32)
    with torch.no_grad():
        for s0 in range(0, pts.shape[0], chunk):
            blk = torch.from_numpy(np.ascontiguousarray(
                pts[s0:s0 + chunk])).to(dev)
            hb = torch.from_numpy(h[s0:s0 + chunk].astype(np.float32)).to(
                dev)
            out[s0:s0 + chunk] = _kde_mode_chunk(blk, grid, hb).cpu().numpy()
    const = h_raw <= 0
    if const.any():
        out[const] = pts[const, 0]
    return out.reshape(m, s)


# ---------------------------------------------------------------------------
# Distances & ensemble statistics
# ---------------------------------------------------------------------------

def wasserstein_1d(u: np.ndarray, v: np.ndarray) -> float:
    """1-D Wasserstein-1 distance; matches scipy.stats.wasserstein_distance
    (used at ERT_Conditional_Diffusion.py:860, 898-899)."""
    u = np.sort(np.asarray(u).ravel())
    v = np.sort(np.asarray(v).ravel())
    all_x = np.sort(np.concatenate([u, v]))
    deltas = np.diff(all_x)
    u_cdf = np.searchsorted(u, all_x[:-1], side="right") / u.size
    v_cdf = np.searchsorted(v, all_x[:-1], side="right") / v.size
    return float(np.sum(np.abs(u_cdf - v_cdf) * deltas))


def ensemble_statistics(sim_data: np.ndarray,
                        conditional: Optional[np.ndarray] = None,
                        mode: Optional[np.ndarray] = None,
                        eps: float = 1e-8,
                        device=None) -> Dict[str, np.ndarray]:
    """Ensemble summary stats over the realization axis.

    sim_data: (n_real, M, S). Mirrors ERT_Conditional_Diffusion.py:865-949.
    Without `mode`, `batched_kde_mode` computes it on `device`.
    """
    sim_data = np.asarray(sim_data)
    out: Dict[str, np.ndarray] = {
        "mean": sim_data.mean(axis=0),
        "std": sim_data.std(axis=0),
        "var": sim_data.var(axis=0),
        "p25": np.percentile(sim_data, 25, axis=0),
        "p50": np.percentile(sim_data, 50, axis=0),
        "p75": np.percentile(sim_data, 75, axis=0),
    }
    out["coefficient_of_variation"] = out["std"] / (np.abs(out["mean"])
                                                    + eps)
    if mode is None:
        mode = batched_kde_mode(sim_data, device=device)
    out["mode"] = mode
    if conditional is not None:
        conditional = np.asarray(conditional)
        out["diff_mean"] = conditional - out["mean"]
        out["diff_mode"] = conditional - mode
        out["pct_error_mean"] = (np.abs(out["mean"] - conditional)
                                 / np.abs(conditional)) * 100
        out["pct_error_mode"] = (np.abs(mode - conditional)
                                 / np.abs(conditional)) * 100
        out["wasserstein_mean"] = wasserstein_1d(out["mean"], conditional)
        out["wasserstein_mode"] = wasserstein_1d(mode, conditional)
        out["mse_mean"] = float(np.mean((out["mean"] - conditional) ** 2))
        out["mse_mode"] = float(np.mean((mode - conditional) ** 2))
        out["rmse_mean"] = float(np.sqrt(out["mse_mean"]))
        out["rmse_mode"] = float(np.sqrt(out["mse_mode"]))
        out["mse_per_sim"] = np.mean(
            (sim_data - conditional[None]) ** 2, axis=(1, 2))
    return out


# ---------------------------------------------------------------------------
# UQ coverage metrics (accuracy / precision / goodness)
# ---------------------------------------------------------------------------

def coverage_proportions(pred: np.ndarray, true: np.ndarray,
                         prob_array: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Empirical symmetric-interval coverage xi-bar(p).

    pred: (n_real, ...) realizations; true: (...) matching trailing shape.
    Reference: ERT_Conditional_Diffusion.py:1121-1132.
    """
    pred = np.asarray(pred)
    true = np.asarray(true)
    if prob_array is None:
        prob_array = np.linspace(0.01, 0.99, 30)
    p = np.asarray(prob_array, dtype=np.float64)
    # all 2*len(p) interval bounds in two vectorized percentile passes
    # (one per bound set) instead of 60 full-array partitions
    low = np.percentile(pred, (1 - p) / 2 * 100, axis=0)   # (len(p), ...)
    upp = np.percentile(pred, (1 + p) / 2 * 100, axis=0)
    cover = (low < true) & (true <= upp)
    avg = cover.reshape(len(p), -1).mean(axis=1)
    return avg, prob_array


# numpy renamed trapz -> trapezoid in 2.0; support both
_trapezoid = np.trapezoid if hasattr(np, "trapezoid") else np.trapz


def avg_prop_indicator_function(avg_proportion: np.ndarray,
                                prob_array: np.ndarray) -> np.ndarray:
    """a(p) = 1[xi-bar(p) >= p]. Reference: :1089-1096."""
    return (np.asarray(avg_proportion) >= np.asarray(prob_array)).astype(int)


def accuracy_score(a_p: np.ndarray, prob_array: np.ndarray) -> float:
    """Accuracy = integral of a(p) dp (trapezoid). Reference: :1098-1100."""
    return float(_trapezoid(a_p, prob_array))


def precision_score(accuracy: float, avg_proportion: np.ndarray,
                    prob_array: np.ndarray, a_p: np.ndarray) -> float:
    """Precision = 1 - 2*∫ a(p)(xi-bar - p) dp; 0 when accuracy is 0.
    Reference (sic 'preccision_score'): :1102-1109."""
    if accuracy == 0:
        return 0.0
    integ = _trapezoid(a_p * (avg_proportion - prob_array), prob_array)
    return float(1.0 - 2.0 * integ)


# keep the reference's (misspelled) name available for parity checks
preccision_score = precision_score


def goodness_score(a_p: np.ndarray, avg_proportion: np.ndarray,
                   prob_array: np.ndarray) -> float:
    """Goodness = 1 - ∫ (3a - 2)(xi-bar - p) dp. Reference: :1111-1115."""
    integ = _trapezoid((3 * a_p - 2) * (avg_proportion - prob_array),
                         prob_array)
    return float(1.0 - integ)


def uq_scores(pred: np.ndarray, true: np.ndarray,
              prob_array: Optional[np.ndarray] = None) -> Dict[str, object]:
    """Joint accuracy/precision/goodness for an ensemble vs truth.

    The 'accuracy'/'precision'/'goodness' values are floats; the
    'avg_proportion'/'prob_array' keys carry the coverage CURVE as
    ndarrays (filter them before json.dumps)."""
    avg, probs = coverage_proportions(pred, true, prob_array)
    a_p = avg_prop_indicator_function(avg, probs)
    acc = accuracy_score(a_p, probs)
    return {
        "accuracy": acc,
        "precision": precision_score(acc, avg, probs, a_p),
        "goodness": goodness_score(a_p, avg, probs),
        "avg_proportion": avg,
        "prob_array": probs,
    }


def per_parameter_uq(pred: np.ndarray, true: np.ndarray, names=None,
                     prob_array: Optional[np.ndarray] = None):
    """Per-parameter UQ table (reference: ERT_Conditional_Diffusion.py:
    1186-1266). pred: (n_real, N, P); true: (N, P). Returns list of dicts
    suitable for CSV export (Parameter_uncertainty_metrics.csv, :1270-1276).
    """
    pred = np.asarray(pred)
    true = np.asarray(true)
    p_dim = pred.shape[-1]
    if names is None:
        names = ParameterSpace().names
    rows = []
    for j in range(p_dim):
        sc = uq_scores(pred[..., j], true[..., j], prob_array)
        rows.append({"Parameter": names[j],
                     "Accuracy": sc["accuracy"],
                     "Precision": sc["precision"],
                     "Goodness": sc["goodness"]})
    return rows


def crps_ensemble(pred: np.ndarray, true: np.ndarray,
                  fair: bool = True) -> np.ndarray:
    """Continuous ranked probability score of an ensemble forecast
    (Gneiting & Raftery 2007): CRPS = E|X - y| - 0.5 E|X - X'|.

    A PROPER score: minimized only by the true predictive distribution,
    so unlike coverage accuracy (reference metric, ERT_Conditional_
    Diffusion.py:1089-1137) it penalizes over-dispersion and
    under-dispersion symmetrically and stays informative when coverage
    saturates at 0 or 1 — the regime the tempering calibration sweeps
    operate in. No reference analogue.

    pred: (R, ...) ensemble draws; true: (...) matching observation
    shape. Returns CRPS per observation cell (...), lower is better.
    fair=True uses the unbiased R(R-1) estimator of E|X - X'| (Ferro
    2014 "fair CRPS" — an exchangeable-member estimate of the
    infinite-ensemble score); fair=False the classic /R^2 plug-in.
    O(R log R) per cell via the sorted-spread identity
    sum_{i<j}(x_(j) - x_(i)) = sum_i (2i - R + 1) x_(i), 0-indexed.
    """
    pred = np.asarray(pred, np.float64)
    true = np.asarray(true, np.float64)
    R = pred.shape[0]
    if R < 2:
        raise ValueError(f"need >= 2 ensemble members, got {R}")
    mae = np.mean(np.abs(pred - true[None]), axis=0)
    xs = np.sort(pred, axis=0)
    coef = (2.0 * np.arange(R) - R + 1.0).reshape((R,) + (1,) * true.ndim)
    pair_sum = 2.0 * np.sum(coef * xs, axis=0)   # sum_{i,j} |x_i - x_j|
    denom = R * (R - 1) if fair else R * R
    return mae - 0.5 * pair_sum / denom


def sbc_ranks(pred: np.ndarray, true: np.ndarray) -> np.ndarray:
    """Simulation-based-calibration rank statistics (Talts et al. 2018,
    arXiv:1804.06788): the rank of each true value among its R posterior
    draws, in 0..R. If the sampler draws from the correct posterior, the
    ranks are uniform over the R+1 bins — over-dispersion piles ranks
    mid-histogram, under-dispersion/bias piles them at the edges, so the
    histogram SHAPE diagnoses what coverage accuracy (reference metric)
    only scores. The terminal UQ workload (true params + (R, N, P)
    posterior ensembles per test condition) is exactly SBC's setup.
    No reference analogue.

    pred: (R, ...); true: (...). Returns int ranks shaped like true.
    """
    pred = np.asarray(pred)
    true = np.asarray(true)
    return (pred < true[None]).sum(axis=0)


def sbc_uniformity(ranks: np.ndarray, n_draws: int) -> float:
    """Kolmogorov-Smirnov distance of SBC ranks from the discrete uniform
    on {0..n_draws}: D = max_k |ecdf(k) - (k+1)/(R+1)|, computed over the
    leading axis; 0 = perfectly calibrated. ranks: (M,) or (M, P) — with
    a parameter axis the statistic is returned per parameter, so callers
    can `.mean()` or rank parameters by mis-calibration.
    """
    ranks = np.asarray(ranks)
    squeeze = ranks.ndim == 1
    if squeeze:
        ranks = ranks[:, None]
    M, P = ranks.shape
    R1 = n_draws + 1
    counts = np.zeros((R1, P))
    for p in range(P):
        counts[:, p] = np.bincount(ranks[:, p], minlength=R1)
    ecdf = np.cumsum(counts, axis=0) / M
    cdf = (np.arange(1, R1 + 1) / R1)[:, None]
    d = np.abs(ecdf - cdf).max(axis=0)
    return float(d[0]) if squeeze else d
