"""The plain posterior: condition scaling, DDIM, the inverse and the
summary statistics, around the plain CondUNet of `model.py`.

From the raw surveys and the training arrays the benchmark made:

* the conditions are min-max scaled per feature (L x C features) by the
  training surveys' minimum and maximum (a zero range scales by 1);
* the condition is encoded once, each block's cross K and V made once;
* DDIM over round(linspace(0, T - 1, steps)) of a linear beta schedule,
  eta 0: x0 = (x - sqrt(1 - ab) eps) / sqrt(ab), x <- sqrt(ab_prev) x0 +
  sqrt(1 - ab_prev) eps, from the given x_T;
* the draws go through a sigmoid and the parameter scaler's inverse
  (min-max over the training parameters), and a draw is valid where all
  its parameters lie within the physical limits;
* the statistics over the valid draws of each condition: mean, standard
  deviation, the 25th, 50th and 75th percentiles (linear interpolation).

The coefficients are float64 on the host; the arithmetic is float32 on
the device, with every product through the `mm` given (float32 for the
reference, a lower precision for the control).
"""
from __future__ import annotations

import numpy as np
import torch

from . import model as ref_model

STATS = ("mean", "std", "p25", "p50", "p75")

# The physical limits (low, high) of the Hanford-site model's 29
# parameters, as the program's parameter space states them: for each of
# the Hanford, Ringold and Pit units porosity, horizontal permeability
# [m^2], the vertical to horizontal ratio and Archie's m, n and a; the
# van Genuchten alpha [1/m], m and residual saturation of the Hanford
# and Ringold units; three surface conductivities and the native and
# flush waters' conductivities [S/m].
_UNIT = [(0.05, 0.35), (2e-13, 1e-7), (0.2, 1.0), (1.1, 2.1), (1.6, 2.6),
         (0.8, 1.2)]
PARAM_LIMITS = np.array(
    _UNIT + [(0.2, 0.5), (1e-12, 1e-8)] + _UNIT[2:] + _UNIT
    + [(2e-5, 9e-3), (0.2, 0.65), (0.0055, 0.24),
       (1e-5, 8e-3), (0.16, 0.8), (0.02, 0.2)]
    + [(1e-5, 1e-2)] * 3 + [(0.005, 0.1)] * 2, np.float64)


def minmax(train: np.ndarray):
    """(data_min, range) per feature of (N, F) training rows, float64,
    a zero range replaced by 1."""
    lo = train.min(axis=0).astype(np.float64)
    rng = train.max(axis=0).astype(np.float64) - lo
    return lo, np.where(rng == 0, 1.0, rng)


def scale_conditions(raw: np.ndarray, train_raw: np.ndarray) -> np.ndarray:
    """(B, L, C) raw surveys -> the scaled float32 conditions."""
    n = raw.shape[0]
    lo, rng = minmax(train_raw.reshape(train_raw.shape[0], -1))
    flat = (raw.reshape(n, -1).astype(np.float64) - lo) / rng
    return flat.astype(np.float32).reshape(raw.shape)


def ddim_coefficients(diffusion: dict, steps: int) -> list:
    """[(t, c_eps, c_div, c_x0, c_dir)] in loop order (noisiest first)."""
    big_t = diffusion["T"]
    betas = np.linspace(diffusion["beta_start"], diffusion["beta_end"],
                        big_t, dtype=np.float64)
    abar = np.cumprod(1.0 - betas)
    ts = np.round(np.linspace(0.0, big_t - 1, steps)).astype(np.int64)
    out = []
    for j in range(steps - 1, -1, -1):
        ab = abar[ts[j]]
        ab_prev = abar[ts[j - 1]] if j > 0 else 1.0
        out.append((int(ts[j]), np.sqrt(1.0 - ab), np.sqrt(ab),
                    np.sqrt(ab_prev), np.sqrt(1.0 - ab_prev)))
    return out


def ddim(x_t: torch.Tensor, cond: torch.Tensor, w, m: dict, diffusion: dict,
         steps: int, mm=ref_model.matmul_fp32, enc_mm=None) -> torch.Tensor:
    """The (B*R, P) condition-major draws u for (B, L, C) scaled
    conditions from x_T, eta 0; the encoder's products through `enc_mm`
    (`mm` when None), the core's through `mm`."""
    tokens, pooled = ref_model.encode(cond, w, m, enc_mm or mm)
    kvs = ref_model.cross_kv(tokens, w, m, mm)
    x = x_t
    for t, c_eps, c_div, c_x0, c_dir in ddim_coefficients(diffusion, steps):
        eps = ref_model.denoise(x, t, pooled, kvs, w, m, mm)
        x0 = (x - c_eps * eps) / c_div
        x = c_x0 * x0 + c_dir * eps
    return x


def inverse(u: np.ndarray, param_train: np.ndarray,
            limits: np.ndarray = PARAM_LIMITS) -> tuple:
    """u (..., P) -> (physical draws float64, valid mask)."""
    lo, rng = minmax(param_train)
    phys = lo + rng / (1.0 + np.exp(-u.astype(np.float64)))
    valid = ((phys >= limits[:, 0]) & (phys <= limits[:, 1])).all(axis=-1)
    return phys, valid


def stats(phys: np.ndarray, valid: np.ndarray) -> dict:
    """Statistics over the valid draws of (R, B, P) draws, (R, B) mask:
    each (B, P), float64; a condition with no valid draw takes those of
    all its draws; the draws each condition's statistics are over, and
    the valid fraction."""
    phys = phys.astype(np.float64)
    out = {k: np.empty(phys.shape[1:]) for k in STATS}
    out["n"] = np.empty(phys.shape[1])
    for b in range(phys.shape[1]):
        rows = phys[valid[:, b], b] if valid[:, b].any() else phys[:, b]
        out["n"][b] = rows.shape[0]
        out["mean"][b] = rows.mean(axis=0)
        out["std"][b] = rows.std(axis=0)
        for q, key in ((25, "p25"), (50, "p50"), (75, "p75")):
            out[key][b] = np.percentile(rows, q, axis=0)
    out["valid_fraction"] = float(valid.mean())
    return out


def posterior_draws(raw: np.ndarray, train_raw: np.ndarray, x_t, w,
                    m: dict, diffusion: dict, steps: int, members: int,
                    device, mm=ref_model.matmul_fp32, enc_mm=None,
                    block: int = 4) -> np.ndarray:
    """(R, B, P) u draws for raw surveys (B, L, C) from the (B*R, P)
    condition-major x_T, `block` conditions at a time."""
    cond = scale_conditions(raw, train_raw)
    b, p = cond.shape[0], m["param_dim"]
    out = np.empty((members, b, p), np.float32)
    with torch.no_grad():
        for s in range(0, b, block):
            e = min(s + block, b)
            u = ddim(x_t[s * members:e * members].to(device, torch.float32),
                     torch.from_numpy(cond[s:e]).to(device), w, m,
                     diffusion, steps, mm, enc_mm)
            out[:, s:e] = u.reshape(e - s, members, p).transpose(
                0, 1).cpu().numpy()
    return out
