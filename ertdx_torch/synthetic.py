"""Synthetic Gaussian resistivity fields (BASELINE.json configs[1]).

Stationary Gaussian random fields via FFT spectral synthesis: white noise
shaped by a squared-exponential power spectrum, exponentiated to get
log-normal "resistivity" if requested. Host-side numpy, a copy of
ertdx/synthetic.py (the same seed gives the same bytes); training and
sampling of the DDPM on these fields (models/uncond.py) run on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def gaussian_random_fields(n: int, grid: Tuple[int, int] = (16, 16),
                           length_scale: float = 0.25,
                           mean: float = 0.0, std: float = 1.0,
                           log_normal: bool = False,
                           seed: Optional[int] = None) -> np.ndarray:
    """Sample n stationary GRFs on a (H, W) grid; returns (n, H*W).

    Spectral synthesis: F^-1[ sqrt(S(k)) * F[white noise] ] with a
    squared-exponential spectrum S(k) = exp(-(|k| * ls)^2 / 2).
    """
    h, w = grid
    rng = np.random.default_rng(seed)
    ky = np.fft.fftfreq(h)[:, None]
    kx = np.fft.fftfreq(w)[None, :]
    k2 = (kx ** 2 + ky ** 2) * (length_scale * max(h, w)) ** 2
    amp = np.exp(-k2 / 2.0)
    amp[0, 0] = 0.0  # zero-mean before shifting

    noise = rng.normal(size=(n, h, w))
    spec = np.fft.fft2(noise, axes=(1, 2)) * amp[None]
    fields = np.fft.ifft2(spec, axes=(1, 2)).real
    flat = fields.reshape(n, h * w)
    cur_std = flat.std()
    if cur_std > 0:
        flat = flat / cur_std * std
    flat = flat + mean
    if log_normal:
        flat = np.exp(flat)
    return flat


def make_unconditional_dataset(n: int = 2048, grid: Tuple[int, int] = (16, 16),
                               length_scale: float = 0.25,
                               seed: Optional[int] = 0):
    """Fields + a dummy condition placeholder so the conditional train/sample
    stack runs unchanged with models.uncond.UncondMLP."""
    fields = gaussian_random_fields(n, grid, length_scale,
                                    seed=seed).astype(np.float32)
    dummy_cond = np.zeros((n, 1, 1), np.float32)
    return fields, dummy_cond


def make_unconditional_ertdataset(n: int = 2048,
                                  grid: Tuple[int, int] = (16, 16),
                                  length_scale: float = 0.25,
                                  seed: Optional[int] = 0):
    """ERTDataset wrapper: fields are already ~N(0,1), so the diffusion
    target space IS the data space (identity scalers; no logit)."""
    from .data import ERTDataset
    from .transforms import MinMaxScaler

    fields, dummy_cond = make_unconditional_dataset(n, grid, length_scale,
                                                    seed)
    d = fields.shape[1]
    identity = MinMaxScaler(np.zeros(d), np.ones(d))
    cond_identity = MinMaxScaler(np.zeros(1), np.ones(1))
    return ERTDataset(fields, dummy_cond, identity, cond_identity)
