"""Dataset preparation, splits and batching in numpy.

Mirrors ertdx/data.py:286-416: the reference prep pipeline (per-column
MinMax over the flattened parameters and over the flattened ERT, the
logit transform of the scaled parameters, feature-last (N, L, C)
conditions), the seeded 80/10/10 split, the seeded epoch shuffle and the
zero-padded tail batch with its weight mask. The trainer moves the
arrays to the device itself (ertdx_torch/train.py).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from .transforms import MinMaxScaler, transform_to_unconstrained


@dataclasses.dataclass
class ERTDataset:
    """Prepared diffusion dataset.

    params_u: (N, P) float32, logit-unconstrained scaled parameters (x0).
    conditions: (N, L, C) float32, min-max scaled ERT, feature-last.
    param_scaler / ert_scaler: the fitted MinMax state (saved with
    checkpoints).
    """

    params_u: np.ndarray
    conditions: np.ndarray
    param_scaler: MinMaxScaler
    ert_scaler: MinMaxScaler
    a: float = 0.0
    b: float = 1.0

    def __len__(self) -> int:
        return self.params_u.shape[0]

    @property
    def param_dim(self) -> int:
        return self.params_u.shape[1]

    @property
    def cond_shape(self) -> Tuple[int, int]:
        return self.conditions.shape[1:]


def prepare_dataset(sim_param: np.ndarray, ert_sim: np.ndarray,
                    a: float = 0.0, b: float = 1.0,
                    param_scaler: Optional[MinMaxScaler] = None,
                    ert_scaler: Optional[MinMaxScaler] = None) -> ERTDataset:
    """sim_param (N, P, 1) or (N, P) and ert_sim (N, L, C) -> ERTDataset.
    Scalers may be passed in (restored from a checkpoint) instead of
    refit."""
    sim_param = np.asarray(sim_param)
    ert_sim = np.asarray(ert_sim)
    if sim_param.ndim == 3 and sim_param.shape[2] == 1:
        raw = np.squeeze(sim_param, axis=2)
    else:
        raw = sim_param.copy()
    n = raw.shape[0]
    if ert_sim.shape[0] != n:
        raise ValueError(f"sim_param has {n} simulations but ert_sim has "
                         f"{ert_sim.shape[0]}")
    if param_scaler is None:
        param_scaler = MinMaxScaler.fit(raw.reshape(n, -1), (a, b))
    scaled = param_scaler.transform(raw.reshape(n, -1)).reshape(raw.shape)
    params_u = transform_to_unconstrained(scaled, a, b).astype(np.float32)
    if ert_scaler is None:
        ert_scaler = MinMaxScaler.fit(ert_sim.reshape(n, -1), (0.0, 1.0))
    cond = ert_scaler.transform(ert_sim.reshape(n, -1)).reshape(
        ert_sim.shape).astype(np.float32)
    return ERTDataset(params_u, cond, param_scaler, ert_scaler, a, b)


def split_dataset(n: int, seed: int = 42,
                  fractions: Tuple[float, float] = (0.8, 0.1)
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded train / val / test index split (numpy PCG64 permutation)."""
    train_size = int(fractions[0] * n)
    val_size = int(fractions[1] * n)
    perm = np.random.default_rng(seed).permutation(n)
    return (perm[:train_size], perm[train_size:train_size + val_size],
            perm[train_size + val_size:])


def batch_iterator(params_u: np.ndarray, conditions: np.ndarray,
                   batch_size: int, *, shuffle: bool, seed: int = 0,
                   epoch: int = 0, drop_remainder: bool = False
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(x0, cond) numpy batches in a seeded per-epoch order."""
    n = params_u.shape[0]
    order = np.arange(n)
    if shuffle:
        order = np.random.default_rng(
            np.random.SeedSequence([seed, epoch])).permutation(n)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for s in range(0, stop, batch_size):
        idx = order[s:s + batch_size]
        yield params_u[idx], conditions[idx]


def pad_batch(x0: np.ndarray, cond: np.ndarray, batch_size: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Zero-pad a ragged tail batch to `batch_size`; returns the weight
    mask (1 for real rows, 0 for padding)."""
    b = x0.shape[0]
    if b == batch_size:
        return x0, cond, np.ones(batch_size, np.float32)
    pad = batch_size - b
    x0p = np.concatenate([x0, np.zeros((pad,) + x0.shape[1:], x0.dtype)])
    condp = np.concatenate(
        [cond, np.zeros((pad,) + cond.shape[1:], cond.dtype)])
    w = np.concatenate([np.ones(b, np.float32), np.zeros(pad, np.float32)])
    return x0p, condp, w
