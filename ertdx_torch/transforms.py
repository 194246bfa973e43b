"""Transforms and scalers on torch tensors or numpy arrays.

Mirrors ertdx/transforms.py:32-201: the logit reparameterization with its
1e-6 clamp and its sigmoid inverse, the per-feature MinMax scaler with
explicit state, the physical <-> unit-interval `ParameterScaler` against
the parameter bounds (log10 space for the log-distributed parameters),
and the parameter-bounds mask and filter. A torch tensor stays a tensor
on its device; a numpy array stays numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from .params import ParameterSpace

Array = Union[np.ndarray, torch.Tensor]

_LOGIT_EPS = 1e-6


def transform_to_unconstrained(x: Array, a: float = 0.0, b: float = 1.0,
                               eps: float = _LOGIT_EPS) -> Array:
    """x in [a, b] -> log(x_n / (1 - x_n)), x_n clamped to [eps, 1-eps]."""
    x_norm = (x - a) / (b - a)
    if isinstance(x, torch.Tensor):
        x_norm = x_norm.clamp(eps, 1.0 - eps)
        return torch.log(x_norm / (1.0 - x_norm))
    x_norm = np.clip(x_norm, eps, 1.0 - eps)
    return np.log(x_norm / (1.0 - x_norm))


def inverse_transform(u: Array, a: float = 0.0, b: float = 1.0) -> Array:
    """The sigmoid inverse of `transform_to_unconstrained`:
    a + (b - a) sigmoid(u)."""
    if isinstance(u, torch.Tensor):
        return a + (b - a) * torch.sigmoid(u)
    un = np.asarray(u)
    e = np.exp(-np.abs(un))          # exp never sees a positive argument
    sig = np.where(un >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
    return a + (b - a) * sig


@dataclasses.dataclass(frozen=True)
class MinMaxScaler:
    """Per-feature min-max scaler (sklearn semantics) with numpy state.

    Columns with zero range scale by 1, as sklearn does."""

    data_min: np.ndarray
    data_max: np.ndarray
    feature_range: Tuple[float, float] = (0.0, 1.0)

    @classmethod
    def fit(cls, x, feature_range: Tuple[float, float] = (0.0, 1.0)
            ) -> "MinMaxScaler":
        x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(
                f"MinMaxScaler.fit expects 2-D input, got {x.shape}")
        return cls(x.min(axis=0), x.max(axis=0), feature_range)

    def _scale_shift(self, like: Array):
        lo, hi = self.feature_range
        dmin = np.asarray(self.data_min, dtype=np.float64)
        rng = np.asarray(self.data_max, dtype=np.float64) - dmin
        scale = (hi - lo) / np.where(rng == 0, 1.0, rng)
        shift = lo - dmin * scale
        if isinstance(like, torch.Tensor):
            return (torch.as_tensor(scale, dtype=like.dtype,
                                    device=like.device),
                    torch.as_tensor(shift, dtype=like.dtype,
                                    device=like.device))
        return scale, shift

    def transform(self, x: Array) -> Array:
        scale, shift = self._scale_shift(x)
        return x * scale + shift

    def inverse(self, y: Array) -> Array:
        scale, shift = self._scale_shift(y)
        return (y - shift) / scale

    def state_dict(self) -> dict:
        """numpy state with the JAX scaler's keys (scalers.npz)."""
        return {
            "data_min": np.asarray(self.data_min),
            "data_max": np.asarray(self.data_max),
            "feature_range": np.asarray(self.feature_range,
                                        dtype=np.float64),
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "MinMaxScaler":
        fr = tuple(float(v) for v in np.asarray(d["feature_range"]))
        return cls(np.asarray(d["data_min"]), np.asarray(d["data_max"]), fr)


@dataclasses.dataclass(frozen=True)
class ParameterScaler:
    """Physical <-> unit-interval scaling against the parameter bounds
    (ertdx/transforms.py:127-171): linear min-max per parameter, min-max
    in log10 space for the log-distributed ones; `descale` clamps to the
    physical bounds and with `warn` (numpy only) prints one line per
    clamped value, as the reference does. Works over any leading batch
    dims, on numpy arrays or torch tensors."""

    space: ParameterSpace = dataclasses.field(default_factory=ParameterSpace)

    def _bounds(self, like: Array):
        lo, hi = self.space.effective_bounds()
        islog = self.space.log_mask
        if isinstance(like, torch.Tensor):
            def t(a):
                return torch.as_tensor(a, dtype=like.dtype,
                                       device=like.device)
            return t(lo), t(hi), torch.as_tensor(islog, device=like.device)
        return lo, hi, islog

    def scale(self, pm: Array) -> Array:
        """Physical (..., 29) -> unit interval [0, 1]."""
        lo, hi, islog = self._bounds(pm)
        if isinstance(pm, torch.Tensor):
            x = torch.where(islog, torch.log10(torch.where(
                islog, pm, torch.ones_like(pm))), pm)
        else:
            x = np.where(islog, np.log10(np.where(islog, pm, 1.0)), pm)
        return (x - lo) / (hi - lo)

    def descale(self, u: Array, warn: bool = False) -> Array:
        """Unit interval (..., 29) -> physical, clamped to the bounds."""
        lo, hi, islog = self._bounds(u)
        y = lo + (hi - lo) * u
        if isinstance(u, torch.Tensor):
            pm = torch.where(islog, torch.pow(10.0, y), y)
            plo = torch.as_tensor(self.space.lo, dtype=pm.dtype,
                                  device=pm.device)
            phi = torch.as_tensor(self.space.hi, dtype=pm.dtype,
                                  device=pm.device)
            return torch.minimum(torch.maximum(pm, plo), phi)
        pm = np.where(islog, np.power(10.0, y), y)
        plo, phi = self.space.lo, self.space.hi
        if warn:
            for idx in np.argwhere(pm < plo):
                i = idx[-1]
                print(f"Warning: Parameter {i} is set to the minimum "
                      f"allowable of {plo[i]}")
            for idx in np.argwhere(pm > phi):
                i = idx[-1]
                print(f"Warning: Parameter {i} is set to the maximum "
                      f"allowable of {phi[i]}")
        return np.clip(pm, plo, phi)


def param_bounds_mask(param: Array, limits) -> Array:
    """Row-validity mask: True where every parameter is inside its bounds."""
    if isinstance(param, torch.Tensor):
        lim = torch.as_tensor(np.asarray(limits), dtype=param.dtype,
                              device=param.device)
        return ((param >= lim[:, 0]) & (param <= lim[:, 1])).all(dim=-1)
    limits = np.asarray(limits)
    return ((param >= limits[:, 0]) & (param <= limits[:, 1])).all(axis=-1)


def check_param_bounds(param, limits, verbose: bool = True):
    """Keep the (B, P) rows fully inside the limits; None if there are none
    (the reference's row filter, as in ertdx/transforms.py:166-193)."""
    param = np.asarray(param)
    limits = np.asarray(limits)
    mask = np.asarray(param_bounds_mask(param, limits))
    if verbose:
        for b in np.nonzero(~mask)[0]:
            bad = np.nonzero((param[b] < limits[:, 0])
                             | (param[b] > limits[:, 1]))[0]
            i = int(bad[0])
            print(f"Sample {b} Parameter {i}: {param[b, i]:.4f} (out of "
                  f"bounds [{limits[i, 0]:.4f}, {limits[i, 1]:.4f}])")
    if not mask.any():
        return None
    return param[mask]
