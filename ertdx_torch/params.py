"""The 29-dimensional Hanford-site parameter space: bounds, log flags, names.

A copy of ertdx/params.py:101-164 (the port may not import ertdx): the
(29, 2) physical limits, the indices of the log10-distributed parameters
and the display names, as pure numpy data, with the reference-API shims
`ParameterLimits` and `ParameterNames`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

PARAM_DIM = 29

# (29, 2) [min, max] bounds. Reference: Generate_ERT_utils.py:16-59.
_PLIMS = np.array(
    [
        # Material 1 — Hanford Formation
        [0.05, 0.35],    # porosity
        [2e-13, 1e-7],   # horizontal permeability [m^2]
        [0.2, 1.0],      # vertical/horizontal permeability ratio
        [1.1, 2.1],      # Archie's cementation exponent
        [1.6, 2.6],      # Archie's saturation exponent
        [0.8, 1.2],      # Archie's tortuosity constant
        # Material 2 — Ringold Formation
        [0.2, 0.5],
        [1e-12, 1e-8],
        [0.2, 1.0],
        [1.1, 2.1],
        [1.6, 2.6],
        [0.8, 1.2],
        # Material 3 — Pit
        [0.05, 0.35],
        [2e-13, 1e-7],
        [0.2, 1.0],
        [1.1, 2.1],
        [1.6, 2.6],
        [0.8, 1.2],
        # Van Genuchten
        [2e-5, 9e-3],    # Hanford Fm VG-Alpha [1/m]
        [0.2, 0.65],     # Hanford Fm VG-M
        [0.0055, 0.24],  # Hanford Fm liquid residual saturation
        [1e-5, 8e-3],    # Ringold Fm VG-Alpha [1/m]
        [0.16, 0.8],     # Ringold Fm VG-M
        [0.02, 0.2],     # Ringold Fm liquid residual saturation
        # Surface electrical conductivities [S/m]
        [1e-5, 1e-2],
        [1e-5, 1e-2],
        [1e-5, 1e-2],
        # Water conductivities [S/m]
        [0.005, 0.1],    # native pore water
        [0.005, 0.1],    # flush water
    ],
    dtype=np.float64,
)

# Indices of log10-distributed parameters. Reference: Generate_ERT_utils.py:12.
_LOGPARMS: Tuple[int, ...] = (1, 7, 13, 18, 21, 24, 25, 26, 27, 28)

# Display names with LaTeX units. Reference: Generate_ERT_utils.py:67-96.
_NAMES: Tuple[str, ...] = (
    "Hanford Fm porosity",
    "Hanford Fm horizontal permeability [$m^2$]",
    "Hanford Fm vertical/horiz. perm. ratio",
    "Hanford Fm Archie's law cementation exponent",
    "Hanford Fm Archie's law saturation exponent",
    "Hanford Fm Archie's law tortuosity constant",
    "Ringold Fm unit porosity",
    "Ringold Fm horizontal permeability [$m^2$]",
    "Ringold Fm vertical/horiz. perm. ratio",
    "Ringold Fm Archie's law cementation exponent",
    "Ringold Fm Archie's law saturation exponent",
    "Ringold Fm Archie's law tortuosity constant",
    "Pit porosity",
    "Pit horizontal permeability [$m^2$]",
    "Pit vertical/horiz. perm. ratio",
    "Pit Archie's law cementation exponent",
    "Pit Archie's law saturation exponent",
    "Pit Archie's law tortuosity constant",
    "Hanford Fm and Pit  VG-Alpha [$1/m$]",
    "Hanford Fm and Pit  VG-M",
    "Hanford Fm and Pit residual saturation",
    "Ringold Fm VG-Alpha [$1/m$]",
    "Ringold Fm VG-M",
    "Ringold Fm residual saturation",
    "Hanford Fm surface electrical conductivity [$S/m$]",
    "Ringold Fm surface electrical conductivity [$S/m$]",
    "Pit surface electrical conductivity [$S/m$]",
    "Native pore water conductivity [$S/m$]",
    "Flush water conductivity [$S/m$]",
)


@dataclasses.dataclass(frozen=True)
class ParameterSpace:
    """Immutable view of the 29-d parameter space.

    Attributes:
      plims: (29, 2) float64 [min, max] physical bounds.
      logparms: indices of log10-distributed parameters.
      names: human-readable parameter names.
    """

    plims: np.ndarray = dataclasses.field(
        default_factory=lambda: _PLIMS.copy())
    logparms: Tuple[int, ...] = _LOGPARMS
    names: Tuple[str, ...] = _NAMES

    @property
    def dim(self) -> int:
        return int(self.plims.shape[0])

    @property
    def log_mask(self) -> np.ndarray:
        """Boolean (dim,) mask, True where the parameter is log-distributed."""
        m = np.zeros(self.dim, dtype=bool)
        m[list(self.logparms)] = True
        return m

    @property
    def lo(self) -> np.ndarray:
        return self.plims[:, 0]

    @property
    def hi(self) -> np.ndarray:
        return self.plims[:, 1]

    def effective_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Bounds in the space scaling operates in: log10 for log params."""
        lo = np.where(self.log_mask, np.log10(self.lo), self.lo)
        hi = np.where(self.log_mask, np.log10(self.hi), self.hi)
        return lo, hi

    def contains(self, pm: np.ndarray) -> np.ndarray:
        """Row-wise in-bounds mask for (..., dim) physical parameters."""
        pm = np.asarray(pm)
        ok = (pm >= self.lo) & (pm <= self.hi)
        return ok.all(axis=-1)


def default_space() -> ParameterSpace:
    return ParameterSpace()


class ParameterLimits:
    """Compatibility shim mirroring the reference's parameter limits."""

    def __init__(self):
        self.plims = _PLIMS.copy()
        self.logparms = list(_LOGPARMS)


class ParameterNames:
    """Compatibility shim mirroring the reference's parameter names."""

    def __init__(self):
        self.names = list(_NAMES)
