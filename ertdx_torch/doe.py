"""Quasi-MC training designs over the parameter bounds (numpy and scipy).

A jax-free copy of `SurrogateDataGenerator` (ertdx/doe.py:106-138;
reference: Generate_ERT_utils.py:484-520): Latin-hypercube or scrambled
Sobol points in the unit cube, scaled to the effective bounds, with
log10 space for the log-distributed parameters. The same seed gives the
JAX package's design.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.stats import qmc

from .params import ParameterSpace


class SurrogateDataGenerator:
    """LHS / scrambled-Sobol designs of physical parameter vectors."""

    def __init__(self, space: Optional[ParameterSpace] = None,
                 seed: Optional[int] = None):
        self.space = space or ParameterSpace()
        self.seed = seed

    def generate_training_samples(self, n_samples: int,
                                  method: str = "lhs") -> np.ndarray:
        """(n_samples, P) physical parameter vectors."""
        d = self.space.dim
        if method == "lhs":
            sampler = qmc.LatinHypercube(d=d, seed=self.seed)
        elif method == "sobol":
            sampler = qmc.Sobol(d=d, scramble=True, seed=self.seed)
        else:
            raise ValueError("Method must be 'lhs' or 'sobol'")
        unit = sampler.random(n=n_samples)
        lo, hi = self.space.effective_bounds()
        scaled = lo + (hi - lo) * unit
        return np.where(self.space.log_mask, 10.0 ** scaled, scaled)
