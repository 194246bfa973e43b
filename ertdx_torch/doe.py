"""Design-of-experiments sampling of the parameter space (numpy, scipy).

Jax-free copies of ertdx/doe.py:28-138 (reference:
Generate_ERT_utils.py:145-192, 484-520). `ParameterSampler` draws
uniform / log-uniform single vectors and Gaussian perturbation ensembles
with per-parameter rejection resampling (the reference's log-space rule
sd = |log10(mean) * sd / mean|) from an injected numpy Generator.
`SurrogateDataGenerator` makes Latin-hypercube or scrambled Sobol points
in the unit cube, scaled to the effective bounds, with log10 space for
the log-distributed parameters. The same seed or Generator state gives
the JAX package's draws.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.stats import qmc

from .params import ParameterSpace


class ParameterSampler:
    """Random draws from the parameter space (uniform / Gaussian
    ensemble)."""

    def __init__(self, space: Optional[ParameterSpace] = None,
                 rng: Optional[np.random.Generator] = None):
        self.space = space or ParameterSpace()
        self.rng = rng or np.random.default_rng()

    def get_mean_parameters(self) -> np.ndarray:
        """Arithmetic mid-point of each parameter's bounds (a plain
        average, for the log parameters too, as the reference)."""
        return self.space.plims.mean(axis=1)

    def sample(self) -> np.ndarray:
        """One uniform draw; log-uniform on the log parameters."""
        lo, hi = self.space.effective_bounds()
        u = self.rng.uniform(lo, hi)
        pm = np.where(self.space.log_mask, 10.0 ** u, u)
        return np.clip(pm, self.space.lo, self.space.hi)

    def build_mod_in(self, pmeans: np.ndarray, psdevs, nmods: int,
                     max_attempts: int = 10_000) -> np.ndarray:
        """Gaussian perturbation ensemble; row 0 is the mean vector.

        Per-parameter rejection resampling until in bounds. A log
        parameter draws 10**Normal(log10(mean), |log10(mean) sd / mean|).
        """
        d = self.space.dim
        pmeans = np.asarray(pmeans, dtype=np.float64)
        if np.isscalar(psdevs) or isinstance(psdevs, (float, int)):
            psdevs = np.full(d, float(psdevs))
        psdevs = np.asarray(psdevs, dtype=np.float64)

        islog = self.space.log_mask
        safe_means = np.where(islog, pmeans, 1.0)
        log_mu = np.log10(safe_means)
        log_sd = np.where(islog, np.abs(log_mu * psdevs / safe_means), 0.0)

        mod_in = np.zeros((nmods, d))
        mod_in[0] = pmeans
        lo, hi = self.space.lo, self.space.hi

        n_rows = nmods - 1
        if n_rows <= 0:
            return mod_in
        vals = np.empty((n_rows, d))
        failed = np.ones((n_rows, d), dtype=bool)
        for _ in range(max_attempts):
            idx = np.nonzero(failed)
            if idx[0].size == 0:
                break
            lin = self.rng.normal(pmeans[idx[1]], psdevs[idx[1]])
            # wild draws would overflow 10**x; they are rejected anyway
            logd = 10.0 ** np.clip(
                self.rng.normal(log_mu[idx[1]], log_sd[idx[1]]), -300, 300)
            draw = np.where(islog[idx[1]], logd, lin)
            vals[idx] = draw
            failed[idx] = ~((draw > lo[idx[1]]) & (draw < hi[idx[1]]))
        if failed.any():
            raise RuntimeError(
                "build_mod_in: rejection sampling did not converge within "
                f"{max_attempts} attempts; check psdevs vs bounds")
        mod_in[1:] = vals
        return mod_in


class SurrogateDataGenerator:
    """LHS / scrambled-Sobol designs of physical parameter vectors."""

    def __init__(self, space: Optional[ParameterSpace] = None,
                 seed: Optional[int] = None):
        self.space = space or ParameterSpace()
        self.seed = seed

    def generate_training_samples(self, n_samples: int, method: str = "lhs",
                                  plot_diagnostics: bool = False,
                                  output_dir: str = ".") -> np.ndarray:
        """(n_samples, P) physical parameter vectors; with
        `plot_diagnostics` also the sampling diagnostics figures in
        `output_dir` (plots.py, which needs matplotlib)."""
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
        parameters = np.where(self.space.log_mask, 10.0 ** scaled, scaled)
        if plot_diagnostics:
            from . import plots
            plots.plot_sampling_diagnostics(parameters, output_dir=output_dir)
        return parameters
