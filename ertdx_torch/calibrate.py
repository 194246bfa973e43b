"""Posterior temperature and guidance calibration on a held-out split.

Mirrors ertdx/calibrate.py: sweep a temperature grid (or a guidance x
temperature grid) on the VALIDATION split, score each arm's posterior
with the coverage objectives of `metrics.uq_scores`, and pick the best,
with the JAX package's records, tie-breaks and NaN rules. Each arm runs
`sample.posterior_over_dataset` on `device` (CUDA unless "cpu" is asked
for).

Every arm sees the same random numbers, as every arm of JAX's sweep
samples from the same key: the arms start from one state of
`generator` (restored before each arm), or take the same injected
per-batch `draws` (the `draws` of `posterior_over_dataset`). `mesh`
passes through to `posterior_over_dataset` (a collective: every rank
calls the calibration alike and gets the same records).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .configs import SampleConfig
from .diffusion import DiffusionSchedule
from .metrics import per_parameter_uq, uq_scores
from .parallel.mesh import check_mesh
from .sample import posterior_over_dataset

DEFAULT_GRID = (1.0, 1.25, 1.5, 2.0, 3.0)
DEFAULT_GUIDANCE_GRID = (0.5, 0.7, 1.0, 1.5)

_OBJECTIVES = ("goodness", "accuracy", "precision")


class _Arms:
    """Runs one grid point after another from the same random numbers."""

    def __init__(self, model, val_conditions, val_true, schedule,
                 param_scaler, n_realizations, batch_size, a, b,
                 generator, draws, device, mesh):
        self.kw = dict(n_realizations=n_realizations,
                       batch_size=batch_size, a=a, b=b, draws=draws,
                       device=device, mesh=mesh)
        self.model, self.schedule = model, schedule
        self.conditions, self.true = val_conditions, val_true
        self.param_scaler = param_scaler
        self.generator = generator
        self.state = generator.get_state() if generator is not None else None

    def __call__(self, run_cfg: SampleConfig) -> dict:
        """One grid point: sample the val posterior, score it."""
        if self.generator is not None:
            self.generator.set_state(self.state)
        pred, mask = posterior_over_dataset(
            self.model, self.conditions, self.schedule, self.param_scaler,
            scfg=run_cfg, generator=self.generator, **self.kw)
        sc = uq_scores(pred, self.true)
        rows = per_parameter_uq(pred, self.true)
        return {"accuracy": float(sc["accuracy"]),
                "precision": float(sc["precision"]),
                "goodness": float(sc["goodness"]),
                "valid_fraction": float(mask.mean()),
                "ensemble_sd_mean": float(pred.std(axis=0).mean()),
                "per_parameter": {
                    "accuracy": [r["Accuracy"] for r in rows],
                    "precision": [r["Precision"] for r in rows],
                    "goodness": [r["Goodness"] for r in rows]}}


def calibrate_temperature(model, val_conditions: np.ndarray,
                          val_true: np.ndarray,
                          schedule: DiffusionSchedule, param_scaler, *,
                          temperatures: Sequence[float] = DEFAULT_GRID,
                          objective: str = "goodness",
                          n_realizations: int = 50,
                          batch_size: int = 32,
                          scfg: Optional[SampleConfig] = None,
                          a: float = 0.0, b: float = 1.0,
                          mesh=None,
                          per_parameter: bool = False,
                          per_parameter_target: Optional[float] = None,
                          per_parameter_tol: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[Sequence[dict]] = None,
                          device=None) -> Tuple[object, Dict[str, dict]]:
    """Pick the sampler temperature maximizing a UQ objective
    (ertdx/calibrate.py:57-145).

    val_conditions: (N, L, C) scaled ERT conditions of the VALIDATION
    split; val_true: (N, P) PHYSICAL true parameters. `objective` is
    'goodness' (default), 'accuracy' or 'precision'; the other sampling
    settings come from `scfg`. Returns (best_temperature, records), the
    records keyed str(temp) -> {accuracy, precision, goodness,
    valid_fraction, ensemble_sd_mean, per_parameter}. Ties break toward
    the LOWEST temperature; NaN scores are skipped, and NaN everywhere
    raises. per_parameter=True picks a per-parameter vector from the
    same sweep (`pick_temperature_per_param`) and runs one verification
    arm with it (records["vector"]); it returns (tuple_of_P, records).
    """
    if objective not in _OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    mesh = check_mesh(mesh)
    base = scfg or SampleConfig(uncertainty_samples=n_realizations)
    val_true = np.asarray(val_true)
    arm = _Arms(model, val_conditions, val_true, schedule, param_scaler,
                n_realizations, batch_size, a, b, generator, draws, device,
                mesh)

    records: Dict[str, dict] = {}
    best_temp, best_val = None, -np.inf
    for temp in temperatures:
        rec = arm(dataclasses.replace(base, temperature=float(temp)))
        records[str(float(temp))] = rec
        score = rec[objective]
        # strict > keeps the earlier winner; a tie prefers the lower
        # temperature whatever the grid order; NaN fails both
        if score > best_val or (score == best_val
                                and best_temp is not None
                                and float(temp) < best_temp):
            best_temp, best_val = float(temp), score
    if best_temp is None:
        raise ValueError(
            f"calibration objective {objective!r} was NaN for every "
            f"temperature in {list(temperatures)!r} — the posterior is "
            "degenerate on this val split (check valid_fraction)")
    if per_parameter:
        vec = pick_temperature_per_param(records, objective,
                                         target=per_parameter_target,
                                         tol=per_parameter_tol)
        rec = arm(dataclasses.replace(base, temperature=tuple(vec)))
        rec["temperature"] = [float(t) for t in vec]
        rec["scalar_winner"] = best_temp
        records["vector"] = rec
        return tuple(float(t) for t in vec), records
    return best_temp, records


def pick_temperature_per_param(records: Dict[str, dict],
                               objective: str,
                               target: Optional[float] = None,
                               tol: float = 0.0) -> np.ndarray:
    """Per-parameter selection over a SCALAR temperature sweep's records
    (ertdx/calibrate.py:148-208). For each parameter j, the LOWEST grid
    temperature whose per_parameter[objective][j] reaches the threshold:
    `target` when given (a parameter that never reaches it falls back to
    its argmax), else that parameter's max less `tol`. Returns a (P,)
    float array."""
    if objective not in _OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    temps, tables = [], []
    for key, rec in records.items():
        try:
            t = float(key)
        except ValueError:
            continue                 # skip non-grid entries ("vector")
        if "per_parameter" not in rec:
            raise ValueError(
                f"record for temperature {key} carries no 'per_parameter' "
                "scores — re-run the sweep with this ertdx version")
        temps.append(t)
        tables.append(np.asarray(rec["per_parameter"][objective],
                                 dtype=np.float64))
    if not temps:
        raise ValueError("records contain no scalar-temperature entries")
    order = np.argsort(temps)        # ascending: first argmax = lowest T
    temps_arr = np.asarray(temps)[order]
    scores = np.stack([tables[i] for i in order])      # (n_temps, P)
    if np.isnan(scores).all(axis=0).any():
        bad = np.where(np.isnan(scores).all(axis=0))[0]
        raise ValueError(
            f"objective {objective!r} is NaN at every grid temperature "
            f"for parameter indices {bad.tolist()}")
    filled = np.where(np.isnan(scores), -np.inf, scores)
    argmax_pick = np.argmax(filled, axis=0)
    thresh = (filled.max(axis=0) - tol) if target is None \
        else np.full(filled.shape[1], float(target))
    meets = filled >= thresh[None, :]
    first_ok = np.where(meets.any(axis=0), np.argmax(meets, axis=0),
                        argmax_pick)
    return temps_arr[first_ok]


def calibrate_guidance(model, val_conditions: np.ndarray,
                       val_true: np.ndarray,
                       schedule: DiffusionSchedule, param_scaler, *,
                       temperatures: Sequence[float] = DEFAULT_GRID,
                       guidance_scales: Sequence[float] =
                       DEFAULT_GUIDANCE_GRID,
                       objective: str = "goodness",
                       n_realizations: int = 50,
                       batch_size: int = 32,
                       scfg: Optional[SampleConfig] = None,
                       a: float = 0.0, b: float = 1.0,
                       mesh=None,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Sequence[dict]] = None,
                       device=None) -> Tuple[Tuple[float, float],
                                             Dict[str, dict]]:
    """Jointly pick (guidance_scale, temperature) maximizing a UQ
    objective on the validation split (ertdx/calibrate.py:211-262).
    Guidance != 1 needs a model trained with uncond_prob > 0; a g == 1
    arm drops any guidance interval (nothing to schedule). Returns
    ((best_guidance, best_temperature), records) with records keyed
    "g{g}_T{t}"; ties break toward the LOWEST temperature, then the
    guidance closest to 1.0, then the lower guidance."""
    if objective not in _OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    mesh = check_mesh(mesh)
    base = scfg or SampleConfig(uncertainty_samples=n_realizations)
    val_true = np.asarray(val_true)
    arm = _Arms(model, val_conditions, val_true, schedule, param_scaler,
                n_realizations, batch_size, a, b, generator, draws, device,
                mesh)

    records: Dict[str, dict] = {}
    for g in guidance_scales:
        for temp in temperatures:
            g, temp = float(g), float(temp)
            run_cfg = dataclasses.replace(base, temperature=temp,
                                          guidance_scale=g)
            if g == 1.0:
                run_cfg = dataclasses.replace(
                    run_cfg, guidance_interval=(0.0, 1.0))
            records[f"g{g}_T{temp}"] = arm(run_cfg)
    return pick_from_records(records, objective), records


def _parse_grid_key(key: str) -> Tuple[float, float]:
    """"g0.7_T1.5" -> (0.7, 1.5)."""
    g_part, t_part = key.split("_T")
    return float(g_part[1:]), float(t_part)


def pick_from_records(records: Dict[str, dict],
                      objective: str) -> Tuple[float, float]:
    """The best (guidance, temperature) of an already-sampled grid (the
    records of `calibrate_guidance`), with its tie-breaks: lowest
    temperature, then guidance closest to 1.0, then lower guidance.
    Raises if the objective is NaN on every point."""
    if objective not in _OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    best, best_val = None, -np.inf
    for key, rec in records.items():
        g, temp = _parse_grid_key(key)
        score = rec[objective]
        better = score > best_val
        if score == best_val and best is not None:
            bg, bt = best
            better = (temp, abs(g - 1.0), g) < (bt, abs(bg - 1.0), bg)
        if better:
            best, best_val = (g, temp), score
    if best is None:
        raise ValueError(
            f"calibration objective {objective!r} was NaN on every "
            f"(guidance, temperature) grid point — the posterior is "
            "degenerate on this val split (check valid_fraction)")
    return best
