"""What decides `correct`: the program's answers against the plain
reference, on a sample of the calls the window finished.

The reference (`reference/`) recomputes each sampled call from the raw
surveys, the training arrays and the prior draw the benchmark made, and
the seed's weights: scaling, encoder, cross K/V, DDIM, inverse and
statistics, in float32. The numbers compared, each against its limit in
the cell's file, are gaps in units of each parameter's span (the
parameter scaler's range, so a gap is one in the sigmoid's [0, 1]):

* `stats_gap`: the largest gap of a statistic (mean, std, p25, p50, p75
  over the valid members) of any survey and parameter, and of the valid
  fraction;
* `mean_z`: the largest gap of a survey's mean in units of the
  reference's standard error of that mean (its std over the square root
  of the draws it is over): rounding moves a mean by a small part of its
  standard error, while a mean over other or fewer members (half of
  them, another survey's) moves it by about one or more;
* `draws_rms` (where the entry returns its draws): the rms gap of the
  draws.

A value that is not finite fails. `control` puts the reference computed
at the configuration's control precisions in the program's place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .reference import model as ref_model
from .reference import sampler as ref

PRECISIONS = {"fp32": ref_model.matmul_fp32, "tf32": ref_model.mm_tf32,
              "bf16": ref_model.mm_bf16, "fp8": ref_model.mm_fp8}


def sample_calls(done: List[int], n: int, seed: int) -> List[int]:
    """n of the finished calls, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 7])
    pick = rng.choice(len(done), size=min(n, len(done)), replace=False)
    return sorted(done[int(k)] for k in pick)


def answer_stats(entry: str, out) -> tuple:
    """(statistics, draws or None) of an entry's answer."""
    if entry == "service":
        st = {k: np.asarray(out[k], np.float64) for k in ref.STATS}
        st["valid_fraction"] = float(out["valid_fraction"])
        return st, None
    pred, mask = out
    return ref.stats(pred, mask), np.asarray(pred, np.float64)


def _worst(g: np.ndarray) -> float:
    return float(g.max()) if np.isfinite(g).all() else float("inf")


def gaps(got: dict, got_draws, want: dict, want_draws,
         span: np.ndarray) -> Dict[str, float]:
    worst = abs(got["valid_fraction"] - want["valid_fraction"])
    for k in ref.STATS:
        worst = max(worst, _worst(np.abs(got[k] - want[k]) / span))
    se = want["std"] / np.sqrt(want["n"])[:, None]
    dm = np.abs(got["mean"] - want["mean"])
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.where(dm == 0, 0.0, dm / se)
    out = {"stats_gap": worst, "mean_z": _worst(z)}
    if got_draws is not None:
        d = (got_draws - want_draws) / span
        out["draws_rms"] = (float(np.sqrt(np.mean(d * d)))
                            if np.isfinite(d).all() else float("inf"))
    return out


@dataclasses.dataclass
class Inputs:
    """What the benchmark made from the seed and hands to both sides."""
    weights: Dict[str, torch.Tensor]
    train_raw: np.ndarray
    train_params: np.ndarray
    raw_pool: np.ndarray
    priors: torch.Tensor

    @property
    def span(self) -> np.ndarray:
        return ref.minmax(self.train_params)[1]


def reference_answer(cell, inputs: Inputs, rows: slice, prior: int,
                     device, mm=ref_model.matmul_fp32, enc_mm=None):
    """The plain computation of one call: (statistics, draws)."""
    cfg = cell.config["config"]
    m, tr = cell.model, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    u = ref.posterior_draws(
        inputs.raw_pool[rows], inputs.train_raw, inputs.priors[prior],
        inputs.weights, m, cfg["diffusion"], cfg["sample"]["ddim_steps"],
        tr["members"], device, mm=mm, enc_mm=enc_mm,
        block=cell.check["block"])
    phys, valid = ref.inverse(u, inputs.train_params)
    return ref.stats(phys, valid), phys


def compare(cell, inputs: Inputs, answers: dict, indices: List[int],
            locate, device) -> Dict[str, float]:
    """The worst of each number over the sampled calls; `locate(i)` gives
    call i's (survey rows, prior block)."""
    entry = cell.traffic["entry"]
    return _worst_gaps(cell, inputs, indices, locate, device,
                       lambda i: answer_stats(entry, answers[i]))


def control(cell, inputs: Inputs, indices: List[int], locate,
            device, lo: Dict[str, str] = None) -> Dict[str, float]:
    """The same numbers with the reference at the configuration's control
    precisions (its "control": encoder and core products; `lo` in its
    place, to lower one part alone) in the program's place."""
    lo = lo or cell.config["control"]
    draws = cell.traffic["entry"] != "service"

    def answer(i):
        st, phys = reference_answer(cell, inputs, *locate(i), device,
                                    mm=PRECISIONS[lo["core"]],
                                    enc_mm=PRECISIONS[lo["encoder"]])
        return st, phys if draws else None

    return _worst_gaps(cell, inputs, indices, locate, device, answer)


def _worst_gaps(cell, inputs: Inputs, indices: List[int], locate, device,
                answer) -> Dict[str, float]:
    """The worst of each gap between `answer(i)` ((statistics, draws or
    None)) and the reference over the calls `indices`."""
    worst: Dict[str, float] = {}
    for i in indices:
        got, got_draws = answer(i)
        want, want_draws = reference_answer(cell, inputs, *locate(i),
                                            device)
        for k, v in gaps(got, got_draws, want, want_draws,
                         inputs.span).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            failed: int) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit, every number of the limits read, and no failed call."""
    table = {k: {"value": numbers.get(k, float("nan")), "limit": v}
             for k, v in limits.items()}
    ok = failed == 0 and all(
        np.isfinite(t["value"]) and t["value"] <= t["limit"]
        for t in table.values())
    return ok, table
