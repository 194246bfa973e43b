"""Posterior-ensemble sampling on the port.

Mirrors ertdx/sample.py:79-568: the condition is encoded ONCE per run, all
realizations fold into the chain axis in condition-major order
(chain = b * R + r), and the denoiser core runs on the fused CUDA kernels
whenever `mega_plan` engages them, else on the per-block module path
(whose attention goes through ops/ensemble_attn.py with
`ensemble_pallas`). Every sampler of the JAX package is here: ancestral
(the default), DDIM, pd and DPM-Solver++(2M), with classifier-free
guidance, limited-interval guidance, and the dataset drivers
`posterior_over_dataset` and `posterior_over_dataset_mixture`. Draws come
out as (R, B, P).

Random draws come from a `torch.Generator`, or are injected (`x_T`,
`noise`, and per batch or per member in the drivers), so that a test can
hand the port JAX's own draws.

A bfloat16 model (ModelConfig.dtype) samples here too: the condition
enters in float32 and its encoder casts it; the fused core computes in
float32 (models/mega.py), and the draws and the inverse pipeline stay
float32. The entry points run under `precision.fp32_precision` (no TF32
in cuBLAS or cuDNN).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import resolve_device, transforms
from .configs import SampleConfig
from .diffusion import (DiffusionSchedule, as_eps_denoiser, sample_ancestral,
                        sample_ddim, sample_dpmpp_2m, sample_pd)
from .models.mega import mega_denoise_ensemble, mega_plan, mega_weights
from .params import ParameterSpace
from .precision import fp32_precision

SAMPLERS = ("ancestral", "ddim", "dpmpp", "pd")


def _check_config(model, scfg: SampleConfig, truncate_steps) -> tuple:
    """JAX's refusals (ertdx/sample.py:104-174); returns (guided,
    interval)."""
    if scfg.sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {scfg.sampler!r} "
                         "(expected 'ancestral', 'ddim', 'dpmpp' or 'pd')")
    if truncate_steps is not None and scfg.sampler != "ancestral":
        raise ValueError("truncate_steps is the reference's ancestral "
                         "compat mode; use ddim_steps/dpmpp_steps for "
                         f"the {scfg.sampler!r} sampler's step budget")
    interval = tuple(scfg.guidance_interval)
    guided = float(scfg.guidance_scale) != 1.0
    if guided and getattr(model, "uncond_prob", 0.0) <= 0.0:
        raise ValueError(
            "guidance_scale != 1 requires a model trained with condition "
            "dropout (ModelConfig.uncond_prob > 0, classifier-free "
            "guidance)")
    if interval != (0.0, 1.0):
        if not 0.0 <= interval[0] < interval[1] <= 1.0:
            raise ValueError(f"guidance_interval must satisfy 0 <= lo < "
                             f"hi <= 1, got {interval}")
        if not guided:
            raise ValueError("guidance_interval is set but "
                             "guidance_scale == 1 (nothing to schedule)")
    return guided, interval


def _run_sampler(scfg: SampleConfig, denoise, shape, schedule,
                 temperature, truncate_steps, generator, x_T, noise, dev):
    """The sampler `scfg` names, its step budget clamped to T. pd and
    dpmpp draw no per-step noise, so `noise` raises there."""
    big_t = schedule.num_steps
    kw = dict(generator=generator, x_T=x_T, device=dev)
    if scfg.sampler in ("pd", "dpmpp") and noise is not None:
        raise ValueError(f"the {scfg.sampler!r} sampler draws no per-step "
                         "noise")
    if scfg.sampler == "pd":
        return sample_pd(denoise, shape, schedule, min(scfg.pd_steps, big_t),
                         temperature, **kw)
    if scfg.sampler == "dpmpp":
        return sample_dpmpp_2m(denoise, shape, schedule,
                               min(scfg.dpmpp_steps, big_t), temperature,
                               **kw)
    if scfg.sampler == "ddim":
        return sample_ddim(denoise, shape, schedule,
                           min(scfg.ddim_steps, big_t), eta=scfg.ddim_eta,
                           temperature=temperature, noise=noise, **kw)
    return sample_ancestral(denoise, shape, schedule, truncate_steps,
                            temperature, noise=noise, **kw)


@fp32_precision()
def posterior_ensemble(model, condition, schedule: DiffusionSchedule,
                       n_realizations: int = 50,
                       scfg: Optional[SampleConfig] = None, *,
                       generator: Optional[torch.Generator] = None,
                       x_T: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None,
                       param_dim: Optional[int] = None,
                       truncate_steps: Optional[int] = None,
                       device=None) -> torch.Tensor:
    """Sample (n_realizations, B, P) unconstrained parameter draws for the
    (B, L, C) `condition`, on `device` (CUDA unless "cpu" is asked for).

    `scfg` defaults to `SampleConfig(uncertainty_samples=n_realizations)`:
    the ancestral chain over all T steps, as in JAX. `x_T`
    ((R*B, P), condition-major) replaces the prior draw and `noise`
    ((steps, R*B, P)) the per-step draws of ancestral and DDIM, so a
    caller can inject another framework's; otherwise both come from
    `generator`. With `guidance_scale != 1` every step combines
    eps_u + g (eps_c - eps_u), the null context running through the same
    path as the condition; with a `guidance_interval` (lo, hi) only the
    steps with round(lo T) <= t < round(hi T) are guided and the others
    skip the null pass (the decision reads t[0] on the host, one
    synchronisation per step)."""
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type or (dev.index is not None
                                      and model_dev != dev):
        raise ValueError(f"model is on {model_dev}, sampling asked for "
                         f"{dev}")
    dev = model_dev
    scfg = scfg or SampleConfig(uncertainty_samples=n_realizations)
    guided, interval = _check_config(model, scfg, truncate_steps)
    p = param_dim or model.param_dim
    temperature = torch.as_tensor(scfg.temperature, dtype=torch.float32)
    if temperature.ndim not in (0, 1) or (
            temperature.ndim == 1 and temperature.shape[0] != p):
        raise ValueError(
            f"temperature must be a scalar or a length-{p} (param_dim) "
            f"vector, got shape {tuple(temperature.shape)}")
    if temperature.ndim == 0:
        temperature = float(temperature)

    condition = torch.as_tensor(condition, dtype=torch.float32).to(dev)
    b = condition.shape[0]
    r = n_realizations
    big_t = schedule.num_steps
    with torch.no_grad():
        cond_ctx = model.encode_condition(condition)
        plan = mega_plan(model, r, b, cond_len=condition.shape[1],
                         device=dev)
        weights = mega_weights(model) if plan is not None else None

        def mk(ctx):
            """The denoiser for one context, on the fused core or the
            per-block module path."""
            if plan is not None:
                return lambda x, t: mega_denoise_ensemble(
                    model, x, t, ctx, r, weights=weights, **plan)
            return lambda x, t: model.denoise_ensemble(x, t, ctx, r)

        if guided:
            g = float(scfg.guidance_scale)
            null_ctx = model.drop_condition(
                cond_ctx, torch.ones(b, dtype=torch.bool, device=dev))
            fn_c, fn_u = mk(cond_ctx), mk(null_ctx)

            def guided_fn(x, t):
                eps_u = fn_u(x, t)
                return eps_u + g * (fn_c(x, t) - eps_u)

            if interval == (0.0, 1.0):
                denoise = guided_fn
            else:
                lo_idx = int(round(interval[0] * big_t))
                hi_idx = int(round(interval[1] * big_t))

                def denoise(x, t):
                    t0 = int(t[0])
                    return (guided_fn(x, t) if lo_idx <= t0 < hi_idx
                            else fn_c(x, t))
        else:
            denoise = mk(cond_ctx)

        denoise = as_eps_denoiser(denoise, schedule.alpha_bar,
                                  model.parameterization)
        u = _run_sampler(scfg, denoise, (r * b, p), schedule, temperature,
                         truncate_steps, generator, x_T, noise, dev)
    return u.reshape(b, r, p).transpose(0, 1)


def inverse_pipeline(u, param_scaler, a: float = 0.0, b: float = 1.0,
                     space: Optional[ParameterSpace] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Unconstrained draws -> physical parameters and a row-validity mask,
    on the host: sigmoid inverse -> MinMax inverse -> bounds mask."""
    space = space or ParameterSpace()
    x = transforms.inverse_transform(u, a, b)
    phys = param_scaler.inverse(x)
    if isinstance(phys, torch.Tensor):
        phys = phys.detach().cpu().numpy()
    phys = np.asarray(phys)
    return phys, np.asarray(transforms.param_bounds_mask(phys, space.plims))


def device_inverse(u: torch.Tensor, scaler: transforms.MinMaxScaler,
                   limits, a: float = 0.0, b: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse pipeline on `u`'s device, in float32: (phys, mask)."""
    phys = scaler.inverse(transforms.inverse_transform(u, a, b))
    return phys, transforms.param_bounds_mask(phys, limits)


# the drivers' `device_inverse` argument shadows the function's name
_device_inverse = device_inverse


def filter_valid(phys: np.ndarray, mask: np.ndarray) -> list:
    """Per realization, the stacked valid rows; realizations with none are
    dropped (the reference's filter). phys: (R, B, P); mask: (R, B)."""
    out = []
    for r in range(phys.shape[0]):
        rows = phys[r][mask[r]]
        if rows.shape[0]:
            out.append(rows)
    return out


@fp32_precision()
def posterior_over_dataset(model, conditions, schedule: DiffusionSchedule,
                           param_scaler, *, n_realizations: int = 50,
                           batch_size: int = 32,
                           scfg: Optional[SampleConfig] = None,
                           a: float = 0.0, b: float = 1.0,
                           space: Optional[ParameterSpace] = None,
                           device_inverse: bool = True,
                           generator: Optional[torch.Generator] = None,
                           draws: Optional[Sequence[dict]] = None,
                           device=None) -> Tuple[np.ndarray, np.ndarray]:
    """The posterior ensemble over a whole (N, L, C) set of conditions, in
    batches of `batch_size`: (pred (R, N, P) physical parameters, valid
    (R, N) mask), as numpy arrays (ertdx/sample.py:410-520).

    A ragged last batch is padded by repeating its last condition, so that
    every batch has one shape, and the padded rows are sliced off before
    the inverse. `device_inverse` runs the inverse pipeline (sigmoid ->
    MinMax inverse -> bounds mask) on the device in float32 for a
    MinMaxScaler; False, or another scaler, runs it on the host.
    `draws[i]` holds the keyword arguments (`x_T`, `noise`) of batch i's
    `posterior_ensemble`, in place of JAX's `fold_in(key, i)`; without
    `draws` every batch draws from `generator`."""
    space = space or ParameterSpace()
    conditions = torch.as_tensor(conditions, dtype=torch.float32)
    n = conditions.shape[0]
    bs = min(batch_size, n)
    n_batches = -(-n // bs)
    if draws is not None and len(draws) != n_batches:
        raise ValueError(f"draws has {len(draws)} entries for {n_batches} "
                         "batches")
    outs = []
    for bi, s in enumerate(range(0, n, bs)):
        cond = conditions[s:s + bs]
        if cond.shape[0] < bs:
            pad = cond[-1:].expand(bs - cond.shape[0], *cond.shape[1:])
            cond = torch.cat([cond, pad], dim=0)
        outs.append(posterior_ensemble(
            model, cond, schedule, n_realizations, scfg,
            generator=generator, device=device,
            **(draws[bi] if draws is not None else {})))
    u_all = torch.cat(outs, dim=1)[:, :n]
    if device_inverse and isinstance(param_scaler, transforms.MinMaxScaler):
        phys, mask = _device_inverse(u_all, param_scaler, space.plims, a,
                                     b)
        return phys.cpu().numpy(), mask.cpu().numpy()
    return inverse_pipeline(u_all.cpu().numpy(), param_scaler, a, b, space)


@fp32_precision()
def posterior_over_dataset_mixture(members, conditions,
                                   schedule: DiffusionSchedule, param_scaler,
                                   *, n_realizations: int = 50,
                                   batch_size: int = 32,
                                   scfg: Optional[SampleConfig] = None,
                                   a: float = 0.0, b: float = 1.0,
                                   space: Optional[ParameterSpace] = None,
                                   generator: Optional[torch.Generator] = None,
                                   draws: Optional[Sequence] = None,
                                   device=None
                                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Equal-weight mixture over independently trained models
    (ertdx/sample.py:522-568): the n_realizations budget splits as evenly
    as possible (the first n_realizations % K members take one more), each
    member runs `posterior_over_dataset` with its share, and the draws
    stack on the R axis. `draws[i]` is member i's per-batch `draws`, in
    place of JAX's `fold_in(key, i)`; a member with no share is skipped."""
    members = list(members)
    if not members:
        raise ValueError("members is empty")
    k = len(members)
    if draws is not None and len(draws) != k:
        raise ValueError(f"draws has {len(draws)} entries for {k} members")
    shares = [n_realizations // k + (1 if i < n_realizations % k else 0)
              for i in range(k)]
    preds, masks = [], []
    for i, (model, share) in enumerate(zip(members, shares)):
        if share == 0:
            continue
        p, m = posterior_over_dataset(
            model, conditions, schedule, param_scaler, n_realizations=share,
            batch_size=batch_size, scfg=scfg, a=a, b=b, space=space,
            generator=generator,
            draws=draws[i] if draws is not None else None, device=device)
        preds.append(p)
        masks.append(m)
    return np.concatenate(preds, axis=0), np.concatenate(masks, axis=0)
