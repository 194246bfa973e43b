"""Posterior-ensemble sampling on the port.

Mirrors ertdx/sample.py:79-410 for the DDIM sampler: the condition is
encoded ONCE per run, all realizations fold into the chain axis in
condition-major order (chain = b * R + r), and the denoiser core runs on
the fused CUDA kernels whenever `mega_plan` engages them. Draws come out
as (R, B, P). The other samplers (ancestral, DPM-Solver++, pd),
classifier-free guidance and `posterior_over_dataset` are not ported yet
(ROADMAP.md) and raise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import resolve_device, transforms
from .configs import SampleConfig
from .diffusion import DiffusionSchedule, as_eps_denoiser, sample_ddim
from .models.mega import mega_denoise_ensemble, mega_plan, mega_weights
from .params import ParameterSpace


def posterior_ensemble(model, condition, schedule: DiffusionSchedule,
                       n_realizations: int = 50,
                       scfg: Optional[SampleConfig] = None, *,
                       generator: Optional[torch.Generator] = None,
                       x_T: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None,
                       param_dim: Optional[int] = None,
                       device=None) -> torch.Tensor:
    """Sample (n_realizations, B, P) unconstrained parameter draws for the
    (B, L, C) `condition`, on `device` (CUDA unless "cpu" is asked for).

    `x_T` ((R*B, P), condition-major) and `noise` ((steps, R*B, P)) replace
    the generator's draws, so a caller can inject another framework's."""
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type or (dev.index is not None
                                      and model_dev != dev):
        raise ValueError(f"model is on {model_dev}, sampling asked for "
                         f"{dev}")
    dev = model_dev
    scfg = scfg or SampleConfig(uncertainty_samples=n_realizations,
                                sampler="ddim")
    if scfg.sampler != "ddim":
        raise NotImplementedError(
            f"sampler {scfg.sampler!r} is not ported yet (ROADMAP.md: "
            "ancestral, DPM++ and pd samplers); use sampler='ddim'")
    if scfg.guidance_scale != 1.0:
        raise NotImplementedError("classifier-free guidance is not ported "
                                  "yet (ROADMAP.md)")
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
    n_steps = min(scfg.ddim_steps, schedule.num_steps)
    with torch.no_grad():
        ctx = model.encode_condition(condition)
        plan = mega_plan(model, r, b, cond_len=condition.shape[1],
                         device=dev)
        if plan is not None:
            weights = mega_weights(model)

            def denoise(x, t):
                return mega_denoise_ensemble(model, x, t, ctx, r,
                                             weights=weights, **plan)
        else:
            def denoise(x, t):
                return model.denoise_ensemble(x, t, ctx, r)

        denoise = as_eps_denoiser(denoise, schedule.alpha_bar,
                                  model.parameterization)
        u = sample_ddim(denoise, (r * b, p), schedule, n_steps,
                        eta=scfg.ddim_eta, temperature=temperature,
                        generator=generator, x_T=x_T, noise=noise,
                        device=dev)
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


def filter_valid(phys: np.ndarray, mask: np.ndarray) -> list:
    """Per realization, the stacked valid rows; realizations with none are
    dropped (the reference's filter). phys: (R, B, P); mask: (R, B)."""
    out = []
    for r in range(phys.shape[0]):
        rows = phys[r][mask[r]]
        if rows.shape[0]:
            out.append(rows)
    return out
