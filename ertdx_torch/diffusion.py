"""Diffusion core on torch tensors: schedules, conversions, the DDIM sampler.

Mirrors ertdx/diffusion.py:52-202 and :255-322. The JAX samplers draw their
randomness from threefry keys; here `sample_ddim` takes a
`torch.Generator`, or an injected prior draw `x_T` and per-step noise, so
that a test can hand it JAX's own draws and compare like with like.

Per-step coefficients are computed once in float32 on the host, as the
JAX scan computes them in float32, and enter the tensor arithmetic as
Python floats (torch casts them back to float32 exactly).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class DiffusionSchedule(NamedTuple):
    """Precomputed noising schedule: three (T,) float32 tensors."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alpha_bar: torch.Tensor

    @property
    def num_steps(self) -> int:
        return int(self.betas.shape[0])


def get_diffusion_schedule(T: int, beta_start: float = 1e-4,
                           beta_end: float = 0.02,
                           dtype=torch.float32,
                           kind: str = "linear") -> DiffusionSchedule:
    """Linear beta schedule (the reference's) or the squared-cosine
    alpha_bar schedule of Nichol & Dhariwal 2021 (s=0.008, betas clipped
    at 0.999), as ertdx/diffusion.py:52-92 builds them. CPU tensors."""
    if kind == "linear":
        betas = torch.linspace(beta_start, beta_end, T, dtype=dtype)
    elif kind == "cosine":
        s = 0.008
        t = torch.arange(T + 1, dtype=torch.float32) / T
        f = torch.cos((t + s) / (1.0 + s) * (math.pi / 2.0)) ** 2
        abar = f / f[0]
        betas = torch.clamp(1.0 - abar[1:] / abar[:-1], 0.0, 0.999)
        betas = betas.to(dtype)
    else:
        raise ValueError(f"unknown schedule kind {kind!r} "
                         "(expected 'linear' or 'cosine')")
    alphas = 1.0 - betas
    alpha_bar = torch.cumprod(alphas, dim=0)
    return DiffusionSchedule(betas, alphas, alpha_bar)


def schedule_from_config(dcfg) -> DiffusionSchedule:
    """The schedule a DiffusionConfig describes."""
    return get_diffusion_schedule(dcfg.T, dcfg.beta_start, dcfg.beta_end,
                                  kind=dcfg.schedule)


def eps_from_v(v, x, abar_t):
    """eps = sigma_t x + alpha_t v."""
    return torch.sqrt(1.0 - abar_t) * x + torch.sqrt(abar_t) * v


def as_eps_denoiser(model_fn: DenoiseFn, alpha_bar: torch.Tensor,
                    parameterization: str) -> DenoiseFn:
    """Adapt a raw model-output closure to the samplers' eps contract:
    identity for "eps", eps = sigma x + alpha v for "v"."""
    if parameterization == "eps":
        return model_fn
    if parameterization != "v":
        raise ValueError(f"unknown parameterization {parameterization!r} "
                         "(expected 'eps' or 'v')")

    def fn(x, t):
        ab = alpha_bar.to(device=x.device, dtype=x.dtype)[t][:, None]
        return eps_from_v(model_fn(x, t), x, ab)

    return fn


def ddim_timesteps(T: int, num_steps: int) -> torch.Tensor:
    """round(linspace(0, T-1, num_steps)): an increasing subsequence of
    [0, T) that holds both endpoints (ertdx/diffusion.py:255-270)."""
    if num_steps > T:
        raise ValueError(f"num_steps={num_steps} > T={T}")
    if num_steps == 1:
        return torch.tensor([T - 1], dtype=torch.int64)
    return torch.round(torch.linspace(0.0, T - 1, num_steps,
                                      dtype=torch.float32)).to(torch.int64)


def sample_ddim(denoise_fn: DenoiseFn, shape, schedule: DiffusionSchedule,
                num_steps: int = 50, eta: float = 0.0, temperature=1.0, *,
                generator: Optional[torch.Generator] = None,
                x_T: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                device=None, dtype=torch.float32) -> torch.Tensor:
    """DDIM over an evenly spaced timestep subsequence
    (ertdx/diffusion.py:272-322).

    eta=0 is the deterministic DDIM ODE path. `temperature` (a scalar or a
    tensor broadcast over the last axis) scales only the injected noise.
    `x_T` replaces the prior draw; `noise`, of shape (num_steps, *shape),
    replaces the per-step draws in loop order (noisiest step first), as
    JAX's `step_keys` order them. Otherwise both come from `generator`.
    """
    ts = ddim_timesteps(schedule.num_steps, num_steps)
    n = shape[0]
    if x_T is None:
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=dtype)
    else:
        if tuple(x_T.shape) != tuple(shape):
            raise ValueError(f"x_T has shape {tuple(x_T.shape)}, "
                             f"expected {tuple(shape)}")
        x = x_T.to(device=device, dtype=dtype)
    if noise is not None and tuple(noise.shape) != (num_steps, *shape):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected "
                         f"{(num_steps, *tuple(shape))}")
    if isinstance(temperature, torch.Tensor):
        temperature = temperature.to(device=x.device, dtype=dtype)

    abar = schedule.alpha_bar.to(torch.float32)
    abar_seq = abar[ts]
    abar_prev_seq = torch.cat([torch.ones(1), abar_seq[:-1]])
    for i, j in enumerate(range(num_steps - 1, -1, -1)):
        ab, ab_prev = abar_seq[j], abar_prev_seq[j]
        c_eps = float(torch.sqrt(1.0 - ab))
        c_div = float(torch.sqrt(ab))
        sigma_t = (eta * torch.sqrt((1.0 - ab_prev) / (1.0 - ab))
                   * torch.sqrt(1.0 - ab / ab_prev))
        dir_coef = float(torch.sqrt(torch.clamp(
            1.0 - ab_prev - sigma_t ** 2, min=0.0)))
        c_x0 = float(torch.sqrt(ab_prev))
        sigma = float(sigma_t)

        t_batch = torch.full((n,), int(ts[j]), dtype=torch.int64,
                             device=x.device)
        eps_hat = denoise_fn(x, t_batch)
        x0_hat = (x - c_eps * eps_hat) / c_div
        x_new = c_x0 * x0_hat + dir_coef * eps_hat
        if eta != 0.0:
            z = (noise[i].to(device=x.device, dtype=dtype)
                 if noise is not None else
                 torch.randn(shape, generator=generator, device=x.device,
                             dtype=dtype))
            x_new = x_new + sigma * temperature * z
        x = x_new
    return x
