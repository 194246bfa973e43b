"""Diffusion core on torch tensors: schedules, noising, training targets,
conversions, and the four samplers (ancestral, DDIM, pd, DPM-Solver++(2M)).

Mirrors ertdx/diffusion.py:52-503. The JAX samplers draw their randomness
from threefry keys; here every sampler takes a `torch.Generator`, or an
injected prior draw `x_T` (and, for the noisy samplers, per-step noise),
so that a test can hand it JAX's own draws and compare like with like.

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


def q_sample(x0, t, noise, alpha_bar):
    """Forward noising x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps
    (ertdx/diffusion.py:96-105). x0, noise (B, D); t (B,) int."""
    ab = alpha_bar[t][:, None]
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise


def v_from_eps_x0(eps, x0, abar_t):
    """The velocity target v = alpha_t eps - sigma_t x0."""
    return torch.sqrt(abar_t) * eps - torch.sqrt(1.0 - abar_t) * x0


def prediction_target(x0, noise, t, alpha_bar, parameterization: str):
    """The regression target: `noise` itself for "eps", the velocity for
    "v" (ertdx/diffusion.py:138-152)."""
    if parameterization == "eps":
        return noise
    if parameterization == "v":
        return v_from_eps_x0(noise, x0, alpha_bar[t][:, None])
    raise ValueError(f"unknown parameterization {parameterization!r} "
                     "(expected 'eps' or 'v')")


def min_snr_weight(t, alpha_bar, parameterization: str, gamma: float):
    """Per-example min-SNR-gamma weight (ertdx/diffusion.py:155-181):
    min(SNR, gamma) / SNR for "eps", min(SNR, gamma) / (SNR + 1) for "v",
    with SNR = abar_t / (1 - abar_t)."""
    snr = alpha_bar[t] / (1.0 - alpha_bar[t])
    if parameterization == "eps":
        return torch.clamp(snr, max=gamma) / snr
    if parameterization == "v":
        return torch.clamp(snr, max=gamma) / (snr + 1.0)
    raise ValueError(f"unknown parameterization {parameterization!r} "
                     "(expected 'eps' or 'v')")


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


def _prior(shape, x_T, generator, device, dtype) -> torch.Tensor:
    """The prior draw: `x_T` when injected, else N(0, I) from `generator`."""
    if x_T is None:
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype)
    if tuple(x_T.shape) != tuple(shape):
        raise ValueError(f"x_T has shape {tuple(x_T.shape)}, expected "
                         f"{tuple(shape)}")
    return x_T.to(device=device, dtype=dtype)


def _check_noise(noise, num_steps: int, shape) -> None:
    if noise is not None and tuple(noise.shape) != (num_steps, *shape):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected "
                         f"{(num_steps, *tuple(shape))}")


def _temperature(temperature, device, dtype):
    if isinstance(temperature, torch.Tensor):
        return temperature.to(device=device, dtype=dtype)
    return temperature


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
    x = _prior(shape, x_T, generator, device, dtype)
    _check_noise(noise, num_steps, shape)
    temperature = _temperature(temperature, x.device, dtype)

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


def sample_ancestral(denoise_fn: DenoiseFn, shape,
                     schedule: DiffusionSchedule,
                     truncate_steps: Optional[int] = None, temperature=1.0,
                     *, generator: Optional[torch.Generator] = None,
                     x_T: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None,
                     device=None, dtype=torch.float32) -> torch.Tensor:
    """Ancestral DDPM reverse chain (ertdx/diffusion.py:203-253).

    x <- (x - (1 - alpha_t) / (sqrt(1 - abar_t) + 1e-8) eps_hat)
         / sqrt(alpha_t) + sqrt(beta_t) temperature z,
    with no noise at t = 0. `truncate_steps` runs only the last that many
    steps (t = truncate_steps - 1 .. 0; the reference's compat mode) and
    raises above T. `noise`, of shape (steps, *shape), replaces the
    per-step draws in loop order (noisiest step first), as JAX's step keys
    order them; its t = 0 row is drawn by JAX but never used, so it is
    ignored here too.
    """
    big_t = schedule.num_steps
    num_steps = big_t if truncate_steps is None else int(truncate_steps)
    if num_steps > big_t:
        raise ValueError(f"truncate_steps {num_steps} > schedule T {big_t}")
    n = shape[0]
    x = _prior(shape, x_T, generator, device, dtype)
    _check_noise(noise, num_steps, shape)
    temperature = _temperature(temperature, x.device, dtype)
    betas = schedule.betas.to(torch.float32)
    alphas = schedule.alphas.to(torch.float32)
    abar = schedule.alpha_bar.to(torch.float32)
    for i, t in enumerate(range(num_steps - 1, -1, -1)):
        coef = float((1.0 - alphas[t]) / (torch.sqrt(1.0 - abar[t]) + 1e-8))
        c_div = float(torch.sqrt(alphas[t]))
        t_batch = torch.full((n,), t, dtype=torch.int64, device=x.device)
        eps_hat = denoise_fn(x, t_batch)
        x = (x - coef * eps_hat) / c_div
        if t > 0:
            z = (noise[i].to(device=x.device, dtype=dtype)
                 if noise is not None else
                 torch.randn(shape, generator=generator, device=x.device,
                             dtype=dtype))
            x = x + float(torch.sqrt(betas[t])) * temperature * z
    return x


def pd_grid(T: int, num_steps: int) -> torch.Tensor:
    """The progressive-distillation grid idx_i = round(i T / N) - 1,
    i = 1..N, increasing (ertdx/diffusion.py:324-347). Exact integer
    round-half-up, so that pd_grid(T, 2N)[2i-1] == pd_grid(T, N)[i-1]."""
    if num_steps > T:
        raise ValueError(f"num_steps={num_steps} > T={T}")
    if num_steps < 1:
        raise ValueError(f"num_steps={num_steps} < 1")
    i = torch.arange(1, num_steps + 1, dtype=torch.int64)
    return torch.div(2 * i * T + num_steps, 2 * num_steps,
                     rounding_mode="floor") - 1


def sample_pd(denoise_fn: DenoiseFn, shape, schedule: DiffusionSchedule,
              num_steps: int = 4, temperature=1.0, *,
              generator: Optional[torch.Generator] = None,
              x_T: Optional[torch.Tensor] = None,
              device=None, dtype=torch.float32) -> torch.Tensor:
    """Deterministic DDIM (eta = 0) over `pd_grid(T, num_steps)`, the chain
    a distilled student was trained on (ertdx/diffusion.py:350-384).
    `temperature` tempers the prior: x_T is the raw N(0, I) draw and the
    chain starts from temperature * x_T."""
    ts = pd_grid(schedule.num_steps, num_steps)
    n = shape[0]
    x = _prior(shape, x_T, generator, device, dtype)
    x = _temperature(temperature, x.device, dtype) * x
    abar = schedule.alpha_bar.to(torch.float32)
    abar_seq = abar[ts]
    abar_prev_seq = torch.cat([torch.ones(1), abar_seq[:-1]])
    for j in range(num_steps - 1, -1, -1):
        ab, ab_prev = abar_seq[j], abar_prev_seq[j]
        t_batch = torch.full((n,), int(ts[j]), dtype=torch.int64,
                             device=x.device)
        eps_hat = denoise_fn(x, t_batch)
        x0_hat = (x - float(torch.sqrt(1.0 - ab)) * eps_hat) / float(
            torch.sqrt(ab))
        x = (float(torch.sqrt(ab_prev)) * x0_hat
             + float(torch.sqrt(1.0 - ab_prev)) * eps_hat)
    return x


def _log_snr(alpha_bar: torch.Tensor) -> torch.Tensor:
    """lambda = 0.5 (log abar - log1p(-abar)), accurate near abar = 1."""
    return 0.5 * (torch.log(alpha_bar) - torch.log1p(-alpha_bar))


def lambda_timesteps(schedule: DiffusionSchedule,
                     num_steps: int) -> torch.Tensor:
    """Decreasing timesteps uniform in log-SNR, both endpoints included:
    the nearest t (argmin over float32 lambdas, first index on a tie) to
    each of num_steps evenly spaced lambda targets
    (ertdx/diffusion.py:396-423)."""
    big_t = schedule.num_steps
    if num_steps > big_t:
        raise ValueError(f"num_steps {num_steps} > schedule T {big_t}")
    if num_steps == 1:
        return torch.tensor([big_t - 1], dtype=torch.int64)
    lam = _log_snr(schedule.alpha_bar.to(torch.float32))
    frac = torch.arange(num_steps, dtype=torch.float32) / (num_steps - 1)
    targets = lam[big_t - 1] + (lam[0] - lam[big_t - 1]) * frac
    return torch.argmin(torch.abs(lam[None, :] - targets[:, None]), dim=1)


def sample_dpmpp_2m(denoise_fn: DenoiseFn, shape,
                    schedule: DiffusionSchedule, num_steps: int = 15,
                    temperature=1.0, *,
                    generator: Optional[torch.Generator] = None,
                    x_T: Optional[torch.Tensor] = None,
                    device=None, dtype=torch.float32) -> torch.Tensor:
    """DPM-Solver++(2M) on the uniform-log-SNR grid
    (ertdx/diffusion.py:426-503). From point s to point u:

        x_u = (sigma_u / sigma_s) x_s - alpha_u expm1(-h) D,
        h = lambda_u - lambda_s, D = (1 + c) x0_s - c x0_prev,
        c = h / (2 h_prev),

    with c = 0 (first order) on the first step, on the last step and
    after a step with h_prev <= 0; the last step lands on the clean point,
    whose exact limit is x = D. Deterministic: `temperature` tempers the
    prior, as in `sample_pd`. Scalar coefficients are float32, as JAX's.
    """
    ts = lambda_timesteps(schedule, num_steps)
    n = shape[0]
    x = _prior(shape, x_T, generator, device, dtype)
    x = _temperature(temperature, x.device, dtype) * x
    abar_seq = schedule.alpha_bar.to(torch.float32)[ts]
    alpha_seq = torch.sqrt(abar_seq)
    sigma_seq = torch.sqrt(1.0 - abar_seq)
    lam_seq = _log_snr(abar_seq)
    x0_prev = h_prev = None
    for j in range(num_steps):
        t_batch = torch.full((n,), int(ts[j]), dtype=torch.int64,
                             device=x.device)
        eps_hat = denoise_fn(x, t_batch)
        x0 = (x - float(sigma_seq[j]) * eps_hat) / float(alpha_seq[j])
        if j == num_steps - 1:
            return x0           # the clean limit of a first-order step
        h = lam_seq[j + 1] - lam_seq[j]
        d = x0
        if x0_prev is not None and float(h_prev) > 0.0:
            coef = h / (2.0 * h_prev)
            d = float(1.0 + coef) * x0 - float(coef) * x0_prev
        x = (float(sigma_seq[j + 1] / sigma_seq[j]) * x
             - float(alpha_seq[j + 1] * torch.expm1(-h)) * d)
        x0_prev, h_prev = x0, h
    return x
