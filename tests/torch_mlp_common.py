"""Shared set-up for the parity tests of the port's two MLP models.

A flax RefCondMLP or UncondMLP is initialised, every parameter is
perturbed (UncondMLP's zero `out` kernel and zero biases would otherwise
make a comparison empty), and the same numbers are loaded into the
port's model with `params_from_jax`. `jax_draws` gives the prior draw and
per-step noise that JAX's samplers make from a key, for injection into
the port.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ertdx.models import RefCondMLP as FlaxRefCondMLP
from ertdx.models import UncondMLP as FlaxUncondMLP
from ertdx_torch.models.refmlp import RefCondMLP
from ertdx_torch.models.uncond import UncondMLP
from ertdx_torch.utils.weights import params_from_jax
from torch_parity_common import t32


def _perturbed(variables, seed, scale):
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(a.shape)
                   ).astype(np.float32), variables["params"])


def refmlp_pair(*, p=29, h=32, c=14, cond_len=64, uncond_prob=0.0,
                parameterization="eps", seed=0, scale=0.05):
    """(flax RefCondMLP, numpy params, port RefCondMLP on the CPU)."""
    fm = FlaxRefCondMLP(param_dim=p, hidden_dim=h, cond_channels=c,
                        uncond_prob=uncond_prob,
                        parameterization=parameterization)
    variables = jax.jit(fm.init)(jax.random.key(seed), jnp.zeros((1, p)),
                                 jnp.zeros((1,), jnp.int32),
                                 jnp.zeros((1, cond_len, c)))
    params = _perturbed(variables, seed, scale)
    tm = RefCondMLP(param_dim=p, hidden_dim=h, cond_channels=c,
                    uncond_prob=uncond_prob,
                    parameterization=parameterization)
    params_from_jax(tm, params)
    return fm, params, tm


def uncond_pair(*, p=64, h=32, parameterization="eps", seed=0,
                scale=0.05):
    """(flax UncondMLP, numpy params, port UncondMLP on the CPU)."""
    fm = FlaxUncondMLP(param_dim=p, hidden_dim=h,
                       parameterization=parameterization)
    variables = jax.jit(fm.init)(jax.random.key(seed), jnp.zeros((1, p)),
                                 jnp.zeros((1,), jnp.int32),
                                 jnp.zeros((1, 1, 1)))
    params = _perturbed(variables, seed, scale)
    tm = UncondMLP(param_dim=p, hidden_dim=h,
                   parameterization=parameterization)
    params_from_jax(tm, params)
    return fm, params, tm


def jax_draws(key, sampler, shape, steps):
    """The port's injected draws (`x_T`, `noise`) for JAX's ancestral or
    DDIM sampler run from `key` over `steps` steps, in JAX's chain order
    (ertdx/diffusion.py: split(key) -> (step key, prior key))."""
    k, init = jax.random.split(key)
    noise = jnp.stack([jax.random.normal(sk, shape)
                       for sk in jax.random.split(k, steps)])
    return {"x_T": t32(jax.random.normal(init, shape)), "noise": t32(noise)}
