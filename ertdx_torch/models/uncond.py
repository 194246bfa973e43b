"""The unconditional denoiser, `UncondMLP` (configs[1]).

A residual time-conditioned MLP over flattened synthetic resistivity
fields (synthetic.py), the schedule and sampler tolerance check, as
ertdx/models/uncond.py builds it, with its interface and names:

  h = inp(x) + time_mlp2(silu(time_mlp1(sinusoidal(t))))
  h = h + d2(silu(d1(silu(h))))     for each of num_blocks pairs
  out(silu(h))

The condition is accepted and ignored: `encode_condition` returns a
(B, 0) float32 placeholder, so that the conditional train and sample
code runs unchanged (the sampler tiles it across the realizations on the
realization-major path). It has no `uncond_prob`, so guidance refuses
it. `init_uncond` draws flax's defaults: lecun-normal kernels, zero
biases, and a zero `out` kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import get_timestep_embedding
from .condunet import _lecun_normal


class UncondMLP(nn.Module):
    def __init__(self, param_dim: int = 256, hidden_dim: int = 256,
                 num_blocks: int = 3, parameterization: str = "eps"):
        super().__init__()
        self.param_dim = param_dim
        self.hidden_dim = hidden_dim
        self.num_blocks = num_blocks
        self.parameterization = parameterization
        self.inp = nn.Linear(param_dim, hidden_dim)
        self.time_mlp1 = nn.Linear(hidden_dim, hidden_dim)
        self.time_mlp2 = nn.Linear(hidden_dim, hidden_dim)
        self.blocks = nn.ModuleList(
            nn.ModuleList([nn.Linear(hidden_dim, hidden_dim),
                           nn.Linear(hidden_dim, hidden_dim)])
            for _ in range(num_blocks))
        self.out = nn.Linear(hidden_dim, param_dim)

    def embed_time(self, t: torch.Tensor) -> torch.Tensor:
        emb = get_timestep_embedding(t, self.hidden_dim)
        return self.time_mlp2(F.silu(self.time_mlp1(emb)))

    def encode_condition(self, condition=None):
        """A (B, 0) float32 placeholder that keeps the batch axis."""
        if condition is None:
            raise ValueError("pass the (B, ...) condition placeholder")
        return torch.zeros((condition.shape[0], 0), dtype=torch.float32,
                           device=condition.device)

    def denoise(self, x, t, cond_ctx):
        del cond_ctx                      # unconditional
        h = self.inp(x) + self.embed_time(t)
        for d1, d2 in self.blocks:
            h = h + d2(F.silu(d1(F.silu(h))))
        return self.out(F.silu(h))

    def forward(self, x, t, condition):
        return self.denoise(x, t, self.encode_condition(condition))


@torch.no_grad()
def init_uncond(model: UncondMLP, generator: torch.Generator) -> UncondMLP:
    """Initialise `model` in place as flax initialises the JAX UncondMLP,
    in distribution: lecun-normal kernels (drawn on the CPU from
    `generator` in named_parameters order), zero biases, a zero `out`
    kernel. Returns the model."""
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            if name == "out":
                mod.weight.zero_()
            else:
                mod.weight.copy_(_lecun_normal(tuple(mod.weight.shape),
                                               mod.weight.shape[1],
                                               generator))
            mod.bias.zero_()
    return model
