"""The reference conditional denoiser, `RefCondMLP` (configs[0]).

The PNNL reference's `ConditionalDiffusionModel`
(ERT_Conditional_Diffusion.py:122-164), as ertdx/models/refmlp.py builds
it, with the same interface and names:

  condition encoder: Conv1d(C->32, k3, s2, p1) + ReLU
                   -> Conv1d(32->64, k3, s2, p1) + ReLU
                   -> mean over L -> Linear(64->H) + ReLU
  time path:         sinusoidal(H) -> Linear(H->H) + ReLU
  head:              Linear(P + 2H -> H) + ReLU -> Linear(H -> P),
                     on the concatenation [x, t_emb, cond_emb]

The condition is feature-last (B, L, C), as in JAX; the encoder turns it
channel-first once for `F.conv1d`. The model has `encode_condition` and
`denoise` but no `denoise_ensemble`: the sampler runs it on JAX's
realization-major path (sample.py), the whole (B, H) context tiled
across the realizations. With `uncond_prob > 0` it holds the learned
guidance null vector `null_vec` (zeros at init). It computes in float32
whatever the config's dtype, as JAX's `build_model` builds it.

`init_refmlp` draws PyTorch's default Linear / Conv1d statistics, which
the JAX model's TorchDense / TorchConv1d reproduce
(ertdx/models/common.py:37-100): weight and bias from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = c_in * k for a conv.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import get_timestep_embedding


class RefCondMLP(nn.Module):
    """eps (or v) predictor conditioned on the timestep and the ERT
    measurement stack."""

    def __init__(self, param_dim: int = 29, hidden_dim: int = 128,
                 cond_channels: int = 14, uncond_prob: float = 0.0,
                 parameterization: str = "eps"):
        super().__init__()
        self.param_dim = param_dim
        self.hidden_dim = hidden_dim
        self.cond_channels = cond_channels
        self.uncond_prob = uncond_prob
        self.parameterization = parameterization
        self.conv1 = nn.Conv1d(cond_channels, 32, 3, stride=2, padding=1)
        self.conv2 = nn.Conv1d(32, 64, 3, stride=2, padding=1)
        self.cond_proj = nn.Linear(64, hidden_dim)
        self.time_proj = nn.Linear(hidden_dim, hidden_dim)
        self.head1 = nn.Linear(param_dim + 2 * hidden_dim, hidden_dim)
        self.head2 = nn.Linear(hidden_dim, param_dim)
        if uncond_prob > 0.0:
            self.null_vec = nn.Parameter(torch.zeros(hidden_dim))

    def drop_condition(self, cond_emb, drop: torch.Tensor):
        """Replace the dropped examples' (B, H) context with the learned
        null vector (drop: (B,) bool). Needs uncond_prob > 0."""
        nv = self.null_vec.to(cond_emb.dtype)[None, :]
        return torch.where(drop[:, None], nv, cond_emb)

    def encode_condition(self, condition):
        """(B, L, C) feature-last condition -> (B, H)."""
        h = F.relu(self.conv1(condition.transpose(1, 2)))
        h = F.relu(self.conv2(h))
        return F.relu(self.cond_proj(h.mean(dim=2)))

    def embed_time(self, t: torch.Tensor) -> torch.Tensor:
        return F.relu(self.time_proj(
            get_timestep_embedding(t, self.hidden_dim)))

    def denoise(self, x, t, cond_emb):
        """x: (B, P) noisy parameters; t: (B,) ints; cond_emb: (B, H)."""
        h = torch.cat([x, self.embed_time(t), cond_emb], dim=1)
        return self.head2(F.relu(self.head1(h)))

    def forward(self, x, t, condition):
        return self.denoise(x, t, self.encode_condition(condition))


@torch.no_grad()
def init_refmlp(model: RefCondMLP, generator: torch.Generator
                ) -> RefCondMLP:
    """Initialise `model` in place with PyTorch's default Linear / Conv1d
    statistics, drawn on the CPU from `generator` in named_parameters
    order (weight, then bias, of each layer); null_vec zero. Returns the
    model."""
    for mod in (model.conv1, model.conv2, model.cond_proj, model.time_proj,
                model.head1, model.head2):
        w = mod.weight
        fan_in = w.shape[1] * (w.shape[2] if w.dim() == 3 else 1)
        bound = 1.0 / math.sqrt(fan_in)
        for p in (mod.weight, mod.bias):
            u = torch.rand(tuple(p.shape), generator=generator)
            p.copy_((2.0 * u - 1.0) * bound)
    if model.uncond_prob > 0.0:
        model.null_vec.zero_()
    return model
