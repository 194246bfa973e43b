"""Shared model pieces: the sinusoidal timestep embedding, and the layers
that compute in a model's dtype as flax's do.

The embedding is the formula of ertdx/models/common.py:18-35 (and the
reference, ERT_Conditional_Diffusion.py:80-88): half = D//2, frequencies
exp(-log(1e4)/(half-1) k), concat(sin, cos), zero column if D is odd.

`Dense`, `Conv1d` and `LayerNorm` follow flax's dtype rules, which a
bfloat16 model (ModelConfig.dtype) relies on and `torch.autocast` does
not keep: `nn.Dense(dtype=d)` and `nn.Conv(dtype=d)` cast the input, the
kernel and the bias to d and return d; `nn.LayerNorm(dtype=d)` takes its
statistics and affine in float32 whatever the input and returns d. The
parameters stay float32 under their usual names, so checkpoints and
`params_from_jax` see one tree for both dtypes. A float32 layer casts
nothing (`Tensor.to` of the dtype a tensor has is the tensor itself).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of ModelConfig.dtype ("float32" or "bfloat16")."""
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r}: the port computes in "
                         f"{' or '.join(DTYPES)}")
    return DTYPES[name]


class Dense(nn.Linear):
    """nn.Linear computing in `dtype`, as flax's nn.Dense(dtype=...)."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class Conv1d(nn.Conv1d):
    """nn.Conv1d on (B, C, L) computing in `dtype`, as flax's
    nn.Conv(dtype=...); no padding of its own."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=0)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with float32 statistics and affine, returning `dtype`
    (flax's nn.LayerNorm(dtype=...))."""

    def __init__(self, dim: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        return super().forward(x.to(torch.float32)).to(self.compute_dtype)


def get_timestep_embedding(timesteps: torch.Tensor,
                           embedding_dim: int) -> torch.Tensor:
    """(B,) timesteps -> (B, embedding_dim) float32 embedding."""
    half_dim = embedding_dim // 2
    emb = math.log(10000.0) / (half_dim - 1)
    exponents = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                       device=timesteps.device) * -emb)
    emb_t = timesteps.to(torch.float32)[:, None] * exponents[None, :]
    out = torch.cat([torch.sin(emb_t), torch.cos(emb_t)], dim=1)
    if embedding_dim % 2 == 1:
        out = torch.nn.functional.pad(out, (0, 1))
    return out
