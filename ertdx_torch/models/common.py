"""Shared model pieces: the sinusoidal timestep embedding.

The same formula as ertdx/models/common.py:18-35 (and the reference,
ERT_Conditional_Diffusion.py:80-88): half = D//2, frequencies
exp(-log(1e4)/(half-1) k), concat(sin, cos), zero column if D is odd.
"""
from __future__ import annotations

import math

import torch


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
