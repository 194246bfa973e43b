"""`CondUNet` in eager PyTorch: condition encoder + AdaLN transformer core.

Mirrors ertdx/models/condunet.py:84-491, in its (B, L, C) feature-last
layout at every public function, so that the tests compare like with
like. The contracts the JAX code fixes, and how this file keeps them:

* Stride-2 convs pad as flax's "SAME" does: the total padding
  (ceil(L/s)-1)*s + k - L is split low = total//2, high = the rest, so
  (1, 1) at length 587 and (0, 1) at length 294. torch's `padding=1`
  gives the same lengths but shifted windows, hence the explicit F.pad.
* LayerNorm eps is 1e-6 (the flax default) in SelfAttention1D, AdaLN and
  out_norm; GroupNorm has 8 groups and eps 1e-5, with its statistics over
  (L, C/G) as in ertdx/ops/groupnorm.py:24-34.
* GELU is the tanh approximation (flax `nn.gelu`).
* The patchify stem zero-pads the condition length to a multiple of the
  patch (4693 -> 4696) before folding windows into channels.
* Ensemble chains are condition-major: chain = b * R + r.

Attention here is the plain path of ertdx/ops/attention.py:36-47
(matmul, softmax, matmul); the fused-core CUDA kernels serve the sampling
hot path through models/mega.py instead.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import get_timestep_embedding

LN_EPS = 1e-6          # flax nn.LayerNorm default
GN_EPS = 1e-5


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Pad the last axis of (B, C, L) as flax/XLA "SAME" padding does."""
    length = x.shape[-1]
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return F.pad(x, (total // 2, total - total // 2))


class Conv1dSame(nn.Conv1d):
    """Conv1d on (B, L, C) tensors with "SAME" padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(cin, cout, kernel, stride=stride, padding=0)

    def forward(self, x):
        h = same_pad(x.transpose(1, 2), self.kernel_size[0], self.stride[0])
        return super().forward(h).transpose(1, 2)


def attention(q, k, v):
    """softmax(q k^T / sqrt(dh)) v over the last two axes."""
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(logits, dim=-1), v)


class GNSiLU(nn.Module):
    """GroupNorm (statistics over L and the channels of a group) + SiLU."""

    def __init__(self, channels: int, num_groups: int = 8):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"channels {channels} not divisible by "
                             f"num_groups {num_groups}")
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, l, c = x.shape
        xg = x.reshape(b, l, self.num_groups, c // self.num_groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = xg.var(dim=(1, 3), unbiased=False, keepdim=True)
        xn = ((xg - mean) * torch.rsqrt(var + GN_EPS)).reshape(b, l, c)
        return F.silu(xn * self.weight + self.bias)


class ResBlock1D(nn.Module):
    """[GN+SiLU, conv3] x 2 with a residual (1x1 conv when widths differ)."""

    def __init__(self, cin: int, features: int, num_groups: int = 8):
        super().__init__()
        self.norm1 = GNSiLU(cin, num_groups)
        self.conv1 = Conv1dSame(cin, features, 3)
        self.norm2 = GNSiLU(features, num_groups)
        self.conv2 = Conv1dSame(features, features, 3)
        self.skip = (None if cin == features
                     else Conv1dSame(cin, features, 1))

    def forward(self, x):
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        return (x if self.skip is None else self.skip(x)) + h


class SelfAttention1D(nn.Module):
    """Pre-norm multi-head self-attention with a residual."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = nn.LayerNorm(channels, eps=LN_EPS)
        self.qkv = nn.Linear(channels, 3 * channels, bias=False)
        self.out = nn.Linear(channels, channels)

    def forward(self, x):
        b, l, c = x.shape
        q, k, v = self.qkv(self.norm(x)).chunk(3, dim=-1)

        def heads(z):
            return z.reshape(b, l, self.num_heads, -1).transpose(1, 2)

        a = attention(heads(q), heads(k), heads(v))
        return x + self.out(a.transpose(1, 2).reshape(b, l, c))


class ConditionEncoder(nn.Module):
    """ERT (B, L, C) -> cond tokens (B, Lc, D) and cond vector (B, D)."""

    def __init__(self, cond_channels: int = 14, hidden_dim: int = 128,
                 base_width: int = 64, depth: int = 3, num_heads: int = 4,
                 patch: int = 8):
        super().__init__()
        self.patch = patch
        w0 = 2 * base_width
        self.stem = nn.Linear(patch * cond_channels, w0)
        self.res = nn.ModuleList([ResBlock1D(w0, w0)])
        self.downs = nn.ModuleList()
        w = w0
        for i in range(depth - 1):
            w_next = min(w0 * 2 ** (i + 1), 4 * base_width)
            self.downs.append(Conv1dSame(w, w_next, 3, stride=2))
            self.res.append(ResBlock1D(w_next, w_next))
            w = w_next
        self.attn = SelfAttention1D(w, num_heads)
        self.res_out = ResBlock1D(w, w)
        self.tokens = nn.Linear(w, hidden_dim)
        self.pool = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, condition) -> Tuple[torch.Tensor, torch.Tensor]:
        b, l, c = condition.shape
        lp = -(-l // self.patch) * self.patch
        if lp != l:
            condition = F.pad(condition, (0, 0, 0, lp - l))
        h = self.stem(condition.reshape(b, lp // self.patch,
                                        self.patch * c))
        h = self.res[0](h)
        for down, res in zip(self.downs, self.res[1:]):
            h = res(down(h))
        h = self.res_out(self.attn(h))
        tokens = self.tokens(h)
        pooled = F.silu(self.pool(tokens.mean(dim=1)))
        return tokens, pooled


class AdaLN(nn.Module):
    """LayerNorm without affine, then scale/shift from the conditioning."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * dim)

    def forward(self, x, c):
        h = F.layer_norm(x, x.shape[-1:], eps=LN_EPS)
        scale, shift = self.proj(F.silu(c)).chunk(2, dim=-1)
        return h * (1.0 + scale[:, None, :]) + shift[:, None, :]


class CoreBlock(nn.Module):
    """AdaLN-conditioned [self-attention, cross-attention to the condition
    tokens, MLP]. With fold > 1 the (B*fold, P, D) chains are condition-
    major and cross-attention folds them into the query length, so the
    condition's K/V are computed once per condition, never tiled."""

    def __init__(self, dim: int, num_heads: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.ada1, self.ada2, self.ada3 = AdaLN(dim), AdaLN(dim), AdaLN(dim)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.self_out = nn.Linear(dim, dim)
        self.cross_q = nn.Linear(dim, dim, bias=False)
        self.cross_kv = nn.Linear(dim, 2 * dim, bias=False)
        self.cross_out = nn.Linear(dim, dim)
        self.mlp_in = nn.Linear(dim, 4 * dim)
        self.mlp_out = nn.Linear(4 * dim, dim)

    def _heads(self, z):
        n, l, d = z.shape
        return z.reshape(n, l, self.num_heads, d // self.num_heads
                         ).transpose(1, 2)

    def _unheads(self, z):
        n, _, l, _ = z.shape
        return z.transpose(1, 2).reshape(n, l, -1)

    def forward(self, x, cond_tokens, cvec, fold: int = 1):
        b, p, d = x.shape
        q, k, v = self.qkv(self.ada1(x, cvec)).chunk(3, dim=-1)
        a = self._unheads(attention(self._heads(q), self._heads(k),
                                    self._heads(v)))
        x = x + self.self_out(a)

        q = self.cross_q(self.ada2(x, cvec))
        bc = cond_tokens.shape[0]
        if fold > 1:
            q = q.reshape(bc, fold * p, d)   # condition-major: a view
        k, v = self.cross_kv(cond_tokens).chunk(2, dim=-1)
        a = self._unheads(attention(self._heads(q), self._heads(k),
                                    self._heads(v))).reshape(b, p, d)
        x = x + self.cross_out(a)

        h = F.gelu(self.mlp_in(self.ada3(x, cvec)), approximate="tanh")
        return x + self.mlp_out(h)


class CondUNet(nn.Module):
    """The flagship conditional denoiser (configs[2], configs[3])."""

    def __init__(self, param_dim: int = 29, hidden_dim: int = 128,
                 cond_channels: int = 14, base_width: int = 64,
                 depth: int = 3, patch: int = 8, num_heads: int = 4,
                 core_heads: int = 1, num_blocks: int = 4,
                 ensemble_mega: bool = True,
                 ensemble_mega_accurate: bool = False,
                 parameterization: str = "eps"):
        super().__init__()
        self.param_dim = param_dim
        self.hidden_dim = hidden_dim
        self.depth = depth
        self.patch = patch
        self.core_heads = core_heads
        self.num_blocks = num_blocks
        self.ensemble_mega = ensemble_mega
        self.ensemble_mega_accurate = ensemble_mega_accurate
        self.parameterization = parameterization
        self.encoder = ConditionEncoder(cond_channels, hidden_dim,
                                        base_width, depth, num_heads, patch)
        self.lift = nn.Linear(1, hidden_dim)
        self.pos_emb = nn.Parameter(
            0.02 * torch.randn(param_dim, hidden_dim))
        self.time_mlp1 = nn.Linear(hidden_dim, hidden_dim)
        self.time_mlp2 = nn.Linear(hidden_dim, hidden_dim)
        self.blocks = nn.ModuleList(
            [CoreBlock(hidden_dim, core_heads) for _ in range(num_blocks)])
        self.out_norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.head = nn.Linear(hidden_dim, 1)

    def encode_condition(self, condition):
        return self.encoder(condition)

    def embed_time(self, t: torch.Tensor) -> torch.Tensor:
        emb = get_timestep_embedding(t, self.hidden_dim)
        return self.time_mlp2(F.silu(self.time_mlp1(emb)))

    def denoise_ensemble(self, x, t, cond_ctx, n_real: int):
        """Denoise (B*n_real, P) condition-major chains against a batch-B
        condition context, which is never tiled across the chains."""
        cond_tokens, cond_vec = cond_ctx
        cvec = self.embed_time(t) + (
            torch.repeat_interleave(cond_vec, n_real, dim=0)
            if n_real > 1 else cond_vec)
        tokens = self.lift(x[..., None]) + self.pos_emb[None]
        for blk in self.blocks:
            tokens = blk(tokens, cond_tokens, cvec, fold=n_real)
        return self.head(self.out_norm(tokens))[..., 0]

    def forward(self, x, t, condition):
        return self.denoise_ensemble(x, t, self.encode_condition(condition),
                                     1)
