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
(matmul, softmax, matmul), except that with `use_pallas` the encoder's
self-attention reads the fused QKV slab through ops/slab_attn.py
(`attn_slab`) or runs the flash kernels of ops/attention.py on the
padded, masked sequence (the length gate, or `flash_min_logits`), and
with `ensemble_pallas` the core's attention at ensemble chain counts goes
through ops/ensemble_attn.py (on the card its CUDA kernels, which compute
JAX's kernels' one-pass function: one bf16 pass a product, the q, k and v
of either dtype loaded as they are), each with the JAX dispatch rule. The encoder's GroupNorm+SiLU goes through
ops/groupnorm.py with `pallas_gn`, and its ResBlocks at or above
`pallas_conv_min_width` channels (all, with `pallas_conv`) fuse GN+SiLU
with the following conv through ops/conv.py. The fused-core CUDA kernels
serve the sampling hot path through models/mega.py. With
`uncond_prob > 0` the model carries the learned null context of
classifier-free guidance.

`dtype` is the compute dtype, float32 or bfloat16 (ModelConfig.dtype),
with flax's rules module by module (ertdx/models/condunet.py): every
Dense and Conv casts its input, kernel and bias to it (models/common.py);
LayerNorm and GroupNorm take their statistics in float32 and return it;
attention takes its logits in float32 and casts the probabilities to v's
dtype (ertdx/ops/attention.py:36-46); `pos_emb` (float32) promotes the
core's residual stream to float32, where each block's bf16 output is
added; the time embedding is float32 and enters `time_mlp1` in the
dtype; `out_norm` and `head` stay float32, so the denoiser returns
float32. Parameters are float32 in either dtype.

`init_params` draws a fresh model the way flax initialises the JAX
CondUNet; the modules' own constructors keep PyTorch's default init.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention, reference_attention
from ..ops.conv import gn_silu_conv3, reference_gn_silu_conv3
from ..ops.ensemble_attn import block_self_attention, folded_cross_attention
from ..ops.groupnorm import (check_groups, groupnorm_silu,
                             reference_groupnorm_silu)
from ..ops.slab_attn import reference_slab_attention, slab_attention
from ..parallel.mesh import full_param, global_rows
from .common import (Conv1d, Dense, LayerNorm, compute_dtype,
                     get_timestep_embedding)

LN_EPS = 1e-6          # flax nn.LayerNorm default
GN_EPS = 1e-5
FLASH_MIN_LEN = 1024   # SelfAttention1D.pallas_min_len in the JAX model


def pad128(length: int) -> int:
    return -(-length // 128) * 128


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Pad the last axis of (B, C, L) as flax/XLA "SAME" padding does."""
    length = x.shape[-1]
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return F.pad(x, (total // 2, total - total // 2))


class Conv1dSame(Conv1d):
    """Conv1d on (B, L, C) tensors with "SAME" padding, computing in
    `dtype`."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, dtype=dtype)

    def forward(self, x):
        h = same_pad(x.transpose(1, 2), self.kernel_size[0], self.stride[0])
        return super().forward(h).transpose(1, 2)


def attention(q, k, v):
    """softmax(q k^T / sqrt(dh)) v over the last two axes: the logits in
    float32 or wider, the probabilities cast to v's dtype."""
    f32 = torch.promote_types(q.dtype, torch.float32)
    logits = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) \
        / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)


class GNSiLU(nn.Module):
    """GroupNorm (statistics over L and the channels of a group) + SiLU,
    in float32 and returned in x's dtype (float32 or bf16). With
    `use_pallas` a CUDA input goes through the fused kernels of
    ops/groupnorm.py (ertdx/models/condunet.py:47-60); the plain version
    is the CPU path and the path with use_pallas off."""

    def __init__(self, channels: int, num_groups: int = 8,
                 use_pallas: bool = True):
        super().__init__()
        check_groups(channels, num_groups)
        self.num_groups = num_groups
        self.use_pallas = use_pallas
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        fn = groupnorm_silu if self.use_pallas else reference_groupnorm_silu
        return fn(x, self.weight, self.bias, self.num_groups, GN_EPS)


class FusedGNConv(nn.Module):
    """GroupNorm + SiLU + k=3 "SAME" conv as one op, ops/conv.py's fused
    kernels on a CUDA input with `use_pallas` (ertdx/models/condunet.py:
    62-82). As in flax it has no dtype of its own: its output takes x's
    dtype (a bf16 model's encoder runs it in bf16). Its parameters keep
    the flax names and layouts: gn_scale, gn_bias (C,), kernel (3, C,
    Cout), bias (Cout,)."""

    def __init__(self, cin: int, features: int, num_groups: int = 8,
                 use_pallas: bool = True):
        super().__init__()
        check_groups(cin, num_groups)
        self.num_groups = num_groups
        self.use_pallas = use_pallas
        self.gn_scale = nn.Parameter(torch.ones(cin))
        self.gn_bias = nn.Parameter(torch.zeros(cin))
        self.kernel = nn.Parameter(torch.empty(3, cin, features))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.normal_(self.kernel, std=(3 * cin) ** -0.5)

    def forward(self, x):
        fn = gn_silu_conv3 if self.use_pallas else reference_gn_silu_conv3
        return fn(x, self.gn_scale, self.gn_bias,
                  full_param(self, "kernel"), self.bias, self.num_groups,
                  GN_EPS)


class ResBlock1D(nn.Module):
    """[GN+SiLU, conv3] x 2 with a residual (1x1 conv when widths differ).
    With `pallas_conv` each pair is one FusedGNConv, which changes the
    parameter tree as in JAX (ertdx/models/condunet.py:84-111); otherwise
    `pallas_gn` sends the GNSiLU pairs through the fused GN kernels."""

    def __init__(self, cin: int, features: int, num_groups: int = 8,
                 pallas_gn: bool = False, pallas_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pallas_conv = pallas_conv
        if pallas_conv:
            self.fused1 = FusedGNConv(cin, features, num_groups)
            self.fused2 = FusedGNConv(features, features, num_groups)
        else:
            self.norm1 = GNSiLU(cin, num_groups, pallas_gn)
            self.conv1 = Conv1dSame(cin, features, 3, dtype=dtype)
            self.norm2 = GNSiLU(features, num_groups, pallas_gn)
            self.conv2 = Conv1dSame(features, features, 3, dtype=dtype)
        self.skip = (None if cin == features
                     else Conv1dSame(cin, features, 1, dtype=dtype))

    def forward(self, x):
        if self.pallas_conv:
            h = self.fused2(self.fused1(x))
        else:
            h = self.conv1(self.norm1(x))
            h = self.conv2(self.norm2(h))
        return (x if self.skip is None else self.skip(x)) + h


class SelfAttention1D(nn.Module):
    """Pre-norm multi-head self-attention with a residual, dispatched as
    ertdx/models/condunet.py:146-174 dispatches it; same parameters on
    every path. With `slab` and `use_pallas`, short unmasked sequences go
    through the packed-head slab attention. Otherwise, with `use_pallas`,
    the flash kernels engage when the padded length lp reaches
    FLASH_MIN_LEN or, with `flash_min_logits` > 0, when b h lp^2
    reaches it, b the global batch under a mesh (`global_rows`): q, k
    and v are zero-padded to lp, the pad keys masked and the output
    sliced back to l. Without them (or with `use_pallas` off)
    the plain attention runs on the raw length."""

    def __init__(self, channels: int, num_heads: int, slab: bool = False,
                 use_pallas: bool = True, flash_min_logits: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.slab = slab
        self.use_pallas = use_pallas
        self.flash_min_logits = flash_min_logits
        self.norm = LayerNorm(channels, LN_EPS, dtype)
        self.qkv = Dense(channels, 3 * channels, bias=False, dtype=dtype)
        self.out = Dense(channels, channels, dtype=dtype)

    def forward(self, x):
        b, l, c = x.shape
        qkv = self.qkv(self.norm(x))
        if (self.slab and c % self.num_heads == 0
                and pad128(l) < FLASH_MIN_LEN):
            fn = slab_attention if self.use_pallas else \
                reference_slab_attention
            return x + self.out(fn(qkv, self.num_heads))
        q, k, v = qkv.chunk(3, dim=-1)

        def heads(z):
            return z.reshape(b, l, self.num_heads, -1).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        lp = pad128(l)
        pallas_ok = self.use_pallas and (
            lp >= FLASH_MIN_LEN
            or (self.flash_min_logits > 0
                and global_rows(b) * self.num_heads * lp * lp
                >= self.flash_min_logits))
        if not pallas_ok:
            a = reference_attention(q, k, v)
        else:
            mask = None
            if lp != l:
                # pad only for the kernels: the plain path keeps the raw
                # length
                q, k, v = (F.pad(z, (0, 0, 0, lp - l)) for z in (q, k, v))
                mask = F.pad(torch.ones(b, l, device=x.device,
                                        dtype=x.dtype), (0, lp - l))
            a = flash_attention(q, k, v, mask)[:, :, :l]
        return x + self.out(a.transpose(1, 2).reshape(b, l, c))


class ConditionEncoder(nn.Module):
    """ERT (B, L, C) -> cond tokens (B, Lc, D) and cond vector (B, D).

    A ResBlock whose output width is at least `pallas_conv_min_width` (or
    every ResBlock, with `pallas_conv`) fuses its GN+SiLU+conv pairs
    (FusedGNConv, another parameter tree); the others run GNSiLU + conv,
    through the GN kernels with `pallas_gn`
    (ertdx/models/condunet.py:211-238)."""

    def __init__(self, cond_channels: int = 14, hidden_dim: int = 128,
                 base_width: int = 64, depth: int = 3, num_heads: int = 4,
                 patch: int = 8, attn_slab: bool = False,
                 pallas_gn: bool = False, pallas_conv: bool = False,
                 pallas_conv_min_width: int = 0, use_pallas: bool = True,
                 flash_min_logits: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch = patch
        self.pallas_conv = pallas_conv
        self.pallas_conv_min_width = pallas_conv_min_width

        def res(width):
            return ResBlock1D(width, width, pallas_gn=pallas_gn,
                              pallas_conv=self._conv_fused(width),
                              dtype=dtype)

        w0 = 2 * base_width
        self.stem = Dense(patch * cond_channels, w0, dtype=dtype)
        self.res = nn.ModuleList([res(w0)])
        self.downs = nn.ModuleList()
        w = w0
        for i in range(depth - 1):
            w_next = min(w0 * 2 ** (i + 1), 4 * base_width)
            self.downs.append(Conv1dSame(w, w_next, 3, stride=2,
                                         dtype=dtype))
            self.res.append(res(w_next))
            w = w_next
        self.attn = SelfAttention1D(w, num_heads, slab=attn_slab,
                                    use_pallas=use_pallas,
                                    flash_min_logits=flash_min_logits,
                                    dtype=dtype)
        self.res_out = res(w)
        self.tokens = Dense(w, hidden_dim, dtype=dtype)
        self.pool = Dense(hidden_dim, hidden_dim, dtype=dtype)

    def _conv_fused(self, width: int) -> bool:
        return self.pallas_conv or (self.pallas_conv_min_width > 0
                                    and width >= self.pallas_conv_min_width)

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
    """LayerNorm without affine (float32 statistics, output in `dtype`),
    then scale/shift from the conditioning."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.proj = Dense(dim, 2 * dim, dtype=dtype)

    def forward(self, x, c):
        h = F.layer_norm(x.to(torch.float32), x.shape[-1:],
                         eps=LN_EPS).to(self.compute_dtype)
        scale, shift = self.proj(F.silu(c)).chunk(2, dim=-1)
        return h * (1.0 + scale[:, None, :]) + shift[:, None, :]


class CoreBlock(nn.Module):
    """AdaLN-conditioned [self-attention, cross-attention to the condition
    tokens, MLP]. With fold > 1 the (B*fold, P, D) chains are condition-
    major and cross-attention folds them into the query length, so the
    condition's K/V are computed once per condition, never tiled.

    `ensemble_pallas` sends both attentions through ops/ensemble_attn.py
    when the block has one head, fold > 1 and at least
    `ensemble_min_chains` chains, counted over the global batch under a
    mesh (ertdx/models/condunet.py:315-340); those
    ops run their CUDA kernels (JAX's one-pass function, as JAX's kernels
    run on their chip) where their shape gate takes the tensors and the
    float32 plain version elsewhere. Same parameters either way."""

    def __init__(self, dim: int, num_heads: int = 1,
                 ensemble_pallas: bool = False,
                 ensemble_min_chains: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.ensemble_pallas = ensemble_pallas
        self.ensemble_min_chains = ensemble_min_chains
        self.ada1, self.ada2, self.ada3 = (AdaLN(dim, dtype)
                                           for _ in range(3))
        self.qkv = Dense(dim, 3 * dim, bias=False, dtype=dtype)
        self.self_out = Dense(dim, dim, dtype=dtype)
        self.cross_q = Dense(dim, dim, bias=False, dtype=dtype)
        self.cross_kv = Dense(dim, 2 * dim, bias=False, dtype=dtype)
        self.cross_out = Dense(dim, dim, dtype=dtype)
        self.mlp_in = Dense(dim, 4 * dim, dtype=dtype)
        self.mlp_out = Dense(4 * dim, dim, dtype=dtype)

    def _heads(self, z):
        n, l, d = z.shape
        return z.reshape(n, l, self.num_heads, d // self.num_heads
                         ).transpose(1, 2)

    def _unheads(self, z):
        n, _, l, _ = z.shape
        return z.transpose(1, 2).reshape(n, l, -1)

    def forward(self, x, cond_tokens, cvec, fold: int = 1):
        b, p, d = x.shape
        fused = (self.ensemble_pallas and self.num_heads == 1 and fold > 1
                 and global_rows(b) >= self.ensemble_min_chains)
        q, k, v = self.qkv(self.ada1(x, cvec)).chunk(3, dim=-1)
        if fused:
            a = block_self_attention(q, k, v, global_n=global_rows(b))
        else:
            a = self._unheads(attention(self._heads(q), self._heads(k),
                                        self._heads(v)))
        x = x + self.self_out(a)

        q = self.cross_q(self.ada2(x, cvec))
        bc = cond_tokens.shape[0]
        if fold > 1:
            q = q.reshape(bc, fold * p, d)   # condition-major: a view
        k, v = self.cross_kv(cond_tokens).chunk(2, dim=-1)
        if fused:
            a = folded_cross_attention(q, k, v).reshape(b, p, d)
        else:
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
                 parameterization: str = "eps", attn_slab: bool = False,
                 uncond_prob: float = 0.0, ensemble_pallas: bool = False,
                 ensemble_min_chains: int = 1024, pallas_gn: bool = False,
                 pallas_conv: bool = False, pallas_conv_min_width: int = 0,
                 use_pallas: bool = True, flash_min_logits: int = 0,
                 dtype: str = "float32"):
        super().__init__()
        dtype = compute_dtype(dtype)
        self.compute_dtype = dtype
        self.param_dim = param_dim
        self.hidden_dim = hidden_dim
        self.depth = depth
        self.patch = patch
        self.core_heads = core_heads
        self.num_blocks = num_blocks
        self.ensemble_mega = ensemble_mega
        self.ensemble_mega_accurate = ensemble_mega_accurate
        self.parameterization = parameterization
        self.uncond_prob = uncond_prob
        self.encoder = ConditionEncoder(cond_channels, hidden_dim,
                                        base_width, depth, num_heads, patch,
                                        attn_slab, pallas_gn, pallas_conv,
                                        pallas_conv_min_width, use_pallas,
                                        flash_min_logits, dtype)
        self.lift = Dense(1, hidden_dim, dtype=dtype)
        self.pos_emb = nn.Parameter(
            0.02 * torch.randn(param_dim, hidden_dim))
        self.time_mlp1 = Dense(hidden_dim, hidden_dim, dtype=dtype)
        self.time_mlp2 = Dense(hidden_dim, hidden_dim, dtype=dtype)
        self.blocks = nn.ModuleList(
            [CoreBlock(hidden_dim, core_heads, ensemble_pallas,
                       ensemble_min_chains, dtype)
             for _ in range(num_blocks)])
        # the final norm and the head stay float32, as in flax
        self.out_norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.head = nn.Linear(hidden_dim, 1)
        if uncond_prob > 0.0:
            # one learned null token broadcast over the condition tokens,
            # and a null conditioning vector (ertdx/models/condunet.py:
            # 433-446); they exist only when the model was trained with
            # condition dropout
            self.null_token = nn.Parameter(0.02 * torch.randn(hidden_dim))
            self.null_vec = nn.Parameter(torch.zeros(hidden_dim))

    def encode_condition(self, condition):
        return self.encoder(condition)

    def drop_condition(self, cond_ctx, drop: torch.Tensor):
        """Replace the dropped examples' context with the learned null
        context (ertdx/models/condunet.py:447-460). drop: (B,) bool; all
        True gives the unconditional branch of guided sampling. Needs
        uncond_prob > 0 at construction."""
        tokens, vec = cond_ctx
        nt = self.null_token.to(tokens.dtype)[None, None, :]
        nv = self.null_vec.to(vec.dtype)[None, :]
        return (torch.where(drop[:, None, None], nt, tokens),
                torch.where(drop[:, None], nv, vec))

    def embed_time(self, t: torch.Tensor) -> torch.Tensor:
        emb = get_timestep_embedding(t, self.hidden_dim)
        return self.time_mlp2(F.silu(self.time_mlp1(emb)))

    def denoise(self, x, t, cond_ctx):
        """Denoise (B, P) chains, one a condition."""
        return self.denoise_ensemble(x, t, cond_ctx, 1)

    def denoise_ensemble(self, x, t, cond_ctx, n_real: int):
        """Denoise (B*n_real, P) condition-major chains against a batch-B
        condition context, which is never tiled across the chains."""
        cond_tokens, cond_vec = cond_ctx
        cvec = self.embed_time(t) + (
            torch.repeat_interleave(cond_vec, n_real, dim=0)
            if n_real > 1 else cond_vec)
        tokens = self.lift(x[..., None]) + full_param(self, "pos_emb")[None]
        for blk in self.blocks:
            tokens = blk(tokens, cond_tokens, cvec, fold=n_real)
        return self.head(self.out_norm(tokens))[..., 0]

    def forward(self, x, t, condition):
        return self.denoise_ensemble(x, t, self.encode_condition(condition),
                                     1)


# flax: variance_scaling(1, "fan_in", "truncated_normal") divides by the
# standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978
# leaves flax initialises to zero (ertdx/models/condunet.py:257, 328, 344,
# 350, 432): AdaLN projections, attention output projections, MLP output
# and the head
_ZERO_KERNELS = ("ada1.proj", "ada2.proj", "ada3.proj", "self_out",
                 "cross_out", "mlp_out")
_NORMS = (GNSiLU, nn.LayerNorm)


def _lecun_normal(shape, fan_in: int, generator: torch.Generator):
    """flax lecun_normal: N(0, 1/fan_in) truncated to +-2 sigma, rescaled
    so that the draw's standard deviation is sqrt(1/fan_in)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    u = (2.0 * lo - 1.0) + u * (2.0 - 4.0 * lo)   # in (erf(-2/sqrt2), ...)
    return (torch.erfinv(u) * math.sqrt(2.0) * std).to(torch.float32)


@torch.no_grad()
def init_params(model: CondUNet, generator: torch.Generator) -> CondUNet:
    """Initialise `model` in place as flax initialises the JAX CondUNet, in
    distribution: lecun-normal Dense, Conv and FusedGNConv kernels (Conv
    fan_in is k * c_in), zero biases, zero AdaLN / output projections and
    head,
    unit norm scales, pos_emb and null_token from N(0, 0.02^2), null_vec
    zero. Draws on the CPU from `generator`, in named_parameters order,
    then copies to the model's device. Returns the model."""
    for mod_name, mod in model.named_modules():
        if isinstance(mod, _NORMS):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, FusedGNConv):
            mod.gn_scale.fill_(1.0)
            mod.gn_bias.zero_()
            k = mod.kernel
            k.copy_(_lecun_normal(tuple(k.shape), k.shape[0] * k.shape[1],
                                  generator))
            mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv1d)):
            zero = mod_name == "head" or (
                mod_name.startswith("blocks.")
                and mod_name.split(".", 2)[2] in _ZERO_KERNELS)
            if zero:
                mod.weight.zero_()
            else:
                w = mod.weight
                fan_in = w.shape[1] * (w.shape[2] if w.dim() == 3 else 1)
                w.copy_(_lecun_normal(tuple(w.shape), fan_in, generator))
            if mod.bias is not None:
                mod.bias.zero_()
    model.pos_emb.copy_(0.02 * torch.randn(
        tuple(model.pos_emb.shape), generator=generator))
    if model.uncond_prob > 0.0:
        model.null_token.copy_(0.02 * torch.randn(
            tuple(model.null_token.shape), generator=generator))
        model.null_vec.zero_()
    return model
