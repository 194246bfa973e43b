"""Fused GroupNorm + SiLU: wrappers, plain version, launch counts.

`groupnorm_silu` ports the TPU kernels of ertdx/ops/groupnorm.py
(`_gn_silu_kernel` :47-76, `_gn_silu_bwd_kernel` :95-131) to the
hand-written CUDA kernels of csrc/groupnorm.cu and csrc/gn_common.cuh:

    x  (B, L, C)  feature-last, C divisible by num_groups
    y  (B, L, C)  silu(gamma * GN(x) + beta), statistics per (row, group)
                  over L and the group's channels, eps inside the rsqrt
    backward      dx (B, L, C), dgamma and dbeta (C,) summed over B

On CUDA tensors the forward launches the forward kernel and the backward
the backward kernels; on CPU tensors both are the plain version under
autograd. `launch_plan` picks, by shape, the staged kernels (the group
copied into shared memory, device memory read once) or the streamed ones
(groups too large to stage); both are hand-written, and the plan is
checked again in C. The kernels take x and the upstream gradient on
16-byte boundaries (the wrappers raise on anything else, the autograd
path copies a misaligned one). A failed build or launch raises: nothing
falls back. Channels not divisible by the groups raise ValueError on
every device, as in JAX (:176-182). `launches` counts the float32
kernels' launches and `launches_bf16` the bfloat16 kernels', one a
forward and one a backward whichever kernel ran, and nothing else.

The kernels dispatch on x's dtype, as the TPU kernels take any input
dtype (:51, 74, 104-105, 163-170): a bfloat16 x (a bf16 model's
encoder) and its upstream gradient run the same kernels instantiated on
bf16 (csrc/gn_common.cuh), which convert on load, compute in float32 and
round y and dx once to bf16; dgamma and dbeta stay float32. The plain
version computes in those dtypes too and is the bf16 kernels' oracle.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

launches = {"groupnorm_silu_fwd": 0, "groupnorm_silu_bwd": 0}
launches_bf16 = {"groupnorm_silu_fwd_bf16": 0, "groupnorm_silu_bwd_bf16": 0}

SMEM_MAX = 232_448        # shared memory an H100 block may use, bytes
STREAM_THREADS = 256      # the streamed kernels' block (GN_THREADS)
MAX_THREADS = 512         # the staged kernels' largest block
# groups staged per kind (the statistics and the forward stage x, the
# backward x and the upstream gradient), the block sums each takes (a
# float a warp each), and the block size each aims at
TILES = {"stats": 1, "fwd": 1, "bwd": 2}
SUMS = {"stats": 2, "fwd": 2, "bwd": 4}
TARGET_THREADS = {"stats": 256, "fwd": 256, "bwd": 256}


class Plan(NamedTuple):
    """How a GN kernel launches: "staged" or "streamed", the block size
    and the dynamic shared-memory bytes (0 when streamed)."""
    path: str
    threads: int
    smem_bytes: int

    def args(self) -> tuple:
        """The plan as the C entry points take it."""
        return int(self.path == "staged"), self.threads, self.smem_bytes


def unit_width(cg: int, itemsize: int = 4) -> int:
    """Channels of a staged thread's unit (gn_common.cuh::gn_width): a
    float4 of float32 x where the group's channels divide by 4, 16 bytes
    (8 values) of bf16 x where they divide by 8, else one."""
    wide = 4 if itemsize == 4 else 8
    return wide if cg % wide == 0 else 1


def tile_bytes(values: int, itemsize: int) -> int:
    """Bytes of a staged tile (gn_common.cuh::gn_tile_bytes): float32
    tiles as they are, bf16 tiles rounded up to 16."""
    return 4 * values if itemsize == 4 else -(-2 * values // 16) * 16


def launch_plan(length: int, channels: int, num_groups: int, kind: str,
                itemsize: int = 4, grad_itemsize: int = 0) -> Plan:
    """The kernel for a (row, group) of `length` x channels / num_groups
    values, for `kind` "fwd", "bwd" or "stats" (the fused conv's), x of
    `itemsize` bytes a value (4 float32, 2 bf16) and, in the backward, an
    upstream gradient of `grad_itemsize` (x's when 0; the fused conv's
    float32 dh beside a bf16 x): staged where its tiles fit in SMEM_MAX
    (gn_common.cuh::gn_staged_bytes), else streamed. A staged block's
    threads each own one unit of channels (`unit_width`), so its size is
    a multiple of the units a position and of a warp, near
    TARGET_THREADS[kind]."""
    cg = channels // num_groups
    units = cg // unit_width(cg, itemsize)
    step = units * 32 // math.gcd(units, 32)
    if step <= MAX_THREADS:
        threads = step * max(1, TARGET_THREADS[kind] // step)
        count = threads // 32 if 32 % units == 0 else threads // units
        chan = 2 * cg * count if kind == "bwd" else 0
        n = length * cg
        tiles = tile_bytes(n, itemsize) + (
            tile_bytes(n, grad_itemsize or itemsize) if TILES[kind] == 2
            else 0)
        smem = tiles + 4 * (SUMS[kind] * threads // 32 + chan)
        if smem <= SMEM_MAX:
            return Plan("staged", threads, smem)
    return Plan("streamed", STREAM_THREADS, 0)


def reset_launches() -> None:
    for counts in (launches, launches_bf16):
        for name in counts:
            counts[name] = 0


def check_groups(channels: int, num_groups: int) -> None:
    if channels % num_groups:
        raise ValueError(f"channels {channels} not divisible by "
                         f"num_groups {num_groups}")


def reference_groupnorm_silu(x: torch.Tensor, gamma: torch.Tensor,
                             beta: torch.Tensor, num_groups: int,
                             eps: float = 1e-5) -> torch.Tensor:
    """The plain version (ertdx/ops/groupnorm.py:24-34): statistics over
    (L, C/G) per row and group, biased variance, then affine and SiLU, in
    float32 or wider (a bf16 x is upcast, a float64 one kept); the result
    in x's dtype."""
    b, l, c = x.shape
    check_groups(c, num_groups)
    xg = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(
        b, l, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), unbiased=False, keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, l, c)
    return F.silu(xn * gamma + beta).to(x.dtype)


def reference_groupnorm_silu_backward(x, gamma, beta, g, num_groups: int,
                                      eps: float = 1e-5):
    """(dx, dgamma, dbeta) of the plain version by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, gamma, beta)]
        out = reference_groupnorm_silu(*leaves, num_groups, eps)
        return torch.autograd.grad(out, leaves, g)


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _checked(x, gamma, beta, num_groups, extra=()):
    if x.dim() != 3:
        raise ValueError(f"x: expected (B, L, C), got {tuple(x.shape)}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"x: the kernels take float32 or bfloat16, got "
                        f"{str(x.dtype).replace('torch.', '')}")
    b, l, c = x.shape
    check_groups(c, num_groups)
    _build.check_cuda("x", x, (b, l, c), x.dtype)
    _build.check_cuda("gamma", gamma, (c,))
    _build.check_cuda("beta", beta, (c,))
    for name, t in extra:
        _build.check_cuda(name, t, (b, l, c), x.dtype)
    if any(t.device != x.device for t in (gamma, beta, *(t for _, t in
                                                          extra))):
        raise ValueError("all tensors must lie on one CUDA device")
    _build.check_aligned16(x=x, **dict(extra))
    return b, l, c


def _entry(x, name: str):
    """The C entry point and the launch-count dict of x's dtype."""
    bf16 = x.dtype == torch.bfloat16
    lib = _build.load().lib
    entry = getattr(lib, f"ertdx_gn_silu_{name}" + ("_bf16" if bf16 else ""))
    return entry, (launches_bf16 if bf16 else launches), \
        f"groupnorm_silu_{name}" + ("_bf16" if bf16 else "")


def groupnorm_silu_fwd(x, gamma, beta, num_groups: int,
                       eps: float = 1e-5) -> torch.Tensor:
    """The forward kernel: (B, L, C) -> (B, L, C) in x's dtype (float32
    or bfloat16). One launch on the current stream."""
    b, l, c = _checked(x, gamma, beta, num_groups)
    out = torch.empty_like(x)
    plan = launch_plan(l, c, num_groups, "fwd", x.element_size())
    entry, counts, name = _entry(x, "fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = entry(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                   out.data_ptr(), b, l, c, num_groups, eps, *plan.args(),
                   stream)
    _build.raise_on(rc, name)
    counts[name] += 1
    return out


def groupnorm_silu_bwd(x, gamma, beta, g, num_groups: int,
                       eps: float = 1e-5):
    """The backward kernels: (dx, dgamma, dbeta) for upstream gradient g
    (B, L, C) in x's dtype; dx in x's dtype, dgamma and dbeta float32.
    Two launches on the current stream (the per-(row, group) pass, then
    the sum over B), counted as one backward."""
    b, l, c = _checked(x, gamma, beta, num_groups, (("g", g),))
    dx = torch.empty_like(x)
    part = torch.empty(b, 2, c, device=x.device, dtype=torch.float32)
    dgb = torch.empty(2, c, device=x.device, dtype=torch.float32)
    plan = launch_plan(l, c, num_groups, "bwd", x.element_size())
    entry, counts, name = _entry(x, "bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = entry(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                   g.data_ptr(), dx.data_ptr(), part.data_ptr(),
                   dgb.data_ptr(), b, l, c, num_groups, eps, *plan.args(),
                   stream)
    _build.raise_on(rc, name)
    counts[name] += 1
    return dx, dgb[0], dgb[1]


class _GroupNormSiLU(torch.autograd.Function):
    """Forward and backward on the CUDA kernels."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps):
        ctx.num_groups, ctx.eps = num_groups, eps
        ctx.save_for_backward(x, gamma, beta)
        return groupnorm_silu_fwd(x, gamma, beta, num_groups, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        dx, dgamma, dbeta = groupnorm_silu_bwd(x, gamma, beta,
                                               _build.contiguous16(g),
                                               ctx.num_groups, ctx.eps)
        return dx, dgamma, dbeta, None, None


def groupnorm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """silu(GroupNorm(x)) with a gradient, in x's dtype: the CUDA kernels
    on a CUDA tensor (float32 or bfloat16), the plain version on a CPU
    tensor."""
    check_groups(x.shape[-1], num_groups)
    if x.device.type == "cpu":
        return reference_groupnorm_silu(x, gamma, beta, num_groups, eps)
    return _GroupNormSiLU.apply(_build.contiguous16(x), gamma.contiguous(),
                                beta.contiguous(), num_groups, eps)
