"""Fused GroupNorm + SiLU + Conv1d(k=3): wrappers, plain version, launch
counts.

`gn_silu_conv3` ports the TPU kernels of ertdx/ops/conv.py
(`_gn_silu_conv3_kernel` :49-82, `_gn_silu_conv3_bwd_kernel` :109-180)
to the hand-written CUDA kernels of csrc/gn_conv.cu:

    x     (B, L, C)       C divisible by num_groups
    w     (3, C, Cout)    the flax kernel layout (tap, in, out)
    bias  (Cout,)
    y     (B, L, Cout)    conv3_SAME(silu(GN(x)), w) + bias
    backward              dx, dgamma, dbeta, dW (3, C, Cout), db (Cout,),
                          all summed over the batch in the kernels

On CUDA tensors the forward and backward launch their kernels (the
kernels take Cout a multiple of 4, B up to 65535 and x, beta, w, bias
and g starting on 16-byte boundaries, which they stage with cp.async; the
wrappers raise on anything else, and the autograd path copies a
misaligned operand); on CPU tensors both are the plain version under
autograd. A failed build or launch raises: nothing falls back. Channels
not divisible by the groups raise ValueError on every device, as in JAX
(:237-243). `launches` counts the float32 kernels' launches and
`launches_bf16` the bfloat16 kernels', and nothing else.

The kernels dispatch on x's dtype. A bfloat16 x (a bf16 model's
encoder) runs the bf16 kernels of csrc/gn_conv.cu, the TPU kernel's
arithmetic (its taps at DEFAULT precision, one bf16 MXU pass a product,
ertdx/ops/conv.py:15-17): float32 statistics and GN+SiLU, h rounded to
bf16, the weight rounded to bf16 once a call (here, before the launch,
into the forward's K-major (3, Cout, C) copy), one pass of Hopper's
bf16 wgmma a product with float32 accumulation, the bias added in
float32 and y rounded once to bf16; the backward's dh stays float32
(:166-171) and dx comes out in bf16; dgamma, dbeta, dW and db are float32.
They take C and Cout multiples of 8. The plain version follows JAX's
reference dtype rule on any input (h in x's dtype, the weight cast to
h's dtype and the bias to the product's, :42-46): on float32 it is the
float32 function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .groupnorm import check_groups, launch_plan, reference_groupnorm_silu

launches = {"gn_silu_conv3_fwd": 0, "gn_silu_conv3_bwd": 0}
launches_bf16 = {"gn_silu_conv3_fwd_bf16": 0, "gn_silu_conv3_bwd_bf16": 0}
MAX_BATCH = 65535          # the GEMM grid's z dimension


def reset_launches() -> None:
    for counts in (launches, launches_bf16):
        for name in counts:
            counts[name] = 0


def reference_gn_silu_conv3(x, gamma, beta, w, bias, num_groups: int,
                            eps: float = 1e-5) -> torch.Tensor:
    """The plain version (ertdx/ops/conv.py:39-46): GN+SiLU in x's dtype,
    then a k=3 stride-1 "SAME" conv (one zero row each side) with the
    weight cast to h's dtype, and the bias cast to the product's dtype,
    as JAX's reference casts them."""
    h = reference_groupnorm_silu(x, gamma, beta, num_groups, eps)
    # contiguous operands, padded as models/condunet.Conv1dSame pads: with
    # the permuted weight view cuDNN picked FFT algorithms that took
    # 200 ms for one backward at (256, 147, 256) on an H100
    hp = F.pad(h.transpose(1, 2), (1, 1))
    wt = w.permute(2, 1, 0).contiguous().to(h.dtype)
    if bias.dtype == h.dtype:    # the float32 function: bias in the conv
        return F.conv1d(hp, wt, bias).transpose(1, 2)
    y = F.conv1d(hp, wt)
    return (y + bias.to(y.dtype)[:, None]).transpose(1, 2)


def reference_gn_silu_conv3_backward(x, gamma, beta, w, bias, g,
                                     num_groups: int, eps: float = 1e-5):
    """(dx, dgamma, dbeta, dW, db) of the plain version by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, gamma, beta, w, bias)]
        out = reference_gn_silu_conv3(*leaves, num_groups, eps)
        return torch.autograd.grad(out, leaves, g)


def _checked(x, gamma, beta, w, num_groups, bias=None, g=None):
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x (B, L, C) and w (3, C, Cout) expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: the kernels take float32 or bfloat16, got "
                        f"{str(x.dtype).replace('torch.', '')}")
    b, l, c = x.shape
    cout = w.shape[-1]
    check_groups(c, num_groups)
    mult = 4 if x.dtype == torch.float32 else 8
    if cout % mult or c % mult or b > MAX_BATCH:
        raise ValueError(f"the fused conv kernels take C and Cout each a "
                         f"multiple of {mult} on "
                         f"{str(x.dtype).replace('torch.', '')} and B <= "
                         f"{MAX_BATCH}, got C={c}, Cout={cout}, B={b}")
    _build.check_cuda("x", x, (b, l, c), x.dtype)
    _build.check_cuda("gamma", gamma, (c,))
    _build.check_cuda("beta", beta, (c,))
    _build.check_cuda("w", w, (3, c, cout))
    staged = {"x": x, "beta": beta, "w": w}    # read by 16-byte cp.async
    if bias is not None:
        _build.check_cuda("bias", bias, (cout,))
        staged["bias"] = bias
    if g is not None:
        _build.check_cuda("g", g, (b, l, cout), x.dtype)
        staged["g"] = g
    if any(t.device != x.device for t in (gamma, *staged.values())):
        raise ValueError("all tensors must lie on one CUDA device")
    _build.check_aligned16(**staged)
    return b, l, c, cout


def _entry(x, name: str):
    """The C entry point, the launch-count dict and the kernel's name for
    x's dtype."""
    bf16 = x.dtype == torch.bfloat16
    suffix = "_bf16" if bf16 else ""
    lib = _build.load().lib
    return getattr(lib, f"ertdx_gn_conv3_{name}{suffix}"), \
        (launches_bf16 if bf16 else launches), \
        f"gn_silu_conv3_{name}{suffix}"


def _kernel_weight(w, x, forward: bool):
    """w as the kernels read it: float32 for a float32 x. For a bf16 x
    rounded to bf16 once (to nearest even), as the TPU's one-pass MXU
    product rounds its operand, in the K-major layout of the wgmma GEMMs'
    B operand, (3, N, K): the forward's as (3, Cout, C), w[j] transposed,
    in the same one pass that rounds it; dh's is w's own (3, C, Cout)."""
    if x.dtype == torch.float32:
        return w
    if not forward:
        return w.to(torch.bfloat16)
    wk = torch.empty(w.shape[0], w.shape[2], w.shape[1], device=w.device,
                     dtype=torch.bfloat16)
    return wk.copy_(w.transpose(1, 2))


def stats_floats(b: int, num_groups: int, c: int) -> int:
    """Floats of the kernels' statistics scratch: the (B, G, 2) mean and
    rstd, padded to 16 bytes, then the (B, C, 2) table of each (row,
    channel)'s group mean and rstd * gamma that the GEMMs read."""
    return (2 * b * num_groups + 3) // 4 * 4 + 2 * b * c


def gn_silu_conv3_fwd(x, gamma, beta, w, bias, num_groups: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """The forward kernels: (B, L, C) -> (B, L, Cout) in x's dtype
    (float32 or bfloat16). Three launches on the current stream
    (statistics, their per-channel table, then the fused GEMM), counted
    as one."""
    b, l, c, cout = _checked(x, gamma, beta, w, num_groups, bias=bias)
    out = torch.empty(b, l, cout, device=x.device, dtype=x.dtype)
    stats = torch.empty(stats_floats(b, num_groups, c), device=x.device,
                        dtype=torch.float32)
    wk = _kernel_weight(w, x, forward=True)
    entry, counts, name = _entry(x, "fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = entry(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                   wk.data_ptr(), bias.data_ptr(), out.data_ptr(),
                   stats.data_ptr(), b, l, c, cout, num_groups, eps,
                   *launch_plan(l, c, num_groups, "stats",
                                x.element_size()).args(), stream)
    _build.raise_on(rc, name)
    counts[name] += 1
    return out


def dw_splits(b: int, c: int, cout: int, sms: int) -> int:
    """How many ways the dW reduction splits the B L rows: as many
    blocks of 64 input by 128 output channels as fit on the card at once
    (one per SM at the kernel's register count), never a second wave, at
    most one split per batch row."""
    tiles = -(-c // 64) * -(-cout // 128)
    return max(1, min(b, sms // tiles))


def gn_silu_conv3_bwd(x, gamma, beta, w, g, num_groups: int,
                      eps: float = 1e-5):
    """The backward kernels: (dx, dgamma, dbeta, dW, db) for upstream
    gradient g (B, L, Cout) in x's dtype; dx in x's dtype, the rest
    float32. Seven launches on the current stream (statistics and their
    per-channel table, dW partials, their sum, dh, the GN backward and
    its sum over B), counted as one backward."""
    b, l, c, cout = _checked(x, gamma, beta, w, num_groups, g=g)
    dev = x.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = dw_splits(b, c, cout, sms)
    nw = 3 * c * cout + cout

    def empty(*shape):
        return torch.empty(*shape, device=dev, dtype=torch.float32)

    dx, dgb, dwb = torch.empty_like(x), empty(2, c), empty(nw)
    stats, dh = empty(stats_floats(b, num_groups, c)), empty(b, l, c)
    part_w, part_gn = empty(splits, nw), empty(b, 2, c)
    wk = _kernel_weight(w, x, forward=False)
    size = x.element_size()
    entry, counts, name = _entry(x, "bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wk.data_ptr(),
            g.data_ptr(), dx.data_ptr(), dgb.data_ptr(), dwb.data_ptr(),
            stats.data_ptr(), dh.data_ptr(), part_w.data_ptr(),
            part_gn.data_ptr(), b, l, c, cout, num_groups, splits, eps,
            *launch_plan(l, c, num_groups, "stats", size).args(),
            *launch_plan(l, c, num_groups, "bwd", size, 4).args(), stream)
    _build.raise_on(rc, name)
    counts[name] += 1
    return (dx, dgb[0], dgb[1], dwb[:3 * c * cout].view(3, c, cout),
            dwb[3 * c * cout:])


class _GNSiLUConv3(torch.autograd.Function):
    """Forward and backward on the CUDA kernels."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, num_groups, eps):
        ctx.num_groups, ctx.eps = num_groups, eps
        ctx.save_for_backward(x, gamma, beta, w)
        return gn_silu_conv3_fwd(x, gamma, beta, w, bias, num_groups, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, w = ctx.saved_tensors
        grads = gn_silu_conv3_bwd(x, gamma, beta, w, _build.contiguous16(g),
                                  ctx.num_groups, ctx.eps)
        return (*grads, None, None)


def gn_silu_conv3(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  w: torch.Tensor, bias: torch.Tensor, num_groups: int,
                  eps: float = 1e-5) -> torch.Tensor:
    """conv3_SAME(silu(GN(x)), w) + bias with a gradient, in x's dtype:
    the CUDA kernels on a CUDA tensor (float32 or bfloat16), the plain
    version on a CPU tensor."""
    check_groups(x.shape[-1], num_groups)
    if x.device.type == "cpu":
        return reference_gn_silu_conv3(x, gamma, beta, w, bias, num_groups,
                                       eps)
    c16 = _build.contiguous16
    return _GNSiLUConv3.apply(c16(x), gamma.contiguous(), c16(beta), c16(w),
                              c16(bias), num_groups, eps)
