"""Fused GroupNorm + SiLU + Conv1d(k=3): wrappers, plain versions, launch
counts, route.

`gn_silu_conv3` ports the TPU kernels of ertdx/ops/conv.py
(`_gn_silu_conv3_kernel` :49-82, `_gn_silu_conv3_bwd_kernel` :109-180)
to the hand-written CUDA kernels of csrc/gn_conv.cu:

    x     (B, L, C)       C divisible by num_groups
    w     (3, C, Cout)    the flax kernel layout (tap, in, out)
    bias  (Cout,)
    y     (B, L, Cout)    conv3_SAME(silu(GN(x)), w) + bias
    backward              dx, dgamma, dbeta, dW (3, C, Cout), db (Cout,),
                          all summed over the batch in the kernels

The TPU kernels run their tap products at DEFAULT precision (one bf16 MXU
pass a product, ertdx/ops/conv.py:15-17; no precision argument at
:79-81, :153-161, :166-171) and their GroupNorm statistics at HIGHEST.
That one-pass function is what a CUDA tensor gets, float32 or bfloat16:
float32 statistics and GN+SiLU, h rounded to bf16 (to nearest even), the
weight rounded to bf16 once a call (here, before the launch, into the
forward's K-major (3, Cout, C) copy), one pass of Hopper's bf16 wgmma a
product with float32 sums, the bias added in float32 and y in x's dtype;
the backward's dW from bf16(h) and bf16(g), db the float32 sum of g as it
comes (:150), dh = bf16(g) bf16(w)^T taps in float32 (:166-171), then the
GN backward in float32, dx in x's dtype; dgamma, dbeta, dW and db
float32. `reference_gn_silu_conv3_onepass` and its backward are that
function written out (`GNSiLUConv3OnepassPlain` under autograd), the
kernels' oracle.

The route (`conv_route`, on `_build.route`): JAX's kernel takes every
shape whose channels the groups divide (its gate is only `use_pallas`
on its TPU, :247, :258); channels the groups do not divide raise
ValueError on every device, as in JAX (:237-243). A CPU tensor gets the
float32 plain version (`reference_gn_silu_conv3`), what JAX's path
computes off its TPU. A CUDA tensor runs the kernels where they take the
shape (C and Cout multiples of 8, B up to 65535; x, beta, w, bias and g
on 16-byte boundaries, which the autograd path copies to), else the plain
one-pass version on the card, warned once per shape. A failed build or
launch raises: nothing falls back. `launches` counts the float32 kernels'
launches and `launches_bf16` the bfloat16 kernels', and nothing else.
The plain version follows JAX's reference dtype rule on any input (h in
x's dtype, the weight cast to h's dtype and the bias to the product's,
:42-46): on float32 it is the float32 function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .core_block import round_bf16
from .groupnorm import (check_groups, launch_plan, reference_groupnorm_silu,
                        reference_groupnorm_silu_backward)

launches = {"gn_silu_conv3_fwd": 0, "gn_silu_conv3_bwd": 0}
launches_bf16 = {"gn_silu_conv3_fwd_bf16": 0, "gn_silu_conv3_bwd_bf16": 0}
MAX_BATCH = 65535          # the kernels' batch limit (conv_shape_ok)


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


def reference_gn_silu_conv3_onepass(x, gamma, beta, w, bias,
                                    num_groups: int,
                                    eps: float = 1e-5) -> torch.Tensor:
    """The TPU kernel's one-pass forward (ertdx/ops/conv.py:49-82 at
    DEFAULT precision): GN+SiLU in float32, h and w rounded to bf16, the
    exact products summed in float32, the bias added in float32, y in x's
    dtype. A float64 x keeps float64 (the same roundings, other sums)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    h = reference_groupnorm_silu(x.to(ct), gamma.to(ct), beta.to(ct),
                                 num_groups, eps)
    hp = F.pad(round_bf16(h), (0, 0, 1, 1))
    wq = round_bf16(w.to(ct))
    length = x.shape[1]
    # the three shifted products, added as JAX's kernel adds them (:79-81)
    y = (hp[:, :length] @ wq[0] + hp[:, 1:length + 1] @ wq[1]
         + hp[:, 2:] @ wq[2])
    return (y + bias.to(ct)).to(x.dtype)


def reference_gn_silu_conv3_onepass_backward(x, gamma, beta, w, bias, g,
                                             num_groups: int,
                                             eps: float = 1e-5):
    """(dx, dgamma, dbeta, dW, db) of the TPU kernel's one-pass backward
    (ertdx/ops/conv.py:109-180), written out: dW[k] = sum shift_k(bf16(h))^T
    bf16(g) and dh = the taps of bf16(g) bf16(w)^T, each summed in
    float32; db the float32 sum of g; then the SiLU chain rule and the GN
    backward in float32 from dh. dx in x's dtype, the rest float32 (a
    float64 x: float64 throughout)."""
    b, length, c = x.shape
    ct = torch.promote_types(x.dtype, torch.float32)
    xf, gf, gamma, beta = x.to(ct), g.to(ct), gamma.to(ct), beta.to(ct)
    h = reference_groupnorm_silu(xf, gamma, beta, num_groups, eps)
    hp = F.pad(round_bf16(h), (0, 0, 1, 1))
    gq = round_bf16(gf)
    wq = round_bf16(w.to(ct))
    rows = gq.reshape(-1, gq.shape[-1])
    dw = torch.stack([hp[:, k:k + length].reshape(-1, c).T @ rows
                      for k in range(3)])
    gp = F.pad(gq, (0, 0, 1, 1))
    dh = (gp[:, 2:] @ wq[0].T + gq @ wq[1].T + gp[:, :length] @ wq[2].T)
    dx, dgamma, dbeta = reference_groupnorm_silu_backward(
        xf, gamma, beta, dh, num_groups, eps)
    return dx.to(x.dtype), dgamma, dbeta, dw, gf.sum(dim=(0, 1))


class GNSiLUConv3OnepassPlain(torch.autograd.Function):
    """The plain one-pass version with its explicit backward, as JAX's
    custom VJP runs its own backward kernel: the kernels' oracle, and the
    route of a CUDA shape JAX's kernel takes and the port's do not."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, num_groups, eps):
        ctx.num_groups, ctx.eps = num_groups, eps
        ctx.save_for_backward(x, gamma, beta, w, bias)
        return reference_gn_silu_conv3_onepass(x, gamma, beta, w, bias,
                                               num_groups, eps)

    @staticmethod
    def backward(ctx, g):
        grads = reference_gn_silu_conv3_onepass_backward(
            *ctx.saved_tensors, g, ctx.num_groups, ctx.eps)
        return (*grads, None, None)


def conv_route(b: int, l: int, c: int, cout: int, num_groups: int,
               device) -> str:
    """Where gn_silu_conv3 computes (`_build.route`'s rule): "kernel",
    "onepass_plain" or "float32". JAX's kernel takes every shape whose
    channels the groups divide (`check_groups` raises on the rest); the
    port's kernels take C and Cout multiples of 8 and B <= MAX_BATCH."""
    check_groups(c, num_groups)
    return _build.route(device, False, True, kernels_take(b, c, cout))


def kernels_take(b: int, c: int, cout: int) -> bool:
    """The kernels' shape check (csrc/gn_conv.cu::conv_shape_ok, beside
    the groups): C and Cout multiples of 8, B <= MAX_BATCH."""
    return c % 8 == 0 and cout % 8 == 0 and cout > 0 and b <= MAX_BATCH


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
    _build.check_cuda("x", x, (b, l, c), x.dtype)
    if not kernels_take(b, c, cout):
        raise ValueError(f"the fused conv kernels take C and Cout each a "
                         f"multiple of 8 and B <= {MAX_BATCH}, got C={c}, "
                         f"Cout={cout}, B={b}")
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


def _kernel_weight(w, forward: bool):
    """w as the kernels read it: rounded to bf16 once (to nearest even),
    as the TPU's one-pass MXU product rounds its operand, in the K-major
    layout of the wgmma GEMMs' B operand, (3, N, K): the forward's as (3,
    Cout, C), w[j] transposed, in the same one pass that rounds it; dh's
    is w's own (3, C, Cout)."""
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
    wk = _kernel_weight(w, forward=True)
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


def db_splits(m: int, sms: int) -> int:
    """How many blocks round a float32 g to bf16 and sum db's partials
    over its m = B L rows: one an SM, each at least 64 rows."""
    return max(1, min(sms, -(-m // 64)))


def gn_silu_conv3_bwd(x, gamma, beta, w, g, num_groups: int,
                      eps: float = 1e-5):
    """The backward kernels: (dx, dgamma, dbeta, dW, db) for upstream
    gradient g (B, L, Cout) in x's dtype; dx in x's dtype, the rest
    float32. Seven launches on the current stream (statistics and their
    per-channel table, dW partials, their sum, dh, the GN backward and
    its sum over B), and on a float32 x two more first (bf16(g) with db's
    partials, and their sum), counted as one backward."""
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
    wk = _kernel_weight(w, forward=False)
    size = x.element_size()
    entry, counts, name = _entry(x, "bwd")
    scratch, pieces = (), ()
    if x.dtype == torch.float32:    # bf16(g) and db's partials
        pieces = (db_splits(b * l, sms),)
        gq = torch.empty(b, l, cout, device=dev, dtype=torch.bfloat16)
        part_db = empty(*pieces, cout)
        scratch = (gq.data_ptr(), part_db.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wk.data_ptr(),
            g.data_ptr(), dx.data_ptr(), dgb.data_ptr(), dwb.data_ptr(),
            stats.data_ptr(), dh.data_ptr(), part_w.data_ptr(),
            part_gn.data_ptr(), *scratch, b, l, c, cout, num_groups,
            splits, *pieces, eps,
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
    """conv3_SAME(silu(GN(x)), w) + bias with a gradient, in x's dtype, by
    `conv_route`: the CUDA kernels (the TPU kernel's one-pass function) on
    a CUDA tensor of a shape they take, the plain one-pass version, warned,
    on one they do not, the float32 plain version on a CPU tensor."""
    b, l, c = x.shape
    cout = w.shape[-1]
    route = conv_route(b, l, c, cout, num_groups, x.device)
    if route == "float32":
        return reference_gn_silu_conv3(x, gamma, beta, w, bias, num_groups,
                                       eps)
    if route == "onepass_plain":
        _build.warn_onepass_plain("gn_silu_conv3", (b, l, c, cout))
        return GNSiLUConv3OnepassPlain.apply(x, gamma, beta, w, bias,
                                             num_groups, eps)
    c16 = _build.contiguous16
    return _GNSiLUConv3.apply(c16(x), gamma.contiguous(), c16(beta), c16(w),
                              c16(bias), num_groups, eps)
