"""Ensemble attention for the per-block denoiser core: wrappers, plain
versions, launch counts.

`block_self_attention` and `folded_cross_attention` port the TPU kernels
of ertdx/ops/ensemble_attn.py (`_block_self_kernel` :89-112, called at
:123; `_folded_cross_kernel` :187-202, called at :221) to the
hand-written CUDA kernels of csrc/ensemble_attn.cu. Both compute
softmax(q k^T / sqrt(D)) v with one head:

    block_self_attention    q, k, v (N, P, D) -> (N, P, D), per chain
    folded_cross_attention  q (B, Lq, D), k, v (B, Lk, D) -> (B, Lq, D),
                            per condition (the chains folded into Lq)

q, k and v may be row-strided views (the chunks of a fused QKV or KV
projection): their last axis must be contiguous and their rows evenly
spaced, 16 bytes apart at least and on 16-byte boundaries. The output is
contiguous, in q's dtype.

The kernels compute JAX's kernels' function as they run on their chip:
every product at `Precision.DEFAULT` (ertdx/ops/ensemble_attn.py:59),
i.e. ONE bf16 pass with float32 accumulation. Its operands are rounded
to bf16 to nearest even where JAX's kernel body rounds them
(`reference_attention_onepass`): q scaled by 1/sqrt(D) in float32, then
rounded; k and v rounded; the softmax in float32 over the unpadded keys,
normalised, then rounded for P V. float32 and bfloat16 q, k, v (one dtype
for all three) are loaded as they are, with no copy; the output is
written in q's dtype, as JAX's `out.astype(o_ref.dtype)`. JAX's kernel
has no float32 mode, so neither has the port's: `ensemble_pallas` is the
only switch, as in JAX.

JAX's gate chooses the function, the port's gate only the route
(`block_self_route`, `folded_cross_route`). Where JAX's gate, evaluated
as on its TPU (`tpu_block_self_attention_ok`,
`tpu_folded_cross_attention_ok`: copies of ertdx/ops/ensemble_attn.py:
62-87, 145-148, 240-258 without the backend term), takes its kernel, a
CUDA tensor gets the kernel's one-pass function: the CUDA kernel where
the port's gate (`block_self_ok`, `folded_cross_ok`) takes the shape, and
a failed build or launch raises; else the plain one-pass version
`reference_attention_onepass` on the card, warned once per shape. Where
JAX's gate refuses, the float32 plain version `reference_attention` runs,
as JAX's XLA reference, and so it does on a CPU tensor, as JAX's
`_bsa_fwd` / `_fca_fwd` off the TPU. The one-pass plain version is also
the kernels' oracle on the card and the port's side of the CPU tests
against JAX's patched kernels. The backward is autograd of the float32
plain version, as JAX's custom VJPs recompute in XLA (:163-168,
:274-279). `launches` counts kernel launches only.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .core_block import mm_onepass, round_bf16

# what the CUDA kernels take (csrc/ensemble_attn.cu): D, a chain's P <= 32
# rows (self), and the keys of one condition (cross), which the kernel
# pads to a bucket of 8-key tiles (8, 16, 19, 24 and, at D = 64 only, 32)
KERNEL_DIMS = (64, 128)
KERNEL_P_MAX = 32
KERNEL_LK_MAX = {64: 256, 128: 192}

# JAX's TPU gates (ertdx/ops/ensemble_attn.py:56-87, 240-258): 8-chain
# chunks, and the VMEM budget of one program's slabs
TPU_CHUNK_CHAINS = 8
TPU_SELF_VMEM_BYTES = 6 * 2 ** 20

launches = {"block_self_attention": 0, "folded_cross_attention": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def block_self_ok(n: int, p: int, d: int) -> bool:
    """Whether the self-attention kernel takes (N, P, D): the port's gate,
    in place of the TPU's 8-chain packing and VMEM estimate."""
    return n >= 1 and d in KERNEL_DIMS and 1 <= p <= KERNEL_P_MAX


def folded_cross_ok(b: int, lq: int, lk: int, d: int) -> bool:
    """Whether the cross-attention kernel takes (B, Lq, D) x (B, Lk, D):
    one condition's keys within the kernel's largest key bucket."""
    return (b >= 1 and lq >= 1 and d in KERNEL_DIMS
            and 1 <= lk <= KERNEL_LK_MAX[d])


def tpu_self_groups_per_program(n_chains: int, p: int, d: int) -> int:
    """JAX's `_self_groups_per_program`: the 8-chain chunks one TPU
    program takes, 0 where the chains are no multiple of 8 or one chunk's
    slabs and logit tile exceed the VMEM budget."""
    if n_chains % TPU_CHUNK_CHAINS:
        return 0
    rows = TPU_CHUNK_CHAINS * p
    chunk_bytes = 4 * (rows * d) * 4 + rows * rows * 4
    if chunk_bytes > TPU_SELF_VMEM_BYTES:
        return 0
    g_cap = TPU_SELF_VMEM_BYTES // chunk_bytes
    g = 1
    total = n_chains // TPU_CHUNK_CHAINS
    for cand in range(1, min(g_cap, total) + 1):
        if total % cand == 0:
            g = cand
    return g


def tpu_block_self_attention_ok(n: int, p: int, d: int) -> bool:
    """JAX's `block_self_attention_ok` as on its TPU."""
    return d % 128 == 0 and tpu_self_groups_per_program(n, p, d) > 0


def tpu_cross_block_q(lq: int, cap: int = 1024) -> int:
    """JAX's `_cross_block_q`: the largest multiple of 8 up to `cap` that
    divides Lq, or 0."""
    best = 0
    for cand in range(8, min(cap, lq) + 1, 8):
        if lq % cand == 0:
            best = cand
    return best


def tpu_folded_cross_attention_ok(b: int, lq: int, lk: int, d: int) -> bool:
    """JAX's `folded_cross_attention_ok` as on its TPU."""
    bq = tpu_cross_block_q(lq)
    if bq <= 0:
        return False
    lkp = -(-lk // 128) * 128
    vmem = (2 * lkp * d + 2 * bq * d + bq * lkp) * 4
    return d % 128 == 0 and vmem <= TPU_SELF_VMEM_BYTES


def block_self_route(n: int, p: int, d: int, device,
                     global_n: int | None = None) -> str:
    """"kernel", "onepass_plain" or "float32" for (N, P, D) chains on
    `device` (module docstring). JAX's gate counts the chains of the
    global batch: under a mesh the caller passes them as `global_n` (by
    default N)."""
    return _build.route(device, False, tpu_block_self_attention_ok(
        n if global_n is None else global_n, p, d), block_self_ok(n, p, d))


def folded_cross_route(b: int, lq: int, lk: int, d: int, device) -> str:
    """"kernel", "onepass_plain" or "float32" for (B, Lq, D) queries
    against (B, Lk, D) keys on `device` (module docstring)."""
    return _build.route(device, False,
                        tpu_folded_cross_attention_ok(b, lq, lk, d),
                        folded_cross_ok(b, lq, lk, d))


def reference_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """The float32 plain version of both kernels: softmax(q k^T / sqrt(D))
    v over the last two axes, per chain (self) or per condition (cross),
    as ertdx/ops/attention.py:36-47 with one head: the logits accumulated,
    scaled and softmaxed in float32 (or wider), the probabilities cast to
    v's dtype for the product with v. The float32 function on float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    f32 = torch.promote_types(q.dtype, torch.float32)
    logits = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)


def onepass_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The operands of JAX's one-pass products, float32 tensors of bf16
    values: q times float32(1/sqrt(D)), then rounded (the scale is applied
    before the rounding: at D = 128 it is no power of two); k and v
    rounded (on bf16 inputs, their values)."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=torch.float32,
                         device=q.device)
    return (round_bf16(q.float() * scale), round_bf16(k.float()),
            round_bf16(v.float()))


def onepass_probs(qs: torch.Tensor, kr: torch.Tensor) -> torch.Tensor:
    """JAX's probabilities from one-pass operands: the logits summed in
    float32, the softmax in float32 (max subtracted, exp, divided by the
    sum), then rounded to bf16 for P V."""
    s = mm_onepass(qs, kr.transpose(-1, -2))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return round_bf16(e / e.sum(dim=-1, keepdim=True))


def reference_attention_onepass(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor) -> torch.Tensor:
    """The one-pass plain version of both kernels, JAX's function on its
    chip (ertdx/ops/ensemble_attn.py:101-111, :193-201 at DEFAULT): the
    rounded operands (`onepass_operands`), the rounded probabilities
    (`onepass_probs`), P V summed in float32, the output in q's dtype."""
    qs, kr, vr = onepass_operands(q, k, v)
    return mm_onepass(onepass_probs(qs, kr), vr).to(q.dtype)


def _row_stride(name: str, t: torch.Tensor) -> int:
    """The row stride of a (X, Y, D) tensor whose rows are evenly spaced
    with a contiguous last axis, 16-byte rows on 16-byte boundaries;
    raises otherwise."""
    x, y, d = t.shape
    ld = t.stride(1) if y > 1 else (t.stride(0) if x > 1 else d)
    if (t.stride(2) != 1 or ld < d or (x > 1 and t.stride(0) != y * ld)
            or (ld * t.element_size()) % 16 or t.data_ptr() % 16):
        raise ValueError(f"{name}: the kernel takes rows of D contiguous "
                         f"values at an even stride (16-byte rows, "
                         f"16-byte aligned), got strides {t.stride()}")
    return ld


def _check_cuda(name: str, t: torch.Tensor, shape, device, dtype) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"got {t.dtype}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {t.dtype}, the kernel takes q, k and v "
                        f"of one dtype ({dtype})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, the kernel "
                         f"expects {tuple(shape)}")
    return _row_stride(name, t)


def _entry(name: str, dtype: torch.dtype):
    lib = _build.load().lib
    return getattr(lib, name + ("_bf16" if dtype == torch.bfloat16 else ""))


def block_self_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """The self-attention kernel: q, k, v (N, P, D), float32 or bfloat16,
    -> (N, P, D) in q's dtype. One launch on the current stream."""
    n, p, d = q.shape
    if not block_self_ok(n, p, d):
        raise ValueError(f"block self-attention kernel does not take "
                         f"N={n}, P={p}, D={d}")
    lds = [_check_cuda(name, t, (n, p, d), q.device, q.dtype)
           for name, t in (("q", q), ("k", k), ("v", v))]
    out = torch.empty(n, p, d, device=q.device, dtype=q.dtype)
    fn = _entry("ertdx_block_self_attn", q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *lds, n, p, d, stream)
    _build.raise_on(rc, "block_self_attention")
    launches["block_self_attention"] += 1
    return out


def folded_cross_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
    """The cross-attention kernel: q (B, Lq, D), k, v (B, Lk, D), float32
    or bfloat16, -> (B, Lq, D) in q's dtype. One launch on the current
    stream."""
    b, lq, d = q.shape
    lk = k.shape[1]
    if not folded_cross_ok(b, lq, lk, d):
        raise ValueError(f"folded cross-attention kernel does not take "
                         f"B={b}, Lq={lq}, Lk={lk}, D={d}")
    ldq = _check_cuda("q", q, (b, lq, d), q.device, q.dtype)
    ldk = _check_cuda("k", k, (b, lk, d), q.device, q.dtype)
    ldv = _check_cuda("v", v, (b, lk, d), q.device, q.dtype)
    out = torch.empty(b, lq, d, device=q.device, dtype=q.dtype)
    fn = _entry("ertdx_folded_cross_attn", q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ldq, ldk, ldv, b, lq, lk, d, stream)
    _build.raise_on(rc, "folded_cross_attention")
    launches["folded_cross_attention"] += 1
    return out


def _float32_grads(ctx, g):
    """dq, dk, dv of the float32 plain version, from the saved inputs."""
    q, k, v = ctx.saved_tensors
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = reference_attention(*leaves)
        return torch.autograd.grad(out, leaves, g)


class _KernelAttention(torch.autograd.Function):
    """Forward on a CUDA kernel; backward by autograd of the float32 plain
    version, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, kernel, q, k, v):
        ctx.save_for_backward(q, k, v)
        return kernel(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return (None, *_float32_grads(ctx, g))


class _OnepassPlainAttention(torch.autograd.Function):
    """Forward on the plain one-pass version; backward as the kernels'."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return reference_attention_onepass(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return _float32_grads(ctx, g)


def _dispatch(route: str, op: str, kernel, q, k, v) -> torch.Tensor:
    if route == "kernel":
        return _KernelAttention.apply(kernel, q, k, v)
    if route == "onepass_plain":
        _build.warn_onepass_plain(op, tuple(q.shape) + (k.shape[-2],))
        return _OnepassPlainAttention.apply(q, k, v)
    return reference_attention(q, k, v)


def block_self_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor,
                         global_n: int | None = None) -> torch.Tensor:
    """Per-chain self-attention over (N, P, D), with a gradient, on the
    route `block_self_route` gives (`global_n`: the chains of the global
    batch under a mesh)."""
    n, p, d = q.shape
    return _dispatch(block_self_route(n, p, d, q.device, global_n),
                     "block_self_attention", block_self_attention_fwd,
                     q, k, v)


def folded_cross_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """(B, Lq, D) folded queries against per-condition (B, Lk, D) keys and
    values, with a gradient, on the route `folded_cross_route` gives."""
    b, lq, d = q.shape
    return _dispatch(folded_cross_route(b, lq, k.shape[1], d, q.device),
                     "folded_cross_attention", folded_cross_attention_fwd,
                     q, k, v)
