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
spaced. The output is contiguous, in q's dtype.

float32 or bfloat16 operands. The kernels compute in float32: bfloat16
q, k and v go in as float32 copies and the output is rounded to
bfloat16, as JAX's TPU kernels load bf16, compute in float32 and write
q's dtype (ertdx/ops/ensemble_attn.py:101-111, :193-201). The plain
version follows JAX's reference on either dtype (logits in float32,
probabilities in v's dtype, ertdx/ops/attention.py:36-46).

On a CUDA tensor that the port's gate (`block_self_ok`,
`folded_cross_ok`) takes, the forward launches the kernel, and a failed
build or launch raises; on a CPU tensor, or where the gate is false, the
plain version runs, as JAX's `_bsa_fwd` / `_fca_fwd` take their XLA
reference off the TPU. The backward is autograd of the plain version, as
JAX's custom VJPs recompute in XLA (:163-168, :274-279). `launches`
counts kernel launches only.
"""
from __future__ import annotations

import math

import torch

from . import _build

# what the CUDA kernels take (csrc/ensemble_attn.cu: D, P <= 32 keys per
# warp pass, Lk <= 256 keys padded to a bucket of 8-key tiles, K and V of
# one condition and at least one warp's 16 q rows in shared memory)
KERNEL_DIMS = (64, 128)
KERNEL_P_MAX = 32
KERNEL_LK_MAX = 256
SMEM_LIMIT = 232448          # bytes of shared memory a block may use
CROSS_KEY_TILES = (8, 16, 19, 24, 32)

launches = {"block_self_attention": 0, "folded_cross_attention": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _cross_smem_bytes(lk: int, d: int) -> int:
    """The least shared memory of one cross-attention block: K and V rows
    of D + 4 floats, padded with zero rows to the bucket of 8-key tiles
    that Lk falls in, and one warp's 16 q rows; a block takes as many
    warps (up to 8) as fit (csrc/ensemble_attn.cu::cross_smem_bytes)."""
    tiles = next(n for n in CROSS_KEY_TILES if 8 * n >= lk)
    return 4 * (2 * 8 * tiles + 16) * (d + 4)


def block_self_ok(n: int, p: int, d: int) -> bool:
    """Whether the self-attention kernel takes (N, P, D): the port's gate,
    in place of the TPU's 8-chain packing and VMEM estimate."""
    return n >= 1 and d in KERNEL_DIMS and 1 <= p <= KERNEL_P_MAX


def folded_cross_ok(b: int, lq: int, lk: int, d: int) -> bool:
    """Whether the cross-attention kernel takes (B, Lq, D) x (B, Lk, D):
    one condition's K and V must fit a block's shared memory."""
    return (b >= 1 and lq >= 1 and d in KERNEL_DIMS
            and 1 <= lk <= KERNEL_LK_MAX
            and _cross_smem_bytes(lk, d) <= SMEM_LIMIT)


def reference_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """The plain version of both kernels: softmax(q k^T / sqrt(D)) v over
    the last two axes, per chain (self) or per condition (cross), as
    ertdx/ops/attention.py:36-47 with one head: the logits accumulated,
    scaled and softmaxed in float32 (or wider), the probabilities cast to
    v's dtype for the product with v. The float32 function on float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    f32 = torch.promote_types(q.dtype, torch.float32)
    logits = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)


def _row_stride(name: str, t: torch.Tensor) -> int:
    """The row stride of a (X, Y, D) tensor whose rows are evenly spaced
    with a contiguous last axis; raises otherwise."""
    x, y, d = t.shape
    ld = t.stride(1) if y > 1 else (t.stride(0) if x > 1 else d)
    if (t.stride(2) != 1 or ld < d or (x > 1 and t.stride(0) != y * ld)
            or ld % 4 or t.data_ptr() % 16):
        raise ValueError(f"{name}: the kernel takes rows of D contiguous "
                         f"floats at an even stride (a multiple of 4, "
                         f"16-byte aligned), got strides {t.stride()}")
    return ld


def _check_cuda(name: str, t: torch.Tensor, shape, device) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, the kernel "
                         f"expects {tuple(shape)}")
    return _row_stride(name, t) if t.dtype == torch.float32 else 0


def _upcast(q, k, v):
    """float32 copies of bfloat16 operands, with their row strides: the
    kernels load float32 (JAX's kernels load bf16 and compute in
    float32)."""
    q, k, v = (t.to(torch.float32, memory_format=torch.contiguous_format)
               for t in (q, k, v))
    return q, k, v, [_row_stride(n, t) for n, t in zip("qkv", (q, k, v))]


def block_self_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """The self-attention kernel: q, k, v (N, P, D) -> (N, P, D) in q's
    dtype. One launch on the current stream."""
    n, p, d = q.shape
    if not block_self_ok(n, p, d):
        raise ValueError(f"block self-attention kernel does not take "
                         f"N={n}, P={p}, D={d}")
    lds = [_check_cuda(name, t, (n, p, d), q.device)
           for name, t in (("q", q), ("k", k), ("v", v))]
    dtype = q.dtype
    if {t.dtype for t in (q, k, v)} != {torch.float32}:
        q, k, v, lds = _upcast(q, k, v)
    out = torch.empty(n, p, d, device=q.device, dtype=torch.float32)
    lib = _build.load().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ertdx_block_self_attn(q.data_ptr(), k.data_ptr(),
                                       v.data_ptr(), out.data_ptr(), *lds,
                                       n, p, d, stream)
    _build.raise_on(rc, "block_self_attention")
    launches["block_self_attention"] += 1
    return out.to(dtype)


def folded_cross_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
    """The cross-attention kernel: q (B, Lq, D), k, v (B, Lk, D) ->
    (B, Lq, D) in q's dtype. One launch on the current stream."""
    b, lq, d = q.shape
    lk = k.shape[1]
    if not folded_cross_ok(b, lq, lk, d):
        raise ValueError(f"folded cross-attention kernel does not take "
                         f"B={b}, Lq={lq}, Lk={lk}, D={d}")
    ldq = _check_cuda("q", q, (b, lq, d), q.device)
    ldk = _check_cuda("k", k, (b, lk, d), q.device)
    ldv = _check_cuda("v", v, (b, lk, d), q.device)
    dtype = q.dtype
    if {t.dtype for t in (q, k, v)} != {torch.float32}:
        q, k, v, (ldq, ldk, ldv) = _upcast(q, k, v)
    out = torch.empty(b, lq, d, device=q.device, dtype=torch.float32)
    lib = _build.load().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ertdx_folded_cross_attn(q.data_ptr(), k.data_ptr(),
                                         v.data_ptr(), out.data_ptr(), ldq,
                                         ldk, ldv, b, lq, lk, d, stream)
    _build.raise_on(rc, "folded_cross_attention")
    launches["folded_cross_attention"] += 1
    return out.to(dtype)


class _KernelAttention(torch.autograd.Function):
    """Forward on a CUDA kernel; backward by autograd of the plain
    version, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, kernel, q, k, v):
        ctx.save_for_backward(q, k, v)
        return kernel(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = reference_attention(*leaves)
            grads = torch.autograd.grad(out, leaves, g)
        return (None, *grads)


def block_self_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Per-chain self-attention over (N, P, D), with a gradient: the CUDA
    kernel on a CUDA tensor the gate takes, else the plain version."""
    n, p, d = q.shape
    if q.device.type == "cpu" or not block_self_ok(n, p, d):
        return reference_attention(q, k, v)
    return _KernelAttention.apply(block_self_attention_fwd, q, k, v)


def folded_cross_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """(B, Lq, D) folded queries against per-condition (B, Lk, D) keys and
    values, with a gradient: the CUDA kernel on a CUDA tensor the gate
    takes, else the plain version."""
    b, lq, d = q.shape
    if q.device.type == "cpu" or not folded_cross_ok(b, lq, k.shape[1], d):
        return reference_attention(q, k, v)
    return _KernelAttention.apply(folded_cross_attention_fwd, q, k, v)
