"""Packed-head slab attention: wrappers, plain version, launch counts.

`slab_attention` ports the TPU kernels of ertdx/ops/slab_attn.py
(`_slab_fwd_kernel` :147-168, `_slab_bwd_kernel` :184-222) to the
hand-written CUDA kernels of csrc/slab_attn.cu. It is the encoder's
deepest-stage self-attention, read straight from the fused QKV slab:

    qkv  (B, L, 3C)  q | k | v, head h at lanes [h dh, (h+1) dh) of each
    out  (B, L, C)   softmax(q k^T / sqrt(dh)) v per head, heads merged
    dqkv (B, L, 3C)  dQ | dK | dV in the slab's layout

On CUDA tensors the forward launches the forward kernel and the backward
the backward kernels (a dQ pass and a dK/dV pass, see the CUDA source);
on CPU tensors both are the plain version under autograd. Where the
port's gate `slab_attention_ok` is false the plain version runs on any
device, as JAX's `_sa_fwd` (:309-314) takes its XLA reference; where it
is true a failed build or launch raises. `launches` counts kernel
launches only.

`accurate` selects HIGHEST-precision matmuls in the TPU kernel. The CUDA
kernels, forward and backward, compute every product as 3xTF32 on the
tensor cores (csrc/tf32x3.cuh), fp32-class, so it has no effect. They
stage the slab with 16-byte cp.async: the kernel wrappers refuse a slab
that does not start on a 16-byte boundary, and `slab_attention` copies
one (`_build.contiguous16`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

# what the CUDA kernels take (csrc/slab_attn.cu: L_MAX, DH, shared memory)
KERNEL_HEAD_DIMS = (32, 64)
KERNEL_L_MAX = 256

launches = {"slab_attention_fwd": 0, "slab_attention_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def slab_attention_ok(b: int, l: int, c: int, num_heads: int) -> bool:
    """Whether the CUDA kernels take this shape (the port's static gate,
    in place of the TPU's VMEM estimate): heads split C evenly, the head
    width is one the kernels are built for, and L fits their shared-memory
    plan (two padded L x dh operands and the per-warp logit rows)."""
    return (b >= 1 and num_heads >= 1 and c % num_heads == 0
            and c // num_heads in KERNEL_HEAD_DIMS
            and 1 <= l <= KERNEL_L_MAX)


def reference_slab_attention(qkv: torch.Tensor,
                             num_heads: int) -> torch.Tensor:
    """The plain version: head split, softmax(q k^T / sqrt(dh)) v, heads
    merged back (ertdx/ops/slab_attn.py:66-83)."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    dh = c // num_heads
    q, k, v = qkv.split(c, dim=-1)

    def heads(z):
        return z.reshape(b, l, num_heads, dh).transpose(1, 2)

    logits = heads(q) @ heads(k).transpose(-1, -2) * (1.0 / math.sqrt(dh))
    out = torch.softmax(logits, dim=-1) @ heads(v)
    return out.transpose(1, 2).reshape(b, l, c)


def reference_slab_attention_backward(qkv: torch.Tensor, do: torch.Tensor,
                                      num_heads: int) -> torch.Tensor:
    """dQKV of the plain version by autograd."""
    with torch.enable_grad():
        z = qkv.detach().requires_grad_(True)
        out = reference_slab_attention(z, num_heads)
        return torch.autograd.grad(out, z, do)[0]


def _dims(qkv: torch.Tensor, num_heads: int):
    b, l, c3 = qkv.shape
    if c3 % 3:
        raise ValueError(f"qkv width {c3} is not 3C")
    c = c3 // 3
    if not slab_attention_ok(b, l, c, num_heads):
        raise ValueError(f"slab attention kernels do not take B={b}, L={l}, "
                         f"C={c}, heads={num_heads}")
    return b, l, c, c // num_heads


def slab_attention_fwd(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The forward kernel: (B, L, 3C) -> (B, L, C). One launch on the
    current stream."""
    b, l, c, dh = _dims(qkv, num_heads)
    _build.check_cuda("qkv", qkv, (b, l, 3 * c))
    _build.check_aligned16(qkv=qkv)
    out = torch.empty(b, l, c, device=qkv.device, dtype=qkv.dtype)
    lib = _build.load().lib
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.ertdx_slab_fwd(qkv.data_ptr(), out.data_ptr(), b, l,
                                num_heads, dh, stream)
    _build.raise_on(rc, "slab_attention_fwd")
    launches["slab_attention_fwd"] += 1
    return out


def slab_attention_bwd(qkv: torch.Tensor, do: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    """The backward kernels: qkv (B, L, 3C) and dO (B, L, C) -> dQKV
    (B, L, 3C). Two launches on the current stream (dQ, then dK/dV),
    counted as one backward."""
    b, l, c, dh = _dims(qkv, num_heads)
    _build.check_cuda("qkv", qkv, (b, l, 3 * c))
    _build.check_cuda("do", do, (b, l, c))
    if do.device != qkv.device:
        raise ValueError("qkv and do must share one CUDA device")
    _build.check_aligned16(qkv=qkv, do=do)
    dqkv = torch.empty_like(qkv)
    scratch = torch.empty(2, b, num_heads, l, device=qkv.device,
                          dtype=torch.float32)
    lib = _build.load().lib
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.ertdx_slab_bwd(qkv.data_ptr(), do.data_ptr(),
                                dqkv.data_ptr(), scratch[0].data_ptr(),
                                scratch[1].data_ptr(), b, l, num_heads, dh,
                                stream)
    _build.raise_on(rc, "slab_attention_bwd")
    launches["slab_attention_bwd"] += 1
    return dqkv


def blocks_per_sm(l: int, dh: int) -> dict:
    """Resident blocks per SM of the three kernels at (L, dh), from the
    CUDA occupancy calculator, and the threads of a block, which all three
    share (needs a card)."""
    out = (ctypes.c_int * 4)()
    rc = _build.load().lib.ertdx_slab_blocks_per_sm(l, dh, out)
    _build.raise_on(rc, "slab occupancy query")
    return dict(zip(("fwd", "bwd_dq", "bwd_dkv", "threads"), out))


class _SlabAttention(torch.autograd.Function):
    """Forward and backward on the CUDA kernels."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv)
        return slab_attention_fwd(qkv, num_heads)

    @staticmethod
    def backward(ctx, do):
        qkv, = ctx.saved_tensors
        return (slab_attention_bwd(qkv, _build.contiguous16(do),
                                   ctx.num_heads), None)


def slab_attention(qkv: torch.Tensor, num_heads: int,
                   accurate: bool = False) -> torch.Tensor:
    """(B, L, 3C) packed QKV slab -> (B, L, C) attention output, with a
    gradient. The CUDA kernels on a CUDA tensor the gate takes; the plain
    version on a CPU tensor, or where the gate is false."""
    del accurate   # fp32-class throughout; see the module docstring
    b, l, c3 = qkv.shape
    if (qkv.device.type == "cpu"
            or not slab_attention_ok(b, l, c3 // 3, num_heads)):
        return reference_slab_attention(qkv, num_heads)
    return _SlabAttention.apply(_build.contiguous16(qkv), num_heads)
