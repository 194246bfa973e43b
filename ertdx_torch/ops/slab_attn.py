"""Packed-head slab attention: wrappers, plain version, launch counts.

`slab_attention` ports the TPU kernels of ertdx/ops/slab_attn.py
(`_slab_fwd_kernel` :147-168, `_slab_bwd_kernel` :184-222) to the
hand-written CUDA kernels of csrc/slab_attn.cu. It is the encoder's
deepest-stage self-attention, read straight from the fused QKV slab:

    qkv  (B, L, 3C)  q | k | v, head h at lanes [h dh, (h+1) dh) of each
    out  (B, L, C)   softmax(q k^T / sqrt(dh)) v per head, heads merged
    dqkv (B, L, 3C)  dQ | dK | dV in the slab's layout

On CUDA tensors the forward launches the forward kernel and the backward
the backward kernels (float32: a dQ pass and a dK/dV pass; bfloat16: one
launch, see the CUDA sources); on CPU tensors both are the plain version
under autograd. Where the port's gate `slab_attention_ok` is false the
plain version runs on any device, as JAX's `_sa_fwd` (:309-314) takes
its XLA reference; where it is true a failed build or launch raises.
`launches` counts the float32 kernels' launches and `launches_bf16` the
bfloat16 kernels', and nothing else.

The kernels dispatch on the slab's dtype. A float32 slab runs the
kernels of csrc/slab_attn.cu, every product as 3xTF32 on the tensor
cores (csrc/tf32x3.cuh), fp32-class, as the TPU kernel's HIGHEST: for
them `accurate` has no effect. A bfloat16 slab (a bf16 model's encoder)
runs those of csrc/slab_attn_bf16.cu, the TPU kernel's DEFAULT class: one
bf16 warpgroup MMA (wgmma) a product with float32 accumulation and a
float32 softmax, P and dS rounded to bf16 for their products, the output
and dQKV in bf16; their operands land by TMA in a ring of head slots
whose depth `bf16_plan` picks. With `accurate=True` a bf16 slab runs the
float32 kernels on the upcast slab (the HIGHEST class) and returns bf16.
All of them read the slab from 16-byte boundaries (cp.async or TMA): the
kernel wrappers refuse a slab that does not start on one, and
`slab_attention` copies one (`_build.contiguous16`).

The plain version computes in the dtypes of JAX's plain version
(ertdx/ops/slab_attn.py:66-83): the logits in float32, the
probabilities cast to v's dtype, the output in the slab's dtype.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

# what the CUDA kernels take (csrc/slab_attn.cu: L_MAX, DH, shared memory)
KERNEL_HEAD_DIMS = (32, 64)
KERNEL_L_MAX = 256
# an H100 block's shared memory, the bf16 kernels' warpgroups a block and
# the deepest rings of head slots they take (csrc/slab_attn_bf16.cu)
SMEM_MAX = 232448
BF16_WARPGROUPS = {"fwd": 3, "bwd": 3}
BF16_MAX_STAGES = {"fwd": 4, "bwd": 3}

launches = {"slab_attention_fwd": 0, "slab_attention_bwd": 0}
launches_bf16 = {"slab_attention_fwd_bf16": 0, "slab_attention_bwd_bf16": 0}


def reset_launches() -> None:
    for counts in (launches, launches_bf16):
        for name in counts:
            counts[name] = 0


def slab_attention_ok(b: int, l: int, c: int, num_heads: int) -> bool:
    """Whether the CUDA kernels take this shape (the port's static gate,
    in place of the TPU's VMEM estimate): heads split C evenly, the head
    width is one the kernels are built for, and L fits their shared-memory
    plan (two padded L x dh operands and the per-warp logit rows)."""
    return (b >= 1 and num_heads >= 1 and c % num_heads == 0
            and c // num_heads in KERNEL_HEAD_DIMS
            and 1 <= l <= KERNEL_L_MAX)


def bf16_plan(l: int, dh: int) -> dict:
    """The bf16 kernels' launch plan at (L, dh), as
    csrc/slab_attn_bf16.cu lays out its shared memory: a head's rows
    padded to `lp` (L rounded up to 32), `tiles` 64-row query (and key)
    tiles, and the deepest ring of head slots, up to BF16_MAX_STAGES,
    whose bytes fit SMEM_MAX: 1 KB of alignment, the slots (Q, K, V; the
    backward's also dO and float32 lse and delta rows), a 64-row staging
    tile a warpgroup and the barriers (two a slot; the backward's
    three)."""
    lp = -(-l // 32) * 32
    rb = 2 * dh
    slot = {"fwd": 3 * lp * rb + 16, "bwd": 4 * lp * rb + 8 * lp + 24}
    plan = {"lp": lp, "tiles": -(-l // 64)}
    for k in ("fwd", "bwd"):
        fixed = 1024 + BF16_WARPGROUPS[k] * 64 * rb
        stages = max((n for n in range(1, BF16_MAX_STAGES[k] + 1)
                      if fixed + n * slot[k] <= SMEM_MAX), default=0)
        if not stages:
            raise ValueError(f"slab bf16 {k}: one slot at L={l}, dh={dh} "
                             f"exceeds {SMEM_MAX} bytes")
        plan[f"{k}_stages"] = stages
        plan[f"{k}_smem"] = fixed + stages * slot[k]
    return plan


def reference_slab_attention(qkv: torch.Tensor,
                             num_heads: int) -> torch.Tensor:
    """The plain version: head split, softmax(q k^T / sqrt(dh)) v, heads
    merged back (ertdx/ops/slab_attn.py:66-83); the logits in float32
    or wider, the probabilities cast to v's dtype."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    dh = c // num_heads
    q, k, v = qkv.split(c, dim=-1)

    def heads(z):
        return z.reshape(b, l, num_heads, dh).transpose(1, 2)

    f32 = torch.promote_types(qkv.dtype, torch.float32)
    logits = heads(q).to(f32) @ heads(k).to(f32).transpose(-1, -2) * (
        1.0 / math.sqrt(dh))
    out = torch.softmax(logits, dim=-1).to(v.dtype) @ heads(v)
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


def _fwd(qkv: torch.Tensor, num_heads: int, dtype: torch.dtype,
         entry: str, name: str, counts: dict) -> torch.Tensor:
    b, l, c, dh = _dims(qkv, num_heads)
    _build.check_cuda("qkv", qkv, (b, l, 3 * c), dtype)
    _build.check_aligned16(qkv=qkv)
    out = torch.empty(b, l, c, device=qkv.device, dtype=qkv.dtype)
    # the bf16 kernel takes its ring's depth
    ring = (bf16_plan(l, dh)["fwd_stages"],) if dtype == torch.bfloat16 \
        else ()
    lib = _build.load().lib
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = getattr(lib, entry)(qkv.data_ptr(), out.data_ptr(), b, l,
                                 num_heads, dh, *ring, stream)
    _build.raise_on(rc, name)
    counts[name] += 1
    return out


def _bwd(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
         dtype: torch.dtype, entry: str, name: str,
         counts: dict) -> torch.Tensor:
    b, l, c, dh = _dims(qkv, num_heads)
    _build.check_cuda("qkv", qkv, (b, l, 3 * c), dtype)
    _build.check_cuda("do", do, (b, l, c), dtype)
    if do.device != qkv.device:
        raise ValueError("qkv and do must share one CUDA device")
    _build.check_aligned16(qkv=qkv, do=do)
    dqkv = torch.empty_like(qkv)
    if dtype == torch.bfloat16:
        # one launch: lse and delta stay in shared memory
        scratch, tail = (), (bf16_plan(l, dh)["bwd_stages"],)
    else:
        # the dQ pass's lse and delta rows for the dK/dV pass
        lse_delta = torch.empty(2, b, num_heads, l, device=qkv.device,
                                dtype=torch.float32)
        scratch = (lse_delta[0].data_ptr(), lse_delta[1].data_ptr())
        tail = ()
    lib = _build.load().lib
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = getattr(lib, entry)(qkv.data_ptr(), do.data_ptr(),
                                 dqkv.data_ptr(), *scratch, b, l, num_heads,
                                 dh, *tail, stream)
    _build.raise_on(rc, name)
    counts[name] += 1
    return dqkv


def slab_attention_fwd(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The float32 forward kernel: (B, L, 3C) -> (B, L, C). One launch on
    the current stream."""
    return _fwd(qkv, num_heads, torch.float32, "ertdx_slab_fwd",
                "slab_attention_fwd", launches)


def slab_attention_bwd(qkv: torch.Tensor, do: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    """The float32 backward kernels: qkv (B, L, 3C) and dO (B, L, C) ->
    dQKV (B, L, 3C). Two launches on the current stream (dQ, then dK/dV),
    counted as one backward."""
    return _bwd(qkv, do, num_heads, torch.float32, "ertdx_slab_bwd",
                "slab_attention_bwd", launches)


def slab_attention_fwd_bf16(qkv: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """The bfloat16 forward kernel: (B, L, 3C) -> (B, L, C), both bf16.
    One launch on the current stream, persistent, `bf16_plan`'s ring."""
    return _fwd(qkv, num_heads, torch.bfloat16, "ertdx_slab_fwd_bf16",
                "slab_attention_fwd_bf16", launches_bf16)


def slab_attention_bwd_bf16(qkv: torch.Tensor, do: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """The bfloat16 backward kernel: qkv (B, L, 3C) and dO (B, L, C) ->
    dQKV (B, L, 3C), all bf16. One launch on the current stream, which
    reads each input once and allocates nothing beside dQKV."""
    return _bwd(qkv, do, num_heads, torch.bfloat16, "ertdx_slab_bwd_bf16",
                "slab_attention_bwd_bf16", launches_bf16)


def blocks_per_sm(l: int, dh: int) -> dict:
    """Resident blocks per SM of the three float32 kernels at (L, dh),
    from the CUDA occupancy calculator, and the threads of a block, which
    all three share (needs a card)."""
    out = (ctypes.c_int * 4)()
    lib = _build.load().lib
    _build.raise_on(lib.ertdx_slab_blocks_per_sm(l, dh, out),
                    "slab occupancy query")
    return dict(zip(("fwd", "bwd_dq", "bwd_dkv", "threads"), out))


class _SlabAttention(torch.autograd.Function):
    """Forward and backward on the CUDA kernels of the slab's dtype; with
    `accurate` a bf16 slab runs the float32 kernels on its upcast copy."""

    @staticmethod
    def forward(ctx, qkv, num_heads, accurate):
        ctx.num_heads = num_heads
        ctx.accurate = accurate
        ctx.save_for_backward(qkv)
        if qkv.dtype == torch.float32:
            return slab_attention_fwd(qkv, num_heads)
        if accurate:
            return slab_attention_fwd(qkv.to(torch.float32),
                                      num_heads).to(qkv.dtype)
        return slab_attention_fwd_bf16(qkv, num_heads)

    @staticmethod
    def backward(ctx, do):
        qkv, = ctx.saved_tensors
        do = _build.contiguous16(do)
        if qkv.dtype == torch.float32:
            dqkv = slab_attention_bwd(qkv, do, ctx.num_heads)
        elif ctx.accurate:
            dqkv = slab_attention_bwd(qkv.to(torch.float32),
                                      do.to(torch.float32),
                                      ctx.num_heads).to(qkv.dtype)
        else:
            dqkv = slab_attention_bwd_bf16(qkv, do, ctx.num_heads)
        return dqkv, None, None


def slab_attention(qkv: torch.Tensor, num_heads: int,
                   accurate: bool = False) -> torch.Tensor:
    """(B, L, 3C) packed QKV slab -> (B, L, C) attention output, with a
    gradient. The CUDA kernels of the slab's dtype (float32 or bfloat16)
    on a CUDA tensor the gate takes; the plain version on a CPU tensor, or
    where the gate is false. `accurate` matters for bf16 slabs only (see
    the module docstring)."""
    b, l, c3 = qkv.shape
    if (qkv.device.type == "cpu"
            or not slab_attention_ok(b, l, c3 // 3, num_heads)):
        return reference_slab_attention(qkv, num_heads)
    return _SlabAttention.apply(_build.contiguous16(qkv), num_heads,
                                accurate)
