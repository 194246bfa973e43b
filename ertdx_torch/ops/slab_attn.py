"""Packed-head slab attention: wrappers, plain version, launch counts.

`slab_attention` ports the TPU kernels of ertdx/ops/slab_attn.py
(`_slab_fwd_kernel` :147-168, `_slab_bwd_kernel` :184-222) to the
hand-written CUDA kernels of csrc/slab_attn_bf16.cu (their DEFAULT
precision, one bf16 pass a product) and csrc/slab_attn.cu (HIGHEST,
`accurate=True`). It is the encoder's
deepest-stage self-attention, read straight from the fused QKV slab:

    qkv  (B, L, 3C)  q | k | v, head h at lanes [h dh, (h+1) dh) of each
    out  (B, L, C)   softmax(q k^T / sqrt(dh)) v per head, heads merged
    dqkv (B, L, 3C)  dQ | dK | dV in the slab's layout

`slab_attention` follows the rule of the port's one-pass kernels: JAX's
gate chooses the function, the port's gate only the route
(`slab_route`). JAX's `_sa_fwd` (:309-314) runs its kernel where
`slab_attention_ok` (:225-252) takes the shape on its TPU, at DEFAULT
precision unless `accurate`; the port evaluates a copy of that gate
without the backend term (`tpu_slab_attention_ok`). On a CUDA tensor:

* `accurate=False` (JAX's default, and what the CondUNet passes): where
  JAX's gate takes the shape, the port computes its kernel's one-pass
  function (JAX's `_dot` at DEFAULT is one bf16 pass with float32 sums),
  on the CUDA kernels of csrc/slab_attn_bf16.cu where the port's gate
  `slab_attention_ok` takes the shape ("kernel"), else on the plain
  one-pass version on the card, warned once per shape ("onepass_plain");
  where JAX's gate refuses, the float32 plain version ("float32"), as
  JAX's XLA reference;
* `accurate=True`: the float32 function, JAX's HIGHEST, on the 3xTF32
  kernels of csrc/slab_attn.cu where the port's gate takes the shape (a
  bf16 slab on its float32 upcast, the result cast back), else the plain
  version.

On a CPU tensor the plain version runs, as JAX's off the TPU. Where a
kernel runs, a failed build or launch raises; no route is a fallback on
failure.

The one-pass kernels (`slab_attention_fwd_onepass` / `_bwd_onepass` on a
float32 slab, `slab_attention_fwd_bf16` / `_bwd_bf16` on a bf16 one; one
templated body each) load the slab as it is and round it in the kernel:
q times float32(1/sqrt(dh)) and k rounded to bf16 for S, the softmax in
float32 over the L keys and normalised, then P and v rounded for P V; the
backward rounds dO, v, P, dS and the unscaled q where JAX's backward
(:204-220) rounds them, delta = rowsum(dP o P) in float32. Each product is
one bf16 warpgroup MMA (wgmma) with float32 sums; the output and dQKV are
in the slab's dtype. A bf16 slab lands by TMA in a ring of head slots
whose depth `bf16_plan` picks, a float32 one by 16-byte loads rounded
into the same ring. The 3xTF32 kernels (`slab_attention_fwd` / `_bwd`)
run every product as three TF32 MMAs (csrc/tf32x3.cuh), fp32-class.
All of them read the slab from 16-byte boundaries: the kernel wrappers
refuse a slab that does not start on one, and `slab_attention` copies one
(`_build.contiguous16`). `launches` counts the 3xTF32 kernels' launches,
`launches_onepass` the float32 one-pass kernels' and `launches_bf16` the
bf16 ones', and nothing else.

The plain version computes in the dtypes of JAX's plain version
(ertdx/ops/slab_attn.py:66-83): the logits in float32, the
probabilities cast to v's dtype, the output in the slab's dtype. The
plain one-pass version (`reference_slab_attention_onepass`, its backward
and `SlabOnepassPlain`, which pairs them under autograd) rounds where
JAX's kernels round at DEFAULT; it is the one-pass kernels' oracle on the
card and the port's side of the CPU tests against JAX's kernels with
their `_dot` rounding at DEFAULT.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .core_block import mm_onepass, round_bf16

# what the CUDA kernels take (csrc/slab_attn.cu: L_MAX, DH, shared memory)
KERNEL_HEAD_DIMS = (32, 64)
KERNEL_L_MAX = 256
# an H100 block's shared memory, the bf16 kernels' warpgroups a block and
# the deepest rings of head slots they take (csrc/slab_attn_bf16.cu)
SMEM_MAX = 232448
BF16_WARPGROUPS = {"fwd": 3, "bwd": 3}
BF16_MAX_STAGES = {"fwd": 4, "bwd": 3}

# JAX's TPU gate (ertdx/ops/slab_attn.py:59-61, 95-104, 225-252): the VMEM
# budget of one program's resident slabs and logit tiles
TPU_SLAB_VMEM_BUDGET = 12 * 2 ** 20

launches = {"slab_attention_fwd": 0, "slab_attention_bwd": 0}
launches_onepass = {"slab_attention_fwd_onepass": 0,
                    "slab_attention_bwd_onepass": 0}
launches_bf16 = {"slab_attention_fwd_bf16": 0, "slab_attention_bwd_bf16": 0}


def reset_launches() -> None:
    for counts in (launches, launches_onepass, launches_bf16):
        for name in counts:
            counts[name] = 0


def tpu_pad128(length: int) -> int:
    return -(-length // 128) * 128


def tpu_group_of(nh: int, dh: int) -> int:
    """JAX's `_group_of`: heads a block-diagonal group, filling 128
    lanes."""
    g = min(max(1, 128 // dh), nh)
    while nh % g:
        g -= 1
    return g


def tpu_pick_block_b(b: int, l: int, c: int, nh: int,
                     backward: bool) -> int:
    """JAX's `_pick_block_b`: batch rows a TPU program, within its VMEM
    budget (the resident slabs, the packed logit tiles and block-diagonal
    K/V, float32), or 0."""
    dh = max(c // max(nh, 1), 1)
    g = tpu_group_of(nh, dh)
    lr = -(-l // 8) * 8
    lp = tpu_pad128(l)
    per_row = 4 * (lr * 3 * c + lr * c + 4 * lr * g * lp
                   + 2 * g * lp * g * dh + 4 * lr * c)
    if backward:
        per_row += 4 * (lr * 3 * c + lr * c + 2 * lr * g * lp)
    for cand in (8, 4, 2, 1):
        if b % cand == 0 and cand * per_row <= TPU_SLAB_VMEM_BUDGET:
            return cand
    return 0


def tpu_slab_attention_ok(b: int, l: int, c: int, num_heads: int) -> bool:
    """JAX's `slab_attention_ok` as on its TPU (its backend term left
    out)."""
    return (c % num_heads == 0
            and tpu_pick_block_b(b, l, c, num_heads, backward=True) > 0)


def slab_route(b: int, l: int, c: int, num_heads: int, device,
               accurate: bool = False) -> str:
    """"kernel", "onepass_plain" or "float32" for a (B, L, 3C) slab on
    `device` (the module docstring's rule)."""
    return _build.route(device, accurate,
                        tpu_slab_attention_ok(b, l, c, num_heads),
                        slab_attention_ok(b, l, c, num_heads))


def slab_attention_ok(b: int, l: int, c: int, num_heads: int) -> bool:
    """Whether the CUDA kernels take this shape (the port's static gate,
    in place of the TPU's VMEM estimate): heads split C evenly, the head
    width is one the kernels are built for, and L fits their shared-memory
    plan (two padded L x dh operands and the per-warp logit rows)."""
    return (b >= 1 and num_heads >= 1 and c % num_heads == 0
            and c // num_heads in KERNEL_HEAD_DIMS
            and 1 <= l <= KERNEL_L_MAX)


def bf16_plan(l: int, dh: int) -> dict:
    """The one-pass kernels' launch plan at (L, dh), as
    csrc/slab_attn_bf16.cu lays out its shared memory, the same for a
    float32 and a bf16 slab (both land as bf16 tiles): a head's rows
    padded to `lp` (L rounded up to 32), `tiles` 64-row query (and key)
    tiles, and the deepest ring of head slots, up to BF16_MAX_STAGES,
    whose bytes fit SMEM_MAX: 1 KB of alignment, the slots (Q, K, V; the
    backward's also dO, at dh = 32 the scaled Q apart, and float32 lse and
    delta rows), a 64-row staging tile a warpgroup and the barriers (two
    a slot; the backward's three)."""
    lp = -(-l // 32) * 32
    rb = 2 * dh
    bwd_tiles = 5 if dh == 32 else 4
    slot = {"fwd": 3 * lp * rb + 16, "bwd": bwd_tiles * lp * rb + 8 * lp + 24}
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


def _onepass_heads(qkv: torch.Tensor, num_heads: int):
    """q, k, v as (B, H, L, dh) in float32 (or wider) and the scale
    float32(1/sqrt(dh)), as JAX's kernels take them."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    dh = c // num_heads
    x = qkv.to(torch.promote_types(qkv.dtype, torch.float32))
    q, k, v = (z.reshape(b, l, num_heads, dh).transpose(1, 2)
               for z in x.split(c, dim=-1))
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32,
                         device=qkv.device).to(x.dtype)
    return q, k, v, scale


def _onepass_probs(q, k, scale):
    """JAX's normalised probabilities at DEFAULT: S from bf16(q scale) and
    bf16(k) summed in float32, the softmax in float32 (`_block_softmax`,
    :128-144); not rounded."""
    s = mm_onepass(q * scale, k.transpose(-1, -2))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _merge(z: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = z.shape
    return z.transpose(1, 2).reshape(b, l, h * dh)


def reference_slab_attention_onepass(qkv: torch.Tensor,
                                     num_heads: int) -> torch.Tensor:
    """The plain one-pass version: JAX's `_slab_fwd_kernel` (:147-168) with
    its `_dot` at DEFAULT, one bf16 pass a product. bf16(q scale) and
    bf16(k) for S, P normalised in float32, then bf16(P) and bf16(v) for P
    V, float32 sums; the output in the slab's dtype."""
    q, k, v, scale = _onepass_heads(qkv, num_heads)
    out = mm_onepass(_onepass_probs(q, k, scale), v)
    return _merge(out).to(qkv.dtype)


def reference_slab_attention_onepass_backward(qkv: torch.Tensor,
                                              do: torch.Tensor,
                                              num_heads: int
                                              ) -> torch.Tensor:
    """dQKV of the plain one-pass version, as JAX's `_slab_bwd_kernel`
    (:184-222) computes it at DEFAULT: S and P as the forward; dV =
    bf16(P)^T bf16(dO), dP = bf16(dO) bf16(v)^T, delta = rowsum(dP o P)
    and dS = P o (dP - delta) in float32, dQ = (bf16(dS) bf16(k)) scale,
    dK = (bf16(dS)^T bf16(q)) scale with q unscaled; dQKV in the slab's
    dtype."""
    q, k, v, scale = _onepass_heads(qkv, num_heads)
    b, l, c = do.shape
    dh = c // num_heads
    dout = do.to(q.dtype).reshape(b, l, num_heads, dh).transpose(1, 2)
    p = _onepass_probs(q, k, scale)
    dv = mm_onepass(p.transpose(-1, -2), dout)
    dp = mm_onepass(dout, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = mm_onepass(ds, k) * scale
    dk = mm_onepass(ds.transpose(-1, -2), q) * scale
    return torch.cat([_merge(dq), _merge(dk), _merge(dv)],
                     dim=-1).to(qkv.dtype)


class SlabOnepassPlain(torch.autograd.Function):
    """The plain one-pass version under autograd: forward
    `reference_slab_attention_onepass`, backward
    `reference_slab_attention_onepass_backward` (JAX's custom VJP pairs
    its two one-pass kernels the same way)."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv)
        return reference_slab_attention_onepass(qkv, num_heads)

    @staticmethod
    def backward(ctx, do):
        qkv, = ctx.saved_tensors
        return reference_slab_attention_onepass_backward(
            qkv, do, ctx.num_heads), None


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
         entry: str, name: str, counts: dict,
         onepass: bool) -> torch.Tensor:
    b, l, c, dh = _dims(qkv, num_heads)
    _build.check_cuda("qkv", qkv, (b, l, 3 * c), dtype)
    _build.check_aligned16(qkv=qkv)
    out = torch.empty(b, l, c, device=qkv.device, dtype=qkv.dtype)
    # the one-pass kernels take their ring's depth
    ring = (bf16_plan(l, dh)["fwd_stages"],) if onepass else ()
    lib = _build.load().lib
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = getattr(lib, entry)(qkv.data_ptr(), out.data_ptr(), b, l,
                                 num_heads, dh, *ring, stream)
    _build.raise_on(rc, name)
    counts[name] += 1
    return out


def _bwd(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
         dtype: torch.dtype, entry: str, name: str, counts: dict,
         onepass: bool) -> torch.Tensor:
    b, l, c, dh = _dims(qkv, num_heads)
    _build.check_cuda("qkv", qkv, (b, l, 3 * c), dtype)
    _build.check_cuda("do", do, (b, l, c), dtype)
    if do.device != qkv.device:
        raise ValueError("qkv and do must share one CUDA device")
    _build.check_aligned16(qkv=qkv, do=do)
    dqkv = torch.empty_like(qkv)
    if onepass:
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
                "slab_attention_fwd", launches, onepass=False)


def slab_attention_bwd(qkv: torch.Tensor, do: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    """The float32 backward kernels: qkv (B, L, 3C) and dO (B, L, C) ->
    dQKV (B, L, 3C). Two launches on the current stream (dQ, then dK/dV),
    counted as one backward."""
    return _bwd(qkv, do, num_heads, torch.float32, "ertdx_slab_bwd",
                "slab_attention_bwd", launches, onepass=False)


def slab_attention_fwd_onepass(qkv: torch.Tensor,
                               num_heads: int) -> torch.Tensor:
    """The one-pass forward kernel on a float32 slab: (B, L, 3C) ->
    (B, L, C), both float32, the slab rounded to bf16 in the kernel. One
    launch on the current stream, persistent, `bf16_plan`'s ring."""
    return _fwd(qkv, num_heads, torch.float32, "ertdx_slab_fwd_onepass",
                "slab_attention_fwd_onepass", launches_onepass, onepass=True)


def slab_attention_bwd_onepass(qkv: torch.Tensor, do: torch.Tensor,
                               num_heads: int) -> torch.Tensor:
    """The one-pass backward kernel on a float32 slab: qkv (B, L, 3C) and
    dO (B, L, C) -> dQKV (B, L, 3C), all float32. One launch on the
    current stream."""
    return _bwd(qkv, do, num_heads, torch.float32, "ertdx_slab_bwd_onepass",
                "slab_attention_bwd_onepass", launches_onepass, onepass=True)


def slab_attention_fwd_bf16(qkv: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """The bfloat16 forward kernel: (B, L, 3C) -> (B, L, C), both bf16.
    One launch on the current stream, persistent, `bf16_plan`'s ring."""
    return _fwd(qkv, num_heads, torch.bfloat16, "ertdx_slab_fwd_bf16",
                "slab_attention_fwd_bf16", launches_bf16, onepass=True)


def slab_attention_bwd_bf16(qkv: torch.Tensor, do: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """The bfloat16 backward kernel: qkv (B, L, 3C) and dO (B, L, C) ->
    dQKV (B, L, 3C), all bf16. One launch on the current stream, which
    reads each input once and allocates nothing beside dQKV."""
    return _bwd(qkv, do, num_heads, torch.bfloat16, "ertdx_slab_bwd_bf16",
                "slab_attention_bwd_bf16", launches_bf16, onepass=True)


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
    """Forward and backward on the CUDA kernels: the one-pass kernels of
    the slab's dtype, or with `accurate` the 3xTF32 kernels (a bf16 slab
    on its float32 upcast)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, accurate):
        ctx.num_heads = num_heads
        ctx.accurate = accurate
        ctx.save_for_backward(qkv)
        if accurate:
            out = slab_attention_fwd(qkv.to(torch.float32), num_heads)
            return out.to(qkv.dtype)
        if qkv.dtype == torch.float32:
            return slab_attention_fwd_onepass(qkv, num_heads)
        return slab_attention_fwd_bf16(qkv, num_heads)

    @staticmethod
    def backward(ctx, do):
        qkv, = ctx.saved_tensors
        do = _build.contiguous16(do)
        if ctx.accurate:
            dqkv = slab_attention_bwd(qkv.to(torch.float32),
                                      do.to(torch.float32),
                                      ctx.num_heads).to(qkv.dtype)
        elif qkv.dtype == torch.float32:
            dqkv = slab_attention_bwd_onepass(qkv, do, ctx.num_heads)
        else:
            dqkv = slab_attention_bwd_bf16(qkv, do, ctx.num_heads)
        return dqkv, None, None


def slab_attention(qkv: torch.Tensor, num_heads: int,
                   accurate: bool = False) -> torch.Tensor:
    """(B, L, 3C) packed QKV slab -> (B, L, C) attention output, with a
    gradient, on the route `slab_route` gives (the module docstring):
    the CUDA kernels, the plain one-pass version on the card, or the
    plain version."""
    b, l, c3 = qkv.shape
    route = slab_route(b, l, c3 // 3, num_heads, qkv.device, accurate)
    if route == "float32":
        return reference_slab_attention(qkv, num_heads)
    if route == "onepass_plain":
        _build.warn_onepass_plain("slab_attention", (b, l, c3, num_heads))
        return SlabOnepassPlain.apply(qkv, num_heads)
    return _SlabAttention.apply(_build.contiguous16(qkv), num_heads,
                                accurate)
