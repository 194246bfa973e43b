"""Flash attention with a key mask: wrappers, plain versions, launch counts.

`flash_attention` ports TPU kernel 4 of ertdx/ops/attention.py (the
forward `_flash_kernel` :53-91, the backward `_flash_bwd_dq_kernel`
:146-176 and `_flash_bwd_dkv_kernel` :178-215) to the hand-written CUDA
kernels of csrc/flash_attn.cu, in JAX's (B, H, L, Dh) layout:

    q (B, H, Lq, Dh), k and v (B, H, Lk, Dh), kv_mask (B, Lk) or None
    out (B, H, Lq, Dh) = softmax(q k^T / sqrt(Dh) + bias) v,
    bias = 0 where kv_mask > 0 and -1e30 elsewhere

On CUDA tensors that JAX's `_aligned` rule takes (Lq, Lk multiples of
128, Dh in 64/128/256) and with `use_pallas`, the forward launches the
forward kernel, which also saves the per-row logsumexp, and the backward
the dQ kernel (which computes delta = rowsum(dO o O)) and then the dK/dV
kernel. Elsewhere, CPU tensors included, the plain version
`reference_attention` runs under autograd, as JAX's `_fa_fwd` (:306-311)
takes its XLA reference off the TPU. Where the gate holds, a failed build
or launch raises. A CUDA call with `use_pallas` whose shapes the gate
refuses (a head width other than 64, 128 or 256, or a length that is not
a multiple of 128) runs the plain version on the card, as JAX does, and
warns once per shape. `launches` counts kernel launches only.

`reference_flash_forward` and `reference_flash_backward` repeat the
kernels' arithmetic from a saved (O, lse) in plain PyTorch: they are the
kernels' oracle. With -1e30 as the bias (not -inf), a batch row whose
keys are all masked gets the uniform mean of V, lse = -1e30, and p = 1 in
the backward, in JAX's kernels and here alike. The CUDA kernels, forward
and backward, run their products as 3xTF32 on the tensor cores
(fp32-class, as JAX's Precision.HIGHEST) and skip key tiles that are all
padding where the batch row has a valid key: p = 0 there exactly, so the
forward's out and lse and the backward's dQ are unchanged and the
skipped keys' dK and dV rows are 0. They stage their operands with
16-byte cp.async: the kernel wrappers refuse one that does not start on
a 16-byte boundary, and `flash_attention` copies one
(`_build.contiguous16`).

Operands in another dtype (a bf16 model's encoder) run the same float32
kernels on upcast copies, as JAX's kernels load bf16 and compute in
float32 at HIGHEST (ertdx/ops/attention.py:61, 69-80, 164-168): the
output is rounded to q's dtype, the backward forms delta from that
rounded output (as JAX forms it from `out` in q's dtype, :231-232), and
dq, dk, dv come back in the inputs' dtypes (:257, 288-289).
"""
from __future__ import annotations

import ctypes
import math
import warnings
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
BLOCK = 128
KERNEL_HEAD_DIMS = (64, 128, 256)

launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def aligned(q: torch.Tensor, k: torch.Tensor, block: int = BLOCK) -> bool:
    """JAX's `_aligned` (ertdx/ops/attention.py:329-332): the shapes the
    kernels take."""
    return (q.shape[2] % block == 0 and k.shape[2] % block == 0
            and q.shape[3] in KERNEL_HEAD_DIMS)


_warned = set()


def warn_unaligned(q: torch.Tensor, k: torch.Tensor) -> None:
    """Warn, once per (Lq, Lk, Dh), that a call the kernels were asked for
    runs the plain version because `aligned` refuses its shapes."""
    key = (q.shape[2], k.shape[2], q.shape[3])
    if key in _warned:
        return
    _warned.add(key)
    warnings.warn(
        f"flash_attention: Lq={key[0]}, Lk={key[1]}, Dh={key[2]} is not a "
        f"shape the CUDA kernels take (lengths a multiple of {BLOCK}, Dh "
        f"in {KERNEL_HEAD_DIMS}); running the plain version", stacklevel=3)


def _bias(kv_mask: torch.Tensor, dtype) -> torch.Tensor:
    """(B, Lk) mask -> (B, 1, 1, Lk) additive bias: 0 where the mask is
    > 0, -1e30 elsewhere (JAX's where(kv_mask, 0, -1e30) for 0/1 masks)."""
    return torch.where(kv_mask[:, None, None, :] > 0, 0.0, NEG_INF).to(dtype)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The plain version (ertdx/ops/attention.py:36-47): the logits in
    float32 or wider, the probabilities cast to v's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    f32 = torch.promote_types(q.dtype, torch.float32)
    logits = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * scale
    if kv_mask is not None:
        logits = logits + _bias(kv_mask, logits.dtype)
    return torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)


def reference_flash_forward(q, k, v, kv_mask=None):
    """(out, lse) with the forward kernel's arithmetic: s = (q scale) k^T +
    bias, out = exp(s - m) v / max(l, 1e-30), lse = m + log(max(l,
    1e-30)); lse is (B, H, Lq)."""
    s = torch.matmul(q * (1.0 / math.sqrt(q.shape[-1])), k.transpose(-1, -2))
    if kv_mask is not None:
        s = s + _bias(kv_mask, s.dtype)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.matmul(p, v) / l, (m + torch.log(l))[..., 0]


def _probs(q, k, kv_mask, lse):
    """p = exp((q k^T) scale + bias - lse), as both backward kernels
    recompute it."""
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if kv_mask is not None:
        s = s + _bias(kv_mask, s.dtype)
    return torch.exp(s - lse[..., None])


def reference_flash_backward_dq(q, k, v, kv_mask, out, lse, do):
    """(dq, delta) with the dQ kernel's arithmetic
    (ertdx/ops/attention.py:146-176, 232-233): delta = rowsum(dO o O),
    dS = p o (dO v^T - delta), dQ = scale dS K; delta is (B, H, Lq)."""
    delta = torch.sum(do * out, dim=-1)
    ds = _probs(q, k, kv_mask, lse) * (
        torch.matmul(do, v.transpose(-1, -2)) - delta[..., None])
    return torch.matmul(ds, k) * (1.0 / math.sqrt(q.shape[-1])), delta


def reference_flash_backward_dkv(q, k, v, kv_mask, lse, delta, do):
    """(dk, dv) with the dK/dV kernel's arithmetic (:178-215): dV = P^T
    dO, dK = scale dS^T Q."""
    p = _probs(q, k, kv_mask, lse)
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - delta[..., None])
    dk = torch.matmul(ds.transpose(-1, -2), q) * (
        1.0 / math.sqrt(q.shape[-1]))
    return dk, torch.matmul(p.transpose(-1, -2), do)


def reference_flash_backward(q, k, v, kv_mask, out, lse, do):
    """(dq, dk, dv) from a saved (out, lse): the two backward kernels'
    arithmetic in plain PyTorch."""
    dq, delta = reference_flash_backward_dq(q, k, v, kv_mask, out, lse, do)
    return (dq,) + reference_flash_backward_dkv(q, k, v, kv_mask, lse,
                                                delta, do)


def _mask_for(kv_mask, b: int, lk: int, device) -> torch.Tensor:
    if kv_mask is None:
        return torch.ones(b, lk, device=device, dtype=torch.float32)
    return kv_mask.to(dtype=torch.float32).contiguous()


def _dims(q, k, v, mask):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    _build.check_cuda("q", q, (b, h, lq, d))
    _build.check_cuda("k", k, (b, h, lk, d))
    _build.check_cuda("v", v, (b, h, lk, d))
    _build.check_cuda("kv_mask", mask, (b, lk))
    if not aligned(q, k):
        raise ValueError(f"flash kernels do not take Lq={lq}, Lk={lk}, "
                         f"Dh={d} (lengths multiples of {BLOCK}, Dh in "
                         f"{KERNEL_HEAD_DIMS})")
    if len({t.device for t in (q, k, v, mask)}) != 1:
        raise ValueError("flash attention operands must share one device")
    return b, h, lq, lk, d


def flash_attention_fwd(q, k, v, kv_mask=None):
    """The forward kernel: (out (B, H, Lq, Dh), lse (B, H, Lq)). One
    launch on the current stream."""
    mask = _mask_for(kv_mask, q.shape[0], k.shape[2], q.device)
    b, h, lq, lk, d = _dims(q, k, v, mask)
    _build.check_aligned16(q=q, k=k, v=v, kv_mask=mask)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, lq, device=q.device, dtype=torch.float32)
    lib = _build.load().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ertdx_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 mask.data_ptr(), out.data_ptr(),
                                 lse.data_ptr(), b * h, h, lq, lk, d,
                                 1.0 / math.sqrt(d), stream)
    _build.raise_on(rc, "flash_attention_fwd")
    launches["flash_attention_fwd"] += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, kv_mask, out, lse, do):
    """The dQ kernel: (dq (B, H, Lq, Dh), delta (B, H, Lq)) from the
    forward's operands, its (out, lse) and dO. One launch."""
    mask = _mask_for(kv_mask, q.shape[0], k.shape[2], q.device)
    b, h, lq, lk, d = _dims(q, k, v, mask)
    _build.check_cuda("out", out, (b, h, lq, d))
    _build.check_cuda("lse", lse, (b, h, lq))
    _build.check_cuda("do", do, (b, h, lq, d))
    _build.check_aligned16(q=q, k=k, v=v, kv_mask=mask, out=out, lse=lse,
                           do=do)
    dq = torch.empty_like(q)
    delta = torch.empty(b, h, lq, device=q.device, dtype=torch.float32)
    lib = _build.load().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ertdx_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    mask.data_ptr(), out.data_ptr(),
                                    lse.data_ptr(), do.data_ptr(),
                                    dq.data_ptr(), delta.data_ptr(), b * h,
                                    h, lq, lk, d, 1.0 / math.sqrt(d), stream)
    _build.raise_on(rc, "flash_attention_bwd_dq")
    launches["flash_attention_bwd_dq"] += 1
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, kv_mask, lse, delta, do):
    """The dK/dV kernel: (dk, dv) from the forward's operands, lse, the dQ
    kernel's delta and dO. One launch."""
    mask = _mask_for(kv_mask, q.shape[0], k.shape[2], q.device)
    b, h, lq, lk, d = _dims(q, k, v, mask)
    _build.check_cuda("lse", lse, (b, h, lq))
    _build.check_cuda("delta", delta, (b, h, lq))
    _build.check_cuda("do", do, (b, h, lq, d))
    _build.check_aligned16(q=q, k=k, v=v, kv_mask=mask, lse=lse,
                           delta=delta, do=do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.load().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ertdx_flash_bwd_dkv(q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), mask.data_ptr(),
                                     lse.data_ptr(), delta.data_ptr(),
                                     do.data_ptr(), dk.data_ptr(),
                                     dv.data_ptr(), b * h, h, lq, lk, d,
                                     1.0 / math.sqrt(d), stream)
    _build.raise_on(rc, "flash_attention_bwd_dkv")
    launches["flash_attention_bwd_dkv"] += 1
    return dk, dv


def skip_tiles(d: int) -> dict:
    """Keys of one skip of all-padding keys at head width d: the forward's
    and the dQ kernel's key tiles and a dK/dV warp's rows (needs the built
    kernels)."""
    out = (ctypes.c_int * 3)()
    rc = _build.load().lib.ertdx_flash_skip_tiles(d, out)
    _build.raise_on(rc, "flash skip tile query")
    return dict(zip(("fwd_key_tile", "dq_key_tile", "dkv_warp_keys"), out))


def flash_attention_bwd(q, k, v, kv_mask, out, lse, do):
    """The backward kernels: (dq, dk, dv). Two launches on the current
    stream, dQ (which writes delta) and then dK/dV."""
    dq, delta = flash_attention_bwd_dq(q, k, v, kv_mask, out, lse, do)
    return (dq,) + flash_attention_bwd_dkv(q, k, v, kv_mask, lse, delta, do)


class _FlashAttention(torch.autograd.Function):
    """Forward and backward on the CUDA kernels. Operands in another
    dtype than float32 go in as float32 copies (`.float()` of a float32
    tensor is the tensor itself); the output is rounded to q's dtype and
    saved so, and the gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask):
        out, lse = flash_attention_fwd(q.float(), k.float(), v.float(),
                                       kv_mask)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q.float(), k.float(), v.float(), kv_mask, out.float(), lse,
            _build.contiguous16(do.float()))
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    use_pallas: bool = True) -> torch.Tensor:
    """(B, H, Lq, Dh) attention with a (B, Lk) key mask, with a gradient.
    The CUDA kernels on CUDA tensors `aligned` takes when `use_pallas`
    (float32 operands directly, others through upcast copies, the output
    in q's dtype); the plain version under autograd elsewhere, with a
    warning (once per shape) where CUDA tensors with `use_pallas` have
    shapes the kernels do not take."""
    if use_pallas and q.device.type == "cuda":
        if aligned(q, k):
            mask = _mask_for(kv_mask, q.shape[0], k.shape[2], q.device)
            return _FlashAttention.apply(
                *(_build.contiguous16(t) for t in (q, k, v, mask)))
        warn_unaligned(q, k)
    return reference_attention(q, k, v, kv_mask)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def flash_cross_attention(q, k, v, kv_mask=None, use_pallas: bool = True,
                          min_q_len: int = 1024):
    """Attention for any (Lq, Lk, Dh) through the flash kernels
    (ertdx/ops/attention.py:338-356): Lq and Lk padded to 128, Dh up to
    64, 128 or 256 with q pre-scaled by sqrt(dp / d) so that the kernels'
    1/sqrt(dp) gives 1/sqrt(d), padded keys masked, the padding sliced
    away. The plain version below `min_q_len` query rows, for Dh > 256,
    without `use_pallas`, and on the CPU."""
    d = q.shape[3]
    dp = next((c for c in KERNEL_HEAD_DIMS if d <= c), None)
    if (not use_pallas or q.device.type != "cuda"
            or q.shape[2] < min_q_len or dp is None):
        return reference_attention(q, k, v, kv_mask)
    return flash_cross_padded(q, k, v, kv_mask)


def flash_cross_padded(q, k, v, kv_mask=None):
    """The padded call of `flash_cross_attention` (JAX's
    `_flash_cross_padded`, :359-375), through `flash_attention`: the
    kernels on the card, the plain version on the padded operands on the
    CPU."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dp = next(c for c in KERNEL_HEAD_DIMS if d <= c)
    lqp, lkp = _ceil_to(lq, BLOCK), _ceil_to(lk, BLOCK)
    if dp != d:
        q = q * math.sqrt(dp / d)
    pad = torch.nn.functional.pad
    q = pad(q, (0, dp - d, 0, lqp - lq))
    k = pad(k, (0, dp - d, 0, lkp - lk))
    v = pad(v, (0, dp - d, 0, lkp - lk))
    base = kv_mask if kv_mask is not None else torch.ones(
        b, lk, device=q.device, dtype=q.dtype)
    mask = pad(base.to(q.dtype), (0, lkp - lk))
    return flash_attention(q, k, v, mask, True)[:, :, :lq, :d]
