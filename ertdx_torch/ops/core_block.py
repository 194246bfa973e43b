"""Fused-core ensemble kernels: wrappers, plain versions, launch counts.

`fused_core_stack` (the whole denoiser core: lift -> nb CoreBlocks ->
out-norm -> head) and `fused_core_block` (one CoreBlock over
condition-major chain slabs) port the TPU kernels of
ertdx/ops/core_block.py:281-518 to the hand-written CUDA kernels of
csrc/core_block.cu. Argument layouts are the JAX package's:

    x     (B*n_chunks, chunk, P) compact chains         [stack]
    x3    (B*n_chunks, chunk*P, D) chain slabs          [block]
    mods  (B, 6*nb, D) / (B, 6, D) AdaLN rows s1,h1,s2,h2,s3,h3 per block
    k, v  (B*nb, Lk, D) / (B, Lk, D) per-condition cross K/V, unpadded
    ws    weight stacks wqkv (nb,D,3D), wso/wcq/wco (nb,D,D), w1 (nb,D,4D),
          w2 (nb,4D,D), biases bso/bco/b2 (nb,D), b1 (nb,4D); dense
          kernels in (in, out) layout

A wrapper given CPU tensors computes the plain PyTorch version; given
CUDA tensors it launches its kernel or raises — it never falls back. The
plain versions are also the oracle the kernels are held against on the
card. `launches` counts kernel launches only.

`accurate` selects the TPU kernels' bf16_3x mode in JAX; the CUDA
kernels run their products on the tensor cores in 3xTF32 (three TF32
MMAs a product, fp32-class, at least as exact as bf16_3x) whatever its
value, so it selects nothing yet: both values give the same bits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build

LN_EPS = 1e-6
# what the CUDA kernels take (csrc/core_block.cu: D, P_MAX, LK_MAX)
KERNEL_D = 128
KERNEL_P_MAX = 32
KERNEL_LK_MAX = 256

launches = {"fused_core_stack": 0, "fused_core_block": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def kernel_supports(p: int, d: int, lk: int) -> bool:
    """Whether the CUDA kernels take this core shape (their feasibility
    check, in place of the TPU's VMEM estimators)."""
    return d == KERNEL_D and 1 <= p <= KERNEL_P_MAX and 1 <= lk <= \
        KERNEL_LK_MAX


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _ln(x):
    """LayerNorm without affine over the last axis, eps 1e-6."""
    return F.layer_norm(x, x.shape[-1:], eps=LN_EPS)


def _block_plain(x, mods, k, v, w, p: int):
    """One CoreBlock on (B, R*P, D) condition-major rows."""
    b, rows, d = x.shape
    scale = 1.0 / math.sqrt(d)
    s1, h1, s2, h2, s3, h3 = (mods[:, j:j + 1, :] for j in range(6))

    qkv = (_ln(x) * (1.0 + s1) + h1) @ w["wqkv"]
    q, kk, vv = (z.reshape(b * rows // p, p, d)
                 for z in qkv.split(d, dim=-1))
    att = torch.softmax((q * scale) @ kk.transpose(1, 2), dim=-1)
    a = (att @ vv).reshape(b, rows, d)
    x = x + a @ w["wso"] + w["bso"]

    q = ((_ln(x) * (1.0 + s2) + h2) @ w["wcq"]) * scale
    att = torch.softmax(q @ k.transpose(1, 2), dim=-1)
    x = x + (att @ v) @ w["wco"] + w["bco"]

    h = F.gelu((_ln(x) * (1.0 + s3) + h3) @ w["w1"] + w["b1"],
               approximate="tanh")
    return x + h @ w["w2"] + w["b2"]


def fused_core_block_plain(x3, mods, k, v, w, *, p: int):
    g, rows, d = x3.shape
    b = mods.shape[0]
    out = _block_plain(x3.reshape(b, g // b * rows, d), mods, k, v, w, p)
    return out.reshape(g, rows, d)


def fused_core_stack_plain(x, mods, k, v, ws, lift_w, lift_b, pos_emb,
                           on_scale, on_bias, head_w, head_b, *, p: int):
    g, chunk, _ = x.shape
    b = mods.shape[0]
    nb = ws["wqkv"].shape[0]
    d = lift_w.shape[-1]
    lk = k.shape[1]
    r = g // b * chunk
    cur = (x.reshape(b * r, p, 1) * lift_w.reshape(1, 1, d)
           + lift_b.reshape(1, 1, d) + pos_emb[None]).reshape(b, r * p, d)
    k4 = k.reshape(b, nb, lk, d)
    v4 = v.reshape(b, nb, lk, d)
    for i in range(nb):
        w = {key: val[i] for key, val in ws.items()}
        cur = _block_plain(cur, mods[:, 6 * i:6 * i + 6], k4[:, i], v4[:, i],
                           w, p)
    tok = _ln(cur) * on_scale.reshape(1, 1, d) + on_bias.reshape(1, 1, d)
    eps = tok @ head_w.reshape(d, 1) + head_b.reshape(1, 1, 1)
    return eps.reshape(g, chunk, p)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

WEIGHT_KEYS = ("wqkv", "wso", "bso", "wcq", "wco", "bco", "w1", "b1", "w2",
               "b2")


def _on_cpu(tensors) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"tensors on mixed devices {sorted(devs)}")
    return False


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, the kernel "
                         f"expects {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes 16-byte aligned data")


def _check_weights(ws, nb: int, d: int, stacked: bool) -> None:
    shapes = {"wqkv": (d, 3 * d), "wso": (d, d), "bso": (d,),
              "wcq": (d, d), "wco": (d, d), "bco": (d,), "w1": (d, 4 * d),
              "b1": (4 * d,), "w2": (4 * d, d), "b2": (d,)}
    for key in WEIGHT_KEYS:
        shape = ((nb,) if stacked else ()) + shapes[key]
        _check(key, ws[key], shape)


def _same_device(tensors) -> None:
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the kernel's tensors must share one CUDA device")


def fused_core_stack(x, mods, k, v, ws, lift_w, lift_b, pos_emb, on_scale,
                     on_bias, head_w, head_b, *, p: int, chunk: int,
                     accurate: bool = False):
    """The whole denoiser core, (B*n_chunks, chunk, P) chains -> eps of the
    same shape. One CUDA launch on the current stream."""
    del accurate   # 3xTF32 for both values; see the module docstring
    tensors = [x, mods, k, v, *(ws[key] for key in WEIGHT_KEYS), lift_w,
               lift_b, pos_emb, on_scale, on_bias, head_w, head_b]
    if _on_cpu(tensors):
        return fused_core_stack_plain(x, mods, k, v, ws, lift_w, lift_b,
                                      pos_emb, on_scale, on_bias, head_w,
                                      head_b, p=p)
    _same_device(tensors)
    g, chunk_, p_ = x.shape
    b = mods.shape[0]
    nb = ws["wqkv"].shape[0]
    d = lift_w.shape[-1]
    lk = k.shape[1]
    if chunk_ != chunk or p_ != p or g % b:
        raise ValueError(f"x shape {tuple(x.shape)} does not fit p={p}, "
                         f"chunk={chunk}, B={b}")
    if not kernel_supports(p, d, lk):
        raise ValueError(f"fused_core_stack kernel does not take p={p}, "
                         f"d={d}, lk={lk}")
    r = g // b * chunk
    _check("x", x, (g, chunk, p))
    _check("mods", mods, (b, 6 * nb, d))
    _check("k", k, (b * nb, lk, d))
    _check("v", v, (b * nb, lk, d))
    _check_weights(ws, nb, d, stacked=True)
    _check("lift_w", lift_w, (1, d))
    _check("lift_b", lift_b, (1, d))
    _check("pos_emb", pos_emb, (p, d))
    _check("on_scale", on_scale, (1, d))
    _check("on_bias", on_bias, (1, d))
    _check("head_w", head_w, (d, 1))
    _check("head_b", head_b, (1, 1))
    out = torch.empty_like(x)
    lib = _build.load().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ertdx_core_stack(*(t.data_ptr() for t in tensors),
                                  out.data_ptr(), b, r, p, nb, lk, stream)
    _build.raise_on(rc, "fused_core_stack")
    launches["fused_core_stack"] += 1
    return out


def fused_core_block(x3, mods, k, v, w, *, p: int, chunk: int,
                     accurate: bool = False):
    """One CoreBlock over (B*n_chunks, chunk*P, D) condition-major chain
    slabs. One CUDA launch on the current stream."""
    del accurate   # 3xTF32 for both values; see the module docstring
    tensors = [x3, mods, k, v, *(w[key] for key in WEIGHT_KEYS)]
    if _on_cpu(tensors):
        return fused_core_block_plain(x3, mods, k, v, w, p=p)
    _same_device(tensors)
    g, rows, d = x3.shape
    b = mods.shape[0]
    lk = k.shape[1]
    if rows != chunk * p or g % b:
        raise ValueError(f"x3 shape {tuple(x3.shape)} does not fit p={p}, "
                         f"chunk={chunk}, B={b}")
    if not kernel_supports(p, d, lk):
        raise ValueError(f"fused_core_block kernel does not take p={p}, "
                         f"d={d}, lk={lk}")
    r = g // b * chunk
    _check("x3", x3, (g, rows, d))
    _check("mods", mods, (b, 6, d))
    _check("k", k, (b, lk, d))
    _check("v", v, (b, lk, d))
    _check_weights(w, 1, d, stacked=False)
    out = torch.empty_like(x3)
    lib = _build.load().lib
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        rc = lib.ertdx_core_block(*(t.data_ptr() for t in tensors),
                                  out.data_ptr(), b, r, p, lk, stream)
    _build.raise_on(rc, "fused_core_block")
    launches["fused_core_block"] += 1
    return out
