"""Fused-core ensemble kernels: wrappers, plain versions, launch counts.

`fused_core_stack` (the whole denoiser core: lift -> nb CoreBlocks ->
out-norm -> head) and `fused_core_block` (one CoreBlock over
condition-major chain slabs) port the TPU kernels of
ertdx/ops/core_block.py:281-518 to the hand-written CUDA kernels of
csrc/core_onepass.cu, on Hopper's bf16 wgmma and TMA in both of JAX's
modes. Argument layouts are the JAX package's:

    x     (B*n_chunks, chunk, P) compact chains         [stack]
    x3    (B*n_chunks, chunk*P, D) chain slabs          [block]
    mods  (B, 6*nb, D) / (B, 6, D) AdaLN rows s1,h1,s2,h2,s3,h3 per block
    k, v  (B*nb, Lk, D) / (B, Lk, D) per-condition cross K/V, unpadded
    ws    weight stacks wqkv (nb,D,3D), wso/wcq/wco (nb,D,D), w1 (nb,D,4D),
          w2 (nb,4D,D), biases bso/bco/b2 (nb,D), b1 (nb,4D); dense
          kernels in (in, out) layout

`accurate` selects JAX's numeric mode (ertdx/ops/core_block.py::_dot),
and each mode has its kernel and its plain version:

* `accurate=False`, JAX's default: every product that JAX's `_dot`
  computes is one bf16 pass with float32 accumulation, its operands
  rounded to bf16 to nearest even (`round_bf16`, `mm_onepass`). The
  stack also rounds what JAX's one-hot relayout products round (the
  chains' x, pos_emb, the head's tokens and weights, eps plus the head
  bias), so every output of the one-pass stack is a bf16 value.
* `accurate=True`: JAX's bf16_3x, a_hi b_hi + a_lo b_hi + a_hi b_lo with
  hi = bf16(a) and lo = bf16(a - hi) (`split_hilo`, `mm_3x`): JAX's
  `_hilo` split, its lo parts rounded by the TPU's one-pass DEFAULT
  products, about 1.3e-5 a product against float32's 1e-7. The stack's
  one-hot relayouts leave x, pos_emb and eps plus the head bias as hi +
  bf16(v - hi) (`round3`), and its head is a bf16_3x dot.

Both modes' kernels run each pass as bf16 wgmma on Hopper, B operands by
TMA: the weights from bf16 copies rounded once a run (`pack_core_weights`
and, with their lo parts, `pack_core_weights_3x`, which `models/mega.py::
mega_weights` makes; a wrapper given none packs its own), K and V
rounded, or split, once a run (`kv_operands`, which `models/mega.py::
mega_cross_kv` calls; a wrapper given none makes its own); 128-row
blocks of two warpgroups, each warpgroup whole chains (`tile_plan`).
The float32 plain versions (`fused_core_stack_plain`,
`fused_core_block_plain`) stay as the exact function the tests measure
both modes against.

A wrapper given CPU tensors computes the plain PyTorch version of the
mode asked for; given CUDA tensors it launches that mode's kernel or
raises — it never falls back. The plain versions are also the oracle the
kernels are held against on the card. `launches` counts kernel launches
of both modes, `onepass_launches` those of the one-pass kernels alone.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

LN_EPS = 1e-6
# what the CUDA kernels take (csrc/core_onepass.cu: D, P_MAX, LK_MAX)
KERNEL_D = 128
KERNEL_P_MAX = 32
KERNEL_LK_MAX = 256
# the packed weight tiles of a CoreBlock, in the order the kernels'
# packs hold them (csrc/core_onepass.cu): the k, v and q columns of
# wqkv, wso, wcq, wco, then w1's and w2's D-wide chunks in turns
PACK_ORDER = ("wqkv_k", "wqkv_v", "wqkv_q", "wso", "wcq", "wco",
              "w1_0", "w2_0", "w1_1", "w2_1", "w1_2", "w2_2", "w1_3", "w2_3")
# rows of a one-pass warpgroup, warpgroups a block (csrc/core_onepass.cu:
# WG_ROWS, WARPGROUPS)
WG_ROWS = 64
WARPGROUPS = 2

launches = {"fused_core_stack": 0, "fused_core_block": 0}
onepass_launches = {"fused_core_stack": 0, "fused_core_block": 0}


def reset_launches() -> None:
    for counts in (launches, onepass_launches):
        for name in counts:
            counts[name] = 0


def kernel_supports(p: int, d: int, lk: int) -> bool:
    """Whether the CUDA kernels take this core shape (their feasibility
    check, in place of the TPU's VMEM estimators)."""
    return d == KERNEL_D and 1 <= p <= KERNEL_P_MAX and 1 <= lk <= \
        KERNEL_LK_MAX


# ---------------------------------------------------------------------------
# JAX's TPU plan (ertdx/ops/core_block.py:160-279), copied so that
# models/mega.py::tpu_mega_plan can tell where JAX runs its kernels. The
# estimates are of a TPU core's VMEM; they choose the function, not a
# launch of this port.
# ---------------------------------------------------------------------------

MAX_SINGLE_TILE = 12
TPU_CORE_VMEM_BUDGET = 16 * 2 ** 20


def chunk_candidates(n_real: int, p: int) -> list:
    """JAX's valid chains-per-tile values, best first: the divisors of R
    that are 8-divisible within the p-aware row cap, then the small ones
    (at most MAX_SINGLE_TILE, and 384 // p) that fill 128 rows or cover R
    whole."""
    cap8 = min(n_real, 64, max(1, 2048 // p))
    cap_small = min(MAX_SINGLE_TILE, max(1, 384 // p))
    div = [c for c in range(1, n_real + 1) if n_real % c == 0]
    eights = [c for c in div if c % 8 == 0 and c <= cap8]
    smalls = [c for c in div if c % 8 and c <= cap_small
              and (c * p >= 128 or c == n_real)]
    return sorted(eights, reverse=True) + sorted(smalls, reverse=True)


def pick_chunk(n_real: int, p: int) -> int:
    cands = chunk_candidates(n_real, p)
    return cands[0] if cands else 0


def stack_vmem_bytes(p: int, d: int, nb: int, lk: int, chunk: int,
                     accurate: bool = False, outer: int = 0) -> int:
    """JAX's VMEM estimate of its stack kernel (bytes, float32)."""
    outer = outer or pick_chunk(chunk, p)
    if outer == 0:
        return 1 << 62
    tile = 8 if outer % 8 == 0 else outer
    lkp = -(-lk // 128) * 128
    rows_o, rows_t = outer * p, tile * p
    fixed = 4 * (2 * chunk * p + 6 * nb * d + 2 * nb * lkp * d
                 + 14 * nb * d * d + 8 * nb * d + 2 * p * d + 6 * d)
    act = 4 * (rows_o * (outer + p) + 4 * rows_o * d + rows_o * 4 * d
               + 2 * rows_t * rows_t + 2 * rows_o * lkp + 3 * rows_t * d)
    if accurate:
        act += 4 * 2 * (rows_o * d + 4 * d * d)
    return fixed + act


def block_vmem_bytes(p: int, d: int, lk: int, chunk: int,
                     accurate: bool = False) -> int:
    """JAX's VMEM estimate of its per-block kernel (bytes, float32)."""
    if chunk == 0:
        return 1 << 62
    tile = 8 if chunk % 8 == 0 else chunk
    lkp = -(-lk // 128) * 128
    rows, rows_t = chunk * p, tile * p
    fixed = 4 * (14 * d * d + 8 * d + 6 * d + 2 * lkp * d)
    slabs = 4 * 3 * rows * d
    act = 4 * (rows * 5 * d + 2 * rows * lkp + 2 * rows_t * rows_t
               + 3 * rows_t * d)
    if accurate:
        act += 4 * 2 * (rows * d + 4 * d * d)
    return fixed + slabs + act


def pick_stack_outer(n_real: int, p: int, d: int, nb: int, lk: int,
                     accurate: bool = False) -> int:
    """JAX's stack tile: the first candidate within the budget, or 0."""
    for c in chunk_candidates(n_real, p):
        if stack_vmem_bytes(p, d, nb, lk, n_real, accurate,
                            outer=c) <= TPU_CORE_VMEM_BUDGET:
            return c
    return 0


def pick_block_chunk(n_real: int, p: int, d: int, lk: int,
                     accurate: bool = False) -> int:
    """JAX's per-block chunk: the first candidate within the budget, or
    0."""
    for c in chunk_candidates(n_real, p):
        if block_vmem_bytes(p, d, lk, c, accurate) <= TPU_CORE_VMEM_BUDGET:
            return c
    return 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _ln(x):
    """LayerNorm without affine over the last axis, eps 1e-6."""
    return F.layer_norm(x, x.shape[-1:], eps=LN_EPS)


def round_bf16(a: torch.Tensor) -> torch.Tensor:
    """a rounded to bf16 to nearest even, in a's dtype: JAX's
    `astype(bfloat16)` bit for bit, a NaN included (the quiet NaN of its
    sign; PyTorch's CPU cast gives another NaN)."""
    r = a.to(torch.bfloat16).to(a.dtype)
    return torch.where(torch.isnan(a),
                       torch.copysign(torch.full_like(a, math.nan), a), r)


def mm_onepass(a, b):
    """a @ b as JAX's one-pass `_dot` computes it: both operands rounded
    to bf16, the exact products summed in a's dtype (float32)."""
    return round_bf16(a) @ round_bf16(b)


def _ftz(a: torch.Tensor) -> torch.Tensor:
    """a with every subnormal value a zero of its sign."""
    return torch.where(a.abs() < torch.finfo(a.dtype).tiny, a * 0, a)


def split_hilo(a: torch.Tensor):
    """(hi, lo) = (bf16(a), bf16(a - hi)), in a's dtype: JAX's `_hilo(a)`
    with its lo part rounded as the TPU's one-pass product rounds it, bit
    for bit. XLA computes a - hi with subnormal operands and results
    flushed to zeros of their sign (on the TPU and on the CPU), and so
    does this (the kernels' sub.ftz)."""
    hi = round_bf16(a)
    return hi, round_bf16(_ftz(_ftz(a) - _ftz(hi)))


def round3(a: torch.Tensor) -> torch.Tensor:
    """hi + lo of `split_hilo(a)`: what a bf16_3x product with a one-hot
    matrix (JAX's relayouts in the stack) leaves of a."""
    hi, lo = split_hilo(a)
    return hi + lo


def mm_3x(a, b):
    """a @ b as JAX's `_dot(accurate=True)` computes it on the TPU,
    bf16_3x: ah bh + al bh + ah bl from `split_hilo` of each operand,
    three float32 sums of exact products added in that order."""
    ah, al = split_hilo(a)
    bh, bl = split_hilo(b)
    return ah @ bh + al @ bh + ah @ bl


def _block_plain(x, mods, k, v, w, p: int, mm=torch.matmul):
    """One CoreBlock on (B, R*P, D) condition-major rows, every product
    through mm."""
    b, rows, d = x.shape
    scale = 1.0 / math.sqrt(d)
    s1, h1, s2, h2, s3, h3 = (mods[:, j:j + 1, :] for j in range(6))

    qkv = mm(_ln(x) * (1.0 + s1) + h1, w["wqkv"])
    q, kk, vv = (z.reshape(b * rows // p, p, d)
                 for z in qkv.split(d, dim=-1))
    att = torch.softmax(mm(q * scale, kk.transpose(1, 2)), dim=-1)
    a = mm(att, vv).reshape(b, rows, d)
    x = x + mm(a, w["wso"]) + w["bso"]

    q = mm(_ln(x) * (1.0 + s2) + h2, w["wcq"]) * scale
    att = torch.softmax(mm(q, k.transpose(1, 2)), dim=-1)
    x = x + mm(mm(att, v), w["wco"]) + w["bco"]

    h = F.gelu(mm(_ln(x) * (1.0 + s3) + h3, w["w1"]) + w["b1"],
               approximate="tanh")
    return x + mm(h, w["w2"]) + w["b2"]


def _block(x3, mods, k, v, w, p: int, mm):
    g, rows, d = x3.shape
    b = mods.shape[0]
    out = _block_plain(x3.reshape(b, g // b * rows, d), mods, k, v, w, p,
                       mm)
    return out.reshape(g, rows, d)


def fused_core_block_plain(x3, mods, k, v, w, *, p: int):
    return _block(x3, mods, k, v, w, p, torch.matmul)


def fused_core_block_onepass_plain(x3, mods, k, v, w, *, p: int):
    return _block(x3, mods, k, v, w, p, mm_onepass)


def fused_core_block_3x_plain(x3, mods, k, v, w, *, p: int):
    return _block(x3, mods, k, v, w, p, mm_3x)


# a stack mode's products and what its one-hot relayouts leave of a value
_STACK_MODES = {"float32": (torch.matmul, lambda a: a),
                "onepass": (mm_onepass, round_bf16),
                "bf16x3": (mm_3x, round3)}


def _stack(x, mods, k, v, ws, lift_w, lift_b, pos_emb, on_scale, on_bias,
           head_w, head_b, p: int, mode: str):
    mm, rnd = _STACK_MODES[mode]
    g, chunk, _ = x.shape
    b = mods.shape[0]
    nb = ws["wqkv"].shape[0]
    d = lift_w.shape[-1]
    lk = k.shape[1]
    r = g // b * chunk
    cur = (rnd(x).reshape(b * r, p, 1) * lift_w.reshape(1, 1, d)
           + lift_b.reshape(1, 1, d) + rnd(pos_emb)[None]
           ).reshape(b, r * p, d)
    k4 = k.reshape(b, nb, lk, d)
    v4 = v.reshape(b, nb, lk, d)
    for i in range(nb):
        w = {key: val[i] for key, val in ws.items()}
        cur = _block_plain(cur, mods[:, 6 * i:6 * i + 6], k4[:, i], v4[:, i],
                           w, p, mm)
    tok = _ln(cur) * on_scale.reshape(1, 1, d) + on_bias.reshape(1, 1, d)
    eps = rnd(mm(tok, head_w.reshape(d, 1)) + head_b.reshape(1, 1, 1))
    return eps.reshape(g, chunk, p)


def fused_core_stack_plain(x, mods, k, v, ws, lift_w, lift_b, pos_emb,
                           on_scale, on_bias, head_w, head_b, *, p: int):
    return _stack(x, mods, k, v, ws, lift_w, lift_b, pos_emb, on_scale,
                  on_bias, head_w, head_b, p, "float32")


def fused_core_stack_onepass_plain(x, mods, k, v, ws, lift_w, lift_b,
                                   pos_emb, on_scale, on_bias, head_w,
                                   head_b, *, p: int):
    return _stack(x, mods, k, v, ws, lift_w, lift_b, pos_emb, on_scale,
                  on_bias, head_w, head_b, p, "onepass")


def fused_core_stack_3x_plain(x, mods, k, v, ws, lift_w, lift_b, pos_emb,
                              on_scale, on_bias, head_w, head_b, *, p: int):
    return _stack(x, mods, k, v, ws, lift_w, lift_b, pos_emb, on_scale,
                  on_bias, head_w, head_b, p, "bf16x3")


def plain_versions(accurate: bool) -> tuple:
    """The plain (stack, block) versions of a mode: what a wrapper
    computes on CPU tensors, and the kernels' oracle on the card."""
    if accurate:
        return fused_core_stack_3x_plain, fused_core_block_3x_plain
    return fused_core_stack_onepass_plain, fused_core_block_onepass_plain


# ---------------------------------------------------------------------------
# the one-pass kernels' operands and tiling
# ---------------------------------------------------------------------------

def _bf16_bits(r: torch.Tensor) -> torch.Tensor:
    """A float32 tensor of bf16 values as a torch.bfloat16 tensor, bit for
    bit (its upper 16 bits; a NaN keeps its sign, which a cast would
    drop)."""
    return (r.view(torch.int32) >> 16).to(torch.int16).view(torch.bfloat16)


def bf16_copy(a: torch.Tensor) -> torch.Tensor:
    """`round_bf16(a)` as a torch.bfloat16 tensor, bit for bit."""
    return _bf16_bits(round_bf16(a.to(torch.float32)))


def _kmajor_tiles(ws) -> torch.Tensor:
    """(nb, 14, D, D) float32: tile j of block i the (in, out) matrix
    PACK_ORDER[j] of block i transposed to K-major (row n, column k: W[k,
    n]). `ws` holds JAX's stacks (leading nb) or one block's matrices."""
    w = {key: ws[key] if ws["wso"].dim() == 3 else ws[key][None]
         for key in ("wqkv", "wso", "wcq", "wco", "w1", "w2")}
    d = w["wso"].shape[-1]

    def cols(m, c):
        return m[..., c * d:(c + 1) * d]

    tiles = [cols(w["wqkv"], 1), cols(w["wqkv"], 2), cols(w["wqkv"], 0),
             w["wso"], w["wcq"], w["wco"]]
    for c in range(4):
        tiles += [cols(w["w1"], c), w["w2"][:, c * d:(c + 1) * d]]
    return torch.stack(tiles, dim=1).transpose(-1, -2).to(torch.float32)


def pack_core_weights(ws) -> torch.Tensor:
    """The one-pass kernels' weights: (nb, 14, D, D) bfloat16, the
    K-major tiles of `_kmajor_tiles`, each value `round_bf16` of the
    float32 weight, which is what JAX's one-pass `_dot` multiplies. TMA
    reads each tile in two boxes of 64 columns and swizzles them by 128
    bytes on the way into shared memory. Computed once a run by
    `models/mega.py::mega_weights`."""
    return bf16_copy(_kmajor_tiles(ws)).contiguous()


def split_bf16(a: torch.Tensor, dim: int) -> torch.Tensor:
    """`split_hilo(a)` as bfloat16 copies, hi then lo, stacked at `dim`."""
    hi, lo = split_hilo(a.to(torch.float32))
    return torch.stack([_bf16_bits(hi), _bf16_bits(lo)],
                       dim=dim).contiguous()


def kv_operands(k: torch.Tensor, v: torch.Tensor, accurate: bool) -> tuple:
    """The mode's kernel operands of the cross K and V: bf16 copies
    (`bf16_copy`), or with `accurate` their hi and lo parts
    (`split_bf16` at dim 1). A wrapper given none makes them each call;
    `models/mega.py::mega_cross_kv` makes them once a run, as K and V do
    not change over a reverse chain's steps."""
    if accurate:
        return split_bf16(k, 1), split_bf16(v, 1)
    return bf16_copy(k), bf16_copy(v)


def pack_core_weights_3x(ws) -> torch.Tensor:
    """The bf16_3x kernels' weights: (nb, 14, 2, D, D) bfloat16, tile j of
    block i as `pack_core_weights` lays it out, its hi part (that pack's
    values) at [i, j, 0] and its lo part, bf16(w - hi), at [i, j, 1]: what
    JAX's `_dot(accurate=True)` multiplies on the TPU. Computed once a run
    by `models/mega.py::mega_weights` for a model in that mode."""
    return split_bf16(_kmajor_tiles(ws), dim=2)


class TilePlan(NamedTuple):
    """How the one-pass kernels cut a condition's R chains of P tokens: a
    warpgroup holds `cpw` = floor(64 / P) whole chains, a block two
    warpgroups, a condition `tiles` blocks (the grid is B x tiles).
    Warpgroup wg of block `tile` takes the chains from (tile WARPGROUPS +
    wg) cpw, at most cpw of them, none past R."""
    cpw: int
    tiles: int


def tile_plan(r: int, p: int) -> TilePlan:
    """The one-pass kernels' tiling of R chains of P tokens (1 <= P <=
    64)."""
    cpw = WG_ROWS // p
    return TilePlan(cpw, -(-r // (WARPGROUPS * cpw)))


def occupancy(accurate: bool = False) -> dict:
    """The mode's kernels' dynamic shared memory a block, resident blocks
    an SM and threads a block, as the card reports them."""
    out = (ctypes.c_int * 4)()
    name = ("ertdx_core_bf16x3_occupancy" if accurate
            else "ertdx_core_onepass_occupancy")
    _build.raise_on(getattr(_build.load().lib, name)(out), name)
    return {"smem_bytes": out[0], "stack_blocks_per_sm": out[1],
            "block_blocks_per_sm": out[2], "threads": out[3]}


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


def _count(name: str, accurate: bool) -> None:
    launches[name] += 1
    if not accurate:
        onepass_launches[name] += 1


def _same_device(tensors) -> None:
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the kernel's tensors must share one CUDA device")


def _check_bf16(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, the kernel "
                         f"expects {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes contiguous 16-byte "
                         "aligned data")


def _operands(k, v, ws, packed, kv, nb: int, d: int, accurate: bool):
    """The mode's kernel's bf16 operands: K and V rounded, or with
    `accurate` split into hi and lo parts (`kv`, or made here from k and
    v: `kv_operands`), and the packed weights (`packed`, or packed here
    from ws)."""
    parts = (2,) if accurate else ()
    if packed is None:
        packed = (pack_core_weights_3x if accurate else pack_core_weights)(ws)
    _check_bf16("packed", packed, (nb, len(PACK_ORDER)) + parts + (d, d))
    kb, vb = kv if kv is not None else kv_operands(k, v, accurate)
    _check_bf16("k operand", kb, k.shape[:1] + parts + k.shape[1:])
    _check_bf16("v operand", vb, v.shape[:1] + parts + v.shape[1:])
    return kb, vb, packed


def fused_core_stack(x, mods, k, v, ws, lift_w, lift_b, pos_emb, on_scale,
                     on_bias, head_w, head_b, *, p: int, chunk: int,
                     accurate: bool = False, packed=None, kv=None):
    """The whole denoiser core, (B*n_chunks, chunk, P) chains -> eps of the
    same shape, in the mode `accurate` selects. One CUDA launch on the
    current stream. `packed`: the mode's packed weights,
    `pack_core_weights(ws)` or with `accurate` `pack_core_weights_3x(ws)`,
    which the kernel reads in place of ws's matrices (packed here where
    None); `kv`: the mode's operands of k and v, `kv_operands(k, v,
    accurate)` (made here where None)."""
    tensors = [x, mods, k, v, *(ws[key] for key in WEIGHT_KEYS), lift_w,
               lift_b, pos_emb, on_scale, on_bias, head_w, head_b]
    if _on_cpu(tensors):
        return plain_versions(accurate)[0](
            x, mods, k, v, ws, lift_w, lift_b, pos_emb, on_scale, on_bias,
            head_w, head_b, p=p)
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
        kb, vb, packed = _operands(k, v, ws, packed, kv, nb, d, accurate)
        _same_device([x, packed, kb, vb])
        plan = tile_plan(r, p)
        entry = (lib.ertdx_core_stack_bf16x3 if accurate
                 else lib.ertdx_core_stack_onepass)
        rc = entry(*(t.data_ptr() for t in (
            x, mods, kb, vb, packed, ws["bso"], ws["bco"], ws["b1"],
            ws["b2"], lift_w, lift_b, pos_emb, on_scale, on_bias, head_w,
            head_b, out)), b, r, p, nb, lk, plan.cpw, plan.tiles, stream)
    _build.raise_on(rc, "fused_core_stack")
    _count("fused_core_stack", accurate)
    return out


def fused_core_block(x3, mods, k, v, w, *, p: int, chunk: int,
                     accurate: bool = False, packed=None, kv=None):
    """One CoreBlock over (B*n_chunks, chunk*P, D) condition-major chain
    slabs, in the mode `accurate` selects. One CUDA launch on the current
    stream. `packed`: the mode's packed weights of the block, (1, 14, D,
    D) or with `accurate` (1, 14, 2, D, D), and `kv` the mode's operands
    of k and v, as for `fused_core_stack`."""
    tensors = [x3, mods, k, v, *(w[key] for key in WEIGHT_KEYS)]
    if _on_cpu(tensors):
        return plain_versions(accurate)[1](x3, mods, k, v, w, p=p)
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
        kb, vb, packed = _operands(k, v, w, packed, kv, 1, d, accurate)
        _same_device([x3, packed, kb, vb])
        plan = tile_plan(r, p)
        entry = (lib.ertdx_core_block_bf16x3 if accurate
                 else lib.ertdx_core_block_onepass)
        rc = entry(*(t.data_ptr() for t in (
            x3, mods, kb, vb, packed, w["bso"], w["bco"], w["b1"], w["b2"],
            out)), b, r, p, lk, plan.cpw, plan.tiles, stream)
    _build.raise_on(rc, "fused_core_block")
    _count("fused_core_block", accurate)
    return out
