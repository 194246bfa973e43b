"""The plan of the one-pass slab attention kernels on wgmma and TMA
(csrc/slab_attn_bf16.cu), on the CPU.

The kernels run only on a card (tests/test_torch_gpu.py, chip_smoke.py
phases 2, 6 and 15). Their launch plan and the order of their arithmetic
are checked here:

* `ops/slab_attn.py::bf16_plan`: the ring of head slots, the staging
  tiles and the barriers fit an H100 block's shared memory at every L <=
  256 and dh in {32, 64}, for a float32 and a bf16 slab alike (both land
  as bf16 tiles); its warpgroups are the kernels'; the 64-row tiles reach
  at most 32 rows past a head's padded rows, which the kernels' layout
  leaves readable (the next tile of the slot, or the staging tiles after
  the ring);
* the forward emulated in numpy: 64-row query tiles over the head padded
  to Lp rows of zeros, the S operand bf16(q scale) (at dh = 64 bf16(q),
  S scaled after its product: the scale is a power of two), keys in
  chunks (64 wide, a last 32; or 32 wide, as the source's flags say), the
  keys past L at -inf; a first pass for the log-sum-exp of the logits
  scaled by log2(e) (an online max and sum), a second for the normalised
  P = exp2(s - lse), rounded to bf16 for P V;
* the backward emulated the same way in its two phases: per query tile a
  first pass over the keys for lse and delta = rowsum(P o dP) (the sum of
  exp2(s - max) dP rescaled beside the sum, divided by it), then S and dP
  again per key chunk, dS = P o (dP - delta) rounded to bf16 for dQ = dS
  K; per key tile the query chunks, P^T and dS^T from the shared lse and
  delta rows (+inf and 0 past L), dV += bf16(P^T) dO and dK += bf16(dS^T)
  Q, q unscaled;
on a bf16 slab and on a float32 one (whose fill rounds q, k, v and dO to
bf16, q times the scale at dh = 32), against JAX's interpret-mode kernels
(`slab_attention_interpret`, `slab_attention_backward_interpret`) with
their `_dot` rounding at DEFAULT, as their chip runs them
(tests/test_torch_slab_onepass.py's `jax_onepass`), on inputs made from a
numpy seed. The products are exact in float64 and rounded to float32, as
the tensor cores sum exact bf16 products in float32 in another order.
Tolerance: tests/test_torch_slab_onepass.py's two rules, the rms error
against the exact function within 0.8-1.25x of JAX's one-pass kernels'
(max error in JAX's bf16 band), and the same-function rule, the rms gap
to JAX's one-pass kernels under a quarter of their rms error.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.ops.slab_attn import (slab_attention_backward_interpret,
                                 slab_attention_interpret)
from ertdx_torch.ops import slab_attn as sa
from test_torch_slab_onepass import _hold, jax_onepass

SOURCE = (Path(sa.__file__).resolve().parent.parent / "csrc"
          / "slab_attn_bf16.cu").read_text()
LOG2E = np.float32(1.4426950408889634)


def _constant(name: str) -> str:
    return re.search(rf"\b{name} = (\w+)[,;]", SOURCE).group(1)


WIDE = {k: _constant(k) == "true" for k in ("FWD_WIDE", "DQ_WIDE",
                                              "DKV_WIDE")}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(x) -> np.ndarray:
    """float32 rounded to bf16 (to nearest even), back in float32."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def _mm(a, b) -> np.ndarray:
    """A product of float32 operands as the tensor cores give it: exact
    products summed, rounded to float32."""
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def _chunks(lp: int, wide: bool):
    c0, out = 0, []
    if wide:
        while c0 + 64 <= lp:
            out.append((c0, 64))
            c0 += 64
    while c0 < lp:
        out.append((c0, 32))
        c0 += 32
    return out


def _row_stats(qs, kp, l, lp, f, wide, vp=None, dout=None):
    """A query tile's first pass: lse (base 2) of the logits S f over the
    L keys, an online max and sum in float32; with dO and V also delta =
    rowsum(P o dP), the sum of exp2(s - max) dP beside it."""
    mx = np.full(len(qs), -np.inf, np.float32)
    sm = np.zeros(len(qs), np.float32)
    dacc = np.zeros(len(qs), np.float32)
    for c0, w in _chunks(lp, wide):
        s = _mm(qs, kp[c0:c0 + w].T) * f
        s[:, np.arange(c0, c0 + w) >= l] = -np.inf
        cm = np.maximum(mx, s.max(axis=1))
        alpha = np.exp2(mx - cm)
        sm *= alpha
        dacc *= alpha
        mx = cm
        p = np.exp2(s - mx[:, None]).astype(np.float32)
        sm += p.sum(axis=1, dtype=np.float32)
        if dout is not None:
            dp = _mm(dout, vp[c0:c0 + w].T)
            dacc += (p * dp).sum(axis=1, dtype=np.float32)
    return mx + np.log2(sm), dacc / sm


def _heads(x, h, dh, part, c):
    lo = part * c + h * dh
    return x[:, lo:lo + dh]


def _pad(x, lp):
    out = np.zeros((lp, x.shape[1]), np.float32)
    out[:len(x)] = x
    return out


def _operands(qkv_b, h, dh, c, lp):
    """A head's tiles as the kernels hold them: q, k, v rounded to bf16,
    and the S operand with its factor: bf16(q scale) and log2(e) at dh =
    32, bf16(q) and scale log2(e) at dh = 64 (the scale 1/8 is exact)."""
    scale = np.float32(1.0 / np.sqrt(np.float32(dh)))
    q, k, v = (_pad(_heads(qkv_b, h, dh, p, c), lp) for p in range(3))
    qb, kb, vb = _bf16(q), _bf16(k), _bf16(v)
    if dh == 32:
        return qb, _bf16(q * scale), kb, vb, LOG2E, scale
    return qb, qb, kb, vb, scale * LOG2E, scale


def emulate_forward(qkv, nh, dtype=np.float32):
    """out (B, L, C) as slab_fwd_wgmma_kernel computes it, in `dtype`'s
    rounding (float32, or bf16 for a bf16 slab)."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    dh = c // nh
    plan = sa.bf16_plan(l, dh)
    lp = plan["lp"]
    out = np.zeros((b, l, c), np.float32)
    for bi in range(b):
        for h in range(nh):
            _, qs, k, v, f, _ = _operands(qkv[bi], h, dh, c, lp)
            for m0 in range(0, 64 * plan["tiles"], 64):
                rows = slice(m0, min(m0 + 64, l))
                lse, _ = _row_stats(qs[rows], k, l, lp, f, WIDE["FWD_WIDE"])
                o = np.zeros((len(lse), dh), np.float32)
                for c0, w in _chunks(lp, WIDE["FWD_WIDE"]):
                    p = np.exp2(_mm(qs[rows], k[c0:c0 + w].T) * f
                                - lse[:, None]).astype(np.float32)
                    p[:, np.arange(c0, c0 + w) >= l] = 0.0
                    o += _mm(_bf16(p), v[c0:c0 + w])
                out[bi, rows, h * dh:(h + 1) * dh] = o
    return out if dtype == np.float32 else _bf16(out)


def emulate_backward(qkv, do, nh, dtype=np.float32):
    """dQKV (B, L, 3C) as slab_bwd_wgmma_kernel computes it, in `dtype`'s
    rounding."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    dh = c // nh
    plan = sa.bf16_plan(l, dh)
    lp, tiles = plan["lp"], plan["tiles"]
    dqkv = np.zeros((b, l, c3), np.float32)
    for bi in range(b):
        for h in range(nh):
            q, qs, k, v, f, scale = _operands(qkv[bi], h, dh, c, lp)
            dout = _bf16(_pad(do[bi, :, h * dh:(h + 1) * dh], lp))
            lse = np.full(lp, np.inf, np.float32)
            delta = np.zeros(lp, np.float32)
            # phase i: query tiles
            for m0 in range(0, 64 * tiles, 64):
                rows = slice(m0, min(m0 + 64, l))
                ls, dl = _row_stats(qs[rows], k, l, lp, f, WIDE["DQ_WIDE"],
                                    v, dout[rows])
                lse[rows], delta[rows] = ls, dl
                dq = np.zeros((len(ls), dh), np.float32)
                for c0, w in _chunks(lp, WIDE["DQ_WIDE"]):
                    s = _mm(qs[rows], k[c0:c0 + w].T)
                    p = np.exp2(s * f - ls[:, None])
                    p[:, np.arange(c0, c0 + w) >= l] = 0.0
                    dp = _mm(dout[rows], v[c0:c0 + w].T)
                    ds = (p * (dp - dl[:, None])).astype(np.float32)
                    dq += _mm(_bf16(ds), k[c0:c0 + w])
                dqkv[bi, rows, h * dh:(h + 1) * dh] = dq * scale
            # phase ii: key tiles, against the lse and delta rows
            for n0 in range(0, 64 * tiles, 64):
                keys = slice(n0, min(n0 + 64, l))
                dk = np.zeros((keys.stop - n0, dh), np.float32)
                dv = np.zeros_like(dk)
                for c0, w in _chunks(lp, WIDE["DKV_WIDE"]):
                    cols = slice(c0, c0 + w)
                    st = _mm(k[keys], qs[cols].T)
                    p = np.exp2(st * f - lse[cols]).astype(np.float32)
                    dpt = _mm(v[keys], dout[cols].T)
                    ds = (p * (dpt - delta[cols])).astype(np.float32)
                    dv += _mm(_bf16(p), dout[cols])
                    dk += _mm(_bf16(ds), q[cols])
                dqkv[bi, keys, c + h * dh:c + (h + 1) * dh] = dk * scale
                dqkv[bi, keys, 2 * c + h * dh:2 * c + (h + 1) * dh] = dv
    return dqkv if dtype == np.float32 else _bf16(dqkv)


def _inputs(b, l, c, seed, dtype):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, l, 3 * c)).astype(np.float32)
    do = rng.normal(size=(b, l, c)).astype(np.float32)
    if dtype == "bf16":
        return _bf16(qkv), _bf16(do)
    return qkv, do


@pytest.mark.parametrize("b,l,c,nh", [
    (2, 1, 64, 1),        # one token: a 32-key chunk, 31 rows of padding
    (2, 17, 64, 2),       # dh=32, one short chunk
    (1, 147, 256, 4),     # the encoder's stage: 64 + 64 + 32 keys
    (2, 147, 256, 8),     # dh=32
    (1, 200, 128, 2),     # four query tiles, 64 x 3 + 32 keys
    (1, 256, 128, 2),     # the longest L
    (1, 256, 64, 2),      # the longest L at dh=32
])
def test_emulated_kernels_match_the_pallas_kernels(b, l, c, nh):
    """Both kernels, on a bf16 and on a float32 slab, against JAX's
    one-pass interpret kernels (the rms and same-function rules). One
    token is exact on both sides (P = 1, dS = 0: out is bf16(v) and dV
    bf16(dO)), so its values are held equal."""
    for dtype in ("bf16", "f32"):
        qkv, do = _inputs(b, l, c, b * 1000 + l + nh, dtype)
        jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        jq, jdo = jnp.asarray(qkv, jdt), jnp.asarray(do, jdt)
        exact = np.asarray(slab_attention_interpret(jnp.asarray(qkv), nh))
        dexact = np.asarray(slab_attention_backward_interpret(
            jnp.asarray(qkv), jnp.asarray(do), nh))
        with jax_onepass():
            want = np.asarray(slab_attention_interpret(jq, nh), np.float32)
            dwant = np.asarray(slab_attention_backward_interpret(jq, jdo, nh),
                               np.float32)
        rounding = np.float32 if dtype == "f32" else "bf16"
        got = emulate_forward(qkv, nh, rounding)
        dgot = emulate_backward(qkv, do, nh, rounding)
        if l == 1:
            assert np.array_equal(got, want) and np.array_equal(dgot, dwant)
            continue
        _hold(got, want, exact, f"forward {dtype}")
        _hold(dgot, dwant, dexact, f"backward {dtype}")


def test_delta_from_o_is_rowsum_p_dp():
    """The kernels' delta, the online sum of exp2(s - max) dP rescaled
    beside the row sum and divided by it, is rowsum(P o dP) with P
    normalised, JAX's delta, within a few float32 roundings; the former
    kernels' rowsum(dO o O), whose O rounds P to bf16 for P V, is not."""
    qkv, do = _inputs(1, 147, 64, 3, "bf16")
    dh = 64
    lp = sa.bf16_plan(147, dh)["lp"]
    _, qs, k, v, f, _ = _operands(qkv[0], 0, dh, dh, lp)
    dout = _pad(do[0], lp)
    lse, delta = _row_stats(qs[:147], k, 147, lp, f, WIDE["DQ_WIDE"], v,
                            dout[:147])
    s = (qs[:147].astype(np.float64) @ k[:147].T.astype(np.float64)) / 8.0
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    exact = (p * (dout[:147].astype(np.float64)
                  @ v[:147].T.astype(np.float64))).sum(1)
    top = np.abs(exact).max()
    assert np.abs(delta - exact).max() <= 1e-5 * top
    o = _mm(_bf16(p.astype(np.float32)), v[:147])
    from_o = (o * dout[:147]).sum(axis=1)
    assert np.abs(from_o - exact).max() > 10 * np.abs(delta - exact).max()


@pytest.mark.parametrize("dh", [32, 64])
def test_plan_fits_shared_memory_at_every_length(dh):
    for l in range(1, sa.KERNEL_L_MAX + 1):
        plan = sa.bf16_plan(l, dh)
        lp, tiles = plan["lp"], plan["tiles"]
        assert lp % 32 == 0 and l <= lp < l + 32
        assert 64 * tiles >= lp and 64 * tiles <= lp + 32
        for k, most in sa.BF16_MAX_STAGES.items():
            assert 1 <= plan[f"{k}_stages"] <= most
            assert plan[f"{k}_smem"] <= sa.SMEM_MAX
            # a deeper ring would not fit, or is past the most taken
            deeper = plan[f"{k}_smem"] + (plan[f"{k}_smem"] - 1024
                                          - sa.BF16_WARPGROUPS[k] * 128 * dh
                                          ) // plan[f"{k}_stages"]
            assert plan[f"{k}_stages"] == most or deeper > sa.SMEM_MAX
        # the backward's last tile reads up to 32 rows past its dO tile:
        # the staging tiles after the ring hold them
        assert sa.BF16_WARPGROUPS["bwd"] * 64 >= 32
    assert sa.bf16_plan(147, 64)["bwd_stages"] >= 2


def test_plan_matches_the_kernels():
    """The plan's warpgroups are the source's, and so are its padding
    (Lp = L rounded up to 32), its backward's tiles a slot (Q, K, V, dO,
    and at dh = 32 the scaled Q apart) and its shared bytes at the
    encoder's shapes; one plan serves both dtypes (the kernels' templates
    on the slab's type share their shared-memory reckoning)."""
    assert sa.BF16_WARPGROUPS == {"fwd": int(_constant("FWD_WARPGROUPS")),
                                  "bwd": int(_constant("BWD_WARPGROUPS"))}
    assert "(L + 31) / 32 * 32" in SOURCE
    assert "return DH == 32 ? 5 : 4;" in SOURCE
    for entry in ("fwd", "bwd"):
        assert re.search(rf"template <typename T, int DH>\ncudaError_t "
                         rf"{entry}\(.*?{entry}_smem\(Lp, DH, stages\)",
                         SOURCE, re.S)
    for dh, tiles in ((64, 4), (32, 5)):
        plan = sa.bf16_plan(147, dh)
        stages, wgs = plan["fwd_stages"], sa.BF16_WARPGROUPS["fwd"]
        assert plan["fwd_smem"] == (1024 + stages * 3 * 160 * 2 * dh
                                    + wgs * 64 * 2 * dh + 16 * stages)
        stages, wgs = plan["bwd_stages"], sa.BF16_WARPGROUPS["bwd"]
        assert plan["bwd_smem"] == (1024 + stages * (tiles * 160 * 2 * dh
                                                     + 2 * 160 * 4)
                                    + wgs * 64 * 2 * dh + 24 * stages)
