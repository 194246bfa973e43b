"""The plan of the bf16 slab attention kernels on wgmma and TMA
(csrc/slab_attn_bf16.cu), on the CPU.

The kernels run only on a card (tests/test_torch_gpu.py, chip_smoke.py
phases 2 and 15). Their launch plan and the order of their arithmetic
are checked here:

* `ops/slab_attn.py::bf16_plan`: the ring of head slots, the staging
  tiles and the barriers fit an H100 block's shared memory at every L <=
  256 and dh in {32, 64}; its warpgroups are the kernels'; the 64-row
  tiles reach at most 32 rows past a head's padded rows, which the
  kernels' layout leaves readable (the next tile of the slot, or the
  staging tiles after the ring);
* the forward emulated in numpy: 64-row query tiles over the head padded
  to Lp rows of zeros, keys in chunks (64 wide, a last 32; or 32 wide,
  as the source's flags say), the keys past L at -inf, an online softmax
  on exp2 of the logits scaled by log2(e), P rounded to bf16 for P V;
* the backward emulated the same way in its two phases: per query tile
  the forward's pass, lse (base 2) and delta = rowsum(dO o O) with O the
  pass's float32 output, then S and dP again per key chunk, dS = P o (dP
  - delta) rounded to bf16 for dQ = dS K; per key tile the query chunks,
  P^T and dS^T from the shared lse and delta rows (+inf and 0 past L),
  dV += bf16(P^T) dO and dK += bf16(dS^T) Q;
against JAX's interpret-mode kernels (`slab_attention_interpret`,
`slab_attention_backward_interpret`) on bf16 inputs made from a numpy
seed. The products are exact in float64 and rounded to float32, as the
tensor cores sum exact bf16 products in float32 in another order.
Tolerance: phase 15 (a)'s gate on the card, max(2 e_plain, 8e-3 max(1,
max|ref|)), with e_plain the error of the port's plain version in bf16
against the same reference; the emulation also stays within 8e-3 max(1,
max|ref|) alone.
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

SOURCE = (Path(sa.__file__).resolve().parent.parent / "csrc"
          / "slab_attn_bf16.cu").read_text()
LOG2E = np.float32(1.4426950408889634)


def _constant(name: str) -> str:
    return re.search(rf"\b{name} = (\w+)[,;]", SOURCE).group(1)


WIDE = {k: _constant(k) == "true" for k in ("FWD_WIDE", "DQ_WIDE",
                                              "DKV_WIDE")}


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


def _attend(q, kp, vp, l, lp, scale2, wide):
    """The forward's pass over one query tile's rows: o (unnormalised),
    the running max mx and the row sums, in float32."""
    mx = np.full(len(q), -np.inf, np.float32)
    sm = np.zeros(len(q), np.float32)
    o = np.zeros((len(q), kp.shape[1]), np.float32)
    for c0, w in _chunks(lp, wide):
        s = _mm(q, kp[c0:c0 + w].T) * scale2
        s[:, np.arange(c0, c0 + w) >= l] = -np.inf
        cm = np.maximum(mx, s.max(axis=1))
        alpha = np.exp2(mx - cm)
        sm *= alpha
        o *= alpha[:, None]
        mx = cm
        p = np.exp2(s - mx[:, None]).astype(np.float32)
        sm += p.sum(axis=1, dtype=np.float32)
        o += _mm(_bf16(p), vp[c0:c0 + w])
    return o, mx, sm


def _heads(x, h, dh, part, c):
    lo = part * c + h * dh
    return x[:, lo:lo + dh]


def _pad(x, lp):
    out = np.zeros((lp, x.shape[1]), np.float32)
    out[:len(x)] = x
    return out


def emulate_forward(qkv, nh):
    """out (B, L, C) as slab_fwd_wgmma_kernel computes it."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    dh = c // nh
    plan = sa.bf16_plan(l, dh)
    lp = plan["lp"]
    scale2 = np.float32(1.0 / np.sqrt(np.float32(dh))) * LOG2E
    out = np.zeros((b, l, c), np.float32)
    for bi in range(b):
        for h in range(nh):
            q, k, v = (_pad(_heads(qkv[bi], h, dh, p, c), lp)
                       for p in range(3))
            for m0 in range(0, 64 * plan["tiles"], 64):
                rows = slice(m0, min(m0 + 64, l))
                o, _, sm = _attend(q[rows], k, v, l, lp, scale2,
                                   WIDE["FWD_WIDE"])
                out[bi, rows, h * dh:(h + 1) * dh] = o * (1 / sm)[:, None]
    return _bf16(out)


def emulate_backward(qkv, do, nh):
    """dQKV (B, L, 3C) as slab_bwd_wgmma_kernel computes it."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    dh = c // nh
    plan = sa.bf16_plan(l, dh)
    lp, tiles = plan["lp"], plan["tiles"]
    scale = np.float32(1.0 / np.sqrt(np.float32(dh)))
    scale2 = scale * LOG2E
    dqkv = np.zeros((b, l, c3), np.float32)
    for bi in range(b):
        for h in range(nh):
            q, k, v = (_pad(_heads(qkv[bi], h, dh, p, c), lp)
                       for p in range(3))
            dout = _pad(do[bi, :, h * dh:(h + 1) * dh], lp)
            lse = np.full(lp, np.inf, np.float32)
            delta = np.zeros(lp, np.float32)
            # phase i: query tiles
            for m0 in range(0, 64 * tiles, 64):
                rows = slice(m0, min(m0 + 64, l))
                o, mx, sm = _attend(q[rows], k, v, l, lp, scale2,
                                    WIDE["DQ_WIDE"])
                dl = (o * dout[rows]).sum(axis=1, dtype=np.float32) / sm
                ls = mx + np.log2(sm)
                lse[rows], delta[rows] = ls, dl
                dq = np.zeros((len(o), dh), np.float32)
                for c0, w in _chunks(lp, WIDE["DQ_WIDE"]):
                    s = _mm(q[rows], k[c0:c0 + w].T)
                    p = np.exp2(s * scale2 - ls[:, None])
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
                    st = _mm(k[keys], q[cols].T)
                    p = np.exp2(st * scale2 - lse[cols]).astype(np.float32)
                    dpt = _mm(v[keys], dout[cols].T)
                    ds = (p * (dpt - delta[cols])).astype(np.float32)
                    dv += _mm(_bf16(p), dout[cols])
                    dk += _mm(_bf16(ds), q[cols])
                dqkv[bi, keys, c + h * dh:c + (h + 1) * dh] = dk * scale
                dqkv[bi, keys, 2 * c + h * dh:2 * c + (h + 1) * dh] = dv
    return _bf16(dqkv)


def _inputs(b, l, c, seed):
    rng = np.random.default_rng(seed)
    return (_bf16(rng.normal(size=(b, l, 3 * c))),
            _bf16(rng.normal(size=(b, l, c))))


def _gate(got, want, plain):
    err = float(np.abs(got - want).max())
    own = float(np.abs(plain - want).max())
    floor = 8e-3 * max(1.0, float(np.abs(want).max()))
    assert err <= max(2 * own, floor), (err, own, floor)
    assert err <= floor, (err, floor)
    return err


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
    qkv, do = _inputs(b, l, c, seed=b * 1000 + l + nh)
    jq, jdo = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(do, jnp.bfloat16)
    want = np.asarray(slab_attention_interpret(jq, nh), np.float32)
    dwant = np.asarray(slab_attention_backward_interpret(jq, jdo, nh),
                       np.float32)
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    tdo = torch.from_numpy(do).to(torch.bfloat16)
    plain = sa.reference_slab_attention(tq, nh).float().numpy()
    dplain = sa.reference_slab_attention_backward(tq, tdo, nh).float()
    _gate(emulate_forward(qkv, nh), want, plain)
    _gate(emulate_backward(qkv, do, nh), dwant, dplain.numpy())


def test_delta_from_o_is_rowsum_p_dp():
    """delta = rowsum(dO o O), O the pass's float32 output, stays within a
    few float32 roundings of rowsum(P o dP) with P in float32 (P V rounds
    P to bf16, which moves delta by a small share of its scale)."""
    qkv, do = _inputs(1, 147, 64, seed=3)
    q, k, v = (qkv[0, :, i * 64:(i + 1) * 64] for i in range(3))
    dh = 64
    lp = sa.bf16_plan(147, dh)["lp"]
    scale2 = np.float32(1.0 / 8.0) * LOG2E
    o, mx, sm = _attend(q, _pad(k, lp), _pad(v, lp), 147, lp, scale2, True)
    delta = (o * do[0]).sum(axis=1) / sm
    s = (q.astype(np.float64) @ k.T.astype(np.float64)) / 8.0
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    exact = (p * (do[0].astype(np.float64) @ v.T.astype(np.float64))).sum(1)
    assert np.abs(delta - exact).max() <= 4e-3 * np.abs(exact).max()


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
    (Lp = L rounded up to 32) and its shared bytes at the encoder's
    shape."""
    assert sa.BF16_WARPGROUPS == {"fwd": int(_constant("FWD_WARPGROUPS")),
                                  "bwd": int(_constant("BWD_WARPGROUPS"))}
    assert "(L + 31) / 32 * 32" in SOURCE
    plan = sa.bf16_plan(147, 64)
    stages, wgs = plan["fwd_stages"], sa.BF16_WARPGROUPS["fwd"]
    assert plan["fwd_smem"] == (1024 + stages * 3 * 160 * 128
                                + wgs * 64 * 128 + 16 * stages)
    stages, wgs = plan["bwd_stages"], sa.BF16_WARPGROUPS["bwd"]
    assert plan["bwd_smem"] == (1024 + stages * (4 * 160 * 128 + 2 * 160 * 4)
                                + wgs * 64 * 128 + 24 * stages)
