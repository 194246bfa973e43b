"""The ensemble attention kernels' 3xTF32 products, emulated in numpy.

The port's block_self_kernel and folded_cross_kernel
(ertdx_torch/csrc/ensemble_attn.cu) run both products on the TF32 tensor
cores as a_lo b_hi + a_hi b_lo + a_hi b_hi (tests/test_torch_tf32x3.py's
split), in one device function, attend_tile: 16 query rows against a
resident key set padded with zero keys (a chain's P to 32; a condition's
Lk to a bucket of 8-key tiles). It computes the logits S = q k^T over the
whole head width on the MMA, masks the padding keys, and takes the row's
key tiles in one pass up to 19 tiles, above that in chunks of 8 under an
online softmax over the raw logits, with exp2(s scale log2e - m scale
log2e). P V accumulates on the MMA, each pass's product added to the
running O (rescaled by the online softmax); the row is scaled by 1 /
rowsum at the end. No card is needed here: numpy rounds the operands as
the card does.

The emulated kernels must match the JAX package's
block_self_attention_interpret and folded_cross_attention_interpret
(float32 on the CPU, Precision.HIGHEST) within 1e-4 x max(1, max|ref|),
the gate chip_smoke.py's phase 8 holds the card's kernels to against
their plain version; one TF32 rounding of each operand misses it, which
is why the kernels pay for three MMAs.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest

from ertdx.ops.ensemble_attn import (block_self_attention_interpret,
                                     folded_cross_attention_interpret)
from ertdx_torch.ops import ensemble_attn as ea
from test_torch_tf32x3 import product

LOG2E = np.float32(1.4426950408889634)
# key tiles of 8 -> the tiles a softmax pass takes (launch_cross_nt)
CHUNK = {8: 8, 16: 16, 19: 19, 24: 8, 32: 8}


def key_tiles(lk):
    """The bucket of 8-key tiles the kernel pads Lk to."""
    return next(n for n in ea.CROSS_KEY_TILES if 8 * n >= lk)


def attend(q, k, v, mm, nt, kc):
    """attend_tile's math for the rows q (Lq, D) against keys k and values
    v (Lk, D), padded with zeros to 8 nt keys, taken kc tiles a pass;
    products through mm."""
    lq, d = q.shape
    lk = k.shape[0]
    sl2 = np.float32(LOG2E / np.float32(math.sqrt(d)))
    pad = ((0, 8 * nt - lk), (0, 0))
    kp, vp = np.pad(k, pad), np.pad(v, pad)
    s = mm(q, kp.T)
    s[:, lk:] = -np.inf
    m = np.full((lq, 1), -np.inf, np.float32)
    total = np.zeros((lq, 1), np.float32)
    acc = np.zeros((lq, d), np.float32)
    for c in range(0, nt, kc):
        keys = slice(8 * c, 8 * min(c + kc, nt))
        m_new = np.maximum(m, s[:, keys].max(axis=1, keepdims=True))
        if c > 0:
            alpha = np.exp2((m - m_new) * sl2)
            total *= alpha
            acc *= alpha
        m = m_new
        e = np.exp2(s[:, keys] * sl2 - m * sl2).astype(np.float32)
        total += e.sum(axis=1, keepdims=True, dtype=np.float32)
        acc += mm(e, vp[keys])
    return acc * (np.float32(1.0) / total)


def folded_cross(q, k, v, mm):
    """(B, Lq, D) with folded_cross_kernel's math, products through mm."""
    nt = key_tiles(k.shape[1])
    return np.stack([attend(q[i], k[i], v[i], mm, nt, CHUNK[nt])
                     for i in range(q.shape[0])])


def block_self(q, k, v, mm):
    """(N, P, D) with block_self_kernel's math: each chain's keys padded to
    32 (4 tiles, one pass), products through mm."""
    return np.stack([attend(q[i], k[i], v[i], mm, 4, 4)
                     for i in range(q.shape[0])])


def _inputs(b, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, lq, d)).astype(np.float32),
            rng.standard_normal((b, lk, d)).astype(np.float32),
            rng.standard_normal((b, lk, d)).astype(np.float32))


def _excess(got, want):
    """max |got - want| over the gate 1e-4 x max(1, max|want|)."""
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) / tol


# (B, Lq, Lk, D): the per-block path's shape at 16 members (Lq = 29 R),
# chip_smoke.py's odd shape (3, 13, 61, 64) with 8 x 13 queries (the JAX
# kernel takes Lq in multiples of 8), and the gate's edges, which take the
# keys in three (24 tiles at D = 128) and four (32 at D = 64) chunks
CASES = [(2, 29 * 16, 147, 128), (3, 8 * 13, 61, 64), (1, 29 * 8, 173, 128),
         (1, 8 * 13, 256, 64)]


@pytest.fixture(scope="module")
def references():
    """case -> (q, k, v, JAX's interpret-mode output)."""
    out = {}
    for case in CASES:
        q, k, v = _inputs(*case, seed=sum(case))
        want = np.asarray(folded_cross_attention_interpret(
            *map(jnp.asarray, (q, k, v))))
        out[case] = (q, k, v, want)
    return out


@pytest.mark.parametrize("mode", ["kernel", "rne"])
@pytest.mark.parametrize("case", CASES)
def test_cross_split_matches_jax(references, case, mode):
    q, k, v, want = references[case]
    got = folded_cross(q, k, v, product(mode))
    print(f"cross {case} {mode}: max |err| "
          f"{np.abs(got - want).max():.2e}, excess {_excess(got, want):.3f}")
    assert _excess(got, want) <= 1.0


@pytest.mark.parametrize("case", CASES[:2])
def test_one_tf32_rounding_misses_the_cross_gate(references, case):
    """The reason for three MMAs: with one TF32 rounding of each operand
    the emulated kernel misses phase 8's gate at these shapes and seeds,
    where the split stays under a tenth of it."""
    q, k, v, want = references[case]
    one = folded_cross(q, k, v, product("1xTF32"))
    three = folded_cross(q, k, v, product("kernel"))
    print(f"cross {case}: max |err| 1xTF32 {np.abs(one - want).max():.2e}, "
          f"3xTF32 {np.abs(three - want).max():.2e}; excess "
          f"{_excess(one, want):.2f} and {_excess(three, want):.3f}")
    assert _excess(one, want) > 1.0
    assert _excess(three, want) <= 0.1


def test_key_buckets_cover_the_gate():
    """Every Lk the gate takes has a bucket of 8-key tiles that holds it
    and a chunk the emulation (and launch_cross_nt) knows: the whole row
    up to 19 tiles, else chunks of 8; Lk = 173 at D = 128 and 256 at
    D = 64 are taken."""
    for d in ea.KERNEL_DIMS:
        for lk in range(1, ea.KERNEL_LK_MAX + 1):
            if not ea.folded_cross_ok(1, 1, lk, d):
                continue
            nt = key_tiles(lk)
            assert 8 * nt >= lk
            assert CHUNK[nt] == (nt if nt <= 19 else 8)
    assert ea.folded_cross_ok(1, 1, 173, 128)
    assert ea.folded_cross_ok(1, 1, 256, 64)


# (N, P, D): the per-block path's chains, and P = 32 (no padding key) at
# D = 64
SELF_CASES = [(16, 29, 128), (8, 32, 64)]


@pytest.fixture(scope="module")
def self_references():
    out = {}
    for case in SELF_CASES:
        q, k, v = (np.random.default_rng(sum(case) + i).standard_normal(
            case).astype(np.float32) for i in range(3))
        want = np.asarray(block_self_attention_interpret(
            *map(jnp.asarray, (q, k, v))))
        out[case] = (q, k, v, want)
    return out


@pytest.mark.parametrize("mode", ["kernel", "rne"])
@pytest.mark.parametrize("case", SELF_CASES)
def test_self_split_matches_jax(self_references, case, mode):
    q, k, v, want = self_references[case]
    got = block_self(q, k, v, product(mode))
    print(f"self {case} {mode}: max |err| {np.abs(got - want).max():.2e}, "
          f"excess {_excess(got, want):.3f}")
    assert _excess(got, want) <= 1.0


def test_one_tf32_rounding_misses_the_self_gate(self_references):
    q, k, v, want = self_references[SELF_CASES[0]]
    one = block_self(q, k, v, product("1xTF32"))
    three = block_self(q, k, v, product("kernel"))
    print(f"self {SELF_CASES[0]}: max |err| 1xTF32 "
          f"{np.abs(one - want).max():.2e}, 3xTF32 "
          f"{np.abs(three - want).max():.2e}; excess "
          f"{_excess(one, want):.2f} and {_excess(three, want):.3f}")
    assert _excess(one, want) > 1.0
    assert _excess(three, want) <= 0.1
