"""The fused GN+SiLU+conv3 kernels' 3xTF32 products, emulated in numpy.

The port's fused conv (ertdx_torch/csrc/gn_conv.cu) runs its three
products on the TF32 tensor cores as a_lo b_hi + a_hi b_lo + a_hi b_hi
(tests/test_torch_tf32x3.py's split), in this order:

* the forward y and the backward's dh: tiles of TM = 128 rows over the
  B L flattened rows (a tile may span batch rows; a tap that crosses a
  batch row reads zeros), each KC = 32-channel chunk's three taps summed
  from zero and added to the accumulator in float32, then the bias;
  h = silu((x - mean) * (rstd * gamma) + beta) in float32 in the GEMM's
  prologue;
* dW and db: the B L rows split into S contiguous ranges of 32-row
  chunks (S = ops/conv.py's dw_splits on a 132-SM card), each chunk's
  product per tap summed from zero and added in float32, the S partials
  added in order.

No card is needed here: numpy rounds the operands as the card does. The
emulated kernels must match the JAX package's TPU kernels in interpret
mode (gn_silu_conv3_interpret and gn_silu_conv3_backward_interpret)
within 1e-4 x max(1, max|ref|), the gate chip_smoke.py's phase 10 holds
the card's kernels to against their plain versions: y, dW and db
directly, dh through the port's plain GN backward as dx, dgamma and
dbeta. One TF32 rounding of each operand misses that gate at 256
channels, which is why the kernels pay for three MMAs a product.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.ops.conv import (gn_silu_conv3_backward_interpret,
                            gn_silu_conv3_interpret)
from ertdx_torch.ops.conv import dw_splits
from ertdx_torch.ops.groupnorm import reference_groupnorm_silu_backward
from test_torch_tf32x3 import product

G, EPS = 8, 1e-5
TM, KC, KR, SMS = 128, 32, 32, 132       # gn_conv.cu's tiles; an H100
# (B, L, C, Cout): a small case; a 128-row tile over three batch rows of
# 37; the encoder's width at a short L
SHAPES = [(2, 61, 64, 72), (3, 37, 32, 16), (2, 24, 256, 256)]


def _inputs(b, l, c, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    gamma = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.3 * rng.standard_normal(c)).astype(np.float32)
    w = (rng.standard_normal((3, c, cout)) / np.sqrt(3 * c)).astype(
        np.float32)
    bias = (0.3 * rng.standard_normal(cout)).astype(np.float32)
    g = rng.standard_normal((b, l, cout)).astype(np.float32)
    return x, gamma, beta, w, bias, g


def gn_silu(x, gamma, beta):
    """h as the kernels' prologue makes it: per-(row, channel) mean and
    rstd * gamma, then silu((x - mean) * scale + beta)."""
    b, l, c = x.shape
    xg = x.reshape(b, l, G, c // G)
    mean = xg.mean(axis=(1, 3), dtype=np.float32)
    var = ((xg - mean[:, None, :, None]) ** 2).mean(axis=(1, 3),
                                                    dtype=np.float32)
    rstd = np.float32(1.0) / np.sqrt(var + np.float32(EPS))
    mean_c = np.repeat(mean, c // G, axis=1)[:, None, :]
    scale = (np.repeat(rstd, c // G, axis=1) * gamma)[:, None, :]
    y = (x - mean_c) * scale + beta
    return y * (np.float32(1.0) / (np.float32(1.0) + np.exp(-y)))


def _taps(a, m0, rows, length):
    """The three taps' A rows of output rows m0 .. m0 + rows of the
    flattened (M, K) a: a[m-1+j], zero where m-1+j leaves m's batch row
    (or the array)."""
    m = np.arange(m0, m0 + rows)
    l = m % length
    out = []
    for j in range(3):
        src = m - 1 + j
        ok = (src >= 0) & (src < len(a)) & ~((j == 0) & (l == 0)) \
            & ~((j == 2) & (l == length - 1))
        out.append(np.where(ok[:, None], a[np.clip(src, 0, len(a) - 1)],
                            np.float32(0.0)))
    return out


def tap3_gemm(a, w_taps, length, mm, bias=None):
    """out = sum_j A_j W_j over the flattened rows of a (M, K), in the
    kernel's order: TM-row tiles, each KC-channel chunk's three taps from
    zero, the chunks added in float32."""
    m_rows, k = a.shape
    out = np.zeros((m_rows, w_taps[0].shape[1]), np.float32)
    for m0 in range(0, m_rows, TM):
        rows = min(TM, m_rows - m0)
        taps = _taps(a, m0, rows, length)
        acc = np.zeros((rows, out.shape[1]), np.float32)
        for c0 in range(0, k, KC):
            ch = slice(c0, c0 + KC)
            part = mm(taps[0][:, ch], w_taps[0][ch])
            for j in (1, 2):
                part = part + mm(taps[j][:, ch], w_taps[j][ch])
            acc += part
        out[m0:m0 + rows] = acc
    return out if bias is None else out + bias


def conv_dw(h, g, length, mm):
    """(dW (3, C, Cout), db) in the kernel's order: S contiguous ranges of
    KR-row chunks, each chunk's product per tap from zero, added in
    float32; the partials added in order."""
    m_rows, c = h.shape
    cout = g.shape[1]
    s = dw_splits(m_rows // length, c, cout, SMS)
    chunks = -(-m_rows // KR)
    per = -(-chunks // s)
    dw = np.zeros((3, c, cout), np.float32)
    db = np.zeros(cout, np.float32)
    for split in range(s):
        acc = np.zeros((3, c, cout), np.float32)
        dbp = np.zeros(cout, np.float32)
        for ch in range(split * per, min(chunks, (split + 1) * per)):
            r0 = ch * KR
            rows = min(KR, m_rows - r0)
            taps = _taps(h, r0, rows, length)
            gc = g[r0:r0 + rows]
            for j in range(3):
                acc[j] += mm(np.ascontiguousarray(taps[j].T), gc)
            dbp += gc.sum(axis=0, dtype=np.float32)
        dw += acc
        db += dbp
    return dw, db


def emulate(x, gamma, beta, w, bias, g, mm):
    """(y, dh, dW, db) with the kernels' math, products through mm."""
    b, l, c = x.shape
    cout = w.shape[2]
    h = gn_silu(x, gamma, beta).reshape(b * l, c)
    y = tap3_gemm(h, list(w), l, mm, bias).reshape(b, l, cout)
    g2 = g.reshape(b * l, cout)
    dh = tap3_gemm(g2, [np.ascontiguousarray(w[2 - j].T) for j in range(3)],
                   l, mm).reshape(b, l, c)
    dw, db = conv_dw(h, g2, l, mm)
    return y, dh, dw, db


@pytest.fixture(scope="module")
def references():
    """shape -> (inputs, JAX's y and (dx, dgamma, dbeta, dW, db))."""
    out = {}
    for shape in SHAPES:
        ins = _inputs(*shape, seed=sum(shape))
        j = [jnp.asarray(a) for a in ins]
        y = np.asarray(gn_silu_conv3_interpret(*j[:5], num_groups=G))
        grads = [np.asarray(t) for t in gn_silu_conv3_backward_interpret(
            *j, num_groups=G)]
        out[shape] = (ins, y, grads)
    return out


def _gaps(ins, y_ref, grads, mode):
    """max |emulated - JAX| and the gate for y, dx, dgamma, dbeta, dW, db."""
    x, gamma, beta, w, bias, g = ins
    y, dh, dw, db = emulate(*ins, product(mode))
    dx, dgamma, dbeta = (t.numpy() for t in reference_groupnorm_silu_backward(
        *(torch.from_numpy(a) for a in (x, gamma, beta, dh)), G))
    got = (y, dx, dgamma, dbeta, dw, db)
    refs = (y_ref, *grads)
    return [(float(np.abs(a - r).max()),
             1e-4 * max(1.0, float(np.abs(r).max()))) for a, r in
            zip(got, refs)]


@pytest.mark.parametrize("shape", SHAPES)
def test_conv_split_matches_jax(references, shape):
    ins, y_ref, grads = references[shape]
    for name, (err, tol) in zip(("y", "dx", "dgamma", "dbeta", "dW", "db"),
                                _gaps(ins, y_ref, grads, "kernel")):
        assert err <= tol, (name, err, tol)


def test_one_tf32_rounding_misses_the_conv_gate(references):
    """At 256 channels one TF32 rounding of each operand puts y, dW and dh
    (as dx) beyond phase 10's gate, where the kernels' split stays well
    inside it."""
    ins, y_ref, grads = references[SHAPES[-1]]
    one = _gaps(ins, y_ref, grads, "1xTF32")
    three = _gaps(ins, y_ref, grads, "kernel")
    for name, k in (("y", 0), ("dx", 1), ("dW", 4)):
        print(f"{name}: max |err| 1xTF32 {one[k][0]:.2e}, 3xTF32 "
              f"{three[k][0]:.2e}, gate {one[k][1]:.2e}")
        assert one[k][0] > one[k][1], name
        assert three[k][0] <= three[k][1] / 10, name


def test_a_tile_spans_batch_rows():
    """At (3, 37) one 128-row tile holds all three batch rows: the taps
    that cross them read zeros, so each batch row's output is that row's
    alone."""
    ins = _inputs(3, 37, 32, 16, seed=5)
    x, gamma, beta, w, bias, g = ins
    mm = product("kernel")
    y = emulate(*ins, mm)[0]
    h = gn_silu(x, gamma, beta)
    for i in range(3):
        alone = tap3_gemm(h[i], list(w), 37, mm, bias)
        # equal but for the order BLAS sums a product of another shape in
        assert np.abs(y[i] - alone).max() <= 1e-6 * np.abs(alone).max()
