"""The fused core's 3xTF32 products, emulated in numpy.

The port's core kernels (ertdx_torch/csrc/core_block.cu) run every
product (the six projections, the self-attention's q k^T and P v over a
tile of 64 rows, the cross logits q K^T and P V) on the TF32 tensor cores
as a_lo b_hi + a_hi b_lo + a_hi b_hi (tests/test_torch_tf32x3.py's
split), each 32-deep k chunk of a product summed from zero and added in
float32; the softmaxes, the LayerNorms and the GELU stay in float32. No
card is needed here: numpy rounds the operands as the card does. At full
width (D=128, 4 blocks,
P=29, Lk=147, B=2, R=10) the emulated kernels must match the JAX
package's fused_core_stack and fused_core_block in interpret mode (float32
on the CPU) within 1e-4 x max(1, max|ref|), the gate chip_smoke.py's
phase 3 holds the card's kernels to against their plain versions; one
TF32 rounding of each operand misses it, which is why the kernels pay for
three MMAs a product.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest

from ertdx.ops.core_block import fused_core_block, fused_core_stack
from test_torch_tf32x3 import product

D, NB, P, LK, B, R = 128, 4, 29, 147, 2, 10
KC = 32                 # the depth of one staged chunk (core_block.cu)
ROWS = 64               # rows of a kernel's tile: ROWS // P whole chains
LN_EPS = np.float32(1e-6)
KEYS = ("wqkv", "wso", "bso", "wcq", "wco", "bco", "w1", "b1", "w2", "b2")


def chunked(a, b, mm):
    """a @ b as the kernels sum it: each KC-deep chunk's product through
    mm from zero, the partials added in float32 in k order."""
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for c in range(0, a.shape[1], KC):
        out += mm(a[:, c:c + KC], b[c:c + KC])
    return out


def _ln(x):
    mu = x.mean(axis=-1, keepdims=True, dtype=np.float32)
    dx = x - mu
    var = (dx * dx).mean(axis=-1, keepdims=True, dtype=np.float32)
    return dx * (np.float32(1.0) / np.sqrt(var + LN_EPS))


def _softmax(s):
    e = np.exp(s - s.max(axis=-1, keepdims=True))
    return e, e.sum(axis=-1, keepdims=True)


def _gelu(x):
    return np.float32(0.5) * x * (np.float32(1.0) + np.tanh(
        np.float32(0.7978845608028654)
        * (x + np.float32(0.044715) * x * x * x)))


def core_block(x, mods, kc, vc, w, p, mm):
    """One CoreBlock on one condition's (rows, D) slab, with the kernels'
    math: the products through `chunked`, q scaled after its projection,
    the self-attention over each tile of ROWS // p chains (the logits of
    the whole tile, each row's probabilities 0 outside its chain), each
    output projection's sum and bias added to the residual."""
    d = x.shape[1]
    scale = np.float32(1.0 / math.sqrt(d))
    s1, h1, s2, h2, s3, h3 = mods

    qkv = chunked(_ln(x) * (1 + s1) + h1, w["wqkv"], mm)
    q, k, v = qkv[:, :d] * scale, qkv[:, d:2 * d], qkv[:, 2 * d:]
    a = np.zeros_like(q)
    rows = ROWS // p * p
    for t0 in range(0, x.shape[0], rows):
        tile = slice(t0, t0 + rows)
        pad = ((0, ROWS - len(q[tile])), (0, 0))
        s = chunked(np.pad(q[tile], pad), np.pad(k[tile], pad).T, mm)
        probs = np.zeros_like(s)
        for c0 in range(0, len(q[tile]), p):
            chain = slice(c0, c0 + p)
            e, total = _softmax(s[chain, chain])
            probs[chain, chain] = e / total
        a[tile] = chunked(probs, np.pad(v[tile], pad), mm)[:len(q[tile])]
    x = x + (chunked(a, w["wso"], mm) + w["bso"])

    q = chunked(_ln(x) * (1 + s2) + h2, w["wcq"], mm) * scale
    e, total = _softmax(chunked(q, np.ascontiguousarray(kc.T), mm))
    o = chunked(e * (np.float32(1.0) / total), vc, mm)
    x = x + (chunked(o, w["wco"], mm) + w["bco"])

    h = _ln(x) * (1 + s3) + h3
    for c in range(4):
        cols = slice(c * d, (c + 1) * d)
        hidden = _gelu(chunked(h, w["w1"][:, cols], mm) + w["b1"][cols])
        x = x + (chunked(hidden, w["w2"][cols], mm)
                 + (w["b2"] if c == 0 else np.float32(0.0)))
    return x


def core_stack(x, mods, k, v, ws, lift_w, lift_b, pos_emb, on_scale,
               on_bias, head_w, head_b, mm):
    """(B, R, P) chains -> eps with the stack kernel's math."""
    b, r, p = x.shape
    nb = ws["wqkv"].shape[0]
    out = np.zeros_like(x)
    for i in range(b):
        cur = (x[i].reshape(r * p, 1) * lift_w + lift_b
               + np.tile(pos_emb, (r, 1)))
        for j in range(nb):
            cur = core_block(cur, mods[i, 6 * j:6 * j + 6], k[i * nb + j],
                             v[i * nb + j], {key: ws[key][j] for key in KEYS},
                             p, mm)
        tok = _ln(cur) * on_scale + on_bias
        out[i] = (tok @ head_w + head_b).reshape(r, p)
    return out


def _inputs(seed=11):
    """Full-width inputs scaled as chip_smoke.py's core_inputs."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    s = 1.0 / math.sqrt(D)
    ws = {"wqkv": rnd(NB, D, 3 * D, scale=s), "wso": rnd(NB, D, D, scale=s),
          "bso": rnd(NB, D, scale=0.1), "wcq": rnd(NB, D, D, scale=s),
          "wco": rnd(NB, D, D, scale=s), "bco": rnd(NB, D, scale=0.1),
          "w1": rnd(NB, D, 4 * D, scale=s), "b1": rnd(NB, 4 * D, scale=0.1),
          "w2": rnd(NB, 4 * D, D, scale=0.5 * s),
          "b2": rnd(NB, D, scale=0.1)}
    return {"x": rnd(B, R, P), "x3": rnd(B, R * P, D),
            "mods": rnd(B, 6 * NB, D, scale=0.3),
            "k": rnd(B * NB, LK, D), "v": rnd(B * NB, LK, D), "ws": ws,
            "head": (rnd(1, D), rnd(1, D, scale=0.1), rnd(P, D, scale=0.1),
                     1 + rnd(1, D, scale=0.1), rnd(1, D, scale=0.1),
                     rnd(D, 1, scale=s), rnd(1, 1, scale=0.1))}


@pytest.fixture(scope="module")
def cases():
    """kind -> (inputs, emulation of the kernel with a product mm, JAX's
    interpret-mode output)."""
    a = _inputs()
    ws, (lw, lb, pe, ons, onb, hw, hb) = a["ws"], a["head"]
    jws = {key: jnp.asarray(val) for key, val in ws.items()}
    stack_ref = np.asarray(fused_core_stack(
        jnp.asarray(a["x"]), jnp.asarray(a["mods"]), jnp.asarray(a["k"]),
        jnp.asarray(a["v"]), jws, *map(jnp.asarray, a["head"]), p=P,
        chunk=R, interpret=True))
    w0 = {key: val[0] for key, val in ws.items()}
    mods0 = np.ascontiguousarray(a["mods"][:, :6])
    k0 = np.ascontiguousarray(a["k"].reshape(B, NB, LK, D)[:, 0])
    v0 = np.ascontiguousarray(a["v"].reshape(B, NB, LK, D)[:, 0])
    block_ref = np.asarray(fused_core_block(
        jnp.asarray(a["x3"]), jnp.asarray(mods0), jnp.asarray(k0),
        jnp.asarray(v0), {key: jnp.asarray(val) for key, val in w0.items()},
        p=P, chunk=R, interpret=True))
    return {
        "stack": (lambda mm: core_stack(a["x"], a["mods"], a["k"], a["v"],
                                        ws, lw, lb, pe, ons, onb, hw, hb,
                                        mm), stack_ref),
        "block": (lambda mm: np.stack([
            core_block(a["x3"][i], mods0[i], k0[i], v0[i], w0, P, mm)
            for i in range(B)]), block_ref)}


def _err(cases, kind, mode):
    emulate, ref = cases[kind]
    got = emulate(product(mode))
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()), 1e-4 * max(1.0, float(
        np.abs(ref).max()))


@pytest.mark.parametrize("mode", ["kernel", "rne"])
@pytest.mark.parametrize("kind", ["stack", "block"])
def test_core_split_matches_jax(cases, kind, mode):
    err, tol = _err(cases, kind, mode)
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("kind", ["stack", "block"])
def test_one_tf32_rounding_misses_the_core_bound(cases, kind):
    """One TF32 rounding of each operand puts the core beyond phase 3's
    gate, where the kernels' split stays well inside it."""
    one, tol = _err(cases, kind, "1xTF32")
    three, _ = _err(cases, kind, "kernel")
    print(f"{kind}: max |err| 1xTF32 {one:.2e}, 3xTF32 {three:.2e}, "
          f"bound {tol:.2e}")
    assert one > tol
    assert three <= tol / 10
