"""The 3xTF32 split of the attention kernels, emulated in numpy.

The port's slab and flash kernels, forward and backward
(ertdx_torch/csrc/tf32x3.cuh), run every product on the TF32 tensor
cores as a_lo b_hi + a_hi b_lo + a_hi b_hi, with a = a_hi + a_lo. No card
is needed here: numpy rounds the operands as the card does and the
products run in float32. Two splits:

* "kernel", the one the card runs: a_hi rounded to TF32 to nearest, ties
  away (cvt.rna's value), a_lo = a - a_hi truncated to TF32 (the MMA reads
  its top 19 bits);
* "rne": both halves rounded to nearest even.

Either must match JAX's interpret-mode kernels within the tolerances of
tests/test_torch_slab_attn.py and tests/test_torch_attention.py (rtol =
atol = 2e-5 forward, 2e-4 backward); one TF32 rounding of each operand
does not, which is why the kernels pay for three MMAs. The flash forward
is emulated tile by tile, as the card runs it: an online softmax over key
tiles that leaves out the tiles that are all padding. The last tests pin
the key-tile skipping: where a batch row has a valid key, a key tile that
is all padding changes neither the forward's out and lse nor dQ, and its
dK and dV rows are 0.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.ops.attention import (_flash_forward,
                                 flash_attention_backward_interpret)
from ertdx.ops.slab_attn import (slab_attention_backward_interpret,
                                 slab_attention_interpret)
from ertdx_torch.ops import attention as at

RTOL = ATOL = 2e-4        # tests/test_torch_slab_attn.py's backward bound
FWD_TOL = 2e-5            # the forward bound of both files, rtol = atol
MASK13 = np.uint32(0xFFFFE000)


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)


def tf32_nearest_away(x):
    """Round to TF32, to nearest with ties away from zero."""
    return ((_bits(x) + np.uint32(0x1000)) & MASK13).view(np.float32)


def tf32_nearest_even(x):
    """Round to TF32, to nearest with ties to even (the low 13 bits)."""
    u = _bits(x)
    return ((u + np.uint32(0xFFF) + ((u >> np.uint32(13)) & np.uint32(1)))
            & MASK13).view(np.float32)


def tf32_truncate(x):
    return (_bits(x) & MASK13).view(np.float32)


def split(x, mode):
    if mode == "kernel":
        hi = tf32_nearest_away(x)
        return hi, tf32_truncate(x - hi)
    hi = tf32_nearest_even(x)
    return hi, tf32_nearest_even(x - hi)


def product(mode):
    """a @ b as the kernels' tensor cores compute it ("kernel", "rne"),
    or with one TF32 rounding of each operand ("1xTF32")."""
    def mm(a, b):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        if mode == "1xTF32":
            return tf32_nearest_even(a) @ tf32_nearest_even(b)
        a_hi, a_lo = split(a, mode)
        b_hi, b_lo = split(b, mode)
        return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    return mm


def slab_backward(qkv, do, nh, mm):
    """dQKV (B, L, 3C) with the slab kernels' math, products through mm:
    S = q k^T scale, P = softmax(S), dP = dO v^T, dS = P o (dP -
    rowsum(P o dP)), dQ = dS k scale, dK = dS^T q scale, dV = P^T dO."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    dh = c // nh
    scale = np.float32(1.0 / math.sqrt(dh))
    out = np.zeros_like(qkv)
    for i in range(b):
        for h in range(nh):
            cols = slice(h * dh, (h + 1) * dh)
            q, k, v = (qkv[i, :, j * c:(j + 1) * c][:, cols]
                       for j in range(3))
            g = do[i][:, cols]
            s = mm(q, k.T) * scale
            p = np.exp(s - s.max(axis=1, keepdims=True))
            p /= p.sum(axis=1, keepdims=True)
            dp = mm(g, v.T)
            ds = p * (dp - (p * dp).sum(axis=1, keepdims=True))
            out[i][:, cols] = mm(ds, k) * scale
            out[i][:, c:2 * c][:, cols] = mm(ds.T, q) * scale
            out[i][:, 2 * c:][:, cols] = mm(p.T, g)
    return out


def flash_backward(q, k, v, mask, out, lse, do, mm):
    """(dq, dk, dv) with the flash backward kernels' math from a saved
    (out, lse), products through mm."""
    scale = np.float32(1.0 / math.sqrt(q.shape[-1]))
    bias = np.where(mask > 0, 0.0, -1e30).astype(np.float32)
    dq, dk, dv = (np.zeros_like(a) for a in (q, k, v))
    for i in range(q.shape[0]):
        for h in range(q.shape[1]):
            s = mm(q[i, h], k[i, h].T) * scale + bias[i][None, :]
            p = np.exp(s - lse[i, h][:, None])
            delta = (do[i, h] * out[i, h]).sum(axis=1, keepdims=True)
            ds = p * (mm(do[i, h], v[i, h].T) - delta)
            dq[i, h] = mm(ds, k[i, h]) * scale
            dk[i, h] = mm(ds.T, q[i, h]) * scale
            dv[i, h] = mm(p.T, do[i, h])
    return dq, dk, dv


def _slab_inputs(b, l, c):
    rng = np.random.default_rng(b * 1000 + l + c)
    return (rng.normal(size=(b, l, 3 * c)).astype(np.float32),
            rng.normal(size=(b, l, c)).astype(np.float32))


def _excess(got, want, tol=RTOL):
    """max |got - want| / (tol + tol |want|): at most 1 within bound."""
    return float(np.max(np.abs(got - want) / (tol + tol * np.abs(want))))


SLAB_SHAPES = [(2, 147, 256, 4), (2, 40, 64, 1)]


@pytest.mark.parametrize("mode", ["kernel", "rne"])
@pytest.mark.parametrize("b,l,c,nh", SLAB_SHAPES)
def test_slab_backward_split_matches_jax(b, l, c, nh, mode):
    qkv, do = _slab_inputs(b, l, c)
    want = np.asarray(slab_attention_backward_interpret(
        jnp.asarray(qkv), jnp.asarray(do), nh))
    got = slab_backward(qkv, do, nh, product(mode))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,l,c,nh", SLAB_SHAPES)
def test_one_tf32_rounding_misses_the_bound(b, l, c, nh):
    """The reason for three MMAs: one TF32 rounding of each operand puts
    the slab backward beyond the bound at these shapes and seeds, where
    the split stays inside it."""
    qkv, do = _slab_inputs(b, l, c)
    want = np.asarray(slab_attention_backward_interpret(
        jnp.asarray(qkv), jnp.asarray(do), nh))
    one = slab_backward(qkv, do, nh, product("1xTF32"))
    three = slab_backward(qkv, do, nh, product("kernel"))
    print(f"slab backward {b, l, c, nh}: max |err| 1xTF32 "
          f"{np.abs(one - want).max():.2e}, 3xTF32 "
          f"{np.abs(three - want).max():.2e}; excess over the bound "
          f"{_excess(one, want):.2f} and {_excess(three, want):.2f}")
    assert _excess(one, want) > 1.0
    assert _excess(three, want) <= 1.0


def _flash_inputs(b, h, l, d, valid, dead, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, h, l, d)).astype(np.float32)
                   for _ in range(4))
    mask = np.zeros((b, l), np.float32)
    mask[:, :valid] = 1.0
    for row in dead:
        mask[row] = 0.0
    return q, k, v, do, mask


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("mode", ["kernel", "rne"])
def test_flash_backward_split_matches_jax(mode):
    """The flash arm's shape at small B: 147 of 256 keys valid, Dh=64."""
    q, k, v, do, mask = _flash_inputs(2, 2, 256, 64, 147, (), seed=9)
    want = flash_attention_backward_interpret(*map(jnp.asarray,
                                                   (q, k, v, mask, do)))
    out, lse = at.reference_flash_forward(_t(q), _t(k), _t(v), _t(mask))
    got = flash_backward(q, k, v, mask, out.numpy(), lse.numpy(), do,
                         product(mode))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


SKIPPED = slice(192, 256)      # the key tile of 64 that is all padding


@pytest.fixture(scope="module")
def padded_with_dead_row():
    """(2, 2, 256, 64), 147 valid keys, batch row 1 with every key
    masked: JAX's interpret kernels and the port's plain backward."""
    q, k, v, do, mask = _flash_inputs(2, 2, 256, 64, 147, (1,), seed=11)
    jax_grads = [np.asarray(g) for g in flash_attention_backward_interpret(
        *map(jnp.asarray, (q, k, v, mask, do)))]
    out, lse = at.reference_flash_forward(_t(q), _t(k), _t(v), _t(mask))
    port = [g.numpy() for g in at.reference_flash_backward(
        _t(q), _t(k), _t(v), _t(mask), out, lse, _t(do))]
    return (q, k, v, do, mask, out, lse), {"jax": jax_grads, "port": port}


@pytest.mark.parametrize("who", ["jax", "port"])
def test_all_padding_key_tile_has_zero_dk_dv(padded_with_dead_row, who):
    _, grads = padded_with_dead_row
    _, dk, dv = grads[who]
    for g in (dk, dv):
        assert (g[0, :, SKIPPED] == 0).all()        # live row: exactly 0
        assert np.abs(g[1, :, SKIPPED]).max() > 0   # dead row: p = 1


def test_dq_without_the_padding_tile_is_the_same(padded_with_dead_row):
    (q, k, v, do, mask, out, lse), grads = padded_with_dead_row
    keep = slice(0, SKIPPED.start)
    dq, _ = at.reference_flash_backward_dq(
        _t(q), _t(k[:, :, keep]).contiguous(), _t(v[:, :, keep]).contiguous(),
        _t(mask[:, keep]).contiguous(), out, lse, _t(do))
    full = grads["port"][0]
    assert np.abs(dq.numpy()[0] - full[0]).max() <= 1e-6
    # the dead row needs every tile: its dQ moves without them
    assert np.abs(dq.numpy()[1] - full[1]).max() > 1e-3


# ---------------------------------------------------------------------------
# The forwards


def chunked(p, v, mm, acc=None):
    """acc + P V as the forward kernels sum it (tf32x3::nn_add): one
    product per k step of 8 keys through mm, each added to acc (zero by
    default) in float32 in key order."""
    out = (np.zeros((p.shape[0], v.shape[1]), np.float32) if acc is None
           else acc.copy())
    for c in range(0, p.shape[1], 8):
        out += mm(p[:, c:c + 8], v[c:c + 8])
    return out


def slab_forward(qkv, nh, mm):
    """(B, L, C) with the slab forward kernel's math, products through mm:
    S = (q scale) k^T, E = exp(S - rowmax), O = (E v) / rowsum(E), E v
    summed per k step."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    dh = c // nh
    scale = np.float32(1.0 / math.sqrt(dh))
    out = np.zeros((b, l, c), np.float32)
    for i in range(b):
        for h in range(nh):
            cols = slice(h * dh, (h + 1) * dh)
            q, k, v = (qkv[i, :, j * c:(j + 1) * c][:, cols]
                       for j in range(3))
            s = mm(q * scale, k.T)
            e = np.exp(s - s.max(axis=1, keepdims=True))
            out[i][:, cols] = chunked(e, v, mm) * (
                np.float32(1.0) / e.sum(axis=1, keepdims=True))
    return out


def flash_forward(q, k, v, mask, mm, tile, skip="live"):
    """(out, lse) with the flash forward kernel's math, products through
    mm: s = (q scale) k^T + bias over key tiles of `tile` keys, the online
    softmax from m = -1e30 (P V summed per k step), out = acc / max(l,
    1e-30), lse = m + log(max(l, 1e-30)). Key tiles whose mask entries are all <= 0 are left out in
    batch rows that have a valid key (skip="live", the kernel's rule), in
    none, or in every batch row ("all")."""
    scale = np.float32(1.0 / math.sqrt(q.shape[-1]))
    bias = np.where(mask > 0, 0.0, -1e30).astype(np.float32)
    b, h, lq, d = q.shape
    out = np.zeros_like(q)
    lse = np.zeros((b, h, lq), np.float32)
    for i in range(b):
        valid = (mask[i] > 0).reshape(-1, tile).any(axis=1)
        keep = {"live": valid if valid.any() else ~valid,
                "none": np.ones_like(valid), "all": valid}[skip]
        for j in range(h):
            qs = q[i, j] * scale
            m = np.full((lq, 1), -1e30, np.float32)
            l = np.zeros((lq, 1), np.float32)
            acc = np.zeros((lq, d), np.float32)
            for t in np.flatnonzero(keep):
                keys = slice(t * tile, (t + 1) * tile)
                s = mm(qs, k[i, j, keys].T) + bias[i, keys][None, :]
                m_new = np.maximum(m, s.max(axis=1, keepdims=True))
                alpha = np.exp(m - m_new)
                p = np.exp(s - m_new)
                l = l * alpha + p.sum(axis=1, keepdims=True)
                acc = chunked(p, v[i, j, keys], mm, acc * alpha)
                m = m_new
            l = np.maximum(l, np.float32(1e-30))
            out[i, j] = acc / l
            lse[i, j] = (m + np.log(l))[:, 0]
    return out, lse


# (B, L, C, heads): the encoder's deepest stage at small B, dh = 64 and 32
FWD_SLAB_SHAPES = [(2, 147, 256, 4), (2, 147, 256, 8)]


@pytest.mark.parametrize("mode", ["kernel", "rne"])
@pytest.mark.parametrize("b,l,c,nh", FWD_SLAB_SHAPES)
def test_slab_forward_split_matches_jax(b, l, c, nh, mode):
    qkv, _ = _slab_inputs(b, l, c)
    want = np.asarray(slab_attention_interpret(jnp.asarray(qkv), nh))
    got = slab_forward(qkv, nh, product(mode))
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


# (B, H, L, Dh, valid keys, dead batch rows, the forward's key tile): the
# flash arm's shape at small B beside a row with every key masked, and
# Dh = 256 with its 16-key tile
FWD_FLASH_CASES = [(2, 2, 256, 64, 147, (1,), 32),
                   (2, 1, 256, 256, 147, (0,), 16)]


def _jax_flash_forward(q, k, v, mask):
    out, lse = _flash_forward(*map(jnp.asarray, (q, k, v, mask)),
                              interpret=True)
    return np.asarray(out), np.asarray(lse).reshape(q.shape[:3])


@pytest.mark.parametrize("mode", ["kernel", "rne"])
@pytest.mark.parametrize("b,h,l,d,valid,dead,tile", FWD_FLASH_CASES)
def test_flash_forward_split_matches_jax(b, h, l, d, valid, dead, tile,
                                         mode):
    q, k, v, _, mask = _flash_inputs(b, h, l, d, valid, dead, seed=d + l)
    want, want_lse = _jax_flash_forward(q, k, v, mask)
    out, lse = flash_forward(q, k, v, mask, product(mode), tile)
    np.testing.assert_allclose(out, want, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse, want_lse, rtol=FWD_TOL, atol=FWD_TOL)
    assert (lse[list(dead)] == -1e30).all()


@pytest.mark.parametrize("b,h,l,d,valid,dead,tile", FWD_FLASH_CASES)
def test_forward_without_the_padding_tiles_is_the_same(b, h, l, d, valid,
                                                       dead, tile):
    """Leaving out the all-padding key tiles changes no live row's out or
    lse, bit for bit; the dead row needs every tile."""
    q, k, v, _, mask = _flash_inputs(b, h, l, d, valid, dead, seed=d + l)
    mm = product("kernel")
    got = flash_forward(q, k, v, mask, mm, tile, skip="live")
    full = flash_forward(q, k, v, mask, mm, tile, skip="none")
    every = flash_forward(q, k, v, mask, mm, tile, skip="all")
    live = [i for i in range(b) if i not in dead]
    skipped = (mask[live] > 0).reshape(len(live), -1, tile).any(axis=2)
    assert 0 < (~skipped).mean() < 1       # some tiles are all padding
    for a, w in zip(got, full):
        assert np.array_equal(a, w)        # the dead row keeps them all
    for a, w in zip(every, full):
        assert np.array_equal(a[live], w[live])
    assert np.abs(every[0][list(dead)] - full[0][list(dead)]).max() > 1e-3


def test_forward_skips_three_of_eight_tiles_on_the_flash_arm():
    """147 of 256 keys valid: 3 of the 8 key tiles of 32 are all padding
    (the share chip_smoke.py logs on the card)."""
    mask = np.zeros(256, np.float32)
    mask[:147] = 1.0
    assert (~(mask > 0).reshape(8, 32).any(axis=1)).sum() == 3


def _forward_errors(kind):
    """(excess over the forward bound with one TF32 rounding, with the
    kernel's split, max |err| of each), against JAX's interpret kernel."""
    if kind == "slab":
        qkv, _ = _slab_inputs(*FWD_SLAB_SHAPES[0][:3])
        nh = FWD_SLAB_SHAPES[0][3]
        want = [np.asarray(slab_attention_interpret(jnp.asarray(qkv), nh))]
        one = [slab_forward(qkv, nh, product("1xTF32"))]
        three = [slab_forward(qkv, nh, product("kernel"))]
    else:
        b, h, l, d, valid, dead, tile = FWD_FLASH_CASES[0]
        q, k, v, _, mask = _flash_inputs(b, h, l, d, valid, dead, d + l)
        want = _jax_flash_forward(q, k, v, mask)
        one = flash_forward(q, k, v, mask, product("1xTF32"), tile)
        three = flash_forward(q, k, v, mask, product("kernel"), tile)
    return [(max(_excess(a, w, FWD_TOL) for a, w in zip(run, want)),
             max(float(np.abs(a - w).max()) for a, w in zip(run, want)))
            for run in (one, three)]


@pytest.mark.parametrize("kind", ["slab", "flash"])
def test_one_tf32_rounding_misses_the_forward_bound(kind):
    """One TF32 rounding of each operand puts the forwards beyond their
    bound at the encoder's shapes, where the split stays inside it."""
    (one, one_err), (three, three_err) = _forward_errors(kind)
    print(f"{kind} forward: max |err| 1xTF32 {one_err:.2e}, 3xTF32 "
          f"{three_err:.2e}; excess over the bound {one:.2f} and "
          f"{three:.2f}")
    assert one > 1.0
    assert three <= 1.0
