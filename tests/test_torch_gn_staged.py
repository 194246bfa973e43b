"""The staged GroupNorm+SiLU kernels' plan and summation order, on the CPU.

The port's GN kernels (ertdx_torch/csrc/gn_common.cuh, groupnorm.cu) pick
their launch by shape with `launch_plan`: a staged kernel that copies one
(row, group) into shared memory, or a streamed one for groups too large
to stage. The first tests pin that choice at the model's shapes.

The rest emulate, in numpy float32, the order in which a staged block of
T threads sums (T from the plan): thread t owns channel unit t % U (U =
cg / W units of W = 4 or 1 channels a position) of the positions t / U,
t / U + T / U, ...; it keeps a float4's four lanes apart and adds them
pairwise at the end; a __shfl_xor tree over the warp follows, then each
thread adds the warps' sums in order. The statistics are two-pass (the
mean, then the mean of squared deviations); fmaf is emulated in float64
and rounded once. The per-channel sums of the backward run the warp
tree over the lanes of one channel where U divides 32, then add their
entries in order; sum_rows_kernel adds the rows over B in order. The
emulated kernels must match the JAX package's TPU kernels in interpret
mode (groupnorm_silu_interpret, groupnorm_silu_backward_interpret) at
tests/test_torch_groupnorm.py's tolerances: y and dx at 1e-5 x max(1,
max|ref|), dgamma and dbeta at 1e-4. Both passes sum x less the
group's first value, as the kernels do: on an input whose mean is far
from zero (1000 + N(0, 1)) that order stays within those gates of the
float64 value, where a one-pass E[x^2] - mean^2 in the same order misses
them.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.ops.groupnorm import (groupnorm_silu_backward_interpret,
                                 groupnorm_silu_interpret)
from ertdx_torch.ops import groupnorm as gn

G, EPS = 8, np.float32(1e-5)
F32 = np.float32
# (B, L, C): cg = 16 (float4 units, a warp tree over 4 lanes a channel),
# cg = 9 (4-byte units, 288 threads, no warp tree), cg = 3 at L = 1
SHAPES = [(2, 19, 128), (3, 20, 72), (2, 1, 24)]
LARGE_MEAN = (1, 48, 64)


def test_plan_stages_the_models_shapes():
    for l, c in ((587, 128), (294, 256), (147, 256)):
        for kind in ("fwd", "bwd", "stats"):
            plan = gn.launch_plan(l, c, G, kind)
            assert plan.path == "staged", (l, c, kind)
            assert plan.threads == 256
    # the condition's own length: 300 KB a group
    for kind in ("fwd", "bwd", "stats"):
        assert gn.launch_plan(4693, 128, G, kind) == gn.Plan(
            "streamed", gn.STREAM_THREADS, 0)


def test_plan_shared_memory_and_blocks():
    """Every staged plan fits an H100 block's shared memory and a block
    size the kernels take; the backward stages two tiles, so its budget
    runs out at half the forward's length."""
    for l in (1, 2, 37, 147, 294, 587, 1000, 1800, 3600, 4693):
        for c in (8, 16, 24, 64, 72, 128, 256, 512):
            for kind in ("fwd", "bwd", "stats"):
                plan = gn.launch_plan(l, c, G, kind)
                assert plan.smem_bytes <= gn.SMEM_MAX == 232_448
                if plan.path == "streamed":
                    continue
                cg = c // G
                units = cg // (4 if cg % 4 == 0 else 1)
                assert plan.threads % 32 == 0 and plan.threads % units == 0
                assert plan.threads <= gn.MAX_THREADS
                assert plan.smem_bytes >= 4 * gn.TILES[kind] * l * cg
                assert plan.args() == (1, plan.threads, plan.smem_bytes)
    fwd, bwd = (gn.launch_plan(2000, 128, G, k) for k in ("fwd", "bwd"))
    assert fwd.path == "staged" and bwd.path == "streamed"
    assert gn.launch_plan(2000, 128, G, "stats") == fwd
    # the stem's forward tile leaves room for 6 blocks an SM (228 KB, 1 KB
    # reserved a block), its backward's two for 3
    assert gn.launch_plan(587, 128, G, "fwd").smem_bytes <= 228 * 1024 // 6 \
        - 1024
    assert gn.launch_plan(587, 128, G, "bwd").smem_bytes <= 228 * 1024 // 3 \
        - 1024


def fma(a, b, c):
    """fmaf: the product exact in float64, one rounding to float32."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def _walk(l, cg, threads):
    """(W, U, R, steps): the units of a position, the positions a sweep,
    and the sweeps over L."""
    w = 4 if cg % 4 == 0 else 1
    u = cg // w
    r = threads // u
    return w, u, r, -(-l // r)


def _sweeps(tile, threads):
    """tile (L, cg) as each thread's units sweep by sweep: (steps, R, U,
    W), zero past L, and where it is past L (steps, R, 1, 1)."""
    l, cg = tile.shape
    w, u, r, steps = _walk(l, cg, threads)
    out = np.zeros((steps * r, u, w), F32)
    out[:l] = tile.reshape(l, u, w)
    past = (np.arange(steps * r) >= l).reshape(steps, r, 1, 1)
    return out.reshape(steps, r, u, w), past


def _block_sum(parts):
    """parts (R, U, W), one W-lane partial a thread (thread t = r U + cu):
    lanes added pairwise, the warp's xor tree, the warps' sums in order."""
    w = parts.shape[-1]
    v = parts.reshape(-1, w)
    v = (v[:, 0] + v[:, 1]) + (v[:, 2] + v[:, 3]) if w == 4 else v[:, 0]
    lane = np.arange(v.size)
    for off in (16, 8, 4, 2, 1):
        v = v + v[lane ^ off]
    total = v[0]
    for warp in range(1, v.size // 32):
        total = total + v[32 * warp]
    return F32(total)


def _channel_sums(parts, threads):
    """parts (R, U, W): the per-channel sum over the threads of each
    channel, as the staged backward takes it -> (cg,)."""
    r, u, w = parts.shape
    v = parts.reshape(threads, w)
    if 32 % u == 0:
        lane = np.arange(threads)
        off = 16
        while off >= u:
            v = v + v[lane ^ off]
            off //= 2
        entries = v.reshape(threads // 32, 32, w)[:, :u]   # (warps, U, W)
    else:
        entries = v.reshape(threads // u, u, w)
    total = entries[0]
    for j in range(1, entries.shape[0]):
        total = total + entries[j]
    return total.reshape(u * w)


def _stats(sw, past, n, one_pass=False):
    """(shift, mean, rstd) of a staged group in the kernels' order (a
    thread adds nothing past L): x - mean_g(x) is (x - shift) - mean, the
    shift the group's first value. `one_pass` takes E[x^2] - mean^2 of x
    itself in the same order instead (shift 0)."""
    shift = F32(0.0) if one_pass else sw[0, 0, 0, 0]
    acc = np.zeros(sw.shape[1:], F32)
    for step, out in zip(sw, past):
        acc = np.where(out, acc, acc + (step - shift))
    mean = F32(_block_sum(acc) / F32(n))
    q = np.zeros(sw.shape[1:], F32)
    for step, out in zip(sw, past):
        d = step if one_pass else (step - shift) - mean
        q = np.where(out, q, fma(d, d, q))
    var = F32(_block_sum(q) / F32(n))
    if one_pass:
        var = F32(var - mean * mean)
        shift, mean = mean, F32(0.0)
    return shift, mean, F32(1.0 / np.sqrt(np.float64(var + EPS)))


def _sigmoid(y):
    with np.errstate(over="ignore"):       # exp(-y) = inf: sigmoid 0
        return F32(1.0) / (F32(1.0) + np.exp(-y))


def emulate(x, gamma, beta, g, one_pass=False):
    """(y, dx, dgamma, dbeta) of the staged kernels, in their order."""
    b, l, c = x.shape
    cg = c // G
    threads = gn.launch_plan(l, c, G, "bwd").threads
    assert gn.launch_plan(l, c, G, "fwd").threads == threads
    w, u, r, steps = _walk(l, cg, threads)
    n = l * cg
    y, dx = np.empty_like(x), np.empty_like(x)
    part = np.zeros((b, 2, c), F32)
    for i in range(b):
        for grp in range(G):
            cs = slice(grp * cg, (grp + 1) * cg)
            sx, past = _sweeps(x[i, :, cs], threads)
            sg, _ = _sweeps(g[i, :, cs], threads)    # zero past L: dy = 0
            shift, mean, rstd = _stats(sx, past, n, one_pass)
            centred = (sx - shift) - mean
            ga, be = (v[cs].reshape(u, w) for v in (gamma, beta))
            # the forward: (x - mean) (rstd gamma) + beta, then SiLU
            yy = fma(centred, rstd * ga, be)
            y[i, :, cs] = (yy * _sigmoid(yy)).reshape(-1, cg)[:l]
            # the backward's first pass
            s1, s2, pg, pb = (np.zeros(sx.shape[1:], F32) for _ in range(4))
            dxh = np.empty_like(sx)
            for k in range(steps):
                xh = centred[k] * rstd
                yk = fma(xh, ga, be)
                sig = _sigmoid(yk)
                dy = sg[k] * sig * fma(yk, F32(1.0) - sig, F32(1.0))
                pg = fma(dy, xh, pg)
                pb = pb + dy
                dxh[k] = dy * ga
                s1 = s1 + dxh[k]
                s2 = fma(dxh[k], xh, s2)
            m1 = F32(_block_sum(s1) / F32(n))
            m2 = F32(_block_sum(s2) / F32(n))
            part[i, 0, cs] = _channel_sums(pg, threads)
            part[i, 1, cs] = _channel_sums(pb, threads)
            xh = centred * rstd
            out = rstd * fma(-xh, m2, dxh - m1)
            dx[i, :, cs] = out.reshape(-1, cg)[:l]
    dgb = part[0]
    for i in range(1, b):
        dgb = dgb + part[i]
    return y, dx, dgb[0], dgb[1]


def _inputs(b, l, c, seed, shift=0.5, scale=2.0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((b, l, c)) + shift).astype(F32)
    gamma = (1.0 + 0.3 * rng.standard_normal(c)).astype(F32)
    beta = (0.3 * rng.standard_normal(c)).astype(F32)
    g = rng.standard_normal((b, l, c)).astype(F32)
    return x, gamma, beta, g


def _references(x, gamma, beta, g):
    args = [jnp.asarray(a) for a in (x, gamma, beta)]
    y = groupnorm_silu_interpret(*args, num_groups=G)
    grads = groupnorm_silu_backward_interpret(*args, jnp.asarray(g),
                                              num_groups=G)
    return [np.asarray(a) for a in (y, *grads)]


def _gaps(got, want):
    """(max |err|, gate) of y, dx, dgamma, dbeta."""
    return [(float(np.abs(a - w).max()),
             rel * max(1.0, float(np.abs(w).max())))
            for a, w, rel in zip(got, want, (1e-5, 1e-5, 1e-4, 1e-4))]


@pytest.mark.parametrize("b,l,c", SHAPES)
def test_staged_order_matches_the_tpu_kernels(b, l, c):
    ins = _inputs(b, l, c, seed=b * l + c)
    for name, (err, tol) in zip(("y", "dx", "dgamma", "dbeta"),
                                _gaps(emulate(*ins), _references(*ins))):
        assert err <= tol, (name, err, tol)


def test_one_pass_variance_misses_the_gate_on_a_large_mean():
    """x = 1000 + N(0, 1). The kernels' order (two passes over x - shift)
    stays within the gates above of the float64 value (the port's plain
    version in float64), and within the card's gate (1e-4 x max(1,
    max|ref|), chip_smoke.py's phase 10) of the JAX kernel, which itself
    lies about 1e-4 from the float64 value: its float32 mean near 1000 is
    rounded by up to half an ulp (3.1e-5), and every x_hat moves by that
    times rstd. E[x^2] - mean^2 in the same order misses both gates by
    three orders of magnitude."""
    ins = _inputs(*LARGE_MEAN, seed=7, shift=1000.0, scale=1.0)
    t64 = [torch.from_numpy(a).double() for a in ins]
    exact = [gn.reference_groupnorm_silu(*t64[:3], G).numpy()] + [
        a.numpy() for a in gn.reference_groupnorm_silu_backward(
            *t64[:3], t64[3], G)]
    jax_ref = _references(*ins)
    card = [1e-4 * max(1.0, float(np.abs(w).max())) for w in jax_ref]
    two, one = emulate(*ins), emulate(*ins, one_pass=True)
    for name, (err, tol), (err1, _), (gap, _), (gap1, _), gate in zip(
            ("y", "dx", "dgamma", "dbeta"), _gaps(two, exact),
            _gaps(one, exact), _gaps(two, jax_ref), _gaps(one, jax_ref),
            card):
        print(f"{name}: vs float64 two-pass {err:.2e}, one-pass "
              f"{err1:.2e} (gate {tol:.2e}); vs JAX {gap:.2e}, "
              f"{gap1:.2e} (gate {gate:.2e})")
        assert err <= tol and gap <= gate, name
        assert err1 > 10 * tol and gap1 > 10 * gate, name


def test_warp_tree_leaves_every_lane_the_same_sum():
    """The xor tree adds the same pairs in every lane (in either order),
    so each lane holds the warp's sum bit for bit: any thread may read it
    after the barrier."""
    v = np.random.default_rng(3).standard_normal(32).astype(F32) * F32(1e3)
    lane = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[lane ^ off]
    assert np.all(v == v[0])
