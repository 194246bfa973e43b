"""The fused core's accurate mode (`accurate=True`) as JAX's bf16_3x.

JAX's `_dot(accurate=True)` (ertdx/ops/core_block.py) computes every
product of the fused core as p(ah, bh) + p(al, bh) + p(ah, bl), `_hilo`'s
split of each operand, each p one DEFAULT pass: one bf16 MXU pass on the
TPU, so the lo parts are rounded to bf16 too. On the CPU JAX's
interpret-mode kernels compute that p in float32, so here JAX's TPU
function is its own kernel under `jax_accurate()` (tests/
torch_core_common.py), which rounds the lo parts, inside these tests
only.

Two computations of bf16_3x that differ by float32 rounding stay
elementwise close (a flipped hi is made good by its lo), so the port is
held to JAX's patched kernel elementwise at 2e-5 x max(1, max|ref|), and
by its error against the exact function (the float32 plain version
computed in float64): the rms errors of the port and of JAX's bf16_3x
within 0.8-1.25x of each other, which the float32 function misses by
about 17x. JAX's unpatched kernel is not that reference: on the CPU it
sits 4-5e-6 rms from the float64 function itself (10x the port's float32
plain version), most of bf16_3x's 7e-6. The CUDA kernels
(csrc/core_onepass.cu, `core_layer3`) cannot run here; their order of
arithmetic is emulated in numpy and held to the same rules.
"""
from __future__ import annotations

import copy
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.models import mega as jmega
from ertdx.models.mega import mega_denoise_ensemble as jax_mega
from ertdx.ops import core_block as jcb
from ertdx_torch.models import mega
from ertdx_torch.ops import _build
from ertdx_torch.ops import core_block as cb
from test_torch_core_onepass import _rounding_cases, exact_dot
from torch_core_common import (B, D, LK, NB, P, R, _inputs, jax_accurate,
                               rms)
from torch_parity_common import make_pair, t32

TOL = 2e-5              # elementwise, x max(1, max|ref|)
RMS_RATIO = (0.8, 1.25)
K16 = 16                # the depth of one wgmma k step
ROWS = 64               # rows of a warpgroup: ROWS // P whole chains
LOG2E = np.float32(1.4426950408889634)
KEYS = ("wqkv", "wso", "bso", "wcq", "wco", "bco", "w1", "b1", "w2", "b2")


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _jax_lo(a):
    """JAX's `_hilo` lo part rounded to bf16, as the TPU's pass rounds it."""
    lo = jcb._hilo(jnp.asarray(a))[1]
    return np.asarray(lo.astype(jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------------------
# (a) the split and one product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["normal", "ties", "zeros_subnormals",
                                  "extremes", "nan"])
def test_split_is_jax_hilo_rounded_bit_for_bit(kind):
    """mm_3x's operands: hi bit for bit JAX's `_hilo` hi, lo bit for bit
    JAX's `_hilo` lo rounded to bf16, NaNs, infinities and ties included;
    hi + lo is what the stack's one-hot relayouts leave (round3)."""
    a = _rounding_cases()[kind]
    hi, lo = (t.numpy() for t in cb.split_hilo(torch.from_numpy(a)))
    assert np.array_equal(_bits(hi), _bits(jcb._hilo(jnp.asarray(a))[0]))
    assert np.array_equal(_bits(lo), _bits(_jax_lo(a)))
    with np.errstate(invalid="ignore"):        # inf + NaN
        assert np.array_equal(
            _bits(cb.round3(torch.from_numpy(a)).numpy()), _bits(hi + lo))


@pytest.mark.parametrize("dims", [None, "nt", "tn"])
def test_mm_3x_is_jax_bf16x3_dot(dims):
    """mm_3x against JAX's `_dot(accurate=True)` under the patch within
    1e-6 x max(1, max|ref|) (float32 sums of the same exact products in
    another order); its error against float64 is bf16_3x's, 10-1000x the
    float32 product's."""
    rng = np.random.default_rng(2)
    m, k, n = 64, 384, 96
    a = rng.standard_normal((k, m) if dims == "tn" else (m, k))
    b = rng.standard_normal((n, k) if dims == "nt" else (k, n))
    a, b = a.astype(np.float32), b.astype(np.float32)
    with jax_accurate():
        want = np.asarray(jcb._dot(jnp.asarray(a), jnp.asarray(b), dims,
                                   accurate=True))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ta, tb = ta.T if dims == "tn" else ta, tb.T if dims == "nt" else tb
    got = cb.mm_3x(ta, tb).numpy()
    assert got.shape == want.shape == (m, n)
    tol = 1e-6 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol
    exact = exact_dot(a, b, dims)
    e3, e32 = rms(got - exact), rms((ta @ tb).numpy() - exact)
    assert 10 * e32 <= e3 <= 1000 * e32, (e3, e32)


# ---------------------------------------------------------------------------
# (b) the stack and the block at full width, and the kernels' order
# ---------------------------------------------------------------------------

def _args():
    a = _inputs()
    ws = a["ws"]
    w0 = {key: val[0] for key, val in ws.items()}
    mods0 = np.ascontiguousarray(a["mods"][:, :6])
    k0 = np.ascontiguousarray(a["k"].reshape(B, NB, LK, D)[:, 0])
    v0 = np.ascontiguousarray(a["v"].reshape(B, NB, LK, D)[:, 0])
    return {"stack": (a["x"], a["mods"], a["k"], a["v"], ws, *a["head"]),
            "block": (a["x3"], mods0, k0, v0, w0)}


def _torch(tree, dtype=torch.float32):
    return [({key: torch.from_numpy(val).to(dtype) for key, val in t.items()}
             if isinstance(t, dict) else torch.from_numpy(t).to(dtype))
            for t in tree]


@pytest.fixture(scope="module")
def full_width():
    """kind -> {"port": the port's accurate=True wrapper on CPU tensors,
    "jax": JAX's kernel under the patch, "jax_f32": JAX's unpatched
    kernel, "jax_f32_again": the same after the patch, "exact": the
    float32 plain version in float64, "args": the inputs}, at D=128,
    nb=4, P=29, Lk=147, B=2, R=10."""
    args = _args()

    def jx(tree):
        return jax.tree_util.tree_map(jnp.asarray, tree)

    def jax_run():
        return {"stack": np.asarray(jcb.fused_core_stack(
                    *jx(args["stack"]), p=P, chunk=R, accurate=True,
                    interpret=True)),
                "block": np.asarray(jcb.fused_core_block(
                    *jx(args["block"]), p=P, chunk=R, accurate=True,
                    interpret=True))}

    exact = jax_run()
    with jax_accurate():
        want = jax_run()
    again = jax_run()
    with torch.no_grad():
        port = {"stack": cb.fused_core_stack(*_torch(args["stack"]), p=P,
                                             chunk=R, accurate=True),
                "block": cb.fused_core_block(*_torch(args["block"]), p=P,
                                             chunk=R, accurate=True)}
        f64 = {"stack": cb.fused_core_stack_plain(
                   *_torch(args["stack"], torch.float64), p=P),
               "block": cb.fused_core_block_plain(
                   *_torch(args["block"], torch.float64), p=P)}
    return {kind: {"port": port[kind].numpy(), "jax": want[kind],
                   "jax_f32": exact[kind], "jax_f32_again": again[kind],
                   "exact": f64[kind].numpy(), "args": args[kind]}
            for kind in ("stack", "block")}


def _hold(got, r, label):
    """The full-width rules: elementwise against JAX's bf16_3x, the rms
    error against the exact function within 0.8-1.25x of JAX's bf16_3x
    one's."""
    want, exact = r["jax"], r["exact"]
    assert got.shape == want.shape == exact.shape
    err = float(np.abs(got - want).max())
    tol = TOL * max(1.0, float(np.abs(want).max()))
    e_got, e_jax = rms(got - exact), rms(want - exact)
    print(f"{label}: max |got - JAX bf16_3x| {err:.3e} (tol {tol:.3e}); "
          f"rms error vs exact {e_got:.3e}, JAX bf16_3x {e_jax:.3e}, "
          f"ratio {e_got / e_jax:.4f}")
    assert err <= tol
    assert RMS_RATIO[0] <= e_got / e_jax <= RMS_RATIO[1], (e_got, e_jax)


@pytest.mark.parametrize("kind", ["stack", "block"])
def test_patch_reaches_jax_kernel(full_width, kind):
    """The patched kernel computes another function; after the patch the
    unpatched one comes back bit for bit (no stale trace either way)."""
    r = full_width[kind]
    assert not np.array_equal(r["jax"], r["jax_f32"])
    assert np.array_equal(r["jax_f32_again"], r["jax_f32"])


@pytest.mark.parametrize("kind", ["stack", "block"])
def test_accurate_core_is_jax_bf16x3(full_width, kind):
    """The port's accurate=True is JAX's bf16_3x: the float32 function
    it computed before (rms error about 1/17 of bf16_3x's) misses this."""
    _hold(full_width[kind]["port"], full_width[kind], kind)


@pytest.mark.parametrize("kind", ["stack", "block"])
def test_bf16x3_error_is_between_float32_and_one_pass(full_width, kind):
    """bf16_3x's error against the exact function: over 5x the float32
    plain version's, under 1/50 of the one-pass version's; JAX's own
    float32 kernel on the CPU sits between the float32 plain version and
    bf16_3x."""
    r = full_width[kind]
    a = _torch(r["args"])
    f32, one = (cb.fused_core_stack_plain, cb.fused_core_stack_onepass_plain
                ) if kind == "stack" else (cb.fused_core_block_plain,
                                           cb.fused_core_block_onepass_plain)
    with torch.no_grad():
        e32 = rms(f32(*a, p=P).numpy() - r["exact"])
        e1 = rms(one(*a, p=P).numpy() - r["exact"])
    e3 = rms(r["port"] - r["exact"])
    assert 5 * e32 < e3 < e1 / 50, (e32, e3, e1)
    assert e32 < rms(r["jax_f32"] - r["exact"]) < e3


def bf16(a):
    """a rounded to bf16 to nearest even (finite a), as float32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).view(np.float32)


def split(a):
    hi = bf16(a)
    return hi, bf16(a - hi)


def kernel_mm(a, b, acc=None, lo=True):
    """acc (+)= a @ b as the bf16_3x kernels sum it: the passes a_hi b_lo,
    a_hi b_hi, a_lo b_hi in that order into one float32 accumulator, each
    pass k step by k step (16 deep). lo=False: the hi pass alone."""
    ah, al = split(a)
    bh, bl = split(b)
    out = np.zeros((a.shape[0], b.shape[1]), np.float32) if acc is None \
        else acc
    passes = ((ah, bl), (ah, bh), (al, bh)) if lo else ((ah, bh),)
    for x, y in passes:
        for k0 in range(0, a.shape[1], K16):
            out += x[:, k0:k0 + K16] @ y[k0:k0 + K16]
    return out


def _ln(x):
    mu = x.mean(axis=-1, keepdims=True, dtype=np.float32)
    dx = x - mu
    var = (dx * dx).mean(axis=-1, keepdims=True, dtype=np.float32)
    return dx * (np.float32(1.0) / np.sqrt(var + np.float32(1e-6)))


def _softmax(s, live):
    """The kernels' softmax: base-2 exponentials of the scaled logits,
    then the sum's reciprocal times each."""
    s = np.where(live, s * LOG2E, -np.inf).astype(np.float32)
    e = np.exp2(s - s.max(axis=-1, keepdims=True))
    return e * (np.float32(1.0) / e.sum(axis=-1, keepdims=True))


def _gelu(x):
    return np.float32(0.5) * x * (np.float32(1.0) + np.tanh(
        np.float32(0.7978845608028654)
        * (x + np.float32(0.044715) * x * x * x)))


def core_layer3(x, mods, kc, vc, w, p, lo=True):
    """One CoreBlock on one condition's (rows, D) slab in the order of
    csrc/core_onepass.cu::core_layer3: the self-attention over each
    warpgroup's ROWS // p chains (64 keys, each row's probabilities 0
    outside its chain), the MLP in four 128-column chunks summed in one
    accumulator before its bias."""
    d = x.shape[1]
    scale = np.float32(1.0 / math.sqrt(d))
    s1, h1, s2, h2, s3, h3 = mods
    mm = lambda a, b, acc=None: kernel_mm(a, b, acc, lo)   # noqa: E731

    h = _ln(x) * (1 + s1) + h1
    k = mm(h, w["wqkv"][:, d:2 * d])
    q = mm(h, w["wqkv"][:, :d]) * scale
    v = mm(h, w["wqkv"][:, 2 * d:])
    a = np.zeros_like(q)
    rows = ROWS // p * p
    key = np.arange(ROWS)
    for t0 in range(0, x.shape[0], rows):
        n = min(rows, x.shape[0] - t0)
        pad = ((0, ROWS - n), (0, 0))
        qt, kt, vt = (np.pad(z[t0:t0 + n], pad) for z in (q, k, v))
        live = key[None, :] // p == key[:, None] // p
        probs = _softmax(mm(qt, np.ascontiguousarray(kt.T)), live)
        a[t0:t0 + n] = mm(probs, vt)[:n]
    x = x + (mm(a, w["wso"]) + w["bso"])

    q = mm(_ln(x) * (1 + s2) + h2, w["wcq"]) * scale
    s = mm(q, np.ascontiguousarray(kc.T))
    probs = _softmax(s, np.ones(s.shape, bool))
    x = x + (mm(mm(probs, vc), w["wco"]) + w["bco"])

    h = _ln(x) * (1 + s3) + h3
    out = np.zeros_like(x)
    for c in range(4):
        cols = slice(c * d, (c + 1) * d)
        hidden = _gelu(mm(h, w["w1"][:, cols]) + w["b1"][cols])
        out = mm(hidden, w["w2"][cols], out)
    return x + (out + w["b2"])


def round3(a):
    hi, lo = split(a)
    return hi + lo


def core_stack3(x, mods, k, v, ws, lift_w, lift_b, pos_emb, on_scale,
                on_bias, head_w, head_b, lo=True):
    """(B, R, P) chains -> eps in the order of the bf16_3x stack kernel:
    x and pos_emb as round3 leaves them, the head's dot over the three
    passes, round3 of eps plus the bias."""
    b, r, p = x.shape
    nb = ws["wqkv"].shape[0]
    out = np.zeros_like(x)
    for i in range(b):
        cur = (round3(x[i]).reshape(r * p, 1) * lift_w + lift_b
               + np.tile(round3(pos_emb), (r, 1)))
        for j in range(nb):
            cur = core_layer3(cur, mods[i, 6 * j:6 * j + 6], k[i * nb + j],
                              v[i * nb + j], {key: ws[key][j] for key in KEYS},
                              p, lo)
        tok = _ln(cur) * on_scale + on_bias
        th, tl = split(tok)
        wh, wl = split(head_w[:, 0])
        dot = ((th * wh + tl * wh + th * wl) if lo else th * wh).sum(
            axis=-1, dtype=np.float32)
        out[i] = round3(dot + head_b[0, 0]).reshape(r, p)
    return out


def _emulate(kind, args, lo=True):
    if kind == "stack":
        return core_stack3(*args, lo=lo)
    x3, mods, k, v, w = args
    return np.stack([core_layer3(x3[i], mods[i], k[i], v[i], w, P, lo)
                     for i in range(B)])


@pytest.mark.parametrize("kind", ["stack", "block"])
def test_kernel_order_matches_jax_bf16x3(full_width, kind):
    """The kernels' arithmetic, emulated (three passes a product into one
    accumulator, k step by k step; the softmaxes on base-2 exponentials),
    under the full-width rules against JAX's bf16_3x; and within the same
    elementwise bound of the port's plain version, the card's oracle."""
    r = full_width[kind]
    got = _emulate(kind, r["args"])
    _hold(got, r, f"{kind} emulated")
    tol = TOL * max(1.0, float(np.abs(r["port"]).max()))
    assert float(np.abs(got - r["port"]).max()) <= tol


@pytest.mark.parametrize("kind", ["stack", "block"])
def test_hi_pass_alone_misses_the_bound(full_width, kind):
    """Without the lo passes (one bf16 pass a product) the emulated core
    misses the elementwise bound by over 100x: the two lo passes are what
    makes bf16_3x."""
    r = full_width[kind]
    err = float(np.abs(_emulate(kind, r["args"], lo=False) - r["jax"]).max())
    assert err > 100 * TOL * max(1.0, float(np.abs(r["jax"]).max()))


# ---------------------------------------------------------------------------
# (c) the hi/lo pack and the K / V split
# ---------------------------------------------------------------------------

def _weights(nb=2, d=32, seed=4):
    rng = np.random.default_rng(seed)
    shapes = {"wqkv": (d, 3 * d), "wso": (d, d), "wcq": (d, d),
              "wco": (d, d), "w1": (d, 4 * d), "w2": (4 * d, d)}
    return {key: torch.from_numpy(
        rng.standard_normal((nb,) + shape).astype(np.float32))
        for key, shape in shapes.items()}


def _bits16(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def test_pack_3x_layout():
    """pack_core_weights_3x: (nb, 14, 2, D, D) bf16, [.., 0] the one-pass
    pack bit for bit, [.., 1] the lo parts of the same K-major tiles, so
    hi + lo reads back each (in, out) matrix as round3 leaves it."""
    ws = _weights()
    packed = cb.pack_core_weights_3x(ws)
    assert packed.dtype == torch.bfloat16
    assert tuple(packed.shape) == (2, len(cb.PACK_ORDER), 2, 32, 32)
    assert np.array_equal(_bits16(packed[:, :, 0]),
                          _bits16(cb.pack_core_weights(ws)))
    both = packed.float()
    t = {name: both[:, j, 0] + both[:, j, 1]
         for j, name in enumerate(cb.PACK_ORDER)}
    d = 32
    assert torch.equal(t["wqkv_q"].transpose(-1, -2),
                       cb.round3(ws["wqkv"][..., :d]))
    assert torch.equal(t["w2_3"].transpose(-1, -2),
                       cb.round3(ws["w2"][:, 3 * d:]))
    assert torch.equal(t["wso"].transpose(-1, -2), cb.round3(ws["wso"]))


@pytest.mark.parametrize("stacked", [True, False])
def test_pack_3x_lo_is_jax_lo_bit_for_bit(stacked):
    """Every lo value of the pack is JAX's `_hilo` lo of the weight,
    rounded to bf16 (bit for bit, checked on w1's chunk 1)."""
    ws = _weights()
    if not stacked:
        ws = {key: val[1] for key, val in ws.items()}
    packed = cb.pack_core_weights_3x(ws)
    j = cb.PACK_ORDER.index("w1_1")
    w1 = ws["w1"] if stacked else ws["w1"][None]
    want = _jax_lo(w1[..., 32:64].transpose(-1, -2).numpy())
    assert np.array_equal(_bits16(packed[:, j, 1]),
                          (_bits(want) >> 16).astype(np.uint16))


def test_kv_split_layout():
    """K and V go to the kernels as (n, 2, Lk, D) bf16, hi then lo."""
    k = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 7, 16)).astype(np.float32))
    s = cb.split_bf16(k, 1)
    assert s.dtype == torch.bfloat16 and tuple(s.shape) == (3, 2, 7, 16)
    hi, lo = cb.split_hilo(k)
    assert torch.equal(s[:, 0].float(), hi) and torch.equal(s[:, 1].float(),
                                                            lo)


@pytest.mark.parametrize("accurate", [False, True])
@pytest.mark.parametrize("kind", ["normal", "ties", "nan"])
def test_kv_operands_are_jax_operands_bit_for_bit(kind, accurate):
    """kv_operands: the one-pass mode's K is JAX's astype(bfloat16) of k,
    bf16_3x's K its hi (the same) at [:, 0] and JAX's `_hilo` lo rounded
    to bf16 at [:, 1], bit for bit, ties and NaNs included; V alike."""
    a = _rounding_cases()[kind]
    k = torch.from_numpy(a.reshape(1, -1, 1).copy())
    v = torch.from_numpy(-a.reshape(1, -1, 1).copy())
    for t, op in zip((k, v), cb.kv_operands(k, v, accurate)):
        x = t.numpy()
        hi = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
            jnp.float32))
        want = [hi, _jax_lo(x)] if accurate else [hi]
        assert tuple(op.shape) == ((1, 2) if accurate else (1,)) + \
            tuple(t.shape[1:])
        for j, w in enumerate(want):
            got = op[:, j] if accurate else op
            assert np.array_equal(_bits16(got).ravel(),
                                  (_bits(w) >> 16).astype(np.uint16).ravel())


@pytest.mark.parametrize("bad", ["dtype", "shape", "mode"])
def test_operands_refuse_a_wrong_kv(bad):
    """A wrapper's `kv` must be the mode's operands of its k and v: bf16,
    k's shape with the bf16_3x hi/lo axis; anything else raises before a
    launch."""
    ws = {key: val[0] for key, val in _weights(nb=1, d=16).items()}
    k = torch.ones(2, 5, 16)
    kv = {"dtype": (k, k), "shape": cb.kv_operands(k[:, :4], k[:, :4], True),
          "mode": cb.kv_operands(k, k, False)}[bad]
    with pytest.raises((TypeError, ValueError), match="operand"):
        cb._operands(k, k, ws, None, kv, 1, 16, True)
    kb, vb, packed = cb._operands(k, k, ws, None, None, 1, 16, True)
    assert kb.dtype == torch.bfloat16 and tuple(kb.shape) == (2, 2, 5, 16)
    assert tuple(packed.shape) == (1, len(cb.PACK_ORDER), 2, 16, 16)


@pytest.mark.parametrize("accurate", [False, True])
@pytest.mark.parametrize("stack", [True, False])
def test_cross_kv_once_a_run_is_what_a_step_makes(stack, accurate):
    """mega_cross_kv, made once a run: each block's K and V are
    cond_tokens @ wkv's halves (stacked block-major for the stack), its
    operands `kv_operands` of them, and a denoiser call given them
    returns bit for bit what one that makes its own does; operands made
    for another variant or mode are refused."""
    from ertdx_torch.models.condunet import CondUNet
    torch.manual_seed(0)
    model = CondUNet(param_dim=29, hidden_dim=32, cond_channels=4,
                     base_width=8, depth=2, num_heads=2, num_blocks=2,
                     ensemble_mega_accurate=accurate)
    w = mega.mega_weights(model)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        ctx = model.encode_condition(torch.randn(2, 96, 4, generator=gen))
        cross = mega.mega_cross_kv(w, ctx, stack=stack, accurate=accurate)
        lk = ctx[0].shape[1]
        for i, wb in enumerate(w["blocks"]):
            k, v = (ctx[0] @ wb["wkv"]).chunk(2, dim=-1)
            if stack:
                got = [z.reshape(2, 2, lk, 32)[:, i]
                       for z in (cross["k"], cross["v"])]
            else:
                got = [cross["k"][i], cross["v"][i]]
            assert torch.equal(got[0], k) and torch.equal(got[1], v)
        ops = cross["operands"] if stack else cross["operands"][1]
        want = cb.kv_operands(*((cross["k"], cross["v"]) if stack else
                                (cross["k"][1], cross["v"][1])), accurate)
        assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                   for a, b in zip(ops, want))
        x = torch.randn(2 * 8, 29, generator=gen)
        t = torch.full((2 * 8,), 17, dtype=torch.long)
        kw = dict(p=29, d=32, num_blocks=2, chunk=8, accurate=accurate,
                  stack=stack, weights=w)
        own = mega.mega_denoise_ensemble(model, x, t, ctx, 8, **kw)
        given = mega.mega_denoise_ensemble(model, x, t, ctx, 8, cross=cross,
                                           **kw)
        assert torch.equal(own, given)
        with pytest.raises(ValueError, match="cross K/V"):
            mega.mega_denoise_ensemble(
                model, x, t, ctx, 8, cross=mega.mega_cross_kv(
                    w, ctx, stack=not stack, accurate=accurate), **kw)


@pytest.mark.parametrize("accurate", [False, True])
def test_mega_weights_carry_the_mode_pack(accurate):
    from ertdx_torch.models.condunet import CondUNet
    torch.manual_seed(0)
    model = CondUNet(param_dim=29, hidden_dim=32, cond_channels=4,
                     base_width=8, depth=2, num_heads=2, num_blocks=2,
                     ensemble_mega_accurate=accurate)
    w = mega.mega_weights(model)
    assert ("packed_3x" in w) is accurate
    assert ("packed" in w) is not accurate
    if accurate:
        assert torch.equal(w["packed_3x"],
                           cb.pack_core_weights_3x(w["stack"]))


# ---------------------------------------------------------------------------
# (d) the route: JAX's gate chooses the function in this mode
# ---------------------------------------------------------------------------

def _core(p=29, d=128, nb=4):
    return types.SimpleNamespace(
        ensemble_mega=True, core_heads=1, dtype="float32",
        compute_dtype=torch.float32, param_dim=p, hidden_dim=d,
        num_blocks=nb, ensemble_mega_accurate=True, patch=8, depth=3)


# (model, R, B, cond_len, route, JAX's variant)
ROUTES = [(_core(), 1000, 8, 4693, "kernel", "stack"),          # configs[3]
          (_core(nb=24), 40000, 1, 4693, "kernel", "block"),    # JAX: block
          (_core(), 1009, 8, 4693, "float32", None),            # JAX: none
          (_core(d=64), 1000, 8, 4693, "float32", None),        # JAX: D % 128
          (_core(), 1000, 8, 9600, "onepass_plain", "stack"),    # Lk=300
          (_core(d=256), 1000, 8, 4693, "onepass_plain", "block"),
          (_core(p=40), 1000, 8, 4693, "onepass_plain", "stack")]


@pytest.mark.parametrize("case", range(len(ROUTES)))
def test_accurate_route_is_jax_gate(monkeypatch, case):
    """With accurate=True JAX's plan, as on its TPU, chooses: its stack
    kernel -> the stack, its per-block kernel -> the block, none -> the
    float32 module path; where JAX plans a kernel and the port's kernel
    does not take the shape, the plain bf16_3x version on the card,
    warned once per shape."""
    model, r, b, cond_len, route, variant = ROUTES[case]
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(_build, "_onepass_plain_warned", set())
    want = jmega.mega_plan(model, r, b, cond_len=cond_len)
    assert (want is None) is (variant is None)
    if want is not None:
        assert want["accurate"] is True
        assert want["stack"] is (variant == "stack")
    assert mega.mega_route(model, r, b, cond_len, "cuda") == route
    assert mega.mega_route(model, r, b, cond_len, "cpu") == "float32"
    if route == "onepass_plain":
        with pytest.warns(UserWarning, match="plain bf16_3x"):
            plan = mega.mega_plan(model, r, b, cond_len, "cuda")
    else:
        plan = mega.mega_plan(model, r, b, cond_len, "cuda")
    if route == "float32":
        assert plan is None
        return
    assert plan["accurate"] is True and plan["chunk"] == r
    assert plan["stack"] is (variant == "stack")
    assert plan.get("plain", False) is (route == "onepass_plain")


# ---------------------------------------------------------------------------
# (e) the slice as a whole
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_model():
    fm, params, tm = make_pair(d=32, num_blocks=2)
    rng = np.random.default_rng(9)
    cond = rng.normal(size=(2, 96, 4)).astype(np.float32)
    x = rng.normal(size=(2 * 8, 29)).astype(np.float32)
    t = np.full((2 * 8,), 13, np.int32)
    ctx = fm.apply({"params": params}, jnp.asarray(cond),
                   method=fm.encode_condition)
    return params, tm, x, t, ctx


@pytest.mark.parametrize("stack", [True, False])
def test_mega_accurate_is_jax_bf16x3(small_model, stack):
    """The port's fused-core denoiser with accurate=True (CPU tensors: the
    plain bf16_3x versions, no launch) against JAX's
    mega_denoise_ensemble(accurate=True) in interpret mode under the
    patch, by the full-width rules against JAX's unpatched result."""
    params, tm, x, t, ctx = small_model

    def jax_run():
        return np.asarray(jax_mega(params, jnp.asarray(x), jnp.asarray(t),
                                   ctx, 8, p=29, d=32, num_blocks=2,
                                   chunk=8, accurate=True, stack=stack,
                                   interpret=True))

    with jax_accurate():
        want = jax_run()
    cb.reset_launches()
    tt = torch.from_numpy(t).long()
    with torch.no_grad():
        got = mega.mega_denoise_ensemble(
            tm, t32(x), tt, tuple(t32(a) for a in ctx), 8, p=29, d=32,
            num_blocks=2, chunk=8, accurate=True, stack=stack).numpy()
        tm64 = copy.deepcopy(tm).double()
        exact = tm64.denoise_ensemble(
            t32(x).double(), tt, tuple(t32(a).double() for a in ctx),
            8).numpy()
    assert cb.launches == {"fused_core_stack": 0, "fused_core_block": 0}
    _hold(got, {"jax": want, "exact": exact}, f"mega stack={stack}")
