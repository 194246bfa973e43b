"""The ensemble attention pair in JAX's one-pass mode, against the JAX
package on the CPU.

JAX's ensemble kernels (ertdx/ops/ensemble_attn.py) run their products at
`Precision.DEFAULT`, which on their chip is ONE bf16 pass: both operands
rounded to bf16, float32 accumulation. On the CPU their interpret-mode
kernels compute in float32, so here JAX's one-pass function is JAX's own
kernel with the module's `jnp` swapped, inside these tests only, for a
proxy whose `dot` rounds its operands through `.astype(bfloat16)` at
DEFAULT precision (`jax_onepass`). The port's plain one-pass version
(`ertdx_torch/ops/ensemble_attn.py::reference_attention_onepass`, the
CUDA kernels' oracle on the card) is held against it.

A one-pass result is held by its error against the exact function (JAX's
unpatched float32 kernel), not elementwise: the rms errors of the two
one-pass results within 0.8-1.25x of each other, and the max error at
most 5e-2 x max(1, max|exact|) (JAX's bf16 band, tests/test_ops.py:568-
571), as tests/test_torch_core_onepass.py holds the fused core.
"""
from __future__ import annotations

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.models import condunet as jcu
from ertdx.ops import ensemble_attn as jea
from ertdx_torch.models import condunet as tcu
from ertdx_torch.ops import ensemble_attn as ea
from torch_parity_common import make_pair, t32

BAND = 5e-2            # max error / max(1, max|exact|), JAX's bf16 band
RMS_RATIO = (0.8, 1.25)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _OnePassJnp:
    """jax.numpy with `dot` at Precision.DEFAULT rounding both operands to
    bf16 and back, as the TPU's one bf16 pass does."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def dot(a, b, *args, precision=None, **kwargs):
        if precision == jax.lax.Precision.DEFAULT:
            a = a.astype(jnp.bfloat16).astype(jnp.float32)
            b = b.astype(jnp.bfloat16).astype(jnp.float32)
        return jnp.dot(a, b, *args, precision=precision, **kwargs)


@contextlib.contextmanager
def jax_onepass():
    """JAX's ensemble kernels with their DEFAULT products in one bf16 pass;
    JAX's caches cleared on entry and exit, so that no trace made on
    either side of the patch is reused."""
    jax.clear_caches()
    jea.jnp = _OnePassJnp()
    try:
        yield
    finally:
        jea.jnp = jnp
        jax.clear_caches()


def rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def bf16_values(a: np.ndarray) -> bool:
    """Whether every value of the float32 array a is a bf16 value."""
    return not np.any(np.ascontiguousarray(a).view(np.uint32) & 0xFFFF)


def _inputs(seed, dtype, *shapes):
    """Arrays of `shapes` from a seed as (jax arrays, torch tensors) in
    `dtype`; bf16 inputs are bf16 values in both."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    out = []
    for shape in shapes:
        a = np.array(jnp.asarray(rng.standard_normal(shape), jdt)
                     .astype(jnp.float32))
        out.append((jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)))
    return [j for j, _ in out], [t for _, t in out]


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32)) if not torch.is_tensor(x) \
        else x.float().numpy()


def _hold(port, jax_onepass_out, exact):
    """The one-pass rule: port's rms error against `exact` within
    0.8-1.25x of JAX's one-pass kernel's, and its max error in the band."""
    port, ref, exact = _f32(port), _f32(jax_onepass_out), _f32(exact)
    ratio = rms(port - exact) / rms(ref - exact)
    assert RMS_RATIO[0] <= ratio <= RMS_RATIO[1], ratio
    band = BAND * max(1.0, float(np.abs(exact).max()))
    assert float(np.abs(port - exact).max()) <= band


SELF_SHAPES = [(16, 29, 32), (8, 29, 128), (24, 5, 64),
               (8, 32, 64)]                       # P = 32, the gate's edge
CROSS_SHAPES = [(2, 8 * 29, 24, 32), (1, 16 * 29, 147, 128),
                (3, 40, 130, 64), (1, 8 * 29, 147, 128),
                (2, 40, 256, 64)]                 # Lk = 256 at D = 64


def _run(kind, jq, jk, jv):
    fn = (jea.block_self_attention_interpret if kind == "self"
          else jea.folded_cross_attention_interpret)
    return fn(jq, jk, jv)


def _shapes(kind, shape):
    if kind == "self":
        return (shape,) * 3
    b, lq, lk, d = shape
    return (b, lq, d), (b, lk, d), (b, lk, d)


# ---------------------------------------------------------------------------
# the patch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["self", "cross"])
def test_the_patch_reaches_the_interpret_kernels(kind):
    """With the patch JAX's kernel computes another function (the one
    pass); without it, before and after, the float32 one, bit for bit."""
    shape = SELF_SHAPES[1] if kind == "self" else CROSS_SHAPES[1]
    (jq, jk, jv), _ = _inputs(3, "f32", *_shapes(kind, shape))
    before = np.asarray(_run(kind, jq, jk, jv))
    with jax_onepass():
        patched = np.asarray(_run(kind, jq, jk, jv))
    after = np.asarray(_run(kind, jq, jk, jv))
    assert np.array_equal(before, after)
    assert not np.array_equal(before, patched)
    # the one pass moves the result by bf16 roundings, not more
    assert float(np.abs(patched - before).max()) <= \
        BAND * max(1.0, float(np.abs(before).max()))


# ---------------------------------------------------------------------------
# the port's plain one-pass version against JAX's patched kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind,shape",
                         [("self", s) for s in SELF_SHAPES]
                         + [("cross", s) for s in CROSS_SHAPES])
def test_plain_onepass_matches_the_patched_kernel(kind, shape, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(sum(shape), dtype,
                                      *_shapes(kind, shape))
    exact = _run(kind, *(a.astype(jnp.float32) for a in (jq, jk, jv)))
    with jax_onepass():
        want = _run(kind, jq, jk, jv)
    got = ea.reference_attention_onepass(q, k, v)
    assert got.dtype == q.dtype and want.dtype == jq.dtype
    _hold(got, want, exact)


# ---------------------------------------------------------------------------
# the operands of the products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
def test_the_products_take_bf16_operands(d, dtype):
    """The plain version's scaled q, k, v and normalised P are bf16 values;
    the scaled q is round_bf16(q * D**-0.5) (in float32) bit for bit, k
    and v JAX's astype(bfloat16) of k and v; P's rows sum to 1 within
    their roundings."""
    (jq, jk, jv), (q, k, v) = _inputs(d, dtype, *[(6, 29, d)] * 3)
    qs, kr, vr = ea.onepass_operands(q, k, v)
    p = ea.onepass_probs(qs, kr)
    for t in (qs, kr, vr, p):
        assert t.dtype == torch.float32 and bf16_values(t.numpy())
    scaled = _f32(jq) * np.float32(d ** -0.5)
    want = np.asarray(jnp.asarray(scaled).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    assert np.array_equal(qs.numpy().view(np.uint32), want.view(np.uint32))
    if d == 128:      # 2**-3.5 is no power of two: rounding q first differs
        assert not np.array_equal(
            qs.numpy(), _f32(jnp.asarray(_f32(jq)).astype(jnp.bfloat16))
            * np.float32(d ** -0.5))
    for got, a in ((kr, jk), (vr, jv)):
        ref = np.asarray(a.astype(jnp.bfloat16).astype(jnp.float32))
        assert np.array_equal(got.numpy().view(np.uint32),
                              ref.view(np.uint32))
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, atol=29 * 2.0 ** -8)


# ---------------------------------------------------------------------------
# the CondUNet's ensemble branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_blocks,b,r", [(2, 4, 8), (1, 2, 16)])
def test_condunet_onepass_branch_matches_jax(monkeypatch, num_blocks, b, r):
    """CondUNet(ensemble_pallas=True, ensemble_min_chains=1) with the
    plain one-pass versions patched into the port's branch, against the
    JAX model on its interpret kernels in the one-pass mode, through the
    whole denoise_ensemble (fold reshapes, strided q/k/v), by the rms rule
    against the JAX model on its unpatched kernels."""
    fm, params, tm = make_pair(num_blocks=num_blocks, seed=51, scale=0.1,
                               ensemble_pallas=True, ensemble_min_chains=1)
    monkeypatch.setattr(jcu, "block_self_attention",
                        jea.block_self_attention_interpret)
    monkeypatch.setattr(jcu, "folded_cross_attention",
                        jea.folded_cross_attention_interpret)
    monkeypatch.setattr(jcu, "block_self_attention_ok", lambda *a: True)
    monkeypatch.setattr(jcu, "folded_cross_attention_ok", lambda *a: True)
    rng = np.random.default_rng(5 + r)
    p = 29
    cond = rng.normal(size=(b, 96, 4)).astype(np.float32)
    x = rng.normal(size=(b * r, p)).astype(np.float32)
    t = rng.integers(0, 10, size=(b * r,)).astype(np.int32)
    v = {"params": params}

    def jax_call():
        ctx = fm.apply(v, jnp.asarray(cond), method=fm.encode_condition)
        return fm.apply(v, jnp.asarray(x), jnp.asarray(t), ctx, r,
                        method=fm.denoise_ensemble)

    exact = jax_call()
    with jax_onepass():
        want = jax_call()
    calls = []
    for name in ("block_self_attention", "folded_cross_attention"):
        monkeypatch.setattr(tcu, name, lambda *a, **_: calls.append(1)
                            or ea.reference_attention_onepass(*a))
    with torch.no_grad():
        tctx = tm.encode_condition(t32(cond))
        got = tm.denoise_ensemble(t32(x), torch.from_numpy(t).long(), tctx,
                                  r)
    assert len(calls) == 2 * num_blocks
    _hold(got, want, exact)


# ---------------------------------------------------------------------------
# the wrappers on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_cpu_wrappers_keep_the_float32_function(kind, dtype):
    """On CPU tensors the wrappers return the float32 plain version, as
    JAX's off-TPU forwards do, bit for bit, and launch nothing."""
    shape = SELF_SHAPES[0] if kind == "self" else CROSS_SHAPES[0]
    _, (q, k, v) = _inputs(7, dtype, *_shapes(kind, shape))
    fn = ea.block_self_attention if kind == "self" else \
        ea.folded_cross_attention
    ea.reset_launches()
    got = fn(q, k, v)
    assert ea.launches == {"block_self_attention": 0,
                           "folded_cross_attention": 0}
    assert torch.equal(got, ea.reference_attention(q, k, v))
    assert not torch.equal(got, ea.reference_attention_onepass(q, k, v))
    assert math.isfinite(float(got.float().abs().max()))
