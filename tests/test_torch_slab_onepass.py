"""The slab attention pair in JAX's one-pass mode, against the JAX package
on the CPU.

JAX's slab kernels (ertdx/ops/slab_attn.py) run their products through
`_dot`, at `Precision.DEFAULT` unless `accurate`: on their chip one bf16
pass, both operands rounded to bf16 and the products summed in float32.
Their interpret-mode kernels compute in float32 on the CPU, so JAX's
one-pass function is JAX's own kernel with the module's `_dot` swapped,
inside these tests only, for one that rounds both operands through
`.astype(bfloat16)` at DEFAULT (`jax_onepass`). The port's plain one-pass
version (`ertdx_torch/ops/slab_attn.py::reference_slab_attention_onepass`,
its backward and `SlabOnepassPlain`, the CUDA kernels' oracle on the
card) is held against it by two rules:

* the rms rule against the exact function (JAX's unpatched kernel on the
  float32 values): the port's rms error within 0.8-1.25x of JAX's
  patched kernel's, and its max error at most 5e-2 x max(1, max|exact|),
  JAX's bf16 band (tests/test_ops.py:568-571), as
  tests/test_torch_core_onepass.py holds the fused core;
* the same-function rule: the rms of the two one-pass results'
  difference under a quarter of JAX's patched rms error against the
  exact one. Two one-pass computations of one function differ only by
  the bf16 ulps that their sum orders flip; another rounding point moves
  a result by the size of the one-pass error itself.
"""
from __future__ import annotations

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx import diffusion as jdiff
from ertdx.models import condunet as jcu
from ertdx.ops import slab_attn as jsa
from ertdx_torch import diffusion, train
from ertdx_torch.models import condunet as tcu
from ertdx_torch.ops import slab_attn as sa
from ertdx_torch.utils.weights import named_to_jax
from torch_parity_common import make_pair, t32

BAND = 5e-2            # max error / max(1, max|exact|), JAX's bf16 band
RMS_RATIO = (0.8, 1.25)
SAME = 0.25            # the same-function rule's share of the error
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# (B, L, C, heads): dh = 64 with L past one 32-row pad, and dh = 32
SHAPES = [(2, 61, 128, 2), (2, 40, 128, 4)]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_DOT = jsa._dot


def _onepass_dot(a, b, dims=None, acc=False):
    """JAX's `_dot` as its chip computes it at DEFAULT: both operands
    rounded to bf16, float32 sums (HIGHEST, `acc`, unchanged)."""
    if not acc:
        a = a.astype(jnp.bfloat16).astype(jnp.float32)
        b = b.astype(jnp.bfloat16).astype(jnp.float32)
    return _DOT(a, b, dims, acc)


@contextlib.contextmanager
def jax_onepass():
    """JAX's slab kernels with their DEFAULT products in one bf16 pass;
    JAX's caches cleared on entry and exit, so that no trace made on
    either side of the patch is reused."""
    jax.clear_caches()
    jsa._dot = _onepass_dot
    try:
        yield
    finally:
        jsa._dot = _DOT
        jax.clear_caches()


def rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _hold(port, jax_onepass_out, exact, tag=""):
    """The rms rule and the same-function rule (module docstring)."""
    port, ref, exact = _f32(port), _f32(jax_onepass_out), _f32(exact)
    err_ref = rms(ref - exact)
    ratio = rms(port - exact) / err_ref
    assert RMS_RATIO[0] <= ratio <= RMS_RATIO[1], (tag, ratio)
    band = BAND * max(1.0, float(np.abs(exact).max()))
    assert float(np.abs(port - exact).max()) <= band, tag
    assert rms(port - ref) < SAME * err_ref, (tag, rms(port - ref), err_ref)


def _inputs(shape, dtype, seed):
    """A slab and dO from a seed, as (jax arrays, torch tensors) in
    `dtype`; bf16 inputs hold the same bf16 values on both sides."""
    b, l, c, _ = shape
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    out = []
    for s in ((b, l, 3 * c), (b, l, c)):
        a = np.array(jnp.asarray(rng.standard_normal(s), jdt)
                     .astype(jnp.float32))
        out.append((jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)))
    return [j for j, _ in out], [t for _, t in out]


def _jax_pair(jq, jdo, nh):
    return (jsa.slab_attention_interpret(jq, nh),
            jsa.slab_attention_backward_interpret(jq, jdo, nh))


# ---------------------------------------------------------------------------
# the patch
# ---------------------------------------------------------------------------

def test_the_patch_reaches_the_interpret_kernels():
    """With the patch both of JAX's kernels compute another function (one
    bf16 pass); without it, before and after, the float32 one, bit for
    bit."""
    (jq, jdo), _ = _inputs(SHAPES[0], "f32", 3)
    before = [np.asarray(a) for a in _jax_pair(jq, jdo, SHAPES[0][3])]
    with jax_onepass():
        patched = [np.asarray(a) for a in _jax_pair(jq, jdo, SHAPES[0][3])]
    after = [np.asarray(a) for a in _jax_pair(jq, jdo, SHAPES[0][3])]
    for b, p, a in zip(before, patched, after):
        assert np.array_equal(b, a)
        assert not np.array_equal(b, p)
        assert float(np.abs(p - b).max()) <= BAND * max(
            1.0, float(np.abs(b).max()))


# ---------------------------------------------------------------------------
# the plain one-pass version against JAX's patched kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_onepass_matches_the_patched_kernels(shape, dtype):
    nh = shape[3]
    (jq, jdo), (qkv, do) = _inputs(shape, dtype, sum(shape))
    exact, dexact = _jax_pair(jq.astype(jnp.float32),
                              jdo.astype(jnp.float32), nh)
    with jax_onepass():
        want, dwant = _jax_pair(jq, jdo, nh)
    got = sa.reference_slab_attention_onepass(qkv, nh)
    dgot = sa.reference_slab_attention_onepass_backward(qkv, do, nh)
    assert got.dtype == dgot.dtype == qkv.dtype
    assert want.dtype == dwant.dtype == jq.dtype
    _hold(got, want, exact, "forward")
    _hold(dgot, dwant, dexact, "backward")
    # under autograd the Function gives the same pair
    z = qkv.clone().requires_grad_(True)
    out = sa.SlabOnepassPlain.apply(z, nh)
    out.backward(do)
    assert torch.equal(out.detach(), got) and torch.equal(z.grad, dgot)


@pytest.mark.parametrize("dh", [32, 64])
def test_the_products_take_jax_rounding_points(dh):
    """The plain version's S operand is round_bf16(q x float32(dh**-0.5))
    (in float32; at dh = 32 the scale is no power of two, so rounding q
    first differs) and its P is normalised before its rounding: its rows
    sum to 1 in float32."""
    _, (qkv, _) = _inputs((1, 24, 2 * dh, 2), "f32", dh)
    q, k, v, scale = sa._onepass_heads(qkv, 2)
    assert scale.dtype == torch.float32
    assert float(scale) == float(np.float32(1.0 / math.sqrt(dh)))
    p = sa._onepass_probs(q, k, scale)
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, atol=1e-6)
    want = np.asarray(jnp.asarray(q.numpy() * np.float32(scale))
                      .astype(jnp.bfloat16).astype(jnp.float32))
    got = sa.round_bf16(q * scale).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    first = sa.round_bf16(q).numpy() * np.float32(scale)
    assert np.array_equal(first, got) == (dh == 64)


# ---------------------------------------------------------------------------
# the CondUNet's slab branch
# ---------------------------------------------------------------------------

def _jax_slab_onepass(nh):
    """JAX's model-level slab_attention on the interpret kernels, under
    `jax_onepass` the patched ones."""
    @jax.custom_vjp
    def f(qkv):
        return jsa.slab_attention_interpret(qkv, nh)

    def fwd(qkv):
        return f(qkv), qkv

    def bwd(qkv, g):
        return (jsa.slab_attention_backward_interpret(qkv, g, nh),)

    f.defvjp(fwd, bwd)
    return lambda qkv, num_heads, use_pallas=True, accurate=False: f(qkv)


def test_condunet_slab_branch_matches_jax(monkeypatch):
    """A small CondUNet with attn_slab=True: the encoder's output and one
    train step's loss and gradients with the plain one-pass Function
    patched into the port's slab branch, against the JAX model on its
    interpret kernels in the one-pass mode, by both rules per leaf
    against the same model on its unpatched kernels."""
    fm, params, tm = make_pair(num_blocks=1, seed=26, scale=0.1,
                               attn_slab=True)
    nh = tm.encoder.attn.num_heads
    monkeypatch.setattr(jcu, "slab_attention", _jax_slab_onepass(nh))
    calls = []
    monkeypatch.setattr(tcu, "slab_attention", lambda qkv, n: calls.append(
        1) or sa.SlabOnepassPlain.apply(qkv, n))
    rng = np.random.default_rng(8)
    b, t_max = 4, 50
    x0 = rng.normal(size=(b, 29)).astype(np.float32)
    cond = rng.uniform(size=(b, 96, 4)).astype(np.float32)
    t = np.array([0, 7, 23, 49], np.int32)
    noise = rng.normal(size=(b, 29)).astype(np.float32)
    jsch = jdiff.get_diffusion_schedule(t_max)

    def jloss(p):
        xn = jdiff.q_sample(x0, t, noise, jsch.alpha_bar)
        out = fm.apply({"params": p}, xn, t, cond)
        return jnp.mean((out - noise) ** 2)

    def jax_run():
        # jitted: an eager pass through the interpret kernels takes about
        # twice as long; each call traces anew (the caches are cleared)
        return jax.jit(lambda p: (fm.apply(
            {"params": p}, jnp.asarray(cond),
            method=fm.encode_condition)[0],
            jax.value_and_grad(jloss)(p)))(params)

    exact = jax_run()
    with jax_onepass():
        want = jax_run()
    with torch.no_grad():
        tokens = tm.encode_condition(t32(cond))[0]
    opt = train.create_optimizer(tm, 1e-4)
    loss = train.train_step(
        tm, opt, t32(x0), t32(cond), torch.from_numpy(t).long(),
        t32(noise), alpha_bar=diffusion.get_diffusion_schedule(
            t_max).alpha_bar, lr=1e-4)
    assert len(calls) == 2          # the encoder call and the train step's
    _hold(tokens, want[0], exact[0], "tokens")
    assert abs(float(loss) - float(want[1][0])) <= SAME * max(
        1e-6, abs(float(want[1][0]) - float(exact[1][0])))
    got = named_to_jax(tm, {n: p.grad for n, p in tm.named_parameters()})
    held = 0
    for path, w in jax.tree_util.tree_leaves_with_path(want[1][1]):
        g, e = got, exact[1][1]
        for k in path:
            g, e = g[k.key], e[k.key]
        if rms(np.asarray(w) - np.asarray(e)) == 0.0:
            # a leaf the one pass does not reach: equal on both sides
            assert rms(g - np.asarray(e)) <= 1e-6 * max(
                1.0, float(np.abs(np.asarray(e)).max())), path
            continue
        _hold(torch.from_numpy(np.asarray(g)), w, e, str(path))
        held += 1
    assert held > 0


# ---------------------------------------------------------------------------
# the dispatcher on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cpu_tensors_keep_the_float32_plain_version(dtype):
    """On CPU tensors slab_attention is the plain version, forward and
    backward, bit for bit, as JAX's off the TPU, and launches nothing."""
    _, (qkv, do) = _inputs(SHAPES[0], dtype, 11)
    nh = SHAPES[0][3]
    sa.reset_launches()
    z = qkv.clone().requires_grad_(True)
    got = sa.slab_attention(z, nh)
    got.backward(do)
    assert torch.equal(got.detach(), sa.reference_slab_attention(qkv, nh))
    assert torch.equal(z.grad,
                       sa.reference_slab_attention_backward(qkv, do, nh))
    assert not torch.equal(got.detach(),
                           sa.reference_slab_attention_onepass(qkv, nh))
    assert all(n == 0 for counts in (sa.launches, sa.launches_onepass,
                                     sa.launches_bf16)
               for n in counts.values())
