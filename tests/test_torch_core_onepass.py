"""The fused core's one-pass mode (`accurate=False`, JAX's default).

JAX's `_dot` (ertdx/ops/core_block.py) runs each product of the fused
core as ONE bf16 MXU pass when `accurate=False`: both operands rounded to
bf16, float32 accumulation. On the CPU its interpret-mode kernels compute
in float32 at DEFAULT precision, so here JAX's one-pass function is JAX's
own kernel with `_dot` patched, inside these tests only, to round its
operands through `_hilo(.)[0]` when `accurate=False`. The port's plain
one-pass versions (ertdx_torch/ops/core_block.py) are held against it.

Rounding to bf16 turns an accumulation-order difference into a whole
bf16 ulp, so two one-pass computations cannot be held together
elementwise at float32 tolerances. They are held by their error against
the exact function (JAX's unpatched float32 kernel): the rms errors of the
two one-pass results within 0.8-1.25x of each other, the max error at most
5e-2 x max(1, max|exact|) (JAX's bf16 band, tests/test_ops.py:568-571).
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.models.mega import mega_denoise_ensemble as jax_mega
from ertdx.ops import core_block as jcb
from ertdx_torch.models import mega
from ertdx_torch.ops import core_block as cb
from torch_core_common import B, D, LK, NB, P, R, _inputs, jax_accurate
from torch_parity_common import make_pair, t32

BAND = 5e-2            # max error / max(1, max|exact|), JAX's bf16 band
RMS_RATIO = (0.8, 1.25)


@contextlib.contextmanager
def jax_onepass():
    """JAX's kernels with `_dot(..., accurate=False)` rounding its operands
    to bf16, as the TPU's one pass does; JAX's caches cleared on entry and
    exit, so that no trace made on either side of the patch is reused."""
    plain_dot = jcb._dot

    def onepass_dot(a, b, dims=None, accurate=True):
        if not accurate:
            a, b = jcb._hilo(a)[0], jcb._hilo(b)[0]
        return plain_dot(a, b, dims, accurate)

    jax.clear_caches()
    jcb._dot = onepass_dot
    try:
        yield
    finally:
        jcb._dot = plain_dot
        jax.clear_caches()


def rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def bf16_values(a: np.ndarray) -> bool:
    """Whether every value of the float32 array a is a bf16 value."""
    return not np.any(a.view(np.uint32) & 0xFFFF)


# ---------------------------------------------------------------------------
# (a) the rounding
# ---------------------------------------------------------------------------

def _bits(*words):
    return np.array(words, np.uint32).view(np.float32)


def _rounding_cases():
    rng = np.random.default_rng(0)
    upper = rng.integers(0, 0x7F7F, 64, dtype=np.uint32) << 16
    sign = rng.integers(0, 2, 64, dtype=np.uint32) << 31
    return {
        "normal": (rng.standard_normal(4096)
                   * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32),
        # low 16 bits 0x8000: halfway, to the even upper half either way
        "ties": (sign | upper | 0x8000).view(np.float32),
        "zeros_subnormals": np.concatenate([
            _bits(0, 0x80000000, 1, 0x80000001, 0x8000, 0x18000, 0x7FFFFF,
                  0x807FFFFF, 0x7F8000, 0x7FFF),
            (rng.integers(1, 0x800000, 256, dtype=np.uint32)
             | rng.integers(0, 2, 256, dtype=np.uint32) << 31
             ).view(np.float32)]),
        # the largest finite values round to inf or stay finite
        "extremes": _bits(0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F7FFF, 0x7F7F8000,
                          0x7F7F0000, 0x7F800000, 0xFF800000),
        "nan": _bits(0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFA00000,
                     0x7FFFFFFF),
    }


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros_subnormals",
                                  "extremes", "nan"])
def test_round_bf16_is_jax_astype_bit_for_bit(kind):
    a = _rounding_cases()[kind]
    want = np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    got = cb.round_bf16(torch.from_numpy(a)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # JAX's _hilo hi part is the same rounding
    hi = np.asarray(jcb._hilo(jnp.asarray(a))[0])
    assert np.array_equal(got.view(np.uint32), hi.view(np.uint32))


# ---------------------------------------------------------------------------
# (b) one product in each of _dot's forms
# ---------------------------------------------------------------------------

def exact_dot(a, b, dims):
    """_dot's product in float64."""
    a = a.T if dims == "tn" else a
    b = b.T if dims == "nt" else b
    return a.astype(np.float64) @ b.astype(np.float64)


@pytest.mark.parametrize("dims", [None, "nt", "tn"])
def test_mm_onepass_is_jax_one_pass_dot(dims):
    """The port's mm_onepass against _dot on _hilo's hi parts at
    accurate=False, within 1e-6 x max(1, max|ref|): float32 sums of the
    same exact products, in another order."""
    rng = np.random.default_rng(1)
    m, k, n = 64, 384, 96
    a = rng.standard_normal((k, m) if dims == "tn" else (m, k))
    b = rng.standard_normal((n, k) if dims == "nt" else (k, n))
    a, b = a.astype(np.float32), b.astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want = np.asarray(jcb._dot(jcb._hilo(ja)[0], jcb._hilo(jb)[0], dims,
                               accurate=False))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = cb.mm_onepass(ta.T if dims == "tn" else ta,
                        tb.T if dims == "nt" else tb).numpy()
    assert got.shape == want.shape == (m, n)
    tol = 1e-6 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol
    # and one pass is not the float32 product
    assert float(np.abs(got - exact_dot(a, b, dims)).max()) > 100 * tol


# ---------------------------------------------------------------------------
# (c) the stack and the block at full width
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full_width():
    """kind -> {"onepass": the port's plain one-pass version, "jax": JAX's
    kernel under the one-pass patch, "exact": JAX's unpatched float32
    kernel, "float32": the port's float32 plain version, "float64": that
    function in float64}, at D=128, nb=4, P=29, Lk=147, B=2, R=10."""
    a = _inputs()
    ws = a["ws"]
    w0 = {key: val[0] for key, val in ws.items()}
    mods0 = np.ascontiguousarray(a["mods"][:, :6])
    k0 = np.ascontiguousarray(a["k"].reshape(B, NB, LK, D)[:, 0])
    v0 = np.ascontiguousarray(a["v"].reshape(B, NB, LK, D)[:, 0])
    stack_in = (a["x"], a["mods"], a["k"], a["v"], ws, *a["head"])
    block_in = (a["x3"], mods0, k0, v0, w0)

    def jx(tree):
        return jax.tree_util.tree_map(jnp.asarray, tree)

    def th(tree, dtype=torch.float32):
        return [({key: torch.from_numpy(val).to(dtype)
                  for key, val in t.items()} if isinstance(t, dict)
                 else torch.from_numpy(t).to(dtype)) for t in tree]

    def jax_run():
        return {"stack": np.asarray(jcb.fused_core_stack(
                    *jx(stack_in), p=P, chunk=R, interpret=True)),
                "block": np.asarray(jcb.fused_core_block(
                    *jx(block_in), p=P, chunk=R, interpret=True))}

    exact = jax_run()
    with jax_onepass():
        onepass = jax_run()
    jax.clear_caches()
    again = jax_run()
    out = {}
    for kind, args, onepass_plain, plain in (
            ("stack", stack_in, cb.fused_core_stack_onepass_plain,
             cb.fused_core_stack_plain),
            ("block", block_in, cb.fused_core_block_onepass_plain,
             cb.fused_core_block_plain)):
        with torch.no_grad():
            out[kind] = {
                "onepass": onepass_plain(*th(args), p=P).numpy(),
                "jax": onepass[kind], "exact": exact[kind],
                "exact_again": again[kind],
                "float32": plain(*th(args), p=P).numpy(),
                "float64": plain(*th(args, torch.float64), p=P).numpy()}
    return out


@pytest.mark.parametrize("kind", ["stack", "block"])
def test_patch_reaches_jax_kernel(full_width, kind):
    """The patched kernel computes another function; after the patch the
    unpatched one comes back bit for bit (no stale trace either way)."""
    r = full_width[kind]
    assert not np.array_equal(r["jax"], r["exact"])
    assert np.array_equal(r["exact_again"], r["exact"])


@pytest.mark.parametrize("kind", ["stack", "block"])
def test_onepass_core_matches_jax_one_pass(full_width, kind):
    r = full_width[kind]
    exact = r["exact"]
    assert r["onepass"].shape == r["jax"].shape == exact.shape
    e_port, e_jax = rms(r["onepass"] - exact), rms(r["jax"] - exact)
    band = BAND * max(1.0, float(np.abs(exact).max()))
    print(f"{kind}: rms error vs JAX's float32 kernel: port {e_port:.3e}, "
          f"JAX one-pass {e_jax:.3e}; max error port "
          f"{np.abs(r['onepass'] - exact).max():.3e}, JAX "
          f"{np.abs(r['jax'] - exact).max():.3e} (band {band:.3e})")
    lo, hi = RMS_RATIO
    assert lo <= e_port / e_jax <= hi, (e_port, e_jax)
    for got in (r["onepass"], r["jax"]):
        assert float(np.abs(got - exact).max()) <= band


@pytest.mark.parametrize("kind", ["stack", "block"])
def test_onepass_error_is_bf16_class(full_width, kind):
    """The one-pass rms error against float64 is at least 100x the
    float32 function's; the float32 plain version is JAX's float32
    kernel's function (tests/test_torch_core_block.py's 2e-5)."""
    r = full_width[kind]
    f64 = r["float64"]
    e32 = rms(r["float32"] - f64)
    assert rms(r["onepass"] - f64) >= 100 * e32
    assert rms(r["jax"] - f64) >= 100 * e32
    np.testing.assert_allclose(r["float32"], r["exact"], rtol=2e-5,
                               atol=2e-5)


def test_onepass_stack_outputs_are_bf16_values(full_width):
    """JAX's one-hot relayout of eps rounds it: every output of the
    one-pass stack is a bf16 value, the float32 stack's are not."""
    r = full_width["stack"]
    assert bf16_values(r["onepass"]) and bf16_values(r["jax"])
    assert not bf16_values(r["exact"])


# ---------------------------------------------------------------------------
# (d) the plan, (e) the defaults on the CPU, and the slice as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accurate", [False, True])
def test_mega_plan_carries_the_model_mode(accurate):
    from ertdx_torch.models.condunet import CondUNet
    model = CondUNet(param_dim=29, hidden_dim=128, cond_channels=14,
                     base_width=8, depth=3, num_heads=2, num_blocks=2,
                     ensemble_mega_accurate=accurate)
    plan = mega.mega_plan(model, 1000, 8, cond_len=4693, device="cuda")
    assert plan["accurate"] is accurate


@pytest.fixture(scope="module")
def small_model():
    """A small perturbed CondUNet pair (D=32, 2 blocks), 2 conditions x 8
    chains, and JAX's context of them."""
    fm, params, tm = make_pair(d=32, num_blocks=2)
    rng = np.random.default_rng(7)
    cond = rng.normal(size=(2, 96, 4)).astype(np.float32)
    x = rng.normal(size=(2 * 8, 29)).astype(np.float32)
    t = np.full((2 * 8,), 11, np.int32)
    ctx = fm.apply({"params": params}, jnp.asarray(cond),
                   method=fm.encode_condition)
    return params, tm, x, t, ctx


def _port_mega(small_model, stack, **kw):
    _, tm, x, t, ctx = small_model
    with torch.no_grad():
        return mega.mega_denoise_ensemble(
            tm, t32(x), torch.from_numpy(t).long(),
            tuple(t32(a) for a in ctx), 8, p=29, d=32, num_blocks=2,
            chunk=8, stack=stack, **kw).numpy()


@pytest.mark.parametrize("stack", [True, False])
def test_defaults_are_the_one_pass_function_on_the_cpu(small_model, stack):
    """mega_denoise_ensemble and the wrappers default to accurate=False:
    on CPU tensors the plain one-pass version, with no launch counted."""
    cb.reset_launches()
    default = _port_mega(small_model, stack)
    onepass = _port_mega(small_model, stack, accurate=False)
    accurate = _port_mega(small_model, stack, accurate=True)
    assert np.array_equal(default, onepass)
    assert not np.array_equal(default, accurate)
    assert cb.launches == cb.onepass_launches == {
        "fused_core_stack": 0, "fused_core_block": 0}


@pytest.mark.parametrize("stack", [True, False])
def test_mega_onepass_matches_jax_one_pass(small_model, stack):
    """The slice as a whole: the port's fused-core denoiser in the
    one-pass mode against JAX's mega_denoise_ensemble(accurate=False) in
    interpret mode under the patch, by the rule of the full-width test,
    against JAX's unpatched result."""
    params, _, x, t, ctx = small_model

    def jax_run(**kw):
        return np.asarray(jax_mega(params, jnp.asarray(x), jnp.asarray(t),
                                   ctx, 8, p=29, d=32, num_blocks=2,
                                   chunk=8, stack=stack, interpret=True,
                                   **kw))

    exact = jax_run(accurate=False)   # float32 on the CPU
    with jax_onepass():
        want = jax_run(accurate=False)
    got = _port_mega(small_model, stack, accurate=False)
    e_port, e_jax = rms(got - exact), rms(want - exact)
    assert e_jax > 0
    assert RMS_RATIO[0] <= e_port / e_jax <= RMS_RATIO[1], (e_port, e_jax)
    band = BAND * max(1.0, float(np.abs(exact).max()))
    assert float(np.abs(got - exact).max()) <= band
    np.testing.assert_allclose(_port_mega(small_model, stack,
                                          accurate=True), exact,
                               rtol=2e-5, atol=2e-5)
