"""The fused GN+SiLU+conv3 in JAX's one-pass mode, against the JAX package
on the CPU.

JAX's fused-conv kernels (ertdx/ops/conv.py) run their tap products with
no `precision` argument, i.e. at `Precision.DEFAULT`: on their chip ONE
bf16 pass, both operands rounded to bf16 and float32 sums (the forward's
three `jnp.dot`s :79-81, the backward's three dW and three dh
`jax.lax.dot_general`s :153-171); their GroupNorm statistics run at
HIGHEST. On the CPU the interpret-mode kernels compute all of it in
float32, so here JAX's one-pass function is JAX's own interpret kernels
with the module's `jnp` and `jax` swapped, inside these tests only, for
proxies whose `dot` and `lax.dot_general` round their operands through
`.astype(bfloat16)` where no precision is given (`jax_onepass`). The
port's plain one-pass pair (`ertdx_torch/ops/conv.py::
reference_gn_silu_conv3_onepass` and its backward, the CUDA kernels'
oracle on the card) is held against it.

A one-pass result is held by its error against the exact function (JAX's
unpatched float32 kernels), not elementwise: the rms errors of the two
one-pass results within 0.8-1.25x of each other, and the max error at
most 5e-2 x max(1, max|exact|) (JAX's bf16 band, tests/test_ops.py:568-
571), as tests/test_torch_ensemble_onepass.py holds the ensemble pair. db
is a plain float32 sum of g with no product (:150): it is held
elementwise, at 1e-4 x max(1, max|JAX's|).
"""
from __future__ import annotations

import contextlib
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.models import condunet as jcu
from ertdx.ops import conv as jconv
from ertdx_torch.ops import _build
from ertdx_torch.ops import conv as cv
from torch_parity_common import make_pair, t32

BAND = 5e-2            # max error / max(1, max|exact|), JAX's bf16 band
RMS_RATIO = (0.8, 1.25)
GROUPS = 8
SHAPES = [(2, 61, 64, 72), (3, 37, 32, 16), (2, 24, 256, 256)]
GRADS = ("dx", "dgamma", "dbeta", "dW", "db")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(a):
    return a.astype(jnp.bfloat16).astype(jnp.float32)


class _Products:
    """What the proxies saw: the products they rounded (no precision) and
    the ones they passed through (HIGHEST)."""

    def __init__(self):
        self.rounded = 0
        self.highest = 0

    def take(self, precision) -> bool:
        if precision is None or precision == jax.lax.Precision.DEFAULT:
            self.rounded += 1
            return True
        self.highest += 1
        return False


class _OnePassJnp:
    """jax.numpy with `dot` rounding both operands to bf16 and back where
    no precision (or DEFAULT) is given, as the TPU's one bf16 pass does."""

    def __init__(self, seen: _Products):
        self._seen = seen

    def __getattr__(self, name):
        return getattr(jnp, name)

    def dot(self, a, b, *args, precision=None, **kwargs):
        if self._seen.take(precision):
            a, b = _bf16(a), _bf16(b)
        return jnp.dot(a, b, *args, precision=precision, **kwargs)


class _OnePassLax:
    def __init__(self, seen: _Products):
        self._seen = seen

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def dot_general(self, a, b, dims, precision=None, **kwargs):
        if self._seen.take(precision):
            a, b = _bf16(a), _bf16(b)
        return jax.lax.dot_general(a, b, dims, precision=precision, **kwargs)


class _OnePassJax:
    """jax with `lax.dot_general` as _OnePassJnp's `dot`."""

    def __init__(self, seen: _Products):
        self.lax = _OnePassLax(seen)

    def __getattr__(self, name):
        return getattr(jax, name)


@contextlib.contextmanager
def jax_onepass():
    """JAX's fused-conv kernels with their DEFAULT products in one bf16
    pass; yields what the proxies saw. JAX's caches cleared on entry and
    exit, so that no trace made on either side of the patch is reused."""
    seen = _Products()
    jax.clear_caches()
    jconv.jnp, jconv.jax = _OnePassJnp(seen), _OnePassJax(seen)
    try:
        yield seen
    finally:
        jconv.jnp, jconv.jax = jnp, jax
        jax.clear_caches()


def rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _np(a) -> np.ndarray:
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _hold(port, jax_onepass_out, exact, tag=""):
    """The one-pass rule: port's rms error against `exact` within
    0.8-1.25x of JAX's one-pass kernel's, and its max error in the band."""
    port, ref, exact = _np(port), _np(jax_onepass_out), _np(exact)
    ratio = rms(port - exact) / rms(ref - exact)
    assert RMS_RATIO[0] <= ratio <= RMS_RATIO[1], (tag, ratio)
    band = BAND * max(1.0, float(np.abs(exact).max()))
    assert float(np.abs(port - exact).max()) <= band, tag


def _close(got, want, rel=1e-4):
    got, want = _np(got), _np(want)
    tol = rel * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol


def _inputs(b, l, c, cout, seed):
    """(x, gamma, beta, w, bias) and g as numpy float32, from a seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    gamma = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.3 * rng.standard_normal(c)).astype(np.float32)
    w = (rng.standard_normal((3, c, cout)) / np.sqrt(3 * c)).astype(
        np.float32)
    bias = (0.3 * rng.standard_normal(cout)).astype(np.float32)
    g = rng.standard_normal((b, l, cout)).astype(np.float32)
    return (x, gamma, beta, w, bias), g


def _jax_pair(ins, g):
    jin = [jnp.asarray(a) for a in ins]
    y = jconv.gn_silu_conv3_interpret(*jin, GROUPS)
    grads = jconv.gn_silu_conv3_backward_interpret(*jin, jnp.asarray(g),
                                                   GROUPS)
    return np.asarray(y), [np.asarray(a) for a in grads]


# ---------------------------------------------------------------------------
# the patch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["forward", "backward"])
def test_the_patch_reaches_exactly_the_default_products(kind):
    """The proxies round the forward's 3 tap products and the backward's 6
    (3 dW, 3 dh) of each trace, and pass every HIGHEST statistics product
    (4 forward, 8 backward) through; with the patch JAX's kernel computes
    another function, within the band of the float32 one, which it
    computes bit for bit before and after."""
    ins, g = _inputs(2, 37, 32, 16, seed=5)
    jin = [jnp.asarray(a) for a in ins]

    def run():
        if kind == "forward":
            return [np.asarray(jconv.gn_silu_conv3_interpret(*jin, GROUPS))]
        return [np.asarray(a) for a in jconv.gn_silu_conv3_backward_interpret(
            *jin, jnp.asarray(g), GROUPS)]

    before = run()
    with jax_onepass() as seen:
        patched = run()
    after = run()
    per_trace = (3, 4) if kind == "forward" else (6, 8)
    traces = seen.rounded // per_trace[0]
    assert traces >= 1
    assert (seen.rounded, seen.highest) == (traces * per_trace[0],
                                            traces * per_trace[1])
    for b, p, a in zip(before, patched, after):
        assert np.array_equal(b, a)
    # db (the last gradient) is a plain sum: the patch leaves it alone
    moved = patched[:-1] if kind == "backward" else patched
    assert all(not np.array_equal(b, p) for b, p in zip(before, moved))
    if kind == "backward":
        assert np.array_equal(before[-1], patched[-1])
    for b, p in zip(before, patched):
        assert float(np.abs(p - b).max()) <= \
            BAND * max(1.0, float(np.abs(b).max()))


# ---------------------------------------------------------------------------
# the port's plain one-pass pair against JAX's patched kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_plain_onepass_forward_matches_the_patched_kernel(shape):
    ins, g = _inputs(*shape, seed=sum(shape))
    exact, _ = _jax_pair(ins, g)
    with jax_onepass():
        want = np.asarray(jconv.gn_silu_conv3_interpret(
            *[jnp.asarray(a) for a in ins], GROUPS))
    got = cv.reference_gn_silu_conv3_onepass(*[t32(a) for a in ins], GROUPS)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _hold(got, want, exact)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_onepass_backward_matches_the_patched_kernel(shape):
    ins, g = _inputs(*shape, seed=sum(shape) + 1)
    _, exact = _jax_pair(ins, g)
    with jax_onepass():
        _, want = _jax_pair(ins, g)
    got = cv.reference_gn_silu_conv3_onepass_backward(
        *[t32(a) for a in ins], t32(g), GROUPS)
    for name, a, w, e in zip(GRADS, got, want, exact):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        if name == "db":
            _close(a, w)
        else:
            _hold(a, w, e, name)


def test_the_autograd_function_runs_the_plain_pair():
    """GNSiLUConv3OnepassPlain: its output and gradients are the plain
    one-pass forward and backward bit for bit."""
    ins, g = _inputs(2, 13, 16, 24, seed=3)
    args = [t32(a) for a in ins]
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = cv.GNSiLUConv3OnepassPlain.apply(*leaves, GROUPS, 1e-5)
    out.backward(t32(g))
    assert torch.equal(out.detach(),
                       cv.reference_gn_silu_conv3_onepass(*args, GROUPS))
    for leaf, want in zip(leaves, cv.reference_gn_silu_conv3_onepass_backward(
            *args, t32(g), GROUPS)):
        assert torch.equal(leaf.grad, want)


# ---------------------------------------------------------------------------
# a small encoder with every ResBlock fused
# ---------------------------------------------------------------------------

def _jax_conv_pair():
    """gn_silu_conv3 on JAX's interpret kernels, forward and backward, as
    its custom VJP runs them on the TPU."""
    @functools.partial(jax.custom_vjp, nondiff_argnums=(5, 6, 7))
    def conv(x, gamma, beta, w, bias, num_groups, eps=1e-5, use_pallas=True):
        return jconv.gn_silu_conv3_interpret(x, gamma, beta, w, bias,
                                             num_groups, eps)

    def fwd(x, gamma, beta, w, bias, num_groups, eps, use_pallas):
        return conv(x, gamma, beta, w, bias, num_groups, eps, use_pallas), \
            (x, gamma, beta, w, bias)

    def bwd(num_groups, eps, use_pallas, res, g):
        return jconv.gn_silu_conv3_backward_interpret(*res, g, num_groups,
                                                      eps)

    conv.defvjp(fwd, bwd)
    return conv


def test_fused_encoder_onepass_matches_jax(monkeypatch):
    """CondUNet(pallas_conv=True): the port with GNSiLUConv3OnepassPlain in
    place of gn_silu_conv3 against JAX's model on its interpret kernels in
    the one-pass mode, the output and every gradient leaf of a loss by the
    one-pass rule against JAX's model on the float32 function (its path
    off the TPU, which the unpatched kernels compute too)."""
    from ertdx_torch.models import condunet as tcu
    from ertdx_torch.utils.weights import named_to_jax

    fm, params, tm = make_pair(seed=27, num_blocks=1, pallas_conv=True)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 29)).astype(np.float32)
    t = np.array([0, 123, 499], np.int32)
    cond = rng.normal(size=(3, 96, 4)).astype(np.float32)

    def loss(p):
        out = fm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(cond))
        return jnp.mean(out ** 2), out

    # jitted: eager, each run takes about 25 s
    (_, exact), gexact = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    monkeypatch.setattr(jcu, "gn_silu_conv3", _jax_conv_pair())
    with jax_onepass() as seen:
        (_, want), gwant = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params)
    assert seen.rounded >= 6 * 9           # 6 convs, 3 + 6 products each
    calls = []
    monkeypatch.setattr(tcu, "gn_silu_conv3", lambda *a: calls.append(1)
                        or cv.GNSiLUConv3OnepassPlain.apply(*a))
    out = tm(t32(x), torch.from_numpy(t).long(), t32(cond))
    torch.mean(out ** 2).backward()
    assert len(calls) == 6
    _hold(out, want, exact, "out")
    got = named_to_jax(tm, {n: p.grad for n, p in tm.named_parameters()})
    flat = jax.tree_util.tree_leaves_with_path
    for (path, a), (_, w), (_, e) in zip(flat(got), flat(gwant),
                                         flat(gexact)):
        _hold(a, w, e, jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,shape,route", [
    ("cpu", (256, 294, 256, 256), "float32"),
    ("cuda", (256, 294, 256, 256), "kernel"),
    ("cuda", (2, 37, 16, 12), "onepass_plain")])
def test_conv_route(device, shape, route):
    """A CPU tensor gets the float32 plain version; a CUDA tensor the
    kernels at a shape they take, the plain one-pass version at Cout = 12
    (JAX's kernel takes it; the wgmma kernels take multiples of 8).
    Channels the groups do not divide raise on every device."""
    assert cv.conv_route(*shape, GROUPS, device) == route
    with pytest.raises(ValueError, match="not divisible"):
        cv.conv_route(2, 37, 12, 16, GROUPS, device)


def test_the_onepass_plain_route_warns_once(monkeypatch):
    """Where the route is the plain one-pass version, gn_silu_conv3 runs
    GNSiLUConv3OnepassPlain, forward and backward, and warns once per
    shape."""
    ins, g = _inputs(2, 37, 16, 12, seed=9)
    monkeypatch.setattr(cv, "conv_route", lambda *a: "onepass_plain")
    monkeypatch.setattr(_build, "_onepass_plain_warned", set())
    args = [t32(a) for a in ins]
    leaves = [a.clone().requires_grad_(True) for a in args]
    with pytest.warns(UserWarning, match="plain one-pass"):
        out = cv.gn_silu_conv3(*leaves, GROUPS)
    out.backward(t32(g))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = cv.gn_silu_conv3(*args, GROUPS)
    assert torch.equal(out.detach(), again)
    assert torch.equal(again, cv.reference_gn_silu_conv3_onepass(*args,
                                                                  GROUPS))
    for leaf, want in zip(leaves, cv.reference_gn_silu_conv3_onepass_backward(
            *args, t32(g), GROUPS)):
        assert torch.equal(leaf.grad, want)


@pytest.mark.parametrize("shape", [(2, 37, 16, 12), (2, 24, 64, 72)])
def test_cpu_tensors_keep_the_float32_function(shape):
    """On CPU tensors gn_silu_conv3 is the float32 plain version, as JAX's
    path off its TPU, bit for bit, not the one-pass one, and launches
    nothing."""
    ins, g = _inputs(*shape, seed=11)
    args = [t32(a) for a in ins]
    cv.reset_launches()
    got = cv.gn_silu_conv3(*args, GROUPS)
    assert not any(cv.launches.values()) and \
        not any(cv.launches_bf16.values())
    assert torch.equal(got, cv.reference_gn_silu_conv3(*args, GROUPS))
    assert not torch.equal(got, cv.reference_gn_silu_conv3_onepass(*args,
                                                                   GROUPS))
