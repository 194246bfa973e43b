"""bf16 GroupNorm+SiLU and the fused GN+SiLU+conv3 against the JAX package,
on the CPU.

On a bf16 input the JAX kernels (ertdx/ops/groupnorm.py, ertdx/ops/conv.py)
load bf16, compute in float32 and write the output (y, dx) in bf16;
dgamma, dbeta, dW and db are float32 partials. The port's plain versions
follow JAX's plain versions' dtype rules (for the fused conv: h in x's
dtype, the weight cast to h's dtype and the bias to the product's); its
bf16 kernels (csrc/gn_common.cuh, csrc/gn_conv.cu) run the TPU's
arithmetic, one bf16 pass a product: h and W rounded to bf16 once,
float32 sums, the bias added in float32, y rounded once. Here, on numpy
inputs from a seed:

* the plain GN, forward and backward, against JAX's reference and its
  interpret-mode kernels on bf16 x;
* the plain fused conv on bf16, forward and backward, against JAX's
  reference and its interpret-mode kernels;
* a numpy emulation of the bf16 kernels' arithmetic against JAX's
  interpret-mode kernels;
* a bf16 CondUNet with the fused-encoder knobs, and one with the flash
  knob, against flax's bf16 CondUNet.

Gates are in bf16 ulps of the compared tensor's largest value (`ulp`,
tests/test_torch_bf16.py): a bf16 output computed in float32 and rounded
once is within half an ulp of the float32 value, so two such outputs that
differ only in float32 rounding order are within one ulp; each gate says
what else lies between the two sides. float32 outputs (dgamma, dbeta, dW,
db) are held at relative gates: they are sums of float32 products of the
same bf16 values.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.models.condunet import CondUNet as FlaxCondUNet
from ertdx.ops.conv import (gn_silu_conv3_backward_interpret,
                            gn_silu_conv3_interpret)
from ertdx.ops.conv import reference_gn_silu_conv3 as jax_conv
from ertdx.ops.groupnorm import (groupnorm_silu_backward_interpret,
                                 groupnorm_silu_interpret)
from ertdx.ops.groupnorm import reference_groupnorm_silu as jax_gn
from ertdx_torch import configs, diffusion, train
from ertdx_torch.models import build_model
from ertdx_torch.models.condunet import CondUNet, FusedGNConv, GNSiLU
from ertdx_torch.ops import conv as cv
from ertdx_torch.ops import groupnorm as gn
from ertdx_torch.utils.weights import (flax_shapes, named_to_jax,
                                       params_from_jax)
from test_torch_bf16 import (BF16, KW, T, _dtypes, _flax_module_path,
                             _inputs, assert_within_ulps, f32, tbf, ulp)

G = 8
BF = jnp.bfloat16


def _rel(got, want, rtol, what):
    """max |got - want| <= rtol x max(1, max |want|)."""
    err = float(np.abs(f32(got) - f32(want)).max())
    bound = rtol * max(1.0, float(np.abs(f32(want)).max()))
    assert err <= bound, (what, err, bound)


def _gn_inputs(seed, b, l, c):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(b, l, c)) * 2 + 0.5, BF)
    gamma = (1 + 0.3 * rng.normal(size=c)).astype(np.float32)
    beta = (0.3 * rng.normal(size=c)).astype(np.float32)
    g = jnp.asarray(rng.normal(size=(b, l, c)), BF)
    return x, gamma, beta, g


# ---------------------------------------------------------------------------
# 1. the plain GN on bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,l,c", [(2, 37, 128), (3, 20, 72)])
def test_plain_groupnorm_bf16_matches_jax(b, l, c):
    x, gamma, beta, g = _gn_inputs(b + l, b, l, c)
    ref, vjp = jax.vjp(lambda x_, ga, be: jax_gn(x_, ga, be, G), x,
                       jnp.asarray(gamma), jnp.asarray(beta))
    dref = vjp(g)
    kern = groupnorm_silu_interpret(x, jnp.asarray(gamma), jnp.asarray(beta),
                                    G)
    dkern = groupnorm_silu_backward_interpret(
        x, jnp.asarray(gamma), jnp.asarray(beta), g, G)
    leaves = [tbf(x).requires_grad_(True),
              torch.from_numpy(gamma).requires_grad_(True),
              torch.from_numpy(beta).requires_grad_(True)]
    out = gn.groupnorm_silu(*leaves, G)
    out.backward(tbf(g))
    dgot = [t.grad for t in leaves]
    assert out.dtype == dgot[0].dtype == BF16
    assert dgot[1].dtype == dgot[2].dtype == torch.float32
    assert ref.dtype == kern.dtype == dkern[0].dtype == BF
    assert dkern[1].dtype == dkern[2].dtype == jnp.float32
    # float32 statistics and one rounding on every side: one ulp apart
    # at most where the float32 values straddle a rounding boundary
    # (measured 0 against both)
    for want in (ref, kern):
        assert_within_ulps(out, want, 1, "y")
    for want in (dref, dkern):
        # dx: one rounding of a float32 value each (measured 0.06 ulp)
        assert_within_ulps(dgot[0], want[0], 1, "dx")
        # float32 sums of the same bf16 values in other orders (measured
        # 3.8e-7 relative)
        _rel(dgot[1], want[1], 1e-5, "dgamma")
        _rel(dgot[2], want[2], 1e-5, "dbeta")


def test_bf16_launch_plan_stages_half_the_bytes():
    """A bf16 group is half the float32 group's bytes: the model's shapes
    stage with 16-byte units of 8 values (cg % 8 == 0), the condition's
    length (2, 4693, 128), streamed in float32, stages its forward (150
    KB) and streams its backward (two tiles); the fused conv's GN backward
    stages a bf16 x beside a float32 dh."""
    for l, c in ((587, 128), (294, 256), (147, 256)):
        for kind in ("fwd", "bwd", "stats"):
            p16 = gn.launch_plan(l, c, G, kind, 2)
            p32 = gn.launch_plan(l, c, G, kind)
            assert p16.path == "staged" and p16.threads == 256
            assert p16.smem_bytes < p32.smem_bytes
    assert gn.launch_plan(4693, 128, G, "fwd").path == "streamed"
    assert gn.launch_plan(4693, 128, G, "fwd", 2) == gn.Plan(
        "staged", 256, 16 * 4693 * 2 + 4 * 2 * 8)
    assert gn.launch_plan(4693, 128, G, "bwd", 2).path == "streamed"
    mixed = gn.launch_plan(294, 256, G, "bwd", 2, 4)
    assert mixed.smem_bytes == gn.launch_plan(294, 256, G, "bwd", 2) \
        .smem_bytes + 2 * 294 * 32
    # one-value units where the group's channels do not divide by 8, and
    # bf16 tiles rounded up to 16 bytes
    assert gn.unit_width(9, 2) == 1 and gn.unit_width(16, 2) == 8
    assert gn.tile_bytes(61 * 9, 2) == 1104 and gn.tile_bytes(5, 4) == 20


# ---------------------------------------------------------------------------
# 2. the plain fused conv on bf16 (the repair)
# ---------------------------------------------------------------------------

def _conv_inputs(seed, b, l, c, cout):
    rng = np.random.default_rng(seed)
    x, gamma, beta, _ = _gn_inputs(seed, b, l, c)
    w = (rng.normal(size=(3, c, cout)) / np.sqrt(3 * c)).astype(np.float32)
    bias = (0.3 * rng.normal(size=cout)).astype(np.float32)
    g = jnp.asarray(rng.normal(size=(b, l, cout)), BF)
    return x, gamma, beta, w, bias, g


def _torch_conv(x, gamma, beta, w, bias, g):
    leaves = [tbf(x).requires_grad_(True)] + [
        torch.from_numpy(a).requires_grad_(True)
        for a in (gamma, beta, w, bias)]
    out = cv.gn_silu_conv3(*leaves, G)
    out.backward(tbf(g))
    return out, [t.grad for t in leaves]


def test_plain_fused_conv_runs_on_bf16():
    """A bf16 x with float32 parameters (a bf16 model's fused ResBlock):
    the weight is cast to h's dtype and the bias to the product's, as in
    JAX (one conv1d of a bf16 input with a float32 bias raises in
    torch); the output is bf16, the parameters' gradients float32."""
    x, gamma, beta, w, bias, g = _conv_inputs(1, 2, 9, 16, 8)
    out, grads = _torch_conv(x, gamma, beta, w, bias, g)
    assert out.dtype == grads[0].dtype == BF16
    assert all(t.dtype == torch.float32 for t in grads[1:])
    assert torch.isfinite(out.float()).all()
    # the float32 function is the float32 plain version, bit for bit
    x32 = torch.from_numpy(f32(x))
    args = [torch.from_numpy(a) for a in (gamma, beta, w, bias)]
    h = gn.reference_groupnorm_silu(x32, args[0], args[1], G)
    want = torch.nn.functional.conv1d(
        torch.nn.functional.pad(h.transpose(1, 2), (1, 1)),
        args[2].permute(2, 1, 0).contiguous(), args[3]).transpose(1, 2)
    assert torch.equal(cv.reference_gn_silu_conv3(x32, *args, G), want)


@pytest.mark.parametrize("b,l,c,cout", [(2, 37, 32, 48), (3, 20, 72, 16)])
def test_plain_fused_conv_bf16_matches_jax(b, l, c, cout):
    x, gamma, beta, w, bias, g = _conv_inputs(b * l + c, b, l, c, cout)
    jargs = (jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(w),
             jnp.asarray(bias))
    ref, vjp = jax.vjp(lambda x_, *a: jax_conv(x_, *a, G), x, *jargs)
    dref = vjp(g)
    kern = gn_silu_conv3_interpret(x, *jargs, G)
    dkern = gn_silu_conv3_backward_interpret(x, *jargs, g, G)
    out, grads = _torch_conv(x, gamma, beta, w, bias, g)
    assert ref.dtype == kern.dtype == dkern[0].dtype == BF
    # the same casts and roundings as JAX's reference (h, the product and
    # the bias add in bf16): within one ulp of it (measured 0)
    assert_within_ulps(out, ref, 1, "y vs reference")
    # the interpret kernel rounds once from float32, the reference three
    # times (h, the product, the bias add): they are themselves one ulp
    # apart at (2, 37, 32 -> 48), 0.03125 at max 4.875 (measured 1 and
    # 0.5 ulp)
    assert_within_ulps(out, kern, 2, "y vs interpret kernel")
    # backward: JAX's reference and the port's plain version take the
    # same bf16 roundings (dh and dW through the bf16 conv, db through the
    # bf16 bias; measured 0.004 ulp for dx, 4e-6 relative for dgamma and
    # dbeta, dW equal); db is a bf16 sum on both sides, summed in other
    # orders (measured 1 ulp)
    assert_within_ulps(grads[0], dref[0], 1, "dx vs reference")
    for got, want, name in zip(grads[1:3], dref[1:3], ("dgamma", "dbeta")):
        _rel(got, want, 1e-4, f"{name} vs reference")
    _rel(grads[3], dref[3], 1e-5, "dW vs reference")
    assert_within_ulps(grads[4], dref[4], 2, "db vs reference")
    # the interpret kernel keeps h, dh and dW in float32 where the plain
    # version rounds them to bf16: 2^-9 of each term, over sums of random
    # sign (measured 1 ulp for dx, at most 3.5e-3 relative for the rest)
    assert_within_ulps(grads[0], dkern[0], 2, "dx vs interpret kernel")
    for got, kwant, name in zip(grads[1:], dkern[1:],
                                ("dgamma", "dbeta", "dW", "db")):
        assert got.dtype == torch.float32
        _rel(got, kwant, 1e-2, f"{name} vs interpret kernel")


# ---------------------------------------------------------------------------
# 3. the bf16 kernels' arithmetic, emulated
# ---------------------------------------------------------------------------

def bf16_round(a) -> np.ndarray:
    """float32 values rounded to bf16 (to nearest even), as float32."""
    return f32(torch.from_numpy(np.asarray(a, np.float32)).to(BF16))


def emulate_bf16_conv(x, gamma, beta, w, bias, g):
    """The bf16 kernels' arithmetic: float32 statistics and GN+SiLU of
    the bf16 x, h rounded to bf16, W rounded to bf16, the products exact
    and summed in float32 (numpy's float32 matmul), the bias added in
    float32 and y rounded once; dW = h^T g and db = sum g in float32
    (g is bf16); dh = g W^T in float32 through the GN backward (the
    port's plain float32 one), dx rounded once."""
    x32 = f32(x)
    b, l, c = x32.shape
    xg = x32.reshape(b, l, G, c // G).astype(np.float64)
    mean = xg.mean(axis=(1, 3), keepdims=True)
    rstd = 1 / np.sqrt(xg.var(axis=(1, 3), keepdims=True) + 1e-5)
    yn = (((xg - mean) * rstd).reshape(b, l, c) * gamma + beta)
    h = bf16_round(yn / (1 + np.exp(-yn)))
    wb = bf16_round(w)
    pad = np.pad(h, ((0, 0), (1, 1), (0, 0)))
    y = sum(pad[:, j:j + l] @ wb[j] for j in range(3)) + bias
    gg = f32(g)
    gpad = np.pad(gg, ((0, 0), (1, 1), (0, 0)))
    dw = np.stack([np.einsum("blc,blo->co", pad[:, j:j + l], gg)
                   for j in range(3)]).astype(np.float32)
    dh = sum(gpad[:, 2 - j:2 - j + l] @ wb[j].T for j in range(3))
    dx, _, _ = gn.reference_groupnorm_silu_backward(
        torch.from_numpy(x32), torch.from_numpy(gamma),
        torch.from_numpy(beta), torch.from_numpy(dh.astype(np.float32)), G)
    return (bf16_round(y), bf16_round(dx.numpy()), dw,
            gg.sum(axis=(0, 1)))


@pytest.mark.parametrize("b,l,c,cout", [(2, 37, 32, 48), (2, 29, 64, 64)])
def test_bf16_kernel_arithmetic_matches_interpret(b, l, c, cout):
    x, gamma, beta, w, bias, g = _conv_inputs(b + l + c, b, l, c, cout)
    jargs = (jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(w),
             jnp.asarray(bias))
    kern = gn_silu_conv3_interpret(x, *jargs, G)
    dkern = gn_silu_conv3_backward_interpret(x, *jargs, g, G)
    y, dx, dw, db = emulate_bf16_conv(x, gamma, beta, w, bias, g)
    # h and W rounded to bf16 move each product by up to 2^-8 of it; over
    # 3 C products of random sign that stays within an ulp of y's largest
    # value beside the final rounding on both sides (measured 0.5)
    assert_within_ulps(y, kern, 1, "y")
    # dx: the same rounded products in dh, then the GN backward and one
    # rounding (measured 0.5 and 1 ulp)
    assert_within_ulps(dx, dkern[0], 2, "dx")
    # dW from rounded h against float32 h: 2^-9 of each product, over
    # B L products of random sign (measured 1.5e-3 relative)
    _rel(dw, dkern[3], 5e-3, "dW")
    # db: float32 sums of the same bf16 values (measured equal)
    _rel(db, dkern[4], 1e-5, "db")


# ---------------------------------------------------------------------------
# 4-5. bf16 models with the fused-encoder and the flash knobs against flax
# ---------------------------------------------------------------------------

def _params(shapes, rng) -> dict:
    """A flax-layout tree at init-like scales, every leaf non-zero, the
    norms' scales (GroupNorm's gn_scale too) near one."""
    out = {}
    for key, val in shapes.items():
        if isinstance(val, dict):
            out[key] = _params(val, rng)
        elif key == "kernel":
            out[key] = (rng.standard_normal(val)
                        / np.sqrt(np.prod(val[:-1]))).astype(np.float32)
        elif key in ("scale", "gn_scale"):
            out[key] = (1 + 0.1 * rng.standard_normal(val)).astype(
                np.float32)
        else:
            out[key] = (0.1 * rng.standard_normal(val)).astype(np.float32)
    return out


FUSED = dict(pallas_gn=True, pallas_conv_min_width=32)


@pytest.fixture(scope="module")
def fused_pair():
    tm = CondUNet(dtype="bfloat16", **KW, **FUSED)
    params = _params(flax_shapes(tm), np.random.default_rng(16))
    params_from_jax(tm, params)
    fm = FlaxCondUNet(dtype=BF, **KW, **FUSED)
    return fm, params, tm


def test_fused_bf16_model_dtypes_and_forward_match_flax(fused_pair):
    fm, params, tm = fused_pair
    assert sum(isinstance(m, FusedGNConv) for m in tm.modules()) == 6
    cond, x, t = _inputs(16)
    (jout, state), jctx = jax.jit(lambda p: (
        fm.apply({"params": p}, x, t, cond, capture_intermediates=True,
                 mutable=["intermediates"]),
        fm.apply({"params": p}, cond, method=fm.encode_condition)))(params)
    want = {}

    def walk(tree, path=()):
        for key, val in tree.items():
            if key == "__call__":
                want[path] = _dtypes(val)
            else:
                walk(val, path + (key,))

    walk(state["intermediates"])
    got, hooks = {}, []
    for name, mod in tm.named_modules():
        if isinstance(mod, (FusedGNConv, GNSiLU)) or name.startswith(
                "encoder.res"):
            hooks.append(mod.register_forward_hook(
                lambda m, i, o, name=name: got.__setitem__(name,
                                                           _dtypes(o))))
    try:
        with torch.no_grad():
            out = tm(torch.from_numpy(x), torch.from_numpy(t).long(),
                     torch.from_numpy(cond))
            ctx = tm.encode_condition(torch.from_numpy(cond))
    finally:
        for h in hooks:
            h.remove()
    # every fused pair and ResBlock returns bf16 in both frameworks
    assert got and all(d == ("bfloat16",) for d in got.values())
    for name, dts in got.items():
        assert want[_flax_module_path(tm, name)] == dts, name
    # the encoder: about a dozen bf16 layers, as tests/test_torch_bf16.py
    # (measured 1.2 and 1.5 ulps)
    for name, a, b in (("tokens", ctx[0], jctx[0]), ("vec", ctx[1],
                                                    jctx[1])):
        assert a.dtype == BF16
        assert_within_ulps(a, b, 4, name)
    # the denoiser's float32 output (tests/test_torch_bf16.py's gate;
    # measured 3.7 ulps)
    assert out.dtype == torch.float32
    assert_within_ulps(out, jout, 8, "denoiser")


def test_fused_bf16_train_step_matches_flax(fused_pair):
    """One Adam step's loss and step-1 gradients against JAX's, from the
    same t and eps, within the JAX package's bf16 band (5e-2 x max(1,
    max|g|) a leaf, tests/test_ops.py:568-571; measured at most 2.2e-2),
    as tests/test_torch_bf16.py holds the slab arm; the loss within 1e-2
    relative."""
    fm, params, _ = fused_pair
    tm = CondUNet(dtype="bfloat16", **KW, **FUSED)
    params_from_jax(tm, params)
    rng = np.random.default_rng(17)
    x0 = rng.normal(size=(4, 29)).astype(np.float32)
    cond = rng.uniform(size=(4, 96, 4)).astype(np.float32)
    t = np.array([0, 17, 250, 499], np.int32)
    noise = rng.normal(size=(4, 29)).astype(np.float32)
    from ertdx import diffusion as jdiff
    jsch = jdiff.get_diffusion_schedule(T)

    def jloss(p):
        xn = jdiff.q_sample(x0, t, noise, jsch.alpha_bar)
        return jnp.mean((fm.apply({"params": p}, xn, t, cond) - noise) ** 2)

    jl, gwant = jax.jit(jax.value_and_grad(jloss))(params)
    opt = train.create_optimizer(tm, 1e-4)
    loss = train.train_step(
        tm, opt, torch.from_numpy(x0), torch.from_numpy(cond),
        torch.from_numpy(t).long(), torch.from_numpy(noise),
        alpha_bar=diffusion.get_diffusion_schedule(T).alpha_bar, lr=1e-4)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-2)
    got = named_to_jax(tm, {n: p.grad for n, p in tm.named_parameters()})
    for path, want in jax.tree_util.tree_leaves_with_path(gwant):
        g = got
        for k in path:
            g = g[k.key]
        _rel(g, np.asarray(want), 5e-2, path)
    assert {p.dtype for p in tm.parameters()} == {torch.float32}


def test_flash_bf16_model_matches_flax():
    """A bf16 model on the flash knob builds (it was refused) and, on the
    CPU, runs the plain attention on the padded, masked sequence as
    flax's does: the context within tests/test_torch_bf16.py's gate
    (measured 1.5 and 2 ulps)."""
    knobs = dict(KW, attn_slab=False)
    tm = build_model(dataclasses.replace(
        configs.V5E8_DP.model, attn_flash_min_logits=1, **knobs),
        device="cpu")
    assert tm.compute_dtype == BF16 and tm.encoder.attn.flash_min_logits
    params = _params(flax_shapes(tm), np.random.default_rng(18))
    params_from_jax(tm, params)
    fm = FlaxCondUNet(dtype=BF, flash_min_logits=1, **knobs)
    cond, _, _ = _inputs(18)
    jctx = jax.jit(lambda p: fm.apply({"params": p}, cond,
                                      method=fm.encode_condition))(params)
    with torch.no_grad():
        ctx = tm.encode_condition(torch.from_numpy(cond))
    for name, a, b in (("tokens", ctx[0], jctx[0]), ("vec", ctx[1],
                                                    jctx[1])):
        assert a.dtype == BF16
        assert_within_ulps(a, b, 4, name)
