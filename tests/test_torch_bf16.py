"""bfloat16 compute in the port against the JAX package, on the CPU.

A bfloat16 CondUNet (ModelConfig.dtype, V5E8_DP's: compute in bf16,
params float32) at small widths (hidden 32, base width 16, depth 2, 2
core blocks, 2 encoder heads, a 96 x 4 condition, the slab attention on)
is held against flax's `CondUNet(dtype=bfloat16)` with the same params:

* the dtype at every module boundary (flax's intermediates against
  forward hooks), params float32, a bf16 context, a float32 denoiser;
* encode_condition and denoise_ensemble (n_real 1 and 3), and one train
  step's loss and gradients, with float32 params and Adam moments;
* the plain bf16 slab attention, forward and backward, against JAX's
  reference and its interpret-mode kernels; the plain GroupNorm+SiLU on
  bf16;
* the fused-core path of a bf16 model (`mega_plan`, and
  `mega_denoise_ensemble` on the CPU against JAX's interpret kernels);
* `build_model` with every kernel knob in bf16 (the GN, fused-conv,
  flash and ensemble knobs build and run in bf16), and the precision
  helper (`ertdx_torch.precision.fp32_precision`) inside the entry
  points.

Tolerances. bf16 keeps 8 significant bits: one rounding moves a value by
up to half an ulp, 2^-9 of it, and the two frameworks round at other
places (XLA fuses a bias into its product's single rounding where torch
rounds twice, or keeps a fused elementwise chain in float32), so every
bf16 layer can put one ulp, 2^-8 relative, between them. Gates are
stated in ulps of the compared tensor's largest value, `ulp(x) =
2^(floor(log2 max|x|) - 7)`: one ulp where a single rounding differs
(GroupNorm+SiLU, the slab's forward), a few where several bf16 layers
feed each other (each gate below says how many). Against float32 (the
fused core after its float32 cast) the float32 gates of the f32 tests
hold.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ertdx import diffusion as jdiff
from ertdx import train as jtrain
from ertdx.models.condunet import CondUNet as FlaxCondUNet
from ertdx.models.mega import mega_denoise_ensemble as jax_mega
from ertdx.ops.groupnorm import reference_groupnorm_silu as jax_gn
from ertdx.ops.slab_attn import (reference_slab_attention as jax_slab,
                                 slab_attention_backward_interpret,
                                 slab_attention_interpret)
from ertdx_torch import configs, diffusion, distill, precision, sample, train
from ertdx_torch.configs import ModelConfig
from ertdx_torch.models import build_model, mega
from ertdx_torch.models.condunet import CondUNet
from ertdx_torch.ops import core_block as cb
from ertdx_torch.ops import groupnorm as gn
from ertdx_torch.ops import slab_attn as sa
from ertdx_torch.utils.weights import (flax_path, flax_shapes, fused_blocks,
                                       named_to_jax, params_from_jax)

BF16 = torch.bfloat16
KW = dict(param_dim=29, hidden_dim=32, cond_channels=4, base_width=16,
          depth=2, num_heads=2, core_heads=1, num_blocks=2, attn_slab=True)
T = 500
LR = 1e-4


def ulp(ref) -> float:
    """One bf16 ulp at the largest magnitude of `ref`."""
    top = float(np.abs(f32(ref)).max())
    return 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -126))) - 7)


def assert_within_ulps(got, want, n: float, what: str) -> None:
    """max |got - want| <= n bf16 ulps of max |want|."""
    err = float(np.abs(f32(got) - f32(want)).max())
    assert err <= n * ulp(want), (what, err, n * ulp(want))


def f32(a) -> np.ndarray:
    """A JAX or torch array as float32 numpy (bf16 converts exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def tbf(a) -> torch.Tensor:
    """A bf16 JAX array (or bf16-exact numpy) as a torch bf16 tensor."""
    return torch.from_numpy(f32(a)).to(BF16)


def random_params(shapes, rng) -> dict:
    """A flax-layout tree at init-like scales, every leaf non-zero."""
    out = {}
    for key, val in shapes.items():
        if isinstance(val, dict):
            out[key] = random_params(val, rng)
        elif key == "kernel":
            out[key] = (rng.standard_normal(val)
                        / math.sqrt(np.prod(val[:-1]))).astype(np.float32)
        elif key == "scale":
            out[key] = (1 + 0.1 * rng.standard_normal(val)).astype(
                np.float32)
        else:
            out[key] = (0.1 * rng.standard_normal(val)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    """(flax bf16 model, numpy params, the port's bf16 model on the CPU)."""
    tm = CondUNet(dtype="bfloat16", **KW)
    params = random_params(flax_shapes(tm), np.random.default_rng(0))
    params_from_jax(tm, params)
    fm = FlaxCondUNet(dtype=jnp.bfloat16, **KW)
    return fm, params, tm


def _inputs(seed, b=2, n_real=1):
    rng = np.random.default_rng(seed)
    cond = rng.normal(size=(b, 96, 4)).astype(np.float32)
    x = rng.normal(size=(b * n_real, 29)).astype(np.float32)
    t = rng.integers(0, T, size=(b * n_real,)).astype(np.int32)
    return cond, x, t


# ---------------------------------------------------------------------------
# 1. dtypes at every module boundary
# ---------------------------------------------------------------------------

def _flax_module_path(tm, name: str) -> tuple:
    """The flax module path of the port's module `name`: its first
    parameter's flax path cut to the module's depth (a ModuleList index
    merges with its list's name, res.0 -> ResBlock1D_0)."""
    if not name:
        return ()
    pname = next(n for n, _ in tm.named_parameters()
                 if n.startswith(name + "."))
    comps = name.split(".")
    depth = len(comps) - sum(c.isdigit() for c in comps)
    return flax_path(pname, tm.depth, fused_blocks(tm))[:depth]


def _dtypes(out) -> tuple:
    """The dtypes of a module's outputs, flattened in order."""
    leaves = (out,) if isinstance(out, torch.Tensor) else \
        jax.tree_util.tree_leaves(out)
    return tuple(str(a.dtype).replace("torch.", "") for a in leaves)


def test_dtypes_at_every_module_boundary(pair):
    fm, params, tm = pair
    cond, x, t = _inputs(1)
    _, state = jax.eval_shape(
        lambda p: fm.apply({"params": p}, x, t, cond,
                           capture_intermediates=True,
                           mutable=["intermediates"]), params)
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
        hooks.append(mod.register_forward_hook(
            lambda m, i, o, name=name: got.__setitem__(name, _dtypes(o))))
    try:
        with torch.no_grad():
            tm(torch.from_numpy(x), torch.from_numpy(t).long(),
               torch.from_numpy(cond))
    finally:
        for h in hooks:
            h.remove()
    checked = 0
    for name, dts in got.items():
        path = _flax_module_path(tm, name)
        assert path in want, (name, path)
        assert dts == want[path], (name, path, dts, want[path])
        checked += 1
    assert checked == sum(not isinstance(m, torch.nn.ModuleList)
                          for m in tm.modules())
    # flax's only modules the port has not are AdaLN's parameterless
    # LayerNorm (F.layer_norm inside the port's AdaLN)
    mapped = {_flax_module_path(tm, n) for n in got}
    assert all(p[-1] == "LayerNorm_0" and p[-2].startswith("AdaLN")
               for p in set(want) - mapped)
    assert got[""] == ("float32",) and got["encoder"] == ("bfloat16",) * 2
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    with torch.no_grad():
        tokens, vec = tm.encode_condition(torch.from_numpy(cond))
    assert tokens.dtype == vec.dtype == BF16


# ---------------------------------------------------------------------------
# 2-3. the forward and one train step against flax's bf16 model
# ---------------------------------------------------------------------------

def test_forward_matches_flax_bf16(pair):
    """encode_condition, and denoise_ensemble at n_real 1 and 3 from
    JAX's context (the same inputs), against flax's bf16 model."""
    fm, params, tm = pair
    cond, x1, t1 = _inputs(2, n_real=1)
    _, x3, t3 = _inputs(3, n_real=3)

    @jax.jit
    def jfwd(p):
        ctx = fm.apply({"params": p}, cond, method=fm.encode_condition)
        return ctx, [fm.apply({"params": p}, x, t, ctx, r,
                              method=fm.denoise_ensemble)
                     for x, t, r in ((x1, t1, 1), (x3, t3, 3))]

    jctx, jouts = jfwd(params)
    with torch.no_grad():
        ctx = tm.encode_condition(torch.from_numpy(cond))
        outs = [tm.denoise_ensemble(torch.from_numpy(x),
                                    torch.from_numpy(t).long(),
                                    tuple(tbf(a) for a in jctx), r)
                for x, t, r in ((x1, t1, 1), (x3, t3, 3))]
    # the encoder: about a dozen bf16 layers (measured 1.25 and 1 ulp)
    for name, got, want in (("tokens", ctx[0], jctx[0]),
                            ("vec", ctx[1], jctx[1])):
        assert got.dtype == BF16
        assert_within_ulps(got, want, 4, name)
    # the denoiser: two core blocks of ten bf16 layers each, added to a
    # float32 residual (measured 4.3 and 4.0 ulps of the output's largest)
    for got, want in zip(outs, jouts):
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        assert_within_ulps(got, want, 8, "denoise_ensemble")


def test_train_step_matches_flax_bf16(pair):
    """One Adam step of the bf16 model: loss and step-1 gradients against
    JAX's, from the same t and eps; params and moments stay float32."""
    fm, params, _ = pair
    tm = CondUNet(dtype="bfloat16", **KW)
    params_from_jax(tm, params)
    rng = np.random.default_rng(4)
    x0 = rng.normal(size=(4, 29)).astype(np.float32)
    cond = rng.uniform(size=(4, 96, 4)).astype(np.float32)
    t = np.array([0, 17, 250, 499], np.int32)
    noise = rng.normal(size=(4, 29)).astype(np.float32)
    jsch = jdiff.get_diffusion_schedule(T)

    def jloss(p):
        xn = jdiff.q_sample(x0, t, noise, jsch.alpha_bar)
        out = fm.apply({"params": p}, xn, t, cond)
        return jnp.mean((out - noise) ** 2)

    jl, gwant = jax.jit(jax.value_and_grad(jloss))(params)
    opt = train.create_optimizer(tm, LR)
    loss = train.train_step(
        tm, opt, torch.from_numpy(x0), torch.from_numpy(cond),
        torch.from_numpy(t).long(), torch.from_numpy(noise),
        alpha_bar=diffusion.get_diffusion_schedule(T).alpha_bar, lr=LR)
    # the loss of 4 examples through the whole bf16 model (measured
    # 4.6e-3 relative); each leaf's gradient within the JAX package's bf16
    # band, 5e-2 x max(1, max|g|) (tests/test_ops.py:568-571; measured at
    # most 2.1e-2)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-2)
    got = named_to_jax(tm, {n: p.grad for n, p in tm.named_parameters()})
    for path, want in jax.tree_util.tree_leaves_with_path(gwant):
        g = got
        for k in path:
            g = g[k.key]
        want = np.asarray(want)
        assert float(np.abs(g - want).max()) <= 5e-2 * max(
            1.0, float(np.abs(want).max())), path
    assert loss.dtype == torch.float32
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    assert {v.dtype for st in opt.state.values() for v in st.values()
            if v.is_floating_point()} == {torch.float32}


# ---------------------------------------------------------------------------
# 4-5. the plain versions on bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,l,c,nh", [(2, 61, 128, 2), (1, 147, 256, 4)])
def test_plain_slab_matches_jax_on_bf16(b, l, c, nh):
    """Forward and backward (jax.vjp) on a bf16 slab: within one ulp of
    JAX's reference (the same roundings; measured 0.25) and two of its
    interpret-mode kernels, which are one ulp from the reference
    themselves."""
    rng = np.random.default_rng(b + l + nh)
    qkv = jnp.asarray(rng.normal(size=(b, l, 3 * c)), jnp.bfloat16)
    do = jnp.asarray(rng.normal(size=(b, l, c)), jnp.bfloat16)
    ref, vjp = jax.vjp(lambda z: jax_slab(z, nh), qkv)
    dref, = vjp(do)
    kern = slab_attention_interpret(qkv, nh)
    dkern = slab_attention_backward_interpret(qkv, do, nh)
    z = tbf(qkv).requires_grad_(True)
    out = sa.slab_attention(z, nh)
    out.backward(tbf(do))
    assert out.dtype == z.grad.dtype == BF16
    assert ref.dtype == kern.dtype == dref.dtype == dkern.dtype == \
        jnp.bfloat16
    assert_within_ulps(out, ref, 1, "forward vs reference")
    assert_within_ulps(z.grad, dref, 1, "dqkv vs reference")
    assert_within_ulps(out, kern, 2, "forward vs interpret kernel")
    assert_within_ulps(z.grad, dkern, 2, "dqkv vs interpret kernel")


def test_plain_groupnorm_matches_jax_on_bf16():
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(2, 37, 64)) * 3 + 1, jnp.bfloat16)
    gamma = rng.normal(size=64).astype(np.float32)
    beta = rng.normal(size=64).astype(np.float32)
    want = jax_gn(x, jnp.asarray(gamma), jnp.asarray(beta), 8)
    got = gn.reference_groupnorm_silu(tbf(x), torch.from_numpy(gamma),
                                      torch.from_numpy(beta), 8)
    # both take float32 statistics and round once at the end
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert_within_ulps(got, want, 1, "groupnorm_silu")


# ---------------------------------------------------------------------------
# 6. the fused core of a bf16 model
# ---------------------------------------------------------------------------

def test_mega_plan_accepts_bf16():
    """As tests/test_ops.py:510-530: a bf16 model takes the fused-core
    path (its kernels are float32; the context is cast at entry)."""
    kw = dict(KW, hidden_dim=128, ensemble_mega=True)
    for dtype in ("bfloat16", "float32"):
        model = CondUNet(dtype=dtype, **kw)
        assert mega.mega_plan(model, 1000, 32, device="cuda") is not None


def test_mega_denoise_of_a_bf16_model_matches_jax_interpret(pair):
    """As tests/test_ops.py:532-572: the bf16 model's fused-core step on
    the CPU (the plain stack) against JAX's interpret-mode kernel from the
    same bf16 context, and against the bf16 module path."""
    fm, params, tm = pair
    n_real, b = 8, 2
    cond, x, _ = _inputs(6, b=b, n_real=n_real)
    t = np.full((b * n_real,), 7, np.int32)     # samplers share one t
    jctx = jax.jit(lambda p: fm.apply({"params": p}, cond,
                                      method=fm.encode_condition))(params)
    assert jctx[0].dtype == jnp.bfloat16
    want = jax_mega(params, jnp.asarray(x), jnp.asarray(t), jctx, n_real,
                    p=29, d=32, num_blocks=2, chunk=n_real, stack=True,
                    interpret=True)
    ctx = tuple(tbf(a) for a in jctx)
    tt = torch.from_numpy(t).long()
    cb.reset_launches()
    with torch.no_grad():
        got = mega.mega_denoise_ensemble(
            tm, torch.from_numpy(x), tt, ctx, n_real, p=29, d=32,
            num_blocks=2, chunk=n_real, stack=True)
        module = tm.denoise_ensemble(torch.from_numpy(x), tt, ctx, n_real)
    assert got.dtype == module.dtype == torch.float32
    # float32 after the cast: tests/test_torch_core_block.py's gate
    np.testing.assert_allclose(got.numpy(), f32(want), rtol=2e-5,
                               atol=2e-5)
    # the bf16 module path within the JAX package's bf16 band
    np.testing.assert_allclose(got.numpy(), module.numpy(), rtol=5e-2,
                               atol=5e-2)
    assert cb.launches == {"fused_core_stack": 0, "fused_core_block": 0}


# ---------------------------------------------------------------------------
# 7-8. the kernel knobs in bf16, and the precision helper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knob,value", [
    ("pallas_gn", True), ("pallas_conv", True),
    ("pallas_conv_min_width", 256), ("ensemble_pallas", True),
    ("attn_flash_min_logits", 1)])
def test_build_model_builds_every_kernel_knob_in_bf16(knob, value):
    """Every kernel knob builds in bf16 and runs a bf16 forward on the CPU
    (their plain versions, as JAX runs them off the TPU); the ensemble
    kernels' knob too, since their bf16 operands go in as float32 copies
    (tests/test_torch_ensemble_bf16.py holds that model against flax's)."""
    cfg = dataclasses.replace(configs.V5E8_DP.model, **{knob: value})
    small = dataclasses.replace(cfg, **KW, cond_length=96)
    model = build_model(small, device="cpu")
    assert model.compute_dtype == BF16
    cond, x, t = _inputs(7)
    with torch.no_grad():
        tokens, vec = model.encode_condition(torch.from_numpy(cond))
        out = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    torch.from_numpy(cond))
    assert tokens.dtype == vec.dtype == BF16
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    # the same knob in float32 builds, and so does the preset in bf16
    build_model(dataclasses.replace(cfg, dtype="float32"), device="cpu")


def test_build_model_builds_the_preset_in_bf16_and_refuses_other_dtypes():
    model = build_model(configs.V5E8_DP.model, device="cpu")
    assert model.compute_dtype == BF16 and model.encoder.attn.slab
    assert model.encoder.attn.qkv.compute_dtype == BF16
    assert model.head.weight.dtype == torch.float32
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        build_model(ModelConfig(name="condunet", dtype="float16"),
                    device="cpu")


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def tf32_on(monkeypatch):
    """Both TF32 flags True, as a caller might leave them; restored
    after the test."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert _flags() == (True, True)


def test_fp32_precision_restores_the_callers_flags(tf32_on):
    with precision.fp32_precision():
        assert _flags() == (False, False)
    assert _flags() == (True, True)
    with pytest.raises(KeyError):
        with precision.fp32_precision():
            raise KeyError("inside")
    assert _flags() == (True, True)


class _Stop(Exception):
    pass


def _small_cfg():
    model = dataclasses.replace(ModelConfig(), name="condunet",
                                dtype="bfloat16", **KW)
    return configs.ExperimentConfig(
        diffusion=configs.DiffusionConfig(T=10), model=model)


@pytest.mark.parametrize("entry", ["train", "distill",
                                   "posterior_over_dataset",
                                   "posterior_over_dataset_mixture"])
def test_entry_points_run_without_tf32(tf32_on, monkeypatch, entry):
    """Each entry point sees both flags False where it works, and the
    caller's come back after it raises (a stand-in for the first thing it
    calls records the flags and stops it)."""
    seen = []

    def stop(*args, **kwargs):
        seen.append(_flags())
        raise _Stop

    cond = np.zeros((2, 96, 4), np.float32)
    if entry == "train":
        monkeypatch.setattr(train, "resolve_device", stop)
        run = lambda: train.train(_small_cfg(), None, device="cpu")
    elif entry == "distill":
        monkeypatch.setattr(distill, "resolve_device", stop)
        run = lambda: distill.distill(_small_cfg(), distill.DistillConfig(),
                                      None, "teacher", device="cpu")
    else:
        monkeypatch.setattr(sample, "posterior_ensemble", stop)
        fn = getattr(sample, entry)
        first = None if entry == "posterior_over_dataset" else [None]
        run = lambda: fn(first, cond, None, None, device="cpu")
    with pytest.raises(_Stop):
        run()
    assert seen == [(False, False)]
    assert _flags() == (True, True)


def test_posterior_ensemble_of_a_bf16_model_runs_without_tf32(tf32_on,
                                                              monkeypatch):
    """A bf16 model samples float32 draws on the CPU; its sampler runs
    with both flags False, and the caller's come back after it returns."""
    seen = []
    run_sampler = sample._run_sampler

    def record(*args, **kwargs):
        seen.append(_flags())
        return run_sampler(*args, **kwargs)

    monkeypatch.setattr(sample, "_run_sampler", record)
    cfg = _small_cfg()
    model = build_model(cfg.model, device="cpu")
    u = sample.posterior_ensemble(
        model, np.random.default_rng(7).normal(size=(2, 96, 4)),
        diffusion.schedule_from_config(cfg.diffusion), 3,
        configs.SampleConfig(sampler="ddim", ddim_steps=2), device="cpu")
    assert seen == [(False, False)] and _flags() == (True, True)
    assert u.shape == (3, 2, 29) and u.dtype == torch.float32
    assert torch.isfinite(u).all()
