"""The port's CUDA kernels on the card (marked gpu; skipped without one).

Run on a machine with an H100: python -m pytest tests/test_torch_gpu.py
Whether there is a card is decided inside the `cuda` fixture, never at
import, so every xdist worker collects the same tests.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from ertdx_torch.ops import _build
from ertdx_torch.ops import core_block as cb

pytestmark = pytest.mark.gpu
P, D, LK = 29, 128, 147


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    # the fused conv's plain version is a cuDNN conv1d, TF32 by default
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, r, nb, seed=0, lk=LK):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    s = 1.0 / math.sqrt(D)
    ws = {"wqkv": rnd(nb, D, 3 * D, scale=s), "wso": rnd(nb, D, D, scale=s),
          "bso": rnd(nb, D, scale=0.1), "wcq": rnd(nb, D, D, scale=s),
          "wco": rnd(nb, D, D, scale=s), "bco": rnd(nb, D, scale=0.1),
          "w1": rnd(nb, D, 4 * D, scale=s), "b1": rnd(nb, 4 * D, scale=0.1),
          "w2": rnd(nb, 4 * D, D, scale=s), "b2": rnd(nb, D, scale=0.1)}
    return ws, rnd(b, 6 * nb, D, scale=0.3), rnd(b * nb, lk, D), \
        rnd(b * nb, lk, D), rnd


def _same_on_rerun_and_accurate(run, got):
    """A rerun is bit-identical, and so is accurate=True: both values
    compute 3xTF32."""
    assert torch.equal(run(False), got)
    assert torch.equal(run(True), got)


# (R, P, Lk): ragged last tile at R=33; the kernels' limits, P=17 with
# Lk=61 (one key block) and P=32 with Lk=256 (two full key blocks)
CORE_CASES = [(10, P, LK), (33, P, LK), (64, P, LK), (33, 17, 61),
              (20, 32, 256)]


@pytest.mark.parametrize("r,p,lk", CORE_CASES)
def test_stack_kernel_matches_plain(cuda, r, p, lk):
    b, nb = 3, 2
    ws, mods, k, v, rnd = _inputs(cuda, b, r, nb, lk=lk)
    args = (rnd(b, r, p), mods, k, v, ws, rnd(1, D), rnd(1, D), rnd(p, D),
            1 + rnd(1, D, scale=0.1), rnd(1, D), rnd(D, 1, scale=0.1),
            rnd(1, 1))
    before = cb.launches["fused_core_stack"]
    got = cb.fused_core_stack(*args, p=p, chunk=r)
    torch.cuda.synchronize()
    assert cb.launches["fused_core_stack"] == before + 1
    want = cb.fused_core_stack_plain(*args, p=p)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    _same_on_rerun_and_accurate(
        lambda acc: cb.fused_core_stack(*args, p=p, chunk=r, accurate=acc),
        got)


@pytest.mark.parametrize("r,p,lk", CORE_CASES[:2] + CORE_CASES[3:])
def test_block_kernel_matches_plain(cuda, r, p, lk):
    b = 2
    ws, mods, k, v, rnd = _inputs(cuda, b, r, 1, seed=1, lk=lk)
    w = {key: val[0].contiguous() for key, val in ws.items()}
    x3 = rnd(b, r * p, D)
    got = cb.fused_core_block(x3, mods, k, v, w, p=p, chunk=r)
    torch.cuda.synchronize()
    want = cb.fused_core_block_plain(x3, mods, k, v, w, p=p)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    _same_on_rerun_and_accurate(
        lambda acc: cb.fused_core_block(x3, mods, k, v, w, p=p, chunk=r,
                                        accurate=acc),
        got)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    ws, mods, k, v, rnd = _inputs(cuda, 2, 4, 1)
    w = {key: val[0].contiguous() for key, val in ws.items()}
    x3 = rnd(2, 4 * P, D)
    with pytest.raises(TypeError, match="float32"):
        cb.fused_core_block(x3.double(), mods, k, v, w, p=P, chunk=4)
    with pytest.raises(ValueError, match="contiguous"):
        cb.fused_core_block(x3, mods, k.transpose(1, 2).contiguous()
                            .transpose(1, 2), v, w, p=P, chunk=4)
    with pytest.raises(ValueError, match="does not fit"):
        cb.fused_core_block(x3, mods, k, v, w, p=P, chunk=5)


def test_build_is_cached(cuda):
    assert _build.load() is _build.load()
    assert "sm_90a" in _build.load().report


def test_posterior_ensemble_runs_on_the_kernel(cuda):
    from ertdx_torch import sample
    from ertdx_torch.diffusion import get_diffusion_schedule
    from ertdx_torch.configs import SampleConfig
    from ertdx_torch.models.condunet import CondUNet

    torch.manual_seed(0)
    model = CondUNet(cond_channels=4, base_width=16, depth=2,
                     num_heads=2, num_blocks=2).to(cuda)
    cond = torch.randn(2, 96, 4, device=cuda)
    scfg = SampleConfig(sampler="ddim", ddim_steps=3)
    sch = get_diffusion_schedule(20)
    x_t = torch.randn(2 * 2048, 29, device=cuda)
    cb.reset_launches()
    u = sample.posterior_ensemble(model, cond, sch, 2048, scfg, x_T=x_t)
    torch.cuda.synchronize()
    assert cb.launches["fused_core_stack"] == 3
    model.ensemble_mega = False
    u_plain = sample.posterior_ensemble(model, cond, sch, 2048, scfg,
                                        x_T=x_t)
    np.testing.assert_allclose(u.cpu().numpy(), u_plain.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,l,c,nh", [
    (3, 147, 256, 4),    # the encoder's deepest stage, ragged last tile
    (2, 65, 256, 8),     # dh=32, one row past a tile
    (2, 1, 64, 1),       # a single token
    (1, 256, 128, 2),    # the longest L the kernels take
])
def test_slab_kernels_match_plain(cuda, b, l, c, nh):
    from ertdx_torch.ops import slab_attn as sa

    g = torch.Generator(device=cuda).manual_seed(b * 100 + l)
    qkv = torch.randn(b, l, 3 * c, generator=g, device=cuda)
    do = torch.randn(b, l, c, generator=g, device=cuda)
    sa.reset_launches()
    z = qkv.clone().requires_grad_(True)
    out = sa.slab_attention(z, nh)
    out.backward(do)
    torch.cuda.synchronize()
    assert sa.launches == {"slab_attention_fwd": 1, "slab_attention_bwd": 1}
    want = sa.reference_slab_attention(qkv, nh)
    dwant = sa.reference_slab_attention_backward(qkv, do, nh)
    assert float((out.detach() - want).abs().max()) <= \
        1e-4 * max(1.0, float(want.abs().max()))
    assert float((z.grad - dwant).abs().max()) <= \
        1e-4 * max(1.0, float(dwant.abs().max()))
    # each kernel owns its outputs (no atomics): reruns are bit-identical
    assert torch.equal(sa.slab_attention_fwd(qkv, nh), out.detach())
    assert torch.equal(sa.slab_attention_fwd(qkv, nh),
                       sa.slab_attention_fwd(qkv, nh))
    again = sa.slab_attention_bwd(qkv, do, nh)
    assert torch.equal(again, sa.slab_attention_bwd(qkv, do, nh))
    assert torch.equal(again, z.grad)


def test_slab_gate_false_runs_the_plain_version(cuda):
    from ertdx_torch.ops import slab_attn as sa

    sa.reset_launches()
    qkv = torch.randn(2, 300, 3 * 64, device=cuda)     # L > 256
    out = sa.slab_attention(qkv, 1)
    assert sa.launches["slab_attention_fwd"] == 0
    assert torch.allclose(out, sa.reference_slab_attention(qkv, 1))
    with pytest.raises(ValueError, match="do not take"):
        sa.slab_attention_fwd(qkv, 1)
    with pytest.raises(TypeError, match="float32"):
        sa.slab_attention_fwd(torch.randn(2, 8, 192, device=cuda,
                                          dtype=torch.float64), 1)


def _ensemble_inputs(dev, shape_q, shape_kv, seed, fused=True):
    """q, k, v on the card; with `fused` they are row-strided chunks of
    one projection, as the model passes them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if fused and shape_q == shape_kv:
        return torch.randn(*shape_q[:-1], 3 * shape_q[-1], generator=g,
                           device=dev).chunk(3, dim=-1)
    q = torch.randn(*shape_q, generator=g, device=dev)
    if fused:
        k, v = torch.randn(*shape_kv[:-1], 2 * shape_kv[-1], generator=g,
                           device=dev).chunk(2, dim=-1)
    else:
        k, v = (torch.randn(*shape_kv, generator=g, device=dev)
                for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("n,p,d,fused", [
    (2000, 29, 128, True),     # the per-block path's shape
    (5, 32, 128, False),       # every lane a key
    (7, 1, 64, True),          # one token
    (3, 17, 64, False),
    (1, 29, 128, True),        # one chain
    (5000, 29, 64, True),      # many chains a block
])
def test_block_self_kernel_matches_plain(cuda, n, p, d, fused):
    from ertdx_torch.ops import ensemble_attn as ea

    q, k, v = _ensemble_inputs(cuda, (n, p, d), (n, p, d), n + p, fused)
    ea.reset_launches()
    got = ea.block_self_attention(q, k, v)
    again = ea.block_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert ea.launches["block_self_attention"] == 2
    want = ea.reference_attention(q, k, v)
    assert float((got - want).abs().max()) <= \
        1e-4 * max(1.0, float(want.abs().max()))
    assert torch.equal(got, again)


@pytest.mark.parametrize("b,lq,lk,d,fused", [
    (2, 29 * 1000, 147, 128, True),   # the per-block path's shape
    (1, 13, 256, 64, False),          # the most keys; a ragged row group
    (3, 1, 1, 128, True),
    (2, 29 * 7, 61, 128, False),
    (1, 29 * 3, 173, 128, True),      # the old gate's edge at D = 128
    (2, 40, 256, 64, True),           # and at D = 64
    (2, 29 * 5, 147, 128, True),      # Lq not a multiple of 16
    (2, 7, 147, 128, False),          # Lq below one 16-row tile
])
def test_folded_cross_kernel_matches_plain(cuda, b, lq, lk, d, fused):
    from ertdx_torch.ops import ensemble_attn as ea

    q, k, v = _ensemble_inputs(cuda, (b, lq, d), (b, lk, d), lq + lk, fused)
    ea.reset_launches()
    got = ea.folded_cross_attention(q, k, v)
    again = ea.folded_cross_attention(q, k, v)
    torch.cuda.synchronize()
    assert ea.launches["folded_cross_attention"] == 2
    want = ea.reference_attention(q, k, v)
    assert float((got - want).abs().max()) <= \
        1e-4 * max(1.0, float(want.abs().max()))
    assert torch.equal(got, again)


@pytest.mark.parametrize("kind,shape_q,shape_kv", [
    ("self", (2000, 29, 128), (2000, 29, 128)),    # the per-block path's
    ("self", (7, 17, 64), (7, 17, 64)),
    ("cross", (2, 29 * 1000, 128), (2, 147, 128)),
    ("cross", (3, 40, 64), (3, 61, 64)),
])
def test_ensemble_kernels_on_bf16_operands(cuda, kind, shape_q, shape_kv):
    """bf16 q, k, v (chunks of a fused projection) go through the float32
    kernels as float32 copies, the output in bf16: against the plain
    version computed in float32 from the same bf16 inputs within one bf16
    rounding of the output (2^-8 x max(1, max|plain|)); reruns
    bit-identical, one launch a call."""
    from ertdx_torch.ops import ensemble_attn as ea

    g = torch.Generator(device=cuda).manual_seed(shape_q[1] + 3)
    d = shape_q[-1]

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).bfloat16()

    if kind == "self":
        q, k, v = rnd(*shape_q[:-1], 3 * d).chunk(3, dim=-1)
    else:
        q = rnd(*shape_q)
        k, v = rnd(*shape_kv[:-1], 2 * d).chunk(2, dim=-1)
    fn = ea.block_self_attention if kind == "self" else \
        ea.folded_cross_attention
    name = "block_self_attention" if kind == "self" else \
        "folded_cross_attention"
    ea.reset_launches()
    got = fn(q, k, v)
    again = fn(q, k, v)
    torch.cuda.synchronize()
    assert ea.launches[name] == 2 and got.dtype == torch.bfloat16
    want = ea.reference_attention(q.float(), k.float(), v.float())
    assert float((got.float() - want).abs().max()) <= \
        2.0 ** -8 * max(1.0, float(want.abs().max()))
    assert torch.equal(got, again)


def test_ensemble_gate_false_runs_the_plain_version(cuda):
    from ertdx_torch.ops import ensemble_attn as ea

    ea.reset_launches()
    q = torch.randn(4, 33, 128, device=cuda)          # P > 32
    out = ea.block_self_attention(q, q, q)
    qc, kc = torch.randn(1, 40, 128, device=cuda), \
        torch.randn(1, 300, 128, device=cuda)         # Lk > 256
    outc = ea.folded_cross_attention(qc, kc, kc)
    assert ea.launches == {"block_self_attention": 0,
                           "folded_cross_attention": 0}
    assert torch.allclose(out, ea.reference_attention(q, q, q))
    assert torch.allclose(outc, ea.reference_attention(qc, kc, kc))


def test_ensemble_kernels_refuse_what_they_do_not_take(cuda):
    from ertdx_torch.ops import ensemble_attn as ea

    q = torch.randn(4, 33, 128, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        ea.block_self_attention_fwd(q, q, q)
    q = torch.randn(4, 29, 128, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ea.block_self_attention_fwd(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="stride"):
        bad = torch.randn(4, 128, 29, device=cuda).transpose(1, 2)
        ea.block_self_attention_fwd(q, bad, q)
    with pytest.raises(ValueError, match="CUDA"):
        ea.folded_cross_attention_fwd(q, q.cpu(), q)


def test_per_block_path_runs_on_the_ensemble_kernels(cuda):
    """A guided pd run below the fused-core threshold goes through the
    ensemble kernels: 2 passes x 2 steps x 2 blocks launches of each."""
    from ertdx_torch import sample
    from ertdx_torch.configs import SampleConfig
    from ertdx_torch.diffusion import get_diffusion_schedule
    from ertdx_torch.models.condunet import CondUNet
    from ertdx_torch.ops import ensemble_attn as ea

    torch.manual_seed(0)
    model = CondUNet(cond_channels=4, base_width=16, depth=2, num_heads=2,
                     num_blocks=2, uncond_prob=0.1, ensemble_pallas=True,
                     ensemble_min_chains=64).to(cuda)
    cond = torch.randn(2, 96, 4, device=cuda)
    scfg = SampleConfig(sampler="pd", pd_steps=2, guidance_scale=2.0)
    sch = get_diffusion_schedule(20)
    x_t = torch.randn(2 * 100, 29, device=cuda)
    ea.reset_launches()
    u = sample.posterior_ensemble(model, cond, sch, 100, scfg, x_T=x_t)
    torch.cuda.synchronize()
    assert ea.launches == {"block_self_attention": 8,
                           "folded_cross_attention": 8}
    for blk in model.blocks:
        blk.ensemble_pallas = False
    u_plain = sample.posterior_ensemble(model, cond, sch, 100, scfg,
                                        x_T=x_t)
    np.testing.assert_allclose(u.cpu().numpy(), u_plain.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


def _close(got, want):
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol, (err, tol)


def _gn_case(dev, b, l, c, shift=0.5, scale=2.0):
    """The GN kernels against their plain versions at one shape, reruns
    bit-identical, one launch a call; returns the plans they ran."""
    from ertdx_torch.ops import groupnorm as gn

    g = torch.Generator(device=dev).manual_seed(b * l + c)
    x = scale * torch.randn(b, l, c, generator=g, device=dev) + shift
    gamma = 1 + 0.3 * torch.randn(c, generator=g, device=dev)
    beta = 0.3 * torch.randn(c, generator=g, device=dev)
    dy = torch.randn(b, l, c, generator=g, device=dev)
    gn.reset_launches()
    got = gn.groupnorm_silu_fwd(x, gamma, beta, 8)
    dgot = gn.groupnorm_silu_bwd(x, gamma, beta, dy, 8)
    torch.cuda.synchronize()
    assert gn.launches == {"groupnorm_silu_fwd": 1, "groupnorm_silu_bwd": 1}
    _close(got, gn.reference_groupnorm_silu(x, gamma, beta, 8))
    for a, w in zip(dgot, gn.reference_groupnorm_silu_backward(
            x, gamma, beta, dy, 8)):
        _close(a, w)
    assert torch.equal(got, gn.groupnorm_silu_fwd(x, gamma, beta, 8))
    again = gn.groupnorm_silu_bwd(x, gamma, beta, dy, 8)
    assert all(torch.equal(a, w) for a, w in zip(dgot, again))
    return [gn.launch_plan(l, c, 8, k).path for k in ("fwd", "bwd")]


# the staged kernels (float4 units; 4-byte units at cg = 9; the stem; the
# fused conv's width) and the streamed ones (the condition's length)
@pytest.mark.parametrize("b,l,c", [(2, 37, 16), (3, 61, 72), (4, 587, 128),
                                   (2, 294, 256), (2, 4693, 128)])
def test_groupnorm_kernels_match_plain(cuda, b, l, c):
    paths = _gn_case(cuda, b, l, c)
    assert paths == (["streamed"] * 2 if l == 4693 else ["staged"] * 2)


def test_groupnorm_kernels_on_a_large_mean(cuda):
    """x = 1000 + N(0, 1): the two-pass statistics hold the gate, where
    E[x^2] - mean^2 would not (tests/test_torch_gn_staged.py)."""
    assert _gn_case(cuda, 4, 587, 128, shift=1000.0, scale=1.0) == \
        ["staged"] * 2


def test_groupnorm_takes_misaligned_views(cuda):
    from ertdx_torch.ops import groupnorm as gn

    # the staged kernels read x and the upstream gradient with 16-byte
    # cp.async: the autograd path copies a misaligned one, the wrappers
    # refuse it
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn(2, 37, 32, generator=g, device=cuda)
    gamma = 1 + 0.3 * torch.randn(32, generator=g, device=cuda)
    beta = 0.3 * torch.randn(32, generator=g, device=cuda)
    dy = torch.randn(2, 37, 32, generator=g, device=cuda)
    leaves = [_misaligned(t).requires_grad_(True) for t in (x, gamma, beta)]
    gn.reset_launches()
    out = gn.groupnorm_silu(*leaves, 8)
    out.backward(_misaligned(dy))
    torch.cuda.synchronize()
    assert gn.launches == {"groupnorm_silu_fwd": 1, "groupnorm_silu_bwd": 1}
    _close(out, gn.reference_groupnorm_silu(x, gamma, beta, 8))
    for leaf, want in zip(leaves, gn.reference_groupnorm_silu_backward(
            x, gamma, beta, dy, 8)):
        _close(leaf.grad, want)
    with pytest.raises(ValueError, match="16-byte aligned"):
        gn.groupnorm_silu_fwd(_misaligned(x), gamma, beta, 8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        gn.groupnorm_silu_bwd(x, gamma, beta, _misaligned(dy), 8)


@pytest.mark.parametrize("b,l,c,cout", [
    (2, 37, 16, 16), (3, 61, 64, 72), (2, 1, 8, 4), (2, 2, 16, 8),
    (4, 147, 256, 256), (2, 294, 128, 256),
    # a 128-row tile over several batch rows; one row past a tile; K not a
    # multiple of the 32-channel stage (C=24, 8 groups of 3, the GN
    # backward's 4-byte units)
    (5, 1, 16, 16), (3, 37, 32, 16), (2, 129, 64, 64), (3, 20, 24, 16),
    # the GN backward streamed beside staged statistics; both streamed
    (1, 1900, 128, 64), (1, 4000, 128, 64)])
def test_conv_kernels_match_plain(cuda, b, l, c, cout):
    from ertdx_torch.ops import conv as cv

    g = torch.Generator(device=cuda).manual_seed(b * l + c + cout)
    x = torch.randn(b, l, c, generator=g, device=cuda)
    gamma = 1 + 0.3 * torch.randn(c, generator=g, device=cuda)
    beta = 0.3 * torch.randn(c, generator=g, device=cuda)
    w = torch.randn(3, c, cout, generator=g, device=cuda) / math.sqrt(3 * c)
    bias = torch.randn(cout, generator=g, device=cuda)
    dy = torch.randn(b, l, cout, generator=g, device=cuda)
    cv.reset_launches()
    got = cv.gn_silu_conv3_fwd(x, gamma, beta, w, bias, 8)
    dgot = cv.gn_silu_conv3_bwd(x, gamma, beta, w, dy, 8)
    torch.cuda.synchronize()
    assert cv.launches == {"gn_silu_conv3_fwd": 1, "gn_silu_conv3_bwd": 1}
    _close(got, cv.reference_gn_silu_conv3(x, gamma, beta, w, bias, 8))
    want = cv.reference_gn_silu_conv3_backward(x, gamma, beta, w, bias, dy,
                                               8)
    for a, wt in zip(dgot, want):
        assert a.shape == wt.shape
        _close(a, wt)
    assert torch.equal(got, cv.gn_silu_conv3_fwd(x, gamma, beta, w, bias, 8))
    again = cv.gn_silu_conv3_bwd(x, gamma, beta, w, dy, 8)
    assert all(torch.equal(a, wt) for a, wt in zip(dgot, again))


def test_gn_conv_kernels_refuse_what_they_do_not_take(cuda):
    from ertdx_torch.ops import conv as cv
    from ertdx_torch.ops import groupnorm as gn

    x = torch.randn(2, 9, 16, device=cuda)
    one = torch.ones(16, device=cuda)
    with pytest.raises(ValueError, match="not divisible"):
        gn.groupnorm_silu(torch.randn(2, 9, 12, device=cuda),
                          torch.ones(12, device=cuda),
                          torch.ones(12, device=cuda), 8)
    with pytest.raises(TypeError, match="float32"):
        gn.groupnorm_silu_fwd(x.double(), one.double(), one.double(), 8)
    with pytest.raises(ValueError, match="CUDA"):
        gn.groupnorm_silu_fwd(x, one.cpu(), one, 8)
    w = torch.randn(3, 16, 6, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        cv.gn_silu_conv3_fwd(x, one, one, w, torch.zeros(6, device=cuda), 8)
    with pytest.raises(ValueError, match="contiguous"):
        w = torch.randn(3, 8, 16, device=cuda).transpose(1, 2)
        cv.gn_silu_conv3_fwd(x, one, one, w, torch.zeros(8, device=cuda), 8)


def test_conv_kernels_take_misaligned_views(cuda):
    from ertdx_torch.ops import conv as cv

    # the GEMMs stage x, beta, w, bias and g with 16-byte cp.async: the
    # autograd path copies a misaligned operand, the wrappers refuse it
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(2, 37, 32, generator=g, device=cuda)
    gamma = 1 + 0.3 * torch.randn(32, generator=g, device=cuda)
    beta = 0.3 * torch.randn(32, generator=g, device=cuda)
    w = torch.randn(3, 32, 16, generator=g, device=cuda) / math.sqrt(96)
    bias = torch.randn(16, generator=g, device=cuda)
    dy = torch.randn(2, 37, 16, generator=g, device=cuda)
    leaves = [_misaligned(t).requires_grad_(True)
              for t in (x, gamma, beta, w, bias)]
    cv.reset_launches()
    out = cv.gn_silu_conv3(*leaves, 8)
    out.backward(_misaligned(dy))
    torch.cuda.synchronize()
    assert cv.launches == {"gn_silu_conv3_fwd": 1, "gn_silu_conv3_bwd": 1}
    _close(out, cv.reference_gn_silu_conv3(x, gamma, beta, w, bias, 8))
    for leaf, want in zip(leaves, cv.reference_gn_silu_conv3_backward(
            x, gamma, beta, w, bias, dy, 8)):
        _close(leaf.grad, want)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cv.gn_silu_conv3_fwd(_misaligned(x), gamma, beta, w, bias, 8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cv.gn_silu_conv3_bwd(x, gamma, beta, w, _misaligned(dy), 8)


def test_fused_encoder_trains_on_the_gn_kernels(cuda):
    """A small CondUNet with pallas_gn and pallas_conv_min_width: one train
    step launches each GN kernel twice (the stem's two GNSiLU) and each
    conv kernel four times (two fused ResBlocks), and agrees with the same
    step with every use_pallas off."""
    import copy

    from ertdx_torch import train
    from ertdx_torch.diffusion import get_diffusion_schedule
    from ertdx_torch.models.condunet import CondUNet, init_params
    from ertdx_torch.ops import conv as cv
    from ertdx_torch.ops import groupnorm as gn

    model = init_params(CondUNet(cond_channels=4, base_width=16, depth=2,
                                 num_heads=2, num_blocks=2, pallas_gn=True,
                                 pallas_conv_min_width=64),
                        torch.Generator().manual_seed(0)).to(cuda)
    plain = copy.deepcopy(model)
    for mod in plain.modules():
        if hasattr(mod, "use_pallas"):
            mod.use_pallas = False
    g = torch.Generator(device=cuda).manual_seed(1)
    x0 = torch.randn(8, 29, generator=g, device=cuda)
    cond = torch.randn(8, 96, 4, generator=g, device=cuda)
    t = torch.randint(0, 50, (8,), generator=g, device=cuda)
    noise = torch.randn(8, 29, generator=g, device=cuda)
    ab = get_diffusion_schedule(50).alpha_bar
    gn.reset_launches()
    cv.reset_launches()
    losses = [train.train_step(m, train.create_optimizer(m, 1e-4), x0, cond,
                               t, noise, alpha_bar=ab, lr=1e-4)
              for m in (model, plain)]
    torch.cuda.synchronize()
    assert gn.launches == {"groupnorm_silu_fwd": 2, "groupnorm_silu_bwd": 2}
    assert cv.launches == {"gn_silu_conv3_fwd": 4, "gn_silu_conv3_bwd": 4}
    assert abs(float(losses[0]) - float(losses[1])) <= 1e-5 * max(
        1.0, float(losses[1]))
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 plain.named_parameters()):
        _close(a.grad, b.grad)


# (B, H, L, Dh, valid keys, rows with every key masked): the encoder's
# flash shape (147 of 256 keys valid), the length gate's, Dh 128 and 256,
# and batch rows whose keys are all masked (the last at the flash arm's
# head width, beside a live row whose last key tiles are all padding)
FLASH_CASES = [(256, 4, 256, 64, 147, ()), (8, 4, 1024, 64, 1024, ()),
               (2, 2, 256, 128, 200, ()), (2, 2, 256, 256, 256, ()),
               (3, 2, 128, 64, 100, (1,)), (2, 1, 256, 256, 147, (0,)),
               (2, 4, 256, 64, 147, (1,))]


def _flash_inputs(dev, b, h, l, d, valid, dead, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, l, d, generator=g, device=dev)
                   for _ in range(4))
    mask = torch.zeros(b, l, device=dev)
    mask[:, :valid] = 1.0
    for row in dead:
        mask[row] = 0.0
    return q, k, v, do, mask


@pytest.mark.parametrize("b,h,l,d,valid,dead", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, b, h, l, d, valid, dead):
    from ertdx_torch.ops import attention as at

    q, k, v, do, mask = _flash_inputs(cuda, b, h, l, d, valid, dead,
                                      b * l + d)
    at.reset_launches()
    out, lse = at.flash_attention_fwd(q, k, v, mask)
    grads = at.flash_attention_bwd(q, k, v, mask, out, lse, do)
    torch.cuda.synchronize()
    assert at.launches == {"flash_attention_fwd": 1,
                           "flash_attention_bwd_dq": 1,
                           "flash_attention_bwd_dkv": 1}
    want, want_lse = at.reference_flash_forward(q, k, v, mask)
    _close(out, want)
    _close(out, at.reference_attention(q, k, v, mask))
    live = mask.amax(dim=1) > 0
    _close(lse[live], want_lse[live])
    assert (lse[~live] == -1e30).all()
    for a, w in zip(grads, at.reference_flash_backward(q, k, v, mask, want,
                                                       want_lse, do)):
        _close(a, w)
    again = at.flash_attention_bwd(q, k, v, mask, out, lse, do)
    assert all(torch.equal(a, w) for a, w in zip(grads, again))
    out2, lse2 = at.flash_attention_fwd(q, k, v, mask)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    # key rows that are all padding in a live batch row: the backward
    # skips them, and their dK and dV are exactly 0 (as p = 0 there)
    pad = (mask.reshape(b, l // 16, 16).amax(dim=2) <= 0) & live[:, None]
    pad = pad.repeat_interleave(16, dim=1)
    for grad in grads[1:]:
        assert (grad.permute(0, 2, 1, 3)[pad] == 0).all()
    if dead:      # the dead rows keep every tile: p = 1 there, as plain
        dq, dk, dv = grads
        wq, wk, wv = at.reference_flash_backward(q, k, v, mask, want,
                                                 want_lse, do)
        for a, w in ((dq, wq), (dk, wk), (dv, wv)):
            _close(a[~live], w[~live])
            assert float(w[~live].abs().max()) > 0


def test_flash_attention_autograd_on_the_kernels(cuda):
    from ertdx_torch.ops import attention as at

    q, k, v, do, mask = _flash_inputs(cuda, 4, 4, 256, 64, 147, (), 3)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    at.reset_launches()
    out = at.flash_attention(*leaves, mask)
    out.backward(do)
    torch.cuda.synchronize()
    assert at.launches == {"flash_attention_fwd": 1,
                           "flash_attention_bwd_dq": 1,
                           "flash_attention_bwd_dkv": 1}
    want, lse = at.reference_flash_forward(q, k, v, mask)
    _close(out.detach(), want)
    for leaf, w in zip(leaves, at.reference_flash_backward(q, k, v, mask,
                                                           want, lse, do)):
        _close(leaf.grad, w)


def _misaligned(t):
    """t's values in a contiguous view that starts 4 bytes past a 16-byte
    boundary of its storage."""
    view = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)[1:]
    view = view.view(t.shape).copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def test_attention_backwards_take_misaligned_views(cuda):
    from ertdx_torch.ops import attention as at
    from ertdx_torch.ops import slab_attn as sa

    # the backward kernels stage with 16-byte cp.async: the autograd paths
    # copy a misaligned operand, the kernel wrappers refuse it by name
    g = torch.Generator(device=cuda).manual_seed(11)
    qkv = torch.randn(2, 147, 3 * 256, generator=g, device=cuda)
    do = torch.randn(2, 147, 256, generator=g, device=cuda)
    sa.reset_launches()
    z = _misaligned(qkv).requires_grad_(True)
    sa.slab_attention(z, 4).backward(_misaligned(do))
    torch.cuda.synchronize()
    assert sa.launches == {"slab_attention_fwd": 1, "slab_attention_bwd": 1}
    _close(z.grad, sa.reference_slab_attention_backward(qkv, do, 4))
    with pytest.raises(ValueError, match="16-byte aligned"):
        sa.slab_attention_bwd(_misaligned(qkv), do, 4)

    q, k, v, do, mask = _flash_inputs(cuda, 2, 4, 256, 64, 147, (), 5)
    leaves = [_misaligned(t).requires_grad_(True) for t in (q, k, v)]
    at.reset_launches()
    at.flash_attention(*leaves, _misaligned(mask)).backward(_misaligned(do))
    torch.cuda.synchronize()
    assert at.launches == {"flash_attention_fwd": 1,
                           "flash_attention_bwd_dq": 1,
                           "flash_attention_bwd_dkv": 1}
    want, lse = at.reference_flash_forward(q, k, v, mask)
    for leaf, w in zip(leaves, at.reference_flash_backward(q, k, v, mask,
                                                           want, lse, do)):
        _close(leaf.grad, w)
    out, lse = at.flash_attention_fwd(q, k, v, mask)
    with pytest.raises(ValueError, match="16-byte aligned"):
        at.flash_attention_bwd_dq(q, k, v, mask, out, lse, _misaligned(do))
    dq, delta = at.flash_attention_bwd_dq(q, k, v, mask, out, lse, do)
    with pytest.raises(ValueError, match="16-byte aligned"):
        at.flash_attention_bwd_dkv(q, _misaligned(k), v, mask, lse, delta,
                                   do)


def test_attention_forwards_take_misaligned_views(cuda):
    from ertdx_torch.ops import attention as at
    from ertdx_torch.ops import slab_attn as sa

    # the forward kernels stage with 16-byte cp.async too: the kernel
    # wrappers refuse a misaligned operand by name, the autograd paths
    # copy it
    g = torch.Generator(device=cuda).manual_seed(12)
    qkv = torch.randn(2, 147, 3 * 256, generator=g, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        sa.slab_attention_fwd(_misaligned(qkv), 4)
    sa.reset_launches()
    with torch.no_grad():
        out = sa.slab_attention(_misaligned(qkv), 4)
    torch.cuda.synchronize()
    assert sa.launches["slab_attention_fwd"] == 1
    _close(out, sa.reference_slab_attention(qkv, 4))

    q, k, v, _, mask = _flash_inputs(cuda, 2, 4, 256, 64, 147, (1,), 6)
    for i in range(4):
        args = [q, k, v, mask]
        args[i] = _misaligned(args[i])
        with pytest.raises(ValueError, match="16-byte aligned"):
            at.flash_attention_fwd(*args)
    at.reset_launches()
    with torch.no_grad():
        out = at.flash_attention(*map(_misaligned, (q, k, v, mask)))
    torch.cuda.synchronize()
    assert at.launches["flash_attention_fwd"] == 1
    _close(out, at.reference_flash_forward(q, k, v, mask)[0])


def test_flash_gate_false_runs_the_plain_version(cuda):
    from ertdx_torch.ops import attention as at

    at.reset_launches()
    q = torch.randn(2, 2, 147, 64, device=cuda)        # L % 128 != 0
    at._warned.discard((147, 147, 64))
    with pytest.warns(UserWarning, match="not a shape the CUDA kernels"):
        out = at.flash_attention(q, q, q)
    off = at.flash_attention(torch.randn(1, 1, 128, 64, device=cuda),
                             torch.randn(1, 1, 128, 64, device=cuda),
                             torch.randn(1, 1, 128, 64, device=cuda),
                             use_pallas=False)
    assert sum(at.launches.values()) == 0
    assert torch.allclose(out, at.reference_attention(q, q, q))
    assert off.shape == (1, 1, 128, 64)
    with pytest.raises(ValueError, match="do not take"):
        at.flash_attention_fwd(q, q, q)
    with pytest.raises(TypeError, match="float32"):
        x = torch.randn(1, 1, 128, 64, device=cuda, dtype=torch.float64)
        at.flash_attention_fwd(x, x, x)


def test_flash_arm_trains_on_the_flash_kernels(cuda):
    """A small CondUNet with attn_flash_min_logits=1: one train step
    launches the flash forward, dQ and dK/dV once each and agrees with the
    same step with use_pallas off, which launches none of the encoder's
    attention kernels (slab included, though attn_slab is on there)."""
    import copy

    from ertdx_torch import train
    from ertdx_torch.diffusion import get_diffusion_schedule
    from ertdx_torch.models.condunet import CondUNet, init_params
    from ertdx_torch.ops import attention as at
    from ertdx_torch.ops import slab_attn as sa

    # one encoder head of width 64: a width the kernels take
    model = init_params(CondUNet(cond_channels=4, base_width=16, depth=2,
                                 num_heads=1, num_blocks=2,
                                 flash_min_logits=1),
                        torch.Generator().manual_seed(0)).to(cuda)
    plain = copy.deepcopy(model)
    plain.encoder.attn.use_pallas = False
    plain.encoder.attn.slab = True
    g = torch.Generator(device=cuda).manual_seed(1)
    x0 = torch.randn(8, 29, generator=g, device=cuda)
    cond = torch.randn(8, 96, 4, generator=g, device=cuda)
    t = torch.randint(0, 50, (8,), generator=g, device=cuda)
    noise = torch.randn(8, 29, generator=g, device=cuda)
    ab = get_diffusion_schedule(50).alpha_bar
    losses, counts = [], []
    for m in (model, plain):
        at.reset_launches()
        sa.reset_launches()
        losses.append(train.train_step(m, train.create_optimizer(m, 1e-4),
                                       x0, cond, t, noise, alpha_bar=ab,
                                       lr=1e-4))
        torch.cuda.synchronize()
        counts.append({**at.launches, **sa.launches})
    assert counts[0] == {"flash_attention_fwd": 1,
                         "flash_attention_bwd_dq": 1,
                         "flash_attention_bwd_dkv": 1,
                         "slab_attention_fwd": 0, "slab_attention_bwd": 0}
    assert sum(counts[1].values()) == 0
    assert abs(float(losses[0]) - float(losses[1])) <= 1e-5 * max(
        1.0, float(losses[1]))
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 plain.named_parameters()):
        _close(a.grad, b.grad)


def test_flash_gate_on_a_head_width_the_kernels_refuse_warns(cuda):
    """An encoder whose flash gate holds at a head width the kernels do
    not take (2 heads of 16) runs the plain version on the card, as JAX
    does, launches nothing and says so."""
    from ertdx_torch.models.condunet import SelfAttention1D
    from ertdx_torch.ops import attention as at

    attn = SelfAttention1D(32, 2, flash_min_logits=1).to(cuda)
    x = torch.randn(2, 147, 32, device=cuda)
    at.reset_launches()
    at._warned.discard((256, 256, 16))
    with pytest.warns(UserWarning, match="Dh=16"):
        got = attn(x)
    torch.cuda.synchronize()
    assert sum(at.launches.values()) == 0
    attn.use_pallas = False
    _close(got.detach(), attn(x).detach())


@pytest.mark.parametrize("masked", [False, True])
def test_flash_cross_attention_on_the_kernels(cuda, masked):
    """Dh=40 pads to 64 with q rescaled, Lq=1100 and Lk=147 pad to 1152 and
    256: one forward launch, the plain attention's values."""
    from ertdx_torch.ops import attention as at

    g = torch.Generator(device=cuda).manual_seed(7 + masked)
    q = torch.randn(2, 2, 1100, 40, generator=g, device=cuda)
    k, v = (torch.randn(2, 2, 147, 40, generator=g, device=cuda)
            for _ in range(2))
    mask = None
    if masked:
        mask = torch.ones(2, 147, device=cuda)
        mask[0, 100:] = 0.0
    at.reset_launches()
    got = at.flash_cross_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert at.launches["flash_attention_fwd"] == 1
    assert got.shape == q.shape
    _close(got, at.reference_attention(q, k, v, mask))


# (B, L, C, heads) of the bf16 slab kernels: the encoder's stage with a
# ragged last tile, dh=32, a single token, two key chunks (L > 160), the
# longest L, and 1200 heads, more than one a block on 132 SMs (the
# persistent blocks' ragged last wave)
SLAB_BF16_CASES = [(3, 147, 256, 4), (2, 65, 256, 8), (2, 1, 64, 1),
                   (2, 200, 128, 2), (1, 256, 128, 2), (300, 147, 256, 4)]


def _bf16_gate(got, want32, plain_bf16):
    """The bf16 kernels against the plain version in float32 from the
    same bf16 inputs: within twice the bf16 plain version's own error, or
    8e-3 x max(1, max|plain|) (a few bf16 roundings of the output)."""
    err = float((got.float() - want32).abs().max())
    own = float((plain_bf16.float() - want32).abs().max())
    tol = max(2 * own, 8e-3 * max(1.0, float(want32.abs().max())))
    assert err <= tol, (err, own, tol)


@pytest.mark.parametrize("b,l,c,nh", SLAB_BF16_CASES)
def test_slab_bf16_kernels_match_plain(cuda, b, l, c, nh):
    from ertdx_torch.ops import slab_attn as sa

    g = torch.Generator(device=cuda).manual_seed(b * 100 + l + 7)
    qkv = torch.randn(b, l, 3 * c, generator=g, device=cuda).bfloat16()
    do = torch.randn(b, l, c, generator=g, device=cuda).bfloat16()
    sa.reset_launches()
    z = qkv.clone().requires_grad_(True)
    out = sa.slab_attention(z, nh)
    out.backward(do)
    torch.cuda.synchronize()
    assert sa.launches == {"slab_attention_fwd": 0, "slab_attention_bwd": 0}
    assert sa.launches_bf16 == {"slab_attention_fwd_bf16": 1,
                                "slab_attention_bwd_bf16": 1}
    assert out.dtype == z.grad.dtype == torch.bfloat16
    _bf16_gate(out.detach(), sa.reference_slab_attention(qkv.float(), nh),
               sa.reference_slab_attention(qkv, nh))
    _bf16_gate(z.grad, sa.reference_slab_attention_backward(
        qkv.float(), do.float(), nh),
        sa.reference_slab_attention_backward(qkv, do, nh))
    # no atomics: reruns are bit-identical
    assert torch.equal(sa.slab_attention_fwd_bf16(qkv, nh), out.detach())
    assert torch.equal(sa.slab_attention_bwd_bf16(qkv, do, nh), z.grad)


def test_slab_bf16_backward_allocates_only_dqkv(cuda):
    """One launch that keeps lse and delta in shared memory: the peak
    memory of a backward call is dQKV's bytes (the float32 kernels' (2,
    B, H, L) scratch would add 301 KB here)."""
    from ertdx_torch.ops import slab_attn as sa

    g = torch.Generator(device=cuda).manual_seed(11)
    qkv = torch.randn(64, 147, 3 * 256, generator=g, device=cuda).bfloat16()
    do = torch.randn(64, 147, 256, generator=g, device=cuda).bfloat16()
    sa.slab_attention_bwd_bf16(qkv, do, 4)        # the build, the caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    sa.reset_launches()
    dqkv = sa.slab_attention_bwd_bf16(qkv, do, 4)
    torch.cuda.synchronize()
    assert sa.launches_bf16["slab_attention_bwd_bf16"] == 1
    peak = torch.cuda.max_memory_allocated() - before
    assert peak <= dqkv.numel() * dqkv.element_size() + 4096, peak


def test_slab_bf16_accurate_runs_the_float32_kernels(cuda):
    from ertdx_torch.ops import slab_attn as sa

    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn(2, 147, 3 * 256, generator=g, device=cuda).bfloat16()
    do = torch.randn(2, 147, 256, generator=g, device=cuda).bfloat16()
    sa.reset_launches()
    z = qkv.clone().requires_grad_(True)
    out = sa.slab_attention(z, 4, accurate=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert sa.launches == {"slab_attention_fwd": 1, "slab_attention_bwd": 1}
    assert sa.launches_bf16 == {"slab_attention_fwd_bf16": 0,
                                "slab_attention_bwd_bf16": 0}
    assert out.dtype == z.grad.dtype == torch.bfloat16
    # fp32-class, rounded to bf16 once: within one bf16 ulp (2^-8 of the
    # largest value) of the float32 plain version
    for got, want in ((out.detach(), sa.reference_slab_attention(
            qkv.float(), 4)), (z.grad, sa.reference_slab_attention_backward(
            qkv.float(), do.float(), 4))):
        scale = float(want.abs().max())
        assert float((got.float() - want).abs().max()) <= \
            2.0 ** (math.floor(math.log2(scale)) - 7)


def test_slab_bf16_kernels_refuse_what_they_do_not_take(cuda):
    from ertdx_torch.ops import slab_attn as sa

    qkv = torch.randn(2, 147, 3 * 256, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        sa.slab_attention_fwd_bf16(qkv, 4)
    with pytest.raises(TypeError, match="bfloat16"):
        sa.slab_attention_bwd_bf16(qkv.bfloat16(), qkv[..., :256], 4)
    # 2 bytes past a 16-byte boundary: the kernels stage with cp.async
    view = torch.empty(qkv.numel() + 1, device=cuda,
                       dtype=torch.bfloat16)[1:].view(qkv.shape)
    view.copy_(qkv)
    with pytest.raises(ValueError, match="16-byte aligned"):
        sa.slab_attention_fwd_bf16(view, 4)
    # the autograd path copies a misaligned slab
    sa.reset_launches()
    z = view.detach().requires_grad_(True)
    sa.slab_attention(z, 4).sum().backward()
    torch.cuda.synchronize()
    assert sa.launches_bf16 == {"slab_attention_fwd_bf16": 1,
                                "slab_attention_bwd_bf16": 1}


def test_bf16_model_trains_on_the_slab_bf16_kernels(cuda):
    """A small bf16 CondUNet (the slab on, use_pallas on) takes one train
    step on the bf16 kernels, one launch each way, and its loss is within
    1e-2 of the same step on the plain bf16 slab (bf16 roundings at other
    places)."""
    import copy
    import dataclasses

    from ertdx_torch import configs, train
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.models import build_model
    from ertdx_torch.ops import slab_attn as sa

    mcfg = dataclasses.replace(configs.V5E8_DP.model, hidden_dim=32,
                               base_width=32, depth=2, num_blocks=1,
                               cond_length=1176, cond_channels=4)
    model = build_model(mcfg, device=cuda)
    plain = copy.deepcopy(model)
    plain.encoder.attn.use_pallas = False
    g = torch.Generator(device=cuda).manual_seed(3)
    x0 = torch.randn(8, 29, generator=g, device=cuda)
    cond = torch.rand(8, 1176, 4, generator=g, device=cuda)
    t = torch.randint(0, 500, (8,), generator=g, device=cuda)
    noise = torch.randn(8, 29, generator=g, device=cuda)
    alpha_bar = schedule_from_config(configs.DiffusionConfig()).alpha_bar
    losses = []
    for m in (model, plain):
        sa.reset_launches()
        losses.append(float(train.train_step(
            m, train.create_optimizer(m, 1e-4), x0, cond, t, noise,
            alpha_bar=alpha_bar, lr=1e-4)))
        torch.cuda.synchronize()
        if m is model:
            assert sa.launches_bf16 == {"slab_attention_fwd_bf16": 1,
                                        "slab_attention_bwd_bf16": 1}
    assert sa.launches_bf16 == {"slab_attention_fwd_bf16": 0,
                                "slab_attention_bwd_bf16": 0}
    assert all(math.isfinite(v) for v in losses)
    assert abs(losses[0] - losses[1]) <= 1e-2 * max(1.0, abs(losses[1]))


# bf16 GroupNorm+SiLU: 16-byte units of 8 values (cg 16, 32), one-value
# units (cg = 9), the stem, the condition's length (the forward staged
# in bf16, the backward streamed), and a large mean
GN_BF16_CASES = [(2, 37, 128, 0.5), (3, 61, 72, 0.5), (4, 587, 128, 0.5),
                 (2, 294, 256, 0.5), (2, 4693, 128, 0.5),
                 (4, 587, 128, 1000.0)]


@pytest.mark.parametrize("b,l,c,shift", GN_BF16_CASES)
def test_groupnorm_bf16_kernels_match_plain(cuda, b, l, c, shift):
    from ertdx_torch.ops import groupnorm as gn

    g = torch.Generator(device=cuda).manual_seed(b * l + c + 16)
    scale = 1.0 if shift > 100 else 2.0
    x = (scale * torch.randn(b, l, c, generator=g, device=cuda)
         + shift).bfloat16()
    gamma = 1 + 0.3 * torch.randn(c, generator=g, device=cuda)
    beta = 0.3 * torch.randn(c, generator=g, device=cuda)
    dy = torch.randn(b, l, c, generator=g, device=cuda).bfloat16()
    gn.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
    out = gn.groupnorm_silu(*leaves, 8)
    out.backward(dy)
    torch.cuda.synchronize()
    assert gn.launches == {"groupnorm_silu_fwd": 0, "groupnorm_silu_bwd": 0}
    assert gn.launches_bf16 == {"groupnorm_silu_fwd_bf16": 1,
                                "groupnorm_silu_bwd_bf16": 1}
    assert out.dtype == leaves[0].grad.dtype == torch.bfloat16
    assert leaves[1].grad.dtype == leaves[2].grad.dtype == torch.float32
    _bf16_gate(out.detach(), gn.reference_groupnorm_silu(
        x.float(), gamma, beta, 8), gn.reference_groupnorm_silu(
        x, gamma, beta, 8))
    want = gn.reference_groupnorm_silu_backward(x.float(), gamma, beta,
                                                dy.float(), 8)
    plain = gn.reference_groupnorm_silu_backward(x, gamma, beta, dy, 8)
    for leaf, w, p in zip(leaves, want, plain):
        _bf16_gate(leaf.grad, w, p)
    assert torch.equal(gn.groupnorm_silu_fwd(x, gamma, beta, 8),
                       out.detach())
    again = gn.groupnorm_silu_bwd(x, gamma, beta, dy, 8)
    assert all(torch.equal(a, leaf.grad) for a, leaf in zip(again, leaves))


# bf16 fused conv: the encoder's widths, a tile over several batch rows,
# one row past a tile, K not a multiple of the 32-channel stage (C = 72,
# cg = 9: one-value GN units), the GN backward streamed
CONV_BF16_CASES = [(2, 37, 16, 16), (3, 61, 64, 72), (4, 147, 256, 256),
                   (2, 294, 128, 256), (5, 1, 16, 16), (2, 129, 64, 64),
                   (3, 20, 72, 16), (1, 1900, 128, 64),
                   # Cout not a multiple of the wgmma's 64 with L below
                   # the 128-row tile; Cout over one 256-wide column
                   # block; C over 256 with a ragged 256-wide block
                   (3, 5, 64, 72), (1, 70, 64, 320), (2, 33, 320, 136)]


@pytest.mark.parametrize("b,l,c,cout", CONV_BF16_CASES)
def test_conv_bf16_kernels_match_plain(cuda, b, l, c, cout):
    from ertdx_torch.ops import conv as cv

    g = torch.Generator(device=cuda).manual_seed(b * l + c + cout + 16)
    x = torch.randn(b, l, c, generator=g, device=cuda).bfloat16()
    gamma = 1 + 0.3 * torch.randn(c, generator=g, device=cuda)
    beta = 0.3 * torch.randn(c, generator=g, device=cuda)
    w = torch.randn(3, c, cout, generator=g, device=cuda) / math.sqrt(3 * c)
    bias = torch.randn(cout, generator=g, device=cuda)
    dy = torch.randn(b, l, cout, generator=g, device=cuda).bfloat16()
    cv.reset_launches()
    leaves = [t.clone().requires_grad_(True)
              for t in (x, gamma, beta, w, bias)]
    out = cv.gn_silu_conv3(*leaves, 8)
    out.backward(dy)
    torch.cuda.synchronize()
    assert cv.launches == {"gn_silu_conv3_fwd": 0, "gn_silu_conv3_bwd": 0}
    assert cv.launches_bf16 == {"gn_silu_conv3_fwd_bf16": 1,
                                "gn_silu_conv3_bwd_bf16": 1}
    assert out.dtype == leaves[0].grad.dtype == torch.bfloat16
    assert all(leaf.grad.dtype == torch.float32 for leaf in leaves[1:])
    ins = (x, gamma, beta, w, bias)
    _bf16_gate(out.detach(), cv.reference_gn_silu_conv3(
        x.float(), *ins[1:], 8), cv.reference_gn_silu_conv3(*ins, 8))
    want = cv.reference_gn_silu_conv3_backward(x.float(), *ins[1:],
                                               dy.float(), 8)
    plain = cv.reference_gn_silu_conv3_backward(*ins, dy, 8)
    for leaf, wt, p in zip(leaves, want, plain):
        assert leaf.grad.shape == wt.shape
        _bf16_gate(leaf.grad, wt, p)
    assert torch.equal(cv.gn_silu_conv3_fwd(*ins, 8), out.detach())
    again = cv.gn_silu_conv3_bwd(x, gamma, beta, w, dy, 8)
    assert all(torch.equal(a, leaf.grad) for a, leaf in zip(again, leaves))


def test_gn_conv_bf16_kernels_refuse_what_they_do_not_take(cuda):
    from ertdx_torch.ops import conv as cv
    from ertdx_torch.ops import groupnorm as gn

    x = torch.randn(2, 9, 16, device=cuda).bfloat16()
    one = torch.ones(16, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        gn.groupnorm_silu_bwd(x, one, one, torch.ones(2, 9, 16,
                                                      device=cuda), 8)
    with pytest.raises(TypeError, match="float32"):
        gn.groupnorm_silu_fwd(x, one.bfloat16(), one, 8)
    w = torch.randn(3, 16, 12, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        cv.gn_silu_conv3_fwd(x, one, one, w, torch.zeros(12, device=cuda),
                             8)


@pytest.mark.parametrize("b,h,l,d,valid", [(4, 4, 256, 64, 147),
                                           (2, 2, 128, 128, 100)])
def test_flash_attention_on_bf16_operands(cuda, b, h, l, d, valid):
    """bf16 q, k, v run the float32 kernels on upcast copies (JAX's flash
    kernels compute in float32 from any input dtype): one forward, dQ and
    dK/dV launch; the output rounded to bf16 once from the float32 plain
    version's value; delta from the rounded output; the gradients in
    bf16."""
    from ertdx_torch.ops import attention as at

    g = torch.Generator(device=cuda).manual_seed(b + l + d)
    q, k, v = (torch.randn(b, h, l, d, generator=g, device=cuda).bfloat16()
               for _ in range(3))
    mask = (torch.arange(l, device=cuda) < valid).bfloat16().expand(b, l)
    do = torch.randn(b, h, l, d, generator=g, device=cuda).bfloat16()
    at.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = at.flash_attention(*leaves, mask)
    out.backward(do)
    torch.cuda.synchronize()
    assert at.launches == {"flash_attention_fwd": 1,
                           "flash_attention_bwd_dq": 1,
                           "flash_attention_bwd_dkv": 1}
    assert out.dtype == torch.bfloat16
    assert all(leaf.grad.dtype == torch.bfloat16 for leaf in leaves)
    q32, k32, v32, m32 = (t.float() for t in (q, k, v, mask))
    want = at.reference_attention(q32, k32, v32, m32)
    scale = float(want.abs().max())
    assert float((out.detach().float() - want).abs().max()) <= \
        2.0 ** (math.floor(math.log2(scale)) - 8) + 1e-4 * scale
    _, lse = at.reference_flash_forward(q32, k32, v32, m32)
    dwant = at.reference_flash_backward(q32, k32, v32, m32,
                                        out.detach().float(), lse,
                                        do.float())
    for leaf, wt in zip(leaves, dwant):
        top = float(wt.abs().max())
        assert float((leaf.grad.float() - wt).abs().max()) <= \
            2.0 ** (math.floor(math.log2(top)) - 8) + 1e-4 * max(1.0, top)


def test_bf16_fused_arm_trains_on_the_bf16_gn_and_conv_kernels(cuda):
    """A small bf16 CondUNet with pallas_gn and pallas_conv_min_width = 64
    takes one train step on the bf16 GN and fused-conv kernels (the stem
    ResBlock's two GN pairs, the 64-wide ResBlocks' fused pairs), none of
    the float32 ones, and its loss is within 1e-2 of the same step with
    every kernel off."""
    import copy
    import dataclasses

    from ertdx_torch import configs, train
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.models import build_model
    from ertdx_torch.ops import conv as cv
    from ertdx_torch.ops import groupnorm as gn

    mcfg = dataclasses.replace(configs.V5E8_DP.model, hidden_dim=32,
                               base_width=16, depth=2, num_blocks=1,
                               cond_length=1176, cond_channels=4,
                               pallas_gn=True, pallas_conv_min_width=64)
    model = build_model(mcfg, device=cuda)
    plain = copy.deepcopy(model)
    for mod in plain.modules():
        if hasattr(mod, "use_pallas"):
            mod.use_pallas = False
    g = torch.Generator(device=cuda).manual_seed(4)
    x0 = torch.randn(8, 29, generator=g, device=cuda)
    cond = torch.rand(8, 1176, 4, generator=g, device=cuda)
    t = torch.randint(0, 500, (8,), generator=g, device=cuda)
    noise = torch.randn(8, 29, generator=g, device=cuda)
    alpha_bar = schedule_from_config(configs.DiffusionConfig()).alpha_bar
    losses = []
    for m in (model, plain):
        gn.reset_launches()
        cv.reset_launches()
        losses.append(float(train.train_step(
            m, train.create_optimizer(m, 1e-4), x0, cond, t, noise,
            alpha_bar=alpha_bar, lr=1e-4)))
        torch.cuda.synchronize()
        if m is model:
            assert gn.launches_bf16 == {"groupnorm_silu_fwd_bf16": 2,
                                        "groupnorm_silu_bwd_bf16": 2}
            assert cv.launches_bf16 == {"gn_silu_conv3_fwd_bf16": 4,
                                        "gn_silu_conv3_bwd_bf16": 4}
            assert gn.launches == {"groupnorm_silu_fwd": 0,
                                   "groupnorm_silu_bwd": 0}
            assert cv.launches == {"gn_silu_conv3_fwd": 0,
                                   "gn_silu_conv3_bwd": 0}
    assert all(math.isfinite(v) for v in losses)
    assert abs(losses[0] - losses[1]) <= 1e-2 * max(1.0, abs(losses[1]))
