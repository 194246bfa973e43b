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
    return torch.device("cuda")


def _inputs(dev, b, r, nb, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    s = 1.0 / math.sqrt(D)
    ws = {"wqkv": rnd(nb, D, 3 * D, scale=s), "wso": rnd(nb, D, D, scale=s),
          "bso": rnd(nb, D, scale=0.1), "wcq": rnd(nb, D, D, scale=s),
          "wco": rnd(nb, D, D, scale=s), "bco": rnd(nb, D, scale=0.1),
          "w1": rnd(nb, D, 4 * D, scale=s), "b1": rnd(nb, 4 * D, scale=0.1),
          "w2": rnd(nb, 4 * D, D, scale=s), "b2": rnd(nb, D, scale=0.1)}
    return ws, rnd(b, 6 * nb, D, scale=0.3), rnd(b * nb, LK, D), \
        rnd(b * nb, LK, D), rnd


@pytest.mark.parametrize("r", [10, 33, 64])    # ragged last tile at 33
def test_stack_kernel_matches_plain(cuda, r):
    b, nb = 3, 2
    ws, mods, k, v, rnd = _inputs(cuda, b, r, nb)
    args = (rnd(b, r, P), mods, k, v, ws, rnd(1, D), rnd(1, D), rnd(P, D),
            1 + rnd(1, D, scale=0.1), rnd(1, D), rnd(D, 1, scale=0.1),
            rnd(1, 1))
    before = cb.launches["fused_core_stack"]
    got = cb.fused_core_stack(*args, p=P, chunk=r)
    torch.cuda.synchronize()
    assert cb.launches["fused_core_stack"] == before + 1
    want = cb.fused_core_stack_plain(*args, p=P)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("r", [10, 33])
def test_block_kernel_matches_plain(cuda, r):
    b = 2
    ws, mods, k, v, rnd = _inputs(cuda, b, r, 1, seed=1)
    w = {key: val[0].contiguous() for key, val in ws.items()}
    x3 = rnd(b, r * P, D)
    got = cb.fused_core_block(x3, mods, k, v, w, p=P, chunk=r)
    torch.cuda.synchronize()
    want = cb.fused_core_block_plain(x3, mods, k, v, w, p=P)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


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
