"""The fused-core kernels' plain versions against the JAX kernels.

The port's `mega_denoise_ensemble` on CPU tensors runs the plain PyTorch
versions of fused_core_stack / fused_core_block; the JAX package's runs
its Pallas kernels in interpret mode. Same perturbed weights, same
inputs, tolerance 2e-5 as tests/test_ops.py's mega parity. Both sides run
accurate=True, JAX's bf16_3x: JAX's kernels under
tests/torch_core_common.py's patch, which rounds the lo parts as the
TPU's passes do (on the CPU they compute in float32 whatever their
mode); tests/test_torch_core_onepass.py holds the one-pass mode and
tests/test_torch_core_bf16x3.py this one at full width.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx.models.mega import mega_denoise_ensemble as jax_mega
from ertdx_torch.models import mega
from ertdx_torch.ops import core_block as cb
from torch_core_common import jax_accurate
from torch_parity_common import make_pair, t32

B = 2


def _inputs(n_real, seed=3):
    fm, params, tm = make_pair(d=32, num_blocks=2)
    rng = np.random.default_rng(seed)
    cond = rng.normal(size=(B, 96, 4)).astype(np.float32)
    x = rng.normal(size=(B * n_real, 29)).astype(np.float32)
    t = np.full((B * n_real,), 7, np.int32)     # samplers share one t
    ctx = fm.apply({"params": params}, jnp.asarray(cond),
                   method=fm.encode_condition)
    return fm, params, tm, x, t, ctx


@pytest.mark.parametrize("stack", [True, False])
@pytest.mark.parametrize("n_real", [8, 10])     # 8-chain tile, single tile
def test_plain_core_matches_jax_interpret(n_real, stack):
    _, params, tm, x, t, ctx = _inputs(n_real)
    with jax_accurate():
        want = np.asarray(jax_mega(
            params, jnp.asarray(x), jnp.asarray(t), ctx, n_real, p=29, d=32,
            num_blocks=2, chunk=n_real, accurate=True, stack=stack,
            interpret=True))
    cb.reset_launches()
    with torch.no_grad():
        got = mega.mega_denoise_ensemble(
            tm, t32(x), torch.from_numpy(t).long(),
            tuple(t32(a) for a in ctx), n_real, p=29, d=32, num_blocks=2,
            chunk=n_real, accurate=True, stack=stack)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert cb.launches == {"fused_core_stack": 0, "fused_core_block": 0}


def test_mega_matches_module_path():
    """The fused-core path equals CondUNet.denoise_ensemble (CPU); at
    these widths bf16_3x stays within 2e-5 of the float32 module path."""
    n_real = 6
    _, _, tm, x, t, ctx = _inputs(n_real, seed=5)
    tctx = tuple(t32(a) for a in ctx)
    tt = torch.from_numpy(t).long()
    with torch.no_grad():
        ref = tm.denoise_ensemble(t32(x), tt, tctx, n_real)
        for stack in (True, False):
            got = mega.mega_denoise_ensemble(
                tm, t32(x), tt, tctx, n_real, p=29, d=32, num_blocks=2,
                chunk=n_real, accurate=True, stack=stack)
            np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                       rtol=2e-5, atol=2e-5)


def test_plain_stack_equals_blocks():
    """The plain stack is lift -> nb plain blocks -> norm -> head."""
    rng = np.random.default_rng(0)
    b, r, p, d, nb, lk = 2, 3, 5, 8, 2, 7
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    ws = {"wqkv": f(nb, d, 3 * d), "wso": f(nb, d, d), "bso": f(nb, d),
          "wcq": f(nb, d, d), "wco": f(nb, d, d), "bco": f(nb, d),
          "w1": f(nb, d, 4 * d), "b1": f(nb, 4 * d), "w2": f(nb, 4 * d, d),
          "b2": f(nb, d)}
    x, mods, k, v = f(b, r, p), f(b, 6 * nb, d), f(b * nb, lk, d), \
        f(b * nb, lk, d)
    lw, lb, pe = f(1, d), f(1, d), f(p, d)
    ons, onb, hw, hb = f(1, d), f(1, d), f(d, 1), f(1, 1)
    got = cb.fused_core_stack(x, mods, k, v, ws, lw, lb, pe, ons, onb, hw,
                              hb, p=p, chunk=r, accurate=True)
    # bf16_3x: x, pos_emb and eps plus the bias as the one-hot relayouts
    # leave them (round3), the head's product an mm_3x
    cur = (cb.round3(x).reshape(b * r, p, 1) * lw + lb + cb.round3(pe)
           ).reshape(b, r * p, d)
    for i in range(nb):
        w = {key: val[i] for key, val in ws.items()}
        cur = cb.fused_core_block(cur, mods[:, 6 * i:6 * i + 6],
                                  k.reshape(b, nb, lk, d)[:, i],
                                  v.reshape(b, nb, lk, d)[:, i], w, p=p,
                                  chunk=r, accurate=True)
    want = cb.round3(cb.mm_3x(cb._ln(cur) * ons + onb, hw) + hb)
    np.testing.assert_allclose(got.numpy(), want.reshape(b, r, p).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_mixed_devices():
    x = torch.zeros(2, 3, 5)
    meta = torch.zeros(2, 6, 8, device="meta")
    with pytest.raises(ValueError, match="mixed devices"):
        cb.fused_core_block(torch.zeros(2, 15, 8), meta, x, x,
                            {key: x for key in cb.WEIGHT_KEYS}, p=5,
                            chunk=3)


@pytest.mark.parametrize("p,d,lk,ok", [
    (29, 128, 147, True),     # configs[3]
    (32, 128, 256, True),     # the limits
    (33, 128, 147, False),    # one warp lane per key token
    (29, 64, 147, False),     # the kernels are built for D=128
    (29, 128, 257, False),    # cross logits live beside q in shared memory
])
def test_kernel_supports(p, d, lk, ok):
    assert cb.kernel_supports(p, d, lk) is ok


def test_mega_plan_gates():
    """mega_plan engages only under its full precondition set."""
    from ertdx_torch.models.condunet import CondUNet

    def model(**kw):
        return CondUNet(**{"param_dim": 29, "hidden_dim": 128,
                           "cond_channels": 14, "base_width": 8,
                           "depth": 3, "num_heads": 2, "num_blocks": 2,
                           **kw})

    big = mega.MIN_TOTAL_CHAINS
    plan = mega.mega_plan(model(), 1000, 8, cond_len=4693, device="cuda")
    assert plan == {"p": 29, "d": 128, "num_blocks": 2, "chunk": 1000,
                    "accurate": False, "stack": True}
    plan = mega.mega_plan(model(ensemble_mega_accurate=True), 1000, 8,
                          cond_len=4693, device="cuda")
    assert plan["accurate"] is True
    assert mega.mega_plan(model(), big, 1, 4693, device="cpu") is None
    assert mega.mega_plan(model(), big, 1, 4693, device=None) is None
    assert mega.mega_plan(model(ensemble_mega=False), big, 1, 4693,
                          device="cuda") is None
    assert mega.mega_plan(model(core_heads=2), big, 1, 4693,
                          device="cuda") is None
    assert mega.mega_plan(model(), big - 1, 1, 4693, device="cuda") is None
    assert mega.mega_plan(model(hidden_dim=64), big, 1, 4693,
                          device="cuda") is None
    # 40 tokens -> 5 patches -> 3 -> 2 keys; an unknown length assumes 256
    assert mega.cond_token_len(model(), 40) == 2
    assert mega.cond_token_len(model(), 4693) == 147
