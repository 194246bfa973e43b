"""The one-pass gates: the port's copies of JAX's gates against JAX's own,
and the routes they give, on the CPU (no kernel runs).

Where JAX's gate, evaluated as on its TPU, takes its kernel, the port
computes that kernel's one-pass function: on the CUDA kernel where the
port's kernel gate takes the shape ("kernel"), else on the plain one-pass
version on the card ("onepass_plain"). Where JAX's gate refuses, the port
computes the float32 plain version ("float32"), as JAX's XLA reference;
so it does on the CPU. JAX's gates read `jax.default_backend()`, which is
patched to "tpu" here; the port's copies leave that term out (its
counterpart is the tensor's CUDA device, an argument of the routes).

The grid holds configs[3] (P=29, D=128, Lk=147, R=1000), V5E8_DP's slab
(256, 147, 256, 4) and every shape where the two packages' gates
disagreed before the routes: cross attention at D=128 with 193-1024 keys,
D=256, self attention at P=40 (JAX takes, the port's kernels do not);
D=64, self attention with N not a multiple of 8, cross attention with an
Lq that no multiple of 8 up to 1024 divides (the port's kernels take,
JAX does not); the fused core at Lk=300 and 512, P=40 and D=256; the
slab at dh=128, dh=16 and L=300.
"""
from __future__ import annotations

import types

import jax
import pytest
import torch

from ertdx.models import mega as jmega
from ertdx.ops import core_block as jcb
from ertdx.ops import ensemble_attn as jea
from ertdx.ops import slab_attn as jsa
from ertdx_torch.models import mega
from ertdx_torch.ops import core_block as cb
from ertdx_torch.ops import ensemble_attn as ea
from ertdx_torch.ops import slab_attn as sa


@pytest.fixture
def on_tpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


# (N, P, D), route on a CUDA tensor
SELF = [((2000, 29, 128), "kernel"),          # configs[3]'s per-block path
        ((16, 29, 128), "kernel"),
        ((2000, 40, 128), "onepass_plain"),   # P past the kernel's 32
        ((2000, 29, 256), "onepass_plain"),   # D=256
        ((2000, 29, 64), "float32"),          # JAX: D % 128
        ((2001, 29, 128), "float32"),         # JAX: N % 8
        ((7, 17, 64), "float32")]
# (B, Lq, Lk, D), route on a CUDA tensor
CROSS = [((2, 29000, 147, 128), "kernel"),
         ((1, 87, 173, 128), "float32"),      # JAX: no q-block divides 87
         ((1, 88, 173, 128), "kernel"),
         ((2, 29000, 193, 128), "onepass_plain"),   # past the kernel's 192
         ((2, 29000, 300, 128), "onepass_plain"),
         ((2, 29000, 1024, 128), "onepass_plain"),
         ((2, 29000, 147, 256), "onepass_plain"),
         ((2, 29000, 147, 64), "float32"),         # JAX: D % 128
         ((2, 28971, 147, 128), "float32"),        # JAX: no q-block
         ((2, 29000, 1536, 128), "float32")]       # JAX: past its VMEM
# (B, L, C, heads), route on a CUDA tensor at accurate False / True
SLAB = [((256, 147, 256, 4), "kernel", "kernel"),    # V5E8_DP
        ((4, 147, 256, 8), "kernel", "kernel"),       # dh=32
        ((2, 61, 128, 2), "kernel", "kernel"),
        ((256, 147, 256, 2), "onepass_plain", "float32"),   # dh=128
        ((256, 147, 128, 8), "onepass_plain", "float32"),   # dh=16
        ((256, 300, 256, 4), "onepass_plain", "float32"),   # L past 256
        ((8, 256, 2048, 4), "float32", "float32"),   # JAX: past its VMEM
        ((2, 40, 256, 3), "float32", "float32")]     # heads do not split C


def _core(p=29, d=128, nb=4, accurate=False, dtype="float32", **kw):
    """A model as both packages' plans read it (the flags, the dtype as
    JAX's `dtype` and the port's `compute_dtype`, the core's shape, the
    encoder's patch and depth, which set Lk)."""
    return types.SimpleNamespace(
        ensemble_mega=True, core_heads=1, dtype=dtype,
        compute_dtype=getattr(torch, dtype), param_dim=p, hidden_dim=d,
        num_blocks=nb, ensemble_mega_accurate=accurate, patch=8, depth=3,
        **kw)


# (model, R, B, cond_len (Lk), route at accurate=False, JAX's variant)
CORE = [(_core(), 1000, 8, 4693, "kernel", "stack"),         # configs[3]
        (_core(), 1000, 8, 9600, "onepass_plain", "stack"),   # Lk=300
        (_core(), 1000, 8, 16384, "onepass_plain", "stack"),  # Lk=512
        (_core(p=40), 1000, 8, 4693, "onepass_plain", "stack"),
        (_core(d=256), 1000, 8, 4693, "onepass_plain", "block"),
        (_core(d=64), 1000, 8, 4693, "float32", None),       # JAX: D % 128
        (_core(), 1009, 8, 4693, "float32", None),           # JAX: no tile
        (_core(), 1000, 2, 4693, "float32", None),           # < 4096 chains
        (_core(nb=24), 40000, 1, 4693, "kernel", "block"),   # stack too big
        (_core(dtype="bfloat16"), 1000, 8, 4693, "kernel", "stack"),
        (_core(dtype="float16"), 1000, 8, 4693, "float32", None)]  # JAX


# ---------------------------------------------------------------------------
# the copies against JAX's own gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [s for s, _ in SELF])
def test_self_gate_is_jax(on_tpu, shape):
    assert ea.tpu_block_self_attention_ok(*shape) is \
        jea.block_self_attention_ok(*shape)
    assert ea.tpu_self_groups_per_program(*shape) == \
        jea._self_groups_per_program(*shape)


@pytest.mark.parametrize("shape", [s for s, _ in CROSS])
def test_cross_gate_is_jax(on_tpu, shape):
    assert ea.tpu_folded_cross_attention_ok(*shape) is \
        jea.folded_cross_attention_ok(*shape)
    assert ea.tpu_cross_block_q(shape[1]) == jea._cross_block_q(shape[1])


@pytest.mark.parametrize("shape", [s for s, _, _ in SLAB])
def test_slab_gate_is_jax(shape):
    b, l, c, nh = shape
    assert sa.tpu_slab_attention_ok(*shape) == jsa.slab_attention_ok(*shape)
    for backward in (False, True):
        assert sa.tpu_pick_block_b(b, l, c, nh, backward) == \
            jsa._pick_block_b(b, l, c, nh, backward)
    if c % nh == 0:
        assert sa.tpu_group_of(nh, c // nh) == jsa._group_of(nh, c // nh)


@pytest.mark.parametrize("case", range(len(CORE)))
def test_core_plan_is_jax(on_tpu, case):
    model, r, b, cond_len, _, variant = CORE[case]
    for accurate in (False, True):
        model.ensemble_mega_accurate = accurate
        want = jmega.mega_plan(model, r, b, cond_len=cond_len)
        got = mega.tpu_mega_plan(model, r, b, cond_len=cond_len)
        assert (got is None) == (want is None)
        if got is not None:
            assert got == {"stack": want["stack"], "chunk": want["chunk"]}
    model.ensemble_mega_accurate = False
    got = mega.tpu_mega_plan(model, r, b, cond_len=cond_len)
    assert (got and ("stack" if got["stack"] else "block")) == variant
    lk = mega.cond_token_len(model, cond_len)
    p, d, nb = model.param_dim, model.hidden_dim, model.num_blocks
    assert cb.chunk_candidates(r, p) == jcb.chunk_candidates(r, p)
    for accurate in (False, True):
        assert cb.pick_stack_outer(r, p, d, nb, lk, accurate) == \
            jcb.pick_stack_outer(r, p, d, nb, lk, accurate)
        assert cb.pick_block_chunk(r, p, d, lk, accurate) == \
            jcb.pick_block_chunk(r, p, d, lk, accurate)
        for c in cb.chunk_candidates(r, p)[:3]:
            assert cb.stack_vmem_bytes(p, d, nb, lk, r, accurate, c) == \
                jcb.stack_vmem_bytes(p, d, nb, lk, r, accurate, c)
            assert cb.block_vmem_bytes(p, d, lk, c, accurate) == \
                jcb.block_vmem_bytes(p, d, lk, c, accurate)


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,route", SELF)
def test_self_route(shape, route):
    assert ea.block_self_route(*shape, "cuda") == route
    assert ea.block_self_route(*shape, "cpu") == "float32"


def test_self_route_counts_global_chains():
    """JAX's self gate counts the chains of the global batch: under a mesh
    the model passes them (`global_n`), and the route follows them."""
    assert ea.block_self_route(4, 29, 128, "cuda") == "float32"
    assert ea.block_self_route(4, 29, 128, "cuda", global_n=8) == "kernel"
    assert ea.block_self_route(8, 29, 128, "cuda", global_n=12) == "float32"


@pytest.mark.parametrize("accurate", [False, True])
@pytest.mark.parametrize("jax_takes", [False, True])
@pytest.mark.parametrize("port_takes", [False, True])
def test_route_rule(accurate, jax_takes, port_takes):
    """The one rule of the three dispatchers (ops/_build.py::route)."""
    from ertdx_torch.ops import _build
    got = _build.route("cuda", accurate, jax_takes, port_takes)
    if accurate:
        want = "kernel" if port_takes else "float32"
    elif not jax_takes:
        want = "float32"
    else:
        want = "kernel" if port_takes else "onepass_plain"
    assert got == want
    assert _build.route("cpu", accurate, jax_takes, port_takes) == "float32"


@pytest.mark.parametrize("shape,route", CROSS)
def test_cross_route(shape, route):
    assert ea.folded_cross_route(*shape, "cuda") == route
    assert ea.folded_cross_route(*shape, "cpu") == "float32"


@pytest.mark.parametrize("shape,route,accurate_route", SLAB)
def test_slab_route(shape, route, accurate_route):
    assert sa.slab_route(*shape, "cuda") == route
    assert sa.slab_route(*shape, "cuda", accurate=True) == accurate_route
    assert sa.slab_route(*shape, "cpu") == "float32"


@pytest.mark.parametrize("case", range(len(CORE)))
def test_core_route_and_plan(case):
    """mega_plan follows mega_route: None on the module path, the kernels'
    plan (JAX's variant) on the kernel route, that plan with "plain" on
    the plain route of the mode (warned once per shape); with
    accurate=True JAX's gate chooses as well, the plain route
    ("onepass_plain") then running the plain bf16_3x version."""
    model, r, b, cond_len, route, variant = CORE[case]
    for accurate in (False, True):
        model.ensemble_mega_accurate = accurate
        assert mega.mega_route(model, r, b, cond_len, "cuda") == route
        assert mega.mega_route(model, r, b, cond_len, "cpu") == "float32"
        if route == "onepass_plain":
            with pytest.warns(UserWarning, match="plain " + (
                    "bf16_3x" if accurate else "one-pass")):
                plan = mega.mega_plan(model, r, b, cond_len, "cuda")
        else:
            plan = mega.mega_plan(model, r, b, cond_len, "cuda")
        if route == "float32":
            assert plan is None
        else:
            assert plan["stack"] is (variant == "stack")
            assert plan["chunk"] == r and plan["accurate"] is accurate
            assert plan.get("plain", False) is (route == "onepass_plain")
    model.ensemble_mega_accurate = False


def test_plain_routes_warn_once_per_shape(monkeypatch):
    """The plain one-pass route warns once per op and shape."""
    from ertdx_torch.ops import _build
    monkeypatch.setattr(_build, "_onepass_plain_warned", set())
    with pytest.warns(UserWarning) as record:
        for _ in range(3):
            _build.warn_onepass_plain("slab_attention", (256, 300, 768, 4))
        _build.warn_onepass_plain("slab_attention", (256, 147, 768, 2))
    assert len(record) == 2
