"""The one-pass core kernels' operands and tiling (ops/core_block.py).

The one-pass kernels (csrc/core_onepass.cu) read the weights as bf16
copies packed once a run (`pack_core_weights`), K and V as bf16 copies
made once a call (`bf16_copy`), and cut a condition's chains into blocks
of two warpgroups of whole chains (`tile_plan`). The kernels run only on
the card; what they read is checked here: the copies are JAX's
`astype(bfloat16)` of every value bit for bit (JAX's one-pass `_dot`
multiplies exactly those), the packed layout reads back to each (in, out)
matrix, `mega_weights` carries the packed copies, and the plan covers
every chain once with whole chains in each warpgroup.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ertdx_torch.models import mega
from ertdx_torch.ops import core_block as cb

D = 32          # the packing is width-generic; the kernels take D = 128
NB = 2
# values whose rounding to bf16 is an edge: signed zeros and infinities,
# NaNs of both signs, a subnormal, ties to even (1 + 2^-8 down, 1 + 3 x
# 2^-8 up), the largest float (to inf) and a value past bf16's largest
SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40,
                     -1e-40, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
                     np.finfo(np.float32).max, -3.39e38, 65504.0,
                     math.pi, -math.e], np.float32)
SPECIALS[5] = -SPECIALS[4]           # np.nan's sign is +; make it -NaN


def _weights(nb: int = NB, d: int = D, seed: int = 0) -> dict:
    """(in, out) weight stacks with SPECIALS spread over every matrix."""
    rng = np.random.default_rng(seed)
    shapes = {"wqkv": (d, 3 * d), "wso": (d, d), "wcq": (d, d),
              "wco": (d, d), "w1": (d, 4 * d), "w2": (4 * d, d)}
    ws = {}
    for key, shape in shapes.items():
        a = rng.standard_normal((nb,) + shape).astype(np.float32)
        flat = a.reshape(-1)
        where = rng.choice(flat.size, len(SPECIALS), replace=False)
        flat[where] = SPECIALS
        ws[key] = torch.from_numpy(a)
    for key, n in (("bso", d), ("bco", d), ("b1", 4 * d), ("b2", d)):
        ws[key] = torch.from_numpy(
            rng.standard_normal((nb, n)).astype(np.float32))
    return ws


def _bits16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _jax_bf16_bits(a: torch.Tensor) -> np.ndarray:
    """JAX's astype(bfloat16) of a, as its 16 bits."""
    return np.asarray(jnp.asarray(a.numpy()).astype(jnp.bfloat16)).view(
        np.uint16)


def _read_back(packed: torch.Tensor) -> dict:
    """The (in, out) matrices of each block, read from the packed tiles as
    PACK_ORDER lays them out (tile j: the matrix transposed, K-major)."""
    t = {name: packed[:, j].transpose(-1, -2)
         for j, name in enumerate(cb.PACK_ORDER)}
    return {"wqkv": torch.cat([t["wqkv_q"], t["wqkv_k"], t["wqkv_v"]], -1),
            "wso": t["wso"], "wcq": t["wcq"], "wco": t["wco"],
            "w1": torch.cat([t[f"w1_{c}"] for c in range(4)], -1),
            "w2": torch.cat([t[f"w2_{c}"] for c in range(4)], -2)}


# ---------------------------------------------------------------------------
# the rounding: bf16_copy and pack_core_weights
# ---------------------------------------------------------------------------

def test_bf16_copy_is_round_bf16_bit_for_bit():
    """bf16_copy holds round_bf16's upper 16 bits, a NaN's sign included
    (a cast to torch.bfloat16 drops it), and JAX's astype bits."""
    a = torch.from_numpy(SPECIALS)
    got = _bits16(cb.bf16_copy(a))
    want = (cb.round_bf16(a).view(torch.int32) >> 16).numpy().astype(
        np.int64) & 0xFFFF
    assert np.array_equal(got, want.astype(np.uint16))
    assert np.array_equal(got, _jax_bf16_bits(a))
    assert int(got[5]) >> 15 == 1 and torch.isnan(cb.bf16_copy(a)[5].float())


@pytest.mark.parametrize("stacked", [True, False])
def test_pack_is_round_bf16_of_every_weight(stacked):
    """Every packed value is round_bf16 of its float32 weight, bit for
    bit, for the specials too; so JAX's one-pass `_dot` operand (its
    astype(bfloat16)) bit for bit."""
    ws = _weights()
    if not stacked:
        ws = {key: val[0] for key, val in ws.items()}
    packed = cb.pack_core_weights(ws)
    nb = NB if stacked else 1
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (nb, len(cb.PACK_ORDER), D, D)
    back = _read_back(packed)
    for key, mat in back.items():
        src = ws[key] if stacked else ws[key][None]
        want = (cb.round_bf16(src).view(torch.int32) >> 16).numpy() \
            .astype(np.int64) & 0xFFFF
        assert np.array_equal(_bits16(mat.contiguous()),
                              want.astype(np.uint16)), key
        assert np.array_equal(_bits16(mat.contiguous()),
                              _jax_bf16_bits(src)), key


@pytest.mark.parametrize("key", ["wqkv", "wso", "wcq", "wco", "w1", "w2"])
def test_packed_layout_reads_back_each_matrix(key):
    """Read back by PACK_ORDER, the tiles give each block's (in, out)
    matrix: the kernels' K-major tiles, tile j row n column k = W[k, n]
    of its D-wide slice."""
    rng = np.random.default_rng(3)
    ws = {name: torch.from_numpy(rng.standard_normal(val.shape).astype(
        np.float32)) for name, val in _weights().items()}
    packed = cb.pack_core_weights(ws)
    got = _read_back(packed)[key].float()
    assert torch.equal(got, cb.round_bf16(ws[key]))
    # one element by the kernels' own index: tile, row n, column k
    j = cb.PACK_ORDER.index("w2_2")
    assert packed[1, j, 5, 7].float() == cb.round_bf16(
        ws["w2"][1, 2 * D + 7, 5])
    j = cb.PACK_ORDER.index("wqkv_k")
    assert packed[0, j, 3, 9].float() == cb.round_bf16(
        ws["wqkv"][0, 9, D + 3])


def test_pack_order_is_the_kernels_order():
    """The tile order the kernels take (csrc/core_onepass.cu: k, v, q of
    wqkv, wso, wcq, then wco and the MLP's chunks in turns)."""
    assert cb.PACK_ORDER[:6] == ("wqkv_k", "wqkv_v", "wqkv_q", "wso",
                                 "wcq", "wco")
    assert cb.PACK_ORDER[6:] == tuple(f"w{m}_{c}" for c in range(4)
                                      for m in (1, 2))


# ---------------------------------------------------------------------------
# mega_weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def core_model():
    from ertdx_torch.models.condunet import CondUNet
    torch.manual_seed(0)
    return CondUNet(param_dim=29, hidden_dim=128, cond_channels=14,
                    base_width=8, depth=3, num_heads=2, num_blocks=2)


def test_mega_weights_carry_the_packed_copies(core_model):
    """mega_weights packs the blocks' matrices once a run, beside the
    float32 stacks the plain versions read."""
    w = mega.mega_weights(core_model)
    assert tuple(w["packed"].shape) == (2, len(cb.PACK_ORDER), 128, 128)
    assert torch.equal(w["packed"].view(torch.int16),
                       cb.pack_core_weights(w["stack"]).view(torch.int16))
    back = _read_back(w["packed"])
    for i, blk in enumerate(w["blocks"]):
        for key in back:
            assert torch.equal(back[key][i].float(),
                               cb.round_bf16(blk[key])), (i, key)


@pytest.mark.parametrize("stack", [True, False])
def test_wrappers_take_the_packed_copies(core_model, stack):
    """The wrappers take `packed=` (the one-pass kernels' weights) and, on
    CPU tensors, compute the plain version of the mode whatever it is."""
    w = mega.mega_weights(core_model)
    rng = np.random.default_rng(5)
    b, r, p, lk = 2, 3, 29, 7

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    if stack:
        args = (rnd(b, r, p), rnd(b, 12, 128), rnd(2 * b, lk, 128),
                rnd(2 * b, lk, 128), w["stack"], w["lift_w"], w["lift_b"],
                w["pos_emb"], w["on_scale"], w["on_bias"], w["head_w"],
                w["head_b"])
        fn, packed = cb.fused_core_stack, w["packed"]
    else:
        args = (rnd(b, r * p, 128), rnd(b, 6, 128), rnd(b, lk, 128),
                rnd(b, lk, 128), w["blocks"][0])
        fn, packed = cb.fused_core_block, w["packed"][:1]
    with torch.no_grad():
        for accurate in (False, True):
            got = fn(*args, p=p, chunk=r, accurate=accurate, packed=packed)
            want = fn(*args, p=p, chunk=r, accurate=accurate)
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the tile plan
# ---------------------------------------------------------------------------

def _chains(plan, r: int, tile: int, wg: int) -> range:
    """The chains of the R that warpgroup wg of block `tile` holds, as the
    kernels take them (csrc/core_onepass.cu::setup); empty past R."""
    first = (tile * cb.WARPGROUPS + wg) * plan.cpw
    return range(first, min(r, first + plan.cpw))


@pytest.mark.parametrize("p", [1, 17, 29, 32])
@pytest.mark.parametrize("r", [1, 2, 7, 10, 33, 1000])
def test_tile_plan_whole_chains_per_warpgroup(p, r):
    """floor(64 / P) whole chains a warpgroup, two warpgroups a block: no
    chain straddles a warpgroup's 64 rows, every chain of the R is in
    exactly one warpgroup, and the grid has no block past the R."""
    plan = cb.tile_plan(r, p)
    assert plan.cpw == 64 // p and plan.cpw * p <= cb.WG_ROWS
    per_block = cb.WARPGROUPS * plan.cpw
    assert (plan.tiles - 1) * per_block < r <= plan.tiles * per_block
    seen = []
    for tile in range(plan.tiles):
        for wg in range(cb.WARPGROUPS):
            chains = _chains(plan, r, tile, wg)
            assert len(chains) <= plan.cpw
            # the warpgroup's rows: chain c's P tokens at rows
            # (c - first) P .. inside its 64
            rows = [(c - chains.start) * p + j for c in chains
                    for j in range(p)]
            assert all(0 <= row < cb.WG_ROWS for row in rows)
            seen.extend(chains)
    assert seen == list(range(r))


@pytest.mark.parametrize("r, p, last", [(5, 29, (1, 0)), (1001, 29, (1, 0)),
                                        (35, 17, (3, 2)), (3, 32, (2, 1)),
                                        (130, 1, (2, 0))])
def test_tile_plan_ragged_last_block(r, p, last):
    """R not a multiple of the chains a block holds: the last block's
    warpgroups hold fewer chains, the second one possibly none (its rows
    are computed and never written)."""
    plan = cb.tile_plan(r, p)
    assert r % (cb.WARPGROUPS * plan.cpw) != 0
    assert tuple(len(_chains(plan, r, plan.tiles - 1, wg))
                 for wg in range(cb.WARPGROUPS)) == last
