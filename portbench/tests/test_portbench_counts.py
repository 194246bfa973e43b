"""The yardstick's counts: the fused core's bound at configs[3]'s shape
(0.515 ms at B = 8, R = 1000, P = 29, D = 128, Lk = 147, as the kernel
table has it), four times that at B = 32, a whole call's operations, and
the kernel groups."""
import json

import pytest

from portbench import cells, counts

SHAPE = dict(r=1000, p=29, d=128, nb=4, lk=147)


def test_core_stack_bound_at_configs3():
    assert counts.core_stack_flops(8, **SHAPE) == pytest.approx(5.0934e11,
                                                                rel=1e-4)
    assert counts.core_stack_bound_s(8, **SHAPE) * 1e3 == pytest.approx(
        0.515, abs=5e-4)
    assert counts.core_stack_bound_s(32, **SHAPE) == pytest.approx(
        4 * counts.core_stack_bound_s(8, **SHAPE), rel=1e-9)
    # compute-bound: the bytes take far less time than the operations
    assert counts.core_stack_bytes(8, **SHAPE) / counts.PEAK_BYTES_PER_S \
        < 0.02 * counts.core_stack_bound_s(8, **SHAPE)


@pytest.mark.parametrize("cell,surveys", [("ddim_ensemble.serve8", 8),
                                          ("v5e8_dp.sweep32", 32)])
def test_call_flops(cell, surveys):
    c = cells.load_cell(cell)
    shape = counts.stack_shape(c.model, c.traffic["surveys"],
                               c.traffic["members"])
    assert shape == dict(b=surveys, **SHAPE)
    flops = counts.call_flops(c.model, surveys, 1000, 50)
    core = 50 * counts.core_stack_flops(**shape)
    # the encoder and the cross K/V add a fraction of a percent
    assert core < flops < 1.01 * core
    assert flops == pytest.approx(surveys / 8 * 2.55e13, rel=0.01)


def test_encoder_flops_by_hand():
    m = json.loads((cells.ROOT / "configs" / "ddim_ensemble.json")
                   .read_text())["config"]["model"]
    stem = 2 * 587 * 112 * 128
    res0 = 2 * (2 * 587 * 3 * 128 * 128)
    down0 = 2 * 294 * 3 * 128 * 256
    res = lambda n: 2 * (2 * n * 3 * 256 * 256)         # noqa: E731
    down1 = 2 * 147 * 3 * 256 * 256
    attn = 2 * 147 * 4 * 256 * 256 + 4 * 147 ** 2 * 256
    tail = 2 * 147 * 256 * 128 + 2 * 128 * 128
    want = stem + res0 + down0 + res(294) + down1 + res(147) + attn \
        + res(147) + tail
    assert counts.encoder_flops(m) == want


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::core_stack_wgmma_kernel<2>(...)",
     "fused core (this port)"),
    ("void slab_fwd_wgmma_kernel<bf16, 64>", "slab attention (this port)"),
    ("sm90_xmma_gemm_f32f32_tf32f32", "matrix product"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("something_else", "other")])
def test_kernel_groups(name, group):
    assert counts.kernel_group(name) == group
