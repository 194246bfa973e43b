"""The plan of the fused conv's wgmma GEMMs (csrc/gn_conv.cu, which a
float32 and a bf16 x both run), on the CPU.

The kernels run only on a card (tests/test_torch_gpu.py, chip_smoke.py
phases 2, 10 and 16). What their design moved into Python, and the index
arithmetic of the design, are checked here:

* the weights as the wrapper hands them (`ops/conv.py::_kernel_weight`):
  K-major (3, N, K) bf16 for both GEMMs, the forward's a (3, Cout, C)
  copy of w[j] transposed, dh's w as it is;
* the tap GEMM's tiling emulated in numpy in float64: 128-row tiles over
  the B L flattened rows with the halo rows [m0 - 1, m0 + 128] zero
  outside [0, M), a fragment row's tap 0 / tap 2 zeroed where it crosses
  a batch row, B read as b[j] (the forward) or b[2 - j] (dh) from the
  (3, N, K) tensor, in column blocks of 256 (N > 128) or 128; against
  the padded convolution and dh's transposed taps;
* dW's split emulated the same way: 64-row chunks in `dw_splits`
  contiguous ranges, A = h^T of tile rows j .. j + 63 (h rows r0 - 1 ..
  r0 + 64), the g rows whose tap crosses a batch row masked, one partial
  a split summed in order; db's six row groups of a chunk;
* `dw_splits`: one block of 64 x 128 channels a split and SM, one wave.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from ertdx_torch.ops import conv as cv

TM, KC, DW_KR = 128, 32, 64


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


@pytest.mark.parametrize("forward", [True, False])
def test_kernel_weights_are_k_major(forward):
    w = torch.from_numpy(_rng_arrays(1, (3, 24, 40))[0].astype(np.float32))
    wk = cv._kernel_weight(w, forward=forward)
    assert wk.dtype == torch.bfloat16 and wk.is_contiguous()
    want = (w.transpose(1, 2) if forward else w).to(torch.bfloat16)
    assert wk.shape == want.shape == ((3, 40, 24) if forward else
                                      (3, 24, 40))
    assert torch.equal(wk, want)
    # a float32 x's kernels read the same bf16 weights (one-pass products)
    assert torch.equal(cv._kernel_weight(w.double(), forward=forward), want)


def _tap_gemm(a, b3, l, reverse):
    """The tap GEMM as the kernel tiles it, in float64: a (M, K), b3 (3,
    N, K) K-major; out[m] = sum_j A[m-1+j] b3[j or 2-j]^T."""
    m_total, k = a.shape
    n = b3.shape[1]
    bn = 256 if n > 128 else 128
    out = np.full((m_total, n), np.nan)
    for m0 in range(0, m_total, TM):
        rows = np.arange(m0 - 1, m0 + TM + 1)          # the A halo
        tile = np.zeros((TM + 2, k))
        ok = (rows >= 0) & (rows < m_total)
        tile[ok] = a[rows[ok]]
        r = np.arange(m0, m0 + TM)
        top = r % l == 0                              # tap 0 crosses
        bottom = r % l == l - 1                       # tap 2 crosses
        for n0 in range(0, n, bn):
            acc = np.zeros((TM, min(bn, n - n0)))
            for j in range(3):
                frag = tile[j:j + TM].copy()
                if j == 0:
                    frag[top] = 0
                if j == 2:
                    frag[bottom] = 0
                acc += frag @ b3[2 - j if reverse else j, n0:n0 + bn].T
            keep = r < m_total
            out[r[keep], n0:n0 + bn] = acc[keep]
    return out


@pytest.mark.parametrize("b,l,c,cout", [(2, 37, 16, 24), (3, 5, 8, 72),
                                        (1, 300, 8, 320), (4, 64, 16, 8)])
def test_tap_gemm_tiles_compute_the_convolution(b, l, c, cout):
    h, w, g = _rng_arrays(b + l + c + cout, (b, l, c), (3, c, cout),
                          (b, l, cout))
    # forward: B = w[j] as (3, Cout, C)
    got = _tap_gemm(h.reshape(b * l, c), w.transpose(0, 2, 1), l, False)
    pad = np.pad(h, ((0, 0), (1, 1), (0, 0)))
    want = sum(pad[:, j:j + l] @ w[j] for j in range(3))
    np.testing.assert_allclose(got.reshape(b, l, cout), want, rtol=1e-12,
                               atol=1e-12)
    # dh: B = w[2 - j]^T read from w as it is, (3, C, Cout)
    got = _tap_gemm(g.reshape(b * l, cout), w, l, True)
    gpad = np.pad(g, ((0, 0), (1, 1), (0, 0)))
    want = sum(gpad[:, 2 - j:2 - j + l] @ w[j].T for j in range(3))
    np.testing.assert_allclose(got.reshape(b, l, c), want, rtol=1e-12,
                               atol=1e-12)


def _dw_split(h, g, l, splits):
    """dW and db as the kernel splits them, in float64: per split, per
    DW_KR-row chunk, tap j's A = h^T of tile rows j .. j + DW_KR - 1,
    masked g rows; db over six row groups a chunk, the groups added in
    order."""
    m_total, c = h.shape
    cout = g.shape[1]
    total = -(-m_total // DW_KR)
    per = -(-total // splits)
    parts = []
    for s in range(splits):
        ch0 = min(total, s * per)
        ch1 = min(total, ch0 + per)
        dw = np.zeros((3, c, cout))
        groups = np.zeros((6, cout))
        for ch in range(ch0, ch1):
            r0 = ch * DW_KR
            rows = np.arange(r0 - 1, r0 + DW_KR + 1)
            tile = np.zeros((DW_KR + 2, c))
            ok = (rows >= 0) & (rows < m_total)
            tile[ok] = h[rows[ok]]
            gr = np.arange(r0, r0 + DW_KR)
            gt = np.zeros((DW_KR, cout))
            gt[gr < m_total] = g[gr[gr < m_total]]
            for j in range(3):
                a = tile[j:j + DW_KR].copy()           # rows k of A^T
                if j != 1:
                    a[gr % l == (0 if j == 0 else l - 1)] = 0
                dw[j] += a.T @ gt
            for q in range(6):
                groups[q] += gt[q::6].sum(axis=0)
        parts.append((dw, groups.sum(axis=0)))
    return (sum(p[0] for p in parts), sum(p[1] for p in parts))


@pytest.mark.parametrize("b,l,c,cout,splits", [
    (3, 61, 16, 24, 3), (5, 1, 8, 8, 5), (2, 200, 8, 16, 2),
    (4, 37, 8, 8, 1)])
def test_dw_split_chunks_compute_dw_and_db(b, l, c, cout, splits):
    h, g = _rng_arrays(b * l + c, (b, l, c), (b, l, cout))
    dw, db = _dw_split(h.reshape(b * l, c), g.reshape(b * l, cout), l,
                       splits)
    pad = np.pad(h, ((0, 0), (1, 1), (0, 0)))
    want = np.stack([np.einsum("blc,blo->co", pad[:, j:j + l], g)
                     for j in range(3)])
    np.testing.assert_allclose(dw, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(db, g.sum(axis=(0, 1)), rtol=1e-12,
                               atol=1e-12)


def test_dw_splits_fill_one_wave():
    # the encoder's 256 -> 256 conv: 4 x 2 channel blocks, 16 splits,
    # 128 blocks on 132 SMs
    assert cv.dw_splits(256, 256, 256, 132) == 16
    assert cv.dw_splits(256, 128, 256, 132) == 33
    # at most one split a batch row; at least one
    assert cv.dw_splits(2, 256, 256, 132) == 2
    assert cv.dw_splits(256, 1024, 1024, 132) == 1
