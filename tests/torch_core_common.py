"""Shared inputs and JAX's TPU function for the fused-core tests.

Full-width inputs of the core (D=128, 4 blocks, P=29, Lk=147, B=2
conditions of R=10 chains), scaled as chip_smoke.py's `core_inputs`, and
`jax_accurate()`: JAX's kernels with `_dot(accurate=True)` computing
bf16_3x as the TPU's DEFAULT passes do, its lo parts rounded to bf16. On
the CPU JAX's interpret-mode kernels compute at float32 whatever their
mode, so the tests patch `_dot`, inside the test only, to get the TPU's
function.
"""
from __future__ import annotations

import contextlib
import math

import jax
import numpy as np

from ertdx.ops import core_block as jcb

D, NB, P, LK, B, R = 128, 4, 29, 147, 2, 10


@contextlib.contextmanager
def jax_accurate():
    """JAX's kernels with `_dot(..., accurate=True)` as the TPU computes
    it: ah bh + al bh + ah bl with `_hilo`'s lo parts rounded to bf16 (a
    DEFAULT pass rounds both of its operands); JAX's caches cleared on
    entry and exit, so that no trace made on either side of the patch is
    reused."""
    plain_dot = jcb._dot

    def bf16x3_dot(a, b, dims=None, accurate=True):
        if not accurate:
            return plain_dot(a, b, dims, accurate)
        ah, al = jcb._hilo(a)
        bh, bl = jcb._hilo(b)
        al, bl = jcb._hilo(al)[0], jcb._hilo(bl)[0]

        def p(x, y):
            return plain_dot(x, y, dims, accurate=False)

        return p(ah, bh) + p(al, bh) + p(ah, bl)

    jax.clear_caches()
    jcb._dot = bf16x3_dot
    try:
        yield
    finally:
        jcb._dot = plain_dot
        jax.clear_caches()


def rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _inputs(seed=11):
    """Full-width inputs scaled as chip_smoke.py's core_inputs."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    s = 1.0 / math.sqrt(D)
    ws = {"wqkv": rnd(NB, D, 3 * D, scale=s), "wso": rnd(NB, D, D, scale=s),
          "bso": rnd(NB, D, scale=0.1), "wcq": rnd(NB, D, D, scale=s),
          "wco": rnd(NB, D, D, scale=s), "bco": rnd(NB, D, scale=0.1),
          "w1": rnd(NB, D, 4 * D, scale=s), "b1": rnd(NB, 4 * D, scale=0.1),
          "w2": rnd(NB, 4 * D, D, scale=0.5 * s),
          "b2": rnd(NB, D, scale=0.1)}
    return {"x": rnd(B, R, P), "x3": rnd(B, R * P, D),
            "mods": rnd(B, 6 * NB, D, scale=0.3),
            "k": rnd(B * NB, LK, D), "v": rnd(B * NB, LK, D), "ws": ws,
            "head": (rnd(1, D), rnd(1, D, scale=0.1), rnd(P, D, scale=0.1),
                     1 + rnd(1, D, scale=0.1), rnd(1, D, scale=0.1),
                     rnd(D, 1, scale=s), rnd(1, 1, scale=0.1))}
