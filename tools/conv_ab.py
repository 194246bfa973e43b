#!/usr/bin/env python3
"""A/B of the fused GN+SiLU+conv3 kernels on one NVIDIA GPU.

    python3 tools/conv_ab.py [--before PATH] [--bf16] [name ...]

Builds ertdx_torch/csrc/gn_conv.cu as it stands ("base") and in the
variants of VARIANTS below (exact text substitutions in gn_conv.cu, or
in a header named as a prefix, "wgmma.cuh:..."); with --before, also an
earlier gn_conv.cu ("before"): PATH is a directory whose sources and
headers replace today's by name (the parent commit's csrc: `git archive
HEAD~1 ertdx_torch/csrc | tar -x -C build/parent` before the copy goes to
the card, which has no .git; PATH build/parent/ertdx_torch/csrc).
tools/core_ab.py's build(), one nvcc per variant, all started together,
into build/conv_ab/. The float32 entry points of a "before" whose
gn_conv.cu still has the 3xTF32 kernels (`tap3_gemm_kernel`) are called
with their own arguments (float32 weights as (3, C, Cout), no bf16(g)
scratch), which compute the float32 function; today's compute JAX's
one-pass function. With --bf16 the bf16 entry points are timed instead,
on bf16 inputs (the same arguments in both).

Then, in turns (the variants in order, then in reverse), it times the
forward and the backward at chip_smoke.py's phase-10 shapes (256, 294,
256 -> 256) and (256, 147, 256 -> 256) two ways: CUDA events around 5
calls launched back to back (the median of 10), and a CUDA graph of 20
calls replayed (a call's device time without the host), with TFLOP/s at
2 B L 3 C Cout a forward and twice that a backward; in the first turn
each launch's profiler device time, and at the first shape each
output's max abs error against the plain version of the function it
computes (the one-pass one, or for a 3xTF32 "before" the float32 one;
bf16 inputs: the bf16 plain version) and whether reruns are
bit-identical. A variant that fails to build stops the script; one that
fails to launch is reported and skipped. Nothing here is imported by
the port; it needs nvcc and a card.
"""
from __future__ import annotations

import ctypes
import math
import os
import re
import shutil
import sys
import time
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs                                    # noqa: E402
import core_ab                                             # noqa: E402
from ertdx_torch.ops import _build, conv as cv             # noqa: E402
from ertdx_torch.ops import groupnorm as gn                # noqa: E402

OUT = os.path.join(ROOT, "build", "conv_ab")
ENTRY_POINTS = ("ertdx_gn_conv3_fwd", "ertdx_gn_conv3_bwd",
                "ertdx_gn_conv3_fwd_bf16", "ertdx_gn_conv3_bwd_bf16")
SHAPES = [(256, 294, 256, 256), (256, 147, 256, 256)]
NAMES = ("y", "dx", "dgamma", "dbeta", "dW", "db")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the 3xTF32 float32 backward's arguments (no bf16(g) scratch)
TF32X3_BWD = [_P] * 12 + [_I] * 6 + [_F] + [_I] * 6 + [_P]

VARIANTS = {
    # the 128-wide column tile at every N (base: 256 where N > 128)
    "n128": [("  return N > 128 ? tap3_gemm_n<TA, GN, WT, 4>",
              "  return false ? tap3_gemm_n<TA, GN, WT, 4>")],
    # the float32 forward's ring at NSUB = 4 (base: 3 stages)
    "f32_stages2": [("  static constexpr int STAGES = NSUB == 4 ? 3 : F32 ? "
                     "4 : 5;", "  static constexpr int STAGES = NSUB == 4 ? "
                     "(F32 ? 2 : 3) : F32 ? 4 : 5;")],
    # the depth of dW's ring (base: 4 slots)
    "dw_stages3": [("constexpr int DW_STAGES = 4;",
                    "constexpr int DW_STAGES = 3;")],
    # diagnostics: wrong results, one kind of work removed
    "diag_no_gn": [("    if (k < K)\n      gn_silu_units<TA>(",
                    "    if (false)\n      gn_silu_units<TA>(")],
    "diag_no_mma": [
        ("wgmma.cuh:// ---- host: TMA tensor maps",
         "__device__ __forceinline__ void mma_skip(float (&d)[32], const "
         "uint32_t (&a)[4], uint64_t b) {\n  d[0] += __uint_as_float(a[0] "
         "& 1u) + (float)(b & 1u);\n}\n\n// ---- host: TMA tensor maps"),
        ("          wg::mma_rs_n64<0>(", "          wg::mma_skip("),
        ("        wg::mma_rs_n64<1>(acc[n], a[kk],",
         "        wg::mma_skip(acc[n], a[kk],")],
}


class _Lib:
    """A variant's conv entry points; every other kernel from the library
    the port builds."""

    def __init__(self, variant, full):
        self.variant, self.full = variant, full

    def __getattr__(self, name):
        return getattr(self.variant if name in ENTRY_POINTS else self.full,
                       name)


def inputs(dev, b, l, c, cout, bf16: bool):
    """chip_smoke.py's phase-10 inputs at one shape (bf16 x and g with
    --bf16)."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 130)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    dt = torch.bfloat16 if bf16 else torch.float32
    ins = (rnd(b, l, c).to(dt), rnd(c, scale=0.3, shift=1.0),
           rnd(c, scale=0.3), rnd(3, c, cout, scale=1.0 / math.sqrt(3 * c)),
           rnd(cout, scale=0.3))
    return ins, rnd(b, l, cout).to(dt)


def tf32x3_fwd(lib, x, gamma, beta, w, bias):
    """The 3xTF32 forward through its own arguments: float32 w (3, C,
    Cout)."""
    b, l, c = x.shape
    out = torch.empty(b, l, w.shape[-1], device=x.device)
    stats = torch.empty(cv.stats_floats(b, cs.GROUPS, c), device=x.device)
    rc = lib.ertdx_gn_conv3_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
        bias.data_ptr(), out.data_ptr(), stats.data_ptr(), b, l, c,
        w.shape[-1], cs.GROUPS, 1e-5,
        *gn.launch_plan(l, c, cs.GROUPS, "stats").args(),
        torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, "3xTF32 forward")
    return out


def tf32x3_bwd(lib, x, gamma, beta, w, g):
    """The 3xTF32 backward through its own arguments."""
    b, l, c = x.shape
    cout, dev = w.shape[-1], x.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = cv.dw_splits(b, c, cout, sms)
    nw = 3 * c * cout + cout

    def empty(*shape):
        return torch.empty(*shape, device=dev)

    dx, dgb, dwb = torch.empty_like(x), empty(2, c), empty(nw)
    stats, dh = empty(cv.stats_floats(b, cs.GROUPS, c)), empty(b, l, c)
    part_w, part_gn = empty(splits, nw), empty(b, 2, c)
    rc = lib.ertdx_gn_conv3_bwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
        g.data_ptr(), dx.data_ptr(), dgb.data_ptr(), dwb.data_ptr(),
        stats.data_ptr(), dh.data_ptr(), part_w.data_ptr(),
        part_gn.data_ptr(), b, l, c, cout, cs.GROUPS, splits, 1e-5,
        *gn.launch_plan(l, c, cs.GROUPS, "stats").args(),
        *gn.launch_plan(l, c, cs.GROUPS, "bwd", 4, 4).args(),
        torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, "3xTF32 backward")
    return (dx, dgb[0], dgb[1], dwb[:3 * c * cout].view(3, c, cout),
            dwb[3 * c * cout:])


def launches(fn) -> str:
    records, _ = cs.kernel_records(fn)
    return ", ".join(
        f"{re.search(r'[a-z0-9_]+_kernel', e.name)[0]} "
        f"{e.time_range.elapsed_us() / 1e3:.4f}" for e in records)


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_ab: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    before = None
    if "--before" in args:
        i = args.index("--before")
        before = args[i + 1]
        del args[i:i + 2]
    bf16 = "--bf16" in args
    args = [a for a in args if a != "--bf16"]
    names = ["base"] + (["before"] if before else []) + args
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    shutil.rmtree(OUT, ignore_errors=True)
    t0 = time.perf_counter()
    libs = core_ab.build(names, "gn_conv.cu", VARIANTS, ENTRY_POINTS, OUT,
                         before)
    tf32x3 = bool(before) and not bf16 and "tap3_gemm_kernel" in open(
        os.path.join(before, "gn_conv.cu")).read()
    if tf32x3:
        libs["before"][0].ertdx_gn_conv3_bwd.argtypes = TF32X3_BWD
    card = cs.card_line()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s"
          f"; {card}", flush=True)
    for name, (_, report) in libs.items():
        lines = [f"{k}: {' | '.join(cs.ptxas_lines(report, k))}"
                 for k in ("tap3_wgmma_kernel", "conv_dw_wgmma_kernel",
                           "round_colsum_kernel", "tap3_gemm_kernel",
                           "conv_dw_kernel")
                 if cs.ptxas_lines(report, k)]
        print(f"ptxas {name}: " + "; ".join(lines), flush=True)

    cases = []
    for shape in SHAPES:
        ins, dy = inputs(dev, *shape, bf16)
        with torch.no_grad():
            if bf16:            # the bf16 plain version
                want = (cv.reference_gn_silu_conv3(*ins, cs.GROUPS),
                        *cv.reference_gn_silu_conv3_backward(*ins, dy,
                                                             cs.GROUPS))
            else:
                want = (cv.reference_gn_silu_conv3_onepass(*ins, cs.GROUPS),
                        *cv.reference_gn_silu_conv3_onepass_backward(
                            *ins, dy, cs.GROUPS))
        f32 = None
        if tf32x3:              # the float32 function, the 3xTF32 kernels'
            f32 = (cv.reference_gn_silu_conv3(*ins, cs.GROUPS),
                   *cv.reference_gn_silu_conv3_backward(*ins, dy,
                                                        cs.GROUPS))
        b, l, c, cout = shape
        cases.append((shape, ins, dy, want, f32, 2 * b * l * 3 * c * cout))

    load = _build.load
    full = load().lib
    try:
        for turn, order in enumerate((names, names[::-1])):
            for name in order:
                variant = libs[name][0]
                lib = types.SimpleNamespace(lib=_Lib(variant, full))
                _build.load = lambda lib=lib: lib
                parts = []
                for shape, ins, dy, want, f32, flops in cases:
                    if name == "before" and tf32x3:
                        fwd = lambda: tf32x3_fwd(variant, *ins)
                        bwd = lambda: tf32x3_bwd(variant, *ins[:4], dy)
                        wants = f32
                    else:
                        fwd = lambda: cv.gn_silu_conv3_fwd(*ins, cs.GROUPS)
                        bwd = lambda: cv.gn_silu_conv3_bwd(*ins[:4], dy,
                                                           cs.GROUPS)
                        wants = want
                    try:
                        with torch.no_grad():
                            got = (fwd(), *bwd())
                            again = (fwd(), *bwd())
                            torch.cuda.synchronize()
                            f_ms, b_ms = cs.time_ms(fwd), cs.time_ms(bwd)
                            fg_ms, bg_ms = cs.graph_ms(fwd), cs.graph_ms(bwd)
                    except RuntimeError as exc:
                        parts.append(f"{shape}: failed ({exc})")
                        break
                    text = (f"L={shape[1]}: fwd {f_ms:.4f} ms by events, "
                            f"{fg_ms:.4f} by graph replay "
                            f"({flops / fg_ms / 1e9:.1f} TFLOP/s), bwd "
                            f"{b_ms:.4f} / {bg_ms:.4f} "
                            f"({2 * flops / bg_ms / 1e9:.1f} TFLOP/s)")
                    if shape == SHAPES[0]:
                        gaps = [float((a.float() - w.float()).abs().max())
                                for a, w in zip(got, wants)]
                        errs = ", ".join(f"{n} {e:.2e}"
                                         for n, e in zip(NAMES, gaps))
                        same = all(torch.equal(a, w)
                                   for a, w in zip(got, again))
                        text += (f"; max|d| against its function's plain "
                                 f"version: {errs}; reruns bit-identical "
                                 f"{same}")
                    if turn == 0:
                        text += (f"; fwd launches {launches(fwd)}; bwd "
                                 f"launches {launches(bwd)}")
                    parts.append(text)
                print(f"[{turn}] {name}: " + "; ".join(parts), flush=True)
    finally:
        _build.load = load
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
