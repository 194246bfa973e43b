#!/usr/bin/env python3
"""A/B of the bf16 fused GN+SiLU+conv3 kernels on one NVIDIA GPU.

    python3 tools/conv_bf16_ab.py [--before PATH] [name ...]

Builds ertdx_torch/csrc/gn_conv.cu as it stands ("base") and in the
variants of VARIANTS below (exact text substitutions in gn_conv.cu, or
in a header named as a prefix, "wgmma.cuh:..."); with --before, also an
earlier gn_conv.cu ("before"): PATH is that file, built against today's
headers, or a directory whose sources and headers replace today's by
name, as for the parent commit's mma.sync kernels, which need their own
bf16mma.cuh (`git archive HEAD~1 ertdx_torch/csrc | tar -x -C
build/parent`, PATH build/parent/ertdx_torch/csrc); it is bound with
today's bf16 entry points, and its forward gets the weights as (3, C,
Cout), as the mma.sync kernels read them (`before_weight_layout`).
tools/core_ab.py's build(),
one nvcc per variant, all started together, into build/conv_bf16_ab/.
Then, in turns (the variants in order, then in reverse), times the bf16
forward and backward (CUDA events) at chip_smoke.py's phase-16 shapes
(256, 294, 256 -> 256) and (256, 147, 256 -> 256), with TFLOP/s at 2 B L
3 C Cout a forward and twice that a backward, and in the first turn
each launch's profiler device time; at the first shape each output's max
abs error against the plain version in float32 from the same bf16
inputs beside phase 15 (a)'s gate, and whether reruns are bit-identical.
A variant that fails to build stops the script; one that fails to launch
is reported and skipped. Nothing here is imported by the port; it needs
nvcc and a card.
"""
from __future__ import annotations

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

OUT = os.path.join(ROOT, "build", "conv_bf16_ab")
ENTRY_POINTS = ("ertdx_gn_conv3_fwd_bf16", "ertdx_gn_conv3_bwd_bf16")
SHAPES = [(256, 294, 256, 256), (256, 147, 256, 256)]
NAMES = ("y", "dx", "dgamma", "dbeta", "dW", "db")

VARIANTS = {
    # the 128-wide column tile at every N (base: 256 where N > 128)
    "n128": [("  return N > 128 ? tap3_gemm_n<GN, WT, 4>",
              "  return false ? tap3_gemm_n<GN, WT, 4>")],
    # the depth of dW's ring (base: 4 slots)
    "dw_stages3": [("constexpr int DW_STAGES = 4;",
                    "constexpr int DW_STAGES = 3;")],
    # no proxy fence where no thread writes a slot (dh; base: every stage)
    "dh_no_fence": [("""    wg::fence_proxy_async();           // before slot i - 1's next fill
    if (i + 1 < stages) land(i + 1);
    wg::bar_sync(1, GEMM_THREADS);""", """    if (GN) wg::fence_proxy_async();
    if (i + 1 < stages) land(i + 1);
    wg::bar_sync(1, GEMM_THREADS);""")],
    # diagnostics: wrong results, one kind of work removed
    "diag_no_gn": [("    if (GN && k < K) {", "    if (false && k < K) {")],
    "diag_no_ldsm": [("        wg::ldsm_x4(a[kk][j], a_base + wg::sw64(r, 2 * kk + "
                      "(lane >> 4)));",
                      "        a[kk][j][0] = a[kk][j][1] = a[kk][j][2] = "
                      "a[kk][j][3] = a_base + r;")],
    "diag_no_bar": [("""    if (i + 1 < stages) land(i + 1);
    wg::bar_sync(1, GEMM_THREADS);""", """    if (i + 1 < stages) land(i + 1);""")],
    "diag_no_mma": [
        ("wgmma.cuh:// ---- host: TMA tensor maps",
         "__device__ __forceinline__ void mma_skip(float (&d)[32], const "
         "uint32_t (&a)[4], uint64_t b) {\n  d[0] += __uint_as_float(a[0] "
         "& 1u) + (float)(b & 1u);\n}\n\n// ---- host: TMA tensor maps"),
        ("          wg::mma_rs_n64<0>(", "          wg::mma_skip("),
        ("        wg::mma_rs_n64<1>(acc[n], a[kk],",
         "        wg::mma_skip(acc[n], a[kk],")],
}


def before_weight_layout(w, x, forward: bool):
    """The weights as the parent's mma.sync kernels read them: (3, C,
    Cout) bf16 in both passes."""
    return w.to(torch.bfloat16)


class _Lib:
    """A variant's two bf16 conv entry points; every other kernel from the
    library the port builds."""

    def __init__(self, variant, full):
        self.variant, self.full = variant, full

    def __getattr__(self, name):
        return getattr(self.variant if name in ENTRY_POINTS else self.full,
                       name)


def inputs(dev, b, l, c, cout):
    """chip_smoke.py's phase-16 (a) inputs at one shape."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 160)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    ins = (rnd(b, l, c).bfloat16(), rnd(c, scale=0.3, shift=1.0),
           rnd(c, scale=0.3), rnd(3, c, cout, scale=1.0 / math.sqrt(3 * c)),
           rnd(cout, scale=0.3))
    return ins, rnd(b, l, cout).bfloat16()


def launches(fn) -> str:
    records, _ = cs.kernel_records(fn)
    return ", ".join(
        f"{re.search(r'[a-z0-9_]+_kernel', e.name)[0]} "
        f"{e.time_range.elapsed_us() / 1e3:.4f}" for e in records)


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_bf16_ab: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    before = None
    if "--before" in args:
        i = args.index("--before")
        before = args[i + 1]
        del args[i:i + 2]
    names = ["base"] + (["before"] if before else []) + (
        args or list(VARIANTS))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    shutil.rmtree(OUT, ignore_errors=True)
    t0 = time.perf_counter()
    libs = core_ab.build(names, "gn_conv.cu", VARIANTS, ENTRY_POINTS, OUT,
                         before)
    card = cs.card_line()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s"
          f"; {card}", flush=True)
    for name, (_, report) in libs.items():
        lines = [f"{k}: {' | '.join(cs.ptxas_lines(report, k))}"
                 for k in ("tap3_wgmma_kernel", "conv_dw_wgmma_kernel",
                           "tap3_gemm_bf16_kernel", "conv_dw_bf16_kernel")
                 if cs.ptxas_lines(report, k)]
        print(f"ptxas {name}: " + "; ".join(lines), flush=True)

    cases = []
    for shape in SHAPES:
        ins, dy = inputs(dev, *shape)
        f32 = (ins[0].float(),) + ins[1:]
        with torch.no_grad():
            want = cv.reference_gn_silu_conv3(*f32, cs.GROUPS)
            own = cv.reference_gn_silu_conv3(*ins, cs.GROUPS)
        dwant = cv.reference_gn_silu_conv3_backward(*f32, dy.float(),
                                                    cs.GROUPS)
        down = cv.reference_gn_silu_conv3_backward(*ins, dy, cs.GROUPS)
        b, l, c, cout = shape
        cases.append((shape, ins, dy, (want, *dwant), (own, *down),
                      2 * b * l * 3 * c * cout))

    load, weight = _build.load, cv._kernel_weight
    full = load().lib
    try:
        for turn, order in enumerate((names, names[::-1])):
            for name in order:
                lib = types.SimpleNamespace(lib=_Lib(libs[name][0], full))
                _build.load = lambda lib=lib: lib
                cv._kernel_weight = before_weight_layout \
                    if name == "before" else weight
                parts = []
                for shape, ins, dy, wants, owns, flops in cases:
                    fwd = lambda: cv.gn_silu_conv3_fwd(*ins, cs.GROUPS)
                    bwd = lambda: cv.gn_silu_conv3_bwd(*ins[:4], dy,
                                                       cs.GROUPS)
                    try:
                        with torch.no_grad():
                            got = (fwd(), *bwd())
                            again = (fwd(), *bwd())
                            torch.cuda.synchronize()
                            f_ms, b_ms = cs.time_ms(fwd), cs.time_ms(bwd)
                    except RuntimeError as exc:
                        parts.append(f"{shape}: failed ({exc})")
                        break
                    text = (f"L={shape[1]}: fwd {f_ms:.4f} ms "
                            f"({flops / f_ms / 1e9:.1f} TFLOP/s), bwd "
                            f"{b_ms:.4f} ms ({2 * flops / b_ms / 1e9:.1f} "
                            f"TFLOP/s)")
                    if shape == SHAPES[0]:
                        errs = []
                        for n, a, w, o in zip(NAMES, got, wants, owns):
                            tol = max(2 * float((o.float() - w).abs().max()),
                                      8e-3 * max(1.0, float(w.abs().max())))
                            err = float((a.float() - w).abs().max())
                            errs.append(f"{n} {err:.2e} (gate {tol:.2e}"
                                        f"{'' if err <= tol else ' FAILS'})")
                        same = all(torch.equal(a, w)
                                   for a, w in zip(got, again))
                        text += (f"; errors {', '.join(errs)}; reruns "
                                 f"bit-identical {same}")
                    if turn == 0:
                        text += (f"; fwd launches {launches(fwd)}; bwd "
                                 f"launches {launches(bwd)}")
                    parts.append(text)
                print(f"[{turn}] {name}: " + "; ".join(parts), flush=True)
    finally:
        _build.load, cv._kernel_weight = load, weight
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
