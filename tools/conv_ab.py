#!/usr/bin/env python3
"""A/B of fused GN+SiLU+conv3 kernel variants on one NVIDIA GPU.

    python3 tools/conv_ab.py [--before PATH] [--train] [name ...]

Builds ertdx_torch/csrc/gn_conv.cu as it stands ("base") and in the
variants of VARIANTS below, each a list of exact text substitutions in
gn_conv.cu or (prefix "H:") tf32x3.cuh; with --before, also the
gn_conv.cu at PATH as it is ("before": an earlier version, e.g. from a
`git archive` of the parent commit, built against today's gn_common.cuh
and bound with today's entry points, so one that takes the GN launch
plans; tools/gn_ab.py builds and binds earlier ones). tools/core_ab.py's
build(), one nvcc per variant, all started together, into
build/conv_ab/. Then, in
turns (the variants in order, then in reverse), times gn_silu_conv3's
forward and backward at chip_smoke.py's phase-10 shapes (256, 294, 256 ->
256) and (256, 147, 256 -> 256) (CUDA events) and prints, at the first,
each output's max abs error against the plain version (y; dx, dgamma,
dbeta, dW, db) and whether reruns are bit-identical. With --train it also
runs phase 11 (a) of chip_smoke.py (5 b256 steps of the fused-encoder
arm, kernel path against plain path) through each variant and prints its
loss and gradient gaps. The "diag_" variants compute wrong results on
purpose: they remove one kind of work to show its cost. A variant whose
build spills is reported and timed all the same; one that fails to
launch is reported and skipped. Nothing here is imported by the port; it
needs nvcc and a card.
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

OUT = os.path.join(ROOT, "build", "conv_ab")
KERNELS = ("tap3_gemm_kernel", "conv_dw_kernel")
ENTRY_POINTS = ("ertdx_gn_conv3_fwd", "ertdx_gn_conv3_bwd")
SHAPES = [(256, 294, 256, 256), (256, 147, 256, 256)]
NAMES = ("y", "dx", "dgamma", "dbeta", "dW", "db")

_GEMM_PART = """    float part[MT][NT][4] = {};
    gemm_chunk<WT>(part, As, As + A_FLOATS, first, last, wm, wn, lane);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] += part[i][n][e];
"""
# dW as it stands: taps outer, each tap's chunk from zero
_DW_TAPS_OUTER = """  using namespace tf32x3;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float part[DW_MT][DW_NT][4] = {};
#pragma unroll 2         // fully unrolled, ptxas spilled (PERF.md)
    for (int kk = 0; kk < DW_KR; kk += 8) {"""
_DW_ADD = """        for (int e = 0; e < 4; ++e) acc[j][i][n][e] += part[i][n][e];
  }
}"""
# dW with the k steps outer and every tap's MMAs on its accumulator: one
# B fragment load for the three taps
_DW_ON_MMA = """  using namespace tf32x3;
#pragma unroll
  for (int kk = 0; kk < DW_KR; kk += 8) {
    FragB fb[DW_NT];
#pragma unroll
    for (int n = 0; n < DW_NT; ++n) {
      load_b_nn(fb[n], Gs, LDG, kk, wn + 8 * n, lane);
      if (db_warp)
        dbp[n] += (__uint_as_float(fb[n].hi[0]) +
                   __uint_as_float(fb[n].lo[0])) +
                  (__uint_as_float(fb[n].hi[1]) +
                   __uint_as_float(fb[n].lo[1]));
    }
    const int k = kk + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const unsigned dead = j == 0 ? first : j == 2 ? last : 0u;
#pragma unroll
      for (int i = 0; i < DW_MT; ++i) {
        FragA fa;
        load_a_t(fa, Hs + j * LDH, LDH, wc + 16 * i, kk, lane);
        if (j != 1) {
          if ((dead >> k) & 1u) fa.hi[0] = fa.lo[0] = fa.hi[1] = fa.lo[1] = 0u;
          if ((dead >> (k + 1)) & 1u)
            fa.hi[2] = fa.lo[2] = fa.hi[3] = fa.lo[3] = 0u;
        }
#pragma unroll
        for (int n = 0; n < DW_NT; ++n) mma3(acc[j][i][n], fa, fb[n]);
      }
    }
  }
}"""
# h = silu(GN(x)) written to device memory by an elementwise pass, then
# the GEMM without its prologue
_H_KERNEL = """// h = silu(GN(x)) of the (M, C) rows, 4 channels a thread
__global__ void gn_silu_rows_kernel(const float* __restrict__ x,
                                    const float* __restrict__ aff,
                                    const float* __restrict__ beta,
                                    float* __restrict__ h, int L, int C,
                                    size_t n4) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const size_t m = i * 4 / C;
  const int c = (int)(i * 4 % C);
  reinterpret_cast<float4*>(h)[i] = gn_silu4(
      reinterpret_cast<const float4*>(x)[i], aff + 2 * ((m / L) * C + c),
      *reinterpret_cast<const float4*>(beta + c));
}

int conv_shape_ok("""
_FWD_GEMM = """  return (int)tap3_gemm<true, false>(x, stats + affine_offset(B, G), beta,
                                     w, bias, out, B, L, C, Cout, s);"""
_FWD_H = """  float* h = nullptr;
  err = cudaMallocAsync((void**)&h, (size_t)B * L * C * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const size_t n4 = (size_t)B * L * C / 4;
  gn_silu_rows_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      x, stats + affine_offset(B, G), beta, h, L, C, n4);
  err = tap3_gemm<false, false>(h, nullptr, nullptr, w, bias, out, B, L, C,
                                Cout, s);
  cudaFreeAsync(h, s);
  return (int)err;"""
# the forward's A tile split into hi and lo once, in the prologue (two
# footprints), and read by a loader that does not split
_LOAD_PRE = """__device__ __forceinline__ void load_a_pre(tf32x3::FragA& f,
                                           const float* hi, const float* lo,
                                           int ld, int m0, int k0, int lane) {
  const int o = (m0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  const float2 ht = *reinterpret_cast<const float2*>(hi + o);
  const float2 hb = *reinterpret_cast<const float2*>(hi + o + 8 * ld);
  const float2 lt = *reinterpret_cast<const float2*>(lo + o);
  const float2 lb = *reinterpret_cast<const float2*>(lo + o + 8 * ld);
  f.hi[0] = __float_as_uint(ht.x); f.hi[1] = __float_as_uint(hb.x);
  f.hi[2] = __float_as_uint(ht.y); f.hi[3] = __float_as_uint(hb.y);
  f.lo[0] = __float_as_uint(lt.x); f.lo[1] = __float_as_uint(lb.x);
  f.lo[2] = __float_as_uint(lt.y); f.lo[3] = __float_as_uint(lb.y);
}

__device__ __forceinline__ float hi_of(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}

// The first flattened row"""
_GN_STORE = """        *p = gn_silu4(*p, aff + 2 * ((size_t)arow[u] * K + k0 + c),
                      *reinterpret_cast<const float4*>(beta + k0 + c));
      }"""
_GN_STORE_PRE = """        const float4 v = gn_silu4(*p, aff + 2 * ((size_t)arow[u] * K + k0 + c),
                      *reinterpret_cast<const float4*>(beta + k0 + c));
        const float4 hv = make_float4(hi_of(v.x), hi_of(v.y), hi_of(v.z),
                                      hi_of(v.w));
        *p = hv;
        *reinterpret_cast<float4*>(As + SF - A_FLOATS + r * LDA + c) =
            make_float4(v.x - hv.x, v.y - hv.y, v.z - hv.z, v.w - hv.w);
      } else if (i < A_ROWS * KC / 4) {
        *reinterpret_cast<float4*>(As + SF - A_FLOATS + r * LDA + c) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }"""
_FAKE = "{0} += __uint_as_float(fa.lo[0] + fb[n].hi[1]);"
_TRANSPOSE = """// wt (3, Cout, C): w (3, C, Cout) transposed per tap, 32 x 32 tiles
__global__ void transpose_taps_kernel(const float* __restrict__ w,
                                      float* __restrict__ wt, int C,
                                      int Cout) {
  __shared__ float t[32][33];
  const int c0 = blockIdx.y * 32, o0 = blockIdx.x * 32;
  const float* src = w + (size_t)blockIdx.z * C * Cout;
  float* dst = wt + (size_t)blockIdx.z * C * Cout;
  for (int r = threadIdx.y; r < 32; r += 8)
    if (c0 + r < C && o0 + (int)threadIdx.x < Cout)
      t[r][threadIdx.x] = src[(size_t)(c0 + r) * Cout + o0 + threadIdx.x];
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8)
    if (o0 + r < Cout && c0 + (int)threadIdx.x < C)
      dst[(size_t)(o0 + r) * C + c0 + threadIdx.x] = t[threadIdx.x][r];
}

"""
_FWD_WT = """  float* wt = nullptr;
  err = cudaMallocAsync((void**)&wt, (size_t)3 * C * Cout * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  transpose_taps_kernel<<<dim3((Cout + 31) / 32, (C + 31) / 32, 3),
                          dim3(32, 8), 0, s>>>(w, wt, C, Cout);
  err = tap3_gemm<true, false>(x, stats + affine_offset(B, G), beta, wt,
                               bias, out, B, L, C, Cout, s);
  cudaFreeAsync(wt, s);
  return (int)err;"""
_GEMM_UNROLL2 = ("#pragma unroll 1\n  for (int kk = 0; kk < KC; kk += 8) {",
                 "#pragma unroll 2\n  for (int kk = 0; kk < KC; kk += 8) {")
_DW_UNROLL1 = ("#pragma unroll 2         // fully unrolled, ptxas spilled "
               "(PERF.md)\n    for (int kk = 0; kk < DW_KR; kk += 8) {",
               "#pragma unroll 1\n    for (int kk = 0; kk < DW_KR; kk += 8) {")
_DW_UNROLLED = (_DW_UNROLL1[0], _DW_UNROLL1[1].replace("unroll 1", "unroll"))
_GEMM_UNROLLED = (_GEMM_UNROLL2[0], _GEMM_UNROLL2[1].replace("unroll 2", "unroll"))
_DH_TAPS = ("    if (WT) {\n#pragma unroll 1\n", "    if (WT) {\n#pragma unroll\n")

VARIANTS = {
    # GN+SiLU in the GEMM's prologue (base) against h written to device
    # memory by an elementwise pass first
    "h_materialised": [("int conv_shape_ok(", _H_KERNEL),
                       (_FWD_GEMM, _FWD_H)],
    # tiles of 128 rows within a batch row (base: over the flattened rows)
    "per_row_tiles": [
        ("  const int m0 = tile * TM;\n  return make_int2(m0, min(M, m0 + TM));",
         "  const int per = (L + TM - 1) / TM, b = tile / per;\n"
         "  const int m0 = b * L + (tile % per) * TM;\n"
         "  return make_int2(m0, min(b * L + L, m0 + TM));"),
        ("int gemm_tiles(int M, int L) { return (M + TM - 1) / TM; }",
         "int gemm_tiles(int M, int L) { return M / L * ((L + TM - 1) / TM); }")],
    # the GEMM's block tile and ring (base: 128 x 128, 32 channels, 2
    # stages, 8 warps of 64 x 32)
    "tn64": [("constexpr int TN = 128;", "constexpr int TN = 64;")],
    "tn64_warps4x2": [("constexpr int TN = 128;", "constexpr int TN = 64;"),
                      ("constexpr int WARPS_M = 2, WARPS_N = 4;",
                       "constexpr int WARPS_M = 4, WARPS_N = 2;")],
    "kc16_3stages": [("constexpr int KC = 32;", "constexpr int KC = 16;"),
                     ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    # A split into hi and lo once, in the forward's prologue (base: at each
    # fragment load)
    "split_once": [
        ("constexpr int STAGE_NN = A_FLOATS + 3 * KC * LDB_NN;",
         "constexpr int STAGE_NN = 2 * A_FLOATS + 3 * KC * LDB_NN;"),
        ("// The first flattened row", _LOAD_PRE),
        ("template <bool WT>\n__device__ __forceinline__ void gemm_tap(",
         "template <bool GN, bool WT>\n__device__ __forceinline__ void "
         "gemm_tap("),
        ("    load_a_perm(fa, As + j * LDA, LDA, wm + 16 * i, kk, lane);",
         "    if (GN)\n      load_a_pre(fa, As + j * LDA, As + STAGE_NN - "
         "A_FLOATS + j * LDA, LDA, wm + 16 * i, kk, lane);\n    else\n"
         "      load_a_perm(fa, As + j * LDA, LDA, wm + 16 * i, kk, lane);"),
        ("template <bool WT>\n__device__ __forceinline__ void gemm_chunk(",
         "template <bool GN, bool WT>\n__device__ __forceinline__ void "
         "gemm_chunk("),
        ("#pragma unroll 1\n      for (int j = 0; j < 3; ++j)\n"
         "        gemm_tap<WT>(",
         "#pragma unroll 1\n      for (int j = 0; j < 3; ++j)\n"
         "        gemm_tap<GN, WT>("),
        ("#pragma unroll\n      for (int j = 0; j < 3; ++j)\n"
         "        gemm_tap<WT>(",
         "#pragma unroll\n      for (int j = 0; j < 3; ++j)\n"
         "        gemm_tap<GN, WT>("),
        ("    gemm_chunk<WT>(part,", "    gemm_chunk<GN, WT>(part,"),
        (_GN_STORE, _GN_STORE_PRE)],
    # how the k steps add up (base: each chunk's MMAs from zero, added in
    # fp32): on the MMA's accumulator, in the GEMMs or in dW
    "gemm_acc_on_mma": [(_GEMM_PART, "    gemm_chunk<WT>(acc, As, As + "
                         "A_FLOATS, first, last, wm, wn, lane);\n")],
    "dw_acc_on_mma": [(_DW_TAPS_OUTER, "#if 0\n" + _DW_TAPS_OUTER),
                      (_DW_ADD, _DW_ADD + "\n#endif\n" + _DW_ON_MMA)],
    # 16 warps a block (base: 8), twice the warps an SM to hide latency
    "gemm_16w_32x32": [("constexpr int WARPS_M = 2, WARPS_N = 4;",
                        "constexpr int WARPS_M = 4, WARPS_N = 4;")],
    "dw_16w_32x16": [("constexpr int DW_WARPS_C = 2, DW_WARPS_N = 4;",
                      "constexpr int DW_WARPS_C = 2, DW_WARPS_N = 8;")],
    # the forward's B from a transposed copy of w, read as an nt operand
    # like dh's (base: w read as an nn operand)
    "fwd_wt": [
        ("constexpr int STAGE_NN = A_FLOATS + 3 * KC * LDB_NN;",
         "constexpr int STAGE_NN = A_FLOATS + 3 * TN * LDB_NT;"),
        ("      if (WT) {             // tap j's rows n of KC floats along k",
         "      if (true) {"),
        ("((size_t)(2 - j) * N + n0 + n)", "((size_t)(WT ? 2 - j : j) * N + n0 + n)"),
        ("    if (WT)\n      load_b_nt_perm(",
         "    if (true)\n      load_b_nt_perm("),
        ("int conv_shape_ok(", _TRANSPOSE + "int conv_shape_ok("),
        (_FWD_GEMM, _FWD_WT)],
    # SiLU by expf and an IEEE division (base: __expf and __fdividef)
    "ieee_silu": [("  return __fdividef(y, 1.f + __expf(-y));",
                   "  return y * sigmoidf(y);")],
    # the loops over k steps and taps (base: the GEMM's k steps rolled,
    # dh's taps too, the forward's taps unrolled; dW's k steps unrolled by
    # 2); the unrolled ones spill
    "gemm_kk_unroll2": [_GEMM_UNROLL2],
    "gemm_unrolled": [_GEMM_UNROLLED, _DH_TAPS],
    "dw_kk_unroll1": [_DW_UNROLL1],
    "dw_unrolled": [_DW_UNROLLED],
    # each k step's MMAs summed from zero and added in fp32 (mma3_add):
    # no chunk partial, 64 registers fewer
    "gemm_acc_per_step": [(_GEMM_PART, "    gemm_chunk<WT>(acc, As, As + "
                           "A_FLOATS, first, last, wm, wn, lane);\n"),
                          ("    for (int n = 0; n < NT; ++n) mma3(part[i][n], fa, fb[n]);",
                           "    for (int n = 0; n < NT; ++n) mma3_add(part[i][n], fa, fb[n]);")],
    # diagnostics: wrong results, one kind of work removed
    "diag_no_mma": [
        ("    for (int n = 0; n < NT; ++n) mma3(part[i][n], fa, fb[n]);",
         "    for (int n = 0; n < NT; ++n) " + _FAKE.format("part[i][n][0]")),
        ("        for (int n = 0; n < DW_NT; ++n) mma3(part[i][n], fa, fb[n]);",
         "        for (int n = 0; n < DW_NT; ++n) "
         + _FAKE.format("part[i][n][0]"))],
    "diag_fwd_no_gn": [("    if (GN) gn_silu_tile(ch);",
                        "    if (false) gn_silu_tile(ch);")],
    "diag_dw_no_gn": [("    gn_silu_tile(ch);\n    __syncthreads();",
                       "    __syncthreads();")],
    "diag_no_loads": [
        ("H:  asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16, %2;\\n\" "
         "::\"r\"(s),\n               \"l\"(src), \"r\"(full ? 16 : 0));",
         "  (void)s;")],
}


def ptxas_summary(report: str) -> list:
    """Registers and spill bytes of each instance of the conv kernels."""
    out, name = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in KERNELS if k in line), None)
            if name:
                args = ",".join(re.findall(r"L[ib](\d+)E", line))
                out.append([f"{name}<{args}>", "", ""])
        elif name and "bytes spill stores" in line:
            out[-1][2] = line.split(",")[1].strip().split()[0] + " spill"
        elif name and "registers" in line:
            out[-1][1] = line.split("Used")[1].split(",")[0].strip()
    return [f"{n} {r}, {sp}" for n, r, sp in out]


class _Lib:
    """A variant's two conv entry points; every other kernel from the
    library the port builds."""

    def __init__(self, variant, full):
        self.variant, self.full = variant, full

    def __getattr__(self, name):
        return getattr(self.variant if name in ENTRY_POINTS else self.full,
                       name)


def inputs(dev, b, l, c, cout):
    """chip_smoke.py's phase-10 inputs at one shape."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 130)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    ins = (rnd(b, l, c), rnd(c, scale=0.3, shift=1.0), rnd(c, scale=0.3),
           rnd(3, c, cout, scale=1.0 / math.sqrt(3 * c)),
           rnd(cout, scale=0.3))
    return ins, rnd(b, l, cout)


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
    train = "--train" in args
    names = ["base"] + (["before"] if before else []) + (
        [a for a in args if a != "--train"] or list(VARIANTS))
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
        print(f"ptxas {name}: " + "; ".join(ptxas_summary(report)))

    cases = []
    for shape in SHAPES:
        ins, dy = inputs(dev, *shape)
        with torch.no_grad():
            want = cv.reference_gn_silu_conv3(*ins, cs.GROUPS)
        dwant = cv.reference_gn_silu_conv3_backward(*ins, dy, cs.GROUPS)
        b, l, c, cout = shape
        flops = 2 * b * l * 3 * c * cout
        cases.append((shape, ins, dy, (want, *dwant), flops))
    if train:
        counts = cs._Counts(*[__import__(f"ertdx_torch.ops.{m}",
                                         fromlist=["x"])
                              for m in ("groupnorm", "conv", "slab_attn")])
        cs.device_profile = lambda fn, label: None

    load = _build.load
    full = load().lib
    try:
        for turn, order in enumerate((names, names[::-1])):
            for name in order:
                lib = types.SimpleNamespace(lib=_Lib(libs[name][0], full))
                _build.load = lambda lib=lib: lib
                parts = []
                for shape, ins, dy, wants, flops in cases:
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
                            f"{b_ms:.4f} ms")
                    if shape == SHAPES[0]:
                        errs = ", ".join(
                            f"{n} {float((a - w).abs().max()):.2e} (gate "
                            f"{1e-4 * max(1.0, float(w.abs().max())):.1e})"
                            for n, a, w in zip(NAMES, got, wants))
                        same = all(torch.equal(a, w)
                                   for a, w in zip(got, again))
                        text += f"; errors {errs}; reruns bit-identical " \
                                f"{same}"
                        if turn == 0:
                            records, _ = cs.kernel_records(bwd)
                            text += "; bwd launches " + ", ".join(
                                f"{re.search(r'[a-z0-9_]+_kernel', e.name)[0]}"
                                f" {e.time_range.elapsed_us() / 1e3:.4f}"
                                for e in records)
                    parts.append(text)
                print(f"[{turn}] {name}: " + "; ".join(parts), flush=True)
                if train and turn == 0 and not name.startswith("diag_"):
                    try:
                        cs.check_fused_training(counts, dev, card)
                    except RuntimeError as exc:
                        print(f"  phase 11 (a) with {name}: failed: {exc}",
                              flush=True)
    finally:
        _build.load = load
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
