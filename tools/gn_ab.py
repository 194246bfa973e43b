#!/usr/bin/env python3
"""A/B of GroupNorm+SiLU kernel variants on one NVIDIA GPU.

    python3 tools/gn_ab.py [--before DIR] [--train] [name ...]

Builds ertdx_torch/csrc/groupnorm.cu and gn_conv.cu (with gn_common.cuh)
into one library as they stand ("base") and in the variants of VARIANTS
below, each a list of exact text substitutions (in groupnorm.cu, or in
the file named as a prefix: "gn_common.cuh:..."); with --before, also the
groupnorm.cu, gn_common.cuh and gn_conv.cu found in DIR ("before": an
earlier version from a `git archive` of the parent commit, e.g. `git
archive HEAD~1 ertdx_torch/csrc | tar -x -C build/parent`, DIR
build/parent/ertdx_torch/csrc; its entry points take no launch plan).
tools/core_ab.py's build(), one nvcc per variant, all started together,
into build/gn_ab/. PLAN_VARIANTS are the base library under another
launch plan (ops/groupnorm.py::launch_plan's block sizes or budget).

Then, in turns (the variants in order, then in reverse), times with CUDA
events groupnorm_silu's forward and backward at the stem (256, 587, 128)
and at (256, 294, 256), and gn_silu_conv3's forward and backward at
chip_smoke.py's first two phase-10 shapes, (256, 294, 256 -> 256) and
(256, 147, 256 -> 256); prints at each GN shape the max abs error of y,
dx, dgamma and dbeta against the plain version with its gate and whether
reruns are bit-identical, and in the first turn the fused conv
backward's launches one by one (the statistics and the GN backward among
them). Beside them, torch's copy_ of the stem's x (the bytes a forward
reads and writes, by a library copy). With --train it also runs phase 11
(a) of chip_smoke.py (5 b256 steps of the fused-encoder arm, kernel path
against plain path) through each variant. The "diag_" variants compute
wrong results on purpose: they remove work to show its cost. Nothing
here is imported by the port; it needs nvcc and a card.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import sys
import time
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs                                    # noqa: E402
import conv_ab                                             # noqa: E402
import core_ab                                             # noqa: E402
from ertdx_torch.ops import _build, conv as cv             # noqa: E402
from ertdx_torch.ops import groupnorm as gn                # noqa: E402

OUT = os.path.join(ROOT, "build", "gn_ab")
SOURCES = ("groupnorm.cu", "gn_conv.cu")
ENTRY_POINTS = ("ertdx_gn_silu_fwd", "ertdx_gn_silu_bwd",
                "ertdx_gn_conv3_fwd", "ertdx_gn_conv3_bwd")
GN_SHAPES = [(256, 587, 128), (256, 294, 256)]
CONV_SHAPES = [(256, 294, 256, 256), (256, 147, 256, 256)]
GROUPS = cs.GROUPS
# the arguments of the entry points before the launch plan (the rest is
# the plan's three ints per GN launch, then the stream), and how many
# plans each takes: the earlier entry points take none
_PLAIN_ARGS = {"ertdx_gn_silu_fwd": (9, 1), "ertdx_gn_silu_bwd": (12, 1),
               "ertdx_gn_conv3_fwd": (13, 1), "ertdx_gn_conv3_bwd": (19, 2)}

_FWD_LAUNCH = "gn_fwd_staged_kernel<4><<<B * G, p.threads, p.smem, s>>>("
# the forward staged in registers: at most REG_UNITS units a thread, so
# only for shapes with L / (T / U) <= REG_UNITS (both GN_SHAPES)
_REGS_KERNEL = """// the forward with each thread's units in registers (no shared tile)
constexpr int REG_UNITS = 12;
template <int W>
__global__ void __launch_bounds__(GN_MAX_THREADS)
    gn_fwd_regs_kernel(const float* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       float* __restrict__ out, int L, int C, int G,
                       float eps) {
  __shared__ float red[2 * GN_MAX_THREADS / 32];
  const GroupWalk w = group_walk<W>(L, C, G);
  const float n = (float)w.L * (float)(w.U * W);
  float v[REG_UNITS][W];
#pragma unroll
  for (int j = 0; j < REG_UNITS; ++j) {
    const int l = w.l0 + j * w.R;
    if (l < w.L) {
      load_w<W>(v[j], x + w.global(l));
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) v[j][k] = 0.f;
    }
  }
  Moments m;
  m.shift = x[w.base];
  float a[W] = {};
#pragma unroll
  for (int j = 0; j < REG_UNITS; ++j)
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (w.l0 + j * w.R < w.L) a[k] += v[j][k] - m.shift;
  m.mean = block_sum(lanes_sum<W>(a), red) / n;
  float q[W] = {};
#pragma unroll
  for (int j = 0; j < REG_UNITS; ++j)
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (w.l0 + j * w.R < w.L) {
        const float d = m.centred(v[j][k]);
        q[k] = fmaf(d, d, q[k]);
      }
  m.rstd = rsqrtf(block_sum(lanes_sum<W>(q), slot(red, 1)) / n + eps);
#pragma unroll
  for (int j = 0; j < REG_UNITS; ++j) {
    const int l = w.l0 + j * w.R;
    if (l >= w.L) continue;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float y = fmaf(m.centred(v[j][k]), m.rstd * gamma[w.ch + k],
                           beta[w.ch + k]);
      v[j][k] = y * gn_sigmoid(y);
    }
    store_w<W>(out + w.global(l), v[j]);
  }
}

}  // namespace"""

_NO_STATS = ("  const Moments m = tile_stats<W>(smem, x, w, eps, red);",
             "  const Moments m{0.f, 0.f, 1.f};\n  (void)red;")
_NO_SILU = ("      const float y = fmaf(m.centred(v[k]), sc[k], sh[k]);\n"
            "      v[k] = y * gn_sigmoid(y);", "")
_G_MAJOR = ("gn_common.cuh:  const int b = blockIdx.x / G, g = blockIdx.x % G, "
            "cg = C / G;",
            "  const int nb = gridDim.x / G, b = blockIdx.x % nb, "
            "g = blockIdx.x / nb, cg = C / G;")

VARIANTS = {
    # the forward staged in registers against shared memory (base)
    "regs_fwd": [("}  // namespace", _REGS_KERNEL),
                 (_FWD_LAUNCH, "gn_fwd_regs_kernel<4><<<B * G, p.threads, "
                               "0, s>>>(")],
    # SiLU by expf and an IEEE division (base: __expf and __fdividef)
    "ieee_silu": [("gn_common.cuh:  return __fdividef(1.f, 1.f + "
                   "__expf(-y));",
                   "  return 1.f / (1.f + expf(-y));")],
    # the statistics without the shift by the group's first value (its
    # cost; less accurate far from zero)
    "no_shift": [("gn_common.cuh:  m.shift = x[w.base];",
                  "  m.shift = 0.f;")],
    # the forward's stores evict-first (base: ordinary stores)
    "stcs_fwd": [("    store_w<W>(out + w.global(l), v);",
                  "    if constexpr (W == 4)\n"
                  "      __stcs(reinterpret_cast<float4*>(out + "
                  "w.global(l)), make_float4(v[0], v[1], v[2], v[3]));\n"
                  "    else\n      store_w<W>(out + w.global(l), v);")],
    # diagnostic: the staged forward copies x to y and does nothing else
    # (stage, wait, write): the bandwidth these bytes reach this way
    "diag_copy": [_NO_STATS, _NO_SILU],
    # diagnostic: the same copy with the groups of a batch row far apart
    # in the grid (block i owns group i / B of row i % B; every staged
    # kernel so mapped)
    "diag_copy_gmajor": [_NO_STATS, _NO_SILU, _G_MAJOR],
    # diagnostic: each thread copies its units straight from x to y (no
    # shared tile, no wait), same blocks and shared-memory reservation:
    # the access pattern without the staging order
    "diag_direct_copy": [
        ("  stage_group<W>(smem, x, w);\n  cp_async_wait_all();\n"
         "  const Moments m = tile_stats<W>(smem, x, w, eps, red);",
         "  for (int l = w.l0; l < w.L; l += w.R) {\n    float v[W];\n"
         "    load_w<W>(v, x + w.global(l));\n"
         "    store_w<W>(out + w.global(l), v);\n  }\n  return;\n"
         "  const Moments m{0.f, 0.f, 1.f};\n  (void)red;")],
}
# the base library under other launch plans: TARGET_THREADS per kind, or
# SMEM_MAX 0 (every shape streamed)
PLAN_VARIANTS = {
    "bwd_128_threads": {"TARGET_THREADS": {"bwd": 128}},
    "fwd_128_threads": {"TARGET_THREADS": {"fwd": 128, "stats": 128}},
    "fwd_512_threads": {"TARGET_THREADS": {"fwd": 512, "stats": 512}},
    "all_streamed": {"SMEM_MAX": 0},
}


class _Lib:
    """A variant's four GN entry points (for "before", adapted to the
    earlier ones, which take no launch plan); every other kernel from the
    library the port builds."""

    def __init__(self, variant, full, planless=False):
        self.variant, self.full, self.planless = variant, full, planless

    def __getattr__(self, name):
        if name not in ENTRY_POINTS:
            return getattr(self.full, name)
        fn = getattr(self.variant, name)
        if not self.planless:
            return fn
        head, plans = _PLAIN_ARGS[name]
        return lambda *a: fn(*a[:head], a[head + 3 * plans])


def _planless_signatures(lib) -> None:
    for name, (head, plans) in _PLAIN_ARGS.items():
        sig = _build.SIGNATURES[name]
        getattr(lib, name).argtypes = sig[:head] + [ctypes.c_void_p]


def _apply_plan(variant: dict) -> dict:
    """Patch ops/groupnorm.py's plan settings; returns what to restore."""
    saved = {}
    for key, value in variant.items():
        saved[key] = getattr(gn, key)
        setattr(gn, key, {**saved[key], **value} if isinstance(value, dict)
                else value)
    return saved


def gn_inputs(dev, b, l, c):
    """chip_smoke.py's phase-10 GN inputs at one shape."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 140)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    return (rnd(b, l, c, scale=2.0, shift=0.5), rnd(c, scale=0.3, shift=1.0),
            rnd(c, scale=0.3)), rnd(b, l, c)


def main() -> int:
    if not torch.cuda.is_available():
        print("gn_ab: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    before = None
    if "--before" in args:
        i = args.index("--before")
        before = args[i + 1]
        del args[i:i + 2]
    train = "--train" in args
    chosen = [a for a in args if a != "--train"] or (
        list(VARIANTS) + list(PLAN_VARIANTS))
    unknown = [a for a in chosen if a not in VARIANTS and
               a not in PLAN_VARIANTS]
    if unknown:
        print(f"gn_ab: no such variant: {unknown}", file=sys.stderr)
        return 2
    built = ["base"] + (["before"] if before else []) + [
        a for a in chosen if a in VARIANTS]
    names = built[:1] + (["before"] if before else []) + chosen
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    shutil.rmtree(OUT, ignore_errors=True)
    t0 = time.perf_counter()
    libs = core_ab.build(built, SOURCES, VARIANTS, ENTRY_POINTS, OUT, before)
    if before:
        _planless_signatures(libs["before"][0])
    card = cs.card_line()
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s"
          f"; {card}", flush=True)
    for name, (_, report) in libs.items():
        print(f"ptxas {name}: " + "; ".join(
            f"{k} " + " | ".join(cs.ptxas_lines(report, k))
            for k in cs.GN_KERNELS if cs.ptxas_lines(report, k)))

    gn_cases = []
    for shape in GN_SHAPES:
        ins, dy = gn_inputs(dev, *shape)
        with torch.no_grad():
            want = gn.reference_groupnorm_silu(*ins, GROUPS)
        dwant = gn.reference_groupnorm_silu_backward(*ins, dy, GROUPS)
        gn_cases.append((shape, ins, dy, (want, *dwant)))
    conv_cases = [(shape, *conv_ab.inputs(dev, *shape))
                  for shape in CONV_SHAPES]
    x = gn_cases[0][1][0]
    y = torch.empty_like(x)
    copy_ms = cs.time_ms(lambda: y.copy_(x))
    print(f"torch copy_ of the stem's x ({x.numel() * 4 / 1e6:.1f} MB read "
          f"and written): {copy_ms:.4f} ms, {2 * x.numel() * 4 / copy_ms / 1e6:.1f}"
          " GB/s", flush=True)
    if train:
        counts = cs._Counts(gn, cv, __import__("ertdx_torch.ops.slab_attn",
                                               fromlist=["x"]))
        cs.device_profile = lambda fn, label: None

    load = _build.load
    full = load().lib
    try:
        for turn, order in enumerate((names, names[::-1])):
            for name in order:
                lib_name = name if name in libs else "base"
                lib = types.SimpleNamespace(lib=_Lib(
                    libs[lib_name][0], full, planless=name == "before"))
                _build.load = lambda lib=lib: lib
                saved = _apply_plan(PLAN_VARIANTS.get(name, {}))
                parts = []
                try:
                    for shape, ins, dy, wants in gn_cases:
                        fwd = lambda: gn.groupnorm_silu_fwd(*ins, GROUPS)
                        bwd = lambda: gn.groupnorm_silu_bwd(*ins, dy,
                                                            GROUPS)
                        with torch.no_grad():
                            got = (fwd(), *bwd())
                            again = (fwd(), *bwd())
                            torch.cuda.synchronize()
                            f_ms, b_ms = cs.time_ms(fwd), cs.time_ms(bwd)
                        b, l, c = shape
                        errs = ", ".join(
                            f"{n} {float((a - w).abs().max()):.2e} (gate "
                            f"{1e-4 * max(1.0, float(w.abs().max())):.1e})"
                            for n, a, w in zip(("y", "dx", "dgamma",
                                                "dbeta"), got, wants))
                        same = all(torch.equal(a, w)
                                   for a, w in zip(got, again))
                        n = b * l * c * 4
                        parts.append(
                            f"GN L={l} C={c}: fwd {f_ms:.4f} ms "
                            f"({2 * n / f_ms / 1e6:.0f} GB/s), bwd "
                            f"{b_ms:.4f} ms ({3 * n / b_ms / 1e6:.0f} GB/s); "
                            f"errors {errs}; reruns bit-identical {same}")
                    for shape, ins, dy in conv_cases:
                        fwd = lambda: cv.gn_silu_conv3_fwd(*ins, GROUPS)
                        bwd = lambda: cv.gn_silu_conv3_bwd(*ins[:4], dy,
                                                           GROUPS)
                        with torch.no_grad():
                            f_ms, b_ms = cs.time_ms(fwd), cs.time_ms(bwd)
                        text = (f"conv L={shape[1]}: fwd {f_ms:.4f} ms, bwd "
                                f"{b_ms:.4f} ms")
                        if turn == 0 and shape == CONV_SHAPES[0]:
                            text += "; bwd launches " + cs.launch_times(bwd)
                        parts.append(text)
                except RuntimeError as exc:
                    parts.append(f"failed ({exc})")
                finally:
                    _apply_plan(saved)
                print(f"[{turn}] {name}: " + "; ".join(parts), flush=True)
                if train and turn == 0 and not name.startswith("diag_"):
                    saved = _apply_plan(PLAN_VARIANTS.get(name, {}))
                    try:
                        cs.check_fused_training(counts, dev, card)
                    except RuntimeError as exc:
                        print(f"  phase 11 (a) with {name}: failed: {exc}",
                              flush=True)
                    finally:
                        _apply_plan(saved)
    finally:
        _build.load = load
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
