#!/usr/bin/env python3
"""A/B of fused-core kernel variants on one NVIDIA GPU.

    python3 tools/core_ab.py [--onepass] [--draws] [--before PATH]
                             [name ...]

Builds ertdx_torch/csrc/core_block.cu (the 3xTF32 kernels) and
core_onepass.cu (the one-pass kernels) as they stand ("base") and in the
variants of VARIANTS below, each a list of exact text substitutions in
core_block.cu or (prefix "H:") tf32x3.cuh, one nvcc per variant, all
started together, into build/core_ab/. Then, in turns (the variants in
order, then in reverse), times fused_core_stack at B=8, R=1000 and
fused_core_block at B=2, R=1000 (chip_smoke.py's phase-3 inputs, CUDA
events) and prints each variant's max abs error against the plain
version and whether a rerun is bit-identical. The mode is the 3xTF32
one (accurate=True; the VARIANTS change its products, the "onepass_"
ones the one-pass kernels'), or with
--onepass the one-pass mode (accurate=False, JAX's default; its weights
packed once, as the main path packs them), against its plain one-pass
version, with the rms error against the float64 function beside the
plain one-pass version's and the share of the bf16 bound. With --draws
it also runs phase 4's configs[3] DDIM-50 ensemble in that mode through
each variant and prints the draws' gaps to the plain module path.

--before PATH builds an earlier tree's core kernels as the variant
"before" (alone with base where no variant is named): PATH is a
core_block.cu, or a directory of an earlier csrc (e.g. the parent's:
`git archive HEAD~1 ertdx_torch/csrc | tar -x -C build/parent`, PATH
build/parent/ertdx_torch/csrc), whose sources of this tree's names
replace this tree's, with its own headers. It says whether this tree's
accurate=True output is bit for bit before's on every case of
chip_smoke.py's phase 3, and times before in the mode asked for: with
--onepass the earlier tree's one-pass entry points, called with their
own float32 arguments (PARENT_ONEPASS; the mma.sync one-pass kernels of
the tree before the wgmma ones), in turns beside this tree's. The
"diag_" variants compute wrong results on purpose: they remove one kind
of work to show its cost. A variant whose build spills is reported and
timed all the same. Nothing here is imported by the port; it needs nvcc
and a card.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs                                    # noqa: E402
from ertdx_torch.ops import _build, core_block as cb       # noqa: E402

CSRC = os.path.join(ROOT, "ertdx_torch", "csrc")
OUT = os.path.join(ROOT, "build", "core_ab")

_PART = """      float part[MT][NT][4];
      zero(part);
      chunk_mma<NTB>(part, A, lda, ch * KC, cur, NTB ? LDK : LDW);
      add_part(acc, part);"""
_TILE_PART = """    float part[MT][NT][4];
    zero(part);
    chunk_mma<NTB>(part, A, lda, k0, NTB ? Bs + k0 : Bs + k0 * ldb, ldb);
    add_part(acc, part);"""
_MMA3 = "      for (int i = 0; i < MT; ++i) mma3(part[i][j], a[i], f);"
_TILES = "constexpr int WM = 32, WN = 16;"
_PROJ = """#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wg::mma_rs<0>(acc, a[kk], kmajor(tile, BOX, 0, kk));"""
_UNROLL = "#pragma unroll 2\n  for (int kk = 0; kk < KC; kk += 8) {"
_BNN = """  split(p[0], f.hi[0], f.lo[0]);
  split(p[ld], f.hi[1], f.lo[1]);"""

VARIANTS = {
    # how a product's k steps add up (base: each 32-deep chunk from zero,
    # added in fp32)
    "acc_on_mma": [
        (_PART, "      chunk_mma<NTB>(acc, A, lda, ch * KC, cur, "
                "NTB ? LDK : LDW);"),
        (_TILE_PART, "    chunk_mma<NTB>(acc, A, lda, k0, NTB ? "
                     "Bs + k0 : Bs + k0 * ldb, ldb);")],
    "acc_per_step": [
        (_MMA3, "      for (int i = 0; i < MT; ++i) "
                "mma3_add(part[i][j], a[i], f);")],
    # warp tiles of the 64 x 128 outputs (base: 16 warps of 32 x 16)
    "tiles_8w_16x64": [(_TILES, "constexpr int WM = 16, WN = 64;")],
    "tiles_8w_32x32": [(_TILES, "constexpr int WM = 32, WN = 32;")],
    "unroll_chunk": [(_UNROLL, _UNROLL.replace("unroll 2", "unroll"))],
    # 32-row tiles (one chain of 29) of 8 warps and 16-deep chunks: 107 KB
    # of shared memory, so two blocks an SM hide each other's barriers
    "rows32_2_blocks": [
        ("constexpr int ROWS = 64;", "constexpr int ROWS = 32;"),
        ("constexpr int KC = 32;", "constexpr int KC = 16;"),
        ("__launch_bounds__(THREADS)\ncore_stack_kernel",
         "__launch_bounds__(THREADS, 2)\ncore_stack_kernel"),
        ("__launch_bounds__(THREADS)\ncore_block_kernel",
         "__launch_bounds__(THREADS, 2)\ncore_block_kernel")],
    "no_idle_skip": [
        ("const bool idle = NTB && b.n0 + warp_col0() >= b.valid;",
         "const bool idle = false;")],
    # the one-pass kernels (time with --onepass): each projection as two
    # m64n64k16 products over the weight tile's two 64-row halves (base:
    # one m64n128k16)
    "onepass_proj_n64": [
        ("core_onepass.cu:" + _PROJ, """  float (&lo)[32] = *reinterpret_cast<float (*)[32]>(&acc[0]);
  float (&hi)[32] = *reinterpret_cast<float (*)[32]>(&acc[32]);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wg::mma_rs<0>(lo, a[kk], kmajor(tile, BOX, 0, kk));
    wg::mma_rs<0>(hi, a[kk], kmajor(tile, BOX, 64, kk));
  }""")],
    # diagnostics: wrong results, one kind of work removed
    "diag_onepass_no_proj_mma": [
        ("core_onepass.cu:" + _PROJ, """#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    acc[kk] += __uint_as_float(a[kk][0] & 0x007fffffu);""")],
    "diag_no_mma": [
        (_MMA3, "      for (int i = 0; i < MT; ++i) part[i][j][0] += "
                "__uint_as_float(a[i].lo[0] + a[i].hi[1] + f.lo[0] + "
                "f.hi[1]);")],
    "diag_no_barrier": [
        ("    __syncthreads();                   // chunk ch has landed "
         "for every thread\n", "")],
    "diag_no_b_split": [
        ("H:" + _BNN, "  f.hi[0] = __float_as_uint(p[0]);\n  f.lo[0] = 0u;"
                      "\n  f.hi[1] = __float_as_uint(p[ld]);\n"
                      "  f.lo[1] = 0u;")],
}


# the C signatures of the one-pass entry points of the tree before the
# wgmma kernels (core_block.cu's mma.sync instances): the 3xTF32 entry
# points' float32 arguments
PARENT_ONEPASS = {"ertdx_core_stack_onepass":
                  _build.SIGNATURES["ertdx_core_stack"],
                  "ertdx_core_block_onepass":
                  _build.SIGNATURES["ertdx_core_block"]}


def build(names, source=("core_block.cu", "core_onepass.cu"), variants=None,
          entry_points=("ertdx_core_stack", "ertdx_core_block",
                        "ertdx_core_stack_onepass",
                        "ertdx_core_block_onepass"), out=OUT,
          before=None) -> dict:
    """name -> (the variant's library, ptxas' report). Each variant is
    `source` (in csrc/; a list of sources builds them into one library)
    with the text substitutions of `variants` (this file's VARIANTS by
    default; "base" has none), written with csrc's headers into
    out/<name>/ and built by one nvcc per variant, all started together;
    `entry_points` get their ctypes signatures. A substitution applies to
    the first source, or to tf32x3.cuh with the prefix "H:", or to any
    other source or header named as a prefix ("gn_common.cuh:..."). The
    variant "before" takes the file at the path `before` for the first
    source (and builds it alone), or, where `before` is a directory,
    every source and header found there by name (and builds the sources
    found there). Used by tools/ensemble_ab.py, tools/conv_ab.py and
    tools/gn_ab.py too."""
    variants = VARIANTS if variants is None else variants
    sources = [source] if isinstance(source, str) else list(source)
    files = {f: open(os.path.join(CSRC, f)).read()
             for f in os.listdir(CSRC) if f.endswith(".cuh")}
    files.update({f: open(os.path.join(CSRC, f)).read() for f in sources})
    procs = {}
    for name in names:
        text = dict(files)
        built = sources
        if name == "before" and os.path.isdir(before):
            text.update({f: open(os.path.join(before, f)).read()
                         for f in os.listdir(before) if f in text})
            built = [f for f in sources if f in os.listdir(before)]
        elif name == "before":
            text[sources[0]] = open(before).read()
            built = sources[:1]
        for old, new in ([] if name in ("base", "before")
                         else variants[name]):
            target, sep, rest = old.partition(":")
            if old.startswith("H:"):
                target, old = "tf32x3.cuh", old[2:]
            elif sep and target in text:
                old = rest
            else:
                target = sources[0]
            if text[target].count(old) != 1:
                raise SystemExit(f"{name}: the text to replace is not found "
                                 f"once in {target}: {old[:60]!r}")
            text[target] = text[target].replace(old, new)
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        for f, body in text.items():
            open(os.path.join(d, f), "w").write(body)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
             os.path.join(d, "lib.so"),
             *[os.path.join(d, f) for f in built]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{report[-3000:]}")
        lib = ctypes.CDLL(os.path.join(out, name, "lib.so"))
        for fn in entry_points:
            if name == "before" and not hasattr(lib, fn):
                continue           # an entry point the earlier tree lacks
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, report)
    return libs


def draws_setup(dev, accurate: bool):
    """Phase 4's model (the fused core in the mode `accurate` selects),
    conditions and x_T, and the plain path's draws."""
    from ertdx_torch import sample
    from ertdx_torch.diffusion import schedule_from_config

    cfg, model, cond, x_T = cs.serving_setup(dev)
    model.ensemble_mega_accurate = accurate
    schedule = schedule_from_config(cfg.diffusion)

    def run():
        return sample.posterior_ensemble(model, cond, schedule, 1000,
                                         cfg.sample, x_T=x_T, device=dev)

    model.ensemble_mega = False
    plain = run()
    model.ensemble_mega = True
    return run, plain


def same_as_before(libs, dev) -> list:
    """For each case of chip_smoke.py's phase 3 (its inputs, drawn in its
    order from its seed): whether base's accurate=True output equals
    before's bit for bit. Sets _build.load; the caller restores it."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    out = []
    for name, b, r, p, lk in cs.KERNEL_CASES:
        stack = name == "fused_core_stack"
        a = cs.core_inputs(gen, b, r, cs.NB if stack else 1, dev, p, lk)
        if stack:
            args = (a["x"], a["mods"], a["k"], a["v"], a["ws"], a["lift_w"],
                    a["lift_b"], a["pos_emb"], a["on_scale"], a["on_bias"],
                    a["head_w"], a["head_b"])
            fn = cb.fused_core_stack
        else:
            args = (a["x3"], a["mods"][:, :6].contiguous(), a["k"], a["v"],
                    {key: val[0].contiguous() for key, val in a["ws"].items()})
            fn = cb.fused_core_block
        got = {}
        for lib_name in ("base", "before"):
            lib = types.SimpleNamespace(lib=libs[lib_name][0])
            _build.load = lambda lib=lib: lib
            with torch.no_grad():
                got[lib_name] = fn(*args, p=p, chunk=r, accurate=True)
        out.append(f"{name} B={b} R={r} P={p} Lk={lk} "
                   f"{torch.equal(got['base'], got['before'])}")
    return out


def parent_onepass(lib, stack: bool, args, p: int):
    """The earlier tree's one-pass kernel (PARENT_ONEPASS) on `args`, the
    wrappers' arguments, called as its wrapper called it."""
    if stack:
        x, mods, k, v, ws, *rest = args
        tensors = [x, mods, k, v, *(ws[key] for key in cb.WEIGHT_KEYS),
                   *rest]
        fn, nb = lib.ertdx_core_stack_onepass, ws["wqkv"].shape[0]
    else:
        x, mods, k, v, w = args
        tensors = [x, mods, k, v, *(w[key] for key in cb.WEIGHT_KEYS)]
        fn = lib.ertdx_core_block_onepass
    out = torch.empty_like(x)
    b, lk = mods.shape[0], k.shape[1]
    rr = x.shape[0] // b * (x.shape[1] if stack else x.shape[1] // p)
    stream = torch.cuda.current_stream().cuda_stream
    ints = (b, rr, p, nb, lk) if stack else (b, rr, p, lk)
    _build.raise_on(fn(*(t.data_ptr() for t in tensors), out.data_ptr(),
                       *ints, stream), "parent one-pass kernel")
    return out


def rms(a) -> float:
    return float(a.double().square().mean().sqrt())


def main() -> int:
    if not torch.cuda.is_available():
        print("core_ab: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    draws, onepass = "--draws" in args, "--onepass" in args
    before = args[args.index("--before") + 1] if "--before" in args \
        else None
    asked = [a for a in args if not a.startswith("--") and a != before]
    names = ["base"] + (asked or ([] if before else list(VARIANTS))) + \
        (["before"] if before else [])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = build(names, before=before)
    if before:
        for fn, argtypes in PARENT_ONEPASS.items():
            if hasattr(libs["before"][0], fn):
                getattr(libs["before"][0], fn).argtypes = argtypes
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s"
          f"; {cs.card_line()}", flush=True)
    for name, (_, report) in libs.items():
        print(f"ptxas {name}: " + "; ".join(
            f"{k}: " + " | ".join(cs.ptxas_lines(report, k))
            for k in cs.CORE_KERNELS + cs.CORE_ONEPASS_KERNELS))

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    a = cs.core_inputs(gen, 8, 1000, cs.NB, dev)
    stack_args = (a["x"], a["mods"], a["k"], a["v"], a["ws"], a["lift_w"],
                  a["lift_b"], a["pos_emb"], a["on_scale"], a["on_bias"],
                  a["head_w"], a["head_b"])
    stack_packed = cb.pack_core_weights(a["ws"])
    flops = {"stack": cs.NB * 8 * 1000 * cs.P * 2 * cs.D * (
        14 * cs.D + 2 * cs.P + 2 * cs.LK)}
    a = cs.core_inputs(gen, 2, 1000, 1, dev)
    block_args = (a["x3"], a["mods"][:, :6].contiguous(), a["k"], a["v"],
                  {key: val[0].contiguous() for key, val in a["ws"].items()})
    block_packed = cb.pack_core_weights(block_args[4])
    flops["block"] = 2 * 1000 * cs.P * 2 * cs.D * (
        14 * cs.D + 2 * cs.P + 2 * cs.LK)
    accurate = not onepass
    stack_exact = block_exact = None
    with torch.no_grad():
        if onepass:
            stack_want = cb.fused_core_stack_onepass_plain(*stack_args,
                                                           p=cs.P)
            block_want = cb.fused_core_block_onepass_plain(*block_args,
                                                           p=cs.P)
            stack_exact = cb.fused_core_stack_plain(
                *cs._double(stack_args), p=cs.P)
            block_exact = cb.fused_core_block_plain(
                *cs._double(block_args), p=cs.P)
        else:
            stack_want = cb.fused_core_stack_plain(*stack_args, p=cs.P)
            block_want = cb.fused_core_block_plain(*block_args, p=cs.P)
    run, plain = draws_setup(dev, accurate) if draws else (None, None)
    print(f"mode: {'one-pass (accurate=False)' if onepass else '3xTF32'}",
          flush=True)

    def runners(name):
        lib = libs[name][0]
        if name == "before" and onepass:
            return (lambda: parent_onepass(lib, True, stack_args, cs.P),
                    lambda: parent_onepass(lib, False, block_args, cs.P))
        kw = {"accurate": accurate}
        if onepass:
            return (lambda: cb.fused_core_stack(
                        *stack_args, p=cs.P, chunk=1000,
                        packed=stack_packed, **kw),
                    lambda: cb.fused_core_block(
                        *block_args, p=cs.P, chunk=1000,
                        packed=block_packed, **kw))
        return (lambda: cb.fused_core_stack(*stack_args, p=cs.P, chunk=1000,
                                            **kw),
                lambda: cb.fused_core_block(*block_args, p=cs.P, chunk=1000,
                                            **kw))

    def error_text(got, want, exact) -> str:
        if not onepass:
            return f"error {float((got - want).abs().max()):.3e}"
        return (f"rms error vs float64 {rms(got - exact):.3e} (plain "
                f"one-pass {rms(want - exact):.3e}), max "
                f"{float((got - exact).abs().max()):.3e}")

    load = _build.load
    try:
        if before:
            print("accurate=True bit for bit before's on phase 3's cases: "
                  + "; ".join(same_as_before(libs, dev)), flush=True)
        for turn, order in enumerate((names, names[::-1])):
            for name in order:
                lib = types.SimpleNamespace(lib=libs[name][0])
                _build.load = lambda lib=lib: lib
                stack, block = runners(name)
                with torch.no_grad():
                    got, again, got_b = stack(), stack(), block()
                    torch.cuda.synchronize()
                    stack_ms, block_ms = cs.time_ms(stack), cs.time_ms(block)
                bound = {k: f / cs.PEAK_BF16_FLOPS * 1e3
                         for k, f in flops.items()}
                share = (f"; share of the bf16 bound stack "
                         f"{100 * bound['stack'] / stack_ms:.1f} %, block "
                         f"{100 * bound['block'] / block_ms:.1f} %"
                         if onepass else "")
                line = (f"[{turn}] {name}: stack {stack_ms:.3f} ms, "
                        f"{error_text(got, stack_want, stack_exact)}, "
                        f"rerun bit-identical {torch.equal(got, again)}; "
                        f"block {block_ms:.3f} ms, "
                        f"{error_text(got_b, block_want, block_exact)}"
                        + share)
                if draws and turn == 0 and name != "before":
                    u = run()
                    line += "; draws vs plain du %.3e dmean %.3e dstd %.3e" % (
                        float((u - plain).abs().max()),
                        float((u.mean(0) - plain.mean(0)).abs().max()),
                        float((u.std(0) - plain.std(0)).abs().max()))
                print(line, flush=True)
    finally:
        _build.load = load
    return 0


if __name__ == "__main__":
    sys.exit(main())
