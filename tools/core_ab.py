#!/usr/bin/env python3
"""A/B of fused-core kernel variants on one NVIDIA GPU.

    python3 tools/core_ab.py [--draws] [name ...]

Builds ertdx_torch/csrc/core_block.cu as it stands ("base") and in the
variants of VARIANTS below, each a list of exact text substitutions in
core_block.cu or (prefix "H:") tf32x3.cuh, one nvcc per variant, all
started together, into build/core_ab/. Then, in turns (the variants in
order, then in reverse), times fused_core_stack at B=8, R=1000 and
fused_core_block at B=2, R=1000 (chip_smoke.py's phase-3 inputs, CUDA
events) and prints each variant's max abs error against the plain
version and whether a rerun is bit-identical. With --draws it also runs
phase 4's configs[3] DDIM-50 ensemble through each variant and prints
the draws' gaps to the plain module path. The "diag_" variants compute
wrong results on purpose: they remove one kind of work to show its
cost. A variant whose build spills is reported and timed all the same.
Nothing here is imported by the port; it needs nvcc and a card.
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
_UNROLL = "#pragma unroll 2\n  for (int kk = 0; kk < KC; kk += 8) {"
_BNN = """  split(p[0], f.hi[0], f.lo[0]);
  split(p[ld], f.hi[1], f.lo[1]);"""

VARIANTS = {
    # how a product's k steps add up (base: each 32-deep chunk from zero,
    # added in fp32)
    "acc_on_mma": [
        (_PART, "      chunk_mma<NTB>(acc, A, lda, ch * KC, cur, "
                "NTB ? LDK : LDW);"),
        (_TILE_PART, "    chunk_mma<NTB>(acc, A, lda, k0, NTB ? Bs + k0 "
                     ": Bs + k0 * ldb, ldb);")],
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
    # diagnostics: wrong results, one kind of work removed
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


def build(names, source="core_block.cu", variants=None,
          entry_points=("ertdx_core_stack", "ertdx_core_block"), out=OUT,
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
    source, or, where `before` is a directory, every source and header
    found there by name. Used by tools/ensemble_ab.py, tools/conv_ab.py
    and tools/gn_ab.py too."""
    variants = VARIANTS if variants is None else variants
    sources = [source] if isinstance(source, str) else list(source)
    files = {f: open(os.path.join(CSRC, f)).read()
             for f in os.listdir(CSRC) if f.endswith(".cuh")}
    files.update({f: open(os.path.join(CSRC, f)).read() for f in sources})
    procs = {}
    for name in names:
        text = dict(files)
        if name == "before" and os.path.isdir(before):
            text.update({f: open(os.path.join(before, f)).read()
                         for f in os.listdir(before) if f in text})
        elif name == "before":
            text[sources[0]] = open(before).read()
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
             *[os.path.join(d, f) for f in sources]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{report[-3000:]}")
        lib = ctypes.CDLL(os.path.join(out, name, "lib.so"))
        for fn in entry_points:
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, report)
    return libs


def draws_setup(dev):
    """Phase 4's model, conditions and x_T, and the plain path's draws."""
    from ertdx_torch import configs, sample
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.models import build_model
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax

    cfg = configs.DDIM_ENSEMBLE
    model = build_model(cfg.model, device=dev).eval()
    rng = np.random.default_rng(cs.SEED)
    params_from_jax(model, cs.random_flax_tree(flax_shapes(model), rng))
    schedule = schedule_from_config(cfg.diffusion)
    cond = torch.from_numpy(rng.standard_normal(
        (8, cfg.model.cond_length, cfg.model.cond_channels)
    ).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    x_T = torch.randn(8 * 1000, cfg.model.param_dim, generator=gen,
                      device=dev)

    def run():
        return sample.posterior_ensemble(model, cond, schedule, 1000,
                                         cfg.sample, x_T=x_T, device=dev)

    model.ensemble_mega = False
    plain = run()
    model.ensemble_mega = True
    return run, plain


def main() -> int:
    if not torch.cuda.is_available():
        print("core_ab: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    draws = "--draws" in args
    names = ["base"] + ([a for a in args if a != "--draws"]
                        or list(VARIANTS))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = build(names)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s"
          f"; {cs.card_line()}", flush=True)
    for name, (_, report) in libs.items():
        print(f"ptxas {name}: " + "; ".join(
            f"{k}: " + " | ".join(cs.ptxas_lines(report, k))
            for k in cs.CORE_KERNELS))

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    a = cs.core_inputs(gen, 8, 1000, cs.NB, dev)
    stack_args = (a["x"], a["mods"], a["k"], a["v"], a["ws"], a["lift_w"],
                  a["lift_b"], a["pos_emb"], a["on_scale"], a["on_bias"],
                  a["head_w"], a["head_b"])
    a = cs.core_inputs(gen, 2, 1000, 1, dev)
    block_args = (a["x3"], a["mods"][:, :6].contiguous(), a["k"], a["v"],
                  {key: val[0].contiguous() for key, val in a["ws"].items()})
    stack = lambda: cb.fused_core_stack(*stack_args, p=cs.P, chunk=1000)
    block = lambda: cb.fused_core_block(*block_args, p=cs.P, chunk=1000)
    with torch.no_grad():
        stack_want = cb.fused_core_stack_plain(*stack_args, p=cs.P)
        block_want = cb.fused_core_block_plain(*block_args, p=cs.P)
    run, plain = draws_setup(dev) if draws else (None, None)

    load = _build.load
    try:
        for turn, order in enumerate((names, names[::-1])):
            for name in order:
                lib = types.SimpleNamespace(lib=libs[name][0])
                _build.load = lambda lib=lib: lib
                with torch.no_grad():
                    got, again, got_b = stack(), stack(), block()
                    torch.cuda.synchronize()
                    stack_ms, block_ms = cs.time_ms(stack), cs.time_ms(block)
                line = (f"[{turn}] {name}: stack {stack_ms:.3f} ms, error "
                        f"{float((got - stack_want).abs().max()):.3e}, "
                        f"rerun bit-identical {torch.equal(got, again)}; "
                        f"block {block_ms:.3f} ms, error "
                        f"{float((got_b - block_want).abs().max()):.3e}")
                if draws and turn == 0:
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
