#!/usr/bin/env python3
"""A/B of fused-core kernel variants on one NVIDIA GPU.

    python3 tools/core_ab.py [--onepass] [--draws] [--before PATH]
                             [name ...]

Builds ertdx_torch/csrc/core_onepass.cu (the fused core's kernels in
both of JAX's modes: bf16_3x for accurate=True, one pass for
accurate=False) as it stands ("base") and in the variants of VARIANTS
below, each a list of exact text substitutions in it, one nvcc per
variant, all started together, into build/core_ab/. Then, in turns (the
variants in order, then in reverse), times fused_core_stack at B=8,
R=1000 and fused_core_block at B=2, R=1000 (chip_smoke.py's phase-3
inputs, CUDA events, the weights packed and K and V rounded once, as the
main path makes them) and prints each variant's error against the mode's
plain version: the bf16_3x mode (accurate=True, the default here) its
max abs gap to the plain bf16_3x version, or with --onepass the one-pass
mode (accurate=False, JAX's default), the rms error against the float64
function beside the plain one-pass version's; both with the share of the
bf16 bound (three passes a product with accurate=True) and whether a
rerun is bit-identical. With --draws it also runs phase 4's configs[3]
DDIM-50 ensemble in that mode through each variant and prints the draws'
gaps to the plain module path.

--before PATH builds an earlier tree's kernels of the mode as the variant
"before" (alone with base where no variant is named): PATH is a
directory of an earlier csrc (e.g. the parent's: `git archive HEAD~1
ertdx_torch/csrc | tar -x -C build/parent`, PATH
build/parent/ertdx_torch/csrc), whose core_block.cu (accurate=True: the
3xTF32 pair that the bf16_3x kernels replaced; PARENT_ACCURATE) or
core_onepass.cu (--onepass) is built with its own headers, and timed in
turns beside this tree's, called with its own float32 arguments. The
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

_PROJ = """#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wg::mma_rs<0>(acc, a[kk], kmajor(tile, BOX, 0, kk));"""
# project3's body: the lo stage's pass waited for and released before
# the hi stage's two passes
_PROJ3 = """  uint32_t tile = f.acquire(j);
  wg::fence_regs(acc);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wg::mma_rs<0>(acc, ah[kk], kmajor(tile, BOX, 0, kk));
  complete();
  f.release(j);
  tile = f.acquire(j + 1);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wg::mma_rs<0>(acc, ah[kk], kmajor(tile, BOX, 0, kk));
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wg::mma_rs<0>(acc, al[kk], kmajor(tile, BOX, 0, kk));
  complete();
  wg::fence_regs(acc);
  f.release(j + 1);"""

VARIANTS = {
    # the one-pass kernels (time with --onepass): each projection as two
    # m64n64k16 products over the weight tile's two 64-row halves (base:
    # one m64n128k16)
    "onepass_proj_n64": [
        (_PROJ, """  float (&lo)[32] = *reinterpret_cast<float (*)[32]>(&acc[0]);
  float (&hi)[32] = *reinterpret_cast<float (*)[32]>(&acc[32]);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wg::mma_rs<0>(lo, a[kk], kmajor(tile, BOX, 0, kk));
    wg::mma_rs<0>(hi, a[kk], kmajor(tile, BOX, 64, kk));
  }""")],
    # the bf16_3x kernels: a projection's lo and hi stages acquired
    # together, its three passes one group, waited for once (base: two
    # groups, the lo stage released before the hi stage is taken)
    "x3_one_group": [
        (_PROJ3, """  const uint32_t lo = f.acquire(j), hi = f.acquire(j + 1);
  wg::fence_regs(acc);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wg::mma_rs<0>(acc, ah[kk], kmajor(lo, BOX, 0, kk));
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wg::mma_rs<0>(acc, ah[kk], kmajor(hi, BOX, 0, kk));
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wg::mma_rs<0>(acc, al[kk], kmajor(hi, BOX, 0, kk));
  complete();
  wg::fence_regs(acc);
  f.release(j);
  f.release(j + 1);""")],
    # diagnostics: wrong results, one kind of work removed
    "diag_onepass_no_proj_mma": [
        (_PROJ, """#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    acc[kk] += __uint_as_float(a[kk][0] & 0x007fffffu);""")],
    "diag_x3_hi_pass_only": [
        (_PROJ3, _PROJ3.replace("""#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wg::mma_rs<0>(acc, al[kk], kmajor(tile, BOX, 0, kk));
""", ""))],
}


# the C signatures of the parent tree's 3xTF32 entry points
# (core_block.cu, gone with this tree's bf16_3x kernels): float32 inputs
# as the JAX package's wrappers take them, the output, then B, R, P,
# (nb,) Lk and the stream
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_ACCURATE = {"ertdx_core_stack": [_P] * 22 + [_I] * 5 + [_P],
                   "ertdx_core_block": [_P] * 15 + [_I] * 4 + [_P]}
ENTRY_POINTS = ("ertdx_core_stack_onepass", "ertdx_core_block_onepass",
                "ertdx_core_stack_bf16x3", "ertdx_core_block_bf16x3")


def build(names, source="core_onepass.cu", variants=None,
          entry_points=ENTRY_POINTS, out=OUT, before=None,
          before_sources=None) -> dict:
    """name -> (the variant's library, ptxas' report). Each variant is
    `source` (in csrc/; a list of sources builds them into one library)
    with the text substitutions of `variants` (this file's VARIANTS by
    default; "base" has none), written with csrc's headers into
    out/<name>/ and built by one nvcc per variant, all started together;
    `entry_points` get their ctypes signatures. A substitution applies to
    the first source, or to any other source or header named as a prefix
    ("gn_common.cuh:..."). The
    variant "before" takes the file at the path `before` for the first
    source (and builds it alone), or, where `before` is a directory,
    every source and header found there by name (and builds the sources
    found there, or `before_sources`, read from there). Used by
    tools/ensemble_ab.py, tools/conv_ab.py and tools/gn_ab.py too."""
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
                         for f in os.listdir(before)
                         if f in text or f in (before_sources or ())})
            built = list(before_sources or
                         [f for f in sources if f in os.listdir(before)])
        elif name == "before":
            text[sources[0]] = open(before).read()
            built = sources[:1]
        for old, new in ([] if name in ("base", "before")
                         else variants[name]):
            target, sep, rest = old.partition(":")
            if sep and target in text:
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


def parent_call(fn, stack: bool, args, p: int):
    """An earlier tree's float32-argument entry point `fn` (the 3xTF32
    pair, PARENT_ACCURATE, or an earlier one-pass pair of that signature)
    on `args`, the wrappers' arguments, called as its wrapper called
    it."""
    if stack:
        x, mods, k, v, ws, *rest = args
        tensors = [x, mods, k, v, *(ws[key] for key in cb.WEIGHT_KEYS),
                   *rest]
        nb = ws["wqkv"].shape[0]
    else:
        x, mods, k, v, w = args
        tensors = [x, mods, k, v, *(w[key] for key in cb.WEIGHT_KEYS)]
    out = torch.empty_like(x)
    b, lk = mods.shape[0], k.shape[1]
    rr = x.shape[0] // b * (x.shape[1] if stack else x.shape[1] // p)
    stream = torch.cuda.current_stream().cuda_stream
    ints = (b, rr, p, nb, lk) if stack else (b, rr, p, lk)
    _build.raise_on(fn(*(t.data_ptr() for t in tensors), out.data_ptr(),
                       *ints, stream), "earlier tree's kernel")
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
    accurate = not onepass
    t0 = time.perf_counter()
    libs = build(names, before=before,
                 before_sources=["core_onepass.cu" if onepass
                                 else "core_block.cu"])
    if before:
        parent = {"ertdx_core_stack_onepass": None,
                  "ertdx_core_block_onepass": None} if onepass else \
            PARENT_ACCURATE
        for fn, argtypes in parent.items():
            f = getattr(libs["before"][0], fn)
            f.argtypes = argtypes or _build.SIGNATURES[fn]
            f.restype = ctypes.c_int
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s"
          f"; {cs.card_line()}", flush=True)
    for name, (_, report) in libs.items():
        print(f"ptxas {name}: " + "; ".join(
            f"{k}: " + " | ".join(cs.ptxas_lines(report, k))
            for k in cs.CORE_KERNELS + cs.CORE_ONEPASS_KERNELS
            + ("core_stack_kernel", "core_block_kernel")))

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    a = cs.core_inputs(gen, 8, 1000, cs.NB, dev)
    stack_args = (a["x"], a["mods"], a["k"], a["v"], a["ws"], a["lift_w"],
                  a["lift_b"], a["pos_emb"], a["on_scale"], a["on_bias"],
                  a["head_w"], a["head_b"])
    flops = {"stack": cs.NB * 8 * 1000 * cs.P * 2 * cs.D * (
        14 * cs.D + 2 * cs.P + 2 * cs.LK)}
    a = cs.core_inputs(gen, 2, 1000, 1, dev)
    block_args = (a["x3"], a["mods"][:, :6].contiguous(), a["k"], a["v"],
                  {key: val[0].contiguous() for key, val in a["ws"].items()})
    flops["block"] = 2 * 1000 * cs.P * 2 * cs.D * (
        14 * cs.D + 2 * cs.P + 2 * cs.LK)
    pack = cb.pack_core_weights_3x if accurate else cb.pack_core_weights
    stack_packed, block_packed = pack(stack_args[4]), pack(block_args[4])
    stack_kv = cb.kv_operands(stack_args[2], stack_args[3], accurate)
    block_kv = cb.kv_operands(block_args[2], block_args[3], accurate)
    plain_stack, plain_block = cb.plain_versions(accurate)
    with torch.no_grad():
        stack_want = plain_stack(*stack_args, p=cs.P)
        block_want = plain_block(*block_args, p=cs.P)
        stack_exact = cb.fused_core_stack_plain(*cs._double(stack_args),
                                                p=cs.P)
        block_exact = cb.fused_core_block_plain(*cs._double(block_args),
                                                p=cs.P)
    run, plain = draws_setup(dev, accurate) if draws else (None, None)
    print(f"mode: {'bf16_3x (accurate=True)' if accurate else 'one-pass'}; "
          f"before: {'the 3xTF32 kernels' if accurate else 'one-pass'}",
          flush=True)

    def runners(name):
        lib = libs[name][0]
        if name == "before":
            fns = ((lib.ertdx_core_stack, lib.ertdx_core_block) if accurate
                   else (lib.ertdx_core_stack_onepass,
                         lib.ertdx_core_block_onepass))
            return (lambda: parent_call(fns[0], True, stack_args, cs.P),
                    lambda: parent_call(fns[1], False, block_args, cs.P))
        return (lambda: cb.fused_core_stack(
                    *stack_args, p=cs.P, chunk=1000, accurate=accurate,
                    packed=stack_packed, kv=stack_kv),
                lambda: cb.fused_core_block(
                    *block_args, p=cs.P, chunk=1000, accurate=accurate,
                    packed=block_packed, kv=block_kv))

    def error_text(got, want, exact) -> str:
        return (f"max |got - plain| {float((got - want).abs().max()):.3e}, "
                f"rms error vs float64 {rms(got - exact):.3e} (plain "
                f"{rms(want - exact):.3e})")

    passes = 3 if accurate else 1
    load = _build.load
    try:
        for turn, order in enumerate((names, names[::-1])):
            for name in order:
                lib = types.SimpleNamespace(lib=libs[name][0])
                _build.load = lambda lib=lib: lib
                stack, block = runners(name)
                with torch.no_grad():
                    got, again, got_b = stack(), stack(), block()
                    torch.cuda.synchronize()
                    stack_ms, block_ms = cs.time_ms(stack), cs.time_ms(block)
                bound = {k: passes * f / cs.PEAK_BF16_FLOPS * 1e3
                         for k, f in flops.items()}
                line = (f"[{turn}] {name}: stack {stack_ms:.3f} ms, "
                        f"{error_text(got, stack_want, stack_exact)}, "
                        f"rerun bit-identical {torch.equal(got, again)}; "
                        f"block {block_ms:.3f} ms, "
                        f"{error_text(got_b, block_want, block_exact)}; "
                        f"share of the bf16 bound ({passes} pass(es)) stack "
                        f"{100 * bound['stack'] / stack_ms:.1f} %, block "
                        f"{100 * bound['block'] / block_ms:.1f} %")
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
