#!/usr/bin/env python3
"""A/B of the bf16 slab attention kernels on one NVIDIA GPU.

    python3 tools/slab_bf16_ab.py [--before PATH] [--stages] [name ...]

Builds ertdx_torch/csrc/slab_attn_bf16.cu as it stands ("base") and in
the variants of VARIANTS below (exact text substitutions in the source,
or in a header named as a prefix, "wgmma.cuh:..."), with
tools/core_ab.py's build() into build/slab_bf16_ab/; with --before, also
an earlier slab_attn_bf16.cu ("before"): PATH is a directory whose
sources and headers replace today's by name (the parent's mma.sync
kernels need its bf16mma.cuh: `git archive HEAD~1 ertdx_torch/csrc | tar
-x -C build/parent` before the copy goes to the card, which has no .git;
PATH build/parent/ertdx_torch/csrc), called through its own entry points
(a float32 lse / delta scratch for its two-launch backward). Then, in
turns (the variants in order, then in reverse), at chip_smoke.py's
phase-15 shape (B=256, L=147, C=256, H=4, bf16) it times
the forward and the backward two ways: CUDA events around 5 calls
launched back to back through ctypes (the median of 10), and a CUDA
graph of 20 launches replayed (events over 5 replays, a launch's device
time without the host); in the first turn each output's max abs error
against the plain version in float32 from the same bf16 inputs beside
phase 15 (a)'s gate, and whether reruns are bit-identical. Beside them
one F.scaled_dot_product_attention call (cuDNN) in bf16 on q, k, v laid
out as contiguous (B, H, L, dh) before the timed call, forward and
backward, both ways, with its kernels' profiler device time. With
--stages the base kernels also run at every ring depth their shared
memory takes. A variant that fails to build stops the script; one that
fails to launch is reported and skipped. Nothing here is imported by the
port; it needs nvcc and a card.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs                                    # noqa: E402
import core_ab                                             # noqa: E402
from ertdx_torch.ops import _build, slab_attn as sa        # noqa: E402

OUT = os.path.join(ROOT, "build", "slab_bf16_ab")
ENTRY_POINTS = ("ertdx_slab_fwd_bf16", "ertdx_slab_bwd_bf16")
_P, _I = ctypes.c_void_p, ctypes.c_int
# the parent's entry points: no ring depth; the backward's lse and delta
BEFORE_SIGNATURES = {"ertdx_slab_fwd_bf16": [_P] * 2 + [_I] * 4 + [_P],
                     "ertdx_slab_bwd_bf16": [_P] * 5 + [_I] * 4 + [_P]}
SHAPE = (256, 147, 256, 4)

VARIANTS = {
    # the forward on four warpgroups, keys 32 at a time (base: three, 64)
    "fwd_wg4": [("constexpr int FWD_WARPGROUPS = 3,",
                 "constexpr int FWD_WARPGROUPS = 4,"),
                ("constexpr bool FWD_WIDE = true,",
                 "constexpr bool FWD_WIDE = false,")],
    # the backward's query tiles walk the keys 64 at a time (base: 32):
    # both passes, the dQ pass alone, the forward's pass alone
    "dq_wide": [("DQ_WIDE = false,", "DQ_WIDE = true,")],
    "dqc_wide": [("      chunks<DQ_WIDE>(Lp,", "      chunks<true>(Lp,")],
    "att_wide": [("        Attend<DH, DQ_WIDE> at;",
                  "        Attend<DH, true> at;")],
    # both kernels on two warpgroups (base: three)
    "wg2": [("constexpr int FWD_WARPGROUPS = 3, BWD_WARPGROUPS = 3;",
             "constexpr int FWD_WARPGROUPS = 2, BWD_WARPGROUPS = 2;")],
    # the backward on two warpgroups, 64 at a time (base: three, 32)
    "bwd_wg2": [("BWD_WARPGROUPS = 3;", "BWD_WARPGROUPS = 2;"),
                ("DQ_WIDE = false, DKV_WIDE = false;",
                 "DQ_WIDE = true, DKV_WIDE = true;")],
    # diagnostics: wrong results, one kind of work removed
    "diag_no_mma": [
        ("wgmma.cuh:// ---- host: TMA tensor maps",
         "template <int N>\n__device__ __forceinline__ void mma_skip(float "
         "(&d)[N], const uint32_t (&a)[4], uint64_t b) {\n  d[0] += "
         "__uint_as_float(a[0] & 1u) + (float)(b & 1u);\n}\n\n"
         "// ---- host: TMA tensor maps"),
        ("    wg::mma_rs<0>(acc, a[kk], Tile<DH>::kmajor(tile, n0, kk));",
         "    wg::mma_skip(acc, a[kk], Tile<DH>::kmajor(tile, n0, kk));"),
        ("    wg::mma_rs<1>(acc, a[kk], Tile<DH>::mnmajor(tile, k0 + 16 * "
         "kk));",
         "    wg::mma_skip(acc, a[kk], Tile<DH>::mnmajor(tile, k0 + 16 * "
         "kk));")],
    "diag_no_exp": [("  asm(\"ex2.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(y) : "
                     "\"f\"(x));", "  y = x;")],
}


def kernel_device_ms(fn, calls: int = 5) -> str:
    records, _ = cs.kernel_records(lambda: [fn() for _ in range(calls)])
    by: dict = {}
    for e in records:
        by.setdefault(e.name[:60], []).append(e.time_range.elapsed_us())
    return "; ".join(f"{n} {statistics.median(v) / 1e3:.4f} ms x"
                     f"{len(v) / calls:g}" for n, v in by.items())


def main() -> int:
    if not torch.cuda.is_available():
        print("slab_bf16_ab: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    before = None
    if "--before" in args:
        i = args.index("--before")
        before = args[i + 1]
        del args[i:i + 2]
    sweep = "--stages" in args
    args = [a for a in args if a != "--stages"]
    names = ["base"] + (["before"] if before else []) + args
    dev = torch.device("cuda")
    shutil.rmtree(OUT, ignore_errors=True)
    t0 = time.perf_counter()
    libs = core_ab.build(names, "slab_attn_bf16.cu", VARIANTS, ENTRY_POINTS,
                         OUT, before)
    if before:
        for fn, sig in BEFORE_SIGNATURES.items():
            getattr(libs["before"][0], fn).argtypes = sig
    card = cs.card_line()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s"
          f"; {card}", flush=True)
    for name, (_, report) in libs.items():
        print(f"ptxas {name}: " + "; ".join(
            f"{k}: {' | '.join(cs.ptxas_lines(report, k))}"
            for k in ("slab_fwd_wgmma_kernel", "slab_bwd_wgmma_kernel",
                      "slab_fwd_bf16_kernel", "slab_bwd_dq_bf16_kernel",
                      "slab_bwd_dkv_bf16_kernel")
            if cs.ptxas_lines(report, k)), flush=True)

    b, l, c, nh = SHAPE
    dh = c // nh
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 15)
    qkv = torch.randn(b, l, 3 * c, generator=gen, device=dev).bfloat16()
    do = torch.randn(b, l, c, generator=gen, device=dev).bfloat16()
    want = sa.reference_slab_attention(qkv.float(), nh)
    dwant = sa.reference_slab_attention_backward(qkv.float(), do.float(), nh)
    own = sa.reference_slab_attention(qkv, nh)
    down = sa.reference_slab_attention_backward(qkv, do, nh)
    plan = sa.bf16_plan(l, dh)
    print(f"plan at L={l}, dh={dh}: {plan}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    def calls(lib, name, fwd_stages, bwd_stages):
        def fwd():
            out = torch.empty(b, l, c, device=dev, dtype=torch.bfloat16)
            extra = () if name == "before" else (fwd_stages,)
            rc = lib.ertdx_slab_fwd_bf16(
                qkv.data_ptr(), out.data_ptr(), b, l, nh, dh, *extra,
                torch.cuda.current_stream().cuda_stream)
            _build.raise_on(rc, f"{name} forward")
            return out

        def bwd():
            dqkv = torch.empty_like(qkv)
            if name == "before":
                scratch = torch.empty(2, b, nh, l, device=dev)
                mid = (scratch[0].data_ptr(), scratch[1].data_ptr())
                tail = ()
            else:
                mid, tail = (), (bwd_stages,)
            rc = lib.ertdx_slab_bwd_bf16(
                qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), *mid, b, l,
                nh, dh, *tail, torch.cuda.current_stream().cuda_stream)
            _build.raise_on(rc, f"{name} backward")
            return dqkv
        return fwd, bwd

    def report(label, fwd, bwd, turn):
        try:
            got = (fwd(), bwd())
            again = (fwd(), bwd())
            torch.cuda.synchronize()
            times = [cs.time_ms(fwd), cs.graph_ms(fwd), cs.time_ms(bwd),
                     cs.graph_ms(bwd)]
        except RuntimeError as exc:
            return f"{label}: failed ({exc})"
        text = (f"{label}: fwd {times[0]:.4f} ms (graph {times[1]:.4f}), "
                f"bwd {times[2]:.4f} ms (graph {times[3]:.4f})")
        if turn == 0:
            errs = []
            for n, a, w, o in (("out", got[0], want, own),
                               ("dqkv", got[1], dwant, down)):
                tol = max(2 * float((o.float() - w).abs().max()),
                          8e-3 * max(1.0, float(w.abs().max())))
                err = float((a.float() - w).abs().max())
                errs.append(f"{n} {err:.2e} (gate {tol:.2e}"
                            f"{'' if err <= tol else ' FAILS'})")
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            text += (f"; errors {', '.join(errs)}; reruns bit-identical "
                     f"{same}; device ms by the profiler: fwd "
                     f"{kernel_device_ms(fwd)}; bwd {kernel_device_ms(bwd)}")
        return text

    # one SDPA call on operands laid out before it (cuDNN in bf16)
    import torch.nn.functional as F
    q, k, v = (z.reshape(b, l, nh, dh).transpose(1, 2).contiguous()
               for z in qkv.split(c, dim=-1))
    dob = do.reshape(b, l, nh, dh).transpose(1, 2).contiguous()
    qg, kg, vg = (z.detach().requires_grad_(True) for z in (q, k, v))
    lib_stream = torch.cuda.Stream()       # the backward's, as in phase 15
    lib_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(lib_stream):
        out_g = F.scaled_dot_product_attention(qg, kg, vg)
    torch.cuda.current_stream().wait_stream(lib_stream)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(q, k, v)

    def sdpa_bwd():
        return torch.autograd.grad(out_g, (qg, kg, vg), dob,
                                   retain_graph=True)
    with torch.no_grad():
        lib_fwd = (cs.time_ms(sdpa_fwd), cs.graph_ms(sdpa_fwd))
    lib_bwd = (cs.time_ms(sdpa_bwd),
               cs.graph_ms(sdpa_bwd, stream=lib_stream))
    print(f"SDPA bf16 on laid-out (B, H, L, dh): fwd {lib_fwd[0]:.4f} ms "
          f"(graph {lib_fwd[1]:.4f}), bwd {lib_bwd[0]:.4f} ms (graph "
          f"{lib_bwd[1]:.4f}); its kernels' "
          f"device ms: fwd {kernel_device_ms(sdpa_fwd)}; bwd "
          f"{kernel_device_ms(sdpa_bwd)}", flush=True)

    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            fwd, bwd = calls(libs[name][0], name, plan["fwd_stages"],
                             plan["bwd_stages"])
            print(f"[{turn}] " + report(name, fwd, bwd, turn), flush=True)
    if sweep:
        depths = sorted({(min(n, plan["fwd_stages"]),
                          min(n, plan["bwd_stages"]))
                         for n in range(1, max(sa.BF16_MAX_STAGES.values())
                                        + 1)})
        for fs, bs in depths:
            fwd, bwd = calls(libs["base"][0], "base", fs, bs)
            print("[stages] " + report(f"fwd {fs} / bwd {bs} slots", fwd,
                                       bwd, 1), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
