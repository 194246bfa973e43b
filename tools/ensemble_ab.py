#!/usr/bin/env python3
"""A/B of ensemble attention kernel variants on one NVIDIA GPU.

    python3 tools/ensemble_ab.py [--before PATH] [--crossover] [--draws]
                                 [name ...]

Builds ertdx_torch/csrc/ensemble_attn.cu (the one-pass kernels) as it
stands ("base") and in the variants of VARIANTS below, each a list of
exact text substitutions in ensemble_attn.cu or (a "bf16mma.cuh:" prefix)
in that header; with --before, also the ensemble_attn.cu at PATH as it is
("before": an earlier version, e.g. the parent's 3xTF32 kernels: `git
archive HEAD~1 ertdx_torch/csrc | tar -x -C build/parent`, PATH
build/parent/ertdx_torch/csrc/ensemble_attn.cu, since the card's copy has
no .git). tools/core_ab.py's build(), one nvcc per variant, all started
together, into build/ensemble_ab/. Then, in turns (the variants in order,
then in reverse), times block_self_attention at N=2000, P=29, D=128 and
folded_cross_attention at B=2, Lq=29,000, Lk=147, D=128 (chip_smoke.py's
phase-8 shapes: q, k and v chunks of one fused projection; by CUDA events
over back-to-back wrapper calls, and by the replay of a CUDA graph of 20
calls, the device time without the host's),
in float32 and in bf16, and prints each variant's rms error against the
float32 function computed in float64 beside the plain one-pass version's
(phase 8's rule: 0.8-1.25x) and whether a rerun is bit-identical. An
earlier tree without bf16 entry points is timed on bf16 inputs as the
port ran them before: float32 copies of q, k and v, its float32 kernel,
the output cast to bf16. With --draws it also runs phase 9 (a) of
chip_smoke.py (the guided v-model's pd-4 over 2 x 1000 chains on the
per-block path) through each variant: the ensemble mean and std against
the plain path's (5e-2 x max(1, |.|)), the draws' max gap, and one
denoiser call under phase 8's rule. With --crossover it also times one
unguided DDIM step of DDIM_ENSEMBLE's CondUNet at 1024, 2000 and 4000
chains on the per-block path (each variant's kernels, and the plain
version) and on the fused-core path (fused_core_stack, which the
variants do not touch), to place the crossover that models/mega.py's
MIN_TOTAL_CHAINS stands for. The "diag_" variants compute wrong results
on purpose: they remove one kind of work to show its cost. A variant
whose build spills is reported and timed all the same. Nothing here is
imported by the port; it needs nvcc and a card.
"""
from __future__ import annotations

import os
import re
import shutil
import sys
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs                                    # noqa: E402
import core_ab                                             # noqa: E402
from ertdx_torch.ops import _build, ensemble_attn as ea    # noqa: E402

OUT = os.path.join(ROOT, "build", "ensemble_ab")
KERNELS = ("block_self_onepass_kernel", "folded_cross_onepass_kernel",
           "block_self_kernel", "folded_cross_kernel")
ENTRY_POINTS = ("ertdx_block_self_attn", "ertdx_block_self_attn_bf16",
                "ertdx_folded_cross_attn", "ertdx_folded_cross_attn_bf16")

VARIANTS = {
    # the cross kernel's q rings 3 deep (base: 2)
    "cross_ring3": [("constexpr int CROSS_STAGES = 2; ",
                     "constexpr int CROSS_STAGES = 3; ")],
    # the cross kernel with up to 16 warps a block (registers capped at 128
    # a thread)
    "cross_16_warps": [("constexpr int CROSS_WARPS = 8; ",
                        "constexpr int CROSS_WARPS = 16;")],
    # diagnostics: wrong results, one kind of work removed
    "diag_self_no_compute": [("    const bool rows = 16 * h < P;",
                              "    const bool rows = false;")],
    "diag_self_no_loads": [("    issue(chain + step, s ^ 1);",
                            "    cp_commit();")],
    "diag_cross_no_q_loads": [
        ("    issue(tile + (ST - 1) * step, (i + ST - 1) % ST);",
         "    cp_commit();")],
    # the float32 K and V neither copied nor rounded
    "diag_f32_no_kv": [
        ("      stage_rows<T, D>(rows, src[j], ld[j], n[j], Lk, 0, "
         "blockDim.x);\n", ""),
        ("      round_rows<T, D>(dst[j], rows, LD, n[j], n[j], 0, "
         "blockDim.x);\n", "")],
    # no output written (the rows still put together in shared memory)
    "diag_no_stores": [
        ("  for (int i = lane; i < nrows * C; i += 32) {",
         "  for (int i = lane; i < nrows * C * 0; i += 32) {")],
    # the softmax's exponentials left out
    "diag_no_exp": [("      s[n][e] = ex2(fmaf(s[n][e], LOG2E, -mx[e >> 1]));",
                     "      s[n][e] = fmaf(s[n][e], LOG2E, -mx[e >> 1]);")],
    # no P V, so no product or softmax either: loads, and the stores of
    # zeros
    "diag_loads_stores_only": [("  for (int j = 0; j < KS; ++j)",
                                "  for (int j = 0; j < 0; ++j)")],
    # each MMA replaced by one dependent add
    "diag_no_mma": [(
        "bf16mma.cuh:"
        """  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));""",
        "  d[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & "
        "0x3c00ffffu);")],
}


def ptxas_summary(report: str) -> list:
    """Registers and spill bytes of each instance of the kernels, as
    'folded_cross_onepass_kernel<128,19> 210 regs, 0 spill'."""
    out, name = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in KERNELS if k in line), None)
            if name:
                args = ",".join(re.findall(r"Li(\d+)E", line))
                kind = "bf16 " if "bfloat16" in line else ""
                out.append([f"{kind}{name}<{args}>", "", ""])
        elif name and "bytes spill stores" in line:
            out[-1][2] = line.split(",")[1].strip().split()[0] + " spill"
        elif name and "registers" in line:
            out[-1][1] = line.split("Used")[1].split(",")[0].strip()
    return [f"{n} {r}, {sp}" for n, r, sp in out]


class _Lib:
    """A variant's ensemble entry points; every other kernel from the
    library the port builds."""

    def __init__(self, variant, full):
        self.variant, self.full = variant, full

    def __getattr__(self, name):
        return getattr(self.variant if name in ENTRY_POINTS else self.full,
                       name)


def upcast(fwd):
    """The port's bf16 path before the one-pass kernels: float32 copies of
    q, k and v through a float32 kernel, the output cast back."""
    def run(q, k, v):
        return fwd(*(t.float() for t in (q, k, v))).to(q.dtype)
    return run


def rule_text(got, q, k, v, exact) -> str:
    """Phase 8's numbers: the rms error against `exact` beside the plain
    one-pass version's, and the max error against its band."""
    return ratio_text(got, ea.reference_attention_onepass(q, k, v), exact)


def ratio_text(got, plain, exact) -> str:
    """got's rms error against `exact` beside plain's, and its max error
    against 5e-2 x max(1, max|exact|)."""
    err, plain_err = got.double() - exact, plain.double() - exact
    rms = float(err.square().mean().sqrt())
    ratio = rms / float(plain_err.square().mean().sqrt())
    band = 5e-2 * max(1.0, float(exact.abs().max()))
    return (f"rms error {rms:.3e} ({ratio:.4f}x the plain one-pass "
            f"version's), max {float(err.abs().max()):.3e} (band "
            f"{band:.3e})")


def draws_setup(dev):
    """Phase 9 (a): DDIM_ENSEMBLE's CondUNet with uncond_prob=0.1, v and
    ensemble_pallas=True (chip_smoke.py's seeds), pd-4 at guidance 2.0
    over 2 conditions x 1000 members; the run, the plain path's draws, and
    one denoiser call with its float32 plain result and its plain
    one-pass result (both attentions in the plain one-pass version)."""
    import dataclasses

    from ertdx_torch import configs, sample
    from ertdx_torch.configs import SampleConfig
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.models import build_model
    from ertdx_torch.models import condunet as condunet_mod
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax

    cfg = configs.DDIM_ENSEMBLE
    mcfg = dataclasses.replace(cfg.model, uncond_prob=0.1,
                               parameterization="v", ensemble_pallas=True)
    model = build_model(mcfg, device=dev).eval()
    rng = np.random.default_rng(cs.SEED + 90)
    params_from_jax(model, cs.random_flax_tree(flax_shapes(model), rng))
    schedule = schedule_from_config(cfg.diffusion)
    cond = torch.from_numpy(rng.standard_normal(
        (3, mcfg.cond_length, mcfg.cond_channels)).astype(np.float32)
    ).to(dev)[:2]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 91)
    x_T = torch.randn(2000, mcfg.param_dim, generator=gen, device=dev)
    scfg = SampleConfig(sampler="pd", pd_steps=4, guidance_scale=2.0)

    def run():
        return sample.posterior_ensemble(model, cond, schedule, 1000, scfg,
                                         x_T=x_T, device=dev)

    with torch.no_grad():
        ctx = model.encode_condition(cond)
        t_mid = torch.full((2000,), schedule.num_steps // 2, device=dev)
        call = lambda: model.denoise_ensemble(x_T, t_mid, ctx, 1000)
        cs.set_ensemble_pallas(model, False)
        plain = run()
        exact = call()
        cs.set_ensemble_pallas(model, True)
        names = ("block_self_attention", "folded_cross_attention")
        kept = {n: getattr(condunet_mod, n) for n in names}
        for n in names:
            setattr(condunet_mod, n, ea.reference_attention_onepass)
        onepass = call()
        for n, fn in kept.items():
            setattr(condunet_mod, n, fn)
    return run, plain, call, exact, onepass


def crossover_setup(dev):
    """Per chain count, a one-step DDIM run of DDIM_ENSEMBLE's CondUNet
    (random weights, ensemble_pallas=True) on the per-block path and on
    the fused-core path; and the model."""
    import dataclasses

    from ertdx_torch import configs
    from ertdx_torch.diffusion import sample_ddim, schedule_from_config
    from ertdx_torch.models import build_model
    from ertdx_torch.models.mega import (mega_cross_kv, mega_denoise_ensemble,
                                         mega_weights)
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax

    cfg = configs.DDIM_ENSEMBLE
    mcfg = dataclasses.replace(cfg.model, ensemble_pallas=True)
    model = build_model(mcfg, device=dev).eval()
    rng = np.random.default_rng(cs.SEED + 120)
    params_from_jax(model, cs.random_flax_tree(flax_shapes(model), rng))
    schedule = schedule_from_config(cfg.diffusion)
    weights = mega_weights(model)
    p = mcfg.param_dim
    runs = {}
    for b, r in ((1, 1024), (2, 1000), (4, 1000)):
        cond = torch.from_numpy(rng.standard_normal(
            (b, mcfg.cond_length, mcfg.cond_channels)).astype(np.float32)
        ).to(dev)
        with torch.no_grad():
            ctx = model.encode_condition(cond)
        x_T = torch.randn(b * r, p, device=dev)

        def step(fn, x_T=x_T):
            return lambda: sample_ddim(fn, tuple(x_T.shape), schedule, 1,
                                       x_T=x_T, device=dev)

        runs[b * r] = {
            "per_block": step(lambda x, t, ctx=ctx, r=r:
                              model.denoise_ensemble(x, t, ctx, r)),
            "fused": step(lambda x, t, ctx=ctx, r=r, cross=mega_cross_kv(
                weights, ctx, stack=True, accurate=False):
                mega_denoise_ensemble(
                    model, x, t, ctx, r, p=p, d=mcfg.hidden_dim,
                    num_blocks=mcfg.num_blocks, chunk=r, stack=True,
                    weights=weights, cross=cross))}
    return runs, model


def inputs(dev, dtype):
    """Phase 8's first self and cross inputs in `dtype`, with the float32
    function of each computed in float64."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 80)
    s = torch.randn(2000, 29, 3 * cs.D, generator=gen, device=dev).to(
        dtype).chunk(3, dim=-1)
    cq = torch.randn(2, 29000, cs.D, generator=gen, device=dev).to(dtype)
    ck, cv = torch.randn(2, 147, 2 * cs.D, generator=gen, device=dev).to(
        dtype).chunk(2, dim=-1)
    with torch.no_grad():
        exact = [ea.reference_attention(*(t.double() for t in qkv))
                 for qkv in (s, (cq, ck, cv))]
    return {"self": (s, exact[0]), "cross": ((cq, ck, cv), exact[1])}


def main() -> int:
    if not torch.cuda.is_available():
        print("ensemble_ab: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    before = None
    if "--before" in args:
        i = args.index("--before")
        before = args[i + 1]
        del args[i:i + 2]
    crossover, draws = "--crossover" in args, "--draws" in args
    asked = [a for a in args if a not in ("--crossover", "--draws")]
    names = ["base"] + (["before"] if before else []) + (
        asked or ([] if before else list(VARIANTS)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    shutil.rmtree(OUT, ignore_errors=True)
    t0 = time.perf_counter()
    libs = core_ab.build(names, "ensemble_attn.cu", VARIANTS, ENTRY_POINTS,
                         OUT, before)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s"
          f"; {cs.card_line()}", flush=True)
    for name, (_, report) in libs.items():
        print(f"ptxas {name}: " + "; ".join(ptxas_summary(report)))

    data = {dtype: inputs(dev, dtype)
            for dtype in (torch.float32, torch.bfloat16)}
    fwd = {"self": ea.block_self_attention_fwd,
           "cross": ea.folded_cross_attention_fwd}
    with torch.no_grad():
        for dtype, cases in data.items():
            for kind, (qkv, _) in cases.items():
                ms = [cs.time_ms(lambda f=f: f(*qkv)) for f in (
                    lambda *a: ea.reference_attention_onepass(*a),
                    lambda *a: ea.reference_attention(*a))]
                sdpa = [f(lambda: F.scaled_dot_product_attention(
                    *(t[:, None] for t in qkv))) for f in (cs.time_ms,
                                                           cs.graph_ms)]
                print(f"plain {kind} in {str(dtype)[6:]}: one-pass "
                      f"{ms[0]:.4f} ms, float32 {ms[1]:.4f} ms; one-head "
                      f"SDPA events {sdpa[0]:.4f} ms, device "
                      f"{sdpa[1]:.4f} ms (CUDA-graph replay)", flush=True)
    runs, model = crossover_setup(dev) if crossover else ({}, None)
    run, plain_u, call, exact_call, onepass_call = draws_setup(dev) \
        if draws else (None,) * 5

    load = _build.load
    full = load().lib
    try:
        for turn, order in enumerate((names, names[::-1])):
            for name in order:
                lib = types.SimpleNamespace(lib=_Lib(libs[name][0], full))
                _build.load = lambda lib=lib: lib
                for dtype, cases in data.items():
                    for kind, (qkv, exact) in cases.items():
                        kernel = fwd[kind]
                        if dtype == torch.bfloat16 and \
                                not hasattr(libs[name][0], ENTRY_POINTS[1]):
                            kernel = upcast(kernel)
                        with torch.no_grad():
                            o1, o2 = kernel(*qkv), kernel(*qkv)
                            torch.cuda.synchronize()
                            ms = cs.time_ms(lambda: kernel(*qkv))
                            graph = cs.graph_ms(lambda: kernel(*qkv))
                            text = rule_text(o1, *qkv, exact)
                        print(f"[{turn}] {name} {kind} {str(dtype)[6:]}: "
                              f"device {graph:.4f} ms (CUDA-graph replay), "
                              f"events {ms:.4f} ms, {text}, rerun "
                              f"bit-identical {torch.equal(o1, o2)}",
                              flush=True)
                if name.startswith("diag_"):
                    continue
                if draws and turn == 0:
                    with torch.no_grad():
                        u = run()
                        got = call()
                    for stat, fn in (("mean", lambda a: a.mean(0)),
                                     ("std", lambda a: a.std(0))):
                        a, b = fn(u), fn(plain_u)
                        gap = float(((a - b).abs() / b.abs().clamp(min=1.0))
                                    .max())
                        print(f"  draws: {stat} gap {gap:.3e} (gate 5e-2)")
                    print(f"  draws' max gap "
                          f"{float((u - plain_u).abs().max()):.3e}; one "
                          f"denoiser call: "
                          f"{ratio_text(got, onepass_call, exact_call)}",
                          flush=True)
                for chains, step in runs.items():
                    with torch.no_grad():
                        ms = cs.time_ms(step["per_block"], reps=5)
                    print(f"  [{turn}] crossover {name}: {chains} chains, "
                          f"per-block path {ms:.3f} ms per DDIM step",
                          flush=True)
    finally:
        _build.load = load
    for chains, step in runs.items():
        with torch.no_grad():
            fused_ms = cs.time_ms(step["fused"], reps=5)
            cs.set_ensemble_pallas(model, False)
            plain_ms = cs.time_ms(step["per_block"], reps=5)
            cs.set_ensemble_pallas(model, True)
        print(f"crossover: {chains} chains, fused-core path {fused_ms:.3f} "
              f"ms, per-block plain path {plain_ms:.3f} ms per DDIM step; "
              f"{cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
