#!/usr/bin/env python3
"""A/B of ensemble attention kernel variants on one NVIDIA GPU.

    python3 tools/ensemble_ab.py [--before PATH] [--crossover] [--draws]
                                 [name ...]

Builds ertdx_torch/csrc/ensemble_attn.cu as it stands ("base") and in the
variants of VARIANTS below, each a list of exact text substitutions in
ensemble_attn.cu or (prefix "H:") tf32x3.cuh; with --before, also the
ensemble_attn.cu at PATH as it is ("before": an earlier version, e.g.
from a `git archive` of the parent commit). tools/core_ab.py's builder,
one nvcc per variant, all started together, into build/ensemble_ab/. Then, in turns (the variants
in order, then in reverse), times block_self_attention at N=2000, P=29,
D=128 and folded_cross_attention at B=2, Lq=29,000, Lk=147, D=128
(chip_smoke.py's phase-8 shapes and inputs: q, k and v chunks of one
fused projection; CUDA events) and prints each variant's max abs error
against the plain version and whether a rerun is bit-identical. With
--draws it also runs phase 9 (a) of chip_smoke.py (the guided v-model's
pd-4 over 2 x 1000 chains on the per-block path) through each variant
and prints the draws' gaps to the plain path. With --crossover it also
times one unguided DDIM step of DDIM_ENSEMBLE's
CondUNet at 1024, 2000 and 4000 chains on the per-block path (each
variant's kernels, and the plain version) and on the fused-core path
(fused_core_stack, which the variants do not touch), to place the
crossover that models/mega.py's MIN_TOTAL_CHAINS stands for. The "diag_"
variants compute wrong results on purpose: they remove one kind of work
to show its cost. A variant whose build spills is reported and timed all
the same. Nothing here is imported by the port; it needs nvcc and a card.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs                                    # noqa: E402
import core_ab                                             # noqa: E402
from ertdx_torch.ops import _build, ensemble_attn as ea    # noqa: E402

OUT = os.path.join(ROOT, "build", "ensemble_ab")
KERNELS = ("block_self_kernel", "folded_cross_kernel")
ENTRY_POINTS = ("ertdx_block_self_attn", "ertdx_folded_cross_attn")

_PV = """    // O += P V, accumulated on the MMA
#pragma unroll
    for (int j = 0; j < KC; ++j)
      if (c + j < NT) {
        FragA a;
        from_c(a, p[j]);
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          FragB f;
          load_b_nn(f, Vs, LD, 8 * (c + j), 8 * n, lane);
          mma3(acc[n], a, f);
        }
      }
  }
"""
_PV_CHUNK = """    // O += P V, 32 keys (4 k steps) at a time: each chunk's MMAs summed
    // from zero, 8 n tiles at a time, and added to O in fp32
#pragma unroll
    for (int j0 = 0; j0 < KC; j0 += 4)
#pragma unroll
      for (int n0 = 0; n0 < NN; n0 += 8) {
        float part[8][4] = {};
#pragma unroll
        for (int j = j0; j < j0 + 4; ++j)
          if (j < KC && c + j < NT) {
            FragA a;
            from_c(a, p[j]);
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              FragB f;
              load_b_nn(f, Vs, LD, 8 * (c + j), 8 * (n0 + n), lane);
              mma3(part[n], a, f);
            }
          }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
      }
  }
"""
_PV_MMA = "          mma3(acc[n], a, f);"
_PREFETCH = """        next < tiles ? qb + (size_t)next * 16 * ldq : nullptr, ldq,"""
_Q_WAIT = """    cp_wait<0>();
    __syncwarp();                                  // the next q rows are in W
"""
_STAGE_Q = """      stage<D>(W, LD, qnext, ldq, 16, qrows, threadIdx.x - lane, 32);"""
_SELF_STAGES = """      stage<D>(Qs, LD, q + row * ldq, ldq, P, P, 0, SELF_THREADS);
      stage<D>(Qs + SELF_ROWS * LD, LD, k + row * ldk, ldk, P, P, 0,
               SELF_THREADS);
      stage<D>(Qs + 2 * SELF_ROWS * LD, LD, v + row * ldv, ldv, P, P, 0,
               SELF_THREADS);"""
_SELF_ATTEND = """    if (16 * warp < P)
      attend_tile<D, SELF_ROWS / 8, SELF_ROWS / 8>(
          Qs + 16 * warp * LD, Qs + SELF_ROWS * LD, Qs + 2 * SELF_ROWS * LD,
          P, scale_log2, out + (size_t)chain * P * D, 16 * warp, P, nullptr,
          0, 0);"""
_FAKE = "{0}[0] += __uint_as_float(a.lo[0] + f.hi[1]);"

VARIANTS = {
    # how P V's k steps add up (base: on the MMA's accumulator): each
    # 32-key chunk from zero, or each k step from zero, added in fp32
    "acc_per_chunk": [(_PV, _PV_CHUNK)],
    "acc_per_step": [(_PV_MMA, "          mma3_add(acc[n], a, f);")],
    # the cross row of 19 key tiles in chunks of 10 and 9, or of 8, 8 and
    # 3, under an online softmax (base: whole)
    "halves": [("launch_cross<D, 19, 19>", "launch_cross<D, 19, 10>")],
    "chunks_of_8": [("launch_cross<D, 19, 19>", "launch_cross<D, 19, 8>")],
    # the next cross q tile staged after P V (base: after the logits)
    "no_q_prefetch": [
        (_PREFETCH, "        nullptr, ldq,"),
        (_Q_WAIT, "    __syncwarp();\n    if (next < tiles)\n"
                  "      stage<D>(W, LD, qb + (size_t)next * 16 * ldq, ldq, "
                  "16, Lq - next * 16, warp * 32, 32);\n    cp_commit();\n"
                  + _Q_WAIT)],
    # ptxas left to its own occupancy target (base: one block an SM)
    "lb_default": [("__launch_bounds__(32 * CROSS_WARPS, 1)",
                    "__launch_bounds__(32 * CROSS_WARPS)")],
    # diagnostics: wrong results, one kind of work removed
    "diag_no_mma": [
        ("          mma3(p[j], a, f);", "          " + _FAKE.format("p[j]")),
        (_PV_MMA, "          " + _FAKE.format("acc[n]"))],
    "diag_cross_no_q_loads": [(_STAGE_Q, "")],
    "diag_self_no_compute": [(_SELF_ATTEND, "")],
    "diag_self_no_loads": [(_SELF_STAGES, "")],
}


def ptxas_summary(report: str) -> list:
    """Registers and spill bytes of each instance of the two kernels, as
    'folded_cross_kernel<128,19,10> 213 regs, 0 spill'."""
    out, name = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in KERNELS if k in line), None)
            if name:
                args = ",".join(re.findall(r"Li(\d+)E", line))
                out.append([f"{name}<{args}>", "", ""])
        elif name and "bytes spill stores" in line:
            out[-1][2] = line.split(",")[1].strip().split()[0] + " spill"
        elif name and "registers" in line:
            out[-1][1] = line.split("Used")[1].split(",")[0].strip()
    return [f"{n} {r}, {sp}" for n, r, sp in out]


class _Lib:
    """A variant's two ensemble entry points; every other kernel from the
    library the port builds."""

    def __init__(self, variant, full):
        self.variant, self.full = variant, full

    def __getattr__(self, name):
        return getattr(self.variant if name in ENTRY_POINTS else self.full,
                       name)


def draws_setup(dev):
    """Phase 9 (a): DDIM_ENSEMBLE's CondUNet with uncond_prob=0.1, v and
    ensemble_pallas=True (chip_smoke.py's seeds), pd-4 at guidance 2.0
    over 2 conditions x 1000 members; the run and the plain path's
    draws."""
    import dataclasses

    from ertdx_torch import configs, sample
    from ertdx_torch.configs import SampleConfig
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.models import build_model
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

    cs.set_ensemble_pallas(model, False)
    plain = run()
    cs.set_ensemble_pallas(model, True)
    return run, plain


def crossover_setup(dev):
    """Per chain count, a one-step DDIM run of DDIM_ENSEMBLE's CondUNet
    (random weights, ensemble_pallas=True) on the per-block path and on
    the fused-core path; and the model."""
    import dataclasses

    from ertdx_torch import configs
    from ertdx_torch.diffusion import sample_ddim, schedule_from_config
    from ertdx_torch.models import build_model
    from ertdx_torch.models.mega import mega_denoise_ensemble, mega_weights
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
            "fused": step(lambda x, t, ctx=ctx, r=r: mega_denoise_ensemble(
                model, x, t, ctx, r, p=p, d=mcfg.hidden_dim,
                num_blocks=mcfg.num_blocks, chunk=r, stack=True,
                weights=weights))}
    return runs, model


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
    names = ["base"] + (["before"] if before else []) + (
        [a for a in args if a not in ("--crossover", "--draws")]
        or list(VARIANTS))
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

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 80)
    sq, sk, sv = torch.randn(2000, 29, 3 * cs.D, generator=gen,
                             device=dev).chunk(3, dim=-1)
    cq = torch.randn(2, 29000, cs.D, generator=gen, device=dev)
    ck, cv = torch.randn(2, 147, 2 * cs.D, generator=gen,
                         device=dev).chunk(2, dim=-1)
    self_k = lambda: ea.block_self_attention_fwd(sq, sk, sv)
    cross_k = lambda: ea.folded_cross_attention_fwd(cq, ck, cv)
    with torch.no_grad():
        self_want = ea.reference_attention(sq, sk, sv)
        cross_want = ea.reference_attention(cq, ck, cv)
        plain = (cs.time_ms(lambda: ea.reference_attention(sq, sk, sv)),
                 cs.time_ms(lambda: ea.reference_attention(cq, ck, cv)))
    print(f"plain: self {plain[0]:.4f} ms, cross {plain[1]:.4f} ms",
          flush=True)
    runs, model = crossover_setup(dev) if crossover else ({}, None)
    run, plain_u = draws_setup(dev) if draws else (None, None)

    load = _build.load
    full = load().lib
    try:
        for turn, order in enumerate((names, names[::-1])):
            for name in order:
                lib = types.SimpleNamespace(lib=_Lib(libs[name][0], full))
                _build.load = lambda lib=lib: lib
                with torch.no_grad():
                    s1, s2, c1, c2 = self_k(), self_k(), cross_k(), cross_k()
                    torch.cuda.synchronize()
                    self_ms, cross_ms = cs.time_ms(self_k), cs.time_ms(cross_k)
                print(f"[{turn}] {name}: self {self_ms:.4f} ms, error "
                      f"{float((s1 - self_want).abs().max()):.3e}, rerun "
                      f"bit-identical {torch.equal(s1, s2)}; cross "
                      f"{cross_ms:.4f} ms, error "
                      f"{float((c1 - cross_want).abs().max()):.3e}, rerun "
                      f"bit-identical {torch.equal(c1, c2)}", flush=True)
                if name.startswith("diag_"):
                    continue
                if draws and turn == 0:
                    with torch.no_grad():
                        u = run()
                    print("  draws vs plain du %.3e dmean %.3e dstd %.3e" % (
                        float((u - plain_u).abs().max()),
                        float((u.mean(0) - plain_u.mean(0)).abs().max()),
                        float((u.std(0) - plain_u.std(0)).abs().max())),
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
