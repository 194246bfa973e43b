#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each timed, each raising on failure (the script then exits
non-zero and prints no result line):

1. device: the card's name and power limit;
2. build: nvcc compiles ertdx_torch/csrc/*.cu (ertdx_torch/ops/_build.py)
   and prints ptxas' register and shared-memory report; `cuobjdump -sass`
   of the library counts the HMMA.1688.F32.TF32 instructions of each
   slab, flash, fused-core, ensemble attention and fused-conv GEMM kernel
   and fails if one has none (they run their products on the tensor
   cores); ptxas' lines of every GN kernel (staged and streamed), where
   a spill fails; the bf16 MMAs (HMMA.16816.F32.BF16) of the bf16 fused
   conv's GEMMs, and ptxas' lines of every bf16 GN and fused-conv kernel,
   where a spill fails;
3. kernels: fused_core_stack and fused_core_block at full width (D=128,
   nb=4, P=29, Lk=147) and at the kernels' limits (P=17 with Lk=61, P=32
   with Lk=256), every weight non-zero, held against their plain PyTorch
   versions (max abs error <= 1e-4 * max(1, max|plain|)), a rerun and
   accurate=True bit-identical to the first run, ptxas' spill line of
   both kernels (a spill fails), timed with CUDA events with their share
   of the TF32 MMA rate; one JSON line {"kernels": [...]};
4. main path: the configs[3] posterior ensemble (CondUNet at
   DDIM_ENSEMBLE's full width, random weights from a seed carried over by
   params_from_jax, 8 conditions x 1000 members, DDIM-50, eta=0) through
   ertdx_torch.sample.posterior_ensemble, with exactly 50 fused_core_stack
   launches, held against the plain module path from the same x_T; then
   the inverse pipeline;
5. per-block path: the same DDIM run over 2 of the conditions through
   mega_denoise_ensemble(stack=False), i.e. fused_core_block, held against
   the main path's draws, with its ms per DDIM step;
6. slab kernels: slab_attention's CUDA forward and backward (both on
   3xTF32 tensor cores) at the encoder's training shape
   (B=256, L=147, C=256, 4 heads), at B=4 with 8 heads (dh=32) and at an
   odd L, held against the plain version (1e-4 * max(1, max|plain|)),
   reruns bit-identical, timed beside the plain version and
   F.scaled_dot_product_attention (the yardstick; the port never calls
   it), with the profiler's kernel names of the slab kernels and of SDPA
   (its route) and the kernels' resident blocks and block size;
7. training path: V5E8_DP's model and train settings in float32 on one
   card (full-width CondUNet, attn_slab=True, batch 256, condition
   4693 x 14). (a) 5 train_steps on the kernel path against the same 5 on
   the plain path (and a plain-vs-plain run that sets the tolerance),
   one slab forward and backward launch per step, ms per step, and a
   torch.profiler breakdown of one step; one step from non-zero weights
   as well. (b) ertdx_torch.train.train for 2
   epochs on 400 examples into a temporary directory, its best and last
   checkpoints read back through the port's reader;
8. ensemble kernels: block_self_attention and folded_cross_attention (both
   on 3xTF32 tensor cores) at the per-block path's shapes (N=2000 chains
   of P=29; B=2 conditions of Lq=29,000 folded queries against Lk=147
   keys; D=128), at a small and at an odd shape and at the cross gate's
   edges (Lk=173 at D=128, Lk=256 at D=64), held against the plain
   version (1e-4 * max(1, max|plain|)), reruns bit-identical, ptxas'
   spill line of both kernels (a spill fails), timed beside the plain
   version and F.scaled_dot_product_attention with one head (the
   yardstick), with TFLOP/s and the share of the bound;
9. the rest of serving: DDIM_ENSEMBLE's CondUNet with uncond_prob=0.1, a
   v-parameterisation and ensemble_pallas=True, random weights (null
   context included) through params_from_jax, 2 conditions x 1000
   members, i.e. 2000 chains, below the fused-core threshold, so the
   per-block path runs on the ensemble kernels: (a) pd-4 guided at 2.0,
   (b) DPM++-15 unguided, (c) ancestral over T=500 guided at 2.0 on the
   interval (0, 0.5), each with exact launch counts and held against the
   same run with ensemble_pallas=False from the same draws (max |du|,
   |dmean|, |dstd| <= 1e-3); (d) posterior_over_dataset over 3 conditions
   in batches of 2 (pd-4, inverse on the device);
10. GN and fused-conv kernels: groupnorm_silu's and gn_silu_conv3's CUDA
   forward and backward at the fused encoder arm's shapes (GN at the
   stem, (256, 587, 128), and at (256, 294, 256); the fused conv at (256,
   294, 256 -> 256) and (256, 147, 256 -> 256)), at the stem-width conv
   (256, 587, 128 -> 128, as pallas_conv=True runs it), a 128 -> 256 conv
   and odd shapes, GN also at the condition's length (2, 4693, 128; the
   streamed kernels) and on x = 1000 + N(0, 1), each case's GN launch
   plan logged (staged or streamed) and the GN kernels' GB/s,
   each output (dx, dgamma, dbeta, dW, db) held against the plain version
   (1e-4 * max(1, max|plain|)), reruns of the forward and the backward
   bit-identical, ptxas' spill line of both fused-conv kernels (a spill
   fails), timed (CUDA events and profiler device time, the backward's
   launch by launch) beside the plain version and the unfused library
   composition (F.group_norm + F.silu, + F.conv1d; cuDNN and TF32 off), a
   yardstick only: no single PyTorch call computes either function, with
   TFLOP/s and the share of the bound;
11. the fused-encoder training arm: V5E8_DP as phase 7 with pallas_gn=True
   and pallas_conv_min_width=256, random weights from a seed through
   params_from_jax. (a) 5 train_steps against the same 5 with every
   kernel switched off (plain-vs-plain first, phase 7's rule), exactly
   2/2/6/6 GN forward/backward and fused-conv forward/backward launches
   and one slab forward and backward per step, ms per step of both paths
   and a profile of one step of each. (b) train() for 2 epochs on 400
   examples with uncond_prob=0.1, ema_decay=0.999 and
   flat_optimizer=True, launches equal to the rule per forward and step,
   then train(resume=True) for a third epoch; its last checkpoint read
   back through the port's reader (forward bit for bit, flat Adam state
   exact) and load_best_model.

12. flash attention kernels: flash_attention's CUDA forward, dQ and dK/dV
   (all on 3xTF32 tensor cores, skipping key tiles that are all padding)
   at the encoder's flash shape (B=256, H=4, L=147 padded to 256
   with the pad keys masked, Dh=64), the length gate's (8, 4, 1024, 64),
   Dh=128 and 256, and batch rows whose keys are all masked (one of them
   at the flash arm's head width with padded key tiles), each output held
   against the plain version (1e-4 * max(1, max|plain|)), all-masked
   rows' lse -1e30, the skipped key rows' dK and dV exactly 0, reruns
   bit-identical (out, lse, dq, dk, dv), timed (CUDA events and
   profiler device time) beside the plain version and
   F.scaled_dot_product_attention on the same padded, masked operands
   (the yardstick; the port never calls it), with the share of key tiles
   skipped and SDPA's kernel names;
13. the flash-encoder arm: V5E8_DP as phase 7 with attn_slab=False and
   attn_flash_min_logits=1, random weights through params_from_jax.
   (a) 5 train_steps against the same 5 with the encoder attention's
   use_pallas off (plain-vs-plain first), exactly one flash forward, dQ
   and dK/dV launch per step, a profile of one step of each path;
   (b) train() for 2 epochs on 400 examples, launches by the epoch grid;
   (c) a configs[3] posterior ensemble (8 conditions x 1000 members,
   DDIM-50) from that checkpoint: one flash forward per call, draws
   within 1e-3 of the all-plain path;
14. distillation of phase 13's checkpoint as an eps teacher: the first
   batch's loss and gradients on the kernel path against the plain path,
   then distill() with a conversion stage and one halving (8 -> 4), one
   epoch each, 2 flash forwards, 1 dQ and 1 dK/dV per step and 2 forwards
   per val batch; the student read back and sampled by sample_pd (pd-4,
   2 x 1000 chains), draws within 1e-3 of the plain path;
15. bfloat16: V5E8_DP in its own dtype (bf16 compute, float32 params),
   one card. (a) the bf16 slab kernels (forward, dQ, dK/dV, one bf16 MMA
   a product) at the slab cases against the plain version computed in
   float32 from the same bf16 inputs, max abs <= max(2 x the bf16 plain
   version's own error, 8e-3 x max(1, max|plain|)), reruns
   bit-identical, ptxas' spill lines (a spill fails) and bf16 MMAs
   (HMMA.16816.F32.BF16) in their SASS, timed beside the float32
   kernels, the bf16 plain version and F.scaled_dot_product_attention in
   bf16 (the yardstick), with SDPA's kernel names; (b) 5 b256 train
   steps on them against the same 5 with use_pallas off, phase 7's gates
   with the tolerance set by the spread of two plain paths (run to run,
   and with the plain slab in float32 from the bf16 slab), exactly one
   bf16 slab forward and backward a step and no float32 slab launch, ms
   a step, a profile of one step of each path, peak memory; (c) train()
   for 2 epochs on 400 examples: launches by the epoch grid, float32
   params and Adam moments in the checkpoint, its echo of bfloat16, and
   load_best_model's bf16 model bit for bit the trained one; (d) a
   configs[3] ensemble (8 x 1000, DDIM-50) from that checkpoint: 50
   fused_core_stack launches and one bf16 slab forward, draws within the
   JAX package's bf16 band (rtol = atol = 5e-2) of the same run with the
   slab kernel off, ms per DDIM step beside phase 4's;
16. the bf16 fused-encoder arm: phase 15's model with pallas_gn=True and
   pallas_conv_min_width=256. (a) the bf16 GN and fused-conv kernels at
   phase 10's shapes in bf16 (GN also at the condition's length and on x
   = 1000 + N(0, 1)), every output against the plain version in float32
   from the same bf16 inputs under phase 15 (a)'s rule, reruns
   bit-identical, each case's launch plan, timed (CUDA events and
   profiler device time) beside the float32 kernels, the bf16 plain
   version and the bf16 library composition (a yardstick), GB/s and the
   share of the bound at 2 bytes a value and 989 TFLOP/s; (b) 5 b256
   steps against every kernel off under phase 15 (b)'s gates, exactly
   2/2 bf16 GN, 6/6 bf16 fused-conv and 1/1 bf16 slab launches a step
   and no float32 GN, conv or slab launch, ms a step, peak memory, a
   profile of one step of each path and the ops that launch its float32
   elementwise kernels; (c) train() for 2 epochs on 400 examples as
   phase 15 (c), launches by the epoch grid; (d) a configs[3] ensemble
   (8 x 1000, DDIM-50) from random non-zero weights: 2 GN, 6 conv and 1
   slab bf16 forwards and 50 fused_core_stack launches, one denoiser call
   from the kernels' context within the bf16 band of the same call with
   the GN and conv kernels off, the draws within that band or twice the
   gap between two plain computations of the model; (e) one
   bf16 b256 step of the flash arm (the float32 flash kernels on upcast
   copies) against use_pallas off under (b)'s gates, one flash forward,
   dQ and dK/dV.

Every kernel's entry in the kernels line has `bound_ms`, the least time
the card could take: the bytes at 3.35 TB/s or the operations at the
fastest rate of their class, 3xTF32 on the tensor cores for float32
matrix products (the fp32 pipe for GroupNorm, which has none), the bf16
tensor cores' 989 TFLOP/s for the bf16 kernels; for the flash kernels
only the keys the mask needs. Beside it `bound_tc_ms` (the 3xTF32 time;
null for GroupNorm) and `bound_fp32_ms` (the fp32 pipe's). The last line of
stdout is {"ok": true, "device": {...}}. The build goes
to build/ertdx_torch_kernels/; the checkpoints of phases 7, 11, 13, 14,
15 and 16 go to temporary directories that are removed; nothing else is
written.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 outside the
# tensor cores, TF32 on them, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12         # bf16 on the tensor cores, dense
P, D, NB, LK = 29, 128, 4, 147
SEED = 0
# (kernel, conditions, members, P, Lk): the configs[3] shapes, R=10, and
# the kernels' limits (P=17 with Lk=61 below one 128-key block; P=32 with
# Lk=256); the first case of each kernel is timed
KERNEL_CASES = [("fused_core_stack", 8, 1000, P, LK),
                ("fused_core_stack", 8, 10, P, LK),
                ("fused_core_stack", 2, 33, 17, 61),
                ("fused_core_stack", 2, 20, 32, 256),
                ("fused_core_block", 2, 1000, P, LK),
                ("fused_core_block", 2, 10, P, LK),
                ("fused_core_block", 2, 33, 17, 61),
                ("fused_core_block", 2, 20, 32, 256)]
# (B, L, C, heads): the encoder's training shape first, then dh=32 and an
# odd L
SLAB_CASES = [(256, 147, 256, 4), (4, 147, 256, 8), (3, 61, 128, 2)]
TRAIN_STEPS = 5
# (N, P, D) and (B, Lq, Lk, D): the per-block path's shapes first (2
# conditions x 1000 members), then a small and an odd one, and the cross
# gate's edges (Lk=173 at D=128, Lk=256 at D=64)
SELF_CASES = [(2000, 29, 128), (16, 29, 128), (7, 17, 64)]
CROSS_CASES = [(2, 29000, 147, 128), (1, 116, 147, 128), (3, 13, 61, 64),
               (1, 87, 173, 128), (2, 40, 256, 64)]
SERVE_CONDS, SERVE_MEMBERS = 2, 1000
# (B, L, C, mean of x) of the GN kernels and (B, L, C, Cout) of the fused
# conv: the fused encoder arm's shapes first (the stem's GN, then at the
# 256-wide ResBlocks' L=294; the fused conv at L=294 and 147), then the
# stem-width conv, a 128 -> 256 conv and odd shapes; for GN also the
# condition's length (the streamed kernels) and x = 1000 + N(0, 1); the
# first case of each is the one in the kernels line
GN_CASES = [(256, 587, 128, 0.5), (256, 294, 256, 0.5), (3, 61, 72, 0.5),
            (2, 4693, 128, 0.5), (4, 587, 128, 1000.0)]
CONV_CASES = [(256, 294, 256, 256), (256, 147, 256, 256),
              (256, 587, 128, 128), (256, 294, 128, 256), (3, 61, 64, 72)]
GROUPS = 8
# (B, H, L, Dh, valid keys, batch rows with every key masked) of the flash
# kernels: the encoder's flash arm (L=147 padded to 256), the length
# gate's shape, Dh 128 and 256, and an all-masked batch row; the first is
# the one in the kernels line
FLASH_CASES = [(256, 4, 256, 64, 147, ()), (8, 4, 1024, 64, 1024, ()),
               (2, 4, 256, 128, 200, ()), (2, 4, 256, 256, 256, ()),
               (3, 2, 128, 64, 100, (1,)), (2, 4, 256, 64, 147, (1,))]


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, t0: float) -> None:
    log(f"[phase] {name}: {time.perf_counter() - t0:.3f} s")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2, run: int = 5) -> float:
    """Median over `reps` samples of the CUDA-event time of one call, each
    sample the mean of `run` calls launched back to back, so that the
    host's launch work overlaps the device's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / run)
    return statistics.median(times)


def core_inputs(gen, b: int, r: int, nb: int, dev, p: int = P,
                lk: int = LK):
    """Random full-width core inputs, every weight non-zero."""
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).contiguous()

    s = 1.0 / math.sqrt(D)
    ws = {"wqkv": rnd(nb, D, 3 * D, scale=s), "wso": rnd(nb, D, D, scale=s),
          "bso": rnd(nb, D, scale=0.1), "wcq": rnd(nb, D, D, scale=s),
          "wco": rnd(nb, D, D, scale=s), "bco": rnd(nb, D, scale=0.1),
          "w1": rnd(nb, D, 4 * D, scale=s), "b1": rnd(nb, 4 * D, scale=0.1),
          "w2": rnd(nb, 4 * D, D, scale=0.5 * s),
          "b2": rnd(nb, D, scale=0.1)}
    return {"mods": rnd(b, 6 * nb, D, scale=0.3), "k": rnd(b * nb, lk, D),
            "v": rnd(b * nb, lk, D), "ws": ws,
            "x": rnd(b, r, p), "x3": rnd(b, r * p, D),
            "lift_w": rnd(1, D), "lift_b": rnd(1, D, scale=0.1),
            "pos_emb": rnd(p, D, scale=0.1),
            "on_scale": 1.0 + rnd(1, D, scale=0.1),
            "on_bias": rnd(1, D, scale=0.1), "head_w": rnd(D, 1, scale=s),
            "head_b": rnd(1, 1, scale=0.1)}


def bound(flops: float, nbytes: float, products: bool = True,
          tc_rate: float = PEAK_TF32_FLOPS / 3) -> dict:
    """The least time, in ms, the card could take to do `flops`
    operations and move `nbytes`: the larger of the bytes at the memory
    rate and the operations at the card's fastest rate of their class.
    For float32 matrix products that is 3xTF32 on the tensor cores (three
    TF32 products each, 495 / 3 TFLOP/s), faster than the fp32 pipe's 67;
    for bf16 products `tc_rate` is the bf16 tensor cores' 989; for other
    work, the fp32 pipe. `bound_tc_ms` is the tensor cores' time (None
    without products), `bound_fp32_ms` the fp32 pipe's."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_fp32 = flops / PEAK_FP32_FLOPS * 1e3
    t_tc = flops / tc_rate * 1e3 if products else None
    t_ops = min(t_fp32, t_tc) if products else t_fp32
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_tc_ms": None if t_tc is None else max(t_tc, t_bytes),
            "bound_fp32_ms": max(t_fp32, t_bytes)}


def bound_text(b: dict, flops: float, nbytes: float) -> str:
    return (f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}: {flops:.3e} "
            f"flops, {nbytes:.3e} bytes; fp32 pipe {b['bound_fp32_ms']:.4f}"
            f" ms)")


def kernel_names(fn, calls: int = 3) -> str:
    """The device kernels fn launches, by name with their device time a
    call (the mean over `calls` calls, with the records of each name: the
    profiler drops a record now and then): which route a library call
    takes."""
    records, _ = kernel_records(lambda: [fn() for _ in range(calls)])
    by_name: dict = {}
    for e in records:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return "; ".join(f"{name[:100]} {us / calls / 1e3:.4f} ms ({n} records)"
                     for name, (us, n) in sorted(by_name.items(),
                                                 key=lambda kv: -kv[1][0]))


# a kernel that runs its products on the tensor cores, in a mangled symbol:
# the slab and flash attention kernels, the fused core's two, the ensemble
# attention pair and the fused conv's GEMMs
TENSOR_CORE_KERNEL = re.compile(
    r"\d((?:slab|flash)_(?:fwd|bwd_dq|bwd_dkv)_kernel"
    r"|core_(?:stack|block)_kernel|block_self_kernel|folded_cross_kernel"
    r"|tap3_gemm_kernel|conv_dw_kernel)[IE]")
CORE_KERNELS = ("core_stack_kernel", "core_block_kernel")
ENSEMBLE_KERNELS = ("block_self_kernel", "folded_cross_kernel")
CONV_KERNELS = ("tap3_gemm_kernel", "conv_dw_kernel")
GN_KERNELS = ("gn_fwd_staged_kernel", "gn_bwd_staged_kernel",
              "gn_stats_staged_kernel", "gn_fwd_stream_kernel",
              "gn_bwd_stream_kernel", "gn_stats_stream_kernel")
# what the fused conv backward's launches compute, by kernel name
LAUNCH_LABELS = {"gn_stats": "statistics", "gn_affine": "table",
                 "conv_dw": "dW", "sum_rows": "sum", "tap3_gemm": "dh",
                 "tap3_wgmma": "dh",
                 "gn_bwd": "GN backward"}


def sass_counts(path, kernel_of, instruction: str):
    """{kernel<template args>: the count of `instruction` (a string, or a
    compiled pattern) in its SASS} for each kernel of the library at
    `path` whose SASS header `kernel_of(line)` names, or None where the
    toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = kernel_of(line)
            if name:
                args = ",".join(re.findall(r"L[ib](\d+)E", line))
                name += f"<{args}>" if args else ""
                counts[name] = 0
        elif name and (instruction.search(line)
                       if hasattr(instruction, "search")
                       else instruction in line):
            counts[name] += 1
    return counts


def check_tensor_cores(path) -> None:
    """Phase 2: the TF32 MMAs (HMMA.1688.F32.TF32) in the SASS of each
    slab, flash, fused-core, ensemble attention and fused-conv kernel of
    the built library; raises where one has none, or where a fused-core,
    ensemble or fused-conv kernel is missing. Logs and returns where the
    toolkit has no cuobjdump."""
    def kernel_of(line):
        fn = TENSOR_CORE_KERNEL.search(line)
        return None if fn is None else fn.group(1)

    counts = sass_counts(path, kernel_of, "HMMA.1688.F32.TF32")
    if counts is None:
        log("sass: no cuobjdump; the tensor-core check is not made")
        return
    log("sass: HMMA.1688.F32.TF32 per tensor-core kernel: " + "; ".join(
        f"{k} {n}" for k, n in sorted(counts.items())))
    bare = [k for k, n in counts.items() if n == 0]
    bare += [k for k in CORE_KERNELS + ENSEMBLE_KERNELS + CONV_KERNELS
             if not any(name.startswith(k) for name in counts)]
    if not counts or bare:
        raise RuntimeError(f"kernels without TF32 MMAs: {bare}")


def check_no_spill(report: str, kernels) -> None:
    """Log ptxas' lines of each kernel; raise where one has none (it was
    not built) or spills."""
    for kernel in kernels:
        lines = ptxas_lines(report, kernel)
        log(f"ptxas {kernel}: " + " | ".join(lines))
        spills = [int(n) for line in lines for n in
                  re.findall(r"(\d+) bytes spill", line)]
        if not lines or any(spills):
            raise RuntimeError(f"{kernel}: no ptxas report or it spills")


def ptxas_lines(report: str, kernel: str) -> list:
    """ptxas' lines (-Xptxas -v) for the entry function whose mangled name
    holds `kernel`: its stack frame and spills, and its registers."""
    lines, inside = [], False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and ("bytes stack frame" in line
                         or "registers" in line):
            lines.append(line.strip())
    return lines


def check_kernels(cb, dev, report: str, card: str) -> dict:
    """Phase 3: both kernels against their plain versions, reruns and
    accurate=True bit-identical, ptxas' spill line of each (a spill
    fails), timed with their share of the TF32 MMA rate."""
    for kernel in CORE_KERNELS:
        lines = ptxas_lines(report, kernel)
        log(f"ptxas {kernel}: " + " | ".join(lines))
        spills = [int(n) for line in lines for n in
                  re.findall(r"(\d+) bytes spill", line)]
        if not lines or any(spills):
            raise RuntimeError(f"{kernel}: no ptxas report or it spills")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    for name, b, r, p, lk in KERNEL_CASES:
        nb = NB if name == "fused_core_stack" else 1
        a = core_inputs(gen, b, r, nb, dev, p, lk)
        if name == "fused_core_stack":
            args = (a["x"], a["mods"], a["k"], a["v"], a["ws"], a["lift_w"],
                    a["lift_b"], a["pos_emb"], a["on_scale"], a["on_bias"],
                    a["head_w"], a["head_b"])
            kernel = lambda acc=False: cb.fused_core_stack(
                *args, p=p, chunk=r, accurate=acc)
            plain = lambda: cb.fused_core_stack_plain(*args, p=p)
            ins = [a["x"], a["mods"], a["k"], a["v"], *a["ws"].values(),
                   a["lift_w"], a["lift_b"], a["pos_emb"], a["on_scale"],
                   a["on_bias"], a["head_w"], a["head_b"]]
            out_bytes = a["x"].numel() * 4
        else:
            w = {key: val[0].contiguous() for key, val in a["ws"].items()}
            mods = a["mods"][:, :6].contiguous()
            args = (a["x3"], mods, a["k"], a["v"], w)
            kernel = lambda acc=False: cb.fused_core_block(
                *args, p=p, chunk=r, accurate=acc)
            plain = lambda: cb.fused_core_block_plain(*args, p=p)
            ins = [a["x3"], mods, a["k"], a["v"], *w.values()]
            out_bytes = a["x3"].numel() * 4
        tag = f"{name} B={b} R={r} P={p} Lk={lk}"
        with torch.no_grad():
            got = kernel()
            again = kernel()
            accurate = kernel(True)
            torch.cuda.synchronize()
            want = plain()
            torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{tag}: non-finite output")
        same = torch.equal(got, again) and torch.equal(got, accurate)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        tol = 1e-4 * max(1.0, scale)
        log(f"{tag}: max_abs_err={err:.3e} "
            f"max_rel_err={err / max(scale, 1e-30):.3e} max|plain|="
            f"{scale:.4f} tol={tol:.3e}; rerun and accurate=True "
            f"bit-identical: {same}")
        if not err <= tol:
            raise RuntimeError(f"{tag}: error {err} > {tol}")
        if not same:
            raise RuntimeError(f"{tag}: a rerun or accurate=True differs")
        rows = b * r * p
        flops = nb * rows * 2 * D * (14 * D + 2 * p + 2 * lk)
        nbytes = sum(t.numel() * 4 for t in ins) + out_bytes
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if r == KERNEL_CASES[0][2]:
            with torch.no_grad():
                ms = time_ms(kernel)
                plain_ms = time_ms(plain)
            bd = bound(flops, nbytes)
            # 3 TF32 MMAs a product: the share of the tensor cores' TF32
            # peak that the counted operations, tripled, reach
            share = 3 * flops / (ms * 1e-3) / PEAK_TF32_FLOPS
            entry.update(ms=ms, plain_ms=plain_ms, **bd, flops=flops,
                         bytes=nbytes, shape=f"B={b} R={r}",
                         tf32_share=share)
            log(f"{tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                f"{bound_text(bd, flops, nbytes)}, achieved "
                f"{flops / ms / 1e9:.2f} TFLOP/s, {100 * share:.1f} % of "
                f"the TF32 MMA rate (3 MMAs a product); {card}")
    return results


def check_slab(sa, dev) -> dict:
    """Phase 6: the slab kernels against their plain version, timed."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    results = {}
    for b, l, c, nh in SLAB_CASES:
        dh = c // nh
        if not sa.slab_attention_ok(b, l, c, nh):
            raise RuntimeError(f"slab gate refuses B={b} L={l} C={c} "
                               f"H={nh}")
        qkv = torch.randn(b, l, 3 * c, generator=gen, device=dev)
        do = torch.randn(b, l, c, generator=gen, device=dev)
        got = sa.slab_attention_fwd(qkv, nh)
        dgot = sa.slab_attention_bwd(qkv, do, nh)
        torch.cuda.synchronize()
        want = sa.reference_slab_attention(qkv, nh)
        dwant = sa.reference_slab_attention_backward(qkv, do, nh)
        torch.cuda.synchronize()
        for name, g, w in (("slab_attention_fwd", got, want),
                           ("slab_attention_bwd", dgot, dwant)):
            if not torch.isfinite(g).all():
                raise RuntimeError(f"{name} B={b} L={l}: non-finite")
            err = float((g - w).abs().max())
            scale = float(w.abs().max())
            tol = 1e-4 * max(1.0, scale)
            log(f"{name} B={b} L={l} C={c} H={nh}: max_abs_err={err:.3e} "
                f"max|plain|={scale:.4f} tol={tol:.3e}")
            if not err <= tol:
                raise RuntimeError(f"{name} B={b} L={l}: error {err} > "
                                   f"{tol}")
            entry = results.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        same = [torch.equal(sa.slab_attention_fwd(qkv, nh), got),
                torch.equal(sa.slab_attention_bwd(qkv, do, nh), dgot)]
        log(f"slab B={b} L={l} C={c} H={nh}: reruns bit-identical (out, "
            f"dqkv) {same}")
        if not all(same):
            raise RuntimeError(f"slab B={b} L={l}: reruns differ")
        if (b, l, c, nh) != SLAB_CASES[0]:
            continue

        def heads(z):
            return z.reshape(b, l, nh, dh).transpose(1, 2)

        def sdpa(z):
            q, k, v = z.split(c, dim=-1)
            out = F.scaled_dot_product_attention(heads(q), heads(k),
                                                 heads(v))
            return out.transpose(1, 2).reshape(b, l, c)

        def backward_of(fn):
            z = qkv.detach().requires_grad_(True)
            out = fn(z)
            return lambda: torch.autograd.grad(out, z, do,
                                               retain_graph=True)

        def sdpa_fwd_bwd():
            z = qkv.detach().requires_grad_(True)
            sdpa(z).backward(do)

        with torch.no_grad():
            fwd_ms = time_ms(lambda: sa.slab_attention_fwd(qkv, nh))
            fwd_plain = time_ms(lambda: sa.reference_slab_attention(qkv,
                                                                    nh))
            fwd_lib = time_ms(lambda: sdpa(qkv))
        bwd_ms = time_ms(lambda: sa.slab_attention_bwd(qkv, do, nh))
        bwd_plain = time_ms(backward_of(
            lambda z: sa.reference_slab_attention(z, nh)))
        bwd_lib = time_ms(backward_of(sdpa))
        fwd_bwd_lib = time_ms(sdpa_fwd_bwd)
        prod = b * nh * l * l * dh
        io = {"fwd": 4 * (b * l * 3 * c + b * l * c),
              "bwd": 4 * (2 * b * l * 3 * c + b * l * c)}
        for name, flops, nbytes, ms, plain_ms, lib_ms in (
                ("slab_attention_fwd", 4 * prod, io["fwd"], fwd_ms,
                 fwd_plain, fwd_lib),
                ("slab_attention_bwd", 10 * prod, io["bwd"], bwd_ms,
                 bwd_plain, bwd_lib)):
            bd = bound(flops, nbytes)
            results[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 **bd, shape=f"B={b} L={l} C={c} H={nh}")
            log(f"{name} B={b} L={l} C={c} H={nh}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
                f"{bound_text(bd, flops, nbytes)}, achieved "
                f"{flops / ms / 1e9:.2f} TFLOP/s")
        log("slab forward's kernel, profiler device time a call: "
            + kernel_names(lambda: sa.slab_attention_fwd(qkv, nh)))
        log("slab backward's kernels, profiler device time a call: "
            + kernel_names(lambda: sa.slab_attention_bwd(qkv, do, nh)))
        log("SDPA's route, forward and backward (profiler kernel names, "
            "device time): " + kernel_names(sdpa_fwd_bwd))
        occ = sa.blocks_per_sm(l, dh)
        threads = occ.pop("threads")
        log(f"resident blocks per SM at L={l}, dh={dh} ({threads} threads "
            f"each): {occ}")
        log(f"SDPA forward+backward (one call each, reshapes included): "
            f"{fwd_bwd_lib:.4f} ms; slab kernels forward+backward "
            f"{fwd_ms + bwd_ms:.4f} ms")
    return results


def check_ensemble(ea, dev, report: str, card: str) -> dict:
    """Phase 8: ptxas' spill line of both ensemble kernels (a spill
    fails); the kernels against their plain version, reruns bit-identical;
    timed at the per-block path's shapes with TFLOP/s and the share of the
    bound. q, k and v are chunks of one fused projection, as the model
    passes them."""
    import torch.nn.functional as F

    for kernel in ENSEMBLE_KERNELS:
        lines = ptxas_lines(report, kernel)
        log(f"ptxas {kernel}: " + " | ".join(lines))
        spills = [int(n) for line in lines for n in
                  re.findall(r"(\d+) bytes spill", line)]
        if not lines or any(spills):
            raise RuntimeError(f"{kernel}: no ptxas report or it spills")
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    results = {}
    cases = ([("block_self_attention", c) for c in SELF_CASES]
             + [("folded_cross_attention", c) for c in CROSS_CASES])
    for name, case in cases:
        if name == "block_self_attention":
            n, p, d = case
            if not ea.block_self_ok(n, p, d):
                raise RuntimeError(f"self gate refuses {case}")
            q, k, v = torch.randn(n, p, 3 * d, generator=gen,
                                  device=dev).chunk(3, dim=-1)
            kernel = lambda: ea.block_self_attention_fwd(q, k, v)
            flops, nbytes = 4 * n * p * p * d, 4 * (4 * n * p * d)
            shape = f"N={n} P={p} D={d}"
        else:
            b, lq, lk, d = case
            if not ea.folded_cross_ok(b, lq, lk, d):
                raise RuntimeError(f"cross gate refuses {case}")
            q = torch.randn(b, lq, d, generator=gen, device=dev)
            k, v = torch.randn(b, lk, 2 * d, generator=gen,
                               device=dev).chunk(2, dim=-1)
            kernel = lambda: ea.folded_cross_attention_fwd(q, k, v)
            flops = 4 * b * lq * lk * d
            nbytes = 4 * (2 * b * lq * d + 2 * b * lk * d)
            shape = f"B={b} Lq={lq} Lk={lk} D={d}"
        plain = lambda: ea.reference_attention(q, k, v)
        with torch.no_grad():
            got = kernel()
            again = kernel()
            torch.cuda.synchronize()
            want = plain()
            torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{name} {shape}: non-finite output")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        tol = 1e-4 * max(1.0, scale)
        same = torch.equal(got, again)
        log(f"{name} {shape}: max_abs_err={err:.3e} max|plain|={scale:.4f} "
            f"tol={tol:.3e}; rerun bit-identical: {same}")
        if not err <= tol:
            raise RuntimeError(f"{name} {shape}: error {err} > {tol}")
        if not same:
            raise RuntimeError(f"{name} {shape}: a rerun differs")
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if case not in (SELF_CASES[0], CROSS_CASES[0]):
            continue
        sdpa = lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None])[:, 0]
        with torch.no_grad():
            lib_err = float((sdpa() - want).abs().max())
            ms = time_ms(kernel)
            plain_ms = time_ms(plain)
            lib_ms = time_ms(sdpa)
            records, _ = kernel_records(lambda: [kernel() for _ in range(10)])
            dev_ms = sum(e.time_range.elapsed_us() for e in records) / 10e3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                kernel()
            host_us = (time.perf_counter() - t0) / 20 * 1e6
            torch.cuda.synchronize()
        bd = bound(flops, nbytes)
        entry.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bd,
                     shape=shape)
        log(f"{name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"SDPA {lib_ms:.4f} ms (max|d| vs plain {lib_err:.2e}), "
            f"{bound_text(bd, flops, nbytes)}, achieved "
            f"{flops / ms / 1e9:.2f} TFLOP/s, "
            f"{100 * bd['bound_ms'] / ms:.1f} % of the bound; "
            f"profiler device time {dev_ms:.4f} ms a launch, host time "
            f"{host_us:.1f} us a wrapper call; {card}")
    return results


def set_ensemble_pallas(model, on: bool) -> None:
    for blk in model.blocks:
        blk.ensemble_pallas = on


def check_serving(ea, cb, dev, card) -> int:
    """Phase 9: the guided v-model on the per-block path, every sampler;
    returns the ensemble kernels' launches over its kernel-path runs."""
    from ertdx_torch import configs, sample
    from ertdx_torch.configs import SampleConfig
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.models import build_model
    from ertdx_torch.models.mega import MIN_TOTAL_CHAINS
    from ertdx_torch.params import ParameterSpace
    from ertdx_torch.transforms import MinMaxScaler
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax

    cfg = configs.DDIM_ENSEMBLE
    mcfg = dataclasses.replace(cfg.model, uncond_prob=0.1,
                               parameterization="v", ensemble_pallas=True)
    model = build_model(mcfg, device=dev).eval()
    rng = np.random.default_rng(SEED + 90)
    params_from_jax(model, random_flax_tree(flax_shapes(model), rng))
    b, r, p = SERVE_CONDS, SERVE_MEMBERS, mcfg.param_dim
    if b * r >= MIN_TOTAL_CHAINS or b * r < mcfg.ensemble_min_chains:
        raise RuntimeError("phase 9 must run the per-block ensemble path")
    log(f"serving model: D={mcfg.hidden_dim} blocks={mcfg.num_blocks} "
        f"uncond_prob={mcfg.uncond_prob} parameterization="
        f"{mcfg.parameterization} ensemble_pallas={mcfg.ensemble_pallas} "
        f"(min chains {mcfg.ensemble_min_chains}); {b} conditions x {r} "
        f"members; null_vec max|.| "
        f"{float(model.null_vec.detach().abs().max()):.3f}")
    schedule = schedule_from_config(cfg.diffusion)
    big_t = schedule.num_steps
    cond = torch.from_numpy(rng.standard_normal(
        (3, mcfg.cond_length, mcfg.cond_channels)).astype(np.float32)
    ).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 91)
    x_T = torch.randn(b * r, p, generator=gen, device=dev)
    noise = torch.randn(big_t, b * r, p, generator=gen, device=dev)
    with torch.no_grad():            # library set-up outside the timings
        model.encode_condition(cond[:1])
    nb = mcfg.num_blocks
    runs = [("(a) pd-4, guidance 2.0",
             SampleConfig(sampler="pd", pd_steps=4, guidance_scale=2.0),
             {"x_T": x_T}, 2 * 4),
            ("(b) DPM++-15, unguided",
             SampleConfig(sampler="dpmpp", dpmpp_steps=15), {"x_T": x_T},
             15),
            (f"(c) ancestral T={big_t}, guidance 2.0 on (0, 0.5)",
             SampleConfig(guidance_scale=2.0, guidance_interval=(0.0, 0.5)),
             {"x_T": x_T, "noise": noise}, big_t + big_t // 2)]
    total = 0
    for tag, scfg, draws, calls in runs:
        torch.cuda.synchronize()
        ea.reset_launches()
        cb.reset_launches()
        t0 = time.perf_counter()
        u = sample.posterior_ensemble(model, cond[:b], schedule, r, scfg,
                                      device=dev, **draws)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = dict(ea.launches)
        want = {name: calls * nb for name in ea.launches}
        if counts != want or any(cb.launches.values()):
            raise RuntimeError(f"{tag}: launches {counts} (fused core "
                               f"{dict(cb.launches)}), expected {want}")
        total += calls * nb
        set_ensemble_pallas(model, False)
        t1 = time.perf_counter()
        u_plain = sample.posterior_ensemble(model, cond[:b], schedule, r,
                                            scfg, device=dev, **draws)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        set_ensemble_pallas(model, True)
        if tuple(u.shape) != (r, b, p) or not torch.isfinite(u).all():
            raise RuntimeError(f"{tag}: wrong shape or non-finite draws")
        du = float((u - u_plain).abs().max())
        dmean = float((u.mean(0) - u_plain.mean(0)).abs().max())
        dstd = float((u.std(0) - u_plain.std(0)).abs().max())
        log(f"{tag}: {calls} denoiser calls, launches {counts}; kernel path "
            f"{run_s:.3f} s ({run_s / calls * 1e3:.3f} ms per denoiser "
            f"call), plain path {plain_s:.3f} s ({plain_s / calls * 1e3:.3f} "
            f"ms per call; {card}); max|du|={du:.3e} max|dmean|={dmean:.3e} "
            f"max|dstd|={dstd:.3e} max|u|={float(u_plain.abs().max()):.4f}")
        if not (du <= 1e-3 and dmean <= 1e-3 and dstd <= 1e-3):
            raise RuntimeError(f"{tag}: kernel path disagrees with the plain "
                               "path")

    with torch.no_grad():
        ctx = model.encode_condition(cond[:b])
        t_mid = torch.full((b * r,), big_t // 2, device=dev)
        for on in (True, False):
            set_ensemble_pallas(model, on)
            device_profile(lambda: model.denoise_ensemble(x_T, t_mid, ctx, r),
                           f"one per-block denoiser call, ensemble_pallas="
                           f"{on}")
        set_ensemble_pallas(model, True)

    space = ParameterSpace()
    scaler = MinMaxScaler.fit(space.plims.T)
    ea.reset_launches()
    t0 = time.perf_counter()
    phys, mask = sample.posterior_over_dataset(
        model, cond, schedule, scaler, n_realizations=r, batch_size=b,
        scfg=SampleConfig(sampler="pd", pd_steps=4), space=space,
        device_inverse=True,
        generator=torch.Generator(device=dev).manual_seed(SEED + 92),
        device=dev)
    run_s = time.perf_counter() - t0
    counts = dict(ea.launches)
    want = {name: 2 * 4 * nb for name in ea.launches}   # 2 batches
    log(f"(d) posterior_over_dataset, 3 conditions in batches of {b}: pred "
        f"{phys.shape}, valid {mask.shape}, valid fraction "
        f"{float(mask.mean()):.6f}, {run_s:.3f} s, launches {counts}")
    if (phys.shape != (r, 3, p) or mask.shape != (r, 3)
            or not np.isfinite(phys).all() or counts != want):
        raise RuntimeError("posterior_over_dataset: bad output or launches")
    return total + 2 * 4 * nb


def train_cfg(configs):
    """V5E8_DP's model and train settings, float32, one device."""
    cfg = configs.V5E8_DP
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="float32"),
        mesh=configs.MeshConfig())


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _run_steps(train, model, opt, batches, alpha_bar, lr, sa=None):
    """The train steps on `batches`; per-step loss, ms, launches and the
    first step's gradients."""
    losses, times, counts, g1 = [], [], [], None
    for x0, cond, t, noise in batches:
        if sa is not None:
            before = dict(sa.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = train.train_step(model, opt, x0, cond, t, noise,
                                alpha_bar=alpha_bar, lr=lr)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if sa is not None:
            counts.append({k: sa.launches[k] - before[k]
                           for k in sa.launches})
        if g1 is None:
            g1 = _grads(model)
    return losses, times, counts, g1


def _compare_grads(tag, got, want) -> float:
    worst = 0.0
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        worst = max(worst, err / tol)
        if not err <= tol:
            raise RuntimeError(f"{tag}: gradient of {name} differs by "
                               f"{err:.3e} > {tol:.3e}")
    return worst


def _param_diffs(a, b) -> torch.Tensor:
    return torch.cat([(pa.detach() - pb.detach()).abs().reshape(-1)
                      for pa, pb in zip(a.parameters(), b.parameters())])


def _log_param_gaps(label, kernel, plain, g1_kernel, g1_plain,
                    n: int = 3) -> None:
    """Where the two paths' parameters end furthest apart after the steps:
    the entry, the gap, and its gradient on both paths at step 1 and at
    the last step (still in .grad), beside the leaf's largest step-1
    gradient. Adam moves an entry by about lr a step whatever the size of
    its gradient, so an entry whose gradient is near 0 and differs in
    sign between the paths ends up to 2 lr a step apart: a gap there is
    a sign flip, where one at a large gradient would be a gradient
    error."""
    rows = []
    for (name, a), b in zip(kernel.named_parameters(), plain.parameters()):
        d = (a.detach() - b.detach()).abs().reshape(-1)
        i = int(d.argmax())
        rows.append((float(d[i]), name, i, a, b))
    for gap, name, i, a, b in sorted(rows, key=lambda r: -r[0])[:n]:
        def at(t):
            return float(t.reshape(-1)[i])
        log(f"{label}: parameter gap {gap:.3e} at {name} {tuple(a.shape)} "
            f"entry {i}: gradient at step 1 kernel {at(g1_kernel[name]):.3e}"
            f" plain {at(g1_plain[name]):.3e}, at the last step kernel "
            f"{at(a.grad):.3e} plain {at(b.grad):.3e}; the leaf's largest "
            f"|step-1 gradient| {float(g1_plain[name].abs().max()):.3e}")


KERNEL_GROUPS = (("GN and fused conv (this port)",
                  ("gn_fwd_", "gn_bwd_", "gn_stats_", "gn_affine_",
                   "tap3_gemm_", "tap3_wgmma_",
                   "conv_dw_", "sum_rows_")),
                 ("slab attention (this port)", ("slab_",)),
                 ("flash attention (this port)",
                  ("(anonymous namespace)::flash_",)),
                 ("ensemble attention (this port)", ("block_self_kernel",
                                                     "folded_cross_kernel")),
                 ("convolution", ("conv", "implicit", "fprop", "dgrad",
                                  "wgrad", "winograd", "nchwtonhwc",
                                  "nhwctonchw")),
                 ("matrix product", ("gemm", "cutlass", "cublas")),
                 ("reduction, norm, softmax", ("reduce", "norm", "softmax")),
                 ("elementwise", ("elementwise", "vectorized", "copy",
                                  "fill", "cat")))


def kernel_records(fn) -> list:
    """The device kernels torch.profiler records while fn runs (synchronised
    at the end), and the wall time in microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)], wall_us


def launch_times(fn, calls: int = 5) -> str:
    """The device time of each kernel fn launches, by name in launch order,
    the mean over `calls` calls of fn from torch.profiler's records, with
    the number of records of each (the profiler has dropped a few)."""
    records, _ = kernel_records(lambda: [fn() for _ in range(calls)])
    by_name: dict = {}
    for e in records:
        name = re.search(r"\w+_kernel(<[^>]*>)?", e.name)
        key = name[0] if name else e.name[:40]
        label = next((v for k, v in LAUNCH_LABELS.items()
                      if key.startswith(k)), None)
        key = f"{label} ({key})" if label else key
        us, n = by_name.get(key, (0.0, 0))
        by_name[key] = (us + e.time_range.elapsed_us(), n + 1)
    return "; ".join(f"{k} {us / calls / 1e3:.4f} ms ({n} records)"
                     for k, (us, n) in by_name.items())


def device_profile(fn, label: str) -> None:
    """Where fn's device time goes: torch.profiler's kernel records, summed
    by name and by rough group, and the device's idle share of fn's wall
    time (profiler overhead included)."""
    kernels, wall_us = kernel_records(fn)
    if not kernels:
        log(f"profile of {label}: the profiler recorded no device time; "
            "breakdown not measured")
        return
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for name, us in by_name.items():
        low = name.lower()
        key = next((g for g, keys in KERNEL_GROUPS
                    if any(k in low for k in keys)), "other")
        groups[key] += us
    log(f"profile of {label}: {len(kernels)} kernel launches, device busy "
        f"{busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall (idle share "
        f"{1 - busy / wall_us:.3f})")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  group {name}: {us / 1e3:.3f} ms ({100 * us / busy:.1f} %)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  kernel {us / 1e3:8.3f} ms  {name[:110]}")


def profile_step(train, model, opt, batch, alpha_bar, lr) -> None:
    """Where one kernel-path train step's device time goes."""
    x0, cond, t, noise = batch
    device_profile(lambda: train.train_step(model, opt, x0, cond, t, noise,
                                            alpha_bar=alpha_bar, lr=lr),
                   "one kernel-path train step")


def check_training(sa, dev, card) -> dict:
    """Phase 7 (a): kernel path against plain path, 5 train steps."""
    from ertdx_torch import configs, train
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.models import build_model
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax

    cfg = train_cfg(configs)
    mcfg, tcfg = cfg.model, cfg.train
    log(f"training config: {mcfg.name} D={mcfg.hidden_dim} "
        f"base_width={mcfg.base_width} depth={mcfg.depth} "
        f"heads={mcfg.num_heads} blocks={mcfg.num_blocks} "
        f"attn_slab={mcfg.attn_slab} dtype={mcfg.dtype} batch="
        f"{tcfg.batch_size} lr={tcfg.lr} condition {mcfg.cond_length} x "
        f"{mcfg.cond_channels}")
    kernel = build_model(mcfg, dev, generator=torch.Generator()
                         .manual_seed(SEED + 7))
    plain = copy.deepcopy(kernel)
    plain.encoder.attn.slab = False
    plain2 = copy.deepcopy(plain)
    alpha_bar = schedule_from_config(cfg.diffusion).alpha_bar.to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    b, p = tcfg.batch_size, mcfg.param_dim
    batches = [(torch.randn(b, p, generator=gen, device=dev),
                torch.rand(b, mcfg.cond_length, mcfg.cond_channels,
                           generator=gen, device=dev),
                torch.randint(0, cfg.diffusion.T, (b,), generator=gen,
                              device=dev),
                torch.randn(b, p, generator=gen, device=dev))
               for _ in range(TRAIN_STEPS)]
    lr = train.make_lr(tcfg, TRAIN_STEPS)

    # plain vs plain first: it sets the tolerance of what follows
    pl, p_ms, _, pg = _run_steps(train, plain,
                                 train.create_optimizer(plain, lr), batches,
                                 alpha_bar, lr)
    pl2, _, _, pg2 = _run_steps(train, plain2,
                                train.create_optimizer(plain2, lr), batches,
                                alpha_bar, lr)
    pp_loss = max(abs(a - c) for a, c in zip(pl, pl2))
    pp_grad = max(float((pg[n] - pg2[n]).abs().max()) for n in pg)
    pp = _param_diffs(plain, plain2)
    pp_share = float((pp > 1e-5).float().mean())
    log(f"plain vs plain: max|dloss|={pp_loss:.3e} max|dgrad|="
        f"{pp_grad:.3e} max|dparam|={float(pp.max()):.3e} share of "
        f"params > 1e-5: {pp_share:.3e}")

    torch.cuda.reset_peak_memory_stats()
    sa.reset_launches()
    kl, k_ms, counts, kg = _run_steps(train, kernel,
                                      train.create_optimizer(kernel, lr),
                                      batches, alpha_bar, lr, sa)
    peak = torch.cuda.max_memory_allocated()
    log(f"kernel path: losses {kl}; slab launches per step {counts}")
    for step, cnt in enumerate(counts):
        if cnt != {"slab_attention_fwd": 1, "slab_attention_bwd": 1}:
            raise RuntimeError(f"train step {step + 1}: slab launches "
                               f"{cnt}, expected one forward and one "
                               "backward")
    loss_tol = max(1e-5, 10 * pp_loss)
    for step, (a, c) in enumerate(zip(kl, pl)):
        if not abs(a - c) <= loss_tol * max(1.0, abs(c)):
            raise RuntimeError(f"train step {step + 1}: loss {a} vs plain "
                               f"{c}, tolerance {loss_tol:.1e}")
    worst = _compare_grads("step 1", kg, pg)
    kp = _param_diffs(kernel, plain)
    k_share = float((kp > 1e-5).float().mean())
    flip_bound = 2 * tcfg.lr * TRAIN_STEPS
    log(f"kernel vs plain: max|dloss|="
        f"{max(abs(a - c) for a, c in zip(kl, pl)):.3e} (tol "
        f"{loss_tol:.1e} x max(1, loss)); step-1 gradients worst "
        f"err/tol {worst:.3f}; params after {TRAIN_STEPS} steps "
        f"max|d|={float(kp.max()):.3e} (bound {flip_bound:.1e}), share > "
        f"1e-5 {k_share:.3e} (limit max(1e-3, 2 x plain-vs-plain))")
    _log_param_gaps("kernel vs plain", kernel, plain, kg, pg)
    if not (float(kp.max()) <= flip_bound + 1e-6
            and k_share <= max(1e-3, 2 * pp_share)):
        raise RuntimeError("kernel-path parameters disagree with the "
                           "plain path")

    # one step from non-zero weights: every projection carries gradient
    rng = np.random.default_rng(SEED + 9)
    tree = random_flax_tree(flax_shapes(kernel), rng)
    nz_k, nz_p = copy.deepcopy(kernel), copy.deepcopy(plain)
    params_from_jax(nz_k, tree)
    params_from_jax(nz_p, tree)
    sa.reset_launches()
    (lk,), _, _, gk = _run_steps(train, nz_k,
                                 train.create_optimizer(nz_k, lr),
                                 batches[:1], alpha_bar, lr)
    (lp,), _, _, gp = _run_steps(train, nz_p,
                                 train.create_optimizer(nz_p, lr),
                                 batches[:1], alpha_bar, lr)
    worst_nz = _compare_grads("non-zero weights", gk, gp)
    log(f"non-zero weights: loss {lk:.6f} vs plain {lp:.6f}; gradients "
        f"worst err/tol {worst_nz:.3f}")
    if not abs(lk - lp) <= loss_tol * max(1.0, abs(lp)):
        raise RuntimeError("non-zero weights: loss disagrees")

    profile_step(train, kernel, train.create_optimizer(kernel, lr),
                 batches[0], alpha_bar, lr)
    k_step = statistics.median(k_ms[1:])
    p_step = statistics.median(p_ms[1:])
    log(f"ms per train step (median of steps 2-{TRAIN_STEPS}; {card}): "
        f"kernel path {k_step:.3f}, plain path {p_step:.3f}; peak memory "
        f"{peak / 2**20:.1f} MiB; step times kernel {k_ms} plain {p_ms}")
    return {"kernel_step_ms": k_step, "plain_step_ms": p_step}


def check_train_entry(sa, dev) -> dict:
    """Phase 7 (b): train() for 2 epochs, checkpoints read back."""
    from ertdx_torch import configs, train
    from ertdx_torch.data import prepare_dataset
    from ertdx_torch.doe import SurrogateDataGenerator
    from ertdx_torch.utils import checkpoint as ckpt_lib
    from ertdx_torch.utils.weights import params_from_jax

    cfg = train_cfg(configs)
    mcfg = cfg.model
    n = 400
    params_phys = SurrogateDataGenerator(seed=SEED).generate_training_samples(
        n, "lhs")
    ert = np.random.default_rng(SEED + 10).normal(
        50.0, 10.0, size=(n, mcfg.cond_length, mcfg.cond_channels))
    ds = prepare_dataset(params_phys[..., None], ert)
    tmp = tempfile.mkdtemp(prefix="ertdx_torch_ckpt_")
    try:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, num_epochs=2, step_checkpoint_every=1,
            checkpoint_dir=tmp))
        sa.reset_launches()
        t0 = time.perf_counter()
        res = train.train(cfg, ds, device=dev, logger=lambda d: log(
            f"train(): {d}"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(sa.launches)
        steps = res.state.step
        log(f"train(): 2 epochs, {steps} steps in {seconds:.3f} s "
            f"({res.steps_per_sec:.3f} steps/s), best epoch "
            f"{res.best_epoch + 1}, val {res.val_history}; slab launches "
            f"{counts}")
        n_val_batches = -(-int(0.1 * n) // cfg.train.batch_size)
        want = {"slab_attention_fwd": steps + 2 * n_val_batches,
                "slab_attention_bwd": steps}
        if counts != want:
            raise RuntimeError(f"train(): slab launches {counts}, expected "
                               f"{want}")
        if not np.isfinite(res.train_history + res.val_history).all():
            raise RuntimeError("train(): non-finite loss")

        best, meta, scalers = train.load_best_model(tmp, cfg, device=dev)
        tree, _, _ = ckpt_lib.restore_checkpoint(os.path.join(tmp, "last"))
        last = copy.deepcopy(res.state.model)
        params_from_jax(last, tree["params"])
        x = torch.from_numpy(ds.params_u[:8]).to(dev)
        cond = torch.from_numpy(ds.conditions[:8]).to(dev)
        t = torch.arange(8, device=dev) * 60
        with torch.no_grad():
            trained = res.state.model(x, t, cond)
            from_last = last(x, t, cond)
            from_best = best.model(x, t, cond)
        d_last = float((from_last - trained).abs().max())
        same = all(torch.equal(a, b) for a, b in
                   zip(last.parameters(), res.state.model.parameters()))
        if not (same and d_last <= 1e-5
                and torch.isfinite(from_best).all()):
            raise RuntimeError(f"checkpoint read back differs: params "
                               f"equal {same}, outputs {d_last}")
        d_best = float((from_best - trained).abs().max())
        log(f"checkpoints: last restores the trained parameters bit for "
            f"bit (outputs max|d|={d_last:.3e}); best (epoch "
            f"{meta['epoch']}) restores, max|d| vs the final model "
            f"{d_best:.3e}, step {best.step}, scalers {sorted(scalers)}")
        if res.best_epoch == 1 and not d_best <= 1e-5:
            raise RuntimeError("best checkpoint of the last epoch differs "
                               "from the trained model")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def check_gn_conv(gn, cv, dev, report: str, card: str) -> dict:
    """Phase 10: ptxas' spill line of both fused-conv kernels (a spill
    fails); the GN and fused-conv kernels, forward and backward, against
    their plain versions, reruns bit-identical, the GN kernels' launch
    plan (staged or streamed) at each case; timed at the large shapes,
    the fused conv's backward launch by launch, with TFLOP/s and the
    share of the bound, and the GN kernels' GB/s at every case."""
    import torch.nn.functional as F

    check_no_spill(report, CONV_KERNELS)

    gen = torch.Generator(device=dev).manual_seed(SEED + 100)
    eps = 1e-5

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    def lib_gn(x, gamma, beta):        # (B, C, L) view in and out
        return F.silu(F.group_norm(x.transpose(1, 2), GROUPS, gamma, beta,
                                   eps))

    def grad_of(fn, ins, g):
        leaves = [t.detach().requires_grad_(True) for t in ins]
        out = fn(*leaves)
        return lambda: torch.autograd.grad(out, leaves, g,
                                           retain_graph=True)

    results = {}
    cases = ([("gn", c) for c in GN_CASES]
             + [("conv", c) for c in CONV_CASES])
    for kind, case in cases:
        if kind == "gn":
            b, l, c, mean = case
            cout = c
            x = rnd(b, l, c, scale=2.0 if mean < 100 else 1.0, shift=mean)
            ins = (x, rnd(c, scale=0.3, shift=1.0), rnd(c, scale=0.3))
            dy = rnd(b, l, c)
            names = ("groupnorm_silu_fwd", "groupnorm_silu_bwd")
            fwd = lambda: gn.groupnorm_silu_fwd(*ins, GROUPS)
            bwd = lambda: gn.groupnorm_silu_bwd(*ins, dy, GROUPS)
            plain = lambda *a: gn.reference_groupnorm_silu(*a, GROUPS)
            lib = lambda xx, ga, be: lib_gn(xx, ga, be).transpose(1, 2)
            grads = ("dx", "dgamma", "dbeta")
            n = b * l * c
            # ~10 operations a value forward (two statistics passes,
            # normalise, affine, SiLU), ~30 backward; bytes: x (and dy)
            # read once, y (dx) written once
            work = {names[0]: (10 * n, 4 * (2 * n + 2 * c)),
                    names[1]: (30 * n, 4 * (3 * n + 4 * c))}
            shape = f"B={b} L={l} C={c}" + (f" mean {mean:g}"
                                            if mean >= 100 else "")
            plans = {name: gn.launch_plan(l, c, GROUPS, k)
                     for name, k in zip(names, ("fwd", "bwd"))}
        else:
            b, l, c, cout = case
            x = rnd(b, l, c)
            ins = (x, rnd(c, scale=0.3, shift=1.0), rnd(c, scale=0.3),
                   rnd(3, c, cout, scale=1.0 / math.sqrt(3 * c)),
                   rnd(cout, scale=0.3))
            dy = rnd(b, l, cout)
            names = ("gn_silu_conv3_fwd", "gn_silu_conv3_bwd")
            fwd = lambda: cv.gn_silu_conv3_fwd(*ins, GROUPS)
            bwd = lambda: cv.gn_silu_conv3_bwd(*ins[:4], dy, GROUPS)
            plain = lambda *a: cv.reference_gn_silu_conv3(*a, GROUPS)
            # explicit pad and contiguous weight: with padding=1 cuDNN
            # picked FFT algorithms at L=147 (200 ms a backward)
            lib = lambda xx, ga, be, ww, bb: F.conv1d(
                F.pad(lib_gn(xx, ga, be), (1, 1)),
                ww.permute(2, 1, 0).contiguous(), bb).transpose(1, 2)
            grads = ("dx", "dgamma", "dbeta", "dW", "db")
            prod = 2 * b * l * 3 * c * cout
            nx, ny, nw = b * l * c, b * l * cout, 3 * c * cout
            work = {names[0]: (prod, 4 * (nx + 2 * c + nw + cout + ny)),
                    names[1]: (2 * prod, 4 * (nx + ny + 2 * c + nw
                                              + nx + 2 * c + nw + cout))}
            shape = f"B={b} L={l} C={c} Cout={cout}"
            plans = {"gn_silu_conv3 statistics":
                     gn.launch_plan(l, c, GROUPS, "stats"),
                     "gn_silu_conv3 GN backward":
                     gn.launch_plan(l, c, GROUPS, "bwd")}
        log(f"{shape}: launch plans " + "; ".join(
            f"{name} {p.path} ({p.threads} threads, {p.smem_bytes} bytes "
            "of shared memory)" for name, p in plans.items()))
        got = fwd()
        dgot = bwd()
        again, dagain = fwd(), bwd()
        torch.cuda.synchronize()
        if not (torch.equal(got, again) and all(
                torch.equal(a, w) for a, w in zip(dgot, dagain))):
            raise RuntimeError(f"{names[0]} {shape}: a rerun differs")
        want = plain(*ins)
        dwant = grad_of(plain, ins, dy)()
        torch.cuda.synchronize()
        checks = [(names[0], "y", got, want)] + [
            (names[1], g, a, w) for g, a, w in zip(grads, dgot, dwant)]
        for name, out, a, w in checks:
            if a.shape != w.shape or not torch.isfinite(a).all():
                raise RuntimeError(f"{name} {shape} {out}: wrong shape or "
                                   "non-finite")
            err = float((a - w).abs().max())
            scale = float(w.abs().max())
            tol = 1e-4 * max(1.0, scale)
            log(f"{name} {shape} {out}: max_abs_err={err:.3e} "
                f"max|plain|={scale:.4f} tol={tol:.3e}")
            if not err <= tol:
                raise RuntimeError(f"{name} {shape} {out}: error {err} > "
                                   f"{tol}")
            entry = results.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if b < 256:
            if kind == "gn":            # the kernels alone, for GB/s
                for name, kernel in zip(names, (fwd, bwd)):
                    with torch.no_grad():
                        ms = time_ms(kernel)
                    flops, nbytes = work[name]
                    bd = bound(flops, nbytes, products=False)
                    log(f"{name} {shape} ({plans[name].path}): kernel "
                        f"{ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s, "
                        f"bound {bd['bound_ms']:.4f} ms, "
                        f"{100 * bd['bound_ms'] / ms:.1f} % of the bound; "
                        f"{card}")
            continue
        lib_err = float((lib(*ins) - want).abs().max())
        timed = {names[0]: (fwd, lambda: plain(*ins), lambda: lib(*ins)),
                 names[1]: (bwd, grad_of(plain, ins, dy),
                            grad_of(lib, ins, dy))}
        for name, (kernel, plain_fn, lib_fn) in timed.items():
            with torch.no_grad() if name == names[0] else \
                    torch.enable_grad():
                ms = time_ms(kernel)
                plain_ms = time_ms(plain_fn)
                lib_ms = time_ms(lib_fn)
                records, _ = kernel_records(
                    lambda: [kernel() for _ in range(10)])
            dev_ms = sum(e.time_range.elapsed_us() for e in records) / 10e3
            flops, nbytes = work[name]
            # GroupNorm does no matrix product
            bd = bound(flops, nbytes,
                       products=not name.startswith("groupnorm"))
            path = f" ({plans[name].path})" if name in plans else ""
            log(f"{name} {shape}{path}: kernel {ms:.4f} ms (profiler device "
                f"{dev_ms:.4f} ms), "
                f"plain {plain_ms:.4f} ms, library composition "
                f"{lib_ms:.4f} ms (its forward vs plain: max|d| "
                f"{lib_err:.2e}), {bound_text(bd, flops, nbytes)}, achieved "
                f"{flops / ms / 1e9:.2f} TFLOP/s, {nbytes / ms / 1e6:.1f} "
                f"GB/s, {100 * bd['bound_ms'] / ms:.1f} % of the bound; "
                f"{card}")
            if name == "gn_silu_conv3_bwd":
                log(f"{name} {shape}, launch by launch: "
                    + launch_times(kernel))
            entry = results[name]
            if "ms" not in entry:       # the first large case: the path's
                entry.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                             composition_ms=lib_ms, device_ms=dev_ms, **bd,
                             shape=shape)
    return results


def check_flash(at, dev, card) -> dict:
    """Phase 12: the flash kernels (forward, dQ, dK/dV) against their
    plain versions at every case, reruns bit-identical, timed at the
    encoder's flash shape beside SDPA on the same padded and masked
    operands (a yardstick: the port never calls it)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 120)
    results = {}
    for b, h, l, d, valid, dead in FLASH_CASES:
        shape = f"B={b} H={h} L={l} Dh={d} valid={valid} dead rows={dead}"
        q, k, v, do = (torch.randn(b, h, l, d, generator=gen, device=dev)
                       for _ in range(4))
        mask = torch.zeros(b, l, device=dev)
        mask[:, :valid] = 1.0
        for row in dead:
            mask[row] = 0.0
        out, lse = at.flash_attention_fwd(q, k, v, mask)
        dq, delta = at.flash_attention_bwd_dq(q, k, v, mask, out, lse, do)
        dk, dv = at.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do)
        torch.cuda.synchronize()
        w_out, w_lse = at.reference_flash_forward(q, k, v, mask)
        w_dq, w_delta = at.reference_flash_backward_dq(q, k, v, mask, w_out,
                                                       w_lse, do)
        w_dk, w_dv = at.reference_flash_backward_dkv(q, k, v, mask, w_lse,
                                                     w_delta, do)
        live = mask.amax(dim=1) > 0
        checks = [("flash_attention_fwd", "out", out, w_out),
                  ("flash_attention_fwd", "out vs reference_attention", out,
                   at.reference_attention(q, k, v, mask)),
                  ("flash_attention_fwd", "lse (rows with a valid key)",
                   lse[live], w_lse[live]),
                  ("flash_attention_bwd_dq", "dq", dq, w_dq),
                  ("flash_attention_bwd_dq", "delta", delta, w_delta),
                  ("flash_attention_bwd_dkv", "dk", dk, w_dk),
                  ("flash_attention_bwd_dkv", "dv", dv, w_dv)]
        for name, what, a, w in checks:
            if a.shape != w.shape or not torch.isfinite(a).all():
                raise RuntimeError(f"{name} {shape} {what}: wrong shape or "
                                   "non-finite")
            err = float((a - w).abs().max())
            scale = float(w.abs().max())
            tol = 1e-4 * max(1.0, scale)
            log(f"{name} {shape} {what}: max_abs_err={err:.3e} "
                f"max|plain|={scale:.4f} tol={tol:.3e}")
            if not err <= tol:
                raise RuntimeError(f"{name} {shape} {what}: error {err} > "
                                   f"{tol}")
            entry = results.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if dead and not (lse[~live] == -1e30).all():
            raise RuntimeError("all-masked rows: lse is not -1e30")
        # key rows the backward skips (all padding, in a live batch row)
        # hold exactly 0 in dK and dV
        tiles = at.skip_tiles(d)
        tile = tiles["dkv_warp_keys"]
        pad = (mask.reshape(b, l // tile, tile).amax(dim=2) <= 0) \
            & live[:, None]
        pad = pad.repeat_interleave(tile, dim=1)[:, None, :, None]
        skipped_nonzero = int(((dk != 0) & pad).sum() + ((dv != 0) & pad).sum())
        log(f"flash {shape}: dK, dV entries of skipped key rows that are "
            f"not 0: {skipped_nonzero} of {2 * int(pad.sum()) * h * d}")
        if skipped_nonzero:
            raise RuntimeError(f"flash {shape}: skipped key rows not zero")
        again = (*at.flash_attention_fwd(q, k, v, mask),
                 at.flash_attention_bwd_dq(q, k, v, mask, out, lse, do)[0],
                 *at.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do))
        same = [torch.equal(a, w)
                for a, w in zip(again, (out, lse, dq, dk, dv))]
        log(f"flash {shape}: reruns bit-identical (out, lse, dq, dk, dv) "
            f"{same}")
        if not all(same):
            raise RuntimeError(f"flash {shape}: reruns differ")
        if (b, h, l, d, valid, dead) != FLASH_CASES[0]:
            continue

        bias = torch.where(mask > 0, 0.0, -1e30)[:, None, None, :]

        def sdpa(q_, k_, v_):
            return F.scaled_dot_product_attention(q_, k_, v_, attn_mask=bias)

        def sdpa_backward():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = sdpa(*leaves)
            return lambda: torch.autograd.grad(o, leaves, do,
                                               retain_graph=True)

        sdpa_err = float((sdpa(q, k, v) - w_out).abs().max())
        timed = {
            "flash_attention_fwd": (
                lambda: at.flash_attention_fwd(q, k, v, mask),
                lambda: at.reference_flash_forward(q, k, v, mask),
                lambda: sdpa(q, k, v)),
            "flash_attention_bwd_dq": (
                lambda: at.flash_attention_bwd_dq(q, k, v, mask, out, lse,
                                                  do),
                lambda: at.reference_flash_backward_dq(q, k, v, mask, out,
                                                       lse, do), None),
            "flash_attention_bwd_dkv": (
                lambda: at.flash_attention_bwd_dkv(q, k, v, mask, lse,
                                                   delta, do),
                lambda: at.reference_flash_backward_dkv(q, k, v, mask, lse,
                                                        delta, do), None)}
        # the work this run's mask needs: every query row against the keys
        # that count, a batch row's valid keys (the rest have p = 0), or
        # all of them where it has none (p = 1 there). Operations: 2 per
        # FMA of the products each kernel needs for its outputs, the
        # forward 2 (S, PV), dQ 3 (S, dP, dS K), dK/dV 4 (S, dP, P^T dO,
        # dS^T Q). Bytes: each input read once, K and V on those keys
        # only; each output written once (dK and dV in full: the padded
        # rows' zeros too)
        n_valid = mask.gt(0).sum(dim=1)
        keys = int(torch.where(n_valid > 0, n_valid, l).sum())
        prod = h * l * keys * d       # one Lq x keys x Dh product, in FMAs
        n_q, n_kv, n_row = b * h * l * d, h * keys * d, b * h * l
        work = {"flash_attention_fwd": (
                    2, 4 * (2 * n_q + 2 * n_kv + n_row + b * l)),
                "flash_attention_bwd_dq": (
                    3, 4 * (4 * n_q + 2 * n_kv + 2 * n_row + b * l)),
                "flash_attention_bwd_dkv": (
                    4, 4 * (4 * n_q + 2 * n_kv + 2 * n_row + b * l))}
        for name, (kernel, plain_fn, lib_fn) in timed.items():
            with torch.no_grad():
                ms = time_ms(kernel)
                plain_ms = time_ms(plain_fn)
                lib_ms = time_ms(lib_fn) if lib_fn else None
                records, _ = kernel_records(
                    lambda: [kernel() for _ in range(10)])
            dev_ms = sum(e.time_range.elapsed_us() for e in records) / 10e3
            n_prod, nbytes = work[name]
            flops = 2 * n_prod * prod
            bd = bound(flops, nbytes)
            log(f"{name} {shape}: kernel {ms:.4f} ms (profiler device "
                f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, SDPA "
                f"{'%.4f ms' % lib_ms if lib_ms else 'none (no one call)'}, "
                f"{bound_text(bd, flops, nbytes)} on {keys} of {b * l} "
                f"keys, achieved {flops / ms / 1e9:.2f} TFLOP/s; {card}")
            results[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 device_ms=dev_ms, **bd, shape=shape)
        bwd_lib = time_ms(sdpa_backward())
        bwd_ms = (results["flash_attention_bwd_dq"]["ms"]
                  + results["flash_attention_bwd_dkv"]["ms"])
        # dQ, dK and dV together: S, dP, dS K, P^T dO, dS^T Q once each
        bwd_bd = bound(2 * 5 * prod,
                       4 * (6 * n_q + 2 * n_kv + n_row + b * l))
        log(f"flash backward (dQ + dK/dV) {bwd_ms:.4f} ms against one SDPA "
            f"backward {bwd_lib:.4f} ms on the same operands (SDPA forward "
            f"vs plain max|d| {sdpa_err:.2e}); the backward's bound with "
            f"the five products counted once {bwd_bd['bound_ms']:.4f} ms "
            f"(fp32 pipe {bwd_bd['bound_fp32_ms']:.4f} ms); {card}")
        live_keys = mask[live]
        for what, tile in (("forward key tiles", tiles["fwd_key_tile"]),
                           ("dQ key tiles", tiles["dq_key_tile"]),
                           ("dK/dV key rows of a warp",
                            tiles["dkv_warp_keys"])):
            empty = live_keys.reshape(-1, l // tile, tile).amax(dim=2) <= 0
            log(f"flash kernels at {shape}: {what} ({tile} keys) skipped "
                f"as all padding: {float(empty.float().mean()):.4f} of them")
        def sdpa_fwd_bwd():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            torch.autograd.grad(sdpa(*leaves), leaves, do)

        log("SDPA's route, forward and backward (profiler kernel names, "
            "device time): " + kernel_names(sdpa_fwd_bwd))
    return results


class _Counts:
    """The launch counts of several ops modules as one `launches` dict."""

    def __init__(self, *mods):
        self.mods = mods

    @property
    def launches(self) -> dict:
        return {k: v for mod in self.mods for k, v in mod.launches.items()}

    def reset_launches(self) -> None:
        for mod in self.mods:
            mod.reset_launches()


class _AllCounts(_Counts):
    """The float32 and bf16 launch counts of several ops modules as one
    `launches` dict."""

    @property
    def launches(self) -> dict:
        return {k: v for mod in self.mods for d in (
            mod.launches, getattr(mod, "launches_bf16", {}))
            for k, v in d.items()}


def fused_arm_cfg(configs):
    """Phase 11's configuration: phase 7's with the fused-encoder arm of
    benchmarks/train_stack.py (pallas_gn, pallas_conv_min_width=256)."""
    cfg = train_cfg(configs)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, pallas_gn=True, pallas_conv_min_width=256))


def set_kernels(model, on: bool) -> None:
    """Every kernel switch of the encoder: use_pallas of the GN and fused
    conv modules, and the slab attention."""
    for mod in model.modules():
        if hasattr(mod, "use_pallas"):
            mod.use_pallas = on
    model.encoder.attn.slab = on


def check_fused_training(counts, dev, card) -> dict:
    """Phase 11 (a): the fused arm's kernel path against its plain path,
    5 train steps."""
    from ertdx_torch import configs
    from ertdx_torch.models import build_model
    from ertdx_torch.models.condunet import FusedGNConv, GNSiLU
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax

    cfg = fused_arm_cfg(configs)
    mcfg, tcfg = cfg.model, cfg.train
    kernel = build_model(mcfg, dev, generator=torch.Generator()
                         .manual_seed(SEED + 110))
    params_from_jax(kernel, random_flax_tree(
        flax_shapes(kernel), np.random.default_rng(SEED + 111)))
    fused = [m for m in kernel.modules() if isinstance(m, FusedGNConv)]
    gns = [m for m in kernel.modules() if isinstance(m, GNSiLU)]
    log(f"fused-encoder arm: pallas_gn={mcfg.pallas_gn} "
        f"pallas_conv_min_width={mcfg.pallas_conv_min_width}: "
        f"{len(fused)} FusedGNConv "
        f"({sorted({tuple(m.kernel.shape[1:]) for m in fused})}), "
        f"{len(gns)} GNSiLU on the GN kernels, attn_slab={mcfg.attn_slab}, "
        f"batch {tcfg.batch_size}, condition {mcfg.cond_length} x "
        f"{mcfg.cond_channels}")
    if len(fused) != 6 or len(gns) != 2 or not all(m.use_pallas
                                                   for m in gns):
        raise RuntimeError("the fused arm's encoder is not 6 fused convs "
                           "and 2 GN pairs")
    plain = copy.deepcopy(kernel)
    set_kernels(plain, False)
    want = {"groupnorm_silu_fwd": 2, "groupnorm_silu_bwd": 2,
            "gn_silu_conv3_fwd": 6, "gn_silu_conv3_bwd": 6,
            "slab_attention_fwd": 1, "slab_attention_bwd": 1}
    return compare_train_paths("fused arm", cfg, kernel, plain, counts,
                               want, SEED + 112, card)


def compare_train_paths(label, cfg, kernel, plain, counts, want, seed,
                        card) -> dict:
    """TRAIN_STEPS b256 train steps of `kernel` against the same steps of
    `plain` under phase 7's rules (plain vs plain first: it sets the
    tolerance), exactly `want` launches (by `counts`) a step, and a
    profile of one step of each path; returns the ms per step of both."""
    from ertdx_torch import train
    from ertdx_torch.diffusion import schedule_from_config

    mcfg, tcfg = cfg.model, cfg.train
    dev = next(kernel.parameters()).device
    plain2 = copy.deepcopy(plain)
    alpha_bar = schedule_from_config(cfg.diffusion).alpha_bar.to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, p = tcfg.batch_size, mcfg.param_dim
    batches = [(torch.randn(b, p, generator=gen, device=dev),
                torch.rand(b, mcfg.cond_length, mcfg.cond_channels,
                           generator=gen, device=dev),
                torch.randint(0, cfg.diffusion.T, (b,), generator=gen,
                              device=dev),
                torch.randn(b, p, generator=gen, device=dev))
               for _ in range(TRAIN_STEPS)]
    lr = train.make_lr(tcfg, TRAIN_STEPS)

    pl, p_ms, _, pg = _run_steps(train, plain,
                                 train.create_optimizer(plain, lr), batches,
                                 alpha_bar, lr)
    pl2, _, _, pg2 = _run_steps(train, plain2,
                                train.create_optimizer(plain2, lr), batches,
                                alpha_bar, lr)
    pp_loss = max(abs(a - c) for a, c in zip(pl, pl2))
    pp = _param_diffs(plain, plain2)
    pp_share = float((pp > 1e-5).float().mean())
    log(f"{label}, plain vs plain: max|dloss|={pp_loss:.3e} max|dgrad|="
        f"{max(float((pg[n] - pg2[n]).abs().max()) for n in pg):.3e} "
        f"max|dparam|={float(pp.max()):.3e} share > 1e-5: {pp_share:.3e}")

    counts.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    kl, k_ms, per_step, kg = _run_steps(train, kernel,
                                        train.create_optimizer(kernel, lr),
                                        batches, alpha_bar, lr, counts)
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}, kernel path: losses {kl}; launches per step {per_step}")
    for step, cnt in enumerate(per_step):
        if cnt != want:
            raise RuntimeError(f"{label} step {step + 1}: launches {cnt}, "
                               f"expected {want}")
    loss_tol = max(1e-5, 10 * pp_loss)
    for step, (a, c) in enumerate(zip(kl, pl)):
        if not abs(a - c) <= loss_tol * max(1.0, abs(c)):
            raise RuntimeError(f"{label} step {step + 1}: loss {a} vs "
                               f"plain {c}, tolerance {loss_tol:.1e}")
    worst = _compare_grads(f"{label} step 1", kg, pg)
    kp = _param_diffs(kernel, plain)
    k_share = float((kp > 1e-5).float().mean())
    flip_bound = 2 * tcfg.lr * TRAIN_STEPS
    log(f"{label}, kernel vs plain: max|dloss|="
        f"{max(abs(a - c) for a, c in zip(kl, pl)):.3e} (tol {loss_tol:.1e}"
        f" x max(1, loss)); step-1 gradients worst err/tol {worst:.3f}; "
        f"params after {TRAIN_STEPS} steps max|d|={float(kp.max()):.3e} "
        f"(bound {flip_bound:.1e}), share > 1e-5 {k_share:.3e} (limit "
        f"max(1e-3, 2 x plain-vs-plain))")
    _log_param_gaps(f"{label}, kernel vs plain", kernel, plain, kg, pg)
    if not (float(kp.max()) <= flip_bound + 1e-6
            and k_share <= max(1e-3, 2 * pp_share)):
        raise RuntimeError(f"{label}: kernel-path parameters disagree "
                           "with the plain path")

    for model, path in ((kernel, "kernel"), (plain, "plain")):
        x0, cond, t, noise = batches[0]
        opt = train.create_optimizer(model, lr)
        device_profile(lambda: train.train_step(model, opt, x0, cond, t,
                                                noise, alpha_bar=alpha_bar,
                                                lr=lr),
                       f"one {label} train step, {path} path")
    k_step = statistics.median(k_ms[1:])
    p_step = statistics.median(p_ms[1:])
    log(f"{label} ms per train step (median of steps 2-{TRAIN_STEPS}; "
        f"{card}): kernel path {k_step:.3f}, plain path {p_step:.3f}; "
        f"peak memory {peak / 2**20:.1f} MiB; step times kernel {k_ms} "
        f"plain {p_ms}")
    return {"kernel_step_ms": k_step, "plain_step_ms": p_step}


def check_fused_train_entry(counts, dev, card) -> dict:
    """Phase 11 (b): train() of the fused arm with guidance dropout, EMA
    and the flat optimizer for 2 epochs, resumed for a third; the last
    checkpoint read back."""
    from ertdx_torch import configs, train
    from ertdx_torch.data import prepare_dataset
    from ertdx_torch.doe import SurrogateDataGenerator
    from ertdx_torch.utils import checkpoint as ckpt_lib
    from ertdx_torch.utils.weights import (adam_state_from_jax,
                                           params_from_jax)

    cfg = fused_arm_cfg(configs)
    mcfg = dataclasses.replace(cfg.model, uncond_prob=0.1)
    n = 400
    params_phys = SurrogateDataGenerator(
        seed=SEED + 1).generate_training_samples(n, "lhs")
    ert = np.random.default_rng(SEED + 113).normal(
        50.0, 10.0, size=(n, mcfg.cond_length, mcfg.cond_channels))
    ds = prepare_dataset(params_phys[..., None], ert)
    tmp = tempfile.mkdtemp(prefix="ertdx_torch_fused_")
    try:
        def run(epochs, resume):
            run_cfg = dataclasses.replace(cfg, model=mcfg,
                                          train=dataclasses.replace(
                cfg.train, num_epochs=epochs, step_checkpoint_every=1,
                ema_decay=0.999, flat_optimizer=True, checkpoint_dir=tmp))
            counts.reset_launches()
            t0 = time.perf_counter()
            res = train.train(run_cfg, ds, device=dev, resume=resume,
                              logger=lambda d: log(f"train(): {d}"))
            torch.cuda.synchronize()
            return run_cfg, res, dict(counts.launches), \
                time.perf_counter() - t0

        def rule(steps, forwards):
            return {"groupnorm_silu_fwd": 2 * forwards,
                    "groupnorm_silu_bwd": 2 * steps,
                    "gn_silu_conv3_fwd": 6 * forwards,
                    "gn_silu_conv3_bwd": 6 * steps,
                    "slab_attention_fwd": forwards,
                    "slab_attention_bwd": steps}

        bsz = cfg.train.batch_size
        per_epoch = -(-int(0.8 * n) // bsz)
        val_batches = -(-int(0.1 * n) // bsz)
        _, res, got, seconds = run(2, False)
        steps = res.state.step
        want = rule(steps, steps + 2 * val_batches)
        log(f"train() fused arm, uncond_prob={mcfg.uncond_prob}, EMA 0.999, "
            f"flat optimizer: 2 epochs, {steps} steps in {seconds:.3f} s "
            f"({res.steps_per_sec:.3f} steps/s; {card}), val "
            f"{res.val_history}; "
            f"rule per forward (train or eval) 2 GN and 6 conv forwards and "
            f"one slab forward, per train step 2 GN and 6 conv backwards "
            f"and one slab backward, {steps} steps + 2 x {val_batches} eval "
            f"batches -> {want}; counted {got}")
        if steps != 2 * per_epoch or got != want:
            raise RuntimeError("train() fused arm: launches differ from "
                               "the rule")
        if not np.isfinite(res.train_history + res.val_history).all():
            raise RuntimeError("train() fused arm: non-finite loss")

        cfg3, res3, got3, seconds3 = run(3, True)
        want3 = rule(per_epoch, per_epoch + val_batches)
        log(f"train(resume=True) to 3 epochs: {seconds3:.3f} s ({card}), "
            f"train "
            f"history {res3.train_history}, step {res3.state.step}; "
            f"launches {got3} (one epoch by the rule: {want3})")
        if (res3.train_history[:2] != res.train_history or got3 != want3
                or res3.state.step != 3 * per_epoch):
            raise RuntimeError("train(resume=True) did not continue the run")

        tree, meta, _ = ckpt_lib.restore_checkpoint(os.path.join(tmp,
                                                                 "last"))
        trained = res3.state.model
        last = copy.deepcopy(trained)
        params_from_jax(last, tree["params"])
        opt = train.create_optimizer(last, res3.state.lr)
        adam_state_from_jax(opt, last, tree["opt_state"], flat=True)
        adam_same = all(
            torch.equal(opt.state[a]["exp_avg"],
                        res3.state.opt.state[b]["exp_avg"])
            and torch.equal(opt.state[a]["exp_avg_sq"],
                            res3.state.opt.state[b]["exp_avg_sq"])
            for a, b in zip(last.parameters(), trained.parameters()))
        x = torch.from_numpy(ds.params_u[:8]).to(dev)
        cond = torch.from_numpy(ds.conditions[:8]).to(dev)
        t = torch.arange(8, device=dev) * 60
        best, bmeta, _ = train.load_best_model(tmp, cfg3, device=dev)
        with torch.no_grad():
            out = trained(x, t, cond)
            from_last = last(x, t, cond)
            from_best = best.model(x, t, cond)
        log(f"last checkpoint (epoch {meta['epoch']}): forward bit for bit "
            f"{torch.equal(out, from_last)}, flat Adam state exact "
            f"{adam_same}, flat mu {tree['opt_state']['0']['mu'].shape}; "
            f"best (epoch {bmeta['epoch']}) restores through "
            f"load_best_model, step {best.step}, EMA "
            f"{best.ema_params is not None}, max|d| vs the final model "
            f"{float((from_best - out).abs().max()):.3e}")
        if not (meta["epoch"] == 3 and torch.equal(out, from_last)
                and adam_same and torch.isfinite(from_best).all()
                and best.ema_params is not None):
            raise RuntimeError("fused arm: checkpoint read back differs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {k: v for k, v in got.items() if not k.startswith("slab_")}


FLASH_WANT = {"flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
              "flash_attention_bwd_dkv": 1}


def flash_arm_cfg(configs):
    """Phases 13-14's configuration: phase 7's with the slab off and the
    batch-aware flash gate at 1, the arm of benchmarks/train_attn.py."""
    cfg = train_cfg(configs)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, attn_slab=False, attn_flash_min_logits=1))


def plain_attention(model):
    """A copy of `model` whose encoder attention runs its plain version
    (use_pallas off, as ModelConfig.use_pallas=False builds it)."""
    plain = copy.deepcopy(model)
    plain.encoder.attn.use_pallas = False
    return plain


def check_flash_training(at, dev, card) -> dict:
    """Phase 13 (a): the flash arm's kernel path against its plain path,
    5 b256 train steps under phase 7's rules."""
    from ertdx_torch import configs
    from ertdx_torch.models import build_model
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax

    cfg = flash_arm_cfg(configs)
    mcfg, tcfg = cfg.model, cfg.train
    kernel = build_model(mcfg, dev, generator=torch.Generator()
                         .manual_seed(SEED + 130))
    params_from_jax(kernel, random_flax_tree(
        flax_shapes(kernel), np.random.default_rng(SEED + 131)))
    attn = kernel.encoder.attn
    log(f"flash arm: attn_slab={attn.slab} use_pallas={attn.use_pallas} "
        f"flash_min_logits={attn.flash_min_logits} heads={attn.num_heads}, "
        f"batch {tcfg.batch_size}, condition {mcfg.cond_length} x "
        f"{mcfg.cond_channels}")
    if attn.slab or not attn.use_pallas or attn.flash_min_logits != 1:
        raise RuntimeError("the flash arm's encoder attention is not gated "
                           "to the flash kernels")
    return compare_train_paths("flash arm", cfg, kernel,
                               plain_attention(kernel), at, FLASH_WANT,
                               SEED + 132, card)


def check_flash_train_entry(at, ckdir, dev, card):
    """Phase 13 (b): train() of the flash arm for 2 epochs into `ckdir`,
    which phase 14 distills; launches by the epoch grid. Returns the
    dataset and the counts."""
    from ertdx_torch import configs, train
    from ertdx_torch.data import prepare_dataset
    from ertdx_torch.doe import SurrogateDataGenerator

    cfg = flash_arm_cfg(configs)
    mcfg = cfg.model
    n = 400
    params_phys = SurrogateDataGenerator(
        seed=SEED + 2).generate_training_samples(n, "lhs")
    ert = np.random.default_rng(SEED + 133).normal(
        50.0, 10.0, size=(n, mcfg.cond_length, mcfg.cond_channels))
    ds = prepare_dataset(params_phys[..., None], ert)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=2, checkpoint_dir=ckdir))
    at.reset_launches()
    t0 = time.perf_counter()
    res = train.train(cfg, ds, device=dev, logger=lambda d: log(
        f"train(): {d}"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = dict(at.launches)
    steps = res.state.step
    val_batches = -(-int(0.1 * n) // cfg.train.batch_size)
    want = {"flash_attention_fwd": steps + 2 * val_batches,
            "flash_attention_bwd_dq": steps,
            "flash_attention_bwd_dkv": steps}
    log(f"train() flash arm: 2 epochs, {steps} steps in {seconds:.3f} s "
        f"({res.steps_per_sec:.3f} steps/s; {card}), val "
        f"{res.val_history}; rule: one flash forward per forward (train "
        f"or eval), one dQ and one dK/dV per step, {steps} steps + 2 x "
        f"{val_batches} eval batches -> {want}; counted {got}")
    if steps != 2 * -(-int(0.8 * n) // cfg.train.batch_size) or got != want:
        raise RuntimeError("train() flash arm: launches differ from the "
                           "rule")
    if not np.isfinite(res.train_history + res.val_history).all():
        raise RuntimeError("train() flash arm: non-finite loss")
    return ds, got


def check_flash_serving(at, cb, ckdir, dev, card) -> None:
    """Phase 13 (c): a configs[3] posterior ensemble (DDIM-50, 8
    conditions x 1000 members on the fused core) from phase 13's trained
    flash-arm model: one flash forward per call (the condition is encoded
    once), draws within 1e-3 of the all-plain path."""
    from ertdx_torch import configs, sample, train
    from ertdx_torch.diffusion import schedule_from_config

    cfg = flash_arm_cfg(configs)
    state, _, _ = train.load_best_model(ckdir, cfg, device=dev)
    model = state.model.eval()
    plain = plain_attention(model)
    plain.ensemble_mega = False
    scfg = configs.DDIM_ENSEMBLE.sample
    schedule = schedule_from_config(cfg.diffusion)
    n_cond, n_real = 8, scfg.uncertainty_samples
    gen = torch.Generator(device=dev).manual_seed(SEED + 134)
    cond = torch.rand(n_cond, cfg.model.cond_length, cfg.model.cond_channels,
                      generator=gen, device=dev)
    x_T = torch.randn(n_cond * n_real, cfg.model.param_dim, generator=gen,
                      device=dev)
    at.reset_launches()
    cb.reset_launches()
    t0 = time.perf_counter()
    u = sample.posterior_ensemble(model, cond, schedule, n_real, scfg,
                                  x_T=x_T, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    got = {**at.launches, **cb.launches}
    t0 = time.perf_counter()
    u_plain = sample.posterior_ensemble(plain, cond, schedule, n_real, scfg,
                                        x_T=x_T, device=dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    du = float((u - u_plain).abs().max())
    dmean = float((u.mean(0) - u_plain.mean(0)).abs().max())
    dstd = float((u.std(0) - u_plain.std(0)).abs().max())
    log(f"flash-arm ensemble ({n_cond} x {n_real}, DDIM-{scfg.ddim_steps}):"
        f" {run_s:.3f} s kernel path, {plain_s:.3f} s plain ({card}); "
        f"launches {got}; max|du|={du:.3e} max|dmean|={dmean:.3e} "
        f"max|dstd|={dstd:.3e}")
    if got["flash_attention_fwd"] != 1 or got["flash_attention_bwd_dq"] or \
            got["fused_core_stack"] != scfg.ddim_steps:
        raise RuntimeError("flash-arm ensemble: launches differ (one flash "
                           "forward and one fused-core launch a step)")
    if not (torch.isfinite(u).all() and du <= 1e-3 and dmean <= 1e-3
            and dstd <= 1e-3):
        raise RuntimeError("flash-arm ensemble disagrees with the plain "
                           "path")


def check_distill(at, ckdir, ds, dev, card) -> dict:
    """Phase 14: progressive distillation of phase 13's flash-arm eps
    teacher at full width: (a) the first batch's loss and gradients on
    the kernel path against the plain path; (b) distill() with a
    conversion stage and one halving (8 -> 4), one epoch each, with exact
    launch counts; (c) the student read back and served by sample_pd
    (pd-4), draws within 1e-3 of the plain path."""
    from ertdx_torch import configs, distill, sample, train
    from ertdx_torch.diffusion import schedule_from_config

    cfg = flash_arm_cfg(configs)
    schedule = schedule_from_config(cfg.diffusion)
    bsz = cfg.train.batch_size
    state, _, _ = train.load_best_model(ckdir, cfg, device=dev)
    teacher = distill._frozen(state.model)
    student = copy.deepcopy(state.model)
    student.parameterization = "v"
    fns = distill.make_distill_epoch(schedule, 4, "eps", device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 140)
    x0 = torch.from_numpy(ds.params_u[:bsz]).to(dev)
    cond = torch.from_numpy(ds.conditions[:bsz]).to(dev)
    i = torch.randint(0, 4, (bsz,), generator=gen, device=dev)
    noise = torch.randn(x0.shape, generator=gen, device=dev)
    out = {}
    for label, (stu, tea) in (("kernel", (student, teacher)),
                              ("plain", (plain_attention(student),
                                         plain_attention(teacher)))):
        at.reset_launches()
        stu.zero_grad(set_to_none=True)
        loss = fns.batch_loss(stu, tea, x0, cond, i, noise)
        loss.backward()
        torch.cuda.synchronize()
        out[label] = (float(loss.detach()), _grads(stu), dict(at.launches))
    (lk, gk, ck), (lp, gp, cp) = out["kernel"], out["plain"]
    worst = _compare_grads("distill batch 1", gk, gp)
    log(f"distill batch 1: loss {lk:.6f} kernel vs {lp:.6f} plain; "
        f"gradients worst err/tol {worst:.3f}; launches kernel {ck}, plain "
        f"{cp}")
    if not abs(lk - lp) <= 1e-5 * max(1.0, abs(lp)):
        raise RuntimeError("distill batch 1: loss disagrees")
    if ck != {**FLASH_WANT, "flash_attention_fwd": 2} or sum(cp.values()):
        raise RuntimeError("distill batch 1: launches differ (2 flash "
                           "forwards, 1 dQ, 1 dK/dV on the kernel path; "
                           "none on the plain path)")

    tmp = tempfile.mkdtemp(prefix="ertdx_torch_student_")
    try:
        dcfg = distill.DistillConfig(target_steps=4, start_steps=8,
                                     epochs_per_stage=1, convert_epochs=1,
                                     batch_size=bsz, seed=SEED)
        at.reset_launches()
        t0 = time.perf_counter()
        res = distill.distill(cfg, dcfg, ds, ckdir, out_dir=tmp, device=dev,
                              logger=lambda d: log(f"distill(): {d}"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = dict(at.launches)
        n = len(ds)
        steps = 2 * -(-int(0.8 * n) // bsz)        # two stages of one epoch
        val_batches = 2 * -(-int(0.1 * n) // bsz)
        want = {"flash_attention_fwd": 2 * steps + 2 * val_batches,
                "flash_attention_bwd_dq": steps,
                "flash_attention_bwd_dkv": steps}
        stages = [(s.kind, s.student_steps) for s in res.stages]
        log(f"distill(): stages {stages} in {seconds:.3f} s ({card}), "
            f"losses {[s.losses for s in res.stages]}, val "
            f"{[s.val_losses for s in res.stages]}; rule: 2 flash forwards "
            f"(teacher and student encoders), 1 dQ and 1 dK/dV per step, 2 "
            f"forwards per val batch; {steps} steps, {val_batches} val "
            f"batches -> {want}; counted {got}")
        if stages != [("convert", 8), ("halve", 4)] or got != want:
            raise RuntimeError("distill(): stages or launches differ")
        if not all(np.isfinite(s.losses + s.val_losses).all()
                   for s in res.stages):
            raise RuntimeError("distill(): non-finite loss")

        saved = configs.experiment_from_dict(train.saved_config(tmp))
        # the echo as the base: the flash gate is a dispatch knob, not a
        # layout field
        st, meta, _ = train.load_best_model(tmp, saved, device=dev)
        model = st.model.eval()
        plain = plain_attention(model)
        scfg = saved.sample
        n_cond, n_real = 2, 1000
        g2 = torch.Generator(device=dev).manual_seed(SEED + 141)
        x_T = torch.randn(n_cond * n_real, cfg.model.param_dim,
                          generator=g2, device=dev)
        cond2 = cond[:n_cond]
        at.reset_launches()
        u = sample.posterior_ensemble(model, cond2, schedule, n_real, scfg,
                                      x_T=x_T, device=dev)
        torch.cuda.synchronize()
        got_s = dict(at.launches)
        u_plain = sample.posterior_ensemble(plain, cond2, schedule, n_real,
                                            scfg, x_T=x_T, device=dev)
        du = float((u - u_plain).abs().max())
        log(f"student (echo: sampler {scfg.sampler}, pd_steps "
            f"{scfg.pd_steps}, parameterization "
            f"{saved.model.parameterization}, meta epoch {meta['epoch']}): "
            f"u {tuple(u.shape)}, launches {got_s}, max|du| vs plain "
            f"{du:.3e}")
        if (scfg.sampler, scfg.pd_steps, saved.model.parameterization) != \
                ("pd", 4, "v") or got_s != {**FLASH_WANT,
                                            "flash_attention_bwd_dq": 0,
                                            "flash_attention_bwd_dkv": 0}:
            raise RuntimeError("student: echo or launches differ")
        if not (torch.isfinite(u).all() and du <= 1e-3):
            raise RuntimeError("student: draws non-finite or off the plain "
                               "path")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return got


# ---------------------------------------------------------------------------
# 15. bfloat16: V5E8_DP in its own dtype
# ---------------------------------------------------------------------------

# the bf16 kernels of csrc/slab_attn_bf16.cu (wgmma and TMA), by the name
# in their symbol: the forward and the one-launch backward
SLAB_BF16_KERNELS = ("slab_fwd_wgmma_kernel", "slab_bwd_wgmma_kernel")
SLAB_BF16_WANT = {"slab_attention_fwd": 0, "slab_attention_bwd": 0,
                  "slab_attention_fwd_bf16": 1, "slab_attention_bwd_bf16": 1}
# phase 15 (a)'s shapes: phase 6's, then two key chunks past 160 keys and
# the longest L (tests/test_torch_gpu.py's SLAB_BF16_CASES)
SLAB_BF16_CASES = SLAB_CASES + [(2, 200, 128, 2), (1, 256, 128, 2)]


def check_bf16_tensor_cores(path, report: str,
                            kernels=SLAB_BF16_KERNELS) -> None:
    """Phase 2: Hopper's bf16 warpgroup MMAs (HGMMA.*.F32.BF16) in the
    SASS of every instance of `kernels` (the bf16 slab kernels, dh 32 and
    64), and no mma.sync (HMMA.16816) in them; raises where one of them
    has no instance, or an instance has no HGMMA or has an HMMA.16816.
    Logs the counts and ptxas' wgmma remarks on them (a serialised wgmma
    pipeline). Logs and returns where the toolkit has no cuobjdump."""
    def kernel_of(line):
        return next((k for k in kernels if k in line), None)

    hgmma = sass_counts(path, kernel_of, HGMMA_BF16)
    if hgmma is None:
        log("sass: no cuobjdump; the bf16 slab wgmma check is not made")
        return
    hmma = sass_counts(path, kernel_of, "HMMA.16816")
    log("sass: HGMMA.*.F32.BF16 / HMMA.16816 per bf16 slab kernel: " +
        "; ".join(f"{k} {n} / {hmma[k]}" for k, n in sorted(hgmma.items())))
    remarks = [line.strip() for line in report.splitlines()
               if re.search(r"\(C75\d\d\)", line)
               and any(k in line for k in kernels)]
    log("ptxas wgmma remarks on the bf16 slab kernels: "
        + (" | ".join(remarks) or "none"))
    bad = [k for k, n in hgmma.items() if n == 0 or hmma[k]]
    bad += [k for k in kernels if not any(n.startswith(k) for n in hgmma)]
    if bad:
        raise RuntimeError(f"bf16 slab kernels without HGMMA, with mma.sync "
                           f"or missing: {bad}")


def graph_ms(fn, launches: int = 20, reps: int = 5, stream=None) -> float:
    """A call's device time without the host: `launches` calls of fn
    captured in one CUDA graph, replayed `reps` times between two CUDA
    events, the mean a call. `stream`: the stream to capture on (an
    autograd backward runs on its forward's stream, so that forward must
    have run on the capturing stream); by default a new one."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * launches)


def check_slab_bf16(sa, dev, card: str) -> dict:
    """Phase 15 (a): the bf16 slab kernels against the plain version in
    float32 from the same bf16 inputs, with the bf16 plain version's own
    error beside it; reruns bit-identical; timed (CUDA events, and a
    CUDA graph's replay for the device time) beside the float32 kernels,
    the bf16 plain version and one F.scaled_dot_product_attention call in
    bf16 on q, k, v laid out as (B, H, L, dh) before it (the yardstick,
    cuDNN's kernels), with the profiler's device time of both."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    bf16 = torch.bfloat16
    results = {}
    for b, l, c, nh in SLAB_BF16_CASES:
        dh = c // nh
        qkv = torch.randn(b, l, 3 * c, generator=gen, device=dev).to(bf16)
        do = torch.randn(b, l, c, generator=gen, device=dev).to(bf16)
        got = sa.slab_attention_fwd_bf16(qkv, nh)
        dgot = sa.slab_attention_bwd_bf16(qkv, do, nh)
        torch.cuda.synchronize()
        q32, do32 = qkv.float(), do.float()
        pairs = (("slab_attention_fwd_bf16", got,
                  sa.reference_slab_attention(q32, nh),
                  sa.reference_slab_attention(qkv, nh)),
                 ("slab_attention_bwd_bf16", dgot,
                  sa.reference_slab_attention_backward(q32, do32, nh),
                  sa.reference_slab_attention_backward(qkv, do, nh)))
        for name, g, want, plain in pairs:
            if g.dtype != bf16 or not torch.isfinite(g.float()).all():
                raise RuntimeError(f"{name} B={b} L={l}: not finite bf16")
            err = float((g.float() - want).abs().max())
            err_plain = float((plain.float() - want).abs().max())
            scale = float(want.abs().max())
            tol = max(2 * err_plain, 8e-3 * max(1.0, scale))
            log(f"{name} B={b} L={l} C={c} H={nh}: max_abs_err={err:.3e} "
                f"against the float32 plain version, the bf16 plain "
                f"version's own {err_plain:.3e}; max|plain|={scale:.4f} "
                f"tol={tol:.3e}")
            if not err <= tol:
                raise RuntimeError(f"{name} B={b} L={l}: error {err} > "
                                   f"{tol}")
            entry = results.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        same = [torch.equal(sa.slab_attention_fwd_bf16(qkv, nh), got),
                torch.equal(sa.slab_attention_bwd_bf16(qkv, do, nh), dgot)]
        log(f"slab bf16 B={b} L={l} C={c} H={nh}: reruns bit-identical "
            f"(out, dqkv) {same}")
        if not all(same):
            raise RuntimeError(f"slab bf16 B={b} L={l}: reruns differ")
        if (b, l, c, nh) != SLAB_CASES[0]:
            continue

        def backward_of(fn, z0, g0):
            z = z0.detach().requires_grad_(True)
            out = fn(z)
            return lambda: torch.autograd.grad(out, z, g0,
                                               retain_graph=True)

        # the yardstick: q, k, v and dO laid out as contiguous (B, H, L,
        # dh) before the timed call, so that one SDPA call is timed
        q, k, v, dob = (z.reshape(b, l, nh, dh).transpose(1, 2).contiguous()
                        for z in (*qkv.split(c, dim=-1), do))
        qg, kg, vg = (z.detach().requires_grad_(True) for z in (q, k, v))
        lib_stream = torch.cuda.Stream(device=dev)  # the backward's
        lib_stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(lib_stream):
            out_g = F.scaled_dot_product_attention(qg, kg, vg)
        torch.cuda.current_stream(dev).wait_stream(lib_stream)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(q, k, v)

        def sdpa_bwd():
            return torch.autograd.grad(out_g, (qg, kg, vg), dob,
                                       retain_graph=True)

        def kern_fwd():
            return sa.slab_attention_fwd_bf16(qkv, nh)

        def kern_bwd():
            return sa.slab_attention_bwd_bf16(qkv, do, nh)

        with torch.no_grad():
            fwd_ms = time_ms(kern_fwd)
            fwd_f32 = time_ms(lambda: sa.slab_attention_fwd(q32, nh))
            fwd_plain = time_ms(lambda: sa.reference_slab_attention(qkv,
                                                                    nh))
            fwd_lib = time_ms(sdpa_fwd)
        bwd_ms = time_ms(kern_bwd)
        bwd_f32 = time_ms(lambda: sa.slab_attention_bwd(q32, do32, nh))
        bwd_plain = time_ms(backward_of(
            lambda z: sa.reference_slab_attention(z, nh), qkv, do))
        bwd_lib = time_ms(sdpa_bwd)
        # device time without the host: CUDA graphs of 20 calls (the
        # wrappers' launches in them are not main-path launches)
        counts = dict(sa.launches_bf16)
        graph = {"fwd": graph_ms(kern_fwd), "bwd": graph_ms(kern_bwd)}
        sa.launches_bf16.update(counts)
        for key, fn, st in (("fwd_lib", sdpa_fwd, None),
                            ("bwd_lib", sdpa_bwd, lib_stream)):
            try:
                graph[key] = graph_ms(fn, stream=st)
            except RuntimeError as exc:     # a yardstick, not a check
                log(f"SDPA {key}: no CUDA-graph time ({exc})")
                graph[key] = None
        prod = b * nh * l * l * dh
        io = {"fwd": 2 * (b * l * 3 * c + b * l * c),
              "bwd": 2 * (2 * b * l * 3 * c + b * l * c)}
        for name, key, flops, nbytes, ms, f32_ms, plain_ms, lib_ms in (
                ("slab_attention_fwd_bf16", "fwd", 4 * prod, io["fwd"],
                 fwd_ms, fwd_f32, fwd_plain, fwd_lib),
                ("slab_attention_bwd_bf16", "bwd", 10 * prod, io["bwd"],
                 bwd_ms, bwd_f32, bwd_plain, bwd_lib)):
            bd = bound(flops, nbytes, tc_rate=PEAK_BF16_FLOPS)
            dev_ms, lib_dev = graph[key], graph[key + "_lib"]
            results[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 fp32_kernel_ms=f32_ms, graph_ms=dev_ms,
                                 library_graph_ms=lib_dev, **bd,
                                 shape=f"B={b} L={l} C={c} H={nh}")
            lib_text = "not measured" if lib_dev is None else \
                f"{lib_dev:.4f} ms"
            log(f"{name} B={b} L={l} C={c} H={nh}: kernel {ms:.4f} ms "
                f"(graph replay {dev_ms:.4f}), the float32 kernel(s) "
                f"{f32_ms:.4f} ms, bf16 plain {plain_ms:.4f} ms, one SDPA "
                f"call on laid-out operands {lib_ms:.4f} ms (graph replay "
                f"{lib_text}), bound {bd['bound_ms']:.4f} ms "
                f"({bd['bound_by']}: {flops:.3e} flops at 989 TFLOP/s, "
                f"{nbytes:.3e} bytes), {100 * bd['bound_ms'] / ms:.1f} % of "
                f"the bound by events, {100 * bd['bound_ms'] / dev_ms:.1f} % "
                f"by the graph, achieved {flops / dev_ms / 1e9:.2f} TFLOP/s, "
                f"{nbytes / dev_ms / 1e6:.1f} GB/s; {card}")
        log("slab bf16 forward's kernel, profiler device time a call: "
            + kernel_names(kern_fwd))
        log("slab bf16 backward's kernel, profiler device time a call: "
            + kernel_names(kern_bwd))
        log("SDPA bf16 forward on laid-out operands (profiler kernel "
            "names, device time): " + kernel_names(sdpa_fwd))
        log("SDPA bf16 backward on laid-out operands: "
            + kernel_names(sdpa_bwd))
        log(f"bf16 kernels' launch plan at L={l}, dh={dh}: "
            f"{sa.bf16_plan(l, dh)}; {sa.BF16_WARPGROUPS} warpgroups a "
            f"block, one block an SM")
    return results


def bf16_cfg(configs):
    """Phase 15's configuration: V5E8_DP in its own dtype (bfloat16
    compute, float32 params) on one card."""
    return dataclasses.replace(configs.V5E8_DP, mesh=configs.MeshConfig())


def _leaf_spread(a: dict, b: dict) -> dict:
    return {n: float((a[n] - b[n]).abs().max()) for n in a}


def check_bf16_training(sa, dev, card) -> dict:
    """Phase 15 (b): TRAIN_STEPS b256 steps of the bf16 model on the bf16
    slab kernels against the same steps with use_pallas off (the plain
    bf16 slab), phase 7's gates with the tolerance set by the spread of
    two plain paths: plain against plain (run to run), and plain against
    the plain slab computed in float32 from the same bf16 slab (where
    bf16 rounds: a second computation of the same bf16 model). A leaf's
    gradient gate is at least two bf16 ulps of its largest value: a bf16
    layer's weight gradient comes out of a bf16 product."""
    from ertdx_torch import configs
    from ertdx_torch.models import build_model
    from ertdx_torch.models import condunet as condunet_mod
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax

    cfg = bf16_cfg(configs)
    mcfg, tcfg = cfg.model, cfg.train
    kernel = build_model(mcfg, dev, generator=torch.Generator()
                         .manual_seed(SEED + 150))
    params_from_jax(kernel, random_flax_tree(
        flax_shapes(kernel), np.random.default_rng(SEED + 151)))
    attn = kernel.encoder.attn
    log(f"bf16 training config: {mcfg.name} dtype={mcfg.dtype} "
        f"(compute {kernel.compute_dtype}, params "
        f"{sorted({str(p.dtype) for p in kernel.parameters()})}) "
        f"D={mcfg.hidden_dim} base_width={mcfg.base_width} "
        f"depth={mcfg.depth} heads={mcfg.num_heads} blocks="
        f"{mcfg.num_blocks} attn_slab={attn.slab} use_pallas="
        f"{attn.use_pallas} batch={tcfg.batch_size} lr={tcfg.lr} "
        f"condition {mcfg.cond_length} x {mcfg.cond_channels}")
    if (kernel.compute_dtype != torch.bfloat16 or not attn.slab
            or not attn.use_pallas):
        raise RuntimeError("phase 15 must train the bf16 slab arm")
    plain = plain_attention(kernel)
    plain_slab = condunet_mod.reference_slab_attention
    patches = {"reference_slab_attention": lambda qkv, nh: plain_slab(
        qkv.float(), nh).to(qkv.dtype)}
    return compare_bf16_train_paths("bf16", cfg, kernel, plain,
                                    _AllCounts(sa), SLAB_BF16_WANT,
                                    SEED + 152, card, patches,
                                    "the float32 slab")


def compare_bf16_train_paths(label, cfg, kernel, plain, counts, want, seed,
                             card, patches, patched, steps=TRAIN_STEPS
                             ) -> dict:
    """`steps` b256 train steps of the bf16 `kernel` model against the
    same steps of `plain`, phase 7's gates with the tolerance set by the
    spread of two plain paths: plain against plain (run to run), and
    plain against a copy whose plain versions named in `patches` (the
    attributes of models/condunet.py they replace) compute in float32
    from the same bf16 inputs (`patched` says which: where bf16 rounds, a
    second computation of the same bf16 model). A leaf's gradient gate is
    at least two bf16 ulps of its largest value: a bf16 layer's weight
    gradient comes out of a bf16 product. Exactly `want` launches (by
    `counts`) a step; ms a step of both paths, peak memory and a profile
    of one step of each; returns the ms a step of both."""
    from ertdx_torch import train
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.models import condunet as condunet_mod

    mcfg, tcfg = cfg.model, cfg.train
    dev = next(kernel.parameters()).device
    plain2 = copy.deepcopy(plain)
    plain32 = copy.deepcopy(plain)
    alpha_bar = schedule_from_config(cfg.diffusion).alpha_bar.to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, p = tcfg.batch_size, mcfg.param_dim
    batches = [(torch.randn(b, p, generator=gen, device=dev),
                torch.rand(b, mcfg.cond_length, mcfg.cond_channels,
                           generator=gen, device=dev),
                torch.randint(0, cfg.diffusion.T, (b,), generator=gen,
                              device=dev),
                torch.randn(b, p, generator=gen, device=dev))
               for _ in range(steps)]
    lr = train.make_lr(tcfg, steps)

    def run(model, cnt=None):
        return _run_steps(train, model, train.create_optimizer(model, lr),
                          batches, alpha_bar, lr, cnt)

    pl, p_ms, _, pg = run(plain)
    pl2, _, _, pg2 = run(plain2)
    saved = {name: getattr(condunet_mod, name) for name in patches}
    for name, fn in patches.items():
        setattr(condunet_mod, name, fn)
    try:
        pl32, _, _, pg32 = run(plain32)
    finally:
        for name, fn in saved.items():
            setattr(condunet_mod, name, fn)
    spreads = {}
    for tag, other, og, om in (("run to run", pl2, pg2, plain2),
                               (patched, pl32, pg32, plain32)):
        d = _param_diffs(plain, om)
        spreads[tag] = {"loss": max(abs(a - c) for a, c in zip(pl, other)),
                        "grad": _leaf_spread(og, pg),
                        "share": float((d > 1e-5).float().mean())}
        log(f"{label} plain vs plain ({tag}): max|dloss|="
            f"{spreads[tag]['loss']:.3e} max|dgrad|="
            f"{max(spreads[tag]['grad'].values()):.3e} max|dparam|="
            f"{float(d.max()):.3e} share > 1e-5: {spreads[tag]['share']:.3e}")

    counts.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    kl, k_ms, per_step, kg = run(kernel, counts)
    peak = torch.cuda.max_memory_allocated()
    log(f"{label} kernel path: losses {kl}; launches per step {per_step}")
    for step, cnt in enumerate(per_step):
        if cnt != want:
            raise RuntimeError(f"{label} train step {step + 1}: launches "
                               f"{cnt}, expected {want}")
    rr, rf = spreads["run to run"], spreads[patched]
    loss_tol = max(1e-5, 10 * rr["loss"], 10 * rf["loss"])
    dloss = max(abs(a - c) for a, c in zip(kl, pl))
    for step, (a, c) in enumerate(zip(kl, pl)):
        if not abs(a - c) <= loss_tol * max(1.0, abs(c)):
            raise RuntimeError(f"{label} train step {step + 1}: loss {a} vs "
                               f"plain {c}, tolerance {loss_tol:.1e}")
    worst = 0.0
    for name, w in pg.items():
        err = float((kg[name] - w).abs().max())
        top = float(w.abs().max())
        # a bf16 layer's weight gradient is computed in bf16: two of its
        # ulps at the leaf's largest value are the finest gate it can meet
        ulp = 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -126))) - 7)
        tol = max(1e-4 * max(1.0, top), 2 * ulp, 10 * rr["grad"][name],
                  4 * rf["grad"][name])
        worst = max(worst, err / tol)
        if not err <= tol:
            raise RuntimeError(f"{label} step 1: gradient of {name} differs "
                               f"by {err:.3e} > {tol:.3e}")
    kp = _param_diffs(kernel, plain)
    k_share = float((kp > 1e-5).float().mean())
    share_limit = max(1e-3, 2 * rr["share"], 2 * rf["share"])
    flip_bound = 2 * tcfg.lr * steps
    log(f"{label} kernel vs plain: max|dloss|={dloss:.3e} (tol "
        f"{loss_tol:.1e} x max(1, loss)); step-1 gradients worst err/tol "
        f"{worst:.3f} (tol per leaf max(1e-4 x max(1, max|g|), 2 bf16 ulps "
        f"of max|g|, 10 x run to run, 4 x {patched}'s)); params after "
        f"{steps} steps max|d|="
        f"{float(kp.max()):.3e} (bound {flip_bound:.1e}), share > 1e-5 "
        f"{k_share:.3e} (limit {share_limit:.3e})")
    _log_param_gaps(f"{label} kernel vs plain", kernel, plain, kg, pg)
    if not (float(kp.max()) <= flip_bound + 1e-6 and k_share <= share_limit):
        raise RuntimeError(f"{label} kernel-path parameters disagree with "
                           "the plain path")

    for model, path in ((kernel, "kernel"), (plain, "plain")):
        x0, cond, t, noise = batches[0]
        opt = train.create_optimizer(model, lr)
        device_profile(lambda: train.train_step(model, opt, x0, cond, t,
                                                noise, alpha_bar=alpha_bar,
                                                lr=lr),
                       f"one {label} train step, {path} path")
    k_step = statistics.median(k_ms[1:] or k_ms)
    p_step = statistics.median(p_ms[1:] or p_ms)
    which = (f"median of steps 2-{steps}" if steps > 1 else
             "its one step, first-call set-up included")
    log(f"{label} ms per train step ({which}; {card}):"
        f" kernel path {k_step:.3f}, plain path {p_step:.3f}; peak memory "
        f"{peak / 2**20:.1f} MiB; step times kernel {k_ms} plain {p_ms}")
    return {"kernel_step_ms": k_step, "plain_step_ms": p_step,
            "batch": batches[0], "alpha_bar": alpha_bar, "lr": lr}


def slab_rule(steps: int, forwards: int) -> dict:
    """Phase 15's launches: one bf16 slab forward per forward (train or
    eval), one backward per step, no float32 slab launch."""
    return {"slab_attention_fwd": 0, "slab_attention_bwd": 0,
            "slab_attention_fwd_bf16": forwards,
            "slab_attention_bwd_bf16": steps}


def check_bf16_train_entry(sa, ckdir, dev, card, cfg=None, counts=None,
                           rule=slab_rule, label="bf16") -> dict:
    """Phase 15 (c) (and 16 (c) with its `cfg`, `counts` and launch
    `rule`): train() of the bf16 model for 2 epochs on 400 examples into
    `ckdir`: launches by the epoch grid, float32 params and Adam moments
    in the checkpoint and its echo of bfloat16, and load_best_model
    giving a bf16 model whose forward is the trained one's bit for bit.
    Returns the launches."""
    from ertdx_torch import configs, train
    from ertdx_torch.data import prepare_dataset
    from ertdx_torch.doe import SurrogateDataGenerator
    from ertdx_torch.utils import checkpoint as ckpt_lib

    cfg = bf16_cfg(configs) if cfg is None else cfg
    mcfg = cfg.model
    n = 400
    params_phys = SurrogateDataGenerator(
        seed=SEED + 3).generate_training_samples(n, "lhs")
    ert = np.random.default_rng(SEED + 153).normal(
        50.0, 10.0, size=(n, mcfg.cond_length, mcfg.cond_channels))
    ds = prepare_dataset(params_phys[..., None], ert)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=2, step_checkpoint_every=1,
        checkpoint_dir=ckdir))
    counts = _AllCounts(sa) if counts is None else counts
    counts.reset_launches()
    t0 = time.perf_counter()
    res = train.train(cfg, ds, device=dev, logger=lambda d: log(
        f"train(): {d}"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = counts.launches
    steps = res.state.step
    val_batches = -(-int(0.1 * n) // cfg.train.batch_size)
    want = rule(steps, steps + 2 * val_batches)
    log(f"train() {label}: 2 epochs, {steps} steps in {seconds:.3f} s "
        f"({res.steps_per_sec:.3f} steps/s; {card}), val {res.val_history};"
        f" rule ({' '.join(rule.__doc__.split()).split(': ')[1]}) -> {want};"
        f" counted "
        f"{got}")
    if steps != 2 * -(-int(0.8 * n) // cfg.train.batch_size) or got != want:
        raise RuntimeError(f"train() {label}: launches differ from the rule")
    if not np.isfinite(res.train_history + res.val_history).all():
        raise RuntimeError(f"train() {label}: non-finite loss")

    def float_leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in float_leaves(v)]
        a = np.asarray(tree)
        return [a.dtype] if np.issubdtype(a.dtype, np.floating) else []

    tree, meta, _ = ckpt_lib.restore_checkpoint(os.path.join(ckdir, "best"))
    dtypes = {str(d) for key in ("params", "opt_state")
              for d in float_leaves(tree[key])}
    echo = meta["config"]["model"]["dtype"]
    log(f"bf16 checkpoint: float leaves of params and opt_state {dtypes}, "
        f"config echo dtype {echo!r}")
    if dtypes != {"float32"} or echo != "bfloat16":
        raise RuntimeError("bf16 checkpoint: params or moments not float32, "
                           "or the echo is not bfloat16")
    # load_best_model on the last checkpoint (the trained state) as best
    tmp = tempfile.mkdtemp(prefix="ertdx_torch_bf16_last_")
    try:
        shutil.copytree(os.path.join(ckdir, "last"),
                        os.path.join(tmp, "best"))
        last, _, _ = train.load_best_model(tmp, cfg, device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    best, bmeta, _ = train.load_best_model(ckdir, cfg, device=dev)
    x = torch.from_numpy(ds.params_u[:8]).to(dev)
    cond = torch.from_numpy(ds.conditions[:8]).to(dev)
    t = torch.arange(8, device=dev) * 60
    with torch.no_grad():
        trained = res.state.model(x, t, cond)
        from_last = last.model(x, t, cond)
        from_best = best.model(x, t, cond)
    same = torch.equal(trained, from_last)
    log(f"load_best_model: compute {last.model.compute_dtype}, forward of "
        f"the trained state bit for bit {same}; best (epoch "
        f"{bmeta['epoch']}) max|d| vs the final model "
        f"{float((from_best - trained).abs().max()):.3e}")
    if not (same and last.model.compute_dtype == torch.bfloat16
            and best.model.compute_dtype == torch.bfloat16
            and torch.isfinite(from_best).all()):
        raise RuntimeError("bf16 checkpoint read back differs")
    return got


def check_bf16_serving(sa, cb, ckdir, dev, card, fp32_step_ms) -> None:
    """Phase 15 (d): a configs[3] posterior ensemble (DDIM-50, 8
    conditions x 1000 members, on the fused core) from phase 15's bf16
    checkpoint: 50 fused_core_stack launches and one bf16 slab forward,
    draws against the same run with the encoder's slab kernel off, within
    the JAX package's bf16 band (rtol = atol = 5e-2)."""
    from ertdx_torch import configs, sample, train
    from ertdx_torch.diffusion import schedule_from_config

    cfg = bf16_cfg(configs)
    state, _, _ = train.load_best_model(ckdir, cfg, device=dev)
    model = state.model.eval()
    plain = plain_attention(model)
    scfg = configs.DDIM_ENSEMBLE.sample
    schedule = schedule_from_config(cfg.diffusion)
    n_cond, n_real = 8, scfg.uncertainty_samples
    gen = torch.Generator(device=dev).manual_seed(SEED + 154)
    cond = torch.rand(n_cond, cfg.model.cond_length, cfg.model.cond_channels,
                      generator=gen, device=dev)
    x_T = torch.randn(n_cond * n_real, cfg.model.param_dim, generator=gen,
                      device=dev)
    counts = _AllCounts(sa)
    with torch.no_grad():           # first bf16 encoder call: set-up
        model.encode_condition(cond[:1])
    counts.reset_launches()
    cb.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = sample.posterior_ensemble(model, cond, schedule, n_real, scfg,
                                  x_T=x_T, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    got = {**counts.launches, **cb.launches}
    t0 = time.perf_counter()
    u_plain = sample.posterior_ensemble(plain, cond, schedule, n_real, scfg,
                                        x_T=x_T, device=dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    du = (u - u_plain).abs()
    excess = float((du - 5e-2 * u_plain.abs()).max())
    dmean = float((u.mean(0) - u_plain.mean(0)).abs().max())
    dstd = float((u.std(0) - u_plain.std(0)).abs().max())
    steps = scfg.ddim_steps
    log(f"bf16 ensemble ({n_cond} x {n_real}, DDIM-{steps}): {run_s:.3f} s "
        f"kernel path ({run_s / steps * 1e3:.3f} ms per DDIM step; phase 4's"
        f" float32 model {fp32_step_ms:.3f}), {plain_s:.3f} s with the slab "
        f"kernel off ({card}); launches {got}; u {u.dtype}; max|du|="
        f"{float(du.max()):.3e} max(|du| - 5e-2 |u_plain|)={excess:.3e} "
        f"(gate 5e-2) max|dmean|={dmean:.3e} max|dstd|={dstd:.3e} max|u|="
        f"{float(u_plain.abs().max()):.4f}")
    want = {"slab_attention_fwd": 0, "slab_attention_bwd": 0,
            "slab_attention_fwd_bf16": 1, "slab_attention_bwd_bf16": 0,
            "fused_core_stack": steps, "fused_core_block": 0}
    if got != want:
        raise RuntimeError(f"bf16 ensemble: launches {got}, expected {want}")
    if not (u.dtype == torch.float32 and torch.isfinite(u).all()
            and excess <= 5e-2):
        raise RuntimeError("bf16 ensemble disagrees with the plain path")


# ---------------------------------------------------------------------------
# 16. bfloat16: V5E8_DP's fused-encoder arm in its own dtype
# ---------------------------------------------------------------------------

# the bf16 GN and fused-conv kernels, by the part of their symbol that
# names them: the conv's GEMMs (bf16 MMAs) and every bf16 instantiation
# of the GN kernels (units of 8 values or one; staged and streamed)
CONV_BF16_KERNELS = ("tap3_wgmma_kernel", "conv_dw_wgmma_kernel")
# the bf16 fused conv's three GEMMs on Hopper's wgmma, by the SASS name and
# template arguments of their instances: the forward (GN, not WT), dh (WT)
# and dW
WGMMA_GEMMS = {"forward": "tap3_wgmma_kernel<1,0,", "dh":
               "tap3_wgmma_kernel<0,1,", "dW": "conv_dw_wgmma_kernel"}
HGMMA_BF16 = re.compile(r"HGMMA\.\S*\.F32\.BF16")


def check_wgmma(path, report: str) -> None:
    """Phase 2: Hopper's bf16 warpgroup MMAs (HGMMA.*.F32.BF16) in the
    SASS of every instance of the bf16 fused conv's three GEMMs, and no
    mma.sync (HMMA.16816) in them; raises where one of the three has no
    instance, an instance has no HGMMA or has an HMMA.16816. Logs the
    counts and ptxas' wgmma remarks (a serialised wgmma pipeline). Logs
    and returns where the toolkit has no cuobjdump."""
    def kernel_of(line):
        return next((k for k in CONV_BF16_KERNELS if k in line), None)

    hgmma = sass_counts(path, kernel_of, HGMMA_BF16)
    if hgmma is None:
        log("sass: no cuobjdump; the wgmma check is not made")
        return
    hmma = sass_counts(path, kernel_of, "HMMA.16816")
    log("sass: HGMMA.*.F32.BF16 / HMMA.16816 per bf16 conv GEMM: " +
        "; ".join(f"{k} {n} / {hmma[k]}" for k, n in sorted(hgmma.items())))
    remarks = [line.strip() for line in report.splitlines()
               if "wgmma" in line.lower() and "ptxas" in line.lower()]
    log("ptxas wgmma remarks: " + (" | ".join(remarks) or "none"))
    bad = [k for k, n in hgmma.items() if n == 0 or hmma[k]]
    bad += [name for name, key in WGMMA_GEMMS.items()
            if not any(k.startswith(key) for k in hgmma)]
    if bad:
        raise RuntimeError(f"bf16 conv GEMMs without HGMMA, with mma.sync or "
                           f"missing: {bad}")
GN_BF16_KERNELS = tuple(
    f"gn_{k}_staged_kernelILi{w}E13__nv_bfloat16"
    for k in ("fwd", "bwd", "stats") for w in (8, 1)) + tuple(
    f"gn_{k}_stream_kernelI13__nv_bfloat16" for k in ("fwd", "bwd", "stats"))
# (B, L, C, mean of x) and (B, L, C, Cout) as phase 10's, in bf16: the
# fused arm's shapes first (the first of each is the kernels line's)
GN_BF16_CASES = [(256, 587, 128, 0.5), (256, 294, 256, 0.5),
                 (2, 4693, 128, 0.5), (4, 587, 128, 1000.0),
                 (3, 61, 72, 0.5)]
CONV_BF16_CASES = [(256, 294, 256, 256), (256, 147, 256, 256),
                   (256, 587, 128, 128), (256, 294, 128, 256),
                   (3, 61, 64, 72)]
FUSED_BF16_WANT = {"groupnorm_silu_fwd": 0, "groupnorm_silu_bwd": 0,
                   "gn_silu_conv3_fwd": 0, "gn_silu_conv3_bwd": 0,
                   "slab_attention_fwd": 0, "slab_attention_bwd": 0,
                   "groupnorm_silu_fwd_bf16": 2, "groupnorm_silu_bwd_bf16": 2,
                   "gn_silu_conv3_fwd_bf16": 6, "gn_silu_conv3_bwd_bf16": 6,
                   "slab_attention_fwd_bf16": 1, "slab_attention_bwd_bf16": 1}


def bf16_fused_cfg(configs):
    """Phase 16's configuration: V5E8_DP in its own dtype (phase 15's)
    with the fused-encoder arm of phase 11 (pallas_gn,
    pallas_conv_min_width=256), the JAX package's bf16 `slab_fconv` arm
    (benchmarks/train_stack.py:35-42) with the GN kernels on as well."""
    cfg = bf16_cfg(configs)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, pallas_gn=True, pallas_conv_min_width=256))


def fused_bf16_rule(steps: int, forwards: int) -> dict:
    """Phase 16's launches: per forward (train or eval) 2 bf16 GN, 6 bf16
    fused-conv and one bf16 slab forward, per step their backwards, no
    float32 GN, conv or slab launch."""
    return {k: n * (forwards if k.endswith("fwd_bf16") else steps)
            for k, n in FUSED_BF16_WANT.items()}


def check_gn_conv_bf16(gn, cv, dev, card: str) -> dict:
    """Phase 16 (a): the bf16 GN and fused-conv kernels, forward and
    backward, at phase 10's shapes in bf16, each output (y, dx, dgamma,
    dbeta, dW, db) against the plain version computed in float32 from the
    same bf16 inputs within max(2 x the bf16 plain version's own error,
    8e-3 x max(1, max|plain|)) (phase 15 (a)'s rule), reruns
    bit-identical, each case's launch plan; timed at B = 256 (CUDA events
    and profiler device time) beside the float32 kernels on the same
    values, the bf16 plain version and the bf16 library composition
    (F.group_norm + F.silu, + F.conv1d; a yardstick only), with GB/s and
    the share of the bound at 2 bytes a bf16 value and 989 TFLOP/s."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 160)
    bf16, eps = torch.bfloat16, 1e-5

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    def lib_gn(x, gamma, beta):        # (B, C, L) view in and out
        return F.silu(F.group_norm(x.transpose(1, 2), GROUPS, gamma, beta,
                                   eps))

    def grad_of(fn, ins, g):
        leaves = [t.detach().requires_grad_(t.is_floating_point())
                  for t in ins]
        out = fn(*leaves)
        return lambda: torch.autograd.grad(out, leaves, g,
                                           retain_graph=True)

    results = {}
    cases = ([("gn", c) for c in GN_BF16_CASES]
             + [("conv", c) for c in CONV_BF16_CASES])
    for kind, case in cases:
        if kind == "gn":
            b, l, c, mean = case
            x = rnd(b, l, c, scale=2.0 if mean < 100 else 1.0,
                    shift=mean).to(bf16)
            ins = (x, rnd(c, scale=0.3, shift=1.0), rnd(c, scale=0.3))
            dy = rnd(b, l, c).to(bf16)
            names = ("groupnorm_silu_fwd_bf16", "groupnorm_silu_bwd_bf16")
            fwd = lambda: gn.groupnorm_silu_fwd(*ins, GROUPS)
            bwd = lambda: gn.groupnorm_silu_bwd(*ins, dy, GROUPS)
            plain = lambda *a: gn.reference_groupnorm_silu(*a, GROUPS)
            f32_ins, dy32 = (x.float(),) + ins[1:], dy.float()
            f32 = (lambda: gn.groupnorm_silu_fwd(*f32_ins, GROUPS),
                   lambda: gn.groupnorm_silu_bwd(*f32_ins, dy32, GROUPS))
            lib = lambda xx, ga, be: lib_gn(xx, ga.to(xx.dtype),
                                            be.to(xx.dtype)).transpose(1, 2)
            grads = ("dx", "dgamma", "dbeta")
            n = b * l * c
            # bytes: x (and dy) read once, y (dx) written once, 2 a bf16
            # value; gamma and beta (and their gradients) float32
            work = {names[0]: (10 * n, 2 * 2 * n + 4 * 2 * c),
                    names[1]: (30 * n, 2 * 3 * n + 4 * 4 * c)}
            shape = f"B={b} L={l} C={c} bf16" + (
                f" mean {mean:g}" if mean >= 100 else "")
            plans = {name: gn.launch_plan(l, c, GROUPS, k, 2)
                     for name, k in zip(names, ("fwd", "bwd"))}
        else:
            b, l, c, cout = case
            x = rnd(b, l, c).to(bf16)
            ins = (x, rnd(c, scale=0.3, shift=1.0), rnd(c, scale=0.3),
                   rnd(3, c, cout, scale=1.0 / math.sqrt(3 * c)),
                   rnd(cout, scale=0.3))
            dy = rnd(b, l, cout).to(bf16)
            names = ("gn_silu_conv3_fwd_bf16", "gn_silu_conv3_bwd_bf16")
            fwd = lambda: cv.gn_silu_conv3_fwd(*ins, GROUPS)
            bwd = lambda: cv.gn_silu_conv3_bwd(*ins[:4], dy, GROUPS)
            plain = lambda *a: cv.reference_gn_silu_conv3(*a, GROUPS)
            f32_ins, dy32 = (x.float(),) + ins[1:], dy.float()
            f32 = (lambda: cv.gn_silu_conv3_fwd(*f32_ins, GROUPS),
                   lambda: cv.gn_silu_conv3_bwd(*f32_ins[:4], dy32, GROUPS))
            # explicit pad and contiguous weight (phase 10)
            lib = lambda xx, ga, be, ww, bb: F.conv1d(
                F.pad(lib_gn(xx, ga.to(xx.dtype), be.to(xx.dtype)), (1, 1)),
                ww.permute(2, 1, 0).contiguous().to(xx.dtype),
                bb.to(xx.dtype)).transpose(1, 2)
            grads = ("dx", "dgamma", "dbeta", "dW", "db")
            prod = 2 * b * l * 3 * c * cout
            nx, ny, nw = b * l * c, b * l * cout, 3 * c * cout
            work = {names[0]: (prod, 2 * (nx + ny) + 4 * (2 * c + nw + cout)),
                    names[1]: (2 * prod, 2 * (nx + ny + nx)
                               + 4 * (2 * c + nw + 2 * c + nw + cout))}
            shape = f"B={b} L={l} C={c} Cout={cout} bf16"
            plans = {"gn_silu_conv3 statistics":
                     gn.launch_plan(l, c, GROUPS, "stats", 2),
                     "gn_silu_conv3 GN backward":
                     gn.launch_plan(l, c, GROUPS, "bwd", 2, 4)}
        log(f"{shape}: launch plans " + "; ".join(
            f"{name} {p.path} ({p.threads} threads, {p.smem_bytes} bytes "
            "of shared memory)" for name, p in plans.items()))
        got = fwd()
        dgot = bwd()
        again, dagain = fwd(), bwd()
        torch.cuda.synchronize()
        if not (torch.equal(got, again) and all(
                torch.equal(a, w) for a, w in zip(dgot, dagain))):
            raise RuntimeError(f"{names[0]} {shape}: a rerun differs")
        want = plain(*f32_ins)
        dwant = grad_of(plain, f32_ins, dy32)()
        own = plain(*ins)
        down = grad_of(plain, ins, dy)()
        torch.cuda.synchronize()
        checks = [(names[0], "y", got, want, own)] + [
            (names[1], g, a, w, o)
            for g, a, w, o in zip(grads, dgot, dwant, down)]
        for name, out, a, w, o in checks:
            dtype = bf16 if out in ("y", "dx") else torch.float32
            if (a.shape != w.shape or a.dtype != dtype
                    or not torch.isfinite(a.float()).all()):
                raise RuntimeError(f"{name} {shape} {out}: wrong shape, "
                                   f"dtype {a.dtype} or non-finite")
            err = float((a.float() - w).abs().max())
            err_plain = float((o.float() - w).abs().max())
            scale = float(w.abs().max())
            tol = max(2 * err_plain, 8e-3 * max(1.0, scale))
            log(f"{name} {shape} {out}: max_abs_err={err:.3e} against the "
                f"float32 plain version, the bf16 plain version's own "
                f"{err_plain:.3e}; max|plain|={scale:.4f} tol={tol:.3e}")
            if not err <= tol:
                raise RuntimeError(f"{name} {shape} {out}: error {err} > "
                                   f"{tol}")
            entry = results.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if b < 256:
            if kind == "gn":            # the kernels alone, for GB/s
                for name, kernel in zip(names, (fwd, bwd)):
                    with torch.no_grad():
                        ms = time_ms(kernel)
                    flops, nbytes = work[name]
                    bd = bound(flops, nbytes, products=False)
                    log(f"{name} {shape} ({plans[name].path}): kernel "
                        f"{ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s, "
                        f"bound {bd['bound_ms']:.4f} ms, "
                        f"{100 * bd['bound_ms'] / ms:.1f} % of the bound; "
                        f"{card}")
            continue
        timed = {names[0]: (fwd, f32[0], lambda: plain(*ins),
                            lambda: lib(*ins)),
                 names[1]: (bwd, f32[1], grad_of(plain, ins, dy),
                            grad_of(lib, ins, dy))}
        for name, (kernel, f32_fn, plain_fn, lib_fn) in timed.items():
            with torch.no_grad() if name == names[0] else \
                    torch.enable_grad():
                ms = time_ms(kernel)
                f32_ms = time_ms(f32_fn)
                plain_ms = time_ms(plain_fn)
                lib_ms = time_ms(lib_fn)
                records, _ = kernel_records(
                    lambda: [kernel() for _ in range(10)])
            dev_ms = sum(e.time_range.elapsed_us() for e in records) / 10e3
            flops, nbytes = work[name]
            bd = bound(flops, nbytes, products=kind == "conv",
                       tc_rate=PEAK_BF16_FLOPS)
            path = f" ({plans[name].path})" if name in plans else ""
            log(f"{name} {shape}{path}: kernel {ms:.4f} ms (profiler device "
                f"{dev_ms:.4f} ms), the float32 kernel(s) {f32_ms:.4f} ms, "
                f"bf16 plain {plain_ms:.4f} ms, bf16 library composition "
                f"{lib_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
                f"({bd['bound_by']}: {flops:.3e} flops at 989 TFLOP/s, "
                f"{nbytes:.3e} bytes at 2 a bf16 value), "
                f"{100 * bd['bound_ms'] / ms:.1f} % of the bound, achieved "
                f"{flops / ms / 1e9:.2f} TFLOP/s, "
                f"{nbytes / ms / 1e6:.1f} GB/s; {card}")
            if name == "gn_silu_conv3_bwd_bf16":
                log(f"{name} {shape}, launch by launch: "
                    + launch_times(kernel))
            entry = results[name]
            if "ms" not in entry:       # the first large case: the path's
                entry.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                             composition_ms=lib_ms, fp32_kernel_ms=f32_ms,
                             device_ms=dev_ms, **bd, shape=shape,
                             **({"tflops": flops / ms / 1e9}
                                if kind == "conv" else {}))
    return results


def float32_elementwise_ops(fn, label: str, top: int = 12) -> None:
    """Which ops launch fn's float32 elementwise kernels: torch.profiler's
    kernels (the elementwise group of KERNEL_GROUPS, float32 by their
    template arguments) summed by the op that launched them, with its
    parent op (an autograd node names the forward op it differentiates)
    and its input shapes; logged beside the elementwise kernels in other
    dtypes and fn's device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    keys = dict(KERNEL_GROUPS)["elementwise"]
    rows, by_dtype, total = {}, {}, 0.0
    for e in prof.events():
        for k in getattr(e, "kernels", []) or []:
            us = float(k.duration)
            total += us
            low = k.name.lower()
            if not any(w in low for w in keys):
                continue
            dtype = ("bf16" if "bfloat16" in low else "float32"
                     if re.search(r"\bfloat\b", k.name) else "other")
            by_dtype[dtype] = by_dtype.get(dtype, 0.0) + us
            if dtype != "float32":
                continue
            parent = e.cpu_parent.name if e.cpu_parent is not None else "-"
            shapes = [tuple(sh) for sh in (e.input_shapes or [])[:2] if sh]
            key = f"{e.name} <- {parent} {shapes}"
            us0, n0 = rows.get(key, (0.0, 0))
            rows[key] = (us0 + us, n0 + 1)
    if not total:
        ops = sorted(prof.key_averages(), key=lambda a: -getattr(
            a, "self_device_time_total", 0.0))[:top]
        log(f"float32 elementwise ops of {label}: the profiler attributed "
            "no kernel to an op, so their dtypes are not measured; the ops "
            "by their own device time: " + "; ".join(
                "%s %.3f ms" % (a.key, getattr(a, "self_device_time_total",
                                               0.0) / 1e3) for a in ops))
        return
    log(f"float32 elementwise ops of {label}: elementwise kernels by dtype "
        + ", ".join(f"{d} {us / 1e3:.3f} ms" for d, us in by_dtype.items())
        + f" of {total / 1e3:.3f} ms of attributed device time; the "
        "float32 ones by launching op (op <- parent [input shapes]):")
    for key, (us, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {us / 1e3:8.3f} ms {n:4d} launches  {key[:150]}")


def check_bf16_fused_training(counts, dev, card) -> dict:
    """Phase 16 (b): TRAIN_STEPS b256 steps of the bf16 fused-encoder
    arm on the bf16 GN, fused-conv and slab kernels against the same
    steps with every kernel off, under phase 15 (b)'s gates (the second
    plain path computes the plain slab and fused conv in float32 from
    the same bf16 inputs), exactly FUSED_BF16_WANT launches a step; the
    ops that launch the float32 elementwise kernels of a step of each
    path."""
    from ertdx_torch import configs, train
    from ertdx_torch.models import build_model
    from ertdx_torch.models import condunet as condunet_mod
    from ertdx_torch.models.condunet import FusedGNConv, GNSiLU
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax

    cfg = bf16_fused_cfg(configs)
    mcfg, tcfg = cfg.model, cfg.train
    kernel = build_model(mcfg, dev, generator=torch.Generator()
                         .manual_seed(SEED + 161))
    params_from_jax(kernel, random_flax_tree(
        flax_shapes(kernel), np.random.default_rng(SEED + 162)))
    fused = [m for m in kernel.modules() if isinstance(m, FusedGNConv)]
    gns = [m for m in kernel.modules() if isinstance(m, GNSiLU)]
    log(f"bf16 fused-encoder arm: dtype={mcfg.dtype} (compute "
        f"{kernel.compute_dtype}, params "
        f"{sorted({str(p.dtype) for p in kernel.parameters()})}) "
        f"pallas_gn={mcfg.pallas_gn} pallas_conv_min_width="
        f"{mcfg.pallas_conv_min_width}: {len(fused)} FusedGNConv "
        f"({sorted({tuple(m.kernel.shape[1:]) for m in fused})}), "
        f"{len(gns)} GNSiLU, attn_slab={mcfg.attn_slab}, batch "
        f"{tcfg.batch_size}, condition {mcfg.cond_length} x "
        f"{mcfg.cond_channels}")
    if (kernel.compute_dtype != torch.bfloat16 or len(fused) != 6
            or len(gns) != 2 or not all(m.use_pallas for m in gns)):
        raise RuntimeError("phase 16 must train the bf16 fused arm: 6 "
                           "fused convs and 2 GN pairs in bf16")
    plain = copy.deepcopy(kernel)
    for mod in plain.modules():     # the plain GN, fused conv and slab
        if hasattr(mod, "use_pallas"):
            mod.use_pallas = False
    plain_slab = condunet_mod.reference_slab_attention
    plain_conv = condunet_mod.reference_gn_silu_conv3
    patches = {"reference_slab_attention": lambda qkv, nh: plain_slab(
                   qkv.float(), nh).to(qkv.dtype),
               "reference_gn_silu_conv3": lambda x, *a: plain_conv(
                   x.float(), *a).to(x.dtype)}
    res = compare_bf16_train_paths(
        "bf16 fused arm", cfg, kernel, plain, counts, FUSED_BF16_WANT,
        SEED + 163, card, patches, "the float32 plain slab and fused conv")
    x0, cond, t, noise = res.pop("batch")
    alpha_bar, lr = res.pop("alpha_bar"), res.pop("lr")
    for model, path in ((kernel, "kernel"), (plain, "plain")):
        opt = train.create_optimizer(model, lr)
        float32_elementwise_ops(
            lambda: train.train_step(model, opt, x0, cond, t, noise,
                                     alpha_bar=alpha_bar, lr=lr),
            f"one bf16 fused-arm train step, {path} path")
    return res


def check_bf16_fused_serving(counts, cb, dev, card) -> None:
    """Phase 16 (d): a configs[3] posterior ensemble (DDIM-50, 8
    conditions x 1000 members, the fused core) of the bf16 fused arm
    from random non-zero weights (a head far from zero, so the draws read
    the encoder): exactly 2 bf16 GN and 6 bf16 fused-conv forwards and
    one bf16 slab forward per encode and 50 fused_core_stack launches.
    Against the same run with the GN and fused-conv kernels off: one
    denoiser call (t = 7, 250, 499) from the kernels' context within the
    JAX package's bf16 band for one call (rtol = atol = 5e-2,
    tests/test_ops.py:568-571); the 50-step draws, over which the random
    model amplifies a one-ulp change of the context, within that band or
    within twice the gap between two plain computations of the same bf16
    model (the plain path, and the plain path with its fused conv
    computed in float32 from the same bf16 inputs and rounded once, the
    kernels' arithmetic), both on the band's measure max(|du| - 5e-2
    |u_plain|)."""
    from ertdx_torch import configs, sample
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.models import build_model
    from ertdx_torch.models import condunet as condunet_mod
    from ertdx_torch.models.condunet import FusedGNConv, GNSiLU
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax

    cfg = bf16_fused_cfg(configs)
    model = build_model(cfg.model, dev).eval()
    params_from_jax(model, random_flax_tree(
        flax_shapes(model), np.random.default_rng(SEED + 164)))
    plain = copy.deepcopy(model)
    for mod in plain.modules():
        if isinstance(mod, (FusedGNConv, GNSiLU)):
            mod.use_pallas = False
    scfg = configs.DDIM_ENSEMBLE.sample
    schedule = schedule_from_config(cfg.diffusion)
    n_cond, n_real = 8, scfg.uncertainty_samples
    gen = torch.Generator(device=dev).manual_seed(SEED + 165)
    cond = torch.rand(n_cond, cfg.model.cond_length, cfg.model.cond_channels,
                      generator=gen, device=dev)
    x_T = torch.randn(n_cond * n_real, cfg.model.param_dim, generator=gen,
                      device=dev)
    with torch.no_grad():           # first bf16 encoder call: set-up
        model.encode_condition(cond[:1])
    counts.reset_launches()
    cb.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = sample.posterior_ensemble(model, cond, schedule, n_real, scfg,
                                  x_T=x_T, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    got = {**counts.launches, **cb.launches}
    t0 = time.perf_counter()
    u_plain = sample.posterior_ensemble(plain, cond, schedule, n_real, scfg,
                                        x_T=x_T, device=dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_conv = condunet_mod.reference_gn_silu_conv3
    condunet_mod.reference_gn_silu_conv3 = lambda x, *a: plain_conv(
        x.float(), *a).to(x.dtype)
    try:
        u_plain32 = sample.posterior_ensemble(plain, cond, schedule, n_real,
                                              scfg, x_T=x_T, device=dev)
    finally:
        condunet_mod.reference_gn_silu_conv3 = plain_conv

    def excess(a, b):
        return float(((a - b).abs() - 5e-2 * b.abs()).max())

    calls = []
    with torch.no_grad():
        ctx, ctx_plain = (m.encode_condition(cond) for m in (model, plain))
        for step in (7, 250, 499):
            t = torch.full((n_cond * n_real,), step, device=dev)
            e, e_plain = (m.denoise_ensemble(x_T, t, c, n_real) for m, c in
                          ((model, ctx), (plain, ctx_plain)))
            calls.append((step, float((e - e_plain).abs().max()),
                          excess(e, e_plain)))
    du = (u - u_plain).abs()
    gap, spread = excess(u, u_plain), excess(u_plain32, u_plain)
    dmean = float((u.mean(0) - u_plain.mean(0)).abs().max())
    dstd = float((u.std(0) - u_plain.std(0)).abs().max())
    steps = scfg.ddim_steps
    step_ms = run_s / steps * 1e3
    log(f"bf16 fused-arm ensemble from random weights ({n_cond} x {n_real},"
        f" DDIM-{steps}): {run_s:.3f} s kernel path ({step_ms:.3f} ms per "
        f"DDIM step), {plain_s:.3f} s with the GN and conv kernels off "
        f"({card}); launches {got}; one denoiser call, kernels' context vs "
        f"plain: " + "; ".join(f"t={s_} max|de|={d:.3e} max(|de| - 5e-2 "
                               f"|e_plain|)={x:.3e}" for s_, d, x in calls)
        + f" (gate 5e-2); the draws max|du|={float(du.max()):.3e} max(|du| "
        f"- 5e-2 |u_plain|)={gap:.3e}, the plain path with its fused conv "
        f"in float32 against the plain path {spread:.3e} (gate max(5e-2, 2 "
        f"x that)); max|dmean|={dmean:.3e} max|dstd|={dstd:.3e} max|u|="
        f"{float(u_plain.abs().max()):.4f} std(u)={float(u.std()):.4f}")
    want = {k: n if k.endswith("fwd_bf16") else 0
            for k, n in FUSED_BF16_WANT.items()}
    want.update(fused_core_stack=steps, fused_core_block=0)
    if got != want:
        raise RuntimeError(f"bf16 fused-arm ensemble: launches {got}, "
                           f"expected {want}")
    if not (u.dtype == torch.float32 and torch.isfinite(u).all()
            and all(x <= 5e-2 for _, _, x in calls)
            and gap <= max(5e-2, 2 * spread)):
        raise RuntimeError("bf16 fused-arm ensemble disagrees with the "
                           "plain path")


def check_bf16_ensemble_serving(ea, cb, dev, card) -> int:
    """Phase 16 (f): a bf16 configs[3] model with `ensemble_pallas` (random
    non-zero weights) serving DDIM-50 to SERVE_CONDS x SERVE_MEMBERS
    chains, below the fused core's threshold: the per-block path, its
    bf16 q, k, v through the ensemble kernels as float32 copies, exactly
    one launch of each kernel per block and DDIM step and no fused-core
    launch. Against the same run with `ensemble_pallas` off (the plain
    bf16 attention, JAX's reference dtypes): the draws within the JAX
    package's bf16 band (5e-2, tests/test_ops.py:568-571) or within twice
    the gap between two plain computations of the same model (the plain
    path, and the ensemble branch with its attention computed in float32
    from the same bf16 inputs and rounded once, the kernels'
    arithmetic), both on the band's measure max(|du| - 5e-2 |u_plain|).
    Returns the launches of each kernel."""
    from ertdx_torch import configs, sample
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.models import build_model
    from ertdx_torch.models import condunet as condunet_mod
    from ertdx_torch.models.mega import MIN_TOTAL_CHAINS
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax

    cfg = configs.DDIM_ENSEMBLE
    mcfg = dataclasses.replace(cfg.model, dtype="bfloat16",
                               ensemble_pallas=True)
    model = build_model(mcfg, device=dev).eval()
    params_from_jax(model, random_flax_tree(
        flax_shapes(model), np.random.default_rng(SEED + 166)))
    b, r, p = SERVE_CONDS, SERVE_MEMBERS, mcfg.param_dim
    if b * r >= MIN_TOTAL_CHAINS or b * r < mcfg.ensemble_min_chains:
        raise RuntimeError("phase 16 (f) must run the per-block path")
    schedule = schedule_from_config(cfg.diffusion)
    gen = torch.Generator(device=dev).manual_seed(SEED + 167)
    cond = torch.rand(b, mcfg.cond_length, mcfg.cond_channels,
                      generator=gen, device=dev)
    x_T = torch.randn(b * r, p, generator=gen, device=dev)
    steps, nb = cfg.sample.ddim_steps, mcfg.num_blocks
    with torch.no_grad():           # first bf16 encoder call: set-up
        model.encode_condition(cond[:1])

    def run(on: bool):
        set_ensemble_pallas(model, on)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = sample.posterior_ensemble(model, cond, schedule, r, cfg.sample,
                                      x_T=x_T, device=dev)
        torch.cuda.synchronize()
        return u, time.perf_counter() - t0

    ea.reset_launches()
    cb.reset_launches()
    u, run_s = run(True)
    got = {**ea.launches, **cb.launches}
    u_plain, plain_s = run(False)
    # the branch's attention in float32 from the same bf16 inputs, rounded
    # once: a second plain computation of the kernels' arithmetic
    patched = {}
    for name in ("block_self_attention", "folded_cross_attention"):
        patched[name] = getattr(condunet_mod, name)
        setattr(condunet_mod, name, lambda q, k, v: ea.reference_attention(
            q.float(), k.float(), v.float()).to(q.dtype))
    try:
        u_plain32, _ = run(True)
    finally:
        for name, fn in patched.items():
            setattr(condunet_mod, name, fn)
        set_ensemble_pallas(model, True)

    def excess(a, b_):
        return float(((a - b_).abs() - 5e-2 * b_.abs()).max())

    gap, spread = excess(u, u_plain), excess(u_plain32, u_plain)
    want = {"block_self_attention": steps * nb,
            "folded_cross_attention": steps * nb,
            "fused_core_stack": 0, "fused_core_block": 0}
    step_ms = run_s / steps * 1e3
    du = float((u - u_plain).abs().max())
    log(f"bf16 ensemble_pallas model ({b} x {r}, DDIM-{steps}, per-block "
        f"path): {run_s:.3f} s on the ensemble kernels ({step_ms:.3f} ms "
        f"per DDIM step), {plain_s:.3f} s with them off ({card}); "
        f"launches {got}; the draws max|du|={du:.3e} "
        f"max(|du| - 5e-2 |u_plain|)={gap:.3e}, the float32-attention "
        f"plain computation against the plain path {spread:.3e} (gate "
        f"max(5e-2, 2 x that)); max|u|={float(u_plain.abs().max()):.4f}")
    if got != want:
        raise RuntimeError(f"bf16 ensemble_pallas serving: launches {got}, "
                           f"expected {want}")
    if not (tuple(u.shape) == (r, b, p) and u.dtype == torch.float32
            and torch.isfinite(u).all() and gap <= max(5e-2, 2 * spread)):
        raise RuntimeError("bf16 ensemble_pallas serving disagrees with the "
                           "plain path")
    return steps * nb


def check_bf16_flash_step(at, dev, card) -> dict:
    """Phase 16 (e): one b256 step of the bf16 model on the flash arm
    (attn_slab=False, attn_flash_min_logits=1; the float32 flash kernels
    on upcast copies of the bf16 operands) against the same step with the
    encoder attention's use_pallas off, under (b)'s gates (the second
    plain path computes the plain attention in float32 from the same
    bf16 q, k, v), exactly one flash forward, dQ and dK/dV."""
    from ertdx_torch import configs
    from ertdx_torch.models import build_model
    from ertdx_torch.models import condunet as condunet_mod
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax

    base = bf16_cfg(configs)
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, attn_slab=False, attn_flash_min_logits=1))
    kernel = build_model(cfg.model, dev, generator=torch.Generator()
                         .manual_seed(SEED + 166))
    params_from_jax(kernel, random_flax_tree(
        flax_shapes(kernel), np.random.default_rng(SEED + 167)))
    if kernel.compute_dtype != torch.bfloat16 or kernel.encoder.attn.slab:
        raise RuntimeError("phase 16 (e) must train the bf16 flash arm")
    plain = plain_attention(kernel)
    plain_attn = condunet_mod.reference_attention
    patches = {"reference_attention": lambda q, k, v, mask=None: plain_attn(
        q.float(), k.float(), v.float(),
        None if mask is None else mask.float()).to(q.dtype)}
    res = compare_bf16_train_paths(
        "bf16 flash arm", cfg, kernel, plain, _Counts(at), FLASH_WANT,
        SEED + 168, card, patches, "the float32 plain attention", steps=1)
    return {k: res[k] for k in ("kernel_step_ms", "plain_step_ms")}


def random_flax_tree(shapes, rng) -> dict:
    """A flax-layout tree of non-zero numpy leaves at init-like scales."""
    out = {}
    for key, val in shapes.items():
        if isinstance(val, dict):
            out[key] = random_flax_tree(val, rng)
        elif key == "kernel":
            fan_in = int(np.prod(val[:-1]))
            out[key] = (rng.standard_normal(val) / math.sqrt(fan_in)
                        ).astype(np.float32)
        elif key in ("scale", "gn_scale"):
            out[key] = (1.0 + 0.1 * rng.standard_normal(val)
                        ).astype(np.float32)
        else:
            out[key] = (0.1 * rng.standard_normal(val)).astype(np.float32)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from ertdx_torch import configs, sample
        from ertdx_torch.diffusion import schedule_from_config, sample_ddim
        from ertdx_torch.models import build_model
        from ertdx_torch.models.mega import (mega_denoise_ensemble,
                                             mega_weights)
        from ertdx_torch.ops import _build
        from ertdx_torch.ops import attention as at
        from ertdx_torch.ops import conv as cv
        from ertdx_torch.ops import core_block as cb
        from ertdx_torch.ops import ensemble_attn as ea
        from ertdx_torch.ops import groupnorm as gn
        from ertdx_torch.ops import slab_attn as sa
        from ertdx_torch.params import ParameterSpace
        from ertdx_torch.transforms import MinMaxScaler
        from ertdx_torch.utils.weights import flax_shapes, params_from_jax
    except ImportError as exc:
        print(f"chip_smoke: the ertdx_torch package is missing ({exc}); "
              "run from the root of the repository", file=sys.stderr)
        return 2

    t_all = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 1. device
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind}; nvidia-smi: {card}")
    phase("device", t0)

    # 2. build
    t0 = time.perf_counter()
    kernels = _build.load()
    log(f"build: {kernels.build_seconds:.2f} s nvcc -> {kernels.path}")
    log("ptxas: " + " | ".join(
        line.strip() for line in kernels.report.splitlines()
        if "registers" in line or "Compiling entry" in line
        or "bytes stack frame" in line))
    check_tensor_cores(kernels.path)
    check_no_spill(kernels.report, GN_KERNELS)
    check_wgmma(kernels.path, kernels.report)
    check_bf16_tensor_cores(kernels.path, kernels.report)
    check_no_spill(kernels.report, CONV_BF16_KERNELS + GN_BF16_KERNELS
                   + SLAB_BF16_KERNELS)
    phase("build", t0)

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    results = check_kernels(cb, dev, kernels.report, card)
    phase("kernels", t0)

    # 4. main path: the configs[3] ensemble
    t0 = time.perf_counter()
    cfg = configs.DDIM_ENSEMBLE
    model = build_model(cfg.model, device=dev).eval()
    rng = np.random.default_rng(SEED)
    params_from_jax(model, random_flax_tree(flax_shapes(model), rng))
    schedule = schedule_from_config(cfg.diffusion)
    n_cond, n_real = 8, cfg.sample.uncertainty_samples
    cond = torch.from_numpy(rng.standard_normal(
        (n_cond, cfg.model.cond_length, cfg.model.cond_channels)
    ).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x_T = torch.randn(n_cond * n_real, cfg.model.param_dim, generator=gen,
                      device=dev)
    steps = cfg.sample.ddim_steps
    with torch.no_grad():           # first encoder call: library set-up
        model.encode_condition(cond[:1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cb.reset_launches()
    t_run = time.perf_counter()
    u = sample.posterior_ensemble(model, cond, schedule, n_real, cfg.sample,
                                  x_T=x_T, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    main_launches = dict(cb.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: u {tuple(u.shape)} in {run_s:.3f} s; launches "
        f"{main_launches}")
    if main_launches["fused_core_stack"] != steps:
        raise RuntimeError(f"fused_core_stack launched "
                           f"{main_launches['fused_core_stack']} times, "
                           f"expected {steps}")
    if tuple(u.shape) != (n_real, n_cond, cfg.model.param_dim) or \
            not torch.isfinite(u).all():
        raise RuntimeError("main path: wrong shape or non-finite draws")
    main_step_ms = run_s / steps * 1e3
    log(f"main path: {main_step_ms:.3f} ms per DDIM step, "
        f"{n_cond * n_real * steps / run_s:.1f} chain-steps/s, peak memory "
        f"{peak / 2**20:.1f} MiB; {card}")

    model.ensemble_mega = False          # the plain module path
    t_plain = time.perf_counter()
    u_plain = sample.posterior_ensemble(model, cond, schedule, n_real,
                                        cfg.sample, x_T=x_T, device=dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t_plain
    model.ensemble_mega = True
    du = float((u - u_plain).abs().max())
    dmean = float((u.mean(0) - u_plain.mean(0)).abs().max())
    dstd = float((u.std(0) - u_plain.std(0)).abs().max())
    log(f"main path vs plain path ({plain_s:.3f} s): max|du|={du:.3e} "
        f"max|dmean|={dmean:.3e} max|dstd|={dstd:.3e} max|u|="
        f"{float(u_plain.abs().max()):.4f}")
    if not (du <= 1e-3 and dmean <= 1e-3 and dstd <= 1e-3):
        raise RuntimeError("main path disagrees with the plain path")

    space = ParameterSpace()
    scaler = MinMaxScaler.fit(space.plims.T)
    phys, mask = sample.inverse_pipeline(u, scaler, space=space)
    if phys.shape != tuple(u.shape) or not np.isfinite(phys).all():
        raise RuntimeError("inverse pipeline: bad output")
    log(f"inverse pipeline: valid fraction {float(mask.mean()):.6f}")
    phase("main path", t0)

    # 5. per-block path: fused_core_block over 2 conditions
    t0 = time.perf_counter()
    nb_cond = 2
    with torch.no_grad():
        ctx = model.encode_condition(cond[:nb_cond])
        weights = mega_weights(model)
        cb.reset_launches()
        torch.cuda.synchronize()
        t_blk = time.perf_counter()
        ub = sample_ddim(
            lambda x, t: mega_denoise_ensemble(
                model, x, t, ctx, n_real, p=cfg.model.param_dim,
                d=cfg.model.hidden_dim, num_blocks=cfg.model.num_blocks,
                chunk=n_real, stack=False, weights=weights),
            (nb_cond * n_real, cfg.model.param_dim), schedule, steps,
            x_T=x_T[:nb_cond * n_real], device=dev)
        torch.cuda.synchronize()
        blk_s = time.perf_counter() - t_blk
    block_launches = dict(cb.launches)
    ub = ub.reshape(nb_cond, n_real, -1).transpose(0, 1)
    dub = float((ub - u[:, :nb_cond]).abs().max())
    log(f"per-block path: launches {block_launches}; max|du| vs main "
        f"path={dub:.3e}; {blk_s / steps * 1e3:.3f} ms per DDIM step "
        f"({nb_cond} conditions x {n_real} members; {card})")
    if block_launches["fused_core_block"] != steps * cfg.model.num_blocks:
        raise RuntimeError("per-block path: wrong fused_core_block count")
    if not dub <= 1e-3:
        raise RuntimeError("per-block path disagrees with the main path")
    phase("per-block path", t0)

    # 6. slab attention kernels against their plain version
    t0 = time.perf_counter()
    slab = check_slab(sa, dev)
    phase("slab kernels", t0)

    # 7. training path: (a) train steps, kernel vs plain; (b) train()
    t0 = time.perf_counter()
    step_ms = check_training(sa, dev, card)
    train_launches = check_train_entry(sa, dev)
    share = (slab["slab_attention_fwd"]["ms"]
             + slab["slab_attention_bwd"]["ms"]) / step_ms["kernel_step_ms"]
    log(f"slab kernels' share of the kernel-path train step: "
        f"{100 * share:.2f} %")
    phase("training path", t0)

    # 8. ensemble attention kernels against their plain version
    t0 = time.perf_counter()
    ensemble = check_ensemble(ea, dev, kernels.report, card)
    phase("ensemble kernels", t0)

    # 9. the rest of serving on the per-block path
    t0 = time.perf_counter()
    serve_launches = check_serving(ea, cb, dev, card)
    phase("serving path", t0)

    # 10. GN and fused-conv kernels against their plain versions
    t0 = time.perf_counter()
    gnconv = check_gn_conv(gn, cv, dev, kernels.report, card)
    phase("GN and fused-conv kernels", t0)

    # 11. the fused-encoder training arm: (a) steps, (b) train() + resume
    t0 = time.perf_counter()
    counts = _Counts(gn, cv, sa)
    fused_ms = check_fused_training(counts, dev, card)
    fused_launches = check_fused_train_entry(counts, dev, card)
    share = sum(gnconv[k]["ms"] * n for k, n in (
        ("groupnorm_silu_fwd", 2), ("groupnorm_silu_bwd", 2))) / \
        fused_ms["kernel_step_ms"]
    log(f"GN kernels' share of the fused-arm step by their phase-10 times: "
        f"{100 * share:.2f} % (the fused convs run at two lengths; the "
        f"profile above has their device time)")
    phase("fused-encoder training arm", t0)

    # 12. flash attention kernels against their plain versions
    t0 = time.perf_counter()
    flash = check_flash(at, dev, card)
    phase("flash kernels", t0)

    # 13. the flash arm: (a) steps, (b) train(), (c) a configs[3] ensemble;
    # 14. distillation of phase 13's checkpoint
    ckdir = tempfile.mkdtemp(prefix="ertdx_torch_flash_")
    try:
        t0 = time.perf_counter()
        flash_ms = check_flash_training(at, dev, card)
        flash_ds, flash_launches = check_flash_train_entry(at, ckdir, dev,
                                                           card)
        check_flash_serving(at, cb, ckdir, dev, card)
        share = sum(flash[k]["ms"] for k in FLASH_WANT) / \
            flash_ms["kernel_step_ms"]
        log(f"flash kernels' share of the flash-arm step by their phase-12 "
            f"times: {100 * share:.2f} %")
        phase("flash-encoder arm", t0)

        t0 = time.perf_counter()
        check_distill(at, ckdir, flash_ds, dev, card)
        phase("distillation", t0)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    # 15. bfloat16: V5E8_DP in its own dtype; (a) the bf16 slab kernels,
    # (b) train steps, (c) train(), (d) a configs[3] ensemble from it
    t0 = time.perf_counter()
    slab_bf16 = check_slab_bf16(sa, dev, card)
    phase("bf16 slab kernels", t0)
    ckdir = tempfile.mkdtemp(prefix="ertdx_torch_bf16_")
    try:
        t0 = time.perf_counter()
        bf16_ms = check_bf16_training(sa, dev, card)
        bf16_launches = check_bf16_train_entry(sa, ckdir, dev, card)
        check_bf16_serving(sa, cb, ckdir, dev, card, main_step_ms)
        share = (slab_bf16["slab_attention_fwd_bf16"]["ms"]
                 + slab_bf16["slab_attention_bwd_bf16"]["ms"]) / \
            bf16_ms["kernel_step_ms"]
        log(f"bf16 slab kernels' share of the bf16 kernel-path train step: "
            f"{100 * share:.2f} %; the float32 step (phase 7) "
            f"{step_ms['kernel_step_ms']:.3f} ms, the bf16 step "
            f"{bf16_ms['kernel_step_ms']:.3f} ms")
        phase("bf16 training and serving", t0)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    # 16. bfloat16 fused-encoder arm: (a) the bf16 GN and fused-conv
    # kernels, (b) train steps, (c) train(), (d) a configs[3] ensemble
    # from random weights; (e) one bf16 step of the flash arm; (f) a bf16
    # ensemble on the per-block path through the ensemble kernels
    t0 = time.perf_counter()
    gnconv_bf16 = check_gn_conv_bf16(gn, cv, dev, card)
    phase("bf16 GN and fused-conv kernels", t0)
    ckdir = tempfile.mkdtemp(prefix="ertdx_torch_bf16_fused_")
    try:
        t0 = time.perf_counter()
        counts16 = _AllCounts(gn, cv, sa)
        fused16_ms = check_bf16_fused_training(counts16, dev, card)
        fused16_launches = check_bf16_train_entry(
            sa, ckdir, dev, card, cfg=bf16_fused_cfg(configs),
            counts=counts16, rule=fused_bf16_rule, label="bf16 fused arm")
        check_bf16_fused_serving(counts16, cb, dev, card)
        flash16_ms = check_bf16_flash_step(at, dev, card)
        check_bf16_ensemble_serving(ea, cb, dev, card)
        log(f"bf16 ms per b256 train step ({card}): the fused arm "
            f"{fused16_ms['kernel_step_ms']:.3f} (its plain path "
            f"{fused16_ms['plain_step_ms']:.3f}), phase 15's slab arm "
            f"{bf16_ms['kernel_step_ms']:.3f}, the flash arm's one step "
            f"{flash16_ms['kernel_step_ms']:.3f}; float32 fused arm (phase "
            f"11) {fused_ms['kernel_step_ms']:.3f}")
        phase("bf16 fused-encoder arm", t0)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    launches = {"fused_core_stack": main_launches["fused_core_stack"],
                "fused_core_block": block_launches["fused_core_block"],
                **train_launches,
                "block_self_attention": serve_launches,
                "folded_cross_attention": serve_launches,
                **fused_launches, **flash_launches,
                **{k: v for k, v in bf16_launches.items()
                   if k.endswith("_bf16")},
                **{k: v for k, v in fused16_launches.items()
                   if k.endswith("_bf16") and not k.startswith("slab_")}}
    replaces = {"fused_core_stack": "ertdx/ops/core_block.py:440",
                "fused_core_block": "ertdx/ops/core_block.py:281",
                "slab_attention_fwd": "ertdx/ops/slab_attn.py:147",
                "slab_attention_bwd": "ertdx/ops/slab_attn.py:184",
                "block_self_attention": "ertdx/ops/ensemble_attn.py:151",
                "folded_cross_attention": "ertdx/ops/ensemble_attn.py:262",
                "groupnorm_silu_fwd": "ertdx/ops/groupnorm.py:47",
                "groupnorm_silu_bwd": "ertdx/ops/groupnorm.py:95",
                "gn_silu_conv3_fwd": "ertdx/ops/conv.py:49",
                "gn_silu_conv3_bwd": "ertdx/ops/conv.py:109",
                "flash_attention_fwd": "ertdx/ops/attention.py:53",
                "flash_attention_bwd_dq": "ertdx/ops/attention.py:146",
                "flash_attention_bwd_dkv": "ertdx/ops/attention.py:178",
                "slab_attention_fwd_bf16": "ertdx/ops/slab_attn.py:147",
                "slab_attention_bwd_bf16": "ertdx/ops/slab_attn.py:184",
                "groupnorm_silu_fwd_bf16": "ertdx/ops/groupnorm.py:47",
                "groupnorm_silu_bwd_bf16": "ertdx/ops/groupnorm.py:95",
                "gn_silu_conv3_fwd_bf16": "ertdx/ops/conv.py:49",
                "gn_silu_conv3_bwd_bf16": "ertdx/ops/conv.py:109"}
    sources = {"fused_core_stack": "ertdx_torch/csrc/core_block.cu",
               "fused_core_block": "ertdx_torch/csrc/core_block.cu",
               "slab_attention_fwd": "ertdx_torch/csrc/slab_attn.cu",
               "slab_attention_bwd": "ertdx_torch/csrc/slab_attn.cu",
               "block_self_attention": "ertdx_torch/csrc/ensemble_attn.cu",
               "folded_cross_attention": "ertdx_torch/csrc/ensemble_attn.cu",
               "groupnorm_silu_fwd": "ertdx_torch/csrc/groupnorm.cu",
               "groupnorm_silu_bwd": "ertdx_torch/csrc/groupnorm.cu",
               "gn_silu_conv3_fwd": "ertdx_torch/csrc/gn_conv.cu",
               "gn_silu_conv3_bwd": "ertdx_torch/csrc/gn_conv.cu",
               **{name: "ertdx_torch/csrc/flash_attn.cu"
                  for name in FLASH_WANT},
               **{name: "ertdx_torch/csrc/slab_attn_bf16.cu"
                  for name in SLAB_BF16_WANT if name.endswith("_bf16")},
               "groupnorm_silu_fwd_bf16": "ertdx_torch/csrc/groupnorm.cu",
               "groupnorm_silu_bwd_bf16": "ertdx_torch/csrc/groupnorm.cu",
               "gn_silu_conv3_fwd_bf16": "ertdx_torch/csrc/gn_conv.cu",
               "gn_silu_conv3_bwd_bf16": "ertdx_torch/csrc/gn_conv.cu"}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name],
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "bound_tc_ms": r["bound_tc_ms"],
         "bound_fp32_ms": r["bound_fp32_ms"],
         "library_ms": r.get("library_ms"), "shape": r["shape"],
         **{k: r[k] for k in ("tflops", "graph_ms", "library_graph_ms")
            if k in r}}
        for name, r in {**results, **slab, **ensemble, **gnconv,
                        **flash, **slab_bf16, **gnconv_bf16}.items()]}
    log(f"[phase] total: {time.perf_counter() - t_all:.3f} s")
    log(json.dumps(line))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
