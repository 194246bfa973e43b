#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each timed, each raising on failure (the script then exits
non-zero and prints no result line):

1. device: the card's name and power limit;
2. build: nvcc compiles ertdx_torch/csrc/*.cu (ertdx_torch/ops/_build.py)
   and prints ptxas' register and shared-memory report; `cuobjdump -sass`
   of the library counts the HMMA.1688.F32.TF32 instructions of each
   3xTF32 slab and flash kernel and fails if one has none (they run
   their products on the tensor cores); the ensemble attention
   pair's one-pass kernels (csrc/ensemble_attn.cu) bf16 mma.sync
   (HMMA.16816.F32.BF16) and no TF32 MMA in every instance, and no spill
   in ptxas' lines; the
   fused core's kernels of both modes (csrc/core_onepass.cu: one-pass
   and bf16_3x) Hopper's bf16 warpgroup MMAs (HGMMA.*.F32.BF16) and no
   mma.sync (HMMA) of any kind; ptxas' lines of the fused-core kernels
   of both modes and of
   every GN kernel (staged and streamed), where a spill fails; the bf16
   warpgroup MMAs (HGMMA.*.F32.BF16) and no mma.sync (HMMA) of any kind
   in every instance of the fused conv's three GEMMs on a float32 and on
   a bf16 x (forward, dh, dW), and of the one-pass
   slab kernels with no mma.sync of any kind in all eight instances
   (float32 and bf16 slabs, dh 32 and 64, forward and backward), and
   ptxas' lines of every bf16 GN, fused-conv and one-pass slab kernel,
   where a spill fails;
3. kernels: fused_core_stack and fused_core_block at full width (D=128,
   nb=4, P=29, Lk=147) and at the kernels' limits (P=17 with Lk=61, P=32
   with Lk=256), every weight non-zero, in both modes: accurate=True
   (JAX's bf16_3x, three bf16 wgmma passes a product) held against the
   plain bf16_3x version (max abs error <= 1e-4 * max(1, max|plain|))
   and against the float32 function computed in float64 (rms error
   within 0.8-1.25x of the plain bf16_3x version's; its rms gap to that
   version under 1/4 of the version's error, or within 1.25x of the gap
   between two plain computations of bf16_3x, float32 and float64 sums:
   a flipped lo rounding carries through the layers, so two computations
   of one function part by 0.5-0.9 of its error); accurate=False (one
   bf16 pass a product, JAX's default) held against the float32 function
   computed in float64 (rms error within 0.8-1.25x of the plain one-pass
   version's, max error <= 5e-2 * max(1, max|exact|), the stack's outputs
   bf16 values); reruns bit-identical in both modes (a first rerun, then
   STRESS_LAUNCHES = 200 more a mode and case), timed with CUDA
   events in both modes (accurate=True also by CUDA-graph replay) with
   the share of the bf16 bound (3 passes a product with accurate=True;
   the kernels with their weights packed and K and V rounded once, as
   the main path makes them); the kernels' shared memory a block and
   resident blocks an SM; one JSON line {"kernels": [...]};
4. main path: the configs[3] posterior ensemble (CondUNet at
   DDIM_ENSEMBLE's full width, random weights from a seed carried over by
   params_from_jax, 8 conditions x 1000 members, DDIM-50, eta=0) through
   ertdx_torch.sample.posterior_ensemble, with ensemble_mega_accurate=True
   (JAX's bf16_3x), exactly 50 fused_core_stack launches, held against
   the same run on the plain bf16_3x version from the same x_T, its gap
   to the float32 module path reported; then the inverse pipeline (phase
   21 runs the preset's default mode);
5. per-block path: the same DDIM run over 2 of the conditions through
   mega_denoise_ensemble(stack=False, accurate=True), i.e. the bf16_3x
   fused_core_block, held against the main path's draws, with its ms per
   DDIM step;
6. slab kernels: the 3xTF32 slab kernels (csrc/slab_attn.cu, which
   slab_attention(accurate=True) runs: one launch each and no one-pass
   launch, bit for bit the wrappers') at the encoder's training shape
   (B=256, L=147, C=256, 4 heads), at B=4 with 8 heads (dh=32) and at an
   odd L, held against the plain version (1e-4 * max(1, max|plain|)),
   reruns bit-identical, timed beside the plain version and
   F.scaled_dot_product_attention (the yardstick; the port never calls
   it), with the profiler's kernel names of the slab kernels and of SDPA
   (its route) and the kernels' resident blocks and block size; then
   the one-pass kernels on float32 slabs (JAX's function at DEFAULT,
   csrc/slab_attn_bf16.cu) at those shapes and two key chunks past 160
   keys and the longest L, held against the float32 function computed in
   float64 (rms error within 0.8-1.25x of the plain one-pass version's,
   max error <= 5e-2 * max(1, max|exact|)), reruns bit-identical, the
   first timed by events and CUDA-graph replay beside the 3xTF32
   kernels, the plain one-pass version and one float32 SDPA call on
   laid-out operands, the bound at 4 bytes a value;
7. training path: V5E8_DP's model and train settings in float32 on one
   card (full-width CondUNet, attn_slab=True, batch 256, condition
   4693 x 14), random non-zero weights. (a) 5 train_steps on the kernel
   path (the one-pass slab kernels) against the same 5 with the plain
   one-pass slab on the card: phase 7's gates, with phase 15 (b)'s spread
   rule (run to run, and the plain one-pass slab in float64) where a
   bf16 ulp flipped by the sum order breaks one, exactly one one-pass
   slab forward and backward launch per step and no 3xTF32 one, ms per
   step, and a torch.profiler breakdown of one step of each path. (b)
   ertdx_torch.train.train for 2
   epochs on 400 examples into a temporary directory, its best and last
   checkpoints read back through the port's reader;
8. ensemble kernels: block_self_attention and folded_cross_attention in
   JAX's one-pass mode (one bf16 mma.sync pass a product, float32 sums)
   at the per-block path's shapes (N=2000 chains of P=29; B=2 conditions
   of Lq=29,000 folded queries against Lk=147 keys; D=128), at a small
   and at an odd shape and at the cross gate's edges (Lk=173 at D=128,
   Lk=256 at D=64), each in float32 and in bf16 (q, k and v chunks of
   one fused projection, loaded as they are), held against the float32
   function computed in float64 (rms error within 0.8-1.25x of the plain
   one-pass version's, max error <= 5e-2 * max(1, max|exact|)), the
   output in the input's dtype, reruns bit-identical; the first case of
   each kernel and dtype timed (CUDA events, CUDA-graph replay and
   profiler device time, every profiled kernel the one-pass kernel, at
   most one a call) beside
   the plain one-pass version and F.scaled_dot_product_attention with
   one head in the same dtype (the yardstick), with the share of the
   bound at 4 or 2 bytes a value;
9. the rest of serving: DDIM_ENSEMBLE's CondUNet with uncond_prob=0.1, a
   v-parameterisation and ensemble_pallas=True, random weights (null
   context included) through params_from_jax, 2 conditions x 1000
   members, i.e. 2000 chains, below the fused-core threshold, so the
   per-block path runs on the ensemble kernels: (a) pd-4 guided at 2.0,
   (b) DPM++-15 unguided, (c) ancestral over T=500 guided at 2.0 on the
   interval (0, 0.5), each with exact launch counts, its ensemble mean
   and std within 5e-2 * max(1, |.|) of the same run with
   ensemble_pallas=False from the same draws, the draws' max gap
   printed; (e) one denoiser call of the kernel path under phase 8's
   rule against the float32 plain path, the path with both attentions
   in the plain one-pass version setting the rms yardstick; (d)
   posterior_over_dataset over 3 conditions in batches of 2 (pd-4,
   inverse on the device);
10. GN and fused-conv kernels: groupnorm_silu's and gn_silu_conv3's CUDA
   forward and backward at the fused encoder arm's shapes (GN at the
   stem, (256, 587, 128), and at (256, 294, 256); the fused conv at (256,
   294, 256 -> 256) and (256, 147, 256 -> 256)), at the stem-width conv
   (256, 587, 128 -> 128, as pallas_conv=True runs it), a 128 -> 256 conv
   and odd shapes, GN also at the condition's length (2, 4693, 128; the
   streamed kernels) and on x = 1000 + N(0, 1), each case's GN launch
   plan logged (staged or streamed) and the GN kernels' GB/s; GN's
   outputs held against the plain version (1e-4 * max(1, max|plain|));
   the float32 fused conv's (JAX's one-pass function on the bf16 wgmma
   GEMMs) by the one-pass and same-function rules against the plain
   one-pass version and the float32 function in float64, db elementwise
   (1e-4 * max(1, max|plain|)); reruns of the forward and the backward
   bit-identical, ptxas' lines of the fused conv's kernels (a spill
   fails), timed (CUDA events, the conv also by CUDA-graph replay, and
   profiler device time, the backward's launch by launch) beside the
   plain versions and the unfused library composition (F.group_norm +
   F.silu, + F.conv1d; cuDNN and TF32 off), a yardstick only: no single
   PyTorch call computes either function, with TFLOP/s and the share of
   the bound;
11. the fused-encoder training arm: V5E8_DP as phase 7 with pallas_gn=True
   and pallas_conv_min_width=256, random weights from a seed through
   params_from_jax. (a) 5 train_steps against the same 5 with every
   kernel switched off (the slab and the fused conv on their plain
   one-pass versions; phase 7's spread and graft rules), exactly 2/2/6/6
   GN forward/backward and fused-conv
   forward/backward launches and one one-pass slab forward and backward
   per step, ms per step of both paths and a profile of one step of
   each. (b) train() for 2 epochs on 400
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
   DDIM-50) from that checkpoint with ensemble_mega_accurate=True (JAX's
   bf16_3x): one flash forward per call, draws within 1e-3 of the
   all-plain path (the plain attention and the plain bf16_3x core), the
   float32 module path's gap logged;
14. distillation of phase 13's checkpoint as an eps teacher: the first
   batch's loss and gradients on the kernel path against the plain path,
   then distill() with a conversion stage and one halving (8 -> 4), one
   epoch each, 2 flash forwards, 1 dQ and 1 dK/dV per step and 2 forwards
   per val batch; the student read back and sampled by sample_pd (pd-4,
   2 x 1000 chains), draws within 1e-3 of the plain path;
15. bfloat16: V5E8_DP in its own dtype (bf16 compute, float32 params),
   one card. (a) the one-pass slab kernels on bf16 slabs (forward and
   one-launch backward, one bf16 wgmma a product) at the slab cases
   under phase 6's one-pass rule against the float32 function in float64
   from the same bf16 inputs, reruns bit-identical, timed beside the
   float32 kernels, the bf16 plain version and
   F.scaled_dot_product_attention in bf16 (the yardstick), with SDPA's
   kernel names; (b) 5 b256 train
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
   dQ and dK/dV; (f) a bf16 ensemble_pallas model from random weights,
   2 x 1000 members by DDIM-50 on the per-block path, its bf16 q, k and
   v loaded by the one-pass ensemble kernels: 200 launches of each, the
   draws within the band or twice the gap between two plain
   computations, ms a DDIM step with the kernels on and off;
17. the user path through the port's CLI (ertdx_torch/cli.py) at
   V5E8_DP's full width in bf16, everything made from a seed in a
   temporary directory: (a) generate-design --n 400, equal to
   SurrogateDataGenerator(seed=0); (b) 4 simulations' .srv files (14
   surveys of 4693 rows, a 259-line header, the time tokens shuffled)
   read back exactly by gather_srv_ensemble, 396 more simulation folders
   from seeded normals, 2 of a wrong shape and 1 missing, gather-data
   --n 403 -> (400, 4693, 14) and (400, 29, 1) with 2 discarded and 1
   missing; (c) train for 2 epochs at batch 256, the bf16 slab launches
   by the epoch grid, the echo of bfloat16; (d) calibrate --temps 1.0,1.5
   --realizations 1000 --commit on the 40-condition val split, exactly 2
   arms x batches x 50 fused_core_stack launches, the committed echo; (e)
   sample with no sampling flags on the test split against an in-process
   posterior_over_dataset from the same seed (1e-6 relative), 50
   fused_core_stack launches a batch, the valid fraction; (f) metrics
   (JAX's keys), batched_kde_mode on a (50, 4693, 14) ensemble against the
   float64 KDE on 63 seeded pixels (one grid step) and a constant pixel,
   its ms; (g) `python -m ertdx_torch.cli serve` as a subprocess, three
   requests (1, 4 and 8 conditions, 1000 members) within 1e-6 relative of
   an in-process PosteriorService (50 fused_core_stack and 1 bf16 slab
   forward each), ms a request by the host clock around the HTTP call,
   and a malformed and an oversized request answered 400;
18. the reference model and the unconditional model (models/refmlp.py,
   models/uncond.py), which run no kernel of csrc/ (JAX computes them
   outside Pallas): every kernel counter set to 0 before and still 0
   after. (a) REF_DEFAULT's RefCondMLP at full width (P=29, H=128, a
   4693 x 14 condition, batch 32, T=500, Adam at 1e-4) from random
   weights through params_from_jax: 5 train_steps on the card against the
   same 5 on the CPU on injected t and eps (losses within 1e-4 relative,
   parameters within 1e-5 but for 0.1 % of the entries, which Adam's
   sign(g) moves up to 2 lr a step), ms a step; train() for 2 epochs on
   400 seeded examples, the best checkpoint read back by load_best_model
   and the last bit for bit the trained model; (b) the configs[0]
   posterior, 8 conditions x 50 members ancestral over 500 steps on the
   realization-major path, unguided and guided at 2.0 (uncond_prob 0.1),
   against the CPU from the same x_T and noise (1e-3 x max(1, max|u|)),
   ms a step, the inverse pipeline; (c) a reference twin's `.pth` state
   dict: the imported model against the twin on the card (1e-5), `sample
   --torch-checkpoint --model refmlp` through the CLI against
   posterior_over_dataset in process from the same seed and
   PosteriorService.from_torch against posterior_ensemble (1e-6); (d)
   generate-synthetic through the CLI (synthetic.py's bytes),
   SYNTHETIC_GAUSSIAN's UncondMLP at full width (P=256, H=256, 3 blocks,
   batch 64, T=500) for 2 epochs and a 512-member ancestral draw, finite,
   ms a step; then tests/test_uncond.py's configs[1] acceptance check on
   the card (8 x 8 fields, T=100, 40 epochs at batch 128 and lr 2e-3,
   the moments and the neighbour correlation within its tolerances);
19. the physics loop (physics.py, the .srv C++ reader, plots.py through
   the CLI): (a) the configs[3] posterior as phase 4 builds it (8 x 1000,
   DDIM-50, exactly 50 fused_core_stack launches) and the inverse
   pipeline on the host in float64; (b) the first 50 valid members of
   condition 0 through `python -m ertdx_torch.cli simulate --mode
   keywords --no-mpi --concurrency 6` on tests/fixtures/
   pflotran_template.in, PFLOTRAN a stand-in Python script (no numpy)
   that this script writes, whose 14 .srv files of 4693 rows (a 259-line
   header) are a fixed function of the spliced values: every run's
   parameters.npy equal to its member and data.npy to that function of
   its input file, exactly, all 700 files read by the C++ reader
   (ertdx_torch/csrc/srv_reader.cpp, built by g++), none by numpy; 5
   members again through run_posterior_validation in this process, the
   same data; one simulation's 14 files read by the C++ reader and by
   np.genfromtxt, timed; (c) gather-data --n 50 -> (50, 4693, 14) and
   (50, 29, 1), ensemble_statistics on the card and wsse_per_simulation
   against condition 0's survey, the KDE mode within one grid step of the
   CPU's on every 32nd pixel, the rest against the host's within 1e-6;
   `plot`, which writes six figures, or without matplotlib (as on the
   card's machine) exits non-zero naming it; (d) the times;
20. the mesh on one card (ertdx_torch/parallel/), ranks started by
   torch.multiprocessing (spawn) on a TCP store, each failing the phase
   if it fails or outlives its timeout; phase 7's model and batch
   (V5E8_DP, float32, attn_slab, b256, condition 4693 x 14). (a) Two
   ranks share the one card over gloo (NCCL refuses two ranks on one
   device), make_mesh(data=2): five DP train_steps, 128 rows a rank,
   from non-zero weights and the global draws of a single-process run of
   the same five steps, held to phase 7's gates against it, one slab
   forward and one backward a rank a step, ms a step (two ranks on one
   card: not a scaling figure); (b) the same world: train(mesh=) for 2
   epochs on 400 examples, histories within 1e-5 relative of train() in
   this process, rank 0 alone writing the checkpoints, which the port's
   reader restores; (c) the same world: the configs[3] posterior on 16
   conditions x 1000 members, DDIM-50, 8000 chains a rank on the fused
   core with ensemble_mega_accurate=True, exactly 50 fused_core_stack
   launches a rank, the draws within
   phase 4's 1e-3 of this process's 16 x 1000 run from the same x_T (a
   DP or TP step: one one-pass slab forward and backward a rank); (d)
   make_mesh(data=1, model=2) over the same ranks: one TP train_step
   (tp_shard_params' 34 leaves) against the single process's first
   step under phase 7's gates, the sharded layers and the kernel route
   of the kernel-read weights logged; (e) a 1-rank NCCL world, cuDNN
   deterministic: (a)'s mesh path for one step and a 2 x 1000 DDIM-50
   ensemble, each within 1e-6 relative of the no-mesh path; (f) `python -m
   torch.distributed.run --standalone --nproc-per-node 2 -m
   ertdx_torch.cli train --mesh-data 2` for one epoch, its history
   equal to (b)'s first epoch within 1e-5;
21. the default main path: configs[3] as shipped
   (ensemble_mega_accurate=False, JAX's default), phase 4's random
   weights, conditions and x_T: 8 x 1000 members, DDIM-50, eta 0,
   exactly 50 one-pass fused_core_stack launches and no bf16_3x one, then
   the inverse pipeline; held against the same run with accurate=True:
   the ensemble mean and std of each condition and parameter within 5e-2
   * max(1, |.|), the draws' max gap reported; the first step's denoiser
   call held to phase 3's one-pass rule against the float64 function;
   ms per DDIM step of both modes, in turns; the per-block variant over 2
   conditions in the one-pass mode (200 one-pass fused_core_block
   launches), its mean and std within the same band of the stack's;
22. the one-pass gates on the card: where JAX's gate takes its kernel
   and the port's kernel does not (folded cross attention at Lk=300 and
   D=128, block self attention at P=40, the slab at dh=128, the fused
   conv at Cout=12, the fused core at Lk=300 through mega_plan and
   mega_denoise_ensemble), the plain one-pass version runs with no kernel
   launch and a warning, under the one-pass rule against the float32
   function (the core's against its float32 module path, its outputs
   bf16 values); a shape JAX refuses (self attention at D=64), and the
   fused conv on CPU tensors, run the float32 plain version bit for bit,
   with no launch and no warning.

Every kernel's entry in the kernels line has `bound_ms`, the least time
the card could take: the bytes at 3.35 TB/s or the operations at the
fastest rate of their class, 3xTF32 on the tensor cores for float32
matrix products (the fp32 pipe for GroupNorm, which has none), the bf16
tensor cores' 989 TFLOP/s for the bf16 kernels, the fused core in both
modes (three passes a product with accurate=True), the one-pass ensemble pair,
the one-pass slab pair and the fused conv on a float32 x (at 4 bytes a
float32 value, 2 a bf16 one);
for the flash kernels
only the keys the mask needs. Beside it `bound_tc_ms` (the 3xTF32 time;
null for GroupNorm) and `bound_fp32_ms` (the fp32 pipe's). The last line of
stdout is {"ok": true, "device": {...}}. The build goes
to build/ertdx_torch_kernels/ and the .srv reader's to
build/ertdx_torch_srv/; the checkpoints of phases 7, 11, 13, 14, 15 and
16 and the files of phases 17, 18, 19 and 20 go to temporary directories
that are removed; nothing else is written.
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
from pathlib import Path

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
# the float32 one-pass slab kernels' cases: phase 6's, then two key
# chunks past 160 keys and the longest L (phase 15 (a)'s)
SLAB_ONEPASS_CASES = SLAB_CASES + [(2, 200, 128, 2), (1, 256, 128, 2)]
# a float32 slab-arm train step's slab launches: one one-pass forward and
# backward, no 3xTF32 one (the model asks for no `accurate`)
SLAB_ONEPASS_STEP = {"slab_attention_fwd": 0, "slab_attention_bwd": 0,
                     "slab_attention_fwd_onepass": 1,
                     "slab_attention_bwd_onepass": 1}


def onepass_slab_rule(steps: int, forwards: int) -> dict:
    """A float32 slab arm's slab launches: a one-pass forward per forward
    (train or eval), a one-pass backward per step, no 3xTF32 launch."""
    return {"slab_attention_fwd": 0, "slab_attention_bwd": 0,
            "slab_attention_fwd_onepass": forwards,
            "slab_attention_bwd_onepass": steps}
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


# a kernel that runs its products on the 3xTF32 tensor-core tile, in a
# mangled symbol: the slab and flash attention kernels
TENSOR_CORE_KERNEL = re.compile(
    r"\d((?:slab|flash)_(?:fwd|bwd_dq|bwd_dkv)_kernel)[IE]")
# the fused core's bf16_3x kernels (csrc/core_onepass.cu, accurate=True)
CORE_KERNELS = ("core_stack_bf16x3_kernel", "core_block_bf16x3_kernel")
# the fused core's one-pass kernels (csrc/core_onepass.cu, wgmma and TMA)
CORE_ONEPASS_KERNELS = ("core_stack_wgmma_kernel",
                        "core_block_wgmma_kernel")
# the ensemble attention pair in JAX's one-pass mode (csrc/ensemble_attn.cu,
# bf16 mma.sync), each templated on float and bf16 operands
ENSEMBLE_KERNELS = ("block_self_onepass_kernel",
                    "folded_cross_onepass_kernel")
ENSEMBLE_NAMES = ("block_self_attention", "folded_cross_attention")
GN_KERNELS = ("gn_fwd_staged_kernel", "gn_bwd_staged_kernel",
              "gn_stats_staged_kernel", "gn_fwd_stream_kernel",
              "gn_bwd_stream_kernel", "gn_stats_stream_kernel")
# what the fused conv backward's launches compute, by kernel name
LAUNCH_LABELS = {"gn_stats": "statistics", "gn_affine": "table",
                 "round_colsum": "bf16(g) and db", "conv_dw": "dW",
                 "sum_rows": "sum", "tap3_wgmma": "dh",
                 "gn_bwd": "GN backward"}


_SASS: dict = {}          # the library's SASS by path, disassembled once


def sass_counts(path, kernel_of, instruction: str):
    """{kernel<template args>: the count of `instruction` (a string, or a
    compiled pattern) in its SASS} for each kernel of the library at
    `path` whose SASS header `kernel_of(line)` names, or None where the
    toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    if str(path) not in _SASS:
        _SASS[str(path)] = subprocess.run(
            [tool, "-sass", str(path)], capture_output=True, text=True,
            check=True).stdout
    sass = _SASS[str(path)]
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
    3xTF32 slab and flash kernel of the built library; raises where a
    kernel lacks them. Logs and returns where the toolkit has no
    cuobjdump."""
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
    if not counts or bare:
        raise RuntimeError(f"kernels without TF32 MMAs, or none: {bare}")


def check_bf16_mma_sync(path, report: str, kernels=ENSEMBLE_KERNELS,
                        label: str = "one-pass ensemble kernels") -> None:
    """Phase 2: bf16 mma.sync (HMMA.16816.F32.BF16) and no TF32 MMA
    (HMMA.1688) in the SASS of every instance of `kernels` (float and bf16
    operands apart), and no spill in ptxas' lines; raises where an instance
    lacks the bf16 MMAs or has TF32 ones, or a kernel is missing. Logs the
    SASS check's absence where the toolkit has no cuobjdump."""
    check_no_spill(report, kernels)

    def kernel_of(line):
        name = next((k for k in kernels if k in line), None)
        if name is None:
            return None
        return name + ("[bf16]" if "__nv_bfloat16" in line else "[f32]")

    bf16 = sass_counts(path, kernel_of, "HMMA.16816.F32.BF16")
    if bf16 is None:
        log(f"sass: no cuobjdump; the {label}' bf16 MMA check is not made")
        return
    tf32 = sass_counts(path, kernel_of, "HMMA.1688")
    log(f"sass: HMMA.16816.F32.BF16 / HMMA.1688 per instance of the {label}"
        f": " + "; ".join(f"{k} {n} / {tf32[k]}"
                          for k, n in sorted(bf16.items())))
    bad = [k for k, n in bf16.items() if n == 0 or tf32[k]]
    bad += [f"{k}[{t}]" for k in kernels for t in ("f32", "bf16")
            if not any(n.startswith(f"{k}[{t}]") for n in bf16)]
    if bad:
        raise RuntimeError(f"{label} without bf16 MMAs, with TF32 ones or "
                           f"missing: {bad}")


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


def onepass_gate(tag, got, onepass_plain, exact, stack: bool,
                 same_fn: bool = True) -> dict:
    """The one-pass rule (tests/test_torch_core_onepass.py): `got`'s rms
    error against the float64 function `exact` within 0.8-1.25x of the
    plain one-pass version's, its max error at most 5e-2 x max(1,
    max|exact|), and, for the stack, every output a bf16 value. With
    `same_fn` also the CPU tests' same-function rule: the rms of `got` -
    `onepass_plain` under 1/4 of the plain one-pass version's rms error,
    which a kernel that rounds at other points than JAX's misses even
    where its own error is of the one-pass size. A product of several
    one-pass layers (the fused core, a denoiser call) takes no `same_fn`:
    there two computations of the same function differ by flipped bf16
    ulps that later roundings carry on (the float32 and float64 plain
    stacks differ by 0.6-0.7 of their rms error; phase 22 logs it).
    Raises where a rule fails; returns the errors."""
    def rms(a):
        return float(a.double().square().mean().sqrt())

    r = {"rms_err_exact": rms(got - exact),
         "plain_rms_err_exact": rms(onepass_plain - exact),
         "max_err_exact": float((got - exact).abs().max()),
         "max_abs_err": float((got - onepass_plain).abs().max()),
         "rms_gap_plain": rms(got - onepass_plain)}
    band = 5e-2 * max(1.0, float(exact.abs().max()))
    # both exact (one key: the output is v, a bf16 value) count as equal
    ratio = (r["rms_err_exact"] / r["plain_rms_err_exact"]
             if r["plain_rms_err_exact"] else
             1.0 if r["rms_err_exact"] == 0.0 else math.inf)
    gap = (r["rms_gap_plain"] / r["plain_rms_err_exact"]
           if r["plain_rms_err_exact"] else
           0.0 if r["rms_gap_plain"] == 0.0 else math.inf)
    bf16 = not stack or not bool((got.view(torch.int32) & 0xFFFF).any())
    log(f"{tag} one-pass: rms error vs exact {r['rms_err_exact']:.3e} "
        f"(plain one-pass {r['plain_rms_err_exact']:.3e}, ratio "
        f"{ratio:.4f}, gate 0.8-1.25); max error {r['max_err_exact']:.3e} "
        f"(band {band:.3e}); max|kernel - plain one-pass| "
        f"{r['max_abs_err']:.3e}, rms {r['rms_gap_plain']:.3e} = "
        f"{gap:.4f} x the plain one-pass version's rms error (gate "
        f"{'< 0.25' if same_fn else 'none'})" +
        ("; outputs bf16 values: " + str(bf16) if stack else ""))
    if not (torch.isfinite(got).all() and 0.8 <= ratio <= 1.25
            and r["max_err_exact"] <= band and bf16
            and (not same_fn or gap < 0.25)):
        raise RuntimeError(f"{tag}: the one-pass kernel misses its rule")
    return r


def _double(args):
    return [({key: val.double() for key, val in a.items()}
             if isinstance(a, dict) else a.double()) for a in args]


def bf16x3_gate(tag, got, plain3, plain3_64, exact) -> dict:
    """The bf16_3x rule (tests/test_torch_core_bf16x3.py): `got` within
    1e-4 x max(1, max|plain3|) of the plain bf16_3x version `plain3`
    elementwise; its rms error against the float64 function `exact`
    within 0.8-1.25x of plain3's; and the same function: its rms gap to
    plain3 under 1/4 of plain3's error (the one-pass kernels' rule), or,
    where two computations of bf16_3x part by more than that, at most
    1.25x the gap between plain3 and `plain3_64` (the same function with
    float64 sums): a lo part's rounding flipped by a float32 difference
    carries through the layers and the stack's last hi + lo rounding, so
    the port's plain version and JAX's own bf16_3x part by 0.5-0.8 of the
    error on the CPU. That last rule also passes a kernel that rounds q
    before its scale or P before its normalisation; it fails lo parts
    left float32 and a dropped pass (tools/bf16x3_rule_reach.py). Raises
    where a rule fails; returns the errors."""
    def rms(a):
        return float(a.double().square().mean().sqrt())

    r = {"max_abs_err": float((got - plain3).abs().max()),
         "rms_err_exact": rms(got - exact),
         "plain_rms_err_exact": rms(plain3 - exact),
         "max_err_exact": float((got - exact).abs().max()),
         "rms_gap_plain": rms(got - plain3),
         "plain_spread": rms(plain3 - plain3_64)}
    tol = 1e-4 * max(1.0, float(plain3.abs().max()))
    ratio = r["rms_err_exact"] / r["plain_rms_err_exact"]
    gap = r["rms_gap_plain"] / r["plain_rms_err_exact"]
    spread = r["plain_spread"] / r["plain_rms_err_exact"]
    same = gap < 0.25 or r["rms_gap_plain"] <= 1.25 * r["plain_spread"]
    log(f"{tag} bf16_3x: max|kernel - plain bf16_3x| {r['max_abs_err']:.3e}"
        f" (tol {tol:.3e}); rms error vs exact {r['rms_err_exact']:.3e} "
        f"(plain {r['plain_rms_err_exact']:.3e}, ratio {ratio:.4f}, gate "
        f"0.8-1.25); rms gap to the plain version {r['rms_gap_plain']:.3e} "
        f"= {gap:.4f} of its error, the plain pair's (float32 / float64 "
        f"sums) {spread:.4f} (gate: < 0.25, or <= 1.25x the pair's)")
    if not (torch.isfinite(got).all() and r["max_abs_err"] <= tol
            and 0.8 <= ratio <= 1.25 and same):
        raise RuntimeError(f"{tag}: the bf16_3x kernel misses its rule")
    return r


# launches of each fused-core kernel a phase-3 case in a row, each held
# bit for bit to the first: a race on the ring's or the self slot's reuse
# would show as a result that differs or a launch that fails
STRESS_LAUNCHES = 200


def reruns_differ(fn, want: torch.Tensor) -> int:
    """fn() STRESS_LAUNCHES times, back to back; how many results are not
    bit-identical to `want` (a launch that fails raises)."""
    bits = want.view(torch.int32)
    bad = torch.zeros((), dtype=torch.int64, device=want.device)
    for _ in range(STRESS_LAUNCHES):
        bad += (fn().view(torch.int32) != bits).any()
    torch.cuda.synchronize()
    return int(bad)


def check_kernels(cb, dev, card: str) -> dict:
    """Phase 3: both kernels in both modes. accurate=True (bf16_3x) under
    `bf16x3_gate` against its plain version and the float32 plain version
    computed in float64; accurate=False (one bf16 pass a product) under
    `onepass_gate` against the same float64 function; reruns
    bit-identical in both modes (and over STRESS_LAUNCHES launches a mode
    and case), the first case of each kernel timed in
    both modes (accurate=True also by CUDA-graph replay) with its share
    of the bf16 bound (three passes a product with accurate=True). Returns
    {name: record}, the one-pass mode's under name + "_onepass"."""
    for accurate in (False, True):
        occ = cb.occupancy(accurate)
        log(f"{'bf16_3x' if accurate else 'one-pass'} core kernels: "
            f"{occ['smem_bytes']} bytes of shared memory a block of "
            f"{occ['threads']} threads; resident blocks an SM: stack "
            f"{occ['stack_blocks_per_sm']}, block "
            f"{occ['block_blocks_per_sm']}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    for name, b, r, p, lk in KERNEL_CASES:
        stack = name == "fused_core_stack"
        nb = NB if stack else 1
        a = core_inputs(gen, b, r, nb, dev, p, lk)
        # the kernels read bf16 copies packed once, as
        # models/mega.py::mega_weights packs them once a run
        ws = a["ws"] if stack else {key: val[0].contiguous()
                                    for key, val in a["ws"].items()}
        packs = {False: cb.pack_core_weights(ws),
                 True: cb.pack_core_weights_3x(ws)}
        # and K and V rounded, or split, once, as mega_cross_kv does
        kvs = {acc: cb.kv_operands(a["k"], a["v"], acc)
               for acc in (False, True)}
        if stack:
            args = (a["x"], a["mods"], a["k"], a["v"], a["ws"], a["lift_w"],
                    a["lift_b"], a["pos_emb"], a["on_scale"], a["on_bias"],
                    a["head_w"], a["head_b"])
            wrapper, plain_fn = cb.fused_core_stack, cb.fused_core_stack_plain
            out_bytes = a["x"].numel() * 4
        else:
            args = (a["x3"], a["mods"][:, :6].contiguous(), a["k"], a["v"],
                    ws)
            wrapper, plain_fn = cb.fused_core_block, cb.fused_core_block_plain
            out_bytes = a["x3"].numel() * 4
        plain3_fn, onepass_fn = (cb.plain_versions(True)[1 - stack],
                                 cb.plain_versions(False)[1 - stack])
        ins = [t for arg in args for t in
               (arg.values() if isinstance(arg, dict) else [arg])]
        kernel = lambda acc: wrapper(*args, p=p, chunk=r, accurate=acc,
                                     packed=packs[acc], kv=kvs[acc])
        plain3 = lambda: plain3_fn(*args, p=p)
        onepass_plain = lambda: onepass_fn(*args, p=p)
        tag = f"{name} B={b} R={r} P={p} Lk={lk}"
        with torch.no_grad():
            got, again = kernel(True), kernel(True)
            one, one_again = kernel(False), kernel(False)
            torch.cuda.synchronize()
            want3, want_one = plain3(), onepass_plain()
            want3_64 = plain3_fn(*_double(args), p=p)
            exact = plain_fn(*_double(args), p=p)
            torch.cuda.synchronize()
        same = torch.equal(got, again) and torch.equal(one, one_again)
        log(f"{tag}: reruns bit-identical in both modes: {same}")
        if not same:
            raise RuntimeError(f"{tag}: a rerun differs")
        with torch.no_grad():
            differ = {mode: reruns_differ(lambda: kernel(acc), want)
                      for mode, acc, want in (("bf16_3x", True, got),
                                              ("one-pass", False, one))}
        log(f"{tag}: {STRESS_LAUNCHES} more launches a mode, results not "
            f"bit-identical to the first: {differ}")
        if any(differ.values()):
            raise RuntimeError(f"{tag}: a rerun differs")
        gate3 = bf16x3_gate(tag, got, want3, want3_64, exact)
        gate = onepass_gate(tag, one, want_one, exact, stack,
                            same_fn=False)
        rows = b * r * p
        flops = nb * rows * 2 * D * (14 * D + 2 * p + 2 * lk)
        nbytes = sum(t.numel() * 4 for t in ins) + out_bytes
        entry = results.setdefault(name, {})
        for key, val in gate3.items():
            entry[key] = max(entry.get(key, 0.0), val)
        entry1 = results.setdefault(name + "_onepass", {"max_abs_err": 0.0})
        for key, val in gate.items():
            entry1[key] = max(entry1.get(key, 0.0), val)
        if r == KERNEL_CASES[0][2]:
            with torch.no_grad():
                ms = time_ms(lambda: kernel(True))
                dev_ms = graph_ms(lambda: kernel(True), launches=5)
                ms1 = time_ms(lambda: kernel(False))
                plain_ms = time_ms(plain3, reps=3)
                plain1_ms = time_ms(onepass_plain, reps=3)
            # three bf16 passes a product at the bf16 rate; the fp32
            # pipe's time for the function's own operations beside it
            bd = bound(3 * flops, nbytes, tc_rate=PEAK_BF16_FLOPS)
            bd["bound_fp32_ms"] = bound(flops, nbytes)["bound_fp32_ms"]
            bd1 = bound(flops, nbytes, tc_rate=PEAK_BF16_FLOPS)
            common = dict(flops=flops, bytes=nbytes, shape=f"B={b} R={r}")
            entry.update(ms=ms, graph_ms=dev_ms, plain_ms=plain_ms, **bd,
                         **common, tflops=flops / ms / 1e9,
                         bound_share=bd["bound_ms"] / ms)
            entry1.update(ms=ms1, plain_ms=plain1_ms, **bd1, **common,
                          tflops=flops / ms1 / 1e9,
                          bound_share=bd1["bound_ms"] / ms1)
            log(f"{tag}: accurate=True (bf16_3x) kernel {ms:.3f} ms by "
                f"events, {dev_ms:.3f} by graph replay, plain bf16_3x "
                f"{plain_ms:.3f} ms, bound {bd['bound_ms']:.4f} ms at the "
                f"bf16 rate, three passes ({bd['bound_by']}), achieved "
                f"{flops / ms / 1e9:.2f} TFLOP/s of the function's "
                f"operations ({3 * flops / ms / 1e9:.2f} in passes), "
                f"{100 * bd['bound_ms'] / ms:.1f} % of the bound; {card}")
            log(f"{tag}: accurate=False (one pass) kernel {ms1:.3f} ms, "
                f"plain one-pass {plain1_ms:.3f} ms, bound "
                f"{bd1['bound_ms']:.4f} ms at the bf16 rate "
                f"({bd1['bound_by']}), achieved {flops / ms1 / 1e9:.2f} "
                f"TFLOP/s, {100 * bd1['bound_ms'] / ms1:.1f} % of the bound,"
                f" {ms / ms1:.3f}x the bf16_3x kernel's speed; {card}")
    return results


def check_slab(sa, dev) -> dict:
    """Phase 6: the 3xTF32 slab kernels against their plain version,
    timed; `slab_attention(accurate=True)` on them (forward and backward,
    one launch each, no one-pass launch)."""
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
        sa.reset_launches()
        z = qkv.detach().requires_grad_(True)
        out = sa.slab_attention(z, nh, accurate=True)
        out.backward(do)
        accurate = dict(_Counts(sa).launches)
        same = [torch.equal(out.detach(), got), torch.equal(z.grad, dgot)]
        log(f"slab_attention(accurate=True) B={b} L={l} C={c} H={nh}: "
            f"launches {accurate}; out and dqkv those of the 3xTF32 "
            f"kernels bit for bit: {same}")
        if accurate != {"slab_attention_fwd": 1, "slab_attention_bwd": 1,
                        "slab_attention_fwd_onepass": 0,
                        "slab_attention_bwd_onepass": 0} or not all(same):
            raise RuntimeError("slab_attention(accurate=True) did not run "
                               "the 3xTF32 kernels alone")
        for name in ("slab_attention_fwd", "slab_attention_bwd"):
            results[name]["launches"] = accurate[name]

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


def check_slab_onepass(sa, dev, card: str) -> dict:
    """Phase 6: the one-pass slab kernels on float32 slabs at
    SLAB_ONEPASS_CASES, each under `onepass_gate` against the float32
    function computed in float64 (the plain one-pass version setting the
    rms yardstick), reruns bit-identical; the first case timed (CUDA
    events, and a CUDA graph's replay for the device time) beside the
    3xTF32 kernels, the plain one-pass version and one float32
    F.scaled_dot_product_attention call on laid-out (B, H, L, dh)
    operands (the yardstick), with the bound at 4 bytes a value and the
    bf16 tensor cores' rate."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    results = {}
    for b, l, c, nh in SLAB_ONEPASS_CASES:
        dh = c // nh
        if sa.slab_route(b, l, c, nh, dev) != "kernel":
            raise RuntimeError(f"slab route of {(b, l, c, nh)} is not the "
                               f"kernel")
        qkv = torch.randn(b, l, 3 * c, generator=gen, device=dev)
        do = torch.randn(b, l, c, generator=gen, device=dev)
        got = sa.slab_attention_fwd_onepass(qkv, nh)
        dgot = sa.slab_attention_bwd_onepass(qkv, do, nh)
        torch.cuda.synchronize()
        shape = f"B={b} L={l} C={c} H={nh}"
        pairs = (("slab_attention_fwd_onepass", got,
                  sa.reference_slab_attention_onepass(qkv, nh),
                  sa.reference_slab_attention(qkv.double(), nh)),
                 ("slab_attention_bwd_onepass", dgot,
                  sa.reference_slab_attention_onepass_backward(qkv, do, nh),
                  sa.reference_slab_attention_backward(
                      qkv.double(), do.double(), nh)))
        for name, g, onepass, exact in pairs:
            if g.dtype != torch.float32:
                raise RuntimeError(f"{name} {shape}: {g.dtype}")
            gate = onepass_gate(f"{name} {shape}", g, onepass, exact,
                                stack=False)
            entry = results.setdefault(name, {})
            for key, val in gate.items():
                entry[key] = max(entry.get(key, 0.0), val)
        same = [torch.equal(sa.slab_attention_fwd_onepass(qkv, nh), got),
                torch.equal(sa.slab_attention_bwd_onepass(qkv, do, nh),
                            dgot)]
        log(f"slab one-pass {shape}: reruns bit-identical (out, dqkv) "
            f"{same}")
        if not all(same):
            raise RuntimeError(f"slab one-pass {shape}: reruns differ")
        if (b, l, c, nh) != SLAB_ONEPASS_CASES[0]:
            continue

        def backward_of(fn):
            z = qkv.detach().requires_grad_(True)
            out = fn(z)
            return lambda: torch.autograd.grad(out, z, do,
                                               retain_graph=True)

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
            return sa.slab_attention_fwd_onepass(qkv, nh)

        def kern_bwd():
            return sa.slab_attention_bwd_onepass(qkv, do, nh)

        with torch.no_grad():
            fwd_ms = time_ms(kern_fwd)
            fwd_tf32 = time_ms(lambda: sa.slab_attention_fwd(qkv, nh))
            fwd_plain = time_ms(lambda: sa.reference_slab_attention_onepass(
                qkv, nh))
            fwd_lib = time_ms(sdpa_fwd)
        bwd_ms = time_ms(kern_bwd)
        bwd_tf32 = time_ms(lambda: sa.slab_attention_bwd(qkv, do, nh))
        bwd_plain = time_ms(
            lambda: sa.reference_slab_attention_onepass_backward(qkv, do, nh))
        bwd_lib = time_ms(sdpa_bwd)
        # device time without the host: CUDA graphs of 20 calls (not
        # main-path launches)
        counts = dict(sa.launches_onepass)
        graph = {"fwd": graph_ms(kern_fwd), "bwd": graph_ms(kern_bwd)}
        sa.launches_onepass.update(counts)
        for key, fn, st in (("fwd_lib", sdpa_fwd, None),
                            ("bwd_lib", sdpa_bwd, lib_stream)):
            try:
                graph[key] = graph_ms(fn, stream=st)
            except RuntimeError as exc:     # a yardstick, not a check
                log(f"SDPA float32 {key}: no CUDA-graph time ({exc})")
                graph[key] = None
        prod = b * nh * l * l * dh
        io = {"fwd": 4 * (b * l * 3 * c + b * l * c),
              "bwd": 4 * (2 * b * l * 3 * c + b * l * c)}
        for name, key, flops, nbytes, ms, tf32_ms, plain_ms, lib_ms in (
                ("slab_attention_fwd_onepass", "fwd", 4 * prod, io["fwd"],
                 fwd_ms, fwd_tf32, fwd_plain, fwd_lib),
                ("slab_attention_bwd_onepass", "bwd", 10 * prod, io["bwd"],
                 bwd_ms, bwd_tf32, bwd_plain, bwd_lib)):
            bd = bound(flops, nbytes, tc_rate=PEAK_BF16_FLOPS)
            dev_ms, lib_dev = graph[key], graph[key + "_lib"]
            results[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 tf32x3_kernel_ms=tf32_ms, graph_ms=dev_ms,
                                 library_graph_ms=lib_dev, **bd,
                                 shape=f"B={b} L={l} C={c} H={nh}")
            lib_text = "not measured" if lib_dev is None else \
                f"{lib_dev:.4f} ms"
            log(f"{name} B={b} L={l} C={c} H={nh}: kernel {ms:.4f} ms "
                f"(graph replay {dev_ms:.4f}), the 3xTF32 kernel(s) "
                f"{tf32_ms:.4f} ms, plain one-pass {plain_ms:.4f} ms, one "
                f"float32 SDPA call on laid-out operands {lib_ms:.4f} ms "
                f"(graph replay {lib_text}), bound {bd['bound_ms']:.4f} ms "
                f"({bd['bound_by']}: {flops:.3e} flops at 989 TFLOP/s, "
                f"{nbytes:.3e} bytes), {100 * bd['bound_ms'] / ms:.1f} % of "
                f"the bound by events, {100 * bd['bound_ms'] / dev_ms:.1f} % "
                f"by the graph, {nbytes / dev_ms / 1e6:.1f} GB/s; {card}")
        log("slab one-pass forward's kernel, profiler device time a call: "
            + kernel_names(kern_fwd))
        log("slab one-pass backward's kernel, profiler device time a call: "
            + kernel_names(kern_bwd))
        log("SDPA float32 forward / backward on laid-out operands (profiler "
            "kernel names, device time): " + kernel_names(sdpa_fwd) + " / "
            + kernel_names(sdpa_bwd))
        log(f"one-pass kernels' launch plan at L={l}, dh={dh}: "
            f"{sa.bf16_plan(l, dh)}")
    return results


def check_ensemble(ea, dev, card: str) -> dict:
    """Phase 8: the one-pass ensemble kernels at SELF_CASES and
    CROSS_CASES, in float32 and in bf16, q, k and v chunks of one fused
    projection as the model passes them: each under `onepass_gate`
    against the float32 function computed in float64 (the plain one-pass
    version setting the rms yardstick), its output in the input's dtype,
    reruns bit-identical; the first case of each kernel and dtype timed
    (CUDA events over back-to-back wrapper calls, which the host's ~40 us
    a call can set; CUDA-graph replay and profiler device time; every
    kernel the profiler records is the one-pass kernel, at most one a
    call) beside the plain one-pass version, the float32 plain version
    and one-head SDPA in the same dtype, with the share of the bound at 4
    or 2 bytes a value.
    Returns {name: record}, the bf16 ones under name + "_bf16"."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    results = {}
    cases = ([("block_self_attention", c) for c in SELF_CASES]
             + [("folded_cross_attention", c) for c in CROSS_CASES])
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        size = torch.finfo(dtype).bits // 8
        for name, case in cases:
            if name == "block_self_attention":
                n, p, d = case
                if not ea.block_self_ok(n, p, d):
                    raise RuntimeError(f"self gate refuses {case}")
                q, k, v = torch.randn(n, p, 3 * d, generator=gen,
                                      device=dev).to(dtype).chunk(3, dim=-1)
                kernel = lambda: ea.block_self_attention_fwd(q, k, v)
                flops, nbytes = 4 * n * p * p * d, size * 4 * n * p * d
                shape = f"N={n} P={p} D={d}"
            else:
                b, lq, lk, d = case
                if not ea.folded_cross_ok(b, lq, lk, d):
                    raise RuntimeError(f"cross gate refuses {case}")
                q = torch.randn(b, lq, d, generator=gen,
                                device=dev).to(dtype)
                k, v = torch.randn(b, lk, 2 * d, generator=gen,
                                   device=dev).to(dtype).chunk(2, dim=-1)
                kernel = lambda: ea.folded_cross_attention_fwd(q, k, v)
                flops = 4 * b * lq * lk * d
                nbytes = size * (2 * b * lq * d + 2 * b * lk * d)
                shape = f"B={b} Lq={lq} Lk={lk} D={d}"
            tag = f"{name}{suffix} {shape}"
            onepass = lambda: ea.reference_attention_onepass(q, k, v)
            with torch.no_grad():
                got = kernel()
                again = kernel()
                torch.cuda.synchronize()
                want = onepass()
                exact = ea.reference_attention(q.double(), k.double(),
                                               v.double())
                torch.cuda.synchronize()
            same = torch.equal(got, again)
            log(f"{tag}: output {got.dtype}, rerun bit-identical: {same}")
            if got.dtype != dtype or not same:
                raise RuntimeError(f"{tag}: wrong dtype or a rerun differs")
            gate = onepass_gate(tag, got, want, exact, stack=False)
            entry = results.setdefault(name + suffix, {})
            for key, val in gate.items():
                entry[key] = max(entry.get(key, 0.0), val)
            if case not in (SELF_CASES[0], CROSS_CASES[0]):
                continue
            sdpa = lambda: F.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None])[:, 0]
            which = ENSEMBLE_KERNELS[name != "block_self_attention"]
            with torch.no_grad():
                lib_err = float((sdpa().double() - exact).abs().max())
                ms = time_ms(kernel)
                plain_ms = time_ms(onepass)
                plain32_ms = time_ms(lambda: ea.reference_attention(q, k, v))
                lib_ms = time_ms(sdpa)
                dev_graph_ms = graph_ms(kernel)
                lib_graph_ms = graph_ms(sdpa)
                records, _ = kernel_records(lambda: [kernel()
                                                     for _ in range(10)])
                dev_ms = sum(e.time_range.elapsed_us()
                             for e in records) / 10e3
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    kernel()
                host_us = (time.perf_counter() - t0) / 20 * 1e6
                torch.cuda.synchronize()
            others = sorted({e.name[:80] for e in records
                             if which not in e.name})
            log(f"{tag}: {len(records)} kernel records over 10 wrapper "
                f"calls, other kernels: {others or 'none'}")
            if not records or len(records) > 10 or others:
                raise RuntimeError(f"{tag}: a wrapper call launched more "
                                   f"than its kernel")
            bd = bound(flops, nbytes, tc_rate=PEAK_BF16_FLOPS)
            entry.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bd,
                         shape=shape, tflops=flops / ms / 1e9,
                         graph_ms=dev_graph_ms,
                         library_graph_ms=lib_graph_ms,
                         bound_share=bd["bound_ms"] / dev_graph_ms)
            log(f"{tag}: kernel {ms:.4f} ms by events, {dev_graph_ms:.4f} "
                f"ms of device time (CUDA-graph replay; profiler "
                f"{dev_ms:.4f}), plain one-pass {plain_ms:.4f} ms, float32 "
                f"plain {plain32_ms:.4f} ms, SDPA in {str(dtype)[6:]} "
                f"{lib_ms:.4f} ms by events, {lib_graph_ms:.4f} device (max "
                f"error vs float64 {lib_err:.2e}), "
                f"{bound_text(bd, flops, nbytes)}, device time "
                f"{100 * bd['bound_ms'] / dev_graph_ms:.1f} % of the bound, "
                f"{flops / dev_graph_ms / 1e9:.2f} TFLOP/s; host time "
                f"{host_us:.1f} us a wrapper call; {card}")
    return results


def set_ensemble_pallas(model, on: bool) -> None:
    for blk in model.blocks:
        blk.ensemble_pallas = on


def check_serving(ea, cb, dev, card) -> int:
    """Phase 9: the guided v-model on the per-block path, every sampler,
    each run's ensemble moments against ensemble_pallas=False; one
    denoiser call under phase 8's one-pass rule; returns the ensemble
    kernels' launches over its kernel-path runs."""
    from ertdx_torch import configs, sample
    from ertdx_torch.configs import SampleConfig
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.models import build_model
    from ertdx_torch.models import condunet as condunet_mod
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
        log(f"{tag}: {calls} denoiser calls, launches {counts}; kernel path "
            f"{run_s:.3f} s ({run_s / calls * 1e3:.3f} ms per denoiser "
            f"call), plain path {plain_s:.3f} s ({plain_s / calls * 1e3:.3f} "
            f"ms per call; {card})")
        moments_gap(f"{tag}, one-pass kernels vs ensemble_pallas=False", u,
                    u_plain)

    with torch.no_grad():
        ctx = model.encode_condition(cond[:b])
        t_mid = torch.full((b * r,), big_t // 2, device=dev)
        call = lambda: model.denoise_ensemble(x_T, t_mid, ctx, r)
        ea.reset_launches()
        got = call()
        launched = dict(ea.launches)
        set_ensemble_pallas(model, False)
        exact = call()
        set_ensemble_pallas(model, True)
        patched = {name: getattr(condunet_mod, name)
                   for name in ("block_self_attention",
                                "folded_cross_attention")}
        try:
            for name in patched:
                setattr(condunet_mod, name,
                        lambda q, k, v, **_: ea.reference_attention_onepass(
                            q, k, v))
            onepass = call()
        finally:
            for name, fn in patched.items():
                setattr(condunet_mod, name, fn)
        torch.cuda.synchronize()
        if launched != {name: nb for name in ea.launches}:
            raise RuntimeError(f"(e) the denoiser call launched {launched}")
        onepass_gate("(e) one denoiser call (t = T/2) against the float32 "
                     "plain path", got, onepass, exact, stack=False,
                     same_fn=False)
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


def _moved_entries(a, b, ga, gb) -> str:
    """Which entries two trained copies hold more than 1e-5 apart: their
    count, how many had step-1 gradients of opposite signs on the two
    paths, and the largest |step-1 gradient| of the others (on either
    path) relative to its leaf's largest. Adam moves an entry about lr a
    step whatever its gradient's size: a step-1 sign flip parts the two
    copies by 2 lr at once, and the others part at a later step, where
    the paths' weights already differ and an entry's Adam direction
    rests on every gradient so far, so their step-1 gradients do not say
    why they parted (logged, gated by their share alone)."""
    n = flipped = 0
    rest = 0.0
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        far = (pa.detach() - pb.detach()).abs() > 1e-5
        flip = far & (torch.sign(ga[name]) != torch.sign(gb[name]))
        n += int(far.sum())
        flipped += int(flip.sum())
        later = far & ~flip
        if later.any():
            top = max(float(gb[name].abs().max()), 1e-30)
            rest = max(rest, float(torch.maximum(
                ga[name][later].abs(), gb[name][later].abs()).max()) / top)
    return (f"{n} entries > 1e-5 apart, {flipped} of them with step-1 "
            f"gradients of opposite signs, the other {n - flipped} at most "
            f"{rest:.1e} of their leaf's largest |step-1 gradient|")


def step1_flips(ga, gb) -> tuple:
    """The entries whose step-1 gradients on two paths have opposite
    signs (or one is 0): how many, and the largest |gradient| there, on
    either path, relative to its leaf's largest on either path (0 where
    there are none). Both paths start from the same weights on the same
    batch, so step 1's rounding alone decides these, and a flip is a
    gradient difference at least as large as the entry: the flip level
    is a function of step 1 only, as the step-1 gradient gate is."""
    n, worst = 0, 0.0
    for name, g in gb.items():
        flip = torch.sign(ga[name]) != torch.sign(g)
        if flip.any():
            n += int(flip.sum())
            top = max(float(g.abs().max()), float(ga[name].abs().max()))
            worst = max(worst, float(torch.maximum(
                ga[name][flip].abs(), g[flip].abs()).max()) / top)
    return n, worst


def graft_steps(label, grafted, kernel, plain, kg, pg, kl, pl, run,
                tol: float, flip_tol: float = 1e-5) -> list:
    """Train `grafted` (an untrained copy of the plain model) with the
    kernel path's step-1 gradient `kg` at the entries that `kernel` and
    `plain` end more than 1e-5 apart, its own everywhere else; log the
    loss gaps a step against both paths. Fails unless the entries whose
    step-1 gradients the two paths give opposite signs are rounding
    noise (at most `flip_tol` of their leaf's largest on either path: see
    step1_flips and compare_bf16_train_paths) and the grafted path's
    loss stays within `tol` x max(1, loss) of the kernel path's at every
    step: apart from them the kernel path trains as the plain one-pass
    path does. Returns what failed, one line a gate (empty: none)."""
    moved = {name: (a.detach() - b.detach()).abs() > 1e-5
             for (name, a), b in zip(kernel.named_parameters(),
                                     plain.parameters())}
    moved = {name: m for name, m in moved.items() if m.any()}
    done, hooks = set(), []
    for name, prm in grafted.named_parameters():
        if name in moved:
            def hook(g, _n=name):
                if _n in done:
                    return None
                done.add(_n)
                return torch.where(moved[_n], kg[_n], g)
            hooks.append(prm.register_hook(hook))
    try:
        gl = run(grafted)[0]
    finally:
        for h in hooks:
            h.remove()
    n = sum(int(m.sum()) for m in moved.values())

    def gaps(a, b):
        return "[" + ", ".join(f"{abs(x - y):.2e}" for x, y in zip(a, b)) \
            + "]"
    flips, level = step1_flips(kg, pg)
    log(f"{label}: loss gaps a step, kernel vs plain {gaps(kl, pl)}; the "
        f"plain path with the kernel path's step-1 gradient at the {n} "
        f"entries they end > 1e-5 apart (of "
        f"{sum(p.numel() for p in plain.parameters())}) vs plain "
        f"{gaps(gl, pl)}, vs kernel {gaps(gl, kl)} (tol {tol:.1e} x "
        f"max(1, loss)); step-1 sign flips {flips}, at most {level:.2e} of "
        f"their leaf's largest |step-1 gradient| (gate {flip_tol:.2e})")
    failed = []
    if level > flip_tol:
        failed.append(f"{label}: the kernel path's step-1 gradient flips "
                      f"sign at entries up to {level:.2e} of their leaf's "
                      f"largest, more than rounding noise ({flip_tol:.2e})")
    if any(abs(a - c) > tol * max(1.0, abs(c)) for a, c in zip(gl, kl)):
        failed.append(f"{label}: the plain path grafted with the kernel "
                      f"path's step-1 gradient at the entries they end apart "
                      f"does not train as the kernel path does")
    return failed


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
                 ("ensemble attention (this port)",
                  ("block_self_onepass_kernel",
                   "folded_cross_onepass_kernel")),
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


def onepass_plain_slab(second: bool = False):
    """The plain one-pass slab (`SlabOnepassPlain`) as a model's plain slab
    (models/condunet.py's `reference_slab_attention`); with `second` the
    same function computed again, in float64 from the same float32 slab
    (other sums, the same rounding points), the spread of two plain
    one-pass computations."""
    from ertdx_torch.ops import slab_attn as sa
    if second:
        return lambda qkv, nh: sa.SlabOnepassPlain.apply(
            qkv.double(), nh).to(qkv.dtype)
    return lambda qkv, nh: sa.SlabOnepassPlain.apply(qkv, nh)


def onepass_plain_conv(second: bool = False):
    """The plain one-pass fused conv (`GNSiLUConv3OnepassPlain`) as a
    model's plain fused conv (models/condunet.py's
    `reference_gn_silu_conv3`); with `second` the same function computed
    again in float64 from the same float32 inputs (the same rounding
    points, other sums): the spread of two plain one-pass computations."""
    from ertdx_torch.ops import conv as cv
    if second:
        return lambda x, *a: cv.GNSiLUConv3OnepassPlain.apply(
            x.double(), *[t.double() for t in a[:4]], *a[4:]).to(x.dtype)
    return cv.GNSiLUConv3OnepassPlain.apply


LOG2E = 1.4426950408889634


def kernel_order_probs(q, k, scale):
    """ops/slab_attn.py's `_onepass_probs` (JAX's normalised P at DEFAULT)
    in the one-pass slab kernels' float32 arithmetic
    (csrc/slab_attn_bf16.cu, `RowStats` and `attend`): the logits times
    f = scale log2(e) (at a power-of-two scale the raw product times f,
    else S times log2(e)), the row's base-2 log-sum-exp lse = max +
    log2(sum 2^(s f - max)), and P = 2^(s f - lse) with the difference
    rounded once, as the kernels' fma; an exact exp2 where they use
    ex2.approx. The same function, other float32 roundings."""
    from ertdx_torch.ops.core_block import mm_onepass
    s = mm_onepass(q * scale, k.transpose(-1, -2))
    sc = float(scale)
    if math.frexp(sc)[0] == 0.5:                # a power of two
        raw, f = s / sc, torch.tensor(sc * LOG2E, dtype=torch.float32)
    else:
        raw, f = s, torch.tensor(LOG2E, dtype=torch.float32)
    t = raw * f.to(raw.device)
    mx = t.amax(dim=-1, keepdim=True)
    lse = mx + torch.log2(torch.exp2(t - mx).sum(dim=-1, keepdim=True))
    return torch.exp2((raw.double() * float(f) - lse.double()).float())


class _patched:
    """Within it `module`.`name` is `value`."""

    def __init__(self, module, name: str, value):
        self.module, self.name, self.value = module, name, value

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def kernel_order_softmax():
    """Within it the plain one-pass slab, forward and backward, takes its
    probabilities from `kernel_order_probs`."""
    from ertdx_torch.ops import slab_attn as sa
    return _patched(sa, "_onepass_probs", kernel_order_probs)


def _slab_keys_reversed(qkv, nh):
    """The plain one-pass slab with the keys (and values) in reverse
    order: the same function, the softmax's and P V's float32 sums in
    another order."""
    from ertdx_torch.ops import slab_attn as sa
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    return sa.SlabOnepassPlain.apply(
        torch.cat([q, k.flip(1), v.flip(1)], dim=-1), nh)


def _slab_dh_reversed(qkv, nh):
    """The plain one-pass slab with q's and k's channels of each head in
    reverse order: the same function, S's float32 sums in another
    order."""
    from ertdx_torch.ops import slab_attn as sa
    b, l, c3 = qkv.shape
    q, k, v = qkv.split(c3 // 3, dim=-1)

    def rev(z):
        return z.reshape(b, l, nh, -1).flip(-1).reshape(b, l, c3 // 3)
    return sa.SlabOnepassPlain.apply(torch.cat([rev(q), rev(k), v],
                                               dim=-1), nh)


def slab_sum_orders() -> dict:
    """Phase 7 (a)'s probes: plain one-pass slabs that compute the same
    function with other float32 roundings, each a context for a copy of
    the plain model (its spread is logged, and sets no tolerance)."""
    from ertdx_torch.models import condunet as condunet_mod
    return {"the plain one-pass slab in the kernels' arithmetic":
            kernel_order_softmax,
            "the plain one-pass slab, keys reversed":
            lambda: _patched(condunet_mod, "reference_slab_attention",
                             _slab_keys_reversed),
            "the plain one-pass slab, head channels reversed":
            lambda: _patched(condunet_mod, "reference_slab_attention",
                             _slab_dh_reversed)}


def slab_step_inputs(train, model, batch, alpha_bar, lr) -> tuple:
    """The float32 slab's input and incoming gradient in one train step of
    a copy of `model` (its plain one-pass slab): (qkv, dO, heads)."""
    from ertdx_torch.models import condunet as condunet_mod
    from ertdx_torch.ops import slab_attn as sa
    rec = {}

    class Capture(torch.autograd.Function):
        @staticmethod
        def forward(ctx, qkv, nh):
            rec["qkv"], rec["nh"], ctx.nh = qkv.detach().clone(), nh, nh
            ctx.save_for_backward(qkv)
            return sa.reference_slab_attention_onepass(qkv, nh)

        @staticmethod
        def backward(ctx, do):
            rec["do"] = do.detach().clone()
            qkv, = ctx.saved_tensors
            return sa.reference_slab_attention_onepass_backward(
                qkv, do, ctx.nh), None

    m = copy.deepcopy(model)
    saved = condunet_mod.reference_slab_attention
    condunet_mod.reference_slab_attention = Capture.apply
    try:
        x0, cond, t, noise = batch
        train.train_step(m, train.create_optimizer(m, lr), x0, cond, t,
                         noise, alpha_bar=alpha_bar, lr=lr)
    finally:
        condunet_mod.reference_slab_attention = saved
    return rec["qkv"], rec["do"], rec["nh"]


def kernel_probs(sa, qkv, nh) -> tuple:
    """bf16(P) of the one-pass slab kernels on a float32 slab, read out
    exactly: the forward's through a one-hot v (o[i, c] = bf16(P[i, j dh
    + c]) times 1, summed with zeros), the backward's through a one-hot dO
    (dV[key, c] = bf16(P[j dh + c, key]) times 1), dh keys (queries) a
    call. P depends on q and k alone, so it is the slab's. (B, H, L, L)
    each."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    dh = c // nh
    fwd = torch.zeros(b, nh, l, l, device=qkv.device)
    bwd = torch.zeros_like(fwd)
    for j0 in range(0, l, dh):
        w = min(dh, l - j0)
        hot = torch.zeros(l, dh, device=qkv.device)
        hot[j0 + torch.arange(w), torch.arange(w)] = 1.0
        hot = hot[None, :, None, :].expand(b, l, nh, dh).reshape(b, l, c)
        z = qkv.clone()
        z[..., 2 * c:] = hot
        o = sa.slab_attention_fwd_onepass(z, nh)
        fwd[..., j0:j0 + w] = o.reshape(b, l, nh, dh).permute(
            0, 2, 1, 3)[..., :w]
        dz = sa.slab_attention_bwd_onepass(qkv, hot.contiguous(), nh)
        bwd[:, :, j0:j0 + w, :] = dz[..., 2 * c:].reshape(
            b, l, nh, dh).permute(0, 2, 3, 1)[:, :, :w, :]
    return fwd, bwd


def check_slab_flips(sa, qkv, do, nh) -> dict:
    """Phase 7 (a)'s reading of the one-pass slab on the first train
    step's slab: where bf16(P) of the kernels (forward and backward, by
    `kernel_probs`), of the plain one-pass version in float64 and of the
    plain one-pass version in the kernels' arithmetic
    (`kernel_order_probs`) differ from the plain one-pass version's in
    float32. Every difference of the kernels' must be one bf16 ulp at a
    near-tie (P, in float64, within 2^-14 of the midpoint of the two
    values, relative), that is a rounding that float32 noise decides, not
    another rounding point. Logs the shares of flipped entries and the
    rms gaps of the outputs and dQKV; raises where a kernel's difference
    is not such a flip."""
    from ertdx_torch.ops.core_block import round_bf16
    with torch.no_grad():
        q, k, _, scale = sa._onepass_heads(qkv, nh)
        p32 = round_bf16(sa._onepass_probs(q, k, scale))
        q64, k64, _, scale64 = sa._onepass_heads(qkv.double(), nh)
        exact = sa._onepass_probs(q64, k64, scale64)
        p64 = round_bf16(exact).float()
        pko = round_bf16(kernel_order_probs(q, k, scale))
        pk_fwd, pk_bwd = kernel_probs(sa, qkv, nh)
        torch.cuda.synchronize()
        out = {}
        for tag, p in (("kernel forward", pk_fwd),
                       ("kernel backward", pk_bwd),
                       ("plain in float64", p64),
                       ("plain in the kernels' arithmetic", pko)):
            diff = p != p32
            n = int(diff.sum())
            bits = (p[diff].to(torch.bfloat16).view(torch.int16).int()
                    - p32[diff].to(torch.bfloat16).view(torch.int16).int())
            mid = (p[diff].double() + p32[diff].double()) / 2
            tie = ((exact[diff] - mid).abs() / mid).max() if n else \
                torch.zeros(())
            out[tag] = {"flips": n, "share": n / p.numel(),
                        "max_ulps": int(bits.abs().max()) if n else 0,
                        "max_tie_dist": float(tie)}
            log(f"(a) step 1's slab, bf16(P) of the {tag} against the "
                f"plain one-pass version in float32: {n} of {p.numel()} "
                f"entries differ (share {n / p.numel():.3e}), at most "
                f"{out[tag]['max_ulps']} bf16 ulp apart, the exact P at "
                f"most {out[tag]['max_tie_dist']:.3e} (relative) from the "
                f"midpoint of the two")
        fwd32 = sa.reference_slab_attention_onepass(qkv, nh)
        bwd32 = sa.reference_slab_attention_onepass_backward(qkv, do, nh)
        with kernel_order_softmax():
            fwd_ko = sa.reference_slab_attention_onepass(qkv, nh)
            bwd_ko = sa.reference_slab_attention_onepass_backward(qkv, do,
                                                                  nh)

        def rms(a):
            return float(a.double().square().mean().sqrt())

        for tag, f, g in (
                ("kernels", sa.slab_attention_fwd_onepass(qkv, nh),
                 sa.slab_attention_bwd_onepass(qkv, do, nh)),
                ("plain in float64",
                 sa.reference_slab_attention_onepass(qkv.double(), nh),
                 sa.reference_slab_attention_onepass_backward(
                     qkv.double(), do.double(), nh)),
                ("plain in the kernels' arithmetic", fwd_ko, bwd_ko)):
            out[tag + " rms gaps"] = (rms(f - fwd32), rms(g - bwd32))
            log(f"(a) step 1's slab, the {tag} against the plain one-pass "
                f"version in float32: rms gap of the output "
                f"{rms(f - fwd32):.3e}, of dQKV {rms(g - bwd32):.3e}")
    for tag in ("kernel forward", "kernel backward"):
        if out[tag]["max_ulps"] > 1 or out[tag]["max_tie_dist"] > 2 ** -14:
            raise RuntimeError(f"(a) bf16(P) of the {tag} differs from "
                               f"the plain one-pass version's by more "
                               f"than flipped near-ties: {out[tag]}")
    return out


def check_training(sa, dev, card) -> dict:
    """Phase 7 (a): TRAIN_STEPS b256 steps of the float32 slab arm from
    random non-zero weights on its kernel path (the one-pass slab kernels:
    the model asks for no `accurate`, as JAX's) against the same steps
    with the plain one-pass slab on the card (use_pallas off, the plain
    slab the one-pass Function): phase 7's gates, with phase 15 (b)'s
    spread rule, the spread between two plain one-pass computations (run
    to run, and with float64 sums). The old 1e-5 loss gate breaks by
    bf16 ulps that float32 noise flips: `check_slab_flips` reads the
    kernels' bf16(P) on the first step's slab, requires every difference
    from the plain version's to be such a flip and counts them beside the
    float64 plain version's and those of the plain version in the
    kernels' arithmetic, whose 5 steps are trained too (logged, not in
    the tolerance). Exactly one one-pass forward and backward a step and
    no 3xTF32 launch; ms a step and a profile of one step of each path."""
    from ertdx_torch import configs, train
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.models import build_model
    from ertdx_torch.models import condunet as condunet_mod
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
    # non-zero weights: every projection carries gradient
    params_from_jax(kernel, random_flax_tree(
        flax_shapes(kernel), np.random.default_rng(SEED + 9)))
    plain = plain_attention(kernel)
    saved = condunet_mod.reference_slab_attention
    condunet_mod.reference_slab_attention = onepass_plain_slab()
    try:
        res = compare_bf16_train_paths(
            "float32 slab arm", cfg, kernel, plain, _Counts(sa),
            SLAB_ONEPASS_STEP, SEED + 8, card,
            {"reference_slab_attention": onepass_plain_slab(second=True)},
            "the plain one-pass slab in float64", ulp_floor=False,
            probes=slab_sum_orders(), graft=True)
    finally:
        condunet_mod.reference_slab_attention = saved
    fresh = plain_attention(kernel)
    params_from_jax(fresh, random_flax_tree(
        flax_shapes(fresh), np.random.default_rng(SEED + 9)))
    qkv, do, nh = slab_step_inputs(train, fresh, res["batch"],
                                   res["alpha_bar"], res["lr"])
    res["flips"] = check_slab_flips(sa, qkv, do, nh)
    return res


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
        counts = dict(_Counts(sa).launches)
        steps = res.state.step
        log(f"train(): 2 epochs, {steps} steps in {seconds:.3f} s "
            f"({res.steps_per_sec:.3f} steps/s), best epoch "
            f"{res.best_epoch + 1}, val {res.val_history}; slab launches "
            f"{counts}")
        n_val_batches = -(-int(0.1 * n) // cfg.train.batch_size)
        want = onepass_slab_rule(steps, steps + 2 * n_val_batches)
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
    """Phase 10: the GN kernels, forward and backward, against their plain
    versions (1e-4 x max(1, max|plain|)), reruns bit-identical, the launch
    plan (staged or streamed) at each case, timed at the large shapes and
    their GB/s at every case; then the fused conv (`check_conv`)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 100)
    eps = 1e-5

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    def grad_of(fn, ins, g):
        leaves = [t.detach().requires_grad_(True) for t in ins]
        out = fn(*leaves)
        return lambda: torch.autograd.grad(out, leaves, g,
                                           retain_graph=True)

    results = {}
    names = ("groupnorm_silu_fwd", "groupnorm_silu_bwd")
    for b, l, c, mean in GN_CASES:
        x = rnd(b, l, c, scale=2.0 if mean < 100 else 1.0, shift=mean)
        ins = (x, rnd(c, scale=0.3, shift=1.0), rnd(c, scale=0.3))
        dy = rnd(b, l, c)
        fwd = lambda: gn.groupnorm_silu_fwd(*ins, GROUPS)
        bwd = lambda: gn.groupnorm_silu_bwd(*ins, dy, GROUPS)
        plain = lambda *a: gn.reference_groupnorm_silu(*a, GROUPS)
        lib = lambda xx, ga, be: F.silu(F.group_norm(
            xx.transpose(1, 2), GROUPS, ga, be, eps)).transpose(1, 2)
        n = b * l * c
        # ~10 operations a value forward (two statistics passes,
        # normalise, affine, SiLU), ~30 backward; bytes: x (and dy) read
        # once, y (dx) written once
        work = {names[0]: (10 * n, 4 * (2 * n + 2 * c)),
                names[1]: (30 * n, 4 * (3 * n + 4 * c))}
        shape = f"B={b} L={l} C={c}" + (f" mean {mean:g}" if mean >= 100
                                        else "")
        plans = {name: gn.launch_plan(l, c, GROUPS, k)
                 for name, k in zip(names, ("fwd", "bwd"))}
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
            (names[1], g, a, w)
            for g, a, w in zip(("dx", "dgamma", "dbeta"), dgot, dwant)]
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
        if b < 256:                     # the kernels alone, for GB/s
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
            bd = bound(flops, nbytes, products=False)   # no product
            log(f"{name} {shape} ({plans[name].path}): kernel {ms:.4f} ms "
                f"(profiler device {dev_ms:.4f} ms), plain {plain_ms:.4f} "
                f"ms, library composition {lib_ms:.4f} ms (its forward vs "
                f"plain: max|d| {lib_err:.2e}), "
                f"{bound_text(bd, flops, nbytes)}, "
                f"{nbytes / ms / 1e6:.1f} GB/s, "
                f"{100 * bd['bound_ms'] / ms:.1f} % of the bound; {card}")
            entry = results[name]
            if "ms" not in entry:       # the first large case: the path's
                entry.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                             composition_ms=lib_ms, device_ms=dev_ms, **bd,
                             shape=shape)
    results.update(check_conv(cv, gn, dev, report, card))
    return results


def check_conv(cv, gn, dev, report: str, card: str) -> dict:
    """Phase 10, the fused conv on a float32 x: ptxas' lines of its wgmma
    GEMMs (a spill fails); at CONV_CASES the forward and backward kernels
    (JAX's one-pass function) held to the plain one-pass version by the
    one-pass and the same-function rules (`onepass_gate`) against the
    float32 function computed in float64, db elementwise (1e-4 x max(1,
    max|plain|): a plain sum of the float32 g, no product), reruns
    bit-identical; at B = 256 timed by CUDA events, CUDA-graph replay and
    profiler device time (the backward launch by launch) beside the
    plain one-pass version, the float32 plain version and the unfused
    library composition (F.group_norm + F.silu, + F.conv1d; cuDNN and
    TF32 off; a yardstick only: no single PyTorch call computes the
    function), with TFLOP/s and the share of the bound at 989 TFLOP/s and
    4 bytes a float32 value."""
    import torch.nn.functional as F

    check_no_spill(report, CONV_BF16_KERNELS + ("round_colsum_kernel",))
    gen = torch.Generator(device=dev).manual_seed(SEED + 101)
    names = ("gn_silu_conv3_fwd", "gn_silu_conv3_bwd")
    grads = ("dx", "dgamma", "dbeta", "dW", "db")

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    def lib(xx, ga, be, ww, bb):
        # explicit pad and contiguous weight: with padding=1 cuDNN picked
        # FFT algorithms at L=147 (200 ms a backward)
        h = F.silu(F.group_norm(xx.transpose(1, 2), GROUPS, ga, be, 1e-5))
        return F.conv1d(F.pad(h, (1, 1)), ww.permute(2, 1, 0).contiguous(),
                        bb).transpose(1, 2)

    def grad_of(fn, ins, g):
        leaves = [t.detach().requires_grad_(True) for t in ins]
        out = fn(*leaves)
        return lambda: torch.autograd.grad(out, leaves, g,
                                           retain_graph=True)

    results = {}
    for b, l, c, cout in CONV_CASES:
        x = rnd(b, l, c)
        ins = (x, rnd(c, scale=0.3, shift=1.0), rnd(c, scale=0.3),
               rnd(3, c, cout, scale=1.0 / math.sqrt(3 * c)),
               rnd(cout, scale=0.3))
        dy = rnd(b, l, cout)
        shape = f"B={b} L={l} C={c} Cout={cout}"
        fwd = lambda: cv.gn_silu_conv3_fwd(*ins, GROUPS)
        bwd = lambda: cv.gn_silu_conv3_bwd(*ins[:4], dy, GROUPS)
        onepass_fwd = lambda: cv.reference_gn_silu_conv3_onepass(*ins,
                                                                 GROUPS)
        onepass_bwd = lambda: cv.reference_gn_silu_conv3_onepass_backward(
            *ins, dy, GROUPS)
        plans = {"statistics": gn.launch_plan(l, c, GROUPS, "stats"),
                 "GN backward": gn.launch_plan(l, c, GROUPS, "bwd")}
        log(f"gn_silu_conv3 {shape}: launch plans " + "; ".join(
            f"{name} {p.path} ({p.threads} threads, {p.smem_bytes} bytes "
            "of shared memory)" for name, p in plans.items()))
        with torch.no_grad():
            got, dgot = fwd(), bwd()
            again, dagain = fwd(), bwd()
            torch.cuda.synchronize()
            if not (torch.equal(got, again) and all(
                    torch.equal(a, w) for a, w in zip(dgot, dagain))):
                raise RuntimeError(f"gn_silu_conv3 {shape}: a rerun differs")
            onepass, donepass = onepass_fwd(), onepass_bwd()
        ins64 = [t.double() for t in ins]
        exact = cv.reference_gn_silu_conv3(*ins64, GROUPS)
        dexact = cv.reference_gn_silu_conv3_backward(*ins64, dy.double(),
                                                     GROUPS)
        checks = [(names[0], "y", got, onepass, exact)] + [
            (names[1], g, a, o, e)
            for g, a, o, e in zip(grads, dgot, donepass, dexact)]
        for name, out, a, o, e in checks:
            if (a.shape != o.shape or a.dtype != torch.float32
                    or not torch.isfinite(a).all()):
                raise RuntimeError(f"{name} {shape} {out}: wrong shape, "
                                   "dtype or non-finite")
            entry = results.setdefault(name, {"max_abs_err": 0.0})
            if out == "db":             # a plain float32 sum
                err = float((a - o).abs().max())
                tol = 1e-4 * max(1.0, float(o.abs().max()))
                log(f"{name} {shape} db: max_abs_err={err:.3e} against the "
                    f"plain one-pass version's float32 sum, tol={tol:.3e}")
                if not err <= tol:
                    raise RuntimeError(f"{name} {shape} db: error {err} > "
                                       f"{tol}")
            else:
                gate = onepass_gate(f"{name} {shape} {out}", a, o, e,
                                    stack=False)
                err = gate["max_abs_err"]
                if out in ("y", "dW"):  # the kernels line's, first case
                    for key in ("rms_err_exact", "plain_rms_err_exact",
                                "max_err_exact", "rms_gap_plain"):
                        entry.setdefault(key, gate[key])
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if b < 256:
            continue
        prod = 2 * b * l * 3 * c * cout
        nx, ny, nw = b * l * c, b * l * cout, 3 * c * cout
        # bytes: x (and g) read once, y (dx) written once, 4 a value;
        # the parameters and their gradients
        work = {names[0]: (prod, 4 * (nx + ny + 2 * c + nw + cout)),
                names[1]: (2 * prod, 4 * (nx + ny + nx + 4 * c + 2 * nw
                                          + cout))}
        float32_fwd = lambda: cv.reference_gn_silu_conv3(*ins, GROUPS)
        timed = {names[0]: (fwd, onepass_fwd, float32_fwd,
                            lambda: lib(*ins)),
                 names[1]: (bwd, onepass_bwd,
                            grad_of(lambda *a: cv.reference_gn_silu_conv3(
                                *a, GROUPS), ins, dy),
                            grad_of(lib, ins, dy))}
        for name, (kernel, plain_fn, f32_fn, lib_fn) in timed.items():
            with torch.no_grad() if name == names[0] else \
                    torch.enable_grad():
                ms = time_ms(kernel)
                g_ms = graph_ms(kernel)
                plain_ms = time_ms(plain_fn)
                f32_ms = time_ms(f32_fn)
                lib_ms = time_ms(lib_fn)
                records, _ = kernel_records(
                    lambda: [kernel() for _ in range(10)])
            dev_ms = sum(e.time_range.elapsed_us() for e in records) / 10e3
            flops, nbytes = work[name]
            bd = bound(flops, nbytes, tc_rate=PEAK_BF16_FLOPS)
            log(f"{name} {shape} (float32, one-pass): kernel {ms:.4f} ms by "
                f"events, {g_ms:.4f} ms by CUDA-graph replay (profiler "
                f"device {dev_ms:.4f} ms), plain one-pass {plain_ms:.4f} "
                f"ms, float32 plain {f32_ms:.4f} ms, library composition "
                f"{lib_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
                f"({bd['bound_by']}: {flops:.3e} flops at 989 TFLOP/s, "
                f"{nbytes:.3e} bytes), {flops / g_ms / 1e9:.2f} TFLOP/s and "
                f"{100 * bd['bound_ms'] / g_ms:.1f} % of the bound by graph "
                f"replay ({flops / ms / 1e9:.2f}, "
                f"{100 * bd['bound_ms'] / ms:.1f} % by events); {card}")
            if name == names[1]:
                log(f"{name} {shape}, launch by launch: "
                    + launch_times(kernel))
            entry = results[name]
            if "ms" not in entry:       # the first large case: the path's
                entry.update(ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                             float32_plain_ms=f32_ms, library_ms=None,
                             composition_ms=lib_ms, device_ms=dev_ms, **bd,
                             shape=shape, tflops=flops / g_ms / 1e9)
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
    """The launch counts of several ops modules as one `launches` dict
    (the float32 kernels', the one-pass slab kernels' among them)."""

    def __init__(self, *mods):
        self.mods = mods

    @property
    def launches(self) -> dict:
        return {k: v for mod in self.mods for d in (
            mod.launches, getattr(mod, "launches_onepass", {}))
            for k, v in d.items()}

    def reset_launches(self) -> None:
        for mod in self.mods:
            mod.reset_launches()


class _AllCounts(_Counts):
    """The float32, one-pass and bf16 launch counts of several ops modules
    as one `launches` dict."""

    @property
    def launches(self) -> dict:
        return {k: v for mod in self.mods for d in (
            mod.launches, getattr(mod, "launches_onepass", {}),
            getattr(mod, "launches_bf16", {}))
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
    5 train steps, the plain slab and fused conv on their plain one-pass
    versions (`GNSiLUConv3OnepassPlain`): phase 7's spread and graft
    rules, exactly 2/2/6/6 GN and fused-conv launches and one one-pass
    slab forward and backward a step."""
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
    # the plain path: every kernel off, the slab's and the fused conv's
    # plain versions the plain one-pass ones (the kernel path computes
    # JAX's one-pass functions), so phase 7's spread rule holds their bf16
    # ulps and its graft rule the noise-level entries Adam moves by lr
    plain = copy.deepcopy(kernel)
    set_kernels(plain, False)
    plain.encoder.attn.slab = True
    want = {"groupnorm_silu_fwd": 2, "groupnorm_silu_bwd": 2,
            "gn_silu_conv3_fwd": 6, "gn_silu_conv3_bwd": 6,
            **SLAB_ONEPASS_STEP}
    from ertdx_torch.models import condunet as condunet_mod
    saved = (condunet_mod.reference_slab_attention,
             condunet_mod.reference_gn_silu_conv3)
    condunet_mod.reference_slab_attention = onepass_plain_slab()
    condunet_mod.reference_gn_silu_conv3 = onepass_plain_conv()
    try:
        return compare_bf16_train_paths(
            "fused arm", cfg, kernel, plain, counts, want, SEED + 112, card,
            {"reference_slab_attention": onepass_plain_slab(second=True),
             "reference_gn_silu_conv3": onepass_plain_conv(second=True)},
            "the plain one-pass slab and fused conv in float64",
            ulp_floor=False, graft=True)
    finally:
        (condunet_mod.reference_slab_attention,
         condunet_mod.reference_gn_silu_conv3) = saved


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
                    **onepass_slab_rule(steps, forwards)}

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


def plain_core_run(sample, fn):
    """fn() with `sample.mega_plan` asking for the plain versions of the
    fused core's mode (`mega_denoise_ensemble(plain=True)`) wherever it
    plans the kernels: the same function, no kernel launch."""
    plan_fn = sample.mega_plan

    def plain_plan(*args, **kw):
        plan = plan_fn(*args, **kw)
        return None if plan is None else {**plan, "plain": True}

    sample.mega_plan = plain_plan
    try:
        return fn()
    finally:
        sample.mega_plan = plan_fn


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
    conditions x 1000 members on the fused core in JAX's accurate mode,
    bf16_3x, ensemble_mega_accurate=True) from phase 13's trained
    flash-arm model: one flash forward per call (the condition is encoded
    once), draws within 1e-3 of the all-plain path (the plain attention
    and the plain bf16_3x core); their gap to the float32 module path
    logged."""
    from ertdx_torch import configs, sample, train
    from ertdx_torch.diffusion import schedule_from_config

    cfg = flash_arm_cfg(configs)
    state, _, _ = train.load_best_model(ckdir, cfg, device=dev)
    model = state.model.eval()
    model.ensemble_mega_accurate = True
    plain = plain_attention(model)
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
    u_plain = plain_core_run(sample, lambda: sample.posterior_ensemble(
        plain, cond, schedule, n_real, scfg, x_T=x_T, device=dev))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain.ensemble_mega = False
    u_f32 = sample.posterior_ensemble(plain, cond, schedule, n_real, scfg,
                                      x_T=x_T, device=dev)
    du = float((u - u_plain).abs().max())
    dmean = float((u.mean(0) - u_plain.mean(0)).abs().max())
    dstd = float((u.std(0) - u_plain.std(0)).abs().max())
    log(f"flash-arm ensemble ({n_cond} x {n_real}, DDIM-{scfg.ddim_steps}):"
        f" {run_s:.3f} s kernel path, {plain_s:.3f} s plain ({card}); "
        f"launches {got}; max|du|={du:.3e} max|dmean|={dmean:.3e} "
        f"max|dstd|={dstd:.3e}; the float32 module path's max|du| "
        f"{float((u - u_f32).abs().max()):.3e}")
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
                  "slab_attention_fwd_onepass": 0,
                  "slab_attention_bwd_onepass": 0,
                  "slab_attention_fwd_bf16": 1, "slab_attention_bwd_bf16": 1}
# phase 15 (a)'s shapes: phase 6's, then two key chunks past 160 keys and
# the longest L (tests/test_torch_gpu.py's SLAB_BF16_CASES)
SLAB_BF16_CASES = SLAB_CASES + [(2, 200, 128, 2), (1, 256, 128, 2)]


def check_bf16_tensor_cores(path, report: str, kernels=SLAB_BF16_KERNELS,
                            label: str = "one-pass slab kernels",
                            mma_sync="HMMA.16816",
                            typed: bool = True) -> None:
    """Phase 2: Hopper's bf16 warpgroup MMAs (HGMMA.*.F32.BF16) in the
    SASS of every instance of `kernels` (the one-pass slab kernels, dh 32
    and 64, on float32 and on bf16 slabs apart (`typed`); or the fused
    core's one-pass kernels), and no mma.sync (`mma_sync`: HMMA.16816, or
    a pattern) in them; raises where one of them has no instance (with
    `typed`, none of either slab type), or an instance has no HGMMA or
    has an mma.sync. Logs the counts and ptxas' wgmma remarks on them (a
    serialised wgmma pipeline). Logs and returns where the toolkit has no
    cuobjdump."""
    def kernel_of(line):
        name = next((k for k in kernels if k in line), None)
        if name is None or not typed:
            return name
        return name + ("[bf16]" if "__nv_bfloat16" in line else "[f32]")

    hgmma = sass_counts(path, kernel_of, HGMMA_BF16)
    if hgmma is None:
        log(f"sass: no cuobjdump; the {label}' wgmma check is not made")
        return
    hmma = sass_counts(path, kernel_of, mma_sync)
    log(f"sass: HGMMA.*.F32.BF16 / mma.sync per kernel of the {label}: " +
        "; ".join(f"{k} {n} / {hmma[k]}" for k, n in sorted(hgmma.items())))
    remarks = [line.strip() for line in report.splitlines()
               if re.search(r"\(C75\d\d\)", line)
               and any(k in line for k in kernels)]
    log(f"ptxas wgmma remarks on the {label}: "
        + (" | ".join(remarks) or "none"))
    bad = [k for k, n in hgmma.items() if n == 0 or hmma[k]]
    bad += [k for k in (kernels if not typed else
                        [f"{k}[{t}]" for k in kernels for t in ("f32",
                                                                "bf16")])
            if not any(n.startswith(k) for n in hgmma)]
    if bad:
        raise RuntimeError(f"{label} without HGMMA, with mma.sync or "
                           f"missing: {bad}")


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
    """Phase 15 (a): the one-pass slab kernels on bf16 slabs under
    `onepass_gate` against the float32 function computed in float64 from
    the same bf16 inputs (the plain one-pass version setting the rms
    yardstick); reruns bit-identical; timed (CUDA events, and a
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
                  sa.reference_slab_attention_onepass(qkv, nh),
                  sa.reference_slab_attention(qkv.double(), nh),
                  sa.reference_slab_attention(q32, nh),
                  sa.reference_slab_attention(qkv, nh)),
                 ("slab_attention_bwd_bf16", dgot,
                  sa.reference_slab_attention_onepass_backward(qkv, do, nh),
                  sa.reference_slab_attention_backward(
                      qkv.double(), do.double(), nh),
                  sa.reference_slab_attention_backward(q32, do32, nh),
                  sa.reference_slab_attention_backward(qkv, do, nh)))
        for name, g, onepass, exact, want, plain in pairs:
            if g.dtype != bf16 or not torch.isfinite(g.float()).all():
                raise RuntimeError(f"{name} B={b} L={l}: not finite bf16")
            # phase 3's one-pass rule: JAX's function on a bf16 slab, its
            # output rounded to bf16 as the plain one-pass version's
            gate = onepass_gate(f"{name} B={b} L={l} C={c} H={nh}",
                                g.float(), onepass.float(), exact,
                                stack=False)
            # and the bf16 kernels' earlier band: against the float32
            # plain version from the same bf16 inputs, within twice the
            # bf16 plain version's own error or 8e-3 x max(1, max|want|)
            err = float((g.float() - want).abs().max())
            err_plain = float((plain.float() - want).abs().max())
            tol = max(2 * err_plain, 8e-3 * max(1.0, float(want.abs().max())))
            log(f"{name} B={b} L={l} C={c} H={nh}: max|kernel - float32 "
                f"plain| {err:.3e}, the bf16 plain version's {err_plain:.3e}"
                f", tol {tol:.3e}")
            if not err <= tol:
                raise RuntimeError(f"{name} B={b} L={l}: error {err} > {tol}")
            entry = results.setdefault(name, {})
            for key, val in gate.items():
                entry[key] = max(entry.get(key, 0.0), val)
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
                             card, patches, patched, steps=TRAIN_STEPS,
                             ulp_floor: bool = True,
                             probes: dict | None = None,
                             graft: bool = False) -> dict:
    """`steps` b256 train steps of the bf16 `kernel` model against the
    same steps of `plain`, phase 7's gates with the tolerance set by the
    spread of two plain paths: plain against plain (run to run), and
    plain against a copy whose plain versions named in `patches` (the
    attributes of models/condunet.py they replace) compute in float32
    from the same bf16 inputs (`patched` says which: where bf16 rounds, a
    second computation of the same bf16 model). A leaf's gradient gate is
    at least two bf16 ulps of its largest value: a bf16 layer's weight
    gradient comes out of a bf16 product (`ulp_floor`; a float32 model's
    phase 7 has none). `probes` names more plain computations, each a
    context within which a copy of `plain` trains: their spreads are
    logged and returned, and set no tolerance. With `graft` a copy of
    `plain` trains the same steps with the kernel path's step-1 gradient
    in place of its own at the entries that the two paths end more than
    1e-5 apart, and `graft_steps`' gates apply: the entries whose step-1
    gradients the kernel and plain paths give opposite signs at most
    max(1e-5, 10 x run to run's, 4 x `patched`'s flip level: the step-1
    gradient gate's factors, as a flip is a gradient difference; see
    step1_flips) of their leaf's largest, the grafted path's loss within
    max(1e-5, 10 x run to run) of the kernel path's.
    Exactly `want` launches (by `counts`) a step; ms a step of both
    paths, peak memory and a profile of one step of each; returns the ms
    a step of both."""
    from ertdx_torch import train
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.models import condunet as condunet_mod

    mcfg, tcfg = cfg.model, cfg.train
    dev = next(kernel.parameters()).device
    plain2 = copy.deepcopy(plain)
    plain32 = copy.deepcopy(plain)
    probed = {tag: (context, copy.deepcopy(plain))
              for tag, context in (probes or {}).items()}
    grafted = copy.deepcopy(plain) if graft else None
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
    runs = [("run to run", pl2, pg2, plain2),
            (patched, pl32, pg32, plain32)]
    for tag, (context, probe) in probed.items():
        with context():
            runs.append((tag, *run(probe)[::3], probe))
        _log_param_gaps(f"{label} {tag} vs plain", probe, plain,
                        runs[-1][2], pg, n=1)
    spreads = {}
    for tag, other, og, om in runs:
        d = _param_diffs(plain, om)
        spreads[tag] = {"loss": max(abs(a - c) for a, c in zip(pl, other)),
                        "grad": _leaf_spread(og, pg),
                        "share": float((d > 1e-5).float().mean())}
        log(f"{label} plain vs plain ({tag}): max|dloss|="
            f"{spreads[tag]['loss']:.3e} max|dgrad|="
            f"{max(spreads[tag]['grad'].values()):.3e} max|dparam|="
            f"{float(d.max()):.3e} share > 1e-5: {spreads[tag]['share']:.3e}"
            f"; {_moved_entries(om, plain, og, pg)}")

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
    loss_share = max(abs(a - c) / (loss_tol * max(1.0, abs(c)))
                     for a, c in zip(kl, pl))
    # every gate is read and logged before the first failure raises
    failed = [f"{label} train step {step + 1}: loss {a} vs plain {c}, "
              f"tolerance {loss_tol:.1e}"
              for step, (a, c) in enumerate(zip(kl, pl))
              if not abs(a - c) <= loss_tol * max(1.0, abs(c))][:1]
    worst = 0.0
    for name, w in pg.items():
        err = float((kg[name] - w).abs().max())
        top = float(w.abs().max())
        # a bf16 layer's weight gradient is computed in bf16: two of its
        # ulps at the leaf's largest value are the finest gate it can meet
        ulp = 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -126))) - 7)
        tol = max(1e-4 * max(1.0, top), 2 * ulp if ulp_floor else 0.0,
                  10 * rr["grad"][name], 4 * rf["grad"][name])
        worst = max(worst, err / tol)
        if not err <= tol:
            failed.append(f"{label} step 1: gradient of {name} differs by "
                          f"{err:.3e} > {tol:.3e}")
    kp = _param_diffs(kernel, plain)
    k_share = float((kp > 1e-5).float().mean())
    share_limit = max(1e-3, 2 * rr["share"], 2 * rf["share"])
    flip_bound = 2 * tcfg.lr * steps
    log(f"{label} kernel vs plain: max|dloss|={dloss:.3e} (tol "
        f"{loss_tol:.1e} x max(1, loss); worst step's gap/tol "
        f"{loss_share:.3f}); step-1 gradients worst err/tol "
        f"{worst:.3f} (tol per leaf max(1e-4 x max(1, max|g|), "
        f"{'2 bf16 ulps of max|g|, ' if ulp_floor else ''}10 x run to run, "
        f"4 x {patched}'s)); params after "
        f"{steps} steps max|d|="
        f"{float(kp.max()):.3e} (bound {flip_bound:.1e}), share > 1e-5 "
        f"{k_share:.3e} (limit {share_limit:.3e})")
    _log_param_gaps(f"{label} kernel vs plain", kernel, plain, kg, pg)
    log(f"{label} kernel vs plain: {_moved_entries(kernel, plain, kg, pg)}")
    if graft:
        levels = [step1_flips(g, pg) for g in (pg2, pg32)]
        log(f"{label} step-1 sign flips against plain: run to run "
            f"{levels[0][0]} (at most {levels[0][1]:.2e} of their leaf's "
            f"largest), {patched} {levels[1][0]} ({levels[1][1]:.2e})")
        failed += graft_steps(
            label, grafted, kernel, plain, kg, pg, kl, pl, run,
            max(1e-5, 10 * rr["loss"]),
            max(1e-5, 10 * levels[0][1], 4 * levels[1][1]))
    if not (float(kp.max()) <= flip_bound + 1e-6 and k_share <= share_limit):
        failed.append(f"{label} kernel-path parameters disagree with the "
                      "plain path")
    if failed:
        raise RuntimeError("; ".join(failed))

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
            "batch": batches[0], "alpha_bar": alpha_bar, "lr": lr,
            "spreads": spreads, "kernel_loss_gap": dloss}


def slab_rule(steps: int, forwards: int) -> dict:
    """Phase 15's launches: one bf16 slab forward per forward (train or
    eval), one backward per step, no float32 slab launch."""
    return {"slab_attention_fwd": 0, "slab_attention_bwd": 0,
            "slab_attention_fwd_onepass": 0, "slab_attention_bwd_onepass": 0,
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
            "slab_attention_fwd_onepass": 0, "slab_attention_bwd_onepass": 0,
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

# the fused conv's GEMMs (csrc/gn_conv.cu, bf16 wgmma) by the part of
# their symbol that names them, on a float32 and on a bf16 x
CONV_BF16_KERNELS = ("tap3_wgmma_kernel", "conv_dw_wgmma_kernel")
# its GEMMs' instances by the SASS name, the A (x) type as the first
# template argument and the ints after it: the forward (GN, not WT) on
# each x, dh (WT; bf16(g) on either x) and dW on each x
WGMMA_GEMMS = {"forward f32": "tap3_wgmma_kernel[f32]<1,0,",
               "forward bf16": "tap3_wgmma_kernel[bf16]<1,0,",
               "dh": "tap3_wgmma_kernel[bf16]<0,1,",
               "dW f32": "conv_dw_wgmma_kernel[f32]",
               "dW bf16": "conv_dw_wgmma_kernel[bf16]"}
HGMMA_BF16 = re.compile(r"HGMMA\.\S*\.F32\.BF16")


def check_wgmma(path, report: str) -> None:
    """Phase 2: Hopper's bf16 warpgroup MMAs (HGMMA.*.F32.BF16) in the
    SASS of every instance of the fused conv's three GEMMs, on a float32
    and on a bf16 x (the A type is the template's first argument: `If`
    in the symbol for float), and no mma.sync (HMMA of any kind: no TF32,
    no bf16 mma.sync) in them; raises where one of WGMMA_GEMMS has no
    instance, an instance has no HGMMA or has an HMMA. Logs the counts
    and ptxas' wgmma remarks (a serialised wgmma pipeline). Logs and
    returns where the toolkit has no cuobjdump."""
    def kernel_of(line):
        name = next((k for k in CONV_BF16_KERNELS if k in line), None)
        if name is None:
            return None
        return name + ("[f32]" if f"{name}If" in line else "[bf16]")

    hgmma = sass_counts(path, kernel_of, HGMMA_BF16)
    if hgmma is None:
        log("sass: no cuobjdump; the wgmma check is not made")
        return
    hmma = sass_counts(path, kernel_of, re.compile(r"HMMA\."))
    log("sass: HGMMA.*.F32.BF16 / HMMA per fused-conv GEMM instance: " +
        "; ".join(f"{k} {n} / {hmma[k]}" for k, n in sorted(hgmma.items())))
    remarks = [line.strip() for line in report.splitlines()
               if re.search(r"\(C75\d\d\)", line)
               and any(k in line for k in CONV_BF16_KERNELS)]
    log("ptxas wgmma remarks on the fused-conv GEMMs: "
        + (" | ".join(remarks) or "none"))
    bad = [k for k, n in hgmma.items() if n == 0 or hmma[k]]
    bad += [name for name, key in WGMMA_GEMMS.items()
            if not any(k.startswith(key) for k in hgmma)]
    if bad:
        raise RuntimeError(f"fused-conv GEMMs without HGMMA, with mma.sync "
                           f"or missing: {bad}")


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
                   "slab_attention_fwd_onepass": 0,
                   "slab_attention_bwd_onepass": 0,
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
    values (the conv's: the one-pass kernels, the bf16 kernels' function
    on a float32 x), the bf16 plain version and the bf16 library composition
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
            f32_kind = "one-pass " if kind == "conv" else ""
            log(f"{name} {shape}{path}: kernel {ms:.4f} ms (profiler device "
                f"{dev_ms:.4f} ms), the float32 {f32_kind}kernel(s) "
                f"{f32_ms:.4f} ms, "
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
    bf16 q, k, v loaded as they are by the one-pass ensemble kernels,
    exactly one launch of each kernel per block and DDIM step and no
    fused-core launch. Against the same run with `ensemble_pallas` off
    (the plain bf16 attention, JAX's reference dtypes): the draws within
    the JAX package's bf16 band (5e-2, tests/test_ops.py:568-571) or
    within twice the gap between two plain computations of the same model
    (the plain path, and the ensemble branch with its attention computed
    in float32 from the same bf16 inputs and rounded once), both on the
    band's measure max(|du| - 5e-2 |u_plain|); ms a DDIM step with the
    kernels on and off. Returns the launches of each kernel."""
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
    # once: a second plain computation of the model
    patched = {}
    for name in ("block_self_attention", "folded_cross_attention"):
        patched[name] = getattr(condunet_mod, name)
        setattr(condunet_mod, name, lambda q, k, v, **_:
                ea.reference_attention(q.float(), k.float(),
                                       v.float()).to(q.dtype))
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
    step_ms, plain_step_ms = run_s / steps * 1e3, plain_s / steps * 1e3
    du = float((u - u_plain).abs().max())
    log(f"bf16 ensemble_pallas model ({b} x {r}, DDIM-{steps}, per-block "
        f"path): {run_s:.3f} s on the one-pass ensemble kernels "
        f"({step_ms:.3f} ms per DDIM step), {plain_s:.3f} s with them off "
        f"({plain_step_ms:.3f} ms per DDIM step; {card}); "
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


# ---------------------------------------------------------------------------
# 17. the user path: the port's CLI and posterior service at full width
# ---------------------------------------------------------------------------

# the user path's sizes: the design and the simulations (of which SRV_SIMS
# go through .srv files), the survey grid, the posterior ensembles' members
USER_DESIGN, SRV_SIMS, ROWS, SURVEYS, USER_MEMBERS = 400, 4, 4693, 14, 1000
SRV_HEADER = 259
# the requests POSTed to the service: (conditions, seed)
SERVE_REQUESTS = ((1, 0), (4, 1), (8, 2))


def expect_launches(label: str, got: dict, want: dict) -> None:
    """Fail unless every counter in `want` took exactly that count."""
    seen = {k: got.get(k, 0) for k in want}
    log(f"{label}: launches {seen}, expected {want}")
    if seen != want:
        raise RuntimeError(f"{label}: launches {seen}, expected {want}")


def run_cli(cli, argv, label, dev) -> tuple:
    """One subcommand of the port's CLI in this process: (its standard
    output, seconds by the host clock, the device synchronised)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{label}: exit code {rc}")
    return buf.getvalue(), seconds


def write_srv(path, values, skip_header: int) -> None:
    """A .srv file: `skip_header` header lines, then 7 columns a row with
    the data in column 5, written so that it parses back exactly."""
    rows = "\n".join(f"{r + 1} 0.0 0.0 0.0 1.0 {v!r} 0.05"
                     for r, v in enumerate(values.tolist()))
    header = "".join(f"survey header line {i}\n" for i in range(skip_header))
    path.write_text(header + rows + "\n")


def make_simulations(root, design, rng, card: str) -> tuple:
    """Simulation folders as physics.py leaves them: SRV_SIMS from .srv
    files read back with gather_srv_ensemble, the rest from seeded normals
    (phase 7's data), then 2 folders of the wrong shape and 1 missing.
    Returns (the folder count, the ERT the valid folders hold)."""
    from ertdx_torch.data import gather_srv_ensemble

    n = design.shape[0]
    srv_vals = rng.normal(50.0, 10.0, size=(SRV_SIMS, SURVEYS, ROWS))
    dirs = []
    t0 = time.perf_counter()
    for s in range(SRV_SIMS):
        d = root / f"srv_{s:04d}"
        d.mkdir()
        days = rng.permutation(np.arange(1, SURVEYS + 1) * 30)
        for k, day in enumerate(days):
            # the shuffled time tokens: survey `rank of day` holds row k's
            rank = int(np.sum(days < day))
            write_srv(d / f"sim_{s:04d}-E1-{day}d.srv", srv_vals[s, rank],
                      SRV_HEADER)
        dirs.append(d)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = gather_srv_ensemble(dirs, "sim_")
    read_s = time.perf_counter() - t0
    want = srv_vals.reshape(SRV_SIMS, -1)
    log(f"user path (b): {SRV_SIMS} simulations x {SURVEYS} .srv files x "
        f"{ROWS} rows ({SRV_HEADER}-line header) written in {write_s:.3f} s,"
        f" read back by gather_srv_ensemble in {read_s:.3f} s: "
        f"{got.shape}, equal to the written values: "
        f"{np.array_equal(got, want)} ({card})")
    if got.shape != want.shape or not np.array_equal(got, want):
        raise RuntimeError("gather_srv_ensemble differs from the .srv files")
    ert = np.concatenate([got, rng.normal(
        50.0, 10.0, size=(n - SRV_SIMS, SURVEYS * ROWS))])
    results = root / "results"
    bad = {n // 4: "shape", n // 2: "shape", 3 * n // 4: "missing"}
    folders, i = n + len(bad), 0
    for f in range(folders):
        sim = results / f"simulation_{f:04d}"
        if bad.get(f) == "missing":
            continue
        sim.mkdir(parents=True)
        if bad.get(f) == "shape":
            np.save(sim / "parameters.npy", design[0, :, 0])
            np.save(sim / "data.npy", np.zeros(SURVEYS * ROWS - SURVEYS))
            continue
        np.save(sim / "parameters.npy", design[i, :, 0])
        np.save(sim / "data.npy", ert[i])
        i += 1
    return folders, ert


def kde_reference(pixels: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """The KDE mode in float64 on a given grid: mode_kde_calculation's
    Gaussian kernel sum with Scott's bandwidth, argmax over `grid`.
    pixels: (n, N) ensembles."""
    from ertdx_torch.metrics import _scott_bandwidth

    out = np.empty(pixels.shape[0])
    for j, x in enumerate(pixels.astype(np.float64)):
        z = (grid[:, None] - x[None, :]) / _scott_bandwidth(x)
        out[j] = grid[np.argmax(np.exp(-0.5 * z * z).sum(axis=1))]
    return out


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(port: int, method: str, path: str, body=None,
              timeout: float = 300.0) -> tuple:
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None else
                     json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def rel_gap(got, want) -> float:
    """max |got - want| / max(|want|, tiny) over the elements."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-30)))


def check_user_path(sa, cb, dev, card, root, preset="v5e8_dp") -> dict:
    """Phase 17: the ertdiff user path through the port's CLI, at
    `preset`'s full width, in a temporary directory `root`:
    (a) generate-design; (b) .srv files at the survey's real size read
    back exactly, simulation folders, gather-data; (c) train for 2 epochs
    (launches by the epoch grid, the bf16 echo); (d) calibrate --commit
    over two temperatures (2 arms x 50 fused_core_stack launches a batch);
    (e) sample with the committed config against posterior_over_dataset;
    (f) metrics, and batched_kde_mode on a (50, 4693, 14) ensemble against
    float64; (g) serve as a subprocess, three requests against the
    in-process service, two bad ones. Returns the times."""
    from ertdx_torch import cli, configs, data, sample, train
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.doe import SurrogateDataGenerator
    from ertdx_torch.metrics import batched_kde_mode
    from ertdx_torch.serve import PosteriorService

    counts = _AllCounts(sa, cb)
    base = configs.PRESETS[preset]
    dev_args = [] if dev.type == "cuda" else ["--device", "cpu"]
    times = {}

    # (a) design
    design_path = root / "design.npy"
    run_cli(cli, ["generate-design", "--n", str(USER_DESIGN), "--method",
                  "sobol", "--seed", "0", "--out", str(design_path)],
            "generate-design", dev)
    design = np.load(design_path)
    want = SurrogateDataGenerator(seed=0).generate_training_samples(
        USER_DESIGN, "sobol")[..., None]
    log(f"user path (a): generate-design {design.shape}, equal to "
        f"SurrogateDataGenerator(seed=0): {np.array_equal(design, want)}")
    if not np.array_equal(design, want):
        raise RuntimeError("generate-design differs from the generator")

    # (b) ingest
    rng = np.random.default_rng(SEED + 170)
    folders, ert_flat = make_simulations(root, design, rng, card)
    p_path, e_path = root / "sim_param.npy", root / "sim_ert.npy"
    out, seconds = run_cli(
        cli, ["gather-data", "--results-dir", str(root / "results"), "--n",
              str(folders), "--surveys", str(SURVEYS), "--out-ert",
              str(e_path), "--out-params", str(p_path)], "gather-data", dev)
    ert, params = np.load(e_path), np.load(p_path)
    report = {line.split(":")[0]: line.split(":")[1].strip()
              for line in out.splitlines() if ":" in line}
    log(f"user path (b): gather-data --n {folders} in {seconds:.3f} s "
        f"({card}): {ert.shape} and {params.shape}; "
        f"{report.get('Discarded simulations')} discarded, "
        f"{report.get('Missing folders')} missing")
    if (ert.shape != (USER_DESIGN, ROWS, SURVEYS)
            or params.shape != (USER_DESIGN, 29, 1)
            or report.get("Discarded simulations") != "2"
            or report.get("Missing folders") != "1"
            or not np.array_equal(params, design)
            or not np.array_equal(ert[:, :, 0], ert_flat[:, :ROWS])):
        raise RuntimeError("gather-data: wrong shapes, report or values")

    # (c) train
    ck = root / "ck"
    common = ["--params", str(p_path), "--ert", str(e_path), "--preset",
              preset, *dev_args]
    counts.reset_launches()
    out, seconds = run_cli(cli, ["train", *common, "--epochs", "2",
                                 "--batch-size", "256", "--checkpoint-dir",
                                 str(ck)], "train", dev)
    n_train = int(base.train.split[0] * USER_DESIGN)
    n_val = int(base.train.split[1] * USER_DESIGN)
    steps = 2 * -(-n_train // 256)
    expect_launches("user path (c) train", counts.launches,
                    slab_rule(steps, steps + 2 * -(-n_val // 256)))
    saved = train.saved_config(str(ck))
    log(f"user path (c): train 2 epochs, {steps} b256 steps in "
        f"{seconds:.3f} s ({card}); {out.strip().splitlines()[-1]}; echo "
        f"dtype {saved['model']['dtype']!r}")
    if saved["model"]["dtype"] != "bfloat16":
        raise RuntimeError("train: the checkpoint does not echo bfloat16")
    times["train_s"] = seconds

    # (d) calibrate --commit on the val split
    temps = (1.0, 1.5)
    batches = -(-n_val // base.train.batch_size)
    ddim = base.sample.ddim_steps
    counts.reset_launches()
    out, seconds = run_cli(
        cli, ["calibrate", *common, "--checkpoint-dir", str(ck), "--temps",
              ",".join(map(str, temps)), "--realizations",
              str(USER_MEMBERS), "--out", str(root / "cal.json"),
              "--commit"], "calibrate", dev)
    arms = len(temps)
    expect_launches("user path (d) calibrate", counts.launches, {
        "fused_core_stack": arms * batches * ddim, "fused_core_block": 0,
        "slab_attention_fwd_bf16": arms * batches,
        "slab_attention_bwd_bf16": 0})
    cal = json.loads((root / "cal.json").read_text())
    committed = train.saved_config(str(ck))["sample"]
    log(f"user path (d): calibrate over {temps} ({n_val} conditions x "
        f"{USER_MEMBERS} members, DDIM-{ddim}) in {seconds:.3f} s, "
        f"{seconds / arms:.3f} s an arm ({card}); picked "
        f"{cal['best_temperature']}; goodness "
        f"{[cal['records'][str(t)]['goodness'] for t in temps]}; committed "
        f"sampler={committed['sampler']} ddim_steps="
        f"{committed['ddim_steps']} temperature={committed['temperature']}")
    if (committed["sampler"] != "ddim" or committed["ddim_steps"] != ddim
            or committed["temperature"] != cal["best_temperature"]):
        raise RuntimeError("calibrate --commit: wrong committed echo")
    times["calibrate_arm_s"] = seconds / arms

    # (e) sample with the committed config
    u_path = root / "Uncertainty_params.npy"
    counts.reset_launches()
    out, seconds = run_cli(cli, ["sample", *common, "--checkpoint-dir",
                                 str(ck), "--realizations",
                                 str(USER_MEMBERS), "--out", str(u_path)],
                           "sample", dev)
    n_test = USER_DESIGN - n_train - n_val
    test_batches = -(-n_test // base.train.batch_size)
    expect_launches("user path (e) sample", counts.launches, {
        "fused_core_stack": test_batches * ddim, "fused_core_block": 0,
        "slab_attention_fwd_bf16": test_batches,
        "slab_attention_bwd_bf16": 0})
    pred, mask = np.load(u_path), np.load(root / "valid_mask.npy")
    cfg = configs.experiment_from_dict(train.saved_config(str(ck)), base)
    state, _, scalers = train.load_best_model(str(ck), cfg, device=dev)
    ds = data.prepare_dataset(params, ert,
                              param_scaler=scalers["param_scaler"],
                              ert_scaler=scalers["ert_scaler"])
    _, _, test_idx = data.split_dataset(len(ds), cfg.train.seed,
                                        cfg.train.split)
    ref, ref_mask = sample.posterior_over_dataset(
        state.model.eval(), ds.conditions[test_idx],
        schedule_from_config(cfg.diffusion), ds.param_scaler,
        n_realizations=USER_MEMBERS, batch_size=cfg.train.batch_size,
        scfg=cfg.sample, generator=torch.Generator(device=dev).manual_seed(
            cfg.train.seed), device=dev)
    gap = rel_gap(pred, ref)
    log(f"user path (e): sample {pred.shape} in {seconds:.3f} s ({card}); "
        f"against the in-process posterior_over_dataset: bit-identical "
        f"{np.array_equal(pred, ref)}, max relative gap {gap:.3e} (gate "
        f"1e-6), masks equal {np.array_equal(mask, ref_mask)}")
    log(f"valid fraction: {float(mask.mean()):.6f}")
    if pred.shape != (USER_MEMBERS, n_test, 29) or not gap <= 1e-6 \
            or not np.array_equal(mask, ref_mask):
        raise RuntimeError("sample differs from posterior_over_dataset")
    times["sample_s"] = seconds

    # (f) metrics, and the batched KDE mode on the card
    out, _ = run_cli(cli, ["metrics", "--pred", str(u_path), "--true",
                           str(root / "true_params.npy"), "--out",
                           str(root / "uq.csv")], "metrics", dev)
    scores = json.loads(out.rsplit("wrote", 1)[0])
    log(f"user path (f): metrics {scores}")
    if set(scores) != {"accuracy", "precision", "goodness",
                       "crps_mean_normalized", "sbc_ks_mean"}:
        raise RuntimeError("metrics: not the JAX package's keys")
    ens = (rng.normal(0.0, 1.0, size=(50, ROWS, SURVEYS))
           * rng.uniform(0.5, 2.0, size=(ROWS, SURVEYS))
           + rng.normal(50.0, 10.0, size=(ROWS, SURVEYS)))
    ens[:, 0, 0] = 42.0                                  # a constant pixel
    batched_kde_mode(ens[:, :8], device=dev)             # first call: set-up
    t0 = time.perf_counter()
    modes = batched_kde_mode(ens, device=dev)
    kde_s = time.perf_counter() - t0
    flat = ens.reshape(50, -1).T
    pick = np.concatenate([[0], rng.choice(np.arange(1, flat.shape[0]), 63,
                                           replace=False)])
    lo, hi = float(ens.astype(np.float32).min()), \
        float(ens.astype(np.float32).max())
    grid = np.linspace(lo, hi, 5000)
    ref = kde_reference(flat[pick[1:]], grid)
    got = modes.reshape(-1)[pick]
    step = (hi - lo) / 4999
    err = float(np.abs(got[1:] - ref).max())
    log(f"user path (f): batched_kde_mode on a {ens.shape} ensemble "
        f"(5000 grid points) in {kde_s * 1e3:.3f} ms by the host clock, "
        f"numpy in and out ({card}); on 63 seeded pixels max |mode - "
        f"float64| {err:.4e} against one grid step {step:.4e}; the "
        f"constant pixel {got[0]!r}")
    if not err <= step * (1 + 1e-6) + 4 * np.spacing(np.float32(hi)) \
            or got[0] != np.float32(42.0):
        raise RuntimeError("batched_kde_mode disagrees with float64")
    times["kde_ms"] = kde_s * 1e3

    # (g) serve
    port = free_port()
    argv = [sys.executable, "-m", "ertdx_torch.cli", "serve",
            "--checkpoint-dir", str(ck), "--preset", preset, "--warmup",
            "--port", str(port), "--realizations", str(USER_MEMBERS),
            *dev_args]
    errlog = open(root / "serve.err", "w+")
    t0 = time.perf_counter()
    child = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.DEVNULL, stderr=errlog)
    try:
        while True:
            try:
                if http_json(port, "GET", "/healthz", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            if child.poll() is not None or time.perf_counter() - t0 > 180:
                errlog.seek(0)
                raise RuntimeError("serve did not answer /healthz within "
                                   f"180 s:\n{errlog.read()[-4000:]}")
            time.sleep(0.5)
        log(f"user path (g): serve answered /healthz "
            f"{time.perf_counter() - t0:.3f}"
            f" s after its start (warm-up of {USER_MEMBERS} members "
            f"included; {card})")
        svc = PosteriorService(str(ck), base, device=dev)
        raw = np.load(e_path)[test_idx]
        per_request = []
        for b, seed in SERVE_REQUESTS:
            body = {"conditions": raw[:b].tolist(),
                    "n_realizations": USER_MEMBERS, "seed": seed}
            t1 = time.perf_counter()
            status, answer = http_json(port, "POST", "/posterior", body)
            ms = (time.perf_counter() - t1) * 1e3
            if status != 200:
                raise RuntimeError(f"serve: status {status}: {answer}")
            counts.reset_launches()
            t1 = time.perf_counter()
            want = svc.posterior(raw[:b], n_realizations=USER_MEMBERS,
                                 seed=seed)
            local_ms = (time.perf_counter() - t1) * 1e3
            expect_launches(f"user path (g) in-process request of {b}",
                            counts.launches, {
                                "fused_core_stack": ddim,
                                "fused_core_block": 0,
                                "slab_attention_fwd_bf16": 1,
                                "slab_attention_bwd_bf16": 0})
            gap = max(rel_gap(answer[k], want[k]) for k in
                      ("mean", "std", "p25", "p50", "p75",
                       "valid_fraction"))
            log(f"user path (g): request of {b} condition(s), seed {seed}, "
                f"{USER_MEMBERS} members: {ms:.3f} ms by the host clock "
                f"around the HTTP call, {local_ms:.3f} ms for the same "
                f"posterior() in this process ({card}); valid fraction "
                f"{answer['valid_fraction']:.6f}; max relative gap to the "
                f"in-process service {gap:.3e} (gate 1e-6)")
            if not gap <= 1e-6 or set(answer) != set(want):
                raise RuntimeError("serve differs from the in-process "
                                   "service")
            per_request.append(ms)
        bad = [({"nope": 1}, "malformed"),
               ({"conditions": raw[:9].tolist()}, "over max_batch")]
        for body, what in bad:
            status, answer = http_json(port, "POST", "/posterior", body)
            log(f"user path (g): {what} request -> {status} {answer}")
            if status != 400:
                raise RuntimeError(f"serve: a {what} request got {status}")
        times["request_ms"] = per_request
    finally:
        child.terminate()
        try:
            child.wait(timeout=30)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
        errlog.close()
    return times


# ---------------------------------------------------------------------------
# 18. the reference model and the unconditional model
# ---------------------------------------------------------------------------

# (a) REF_DEFAULT's train steps, and train() on this many seeded examples;
# (b) the configs[0] posterior: conditions x members, ancestral over T;
# (c) the .pth route: the design the CLI samples from; (d) configs[1]'s
# fields and the members of its draw
REF_STEPS, REF_EXAMPLES = 5, 400
REF_CONDITIONS, REF_MEMBERS = 8, 50
PTH_DESIGN = 80
UNCOND_MEMBERS = 512


class _TorchRef(torch.nn.Module):
    """An independent rebuild of the reference's ConditionalDiffusionModel
    (ERT_Conditional_Diffusion.py:121-164), channel-first, whose state
    dict is what the reference's `.pth` files hold."""

    def __init__(self, param_dim=29, hidden_dim=128, channels=14):
        super().__init__()
        nn = torch.nn
        self.hidden_dim = hidden_dim
        self.condition_encoder = nn.Sequential(
            nn.Conv1d(channels, 32, 3, stride=2, padding=1), nn.ReLU(),
            nn.Conv1d(32, 64, 3, stride=2, padding=1), nn.ReLU(),
            nn.AdaptiveAvgPool1d(1), nn.Flatten(),
            nn.Linear(64, hidden_dim), nn.ReLU())
        self.time_embed = nn.Sequential(
            nn.Linear(hidden_dim, hidden_dim), nn.ReLU())
        self.mlp = nn.Sequential(
            nn.Linear(param_dim + 2 * hidden_dim, hidden_dim), nn.ReLU(),
            nn.Linear(hidden_dim, param_dim))

    def forward(self, x, t, condition):
        half = self.hidden_dim // 2
        freqs = torch.exp(
            -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                              device=x.device) / (half - 1))
        args = t.float()[:, None] * freqs[None]
        temb = self.time_embed(torch.cat([torch.sin(args), torch.cos(args)],
                                         dim=1))
        return self.mlp(torch.cat([x, temb,
                                   self.condition_encoder(condition)], dim=1))


def all_launches() -> dict:
    """Every kernel counter of the port's ops modules, by name."""
    from ertdx_torch.ops import attention, conv, core_block, ensemble_attn
    from ertdx_torch.ops import groupnorm, slab_attn
    out = {}
    for mod in (attention, conv, core_block, ensemble_attn, groupnorm,
                slab_attn):
        out.update(mod.launches)
        out.update(getattr(mod, "launches_onepass", {}))
        out.update(getattr(mod, "launches_bf16", {}))
    return out


def reset_all_launches() -> None:
    from ertdx_torch.ops import attention, conv, core_block, ensemble_attn
    from ertdx_torch.ops import groupnorm, slab_attn
    for mod in (attention, conv, core_block, ensemble_attn, groupnorm,
                slab_attn):
        mod.reset_launches()


def rel_err(got, want) -> float:
    """max |got - want| / max(1, max |want|) of two tensors or arrays."""
    got, want = (torch.as_tensor(a).detach().double().cpu()
                 for a in (got, want))
    return float((got - want).abs().max()) / max(1.0, float(
        want.abs().max()))


def check_draws(label, got, want, tol: float = 1e-3) -> float:
    """Fail unless the draws agree within tol x max(1, max|want|)."""
    err = rel_err(got, want)
    log(f"{label}: max|du| / max(1, max|u|) = {err:.3e} (gate {tol:g})")
    if not err <= tol:
        raise RuntimeError(f"{label}: draws differ by {err:.3e} > {tol:g}")
    return err


def check_ref_steps(configs, train, dev, card) -> float:
    """(a) REF_DEFAULT's RefCondMLP at full width: REF_STEPS train_steps on
    the card against the same steps on the CPU, on injected t and eps.
    Gates: each loss within 1e-4 relative; every parameter within 1e-5,
    but for at most 0.1 % of the entries, which Adam's sign(g) may move
    up to 2 lr a step apart where a gradient is near 0 (tests/
    test_torch_train.py's rule). Returns ms per step on the card."""
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.models import build_model
    from ertdx_torch.precision import fp32_precision
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax

    cfg = configs.REF_DEFAULT
    m = cfg.model
    rng = np.random.default_rng(SEED + 18)
    card_model = build_model(m, device=dev)
    tree = random_flax_tree(flax_shapes(card_model), rng)
    params_from_jax(card_model, tree)
    cpu_model = params_from_jax(build_model(m, device="cpu"), tree)
    bsz, lr = cfg.train.batch_size, cfg.train.lr
    alpha_bar = schedule_from_config(cfg.diffusion).alpha_bar
    batches = [(rng.standard_normal((bsz, m.param_dim)).astype(np.float32),
                rng.uniform(size=(bsz, m.cond_length, m.cond_channels)
                            ).astype(np.float32),
                rng.integers(0, cfg.diffusion.T, bsz),
                rng.standard_normal((bsz, m.param_dim)).astype(np.float32))
               for _ in range(REF_STEPS)]
    losses = {}
    with fp32_precision():
        for where, model in (("card", card_model), ("cpu", cpu_model)):
            d = next(model.parameters()).device
            opt = train.create_optimizer(model, lr)
            losses[where] = [float(train.train_step(
                model, opt, *(torch.from_numpy(a).to(d) for a in (x0, c)),
                torch.from_numpy(t).to(d), torch.from_numpy(e).to(d),
                alpha_bar=alpha_bar, lr=lr))
                for x0, c, t, e in batches]
        x0, c, t, e = (torch.from_numpy(a).to(dev) for a in batches[0])
        probe = copy.deepcopy(card_model)
        opt = train.create_optimizer(probe, lr)
        step_ms = time_ms(lambda: train.train_step(
            probe, opt, x0, c, t, e, alpha_bar=alpha_bar, lr=lr), reps=5)
        device_profile(lambda: train.train_step(
            probe, opt, x0, c, t, e, alpha_bar=alpha_bar, lr=lr),
            "refmlp (a) one REF_DEFAULT train step")
    worst_loss = max(abs(a - b) / abs(b) for a, b in
                     zip(losses["card"], losses["cpu"]))
    diffs = torch.cat([(a.detach().cpu() - b.detach()).abs().reshape(-1)
                       for a, b in zip(card_model.parameters(),
                                       cpu_model.parameters())])
    loose = int((diffs > 1e-5).sum())
    log(f"refmlp (a): {REF_STEPS} REF_DEFAULT steps (batch {bsz}, "
        f"condition {m.cond_length} x {m.cond_channels}, Adam lr {lr:g}) "
        f"card vs cpu: losses card {losses['card']} cpu {losses['cpu']}, "
        f"worst relative loss gap {worst_loss:.3e} (gate 1e-4); parameter "
        f"gap max {float(diffs.max()):.3e}, {loose} of {diffs.numel()} "
        f"entries above 1e-5 (gate 0.1 %, each <= {2 * lr * REF_STEPS:g})")
    if not (worst_loss <= 1e-4 and loose <= 1e-3 * diffs.numel()
            and float(diffs.max()) <= 2 * lr * REF_STEPS + 1e-5):
        raise RuntimeError("refmlp (a): the card's train steps disagree "
                           "with the CPU's")
    log(f"refmlp (a): {step_ms:.4f} ms per REF_DEFAULT train step on the "
        f"card (CUDA events; {card})")
    return step_ms


def check_ref_train(configs, data, train, dev, root) -> None:
    """(a) train() for 2 epochs on REF_EXAMPLES seeded examples; the best
    and last checkpoints read back, the last bit for bit the trained
    model."""
    from ertdx_torch.doe import SurrogateDataGenerator
    from ertdx_torch.models import build_model
    from ertdx_torch.utils import checkpoint as ckpt_lib
    from ertdx_torch.utils.weights import params_from_jax

    m = configs.REF_DEFAULT.model
    rng = np.random.default_rng(SEED + 19)
    design = SurrogateDataGenerator(seed=SEED).generate_training_samples(
        REF_EXAMPLES, "lhs")[..., None]
    ert = rng.normal(50.0, 10.0, size=(REF_EXAMPLES, m.cond_length,
                                       m.cond_channels)).astype(np.float32)
    ds = data.prepare_dataset(design, ert)
    cfg = dataclasses.replace(
        configs.REF_DEFAULT, train=dataclasses.replace(
            configs.REF_DEFAULT.train, num_epochs=2,
            step_checkpoint_every=1))
    ckdir = root / "ref_train"
    t0 = time.perf_counter()
    res = train.train(cfg, ds, checkpoint_dir=str(ckdir), device=dev)
    seconds = time.perf_counter() - t0
    state, meta, _ = train.load_best_model(str(ckdir), configs.REF_DEFAULT,
                                           device=dev)
    tree, last_meta, _ = ckpt_lib.restore_checkpoint(ckdir / "last")
    last = params_from_jax(build_model(m, device=dev), tree["params"])
    exact = all(torch.equal(a, b) for a, b in zip(
        last.parameters(), res.state.model.parameters()))
    log(f"refmlp (a): train() 2 epochs on {REF_EXAMPLES} examples in "
        f"{seconds:.3f} s ({res.steps_per_sec:.2f} steps/s), losses "
        f"{res.train_history} val {res.val_history}; best (epoch "
        f"{meta['epoch']}, model {meta['model']!r}) read back as "
        f"{type(state.model).__name__}, last (epoch {last_meta['epoch']}) "
        f"bit for bit the trained model: {exact}")
    steps_per_epoch = res.state.step // 2
    if not (exact and meta["model"] == "refmlp"
            and np.isfinite(res.train_history).all()
            and state.step == meta["epoch"] * steps_per_epoch):
        raise RuntimeError("refmlp (a): train() or its checkpoints failed")


def _ref_posterior_model(configs, dev, uncond_prob, seed):
    """REF_DEFAULT's model (with uncond_prob) from random non-zero weights,
    on the card and on the CPU."""
    from ertdx_torch.models import build_model
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax
    m = dataclasses.replace(configs.REF_DEFAULT.model,
                            uncond_prob=uncond_prob)
    card_model = build_model(m, device=dev).eval()
    tree = random_flax_tree(flax_shapes(card_model),
                            np.random.default_rng(seed))
    params_from_jax(card_model, tree)
    return card_model, params_from_jax(build_model(m, device="cpu"),
                                       tree).eval()


def check_ref_posterior(configs, sample, dev, card) -> float:
    """(b) the configs[0] posterior: REF_CONDITIONS x REF_MEMBERS chains,
    ancestral over all T=500 steps, realization-major, from injected x_T
    and noise, on the card against the CPU (1e-3 x max(1, max|u|)); the
    same guided at g = 2 from a model with uncond_prob = 0.1; then the
    inverse pipeline. Returns ms per sampling step on the card."""
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.params import ParameterSpace
    from ertdx_torch.transforms import MinMaxScaler

    cfg = configs.REF_DEFAULT
    m, big_t = cfg.model, cfg.diffusion.T
    schedule = schedule_from_config(cfg.diffusion)
    rng = np.random.default_rng(SEED + 20)
    cond = rng.uniform(size=(REF_CONDITIONS, m.cond_length,
                             m.cond_channels)).astype(np.float32)
    chains = REF_CONDITIONS * REF_MEMBERS
    x_T = torch.from_numpy(rng.standard_normal(
        (chains, m.param_dim)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal(
        (big_t, chains, m.param_dim)).astype(np.float32))
    step_ms = None
    for label, uncond_prob, g in (("unguided", 0.0, 1.0),
                                  ("guided g=2", 0.1, 2.0)):
        card_model, cpu_model = _ref_posterior_model(configs, dev,
                                                     uncond_prob, SEED + 21)
        scfg = dataclasses.replace(cfg.sample, guidance_scale=g,
                                   uncertainty_samples=REF_MEMBERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = sample.posterior_ensemble(
            card_model, torch.from_numpy(cond), schedule, REF_MEMBERS, scfg,
            x_T=x_T.to(dev), noise=noise.to(dev), device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        u_cpu = sample.posterior_ensemble(
            cpu_model, torch.from_numpy(cond), schedule, REF_MEMBERS, scfg,
            x_T=x_T, noise=noise, device="cpu")
        if tuple(u.shape) != (REF_MEMBERS, REF_CONDITIONS, m.param_dim) \
                or not torch.isfinite(u).all():
            raise RuntimeError(f"refmlp (b) {label}: bad draws")
        check_draws(f"refmlp (b) {label}: {REF_CONDITIONS} x {REF_MEMBERS}"
                    f" ancestral-{big_t} card vs cpu", u, u_cpu)
        ms = seconds / big_t * 1e3
        log(f"refmlp (b) {label}: {seconds:.3f} s, {ms:.4f} ms per "
            f"sampling step ({chains} chains; {card})")
        step_ms = step_ms or ms
    space = ParameterSpace()
    phys, mask = sample.inverse_pipeline(u, MinMaxScaler.fit(space.plims.T),
                                         space=space)
    if phys.shape != tuple(u.shape) or not np.isfinite(phys).all():
        raise RuntimeError("refmlp (b): inverse pipeline: bad output")
    log(f"refmlp (b): inverse pipeline valid fraction "
        f"{float(mask.mean()):.6f}")
    return step_ms


def check_pth_route(configs, cli, data, sample, dev, root) -> None:
    """(c) the reference's `.pth` weights on the card: a twin's forward
    against the imported RefCondMLP's (1e-5 x max(1, max|twin|)); `sample
    --torch-checkpoint --model refmlp` through the CLI against
    posterior_over_dataset in process from the same seed, and
    PosteriorService.from_torch against posterior_ensemble in process
    (both 1e-6 x max(1, max|draws|))."""
    from ertdx_torch.compat import load_reference_model
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.doe import SurrogateDataGenerator
    from ertdx_torch.serve import PosteriorService

    cfg = configs.REF_DEFAULT
    m = cfg.model
    torch.manual_seed(SEED + 22)
    twin = _TorchRef(m.param_dim, m.hidden_dim, m.cond_channels).eval()
    pth = root / "best_model.pth"
    torch.save(twin.state_dict(), pth)
    rng = np.random.default_rng(SEED + 23)
    design = SurrogateDataGenerator(seed=SEED + 1).generate_training_samples(
        PTH_DESIGN, "lhs")[..., None]
    ert = rng.normal(50.0, 10.0, size=(PTH_DESIGN, m.cond_length,
                                       m.cond_channels)).astype(np.float32)
    np.save(root / "pth_param.npy", design)
    np.save(root / "pth_ert.npy", ert)

    model, _ = load_reference_model(pth, m, dev)
    model.eval()
    twin = twin.to(dev)
    x = torch.randn(8, m.param_dim, device=dev)
    t = torch.arange(8, device=dev) * 60
    c = torch.from_numpy(ert[:8] / 100.0).to(dev)
    with torch.no_grad():
        err = rel_err(model(x, t, c), twin(x, t, c.transpose(1, 2)))
    log(f"refmlp (c): imported RefCondMLP vs the reference twin on the card:"
        f" {err:.3e} (gate 1e-5)")
    if not err <= 1e-5:
        raise RuntimeError("refmlp (c): the imported model disagrees with "
                           "the twin")

    out = root / "pth_u.npy"
    _, seconds = run_cli(cli, [
        "sample", "--params", str(root / "pth_param.npy"), "--ert",
        str(root / "pth_ert.npy"), "--torch-checkpoint", str(pth),
        "--model", "refmlp", "--realizations", str(REF_MEMBERS), "--seed",
        "3", "--out", str(out)] + ([] if dev.type == "cuda" else
                                   ["--device", "cpu"]),
        "sample --torch-checkpoint", dev)
    pred = np.load(out)
    ds = data.prepare_dataset(design, ert)
    _, _, test_idx = data.split_dataset(len(ds), 3, cfg.train.split)
    want, _ = sample.posterior_over_dataset(
        model, ds.conditions[test_idx], schedule_from_config(cfg.diffusion),
        ds.param_scaler, n_realizations=REF_MEMBERS,
        batch_size=cfg.train.batch_size, scfg=cfg.sample,
        generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    err = rel_err(pred, want)
    log(f"refmlp (c): sample --torch-checkpoint {pred.shape} in "
        f"{seconds:.3f} s vs posterior_over_dataset in process: {err:.3e} "
        f"(gate 1e-6)")
    if pred.shape != want.shape or not err <= 1e-6:
        raise RuntimeError("refmlp (c): the CLI's draws differ")

    svc = PosteriorService.from_torch(pth, cfg, design, ert, max_batch=8,
                                      device=dev)
    got = svc.posterior(ert[:4], n_realizations=REF_MEMBERS, seed=4,
                        return_draws=True)
    cond = ds.ert_scaler.transform(ert[:4].reshape(4, -1)).reshape(
        4, m.cond_length, m.cond_channels).astype(np.float32)
    cond = np.concatenate([cond, np.zeros((4,) + cond.shape[1:],
                                          np.float32)])
    u = sample.posterior_ensemble(
        model, torch.from_numpy(cond), schedule_from_config(cfg.diffusion),
        REF_MEMBERS, cfg.sample,
        generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    phys, _ = sample.device_inverse(u, ds.param_scaler, svc.space.plims)
    err = rel_err(np.asarray(got["draws"], np.float32),
                  phys[:, :4].cpu().numpy())
    log(f"refmlp (c): PosteriorService.from_torch ({svc.meta}) vs "
        f"posterior_ensemble in process: {err:.3e} (gate 1e-6), valid "
        f"fraction {got['valid_fraction']:.4f}")
    if not err <= 1e-6:
        raise RuntimeError("refmlp (c): from_torch's draws differ")


def check_synthetic(configs, cli, sample, train, dev, card, root) -> dict:
    """(d) configs[1]: generate-synthetic through the CLI (the port's
    synthetic.py's bytes); SYNTHETIC_GAUSSIAN's UncondMLP at full width
    (P=256, H=256, 3 blocks, batch 64, T=500) for 2 epochs, then a
    UNCOND_MEMBERS-member ancestral draw, finite; then tests/
    test_uncond.py's acceptance check on the card with its settings and
    tolerances. Returns ms per train and per sampling step."""
    from ertdx_torch import synthetic
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.precision import fp32_precision

    fields = root / "synthetic_fields.npy"
    run_cli(cli, ["generate-synthetic", "--out", str(fields)],
            "generate-synthetic", dev)
    cfg = dataclasses.replace(configs.SYNTHETIC_GAUSSIAN,
                              train=dataclasses.replace(
                                  configs.SYNTHETIC_GAUSSIAN.train,
                                  num_epochs=2))
    ds = synthetic.make_unconditional_ertdataset()
    same = np.load(fields).tobytes() == ds.params_u.tobytes() and \
        np.load(root / "synthetic_cond.npy").tobytes() == \
        ds.conditions.tobytes()
    res = train.train(cfg, ds, checkpoint_dir=str(root / "uncond"),
                      device=dev)
    state, meta, _ = train.load_best_model(str(root / "uncond"), cfg,
                                           device=dev)
    schedule = schedule_from_config(cfg.diffusion)
    probe = copy.deepcopy(state.model)
    opt = train.create_optimizer(probe, cfg.train.lr)
    x0 = torch.from_numpy(ds.params_u[:cfg.train.batch_size]).to(dev)
    cond = torch.zeros(cfg.train.batch_size, 1, 1, device=dev)
    with fp32_precision():
        step_ms = time_ms(lambda: train.train_step(
            probe, opt, x0, cond, alpha_bar=schedule.alpha_bar,
            lr=cfg.train.lr), reps=5)
        device_profile(lambda: train.train_step(
            probe, opt, x0, cond, alpha_bar=schedule.alpha_bar,
            lr=cfg.train.lr), "uncond (d) one SYNTHETIC_GAUSSIAN train step")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = sample.posterior_ensemble(
        state.model.eval(), torch.zeros(1, 1, 1), schedule, UNCOND_MEMBERS,
        param_dim=cfg.model.param_dim,
        generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    sample_ms = (time.perf_counter() - t0) / cfg.diffusion.T * 1e3
    train_ms = 1e3 / res.steps_per_sec
    log(f"uncond (d): generate-synthetic {np.load(fields).shape}, the bytes "
        f"of synthetic.py: {same}; train() 2 epochs at batch "
        f"{cfg.train.batch_size}: losses {res.train_history}, "
        f"{train_ms:.4f} ms per step (host clock over the epochs, the "
        f"first steps' set-up included); one train_step {step_ms:.4f} ms "
        f"(CUDA events); "
        f"{UNCOND_MEMBERS}-member ancestral-{cfg.diffusion.T} draw "
        f"{tuple(u.shape)} in {sample_ms:.4f} ms per step, finite: "
        f"{bool(torch.isfinite(u).all())}; meta model {meta['model']!r} "
        f"({card})")
    if not (same and tuple(u.shape) == (UNCOND_MEMBERS, 1, 256)
            and torch.isfinite(u).all() and meta["model"] == "uncondmlp"):
        raise RuntimeError("uncond (d): the configs[1] path failed")

    grid = (8, 8)
    d = grid[0] * grid[1]
    small = synthetic.make_unconditional_ertdataset(
        n=1024, grid=grid, length_scale=0.4, seed=0)
    acfg = configs.ExperimentConfig(
        diffusion=configs.DiffusionConfig(T=100),
        model=dataclasses.replace(configs.ModelConfig(), name="uncondmlp",
                                  param_dim=d, hidden_dim=128,
                                  cond_length=1, cond_channels=1),
        train=dataclasses.replace(configs.TrainConfig(), num_epochs=40,
                                  batch_size=128, lr=2e-3,
                                  checkpoint_dir="", log_every=1000))
    ares = train.train(acfg, small, device=dev)
    x = sample.posterior_ensemble(
        ares.state.model.eval(), torch.zeros(1, 1, 1),
        schedule_from_config(acfg.diffusion), 512, param_dim=d,
        generator=torch.Generator(device=dev).manual_seed(0),
        device=dev).cpu().numpy().reshape(512, d)
    g = x.reshape(512, *grid)
    c_near = float(np.corrcoef(g[:, 4, 4], g[:, 4, 5])[0, 1])
    dmean = abs(float(x.mean()) - float(small.params_u.mean()))
    dstd = abs(float(x.std()) - float(small.params_u.std()))
    drop = ares.train_history[-1] / ares.train_history[0]
    log(f"uncond (d): configs[1] acceptance on the card: loss ratio "
        f"{drop:.4f} (gate < 0.8), |dmean| {dmean:.4f} (< 0.15), |dstd| "
        f"{dstd:.4f} (< 0.25), neighbour correlation {c_near:.4f} (> 0.2)")
    if not (drop < 0.8 and dmean < 0.15 and dstd < 0.25 and c_near > 0.2):
        raise RuntimeError("uncond (d): the configs[1] check failed")
    return {"train_ms": train_ms, "step_ms": step_ms,
            "sample_ms": sample_ms}


def check_other_models(sample, dev, card, root) -> dict:
    """Phase 18: the reference and unconditional models on the card, (a)
    to (d). Their path runs no kernel of csrc/ (JAX computes both models
    outside Pallas): every kernel counter is set to 0 before and read
    after, and must stay 0."""
    from ertdx_torch import cli, configs, data, train

    reset_all_launches()
    ref_step_ms = check_ref_steps(configs, train, dev, card)
    check_ref_train(configs, data, train, dev, root)
    ref_sample_ms = check_ref_posterior(configs, sample, dev, card)
    check_pth_route(configs, cli, data, sample, dev, root)
    uncond = check_synthetic(configs, cli, sample, train, dev, card, root)
    launched = {k: v for k, v in all_launches().items() if v}
    log(f"refmlp / uncond path: kernel launches {launched or 'none'}")
    if launched:
        raise RuntimeError(f"the MLP models' path launched {launched}")
    return {"ref_step_ms": ref_step_ms, "ref_sample_ms": ref_sample_ms,
            "uncond_train_ms": uncond["train_ms"],
            "uncond_step_ms": uncond["step_ms"],
            "uncond_sample_ms": uncond["sample_ms"]}


# the physics loop: the members pushed through the forward model by the
# CLI, of which PHYS_VALIDATE again through run_posterior_validation
PHYS_MEMBERS, PHYS_VALIDATE, PHYS_CONCURRENCY = 50, 5, 6
PHYS_TEMPLATE = Path(__file__).resolve().parent / "tests" / "fixtures" / \
    "pflotran_template.in"
# The stand-in PFLOTRAN of phase 19: a Python script without numpy that
# takes `-pflotranin <file>`, reads the values on the input file's
# parameter lines and writes 14 surveys of 4693 rows (a 259-line header,
# the data in column 5, written by repr so that they parse back exactly)
# as a fixed function of them. chip_smoke runs the same two functions to
# check every run's data.
PFLOTRAN_STANDIN = r"""
import sys

KEYS = ("ARCHIE_CEMENTATION_EXPONENT", "ARCHIE_SATURATION_EXPONENT",
        "ARCHIE_TORTUOSITY_CONSTANT", "POROSITY",
        "SURFACE_ELECTRICAL_CONDUCTIVITY", "PERM_X", "PERM_Y", "PERM_Z",
        "ALPHA", "M", "LIQUID_RESIDUAL_SATURATION", "WATER_CONDUCTIVITY")
SURVEYS, ROWS, HEADER = 14, 4693, 259


def spliced(path):
    # the values of the parameter lines, in file order
    vals = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if len(tok) >= 2 and tok[0] in KEYS:
                vals.append(float(tok[1]))
    return vals


def response(vals):
    # SURVEYS lists of ROWS transfer resistances
    out = []
    for s in range(SURVEYS):
        base = 0.0
        for k, v in enumerate(vals):
            base += v * ((k + s) % 7 + 1)
        lead = vals[s % len(vals)]
        out.append([base * (1.0 + r / ROWS) + lead * r
                    for r in range(ROWS)])
    return out


if __name__ == "__main__":
    inp = sys.argv[sys.argv.index("-pflotranin") + 1]
    stem = inp[:-3] if inp.endswith(".in") else inp
    header = "".join(f"survey header line {i}\n" for i in range(HEADER))
    for s, col in enumerate(response(spliced(inp))):
        rows = "".join(f"{r + 1} 0.0 0.0 0.0 1.0 {v!r} 0.05\n"
                       for r, v in enumerate(col))
        with open(f"{stem}-E1-{(s + 1) * 30}d.srv", "w") as f:
            f.write(header + rows)
"""


def write_standin(root: Path) -> tuple:
    """The stand-in PFLOTRAN as an executable in `root`, and its two
    functions (spliced, response) in this process."""
    path = root / "pflotran_standin.py"
    path.write_text(f"#!{sys.executable}\n" + PFLOTRAN_STANDIN)
    path.chmod(0o755)
    ns = {"__name__": "pflotran_standin"}
    exec(compile(PFLOTRAN_STANDIN, str(path), "exec"), ns)
    return path, ns["spliced"], ns["response"]


def run_module_cli(argv, label, dev, timeout: float = 900.0):
    """`python -m ertdx_torch.cli <argv>` as a subprocess from the root of
    the checkout: (the process, seconds by the host clock)."""
    repo = Path(__file__).resolve().parent
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [str(repo)] + [p for p in [os.environ.get("PYTHONPATH")]
                              if p])}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ertdx_torch.cli", *argv],
                          cwd=repo, env=env, capture_output=True, text=True,
                          timeout=timeout)
    seconds = time.perf_counter() - t0
    log(f"{label}: python -m ertdx_torch.cli {argv[0]} exit "
        f"{proc.returncode} in {seconds:.3f} s")
    return proc, seconds


def check_physics_loop(dev, card, root) -> dict:
    """Phase 19: the physics loop in a temporary directory `root`.
    (a) the configs[3] posterior (CondUNet at DDIM_ENSEMBLE's full width,
    random weights from SEED through params_from_jax, 8 conditions x 1000
    members, DDIM-50) with exactly 50 fused_core_stack launches, and the
    inverse pipeline on the host; (b) the first PHYS_MEMBERS valid members
    of condition 0 through `python -m ertdx_torch.cli simulate --mode
    keywords --no-mpi` on tests/fixtures/pflotran_template.in with the
    stand-in PFLOTRAN, each run's parameters and data checked exactly,
    every .srv file read by the C++ reader; PHYS_VALIDATE of them again
    through run_posterior_validation in this process; (c) gather-data,
    ensemble_statistics on `dev` (its batched_kde_mode) and
    wsse_per_simulation against condition 0's survey, held against the
    CPU's on a strided set of pixels that keeps the KDE grid (one grid
    step for the mode, 1e-6 relative for the rest), and `plot`, which
    writes six figures or, without matplotlib, exits naming it; (d) the
    times. Returns them."""
    from ertdx_torch import cli, configs, sample
    from ertdx_torch.data import SrvFormat, gather_srv_data
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.metrics import (batched_kde_mode, ensemble_statistics,
                                     wsse_per_simulation)
    from ertdx_torch.models import build_model
    from ertdx_torch.params import ParameterSpace
    from ertdx_torch.physics import (ForwardModelRunner, PflotranSimulator,
                                     RunnerConfig, SimulationManager,
                                     run_posterior_validation)
    from ertdx_torch.transforms import MinMaxScaler
    from ertdx_torch.utils import srv_native
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax

    times = {}
    # (a) the posterior, as phase 4 builds it
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
    with torch.no_grad():
        model.encode_condition(cond[:1])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    u = sample.posterior_ensemble(model, cond, schedule, n_real, cfg.sample,
                                  x_T=x_T, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    times["posterior_s"] = time.perf_counter() - t0
    launches = all_launches()
    log(f"physics loop (a): posterior {tuple(u.shape)} in "
        f"{times['posterior_s']:.3f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    expect_launches("physics loop (a)", launches,
                    {"fused_core_stack": cfg.sample.ddim_steps,
                     "fused_core_block": 0})
    space = ParameterSpace()
    scaler = MinMaxScaler.fit(space.plims.T)
    # the draws on the host first: the inverse then runs in float64, as
    # the JAX package's closure loop hands them over
    phys, mask = sample.inverse_pipeline(u.cpu().numpy(), scaler,
                                         space=space)
    valid = np.nonzero(mask[:, 0])[0]
    log(f"physics loop (a): inverse pipeline {phys.dtype} {phys.shape}, "
        f"valid fraction {float(mask.mean()):.6f}, condition 0 "
        f"{valid.size} of {n_real}")
    if phys.dtype != np.float64 or valid.size < PHYS_MEMBERS:
        raise RuntimeError("physics loop (a): too few valid members")
    members = np.ascontiguousarray(phys[valid[:PHYS_MEMBERS], 0, :])
    members_path = root / "members.npy"
    np.save(members_path, members)

    # (b) the forward runs through the CLI, on the stand-in
    standin, spliced, response = write_standin(root)
    srv_native.load()                 # built once, before the runs
    rows, surveys = 4693, 14
    proc, seconds = run_module_cli(
        ["simulate", "--template", str(PHYS_TEMPLATE), "--params",
         str(members_path), "--pflotran", str(standin), "--no-mpi",
         "--mode", "keywords", "--concurrency", str(PHYS_CONCURRENCY),
         "--surveys", str(surveys), "--measurements", str(rows),
         "--workdir", str(root / "runs"), "--results-dir",
         str(root / "results"), "--max-retries", "0"],
        "physics loop (b) simulate", dev)
    if proc.returncode != 0:
        raise RuntimeError(f"simulate failed:\n{proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-4000:]}")
    times["forward_s"] = seconds
    read = [ln for ln in proc.stdout.splitlines()
            if ln.startswith(".srv files read:")]
    want_read = (f".srv files read: {PHYS_MEMBERS * surveys} by the C++ "
                 f"reader, 0 by numpy")
    log(f"physics loop (b): {PHYS_MEMBERS} forward runs ({surveys} .srv "
        f"files of {rows} rows each, {PHYS_CONCURRENCY} at a time) in "
        f"{seconds:.3f} s ({card}); {read}")
    if read != [want_read]:
        raise RuntimeError(f"simulate: {read}, expected {want_read!r}")
    prefix = "ertdx_run"
    for i in range(PHYS_MEMBERS):
        sim = root / "results" / f"simulation_{i:04d}"
        inp = root / "runs" / f"run_{i:04d}" / f"{prefix}_{i:04d}.in"
        vals = spliced(inp)
        want = np.asarray(response(vals), dtype=np.float64).ravel()
        porosity = next(float(line.split()[1]) for line in open(inp)
                        if line.split()[:1] == ["POROSITY"])
        got_p = np.load(sim / "parameters.npy")
        got_d = np.load(sim / "data.npy")
        if not (np.array_equal(got_p, members[i])
                and got_p.dtype == np.float64
                and np.array_equal(got_d, want)
                and porosity == float(f"{members[i][0]:12.4e}")):
            raise RuntimeError(f"physics loop (b): run {i} differs from "
                               f"its member or from the stand-in")
    log(f"physics loop (b): all {PHYS_MEMBERS} runs' parameters.npy equal "
        f"their members and data.npy the stand-in's response to the "
        f"spliced values, exactly")

    val_root = root / "validation"
    runner = ForwardModelRunner(
        PflotranSimulator(str(PHYS_TEMPLATE), prefix, mode="keywords"),
        cfg=RunnerConfig(pflotran_path=str(standin), use_mpi=False,
                         n_surveys=surveys, measurements_per_survey=rows),
        workdir=str(val_root / "runs"))
    mgr = SimulationManager(base_dir=str(val_root / "results"))
    before = dict(srv_native.reads)
    t0 = time.perf_counter()
    completed = run_posterior_validation(runner, mgr,
                                         members[:PHYS_VALIDATE],
                                         progress=lambda msg: None)
    times["validation_s"] = time.perf_counter() - t0
    read = {k: srv_native.reads[k] - before[k] for k in before}
    same = all(np.array_equal(
        np.load(val_root / "results" / f"simulation_{i:04d}" / "data.npy"),
        np.load(root / "results" / f"simulation_{i:04d}" / "data.npy"))
        for i in completed)
    log(f"physics loop (b): run_posterior_validation of {PHYS_VALIDATE} "
        f"members in {times['validation_s']:.3f} s: completed {completed}, "
        f"reads {read}, data equal to the CLI's: {same}")
    if (completed != list(range(PHYS_VALIDATE)) or not same
            or read != {"native": PHYS_VALIDATE * surveys, "numpy": 0}):
        raise RuntimeError("physics loop (b): run_posterior_validation")

    # one simulation's 14 files: the C++ reader against np.genfromtxt
    fmt = SrvFormat()
    run0 = root / "runs" / "run_0000"
    paths = sorted(run0.glob(f"{prefix}_0000-*.srv"),
                   key=lambda q: int(q.name.split("-")[2][:-5]))
    native_ms, numpy_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        flat = gather_srv_data(f"{prefix}_0000", str(run0), fmt)
        native_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        ref = np.concatenate([np.genfromtxt(q, skip_header=fmt.skip_header,
                                            usecols=fmt.usecols)
                              for q in paths])
        numpy_ms.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(flat, ref):
            raise RuntimeError("the C++ reader differs from np.genfromtxt")
    times["read_native_ms"] = statistics.median(native_ms)
    times["read_numpy_ms"] = statistics.median(numpy_ms)
    # where a run's time goes: the stand-in alone, one input file
    t0 = time.perf_counter()
    subprocess.run([str(standin), "-pflotranin",
                    str(run0 / f"{prefix}_0000.in")], cwd=root, check=True)
    times["standin_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"physics loop (d): one simulation's {len(paths)} .srv files read "
        f"in {times['read_native_ms']:.3f} ms by gather_srv_data (C++) "
        f"against {times['read_numpy_ms']:.3f} ms by np.genfromtxt "
        f"(medians of 3, warm page cache; {card}); the stand-in alone "
        f"{times['standin_ms']:.3f} ms a run")

    # (c) re-ingest and statistics
    e_path, p_path = root / "sim_ert.npy", root / "sim_param.npy"
    out, seconds = run_cli(
        cli, ["gather-data", "--results-dir", str(root / "results"), "--n",
              str(PHYS_MEMBERS), "--surveys", str(surveys), "--out-ert",
              str(e_path), "--out-params", str(p_path)], "gather-data", dev)
    ert, params = np.load(e_path), np.load(p_path)
    log(f"physics loop (c): gather-data --n {PHYS_MEMBERS} in "
        f"{seconds:.3f} s: {ert.shape} and {params.shape}")
    if (ert.shape != (PHYS_MEMBERS, rows, surveys)
            or params.shape != (PHYS_MEMBERS, 29, 1)
            or not np.array_equal(params[..., 0], members)):
        raise RuntimeError("physics loop (c): gather-data")
    conditional = cond[0].cpu().numpy().astype(np.float64)
    t0 = time.perf_counter()
    stats = ensemble_statistics(ert, conditional, device=dev)
    wsse = wsse_per_simulation(ert, conditional)
    times["stats_ms"] = (time.perf_counter() - t0) * 1e3
    # everything but the KDE mode again on the host, from the card's mode
    host = ensemble_statistics(ert, conditional, mode=stats["mode"],
                               device="cpu")
    worst = max(rel_gap(stats[k], host[k]) for k in host)
    # the KDE mode on the CPU on every 32nd pixel and on the pixels that
    # hold the ensemble's minimum and maximum, so that the grid is the same
    flat_sim = ert.reshape(PHYS_MEMBERS, -1)
    pix = np.unique(np.r_[np.arange(0, flat_sim.shape[1], 32),
                          np.argmin(flat_sim) % flat_sim.shape[1],
                          np.argmax(flat_sim) % flat_sim.shape[1]])
    cpu_mode = batched_kde_mode(flat_sim[:, pix, None], device="cpu")
    step = float(flat_sim.max() - flat_sim.min()) / 4999
    mode_gap = float(np.abs(stats["mode"].ravel()[pix] - cpu_mode.ravel())
                     .max())
    log(f"physics loop (c): ensemble_statistics at {ert.shape} on {dev} and "
        f"wsse_per_simulation {wsse.shape} in {times['stats_ms']:.3f} ms "
        f"({card}); the mode against the CPU's on {pix.size} pixels "
        f"{mode_gap:.4e} (one grid step {step:.4e}); the other statistics "
        f"against the host's worst relative gap {worst:.3e} (gate 1e-6)")
    if not (mode_gap <= step * (1 + 1e-4) and worst <= 1e-6
            and np.isfinite(wsse).all()
            and all(np.isfinite(np.asarray(v, float)).all()
                    for v in stats.values())):
        raise RuntimeError("physics loop (c): statistics differ from the "
                           "CPU's")

    np.save(root / "cond0.npy", conditional)
    import importlib.util
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    dev_args = [] if dev.type == "cuda" else ["--device", "cpu"]
    proc, seconds = run_module_cli(
        ["plot", "--sim", str(e_path), "--conditional",
         str(root / "cond0.npy"), "--out-dir", str(root / "figs"),
         *dev_args], "physics loop (c) plot", dev)
    figs = sorted(q.name for q in (root / "figs").glob("*.png")) \
        if (root / "figs").exists() else []
    if has_mpl:
        ok = proc.returncode == 0 and len(figs) == 6
        log(f"physics loop (c): matplotlib present: plot wrote {figs} in "
            f"{seconds:.3f} s")
    else:
        last = (proc.stderr.strip().splitlines() or [""])[-1]
        ok = proc.returncode != 0 and "matplotlib" in last and not figs
        log(f"physics loop (c): matplotlib absent: plot exited "
            f"{proc.returncode} after {seconds:.3f} s naming it: {last!r}")
    if not ok:
        raise RuntimeError(f"plot: exit {proc.returncode}, figures {figs}:"
                           f"\n{proc.stderr[-3000:]}")
    times["plot_s"] = seconds
    return times


# ---------------------------------------------------------------------------
# 20. the mesh on one card
# ---------------------------------------------------------------------------

MESH_RANKS = 2
MESH_EXAMPLES = 400
MESH_CONDS = 16
MESH_TIMEOUT = 420.0
# tp_shard_params' min_dim (JAX's default) and the leaves it shards at
# V5E8_DP's widths
TP_MIN_DIM = 256
TP_LEAVES = 34


def mesh_posterior_cfg(configs):
    """The configs[3] model and sampler of phase 20 (c) and (e), the fused
    core in JAX's accurate mode, bf16_3x (held at phase 4's 1e-3)."""
    cfg = configs.DDIM_ENSEMBLE
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, ensemble_mega_accurate=True))


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def mesh_model(cfg, dev, seed: int):
    """cfg's model on `dev` with non-zero weights from `seed`, alike in
    every process."""
    from ertdx_torch.models import build_model
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax
    model = build_model(cfg.model, dev)
    params_from_jax(model, random_flax_tree(
        flax_shapes(model), np.random.default_rng(seed)))
    return model


def mesh_batches(cfg, dev, steps: int = TRAIN_STEPS) -> list:
    """Phase 20 (a)'s global batches and draws (x0, cond, t, eps), drawn
    alike in every process from one seed."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    b, m = cfg.train.batch_size, cfg.model
    return [(torch.randn(b, m.param_dim, generator=gen, device=dev),
             torch.rand(b, m.cond_length, m.cond_channels, generator=gen,
                        device=dev),
             torch.randint(0, cfg.diffusion.T, (b,), generator=gen,
                           device=dev),
             torch.randn(b, m.param_dim, generator=gen, device=dev))
            for _ in range(steps)]


def mesh_dataset(cfg, n: int):
    """Phase 20 (b) and (f)'s examples: (params (n, 29, 1), ert (n, L, C)
    float32)."""
    from ertdx_torch.doe import SurrogateDataGenerator
    p = SurrogateDataGenerator(seed=SEED).generate_training_samples(n, "lhs")
    ert = np.random.default_rng(SEED + 21).normal(
        50.0, 10.0, size=(n, cfg.model.cond_length, cfg.model.cond_channels)
    ).astype(np.float32)
    return p[..., None], ert


def mesh_posterior_inputs(pcfg, dev, n_cond: int):
    """Phase 20 (c)'s model, conditions and prior draw, alike in every
    process."""
    model = mesh_model(pcfg, dev, SEED + 22).eval()
    m = pcfg.model
    cond = torch.from_numpy(np.random.default_rng(SEED + 23).standard_normal(
        (n_cond, m.cond_length, m.cond_channels)).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    x_T = torch.randn(n_cond * pcfg.sample.uncertainty_samples, m.param_dim,
                      generator=gen, device=dev)
    return model, cond, x_T


def _named(model, tensors) -> dict:
    """{name: whole tensor on the CPU} of per-parameter tensors, gathered
    over a model axis (a collective where leaves are sharded)."""
    from ertdx_torch.parallel.mesh import whole_tensor
    return {n: whole_tensor(model, n, t).cpu() for n, t in tensors}


def _mesh_steps(train, sa, model, batches, cfg, dev, mesh):
    """train_steps on `mesh`: losses, ms, slab launches a step, step-1
    gradients and the parameters after the last step (whole)."""
    from ertdx_torch.diffusion import schedule_from_config
    alpha_bar = schedule_from_config(cfg.diffusion).alpha_bar.to(dev)
    lr = train.make_lr(cfg.train, TRAIN_STEPS)
    opt = train.create_optimizer(model, lr)
    out = {"losses": [], "ms": [], "counts": []}
    for x0, cond, t, noise in batches:
        before = dict(_Counts(sa).launches)
        sync(dev)
        t0 = time.perf_counter()
        loss = train.train_step(model, opt, x0, cond, t, noise,
                                alpha_bar=alpha_bar, lr=lr, mesh=mesh)
        sync(dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(loss))
        after = _Counts(sa).launches
        out["counts"].append({k: after[k] - before[k] for k in after})
        if "g1" not in out:
            out["g1"] = _named(model, ((n, p.grad) for n, p in
                                       model.named_parameters()))
    out["params"] = _named(model, model.named_parameters())
    return out


def mesh_job_steps(rank, spec, dev):
    """(a) five DP steps on make_mesh(data=2)."""
    from ertdx_torch import configs, train
    from ertdx_torch.ops import slab_attn as sa
    from ertdx_torch.parallel import make_mesh
    cfg = configs.experiment_from_dict(spec["cfg"])
    mesh = make_mesh(data=spec["world"], device=dev)
    model = mesh_model(cfg, dev, SEED + 20)
    return _mesh_steps(train, sa, model, mesh_batches(cfg, dev), cfg, dev,
                       mesh)


def mesh_job_train(rank, spec, dev):
    """(b) train(mesh=) for 2 epochs; rank 0 alone writes."""
    from ertdx_torch import configs, train
    from ertdx_torch.data import prepare_dataset
    from ertdx_torch.ops import slab_attn as sa
    from ertdx_torch.parallel import make_mesh
    cfg = configs.experiment_from_dict(spec["cfg"])
    ds = prepare_dataset(*mesh_dataset(cfg, spec["examples"]))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=2, step_checkpoint_every=1))
    writes = []
    save = train.ckpt_lib.save_checkpoint
    train.ckpt_lib.save_checkpoint = lambda *a, **k: (writes.append(
        str(a[0])), save(*a, **k))
    before = dict(_Counts(sa).launches)
    try:
        sync(dev)
        t0 = time.perf_counter()
        res = train.train(cfg, ds, checkpoint_dir=spec["ckdir"], device=dev,
                          mesh=make_mesh(data=spec["world"], device=dev))
        sync(dev)
    finally:
        train.ckpt_lib.save_checkpoint = save
    return {"train": res.train_history, "val": res.val_history,
            "writes": writes, "s": time.perf_counter() - t0,
            "steps": res.state.step,
            "counts": {k: v - before[k]
                       for k, v in _Counts(sa).launches.items()},
            "params": _named(res.state.model,
                             res.state.model.named_parameters())}


def mesh_job_posterior(rank, spec, dev):
    """(c) the configs[3] posterior over the conditions on the mesh."""
    from ertdx_torch import configs, sample
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.ops import core_block as cb
    from ertdx_torch.parallel import make_mesh
    pcfg = configs.experiment_from_dict(spec["pcfg"])
    model, cond, x_T = mesh_posterior_inputs(pcfg, dev, spec["conds"])
    mesh = make_mesh(data=spec["world"], device=dev)
    with torch.no_grad():           # first encoder call: library set-up
        model.encode_condition(cond[:1])
    sync(dev)
    cb.reset_launches()
    t0 = time.perf_counter()
    u = sample.posterior_ensemble(
        model, cond, schedule_from_config(pcfg.diffusion),
        pcfg.sample.uncertainty_samples, pcfg.sample, x_T=x_T, device=dev,
        mesh=mesh)
    sync(dev)
    return {"u": u.cpu(), "s": time.perf_counter() - t0,
            "launches": dict(cb.launches)}


def mesh_job_tp(rank, spec, dev):
    """(d) one TP step on make_mesh(data=1, model=2)."""
    from ertdx_torch import configs, train
    from ertdx_torch.ops import slab_attn as sa
    from ertdx_torch.parallel import make_mesh, tp_shard_params
    cfg = configs.experiment_from_dict(spec["cfg"])
    mesh = make_mesh(data=1, model=spec["world"], device=dev)
    model = tp_shard_params(mesh_model(cfg, dev, SEED + 20), mesh,
                            min_dim=spec["tp_min_dim"])
    out = _mesh_steps(train, sa, model, mesh_batches(cfg, dev)[:1], cfg,
                      dev, mesh)
    out["leaves"] = sorted(model.tp_leaves)
    out["fused_conv"] = any(hasattr(m, "fused1") for m in model.modules())
    return out


def mesh_job_nccl(rank, spec, dev):
    """(e) in a 1-rank NCCL world: (a)'s mesh path for one step and a
    2 x 1000 DDIM-50 ensemble, each beside the no-mesh path. With cuDNN's
    default algorithms two steps of the same code differed by up to
    7.4e-7 relative on the card, so cuDNN runs its deterministic ones
    here."""
    from ertdx_torch import configs, sample, train
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.ops import slab_attn as sa
    from ertdx_torch.parallel import make_mesh
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = configs.experiment_from_dict(spec["cfg"])
    mesh = make_mesh(data=1, device=dev)
    batches = mesh_batches(cfg, dev)[:1]
    out = {"backend": torch.distributed.get_backend()}
    for tag, m in (("mesh", mesh), ("plain", None)):
        model = mesh_model(cfg, dev, SEED + 20)
        out[tag] = _mesh_steps(train, sa, model, batches, cfg, dev, m)
    pcfg = configs.experiment_from_dict(spec["pcfg"])
    model, cond, x_T = mesh_posterior_inputs(pcfg, dev, 2)
    sch = schedule_from_config(pcfg.diffusion)
    for tag, m in (("u_mesh", mesh), ("u_plain", None)):
        out[tag] = sample.posterior_ensemble(
            model, cond, sch, pcfg.sample.uncertainty_samples, pcfg.sample,
            x_T=x_T, device=dev, mesh=m).cpu()
    return out


def mesh_rank(rank: int, world: int, port: int, spec_path: str) -> None:
    """One rank of a phase 20 world (spawned): join the group, run the
    spec's jobs, write each job's result to <root>/<job>.r<rank>.pt."""
    import pickle

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    from ertdx_torch.parallel.mesh import rank_device
    from ertdx_torch.parallel.multihost import init_distributed
    dev = rank_device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(f"localhost:{port}", world, rank,
                     device=spec["device"])
    try:
        for job in spec["jobs"]:
            result = globals()[f"mesh_job_{job}"](rank, spec, dev)
            torch.save(result, Path(spec["root"]) / f"{job}.r{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def run_mesh_world(world: int, spec: dict, root: Path) -> list:
    """Start `world` ranks of `mesh_rank` (spawn), wait for all, and
    return each rank's results {job: result}. A rank that fails or a
    world past MESH_TIMEOUT kills every rank and fails the phase."""
    import pickle
    import torch.multiprocessing as tmp

    spec = {**spec, "world": world, "root": str(root)}
    spec_path = root / f"spec_{'_'.join(spec['jobs'])}.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    ctx = tmp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=mesh_rank,
                         args=(r, world, port, str(spec_path)))
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + MESH_TIMEOUT
    try:
        while any(proc.exitcode is None for proc in procs):
            bad = [r for r, proc in enumerate(procs)
                   if proc.exitcode not in (None, 0)]
            if bad:
                raise RuntimeError(f"mesh world {spec['jobs']}: rank(s) "
                                   f"{bad} failed")
            if time.monotonic() > deadline:
                raise RuntimeError(f"mesh world {spec['jobs']}: past "
                                   f"{MESH_TIMEOUT} s")
            time.sleep(0.1)
        bad = [r for r, proc in enumerate(procs) if proc.exitcode != 0]
        if bad:
            raise RuntimeError(f"mesh world {spec['jobs']}: rank(s) {bad} "
                               "failed")
    finally:
        for proc in procs:
            if proc.exitcode is None:
                proc.kill()
            proc.join()
    return [{job: torch.load(root / f"{job}.r{r}.pt", weights_only=False)
             for job in spec["jobs"]} for r in range(world)]


def _mesh_gates(label, got, want, lr, steps, g_key="g1") -> None:
    """Phase 7's gates for a mesh run against the single process: losses
    within max(1e-5, 0) x max(1, loss) (the single process reruns bit
    for bit), step-1 gradients at 1e-4 x max(1, max|g|), parameters
    within 2 lr a step of each other but for 0.1 % of the entries."""
    for step, (a, c) in enumerate(zip(got["losses"], want["losses"])):
        if not abs(a - c) <= 1e-5 * max(1.0, abs(c)):
            raise RuntimeError(f"{label} step {step + 1}: loss {a} vs the "
                               f"single process {c}")
    worst = _compare_grads(label, got[g_key], want[g_key])
    diffs = torch.cat([(got["params"][n] - w).abs().reshape(-1)
                       for n, w in want["params"].items()])
    share = float((diffs > 1e-5).float().mean())
    log(f"{label}: losses {got['losses']} vs {want['losses']}; step-1 "
        f"gradients worst err/tol {worst:.3f}; params max|d| "
        f"{float(diffs.max()):.3e} (bound {2 * lr * steps:.1e}), share > "
        f"1e-5 {share:.3e} (limit 1e-3)")
    if not (float(diffs.max()) <= 2 * lr * steps + 1e-6 and share <= 1e-3):
        raise RuntimeError(f"{label}: parameters disagree with the single "
                           "process")


def check_mesh_cli(cfg, first_epoch, root: Path, card: str) -> float:
    """(f) the CLI's train --mesh-data 2 under torch.distributed.run for
    one epoch, against (b)'s first epoch."""
    params, ert = mesh_dataset(cfg, MESH_EXAMPLES)
    np.save(root / "p.npy", params)
    np.save(root / "e.npy", ert)
    env = {**os.environ, "PYTHONPATH": os.path.dirname(
        os.path.abspath(__file__))}
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(MESH_RANKS), "-m", "ertdx_torch.cli",
            "train", "--params", str(root / "p.npy"), "--ert",
            str(root / "e.npy"), "--preset", "v5e8_dp", "--dtype",
            cfg.model.dtype, "--epochs", "1", "--checkpoint-dir",
            str(root / "cli_ck"), "--log-file", str(root / "cli.jsonl"),
            "--mesh-data", str(MESH_RANKS)]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=str(root), env=env, capture_output=True,
                          text=True, timeout=MESH_TIMEOUT)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"CLI on the mesh: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    recs = [json.loads(line) for line in
            (root / "cli.jsonl").read_text().splitlines()]
    hist = [(r["train_loss"], r["val_loss"]) for r in recs
            if "train_loss" in r]
    printed = proc.stdout.count("best val loss")
    log(f"CLI train --mesh-data {MESH_RANKS} (torch.distributed.run, "
        f"{seconds:.3f} s by the host clock; {card}): history {hist} vs "
        f"(b)'s first epoch {first_epoch}; 'best val loss' printed "
        f"{printed} time(s)")
    if len(hist) != 1 or printed != 1 or not all(
            abs(g - w) <= 1e-5 * max(1.0, abs(w))
            for g, w in zip(hist[0], first_epoch)):
        raise RuntimeError("CLI on the mesh disagrees with (b)'s first "
                           "epoch")
    return seconds


def check_mesh_phase(dev, card: str, root: Path) -> dict:
    """Phase 20: the mesh on one card, (a)-(f)."""
    from ertdx_torch import configs, sample, train
    from ertdx_torch.data import prepare_dataset
    from ertdx_torch.diffusion import schedule_from_config
    from ertdx_torch.ops import core_block as cb
    from ertdx_torch.ops import slab_attn as sa
    from ertdx_torch.utils import checkpoint as ckpt_lib
    from ertdx_torch.utils.weights import named_from_jax

    cfg = train_cfg(configs)
    pcfg = mesh_posterior_cfg(configs)
    lr = cfg.train.lr
    spec = {"cfg": dataclasses.asdict(cfg), "pcfg": dataclasses.asdict(pcfg),
            "device": dev.type, "examples": MESH_EXAMPLES,
            "conds": MESH_CONDS, "ckdir": str(root / "ck"),
            "tp_min_dim": TP_MIN_DIM}

    # the single process's references
    t0 = time.perf_counter()
    single = _mesh_steps(train, sa, mesh_model(cfg, dev, SEED + 20),
                         mesh_batches(cfg, dev), cfg, dev, None)
    step1 = _mesh_steps(train, sa, mesh_model(cfg, dev, SEED + 20),
                        mesh_batches(cfg, dev)[:1], cfg, dev, None)
    ds = prepare_dataset(*mesh_dataset(cfg, MESH_EXAMPLES))
    ref = train.train(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=2, checkpoint_dir="")), ds, device=dev)
    model, cond, x_T = mesh_posterior_inputs(pcfg, dev, MESH_CONDS)
    sync(dev)
    t_u = time.perf_counter()
    u_single = sample.posterior_ensemble(
        model, cond, schedule_from_config(pcfg.diffusion),
        pcfg.sample.uncertainty_samples, pcfg.sample, x_T=x_T,
        device=dev).cpu()
    single_u_s = time.perf_counter() - t_u
    del model, cond, x_T
    log(f"mesh references in this process: {time.perf_counter() - t0:.3f} "
        f"s; steps {single['losses']}, train() {ref.train_history} / "
        f"{ref.val_history}, the {MESH_CONDS} x "
        f"{pcfg.sample.uncertainty_samples} posterior in {single_u_s:.3f} s")

    # (a)-(d): two ranks on the one card over gloo
    t0 = time.perf_counter()
    ranks = run_mesh_world(MESH_RANKS, {**spec, "jobs": [
        "steps", "train", "posterior", "tp"]}, root)
    log(f"mesh world of {MESH_RANKS} ranks over gloo on {dev}: "
        f"{time.perf_counter() - t0:.3f} s, the ranks' start included")
    out = {}
    for r, res in enumerate(ranks):
        a = res["steps"]
        _mesh_gates(f"(a) rank {r} DP steps", a, single, lr, TRAIN_STEPS)
        for step, cnt in enumerate(a["counts"]):
            expect_launches(f"(a) rank {r} step {step + 1}", cnt,
                            SLAB_ONEPASS_STEP)
        ms = statistics.median(a["ms"][1:])
        log(f"(a) rank {r}: {ms:.3f} ms a DP step (median of steps "
            f"2-{TRAIN_STEPS}, 128 rows a rank; two ranks share one card, "
            f"so this says nothing about scaling; {card}); the single "
            f"process {statistics.median(single['ms'][1:]):.3f} ms a b256 "
            f"step; step times {[round(t, 3) for t in a['ms']]}")
        out.setdefault("dp_step_ms", []).append(ms)

        b = res["train"]
        for got, want in ((b["train"], ref.train_history),
                          (b["val"], ref.val_history)):
            if not np.allclose(got, want, rtol=1e-5, atol=0.0):
                raise RuntimeError(f"(b) rank {r}: history {got} vs the "
                                   f"single process {want}")
        log(f"(b) rank {r}: train(mesh=) {b['s']:.3f} s, {b['steps']} "
            f"steps, history {b['train']} / {b['val']}, checkpoint writes "
            f"{len(b['writes'])}, slab launches {b['counts']}")
        if (r == 0) != bool(b["writes"]):
            raise RuntimeError(f"(b) rank {r} wrote {b['writes']}")

        c = res["posterior"]
        expect_launches(f"(c) rank {r}", c["launches"],
                        {"fused_core_stack": pcfg.sample.ddim_steps})
        du = float((c["u"] - u_single).abs().max())
        dmean = float((c["u"].mean(0) - u_single.mean(0)).abs().max())
        dstd = float((c["u"].std(0) - u_single.std(0)).abs().max())
        log(f"(c) rank {r}: {MESH_CONDS // MESH_RANKS} conditions x "
            f"{pcfg.sample.uncertainty_samples} a rank in {c['s']:.3f} s "
            f"(this process: {MESH_CONDS} in {single_u_s:.3f} s; {card}); "
            f"vs the single process max|du|={du:.3e} max|dmean|="
            f"{dmean:.3e} max|dstd|={dstd:.3e}")
        if not (du <= 1e-3 and dmean <= 1e-3 and dstd <= 1e-3
                and tuple(c["u"].shape) == tuple(u_single.shape)):
            raise RuntimeError(f"(c) rank {r}: draws disagree")

        d = res["tp"]
        _mesh_gates(f"(d) rank {r} TP step", d, step1, lr, 1)
        expect_launches(f"(d) rank {r}", d["counts"][0], SLAB_ONEPASS_STEP)
        if r == 0:
            log(f"(d) tp_shard_params sharded {len(d['leaves'])} leaves: "
                f"{d['leaves']}")
            conv = ("in this model" if d["fused_conv"]
                    else "not in this model: pallas_conv is off")
            log("(d) kernel routes: the slab kernels read the gathered "
                f"QKV activations; a fused GN+SiLU+conv3 kernel ({conv}) "
                "and the fused core (mega_weights) take their weights "
                "gathered whole (full_param), as GSPMD replicates a "
                f"pallas_call's operands; {d['ms'][0]:.3f} ms the TP step")
            if len(d["leaves"]) != TP_LEAVES:
                raise RuntimeError(f"(d) {len(d['leaves'])} sharded leaves,"
                                   f" expected {TP_LEAVES}")

    # rank 0's checkpoints restore in the port's reader
    best, meta, _ = train.load_best_model(spec["ckdir"], cfg, device=dev)
    tree, _, _ = ckpt_lib.restore_checkpoint(Path(spec["ckdir"]) / "last")
    last = named_from_jax(best.model, tree["params"])
    same = all(torch.equal(last[n], p) for n, p in
               ranks[0]["train"]["params"].items())
    log(f"(b) checkpoints: best (epoch {meta['epoch']}) restores; last "
        f"equals rank 0's trained parameters bit for bit: {same}")
    if not same:
        raise RuntimeError("(b) the last checkpoint differs from rank 0's "
                           "parameters")

    # (e): a 1-rank NCCL world (gloo on the CPU)
    t0 = time.perf_counter()
    (e,) = run_mesh_world(1, {**spec, "jobs": ["nccl"]}, root)
    e = e["nccl"]

    def rel_step(a, b):
        """The loss's and the parameters' largest relative gaps."""
        dl = abs(a["losses"][0] - b["losses"][0]) / max(
            1.0, abs(b["losses"][0]))
        dp = max(float((a["params"][n] - p).abs().max())
                 / max(1.0, float(p.abs().max()))
                 for n, p in b["params"].items())
        return dl, dp

    dl, dp = rel_step(e["mesh"], e["plain"])
    du = float((e["u_mesh"] - e["u_plain"]).abs().max()) / max(
        1.0, float(e["u_plain"].abs().max()))
    log(f"(e) 1-rank {e['backend']} world ({time.perf_counter() - t0:.3f} "
        f"s): mesh vs no-mesh step loss {dl:.3e}, params {dp:.3e}, 2 x "
        f"{pcfg.sample.uncertainty_samples} DDIM ensemble {du:.3e} "
        f"(relative; gate 1e-6)")
    if not (dl <= 1e-6 and dp <= 1e-6 and du <= 1e-6):
        raise RuntimeError("(e) the 1-rank mesh differs from no mesh")

    # (f): the CLI under torch.distributed.run
    out["cli_s"] = check_mesh_cli(
        cfg, (ref.train_history[0], ref.val_history[0]), root, card)
    return out


# ---------------------------------------------------------------------------
# 21. the default main path: the fused core's one-pass mode
# ---------------------------------------------------------------------------

def serving_setup(dev):
    """configs[3] as shipped (DDIM_ENSEMBLE: random weights from SEED
    through params_from_jax), its 8 conditions and x_T: phases 4 and
    21."""
    from ertdx_torch import configs
    from ertdx_torch.models import build_model
    from ertdx_torch.utils.weights import flax_shapes, params_from_jax
    cfg = configs.DDIM_ENSEMBLE
    model = build_model(cfg.model, device=dev).eval()
    rng = np.random.default_rng(SEED)
    params_from_jax(model, random_flax_tree(flax_shapes(model), rng))
    n_cond = 8
    cond = torch.from_numpy(rng.standard_normal(
        (n_cond, cfg.model.cond_length, cfg.model.cond_channels)
    ).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x_T = torch.randn(n_cond * cfg.sample.uncertainty_samples,
                      cfg.model.param_dim, generator=gen, device=dev)
    return cfg, model, cond, x_T


def moments_gap(label, u, ref) -> float:
    """Fail unless the ensemble mean and std of each condition and
    parameter of u (members, conditions, P) lie within 5e-2 x max(1,
    |ref's|) of ref's; log them and the draws' max gap, return it."""
    gaps = {}
    for stat, fn in (("mean", lambda a: a.mean(0)),
                     ("std", lambda a: a.std(0))):
        a, b = fn(u), fn(ref)
        gaps[stat] = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
    du = float((u - ref).abs().max())
    log(f"{label}: max|dmean| / max(1, |mean|) = {gaps['mean']:.3e}, "
        f"max|dstd| / max(1, |std|) = {gaps['std']:.3e} (gate 5e-2); the "
        f"draws' max gap {du:.3e}, max|u| {float(ref.abs().max()):.4f}")
    if not (torch.isfinite(u).all() and max(gaps.values()) <= 5e-2):
        raise RuntimeError(f"{label}: the ensemble moments disagree")
    return du


def check_onepass_serving(cb, dev, card) -> dict:
    """Phase 21: configs[3] as shipped, in the fused core's one-pass
    mode, JAX's default: (a) 8 x 1000 members by DDIM-50 with exactly 50
    one-pass fused_core_stack launches and no bf16_3x one, then the
    inverse pipeline; (b) the same run with accurate=True from the same
    x_T, the moments within `moments_gap`'s band; (c) the first step's
    denoiser call (its kernel inputs captured in (a)) under
    `onepass_gate`; (d) both modes' ms per DDIM step, in turns (one-pass,
    accurate, accurate, one-pass; reruns bit-identical); (e) the
    per-block variant over 2 conditions in the one-pass mode, 200
    one-pass fused_core_block launches, its moments against (a)'s."""
    from ertdx_torch import sample
    from ertdx_torch.diffusion import sample_ddim, schedule_from_config
    from ertdx_torch.models import mega
    from ertdx_torch.params import ParameterSpace
    from ertdx_torch.transforms import MinMaxScaler

    cfg, model, cond, x_T = serving_setup(dev)
    if model.ensemble_mega_accurate:
        raise RuntimeError("configs[3] does not ship JAX's default mode")
    schedule = schedule_from_config(cfg.diffusion)
    n_cond, n_real = cond.shape[0], cfg.sample.uncertainty_samples
    steps, nb = cfg.sample.ddim_steps, cfg.model.num_blocks
    first = []
    stack_fn = mega.fused_core_stack

    def capture(*args, **kw):
        if not first:
            first.append(([a.clone() if torch.is_tensor(a) else a
                           for a in args], kw))
        return stack_fn(*args, **kw)

    def run(label, accurate):
        model.ensemble_mega_accurate = accurate
        cb.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = sample.posterior_ensemble(model, cond, schedule, n_real,
                                      cfg.sample, x_T=x_T, device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        one = cb.onepass_launches["fused_core_stack"]
        expect_launches(label, {"one-pass": one, "bf16_3x":
                                cb.launches["fused_core_stack"] - one},
                        {"one-pass": 0 if accurate else steps,
                         "bf16_3x": steps if accurate else 0})
        return u, ms

    mega.fused_core_stack = capture
    try:
        u1, ms1 = run("(a) one-pass ensemble", False)
    finally:
        mega.fused_core_stack = stack_fn
    if tuple(u1.shape) != (n_real, n_cond, cfg.model.param_dim):
        raise RuntimeError("(a) one-pass ensemble: wrong shape")
    space = ParameterSpace()
    phys, mask = sample.inverse_pipeline(
        u1, MinMaxScaler.fit(space.plims.T), space=space)
    if phys.shape != tuple(u1.shape) or not np.isfinite(phys).all():
        raise RuntimeError("(a) inverse pipeline: bad output")
    log(f"(a) inverse pipeline: valid fraction {float(mask.mean()):.6f}")

    u3, ms3 = run("(b) accurate=True ensemble", True)
    du = moments_gap("(b) one-pass vs accurate=True", u1, u3)

    args, kw = first[0]
    p = kw["p"]
    with torch.no_grad():
        got = stack_fn(*args, **kw)
        torch.cuda.synchronize()
        onepass_gate("(c) the first step's denoiser call", got,
                     cb.fused_core_stack_onepass_plain(*args, p=p),
                     cb.fused_core_stack_plain(*_double(args), p=p),
                     stack=True, same_fn=False)

    u3b, ms3b = run("(d) accurate=True again", True)
    u1b, ms1b = run("(d) one-pass again", False)
    if not (torch.equal(u1, u1b) and torch.equal(u3, u3b)):
        raise RuntimeError("(d) a rerun differs")
    log(f"(d) ms per DDIM step (8 x 1000, host clock, in turns): one-pass "
        f"{ms1:.3f} / {ms1b:.3f} (the first with the input capture), "
        f"accurate=True {ms3:.3f} / {ms3b:.3f}; reruns bit-identical; "
        f"{card}")

    nb_cond = 2
    model.ensemble_mega_accurate = False
    with torch.no_grad():
        ctx = model.encode_condition(cond[:nb_cond])
        weights = mega.mega_weights(model)
        cross = mega.mega_cross_kv(weights, ctx, stack=False, accurate=False)
        cb.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ub = sample_ddim(
            lambda x, t: mega.mega_denoise_ensemble(
                model, x, t, ctx, n_real, p=cfg.model.param_dim,
                d=cfg.model.hidden_dim, num_blocks=nb, chunk=n_real,
                accurate=False, stack=False, weights=weights, cross=cross),
            (nb_cond * n_real, cfg.model.param_dim), schedule, steps,
            x_T=x_T[:nb_cond * n_real], device=dev)
        torch.cuda.synchronize()
        block_ms = (time.perf_counter() - t0) / steps * 1e3
    expect_launches("(e) per-block one-pass", {
        "one-pass": cb.onepass_launches["fused_core_block"],
        "bf16_3x": cb.launches["fused_core_block"]
        - cb.onepass_launches["fused_core_block"]},
        {"one-pass": steps * nb, "bf16_3x": 0})
    ub = ub.reshape(nb_cond, n_real, -1).transpose(0, 1)
    moments_gap("(e) per-block one-pass vs the stack", ub, u1[:, :nb_cond])
    log(f"(e) per-block one-pass: {block_ms:.3f} ms per DDIM step "
        f"({nb_cond} conditions x {n_real} members; {card})")
    return {"onepass_step_ms": [ms1, ms1b], "accurate_step_ms": [ms3, ms3b],
            "du": du, "block_step_ms": block_ms,
            "launches": {"fused_core_stack_onepass": steps,
                         "fused_core_block_onepass": steps * nb}}


def _gate_call(tag: str, route: str, fn):
    """fn() on the card with every kernel counter at 0 before it: no
    launch after it, and a warning of the plain one-pass version exactly
    where `route` is "onepass_plain"; returns fn's result."""
    import warnings
    reset_all_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = fn()
    torch.cuda.synchronize()
    launched = {k: v for k, v in all_launches().items() if v}
    warned = [str(w.message) for w in caught
              if "plain one-pass" in str(w.message)]
    log(f"gates: {tag}: route {route}, launches {launched or 'none'}, "
        f"warnings {warned or 'none'}")
    if launched or bool(warned) != (route == "onepass_plain"):
        raise RuntimeError(f"gates: {tag}: launches {launched}, warnings "
                           f"{warned} on the {route} route")
    return got


def check_conv_gate(cv, dev) -> None:
    """Phase 22, the fused conv: at Cout = 12 (JAX's kernel takes it, the
    wgmma kernels take multiples of 8) gn_silu_conv3 runs the plain
    one-pass version on the card, warned, with no launch, forward and
    backward bit for bit `GNSiLUConv3OnepassPlain`'s and under the
    one-pass rule against the float32 function in float64; the same
    inputs on the CPU run the float32 plain version bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 221)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    b, l, c, cout = 4, 147, 64, 12
    ins = (rnd(b, l, c), rnd(c, scale=0.3, shift=1.0), rnd(c, scale=0.3),
           rnd(3, c, cout, scale=1.0 / math.sqrt(3 * c)),
           rnd(cout, scale=0.3))
    dy = rnd(b, l, cout)
    route = cv.conv_route(b, l, c, cout, GROUPS, dev)
    leaves = [t.detach().requires_grad_(True) for t in ins]

    def conv_step():
        out = cv.gn_silu_conv3(*leaves, GROUPS)
        out.backward(dy)
        return out.detach()

    got = _gate_call(f"fused conv B={b} L={l} C={c} Cout={cout}", route,
                     conv_step)
    onepass = cv.reference_gn_silu_conv3_onepass(*ins, GROUPS)
    donepass = cv.reference_gn_silu_conv3_onepass_backward(*ins, dy, GROUPS)
    ins64 = [t.double() for t in ins]
    exact = cv.reference_gn_silu_conv3(*ins64, GROUPS)
    dexact = cv.reference_gn_silu_conv3_backward(*ins64, dy.double(),
                                                 GROUPS)
    same = [torch.equal(got, onepass)] + [
        torch.equal(leaf.grad, d) for leaf, d in zip(leaves, donepass)]
    onepass_gate("gates: fused conv Cout=12 y", got, onepass, exact,
                 stack=False)
    for name, leaf, d, e in zip(("dx", "dgamma", "dbeta", "dW"), leaves,
                                donepass, dexact):
        onepass_gate(f"gates: fused conv Cout=12 {name}", leaf.grad, d, e,
                     stack=False)
    cpu = [t.cpu() for t in ins]
    cpu_route = cv.conv_route(b, l, c, cout, GROUPS, "cpu")
    on_cpu = _gate_call("fused conv on CPU tensors", cpu_route,
                        lambda: cv.gn_silu_conv3(*cpu, GROUPS))
    f32 = torch.equal(on_cpu, cv.reference_gn_silu_conv3(*cpu, GROUPS))
    log(f"gates: fused conv routes {route} (card) and {cpu_route} (CPU); "
        f"the card's forward and gradients the plain one-pass version's "
        f"bit for bit: {same}; the CPU's the float32 plain version's: "
        f"{f32}")
    if (route, cpu_route) != ("onepass_plain", "float32") or \
            not all(same) or not f32:
        raise RuntimeError("gates: the fused conv's routes are not JAX's")


def check_gates(ea, sa, cb, cv, dev, card: str) -> None:
    """Phase 22: the one-pass gates on the card. One shape of each kernel
    family where JAX's gate takes its kernel and the port's kernel does
    not (cross attention with Lk=300 at D=128, self attention at P=40, the
    slab at dh=128, the fused conv at Cout=12, the fused core at Lk=300
    through `mega_plan` and `mega_denoise_ensemble`) runs the plain
    one-pass version with no kernel launch, warned, and passes the
    one-pass rule against the float32 function (in float64; the core's
    against its float32 module path); a shape JAX refuses (self attention
    at D=64) and the fused conv on CPU tensors run the float32 plain
    version bit for bit, with no launch and no warning."""
    from ertdx_torch.models import mega

    gen = torch.Generator(device=dev).manual_seed(SEED + 220)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    with torch.no_grad():
        q = rnd(2, 8 * 29, 128)
        k, v = rnd(2, 300, 256).chunk(2, dim=-1)
        route = ea.folded_cross_route(2, 8 * 29, 300, 128, dev)
        got = _gate_call("folded cross B=2 Lq=232 Lk=300 D=128", route,
                         lambda: ea.folded_cross_attention(q, k, v))
        onepass = ea.reference_attention_onepass(q, k, v)
        onepass_gate("gates: folded cross Lk=300", got, onepass,
                     ea.reference_attention(q.double(), k.double(),
                                            v.double()), stack=False)
        q, k, v = rnd(16, 40, 3 * 128).chunk(3, dim=-1)
        route_self = ea.block_self_route(16, 40, 128, dev)
        got_self = _gate_call("block self N=16 P=40 D=128", route_self,
                              lambda: ea.block_self_attention(q, k, v))
        onepass_self = ea.reference_attention_onepass(q, k, v)
        onepass_gate("gates: block self P=40", got_self, onepass_self,
                     ea.reference_attention(q.double(), k.double(),
                                            v.double()), stack=False)
        q, k, v = rnd(16, 29, 3 * 64).chunk(3, dim=-1)
        route64 = ea.block_self_route(16, 29, 64, dev)
        got64 = _gate_call("block self N=16 P=29 D=64", route64,
                           lambda: ea.block_self_attention(q, k, v))
    same = [torch.equal(got, onepass), torch.equal(got_self, onepass_self),
            torch.equal(got64, ea.reference_attention(q, k, v))]
    log(f"gates: ensemble routes {route}, {route_self}, {route64}; each "
        f"the plain version of its route bit for bit: {same}")
    if (route, route_self, route64) != ("onepass_plain", "onepass_plain",
                                        "float32") or not all(same):
        raise RuntimeError("gates: the ensemble routes are not JAX's")

    b, l, c, nh = 8, 147, 256, 2                  # dh = 128
    route = sa.slab_route(b, l, c, nh, dev)
    qkv, do = rnd(b, l, 3 * c), rnd(b, l, c)
    z = qkv.detach().requires_grad_(True)

    def slab_step():
        out = sa.slab_attention(z, nh)
        out.backward(do)
        return out.detach()

    got = _gate_call(f"slab B={b} L={l} C={c} H={nh}", route, slab_step)
    for tag, g, onepass, exact in (
            ("forward", got, sa.reference_slab_attention_onepass(qkv, nh),
             sa.reference_slab_attention(qkv.double(), nh)),
            ("backward", z.grad,
             sa.reference_slab_attention_onepass_backward(qkv, do, nh),
             sa.reference_slab_attention_backward(qkv.double(),
                                                  do.double(), nh))):
        onepass_gate(f"gates: slab dh=128 {tag}", g, onepass, exact,
                     stack=False)
    if route != "onepass_plain":
        raise RuntimeError(f"gates: the slab at dh=128 takes route {route}")
    check_conv_gate(cv, dev)

    cfg, model, _, _ = serving_setup(dev)
    cond_len = 9600                           # 300 condition tokens
    r = mega.MIN_TOTAL_CHAINS
    lk = mega.cond_token_len(model, cond_len)
    route = mega.mega_route(model, r, 1, cond_len, dev)
    stack_args = []
    plain_stack = cb.fused_core_stack_onepass_plain
    versions = mega.plain_versions

    def capture(*args, **kw):
        stack_args.append((args, kw))
        return plain_stack(*args, **kw)

    with torch.no_grad():
        cond = rnd(1, cond_len, cfg.model.cond_channels)
        ctx = model.encode_condition(cond)
        x = rnd(r, cfg.model.param_dim)
        t = torch.full((r,), 250, device=dev, dtype=torch.long)
        weights = mega.mega_weights(model)

        def core_call():
            plan = mega.mega_plan(model, r, 1, cond_len, dev)
            if not plan or not plan.get("plain"):
                raise RuntimeError(f"gates: core plan {plan}")
            return mega.mega_denoise_ensemble(model, x, t, ctx, r,
                                              weights=weights, **plan)

        mega.plain_versions = lambda accurate: (
            versions(accurate) if accurate else
            (capture, versions(accurate)[1]))
        try:
            t0 = time.perf_counter()
            got = _gate_call(f"fused core R={r} Lk={lk}", route, core_call)
            plain_ms = (time.perf_counter() - t0) * 1e3
        finally:
            mega.plain_versions = versions
        if len(stack_args) != 1:
            raise RuntimeError(f"gates: the core ran the plain one-pass "
                               f"stack {len(stack_args)} times")
        # the stack's own inputs, computed again apart from the route: the
        # plain one-pass stack in float32 (bit for bit the route's), in
        # float64 (the rms yardstick) and the float32 function in float64
        args, kw = stack_args[0]
        again = cb.fused_core_stack_onepass_plain(*args, **kw).reshape(
            got.shape)
        onepass64 = cb.fused_core_stack_onepass_plain(
            *_double(args), **kw).reshape(got.shape)
        exact = cb.fused_core_stack_plain(*_double(args), **kw).reshape(
            got.shape)
        set_ensemble_pallas(model, False)
        module = model.denoise_ensemble(x, t, ctx, r)
    onepass_gate(f"gates: fused core Lk={lk}", got, onepass64, exact,
                 stack=True, same_fn=False)
    gap = float((got - module).abs().max())
    band = 5e-2 * max(1.0, float(module.abs().max()))
    log(f"gates: fused core at Lk={lk}, R={r}: route {route}, the stack "
        f"again bit for bit: {torch.equal(got, again)}; max|route - the "
        f"float32 module path| {gap:.3e} (band {band:.3e}); one denoiser "
        f"call on the plain one-pass stack {plain_ms:.3f} ms by the host "
        f"clock; {card}")
    if route != "onepass_plain" or lk != 300:
        raise RuntimeError(f"gates: the core at Lk={lk} takes route "
                           f"{route}")
    if not torch.equal(got, again) or not gap <= band:
        raise RuntimeError("gates: the core's plain one-pass route is not "
                           "the plain one-pass stack of the model")


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
        from ertdx_torch.models.mega import (mega_cross_kv,
                                             mega_denoise_ensemble,
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
    check_bf16_tensor_cores(kernels.path, kernels.report,
                            CORE_ONEPASS_KERNELS + CORE_KERNELS,
                            "fused-core kernels (one-pass and bf16_3x)",
                            re.compile(r"HMMA\."), typed=False)
    check_no_spill(kernels.report, CORE_KERNELS + CORE_ONEPASS_KERNELS
                   + GN_KERNELS)
    check_bf16_mma_sync(kernels.path, kernels.report)
    check_wgmma(kernels.path, kernels.report)
    check_bf16_tensor_cores(kernels.path, kernels.report,
                            mma_sync=re.compile(r"HMMA\."))
    check_no_spill(kernels.report, CONV_BF16_KERNELS + GN_BF16_KERNELS
                   + SLAB_BF16_KERNELS)
    phase("build", t0)

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    results = check_kernels(cb, dev, card)
    phase("kernels", t0)

    # 4. main path: the configs[3] ensemble
    t0 = time.perf_counter()
    cfg, model, cond, x_T = serving_setup(dev)
    # JAX's bf16_3x, held at 1e-3 to the same run on its plain version;
    # phase 21 runs the preset's default, JAX's one-pass mode
    model.ensemble_mega_accurate = True
    schedule = schedule_from_config(cfg.diffusion)
    n_cond, n_real = cond.shape[0], cfg.sample.uncertainty_samples
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
    if main_launches["fused_core_stack"] != steps or \
            cb.onepass_launches["fused_core_stack"]:
        raise RuntimeError(f"fused_core_stack launched "
                           f"{main_launches['fused_core_stack']} times "
                           f"({cb.onepass_launches['fused_core_stack']} "
                           f"one-pass), expected {steps} bf16_3x")
    if tuple(u.shape) != (n_real, n_cond, cfg.model.param_dim) or \
            not torch.isfinite(u).all():
        raise RuntimeError("main path: wrong shape or non-finite draws")
    main_step_ms = run_s / steps * 1e3
    log(f"main path: {main_step_ms:.3f} ms per DDIM step, "
        f"{n_cond * n_real * steps / run_s:.1f} chain-steps/s, peak memory "
        f"{peak / 2**20:.1f} MiB; {card}")

    # the same function's plain path: the plain bf16_3x stack in place of
    # the kernel, through the same sampler from the same x_T
    t_plain = time.perf_counter()
    u_plain = plain_core_run(sample, lambda: sample.posterior_ensemble(
        model, cond, schedule, n_real, cfg.sample, x_T=x_T, device=dev))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t_plain
    if cb.launches["fused_core_stack"] != steps:
        raise RuntimeError("the plain bf16_3x path launched a kernel")
    model.ensemble_mega = False          # the float32 module path
    u_f32 = sample.posterior_ensemble(model, cond, schedule, n_real,
                                      cfg.sample, x_T=x_T, device=dev)
    torch.cuda.synchronize()
    model.ensemble_mega = True
    du = float((u - u_plain).abs().max())
    dmean = float((u.mean(0) - u_plain.mean(0)).abs().max())
    dstd = float((u.std(0) - u_plain.std(0)).abs().max())
    log(f"main path vs the plain bf16_3x path ({plain_s:.3f} s): max|du|="
        f"{du:.3e} max|dmean|={dmean:.3e} max|dstd|={dstd:.3e} max|u|="
        f"{float(u_plain.abs().max()):.4f}; vs the float32 module path: "
        f"max|du|={float((u - u_f32).abs().max()):.3e} max|dmean|="
        f"{float((u.mean(0) - u_f32.mean(0)).abs().max()):.3e} max|dstd|="
        f"{float((u.std(0) - u_f32.std(0)).abs().max()):.3e} (the plain "
        f"bf16_3x path's: max|du|="
        f"{float((u_plain - u_f32).abs().max()):.3e})")
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
        # what posterior_ensemble makes once a run: the weights' packs,
        # the cross K/V and their kernel operands
        weights = mega_weights(model)
        cross = mega_cross_kv(weights, ctx, stack=False,
                              accurate=model.ensemble_mega_accurate)
        cb.reset_launches()
        torch.cuda.synchronize()
        t_blk = time.perf_counter()
        ub = sample_ddim(
            lambda x, t: mega_denoise_ensemble(
                model, x, t, ctx, n_real, p=cfg.model.param_dim,
                d=cfg.model.hidden_dim, num_blocks=cfg.model.num_blocks,
                chunk=n_real, accurate=model.ensemble_mega_accurate,
                stack=False, weights=weights, cross=cross),
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

    # 6. slab attention kernels against their plain versions: the 3xTF32
    # kernels (accurate=True), the one-pass kernels on float32 slabs
    t0 = time.perf_counter()
    slab = check_slab(sa, dev)
    accurate_launches = {k: slab[k].pop("launches")
                         for k in ("slab_attention_fwd", "slab_attention_bwd")}
    slab_onepass = check_slab_onepass(sa, dev, card)
    phase("slab kernels", t0)

    # 7. training path: (a) train steps, kernel vs plain; (b) train()
    t0 = time.perf_counter()
    step_ms = check_training(sa, dev, card)
    train_launches = check_train_entry(sa, dev)
    share = (slab_onepass["slab_attention_fwd_onepass"]["ms"]
             + slab_onepass["slab_attention_bwd_onepass"]["ms"]) / \
        step_ms["kernel_step_ms"]
    log(f"one-pass slab kernels' share of the kernel-path train step: "
        f"{100 * share:.2f} %")
    phase("training path", t0)

    # 8. the one-pass ensemble attention kernels, float32 and bf16
    t0 = time.perf_counter()
    ensemble = check_ensemble(ea, dev, card)
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
        ens16_launches = check_bf16_ensemble_serving(ea, cb, dev, card)
        log(f"bf16 ms per b256 train step ({card}): the fused arm "
            f"{fused16_ms['kernel_step_ms']:.3f} (its plain path "
            f"{fused16_ms['plain_step_ms']:.3f}), phase 15's slab arm "
            f"{bf16_ms['kernel_step_ms']:.3f}, the flash arm's one step "
            f"{flash16_ms['kernel_step_ms']:.3f}; float32 fused arm (phase "
            f"11) {fused_ms['kernel_step_ms']:.3f}")
        phase("bf16 fused-encoder arm", t0)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    # 17. the user path: the port's CLI and posterior service
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ertdx_torch_user_")
    try:
        user = check_user_path(sa, cb, dev, card, Path(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"user path ({card}): train {user['train_s']:.3f} s, calibrate "
        f"{user['calibrate_arm_s']:.3f} s an arm, sample "
        f"{user['sample_s']:.3f} s, batched_kde_mode {user['kde_ms']:.3f} "
        f"ms, requests of {[b for b, _ in SERVE_REQUESTS]} conditions "
        f"{[round(ms, 3) for ms in user['request_ms']]} ms")
    phase("user path", t0)

    # 18. the reference model and the unconditional model: (a) REF_DEFAULT
    # train steps and train(), (b) the configs[0] posterior, (c) the .pth
    # route, (d) SYNTHETIC_GAUSSIAN and the configs[1] check
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ertdx_torch_mlp_")
    try:
        mlp = check_other_models(sample, dev, card, Path(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"reference and unconditional models ({card}): REF_DEFAULT "
        f"{mlp['ref_step_ms']:.4f} ms per train step (batch 32), "
        f"{mlp['ref_sample_ms']:.4f} ms per sampling step (400 chains); "
        f"SYNTHETIC_GAUSSIAN {mlp['uncond_step_ms']:.4f} ms per train "
        f"step (batch 64; {mlp['uncond_train_ms']:.4f} by the host clock "
        f"over train()), {mlp['uncond_sample_ms']:.4f} ms per sampling "
        f"step ({UNCOND_MEMBERS} chains)")
    phase("reference and unconditional models", t0)

    # 19. the physics loop: (a) the configs[3] posterior, (b) 50 members
    # through `simulate` on a stand-in PFLOTRAN and 5 through
    # run_posterior_validation, (c) gather-data, statistics and `plot`
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ertdx_torch_physics_")
    try:
        loop = check_physics_loop(dev, card, Path(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    loop["phase_s"] = time.perf_counter() - t0
    log(f"physics loop ({card}): {PHYS_MEMBERS} forward runs "
        f"{loop['forward_s']:.3f} s; one simulation's 14 .srv files "
        f"{loop['read_native_ms']:.3f} ms native against "
        f"{loop['read_numpy_ms']:.3f} ms by np.genfromtxt; the phase "
        f"{loop['phase_s']:.3f} s")
    phase("physics loop", t0)

    # 20. the mesh on one card: (a)-(d) two ranks over gloo, (e) a 1-rank
    # NCCL world, (f) the CLI under torch.distributed.run
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ertdx_torch_mesh_")
    try:
        meshed = check_mesh_phase(dev, card, Path(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"mesh on one card ({card}): DP step "
        f"{[round(ms, 3) for ms in meshed['dp_step_ms']]} ms a rank (two "
        f"ranks share one card: not a scaling figure); the CLI "
        f"{meshed['cli_s']:.3f} s; the phase "
        f"{time.perf_counter() - t0:.3f} s")
    phase("mesh on one card", t0)

    # 21. the default main path: configs[3] in the one-pass mode
    t0 = time.perf_counter()
    onepass = check_onepass_serving(cb, dev, card)
    one_ms = [round(ms, 3) for ms in onepass["onepass_step_ms"]]
    acc_ms = [round(ms, 3) for ms in onepass["accurate_step_ms"]]
    log(f"one-pass main path ({card}): {one_ms} ms per DDIM step against "
        f"{acc_ms} with accurate=True; the draws' max gap "
        f"{onepass['du']:.3e}; per-block {onepass['block_step_ms']:.3f}")
    phase("one-pass main path", t0)

    # 22. the one-pass gates on the card: shapes JAX's kernels take and the
    # port's do not run the plain one-pass version, a JAX-refused one the
    # float32 plain version
    t0 = time.perf_counter()
    check_gates(ea, sa, cb, cv, dev, card)
    phase("one-pass gates", t0)

    launches = {"fused_core_stack": main_launches["fused_core_stack"],
                "fused_core_block": block_launches["fused_core_block"],
                **train_launches, **accurate_launches,
                "block_self_attention": serve_launches,
                "folded_cross_attention": serve_launches,
                "block_self_attention_bf16": ens16_launches,
                "folded_cross_attention_bf16": ens16_launches,
                **fused_launches, **flash_launches,
                **{k: v for k, v in bf16_launches.items()
                   if k.endswith("_bf16")},
                **{k: v for k, v in fused16_launches.items()
                   if k.endswith("_bf16") and not k.startswith("slab_")},
                **onepass["launches"]}
    replaces = {"fused_core_stack": "ertdx/ops/core_block.py:440",
                "fused_core_block": "ertdx/ops/core_block.py:281",
                "fused_core_stack_onepass": "ertdx/ops/core_block.py:440",
                "fused_core_block_onepass": "ertdx/ops/core_block.py:281",
                "slab_attention_fwd": "ertdx/ops/slab_attn.py:147",
                "slab_attention_bwd": "ertdx/ops/slab_attn.py:184",
                "slab_attention_fwd_onepass": "ertdx/ops/slab_attn.py:147",
                "slab_attention_bwd_onepass": "ertdx/ops/slab_attn.py:184",
                "block_self_attention": "ertdx/ops/ensemble_attn.py:89",
                "folded_cross_attention": "ertdx/ops/ensemble_attn.py:187",
                "block_self_attention_bf16": "ertdx/ops/ensemble_attn.py:89",
                "folded_cross_attention_bf16":
                "ertdx/ops/ensemble_attn.py:187",
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
    sources = {"fused_core_stack": "ertdx_torch/csrc/core_onepass.cu",
               "fused_core_block": "ertdx_torch/csrc/core_onepass.cu",
               "fused_core_stack_onepass": "ertdx_torch/csrc/core_onepass.cu",
               "fused_core_block_onepass": "ertdx_torch/csrc/core_onepass.cu",
               "slab_attention_fwd": "ertdx_torch/csrc/slab_attn.cu",
               "slab_attention_bwd": "ertdx_torch/csrc/slab_attn.cu",
               **{name + dt: "ertdx_torch/csrc/ensemble_attn.cu"
                  for name in ENSEMBLE_NAMES for dt in ("", "_bf16")},
               "groupnorm_silu_fwd": "ertdx_torch/csrc/groupnorm.cu",
               "groupnorm_silu_bwd": "ertdx_torch/csrc/groupnorm.cu",
               "gn_silu_conv3_fwd": "ertdx_torch/csrc/gn_conv.cu",
               "gn_silu_conv3_bwd": "ertdx_torch/csrc/gn_conv.cu",
               **{name: "ertdx_torch/csrc/flash_attn.cu"
                  for name in FLASH_WANT},
               **{name: "ertdx_torch/csrc/slab_attn_bf16.cu"
                  for name in SLAB_BF16_WANT
                  if name.endswith(("_bf16", "_onepass"))},
               "groupnorm_silu_fwd_bf16": "ertdx_torch/csrc/groupnorm.cu",
               "groupnorm_silu_bwd_bf16": "ertdx_torch/csrc/groupnorm.cu",
               "gn_silu_conv3_fwd_bf16": "ertdx_torch/csrc/gn_conv.cu",
               "gn_silu_conv3_bwd_bf16": "ertdx_torch/csrc/gn_conv.cu"}
    # the kernel function of the entries whose source holds several
    functions = {name + dt: fn for name, fn in
                 zip(ENSEMBLE_NAMES, ENSEMBLE_KERNELS)
                 for dt in ("", "_bf16")}
    functions.update({
        "fused_core_stack": "core_stack_bf16x3_kernel",
        "fused_core_block": "core_block_bf16x3_kernel",
        "fused_core_stack_onepass": "core_stack_wgmma_kernel",
        "fused_core_block_onepass": "core_block_wgmma_kernel",
        "gn_silu_conv3_fwd": "tap3_wgmma_kernel<float, true, false, ...>",
        "gn_silu_conv3_bwd": "round_colsum_kernel, conv_dw_wgmma_kernel"
                             "<float>, tap3_wgmma_kernel<bf16, false, "
                             "true, ...>",
        "gn_silu_conv3_fwd_bf16": "tap3_wgmma_kernel<bf16, true, false, "
                                  "...>",
        "gn_silu_conv3_bwd_bf16": "conv_dw_wgmma_kernel<bf16>, "
                                  "tap3_wgmma_kernel<bf16, false, true, "
                                  "...>"})
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name],
         **({"kernel": functions[name]} if name in functions else {}),
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "bound_tc_ms": r["bound_tc_ms"],
         "bound_fp32_ms": r["bound_fp32_ms"],
         "library_ms": r.get("library_ms"), "shape": r["shape"],
         **{k: r[k] for k in ("tflops", "graph_ms", "library_graph_ms",
                              "rms_err_exact", "plain_rms_err_exact",
                              "max_err_exact", "rms_gap_plain",
                              "plain_spread") if k in r}}
        for name, r in {**results, **slab, **slab_onepass, **ensemble,
                        **gnconv, **flash, **slab_bf16,
                        **gnconv_bf16}.items()]}
    log(f"[phase] total: {time.perf_counter() - t_all:.3f} s")
    log(json.dumps(line))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
