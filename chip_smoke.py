#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each timed, each raising on failure (the script then exits
non-zero and prints no result line):

1. device: the card's name and power limit;
2. build: nvcc compiles ertdx_torch/csrc/*.cu (ertdx_torch/ops/_build.py)
   and prints ptxas' register and shared-memory report;
3. kernels: fused_core_stack and fused_core_block at full width (D=128,
   nb=4, P=29, Lk=147), every weight non-zero, held against their plain
   PyTorch versions (max abs error <= 1e-4 * max(1, max|plain|)) and timed
   with CUDA events; one JSON line {"kernels": [...]};
4. main path: the configs[3] posterior ensemble (CondUNet at
   DDIM_ENSEMBLE's full width, random weights from a seed carried over by
   params_from_jax, 8 conditions x 1000 members, DDIM-50, eta=0) through
   ertdx_torch.sample.posterior_ensemble, with exactly 50 fused_core_stack
   launches, held against the plain module path from the same x_T; then
   the inverse pipeline;
5. per-block path: the same DDIM run over 2 of the conditions through
   mega_denoise_ensemble(stack=False), i.e. fused_core_block, held against
   the main path's draws.

The last line of stdout is {"ok": true, "device": {...}}. The build goes
to build/ertdx_torch_kernels/; nothing else is written.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
P, D, NB, LK = 29, 128, 4, 147
SEED = 0
# (kernel, conditions, members): the configs[3] shapes, then R=10
KERNEL_CASES = [("fused_core_stack", 8, 1000), ("fused_core_stack", 8, 10),
                ("fused_core_block", 2, 1000), ("fused_core_block", 2, 10)]


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, t0: float) -> None:
    log(f"[phase] {name}: {time.perf_counter() - t0:.3f} s")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of one call, over `reps` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def core_inputs(gen, b: int, r: int, nb: int, dev):
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
    return {"mods": rnd(b, 6 * nb, D, scale=0.3), "k": rnd(b * nb, LK, D),
            "v": rnd(b * nb, LK, D), "ws": ws,
            "x": rnd(b, r, P), "x3": rnd(b, r * P, D),
            "lift_w": rnd(1, D), "lift_b": rnd(1, D, scale=0.1),
            "pos_emb": rnd(P, D, scale=0.1),
            "on_scale": 1.0 + rnd(1, D, scale=0.1),
            "on_bias": rnd(1, D, scale=0.1), "head_w": rnd(D, 1, scale=s),
            "head_b": rnd(1, 1, scale=0.1)}


def bound(flops: float, nbytes: float) -> tuple:
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_kernels(cb, dev) -> dict:
    """Phase 3: both kernels against their plain versions, timed."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    for name, b, r in KERNEL_CASES:
        nb = NB if name == "fused_core_stack" else 1
        a = core_inputs(gen, b, r, nb, dev)
        if name == "fused_core_stack":
            args = (a["x"], a["mods"], a["k"], a["v"], a["ws"], a["lift_w"],
                    a["lift_b"], a["pos_emb"], a["on_scale"], a["on_bias"],
                    a["head_w"], a["head_b"])
            kernel = lambda: cb.fused_core_stack(*args, p=P, chunk=r)
            plain = lambda: cb.fused_core_stack_plain(*args, p=P)
            ins = [a["x"], a["mods"], a["k"], a["v"], *a["ws"].values(),
                   a["lift_w"], a["lift_b"], a["pos_emb"], a["on_scale"],
                   a["on_bias"], a["head_w"], a["head_b"]]
            out_bytes = a["x"].numel() * 4
        else:
            w = {key: val[0].contiguous() for key, val in a["ws"].items()}
            mods = a["mods"][:, :6].contiguous()
            args = (a["x3"], mods, a["k"], a["v"], w)
            kernel = lambda: cb.fused_core_block(*args, p=P, chunk=r)
            plain = lambda: cb.fused_core_block_plain(*args, p=P)
            ins = [a["x3"], mods, a["k"], a["v"], *w.values()]
            out_bytes = a["x3"].numel() * 4
        with torch.no_grad():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{name} B={b} R={r}: non-finite output")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        tol = 1e-4 * max(1.0, scale)
        log(f"{name} B={b} R={r}: max_abs_err={err:.3e} "
            f"max_rel_err={err / max(scale, 1e-30):.3e} max|plain|="
            f"{scale:.4f} tol={tol:.3e}")
        if not err <= tol:
            raise RuntimeError(f"{name} B={b} R={r}: error {err} > {tol}")
        rows = b * r * P
        flops = nb * rows * 2 * D * (14 * D + 2 * P + 2 * LK)
        nbytes = sum(t.numel() * 4 for t in ins) + out_bytes
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if r == KERNEL_CASES[0][2]:
            with torch.no_grad():
                ms = time_ms(kernel)
                plain_ms = time_ms(plain)
            bound_ms, bound_by = bound(flops, nbytes)
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, flops=flops, bytes=nbytes,
                         shape=f"B={b} R={r}")
            log(f"{name} B={b} R={r}: kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: "
                f"{flops:.3e} flops, {nbytes:.3e} bytes), achieved "
                f"{flops / ms / 1e9:.2f} TFLOP/s")
    return results


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
        elif key == "scale":
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
        from ertdx_torch.ops import core_block as cb
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
    phase("build", t0)

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    results = check_kernels(cb, dev)
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
    log(f"main path: {run_s / steps * 1e3:.3f} ms per DDIM step, "
        f"{n_cond * n_real * steps / run_s:.1f} chain-steps/s, peak memory "
        f"{peak / 2**20:.1f} MiB")

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
        ub = sample_ddim(
            lambda x, t: mega_denoise_ensemble(
                model, x, t, ctx, n_real, p=cfg.model.param_dim,
                d=cfg.model.hidden_dim, num_blocks=cfg.model.num_blocks,
                chunk=n_real, stack=False, weights=weights),
            (nb_cond * n_real, cfg.model.param_dim), schedule, steps,
            x_T=x_T[:nb_cond * n_real], device=dev)
        torch.cuda.synchronize()
    block_launches = dict(cb.launches)
    ub = ub.reshape(nb_cond, n_real, -1).transpose(0, 1)
    dub = float((ub - u[:, :nb_cond]).abs().max())
    log(f"per-block path: launches {block_launches}; max|du| vs main "
        f"path={dub:.3e}")
    if block_launches["fused_core_block"] != steps * cfg.model.num_blocks:
        raise RuntimeError("per-block path: wrong fused_core_block count")
    if not dub <= 1e-3:
        raise RuntimeError("per-block path disagrees with the main path")
    phase("per-block path", t0)

    launches = {"fused_core_stack": main_launches["fused_core_stack"],
                "fused_core_block": block_launches["fused_core_block"]}
    replaces = {"fused_core_stack": "ertdx/ops/core_block.py:440",
                "fused_core_block": "ertdx/ops/core_block.py:281"}
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "ertdx_torch/csrc/core_block.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": None,
         "shape": r["shape"]}
        for name, r in results.items()]}
    log(f"[phase] total: {time.perf_counter() - t_all:.3f} s")
    log(json.dumps(line))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
