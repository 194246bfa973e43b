#!/usr/bin/env python3
"""What phase 3's bf16_3x rule can tell apart: plausible wrong variants
of the fused core's bf16_3x function under `chip_smoke.bf16x3_gate`.

    python3 tools/bf16x3_rule_reach.py [--device cuda] [--seed N]

For each of chip_smoke.py's phase-3 core cases (on the CPU with R cut to
10 chains), computes the plain bf16_3x version with float32 sums (the
rule's reference), with float64 sums (its pair), the float32 function in
float64 (the exact one), and these variants of the plain version, each a
change a kernel could make:

  sum_order  a_hi b_hi + (a_lo b_hi + a_hi b_lo): the same function in
             another float32 order, which the rule must pass;
  q_scale    q split before its 1/sqrt(D) scale, the scale on the logits;
  p_norm     the probabilities split before they are normalised, P V
             divided by the row sums after the product;
  f32_lo     the lo parts left float32 (not rounded to bf16);
  two_pass   a_lo b_hi dropped.

Each variant goes through `bf16x3_gate` as a kernel's result would; the
script prints the rule's readings for it (its rms error against the
exact function over the plain version's, its rms gap to the plain
version over the plain version's error and over the pair's gap, its max
gap against the tolerance) and whether the rule passes it. Nothing here
is imported by the port.
"""
from __future__ import annotations

import math
import os
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs                              # noqa: E402
from ertdx_torch.ops import core_block as cb         # noqa: E402


def mm_sum_order(a, b):
    ah, al = cb.split_hilo(a)
    bh, bl = cb.split_hilo(b)
    return ah @ bh + (al @ bh + ah @ bl)


def mm_f32_lo(a, b):
    ah, bh = cb.round_bf16(a), cb.round_bf16(b)
    return ah @ bh + (a - ah) @ bh + ah @ (b - bh)


def mm_two_pass(a, b):
    ah, _ = cb.split_hilo(a)
    bh, bl = cb.split_hilo(b)
    return ah @ bh + ah @ bl


def block_variant(where: str):
    """ops/core_block.py::_block_plain with one rounding point moved:
    `where` "q_scale" or "p_norm" (else as it is)."""
    def attend(q, k, v, mm, scale):
        s = mm(q, k.transpose(1, 2)) * scale if where == "q_scale" else \
            mm(q * scale, k.transpose(1, 2))
        if where != "p_norm":
            return mm(torch.softmax(s, dim=-1), v)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        return mm(e, v) / e.sum(-1, keepdim=True)

    def block(x, mods, k, v, w, p: int, mm=torch.matmul):
        b, rows, d = x.shape
        scale = 1.0 / math.sqrt(d)
        s1, h1, s2, h2, s3, h3 = (mods[:, j:j + 1, :] for j in range(6))
        qkv = mm(cb._ln(x) * (1.0 + s1) + h1, w["wqkv"])
        q, kk, vv = (z.reshape(b * rows // p, p, d)
                     for z in qkv.split(d, dim=-1))
        a = attend(q, kk, vv, mm, scale).reshape(b, rows, d)
        x = x + mm(a, w["wso"]) + w["bso"]
        q = mm(cb._ln(x) * (1.0 + s2) + h2, w["wcq"])
        x = x + mm(attend(q, k, v, mm, scale), w["wco"]) + w["bco"]
        h = F.gelu(mm(cb._ln(x) * (1.0 + s3) + h3, w["w1"]) + w["b1"],
                   approximate="tanh")
        return x + mm(h, w["w2"]) + w["b2"]

    return block


VARIANTS = {"sum_order": (mm_sum_order, ""), "q_scale": (cb.mm_3x, "q_scale"),
            "p_norm": (cb.mm_3x, "p_norm"), "f32_lo": (mm_f32_lo, ""),
            "two_pass": (mm_two_pass, "")}


def run_variant(name, plain3_fn, args, p):
    """plain3_fn(*args) with the variant's products and rounding points."""
    mm, where = VARIANTS[name]
    block, modes = cb._block_plain, dict(cb._STACK_MODES)
    cb._block_plain = block_variant(where)
    cb._STACK_MODES["bf16x3"] = (mm, cb.round3)
    saved = cb.mm_3x
    cb.mm_3x = mm                  # the per-block plain version's products
    try:
        return plain3_fn(*args, p=p)
    finally:
        cb._block_plain, cb.mm_3x = block, saved
        cb._STACK_MODES.clear()
        cb._STACK_MODES.update(modes)


def main() -> int:
    args = sys.argv[1:]
    dev = torch.device(args[args.index("--device") + 1]
                       if "--device" in args else "cpu")
    seed = int(args[args.index("--seed") + 1]) if "--seed" in args \
        else cs.SEED
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(cs.card_line(), flush=True)
    else:
        torch.set_num_threads(min(8, os.cpu_count() or 1))
    cs.log = lambda line: None      # the gate's own lines: summed below
    gen = torch.Generator(device=dev).manual_seed(seed)
    print(f"device {dev}, seed {seed}; per variant: err ratio (gate "
          f"0.8-1.25), gap / plain error, gap / pair gap (gate <= 1.25), "
          f"max gap / tol (gate <= 1), rule", flush=True)
    for name, b, r, p, lk in cs.KERNEL_CASES:
        r = r if dev.type == "cuda" else min(r, 10)
        stack = name == "fused_core_stack"
        a = cs.core_inputs(gen, b, r, cs.NB if stack else 1, dev, p, lk)
        if stack:
            fargs = (a["x"], a["mods"], a["k"], a["v"], a["ws"],
                     a["lift_w"], a["lift_b"], a["pos_emb"], a["on_scale"],
                     a["on_bias"], a["head_w"], a["head_b"])
            plain3_fn = cb.fused_core_stack_3x_plain
            exact_fn = cb.fused_core_stack_plain
        else:
            ws = {key: val[0].contiguous() for key, val in a["ws"].items()}
            fargs = (a["x3"], a["mods"][:, :6].contiguous(), a["k"], a["v"],
                     ws)
            plain3_fn = cb.fused_core_block_3x_plain
            exact_fn = cb.fused_core_block_plain
        with torch.no_grad():
            plain3 = plain3_fn(*fargs, p=p)
            plain3_64 = plain3_fn(*cs._double(fargs), p=p)
            exact = exact_fn(*cs._double(fargs), p=p)
            readings = []
            for var in VARIANTS:
                got = run_variant(var, plain3_fn, fargs, p)
                try:
                    cs.bf16x3_gate(var, got, plain3, plain3_64, exact)
                    verdict = "passes"
                except RuntimeError:
                    verdict = "FAILS"
                r3 = float((plain3.double() - exact).square().mean().sqrt())
                pair = float((plain3.double() - plain3_64).square().mean()
                             .sqrt())
                gap = float((got.double() - plain3).square().mean().sqrt())
                e = float((got.double() - exact).square().mean().sqrt())
                tol = 1e-4 * max(1.0, float(plain3.abs().max()))
                mx = float((got - plain3).abs().max())
                readings.append(f"{var} {e / r3:.3f} {gap / r3:.3f} "
                                f"{gap / pair:.3f} {mx / tol:.3f} {verdict}")
        print(f"{name} B={b} R={r} P={p} Lk={lk}: pair gap "
              f"{pair / r3:.3f} of the plain error; " + "; ".join(readings),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
