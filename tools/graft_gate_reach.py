#!/usr/bin/env python3
"""What phase 11's graft gates tell apart, on the card: the fused arm's
5 train steps (`chip_smoke.check_fused_training`) on the real kernels
several times, then on mutants whose fused-conv backward returns a dW
with one entry's sign flipped at every step.

    python3 tools/graft_gate_reach.py [--repeats N]

Each repeat trains new copies from the same seeds, so what changes from
one to the next is what the card does not fix: cuDNN's backward and the
order of atomic sums. Each run logs phase 11's readings (the step-1
gradient gate, the moved entries, the step-1 sign flips and their gate)
and whether the phase passed or which of its gates failed.

The mutants pick, at the first backward of the first fused conv (the
encoder's last), the entry of dW whose |value| is nearest a target and
flip its sign there at every later backward of that conv:

  small  |dW| near 4.5e-5, an error of 9e-5 there: under the step-1
         gradient gate's floor of 1e-4 x max(1, max|g|);
  mid    |dW| near 1e-3 of the leaf's largest;
  large  |dW| near 1e-2 of the leaf's largest.

Every gate of the phase is read and logged before it raises, so each
mutant's line names every gate it failed.

Needs one card. Nothing here is imported by the port.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs                              # noqa: E402
from ertdx_torch.ops import _build                   # noqa: E402
from ertdx_torch.ops import conv as cv               # noqa: E402
from ertdx_torch.ops import groupnorm as gn          # noqa: E402
from ertdx_torch.ops import slab_attn as sa          # noqa: E402


TARGETS = {"small": 4.5e-5, "mid": 1e-3, "large": 1e-2}


def mutant(target: str):
    """A gn_silu_conv3_bwd whose dW is the kernel's with one entry's sign
    flipped (chosen at the first call, see the module docstring), and
    where it chose."""
    real = cv.gn_silu_conv3_bwd
    chosen: dict = {}

    def bwd(x, gamma, beta, w, g, num_groups, eps=1e-5):
        dx, dgamma, dbeta, dw, db = real(x, gamma, beta, w, g, num_groups,
                                         eps)
        key = w.data_ptr()
        if not chosen:
            flat = dw.reshape(-1).abs()
            want = TARGETS[target] * (1.0 if target == "small"
                                      else float(flat.max()))
            i = int((flat - want).abs().argmin())
            chosen.update(key=key, index=i, value=float(dw.reshape(-1)[i]),
                          top=float(flat.max()), shape=tuple(dw.shape))
        if key == chosen["key"]:
            dw = dw.clone()
            dw.view(-1)[chosen["index"]] *= -1
        return dx, dgamma, dbeta, dw, db
    return bwd, chosen


def attempt(counts, dev, card) -> str:
    try:
        cs.check_fused_training(counts, dev, card)
        return "passed"
    except RuntimeError as exc:
        return f"failed: {exc}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("graft_gate_reach: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"device: {card}")
    _build.load()
    counts = cs._Counts(gn, cv, sa)
    results = []
    for r in range(args.repeats):
        cs.log(f"== kernel, repeat {r + 1}")
        results.append((f"kernel {r + 1}", attempt(counts, dev, card)))
    real = cv.gn_silu_conv3_bwd
    for target in TARGETS:
        cs.log(f"== mutant {target}")
        cv.gn_silu_conv3_bwd, chosen = mutant(target)
        try:
            out = attempt(counts, dev, card)
        finally:
            cv.gn_silu_conv3_bwd = real
        results.append((f"mutant {target} (dW {chosen.get('shape')} entry "
                        f"{chosen.get('index')}: {chosen.get('value'):.3e}, "
                        f"leaf's largest |dW| {chosen.get('top'):.3e})",
                        out))
    cs.log("summary (" + card + "):")
    for name, out in results:
        cs.log(f"  {name}: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
