#!/usr/bin/env python3
"""chip_smoke.py's phase 5 alone, timed: the per-block fused core's DDIM
step on one NVIDIA GPU, for this tree or an earlier one.

    python3 tools/block_step_ab.py [--tree DIR] [--mode accurate|onepass]
                                   [--reps N]

Imports `chip_smoke` and `ertdx_torch` from DIR (this tree by default;
e.g. the parent's whole tree: `git archive HEAD~1 | tar -x -C
build/parent_tree --exclude=docs/results/flagship_fullscale`, DIR
build/parent_tree), builds that tree's kernels, and runs phase 5 as that
tree's chip_smoke.py runs it: configs[3] (its `serving_setup`) in the
fused core's mode (`--mode`, accurate=True by default), 2 conditions x
1000 members, DDIM-50 through `mega_denoise_ensemble(stack=False)` with
the weights gathered once and, where the tree has `mega_cross_kv`, the
cross K/V and their kernel operands made once, both before the clock
starts. One run first as warm-up, then `--reps` runs (3 by default) each
timed on the host clock around a synchronised run; prints the ms per
DDIM step of each, the fused_core_block launches (4 a step) and the
card's name and power limit. To compare two trees, run them in turns in
one call (A, B, B, A). Nothing here is imported by the port.
"""
from __future__ import annotations

import os
import sys
import time


def main() -> int:
    args = sys.argv[1:]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tree = os.path.abspath(args[args.index("--tree") + 1]) \
        if "--tree" in args else root
    accurate = (args[args.index("--mode") + 1] if "--mode" in args
                else "accurate") == "accurate"
    reps = int(args[args.index("--reps") + 1]) if "--reps" in args else 3
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from ertdx_torch.diffusion import sample_ddim, schedule_from_config
    from ertdx_torch.models import mega
    from ertdx_torch.ops import _build
    from ertdx_torch.ops import core_block as cb

    if not torch.cuda.is_available():
        print("block_step_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    cfg, model, cond, x_T = cs.serving_setup(dev)
    model.ensemble_mega_accurate = accurate
    schedule = schedule_from_config(cfg.diffusion)
    n_real, steps = cfg.sample.uncertainty_samples, cfg.sample.ddim_steps
    nb_cond, nb = 2, cfg.model.num_blocks
    with torch.no_grad():
        ctx = model.encode_condition(cond[:nb_cond])
        # made before the clock starts, as phase 5 makes them
        weights = mega.mega_weights(model)
        kw = {}
        if hasattr(mega, "mega_cross_kv"):
            kw["cross"] = mega.mega_cross_kv(weights, ctx, stack=False,
                                             accurate=accurate)

    def run():
        return sample_ddim(
            lambda x, t: mega.mega_denoise_ensemble(
                model, x, t, ctx, n_real, p=cfg.model.param_dim,
                d=cfg.model.hidden_dim, num_blocks=nb, chunk=n_real,
                accurate=accurate, stack=False, weights=weights, **kw),
            (nb_cond * n_real, cfg.model.param_dim), schedule, steps,
            x_T=x_T[:nb_cond * n_real], device=dev)

    times = []
    with torch.no_grad():
        run()
        for _ in range(reps):
            cb.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / steps * 1e3)
            if cb.launches["fused_core_block"] != steps * nb:
                raise RuntimeError(f"{cb.launches['fused_core_block']} "
                                   f"fused_core_block launches, expected "
                                   f"{steps * nb}")
    print(f"tree {os.path.relpath(tree, root)}: phase 5 "
          f"({'bf16_3x' if accurate else 'one-pass'}, {nb_cond} x "
          f"{n_real}, DDIM-{steps}) ms per step "
          + " / ".join(f"{ms:.3f}" for ms in times)
          + f"; {steps * nb} fused_core_block launches a run; build "
          f"{build_s:.1f} s; {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
