#!/usr/bin/env python3
"""Where the time of the physics loop's forward runs goes.

    python3 tools/forward_breakdown.py [--runs N]

Runs on the host of the card's machine (or any host; it launches no
kernel). First the import that `python -m ertdx_torch.cli simulate`
pays in a fresh interpreter (`import torch`, then the CLI and
physics.py), each timed around a subprocess. Then chip_smoke.py's phase
19 forward runs in this process: N members of a seeded LHS design
through ertdx_torch.physics.ForwardModelRunner on chip_smoke.py's
stand-in PFLOTRAN and tests/fixtures/pflotran_template.in in keyword
mode, 6 at a time and then one at a time, with each run's input file,
stand-in process and .srv read timed (host clock, per run; their sums
are thread-seconds, not wall time). Last the same members through
`python -m ertdx_torch.cli simulate` as phase 19 runs it, timed around
the subprocess. Files go to a temporary directory that is removed.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def fresh_import_s(code: str) -> float:
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True)
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=50)
    args = ap.parse_args()
    torch_s = fresh_import_s("import torch")
    cli_s = fresh_import_s("import ertdx_torch.cli, ertdx_torch.physics")
    print(f"{os.cpu_count()} CPUs; a fresh interpreter: import torch "
          f"{torch_s:.3f} s, import ertdx_torch.cli and .physics "
          f"{cli_s:.3f} s")

    import chip_smoke
    from ertdx_torch import physics
    from ertdx_torch.doe import SurrogateDataGenerator
    from ertdx_torch.utils import srv_native

    root = Path(tempfile.mkdtemp(prefix="ertdx_torch_forward_"))
    try:
        standin, _, _ = chip_smoke.write_standin(root)
        members = SurrogateDataGenerator(seed=0).generate_training_samples(
            args.runs, "lhs")
        srv_native.load()
        spans = {"input file": [], "stand-in": [], "read": []}
        lock = threading.Lock()

        def timed(name, fn):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                with lock:
                    spans[name].append(time.perf_counter() - t0)
                return out
            return wrapper

        # physics.py calls these three by these names once a run
        run = subprocess.run
        physics.PflotranSimulator.create_input_file = timed(
            "input file", physics.PflotranSimulator.create_input_file)
        physics.subprocess.run = timed("stand-in", run)
        physics.gather_srv_data = timed("read", physics.gather_srv_data)
        for conc in (chip_smoke.PHYS_CONCURRENCY, 1):
            for v in spans.values():
                v.clear()
            runner = physics.ForwardModelRunner(
                physics.PflotranSimulator(str(chip_smoke.PHYS_TEMPLATE),
                                          "ertdx_run", mode="keywords"),
                cfg=physics.RunnerConfig(pflotran_path=str(standin),
                                         use_mpi=False,
                                         max_concurrent=conc),
                workdir=str(root / f"runs_{conc}"))
            t0 = time.perf_counter()
            runner.run_simulations_with_params(members,
                                               progress=lambda msg: None)
            wall = time.perf_counter() - t0
            per_run = ", ".join(
                f"{k} {1e3 * np.mean(v):.2f} ms (max {1e3 * np.max(v):.2f})"
                for k, v in spans.items())
            sums = ", ".join(f"{k} {sum(v):.3f}" for k, v in spans.items())
            print(f"{args.runs} runs, {conc} at a time: {wall:.3f} s; a run: "
                  f"{per_run}; thread-seconds: {sums}")
        physics.subprocess.run = run
        np.save(root / "members.npy", members)
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "ertdx_torch.cli", "simulate",
             "--template", str(chip_smoke.PHYS_TEMPLATE), "--params",
             str(root / "members.npy"), "--pflotran", str(standin),
             "--no-mpi", "--mode", "keywords", "--concurrency",
             str(chip_smoke.PHYS_CONCURRENCY), "--workdir",
             str(root / "cli_runs"), "--results-dir", str(root / "results")],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
            check=True, capture_output=True)
        print(f"the same {args.runs} runs through `python -m ertdx_torch.cli "
              f"simulate`: {time.perf_counter() - t0:.3f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
