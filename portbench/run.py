"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout that holds the port (`ertdx_torch`) and
BENCHMARK.json. One process a run: set-up (the seed's weights and inputs
on the card, the program's entry over a checkpoint of them, one warm
call a client or thread), with `--trace 1` a profiled stretch of whole calls, the
window of `--seconds`, then the check of a sample of the window's
answers against the plain reference. The last lines on standard error
are the numbers compared, each with its limit; the last line on
standard output is the result as one JSON object. Without a CUDA device
(or with fewer than the cell asks for) it prints no result and exits 2;
if JAX, jaxlib, flax or the JAX package is loaded in the process once
the window has closed, it prints no result and exits 3.

The port's kernels build into build/ertdx_torch_kernels/ inside the
checkout at the first run there; later runs load them.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ertdx")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, whole, is a forbidden one."""
    mods = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in mods}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "not read"


def _finite(obj):
    """The result with every non-finite number as null (strict JSON)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from portbench import cells

    cell = cells.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              "device(s); none or too few here", file=sys.stderr)
        return 2
    from portbench import harness

    def log(msg: str) -> None:
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START, log=log)
    log(f"card: {card_line()}")
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}; no "
              "result", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out.pop("memory_peak_bytes")}
    for key in ("busy_s", "window_s"):
        if key in out:
            device[key] = out.pop(key)
    table = out.pop("check")
    result = {**out, "device": device, "check": table}
    for name, t in table.items():
        print(f"check {name} {t['value']!r} limit {t['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
