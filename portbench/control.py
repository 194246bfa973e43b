"""The control of a cell's check: the reference at the configuration's
control precisions (its "control" group: the encoder's and the core's
products, one step below what the configuration states) put in the
program's place, on the cell's own sizes and the calls a run samples.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13
                                 [--encoder P] [--core P]

prints one JSON line a seed with each number compared, its limit and
whether the check passed; the control has to fail it. `--encoder` or
`--core` (fp32, tf32, bf16, fp8) puts another precision in place of the
configuration's for that part, to read what the check sees of one part
lowered alone. The benchmark's runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path


def control_numbers(name: str, seed: int, device, root=None,
                    calls: int = 64, lo: dict = None) -> dict:
    """The control's numbers for the calls a run of `calls` calls would
    sample with this seed; `lo` overrides parts of the control's
    precisions."""
    from portbench import cells, check, harness, loadgen

    cell = cells.load_cell(name, root or cells.ROOT)
    inputs = harness.make_inputs(cell, seed, device)
    tr = cell.traffic
    sample = check.sample_calls(list(range(calls)), cell.check["sample"],
                                seed)
    numbers = check.control(
        cell, inputs, sample,
        lambda i: (loadgen.survey_rows(i, tr), i % tr["prior_pool"]),
        device, {**cell.config["control"], **(lo or {})})
    correct, table = check.verdict(numbers, cell.check["limits"], 0)
    return {"seed": seed, "correct": correct, "check": table}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    for part in ("encoder", "core"):
        ap.add_argument(f"--{part}", choices=("fp32", "tf32", "bf16", "fp8"))
    args = ap.parse_args(argv)
    lo = {k: v for k, v in (("encoder", args.encoder),
                            ("core", args.core)) if v}
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control_numbers(args.workload, seed, torch.device("cuda"),
                              lo=lo)
        out["precisions"] = lo
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
