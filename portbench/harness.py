"""One run of one cell: set-up, an optional traced stretch, the measured
window, the check, and the result line's content.

Set-up makes the seed's weights and inputs on the device, builds the
program's entry over them (`program.Program`), and warms it up with one
call from each client or thread at the cell's own shape, all at once;
`setup_s` runs from the process's start to the end of that warm-up, less
the writing of the seed's checkpoint, which a deployment finds written.
With `trace`, a stretch of `profile_calls` whole calls, arriving as the
traffic's do, then runs under torch.profiler. The window runs the
traffic for `seconds` on the host clock. Once it has closed and
the peak memory is read, the program is freed and the check runs. The
traffic file's "report" names the cell's end-to-end metrics besides
`setup_s`; a traced run reports the per-layer metrics that move one of
them.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import cells, check, counts, loadgen, program, tracing
from . import weights as make

STRETCH_FIRST = 1_000_000      # call indices of the traced stretch


@dataclasses.dataclass
class RunView:
    """What a per-layer metric's reader reads."""
    cell: cells.Cell
    records: List[loadgen.Record]
    window_start: float
    window_s: float
    launches: int                 # fused-core stack launches in the window
    trace: Optional[tracing.Trace]
    call_flops: float
    stack_shape: Dict[str, int]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_inputs(cell: cells.Cell, seed: int, dev) -> check.Inputs:
    tr, m = cell.traffic, cell.model
    shape = (m["cond_length"], m["cond_channels"])
    train_raw = make.make_surveys(make.TRAIN_SURVEYS, *shape, seed, 1, dev)
    pool = make.make_surveys(tr["survey_pool"], *shape, seed, 2, dev)
    return check.Inputs(
        make.make_weights(m, seed, dev),
        train_raw.cpu().numpy(),
        make.make_params(make.TRAIN_SURVEYS, seed, dev),
        pool.cpu().numpy(),
        make.make_priors(tr["prior_pool"], tr["surveys"] * tr["members"],
                         m["param_dim"], seed, dev))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda", root=cells.ROOT,
             log: Callable[[str], None] = print) -> dict:
    """Run the cell and return the result line's content (without
    `device`, which the caller adds)."""
    cell = cells.load_cell(name, root)
    tr, m = cell.traffic, cell.model
    dev = torch.device(device)
    log(f"imports done {time.perf_counter() - t_start:.3f} s")
    inputs = make_inputs(cell, seed, dev)
    _sync(dev)
    log(f"inputs made {time.perf_counter() - t_start:.3f} s")
    prog = program.Program(tr["entry"], cell.config, tr, inputs.weights,
                           inputs.train_params, inputs.train_raw, dev)
    prepared = prog.prepare(inputs.raw_pool)
    log(f"program built {time.perf_counter() - t_start:.3f} s")

    def locate(i: int):
        return loadgen.survey_rows(i, tr), i % tr["prior_pool"]

    def call(i: int):
        rows, prior = locate(i)
        with torch.profiler.record_function("portbench.call"):
            return prog.call(i, prepared[rows], inputs.priors[prior])

    warm = loadgen.concurrency(tr)
    loadgen.run(call, dict(tr, arrivals={"kind": "closed", "clients": warm}),
                count=warm)
    _sync(dev)
    setup_s = time.perf_counter() - t_start - prog.write_s
    log(f"set-up {setup_s:.3f} s (the checkpoint's writing, "
        f"{prog.write_s:.3f} s, left out)")

    stretch = None
    if trace:
        n0 = program.launches()
        stretch = tracing.profile_stretch(lambda: loadgen.run(
            call, tr, count=tr["profile_calls"], first=STRETCH_FIRST), dev)
        stretch.calls = tr["profile_calls"]
        stretch.launches = program.launches() - n0
        log(f"traced stretch: {stretch.calls} calls, {stretch.wall_s:.3f} s"
            f" wall, {len(stretch.kernels)} kernel records")

    answers: dict = {}
    n0 = program.launches()
    _sync(dev)
    t0 = time.perf_counter()
    records = loadgen.run(call, tr, start=t0, seconds=seconds,
                          outputs=answers)
    _sync(dev)
    launches = program.launches() - n0
    summary = loadgen.window_summary(records, t0, seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"window {seconds:g} s: {summary['attempted']} calls sent, "
        f"{summary['calls']:.3f} done in it, "
        f"{summary['failed']} failed, {launches} stack launches")
    for r in records:
        if r.error:
            log(f"call {r.index} failed: {r.error}")
    prog.close()
    del prog, prepared
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    done = [r.index for r in records if r.error is None]
    sample = check.sample_calls(done, cell.check["sample"], seed)
    t_check = time.perf_counter()
    numbers = check.compare(cell, inputs, answers, sample, locate, dev)
    log(f"check of calls {sample}: {time.perf_counter() - t_check:.3f} s")
    correct, table = check.verdict(numbers, cell.check["limits"],
                                   summary["failed"])

    if trace:
        view = RunView(cell, records, t0, seconds, launches, stretch,
                       counts.call_flops(m, tr["surveys"], tr["members"],
                                         cell.config["config"]["sample"]
                                         ["ddim_steps"]),
                       counts.stack_shape(m, tr["surveys"], tr["members"]))
        metrics = {}
        for mname, reader in cells.metric_readers(root).items():
            if reader.MOVES not in ("setup_s", *tr["report"]):
                continue
            value = reader.read(view, log)
            if value is not None:
                metrics[mname] = {"value": value, "unit": reader.UNIT}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for name in tr["report"]:
            if name.startswith("members_per_s"):
                metrics[name] = {"value": summary["members_per_s"],
                                 "unit": "members/s"}
            elif name == "request_p95_ms" and len(summary["latencies_s"]):
                metrics[name] = {"value": float(np.percentile(
                    summary["latencies_s"], 95)) * 1e3, "unit": "ms"}
    out = {"correct": bool(correct), "attempted": summary["attempted"],
           "failed": summary["failed"], "metrics": metrics,
           "memory_peak_bytes": int(peak)}
    if stretch is not None:
        out["busy_s"] = stretch.busy_s
        out["window_s"] = stretch.window_s
        out["breakdown"] = {"device_ops": stretch.device_ops(),
                            "idle_gaps": stretch.idle_gaps()}
    out["check"] = table
    return out
