"""Launching a gloo world of the port's mesh jobs from a test module.

`run_world(n, jobs, tmp)` starts n processes of tests/torch_mesh_worker.py
(one rank each, CPU, one torch thread) that run the named jobs of
tests/torch_mesh_jobs.py in order, and waits for them (`World` starts
them and returns, so that JAX's references are computed meanwhile); the
inputs and outputs travel through `tmp` as pickles (`save`, `load`,
`out`). A rank that fails, or a world that outlives `timeout`, fails the
test with every rank's output, and no process is left running.
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_mesh_worker.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def save(tmp, name: str, obj) -> None:
    with open(Path(tmp) / f"{name}.pkl", "wb") as f:
        pickle.dump(obj, f)


def load(tmp, name: str):
    with open(Path(tmp) / f"{name}.pkl", "rb") as f:
        return pickle.load(f)


def out(tmp, name: str, rank: int = 0):
    """What rank `rank` of the world wrote under `name`."""
    return load(tmp, f"{name}.r{rank}")


class World:
    """An n-rank gloo world running `jobs`, started at construction so
    that the pytest process can compute its references meanwhile;
    `wait()` returns each rank's output or fails the test. Use it as a
    context manager, so that no rank outlives a failed reference."""

    def __init__(self, n: int, jobs, tmp, timeout: float = 240.0):
        port = free_port()
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(
                   [str(HERE.parent), os.environ.get("PYTHONPATH", "")])}
        env.pop("WORLD_SIZE", None)
        self.jobs = list(jobs)
        self.deadline = time.monotonic() + timeout
        self.logs = [open(Path(tmp) / f"rank{r}.log", "w+")
                     for r in range(n)]
        self.procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(n), str(port),
             str(tmp), *self.jobs], cwd=str(HERE.parent), env=env,
            stdout=self.logs[r], stderr=subprocess.STDOUT, text=True)
            for r in range(n)]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        """Kill whatever still runs (the references failed)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()

    def wait(self) -> list:
        procs, failed = self.procs, None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad or time.monotonic() > self.deadline:
                    failed = bad or "timeout"
                    break
                time.sleep(0.05)
            if failed is None:
                failed = [r for r, p in enumerate(procs)
                          if p.returncode != 0] or None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for f in self.logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
        if failed is not None:
            raise AssertionError(
                f"mesh world {self.jobs} failed ({failed}):\n" + "\n".join(
                    f"--- rank {r} ---\n{t[-4000:]}"
                    for r, t in enumerate(texts)))
        return texts


def run_world(n: int, jobs, tmp, timeout: float = 240.0) -> list:
    """Run `jobs` on an n-rank gloo world; returns each rank's stdout."""
    return World(n, jobs, tmp, timeout).wait()
