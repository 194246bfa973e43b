"""Profiling and timing hooks (ertdx/utils/profiling.py on torch).

`StepTimer` times steps by the host clock with warm-up steps left out;
`trace(logdir)` records a torch.profiler trace (CPU and, on a card, CUDA
activity) into `logdir`, and is a no-op for None; `block_until_ready`
waits for the CUDA work behind the tensors of a tree.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


class StepTimer:
    """Wall-clock step timer with warmup exclusion."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt

    @property
    def steps_per_sec(self) -> float:
        n = self.count - self.warmup
        return n / self.total if n > 0 and self.total > 0 else float("nan")


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """torch.profiler trace context writing a Chrome trace under
    `logdir` (no-op if logdir is None)."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     str(logdir))):
        yield


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def block_until_ready(tree):
    """Wait for the CUDA work behind every tensor in `tree`; returns the
    tree."""
    devices = {leaf.device for leaf in _leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree
