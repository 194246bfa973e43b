"""A traced stretch of whole calls, read from torch.profiler.

`profile_stretch(fn)` runs fn (a few whole calls of the cell's traffic)
under torch.profiler with CPU and CUDA activities, on every thread (the
clients call from threads of their own), and returns a `Trace`:
the device kernels' intervals and names, the host's operator spans, and
the stretch's wall length. From it:

* `busy_s`: the length of the union of the kernel intervals;
* `device_ops`: device seconds by kernel group (`counts.kernel_group`);
* `idle_gaps`: the gaps between kernels, each named by the innermost
  host operator running at its middle on any thread (`portbench.call`
  where a client is inside its call but in no operator, as in numpy),
  seconds summed by that name; gaps under `SHORT_GAP_US` are summed as
  one entry.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, List, Tuple

import torch

from . import counts

SHORT_GAP_US = 20.0
STRETCH_SPAN = "portbench.stretch"


@dataclasses.dataclass
class Trace:
    kernels: List[Tuple[str, float, float]]    # name, start us, end us
    host: List[Tuple[str, float, float]]       # name, start us, end us
    start_us: float
    end_us: float
    wall_s: float
    calls: int = 0
    launches: int = 0

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, self.start_us), min(e, self.end_us)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_times(self, kernel: str) -> List[float]:
        """Device seconds of each record whose name holds `kernel`."""
        return [(e - s) * 1e-6 for n, s, e in self.kernels if kernel in n]

    def device_ops(self, top: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.kernels:
            g = counts.kernel_group(name)
            by[g] = by.get(g, 0.0) + (e - s) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        edges = [self.start_us]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.end_us)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        longest = max((e - s for _, s, e in host), default=0.0)
        by: dict = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            if b - a < SHORT_GAP_US:
                label = f"gaps under {SHORT_GAP_US:g} us"
            else:
                mid = 0.5 * (a + b)
                lo = bisect.bisect_left(starts, mid - longest)
                hi = bisect.bisect_right(starts, mid)
                inside = [h for h in host[lo:hi] if h[2] >= mid]
                label = (min(inside, key=lambda h: h[2] - h[1])[0]
                         if inside else "no host operator")
            by[label] = by.get(label, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]


def profile_stretch(fn: Callable[[], None], device: torch.device) -> Trace:
    """fn under torch.profiler (CUDA activities where `device` is a card;
    on the CPU the trace holds no kernels)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities,
                 experimental_config=every_thread) as prof:
        t0 = time.perf_counter()
        with record_function(STRETCH_SPAN):
            fn()
            sync()
        wall = time.perf_counter() - t0
    kernels, host, span = [], [], None
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                kernels.append((e.name, *rng))
        elif e.name == STRETCH_SPAN:
            span = rng
        else:
            host.append((e.name, *rng))
    if span is None:
        raise RuntimeError("the profiler recorded no span of the stretch")
    return Trace(kernels, host, span[0], span[1], wall)
