"""The benchmark's one load generator, driven by a traffic file.

A traffic file (`traffic/<mix>.json`) gives the entry its requests call
("service" or "dataset_sweep"), how they arrive ("arrivals"), the
surveys a call carries and the members each survey is sampled to, the
pools the inputs come from, the calls the traced stretch holds, and the
end-to-end metrics the cell reports besides `setup_s` ("report").

Arrivals are one of:

* `{"kind": "closed", "clients": N}`: N clients, each sending its next
  call when its last one has returned, until the window's end;
* `{"kind": "open", "rate_per_s": r, "threads": T}`: a request due every
  1 / r seconds whatever the program does, as a monitoring array's
  acquisition system posts its surveys on a schedule, served by T threads
  as a threading HTTP server serves them; a request waits for a free
  thread, then for the program. Every run sends the same requests at the
  same times. (Poisson arrivals, even with one set of gaps for every seed
  in another order, made the p95 of a 51 s window spread by 39 % from one
  order to the next, too wide for any bound.)

Inputs come from pools made from the seed in set-up: `survey_pool` raw
surveys and `prior_pool` prior draws x_T of (surveys a call x members,
P) each. Call i takes the contiguous surveys from
(i x `survey_stride`) mod (survey_pool - surveys + 1) and prior block
i mod prior_pool, so every call has the same size and consecutive calls
differ.

A call due inside the window is sent and waited for. `Record` keeps each
call's host-clock due time, start and end, the members it delivered and
its error, if it raised; its latency runs from when it was due.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import traceback
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class Record:
    index: int
    due: float
    start: float
    end: float
    members: int
    error: Optional[str] = None

    @property
    def seconds(self) -> float:
        """The latency a user sees: from when the call was due."""
        return self.end - self.due


def survey_rows(i: int, traffic: dict) -> slice:
    """The pool rows of call i's surveys."""
    k = traffic["surveys"]
    starts = traffic["survey_pool"] - k + 1
    s = (i * traffic["survey_stride"]) % starts
    return slice(s, s + k)


def concurrency(traffic: dict) -> int:
    """The calls that can be in the program at once: clients or threads."""
    arr = traffic["arrivals"]
    return arr["clients"] if arr["kind"] == "closed" else arr["threads"]


def due_times(traffic: dict, start: float, *, seconds: float = None,
              count: int = None) -> np.ndarray:
    """The due times of an open loop's requests from `start`: those of a
    window of `seconds` (the rate times its length, all due inside it),
    or `count` of them."""
    rate = traffic["arrivals"]["rate_per_s"]
    n = count if count is not None else int(rate * seconds)
    return start + np.arange(n) / rate


def run(call: Callable, traffic: dict, *, start: float = None,
        seconds: float = None, count: int = None, first: int = 0,
        outputs: dict = None) -> List[Record]:
    """Drive `call(i)` for the indices first, first + 1, ... as the traffic's
    arrivals say, from `start` (now if None): for `seconds`, or `count`
    calls in all. Returns the records in index order; with `outputs`,
    stores each call's result under its index."""
    arr = traffic["arrivals"]
    t0 = time.perf_counter() if start is None else start
    if arr["kind"] == "closed":
        until = None if seconds is None else t0 + seconds

        def due_of(k):
            now = time.perf_counter()
            if (count is not None and k >= count) or (
                    until is not None and now >= until):
                return None
            return now
    else:
        due = due_times(traffic, t0, seconds=seconds, count=count)

        def due_of(k):
            return due[k] if k < len(due) else None

    ks = itertools.count()
    lock = threading.Lock()
    records: List[Record] = []
    members = traffic["surveys"] * traffic["members"]

    def worker():
        while True:
            with lock:
                k = next(ks)
                due = due_of(k)
            if due is None:
                return
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            start = time.perf_counter()
            try:
                out, error = call(first + k), None
            except Exception:  # noqa: BLE001 -- a failed call is recorded
                out, error = None, traceback.format_exc(limit=4)
            end = time.perf_counter()
            with lock:
                records.append(Record(first + k, due, start, end, members,
                                      error))
                if outputs is not None and error is None:
                    outputs[first + k] = out

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(concurrency(traffic))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sorted(records, key=lambda r: r.index)


def window_share(r: Record, end: float) -> float:
    """The share of call r's work done by `end`: 1 for a call that ended
    by then, the part of its time before `end` for the call in flight at
    the close, 0 for a failed call."""
    if r.error is not None or r.start >= end:
        return 0.0
    if r.end <= end:
        return 1.0
    return (end - r.start) / (r.end - r.start)


def window_summary(records: List[Record], t0: float, seconds: float
                   ) -> dict:
    """The end-to-end numbers of a window [t0, t0 + seconds]: the members
    delivered in it over its length (the calls that ended inside it, and
    the share of each call in flight at its close that lies inside it),
    and each call's latency (every call due in it, the last ones waited
    for)."""
    end = t0 + seconds
    calls = sum(window_share(r, end) for r in records)
    lat = np.array([r.seconds for r in records if r.error is None])
    members = records[0].members if records else 0
    return {"calls": calls,
            "members_per_s": calls * members / seconds,
            "latencies_s": lat,
            "attempted": len(records),
            "failed": sum(r.error is not None for r in records)}
