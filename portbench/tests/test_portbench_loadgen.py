"""The load generator: an open loop sends its requests on schedule, all
due inside the window, and times each from when it was due; a closed
loop keeps its clients busy."""
import time

import numpy as np

from portbench import loadgen


def _mix(**arrivals):
    return {"arrivals": arrivals, "surveys": 2, "members": 3}


def test_open_window_sends_its_rate_times_its_length():
    mix = _mix(kind="open", rate_per_s=3.2, threads=4)
    due = loadgen.due_times(mix, 100.0, seconds=51.0)
    assert len(due) == int(3.2 * 51.0)
    assert due[0] == 100.0 and due[-1] < 151.0
    assert np.allclose(np.diff(due), 1 / 3.2)


def test_open_loop_times_from_the_due_time():
    """One thread, requests due faster than it serves them: each waits for
    the last, and its latency holds the wait."""
    mix = _mix(kind="open", rate_per_s=50.0, threads=1)

    def call(i):
        time.sleep(0.04)
        return i

    outputs = {}
    rec = loadgen.run(call, mix, seconds=0.3, first=10,
                      outputs=outputs)
    assert [r.index for r in rec] == list(range(10, 25))
    assert sorted(outputs) == list(range(10, 25))
    assert all(r.start >= r.due for r in rec)
    assert rec[-1].seconds > rec[-1].end - rec[-1].start + 0.2
    summary = loadgen.window_summary(rec, rec[0].due, 0.3)
    assert summary["attempted"] == 15 and summary["failed"] == 0
    assert summary["calls"] < 15


def test_closed_loop_and_failed_calls():
    mix = _mix(kind="closed", clients=2)

    def call(i):
        if i == 1:
            raise ValueError("planted")
        return i

    rec = loadgen.run(call, mix, count=5)
    assert [r.index for r in rec] == list(range(5))
    assert rec[1].error and "planted" in rec[1].error
    assert all(0 <= r.start - r.due < 0.05 for r in rec)
    assert loadgen.window_share(rec[1], rec[-1].end + 1) == 0.0
