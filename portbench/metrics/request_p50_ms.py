"""The median request latency of the service, by the harness's host
clock around each call, over the traced run's window (the profiled
stretch runs before it)."""
import numpy as np

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "Service: serve.py PosteriorService.posterior"
MOVES = "request_p95_ms"


def read(view, log):
    lat = [r.seconds for r in view.records if r.error is None]
    return float(np.median(lat)) * 1e3 if lat else None
