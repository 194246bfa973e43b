"""Per-layer metrics, one module each (found by `cells.metric_readers`).

A module names its metric's UNIT, BETTER, SOURCE, LAYER and MOVES (as
BENCHMARK.json lists them) and `read(view, log)`, which returns the
metric from a traced run's `harness.RunView`, or None where the run has
nothing to read (the harness then leaves the metric out). A cell reports
the metrics that move one of its end-to-end metrics (its traffic file's
"report", and `setup_s`).
"""
