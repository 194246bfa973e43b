"""Structured metrics logging: per-step dicts -> JSON lines / CSV.

A copy of ertdx/utils/logging.py: each record is written and flushed at
once, so a run that is cut loses at most one record.
"""
from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append metric records to a JSON-lines file (and optionally echo
    them). Calling the logger logs a record, so it can be handed to
    `train` and `distill` as their `logger`."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = Path(path) if path else None
        self.echo = echo
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
        else:
            self._fh = None

    def log(self, record: Dict[str, Any]) -> None:
        record = dict(record)
        record.setdefault("ts", time.time())
        if self._fh:
            self._fh.write(json.dumps(record, default=_default) + "\n")
            self._fh.flush()
        if self.echo:
            parts = [f"{k}={_fmt(v)}" for k, v in record.items()
                     if k != "ts"]
            print(" | ".join(parts))

    __call__ = log

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_csv(path, rows, fieldnames=None) -> None:
    rows = list(rows)
    if not rows:
        return
    fieldnames = fieldnames or list(rows[0].keys())
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        w.writerows(rows)


def _default(o):
    try:
        return float(o)
    except Exception:
        return str(o)


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return v
