"""Files, not edits: a cell, a traffic mix and a per-layer metric are
added by adding their files, which the harness lists and resolves with
no code change;
every name in BENCHMARK.json resolves to its file and keeps to the
allowed characters."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import cells
from portbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")

NEW_METRIC = '''"""A metric added as a file."""
UNIT = "calls"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "Service: serve.py PosteriorService.posterior"
MOVES = "request_p95_ms"


def read(view, log):
    return float(len(view.records))
'''


def test_added_cell_mix_and_metric_resolve(tmp_path):
    """A new cell over a new traffic file, an open loop of requests of two
    surveys from two threads, and a new metric: all three files alone."""
    copy = tmp_path / "portbench"
    shutil.copytree(cells.ROOT, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = json.loads((copy / "workloads" / "ddim_ensemble.serve8.json")
                      .read_text())
    cell.update(traffic="added_open", why="an added open loop")
    (copy / "workloads" / "ddim_ensemble.added.json").write_text(
        json.dumps(cell))
    mix = json.loads((copy / "traffic" / "serve8.json").read_text())
    mix.update(arrivals={"kind": "open", "rate_per_s": 1.0, "threads": 2},
               surveys=2)
    (copy / "traffic" / "added_open.json").write_text(json.dumps(mix))
    (copy / "metrics" / "calls_in_window.py").write_text(NEW_METRIC)
    code = f"""
import json, sys, time
sys.path[:0] = [{str(tmp_path)!r}, {str(REPO)!r}]
from pathlib import Path
from portbench import cells, harness
from portbench.tests.tiny import tiny_root
assert cells.ROOT == Path({str(copy)!r})
root = tiny_root(Path({str(tmp_path / "tiny")!r}))
out = harness.run_cell("ddim_ensemble.added", 5, 0.3, True,
                       t_start=time.perf_counter(), device="cpu",
                       root=root, log=lambda m: None)
plain = harness.run_cell("ddim_ensemble.added", 5, 0.3, False,
                         t_start=time.perf_counter(), device="cpu",
                         root=root, log=lambda m: None)
print(json.dumps({{"cells": cells.names("workloads"),
                  "mixes": cells.names("traffic"),
                  "metrics": sorted(cells.metric_readers()),
                  "reported": sorted(out["metrics"]),
                  "end_to_end": sorted(plain["metrics"]),
                  "sent": plain["attempted"],
                  "correct": [out["correct"], plain["correct"]]}}))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert "ddim_ensemble.added" in got["cells"]
    assert "added_open" in got["mixes"]
    assert "calls_in_window" in got["metrics"]
    assert "calls_in_window" in got["reported"]
    assert got["end_to_end"] == ["request_p95_ms", "setup_s"]
    assert got["sent"] == int(tiny.TINY_RATE * 0.3)
    assert got["correct"] == [True, True]


def test_benchmark_names_resolve():
    for conf in BENCH["configs"]:
        assert (REPO / conf["file"]).is_file()
        assert conf["file"] == f"portbench/configs/{conf['name']}.json"
        data = json.loads((REPO / conf["file"]).read_text())
        assert data["name"] == conf["name"]
        assert data["source"] == conf["source"]
        assert data["reduced"] == conf["reduced"]
    for w in BENCH["workloads"]:
        cell = json.loads((cells.ROOT / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} \
            == {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert (cells.ROOT / "traffic" / f"{w['traffic']}.json").is_file()
    readers = cells.metric_readers()
    assert sorted(readers) == sorted(m["name"] for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        mod = readers[m["name"]]
        assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == (
            m["unit"], m["better"], m["source"], m["layer"], m["moves"])


def _names(bench):
    yield from (c["name"] for c in bench["configs"])
    for w in bench["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for m in bench["end_to_end"] + bench["per_layer"])
    for c in bench["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names(BENCH))))
def test_names_use_allowed_characters(name):
    assert NAME.match(name)


def test_units_and_texts():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + BENCH["command"]):
        assert TEXT.match(text)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
