"""The benchmark's data files, found by name.

* `workloads/<cell>.json`: a cell: its configuration, traffic mix, chips,
  why, and the check of its outputs (how many calls it samples, the
  limit of each number compared);
* `configs/<config>.json`: a configuration: the program's configuration
  as it is run ("config", every field of the preset it names), its
  source and what it reduced, and the precisions of its control (the
  seed's weights and inputs follow `weights.py`'s rule for every
  configuration);
* `traffic/<mix>.json`: a traffic mix, read by `loadgen`;
* `metrics/<metric>.py`: a per-layer metric's reader, `read(view, log)`;
  files whose name starts with "_" hold what readers share.

A cell, a configuration, a mix or a metric is added by adding its file;
no code here names one. A metric's name may hold dots
(`device_idle_pct.serve`), so readers load from their files.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    check: dict
    chips: int
    why: str

    @property
    def model(self) -> dict:
        return self.config["config"]["model"]


def _load(kind: str, name: str, root: Path) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def names(kind: str, root: Path = ROOT) -> List[str]:
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(p.name[:-len(suffix)] for p in (root / kind).glob(
        "*" + suffix) if not p.name.startswith("_"))


def load_cell(name: str, root: Path = ROOT) -> Cell:
    w = _load("workloads", name, root)
    return Cell(name, w["config"], _load("configs", w["config"], root),
                _load("traffic", w["traffic"], root), w["check"],
                w["chips"], w["why"])


def metric_readers(root: Path = ROOT) -> Dict[str, object]:
    """Every per-layer metric's module, by its name."""
    readers = {}
    for n in names("metrics", root):
        spec = importlib.util.spec_from_file_location(
            f"{root.name}.metrics.{n}", root / "metrics" / f"{n}.py")
        readers[n] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(readers[n])
    return readers
