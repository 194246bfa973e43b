"""A copy of the benchmark's data files at a size the CPU runs in
seconds, for the tests: every cell's configuration cut to small widths
and its traffic to a few surveys and members."""
import json
import shutil
from pathlib import Path

from portbench import cells

TINY_MODEL = {"hidden_dim": 32, "cond_length": 64, "cond_channels": 4,
              "base_width": 16, "depth": 2, "num_heads": 2,
              "num_blocks": 2}
TINY_TRAFFIC = {"surveys": 2, "members": 8, "max_batch": 2,
                "batch_size": 2, "survey_pool": 5, "survey_stride": 1,
                "prior_pool": 3, "profile_calls": 2}
TINY_RATE = 20.0          # requests a second of an open loop


def tiny_root(tmp: Path, steps: int = 4) -> Path:
    """tmp/portbench holding tiny copies of the data files."""
    root = Path(tmp) / "portbench"
    for kind in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(cells.ROOT / kind, root / kind)
    for path in (root / "configs").glob("*.json"):
        conf = json.loads(path.read_text())
        conf["config"]["model"].update(TINY_MODEL)
        conf["config"]["diffusion"]["T"] = 50
        conf["config"]["sample"]["ddim_steps"] = steps
        path.write_text(json.dumps(conf))
    for path in (root / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr.update({k: v for k, v in TINY_TRAFFIC.items() if k in tr})
        if tr["arrivals"]["kind"] == "open":
            tr["arrivals"].update(rate_per_s=TINY_RATE, threads=2)
        path.write_text(json.dumps(tr))
    for path in (root / "workloads").glob("*.json"):
        w = json.loads(path.read_text())
        w["check"].update(sample=2, block=2)
        path.write_text(json.dumps(w))
    return root
