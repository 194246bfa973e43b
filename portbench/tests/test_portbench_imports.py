"""The import guard: a dry run of the harness on the CPU (every module it
loads, at a tiny size) loads no jax, jaxlib, flax or the JAX package
`ertdx`, compared by whole top-level names (`ertdx_torch` is the port),
and the plain reference loads nothing of the port."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.run import forbidden_modules

REPO = Path(__file__).resolve().parents[2]


def _python(code: str, cwd=REPO) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run_loads_no_jax(tmp_path, trace):
    got = _python(f"""
import json, sys, time
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
from portbench import cells, harness, run
from portbench.tests.tiny import tiny_root
root = tiny_root(Path({str(tmp_path)!r}))
for cell in cells.names("workloads", root):
    out = harness.run_cell(cell, 2 ** 35 + 3, 0.3, bool({trace}),
                           t_start=time.perf_counter(), device="cpu",
                           root=root, log=lambda m: None)
    assert out["correct"], out
print(json.dumps({{"forbidden": run.forbidden_modules(),
                  "port": "ertdx_torch" in sys.modules}}))
""")
    assert got == {"forbidden": [], "port": True}


def test_reference_loads_nothing_of_the_port():
    got = _python(f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
import portbench.reference.model, portbench.reference.sampler
import portbench.counts, portbench.check
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}}
                        & {{"ertdx_torch", "ertdx", "jax", "flax"}})))
""")
    assert got == []


def test_forbidden_names_are_whole():
    mods = {"ertdx_torch.serve": 1, "jaxtyping": 1, "flaxen": 1,
            "ertdx_torch": 1}
    assert forbidden_modules(mods) == []
    assert forbidden_modules({**mods, "ertdx.configs": 1, "jax": 1}) == [
        "ertdx", "jax"]
