"""One rank of a gloo world that runs the port's mesh jobs.

    python tests/torch_mesh_worker.py <rank> <world> <port> <dir> <job>...

Not a pytest module (no test_ prefix): tests/torch_mesh_common.py
launches one world per test module (tests/test_torch_parallel.py,
test_torch_dp_train.py, test_torch_dp_sample.py, test_torch_tp.py), as
tests/test_multihost.py launches tests/multihost_worker.py. Each rank
pins torch to one thread, joins the gloo world on localhost:<port> and
runs the named jobs of tests/torch_mesh_jobs.py in order; a job reads its
inputs from <dir> and writes its outputs there. A job that raises makes
the rank exit non-zero. The last stdout line is one JSON object: the
rank and each job's seconds.
"""
import json
import os
import sys
import time
from pathlib import Path

rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], Path(sys.argv[4]))
jobs = sys.argv[5:]

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import torch  # noqa: E402

torch.set_num_threads(1)

from ertdx_torch.parallel.multihost import init_distributed  # noqa: E402

import torch_mesh_jobs  # noqa: E402

init_distributed(f"localhost:{port}", world, rank, device="cpu")
seconds = {}
try:
    for name in jobs:
        t0 = time.perf_counter()
        getattr(torch_mesh_jobs, name)(torch_mesh_jobs.Ctx(rank, world,
                                                           out_dir))
        seconds[name] = round(time.perf_counter() - t0, 3)
finally:
    torch.distributed.destroy_process_group()
print(json.dumps({"rank": rank, "seconds": seconds}), flush=True)
