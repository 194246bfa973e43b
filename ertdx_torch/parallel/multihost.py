"""Multi-process scaling: process-group set-up and process-local batches.

The port of ertdx/parallel/multihost.py. `init_distributed` joins the
torch.distributed process group over a TCP store; `global_mesh` builds
the (data, model) mesh over every rank; `global_batch` assembles the
global batch from each process's local rows (process-major); and
`replicate_tree` broadcasts rank 0's values.

The backend follows the topology, decided before the group starts and
logged: NCCL when every rank has a card of its own, gloo on the CPU and
where ranks share a card (NCCL refuses two ranks on one device). It is
not a flag, and a failed NCCL start is never retried on gloo.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, all_gather_cat, broadcast_, make_mesh, world


def choose_backend(num_processes: int, device=None) -> str:
    """"nccl" when each local rank has a card of its own, else "gloo"."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int,
                     local_device_ids: Optional[list] = None,
                     device=None) -> str:
    """Join the process group (call once on every process, before the
    first collective). `coordinator_address` is "host:port" of rank 0's
    TCP store; `local_device_ids` pins this process's card; `device`
    "cpu" runs the world on the CPU. Returns the backend."""
    backend = choose_backend(num_processes, device)
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    elif backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id))
                              % torch.cuda.device_count())
    print(f"ertdx_torch.parallel: rank {process_id} of {num_processes} "
          f"joins over {backend}", file=sys.stderr, flush=True)
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return backend


def init_from_env(device=None) -> Optional[str]:
    """Join the group a launcher (`python -m torch.distributed.run`)
    describes in the environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT); without one the process stays a world of one and this
    returns None."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return None
    n = int(os.environ["WORLD_SIZE"])
    addr = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
            f"{os.environ['MASTER_PORT']}")
    return init_distributed(addr, n, int(os.environ["RANK"]), device=device)


def process_count() -> int:
    return world()[1]


def process_index() -> int:
    return world()[0]


def global_mesh(data: Optional[int] = None, model: int = 1,
                device=None) -> Mesh:
    """The (data, model) mesh over every process's rank."""
    return make_mesh(data=data, model=model, device=device)


def global_batch(mesh: Mesh, *arrays):
    """The global batch from each process's local rows, process-major
    (process 0's rows first), as tensors on the mesh's device. Every
    process must pass the same row count; uneven counts raise."""
    n_proc = process_count()
    out = []
    for a in arrays:
        t = torch.as_tensor(np.asarray(a)).to(mesh.device)
        if n_proc > 1:
            counts = all_gather_cat(torch.tensor(
                [t.shape[0]], device=mesh.device), dist.group.WORLD)
            counts = counts.cpu().tolist()
            if len(set(counts)) > 1:
                raise ValueError(
                    f"global_batch: uneven per-process rows {counts}; "
                    "pad local shards to a common size (data.pad_batch)")
            t = all_gather_cat(t, dist.group.WORLD)
        out.append(t)
    return out[0] if len(out) == 1 else out


def replicate_tree(mesh: Mesh, tree):
    """Rank 0's values of a tree (nested dicts, lists or tuples of
    tensors or arrays, or an nn.Module's parameters and buffers) on every
    rank, in place for tensors and modules."""
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                broadcast_(t.data)
        return tree
    if isinstance(tree, dict):
        return {k: replicate_tree(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate_tree(mesh, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return broadcast_(tree)
    arr = np.asarray(tree)
    t = broadcast_(torch.as_tensor(arr).to(mesh.device).contiguous())
    return t.cpu().numpy()
