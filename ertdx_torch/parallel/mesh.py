"""A (data, model) mesh over the ranks of a torch.distributed world.

The port of ertdx/parallel/mesh.py. JAX's mesh is single-controller: one
process drives every device, and GSPMD inserts the collectives. PyTorch
is multi-controller: one process a rank, every rank running the same
program. The port's mesh is a (data, model) grid over the world's ranks,
row-major as in `make_mesh`: rank = d * model + m. Without
`torch.distributed` initialised the process is a world of one.

Every entry point that takes `mesh=` is a collective: every rank of the
mesh calls it with the same arguments, computes the global function that
JAX's GSPMD program computes, and returns what JAX's caller would read
from the global array. Batches shard over `data` (contiguous rows, rank
d holding rows [d n/D, (d+1) n/D)); a batch that does not divide the
data axis runs replicated, as JAX keeps it replicated. Random draws are
made at the global shape on every rank from the shared generator, and
each rank keeps its own rows, so the streams equal the single-process
ones.

The collectives are `all_reduce` (sum), `all_gather` and `broadcast`
only: gloo has CUDA variants of these three, and no `reduce_scatter`.

Tensor parallelism (`tp_shard_params`) follows JAX's rule for which
leaves shard: those with ndim >= 2 whose last (flax) dim is >= min_dim
and divisible by the model-axis size, column-sharded over `model`. The
port's layers do it as follows:

* a Dense or Conv weight (nn.Linear, nn.Conv1d and their subclasses)
  keeps its local slice of output channels; the layer computes its
  slice, all-gathers the activation along channels (`gather_columns`,
  whose backward keeps the local slice of the gradient) and adds the
  replicated bias after the gather. The layer's input passes through
  `reduce_grad` (identity forward, all-reduce of the input gradient
  over `model` backward), because each rank's input gradient is the
  part its slice contributes;
* any other leaf (the fused GN+SiLU+conv3's kernel, `pos_emb`, and
  every weight the fused core reads through `models/mega.py`) is
  gathered whole before use (`full_param`), as GSPMD replicates a
  `pallas_call`'s operands; the gather's backward keeps the local slice.

Sharded leaves' gradients are all-reduced over `data` only, and Adam
steps each rank's local slices. `utils/weights.py` gathers the full tree
for checkpoints and `params_to_jax`.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def world() -> tuple:
    """(rank, world size) of torch.distributed, (0, 1) without it."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of ranks: its shape dict, this rank's
    coordinates, this rank's data and model process groups (None where an
    axis has one rank) and the rank's device."""

    shape: dict
    rank: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object
    device: torch.device

    def rows(self, n: int) -> Optional[slice]:
        """This rank's rows of an n-row global batch: contiguous rows
        when n divides the data axis, else None (the batch runs
        replicated)."""
        d = self.shape[DATA_AXIS]
        if d == 1 or n % d:
            return None
        k = n // d
        return slice(self.data_index * k, (self.data_index + 1) * k)

    def condition_rows(self, b: int, r: int) -> Optional[tuple]:
        """(conditions, chains): this rank's slice of b conditions and of
        their b * r condition-major chains (b * R + r, contiguous), or
        None when b does not divide the data axis."""
        conds = self.rows(b)
        if conds is None:
            return None
        return conds, slice(conds.start * r, conds.stop * r)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"device={self.device})")


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when asked for, else
    cuda:(local_rank % device_count); raises without a card."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ertdx_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the mesh on the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", world()[0]))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(data: Optional[int] = None, model: int = 1,
              device=None) -> Mesh:
    """Build a (data, model) mesh over the world's ranks (JAX's
    "devices"); data=None takes every rank left. `device` is "cpu" or the
    card (the default). A call on every rank: it creates the process
    groups. A mesh must cover the whole world."""
    rank, n = world()
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices, have {n}")
    if data * model < n:
        raise ValueError(
            f"mesh {data}x{model} covers {data * model} of the world's "
            f"{n} ranks: launch {data * model} processes")
    data_group = model_group = None
    if data > 1:
        for m in range(model):          # every rank creates every group
            ranks = [d * model + m for d in range(data)]
            g = dist.new_group(ranks)
            if rank in ranks:
                data_group = g
    if model > 1:
        for d in range(data):
            ranks = [d * model + m for m in range(model)]
            g = dist.new_group(ranks)
            if rank in ranks:
                model_group = g
    d_idx, m_idx = divmod(rank, model)
    return Mesh({DATA_AXIS: data, MODEL_AXIS: model}, rank, d_idx, m_idx,
                data_group, model_group, rank_device(device))


def check_mesh(mesh) -> Optional[Mesh]:
    """`mesh` if it is a Mesh (or None); anything else raises."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be an ertdx_torch.parallel.Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    return mesh


def mesh_device(mesh: Optional[Mesh], device=None) -> torch.device:
    """The device an entry point runs on: `resolve_device(device)`
    without a mesh, else the mesh's (a `device` of another type raises).
    A `mesh` that is not a Mesh raises TypeError."""
    if check_mesh(mesh) is None:
        return resolve_device(device)
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {device} asked for on a mesh over "
                         f"{mesh.device}")
    return mesh.device


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of global arrays: split over `data` (contiguous),
    replicated over `model`. An array whose rows do not divide the data
    axis raises, as jax.device_put does."""
    out = []
    for a in arrays:
        n = a.shape[0]
        if n % mesh.shape[DATA_AXIS]:
            raise ValueError(f"{n} rows do not divide the data axis "
                             f"{mesh.shape[DATA_AXIS]}")
        rows = mesh.rows(n)
        out.append(a if rows is None else a[rows])
    return out[0] if len(out) == 1 else tuple(out)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Zero-pad `axis` to a multiple (so batches divide the mesh)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad), n


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place (a no-op without a group)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """`t` of every rank of `group`, concatenated along `dim` in group
    order. bf16 travels as float32 (exact), which gloo takes."""
    if group is None:
        return t
    dtype = t.dtype
    src = t.float() if dtype == torch.bfloat16 else t
    src = src.contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(dtype)


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Broadcast `t` from global rank `src`, in place."""
    if world()[1] > 1:
        dist.broadcast(t, src, group=group)
    return t


def barrier() -> None:
    """Wait for every rank of the world (a no-op in a world of one)."""
    if world()[1] > 1:
        dist.barrier()


def is_writer() -> bool:
    """Whether this rank writes files and prints: rank 0."""
    return world()[0] == 0


def data_all_reduce_grads(model: nn.Module, mesh: Optional[Mesh]) -> None:
    """Sum every parameter gradient over the data axis: one all_reduce of
    the flattened gradients."""
    group = None if mesh is None else mesh.data_group
    if group is None:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """A leaf's column shard: the model group, the torch dim that is
    split, the model-axis size and this rank's index on it. A copy of a
    sharded model shares it (a process group cannot be copied)."""

    group: object
    dim: int
    size: int
    index: int

    def __deepcopy__(self, memo):
        return self


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, info):
        ctx.dim, ctx.info, ctx.width = dim, info, x.shape[dim]
        return all_gather_cat(x, info.group, dim)

    @staticmethod
    def backward(ctx, grad):
        k = ctx.width
        return grad.narrow(ctx.dim, ctx.info.index * k, k), None, None


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, info):
        ctx.info = info
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        return all_reduce_(grad, ctx.info.group), None


def gather_columns(x: torch.Tensor, dim: int, info: ShardInfo):
    """All-gather a column shard along `dim`; the backward keeps the
    local slice of the gradient."""
    dim = dim % x.dim()
    if not torch.is_grad_enabled() or not x.requires_grad:
        return all_gather_cat(x, info.group, dim)
    return _GatherColumns.apply(x, dim, info)


def reduce_grad(x: torch.Tensor, info: ShardInfo):
    """Identity forward; the backward sums the gradient over the model
    group (each rank's part is its slice's contribution)."""
    if not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _ReduceGrad.apply(x, info)


class _ColumnLinear:
    """Column-parallel forward of a (Dense or nn.Linear) layer whose weight
    holds this rank's output rows."""

    def forward(self, x):
        dt = getattr(self, "compute_dtype", self.weight.dtype)
        info = self.tp_shard
        y = F.linear(reduce_grad(x.to(dt), info), self.weight.to(dt))
        y = gather_columns(y, -1, info)
        return y if self.bias is None else y + self.bias.to(dt)


class _ColumnConv:
    """Column-parallel convolution: the local output channels, gathered
    along the channel axis of (B, C, L), then the bias."""

    def _conv_forward(self, x, w, b):
        info = self.tp_shard
        y = super()._conv_forward(reduce_grad(x, info), w, None)
        y = gather_columns(y, 1, info)
        return y if b is None else y + b[None, :, None]


_COLUMN_CLASSES: dict = {}


def _column_class(cls):
    if cls not in _COLUMN_CLASSES:
        mixin = _ColumnConv if issubclass(cls, nn.Conv1d) else _ColumnLinear
        _COLUMN_CLASSES[cls] = type(f"Column{cls.__name__}", (mixin, cls),
                                    {"__module__": __name__})
    return _COLUMN_CLASSES[cls]


def _flax_last_dim(name: str, param: torch.Tensor) -> int:
    """The torch dim that holds the flax leaf's last axis: 0 for Linear
    and Conv1d weights (their axes are reversed), else the last."""
    return 0 if name.endswith(".weight") else param.dim() - 1


def shard_of(model: nn.Module, name: str) -> Optional[ShardInfo]:
    """The ShardInfo of parameter `name`, None if it is whole."""
    mod_name, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    if leaf == "weight" and getattr(mod, "tp_shard", None) is not None:
        return mod.tp_shard
    return getattr(mod, "tp_params", {}).get(leaf)


def whole_tensor(model: nn.Module, name: str, t: torch.Tensor
                 ) -> torch.Tensor:
    """A tensor shaped like parameter `name` (the parameter, its
    gradient, an Adam moment), gathered whole over the model axis where
    the parameter is a column shard; detached. A collective on a
    sharded leaf."""
    info = shard_of(model, name)
    if info is None:
        return t.detach()
    return all_gather_cat(t.detach(), info.group, info.dim)


def full_param(module: nn.Module, name: str) -> torch.Tensor:
    """Parameter `name` of `module`, gathered whole where it is a column
    shard (its gradient flows back to the local slice)."""
    p = getattr(module, name)
    info = (module.tp_shard if name == "weight"
            and getattr(module, "tp_shard", None) is not None
            else getattr(module, "tp_params", {}).get(name))
    return p if info is None else gather_columns(p, info.dim, info)


def tp_leaves(model: nn.Module, tp: int, min_dim: int = 256) -> dict:
    """{torch name: flax path} of the leaves JAX's rule shards over a
    model axis of size `tp`: ndim >= 2, the last flax dim >= min_dim and
    divisible by tp."""
    from ..utils.weights import model_paths
    paths = model_paths(model)
    out = {}
    for name, p in model.named_parameters():
        last = p.shape[_flax_last_dim(name, p)]
        if p.dim() >= 2 and last >= min_dim and last % tp == 0:
            out[name] = paths[name]
    return out


def tp_shard_params(model: nn.Module, mesh: Mesh, min_dim: int = 256
                    ) -> nn.Module:
    """Column-shard `model`'s wide leaves over the mesh's model axis, in
    place (JAX's rule, `tp_leaves`); the rest stays replicated. With
    model=1 nothing changes. Build the optimizer after this call (or
    before any step), so that its moments take the local shapes.
    Returns the model; `model.tp_leaves` names the sharded leaves."""
    tp = mesh.shape[MODEL_AXIS]
    leaves = tp_leaves(model, tp, min_dim) if tp > 1 else {}
    for name in leaves:
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        p = getattr(mod, leaf)
        dim = _flax_last_dim(name, p)
        k = p.shape[dim] // tp
        info = ShardInfo(mesh.model_group, dim, tp, mesh.model_index)
        with torch.no_grad():
            p.data = p.data.narrow(dim, mesh.model_index * k, k).clone()
        if leaf == "weight" and isinstance(mod, (nn.Linear, nn.Conv1d)):
            mod.__class__ = _column_class(type(mod))
            mod.tp_shard = info
        else:
            mod.tp_params = {**getattr(mod, "tp_params", {}), leaf: info}
    model.tp_leaves = leaves
    return model


# ---------------------------------------------------------------------------
# the batch the model's gates read
# ---------------------------------------------------------------------------

_ROW_SHARDS = contextvars.ContextVar("ertdx_torch_row_shards", default=1)


@contextlib.contextmanager
def sharded_rows(shards: int):
    """Within the block, the model sees 1/`shards` of each global batch:
    `global_rows` multiplies a local row count back. The batch gates of
    models/condunet.py read the global batch, as JAX's trace under GSPMD
    does."""
    token = _ROW_SHARDS.set(int(shards))
    try:
        yield
    finally:
        _ROW_SHARDS.reset(token)


def global_rows(local: int) -> int:
    """The global row count of a batch whose local count is `local`."""
    return local * _ROW_SHARDS.get()
