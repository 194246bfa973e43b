"""Carry CondUNet parameters and Adam state between the port and JAX.

`params_from_jax(model, tree)` takes the flax tree as nested dicts of
numpy arrays (`variables["params"]` of ertdx's CondUNet) and copies each
leaf into the matching torch parameter; `params_to_jax(model)` is its
inverse. The layouts:

* Dense kernel (in, out) -> Linear weight (out, in), transposed;
* Conv kernel (k, in, out) -> Conv1d weight (out, in, k);
* LayerNorm / GroupNorm `scale`, `bias` -> `weight`, `bias`;
* FusedGNConv `gn_scale`, `gn_bias`, `kernel` (3, C, Cout), `bias`, under
  the same names and in the same layout (a ResBlock fused by
  `pallas_conv` or `pallas_conv_min_width` holds FusedGNConv_{0,1} where
  the plain one holds GNSiLU_{0,1} and Conv_{0,1});
* `pos_emb`, and the guidance null context `null_token` and `null_vec`,
  as they are.

Dense and Conv kernels reverse the axes. The flax names come from
@nn.compact creation order; the core block's follow
ertdx/models/mega.py:19-22, 52-64 (AdaLN_{0,1,2}/Dense_0, Dense_0 qkv,
Dense_1 self-out, Dense_2 cross-q, Dense_3 cross-kv, Dense_4 cross-out,
Dense_5/Dense_6 MLP). A tree leaf
left unused, a parameter left without a leaf, or a shape that disagrees
raises.

`adam_state_to_jax` / `adam_state_from_jax` map torch Adam's per-parameter
`exp_avg`, `exp_avg_sq` and `step` to and from optax's adam state as
flax serializes it: {"0": {"count", "mu", "nu"}, "1": {...}}, where "1"
is the learning-rate stage, empty for a constant lr and {"count"} for a
schedule or warmup (ertdx/train.py:85-107). With `flat=True` mu and nu
are the single vectors of `optax.flatten(optax.adam(...))`
(flat_optimizer, ertdx/train.py:73-76): the leaves of the flax tree
concatenated in jax's flattening order, dict keys sorted at every level
(`ravel_tree`, `unravel_like`).
"""
from __future__ import annotations

import numpy as np
import torch

_BLOCK = {"ada1.proj": ("AdaLN_0", "Dense_0"),
          "ada2.proj": ("AdaLN_1", "Dense_0"),
          "ada3.proj": ("AdaLN_2", "Dense_0"),
          "qkv": ("Dense_0",), "self_out": ("Dense_1",),
          "cross_q": ("Dense_2",), "cross_kv": ("Dense_3",),
          "cross_out": ("Dense_4",), "mlp_in": ("Dense_5",),
          "mlp_out": ("Dense_6",)}
_RES = {"norm1": "GNSiLU_0", "conv1": "Conv_0", "norm2": "GNSiLU_1",
        "conv2": "Conv_1", "skip": "Conv_2"}
# a fused ResBlock holds FusedGNConv_{0,1}; its skip is then the block's
# only nn.Conv (ertdx/models/condunet.py:97-110)
_RES_FUSED = {"fused1": "FusedGNConv_0", "fused2": "FusedGNConv_1",
              "skip": "Conv_0"}
_ATTN = {"norm": "LayerNorm_0", "qkv": "Dense_0", "out": "Dense_1"}
_ENC = {"stem": "Dense_0", "tokens": "Dense_1", "pool": "Dense_2"}
_NORMS = {"norm", "norm1", "norm2", "out_norm"}
# parameters of the CondUNet itself, named alike in both packages; the
# null context exists only with uncond_prob > 0
_TOP_LEVEL = {"pos_emb", "null_token", "null_vec"}


def fused_blocks(model: torch.nn.Module) -> frozenset:
    """Module names of the model's ResBlocks whose GN+SiLU+conv pairs are
    fused (FusedGNConv), e.g. {"encoder.res_out"}."""
    return frozenset(name for name, mod in model.named_modules()
                     if hasattr(mod, "fused1"))


def flax_path(name: str, depth: int, fused: frozenset = frozenset()
              ) -> tuple:
    """The flax tree path of the torch parameter `name` of a CondUNet;
    `fused` names the fused ResBlocks (`fused_blocks(model)`)."""
    if name in _TOP_LEVEL:
        return (name,)
    *mod, leaf = name.split(".")
    if leaf in ("weight", "bias"):
        fleaf = {"weight": "scale" if mod[-1] in _NORMS else "kernel",
                 "bias": "bias"}[leaf]
    else:                                   # FusedGNConv: flax's own names
        fleaf = leaf
    top = mod[0]
    if top == "blocks":
        base = (f"blocks_{mod[1]}",) + _BLOCK[".".join(mod[2:])]
    elif top == "encoder":
        sub = mod[1]
        if sub in _ENC:
            base = ("encoder", _ENC[sub])
        elif sub == "attn":
            base = ("encoder", "SelfAttention1D_0", _ATTN[mod[2]])
        elif sub == "downs":
            base = ("encoder", f"Conv_{mod[2]}")
        elif sub in ("res", "res_out"):
            block, part = ((f"ResBlock1D_{mod[2]}", mod[3]) if sub == "res"
                           else (f"ResBlock1D_{depth}", mod[2]))
            names = (_RES_FUSED if ".".join(mod[:-1]) in fused
                     else _RES)
            base = ("encoder", block, names[part])
        else:
            raise KeyError(name)
    else:
        base = (top,)
    return base + (fleaf,)


def _reversed_axes(name: str) -> bool:
    """Whether the torch tensor holds the flax kernel with its axes
    reversed: Linear and Conv1d weights do; FusedGNConv keeps flax's
    (3, C, Cout) layout, which its CUDA kernels read."""
    return name.endswith(".weight")


def _paths(model: torch.nn.Module) -> dict:
    fused = fused_blocks(model)
    return {name: flax_path(name, model.depth, fused)
            for name, _ in model.named_parameters()}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _sorted_leaves(tree, prefix=()):
    """(path, leaf) in jax.tree_util's order for nested dicts: keys sorted
    at every level, depth first."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _sorted_leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def ravel_tree(tree: dict) -> np.ndarray:
    """A flax-layout tree as one float32 vector, in the order optax.flatten
    concatenates it."""
    return np.concatenate([np.asarray(v, np.float32).reshape(-1)
                           for _, v in _sorted_leaves(tree)])


def unravel_like(shapes: dict, flat) -> dict:
    """The inverse of `ravel_tree` for a tree of shapes (`flax_shapes`)."""
    flat = np.asarray(flat, np.float32).reshape(-1)
    leaves = list(_sorted_leaves(shapes))
    total = sum(int(np.prod(shape)) for _, shape in leaves)
    if flat.size != total:
        raise ValueError(f"flat optimizer state has {flat.size} entries, "
                         f"the model {total}")
    tree: dict = {}
    offset = 0
    for path, shape in leaves:
        size = int(np.prod(shape))
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = flat[offset:offset + size].reshape(shape)
        offset += size
    return tree


def flax_shapes(model: torch.nn.Module) -> dict:
    """The flax parameter layout of `model`: a nested dict of shapes."""
    tree: dict = {}
    paths = _paths(model)
    for name, param in model.named_parameters():
        path = paths[name]
        shape = tuple(param.shape)
        if path[-1] == "kernel" and _reversed_axes(name):
            shape = shape[::-1]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = shape
    return tree


def named_to_jax(model: torch.nn.Module, named: dict) -> dict:
    """Per-parameter tensors {torch name: tensor shaped like the
    parameter} -> a flax-layout tree of float32 numpy arrays (kernels
    transposed back)."""
    tree: dict = {}
    paths = _paths(model)
    for name, param in model.named_parameters():
        path = paths[name]
        arr = named[name].detach().to("cpu", torch.float32).numpy()
        if path[-1] == "kernel" and _reversed_axes(name):
            arr = arr.transpose()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return tree


def params_to_jax(model: torch.nn.Module) -> dict:
    """The model's parameters as a flax CondUNet tree (the inverse of
    `params_from_jax`)."""
    return named_to_jax(model, dict(model.named_parameters()))


def named_from_jax(model: torch.nn.Module, tree) -> dict:
    """A flax-layout tree -> {torch name: float32 CPU tensor shaped like
    the parameter}. Raises on a missing or unused leaf or a wrong shape."""
    flat = dict(_flatten(tree))
    want = _paths(model)
    missing = sorted("/".join(p) for p in set(want.values()) - set(flat))
    unused = sorted("/".join(p) for p in set(flat) - set(want.values()))
    if missing or unused:
        raise KeyError(f"parameter tree does not match the model: missing "
                       f"{missing}, unused {unused}")
    out = {}
    for name, param in model.named_parameters():
        path = want[name]
        arr = np.asarray(flat[path])
        if path[-1] == "kernel" and _reversed_axes(name):
            arr = arr.transpose()
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{'/'.join(path)}: tree gives {arr.shape}, "
                             f"model has {tuple(param.shape)}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32,
                                              order="C"))
    return out


def adam_state_to_jax(opt: torch.optim.Optimizer, model: torch.nn.Module,
                      schedule: bool, flat: bool = False) -> dict:
    """torch Adam's state for `model`'s parameters -> optax's adam state
    tree (mu and nu raveled with `flat`). Moments that do not exist yet
    (no step taken) are zeros."""
    named = dict(model.named_parameters())
    mu, nu, count = {}, {}, 0
    for name, param in named.items():
        st = opt.state.get(param, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(param))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(param))
        if "step" in st:
            count = int(st["step"])
    mu_tree, nu_tree = named_to_jax(model, mu), named_to_jax(model, nu)
    if flat:
        mu_tree, nu_tree = ravel_tree(mu_tree), ravel_tree(nu_tree)
    count_arr = np.asarray(count, dtype=np.int32)
    return {"0": {"count": count_arr, "mu": mu_tree, "nu": nu_tree},
            "1": {"count": count_arr.copy()} if schedule else {}}


def adam_state_from_jax(opt: torch.optim.Optimizer, model: torch.nn.Module,
                        tree: dict, flat: bool = False) -> None:
    """Load optax's adam state tree (flat mu and nu with `flat`) into
    torch Adam's state, in place."""
    count = int(np.asarray(tree["0"]["count"]))
    mu_tree, nu_tree = tree["0"]["mu"], tree["0"]["nu"]
    if flat:
        shapes = flax_shapes(model)
        mu_tree = unravel_like(shapes, mu_tree)
        nu_tree = unravel_like(shapes, nu_tree)
    mu = named_from_jax(model, mu_tree)
    nu = named_from_jax(model, nu_tree)
    for name, param in model.named_parameters():
        opt.state[param] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name].to(param.device),
            "exp_avg_sq": nu[name].to(param.device)}


def params_from_jax(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Load a flax CondUNet parameter tree into `model`, in place, and
    return the model."""
    named = named_from_jax(model, tree)
    with torch.no_grad():
        for name, param in model.named_parameters():
            param.copy_(named[name].to(param.dtype))
    return model
