"""Carry CondUNet parameters and Adam state between the port and JAX.

`params_from_jax(model, tree)` takes the flax tree as nested dicts of
numpy arrays (`variables["params"]` of ertdx's CondUNet) and copies each
leaf into the matching torch parameter; `params_to_jax(model)` is its
inverse. The layouts:

* Dense kernel (in, out) -> Linear weight (out, in), transposed;
* Conv kernel (k, in, out) -> Conv1d weight (out, in, k);
* LayerNorm / GroupNorm `scale`, `bias` -> `weight`, `bias`;
* `pos_emb`, and the guidance null context `null_token` and `null_vec`,
  as they are.

Both kernel cases reverse the axes. The flax names come from @nn.compact
creation order; the core block's follow ertdx/models/mega.py:19-22, 52-64
(AdaLN_{0,1,2}/Dense_0, Dense_0 qkv, Dense_1 self-out, Dense_2 cross-q,
Dense_3 cross-kv, Dense_4 cross-out, Dense_5/Dense_6 MLP). A tree leaf
left unused, a parameter left without a leaf, or a shape that disagrees
raises.

`adam_state_to_jax` / `adam_state_from_jax` map torch Adam's per-parameter
`exp_avg`, `exp_avg_sq` and `step` to and from optax's adam state as
flax serializes it: {"0": {"count", "mu", "nu"}, "1": {...}}, where "1"
is the learning-rate stage, empty for a constant lr and {"count"} for a
schedule or warmup (ertdx/train.py:85-107).
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
_ATTN = {"norm": "LayerNorm_0", "qkv": "Dense_0", "out": "Dense_1"}
_ENC = {"stem": "Dense_0", "tokens": "Dense_1", "pool": "Dense_2"}
_NORMS = {"norm", "norm1", "norm2", "out_norm"}
# parameters of the CondUNet itself, named alike in both packages; the
# null context exists only with uncond_prob > 0
_TOP_LEVEL = {"pos_emb", "null_token", "null_vec"}


def flax_path(name: str, depth: int) -> tuple:
    """The flax tree path of the torch parameter `name` of a CondUNet."""
    if name in _TOP_LEVEL:
        return (name,)
    *mod, leaf = name.split(".")
    fleaf = {"weight": "scale" if mod[-1] in _NORMS else "kernel",
             "bias": "bias"}[leaf]
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
        elif sub == "res":
            base = ("encoder", f"ResBlock1D_{mod[2]}", _RES[mod[3]])
        elif sub == "res_out":
            base = ("encoder", f"ResBlock1D_{depth}", _RES[mod[2]])
        else:
            raise KeyError(name)
    else:
        base = (top,)
    return base + (fleaf,)


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def flax_shapes(model: torch.nn.Module) -> dict:
    """The flax parameter layout of `model`: a nested dict of shapes."""
    tree: dict = {}
    for name, param in model.named_parameters():
        path = flax_path(name, model.depth)
        shape = tuple(param.shape)
        if path[-1] == "kernel":
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
    for name, param in model.named_parameters():
        path = flax_path(name, model.depth)
        arr = named[name].detach().to("cpu", torch.float32).numpy()
        if path[-1] == "kernel":
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
    want = {name: flax_path(name, model.depth)
            for name, _ in model.named_parameters()}
    missing = sorted("/".join(p) for p in set(want.values()) - set(flat))
    unused = sorted("/".join(p) for p in set(flat) - set(want.values()))
    if missing or unused:
        raise KeyError(f"parameter tree does not match the model: missing "
                       f"{missing}, unused {unused}")
    out = {}
    for name, param in model.named_parameters():
        path = want[name]
        arr = np.asarray(flat[path])
        if path[-1] == "kernel":
            arr = arr.transpose()
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{'/'.join(path)}: tree gives {arr.shape}, "
                             f"model has {tuple(param.shape)}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32,
                                              order="C"))
    return out


def adam_state_to_jax(opt: torch.optim.Optimizer, model: torch.nn.Module,
                      schedule: bool) -> dict:
    """torch Adam's state for `model`'s parameters -> optax's adam state
    tree. Moments that do not exist yet (no step taken) are zeros."""
    named = dict(model.named_parameters())
    mu, nu, count = {}, {}, 0
    for name, param in named.items():
        st = opt.state.get(param, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(param))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(param))
        if "step" in st:
            count = int(st["step"])
    count_arr = np.asarray(count, dtype=np.int32)
    return {"0": {"count": count_arr, "mu": named_to_jax(model, mu),
                  "nu": named_to_jax(model, nu)},
            "1": {"count": count_arr.copy()} if schedule else {}}


def adam_state_from_jax(opt: torch.optim.Optimizer, model: torch.nn.Module,
                        tree: dict) -> None:
    """Load optax's adam state tree into torch Adam's state, in place."""
    count = int(np.asarray(tree["0"]["count"]))
    mu = named_from_jax(model, tree["0"]["mu"])
    nu = named_from_jax(model, tree["0"]["nu"])
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
