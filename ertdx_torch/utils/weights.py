"""Carry a JAX CondUNet parameter tree into the port's modules.

`params_from_jax(model, tree)` takes the flax tree as nested dicts of
numpy arrays (`variables["params"]` of ertdx's CondUNet) and copies each
leaf into the matching torch parameter:

* Dense kernel (in, out) -> Linear weight (out, in), transposed;
* Conv kernel (k, in, out) -> Conv1d weight (out, in, k);
* LayerNorm / GroupNorm `scale`, `bias` -> `weight`, `bias`;
* `pos_emb` as it is.

Both kernel cases reverse the axes. The flax names come from @nn.compact
creation order; the core block's follow ertdx/models/mega.py:19-22, 52-64
(AdaLN_{0,1,2}/Dense_0, Dense_0 qkv, Dense_1 self-out, Dense_2 cross-q,
Dense_3 cross-kv, Dense_4 cross-out, Dense_5/Dense_6 MLP). A tree leaf
left unused, a parameter left without a leaf, or a shape that disagrees
raises.
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


def flax_path(name: str, depth: int) -> tuple:
    """The flax tree path of the torch parameter `name` of a CondUNet."""
    if name == "pos_emb":
        return ("pos_emb",)
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


def params_from_jax(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Load a flax CondUNet parameter tree into `model`, in place, and
    return the model."""
    flat = dict(_flatten(tree))
    want = {name: flax_path(name, model.depth)
            for name, _ in model.named_parameters()}
    missing = sorted("/".join(p) for p in set(want.values()) - set(flat))
    unused = sorted("/".join(p) for p in set(flat) - set(want.values()))
    if missing or unused:
        raise KeyError(f"parameter tree does not match the model: missing "
                       f"{missing}, unused {unused}")
    with torch.no_grad():
        for name, param in model.named_parameters():
            path = want[name]
            arr = np.asarray(flat[path])
            if path[-1] == "kernel":
                arr = arr.transpose()
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{'/'.join(path)}: tree gives "
                                 f"{arr.shape}, model has "
                                 f"{tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.ascontiguousarray(arr))
                        .to(param.dtype))
    return model
