"""The reference's `.pth` weights on the port: state dict -> RefCondMLP.

The reference trains `ConditionalDiffusionModel`
(ERT_Conditional_Diffusion.py:121-164) and saves it with
`torch.save(model.state_dict(), ...)` (`:340-345`). Its layers are the
port's RefCondMLP's, under other names; this module maps them, as
ertdx/compat.py:27-43 maps them onto the flax tree, so a reference user
carries trained weights over instead of retraining:

    model, tree = ertdx_torch.compat.load_reference_model(
        "best_model.pth", cfg.model)

The reference runs its convs channel-first on (B, C, L) and the models
take (B, L, C): only the input's layout differs, not the weights'. Its
head concatenates [x, t_emb, cond_emb] (`:161`) as RefCondMLP.denoise
does, so `mlp.0` needs no column permutation. `reference_tree` also
gives the flax-layout tree (torch Linear (out, in) -> Dense (in, out);
Conv1d (out, in, k) -> Conv (k, in, out)), which is what the JAX
package's `torch_reference_params` returns.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .configs import ModelConfig
from .models import build_model
from .models.refmlp import RefCondMLP
from .utils.weights import params_from_jax

# reference state-dict key -> (RefCondMLP flax path, transpose)
_MAP = {
    "condition_encoder.0.weight": ("conv1/Conv_0/kernel", (2, 1, 0)),
    "condition_encoder.0.bias": ("conv1/Conv_0/bias", None),
    "condition_encoder.2.weight": ("conv2/Conv_0/kernel", (2, 1, 0)),
    "condition_encoder.2.bias": ("conv2/Conv_0/bias", None),
    # Sequential indices: 0 Conv, 1 ReLU, 2 Conv, 3 ReLU, 4 AvgPool,
    # 5 Flatten, 6 Linear, 7 ReLU
    "condition_encoder.6.weight": ("cond_proj/Dense_0/kernel", (1, 0)),
    "condition_encoder.6.bias": ("cond_proj/Dense_0/bias", None),
    "time_embed.0.weight": ("time_proj/Dense_0/kernel", (1, 0)),
    "time_embed.0.bias": ("time_proj/Dense_0/bias", None),
    "mlp.0.weight": ("head1/Dense_0/kernel", (1, 0)),
    "mlp.0.bias": ("head1/Dense_0/bias", None),
    "mlp.2.weight": ("head2/Dense_0/kernel", (1, 0)),
    "mlp.2.bias": ("head2/Dense_0/bias", None),
}


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


def reference_tree(state: Any) -> Dict:
    """The reference's weights as RefCondMLP's flax-layout tree of
    float32 numpy arrays (ertdx.compat.torch_reference_params), from a
    `.pth` path, the state dict itself (tensors or arrays), or a
    checkpoint dict that holds it under `state_dict` or `model`. Raises
    KeyError listing the missing keys."""
    if isinstance(state, (str, bytes)) or hasattr(state, "__fspath__"):
        state = torch.load(state, map_location="cpu", weights_only=True)
    if isinstance(state, Mapping):
        for alias in ("state_dict", "model"):
            inner = state.get(alias)
            if isinstance(inner, Mapping) and "mlp.0.weight" in inner:
                state = inner
                break
    missing = [k for k in _MAP if k not in state]
    if missing:
        raise KeyError(
            f"not a reference ConditionalDiffusionModel state dict; "
            f"missing keys: {missing}")
    tree: Dict = {}
    for key, (path, perm) in _MAP.items():
        arr = _to_numpy(state[key])
        if perm is not None:
            arr = np.ascontiguousarray(arr.transpose(perm))
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree


def load_reference_model(state: Any, mcfg: ModelConfig, device=None
                         ) -> Tuple[RefCondMLP, Dict]:
    """(the RefCondMLP that `mcfg`, a `refmlp` ModelConfig, builds on
    `device` (CUDA unless "cpu" is asked for), holding the reference's
    weights; the flax-layout tree). Weights of other widths raise, as
    does any other model: the reference's layers map onto refmlp's."""
    if mcfg.name != "refmlp":
        raise ValueError("the reference's weights map onto the reference "
                         "architecture: the model must be 'refmlp'")
    tree = reference_tree(state)
    model = build_model(mcfg, device)
    params_from_jax(model, tree)
    return model, tree
