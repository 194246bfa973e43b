"""Model registry: `build_model` for the port's denoisers.

This slice ports the flagship `condunet`. The other models of the JAX
package (`refmlp`, configs[0]; `uncondmlp`, configs[1]) are ROADMAP.md
queue 1 item 7 and raise here.
"""
from __future__ import annotations

from .. import resolve_device
from ..configs import ModelConfig
from .condunet import CondUNet


def build_model(cfg: ModelConfig, device=None) -> CondUNet:
    """The model `cfg` names, on `device` (CUDA unless "cpu" is asked
    for). Weights are PyTorch's default init; load trained or seeded
    weights with `ertdx_torch.utils.weights.params_from_jax`."""
    dev = resolve_device(device)
    if cfg.name != "condunet":
        raise NotImplementedError(
            f"model {cfg.name!r} is not ported yet (ROADMAP.md queue 1 "
            "item 7: the other models)")
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"dtype {cfg.dtype!r}: the port computes in float32 only")
    if cfg.uncond_prob > 0.0:
        raise NotImplementedError(
            "classifier-free guidance (uncond_prob > 0) is not ported yet "
            "(ROADMAP.md: samplers and guidance)")
    return CondUNet(param_dim=cfg.param_dim, hidden_dim=cfg.hidden_dim,
                    cond_channels=cfg.cond_channels,
                    base_width=cfg.base_width, depth=cfg.depth,
                    num_heads=cfg.num_heads, core_heads=cfg.core_heads,
                    num_blocks=cfg.num_blocks,
                    ensemble_mega=cfg.ensemble_mega,
                    ensemble_mega_accurate=cfg.ensemble_mega_accurate,
                    parameterization=cfg.parameterization).to(dev)


__all__ = ["CondUNet", "build_model"]
