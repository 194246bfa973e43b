"""Model registry: `build_model` for the port's denoisers.

The port has the flagship `condunet`, with the guidance null context
when `uncond_prob > 0`, the encoder's GN and fused GN+conv kernels
under `pallas_gn`, `pallas_conv` and `pallas_conv_min_width`, and its
slab or flash attention kernels under `use_pallas` with `attn_slab` or
`attn_flash_min_logits`, in float32 or bfloat16 (`dtype`: the compute
dtype, parameters float32, flax's rules; models/condunet.py). A bfloat16
model runs the encoder's slab attention, GroupNorm+SiLU and fused
GN+SiLU+conv3 on their bf16 kernels, its flash attention on the float32
kernels through upcast copies (as JAX's flash kernels compute in
float32), its per-block ensemble attention (`ensemble_pallas`) on the
float32 ensemble kernels through upcast copies too (as JAX's kernels
load bf16 and compute in float32), and samples on the float32 fused
core (models/mega.py casts at entry). The other models of the JAX
package (`refmlp`, configs[0]; `uncondmlp`, configs[1]) are ROADMAP.md
queue 1 item 3 and raise here.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..configs import ModelConfig
from .condunet import CondUNet, init_params


def build_model(cfg: ModelConfig, device=None,
                generator: Optional[torch.Generator] = None) -> CondUNet:
    """The model `cfg` names, on `device` (CUDA unless "cpu" is asked
    for), initialised as flax initialises the JAX model (`init_params`)
    from `generator` (a CPU torch.Generator; seed 0 when none is given).
    Load trained weights with `ertdx_torch.utils.weights.params_from_jax`
    or `ertdx_torch.train.load_best_model`."""
    dev = resolve_device(device)
    if cfg.name != "condunet":
        raise NotImplementedError(
            f"model {cfg.name!r} is not ported yet (ROADMAP.md queue 1 "
            "item 3: the other models)")
    model = CondUNet(param_dim=cfg.param_dim, hidden_dim=cfg.hidden_dim,
                     cond_channels=cfg.cond_channels,
                     base_width=cfg.base_width, depth=cfg.depth,
                     num_heads=cfg.num_heads, core_heads=cfg.core_heads,
                     num_blocks=cfg.num_blocks,
                     ensemble_mega=cfg.ensemble_mega,
                     ensemble_mega_accurate=cfg.ensemble_mega_accurate,
                     parameterization=cfg.parameterization,
                     attn_slab=cfg.attn_slab, uncond_prob=cfg.uncond_prob,
                     ensemble_pallas=cfg.ensemble_pallas,
                     ensemble_min_chains=cfg.ensemble_min_chains,
                     pallas_gn=cfg.pallas_gn, pallas_conv=cfg.pallas_conv,
                     pallas_conv_min_width=cfg.pallas_conv_min_width,
                     use_pallas=cfg.use_pallas,
                     flash_min_logits=cfg.attn_flash_min_logits,
                     dtype=cfg.dtype)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_params(model, generator).to(dev)


__all__ = ["CondUNet", "build_model", "init_params"]
