"""Model registry: `build_model` for the port's three denoisers.

Every model has `encode_condition(condition)` (the context, computed
once a batch or a posterior run), `denoise(x, t, ctx)` (one denoising
call on (B, P) chains) and `forward(x, t, condition)`; a model trained
with `uncond_prob > 0` also has `drop_condition(ctx, drop)`, the
guidance null context. The names of ertdx/models/__init__.py:

* `refmlp` (configs[0], the CLI's default): the reference's RefCondMLP
  (models/refmlp.py), float32 whatever `dtype` says, as JAX builds it;
* `uncondmlp` (configs[1]): UncondMLP (models/uncond.py), three residual
  blocks whatever `num_blocks` says, as JAX builds it;
* `condunet` (configs[2]-[4]): the flagship, the only model with
  `denoise_ensemble` (the condition-major chain layout and the fused
  core), with the encoder's GN and fused GN+conv kernels under
  `pallas_gn`, `pallas_conv` and `pallas_conv_min_width`, and its slab
  or flash attention kernels under `use_pallas` with `attn_slab` or
  `attn_flash_min_logits`, in float32 or bfloat16 (`dtype`: the compute
  dtype, parameters float32, flax's rules; models/condunet.py). A
  bfloat16 model runs the encoder's slab attention, GroupNorm+SiLU and
  fused GN+SiLU+conv3 on their bf16 kernels, its flash attention on the
  float32 kernels through upcast copies (as JAX's flash kernels compute
  in float32), its per-block ensemble attention (`ensemble_pallas`) on
  the float32 ensemble kernels through upcast copies too (as JAX's
  kernels load bf16 and compute in float32), and samples on the float32
  fused core (models/mega.py casts at entry).

The two MLPs run no kernel of their own: JAX computes them with nn.Conv
and nn.Dense outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .. import resolve_device
from ..configs import ModelConfig
from .condunet import CondUNet, init_params
from .refmlp import RefCondMLP, init_refmlp
from .uncond import UncondMLP, init_uncond

Model = Union[RefCondMLP, UncondMLP, CondUNet]


def build_model(cfg: ModelConfig, device=None,
                generator: Optional[torch.Generator] = None) -> Model:
    """The model `cfg` names, on `device` (CUDA unless "cpu" is asked
    for), initialised as the JAX package initialises it (`init_refmlp`,
    `init_uncond`, `init_params`) from `generator` (a CPU
    torch.Generator; seed 0 when none is given). Load trained weights
    with `ertdx_torch.utils.weights.params_from_jax` or
    `ertdx_torch.train.load_best_model`."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if cfg.name == "refmlp":
        model = RefCondMLP(param_dim=cfg.param_dim,
                           hidden_dim=cfg.hidden_dim,
                           cond_channels=cfg.cond_channels,
                           uncond_prob=cfg.uncond_prob,
                           parameterization=cfg.parameterization)
        return init_refmlp(model, generator).to(dev)
    if cfg.name == "uncondmlp":
        model = UncondMLP(param_dim=cfg.param_dim, hidden_dim=cfg.hidden_dim,
                          parameterization=cfg.parameterization)
        return init_uncond(model, generator).to(dev)
    if cfg.name != "condunet":
        raise ValueError(f"unknown model {cfg.name!r}")
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
    return init_params(model, generator).to(dev)


__all__ = ["CondUNet", "Model", "RefCondMLP", "UncondMLP", "build_model",
           "init_params", "init_refmlp", "init_uncond"]
