"""Config dataclasses and presets, field for field as in ertdx/configs.py.

The field names and defaults match the JAX package so that a checkpoint's
`meta.json` config echo means the same thing to both packages
(ertdx/configs.py:13-200). Only the presets this slice serves are here:
FULL_CONDITIONAL (configs[2]) and DDIM_ENSEMBLE (configs[3]).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    T: int = 500
    beta_start: float = 1e-4
    beta_end: float = 0.02
    schedule: str = "linear"       # "linear" | "cosine"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "refmlp"           # "refmlp" | "uncondmlp" | "condunet"
    param_dim: int = 29
    hidden_dim: int = 128
    cond_channels: int = 14
    cond_length: int = 4693
    # condunet-only knobs
    base_width: int = 64
    depth: int = 3
    num_heads: int = 4             # encoder attention heads
    core_heads: int = 1            # denoiser-core attention heads
    num_blocks: int = 4
    use_pallas: bool = True        # TPU kernel switches of the JAX
    pallas_gn: bool = False        # package; kept so config echoes
    pallas_conv: bool = False      # round-trip. The port's encoder runs
    pallas_conv_min_width: int = 0  # plain PyTorch whatever they say.
    ensemble_pallas: bool = False
    ensemble_min_chains: int = 1024
    ensemble_mega: bool = True     # fused-core ensemble sampling
                                   # (models/mega.py, ops/core_block.py)
    ensemble_mega_accurate: bool = False  # no effect in the port yet
    attn_flash_min_logits: int = 0
    attn_slab: bool = False
    dtype: str = "float32"         # the port computes in float32 only
    uncond_prob: float = 0.0       # classifier-free guidance dropout
    parameterization: str = "eps"  # "eps" | "v"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    lr: float = 1e-4
    num_epochs: int = 500
    seed: int = 42
    split: Tuple[float, float] = (0.8, 0.1)
    split_seed: "int | None" = None
    deterministic_val: bool = False
    checkpoint_dir: str = "checkpoints"
    step_checkpoint_every: int = 0
    epochs_per_dispatch: int = 1
    ema_decay: float = 0.0
    flat_optimizer: bool = False
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    lr_end_fraction: float = 0.0
    loss_weighting: str = "none"
    snr_gamma: float = 5.0
    log_every: int = 1


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    uncertainty_samples: int = 50
    temperature: "float | tuple" = 1.0   # scalar, or one per parameter
    sampler: str = "ancestral"     # "ancestral" | "ddim" | "dpmpp" | "pd"
    ddim_steps: int = 50
    ddim_eta: float = 0.0
    dpmpp_steps: int = 15
    pd_steps: int = 4
    guidance_scale: float = 1.0
    guidance_interval: Tuple[float, float] = (0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    diffusion: DiffusionConfig = DiffusionConfig()
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    sample: SampleConfig = SampleConfig()
    mesh: MeshConfig = MeshConfig()
    name: str = "default"


# configs[2]: full conditional CondUNet at the native 4693 x 14 grid.
FULL_CONDITIONAL = ExperimentConfig(
    name="full_conditional",
    model=dataclasses.replace(ModelConfig(), name="condunet"),
)

# configs[3]: DDIM 50-step sampling, 1000-member posterior ensemble.
DDIM_ENSEMBLE = ExperimentConfig(
    name="ddim_ensemble",
    model=dataclasses.replace(ModelConfig(), name="condunet"),
    sample=SampleConfig(uncertainty_samples=1000, sampler="ddim",
                        ddim_steps=50),
)

PRESETS = {c.name: c for c in (FULL_CONDITIONAL, DDIM_ENSEMBLE)}
