"""Config dataclasses and presets, field for field as in ertdx/configs.py.

The field names and defaults match the JAX package so that a checkpoint's
`meta.json` config echo means the same thing to both packages
(ertdx/configs.py:13-200). Only the presets the port runs are here:
FULL_CONDITIONAL (configs[2]), DDIM_ENSEMBLE (configs[3]) and V5E8_DP
(configs[4], the throughput training preset, which computes in bfloat16
with float32 parameters; the port builds it in its own dtype and trains
it on one device: give it MeshConfig()).
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
    use_pallas: bool = True        # False: the encoder's slab and flash
                                   # attention run their plain versions
    pallas_gn: bool = False        # encoder GN+SiLU on ops/groupnorm.py
    pallas_conv: bool = False      # fuse GN+SiLU+conv3 in every ResBlock
    pallas_conv_min_width: int = 0  # ... or in those this wide and wider
                                   # (ops/conv.py; either changes the
                                   # parameter tree, as in JAX)
    ensemble_pallas: bool = False
    ensemble_min_chains: int = 1024
    ensemble_mega: bool = True     # fused-core ensemble sampling
                                   # (models/mega.py, ops/core_block.py)
    ensemble_mega_accurate: bool = False  # no effect in the port yet
    attn_flash_min_logits: int = 0  # encoder flash attention (ops/
                                    # attention.py) once b h lp^2 reaches
                                    # it; 0 = only at lp >= 1024
    attn_slab: bool = False        # encoder slab attention (ops/slab_attn.py)
    dtype: str = "float32"         # compute dtype, "float32" or
                                   # "bfloat16"; parameters, optimizer
                                   # state and loss stay float32
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

# configs[4]: data-parallel b256 training with the encoder's slab
# attention (ertdx/configs.py:312-320). The port builds it in bfloat16,
# its own compute dtype (params stay float32), with the slab attention's
# bf16 kernels; the 8-way mesh is the JAX preset's and the port runs one
# device, so it trains this preset with MeshConfig().
V5E8_DP = ExperimentConfig(
    name="v5e8_dp",
    model=dataclasses.replace(ModelConfig(), name="condunet",
                              dtype="bfloat16", attn_slab=True),
    train=dataclasses.replace(TrainConfig(), batch_size=256),
    sample=SampleConfig(uncertainty_samples=1000, sampler="ddim",
                        ddim_steps=50),
    mesh=MeshConfig(data=8, model=1),
)

PRESETS = {c.name: c for c in (FULL_CONDITIONAL, DDIM_ENSEMBLE, V5E8_DP)}


def split_seed_of(tcfg: TrainConfig) -> int:
    """The seed of the train/val/test split: split_seed when set, else
    the training seed (ertdx/configs.py:210-215)."""
    return tcfg.seed if tcfg.split_seed is None else int(tcfg.split_seed)


def _fields_from_dict(dc, d):
    """A frozen config from a (possibly partial) dict over `dc`. JSON
    turns tuples into lists; no field is list-typed, so lists become
    tuples again."""
    vals = {f.name: (tuple(d[f.name]) if isinstance(d[f.name], list)
                     else d[f.name])
            for f in dataclasses.fields(dc) if f.name in d}
    return dataclasses.replace(dc, **vals) if vals else dc


def experiment_from_dict(d: dict, base: "ExperimentConfig | None" = None
                         ) -> ExperimentConfig:
    """ExperimentConfig from a (possibly partial) nested dict over `base`:
    the inverse of dataclasses.asdict for a checkpoint's config echo
    (ertdx/configs.py:239-258)."""
    base = base or ExperimentConfig()
    return dataclasses.replace(
        base,
        diffusion=_fields_from_dict(base.diffusion, d.get("diffusion", {})),
        model=_fields_from_dict(base.model, d.get("model", {})),
        train=_fields_from_dict(base.train, d.get("train", {})),
        sample=_fields_from_dict(base.sample, d.get("sample", {})),
        mesh=_fields_from_dict(base.mesh, d.get("mesh", {})),
        name=d.get("name", base.name),
    )
