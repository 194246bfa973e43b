"""ertdx_torch — the PyTorch/CUDA port of ertdx for NVIDIA Hopper.

A package of its own beside the JAX reference (`ertdx/`): it imports
`torch` and never `jax`, `flax`, `optax`, `msgpack` or `ertdx`. Module
names mirror `ertdx/`. It has the JAX package's three models: the
reference's RefCondMLP (configs[0], the default; `compat.py` loads the
reference's `.pth` weights into it), UncondMLP on the synthetic fields of
`synthetic.py` (configs[1]), and the flagship CondUNet (configs[2]-[4]).
The two MLPs train and sample on the generic path, realization-major, as
in JAX, with no kernel of their own (JAX runs them outside Pallas). The
CondUNet serves posterior ensembles with every sampler
of the JAX package (ancestral, DDIM, pd, DPM-Solver++), with and without
classifier-free guidance, on the fused-core kernels of
`csrc/core_onepass.cu` (JAX's one-pass mode and its bf16_3x
`accurate=True`) or, below their chain
threshold, on the per-block path with the one-pass ensemble-attention
kernels of `csrc/ensemble_attn.cu` (float32 or bf16 loads); and
it trains the CondUNet with the encoder's slab attention kernels of
`csrc/slab_attn.cu` and, in the fused-encoder arm (`pallas_gn`,
`pallas_conv_min_width`), the GroupNorm+SiLU and GN+SiLU+conv3 kernels of
`csrc/groupnorm.cu` and `csrc/gn_conv.cu`, or, in the flash arm
(`attn_flash_min_logits`), the flash attention kernels of
`csrc/flash_attn.cu`. A CondUNet computes in float32 or, with
`ModelConfig.dtype="bfloat16"` (the throughput preset's), in bfloat16 by
flax's rules, its slab attention then on the bf16 kernels of
`csrc/slab_attn_bf16.cu`. `distill.py` distills a trained model into a
few-step student for the pd sampler. On the host, `physics.py` runs
PFLOTRAN over parameter sets and reads each run's `.srv` files back with
the C++ reader of `csrc/srv_reader.cpp` (built by g++,
`utils/srv_native.py`), and `plots.py` draws the figures (matplotlib,
imported only when a figure is drawn).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card and without that argument they raise.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA by default, the CPU only
    when asked for. Never falls back to the CPU by itself."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ertdx_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev
