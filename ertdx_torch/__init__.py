"""ertdx_torch — the PyTorch/CUDA port of ertdx for NVIDIA Hopper.

A package of its own beside the JAX reference (`ertdx/`): it imports
`torch` and never `jax`, `flax`, `optax`, `msgpack` or `ertdx`. Module
names mirror `ertdx/`. This slice serves the configs[3] posterior
ensemble (CondUNet, DDIM-50, 1000 members per condition) through the
two hand-written fused-core CUDA kernels in `csrc/core_block.cu`.

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
