"""The port's float32 precision, pinned for the length of an entry point.

PyTorch runs a float32 matrix product in full float32 by default, but a
float32 convolution through cuDNN in TF32 (`torch.backends.cudnn.
allow_tf32` is True), which keeps about three decimal digits. The port's
float32 models are meant to compute float32-class, as the JAX package's
Precision.HIGHEST and the port's 3xTF32 kernels do, and every float32
number in PERF.md is taken in that mode. `fp32_precision` sets both TF32
flags to False for the call and gives the caller's values back afterwards,
after an exception too. `train`, `posterior_ensemble`,
`posterior_over_dataset`, `posterior_over_dataset_mixture` and `distill`
run under it.

It adds no knob: a float32 model gets the float32-class mode, and a
bfloat16 model (ModelConfig.dtype) computes in bfloat16, which the flags
do not touch.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_precision():
    """Context manager (and decorator): cuBLAS and cuDNN without TF32
    inside, the caller's flags restored on the way out."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
