"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use, `load()` compiles each `ertdx_torch/csrc/*.cu` to an object
file, one nvcc process per source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
         -Xcompiler -fPIC -Xptxas -v

then links the objects into one shared library with a plain C interface
(`nvcc -shared`), in `build/ertdx_torch_kernels/<hash>/` at the root of
the checkout,
where <hash> covers the sources and the flags: an unchanged tree loads
the library it already built, a changed one builds anew. No source
includes PyTorch's headers, and neither ninja nor
`torch.utils.cpp_extension` is used. A failed build raises with nvcc's
output; nothing falls back to the plain versions. `check_cuda` and
`raise_on` are the argument and launch-error checks the kernel wrappers
share; `route` is the rule of the one-pass dispatchers, and
`warn_onepass_plain` the warning of the shape gates that send JAX's
one-pass function to its plain version on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import warnings
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "ertdx_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]
LIB_NAME = "libertdx_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_F = ctypes.c_float
# C signatures of csrc/*.cu (pointers and the stream as void*)
SIGNATURES = {
    "ertdx_gn_silu_fwd": [_P] * 4 + [_I] * 4 + [_F] + [_I] * 3 + [_P],
    "ertdx_gn_silu_bwd": [_P] * 7 + [_I] * 4 + [_F] + [_I] * 3 + [_P],
    "ertdx_gn_conv3_fwd": [_P] * 7 + [_I] * 5 + [_F] + [_I] * 3 + [_P],
    "ertdx_gn_conv3_bwd": [_P] * 14 + [_I] * 7 + [_F] + [_I] * 6 + [_P],
    "ertdx_gn_silu_fwd_bf16": [_P] * 4 + [_I] * 4 + [_F] + [_I] * 3 + [_P],
    "ertdx_gn_silu_bwd_bf16": [_P] * 7 + [_I] * 4 + [_F] + [_I] * 3 + [_P],
    "ertdx_gn_conv3_fwd_bf16": [_P] * 7 + [_I] * 5 + [_F] + [_I] * 3 + [_P],
    "ertdx_gn_conv3_bwd_bf16":
        [_P] * 12 + [_I] * 6 + [_F] + [_I] * 6 + [_P],
    "ertdx_core_stack_onepass": [_P] * 17 + [_I] * 7 + [_P],
    "ertdx_core_stack_bf16x3": [_P] * 17 + [_I] * 7 + [_P],
    "ertdx_core_block_onepass": [_P] * 10 + [_I] * 6 + [_P],
    "ertdx_core_block_bf16x3": [_P] * 10 + [_I] * 6 + [_P],
    "ertdx_core_onepass_occupancy": [_P],
    "ertdx_core_bf16x3_occupancy": [_P],
    "ertdx_slab_fwd": [_P] * 2 + [_I] * 4 + [_P],
    "ertdx_slab_bwd": [_P] * 5 + [_I] * 4 + [_P],
    "ertdx_slab_blocks_per_sm": [_I, _I, _P],
    "ertdx_slab_fwd_bf16": [_P] * 2 + [_I] * 5 + [_P],
    "ertdx_slab_bwd_bf16": [_P] * 3 + [_I] * 5 + [_P],
    "ertdx_slab_fwd_onepass": [_P] * 2 + [_I] * 5 + [_P],
    "ertdx_slab_bwd_onepass": [_P] * 3 + [_I] * 5 + [_P],
    "ertdx_block_self_attn": [_P] * 4 + [_L] * 3 + [_I] * 3 + [_P],
    "ertdx_block_self_attn_bf16": [_P] * 4 + [_L] * 3 + [_I] * 3 + [_P],
    "ertdx_folded_cross_attn": [_P] * 4 + [_L] * 3 + [_I] * 4 + [_P],
    "ertdx_folded_cross_attn_bf16": [_P] * 4 + [_L] * 3 + [_I] * 4 + [_P],
    "ertdx_flash_fwd": [_P] * 6 + [_I] * 5 + [_F, _P],
    "ertdx_flash_bwd_dq": [_P] * 9 + [_I] * 5 + [_F, _P],
    "ertdx_flash_bwd_dkv": [_P] * 9 + [_I] * 5 + [_F, _P],
    "ertdx_flash_skip_tiles": [_I, _P],
}


class Kernels:
    """The loaded library, with what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, report: str,
                 build_seconds: float):
        self.lib = lib
        self.path = path
        self.report = report              # nvcc -Xptxas -v output
        self.build_seconds = build_seconds  # 0.0 when loaded as built


_loaded: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's kernels are built with nvcc at first use")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> tuple:
    """Run the commands concurrently; raise with the output of any that
    fails. Returns their joined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return "\n".join(out.strip() for out in outs if out.strip())


def _build(out_dir: Path) -> tuple:
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [out_dir / f".{src.stem}.{tag}.o" for src in sources]
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    try:
        report = _run_all([[nvcc, *NVCC_FLAGS, "-o", str(obj), str(src)]
                           for src, obj in zip(sources, objs)])
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    (out_dir / "ptxas.txt").write_text(report)
    os.replace(tmp, out_dir / LIB_NAME)
    return report, seconds


def load() -> Kernels:
    """The kernels' library: built at first use, then cached on disk per
    source hash. Within a process the first library loaded is returned
    without hashing the sources again: every kernel launch calls this."""
    if _loaded:
        return _loaded["lib"]
    key = source_hash()
    out_dir = BUILD_ROOT / key
    path = out_dir / LIB_NAME
    if path.exists():
        report = (out_dir / "ptxas.txt").read_text() \
            if (out_dir / "ptxas.txt").exists() else ""
        seconds = 0.0
    else:
        report, seconds = _build(out_dir)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _loaded["lib"] = Kernels(lib, path, report, seconds)
    return _loaded["lib"]


def check_cuda(name: str, t: torch.Tensor, shape,
               dtype: torch.dtype = torch.float32) -> None:
    """What the kernels take: a contiguous CUDA tensor of the expected
    shape and dtype (float32 unless the kernel says otherwise); raises
    otherwise."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{t.device}")
    if t.dtype != dtype:
        want, got = (str(d).replace("torch.", "") for d in (dtype, t.dtype))
        raise TypeError(f"{name}: the kernel takes {want}, got {got}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, the kernel "
                         f"expects {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def check_aligned16(**tensors: torch.Tensor) -> None:
    """What kernels that stage with 16-byte cp.async take: data that
    starts on a 16-byte boundary; raises otherwise."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes 16-byte aligned "
                             "data (contiguous16 makes a copy that is)")


def contiguous16(t: torch.Tensor) -> torch.Tensor:
    """t as a contiguous tensor whose data starts on a 16-byte boundary:
    t itself where it is one, else a copy (a contiguous view may start at
    any float of its storage)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def raise_on(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def route(device, accurate: bool, jax_takes: bool, port_takes: bool) -> str:
    """The one-pass dispatchers' route: "kernel", "onepass_plain" or
    "float32". A CPU tensor gets the float32 plain version, as JAX's path
    off its TPU. With `accurate` (the float32 function) the CUDA kernel
    runs where the port's gate takes the shape (`port_takes`), else the
    float32 plain version. Otherwise JAX's gate as on its TPU
    (`jax_takes`) chooses the function: where it takes its kernel, the
    one-pass function, on the CUDA kernel where the port's gate takes the
    shape and on the plain one-pass version on the card where it does not;
    where it refuses, the float32 plain version, as JAX's XLA reference."""
    if torch.device(device).type != "cuda":
        return "float32"
    if not accurate and not jax_takes:
        return "float32"
    if port_takes:
        return "kernel"
    return "float32" if accurate else "onepass_plain"


_onepass_plain_warned: set = set()


def warn_onepass_plain(op: str, shape: tuple,
                       function: str = "one-pass") -> None:
    """Warn, once per (op, shape, function), that a CUDA call runs the
    plain version of JAX's `function` ("one-pass", or the fused core's
    "bf16_3x"): JAX's gate takes its kernel there, so the port computes
    that kernel's function, but the port's kernel does not take the
    shape. A shape gate, not a fallback on failure: a kernel that fails to
    build or launch still raises."""
    key = (op, tuple(shape), function)
    if key in _onepass_plain_warned:
        return
    _onepass_plain_warned.add(key)
    warnings.warn(f"{op}: {tuple(shape)} is a shape JAX's kernel takes and "
                  f"the CUDA kernel does not; running the plain {function} "
                  f"version on the card (20-25x slower than a kernel)",
                  stacklevel=3)
