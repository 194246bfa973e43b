"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use, `load()` compiles every `ertdx_torch/csrc/*.cu` into one
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into `build/ertdx_torch_kernels/<hash>/` at the root of the checkout,
where <hash> covers the sources and the flags: an unchanged tree loads
the library it already built, a changed one builds anew. No source
includes PyTorch's headers, and neither ninja nor
`torch.utils.cpp_extension` is used. A failed build raises with nvcc's
output; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "ertdx_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libertdx_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/core_block.cu (pointers and the stream as void*)
SIGNATURES = {
    "ertdx_core_stack": [_P] * 22 + [_I] * 5 + [_P],
    "ertdx_core_block": [_P] * 15 + [_I] * 4 + [_P],
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


def _build(out_dir: Path) -> tuple:
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    report = (proc.stdout + proc.stderr).strip()
    (out_dir / "ptxas.txt").write_text(report)
    os.replace(tmp, out_dir / LIB_NAME)
    return report, seconds


def load() -> Kernels:
    """The kernels' library: built at first use, then cached per source
    hash (in this process and on disk)."""
    key = source_hash()
    if key in _loaded:
        return _loaded[key]
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
    _loaded[key] = Kernels(lib, path, report, seconds)
    return _loaded[key]
