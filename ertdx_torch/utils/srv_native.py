"""ctypes binding to the port's C++ .srv column reader
(ertdx_torch/csrc/srv_reader.cpp, a copy of csrc/srv_reader.cpp).

At first use g++ builds the source with csrc/Makefile's flags

    g++ -O3 -fPIC -Wall -Wextra -pthread -shared

(no -march=native: the library must run on any x86-64 host) into
`build/ertdx_torch_srv/<hash>/` at the root of the checkout, where <hash>
covers the source and the flags, so a changed source builds anew and a
library built from another source is never loaded. The library is
published with os.replace: processes that build at once each write their
own file and the last rename wins. A failed build raises with g++'s
output; nothing falls back to numpy because the compiler is missing.

What falls back, as in the JAX package's binding (ertdx/utils/
srv_native.py): a file that trips the parser (missing, a short row, a
line over the parser's 64 KiB buffer) makes `read_srv_column` and
`read_srv_batch` return None, and ertdx_torch/data.py then parses with
np.genfromtxt. `reads` counts, per process, the files read natively and
by numpy. The C ABI uses fixed-width int64_t on both sides.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "srv_reader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "ertdx_torch_srv"
CXX_FLAGS = ["-O3", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared"]
LIB_NAME = "libertdx_torch_srv.so"

#: files parsed by the C++ reader and by np.genfromtxt in this process
reads = {"native": 0, "numpy": 0}

_lock = threading.Lock()
_loaded: dict = {}


def count_read(kind: str, n: int = 1) -> None:
    with _lock:
        reads[kind] += n


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def _build(path: Path) -> None:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found on PATH: the .srv reader is "
                           "built with it at first use")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f".{LIB_NAME}.{os.getpid()}.{threading.get_ident()}")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def load() -> ctypes.CDLL:
    """The reader's library: built at first use, then cached on disk per
    source hash and in this process."""
    with _lock:
        if "lib" in _loaded:
            return _loaded["lib"]
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.srv_count_rows.restype = ctypes.c_int64
        lib.srv_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.srv_read_column.restype = ctypes.c_int64
        lib.srv_read_column.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
        lib.srv_count_batch.restype = ctypes.c_int64
        lib.srv_count_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.srv_read_batch.restype = ctypes.c_int64
        lib.srv_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64]
        _loaded["lib"] = lib
        return lib


def read_srv_column(path: str, skip_header: int,
                    usecols: int) -> Optional[np.ndarray]:
    """The parsed column, or None when the file trips the parser (the
    caller then parses with numpy)."""
    lib = load()
    p = str(path).encode()
    n = lib.srv_count_rows(p, skip_header)
    if n < 0:
        return None
    out = np.empty(n, dtype=np.float64)
    got = lib.srv_read_column(
        p, skip_header, usecols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
    if got < 0:
        return None
    count_read("native")
    return out[:got]


def read_srv_batch(paths, skip_header: int, usecols: int,
                   return_counts: bool = False):
    """Parse many files on the C++ thread pool: the flat concatenation of
    every file's column in file order, or (flat, per-file row counts)
    with return_counts=True. None when any file trips the parser (the
    caller then reads file by file)."""
    if not paths:
        return None
    lib = load()
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    counts = np.zeros(n, dtype=np.int64)
    counts_p = counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    if lib.srv_count_batch(arr, n, skip_header, counts_p, 0) != 0:
        return None
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    out = np.empty(int(counts.sum()), dtype=np.float64)
    rc = lib.srv_read_batch(
        arr, n, skip_header, usecols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts_p, 0)
    if rc != 0:
        return None
    count_read("native", n)
    return (out, counts) if return_counts else out
