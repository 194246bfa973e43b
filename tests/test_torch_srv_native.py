"""The port's C++ .srv reader (ertdx_torch/utils/srv_native.py on
ertdx_torch/csrc/srv_reader.cpp) against np.genfromtxt and against the
JAX package's reader.

tests/test_native.py's cases on the port's binding: genfromtxt parity,
scientific and negative values, comment lines, batch reads against
per-file reads, gather_srv_ensemble, and the four cases that fall back to
numpy (a missing file, a short row, a batch with a missing file, a line
over the parser's buffer). Then the port's reader against JAX's native
reader and JAX's gather_srv_* on the same files, the read counter, and
the build under build/ertdx_torch_srv/. JAX's library is built with `make
-C csrc` where it is missing, as tests/test_native.py builds it.
"""
from __future__ import annotations

import os
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest

from ertdx import data as jdata
from ertdx.utils import srv_native as jnative
from ertdx_torch import data as tdata
from ertdx_torch.utils import srv_native as native
from test_native import _write

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_native():
    """JAX's C++ reader. Where it is missing it is built as
    tests/test_native.py builds it (make -C csrc), into a file of its own
    that is then renamed into place, so that no process loads it half
    written; probed again a few times, since tests/test_native.py may be
    writing the library in place at the same moment."""
    lib = REPO / "ertdx" / "utils" / "_srv_reader.so"
    for _ in range(5):
        jnative._TRIED = False
        if jnative.available():
            return jnative
        tmp = lib.with_name(f".{os.getpid()}{lib.name}")
        r = subprocess.run(["make", "-C", str(REPO / "csrc"),
                            f"TARGET={tmp}"], capture_output=True,
                           text=True)
        assert r.returncode == 0, r.stdout + r.stderr
        os.replace(tmp, lib)
        time.sleep(0.5)
    jnative._TRIED = False
    assert jnative.available(), "make -C csrc did not build the reader"
    return jnative


def test_matches_genfromtxt(tmp_path):
    p = tmp_path / "a.srv"
    _write(p, header=259, rows=500)
    ours = native.read_srv_column(str(p), 259, 5)
    ref = np.genfromtxt(p, skip_header=259, usecols=5)
    assert ours.dtype == np.float64
    np.testing.assert_array_equal(ours, ref)


def test_scientific_and_negative(tmp_path):
    p = tmp_path / "b.srv"
    vals = _write(p, header=2, rows=50, scale=1e-11)
    ours = native.read_srv_column(str(p), 2, 5)
    np.testing.assert_allclose(ours, vals, rtol=1e-9)
    np.testing.assert_array_equal(
        ours, np.genfromtxt(p, skip_header=2, usecols=5))
    assert (ours < 0).any()


def test_comment_lines_match_genfromtxt(tmp_path):
    p = tmp_path / "c.srv"
    with open(p, "w") as f:
        f.write("# header\n# header\n")
        f.write("0.1 0.2 0.3 0.4 0.5 1.25 0.7\n")
        f.write("# 0 1 2 3 4 5 6\n")          # numeric-looking comment
        f.write("0.1 0.2 0.3 0.4 0.5 2.5 0.7\n")
    got = native.read_srv_column(str(p), 2, 5)
    ref = np.atleast_1d(np.genfromtxt(p, skip_header=2, usecols=5))
    np.testing.assert_array_equal(got, ref)
    assert list(got) == [1.25, 2.5]


def test_batch_reader_matches_per_file(tmp_path):
    paths = []
    for i, rows in enumerate((7, 31, 1, 64)):
        p = tmp_path / f"b{i}.srv"
        _write(p, header=2, rows=rows)
        paths.append(str(p))
    batch, counts = native.read_srv_batch(paths, 2, 5, return_counts=True)
    assert counts.tolist() == [7, 31, 1, 64]
    per_file = np.concatenate(
        [native.read_srv_column(p, 2, 5) for p in paths])
    np.testing.assert_array_equal(batch, per_file)
    np.testing.assert_array_equal(native.read_srv_batch(paths, 2, 5), batch)
    assert native.read_srv_batch([], 2, 5) is None


def test_gather_srv_ensemble(tmp_path, jax_native):
    """Shape, time order, parity with per-simulation gather_srv_data and
    with JAX's; ragged file counts and ragged row counts raise as JAX's."""
    fmt = tdata.SrvFormat(skip_header=2, usecols=5)
    jfmt = jdata.SrvFormat(skip_header=2, usecols=5)
    dirs = []
    for s in range(3):
        d = tmp_path / f"sim{s}"
        d.mkdir()
        for day in (30, 10, 20):       # out of order: sorted by time
            _write(d / f"job-E1-{day}d.srv", header=2, rows=11,
                   scale=1.0 + s)
        dirs.append(d)
    out = tdata.gather_srv_ensemble(dirs, "job", fmt)
    assert out.shape == (3, 33)
    np.testing.assert_array_equal(out, jdata.gather_srv_ensemble(
        dirs, "job", jfmt))
    for s, d in enumerate(dirs):
        np.testing.assert_array_equal(
            out[s], tdata.gather_srv_data("job", str(d), fmt))
    (dirs[1] / "job-E1-40d.srv").write_text("# h\n# h\n" + "1 " * 6 + "2\n")
    msgs = []
    for mod, f in ((tdata, fmt), (jdata, jfmt)):
        with pytest.raises(ValueError, match="survey files") as e:
            mod.gather_srv_ensemble(dirs, "job", f)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    (dirs[1] / "job-E1-40d.srv").unlink()
    _write(dirs[0] / "job-E1-10d.srv", header=2, rows=12)   # 12,11,11
    _write(dirs[1] / "job-E1-10d.srv", header=2, rows=10)   # 10,11,11
    msgs = []
    for mod, f in ((tdata, fmt), (jdata, jfmt)):
        with pytest.raises(ValueError, match="row counts") as e:
            mod.gather_srv_ensemble(dirs[:2], "job", f)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("case", ["missing_file", "short_rows",
                                  "batch_missing_file", "overlong_line"])
def test_falls_back_to_numpy_as_jax(tmp_path, case, jax_native):
    """The four fall-back cases: the native call returns None in both
    packages, and the reader entry points then give numpy's answer (the
    port counting a numpy read)."""
    fmt = tdata.SrvFormat(skip_header=2, usecols=5)
    if case == "missing_file":
        for mod in (native, jax_native):
            assert mod.read_srv_column("/nonexistent/x.srv", 0, 0) is None
        with pytest.raises(OSError):
            tdata.read_srv_file(str(tmp_path / "nope.srv"), fmt)
        return
    if case == "short_rows":
        p = tmp_path / "c.srv"
        p.write_text("h\nonly two cols\n1.0 2.0\n")
        for mod in (native, jax_native):
            assert mod.read_srv_column(str(p), 1, 5) is None
        return
    if case == "batch_missing_file":
        good = tmp_path / "g.srv"
        _write(good, header=1, rows=4)
        paths = [str(good), str(tmp_path / "missing.srv")]
        for mod in (native, jax_native):
            assert mod.read_srv_batch(paths, 1, 5) is None
        return
    p = tmp_path / "long-E1-10d.srv"
    with open(p, "w") as f:
        f.write("# h\n# h\n")
        f.write("0 1 2 3 4 5.5 " + "9 " * 40000 + "\n")   # ~80 KB line
        f.write("0 1 2 3 4 6.5 7\n")
    for mod in (native, jax_native):
        assert mod.read_srv_column(str(p), 2, 5) is None
    before = dict(native.reads)
    out = tdata.read_srv_file(str(p), fmt)
    assert native.reads["numpy"] == before["numpy"] + 1
    assert native.reads["native"] == before["native"]
    np.testing.assert_array_equal(out, [5.5, 6.5])
    np.testing.assert_array_equal(out, jdata.read_srv_file(
        str(p), jdata.SrvFormat(skip_header=2, usecols=5)))
    np.testing.assert_array_equal(
        tdata.gather_srv_data("long", str(tmp_path), fmt),
        jdata.gather_srv_data("long", str(tmp_path),
                              jdata.SrvFormat(skip_header=2, usecols=5)))


@pytest.mark.parametrize("header,rows,cols,col", [
    (259, 4693, 7, 5), (0, 17, 6, 0), (3, 1, 12, 11)])
def test_against_jax_native_reader(tmp_path, jax_native, header, rows,
                                   cols, col):
    """The port's reader against JAX's on the same files: single reads,
    batch reads, and gather_srv_data of a 14-survey simulation."""
    paths = []
    for k, day in enumerate(np.random.default_rng(rows).permutation(14)):
        p = tmp_path / f"run-E1-{(day + 1) * 7}d.srv"
        _write(p, header=header, rows=rows, cols=cols, col=col,
               scale=10.0 ** (k % 5 - 2))
        paths.append(str(p))
    for p in paths:
        np.testing.assert_array_equal(native.read_srv_column(p, header, col),
                                      jax_native.read_srv_column(p, header,
                                                                 col))
    got, counts = native.read_srv_batch(paths, header, col,
                                        return_counts=True)
    want, wcounts = jax_native.read_srv_batch(paths, header, col,
                                              return_counts=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(counts, wcounts)
    fmt = dict(skip_header=header, usecols=col)
    before = native.reads["native"]
    out = tdata.gather_srv_data("run", str(tmp_path), tdata.SrvFormat(**fmt))
    assert native.reads["native"] == before + 14
    np.testing.assert_array_equal(out, jdata.gather_srv_data(
        "run", str(tmp_path), jdata.SrvFormat(**fmt)))
    assert out.shape == (14 * rows,)


def test_build_lands_in_build_dir_and_is_reused(tmp_path):
    """The library is built from the port's own copy of the source into
    build/ertdx_torch_srv/<hash>/, and a second load reuses it."""
    lib = native.load()
    path = native.library_path()
    assert path.exists() and lib._name == str(path)
    assert path.parent.parent == REPO / "build" / "ertdx_torch_srv"
    assert native.SOURCE == REPO / "ertdx_torch" / "csrc" / "srv_reader.cpp"
    assert native.SOURCE.read_bytes().count(b"int64_t srv_read_batch(") == 1
    mtime = os.stat(path).st_mtime_ns
    saved = dict(native._loaded)
    native._loaded.clear()
    try:
        assert native.load()._name == str(path)
        assert os.stat(path).st_mtime_ns == mtime
    finally:
        native._loaded.clear()
        native._loaded.update(saved)
    # a failed build raises with the compiler's output
    bad = native.SOURCE.with_name("no_such_source.cpp")
    orig = native.SOURCE
    native.SOURCE = bad
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native._build(tmp_path / "x.so")
    finally:
        native.SOURCE = orig


def test_read_counter_under_threads(tmp_path):
    """The per-process read counter loses no update when more threads than
    cores read at once (the runner's pool reads from its threads)."""
    import sys
    from concurrent.futures import ThreadPoolExecutor
    paths = []
    for i in range(3):
        p = tmp_path / f"t{i}.srv"
        _write(p, header=1, rows=5)
        paths.append(str(p))
    n_threads, n_calls = 4 * (os.cpu_count() or 1), 20
    before = dict(native.reads)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(n_threads) as pool:
            futs = [pool.submit(native.read_srv_batch, paths, 1, 5)
                    for _ in range(n_threads * n_calls)]
            done = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(interval)
    assert all(d is not None and d.size == 15 for d in done)
    assert native.reads["native"] - before["native"] == \
        3 * n_threads * n_calls
    assert native.reads["numpy"] == before["numpy"]
