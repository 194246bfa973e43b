"""The port's .srv readers and simulation loader against the JAX package's.

Every case writes its files with copies of tests/test_data.py's writers
and runs both packages on them: the same array, or the same exception
type and message. Both packages parse with their C++ reader and fall
back to numpy (np.genfromtxt) file by file, so each case runs twice: the
port against JAX on their C++ readers (JAX's library is built with `make
-C csrc` where it is missing, as tests/test_native.py builds it), and
the port against JAX with both C++ readers switched off.
"""
from __future__ import annotations

import os
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest

from ertdx import data as jdata
from ertdx.utils import srv_native
from ertdx_torch import data as tdata
from ertdx_torch.utils import srv_native as tnative

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """JAX's C++ reader. Where it is missing it is built as
    tests/test_native.py builds it (make -C csrc), into a file of its own
    that is then renamed into place, so that no process loads it half
    written; probed again a few times, since tests/test_native.py may be
    writing the library in place at the same moment."""
    lib = REPO / "ertdx" / "utils" / "_srv_reader.so"
    for _ in range(5):
        srv_native._TRIED = False
        if srv_native.available():
            return srv_native
        tmp = lib.with_name(f".{os.getpid()}{lib.name}")
        r = subprocess.run(["make", "-C", str(REPO / "csrc"),
                            f"TARGET={tmp}"], capture_output=True,
                           text=True)
        assert r.returncode == 0, r.stdout + r.stderr
        os.replace(tmp, lib)
        time.sleep(0.5)
    srv_native._TRIED = False
    assert srv_native.available(), "make -C csrc did not build the reader"
    return srv_native


def _write_srv(path, n_rows, value, skip_header, n_cols=7):
    with open(path, "w") as f:
        for i in range(skip_header):
            f.write(f"header line {i}\n")
        for r in range(n_rows):
            cols = [f"{c + 1}.0" for c in range(n_cols)]
            cols[5] = f"{value + r:.6f}"
            f.write(" ".join(cols) + "\n")


def _write_srv_grid(path, values, skip_header, n_cols, usecols,
                    header_text="survey header"):
    with open(path, "w") as f:
        for i in range(skip_header):
            f.write(f"{header_text} {i}\n")
        for v in values:
            cols = [f"{c + 1}.0" for c in range(n_cols)]
            cols[usecols] = f"{v:.6f}"
            f.write(" ".join(cols) + "\n")


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — compared below
        return ("raised", type(e), str(e))


def _jax_numpy_path(monkeypatch):
    monkeypatch.setattr(srv_native, "read_srv_batch", lambda *a, **k: None)
    monkeypatch.setattr(srv_native, "read_srv_column", lambda *a, **k: None)


def _port_numpy_path(monkeypatch):
    monkeypatch.setattr(tnative, "read_srv_batch", lambda *a, **k: None)
    monkeypatch.setattr(tnative, "read_srv_column", lambda *a, **k: None)


def _agree(monkeypatch, name, *args, fmt_pair=None):
    """Run `name` in both packages, on their C++ readers and again on
    their numpy paths; assert the same array or exception (type and
    message) each time. Returns the port's outcome on its C++ reader."""
    jargs = args + ((fmt_pair[0],) if fmt_pair else ())
    targs = args + ((fmt_pair[1],) if fmt_pair else ())
    got = _outcome(getattr(tdata, name), *targs)
    want = _outcome(getattr(jdata, name), *jargs)
    with monkeypatch.context() as m:
        _jax_numpy_path(m)
        _port_numpy_path(m)
        got_np = _outcome(getattr(tdata, name), *targs)
        want_np = _outcome(getattr(jdata, name), *jargs)
    for g, w in ((got, want), (got_np, want_np)):
        assert g[0] == w[0], (g, w)
        if g[0] == "ok":
            np.testing.assert_array_equal(g[1], w[1])
        else:
            assert g[1:] == w[1:]
    if got[0] == "ok" and got_np[0] == "ok":
        np.testing.assert_array_equal(got[1], got_np[1])
    return got


def _fmts(**kw):
    return jdata.SrvFormat(**kw), tdata.SrvFormat(**kw)


@pytest.mark.parametrize("trial", range(12))
def test_fuzz_random_formats(tmp_path, monkeypatch, trial):
    """tests/test_data.py's fuzz, trial by trial: a matching SrvFormat
    recovers the written values in time order in both packages."""
    rng = np.random.default_rng(7)
    for t in range(trial + 1):           # the same draws as the original
        skip = int(rng.integers(0, 9))
        n_cols = int(rng.integers(6, 11))
        usecols = int(rng.integers(0, n_cols))
        n_files = int(rng.integers(1, 5))
        rows = int(rng.integers(1, 7))
        days = rng.choice(np.arange(1, 400), size=n_files,
                          replace=False).astype(float)
        if t % 2:
            days = days + 0.5
        vals = [rng.normal(size=rows) * 100 for _ in days]
    for day, v in zip(days, vals):
        _write_srv_grid(tmp_path / f"sim-E1-{day:g}d.srv", v, skip, n_cols,
                        usecols)
    truth = np.concatenate([v for _, v in sorted(zip(days, vals),
                                                 key=lambda p: p[0])])
    fmts = _fmts(skip_header=skip, usecols=usecols, time_token_index=2)
    got = _agree(monkeypatch, "gather_srv_data", "sim", str(tmp_path),
                 fmt_pair=fmts)
    np.testing.assert_allclose(got[1], truth, rtol=1e-6)
    # the same files as a one-simulation ensemble
    got = _agree(monkeypatch, "gather_srv_ensemble", [tmp_path], "sim",
                 fmt_pair=fmts)
    np.testing.assert_allclose(got[1][0], truth, rtol=1e-6)


def test_sorted_by_time_and_distractors(tmp_path, monkeypatch):
    _write_srv(tmp_path / "pref_0001-E1-30d.srv", 4, 300.0, 3)
    _write_srv(tmp_path / "pref_0001-E1-10d.srv", 4, 100.0, 3)
    _write_srv(tmp_path / "pref_0001-E1-20d.srv", 4, 200.0, 3)
    _write_srv(tmp_path / "other-E1-5d.srv", 4, 1.0, 3)
    (tmp_path / "pref_0001-E1-40d.txt").write_text("nope")
    fmts = _fmts(skip_header=3, usecols=5, time_token_index=2)
    got = _agree(monkeypatch, "gather_srv_data", "pref_0001", str(tmp_path),
                 fmt_pair=fmts)
    np.testing.assert_allclose(got[1][:4], [100, 101, 102, 103])
    handler = tdata.ERTDataHandler(str(tmp_path), fmts[1])
    np.testing.assert_array_equal(
        handler.gather_data("pref_0001"),
        jdata.ERTDataHandler(str(tmp_path), fmts[0]).gather_data(
            "pref_0001"))
    # one file, and equal time tokens keep their name order
    _agree(monkeypatch, "read_srv_file",
           str(tmp_path / "pref_0001-E1-10d.srv"), fmt_pair=fmts)
    _write_srv(tmp_path / "tie-a-10d.srv", 2, 1.0, 3)
    _write_srv(tmp_path / "tie-b-10d.srv", 2, 5.0, 3)
    got = _agree(monkeypatch, "gather_srv_data", "tie", str(tmp_path),
                 fmt_pair=fmts)
    np.testing.assert_allclose(got[1], [1, 2, 5, 6])


def test_missing_files(tmp_path, monkeypatch):
    got = _agree(monkeypatch, "gather_srv_data", "nothing", str(tmp_path))
    assert got[1] is FileNotFoundError
    got = _agree(monkeypatch, "gather_srv_ensemble", [tmp_path], "nothing")
    assert got[1] is FileNotFoundError


def test_header_undercount_raises_not_corrupts(tmp_path, monkeypatch):
    _write_srv_grid(tmp_path / "sim-E1-10d.srv", np.arange(4.0), 6, 7, 5,
                    header_text="hA hB hC hD hE hF")
    with monkeypatch.context() as m:
        _jax_numpy_path(m)
        for name, args in (("gather_srv_data", ("sim", str(tmp_path))),
                           ("gather_srv_ensemble", ([tmp_path], "sim"))):
            fj, ft = _fmts(skip_header=3, usecols=5)
            want = _outcome(getattr(jdata, name), *args, fj)
            got = _outcome(getattr(tdata, name), *args, ft)
            assert got == want and "skip_header" in got[2]
            fj, ft = _fmts(skip_header=3, usecols=5, require_finite=False)
            want = getattr(jdata, name)(*args, fj)
            got = getattr(tdata, name)(*args, ft)
            assert np.isnan(got).any()
            np.testing.assert_array_equal(got, want)


def test_header_overcount_is_ragged(tmp_path, monkeypatch):
    d1, d2 = tmp_path / "s1", tmp_path / "s2"
    d1.mkdir()
    d2.mkdir()
    _write_srv_grid(d1 / "sim-E1-10d.srv", np.arange(6.0), 4, 7, 5)
    _write_srv_grid(d2 / "sim-E1-10d.srv", np.arange(4.0), 4, 7, 5)
    got = _agree(monkeypatch, "gather_srv_ensemble", [d1, d2], "sim",
                 fmt_pair=_fmts(skip_header=4, usecols=5))
    assert got[1] is ValueError and "ragged" in got[2]


def test_ensemble_file_count_mismatch(tmp_path, monkeypatch):
    d1, d2 = tmp_path / "s1", tmp_path / "s2"
    d1.mkdir()
    d2.mkdir()
    for d, n in ((d1, 2), (d2, 1)):
        for k in range(n):
            _write_srv_grid(d / f"sim-E1-{k + 1}d.srv", np.arange(3.0), 2,
                            7, 5)
    got = _agree(monkeypatch, "gather_srv_ensemble", [d1, d2], "sim",
                 fmt_pair=_fmts(skip_header=2, usecols=5))
    assert got[1] is ValueError and "survey files" in got[2]


def test_missing_column_raises(tmp_path, monkeypatch):
    _write_srv_grid(tmp_path / "sim-E1-10d.srv", np.arange(4.0), 2, 4, 3)
    got = _agree(monkeypatch, "gather_srv_data", "sim", str(tmp_path),
                 fmt_pair=_fmts(skip_header=2, usecols=5))
    assert got[0] == "raised"


def test_extra_columns_ok(tmp_path, monkeypatch):
    _write_srv_grid(tmp_path / "sim-E1-10d.srv", np.array([7.0, 8.0, 9.0]),
                    2, 12, 5)
    got = _agree(monkeypatch, "gather_srv_data", "sim", str(tmp_path),
                 fmt_pair=_fmts(skip_header=2, usecols=5))
    np.testing.assert_allclose(got[1], [7.0, 8.0, 9.0])


def test_ragged_within_sim_raises(tmp_path, monkeypatch):
    _write_srv_grid(tmp_path / "sim-E1-10d.srv", np.arange(4.0), 2, 7, 5)
    _write_srv_grid(tmp_path / "sim-E1-20d.srv", np.arange(3.0), 2, 7, 5)
    for name, args in (("gather_srv_data", ("sim", str(tmp_path))),
                       ("gather_srv_ensemble", ([tmp_path], "sim"))):
        got = _agree(monkeypatch, name, *args,
                     fmt_pair=_fmts(skip_header=2, usecols=5))
        assert got[1] is ValueError


def test_filename_token_variants(tmp_path, monkeypatch):
    _write_srv_grid(tmp_path / "sim-9d.srv", [9.0], 1, 7, 5)
    _write_srv_grid(tmp_path / "sim-10d.srv", [10.0], 1, 7, 5)
    _write_srv_grid(tmp_path / "sim-100d_final.srv", [100.0], 1, 7, 5)
    got = _agree(monkeypatch, "gather_srv_data", "sim", str(tmp_path),
                 fmt_pair=_fmts(skip_header=1, usecols=5,
                                time_token_index=1))
    np.testing.assert_allclose(got[1], [9.0, 10.0, 100.0])


@pytest.mark.parametrize("fname,index", [("simnodash.srv", 2),
                                         ("sim-E1-xd.srv", 2)])
def test_bad_time_token_clear_error(tmp_path, monkeypatch, fname, index):
    _write_srv_grid(tmp_path / fname, [1.0], 1, 7, 5)
    got = _agree(monkeypatch, "gather_srv_data", fname.split("-")[0][:3],
                 str(tmp_path), fmt_pair=_fmts(skip_header=1, usecols=5,
                                               time_token_index=index))
    assert got[1] is ValueError and "time" in got[2]


def test_ensemble_at_survey_size(tmp_path, monkeypatch):
    """Three simulations of 14 surveys x 30 rows each, with a 259-line
    header and the time tokens written out of order."""
    rng = np.random.default_rng(3)
    dirs, want = [], []
    for s in range(3):
        d = tmp_path / f"simulation_{s:04d}"
        d.mkdir()
        days = rng.permutation(np.arange(1, 15) * 7)
        vals = {day: rng.normal(100.0, 30.0, 30) for day in days}
        for day in days:
            _write_srv_grid(d / f"run{s}-E1-{day}d.srv", vals[day], 259, 7,
                            5)
        dirs.append(d)
        want.append(np.concatenate([vals[day] for day in sorted(days)]))
    got = _agree(monkeypatch, "gather_srv_ensemble", dirs, "run",
                 fmt_pair=_fmts())
    # the files carry 6 decimals
    np.testing.assert_allclose(got[1], np.stack(want), rtol=0, atol=5e-7)


def test_load_simulation_data_and_report(tmp_path, capsys):
    good = np.ones((4, 3))
    for i in [0, 1, 3, 5]:
        d = tmp_path / f"simulation_{i:04d}"
        d.mkdir()
        np.save(d / "data.npy", good * i)
        np.save(d / "parameters.npy", np.full(29, i))
    d = tmp_path / "simulation_0002"
    d.mkdir()
    np.save(d / "data.npy", np.ones((2, 2)))
    np.save(d / "parameters.npy", np.full(29, 2))
    want = jdata.load_simulation_data(tmp_path, 7)
    want_out = capsys.readouterr().out
    got = tdata.load_simulation_data(tmp_path, 7)
    assert capsys.readouterr().out == want_out
    assert "Missing folders: 2" in want_out
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert _outcome(tdata.load_simulation_data, tmp_path / "none", 2) == \
        _outcome(jdata.load_simulation_data, tmp_path / "none", 2)


@pytest.mark.parametrize("shape", [(42,), (1, 42), (42, 1), (6, 7)])
def test_refold_ert_vector(shape):
    flat = np.arange(np.prod(shape), dtype=float).reshape(shape)
    got = _outcome(tdata.refold_ert_vector, flat, 3)
    want = _outcome(jdata.refold_ert_vector, flat, 3)
    assert got[0] == want[0]
    if got[0] == "ok":
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert got[1:] == want[1:]
