"""Data layer in numpy: `.srv` survey files, simulation re-ingest,
dataset preparation, splits and batching.

Mirrors ertdx/data.py:45-416:
  * `.srv` parsing with a configurable layout (`SrvFormat`: header lines,
    data column, filename time token), files of one simulation sorted by
    survey time (a stable sort over the lexicographic order), the
    ragged-file and non-finite checks. As in JAX, the files go through
    the C++ reader (utils/srv_native.py, built with g++ at first use):
    one simulation's files, or a whole ensemble's, in one threaded batch
    call; a file that trips it is parsed with np.genfromtxt, which gives
    the same array. The arrays, the exception types and the messages are
    those of JAX's readers on the same path;
  * the re-ingest of simulation_{i:04d}/{data,parameters}.npy folders
    with the most-common-shape filter and its report, and the flat-vector
    -> (measurements, surveys) refold;
  * the reference prep pipeline (per-column MinMax over the flattened
    parameters and over the flattened ERT, the logit transform of the
    scaled parameters, feature-last (N, L, C) conditions), the seeded
    80/10/10 split, the seeded epoch shuffle and the zero-padded tail
    batch with its weight mask. The trainer moves the arrays to the
    device itself (ertdx_torch/train.py).
"""
from __future__ import annotations

import dataclasses
import os
from collections import Counter
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from .transforms import MinMaxScaler, transform_to_unconstrained
from .utils import srv_native


# --------------------------------------------------------------------------
# .srv survey files
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SrvFormat:
    """Configurable .srv layout: `skip_header` lines before the data,
    the data column `usecols`, and the index of the survey-time token in
    the '-'-split filename ('<prefix>-<x>-<days>d...'). With
    `require_finite` (the default) a non-finite parsed value raises with
    a skip_header hint: a header longer than skip_header parses as NaN
    rows."""

    skip_header: int = 259
    usecols: int = 5
    time_token_index: int = 2
    require_finite: bool = True


def _check_finite(arr: np.ndarray, where: str, fmt: "SrvFormat") -> None:
    if fmt.require_finite and not np.isfinite(arr).all():
        bad = int(np.size(arr) - np.isfinite(arr).sum())
        raise ValueError(
            f"{where}: {bad} non-finite values parsed — usually "
            f"skip_header={fmt.skip_header} is smaller than the file's "
            f"real header (text rows parse as NaN), or the data column "
            f"index usecols={fmt.usecols} is wrong. Adjust SrvFormat, or "
            f"set require_finite=False for corpora with genuine "
            f"non-finite measurements.")


def _srv_time(fname: str, fmt: SrvFormat) -> float:
    parts = fname.split("-")
    if len(parts) <= fmt.time_token_index:
        raise ValueError(
            f".srv filename {fname!r} has no '-'-separated time token at "
            f"index {fmt.time_token_index}; expected names like "
            f"'<prefix>-E1-<days>d.srv' (adjust SrvFormat.time_token_index)")
    token = parts[fmt.time_token_index].split("d")[0]
    try:
        return float(token)
    except ValueError as e:
        raise ValueError(
            f".srv filename {fname!r}: token {token!r} is not a survey "
            f"time in days") from e


def read_srv_file(path: str, fmt: SrvFormat = SrvFormat()) -> np.ndarray:
    """One .srv file's data column (float64): the C++ reader, or
    np.genfromtxt where the file trips it."""
    out = srv_native.read_srv_column(path, fmt.skip_header, fmt.usecols)
    if out is None:
        out = np.genfromtxt(path, skip_header=fmt.skip_header,
                            usecols=fmt.usecols)
        srv_native.count_read("numpy")
    _check_finite(out, str(path), fmt)
    return out


def _sorted_srv_paths(directory: str, prefix: str, fmt: SrvFormat) -> list:
    """'<prefix>*.srv' in `directory`, in lexicographic order, then
    stably sorted by survey time (equal times keep the name order)."""
    fnames = sorted(f for f in os.listdir(directory)
                    if f.startswith(prefix) and f.endswith(".srv"))
    if not fnames:
        raise FileNotFoundError(
            f"no '{prefix}*.srv' files in {directory!r}")
    times = [_srv_time(f, fmt) for f in fnames]
    order = np.argsort(times, kind="stable")
    return [os.path.join(directory, fnames[i]) for i in order]


def gather_srv_data(prefix: str, directory: str = ".",
                    fmt: SrvFormat = SrvFormat()) -> np.ndarray:
    """All '<prefix>*.srv' files of `directory` sorted by survey time,
    flattened (the reference's ERTDataHandler.gather_data with an
    explicit directory). The files are parsed in one batch call to the
    C++ reader; files of different lengths raise a ValueError (numpy's
    inhomogeneous-shape one where a file fell back to numpy)."""
    paths = _sorted_srv_paths(directory, prefix, fmt)
    res = srv_native.read_srv_batch(paths, fmt.skip_header, fmt.usecols,
                                    return_counts=True)
    if res is not None:
        batch, counts = res
        if len(set(counts.tolist())) > 1:
            # the fast path must not shift rows across surveys
            raise ValueError(
                f"ragged .srv files in {directory!r}: per-file rows "
                f"{sorted(set(counts.tolist()))}")
        _check_finite(batch, f"{prefix}*.srv in {directory!r}", fmt)
        return batch
    data = [read_srv_file(p, fmt) for p in paths]
    return np.array(data).flatten()


def gather_srv_ensemble(directories, prefix: str,
                        fmt: SrvFormat = SrvFormat()) -> np.ndarray:
    """Every simulation's survey files: (n_sims, files_per_sim * rows).

    Every simulation must have the same number of files, and every file
    the same number of rows (a truncated survey would shift rows across
    simulations); the most-common-shape filter runs downstream on .npy
    stores (`load_simulation_data`)."""
    dirs = [str(d) for d in directories]
    all_paths = []
    per_sim = None
    for d in dirs:
        paths = _sorted_srv_paths(d, prefix, fmt)
        if per_sim is None:
            per_sim = len(paths)
        elif len(paths) != per_sim:
            raise ValueError(
                f"{d!r} has {len(paths)} survey files, expected {per_sim}")
        all_paths.extend(paths)
    # one C++ batch call over every simulation's files
    res = srv_native.read_srv_batch(all_paths, fmt.skip_header,
                                    fmt.usecols, return_counts=True)
    if res is None:
        parts = [read_srv_file(p, fmt) for p in all_paths]
        counts = np.array([p.size for p in parts], dtype=np.int64)
        batch = np.concatenate(parts)
    else:
        batch, counts = res
    if len(set(counts.tolist())) > 1:
        bad = {all_paths[i]: int(c) for i, c in enumerate(counts)
               if c != counts[0]}
        raise ValueError(
            f"ragged ensemble: per-file row counts differ from "
            f"{int(counts[0])}: {dict(list(bad.items())[:4])}")
    _check_finite(batch, f"{prefix}*.srv ensemble ({len(dirs)} dirs)", fmt)
    return batch.reshape(len(dirs), -1)


class ERTDataHandler:
    """Compatibility shim mirroring the reference API."""

    def __init__(self, directory: str = ".", fmt: SrvFormat = SrvFormat()):
        self.directory = directory
        self.fmt = fmt

    def gather_data(self, prefix: str) -> np.ndarray:
        return gather_srv_data(prefix, self.directory, self.fmt)


# --------------------------------------------------------------------------
# Simulation-results re-ingest
# --------------------------------------------------------------------------

def load_simulation_data(base_folder, number_of_simulations: int,
                         verbose: bool = True
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Load simulation_{i:04d}/{data,parameters}.npy folders, keeping the
    runs whose shapes match the most common shape; report the valid,
    discarded and missing ones."""
    base_path = Path(base_folder)
    shapes_data, shapes_params, present = [], [], []
    missing = []
    for i in range(number_of_simulations):
        sim = base_path / f"simulation_{i:04d}"
        try:
            d = np.load(sim / "data.npy")
            p = np.load(sim / "parameters.npy")
        except FileNotFoundError:
            missing.append(i)
            continue
        shapes_data.append(d.shape)
        shapes_params.append(p.shape)
        present.append((i, d, p))

    if not present:
        raise FileNotFoundError(f"no simulations found under {base_folder}")

    common_d = Counter(shapes_data).most_common(1)[0][0]
    common_p = Counter(shapes_params).most_common(1)[0][0]

    all_data, all_params, discarded = [], [], []
    for i, d, p in present:
        if d.shape == common_d and p.shape == common_p:
            all_data.append(d)
            all_params.append(p)
        else:
            discarded.append((i, d.shape, p.shape))

    if verbose:
        print(f"Most common data shape: {common_d}")
        print(f"Most common parameter shape: {common_p}")
        print(f"Valid simulations: {len(all_data)}")
        print(f"Discarded simulations: {len(discarded)}")
        print(f"Missing folders: {len(missing)}")
        for i, ds, ps in discarded:
            print(f"simulation_{i:04d}: data{ds}, params{ps}")
        for i in missing:
            print(f"simulation_{i:04d}")
    return np.array(all_data), np.array(all_params)


def refold_ert_vector(flat: np.ndarray, n_surveys: int = 14) -> np.ndarray:
    """(S*M,) flat simulation output -> (M, S): surveys are contiguous
    blocks."""
    flat = np.asarray(flat).squeeze()
    m = flat.shape[-1] // n_surveys if flat.ndim == 1 else None
    if flat.ndim != 1:
        raise ValueError(f"expected flat vector, got shape {flat.shape}")
    return flat.reshape(n_surveys, m).T


# --------------------------------------------------------------------------
# Dataset prep + splits + feed
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ERTDataset:
    """Prepared diffusion dataset.

    params_u: (N, P) float32, logit-unconstrained scaled parameters (x0).
    conditions: (N, L, C) float32, min-max scaled ERT, feature-last.
    param_scaler / ert_scaler: the fitted MinMax state (saved with
    checkpoints).
    """

    params_u: np.ndarray
    conditions: np.ndarray
    param_scaler: MinMaxScaler
    ert_scaler: MinMaxScaler
    a: float = 0.0
    b: float = 1.0

    def __len__(self) -> int:
        return self.params_u.shape[0]

    @property
    def param_dim(self) -> int:
        return self.params_u.shape[1]

    @property
    def cond_shape(self) -> Tuple[int, int]:
        return self.conditions.shape[1:]


def prepare_dataset(sim_param: np.ndarray, ert_sim: np.ndarray,
                    a: float = 0.0, b: float = 1.0,
                    param_scaler: Optional[MinMaxScaler] = None,
                    ert_scaler: Optional[MinMaxScaler] = None) -> ERTDataset:
    """sim_param (N, P, 1) or (N, P) and ert_sim (N, L, C) -> ERTDataset.
    Scalers may be passed in (restored from a checkpoint) instead of
    refit."""
    sim_param = np.asarray(sim_param)
    ert_sim = np.asarray(ert_sim)
    if sim_param.ndim == 3 and sim_param.shape[2] == 1:
        raw = np.squeeze(sim_param, axis=2)
    else:
        raw = sim_param.copy()
    n = raw.shape[0]
    if ert_sim.shape[0] != n:
        raise ValueError(f"sim_param has {n} simulations but ert_sim has "
                         f"{ert_sim.shape[0]}")
    if param_scaler is None:
        param_scaler = MinMaxScaler.fit(raw.reshape(n, -1), (a, b))
    scaled = param_scaler.transform(raw.reshape(n, -1)).reshape(raw.shape)
    params_u = transform_to_unconstrained(scaled, a, b).astype(np.float32)
    if ert_scaler is None:
        ert_scaler = MinMaxScaler.fit(ert_sim.reshape(n, -1), (0.0, 1.0))
    cond = ert_scaler.transform(ert_sim.reshape(n, -1)).reshape(
        ert_sim.shape).astype(np.float32)
    return ERTDataset(params_u, cond, param_scaler, ert_scaler, a, b)


def split_dataset(n: int, seed: int = 42,
                  fractions: Tuple[float, float] = (0.8, 0.1)
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded train / val / test index split (numpy PCG64 permutation)."""
    train_size = int(fractions[0] * n)
    val_size = int(fractions[1] * n)
    perm = np.random.default_rng(seed).permutation(n)
    return (perm[:train_size], perm[train_size:train_size + val_size],
            perm[train_size + val_size:])


def batch_iterator(params_u: np.ndarray, conditions: np.ndarray,
                   batch_size: int, *, shuffle: bool, seed: int = 0,
                   epoch: int = 0, drop_remainder: bool = False,
                   mesh=None) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(x0, cond) numpy batches in a seeded per-epoch order. With `mesh`
    a batch whose rows divide the data axis yields this rank's rows
    (ertdx/data.py:363-400); another batch comes whole."""
    n = params_u.shape[0]
    order = np.arange(n)
    if shuffle:
        order = np.random.default_rng(
            np.random.SeedSequence([seed, epoch])).permutation(n)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for s in range(0, stop, batch_size):
        idx = order[s:s + batch_size]
        rows = None if mesh is None else mesh.rows(len(idx))
        if rows is not None:
            idx = idx[rows]
        yield params_u[idx], conditions[idx]


def pad_batch(x0: np.ndarray, cond: np.ndarray, batch_size: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Zero-pad a ragged tail batch to `batch_size`; returns the weight
    mask (1 for real rows, 0 for padding)."""
    b = x0.shape[0]
    if b == batch_size:
        return x0, cond, np.ones(batch_size, np.float32)
    pad = batch_size - b
    x0p = np.concatenate([x0, np.zeros((pad,) + x0.shape[1:], x0.dtype)])
    condp = np.concatenate(
        [cond, np.zeros((pad,) + cond.shape[1:], cond.dtype)])
    w = np.concatenate([np.ones(b, np.float32), np.zeros(pad, np.float32)])
    return x0p, condp, w
