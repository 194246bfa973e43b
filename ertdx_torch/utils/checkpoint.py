"""Checkpoint directories in the JAX package's format.

As ertdx/utils/checkpoint.py:37-88 lays them out, a checkpoint is a
directory holding:

  state.msgpack  the train state as flax serializes it: {"params",
                 "opt_state", "step"} and, with EMA, "ema_params"; flax
                 layout, numpy leaves (utils/msgpack_lite.py)
  meta.json      epoch, best_val_loss, histories, the config echo
  scalers.npz    MinMax scaler arrays, keys "<scaler>.<field>"

The JAX package restores what this module writes and the other way round.
Every file is written to a temporary name beside it and renamed, so a
crash mid-save leaves the previous checkpoint whole. `commit_sample_config`
writes a calibrated sampling configuration into the config echo, as
ertdx/utils/checkpoint.py:91-127 does.
"""
from __future__ import annotations

import io
import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..transforms import MinMaxScaler
from . import msgpack_lite


def _atomic_write(path: Path, data: bytes) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def save_checkpoint(ckpt_dir, state: dict, meta: Dict[str, Any],
                    scalers: Optional[Dict[str, MinMaxScaler]] = None
                    ) -> None:
    """Write `state` (a flax-layout tree of numpy leaves), `meta` and the
    scalers' state into `ckpt_dir`."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    _atomic_write(ckpt_dir / "state.msgpack", msgpack_lite.packb(state))
    _atomic_write(ckpt_dir / "meta.json",
                  json.dumps(meta, indent=2,
                             default=_json_default).encode())
    sc_path = ckpt_dir / "scalers.npz"
    if scalers:
        arrays = {f"{name}.{key}": val for name, sc in scalers.items()
                  for key, val in sc.state_dict().items()}
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        _atomic_write(sc_path, buf.getvalue())
    elif sc_path.exists():
        sc_path.unlink()     # never pair a new state with stale scalers


def restore_checkpoint(ckpt_dir) -> Tuple[dict, Dict[str, Any],
                                          Dict[str, MinMaxScaler]]:
    """(state tree, meta, scalers) of a checkpoint directory."""
    ckpt_dir = Path(ckpt_dir)
    state = msgpack_lite.unpackb((ckpt_dir / "state.msgpack").read_bytes())
    meta_path = ckpt_dir / "meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return state, meta, load_scalers(ckpt_dir)


def load_scalers(ckpt_dir) -> Dict[str, MinMaxScaler]:
    """The scalers of a checkpoint directory, without reading its state."""
    scalers = {}
    sc_path = Path(ckpt_dir) / "scalers.npz"
    if sc_path.exists():
        with np.load(sc_path) as z:
            for name in sorted({k.split(".")[0] for k in z.files}):
                scalers[name] = MinMaxScaler.from_state_dict(
                    {k.split(".", 1)[1]: z[k] for k in z.files
                     if k.startswith(name + ".")})
    return scalers


def commit_sample_config(checkpoint_root, sample_fields: Dict[str, Any],
                         calibration: Optional[Dict[str, Any]] = None
                         ) -> list:
    """Write a calibrated sampling configuration into the config echo of
    every checkpoint under `checkpoint_root` ("best" and, if present,
    "last"): `sample_fields` update meta["config"]["sample"], and
    `calibration` (objective, grid, winning scores) lands under
    meta["calibration"] as the audit record. `sample`, `serve` and every
    `train.saved_config` reader then adopt the calibrated posterior with
    no sampling flags (explicit flags still win). Returns the rewritten
    meta.json paths."""
    root = Path(checkpoint_root)
    updated = []
    for name in ("best", "last"):
        p = root / name / "meta.json"
        if not p.exists():
            continue
        meta = json.loads(p.read_text())
        cfg = meta.setdefault("config", {})
        cfg.setdefault("sample", {}).update(sample_fields)
        if calibration is not None:
            meta["calibration"] = calibration
        _atomic_write(p, json.dumps(meta, indent=2,
                                    default=_json_default).encode())
        updated.append(p)
    if not updated:
        raise FileNotFoundError(
            f"no best/ or last/ meta.json under {root} — is this a "
            "checkpoint directory?")
    return updated
