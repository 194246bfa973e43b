"""The program under test, as a user drives it: the only module of the
benchmark that imports `ertdx_torch`.

`Program` writes the seed's weights as a checkpoint of the program's
format (in a temporary directory under TMPDIR) with the scalers fit to
the seed's training arrays, and opens it the way the entry point does.
`write_s` is the writing's time, which set-up leaves out: a deployment's
checkpoint is written already. Loading builds an optimizer as writing
does, so torch.optim's first construction, whose imports take seconds,
is made before the writing's clock starts and stays in set-up.

* "service": `PosteriorService(checkpoint, cfg, max_batch)`, whose
  `posterior(raw surveys, members, seed, draws={"x_T"})` scales, pads,
  samples, inverts and summarises a request;
* "dataset_sweep": `load_best_model`, the test set scaled once with the
  checkpoint's ert_scaler, as the CLI's `sample` scales it, then
  `posterior_over_dataset(..., batch_size, draws=[{"x_T"}])` a call.

`launches()` reads the port's own count of fused-core stack launches.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
from typing import Callable, Dict

import numpy as np
import torch

from ertdx_torch import configs as port_configs
from ertdx_torch.diffusion import schedule_from_config
from ertdx_torch.models import build_model
from ertdx_torch.ops import core_block
from ertdx_torch.sample import posterior_over_dataset
from ertdx_torch.serve import PosteriorService
from ertdx_torch.train import create_optimizer, load_best_model
from ertdx_torch.transforms import MinMaxScaler
from ertdx_torch.utils import checkpoint as port_checkpoint
from ertdx_torch.utils.weights import adam_state_to_jax, params_to_jax


def experiment(config: dict) -> port_configs.ExperimentConfig:
    """The program's configuration from a configuration file's
    "config" group (every field of the preset it names)."""
    return port_configs.experiment_from_dict(
        config, base=port_configs.PRESETS[config["name"]])


def launches() -> int:
    return core_block.launches["fused_core_stack"]


def _write_checkpoint(root: str, cfg, weights: Dict[str, torch.Tensor],
                      train_params: np.ndarray, train_raw: np.ndarray,
                      device) -> None:
    model = build_model(cfg.model, device)
    model.load_state_dict(weights, strict=True)
    tree = {"params": params_to_jax(model),
            "opt_state": adam_state_to_jax(create_optimizer(model, 1e-4),
                                           model, schedule=False),
            "step": np.asarray(0, np.int32)}
    meta = {"param_dim": cfg.model.param_dim, "model": cfg.model.name,
            "epoch": 0, "best_val_loss": 0.0,
            "config": dataclasses.asdict(cfg)}
    n = train_raw.shape[0]
    scalers = {"param_scaler": MinMaxScaler.fit(train_params),
               "ert_scaler": MinMaxScaler.fit(train_raw.reshape(n, -1))}
    port_checkpoint.save_checkpoint(f"{root}/best", tree, meta, scalers)
    del model


class Program:
    """One entry of the program, built over the seed's checkpoint;
    `call(i, raw, x_t)` runs one request or sweep call and returns what
    the entry returns; `close()` frees it and its checkpoint."""

    def __init__(self, entry: str, config: dict, traffic: dict,
                 weights: Dict[str, torch.Tensor], train_params: np.ndarray,
                 train_raw: np.ndarray, device):
        self.cfg = experiment(config["config"])
        self.members = traffic["members"]
        self.device = torch.device(device)
        self._root = tempfile.mkdtemp(prefix="portbench_ckpt_")
        torch.optim.Adam([torch.zeros(1, requires_grad=True)])
        t0 = time.perf_counter()
        _write_checkpoint(self._root, self.cfg, weights, train_params,
                          train_raw, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.write_s = time.perf_counter() - t0
        self.call: Callable = getattr(self, "_" + entry)
        if entry == "service":
            self._svc = PosteriorService(self._root, self.cfg,
                                         max_batch=traffic["max_batch"],
                                         device=str(self.device))
        else:
            state, _, scalers = load_best_model(self._root, self.cfg,
                                                device=self.device)
            self._model = state.model.eval()
            self._scalers = scalers
            self._schedule = schedule_from_config(self.cfg.diffusion)
            self._batch = traffic["batch_size"]

    def prepare(self, raw: np.ndarray) -> np.ndarray:
        """What the entry takes for the raw surveys: the service takes
        them raw; a sweep's test set is scaled once beforehand with the
        checkpoint's ert_scaler, as `prepare_dataset` scales it."""
        if not hasattr(self, "_scalers"):
            return raw
        n = raw.shape[0]
        flat = self._scalers["ert_scaler"].transform(raw.reshape(n, -1))
        return np.asarray(flat, np.float32).reshape(raw.shape)

    def _service(self, i: int, surveys, x_t) -> dict:
        return self._svc.posterior(surveys, n_realizations=self.members,
                                   seed=i, draws={"x_T": x_t})

    def _dataset_sweep(self, i: int, conditions, x_t) -> tuple:
        return posterior_over_dataset(
            self._model, conditions, self._schedule,
            self._scalers["param_scaler"], n_realizations=self.members,
            batch_size=self._batch, scfg=self.cfg.sample,
            draws=[{"x_T": x_t}], device=self.device)

    def close(self) -> None:
        for name in ("_svc", "_model", "_scalers"):
            if hasattr(self, name):
                delattr(self, name)
        shutil.rmtree(self._root, ignore_errors=True)
