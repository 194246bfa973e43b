"""Deployment surface: a posterior-inversion service over a checkpoint.

Mirrors ertdx/serve.py: `PosteriorService` loads the best checkpoint
once (its config echo wins over the caller's config, as in JAX) and
answers inversion requests: raw ERT (B, L, C) -> MinMax scale with the
checkpointed ert_scaler -> zero-pad to `max_batch` -> the posterior
ensemble on the card (`sample.posterior_ensemble`: the encoder once, then
a CondUNet's fused core, or another model's `denoise`, for every sampler
step) -> sigmoid and MinMax inverse and the bounds mask on the card
(`sample.device_inverse`) -> the pad rows sliced off on the host ->
summary statistics over the valid draws. That is the function JAX's
fused serving program computes. `PosteriorService.from_torch` serves the
reference's `.pth` weights instead (compat.py). `serve()` and
`make_server()` put it behind a stdlib ThreadingHTTPServer JSON API:
GET /healthz, POST /posterior.

A request's `seed` seeds a torch.Generator on the service's device. One
lock guards the device call: the generator and the kernels' launch
counters are not thread-safe. With `mesh` the service runs
`posterior_ensemble(mesh=)`, so `posterior` and `warmup` are
collectives: every rank of the mesh calls them with the same request,
and every rank returns the same answer. The HTTP server has no
follower loop (JAX's CLI `serve` has no mesh either).
"""
from __future__ import annotations

import json
import threading
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from . import data as data_lib
from .compat import load_reference_model
from .configs import ExperimentConfig, SampleConfig, experiment_from_dict
from .diffusion import schedule_from_config
from .parallel.mesh import mesh_device
from .params import ParameterSpace
from .sample import device_inverse, posterior_ensemble
from .train import load_best_model, saved_config


def masked_posterior_stats(phys: np.ndarray, mask: np.ndarray) -> dict:
    """Summary statistics over VALID draws only; conditions with no
    valid draw fall back to the statistics of all draws (their
    valid_fraction shows it). phys: (R, B, P); mask: (R, B)."""
    draws = np.where(mask[:, :, None], phys, np.nan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        stats = {"mean": np.nanmean(draws, axis=0),
                 "std": np.nanstd(draws, axis=0),
                 "p25": np.nanpercentile(draws, 25, axis=0),
                 "p50": np.nanpercentile(draws, 50, axis=0),
                 "p75": np.nanpercentile(draws, 75, axis=0)}
    none_valid = ~mask.any(axis=0)                 # (B,)
    if none_valid.any():
        raw = {"mean": phys.mean(axis=0), "std": phys.std(axis=0),
               "p25": np.percentile(phys, 25, axis=0),
               "p50": np.percentile(phys, 50, axis=0),
               "p75": np.percentile(phys, 75, axis=0)}
        for k, v in stats.items():
            v[none_valid] = raw[k][none_valid]
    return stats


class PosteriorService:
    """Loads a checkpoint once onto `device` (CUDA unless "cpu" is asked
    for) and answers posterior-inversion queries. Requests smaller than
    `max_batch` are zero-padded to it, so every call runs one shape."""

    def __init__(self, checkpoint_dir: str, cfg: ExperimentConfig,
                 max_batch: int = 8, mesh=None, device=None):
        dev = mesh_device(mesh, device)
        saved = saved_config(checkpoint_dir)
        if saved:
            cfg = experiment_from_dict(saved, base=cfg)
        state, meta, scalers = load_best_model(checkpoint_dir, cfg,
                                               device=dev)
        model = state.model
        if cfg.train.ema_decay > 0.0 and state.ema_params is not None:
            with torch.no_grad():
                for name, param in model.named_parameters():
                    param.copy_(state.ema_params[name])
        self._init_common(
            cfg, model, {k: meta[k] for k in ("epoch", "best_val_loss",
                                              "model") if k in meta},
            scalers["param_scaler"], scalers["ert_scaler"], max_batch,
            mesh)

    @classmethod
    def from_torch(cls, torch_checkpoint, cfg: ExperimentConfig,
                   sim_param: np.ndarray, ert_sim: np.ndarray,
                   max_batch: int = 8, mesh=None,
                   device=None) -> "PosteriorService":
        """Serve weights trained by the reference scripts (a `.pth` state
        dict, compat.py) on `device` (CUDA unless "cpu" is asked for).
        The scalers are refit from the training arrays, as the
        reference's own inference cells do
        (ERT_Conditional_Diffusion.py:233-261); cfg.model must be the
        reference architecture (refmlp)."""
        if cfg.model.name != "refmlp":
            raise ValueError("from_torch maps onto the reference "
                             "architecture: cfg.model.name must be "
                             "'refmlp'")
        dev = mesh_device(mesh, device)
        ds = data_lib.prepare_dataset(np.asarray(sim_param),
                                      np.asarray(ert_sim))
        model, _ = load_reference_model(torch_checkpoint, cfg.model, dev)
        self = cls.__new__(cls)
        self._init_common(cfg, model, {"model": "refmlp (torch import)"},
                          ds.param_scaler, ds.ert_scaler, max_batch, mesh)
        return self

    def _init_common(self, cfg, model, meta, param_scaler, ert_scaler,
                     max_batch, mesh=None) -> None:
        self.cfg = cfg
        self.mesh = mesh
        self.device = next(model.parameters()).device
        self.max_batch = int(max_batch)
        self.model = model.eval()
        self.meta = meta
        self.param_scaler = param_scaler
        self.ert_scaler = ert_scaler
        self.schedule = schedule_from_config(cfg.diffusion)
        self.space = ParameterSpace()
        self._lock = threading.Lock()

    def _scale_conditions(self, ert: np.ndarray) -> np.ndarray:
        n, length, ch = ert.shape
        flat = self.ert_scaler.transform(ert.reshape(n, -1))
        return np.asarray(flat, np.float32).reshape(n, length, ch)

    def posterior(self, ert: np.ndarray, n_realizations: int = 50,
                  scfg: Optional[SampleConfig] = None, seed: int = 0,
                  return_draws: bool = False,
                  draws: Optional[dict] = None) -> dict:
        """Raw ERT (B, L, C) -> physical posterior stats (+draws).
        `draws` ({"x_T": ..., "noise": ...} over max_batch conditions,
        in the chain order of `posterior_ensemble`'s path for the model)
        replaces the seeded generator's numbers."""
        ert = np.asarray(ert, np.float32)
        if ert.ndim != 3:
            raise ValueError(f"conditions must be (B, L, C), got {ert.shape}")
        b = ert.shape[0]
        if b > self.max_batch:
            raise ValueError(f"batch {b} exceeds max_batch {self.max_batch}")
        # the service's configured sampler is the default
        scfg = scfg if scfg is not None else self.cfg.sample
        cond = self._scale_conditions(ert)
        if b < self.max_batch:                      # one shape per call
            pad = np.zeros((self.max_batch - b,) + cond.shape[1:],
                           np.float32)
            cond = np.concatenate([cond, pad], axis=0)
        p = self.model.param_dim
        temperature = np.asarray(scfg.temperature, np.float32)
        if temperature.ndim not in (0, 1) or (
                temperature.ndim == 1 and temperature.shape[0] != p):
            raise ValueError(
                f"temperature must be a scalar or a length-{p} "
                f"(param_dim) vector, got {temperature.shape}")
        with self._lock:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            u = posterior_ensemble(
                self.model, torch.from_numpy(cond).to(self.device),
                self.schedule, n_realizations, scfg, generator=gen,
                device=self.device, mesh=self.mesh, **(draws or {}))
            phys, mask = device_inverse(u, self.param_scaler,
                                        self.space.plims, 0.0, 1.0)
            phys, mask = phys.cpu().numpy(), mask.cpu().numpy()
        phys, mask = phys[:, :b], mask[:, :b]
        stats = masked_posterior_stats(phys, mask)
        out = {
            **{k: v.tolist() for k, v in stats.items()},
            "valid_fraction": float(mask.mean()),
            "n_realizations": int(n_realizations),
            "param_names": list(self.space.names),
        }
        if return_draws:
            out["draws"] = phys.tolist()
            out["valid"] = mask.tolist()
        return out

    def warmup(self, n_realizations: int = 50,
               scfg: Optional[SampleConfig] = None) -> None:
        """One call before the first request (the kernels' first launch
        and the libraries' set-up)."""
        dummy = np.zeros((1, self.cfg.model.cond_length,
                          self.cfg.model.cond_channels), np.float32)
        self.posterior(dummy, n_realizations=n_realizations, scfg=scfg)


#: request keys that select a non-default sampler; ANY of them present
#: builds a SampleConfig
_SAMPLER_KEYS = ("sampler", "ddim_steps", "ddim_eta", "dpmpp_steps",
                 "pd_steps", "guidance_scale", "guidance_interval",
                 "temperature")


def _temperature_cast(v):
    """Scalar (global) or list (per-parameter vector) tempering."""
    if isinstance(v, (list, tuple)):
        return tuple(float(x) for x in v)
    return float(v)


_SAMPLER_CASTS = {"sampler": str, "ddim_steps": int, "ddim_eta": float,
                  "dpmpp_steps": int, "pd_steps": int,
                  "guidance_scale": float,
                  "guidance_interval":
                      lambda v: tuple(float(x) for x in v),
                  "temperature": _temperature_cast}


def scfg_from_request(req: dict) -> Optional[SampleConfig]:
    """SampleConfig from a /posterior JSON body; None = the service's
    default. Unspecified fields take the SampleConfig defaults."""
    given = {k: _SAMPLER_CASTS[k](req[k]) for k in _SAMPLER_KEYS
             if k in req}
    return SampleConfig(**given) if given else None


class _Handler(BaseHTTPRequestHandler):
    service: PosteriorService = None  # injected by make_server

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def do_GET(self):  # noqa: N802 — http.server API
        if self.path == "/healthz":
            self._reply(200, {"status": "ok", **self.service.meta})
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        if self.path != "/posterior":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n))
            ert = np.asarray(req["conditions"], np.float32)
            scfg = scfg_from_request(req)
            out = self.service.posterior(
                ert, n_realizations=int(req.get("n_realizations", 50)),
                scfg=scfg, seed=int(req.get("seed", 0)),
                return_draws=bool(req.get("return_draws", False)))
            self._reply(200, out)
        except (KeyError, ValueError, TypeError) as e:
            self._reply(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — keep the server alive
            self._reply(500, {"error": str(e)})


def make_server(service: PosteriorService, host: str = "127.0.0.1",
                port: int = 8337) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; callers own its thread."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def serve(service: PosteriorService, host: str = "127.0.0.1",
          port: int = 8337) -> None:
    """Blocking serve loop (Ctrl-C to stop)."""
    server = make_server(service, host, port)
    print(f"ertdx_torch posterior service on http://{host}:"
          f"{server.server_port} (model={service.meta.get('model')}, "
          f"best_val={service.meta.get('best_val_loss')}, "
          f"device={service.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
