"""Training: the train and eval steps, the epoch loop, best-val checkpoints.

Mirrors ertdx/train.py on its single-device, device-resident path
(:515-517, :663-741): the dataset is moved to the device once; each epoch
shuffles the train split with numpy PCG64 seeded by (seed, 7, epoch), as
the JAX package does, and wraps the ragged tail to the head of the
permutation (`_epoch_batches`, :452-458); the validation split runs in
fixed batches whose padded rows carry weight 0. After every epoch the
validation loss decides the best-val checkpoint, written in the JAX
package's format with the config echo and the scalers (:823-844).

One train step (`train_step`, the body of ertdx/train.py:144-191): draw
t ~ U{0..T-1} and eps ~ N(0, I) (or take them from the caller), noise x0
with `q_sample`, regress the model output on the eps or v target with the
MSE (weighted by `w` over padded rows, min-SNR weighted when asked for),
one Adam update (lr 1e-4, betas (0.9, 0.999), eps 1e-8: the update of
optax.adam) and, with ema_decay > 0, the EMA of the parameters. A model
with uncond_prob > 0 trains for classifier-free guidance: each example's
encoded condition is replaced by the learned null context with
probability uncond_prob (ertdx/train.py:120-141; evaluation drops
nothing). The encoder's slab attention, GN+SiLU and fused GN+SiLU+conv
run on their CUDA kernels when the model asks for them and lies on the
card.

A bfloat16 model (ModelConfig.dtype, V5E8_DP's) trains as the JAX
package trains it: the model computes in bfloat16 while its parameters,
the Adam moments, the EMA and the loss stay float32, and checkpoints
echo the dtype. `train` runs under `precision.fp32_precision` (no TF32
in cuBLAS or cuDNN), so a float32 model computes float32-class.

Random draws come from torch.Generators seeded from the config's seed,
not from JAX's threefry keys: the same seed gives other numbers than the
JAX package. Tests hand both packages the same t, eps and drop mask.
Every draw of an epoch comes from a generator seeded by (seed, epoch), so
`train(..., resume=True)` from the `last` checkpoint continues the run
that went straight through. `flat_optimizer` changes only how the Adam
moments are saved (one flat vector each, as optax.flatten keeps them).
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np
import torch

from . import configs as configs_lib
from . import data as data_lib
from .configs import ExperimentConfig
from .diffusion import (min_snr_weight, prediction_target, q_sample,
                        schedule_from_config)
from .models import build_model
from .parallel.mesh import (all_reduce_, barrier, data_all_reduce_grads,
                            is_writer, mesh_device, sharded_rows)
from .precision import fp32_precision
from .utils import checkpoint as ckpt_lib
from .utils.weights import (adam_state_from_jax, adam_state_to_jax,
                            named_from_jax, named_to_jax, params_from_jax,
                            params_to_jax)

LR = Union[float, Callable[[int], float]]


# ---------------------------------------------------------------------------
# learning rate and optimizer
# ---------------------------------------------------------------------------

def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule; constant `init` when steps <= 0."""
    if steps <= 0:
        return lambda count: init

    def fn(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return fn


def _cosine(init: float, decay_steps: int, alpha: float
            ) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with exponent 1."""
    def fn(count):
        count = min(count, decay_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init * ((1.0 - alpha) * decay + alpha)
    return fn


def _join(first, second, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules of two schedules at one boundary."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def make_lr(tcfg, total_steps: int) -> LR:
    """The learning rate of ertdx/train.py:85-107: a float for a constant
    lr without warmup, else a schedule count -> lr (linear warmup then
    constant, or optax's warmup_cosine_decay_schedule over total_steps)."""
    if tcfg.lr_schedule not in ("constant", "cosine"):
        raise ValueError(f"unknown lr_schedule {tcfg.lr_schedule!r}")
    if tcfg.lr_schedule == "constant":
        if tcfg.warmup_steps <= 0:
            return tcfg.lr
        return _join(_linear(0.0, tcfg.lr, tcfg.warmup_steps),
                     lambda count: tcfg.lr, tcfg.warmup_steps)
    warmup = max(tcfg.warmup_steps, 0)
    decay_steps = max(total_steps, warmup + 1)
    alpha = 0.0 if tcfg.lr == 0.0 else tcfg.lr_end_fraction
    return _join(_linear(0.0, tcfg.lr, warmup),
                 _cosine(tcfg.lr, decay_steps - warmup, alpha), warmup)


def lr_at(lr: LR, count: int) -> float:
    """The learning rate of the update that follows `count` updates."""
    return float(lr(count)) if callable(lr) else float(lr)


def create_optimizer(model: torch.nn.Module, lr: LR) -> torch.optim.Adam:
    """Adam with optax.adam's defaults; a schedule is applied per step by
    `train_step`."""
    return torch.optim.Adam(model.parameters(), lr=lr_at(lr, 0),
                            betas=(0.9, 0.999), eps=1e-8)


def optimizer_steps(opt: torch.optim.Optimizer) -> int:
    """Updates the optimizer has taken (optax's adam count)."""
    for st in opt.state.values():
        if "step" in st:
            return int(st["step"])
    return 0


def ema_update(ema: dict, model: torch.nn.Module, decay: float) -> None:
    """ema <- decay ema + (1 - decay) params, in place."""
    with torch.no_grad():
        for name, param in model.named_parameters():
            ema[name].mul_(decay).add_(param, alpha=1.0 - decay)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def _draws(x0, t, noise, T: int, generator):
    if t is None:
        t = torch.randint(0, T, (x0.shape[0],), generator=generator,
                          device=x0.device)
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator,
                            device=x0.device, dtype=x0.dtype)
    return t.to(device=x0.device, dtype=torch.int64), noise.to(x0.device)


def _predict(model, x_noisy, t, cond, drop):
    """The model output; with a drop mask (B,) bool, the dropped examples
    see the null context (ertdx/train.py:129-140)."""
    if drop is None:
        return model(x_noisy, t, cond)
    if getattr(model, "uncond_prob", 0.0) <= 0.0:
        raise ValueError("a condition drop mask needs a model with "
                         "uncond_prob > 0 (the null context)")
    ctx = model.drop_condition(model.encode_condition(cond),
                               drop.to(device=cond.device, dtype=torch.bool))
    return model.denoise(x_noisy, t, ctx)


def _shard(mesh, n: int):
    """(rows, shards) of an n-row global batch under `mesh`: this rank's
    slice and the number of data shards, or (None, 1) when the batch runs
    whole (no mesh, one data rank, or n not divisible by the data axis,
    where JAX keeps the batch replicated)."""
    rows = None if mesh is None else mesh.rows(n)
    return rows, (1 if rows is None else mesh.shape["data"])


def _take(rows, *tensors):
    """Rows `rows` of each tensor (None stays None; rows=None keeps
    them all)."""
    return tuple(a if a is None or rows is None else a[rows]
                 for a in tensors)


def _sharded_loss(per_ex, w, n: int):
    """This rank's share of the global batch loss: its sum over the
    global count n, or over the global sum of w, which every rank holds
    (w = (this rank's w, the global w); ertdx/train.py:110-117's
    weighted_eps_mse). Without a mesh it is the batch's mean."""
    if w is None:
        return torch.sum(per_ex) / n
    return torch.sum(per_ex * w[0]) / torch.clamp(torch.sum(w[1]), min=1.0)


def train_step(model, opt, x0, cond, t=None, noise=None, w=None, *,
               alpha_bar, lr: Optional[LR] = None, generator=None,
               parameterization: str = "eps",
               loss_weighting: str = "none", snr_gamma: float = 5.0,
               ema: Optional[dict] = None, ema_decay: float = 0.0,
               drop: Optional[torch.Tensor] = None, mesh=None):
    """One optimizer step on the batch (x0 (B, P), cond (B, L, C)).

    t and noise are drawn from `generator` unless given. A model with
    uncond_prob > 0 drops each example's condition with that probability:
    `drop` (B,) bool gives the mask, else it is drawn from `generator`
    after t and noise. With w=None the
    loss is the unweighted mean((out - target)^2); with w (B,) it is the
    padded-batch weighted mean. min-SNR weighting applies to this (train)
    loss only. `lr` (a float or a schedule) sets the step's learning rate
    from the optimizer's count; None keeps the optimizer's. The gradients
    stay in the parameters' .grad after the step. Returns the loss
    (a detached 0-d tensor).

    With `mesh` (a collective: every rank calls it with the same global
    batch and draws) each rank keeps its rows of the batch and of every
    draw (drawn at the global shape), its loss is its sum over the
    global count (or the global sum of w), one all_reduce sums the
    gradients over the data axis, and every rank takes the same Adam
    and EMA step; the loss returned is the global batch's."""
    if loss_weighting not in ("none", "min_snr"):
        raise ValueError(f"unknown loss_weighting {loss_weighting!r} "
                         "(expected 'none' or 'min_snr')")
    alpha_bar = alpha_bar.to(x0.device)
    n = x0.shape[0]
    t, noise = _draws(x0, t, noise, alpha_bar.shape[0], generator)
    uncond_prob = getattr(model, "uncond_prob", 0.0)
    if drop is None and uncond_prob > 0.0:
        drop = torch.rand(n, generator=generator,
                          device=x0.device) < uncond_prob
    rows, shards = _shard(mesh, n)
    w_all = w
    x0, cond, t, noise, w, drop = _take(rows, x0, cond, t, noise, w, drop)
    x_noisy = q_sample(x0, t, noise, alpha_bar)
    target = prediction_target(x0, noise, t, alpha_bar, parameterization)
    opt.zero_grad(set_to_none=True)
    with sharded_rows(shards):
        out = _predict(model, x_noisy, t, cond, drop)
    per_ex = torch.mean((out - target) ** 2, dim=-1)
    if loss_weighting == "min_snr":
        per_ex = per_ex * min_snr_weight(t, alpha_bar, parameterization,
                                         snr_gamma)
    loss = _sharded_loss(per_ex, None if w is None else (w, w_all), n)
    loss.backward()
    if rows is not None:
        data_all_reduce_grads(model, mesh)
        loss = all_reduce_(loss.detach().clone(), mesh.data_group)
    if lr is not None:
        step_lr = lr_at(lr, optimizer_steps(opt))
        for group in opt.param_groups:
            group["lr"] = step_lr
    opt.step()
    if ema is not None and ema_decay > 0.0:
        ema_update(ema, model, ema_decay)
    return loss.detach()


@torch.no_grad()
def eval_step(model, x0, cond, w, *, alpha_bar, generator=None,
              parameterization: str = "eps", mesh=None):
    """The weighted validation loss of one padded batch, t and eps drawn
    from `generator` (unweighted by min-SNR, as in
    ertdx/train.py:389-410). With `mesh` each rank scores its rows and
    the numerators are all-reduced over the data axis: the global
    batch's loss on every rank."""
    alpha_bar = alpha_bar.to(x0.device)
    t, noise = _draws(x0, None, None, alpha_bar.shape[0], generator)
    rows, shards = _shard(mesh, x0.shape[0])
    x0_l, cond_l, t, noise, w_l = _take(rows, x0, cond, t, noise, w)
    x_noisy = q_sample(x0_l, t, noise, alpha_bar)
    target = prediction_target(x0_l, noise, t, alpha_bar, parameterization)
    with sharded_rows(shards):
        out = model(x_noisy, t, cond_l)
    num = all_reduce_(torch.sum(torch.mean((out - target) ** 2, dim=-1)
                                * w_l),
                      None if rows is None else mesh.data_group)
    return num / torch.clamp(torch.sum(w), min=1.0)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the lr (float or schedule), with EMA the
    averaged parameters {torch name: tensor}, and whether checkpoints
    keep the Adam moments flat (flat_optimizer)."""

    model: torch.nn.Module
    opt: torch.optim.Adam
    lr: LR
    ema_params: Optional[dict] = None
    flat_optimizer: bool = False

    @property
    def step(self) -> int:
        return optimizer_steps(self.opt)


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    best_val_loss: float
    best_epoch: int
    train_history: list
    val_history: list
    steps_per_sec: float


def _epoch_batches(n: int, batch_size: int, order: np.ndarray) -> np.ndarray:
    """(n_batches, B) index matrix; the ragged tail wraps around to the
    front of the permutation."""
    n_batches = -(-n // batch_size)
    return np.resize(order, n_batches * batch_size).reshape(
        n_batches, batch_size).astype(np.int64)


def _seed(*words: int) -> int:
    """A 63-bit seed from a tuple of ints (numpy SeedSequence)."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _restore(state: TrainState, tree: dict) -> None:
    """Load a checkpoint's params, Adam state and EMA into `state`."""
    model = state.model
    params_from_jax(model, tree["params"])
    adam_state_from_jax(state.opt, model, tree["opt_state"],
                        flat=state.flat_optimizer)
    if "ema_params" in tree:
        dev = next(model.parameters()).device
        state.ema_params = {name: val.to(dev) for name, val in
                            named_from_jax(model,
                                           tree["ema_params"]).items()}


@fp32_precision()
def train(cfg: ExperimentConfig, dataset: data_lib.ERTDataset,
          checkpoint_dir: Optional[str] = None, device=None,
          logger: Optional[Callable[[dict], None]] = None,
          resume: bool = False, mesh=None) -> TrainResult:
    """Train `cfg`'s model on `dataset` with best-val checkpointing.

    Runs on the CUDA device unless device="cpu". Each epoch trains over
    the shuffled train split, then evaluates the validation split; an
    epoch whose validation loss beats the best so far writes
    `<checkpoint_dir>/best`, and `step_checkpoint_every` writes `last`.
    With `resume` and a `<checkpoint_dir>/last` checkpoint, training
    continues from it (params, Adam state, EMA, epoch, best-val and
    histories, ertdx/train.py:569-590); without one it starts fresh.
    `epochs_per_dispatch` only changes how the JAX package dispatches;
    the port computes the same epochs one at a time. `logger` receives
    one dict per logged epoch (and one on resuming).

    With `mesh` (a collective: every rank calls it alike) every batch
    whose size divides the data axis shards over it (`train_step`,
    `eval_step`), else it runs replicated, as JAX keeps it; every rank
    ends with the same state and histories, which equal the single
    process's. Only rank 0 writes checkpoints and calls `logger`; the
    ranks wait for it after each write, and `resume` reads on every
    rank."""
    tcfg = cfg.train
    dev = mesh_device(mesh, device)
    if mesh is not None and not is_writer():
        logger = None
    checkpoint_dir = checkpoint_dir or tcfg.checkpoint_dir

    train_idx, val_idx, _ = data_lib.split_dataset(
        len(dataset), configs_lib.split_seed_of(tcfg), tcfg.split)
    model = build_model(cfg.model, dev, generator=torch.Generator()
                        .manual_seed(_seed(tcfg.seed, 0)))
    alpha_bar = schedule_from_config(cfg.diffusion).alpha_bar.to(dev)
    bsz = tcfg.batch_size
    steps_per_epoch = -(-len(train_idx) // bsz)
    lr = make_lr(tcfg, steps_per_epoch * tcfg.num_epochs)
    state = TrainState(model, create_optimizer(model, lr), lr,
                       flat_optimizer=tcfg.flat_optimizer)
    if tcfg.ema_decay > 0.0:
        state.ema_params = {name: p.detach().clone()
                            for name, p in model.named_parameters()}

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    x0_tr, cond_tr = put(dataset.params_u[train_idx]), \
        put(dataset.conditions[train_idx])
    x0_va, cond_va = put(dataset.params_u[val_idx]), \
        put(dataset.conditions[val_idx])
    n_va = len(val_idx)
    v_idx = torch.from_numpy(_epoch_batches(n_va, bsz, np.arange(n_va)))
    v_w = np.zeros(v_idx.shape, np.float32)
    v_w.reshape(-1)[:n_va] = 1.0
    v_w = put(v_w)
    v_idx = v_idx.to(dev)
    step_kw = dict(alpha_bar=alpha_bar, parameterization=
                   cfg.model.parameterization)

    best_val, best_epoch = float("inf"), -1
    train_hist, val_hist = [], []
    step_count, step_time = 0, 0.0
    start_epoch = 0
    last = Path(checkpoint_dir) / "last" if checkpoint_dir else None
    if resume and last and (last / "state.msgpack").exists():
        tree, meta, _ = ckpt_lib.restore_checkpoint(last)
        _restore(state, tree)
        start_epoch = int(meta.get("epoch", 0))
        best_val = float(meta.get("best_val_loss", float("inf")))
        best_epoch = int(meta.get("best_epoch", -1))
        train_hist = list(meta.get("train_history", []))
        val_hist = list(meta.get("val_history", []))
        if logger:
            logger({"resumed_from_epoch": start_epoch, "best_val": best_val})
    for epoch in range(start_epoch, tcfg.num_epochs):
        t0 = time.perf_counter()
        model.train()
        order = np.random.default_rng(np.random.SeedSequence(
            [tcfg.seed, 7, epoch])).permutation(len(train_idx))
        bidx = torch.from_numpy(_epoch_batches(len(train_idx), bsz,
                                               order)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(
            _seed(tcfg.seed, 1, epoch))
        losses = []
        for idx in bidx:
            losses.append(train_step(
                model, state.opt, x0_tr[idx], cond_tr[idx], lr=lr,
                generator=gen, loss_weighting=tcfg.loss_weighting,
                snr_gamma=tcfg.snr_gamma, ema=state.ema_params,
                ema_decay=tcfg.ema_decay, mesh=mesh, **step_kw))
        epoch_loss = float(torch.stack(losses).mean())   # synchronizes
        step_time += time.perf_counter() - t0
        step_count += len(losses)

        model.eval()
        vgen = torch.Generator(device=dev).manual_seed(
            _seed(tcfg.seed, 2) if tcfg.deterministic_val
            else _seed(tcfg.seed, 2, epoch))
        num = torch.zeros((), device=dev)
        den = torch.zeros((), device=dev)
        for idx, w in zip(v_idx, v_w):
            vloss = eval_step(model, x0_va[idx], cond_va[idx], w,
                              generator=vgen, mesh=mesh, **step_kw)
            num += vloss * w.sum()
            den += w.sum()
        val_loss = float(num / torch.clamp(den, min=1.0))

        train_hist.append(epoch_loss)
        val_hist.append(val_loss)
        improved = val_loss < best_val
        if improved:
            best_val, best_epoch = val_loss, epoch
            if checkpoint_dir:
                _save(checkpoint_dir, "best", state, dataset, cfg,
                      {"epoch": epoch + 1, "best_val_loss": best_val,
                       "train_history": train_hist,
                       "val_history": val_hist})
        if (checkpoint_dir and tcfg.step_checkpoint_every
                and (epoch + 1) % tcfg.step_checkpoint_every == 0):
            _save(checkpoint_dir, "last", state, dataset, cfg,
                  {"epoch": epoch + 1, "best_val_loss": best_val,
                   "best_epoch": best_epoch, "train_history": train_hist,
                   "val_history": val_hist})
        if logger and tcfg.log_every and (epoch + 1) % tcfg.log_every == 0:
            logger({"epoch": epoch + 1, "train_loss": epoch_loss,
                    "val_loss": val_loss, "best_val": best_val,
                    "improved": int(improved)})

    sps = step_count / step_time if step_time > 0 else float("nan")
    return TrainResult(state, best_val, best_epoch, train_hist, val_hist,
                       sps)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

#: config fields that travel with the weights at restore
#: (ertdx/train.py:750-759): model fields that change the parameter tree
#: or what the output means, train fields that change the opt-state layout
_MODEL_LAYOUT_FIELDS = (
    "name", "param_dim", "hidden_dim", "cond_channels", "cond_length",
    "base_width", "depth", "num_heads", "core_heads", "num_blocks",
    "uncond_prob", "pallas_conv", "pallas_conv_min_width",
    "parameterization")
_TRAIN_LAYOUT_FIELDS = ("lr_schedule", "warmup_steps", "flat_optimizer",
                        "ema_decay")


def _state_tree(state: TrainState) -> dict:
    """The train state as the JAX package serializes it: params, optax
    adam state, step and, with EMA, ema_params, in flax layout."""
    model = state.model
    tree = {"params": params_to_jax(model),
            "opt_state": adam_state_to_jax(state.opt, model,
                                           schedule=callable(state.lr),
                                           flat=state.flat_optimizer),
            "step": np.asarray(state.step, dtype=np.int32)}
    if state.ema_params is not None:
        tree["ema_params"] = named_to_jax(model, state.ema_params)
    return tree


def _save(checkpoint_dir, name, state, dataset, cfg, meta_extra) -> None:
    """Write a checkpoint. Every rank of a world builds the tree (which
    gathers tensor-parallel shards), rank 0 alone writes it, and the
    ranks wait for the write."""
    meta = {"param_dim": dataset.param_dim, "model": cfg.model.name,
            "config": dataclasses.asdict(cfg)}
    meta.update(meta_extra)
    tree = _state_tree(state)
    if is_writer():
        ckpt_lib.save_checkpoint(
            f"{checkpoint_dir}/{name}", tree, meta,
            scalers={"param_scaler": dataset.param_scaler,
                     "ert_scaler": dataset.ert_scaler})
    barrier()


def saved_config(checkpoint_dir: str) -> Optional[dict]:
    """The config echo in meta.json (best, else last); None without one."""
    for name in ("best", "last"):
        p = Path(checkpoint_dir) / name / "meta.json"
        if p.exists():
            d = json.loads(p.read_text()).get("config")
            if d:
                return d
    return None


def load_best_model(checkpoint_dir: str, cfg: ExperimentConfig,
                    device=None):
    """Restore `<checkpoint_dir>/best`, written by the JAX package or the
    port; returns (TrainState, meta, scalers). The checkpoint's config
    echo wins over `cfg` for the fields that fix the parameter tree and
    the optimizer-state layout (ertdx/train.py:775-820)."""
    saved = saved_config(checkpoint_dir)
    if saved:
        cfg = configs_lib.experiment_from_dict(
            {"model": {k: v for k, v in saved.get("model", {}).items()
                       if k in _MODEL_LAYOUT_FIELDS},
             "train": {k: v for k, v in saved.get("train", {}).items()
                       if k in _TRAIN_LAYOUT_FIELDS}},
            base=cfg)
    model = build_model(cfg.model, device)
    tree, meta, scalers = ckpt_lib.restore_checkpoint(
        Path(checkpoint_dir) / "best")
    # the lr's horizon does not change the state layout, so 1 will do
    lr = make_lr(cfg.train, 1)
    state = TrainState(model, create_optimizer(model, lr), lr,
                       flat_optimizer=cfg.train.flat_optimizer)
    _restore(state, tree)
    return state, meta, scalers
