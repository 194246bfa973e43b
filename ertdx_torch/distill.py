"""Progressive distillation (Salimans & Ho 2022, arXiv:2202.00512).

Mirrors ertdx/distill.py on one device. A stage halves the step count: a
student (a copy of the teacher's weights, predicting v) learns to take in
ONE DDIM (eta=0) step what the teacher takes in two on the grid twice as
fine (`pd_grid` nests exactly under halving); its regression target is
`one_step_target`, weighted by the truncated SNR max(abar/(1-abar), 1).
An eps teacher (or a guided one) first goes through a same-grid
conversion stage that regresses the student's x0 onto the teacher's.
After each stage the student becomes the next teacher. Every stage gets a
fresh Adam with the per-stage cosine schedule (optax's
cosine_decay_schedule(lr, max(horizon, 1)), `train.make_lr`).

The teacher is a second module of the same configuration, run under
`torch.no_grad()`. On the card every distillation step runs the encoder
twice (teacher and student) and its backward once, so a flash-arm or
slab-arm teacher exercises those kernels on every step.

Contracts kept from the JAX package: the teacher's config echo wins over
the caller's cfg (model, schedule, split fractions and seeds, the
teacher's parameterization); `start_steps` clamps to the largest
halvable grid <= T; guided distillation needs a CFG-trained teacher and
applies the guidance only while the original teacher is the target; a
conversion-only no-op raises; `save_stages` writes `pd<N>`
subdirectories; the student's echo carries sampler="pd", its pd_steps,
guidance_scale=1 and guidance_interval=(0, 1), so `sample_pd` (and JAX's
`load_best_model`) restore it without flags. `distill` runs under
`precision.fp32_precision` (no TF32 in cuBLAS or cuDNN).

Random draws: the per-epoch shuffle is numpy's
SeedSequence([seed, 11, student_steps, epoch]) permutation, exactly as in
JAX. JAX's keys (`fold_in`, `split`) cannot be reproduced in torch: each
epoch's grid indices (or timesteps) and noise come from a
torch.Generator seeded from (seed, stage, epoch), and validation's from
(seed, stage, 10_000 + epoch). Every batch-loss function takes injected
draws, so that a test can hand it JAX's.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import configs as configs_lib
from . import data as data_lib
from . import resolve_device
from . import train as train_lib
from .configs import ExperimentConfig
from .diffusion import pd_grid, schedule_from_config
from .precision import fp32_precision


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Progressive-distillation schedule. start_steps must be
    target_steps * 2**k (the grids nest by exact halving)."""

    target_steps: int = 4
    start_steps: int = 64          # first teacher grid (clamped to T)
    epochs_per_stage: int = 60
    convert_epochs: int = 40       # eps->v conversion stage (0 = skip;
                                   # ignored when the teacher is already v)
    lr: float = 1e-4               # fresh Adam per stage
    cosine_lr: bool = True         # anneal each stage's lr to 0
    batch_size: int = 32
    seed: int = 42
    use_ema_teacher: bool = False  # start from the teacher's EMA params
    save_stages: bool = False      # also checkpoint every halving's
                                   # student under <out_dir>/pd<N>
    guidance_scale: float = 1.0    # != 1: guided distillation (Meng et
                                   # al. 2023): the CFG teacher's guided
                                   # output is baked into the student


@dataclasses.dataclass
class StageResult:
    kind: str                      # "convert" | "halve"
    student_steps: int             # grid size the student was trained for
    losses: list                   # per-epoch mean train loss
    val_losses: list               # per-epoch distill loss on the val split
    seconds: float


@dataclasses.dataclass
class DistillResult:
    state: train_lib.TrainState
    stages: list                   # [StageResult]
    target_steps: int


def _x0_from_out(out, x, alpha, sigma, kind: str):
    """Model output -> x0 prediction under the given parameterization."""
    if kind == "v":
        return alpha * x - sigma * out
    return (x - sigma * out) / alpha          # eps


def _eps_from_out(out, x, alpha, sigma, kind: str):
    if kind == "v":
        return sigma * x + alpha * out
    return out


def _snr_weight(abar):
    """Truncated-SNR loss weight max(SNR, 1) (arXiv:2202.00512 §4)."""
    return torch.clamp(abar / (1.0 - abar), min=1.0)


def one_step_target(x, x_dst, ab_t, ab_dst):
    """The x0 that makes ONE DDIM (eta=0) step from (x, abar_t) land
    exactly on x_dst at abar_dst (arXiv:2202.00512 eq. 8):
    x0 = (x_dst - (sigma_dst/sigma_t) x) / (alpha_dst - (sigma_dst/sigma_t)
    alpha_t); at ab_dst == 1 it is x_dst itself."""
    s_t, s_dst = torch.sqrt(1.0 - ab_t), torch.sqrt(1.0 - ab_dst)
    sr = s_dst / s_t
    return (x_dst - sr * x) / (torch.sqrt(ab_dst) - sr * torch.sqrt(ab_t))


def _make_teacher_fn(guidance: float):
    """(prep, call) for the teacher's raw outputs. prep encodes the
    condition once per batch; with guidance != 1 call runs the guided
    combination out_u + g (out_c - out_u), valid for eps and v outputs
    alike (ertdx/distill.py:146-178)."""
    if float(guidance) == 1.0:
        def prep(teacher, cond, n_batch):
            del n_batch
            return teacher.encode_condition(cond)

        def call(teacher, x, t, ctxs):
            return teacher.denoise_ensemble(x, t, ctxs, 1)
        return prep, call

    def prep(teacher, cond, n_batch):
        ctx_c = teacher.encode_condition(cond)
        ctx_u = teacher.drop_condition(
            ctx_c, torch.ones(n_batch, dtype=torch.bool, device=cond.device))
        return ctx_c, ctx_u

    def call(teacher, x, t, ctxs):
        ctx_c, ctx_u = ctxs
        out_c = teacher.denoise_ensemble(x, t, ctx_c, 1)
        out_u = teacher.denoise_ensemble(x, t, ctx_u, 1)
        return out_u + guidance * (out_c - out_u)
    return prep, call


def _weighted_mean(per_ex, w):
    """Plain mean for the train path (w=None); padded-row-exact weighted
    mean for validation."""
    if w is None:
        return torch.mean(per_ex)
    return torch.sum(per_ex * w) / torch.clamp(torch.sum(w), min=1.0)


def _student_loss(student, x, t, cond, a, s, x0_tgt, ab, student_kind, w):
    ctx_s = student.encode_condition(cond)
    out_s = student.denoise_ensemble(x, t, ctx_s, 1)
    x0_pred = _x0_from_out(out_s, x, a, s, student_kind)
    per_ex = torch.mean(_snr_weight(ab) * (x0_pred - x0_tgt) ** 2, dim=-1)
    return _weighted_mean(per_ex, w)


class EpochFns(NamedTuple):
    """What make_distill_epoch and make_convert_epoch return: the epoch
    (train), the validation pass, and the batch loss they are built on."""

    epoch: Callable
    val: Callable
    batch_loss: Callable


def make_distill_epoch(schedule, n_student: int, teacher_kind: str,
                       student_kind: str = "v", guidance: float = 1.0,
                       device=None) -> EpochFns:
    """One halving stage: teacher at 2 n_student grid points, student at
    n_student (ertdx/distill.py:181-253). `schedule` is the teacher's.
    The batch loss is

        batch_loss(student, teacher, x0, cond, i=None, noise=None, w=None,
                   generator=None)

    with `i` (B,) the student grid indices and `noise` (B, P), drawn from
    `generator` (i first) unless given."""
    T = schedule.num_steps
    ts_stu = pd_grid(T, n_student).numpy()
    ts_tea = pd_grid(T, 2 * n_student).numpy()
    # nesting invariant: the student's point i IS the teacher's 2i+1
    assert (ts_tea[1::2] == ts_stu).all()
    abar = schedule.alpha_bar.detach().cpu().numpy().astype(np.float64)
    abar_t = abar[ts_stu]
    abar_mid = abar[ts_tea[0::2]]
    # two teacher steps land on the previous student grid point; for the
    # cleanest student point that is the clean limit abar = 1
    abar_dst = np.concatenate([[1.0], abar_t[:-1]])
    t_tbl = torch.as_tensor(np.stack([ts_stu, ts_tea[0::2]], axis=1),
                            dtype=torch.int64, device=device)
    ab_tbl = torch.as_tensor(np.stack([abar_t, abar_mid, abar_dst], axis=1),
                             dtype=torch.float32, device=device)
    t_prep, t_call = _make_teacher_fn(guidance)

    def batch_loss(student, teacher, x0, cond, i=None, noise=None, w=None,
                   generator=None):
        b = x0.shape[0]
        if i is None:
            i = torch.randint(0, n_student, (b,), generator=generator,
                              device=x0.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator,
                                device=x0.device, dtype=x0.dtype)
        i = i.to(device=t_tbl.device, dtype=torch.int64)
        t, t_mid = t_tbl[i, 0], t_tbl[i, 1]
        ab = ab_tbl[i]
        ab_t, ab_mid, ab_dst = ab[:, 0:1], ab[:, 1:2], ab[:, 2:3]
        a_t, s_t = torch.sqrt(ab_t), torch.sqrt(1.0 - ab_t)
        a_mid, s_mid = torch.sqrt(ab_mid), torch.sqrt(1.0 - ab_mid)
        a_dst, s_dst = torch.sqrt(ab_dst), torch.sqrt(1.0 - ab_dst)
        x = a_t * x0 + s_t * noise.to(x0.device)

        with torch.no_grad():       # two teacher DDIM (eta=0) steps
            ctx_t = t_prep(teacher, cond, b)
            out1 = t_call(teacher, x, t, ctx_t)
            eps1 = _eps_from_out(out1, x, a_t, s_t, teacher_kind)
            x0h1 = _x0_from_out(out1, x, a_t, s_t, teacher_kind)
            x_mid = a_mid * x0h1 + s_mid * eps1
            out2 = t_call(teacher, x_mid, t_mid, ctx_t)
            eps2 = _eps_from_out(out2, x_mid, a_mid, s_mid, teacher_kind)
            x0h2 = _x0_from_out(out2, x_mid, a_mid, s_mid, teacher_kind)
            x_dst = a_dst * x0h2 + s_dst * eps2
            x0_tgt = one_step_target(x, x_dst, ab_t, ab_dst)
        return _student_loss(student, x, t, cond, a_t, s_t, x0_tgt, ab_t,
                             student_kind, w)

    return _build_epoch(batch_loss)


def make_convert_epoch(schedule, teacher_kind: str, student_kind: str = "v",
                       guidance: float = 1.0, device=None) -> EpochFns:
    """Same-grid conversion: the student's x0 regresses onto the teacher's
    (guided, with guidance != 1) x0 at uniformly drawn t
    (ertdx/distill.py:264-298). The batch loss takes `t` (B,) and `noise`
    (B, P) in place of the draws, t first."""
    T = schedule.num_steps
    abar_all = schedule.alpha_bar.to(device=device, dtype=torch.float32)
    t_prep, t_call = _make_teacher_fn(guidance)

    def batch_loss(student, teacher, x0, cond, t=None, noise=None, w=None,
                   generator=None):
        b = x0.shape[0]
        if t is None:
            t = torch.randint(0, T, (b,), generator=generator,
                              device=x0.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator,
                                device=x0.device, dtype=x0.dtype)
        t = t.to(device=abar_all.device, dtype=torch.int64)
        ab = abar_all[t][:, None]
        a, s = torch.sqrt(ab), torch.sqrt(1.0 - ab)
        x = a * x0 + s * noise.to(x0.device)
        with torch.no_grad():
            out_t = t_call(teacher, x, t, t_prep(teacher, cond, b))
            x0_tgt = _x0_from_out(out_t, x, a, s, teacher_kind)
        return _student_loss(student, x, t, cond, a, s, x0_tgt, ab,
                             student_kind, w)

    return _build_epoch(batch_loss)


def _build_epoch(batch_loss: Callable) -> EpochFns:
    """The epoch and validation loops around a batch loss (the port of
    ertdx/distill.py:301-352's scans).

    epoch(state, teacher, x0_all, cond_all, batch_idx, generator=None,
          draws=None) -> mean train loss: one Adam step per row of the
          (n_batches, B) `batch_idx`, the lr from `state.lr` at the
          optimizer's count; `draws`, one (i or t, noise) pair per batch,
          replaces the generator's.
    val(model, teacher, x0_all, cond_all, batch_idx, w_all,
        generator=None, draws=None) -> the weighted mean loss over the
        live rows (w > 0)."""

    def epoch(state, teacher, x0_all, cond_all, batch_idx, generator=None,
              draws=None):
        model, opt = state.model, state.opt
        losses = []
        for n, idx in enumerate(batch_idx):
            d = draws[n] if draws is not None else (None, None)
            opt.zero_grad(set_to_none=True)
            loss = batch_loss(model, teacher, x0_all[idx], cond_all[idx],
                              *d, generator=generator)
            loss.backward()
            step_lr = train_lib.lr_at(state.lr,
                                      train_lib.optimizer_steps(opt))
            for group in opt.param_groups:
                group["lr"] = step_lr
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    @torch.no_grad()
    def val(model, teacher, x0_all, cond_all, batch_idx, w_all,
            generator=None, draws=None):
        num = den = 0.0
        for n, (idx, w) in enumerate(zip(batch_idx, w_all)):
            d = draws[n] if draws is not None else (None, None)
            loss = batch_loss(model, teacher, x0_all[idx], cond_all[idx],
                              *d, w=w, generator=generator)
            num = num + loss * w.sum()
            den = den + w.sum()
        return num / torch.clamp(torch.as_tensor(den), min=1.0)

    return EpochFns(epoch, val, batch_loss)


def _halvings(start: int, target: int):
    if start < target:
        raise ValueError(f"start_steps {start} < target_steps {target}")
    ns, n = [], start
    while n > target:
        if n % 2:
            raise ValueError(
                f"start_steps {start} must be target_steps {target} * 2**k")
        ns.append(n)
        n //= 2
    if n != target:
        raise ValueError(
            f"start_steps {start} must be target_steps {target} * 2**k")
    return ns                      # teacher grids, e.g. [64, 32, ..., 8]


def _frozen(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of `model` that takes no gradient: the next stage's
    teacher."""
    return copy.deepcopy(model).requires_grad_(False).eval()


@fp32_precision()
def distill(cfg: ExperimentConfig, dcfg: DistillConfig,
            dataset: data_lib.ERTDataset, teacher_dir: str,
            out_dir: Optional[str] = None, mesh=None,
            logger: Optional[Callable[[dict], None]] = None,
            device=None) -> DistillResult:
    """Progressively distill the checkpoint in `teacher_dir` down to
    dcfg.target_steps denoiser calls, on `device` (CUDA unless "cpu" is
    asked for). The checkpoint's config echo wins over `cfg`. The final
    student is saved under `out_dir`/best with an echo carrying
    parameterization="v" and sampler="pd"/pd_steps=target. `logger`
    receives one dict per epoch. `mesh` is not ported (ROADMAP.md queue 1
    item 5) and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "distill(mesh=...): data parallelism is not ported yet "
            "(ROADMAP.md queue 1 item 5); the port distills on one device")
    dev = resolve_device(device)
    saved = train_lib.saved_config(teacher_dir) or {}
    if saved:
        cfg = configs_lib.experiment_from_dict(saved, base=cfg)
    T = cfg.diffusion.T
    schedule = schedule_from_config(cfg.diffusion)
    if dcfg.target_steps > T:
        raise ValueError(f"target_steps {dcfg.target_steps} > teacher "
                         f"schedule T {T}")
    # validate the 2**k relation on the requested grid, then clamp to the
    # largest valid grid <= T (start 512 over T=500 -> 256)
    _halvings(dcfg.start_steps, dcfg.target_steps)
    start = dcfg.target_steps
    while start * 2 <= min(dcfg.start_steps, T):
        start *= 2
    stages_n = _halvings(start, dcfg.target_steps)

    t_state, _, _ = train_lib.load_best_model(teacher_dir, cfg, device=dev)
    teacher_kind = saved.get("model", {}).get(
        "parameterization", cfg.model.parameterization)
    teacher = t_state.model.requires_grad_(False).eval()
    if dcfg.use_ema_teacher and t_state.ema_params is not None:
        with torch.no_grad():
            for name, param in teacher.named_parameters():
                param.copy_(t_state.ema_params[name])
    mcfg = dataclasses.replace(cfg.model, parameterization="v")

    # data: the teacher's train-time split (split_seed when it had one)
    n = len(dataset)
    saved_tr = saved.get("train", {})
    seed = int(saved_tr.get("seed", cfg.train.seed))
    sseed = saved_tr.get("split_seed")
    split_seed = seed if sseed is None else int(sseed)
    train_idx, val_idx, _ = data_lib.split_dataset(n, split_seed,
                                                   cfg.train.split)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    x0_tr, cond_tr = put(dataset.params_u[train_idx]), \
        put(dataset.conditions[train_idx])
    x0_va, cond_va = put(dataset.params_u[val_idx]), \
        put(dataset.conditions[val_idx])
    bsz = dcfg.batch_size
    v_idx = train_lib._epoch_batches(len(val_idx), bsz,
                                     np.arange(len(val_idx)))
    v_w = np.zeros(v_idx.shape, np.float32)
    v_w.reshape(-1)[:len(val_idx)] = 1.0
    v_idx, v_w = put(v_idx), put(v_w)
    steps_per_epoch = -(-len(train_idx) // bsz)

    def fresh_state(source, n_epochs):
        horizon = steps_per_epoch * n_epochs
        lr = (train_lib.make_lr(configs_lib.TrainConfig(
                  lr=dcfg.lr, lr_schedule="cosine"), max(horizon, 1))
              if dcfg.cosine_lr else dcfg.lr)
        student = copy.deepcopy(source).requires_grad_(True).train()
        student.parameterization = "v"
        return train_lib.TrainState(student,
                                    train_lib.create_optimizer(student, lr),
                                    lr)

    def run_stage(kind, student_steps, n_epochs, teacher, stage, tkind, g):
        if kind == "convert":
            fns = make_convert_epoch(schedule, tkind, guidance=g, device=dev)
        else:
            fns = make_distill_epoch(schedule, student_steps, tkind,
                                     guidance=g, device=dev)
        state = fresh_state(teacher, n_epochs)
        losses, vlosses = [], []
        t0 = time.perf_counter()
        for e in range(n_epochs):
            order = np.random.default_rng(np.random.SeedSequence(
                [dcfg.seed, 11, student_steps, e])).permutation(
                    len(train_idx))
            bidx = put(train_lib._epoch_batches(len(train_idx), bsz, order))
            gen = torch.Generator(device=dev).manual_seed(
                train_lib._seed(dcfg.seed, stage, e))
            loss = fns.epoch(state, teacher, x0_tr, cond_tr, bidx, gen)
            vgen = torch.Generator(device=dev).manual_seed(
                train_lib._seed(dcfg.seed, stage, 10_000 + e))
            vloss = fns.val(state.model, teacher, x0_va, cond_va, v_idx,
                            v_w, vgen)
            losses.append(float(loss))
            vlosses.append(float(vloss))
            if logger:
                logger({"stage": kind, "student_steps": student_steps,
                        "epoch": e + 1, "loss": losses[-1],
                        "val_loss": vlosses[-1]})
        return state, StageResult(kind, student_steps, losses, vlosses,
                                  time.perf_counter() - t0)

    # guided distillation: the guided combination applies only while the
    # original teacher is the target; later stages distill the student
    # that baked it in, unguided
    g_left = float(dcfg.guidance_scale)
    if g_left != 1.0 and getattr(teacher, "uncond_prob", 0.0) <= 0.0:
        raise ValueError(
            "guidance_scale != 1 requires a CFG-trained teacher "
            "(ModelConfig.uncond_prob > 0)")

    stages = []
    kinds_done = 0
    if (teacher_kind != "v" or g_left != 1.0) and dcfg.convert_epochs > 0:
        state, sr = run_stage("convert", start, dcfg.convert_epochs,
                              teacher, kinds_done, teacher_kind, g_left)
        stages.append(sr)
        teacher = _frozen(state.model)
        teacher_kind = "v"
        g_left = 1.0
        kinds_done += 1

    state = None
    for si, n_teacher in enumerate(stages_n):
        state, sr = run_stage("halve", n_teacher // 2,
                              dcfg.epochs_per_stage, teacher,
                              kinds_done + si, teacher_kind, g_left)
        g_left = 1.0
        stages.append(sr)
        if out_dir and dcfg.save_stages:
            _save_student(f"{out_dir}/pd{n_teacher // 2}", state,
                          n_teacher // 2, stages, cfg, mcfg, dcfg, seed,
                          teacher_dir, dataset)
        teacher = _frozen(state.model)
        teacher_kind = "v"

    if state is None:                      # conversion only (start == target)
        if teacher_kind != "v" or g_left != 1.0:
            # nothing ran: saving raw eps weights under a v echo (or an
            # unguided teacher as a guided student) would give wrong
            # samples at restore
            raise ValueError(
                "nothing to distill: start_steps == target_steps and the "
                "conversion stage is disabled (convert_epochs=0) for a "
                f"{teacher_kind!r} teacher with guidance "
                f"{dcfg.guidance_scale}")
        state = fresh_state(teacher, 1)

    if out_dir:
        _save_student(out_dir, state, dcfg.target_steps, stages, cfg, mcfg,
                      dcfg, seed, teacher_dir, dataset)
    return DistillResult(state, stages, dcfg.target_steps)


def _save_student(dir_, state, steps, stages, cfg, mcfg, dcfg, seed,
                  teacher_dir, dataset):
    """Checkpoint a student with a layout-true config echo
    (ertdx/distill.py:567-596): per-stage Adam with a schedule count iff
    cosine_lr, no EMA, no flat optimizer; seed stays the teacher's train
    seed (it pins the data split); guidance_scale 1 and the interval reset,
    because the student has the guidance baked in."""
    tr_out = dataclasses.replace(
        cfg.train, lr=dcfg.lr, batch_size=dcfg.batch_size, seed=seed,
        lr_schedule="cosine" if dcfg.cosine_lr else "constant",
        warmup_steps=0, lr_end_fraction=0.0, ema_decay=0.0,
        flat_optimizer=False)
    cfg_out = dataclasses.replace(
        cfg, model=mcfg, train=tr_out,
        sample=dataclasses.replace(cfg.sample, sampler="pd",
                                   pd_steps=steps, guidance_scale=1.0,
                                   guidance_interval=(0.0, 1.0)))
    train_lib._save(dir_, "best", state, dataset, cfg_out,
                    {"distilled_from": str(teacher_dir),
                     "target_steps": steps,
                     "baked_guidance_scale": dcfg.guidance_scale,
                     "stages": [dataclasses.asdict(s) for s in stages],
                     "best_val_loss": stages[-1].val_losses[-1] if stages
                     else float("nan"),
                     "epoch": sum(len(s.losses) for s in stages)})
