"""`ertdiff` on the port: the JAX package's CLI (ertdx/cli.py) on PyTorch.

Usage: python -m ertdx_torch.cli <command> [options]

Every subcommand takes the flags of its JAX counterpart, with the same
defaults and the same SystemExit messages, and one more where it runs on
a device: `--device {cuda,cpu}` (default cuda; cpu runs the plain
PyTorch versions of the kernels). `train`, `sample`, `calibrate`,
`distill` and `serve` read and write the JAX package's checkpoint
directories, so either package restores what the other wrote.

All three models run: the presets ref_default (refmlp, the default) and
synthetic_gaussian (uncondmlp, on the fields `generate-synthetic`
writes) as well as the CondUNet's, and `sample` and `serve` take the
reference's `.pth` weights with --torch-checkpoint (compat.py).

`simulate` runs PFLOTRAN (or any program that takes `-pflotranin
<file>` and writes the .srv files) over a parameter design through
physics.py and reads each run back on the C++ .srv reader; `plot` (its
statistics on `--device`) and the --plot, --plots-dir and --diagnostics
flags draw with matplotlib, imported only when a figure is drawn.

`train`, `sample` and `distill` take `--mesh-data N`: a data-parallel
mesh of N ranks, one process a rank, launched as

    python -m torch.distributed.run --standalone --nproc-per-node N \
        -m ertdx_torch.cli <command> ... --mesh-data N

(the process group starts from the launcher's environment; NCCL when
each rank has a card of its own, gloo on the CPU and where ranks share
one). Without a launcher the process is a world of one, and a mesh
larger than the world raises JAX's message. Only rank 0 writes files
and prints.

`bench`, which runs the JAX package's own benchmark, raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

def _mesh(args):
    """The --mesh-data mesh, or None without the flag. Under a launcher
    the process group starts from its environment (main() ends it);
    make_mesh's ValueError (a mesh larger than the world) exits with its
    message."""
    if not args.mesh_data:
        return None
    from .parallel.mesh import make_mesh
    from .parallel.multihost import init_from_env
    init_from_env(args.device)
    try:
        return make_mesh(data=args.mesh_data, device=args.device)
    except ValueError as exc:
        raise SystemExit(str(exc)) from exc


def _load_cfg(args, adopt_checkpoint: bool = False
              ) -> "configs.ExperimentConfig":
    from . import configs
    cfg = configs.PRESETS[args.preset]
    if adopt_checkpoint and getattr(args, "checkpoint_dir", None):
        # restore commands: the checkpoint's config echo is the source of
        # truth for what was trained; explicit flags below still win
        from .train import saved_config
        saved = saved_config(args.checkpoint_dir)
        if saved:
            cfg = configs.experiment_from_dict(saved, base=cfg)
    overrides = {}
    if getattr(args, "epochs", None) is not None:
        overrides["num_epochs"] = args.epochs
    if getattr(args, "batch_size", None) is not None:
        overrides["batch_size"] = args.batch_size
    if getattr(args, "seed", None) is not None:
        overrides["seed"] = args.seed
    if getattr(args, "split_seed", None) is not None:
        overrides["split_seed"] = args.split_seed
    if getattr(args, "checkpoint_dir", None):
        overrides["checkpoint_dir"] = args.checkpoint_dir
    if getattr(args, "save_every", None) is not None:
        overrides["step_checkpoint_every"] = args.save_every
    if getattr(args, "ema_decay", None) is not None:
        overrides["ema_decay"] = args.ema_decay
    if getattr(args, "lr_schedule", None):
        overrides["lr_schedule"] = args.lr_schedule
    if getattr(args, "warmup_steps", None) is not None:
        overrides["warmup_steps"] = args.warmup_steps
    if getattr(args, "loss_weighting", None):
        overrides["loss_weighting"] = args.loss_weighting
    if getattr(args, "snr_gamma", None) is not None:
        overrides["snr_gamma"] = args.snr_gamma
    if overrides:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **overrides))
    model_overrides = {}
    if getattr(args, "model", None):
        model_overrides["name"] = args.model
    if getattr(args, "dtype", None):
        model_overrides["dtype"] = args.dtype
    if getattr(args, "uncond_prob", None) is not None:
        model_overrides["uncond_prob"] = args.uncond_prob
    if getattr(args, "cond_length", None) is not None:
        model_overrides["cond_length"] = args.cond_length
    if getattr(args, "cond_channels", None) is not None:
        model_overrides["cond_channels"] = args.cond_channels
    if model_overrides:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **model_overrides))
    if getattr(args, "beta_schedule", None):
        cfg = dataclasses.replace(
            cfg, diffusion=dataclasses.replace(
                cfg.diffusion, schedule=args.beta_schedule))
    return cfg


def _split_seed(args, cfg) -> int:
    """The train/val/test split is the TRAIN-TIME split (the checkpoint
    echo's split_seed, else its train seed): --seed varies only the
    sampling randomness, so trained-on rows never leak into the
    evaluation split."""
    if getattr(args, "checkpoint_dir", None):
        from .train import saved_config
        saved = saved_config(args.checkpoint_dir)
        tr = (saved or {}).get("train", {})
        if tr.get("split_seed") is not None:
            return int(tr["split_seed"])
        if "seed" in tr:
            return int(tr["seed"])
    from .configs import split_seed_of
    return split_seed_of(cfg.train)


def _generator(args, cfg, mesh=None):
    """A torch.Generator on the command's device (the mesh's), seeded by
    --seed (else the config's train seed)."""
    import torch

    from .parallel.mesh import mesh_device
    dev = mesh_device(mesh, args.device)
    seed = args.seed if args.seed is not None else cfg.train.seed
    return torch.Generator(device=dev).manual_seed(int(seed)), dev


def _use_ema(state) -> None:
    """Load the checkpoint's EMA parameters into its model."""
    import torch
    if state.ema_params is None:
        raise SystemExit(
            "--ema: this checkpoint has no EMA parameters; train "
            "with --ema-decay > 0 first")
    with torch.no_grad():
        for name, param in state.model.named_parameters():
            param.copy_(state.ema_params[name])


def _sampler_overrides(args, scfg):
    """`scfg` with the sampling flags of `sample` or `calibrate` applied
    (calibrate has no --temperature: it sweeps it)."""
    overrides = {}
    if args.sampler:
        overrides["sampler"] = args.sampler
    if getattr(args, "temperature", None) is not None:
        overrides["temperature"] = _parse_temperature(args.temperature)
    if args.steps is not None:
        # one flag steers whichever subsequence sampler is active
        overrides["ddim_steps"] = args.steps
        overrides["dpmpp_steps"] = args.steps
        overrides["pd_steps"] = args.steps
    if args.eta is not None:
        overrides["ddim_eta"] = args.eta
    if args.guidance is not None:
        overrides["guidance_scale"] = args.guidance
    if args.guidance_interval:
        lo, hi = (float(x) for x in args.guidance_interval.split(","))
        overrides["guidance_interval"] = (lo, hi)
    return dataclasses.replace(scfg, **overrides) if overrides else scfg


def cmd_generate_design(args) -> int:
    import warnings

    from .doe import SurrogateDataGenerator
    gen = SurrogateDataGenerator(seed=args.seed)
    with warnings.catch_warnings():
        # scipy's Sobol balance warning (non-power-of-2 n) is expected
        # for user-chosen design sizes; the scrambled points stay valid
        warnings.filterwarnings(
            "ignore", message=".*balance properties of Sobol.*")
        params = gen.generate_training_samples(
            args.n, method=args.method, plot_diagnostics=args.diagnostics,
            output_dir=str(Path(args.out).parent))
    np.save(args.out, params[..., None])  # (N, 29, 1) reference layout
    print(f"wrote {args.out}: {params.shape[0]} x {params.shape[1]} design")
    return 0


def cmd_generate_synthetic(args) -> int:
    from .synthetic import make_unconditional_dataset
    fields, cond = make_unconditional_dataset(
        args.n, (args.grid, args.grid), args.length_scale, args.seed)
    np.save(args.out, fields)
    np.save(Path(args.out).with_name("synthetic_cond.npy"), cond)
    print(f"wrote {args.out}: {fields.shape} Gaussian fields "
          f"(grid {args.grid}x{args.grid})")
    return 0


def cmd_simulate(args) -> int:
    from .data import SrvFormat
    from .physics import (ForwardModelRunner, PflotranSimulator,
                          RunnerConfig, SimulationManager)
    from .utils import srv_native
    sim = PflotranSimulator(args.template, args.prefix, mode=args.mode,
                            output_dir=args.workdir)
    cfg = RunnerConfig(pflotran_path=args.pflotran, timeout_s=args.timeout,
                       max_concurrent=args.concurrency,
                       max_retries=args.max_retries,
                       n_surveys=args.surveys,
                       measurements_per_survey=args.measurements,
                       srv_format=SrvFormat(skip_header=args.srv_skip_header,
                                            usecols=args.srv_usecols),
                       use_mpi=not args.no_mpi)
    mgr = SimulationManager(base_dir=args.results_dir)
    runner = ForwardModelRunner(sim, cfg=cfg, workdir=args.workdir,
                                manager=mgr)
    params = np.load(args.params)
    if params.ndim == 3:
        params = params.squeeze(-1)
    before = dict(srv_native.reads)
    runner.run_simulations_with_params(params)
    print(f"results under {mgr.base_output_dir}")
    read = {k: srv_native.reads[k] - before[k] for k in before}
    print(f".srv files read: {read['native']} by the C++ reader, "
          f"{read['numpy']} by numpy")
    return 0


def cmd_gather_data(args) -> int:
    from .data import load_simulation_data, refold_ert_vector
    data, params = load_simulation_data(args.results_dir, args.n)
    folded = np.stack([refold_ert_vector(d.squeeze(), args.surveys)
                       for d in data])
    np.save(args.out_ert, folded)
    np.save(args.out_params, params[..., None]
            if params.ndim == 2 else params)
    print(f"wrote {args.out_ert} {folded.shape} and {args.out_params} "
          f"{params.shape}")
    return 0


def cmd_train(args) -> int:
    from . import data as data_lib
    from .parallel.mesh import is_writer
    from .train import train
    from .utils.logging import MetricsLogger
    from .utils.profiling import trace
    cfg = _load_cfg(args)
    mesh = _mesh(args)
    sim_param = np.load(args.params)
    ert = np.load(args.ert)
    ds = data_lib.prepare_dataset(sim_param, ert)
    logger = MetricsLogger(args.log_file, echo=True) if is_writer() else None
    with trace(args.profile):
        # the preset's MeshConfig is the JAX package's; as JAX's CLI, the
        # port trains on a mesh only with --mesh-data
        res = train(cfg, ds, checkpoint_dir=cfg.train.checkpoint_dir,
                    device=args.device, logger=logger, resume=args.resume,
                    mesh=mesh)
    if not is_writer():
        return 0
    print(f"best val loss {res.best_val_loss:.6f} at epoch "
          f"{res.best_epoch + 1}; {res.steps_per_sec:.2f} steps/sec")
    if args.plot:
        from .plots import plot_loss_curves
        plot_loss_curves(res.train_history, res.val_history,
                         path=str(Path(cfg.train.checkpoint_dir)
                                  / "loss_curves.png"))
    return 0


def cmd_sample(args) -> int:
    from . import data as data_lib
    from .diffusion import schedule_from_config
    from .parallel.mesh import is_writer
    from .sample import posterior_over_dataset
    from .train import load_best_model
    from .transforms import inverse_transform
    cfg = _load_cfg(args, adopt_checkpoint=True)
    if args.ema:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, ema_decay=0.999))
    if not args.checkpoint_dir and not args.torch_checkpoint:
        raise SystemExit(
            "one of --checkpoint-dir / --torch-checkpoint is required")
    if args.torch_checkpoint:
        # the reference's .pth state dict: the trained weights carried
        # over, the scalers refit from the data arrays as the reference's
        # own inference cells do
        if args.ema:
            raise SystemExit("--ema has no meaning for --torch-checkpoint")
        if cfg.model.name != "refmlp":
            raise SystemExit("--torch-checkpoint maps onto the reference "
                             "architecture: use --model refmlp")
    mesh = _mesh(args)
    sim_param = np.load(args.params)
    ert = np.load(args.ert)
    gen, dev = _generator(args, cfg, mesh)
    if args.torch_checkpoint:
        from .compat import load_reference_model
        model, _ = load_reference_model(args.torch_checkpoint, cfg.model,
                                        dev)
        scalers = {}
    else:
        state, meta, scalers = load_best_model(args.checkpoint_dir, cfg,
                                               device=dev)
        if args.ema:
            _use_ema(state)
        model = state.model
    ds = data_lib.prepare_dataset(sim_param, ert,
                                  param_scaler=scalers.get("param_scaler"),
                                  ert_scaler=scalers.get("ert_scaler"))
    _, _, test_idx = data_lib.split_dataset(len(ds), _split_seed(args, cfg),
                                            cfg.train.split)
    sch = schedule_from_config(cfg.diffusion)
    scfg = _sampler_overrides(args, cfg.sample)
    pred, mask = posterior_over_dataset(
        model.eval(), ds.conditions[test_idx], sch, ds.param_scaler,
        n_realizations=args.realizations, batch_size=cfg.train.batch_size,
        scfg=scfg, a=ds.a, b=ds.b, generator=gen, device=dev, mesh=mesh)
    if not is_writer():
        return 0
    np.save(args.out, pred)
    np.save(Path(args.out).with_name("valid_mask.npy"), mask)
    # true params for UQ comparison
    true = ds.param_scaler.inverse(
        inverse_transform(ds.params_u[test_idx].astype(np.float64),
                          ds.a, ds.b))
    np.save(Path(args.out).with_name("true_params.npy"), true)
    print(f"wrote {args.out} {pred.shape}; valid fraction "
          f"{mask.mean():.3f}")
    return 0


def _parse_temperature(s: str):
    """'1.5' -> 1.5 (global); '1.5,2.0,...' -> tuple (per-parameter)."""
    parts = [p for p in str(s).split(",") if p]
    if len(parts) == 1:
        return float(parts[0])
    return tuple(float(p) for p in parts)


def cmd_calibrate(args) -> int:
    """Pick the sampler temperature on the VALIDATION split (never test)."""
    from . import data as data_lib
    from .calibrate import calibrate_temperature
    from .diffusion import schedule_from_config
    from .train import load_best_model
    from .transforms import inverse_transform
    cfg = _load_cfg(args, adopt_checkpoint=True)
    sim_param = np.load(args.params)
    ert = np.load(args.ert)
    gen, dev = _generator(args, cfg)
    state, _, scalers = load_best_model(args.checkpoint_dir, cfg, device=dev)
    ds = data_lib.prepare_dataset(sim_param, ert,
                                  param_scaler=scalers.get("param_scaler"),
                                  ert_scaler=scalers.get("ert_scaler"))
    _, val_idx, _ = data_lib.split_dataset(len(ds), _split_seed(args, cfg),
                                           cfg.train.split)
    sch = schedule_from_config(cfg.diffusion)
    true_phys = ds.param_scaler.inverse(
        inverse_transform(ds.params_u[val_idx].astype(np.float64),
                          ds.a, ds.b))
    if args.ema:
        # calibrate on the SAME weights sample-time will use
        _use_ema(state)
    model = state.model.eval()
    scfg = _sampler_overrides(args, cfg.sample)
    temps = [float(t) for t in args.temps.split(",") if t]
    common = dict(temperatures=temps, objective=args.objective,
                  n_realizations=args.realizations,
                  batch_size=cfg.train.batch_size, scfg=scfg, a=ds.a,
                  b=ds.b, generator=gen, device=dev)
    if args.guidance_grid:
        if args.guidance is not None:
            raise SystemExit("--guidance fixes one scale; it cannot be "
                             "combined with --guidance-grid")
        if args.per_parameter:
            raise SystemExit("--per-parameter refines the temperature "
                             "sweep; run it with a FIXED --guidance, not "
                             "--guidance-grid (pick g first)")
        from .calibrate import calibrate_guidance
        (best_g, best_t), records = calibrate_guidance(
            model, ds.conditions[val_idx], true_phys, sch, ds.param_scaler,
            guidance_scales=[float(g) for g in
                             args.guidance_grid.split(",") if g],
            **common)
        result = {"best_guidance": best_g, "best_temperature": best_t,
                  "objective": args.objective, "records": records}
    else:
        best, records = calibrate_temperature(
            model, ds.conditions[val_idx], true_phys, sch, ds.param_scaler,
            per_parameter=args.per_parameter,
            per_parameter_target=args.pp_target,
            per_parameter_tol=args.pp_tol, **common)
        best_out = list(best) if isinstance(best, tuple) else best
        result = {"best_temperature": best_out,
                  "objective": args.objective, "records": records}
    print(json.dumps(result, indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps(result))
        print(f"wrote {args.out}")
    if args.commit:
        # make the pick deployable: the winning sampling config goes into
        # the checkpoint's config echo, so sample/serve use it with no
        # sampling flags
        from .utils.checkpoint import commit_sample_config
        if args.guidance_grid:
            winning = dataclasses.replace(scfg, temperature=best_t,
                                          guidance_scale=best_g)
            if best_g == 1.0:
                # an unguided winner with an interval would be refused
                winning = dataclasses.replace(
                    winning, guidance_interval=(0.0, 1.0))
        else:
            winning = dataclasses.replace(
                scfg, temperature=(tuple(best_out)
                                   if isinstance(best_out, list)
                                   else float(best_out)))
        audit = {"objective": args.objective, "temps": temps,
                 "realizations": args.realizations,
                 "ema": bool(args.ema),
                 "result": {k: v for k, v in result.items()
                            if k != "records"}}
        if args.guidance_grid:
            audit["guidance_grid"] = [
                float(g) for g in args.guidance_grid.split(",") if g]
        paths = commit_sample_config(args.checkpoint_dir,
                                     dataclasses.asdict(winning),
                                     calibration=audit)
        print(f"committed calibrated sample config into "
              f"{', '.join(str(p) for p in paths)}")
    return 0


def cmd_distill(args) -> int:
    """Progressively distill a trained checkpoint to few-step sampling."""
    from . import data as data_lib
    from .distill import DistillConfig, distill
    from .parallel.mesh import is_writer
    from .utils.checkpoint import load_scalers
    from .utils.logging import MetricsLogger
    cfg = _load_cfg(args, adopt_checkpoint=True)
    mesh = _mesh(args)
    sim_param = np.load(args.params)
    ert = np.load(args.ert)
    # scalers only; the teacher itself is restored inside distill()
    scalers = load_scalers(Path(args.checkpoint_dir) / "best")
    ds = data_lib.prepare_dataset(sim_param, ert,
                                  param_scaler=scalers.get("param_scaler"),
                                  ert_scaler=scalers.get("ert_scaler"))
    dcfg = DistillConfig(
        target_steps=args.target_steps, start_steps=args.start_steps,
        epochs_per_stage=args.epochs_per_stage,
        convert_epochs=args.convert_epochs, lr=args.lr,
        cosine_lr=not args.constant_lr, batch_size=args.batch_size,
        seed=args.seed, use_ema_teacher=args.ema,
        guidance_scale=args.guidance)
    logger = MetricsLogger(args.log_file, echo=True) if is_writer() else None
    res = distill(cfg, dcfg, ds, teacher_dir=args.checkpoint_dir,
                  out_dir=args.out_dir, logger=logger, device=args.device,
                  mesh=mesh)
    if not is_writer():
        return 0
    for s in res.stages:
        print(f"stage {s.kind}@{s.student_steps}: "
              f"loss {s.losses[0]:.5f} -> {s.losses[-1]:.5f} "
              f"(val {s.val_losses[-1]:.5f}) in {s.seconds:.1f}s")
    print(f"student ({res.target_steps}-step pd sampler) saved under "
          f"{args.out_dir}; sample with: python -m ertdx_torch.cli sample "
          f"--checkpoint-dir {args.out_dir}")
    return 0


def cmd_metrics(args) -> int:
    from .metrics import (crps_ensemble, per_parameter_uq, sbc_ranks,
                          sbc_uniformity, uq_scores)
    from .utils.logging import write_csv
    pred = np.load(args.pred)
    true = np.load(args.true)
    joint = uq_scores(pred, true)
    out = {k: float(v) for k, v in joint.items()
           if np.isscalar(v) or getattr(v, "ndim", 1) == 0}
    # proper-score + calibration diagnostics: range-normalized CRPS and
    # SBC rank uniformity
    span = true.max(axis=0) - true.min(axis=0) + 1e-12
    out["crps_mean_normalized"] = float(
        (crps_ensemble(pred, true) / span).mean())
    out["sbc_ks_mean"] = float(np.mean(sbc_uniformity(
        sbc_ranks(pred, true), pred.shape[0])))
    print(json.dumps(out, indent=2))
    rows = per_parameter_uq(pred, true)
    write_csv(args.out, rows)
    print(f"wrote {args.out}")
    if args.plots_dir:
        # joint + per-parameter coverage figures (the reference's loop,
        # ERT_Conditional_Diffusion.py:1139-1262)
        from .params import ParameterSpace
        from .plots import plot_coverage
        out = Path(args.plots_dir)
        plot_coverage(pred.reshape(pred.shape[0], -1), true.reshape(-1),
                      path=str(out / "coverage_joint.png"))
        names = ParameterSpace().names
        for j in range(pred.shape[-1]):
            plot_coverage(pred[..., j], true[..., j],
                          title=names[j] if j < len(names) else f"p{j}",
                          path=str(out / f"coverage_param_{j:02d}.png"))
        print(f"coverage figures under {out}")
    return 0


def cmd_plot(args) -> int:
    from .metrics import ensemble_statistics, wsse_per_simulation
    sim = np.load(args.sim)
    cond = np.load(args.conditional)
    out = Path(args.out_dir)
    # the statistics first (the KDE mode on --device), then the figures
    stats = ensemble_statistics(sim, cond, device=args.device)
    wsse = wsse_per_simulation(sim, cond)
    from . import plots
    plots.plot_ensemble_grid(stats, cond, path=str(out / "ensemble_grid.png"))
    plots.plot_wsse_per_survey(wsse, path=str(out / "wsse.png"))
    plots.plot_best_sim_panels(sim, cond, wsse.sum(axis=1),
                               path=str(out / "best_sims.png"))
    plots.plot_estimate_vs_conditional(stats["mean"], cond, "Ensemble Mean",
                                       path=str(out / "mean_vs_cond.png"))
    plots.plot_estimate_vs_conditional(stats["mode"], cond, "Ensemble Mode",
                                       path=str(out / "mode_vs_cond.png"))
    plots.plot_mse_distribution(sim, cond,
                                path=str(out / "mse_distribution.png"))
    print(f"figures under {out}")
    return 0


def cmd_serve(args) -> int:
    from .serve import PosteriorService, serve
    cfg = _load_cfg(args, adopt_checkpoint=True)
    if args.torch_checkpoint:
        if not (args.params and args.ert):
            raise SystemExit("--torch-checkpoint needs --params/--ert "
                             "(scalers are refit from the training data, "
                             "as the reference's inference cells do)")
        svc = PosteriorService.from_torch(
            args.torch_checkpoint, cfg, np.load(args.params),
            np.load(args.ert), max_batch=args.max_batch, device=args.device)
    elif not args.checkpoint_dir:
        raise SystemExit(
            "one of --checkpoint-dir / --torch-checkpoint is required")
    else:
        svc = PosteriorService(args.checkpoint_dir, cfg,
                               max_batch=args.max_batch, device=args.device)
    if args.warmup:
        print("warming up the serving path...", flush=True)
        svc.warmup(n_realizations=args.realizations, scfg=cfg.sample)
    serve(svc, host=args.host, port=args.port)
    return 0


def cmd_bench(args) -> int:
    raise SystemExit(
        "bench runs bench.py, which measures the JAX package; the port "
        "has no benchmark harness yet (no BENCHMARK.json: that is the "
        "benchmark work, not a queue 1 item)")


def _device_flag(parser) -> None:
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the command runs (cpu: the plain "
                             "PyTorch versions of the kernels)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ertdiff", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate-design", help="LHS/Sobol parameter design")
    g.add_argument("--n", type=int, default=5000)
    g.add_argument("--method", choices=["lhs", "sobol"], default="sobol")
    g.add_argument("--seed", type=int, default=None)
    g.add_argument("--out", default="sim_param_design.npy")
    g.add_argument("--diagnostics", action="store_true")
    g.set_defaults(fn=cmd_generate_design)

    gs = sub.add_parser("generate-synthetic",
                        help="synthetic Gaussian resistivity fields "
                             "(configs[1])")
    gs.add_argument("--n", type=int, default=2048)
    gs.add_argument("--grid", type=int, default=16)
    gs.add_argument("--length-scale", type=float, default=0.25)
    gs.add_argument("--seed", type=int, default=0)
    gs.add_argument("--out", default="synthetic_fields.npy")
    gs.set_defaults(fn=cmd_generate_synthetic)

    s = sub.add_parser("simulate", help="run PFLOTRAN forward simulations")
    s.add_argument("--template", required=True)
    s.add_argument("--params", required=True)
    s.add_argument("--prefix", default="ertdx_run")
    s.add_argument("--pflotran", default="pflotran")
    s.add_argument("--workdir", default=".")
    s.add_argument("--results-dir", default=None)
    s.add_argument("--mode", choices=["lines", "keywords"], default="lines")
    s.add_argument("--timeout", type=float, default=3600)
    s.add_argument("--concurrency", type=int, default=6)
    s.add_argument("--max-retries", type=int, default=None)
    s.add_argument("--surveys", type=int, default=14)
    s.add_argument("--measurements", type=int, default=4693)
    s.add_argument("--srv-skip-header", type=int, default=259,
                   help=".srv header lines (this varies across setups)")
    s.add_argument("--srv-usecols", type=int, default=5)
    s.add_argument("--no-mpi", action="store_true")
    s.set_defaults(fn=cmd_simulate)

    gd = sub.add_parser("gather-data", help="re-ingest simulation outputs")
    gd.add_argument("--results-dir", required=True)
    gd.add_argument("--n", type=int, required=True)
    gd.add_argument("--surveys", type=int, default=14)
    gd.add_argument("--out-ert", default="sim_ert.npy")
    gd.add_argument("--out-params", default="sim_param.npy")
    gd.set_defaults(fn=cmd_gather_data)

    t = sub.add_parser("train", help="train the conditional denoiser")
    t.add_argument("--params", required=True)
    t.add_argument("--ert", required=True)
    t.add_argument("--preset", default="ref_default")
    t.add_argument("--model", choices=["refmlp", "condunet"], default=None)
    t.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help="condunet compute dtype (params stay float32)")
    t.add_argument("--lr-schedule", choices=["constant", "cosine"],
                   default=None,
                   help="constant = reference semantics; cosine = "
                        "warmup + cosine decay over the step budget")
    t.add_argument("--warmup-steps", type=int, default=None)
    t.add_argument("--loss-weighting", choices=["none", "min_snr"],
                   default=None,
                   help="train-loss timestep weighting (min-SNR-gamma, "
                        "arXiv:2303.09556); val loss stays unweighted")
    t.add_argument("--snr-gamma", type=float, default=None,
                   help="gamma clamp for --loss-weighting min_snr")
    t.add_argument("--beta-schedule", choices=["linear", "cosine"],
                   default=None,
                   help="noising schedule: linear (reference) or "
                        "squared-cosine alpha_bar (arXiv:2102.09672); "
                        "travels in the checkpoint config echo")
    t.add_argument("--uncond-prob", type=float, default=None,
                   help="classifier-free-guidance condition dropout "
                        "(enables `sample --guidance`)")
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--seed", type=int, default=None)
    t.add_argument("--split-seed", type=int, default=None,
                   dest="split_seed",
                   help="pin the train/val/test split independently of "
                        "--seed (deep-ensemble members: same split, "
                        "different training stochasticity)")
    t.add_argument("--checkpoint-dir", default=None)
    t.add_argument("--mesh-data", type=int, default=0)
    t.add_argument("--log-file", default=None)
    t.add_argument("--plot", action="store_true")
    t.add_argument("--resume", action="store_true",
                   help="continue from <checkpoint-dir>/last")
    t.add_argument("--save-every", type=int, default=None,
                   help="write a resumable checkpoint every N epochs")
    t.add_argument("--ema-decay", type=float, default=None,
                   help="EMA of params for sampling (e.g. 0.999; 0 = off)")
    t.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="capture a torch.profiler trace to LOGDIR")
    _device_flag(t)
    t.set_defaults(fn=cmd_train)

    sa = sub.add_parser("sample", help="posterior ensemble over the test set")
    sa.add_argument("--params", required=True)
    sa.add_argument("--ert", required=True)
    sa.add_argument("--checkpoint-dir", default=None)
    sa.add_argument("--torch-checkpoint", default=None,
                    help="reference .pth state dict")
    sa.add_argument("--preset", default="ref_default")
    sa.add_argument("--model", choices=["refmlp", "condunet"], default=None)
    sa.add_argument("--realizations", type=int, default=50)
    sa.add_argument("--seed", type=int, default=None)
    sa.add_argument("--mesh-data", type=int, default=0)
    sa.add_argument("--ema", action="store_true",
                    help="sample with the EMA parameters from the checkpoint")
    sa.add_argument("--sampler", choices=["ancestral", "ddim", "dpmpp", "pd"],
                    default=None, help="override the preset's sampler")
    sa.add_argument("--steps", type=int, default=None,
                    help="subsequence step budget for ddim/dpmpp/pd")
    sa.add_argument("--eta", type=float, default=None,
                    help="DDIM eta (0 = deterministic ODE)")
    sa.add_argument("--temperature", type=str, default=None,
                    help="noise tempering (per-step for ancestral/ddim "
                         "eta>0; prior for dpmpp/pd): one value, or a "
                         "comma list of param_dim values for "
                         "per-parameter tempering")
    sa.add_argument("--guidance", type=float, default=None,
                    help="classifier-free guidance scale (needs a model "
                         "trained with --uncond-prob > 0)")
    sa.add_argument("--guidance-interval", default=None,
                    dest="guidance_interval",
                    help="lo,hi chain fractions: guide only at "
                         "lo*T <= t < hi*T (1x denoiser cost outside)")
    sa.add_argument("--uncond-prob", type=float, default=None,
                    help="the checkpoint's training value (builds the "
                         "matching restore template)")
    sa.add_argument("--out", default="Uncertainty_params.npy")
    _device_flag(sa)
    sa.set_defaults(fn=cmd_sample)

    ca = sub.add_parser("calibrate",
                        help="pick sampler temperature on the val split")
    ca.add_argument("--params", required=True)
    ca.add_argument("--ert", required=True)
    ca.add_argument("--checkpoint-dir", required=True)
    ca.add_argument("--preset", default="ref_default")
    ca.add_argument("--model", choices=["refmlp", "condunet"], default=None)
    ca.add_argument("--temps", default="1.0,1.25,1.5,2.0,3.0")
    ca.add_argument("--objective", default="goodness",
                    choices=["goodness", "accuracy", "precision"])
    ca.add_argument("--per-parameter", action="store_true",
                    dest="per_parameter",
                    help="pick a PER-PARAMETER temperature vector from "
                         "the same sweep (zero extra sampling) + one "
                         "verification arm")
    ca.add_argument("--pp-target", type=float, default=None,
                    dest="pp_target",
                    help="per-parameter threshold rule: lowest grid T "
                         "reaching this objective value per parameter "
                         "(e.g. a 0.95 coverage target)")
    ca.add_argument("--pp-tol", type=float, default=0.0, dest="pp_tol",
                    help="per-parameter tolerance below each "
                         "parameter's max (lowest T within tol)")
    ca.add_argument("--sampler", choices=["ancestral", "ddim", "dpmpp", "pd"],
                    default=None)
    ca.add_argument("--steps", type=int, default=None,
                    help="subsequence sampler step budget (as at sample "
                         "time)")
    ca.add_argument("--eta", type=float, default=None)
    ca.add_argument("--guidance", type=float, default=None,
                    help="CFG scale to calibrate under")
    ca.add_argument("--guidance-interval", default=None,
                    dest="guidance_interval",
                    help="lo,hi chain fractions: guide only at "
                         "lo*T <= t < hi*T (as at sample time)")
    ca.add_argument("--guidance-grid", default=None,
                    help="comma list of CFG scales: jointly calibrate "
                         "(guidance, temperature) on the val split "
                         "(needs uncond_prob > 0; excludes --guidance)")
    ca.add_argument("--ema", action="store_true",
                    help="calibrate on the EMA weights (as sampled)")
    ca.add_argument("--realizations", type=int, default=50)
    ca.add_argument("--uncond-prob", type=float, default=None,
                    help="the checkpoint's training value (restore "
                         "template)")
    ca.add_argument("--seed", type=int, default=None)
    ca.add_argument("--out", default=None)
    ca.add_argument("--commit", action="store_true",
                    help="persist the winning (temperature, guidance, "
                         "sampler) into the checkpoint's config echo so "
                         "sample/serve deploy it with zero flags")
    _device_flag(ca)
    ca.set_defaults(fn=cmd_calibrate)

    di = sub.add_parser("distill",
                        help="progressive distillation to a few-step "
                             "pd-sampler student (Salimans & Ho 2022)")
    di.add_argument("--params", required=True)
    di.add_argument("--ert", required=True)
    di.add_argument("--checkpoint-dir", required=True,
                    help="the trained teacher checkpoint")
    di.add_argument("--out-dir", required=True,
                    help="where the student checkpoint lands")
    di.add_argument("--preset", default="ref_default")
    di.add_argument("--model", choices=["refmlp", "condunet"], default=None)
    di.add_argument("--target-steps", type=int, default=4)
    di.add_argument("--start-steps", type=int, default=64,
                    help="first teacher grid (target * 2**k; clamped to T)")
    di.add_argument("--epochs-per-stage", type=int, default=60)
    di.add_argument("--convert-epochs", type=int, default=40,
                    help="same-grid eps->v conversion stage (skipped for "
                         "v teachers)")
    di.add_argument("--lr", type=float, default=1e-4)
    di.add_argument("--constant-lr", action="store_true",
                    help="constant per-stage lr instead of cosine-to-0")
    di.add_argument("--batch-size", type=int, default=32)
    di.add_argument("--seed", type=int, default=42)
    di.add_argument("--ema", action="store_true",
                    help="distill from the teacher's EMA weights")
    di.add_argument("--guidance", type=float, default=1.0,
                    help="guided distillation: bake this CFG scale into "
                         "the student (teacher must be CFG-trained); the "
                         "student then samples unguided at 1x cost")
    di.add_argument("--mesh-data", type=int, default=0)
    di.add_argument("--log-file", default=None)
    _device_flag(di)
    di.set_defaults(fn=cmd_distill)

    m = sub.add_parser("metrics", help="UQ accuracy/precision/goodness")
    m.add_argument("--pred", required=True)
    m.add_argument("--true", required=True)
    m.add_argument("--out", default="Parameter_uncertainty_metrics.csv")
    m.add_argument("--plots-dir", default=None,
                   help="also write the joint + per-parameter coverage "
                        "figures here")
    m.set_defaults(fn=cmd_metrics)

    pl = sub.add_parser("plot", help="ensemble figures")
    pl.add_argument("--sim", required=True)
    pl.add_argument("--conditional", required=True)
    pl.add_argument("--out-dir", default="figures")
    _device_flag(pl)
    pl.set_defaults(fn=cmd_plot)

    sv = sub.add_parser("serve", help="posterior-inversion HTTP service "
                                      "over a checkpoint")
    sv.add_argument("--checkpoint-dir", default=None)
    sv.add_argument("--torch-checkpoint", default=None,
                    help="serve a reference .pth state dict")
    sv.add_argument("--params", default=None)
    sv.add_argument("--ert", default=None)
    sv.add_argument("--preset", default="ref_default")
    sv.add_argument("--model", choices=["refmlp", "condunet"], default=None)
    sv.add_argument("--cond-length", type=int, default=None)
    sv.add_argument("--cond-channels", type=int, default=None)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8337)
    sv.add_argument("--max-batch", type=int, default=8)
    sv.add_argument("--realizations", type=int, default=50)
    sv.add_argument("--warmup", action="store_true",
                    help="run one request before listening")
    _device_flag(sv)
    sv.set_defaults(fn=cmd_serve)

    b = sub.add_parser("bench", help="the JAX package's benchmark harness "
                                     "(not run by the port)")
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    import torch.distributed as dist
    args = build_parser().parse_args(argv)
    started = dist.is_initialized()
    try:
        return args.fn(args)
    finally:
        if dist.is_initialized() and not started:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
