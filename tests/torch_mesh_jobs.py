"""The jobs a rank of tests/torch_mesh_worker.py runs (torch only).

Each job takes a `Ctx` (rank, world size, the directory the test module
and the ranks share), reads what the test module wrote there with
`ctx.load(name)` and writes its results with `ctx.save(name, obj)` under
`<name>.r<rank>.pkl`. The test modules compare them with JAX's results
(computed in the pytest process, on conftest's 8 fake devices) or with
the port's single-process results, which the jobs compute beside the
mesh run from the same inputs. Nothing here imports jax or ertdx.
"""
from __future__ import annotations

import copy
import dataclasses
import pickle
from pathlib import Path

import numpy as np
import torch

from ertdx_torch import configs, data, diffusion, sample, train
from ertdx_torch.models import build_model
from ertdx_torch.models import condunet as cu
from ertdx_torch.models.condunet import CondUNet
from ertdx_torch.parallel import (global_batch, make_mesh, replicate_tree,
                                  shard_batch, tp_shard_params)
from ertdx_torch.utils.weights import params_from_jax, params_to_jax

_KNOBS = ("attn_slab", "parameterization", "uncond_prob", "ensemble_pallas",
          "ensemble_min_chains", "pallas_gn", "pallas_conv",
          "pallas_conv_min_width", "use_pallas", "flash_min_logits")


class Ctx:
    def __init__(self, rank: int, world: int, path: Path):
        self.rank, self.world, self.path = rank, world, Path(path)

    def load(self, name: str):
        with open(self.path / f"{name}.pkl", "rb") as f:
            return pickle.load(f)

    def save(self, name: str, obj) -> None:
        with open(self.path / f"{name}.r{self.rank}.pkl", "wb") as f:
            pickle.dump(obj, f)


def t32(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def condunet(args: dict, tree=None) -> CondUNet:
    """The port half of tests/torch_parity_common.py::make_pair for the
    same arguments, loaded with `tree` (a flax tree) when given, else
    initialised as flax does from seed 0 (alike on every rank)."""
    a = dict(p=29, d=32, cond_channels=4, base_width=16, depth=2,
             num_heads=2, num_blocks=2, dtype="float32")
    a.update({k: v for k, v in args.items()
              if k not in ("seed", "scale", "cond_len")})
    knobs = {k: a.pop(k) for k in list(a) if k in _KNOBS}
    model = CondUNet(param_dim=a["p"], hidden_dim=a["d"],
                     cond_channels=a["cond_channels"],
                     base_width=a["base_width"], depth=a["depth"],
                     num_heads=a["num_heads"], core_heads=1,
                     num_blocks=a["num_blocks"], dtype=a["dtype"], **knobs)
    if tree is not None:
        params_from_jax(model, tree)
    else:
        cu.init_params(model, torch.Generator().manual_seed(0))
    return model


def perturbed(model, seed: int, scale: float = 0.05):
    """Every parameter plus scale * N(0, 1) from a seeded generator, so
    that every leaf carries gradient."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen))
    return model


def numpy_params(model) -> dict:
    return {n: p.detach().numpy().copy() for n, p in
            model.named_parameters()}


def cpu_mesh(**kw):
    return make_mesh(device="cpu", **kw)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------

def parallel_world(ctx):
    """make_mesh in a 2-rank world, its messages, global_batch,
    replicate_tree, shard_batch and batch_iterator."""
    out = {}
    dp = cpu_mesh(data=2)
    out["dp"] = (dict(dp.shape), dp.data_index, dp.model_index,
                 dp.rows(8), dp.rows(7))
    tp = cpu_mesh(data=1, model=2)
    out["tp"] = (dict(tp.shape), tp.data_index, tp.model_index, tp.rows(8))
    out["default"] = dict(cpu_mesh().shape)
    errors = {}
    for key, kw in (("data4", dict(data=4)), ("model3", dict(model=3)),
                    ("data1_model3", dict(data=1, model=3))):
        try:
            cpu_mesh(**kw)
        except ValueError as exc:
            errors[key] = str(exc)
    out["errors"] = errors
    local = np.arange(6, dtype=np.float32).reshape(3, 2) + 100 * ctx.rank
    out["global"] = global_batch(dp, local).numpy()
    try:
        global_batch(dp, np.zeros((3 - ctx.rank, 2), np.float32))
    except ValueError as exc:
        out["uneven"] = str(exc)
    tree = {"a": torch.full((3,), float(ctx.rank)),
            "b": [np.full(2, ctx.rank, np.float32)]}
    rep = replicate_tree(dp, tree)
    layer = torch.nn.Linear(2, 3)
    with torch.no_grad():
        layer.weight.fill_(ctx.rank + 1.0)
    replicate_tree(dp, layer)
    out["replicated"] = (rep["a"].numpy(), rep["b"][0],
                         layer.weight.detach().numpy())
    out["shard"] = shard_batch(dp, torch.arange(8)).numpy()
    x0 = np.arange(10, dtype=np.float32)[:, None]
    out["batches"] = [b[0][:, 0] for b in data.batch_iterator(
        x0, x0, 4, shuffle=False, mesh=dp)]
    ctx.save("parallel", out)


# ---------------------------------------------------------------------------
# tests/test_torch_dp_train.py
# ---------------------------------------------------------------------------

def dp_step_jax(ctx):
    """One DP train_step from JAX's init and draws, on refmlp."""
    inp = ctx.load("dp_step_jax")
    model = build_model(dataclasses.replace(configs.ModelConfig(),
                                            **inp["model"]), "cpu")
    params_from_jax(model, inp["tree"])
    alpha_bar = diffusion.get_diffusion_schedule(inp["T"]).alpha_bar
    opt = train.create_optimizer(model, inp["lr"])
    loss = train.train_step(model, opt, t32(inp["x0"]), t32(inp["cond"]),
                            torch.from_numpy(inp["t"]).long(),
                            t32(inp["noise"]), t32(inp["w"]),
                            alpha_bar=alpha_bar, lr=inp["lr"],
                            mesh=cpu_mesh(data=2))
    ctx.save("dp_step_jax", {"loss": float(loss),
                             "params": params_to_jax(model)})


def _steps(model, batches, mesh, cfg, ema):
    opt = train.create_optimizer(model, 1e-3)
    alpha_bar = diffusion.get_diffusion_schedule(20).alpha_bar
    gen = torch.Generator().manual_seed(17)
    losses = []
    for x0, cond, w in batches:
        losses.append(float(train.train_step(
            model, opt, x0, cond, None, None, w, alpha_bar=alpha_bar,
            lr=1e-3, generator=gen, parameterization=cfg.parameterization,
            loss_weighting="min_snr", snr_gamma=4.0, ema=ema,
            ema_decay=0.9, mesh=mesh)))
    return losses


def dp_step_port(ctx):
    """Three train steps drawing t, eps and the drop mask from a
    generator (v target, min-SNR, a padded w, CFG dropout, EMA), on a
    2-way mesh and in one process: batches of 8 (sharded) and one of 7
    (replicated)."""
    cfg = dataclasses.replace(
        configs.ModelConfig(), name="condunet", hidden_dim=32,
        cond_length=96, cond_channels=4, base_width=16, depth=2,
        num_heads=2, num_blocks=2, attn_slab=True, uncond_prob=0.3,
        parameterization="v")
    single = perturbed(build_model(cfg, "cpu", torch.Generator()
                                   .manual_seed(3)), 4)
    meshed = copy.deepcopy(single)
    rng = np.random.default_rng(5)
    batches = []
    for b, live in ((8, 6), (8, 8), (7, 7)):
        w = np.zeros(b, np.float32)
        w[:live] = 1.0
        batches.append((t32(rng.normal(size=(b, 29))),
                        t32(rng.uniform(size=(b, 96, 4))), t32(w)))
    ema_s = {n: p.detach().clone() for n, p in single.named_parameters()}
    ema_m = copy.deepcopy(ema_s)
    ls = _steps(single, batches, None, cfg, ema_s)
    lm = _steps(meshed, batches, cpu_mesh(data=2), cfg, ema_m)
    ctx.save("dp_step_port", {
        "single": ls, "mesh": lm, "params_single": numpy_params(single),
        "params_mesh": numpy_params(meshed),
        "grads_single": {n: p.grad.numpy() for n, p in
                         single.named_parameters()},
        "ema_single": {n: v.numpy() for n, v in ema_s.items()},
        "ema_mesh": {n: v.numpy() for n, v in ema_m.items()}})


def _dataset(n: int, cond_len: int = 96, channels: int = 4, seed: int = 1):
    from ertdx_torch.doe import SurrogateDataGenerator
    p = SurrogateDataGenerator(seed=seed).generate_training_samples(
        n, "lhs")
    ert = np.random.default_rng(seed).normal(50.0, 10.0,
                                             size=(n, cond_len, channels))
    return data.prepare_dataset(p[..., None], ert)


def dp_train(ctx):
    """train(mesh=) for 2 epochs against train() in one process; only
    rank 0 writes the checkpoints."""
    inp = ctx.load("dp_train")
    cfg = configs.experiment_from_dict(inp["cfg"])
    ds = _dataset(inp["n"])
    writes = []
    save = train.ckpt_lib.save_checkpoint
    train.ckpt_lib.save_checkpoint = lambda *a, **k: (writes.append(a[0]),
                                                      save(*a, **k))
    try:
        res = train.train(cfg, ds, checkpoint_dir=inp["dir"], device="cpu",
                          mesh=cpu_mesh(data=2))
    finally:
        train.ckpt_lib.save_checkpoint = save
    ref = train.train(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir="")), ds, device="cpu")
    out = {"mesh": (res.train_history, res.val_history),
           "single": (ref.train_history, ref.val_history),
           "writes": [str(w) for w in writes],
           "steps": res.state.step}
    state, _, _ = train.load_best_model(inp["dir"], cfg, device="cpu")
    out["best"] = params_to_jax(state.model)
    ctx.save("dp_train", out)


# ---------------------------------------------------------------------------
# tests/test_torch_dp_sample.py
# ---------------------------------------------------------------------------

def _model_of(case):
    if case["kind"] == "refmlp":
        from ertdx_torch.models.refmlp import RefCondMLP
        model = RefCondMLP(**case["args"])
        params_from_jax(model, case["tree"])
        return model
    return condunet(case["args"], case["tree"])


def dp_posterior(ctx):
    """posterior_ensemble(mesh=) on each case (injected global draws, or a
    generator, then also in one process)."""
    mesh = cpu_mesh(data=2)
    out = {}
    for name, case in ctx.load("dp_posterior").items():
        model = _model_of(case).eval()
        sch = diffusion.get_diffusion_schedule(case["T"])
        scfg = configs.SampleConfig(**case["scfg"])
        kw = dict(scfg=scfg, device="cpu")
        if case.get("draws") is not None:
            kw.update({k: t32(v) for k, v in case["draws"].items()})
        got = {}
        for tag, m in (("mesh", mesh), ("single", None)):
            if case.get("draws") is None:
                kw["generator"] = torch.Generator().manual_seed(11)
            calls = {"ensemble": 0, "flash": 0}
            self_attn, flash = cu.block_self_attention, cu.flash_attention

            def count_self(*a, _f=self_attn, **kw):
                calls["ensemble"] += 1
                return _f(*a, **kw)

            def count_flash(*a, _f=flash):
                calls["flash"] += 1
                return _f(*a)

            cu.block_self_attention, cu.flash_attention = \
                count_self, count_flash
            try:
                u = sample.posterior_ensemble(
                    model, t32(case["cond"]), sch, case["R"], mesh=m, **kw)
            finally:
                cu.block_self_attention, cu.flash_attention = \
                    self_attn, flash
            got[tag] = (u.numpy(), dict(calls))
        out[name] = got
    ctx.save("dp_posterior", out)


def dp_over_dataset(ctx):
    """posterior_over_dataset(mesh=) with JAX's per-batch draws."""
    from ertdx_torch.transforms import MinMaxScaler
    inp = ctx.load("dp_over_dataset")
    model = condunet(inp["args"], inp["tree"]).eval()
    scaler = MinMaxScaler.fit(inp["scaler_data"])
    pred, valid = sample.posterior_over_dataset(
        model, t32(inp["conds"]), diffusion.get_diffusion_schedule(
            inp["T"]), scaler, n_realizations=inp["R"],
        batch_size=inp["batch_size"],
        scfg=configs.SampleConfig(**inp["scfg"]),
        draws=[{"x_T": t32(d)} for d in inp["draws"]], device="cpu",
        mesh=cpu_mesh(data=2))
    ctx.save("dp_over_dataset", (pred, valid))


def dp_mega(ctx):
    """mega_denoise_ensemble_sharded (the plain core on the CPU)."""
    from ertdx_torch.models.mega import mega_denoise_ensemble_sharded
    inp = ctx.load("dp_mega")
    model = condunet(inp["args"], inp["tree"]).eval()
    with torch.no_grad():
        ctx_ = model.encode_condition(t32(inp["cond"]))
        out = mega_denoise_ensemble_sharded(
            model, t32(inp["x"]), torch.from_numpy(inp["t"]).long(), ctx_,
            inp["R"], cpu_mesh(data=2), **inp["plan"])
    ctx.save("dp_mega", out.numpy())


def dp_distill(ctx):
    """distill(mesh=) against distill() in one process."""
    from ertdx_torch import distill
    inp = ctx.load("dp_distill")
    ds = _dataset(inp["n"])
    dcfg = distill.DistillConfig(**inp["dcfg"])
    cfg = configs.ExperimentConfig()
    res = distill.distill(cfg, dcfg, ds, teacher_dir=inp["teacher"],
                          out_dir=inp["out"], device="cpu",
                          mesh=cpu_mesh(data=2))
    ref = distill.distill(cfg, dcfg, ds, teacher_dir=inp["teacher"],
                          device="cpu")
    ctx.save("dp_distill", {
        "mesh": [(s.kind, s.losses, s.val_losses) for s in res.stages],
        "single": [(s.kind, s.losses, s.val_losses) for s in ref.stages],
        "params_mesh": numpy_params(res.state.model),
        "params_single": numpy_params(ref.state.model)})


def dp_calibrate(ctx):
    """calibrate_temperature / calibrate_guidance(mesh=) against one
    process, and PosteriorService(mesh=) against one process."""
    from ertdx_torch import calibrate, serve
    inp = ctx.load("dp_calibrate")
    cfg = configs.experiment_from_dict(inp["cfg"])
    state, _, scalers = train.load_best_model(inp["teacher"], cfg,
                                              device="cpu")
    model = state.model.eval()
    sch = diffusion.schedule_from_config(cfg.diffusion)
    scfg = configs.SampleConfig(**inp["scfg"])
    out = {}
    for tag, m in (("mesh", cpu_mesh(data=2)), ("single", None)):
        common = dict(temperatures=(1.0, 1.5), n_realizations=4,
                      batch_size=4, scfg=scfg, device="cpu", mesh=m)
        t_best, t_rec = calibrate.calibrate_temperature(
            model, t32(inp["conds"]), inp["true"], sch,
            scalers["param_scaler"],
            generator=torch.Generator().manual_seed(2), **common)
        g_best, g_rec = calibrate.calibrate_guidance(
            model, t32(inp["conds"]), inp["true"], sch,
            scalers["param_scaler"], guidance_scales=(1.0, 1.5),
            generator=torch.Generator().manual_seed(3), **common)
        svc = serve.PosteriorService(inp["teacher"], cfg, max_batch=4,
                                     mesh=m, device="cpu")
        answer = svc.posterior(inp["ert"], n_realizations=4, scfg=scfg,
                               seed=5, return_draws=True)
        out[tag] = {"temperature": (t_best, t_rec),
                    "guidance": (g_best, g_rec), "serve": answer}
    ctx.save("dp_calibrate", out)


# ---------------------------------------------------------------------------
# tests/test_torch_tp.py
# ---------------------------------------------------------------------------

def tp_step_jax(ctx):
    """JAX's TP test set-up: one step on a data=2 x model=2 mesh from
    JAX's init and draws, min_dim=64."""
    inp = ctx.load("tp_step_jax")
    mesh = cpu_mesh(data=2, model=2)
    model = condunet(inp["args"], inp["tree"])
    tp_shard_params(model, mesh, min_dim=64)
    opt = train.create_optimizer(model, inp["lr"])
    loss = train.train_step(
        model, opt, t32(inp["x0"]), t32(inp["cond"]),
        torch.from_numpy(inp["t"]).long(), t32(inp["noise"]),
        t32(inp["w"]), alpha_bar=diffusion.get_diffusion_schedule(
            inp["T"]).alpha_bar, lr=inp["lr"], mesh=mesh)
    ctx.save("tp_step_jax", {"loss": float(loss),
                             "params": params_to_jax(model),
                             "leaves": sorted(model.tp_leaves)})


def tp_graft(ctx):
    """__graft_entry__'s sequence on a data=2 x model=2 mesh: a DP+TP
    step with CFG dropout from non-zero weights, then a posterior, then a
    guided (1.5) and tempered (1.2) posterior; each against one
    process."""
    inp = ctx.load("tp_graft")
    mesh = cpu_mesh(data=2, model=2)
    single = perturbed(condunet(inp["args"]), 9)
    sharded = tp_shard_params(copy.deepcopy(single), mesh, min_dim=64)
    sch = diffusion.get_diffusion_schedule(inp["T"])
    x0, cond, w = t32(inp["x0"]), t32(inp["cond"]), t32(inp["w"])
    out = {}
    for tag, model, m in (("single", single, None),
                          ("mesh", sharded, mesh)):
        opt = train.create_optimizer(model, 1e-4)
        loss = train.train_step(model, opt, x0, cond, None, None, w,
                                alpha_bar=sch.alpha_bar, lr=1e-4,
                                generator=torch.Generator().manual_seed(1),
                                mesh=m)
        grads = {n: p.grad for n, p in model.named_parameters()}
        from ertdx_torch.utils.weights import named_to_jax
        out[tag] = {"loss": float(loss), "params": params_to_jax(model),
                    "grads": named_to_jax(model, grads)}
    # sampling from the same weights: the single process takes the mesh
    # model's (gathered) parameters
    params_from_jax(single, out["mesh"]["params"])
    for tag, model, m in (("single", single, None),
                          ("mesh", sharded, mesh)):
        model.eval()
        for key, scfg in (("plain", configs.SampleConfig(
                uncertainty_samples=4)), ("guided", configs.SampleConfig(
                    uncertainty_samples=4, guidance_scale=1.5,
                    temperature=1.2))):
            u = sample.posterior_ensemble(
                model, cond, sch, 4, scfg, device="cpu", mesh=m,
                generator=torch.Generator().manual_seed(2))
            out[tag][key] = u.numpy()
    ctx.save("tp_graft", out)
