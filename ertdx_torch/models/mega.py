"""Fused-core ensemble denoiser: CondUNet.denoise_ensemble on the kernels.

A functional twin of `CondUNet.denoise_ensemble` for the posterior-
ensemble reverse chain (ertdx/models/mega.py:43-219), dispatching the
core to the fused CUDA kernels of ops/core_block.py. The cheap parts stay
in plain PyTorch: the time embedding, the per-condition AdaLN rows (six
vectors per block), the per-condition cross K/V (one small product per
block), and, for the per-block variant, lift, out-norm and head.

SHARED-T CONTRACT: the samplers call the denoiser with one t broadcast
over every chain (ertdx_torch/diffusion.py), so the AdaLN rows collapse
to one set per condition; this module reads t[0] and must only be wired
through ertdx_torch.sample.posterior_ensemble, which keeps that contract.

Weights are the model's own, in the JAX kernels' (in, out) layout
(`extract_core_weights`, names as in ertdx/models/mega.py:52-64).

A bfloat16 model takes this path as JAX's does (ertdx/models/mega.py:
82-99, 167-173): only its condition encoder, which runs once a run,
computes in bfloat16; `mega_denoise_ensemble` casts the context and the
chains to float32 once, at entry, and everything after it (the time
MLP, the AdaLN rows, the cross K/V and the fused-core kernels' inputs)
is float32 from the float32 parameters.

The kernels' numeric mode is the model's `ensemble_mega_accurate`, as
in JAX (ertdx/models/mega.py:116-132): False, the default, runs JAX's
one-pass mode (each product one bf16 pass, float32 accumulation), True
JAX's bf16_3x (three bf16 passes a product, hi and lo parts); both on
bf16 wgmma on the card, see ops/core_block.py.

In both modes JAX's gate chooses the function (`mega_route`): where JAX,
evaluated as on its TPU (`tpu_mega_plan`, which reads the mode), plans
its kernels, the port computes their function in the model's mode, on
the CUDA kernels where they take the core's shape and on the mode's plain
version on the card where they do not (warned once per shape); where JAX
plans none, the module path computes the float32 function, as JAX's XLA
path. On the CPU nothing changes: the module path runs.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops._build import route, warn_onepass_plain
from ..ops.core_block import (WEIGHT_KEYS, _ln, fused_core_block,
                              fused_core_stack, kernel_supports, kv_operands,
                              pack_core_weights, pack_core_weights_3x,
                              pick_block_chunk, pick_stack_outer,
                              plain_versions)
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, all_gather_cat,
                             full_param)
from .common import get_timestep_embedding

# Engage the fused-core path only above this TOTAL chain count
# (n_realizations x condition batch). The value is the crossover the JAX
# package measured on a TPU v5e (ertdx/models/mega.py:36-40). On an H100
# `python3 tools/ensemble_ab.py --crossover` measured the fused core
# ahead of the per-block path already at 1024 chains (PERF.md §5); the
# value is kept until that is weighed (ROADMAP.md queue 2 D).
MIN_TOTAL_CHAINS = 4096


def cond_token_len(model, cond_len: int) -> int:
    """Condition tokens the encoder emits for a length-L condition:
    patchify (ceil to patch windows), then depth-1 stride-2 SAME convs."""
    length = -(-cond_len // model.patch)
    for _ in range(model.depth - 1):
        length = -(-length // 2)
    return length


def extract_core_weights(model, i: int) -> dict:
    """Block i's weights as (in, out) matrices, contiguous."""
    blk = model.blocks[i]

    def t(lin):
        return full_param(lin, "weight").detach().t().contiguous()

    return {
        "ada": [(t(a.proj), a.proj.bias.detach())
                for a in (blk.ada1, blk.ada2, blk.ada3)],
        "wqkv": t(blk.qkv),
        "wso": t(blk.self_out), "bso": blk.self_out.bias.detach(),
        "wcq": t(blk.cross_q),
        "wkv": t(blk.cross_kv),
        "wco": t(blk.cross_out), "bco": blk.cross_out.bias.detach(),
        "w1": t(blk.mlp_in), "b1": blk.mlp_in.bias.detach(),
        "w2": t(blk.mlp_out), "b2": blk.mlp_out.bias.detach(),
    }


def mega_weights(model) -> dict:
    """Every weight the fused path reads, gathered once per run (whole,
    where tensor parallelism holds a column shard: the kernels take every
    weight, as GSPMD replicates a pallas_call's operands), with the
    kernels' bf16 copies of the blocks' matrices in the model's mode,
    rounded once a run: the one-pass kernels' ("packed",
    `pack_core_weights`), or for a model in JAX's accurate mode the
    bf16_3x kernels' hi and lo copies ("packed_3x",
    `pack_core_weights_3x`)."""
    blocks = [extract_core_weights(model, i)
              for i in range(model.num_blocks)]
    d = model.hidden_dim
    stack = {key: torch.stack([w[key] for w in blocks])
             for key in WEIGHT_KEYS}
    out = {
        "blocks": blocks,
        "stack": stack,
        "lift_w": full_param(model.lift, "weight").detach().reshape(
            1, d).contiguous(),
        "lift_b": model.lift.bias.detach().reshape(1, d),
        "pos_emb": full_param(model, "pos_emb").detach(),
        "on_scale": model.out_norm.weight.detach().reshape(1, d),
        "on_bias": model.out_norm.bias.detach().reshape(1, d),
        "head_w": model.head.weight.detach().reshape(d, 1).contiguous(),
        "head_b": model.head.bias.detach().reshape(1, 1),
    }
    if getattr(model, "ensemble_mega_accurate", False):
        out["packed_3x"] = pack_core_weights_3x(stack)
    else:
        out["packed"] = pack_core_weights(stack)
    return out


def _local_batch(model, n_real: int, batch: int, mesh) -> Optional[int]:
    """The gate's terms that JAX's and the port's plans share: the
    `ensemble_mega` flag, a single-head core, a mesh whose data axis the
    condition batch divides and whose model axis is 1, and at least
    MIN_TOTAL_CHAINS chains a device. The conditions a device, or None."""
    if not getattr(model, "ensemble_mega", False):
        return None
    if getattr(model, "core_heads", 0) != 1:
        return None
    if mesh is not None:
        n_d = mesh.shape[DATA_AXIS]
        if batch % n_d or mesh.shape[MODEL_AXIS] != 1:
            return None
        batch //= n_d
    if n_real * batch < MIN_TOTAL_CHAINS:
        return None
    return batch


def _lk(model, cond_len: Optional[int]) -> int:
    # an unknown length: two padded lane groups, as JAX assumes
    return cond_token_len(model, cond_len) if cond_len is not None else 256


def tpu_mega_plan(model, n_real: int, batch: int = 1,
                  cond_len: Optional[int] = None,
                  mesh=None) -> Optional[dict]:
    """JAX's `mega_plan` (ertdx/models/mega.py:67-133) as it decides on its
    TPU, without the backend term: {"stack": True, "chunk": tile} where
    its whole-core kernel's VMEM estimate fits, else {"stack": False,
    "chunk": chunk} where the per-block kernel's does, else None (JAX runs
    the module path). The estimates are of a TPU core's VMEM
    (ops/core_block.py::pick_stack_outer, pick_block_chunk); here they say
    which function JAX computes, not what the CUDA kernels take. JAX's
    dtype term reads the port's `compute_dtype` (a port model computes in
    float32 or bfloat16, both of which JAX plans)."""
    if _local_batch(model, n_real, batch, mesh) is None \
            or model.compute_dtype not in (torch.float32, torch.bfloat16) \
            or model.hidden_dim % 128:
        return None
    p, d, nb = model.param_dim, model.hidden_dim, model.num_blocks
    accurate = bool(model.ensemble_mega_accurate)
    lk = _lk(model, cond_len)
    outer = pick_stack_outer(n_real, p, d, nb, lk, accurate)
    if outer:
        return {"stack": True, "chunk": outer}
    chunk = pick_block_chunk(n_real, p, d, lk, accurate)
    return {"stack": False, "chunk": chunk} if chunk else None


def mega_route(model, n_real: int, batch: int = 1,
               cond_len: Optional[int] = None, device=None,
               mesh=None) -> str:
    """Which path the ensemble's core takes: "kernel" (the CUDA kernels),
    "onepass_plain" (the plain version of the model's mode on the card:
    one-pass, or bf16_3x with `ensemble_mega_accurate`) or "float32"
    (the per-block module path, float32 products).

    JAX's gate chooses the function (`tpu_mega_plan`, in the model's mode
    `ensemble_mega_accurate`): where it plans its kernels the port
    computes their function in that mode, JAX's one-pass or bf16_3x, on
    the CUDA kernels where `kernel_supports` takes the core's shape, else
    on the mode's plain version; where it plans none, the module path, as
    JAX's. CPU tensors take the module path."""
    if device is None or _local_batch(model, n_real, batch, mesh) is None:
        return "float32"
    return route(device, False,
                 tpu_mega_plan(model, n_real, batch, cond_len, mesh)
                 is not None,
                 kernel_supports(model.param_dim, model.hidden_dim,
                                 _lk(model, cond_len)))


def mega_plan(model, n_real: int, batch: int = 1,
              cond_len: Optional[int] = None, device=None,
              mesh=None) -> Optional[dict]:
    """The fused-core plan, or None for the plain module path, as
    `mega_route` decides. The plan's variant is JAX's: the one-launch
    stack where JAX plans its stack kernel, one launch per block where
    JAX plans its per-block kernel; "plain": True where the route is
    "onepass_plain" (warned once per shape).
    The kernels tile R themselves, so the chunk is R. With a mesh each
    rank runs the kernel on its own conditions (the batch divides the
    data axis). `accurate` is the model's `ensemble_mega_accurate`: the
    kernels' numeric mode."""
    route = mega_route(model, n_real, batch, cond_len, device, mesh)
    if route == "float32":
        return None
    p, d, nb = model.param_dim, model.hidden_dim, model.num_blocks
    accurate = bool(model.ensemble_mega_accurate)
    stack = tpu_mega_plan(model, n_real, batch, cond_len, mesh)["stack"]
    plan = {"p": p, "d": d, "num_blocks": nb, "chunk": n_real,
            "accurate": accurate, "stack": stack}
    if route != "kernel":
        warn_onepass_plain("fused core", (n_real, p, d, _lk(model, cond_len)),
                           "bf16_3x" if accurate else "one-pass")
        plan["plain"] = True
    return plan


def _cvec_silu(model, t, cond_vec, d):
    """silu(AdaLN conditioning vector) per condition — shared t; float32
    from the float32 parameters whatever the model's dtype, as JAX's."""
    temb = get_timestep_embedding(t[:1], d)
    m1, m2 = model.time_mlp1, model.time_mlp2
    h = F.silu(F.linear(temb, full_param(m1, "weight"), m1.bias))
    return F.silu(F.linear(h, full_param(m2, "weight"), m2.bias) + cond_vec)


def _block_mods(w, sc):
    """(B, 6, D) AdaLN rows for one block."""
    return torch.stack([m for wk, bk in w["ada"]
                        for m in (sc @ wk + bk).chunk(2, dim=-1)], dim=1)


def mega_cross_kv(weights: dict, cond_ctx, *, stack: bool, accurate: bool,
                  operands: bool = True) -> dict:
    """Every block's cross K and V for one context, `cond_tokens @ wkv`,
    which a reverse chain's steps share: made once a run (the sampler
    does so for each context it denoises with) and handed to
    `mega_denoise_ensemble` as `cross`. For the stack (`stack`) K and V
    are (B*nb, Lk, D), block-major within a condition; for the per-block
    kernel a list of (B, Lk, D), one a block. With `operands`, also the
    kernels' operands of them in the mode `accurate` selects
    (`kv_operands`: bf16 copies, or hi and lo parts)."""
    cond_tokens = cond_ctx[0].to(torch.float32)
    kv = [(cond_tokens @ wb["wkv"]).chunk(2, dim=-1)
          for wb in weights["blocks"]]
    if stack:
        bsz, lk, d = cond_tokens.shape[0], cond_tokens.shape[1], \
            kv[0][0].shape[-1]
        k, v = (torch.stack([z[j] for z in kv], dim=1).reshape(
            bsz * len(kv), lk, d) for j in (0, 1))
        ops = kv_operands(k, v, accurate) if operands else None
    else:
        k, v = ([z[j].contiguous() for z in kv] for j in (0, 1))
        ops = ([kv_operands(kb, vb, accurate) for kb, vb in zip(k, v)]
               if operands else None)
    return {"stack": stack, "accurate": accurate, "k": k, "v": v,
            "operands": ops}


def mega_denoise_ensemble(model, x, t, cond_ctx, n_real: int, *, p: int,
                          d: int, num_blocks: int, chunk: int,
                          accurate: bool = False, stack: bool = True,
                          weights: Optional[dict] = None,
                          plain: bool = False,
                          cross: Optional[dict] = None):
    """(B*n_real, P) condition-major chains -> eps_hat on the fused core.

    stack=True runs lift -> all blocks -> head as ONE kernel launch;
    stack=False launches one kernel per block, with lift, out-norm and
    head in plain PyTorch (float32 in both modes). `accurate` selects the
    kernels' mode (False: one bf16 pass a product, JAX's default; True:
    bf16_3x). `weights` (from `mega_weights`) and `cross` (from
    `mega_cross_kv` for this context, this `stack` and this `accurate`)
    save remaking them at every step. `plain` computes the mode's plain
    versions in place of the kernels, on any device (`mega_plan`'s plain
    routes)."""
    w = weights if weights is not None else mega_weights(model)
    # a bfloat16 model hands over a bf16 context: the kernel side computes
    # in float32, so cast once here (ertdx/models/mega.py:167-173)
    cond_tokens, cond_vec = (z.to(torch.float32) for z in cond_ctx)
    if cross is None:
        cross = mega_cross_kv(w, cond_ctx, stack=stack, accurate=accurate,
                              operands=not plain and cond_tokens.is_cuda)
    elif (cross["stack"], cross["accurate"]) != (stack, accurate):
        raise ValueError(f"cross K/V made for stack={cross['stack']}, "
                         f"accurate={cross['accurate']}; the call asks for "
                         f"stack={stack}, accurate={accurate}")
    x = x.to(torch.float32)
    bsz = cond_tokens.shape[0]
    n = x.shape[0]
    n_chunks = n_real // chunk
    sc = _cvec_silu(model, t, cond_vec, d)
    mods = [_block_mods(wb, sc) for wb in w["blocks"]]
    plain_stack, plain_block = plain_versions(accurate)
    packed = w.get("packed_3x" if accurate else "packed")
    ops = cross["operands"]

    if stack:
        args = (x.reshape(bsz * n_chunks, chunk, p).contiguous(),
                torch.cat(mods, dim=1).contiguous(), cross["k"], cross["v"],
                w["stack"], w["lift_w"], w["lift_b"], w["pos_emb"],
                w["on_scale"], w["on_bias"], w["head_w"], w["head_b"])
        if plain:
            out = plain_stack(*args, p=p)
        else:
            out = fused_core_stack(*args, p=p, chunk=chunk,
                                   accurate=accurate, packed=packed, kv=ops)
        return out.reshape(n, p)

    tokens = x[..., None] @ w["lift_w"] + w["lift_b"] + w["pos_emb"][None]
    x3 = tokens.reshape(bsz * n_chunks, chunk * p, d)
    for i, (m, k, v) in enumerate(zip(mods, cross["k"], cross["v"])):
        if plain:
            x3 = plain_block(x3, m, k, v, w["blocks"][i], p=p)
        else:
            x3 = fused_core_block(x3, m.contiguous(), k, v,
                                  w["blocks"][i], p=p, chunk=chunk,
                                  accurate=accurate,
                                  packed=None if packed is None
                                  else packed[i:i + 1],
                                  kv=None if ops is None else ops[i])
    tokens = x3.reshape(n, p, d)
    tokens = _ln(tokens) * w["on_scale"] + w["on_bias"]
    return (tokens @ w["head_w"] + w["head_b"])[..., 0]


def mega_denoise_ensemble_sharded(model, x, t, cond_ctx, n_real: int, mesh,
                                  **plan):
    """The fused-core denoise with the conditions sharded over `data`
    (ertdx/models/mega.py:222-255): x (B*n_real, P) condition-major, t
    and the (B-row) context are global on every rank; each rank runs the
    kernel on its own conditions' block (`Mesh.condition_rows`, as
    `posterior_ensemble` slices them) and the blocks are all-gathered,
    so every rank returns the global eps_hat. The condition batch must
    divide the data axis, as JAX's shard_map requires. A collective:
    every rank of the mesh calls it. No entry point calls it
    (`posterior_ensemble` slices once and gathers once at the end); it
    is the port of JAX's function and is held against it by the tests."""
    tokens, vec = cond_ctx
    split = mesh.condition_rows(tokens.shape[0], n_real)
    if split is None:
        if mesh.shape[DATA_AXIS] == 1:
            return mega_denoise_ensemble(model, x, t, cond_ctx, n_real,
                                         **plan)
        raise ValueError(f"{tokens.shape[0]} conditions do not divide "
                         f"the data axis {mesh.shape[DATA_AXIS]}")
    conds, chains = split
    out = mega_denoise_ensemble(model, x[chains], t[chains],
                                (tokens[conds], vec[conds]), n_real, **plan)
    return all_gather_cat(out, mesh.data_group)
