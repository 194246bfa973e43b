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
MLP, the AdaLN rows, the cross K/V and the fused-core kernels) computes
in float32 from the float32 parameters.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.core_block import (WEIGHT_KEYS, _ln, fused_core_block,
                              fused_core_stack, kernel_supports)
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
        return lin.weight.detach().t().contiguous()

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
    """Every weight the fused path reads, gathered once per run."""
    blocks = [extract_core_weights(model, i)
              for i in range(model.num_blocks)]
    d = model.hidden_dim
    return {
        "blocks": blocks,
        "stack": {key: torch.stack([w[key] for w in blocks])
                  for key in WEIGHT_KEYS},
        "lift_w": model.lift.weight.detach().reshape(1, d).contiguous(),
        "lift_b": model.lift.bias.detach().reshape(1, d),
        "pos_emb": model.pos_emb.detach(),
        "on_scale": model.out_norm.weight.detach().reshape(1, d),
        "on_bias": model.out_norm.bias.detach().reshape(1, d),
        "head_w": model.head.weight.detach().reshape(d, 1).contiguous(),
        "head_b": model.head.bias.detach().reshape(1, 1),
    }


def mega_plan(model, n_real: int, batch: int = 1,
              cond_len: Optional[int] = None, device=None) -> Optional[dict]:
    """The fused-core plan, or None for the plain module path.

    Requires the `ensemble_mega` flag, a single-head core (float32 or
    bfloat16: both run the float32 kernels), tensors on a CUDA device,
    at least MIN_TOTAL_CHAINS chains, and a core shape the CUDA kernels
    take (ops/core_block.kernel_supports: D=128, P <= 32,
    Lk <= 256), which replaces the TPU's VMEM estimators. The one-launch
    stack kernel is always preferred; the per-block kernel stays
    reachable through `mega_denoise_ensemble(stack=False)`, the
    per-block variant and A/B comparator."""
    if not getattr(model, "ensemble_mega", False):
        return None
    if getattr(model, "core_heads", 0) != 1:
        return None
    if device is None or torch.device(device).type != "cuda":
        return None
    if n_real * batch < MIN_TOTAL_CHAINS:
        return None
    p, d, nb = model.param_dim, model.hidden_dim, model.num_blocks
    lk = cond_token_len(model, cond_len) if cond_len is not None else 256
    if not kernel_supports(p, d, lk):
        return None
    return {"p": p, "d": d, "num_blocks": nb, "chunk": n_real,
            "accurate": bool(model.ensemble_mega_accurate), "stack": True}


def _cvec_silu(model, t, cond_vec, d):
    """silu(AdaLN conditioning vector) per condition — shared t; float32
    from the float32 parameters whatever the model's dtype, as JAX's."""
    temb = get_timestep_embedding(t[:1], d)
    m1, m2 = model.time_mlp1, model.time_mlp2
    h = F.silu(F.linear(temb, m1.weight, m1.bias))
    return F.silu(F.linear(h, m2.weight, m2.bias) + cond_vec)


def _block_mods_kv(w, sc, cond_tokens):
    """(B, 6, D) AdaLN rows and (B, Lk, D) cross K/V for one block."""
    mods = torch.stack([m for wk, bk in w["ada"]
                        for m in (sc @ wk + bk).chunk(2, dim=-1)], dim=1)
    k, v = (cond_tokens @ w["wkv"]).chunk(2, dim=-1)
    return mods, k.contiguous(), v.contiguous()


def mega_denoise_ensemble(model, x, t, cond_ctx, n_real: int, *, p: int,
                          d: int, num_blocks: int, chunk: int,
                          accurate: bool = False, stack: bool = True,
                          weights: Optional[dict] = None):
    """(B*n_real, P) condition-major chains -> eps_hat on the fused core.

    stack=True runs lift -> all blocks -> head as ONE kernel launch;
    stack=False launches one kernel per block, with lift, out-norm and
    head in plain PyTorch. `weights` (from `mega_weights`) saves
    regathering them at every step."""
    w = weights if weights is not None else mega_weights(model)
    # a bfloat16 model hands over a bf16 context: the kernel side computes
    # in float32, so cast once here (ertdx/models/mega.py:167-173)
    cond_tokens, cond_vec = (z.to(torch.float32) for z in cond_ctx)
    x = x.to(torch.float32)
    bsz = cond_tokens.shape[0]
    n = x.shape[0]
    n_chunks = n_real // chunk
    sc = _cvec_silu(model, t, cond_vec, d)
    per = [_block_mods_kv(wb, sc, cond_tokens) for wb in w["blocks"]]

    if stack:
        mods = torch.cat([m for m, _, _ in per], dim=1).contiguous()
        lk = cond_tokens.shape[1]
        k = torch.stack([k for _, k, _ in per], dim=1).reshape(
            bsz * num_blocks, lk, d)
        v = torch.stack([v for _, _, v in per], dim=1).reshape(
            bsz * num_blocks, lk, d)
        out = fused_core_stack(
            x.reshape(bsz * n_chunks, chunk, p).contiguous(), mods, k, v,
            w["stack"], w["lift_w"], w["lift_b"], w["pos_emb"],
            w["on_scale"], w["on_bias"], w["head_w"], w["head_b"],
            p=p, chunk=chunk, accurate=accurate)
        return out.reshape(n, p)

    tokens = x[..., None] @ w["lift_w"] + w["lift_b"] + w["pos_emb"][None]
    x3 = tokens.reshape(bsz * n_chunks, chunk * p, d)
    for i, (mods, k, v) in enumerate(per):
        x3 = fused_core_block(x3, mods.contiguous(), k, v, w["blocks"][i],
                              p=p, chunk=chunk, accurate=accurate)
    tokens = x3.reshape(n, p, d)
    tokens = _ln(tokens) * w["on_scale"] + w["on_bias"]
    return (tokens @ w["head_w"] + w["head_b"])[..., 0]
