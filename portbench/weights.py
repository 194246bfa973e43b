"""The seed's weights and inputs, made on the device in a few large calls.

Weights: one normal draw for every leaf of `reference.model.param_shapes`,
cut into the leaves and scaled by `RULE`:

* a matrix or conv kernel: N(0, gain^2 / fan_in), gain 1, except the
  block outputs the JAX package initialises to zero (the AdaLN
  projections, the attention and MLP output projections), which take
  `residual_gain`;
* a bias N(0, bias_std^2); a norm's scale 1 + N(0, norm_std^2);
* the lift N(0, lift_std^2), its bias and the position embedding
  N(0, context_std^2);
* the head, made so that the denoiser starts near an identity of x: the
  head reads, through the final LayerNorm, the part of the lift's
  direction orthogonal to every position's (lift bias + position
  embedding), scaled so that eps is about x at the typical token spread,
  and its bias cancels the norm's bias along it.

Fully random weights make an eps that ignores x: DDIM then scales the
prior draw by about 1 / sqrt(alpha_bar_T) (12 at T = 500), the sigmoid
of the parameter inverse saturates, and a comparison of the draws sees
nothing. A denoiser near x at high noise, as a trained one is, keeps
the draws inside the sigmoid's range, and the blocks' residuals, which
the fused core computes, still move every draw.

Inputs: the raw surveys of the requests (log-normal apparent
resistivities about `SURVEY_MEDIAN`), the `TRAIN_SURVEYS` training
surveys and parameters the scalers are fit to (the parameters uniform
inside each physical limit's central share, `PARAM_MARGIN` off each
end), and each request's prior draw x_T, all from torch.Generators on
the device seeded from --seed.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .reference import model as ref_model
from .reference import sampler as ref

RULE = {"lift_std": 0.1, "context_std": 1.0, "head_gain": 1.0,
        "residual_gain": 0.1, "bias_std": 0.02, "norm_std": 0.1}
SURVEY_MEDIAN, SURVEY_LOG_STD = 50.0, 0.3     # ohm m, natural log
TRAIN_SURVEYS = 16
PARAM_MARGIN = 0.05

_RESIDUAL_LEAVES = ("ada1.proj", "ada2.proj", "ada3.proj", "self_out",
                    "cross_out", "mlp_out")


def _generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on `device` for one of the seed's streams."""
    words = np.random.SeedSequence([int(seed) % 2 ** 64, stream])
    return torch.Generator(device=device).manual_seed(
        int(words.generate_state(1, np.uint64)[0] >> np.uint64(1)))


def make_weights(model_cfg: dict, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    shapes = ref_model.param_shapes(model_cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=_generator(device, seed, 0),
                       device=device, dtype=torch.float32)
    w = {}
    for (name, shape), part in zip(shapes.items(),
                                   torch.split(flat, sizes)):
        z = part.view(shape)
        leaf = name.rsplit(".", 1)
        if name == "pos_emb" or name == "lift.bias":
            w[name] = z * RULE["context_std"]
        elif name == "lift.weight":
            w[name] = z * RULE["lift_std"]
        elif len(shape) >= 2:
            gain = (RULE["residual_gain"]
                    if leaf[0].split(".", 2)[-1] in _RESIDUAL_LEAVES
                    and leaf[0].startswith("blocks.") else 1.0)
            w[name] = z * (gain / math.sqrt(math.prod(shape[1:])))
        elif leaf[-1] == "weight":        # a norm's scale
            w[name] = 1.0 + RULE["norm_std"] * z
        else:
            w[name] = z * RULE["bias_std"]
    _identity_head(w)
    return w


def _identity_head(w: Dict[str, torch.Tensor]) -> None:
    """Set head.weight and head.bias as the module docstring says."""
    lift = w["lift.weight"][:, 0]
    ctx = w["lift.bias"][None, :] + w["pos_emb"]          # (P, D)
    ctx = ctx - ctx.mean(dim=1, keepdim=True)
    lift = lift - lift.mean()
    basis, _ = torch.linalg.qr(torch.cat(
        [ctx, torch.ones_like(lift)[None]], dim=0).t())   # (D, P + 1)
    along = lift - basis @ (basis.t() @ lift)
    spread = float(ctx.pow(2).mean().sqrt())
    u = along * (RULE["head_gain"] * spread
                 / float(along.pow(2).sum()))
    gamma = w["out_norm.weight"]
    head = u / gamma
    w["head.weight"] = head[None, :].contiguous()
    w["head.bias"] = -(head * w["out_norm.bias"]).sum().reshape(1)


def make_surveys(n: int, length: int, channels: int, seed: int,
                 stream: int, device) -> torch.Tensor:
    """(n, L, C) raw surveys: log-normal apparent resistivities."""
    z = torch.randn((n, length, channels),
                    generator=_generator(device, seed, stream),
                    device=device, dtype=torch.float32)
    return torch.exp(math.log(SURVEY_MEDIAN) + SURVEY_LOG_STD * z)


def make_params(n: int, seed: int, device) -> np.ndarray:
    """(n, P) training parameters, uniform inside each physical limit's
    central (1 - 2 PARAM_MARGIN) share."""
    limits, margin = ref.PARAM_LIMITS, PARAM_MARGIN
    lo, hi = limits[:, 0], limits[:, 1]
    span = hi - lo
    u = torch.rand((n, limits.shape[0]), generator=_generator(device,
                   seed, 3), device=device, dtype=torch.float64)
    return (lo + span * margin) + u.cpu().numpy() * span * (1 - 2 * margin)


def make_priors(n: int, chains: int, p: int, seed: int,
                device) -> torch.Tensor:
    """(n, chains, P) prior draws x_T, one block a request."""
    return torch.randn((n, chains, p), generator=_generator(device, seed, 4),
                       device=device, dtype=torch.float32)
