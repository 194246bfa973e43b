"""The yardstick's arithmetic: operations and bytes from shapes, the
card's peaks, and the kernel-name groups of a device breakdown.

Operations count 2 per multiply-add. The fused core stack, per token row
(P rows a chain) and block: 2 D (14 D + 2 P + 2 Lk): the Dense products
(qkv 3 D^2, self-out, cross-q and cross-out D^2 each, the MLP 8 D^2),
self-attention over P keys and cross-attention over Lk keys (q k^T and
p v each). Its bytes: every input of the launch read once and its
output written once, at the sizes the kernel takes (float32 chains,
AdaLN rows, biases and the small weights; bf16 K, V and packed block
weights). A whole call adds the encoder's forward for each survey and
the cross K/V products, made once a call.
"""
from __future__ import annotations

from typing import Dict

from .reference import model as ref_model

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# device kernel groups by name (the first group whose key the lowercased
# name contains); the port's fused core first, then the groups of
# chip_smoke.py's profiles
KERNEL_GROUPS = (("fused core (this port)", ("core_stack_", "core_block_")),
                 ("GN and fused conv (this port)",
                  ("gn_fwd_", "gn_bwd_", "gn_stats_", "gn_affine_",
                   "tap3_gemm_", "tap3_wgmma_",
                   "conv_dw_", "sum_rows_")),
                 ("slab attention (this port)", ("slab_",)),
                 ("flash attention (this port)",
                  ("(anonymous namespace)::flash_",)),
                 ("ensemble attention (this port)",
                  ("block_self_onepass_kernel",
                   "folded_cross_onepass_kernel")),
                 ("convolution", ("conv", "implicit", "fprop", "dgrad",
                                  "wgrad", "winograd", "nchwtonhwc",
                                  "nhwctonchw")),
                 ("matrix product", ("gemm", "cutlass", "cublas")),
                 ("reduction, norm, softmax", ("reduce", "norm", "softmax")),
                 ("elementwise", ("elementwise", "vectorized", "copy",
                                  "fill", "cat")))

STACK_KERNEL = "core_stack_wgmma_kernel"


def kernel_group(name: str) -> str:
    low = name.lower()
    return next((g for g, keys in KERNEL_GROUPS
                 if any(k in low for k in keys)), "other")


def core_stack_flops(b: int, r: int, p: int, d: int, nb: int,
                     lk: int) -> float:
    """One fused_core_stack launch over b conditions x r chains."""
    return 2.0 * d * (14 * d + 2 * p + 2 * lk) * b * r * p * nb


def core_stack_bytes(b: int, r: int, p: int, d: int, nb: int,
                     lk: int) -> float:
    chains = 4 * b * r * p * 2                    # x in, eps out (float32)
    mods = 4 * b * 6 * nb * d
    kv = 2 * 2 * b * nb * lk * d                  # bf16 K and V
    packed = 2 * nb * 14 * d * d                  # bf16 block weights
    small = 4 * (nb * 7 * d + 2 * d + p * d + 2 * d + d + 1)
    return float(chains + mods + kv + packed + small)


def core_stack_bound_s(b, r, p, d, nb, lk) -> float:
    """The least time one launch can take on the card: the larger of its
    operations at the bf16 peak and its bytes at the memory's rate."""
    return max(core_stack_flops(b, r, p, d, nb, lk) / PEAK_BF16_FLOPS,
               core_stack_bytes(b, r, p, d, nb, lk) / PEAK_BYTES_PER_S)


def encoder_flops(m: dict) -> float:
    """One survey through the condition encoder (the products only)."""
    widths = ref_model.encoder_widths(m["base_width"], m["depth"])
    length = -(-m["cond_length"] // ref_model.PATCH)
    flops = 2.0 * length * ref_model.PATCH * m["cond_channels"] * widths[0]
    conv3 = 2.0 * 3 * 2                            # two conv3 a ResBlock

    flops += conv3 * length * widths[0] ** 2
    for w_in, w_out in zip(widths, widths[1:]):
        length = -(-length // 2)
        flops += 2.0 * 3 * length * w_in * w_out + conv3 * length * w_out ** 2
    w = widths[-1]
    flops += 2.0 * length * (3 * w * w + w * w) + 4.0 * length ** 2 * w
    flops += conv3 * length * w * w
    flops += 2.0 * length * w * m["hidden_dim"] + 2.0 * m["hidden_dim"] ** 2
    return flops


def call_flops(m: dict, surveys: int, members: int, steps: int) -> float:
    """One call: the encoder per survey, each block's cross K/V once, and
    `steps` denoiser calls (the stack, with the lift and head)."""
    d, p, nb = m["hidden_dim"], m["param_dim"], m["num_blocks"]
    lk = ref_model.token_length(m["cond_length"], m["depth"])
    core = core_stack_flops(surveys, members, p, d, nb, lk) \
        + 4.0 * d * surveys * members * p
    kv = 2.0 * surveys * nb * lk * d * 2 * d
    return surveys * encoder_flops(m) + kv + steps * core


def stack_shape(m: dict, surveys: int, members: int) -> Dict[str, int]:
    return {"b": surveys, "r": members, "p": m["param_dim"],
            "d": m["hidden_dim"], "nb": m["num_blocks"],
            "lk": ref_model.token_length(m["cond_length"], m["depth"])}
