"""A plain float32 CondUNet: the condition encoder and the denoiser core.

Written from the architecture as configs[3] and configs[4] state it
(https://github.com/pnnl/ERT-Conditional-Diffusion-Model, the CondUNet of
this repository's presets), in plain PyTorch and as functions of a
weights dictionary, with no module of the program under test imported.
The weights' names and shapes are those `param_shapes` lists; the
benchmark makes the weights from its seed and hands the same dictionary
to both sides.

Every matrix product goes through a `mm(a, b)` function, so that the
control can compute the same model at a lower precision: `matmul_fp32`
is the reference (float32, TF32 off), `round_tf32`, bfloat16 and
`round_fp8` round a product's operands as a TF32, a bf16 or an fp8 (e4m3)
product would.

The encoder: patchify (pad the length to a multiple of 8, fold 8
positions into the channels), a Dense stem, ResBlocks of [GroupNorm(8) +
SiLU, conv3] x 2 with a residual, stride-2 "SAME" downsampling convs,
one pre-norm multi-head self-attention, a last ResBlock, a Dense to the
token width and a pooled conditioning vector. The core: lift each of
the P parameters to a D-wide token, add a position embedding, then
blocks of AdaLN-conditioned [self-attention over the P tokens of a
chain, cross-attention to the condition's tokens, GELU MLP], a final
LayerNorm and a scalar head. Chains are condition-major (chain b R + r).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

PATCH = 8
GN_GROUPS = 8
GN_EPS = 1e-5
LN_EPS = 1e-6

Weights = Dict[str, torch.Tensor]
MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """a's float32 values rounded to TF32's 10-bit mantissa, to nearest
    even."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(a: torch.Tensor) -> torch.Tensor:
    """a rounded to fp8 e4m3 under a power-of-two per-tensor scale that
    puts its largest magnitude at or under e4m3's largest value (448), as
    an fp8 product scales its operands."""
    amax = float(a.abs().max())
    if amax == 0.0 or not math.isfinite(amax):
        return a
    scale = 2.0 ** math.ceil(math.log2(amax / 448.0))
    return (a / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def mm_tf32(a, b):
    """A TF32 product: both operands rounded to TF32, float32 sums."""
    return torch.matmul(round_tf32(a), round_tf32(b))


def mm_bf16(a, b):
    """A bf16 product: both operands rounded to bfloat16, float32 sums."""
    return torch.matmul(a.to(torch.bfloat16).float(),
                        b.to(torch.bfloat16).float())


def mm_fp8(a, b):
    """An fp8 product: both operands rounded to e4m3, float32 sums."""
    return torch.matmul(round_fp8(a), round_fp8(b))


# --------------------------------------------------------------------------
# shapes
# --------------------------------------------------------------------------

def encoder_widths(base_width: int, depth: int) -> List[int]:
    """The ResBlock widths of the encoder, stem first."""
    w0 = 2 * base_width
    widths = [w0]
    for i in range(depth - 1):
        widths.append(min(w0 * 2 ** (i + 1), 4 * base_width))
    return widths


def token_length(cond_length: int, depth: int) -> int:
    length = -(-cond_length // PATCH)
    for _ in range(depth - 1):
        length = -(-length // 2)
    return length


def param_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    """Every weight of the model `m` (a configuration's "model" fields)
    by name, in a fixed order."""
    d, p, c = m["hidden_dim"], m["param_dim"], m["cond_channels"]
    widths = encoder_widths(m["base_width"], m["depth"])
    shapes: Dict[str, Tuple[int, ...]] = {"pos_emb": (p, d)}

    def dense(name, cin, cout, bias=True):
        shapes[name + ".weight"] = (cout, cin)
        if bias:
            shapes[name + ".bias"] = (cout,)

    def conv(name, cin, cout, k):
        shapes[name + ".weight"] = (cout, cin, k)
        shapes[name + ".bias"] = (cout,)

    def norm(name, width):
        shapes[name + ".weight"] = (width,)
        shapes[name + ".bias"] = (width,)

    def res(name, w):
        norm(name + ".norm1", w)
        conv(name + ".conv1", w, w, 3)
        norm(name + ".norm2", w)
        conv(name + ".conv2", w, w, 3)

    dense("encoder.stem", PATCH * c, widths[0])
    for i, w in enumerate(widths):
        res(f"encoder.res.{i}", w)
    for i in range(len(widths) - 1):
        conv(f"encoder.downs.{i}", widths[i], widths[i + 1], 3)
    w = widths[-1]
    norm("encoder.attn.norm", w)
    dense("encoder.attn.qkv", w, 3 * w, bias=False)
    dense("encoder.attn.out", w, w)
    res("encoder.res_out", w)
    dense("encoder.tokens", w, d)
    dense("encoder.pool", d, d)
    dense("lift", 1, d)
    dense("time_mlp1", d, d)
    dense("time_mlp2", d, d)
    for i in range(m["num_blocks"]):
        b = f"blocks.{i}"
        for a in ("ada1", "ada2", "ada3"):
            dense(f"{b}.{a}.proj", d, 2 * d)
        dense(f"{b}.qkv", d, 3 * d, bias=False)
        dense(f"{b}.self_out", d, d)
        dense(f"{b}.cross_q", d, d, bias=False)
        dense(f"{b}.cross_kv", d, 2 * d, bias=False)
        dense(f"{b}.cross_out", d, d)
        dense(f"{b}.mlp_in", d, 4 * d)
        dense(f"{b}.mlp_out", 4 * d, d)
    norm("out_norm", d)
    dense("head", d, 1)
    return shapes


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def dense(x, w: Weights, name: str, mm: MatMul):
    y = mm(x, w[name + ".weight"].t())
    bias = w.get(name + ".bias")
    return y if bias is None else y + bias


def conv_same(x, w: Weights, name: str, stride: int, mm: MatMul):
    """A "SAME"-padded conv on (B, L, C): the total padding
    (ceil(L/s) - 1) s + k - L split low = total // 2, high = the rest."""
    weight = w[name + ".weight"]                  # (Cout, Cin, k)
    cout, cin, k = weight.shape
    b, length, _ = x.shape
    out = -(-length // stride)
    total = max((out - 1) * stride + k - length, 0)
    xp = F.pad(x, (0, 0, total // 2, total - total // 2))
    taps = torch.stack([xp[:, j:j + stride * (out - 1) + 1:stride]
                        for j in range(k)], dim=-1)     # (B, out, Cin, k)
    y = mm(taps.reshape(b, out, cin * k), weight.reshape(cout, cin * k).t())
    return y + w[name + ".bias"]


def groupnorm_silu(x, w: Weights, name: str):
    b, length, c = x.shape
    g = x.reshape(b, length, GN_GROUPS, c // GN_GROUPS)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    h = ((g - mean) / torch.sqrt(var + GN_EPS)).reshape(b, length, c)
    return F.silu(h * w[name + ".weight"] + w[name + ".bias"])


def layernorm(x, eps: float = LN_EPS):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def attention(q, k, v, mm: MatMul):
    """softmax(q k^T / sqrt(dh)) v over the last two axes."""
    logits = mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return mm(torch.softmax(logits, dim=-1), v)


def resblock(x, w: Weights, name: str, mm: MatMul):
    h = conv_same(groupnorm_silu(x, w, name + ".norm1"), w, name + ".conv1",
                  1, mm)
    h = conv_same(groupnorm_silu(h, w, name + ".norm2"), w, name + ".conv2",
                  1, mm)
    return x + h


def encode(cond, w: Weights, m: dict, mm: MatMul = matmul_fp32):
    """(B, L, C) scaled conditions -> (tokens (B, Lk, D), vector (B, D))."""
    b, length, c = cond.shape
    lp = -(-length // PATCH) * PATCH
    x = F.pad(cond, (0, 0, 0, lp - length))
    h = dense(x.reshape(b, lp // PATCH, PATCH * c), w, "encoder.stem", mm)
    h = resblock(h, w, "encoder.res.0", mm)
    for i in range(m["depth"] - 1):
        h = conv_same(h, w, f"encoder.downs.{i}", 2, mm)
        h = resblock(h, w, f"encoder.res.{i + 1}", mm)
    # pre-norm multi-head self-attention with a residual
    nh = m["num_heads"]
    bl, lt, ct = h.shape
    a = layernorm(h) * w["encoder.attn.norm.weight"] \
        + w["encoder.attn.norm.bias"]
    qkv = dense(a, w, "encoder.attn.qkv", mm)
    q, k, v = (z.reshape(bl, lt, nh, ct // nh).transpose(1, 2)
               for z in qkv.chunk(3, dim=-1))
    o = attention(q, k, v, mm).transpose(1, 2).reshape(bl, lt, ct)
    h = h + dense(o, w, "encoder.attn.out", mm)
    h = resblock(h, w, "encoder.res_out", mm)
    tokens = dense(h, w, "encoder.tokens", mm)
    pooled = F.silu(dense(tokens.mean(dim=1), w, "encoder.pool", mm))
    return tokens, pooled


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding: frequencies exp(-log(1e4) k / (dim/2 - 1)),
    [sin, cos]."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float64,
                                   device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    arg = t.to(torch.float64)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=1).to(
        torch.float32)


def cond_vector(t: int, pooled, w: Weights, mm: MatMul):
    """The AdaLN conditioning vector of each condition at step t (every
    chain of a step shares t): time MLP + the pooled condition."""
    d = pooled.shape[-1]
    temb = timestep_embedding(torch.full((1,), t, device=pooled.device), d)
    h = F.silu(dense(temb, w, "time_mlp1", mm))
    return dense(h, w, "time_mlp2", mm) + pooled        # (B, D)


def ada(x, c, w: Weights, name: str, mm: MatMul):
    """LayerNorm without affine, then (1 + scale), shift from c: x is
    (B, N, D), c (B, D)."""
    scale, shift = dense(F.silu(c), w, name + ".proj", mm).chunk(2, dim=-1)
    return layernorm(x) * (1.0 + scale[:, None, :]) + shift[:, None, :]


def core_block(x, c, kv, w: Weights, i: int, p: int, mm: MatMul):
    """One block on (B, R*P, D) condition-major rows; kv the condition's
    (k, v), each (B, Lk, D)."""
    b, rows, d = x.shape
    name = f"blocks.{i}"
    q, k, v = dense(ada(x, c, w, name + ".ada1", mm), w, name + ".qkv",
                    mm).chunk(3, dim=-1)
    chains = b * rows // p
    a = attention(q.reshape(chains, p, d), k.reshape(chains, p, d),
                  v.reshape(chains, p, d), mm).reshape(b, rows, d)
    x = x + dense(a, w, name + ".self_out", mm)
    q = dense(ada(x, c, w, name + ".ada2", mm), w, name + ".cross_q", mm)
    x = x + dense(attention(q, kv[0], kv[1], mm), w, name + ".cross_out", mm)
    h = F.gelu(dense(ada(x, c, w, name + ".ada3", mm), w, name + ".mlp_in",
                     mm), approximate="tanh")
    return x + dense(h, w, name + ".mlp_out", mm)


def cross_kv(tokens, w: Weights, m: dict, mm: MatMul) -> list:
    """Each block's cross K and V of the condition tokens."""
    return [dense(tokens, w, f"blocks.{i}.cross_kv", mm).chunk(2, dim=-1)
            for i in range(m["num_blocks"])]


def denoise(x, t: int, pooled, kvs: list, w: Weights, m: dict,
            mm: MatMul = matmul_fp32):
    """eps for (B*R, P) condition-major chains at the shared step t."""
    b = pooled.shape[0]
    n, p = x.shape
    d = m["hidden_dim"]
    c = cond_vector(t, pooled, w, mm)
    tok = mm(x.reshape(n * p, 1), w["lift.weight"].t()).reshape(n, p, d) \
        + w["lift.bias"] + w["pos_emb"]
    h = tok.reshape(b, n // b * p, d)
    for i in range(m["num_blocks"]):
        h = core_block(h, c, kvs[i], w, i, p, mm)
    h = layernorm(h) * w["out_norm.weight"] + w["out_norm.bias"]
    return dense(h.reshape(n, p, d), w, "head", mm)[..., 0]
