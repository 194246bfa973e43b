// Fused CoreBlock kernels for the posterior-ensemble denoiser core (sm_90a).
//
// Replaces the TPU kernels of ertdx/ops/core_block.py:
//   * core_stack_kernel  <- fused_core_stack (_core_stack_kernel): lift and
//     positional embedding, nb CoreBlocks, out-norm and the Dense(1) head,
//     from compact (chains, P) inputs to compact eps outputs;
//   * core_block_kernel  <- fused_core_block (_core_block_kernel): one
//     CoreBlock over condition-major (chains * P, D) slabs.
// One CoreBlock is: AdaLN -> self-attention over the P tokens of each chain
// -> AdaLN -> cross-attention to the condition's Lk keys -> AdaLN -> MLP
// D -> 4D -> D with tanh-GELU, each with its residual add. LayerNorm eps is
// 1e-6; AdaLN rows (scale, shift) x 3 arrive per condition (shared t).
//
// What bounds it on an H100: operations. Per row and block it does
// 2 D (14 D + 2 P + 2 Lk) flops on 4 bytes in and out per token, so at the
// configs[3] shape (P=29, D=128, Lk=147, 232,000 rows, 4 blocks) it is
// ~5.1e11 fp32 flops against < 12 MB of device-memory traffic.
//
// What the design does about it, and what it changes from the TPU kernel:
//   * Grid: one CUDA block per (condition, tile of ROWS/P chains), not one
//     program per condition; the forward is chain-local, so 8 conditions x
//     1000 chains give 4,000 independent blocks for 132 SMs. Each block
//     loads its own condition's AdaLN rows and K/V.
//   * Activations of the tile (<= 64 rows x 128) stay in shared memory
//     through every block of the stack; device memory sees only the
//     compact x in and eps out (stack) or the slab in and out (block).
//   * Weights (14 nb D^2 floats = 3.7 MB at nb=4) do not fit in shared
//     memory: each product stages one 32 x 128 weight tile at a time
//     through shared memory, and the 50 MB L2 holds the stack for all
//     blocks.
//   * Self-attention is 29 x 29 per chain: the TPU's (8P, 8P) block-
//     diagonal tile and its 7/8 masked logits are not computed.
//   * Cross-attention runs over the Lk valid keys only; the TPU's padding
//     of 147 to 256 and its column mask are gone.
//   * The MLP hidden activation (rows x 4D) is made and consumed in
//     128-column chunks, accumulating into the residual.
//   * Every product is an fp32 FMA on the CUDA cores (bound: 67 TFLOP/s),
//     more exact than both TPU modes. Tensor cores (wgmma, TF32 or bf16)
//     and TMA are later work; `accurate` has no effect until then.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 128;                 // hidden width the kernels take
constexpr int ROWS = 64;               // rows of one block's tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LDX = D + 4;             // padded row stride, X and H
constexpr int LDB = 3 * D + 4;         // padded row stride, BIG
constexpr int KC = 32;                 // depth of one staged weight tile
constexpr int LK_MAX = 256;            // cross logits live in BIG[:, D:]
constexpr int P_MAX = 32;              // one warp lane per key token
constexpr int SMEM_FLOATS = 2 * ROWS * LDX + ROWS * LDB + KC * D;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
constexpr float LN_EPS = 1e-6f;

struct LayerW {
  const float* wqkv;  // (D, 3D)
  const float* wso;   // (D, D)
  const float* bso;   // (D)
  const float* wcq;   // (D, D)
  const float* wco;   // (D, D)
  const float* bco;   // (D)
  const float* w1;    // (D, 4D)
  const float* b1;    // (4D)
  const float* w2;    // (4D, D)
  const float* b2;    // (D)
};

struct Tile {
  float* X;    // (ROWS, LDX) the residual stream
  float* H;    // (ROWS, LDX) normed activations / attention outputs
  float* BIG;  // (ROWS, LDB) qkv, cross q + logits, MLP hidden chunk
  float* W;    // (KC, D) staged weight tile
  int nrows;   // valid rows (chains * P)
  int P;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int gemm_col(int tx, int j) {
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x *
         (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// acc[i][j] = sum_{k<K} A[r_i][k] * B[k][n0 + c_j] for the thread's rows
// r_i = ty*4+i and columns c_j = gemm_col(tx, j) of a 64 x 128 output tile.
// A lives in shared memory (row stride lda) and must be finite up to K
// rounded up to KC. B is row-major (K x ldb) in device memory, or with
// TRANS the transpose of a row-major (nvalid x ldb) matrix; columns at or
// beyond nvalid and rows at or beyond K stage as zeros. Ends with a
// barrier, so the caller may overwrite A in its epilogue.
template <bool TRANS>
__device__ void gemm_tile(const float* A, int lda, int K,
                          const float* __restrict__ B, int ldb, int n0,
                          int nvalid, float* Ws, float acc[4][8]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    for (int s = tid; s < KC * D / 4; s += THREADS) {
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!TRANS) {
        const int kk = s / (D / 4), c = (s % (D / 4)) * 4;
        if (k0 + kk < K && n0 + c < nvalid)
          val = *reinterpret_cast<const float4*>(B + (size_t)(k0 + kk) * ldb +
                                                 n0 + c);
        *reinterpret_cast<float4*>(Ws + kk * D + c) = val;
      } else {
        const int n = s / (KC / 4), kq = (s % (KC / 4)) * 4;
        if (n0 + n < nvalid && k0 + kq < K)
          val = *reinterpret_cast<const float4*>(B + (size_t)(n0 + n) * ldb +
                                                 k0 + kq);
        Ws[(kq + 0) * D + n] = val.x;
        Ws[(kq + 1) * D + n] = val.y;
        Ws[(kq + 2) * D + n] = val.z;
        Ws[(kq + 3) * D + n] = val.w;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * lda + k0 + kk];
      const float4 b0 = *reinterpret_cast<const float4*>(Ws + kk * D + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Ws + kk * D + 64 + tx * 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();
}

// dst = LN(src) * (1 + scale) + shift (ada) or LN(src) * scale + shift,
// one warp per row; scale/shift are (D) vectors in device memory.
__device__ void norm_rows(const float* src, float* dst,
                          const float* __restrict__ scale,
                          const float* __restrict__ shift, bool ada) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4 s = *reinterpret_cast<const float4*>(scale + lane * 4);
  const float4 h = *reinterpret_cast<const float4*>(shift + lane * 4);
  const float add = ada ? 1.0f : 0.0f;
  for (int r = warp; r < ROWS; r += WARPS) {
    const float4 v = *reinterpret_cast<const float4*>(src + r * LDX + lane * 4);
    const float mu = warp_sum(v.x + v.y + v.z + v.w) * (1.0f / D);
    const float dx = v.x - mu, dy = v.y - mu, dz = v.z - mu, dw = v.w - mu;
    const float var =
        warp_sum(dx * dx + dy * dy + dz * dz + dw * dw) * (1.0f / D);
    const float inv = 1.0f / sqrtf(var + LN_EPS);
    float4 o;
    o.x = dx * inv * (add + s.x) + h.x;
    o.y = dy * inv * (add + s.y) + h.y;
    o.z = dz * inv * (add + s.z) + h.z;
    o.w = dw * inv * (add + s.w) + h.w;
    *reinterpret_cast<float4*>(dst + r * LDX + lane * 4) = o;
  }
}

// One CoreBlock on the tile in t.X, in place. mods: (6, D) rows
// s1,h1,s2,h2,s3,h3 of this condition; kc, vc: (Lk, D) of this condition.
__device__ void core_layer(const Tile& t, const float* __restrict__ mods,
                           const float* __restrict__ kc,
                           const float* __restrict__ vc, int Lk,
                           const LayerW& w) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int P = t.P, nrows = t.nrows;
  const float scale = 1.0f / sqrtf((float)D);
  float acc[4][8];

  // ---- self-attention over each chain's P tokens ----
  norm_rows(t.X, t.H, mods + 0 * D, mods + 1 * D, true);
  for (int c = 0; c < 3; ++c) {   // q (pre-scaled), k, v into BIG[:, cD:]
    gemm_tile<false>(t.H, LDX, D, w.wqkv, 3 * D, c * D, 3 * D, t.W, acc);
    const float f = c == 0 ? scale : 1.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        t.BIG[(ty * 4 + i) * LDB + c * D + gemm_col(tx, j)] = acc[i][j] * f;
  }
  __syncthreads();
  float* S = t.H;                  // (ROWS, 32) logits; H is free now
  for (int e = tid; e < nrows * P; e += THREADS) {
    const int r = e / P, j = e % P, key = (r / P) * P + j;
    const float4* q = reinterpret_cast<const float4*>(t.BIG + r * LDB);
    const float4* k = reinterpret_cast<const float4*>(t.BIG + key * LDB + D);
    float s = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D / 4; ++d) {
      const float4 a = q[d], b = k[d];
      s = fmaf(a.x, b.x, s);
      s = fmaf(a.y, b.y, s);
      s = fmaf(a.z, b.z, s);
      s = fmaf(a.w, b.w, s);
    }
    S[r * 32 + j] = s;
  }
  __syncthreads();
  for (int r = warp; r < nrows; r += WARPS) {
    const float s = lane < P ? S[r * 32 + lane] : -INFINITY;
    const float m = warp_max(s);
    const float e = lane < P ? expf(s - m) : 0.0f;
    const float sum = warp_sum(e);
    if (lane < P) S[r * 32 + lane] = e / sum;
  }
  __syncthreads();
  for (int e = tid; e < ROWS * D; e += THREADS) {  // a = p v into BIG[:, :D]
    const int r = e / D, c = e % D;
    float a = 0.0f;
    if (r < nrows) {
      const int base = (r / P) * P;
      for (int j = 0; j < P; ++j)
        a = fmaf(S[r * 32 + j], t.BIG[(base + j) * LDB + 2 * D + c], a);
    }
    t.BIG[r * LDB + c] = a;
  }
  gemm_tile<false>(t.BIG, LDB, D, w.wso, D, 0, D, t.W, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = gemm_col(tx, j);
      t.X[(ty * 4 + i) * LDX + col] += acc[i][j] + w.bso[col];
    }
  __syncthreads();

  // ---- cross-attention to the condition's Lk keys ----
  norm_rows(t.X, t.H, mods + 2 * D, mods + 3 * D, true);
  gemm_tile<false>(t.H, LDX, D, w.wcq, D, 0, D, t.W, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      t.BIG[(ty * 4 + i) * LDB + gemm_col(tx, j)] = acc[i][j] * scale;
  for (int n0 = 0; n0 < Lk; n0 += D) {  // logits q k^T into BIG[:, D:]
    gemm_tile<true>(t.BIG, LDB, D, kc, D, n0, Lk, t.W, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + gemm_col(tx, j);
        if (col < Lk) t.BIG[(ty * 4 + i) * LDB + D + col] = acc[i][j];
      }
  }
  __syncthreads();
  const int lk_pad = (Lk + KC - 1) / KC * KC;
  for (int r = warp; r < ROWS; r += WARPS) {
    float* row = t.BIG + r * LDB + D;
    float m = -INFINITY;
    for (int j = lane; j < Lk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    for (int j = lane; j < lk_pad; j += 32)
      row[j] = j < Lk ? row[j] * inv : 0.0f;
  }
  gemm_tile<false>(t.BIG + D, LDB, Lk, vc, D, 0, D, t.W, acc);  // p v
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      t.H[(ty * 4 + i) * LDX + gemm_col(tx, j)] = acc[i][j];
  gemm_tile<false>(t.H, LDX, D, w.wco, D, 0, D, t.W, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = gemm_col(tx, j);
      t.X[(ty * 4 + i) * LDX + col] += acc[i][j] + w.bco[col];
    }
  __syncthreads();

  // ---- MLP, hidden made and consumed in 128-column chunks ----
  norm_rows(t.X, t.H, mods + 4 * D, mods + 5 * D, true);
  for (int c = 0; c < 4; ++c) {
    gemm_tile<false>(t.H, LDX, D, w.w1, 4 * D, c * D, 4 * D, t.W, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = gemm_col(tx, j);
        t.BIG[(ty * 4 + i) * LDB + col] =
            gelu_tanh(acc[i][j] + w.b1[c * D + col]);
      }
    gemm_tile<false>(t.BIG, LDB, D, w.w2 + (size_t)c * D * D, D, 0, D, t.W,
                     acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = gemm_col(tx, j);
        t.X[(ty * 4 + i) * LDX + col] +=
            acc[i][j] + (c == 0 ? w.b2[col] : 0.0f);
      }
  }
  __syncthreads();
}

__device__ Tile make_tile(float* smem, int nrows, int P) {
  Tile t;
  t.X = smem;
  t.H = t.X + ROWS * LDX;
  t.BIG = t.H + ROWS * LDX;
  t.W = t.BIG + ROWS * LDB;
  t.nrows = nrows;
  t.P = P;
  return t;
}

__device__ LayerW layer_at(const LayerW& w, int i) {
  LayerW o;
  o.wqkv = w.wqkv + (size_t)i * D * 3 * D;
  o.wso = w.wso + (size_t)i * D * D;
  o.bso = w.bso + (size_t)i * D;
  o.wcq = w.wcq + (size_t)i * D * D;
  o.wco = w.wco + (size_t)i * D * D;
  o.bco = w.bco + (size_t)i * D;
  o.w1 = w.w1 + (size_t)i * D * 4 * D;
  o.b1 = w.b1 + (size_t)i * 4 * D;
  o.w2 = w.w2 + (size_t)i * 4 * D * D;
  o.b2 = w.b2 + (size_t)i * D;
  return o;
}

struct StackArgs {
  const float* x;     // (B*R, P) compact chains, condition-major
  const float* mods;  // (B, 6 nb, D)
  const float* k;     // (B*nb, Lk, D)
  const float* v;     // (B*nb, Lk, D)
  LayerW w;           // stacks with leading dim nb
  const float* lw;    // (D) lift kernel
  const float* lb;    // (D) lift bias
  const float* pe;    // (P, D) positional embedding
  const float* ons;   // (D) out-norm scale
  const float* onb;   // (D) out-norm bias
  const float* hw;    // (D) head kernel
  const float* hb;    // (1) head bias
  float* out;         // (B*R, P)
  int R, P, nb, Lk;
};

__global__ void __launch_bounds__(THREADS)
core_stack_kernel(const StackArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int cpt = ROWS / a.P;
  const int tiles = (a.R + cpt - 1) / cpt;
  const int b = blockIdx.x / tiles, r0 = (blockIdx.x % tiles) * cpt;
  const int nrows = min(cpt, a.R - r0) * a.P;
  const size_t row0 = ((size_t)b * a.R + r0) * a.P;
  const Tile t = make_tile(smem, nrows, a.P);

  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {  // lift + pos
    const int r = e / D, c = e % D;
    t.X[r * LDX + c] = r < nrows ? a.x[row0 + r] * a.lw[c] + a.lb[c] +
                                       a.pe[(r % a.P) * D + c]
                                 : 0.0f;
  }
  __syncthreads();
  for (int i = 0; i < a.nb; ++i) {
    const size_t kv = ((size_t)b * a.nb + i) * a.Lk * D;
    core_layer(t, a.mods + ((size_t)b * a.nb * 6 + 6 * i) * D, a.k + kv,
               a.v + kv, a.Lk, layer_at(a.w, i));
  }
  norm_rows(t.X, t.H, a.ons, a.onb, false);  // out-norm, then the head
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const float4 hw = *reinterpret_cast<const float4*>(a.hw + lane * 4);
  for (int r = threadIdx.x >> 5; r < nrows; r += WARPS) {
    const float4 h = *reinterpret_cast<const float4*>(t.H + r * LDX + lane * 4);
    const float s = warp_sum(h.x * hw.x + h.y * hw.y + h.z * hw.z + h.w * hw.w);
    if (lane == 0) a.out[row0 + r] = s + a.hb[0];
  }
}

struct BlockArgs {
  const float* x;     // (B*R*P, D) condition-major slab rows
  const float* mods;  // (B, 6, D)
  const float* k;     // (B, Lk, D)
  const float* v;     // (B, Lk, D)
  LayerW w;
  float* out;         // (B*R*P, D)
  int R, P, Lk;
};

__global__ void __launch_bounds__(THREADS)
core_block_kernel(const BlockArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int cpt = ROWS / a.P;
  const int tiles = (a.R + cpt - 1) / cpt;
  const int b = blockIdx.x / tiles, r0 = (blockIdx.x % tiles) * cpt;
  const int nrows = min(cpt, a.R - r0) * a.P;
  const size_t row0 = ((size_t)b * a.R + r0) * a.P;
  const Tile t = make_tile(smem, nrows, a.P);

  for (int e = threadIdx.x; e < ROWS * D / 4; e += THREADS) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    const float4 val =
        r < nrows
            ? *reinterpret_cast<const float4*>(a.x + (row0 + r) * D + c)
            : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(t.X + r * LDX + c) = val;
  }
  __syncthreads();
  core_layer(t, a.mods + (size_t)b * 6 * D, a.k + (size_t)b * a.Lk * D,
             a.v + (size_t)b * a.Lk * D, a.Lk, a.w);
  for (int e = threadIdx.x; e < nrows * D / 4; e += THREADS) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    *reinterpret_cast<float4*>(a.out + (row0 + r) * D + c) =
        *reinterpret_cast<const float4*>(t.X + r * LDX + c);
  }
}

bool shape_ok(int B, int R, int P, int Lk) {
  return B >= 1 && R >= 1 && P >= 1 && P <= P_MAX && Lk >= 1 &&
         Lk <= LK_MAX;
}

int grid_of(int B, int R, int P) {
  const int cpt = ROWS / P;
  return B * ((R + cpt - 1) / cpt);
}

}  // namespace

extern "C" {

int ertdx_core_stack(const float* x, const float* mods, const float* k,
                     const float* v, const float* wqkv, const float* wso,
                     const float* bso, const float* wcq, const float* wco,
                     const float* bco, const float* w1, const float* b1,
                     const float* w2, const float* b2, const float* lw,
                     const float* lb, const float* pe, const float* ons,
                     const float* onb, const float* hw, const float* hb,
                     float* out, int B, int R, int P, int nb, int Lk,
                     void* stream) {
  if (!shape_ok(B, R, P, Lk) || nb < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      core_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  StackArgs a;
  a.x = x; a.mods = mods; a.k = k; a.v = v;
  a.w = LayerW{wqkv, wso, bso, wcq, wco, bco, w1, b1, w2, b2};
  a.lw = lw; a.lb = lb; a.pe = pe; a.ons = ons; a.onb = onb;
  a.hw = hw; a.hb = hb; a.out = out;
  a.R = R; a.P = P; a.nb = nb; a.Lk = Lk;
  core_stack_kernel<<<grid_of(B, R, P), THREADS, SMEM_BYTES,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int ertdx_core_block(const float* x, const float* mods, const float* k,
                     const float* v, const float* wqkv, const float* wso,
                     const float* bso, const float* wcq, const float* wco,
                     const float* bco, const float* w1, const float* b1,
                     const float* w2, const float* b2, float* out, int B,
                     int R, int P, int Lk, void* stream) {
  if (!shape_ok(B, R, P, Lk)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      core_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  BlockArgs a;
  a.x = x; a.mods = mods; a.k = k; a.v = v;
  a.w = LayerW{wqkv, wso, bso, wcq, wco, bco, w1, b1, w2, b2};
  a.out = out;
  a.R = R; a.P = P; a.Lk = Lk;
  core_block_kernel<<<grid_of(B, R, P), THREADS, SMEM_BYTES,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
