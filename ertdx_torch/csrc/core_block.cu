// Fused CoreBlock kernels for the posterior-ensemble denoiser core (sm_90a;
// every large product on the 3xTF32 tensor-core tile of tf32x3.cuh).
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
// ~5.1e11 flops against < 12 MB of device-memory traffic: 3.1 ms at the
// 3xTF32 rate (495 / 3 TFLOP/s), 7.6 ms on the fp32 pipe. The six
// projections are 84 % of the flops, the cross-attention 14 %, the
// self-attention 3 %. A second floor: each 64-row tile reads a block's
// 14 D^2 weights and its condition's K and V from L2, about 17 GB a
// configs[3] launch.
//
// What the design does about it, and what it changes from the TPU kernel:
//   * Grid: one CUDA block per (condition, tile of ROWS/P chains), not one
//     program per condition; the forward is chain-local, so 8 conditions x
//     1000 chains give 4,000 independent blocks for 132 SMs. Each block
//     loads its own condition's AdaLN rows and K/V.
//   * Activations of the tile (<= 64 rows x 128) stay in shared memory
//     through every block of the stack; device memory sees only the
//     compact x in and eps out (stack) or the slab in and out (block).
//   * Every product (the six projections, the self-attention's q k^T and
//     P v, the cross logits q K^T and P V) runs on the 3xTF32 tile of
//     tf32x3.cuh: warp-level mma.sync m16n8k8, each operand split into TF32
//     hi and lo, three MMAs a product; fp32-class, more exact than both TPU
//     modes (one TF32 rounding misses phase 3's gate:
//     tests/test_torch_core_tf32x3.py), so `accurate` selects nothing. A
//     block is 16 warps (one block an SM: 206 KB of shared memory, 128
//     registers a thread); they split each 64 x 128 output into 32 x 16
//     parts, which measured faster than 8 warps of 16 x 64 or 32 x 32
//     (PERF.md; tools/core_ab.py). Every operand read from shared memory
//     takes k in the order 0 2 4 6 1 3 5 7, so a fragment's two k values
//     are one 8-byte load.
//   * The B operands (weights, K, V; 14 nb D^2 floats = 3.7 MB of weights
//     at nb=4, which the 50 MB L2 holds) stream through a double-buffered
//     ring of 32-deep chunks by cp.async: while the MMAs run on one chunk
//     the next is in flight, and a product's last chunk issues the next
//     product's first, so that it loads during the epilogue, the softmax
//     or the LayerNorm in between.
//   * Each 32-deep chunk's MMAs sum from zero and the partial is added to
//     the accumulator in fp32, in every product: half the error of
//     accumulating on the MMA, for 2 % more time (PERF.md).
//   * Self-attention: q k^T over the whole tile (64 x 64 logits, 2 chains
//     of 29 at configs[3]) and P v over its 64 keys, from q, k, v in
//     shared memory; the softmax keeps each row's own chain's P keys and
//     gives every other key probability 0, so a chain may straddle the
//     MMA's 16-row tiles. The TPU's (8P, 8P) tile with 7/8 of its logits
//     masked becomes one of 64 rows with about half of them masked.
//   * Cross-attention runs over the Lk valid keys only: K and V rows past
//     Lk stage as zeros, logits past Lk are never read and their
//     probabilities are 0, and the warps whose keys are all past Lk skip
//     the logits' MMAs; the TPU's padding of 147 to 256 is gone.
//   * The MLP hidden activation (rows x 4D) is made and consumed in
//     128-column chunks, accumulating into the residual.
//   * No atomics: each output element is written by one thread, in a fixed
//     order; reruns are bit-identical.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int D = 128;                 // hidden width the kernels take
constexpr int ROWS = 64;               // rows of one block's tile
constexpr int WM = 32, WN = 16;        // a warp's part of a 64 x 128 output
constexpr int MT = WM / 16, NT = WN / 8;   // its m16 and n8 tiles
constexpr int WARPS = (ROWS / WM) * (D / WN);
constexpr int THREADS = 32 * WARPS;
constexpr int LDX = D + 8;             // row stride of X and H, 8 (mod 32)
constexpr int LDB = 3 * D + 8;         // row stride of BIG, 8 (mod 32)
constexpr int LDS = ROWS + 8;          // self logits (ROWS, LDS) in H
constexpr int KC = 32;                 // depth of one staged B chunk
constexpr int LDW = D + 4;             // (KC, D) weight or V chunk, 4 (mod 32)
constexpr int LDK = KC + 8;            // (D keys, KC) K chunk, 8 (mod 32)
constexpr int STAGE = D * LDK;         // floats of a ring slot (>= KC LDW)
constexpr int LK_MAX = 256;            // cross logits live in BIG[:, D:]
constexpr int P_MAX = 32;              // one warp lane per key token
constexpr int SMEM_FLOATS = 2 * ROWS * LDX + ROWS * LDB + 2 * STAGE;
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

// The B operand of one product over a 128-column block, streamed in
// KC-deep chunks. Row-major: B(k, n) = p[k ld + n0 + n] (a weight, or V),
// rows k >= valid staged as zeros. nt: B(k, n) = p[(n0 + n) ld + k] (K),
// key rows n0 + n >= valid staged as zeros. K: the depth run, a multiple
// of KC (or rounded up to one).
struct BSrc {
  const float* p;
  int ld, n0, K, valid;
  bool nt;
};

__device__ __forceinline__ BSrc rowmajor(const float* p, int ld, int n0,
                                         int K, int valid) {
  return BSrc{p, ld, n0, K, valid, false};
}

__device__ __forceinline__ BSrc keys_of(const float* p, int n0, int Lk) {
  return BSrc{p, D, n0, D, Lk, true};
}

struct Tile {
  float* X;     // (ROWS, LDX) the residual stream
  float* H;     // (ROWS, LDX) normed activations / attention outputs
  float* BIG;   // (ROWS, LDB) qkv, cross q + logits, MLP hidden chunk
  float* ring;  // 2 x STAGE: the B chunks
  int slot;     // the ring slot of the next chunk to compute on
  int nrows;    // valid rows (chains * P)
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

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x *
         (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// Issue chunk `chunk` of b into the ring slot s with cp.async (one commit
// group per thread).
__device__ void stage_chunk(float* s, const BSrc& b, int chunk) {
  const int k0 = chunk * KC;
  if (!b.nt) {                         // KC rows of D floats
    for (int i = threadIdx.x; i < KC * D / 4; i += THREADS) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool ok = k0 + r < b.valid;
      tf32x3::cp16(s + r * LDW + c,
                   b.p + (ok ? (size_t)(k0 + r) * b.ld + b.n0 + c : 0), ok);
    }
  } else {                             // D key rows of KC floats
    for (int i = threadIdx.x; i < D * KC / 4; i += THREADS) {
      const int n = i / (KC / 4), c = (i % (KC / 4)) * 4;
      const bool ok = b.n0 + n < b.valid;
      tf32x3::cp16(s + n * LDK + c,
                   b.p + (ok ? (size_t)(b.n0 + n) * b.ld + k0 + c : 0), ok);
    }
  }
  tf32x3::cp_commit();
}

// The first row and column of the warp's WM x WN part of a 64 x 128
// output tile.
__device__ __forceinline__ int warp_row0() {
  return WM * ((threadIdx.x >> 5) % (ROWS / WM));
}
__device__ __forceinline__ int warp_col0() {
  return WN * ((threadIdx.x >> 5) / (ROWS / WM));
}

__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// part += columns [k0, k0 + KC) of A times a KC-deep B chunk in shared
// memory, on the 3xTF32 tile, for the warp's part of the output. A is a
// shared tile with row stride lda = 8 (mod 32); B(k, n) = Bs[k ldb + n],
// or with NTB Bs[n ldb + k]. Two k steps at a time: the whole chunk
// unrolled needs more than the 128 registers a thread has and spills.
template <bool NTB>
__device__ __forceinline__ void chunk_mma(float (&part)[MT][NT][4],
                                          const float* A, int lda, int k0,
                                          const float* Bs, int ldb) {
  using namespace tf32x3;
  const int lane = threadIdx.x & 31;
  const int m0 = warp_row0(), c0 = warp_col0();
#pragma unroll 2
  for (int kk = 0; kk < KC; kk += 8) {
    FragA a[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      load_a_perm(a[i], A, lda, m0 + 16 * i, k0 + kk, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragB f;
      if (NTB)
        load_b_nt_perm(f, Bs, ldb, c0 + 8 * j, kk, lane);
      else
        load_b_nn(f, Bs, ldb, kk, c0 + 8 * j, lane);
#pragma unroll
      for (int i = 0; i < MT; ++i) mma3(part[i][j], a[i], f);
    }
  }
}

// acc += part: each chunk's MMAs sum from zero and the partial is added
// in fp32, since over many k steps the MMA's own accumulation drifts
// (PERF.md).
__device__ __forceinline__ void add_part(float (&acc)[MT][NT][4],
                                         const float (&part)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// acc = A B for the warp's part of a 64 x 128 output. A is (ROWS, b.K) in
// shared memory, row stride lda = 8 (mod 32), finite up to b.K. b's chunk
// 0 is already in flight into ring slot t.slot (issued by the kernel's
// prologue or by the previous product); the last chunk issues next's
// chunk 0 (where next.p), so the next product's first weights load while
// this epilogue and what follows it run. Each chunk starts with a
// barrier, which also orders the caller's shared-memory writes before it;
// there is none at the end, so the epilogue must not write A.
template <bool NTB>
__device__ void gemm(Tile& t, const float* A, int lda, const BSrc& b,
                     const BSrc& next, float (&acc)[MT][NT][4]) {
  zero(acc);
  // a warp whose columns are all past the valid keys has nothing to do
  const bool idle = NTB && b.n0 + warp_col0() >= b.valid;
  const int chunks = (b.K + KC - 1) / KC;
  for (int ch = 0; ch < chunks; ++ch) {
    tf32x3::cp_wait<0>();
    __syncthreads();                   // chunk ch has landed for every thread
    const float* cur = t.ring + t.slot * STAGE;
    float* other = t.ring + (t.slot ^ 1) * STAGE;
    if (ch + 1 < chunks)
      stage_chunk(other, b, ch + 1);
    else if (next.p)
      stage_chunk(other, next, 0);
    if (!idle) {
      float part[MT][NT][4];
      zero(part);
      chunk_mma<NTB>(part, A, lda, ch * KC, cur, NTB ? LDK : LDW);
      add_part(acc, part);
    }
    t.slot ^= 1;
  }
}

// acc = A B with B resident in shared memory (the tile's own k or v, row
// stride ldb), K a multiple of KC: B(k, n) = Bs[k ldb + n], or with NTB
// Bs[n ldb + k]. No barrier: the caller orders the writes of A and B.
template <bool NTB>
__device__ void tile_product(const float* A, int lda, const float* Bs,
                             int ldb, int K, float (&acc)[MT][NT][4]) {
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += KC) {
    float part[MT][NT][4];
    zero(part);
    chunk_mma<NTB>(part, A, lda, k0, NTB ? Bs + k0 : Bs + k0 * ldb, ldb);
    add_part(acc, part);
  }
}

// f(row, col, v0, v1) for the output elements (row, col) and (row, col+1)
// that acc holds, over the warp's WM x WN part of the 64 x 128 tile.
template <class F>
__device__ __forceinline__ void for_pairs(const float (&acc)[MT][NT][4],
                                          F f) {
  const int lane = threadIdx.x & 31;
  const int r = warp_row0() + (lane >> 2);
  const int c = warp_col0() + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      f(r + 16 * i, c + 8 * j, acc[i][j][0], acc[i][j][1]);
      f(r + 16 * i + 8, c + 8 * j, acc[i][j][2], acc[i][j][3]);
    }
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// p[0:2] += (v0, v1): an output projection's residual add.
__device__ __forceinline__ void add2(float* p, float v0, float v1) {
  float2 x = *reinterpret_cast<float2*>(p);
  x.x += v0;
  x.y += v1;
  *reinterpret_cast<float2*>(p) = x;
}

// The first product of a CoreBlock: the q columns of the qkv projection.
__device__ __forceinline__ BSrc first_product(const LayerW& w) {
  return rowmajor(w.wqkv, 3 * D, 0, D, D);
}

// dst = LN(src) * (1 + scale) + shift (ada) or LN(src) * scale + shift;
// each warp takes ROWS / WARPS rows and reduces their sums together, so
// that their shuffles overlap. scale/shift are (D) vectors in device
// memory.
__device__ void norm_rows(const float* src, float* dst,
                          const float* __restrict__ scale,
                          const float* __restrict__ shift, bool ada) {
  constexpr int RR = ROWS / WARPS;       // a warp's rows, reduced together
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4 s = *reinterpret_cast<const float4*>(scale + lane * 4);
  const float4 h = *reinterpret_cast<const float4*>(shift + lane * 4);
  const float add = ada ? 1.0f : 0.0f;
  float4 v[RR];
  float mu[RR], var[RR];
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    v[i] = *reinterpret_cast<const float4*>(src + (warp + i * WARPS) * LDX +
                                            lane * 4);
    mu[i] = v[i].x + v[i].y + v[i].z + v[i].w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < RR; ++i)
      mu[i] += __shfl_xor_sync(0xffffffffu, mu[i], o);
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    mu[i] *= 1.0f / D;
    v[i].x -= mu[i];
    v[i].y -= mu[i];
    v[i].z -= mu[i];
    v[i].w -= mu[i];
    var[i] = v[i].x * v[i].x + v[i].y * v[i].y + v[i].z * v[i].z +
             v[i].w * v[i].w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < RR; ++i)
      var[i] += __shfl_xor_sync(0xffffffffu, var[i], o);
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    const float inv = 1.0f / sqrtf(var[i] * (1.0f / D) + LN_EPS);
    float4 o;
    o.x = v[i].x * inv * (add + s.x) + h.x;
    o.y = v[i].y * inv * (add + s.y) + h.y;
    o.z = v[i].z * inv * (add + s.z) + h.z;
    o.w = v[i].w * inv * (add + s.w) + h.w;
    *reinterpret_cast<float4*>(dst + (warp + i * WARPS) * LDX + lane * 4) = o;
  }
}

// One CoreBlock on the tile in t.X, in place. mods: (6, D) rows
// s1,h1,s2,h2,s3,h3 of this condition; kc, vc: (Lk, D) of this condition.
// The block's first product (first_product(w)) is already in flight;
// `after` is the product that follows the block (its chunk 0 is issued
// by the last one here), or p == nullptr for none.
__device__ void core_layer(Tile& t, const float* __restrict__ mods,
                           const float* __restrict__ kc,
                           const float* __restrict__ vc, int Lk,
                           const LayerW& w, const BSrc& after) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int P = t.P, nrows = t.nrows;
  const float scale = 1.0f / sqrtf((float)D);
  const int lk_pad = (Lk + KC - 1) / KC * KC;
  float acc[MT][NT][4];

  // ---- self-attention over each chain's P tokens ----
  norm_rows(t.X, t.H, mods + 0 * D, mods + 1 * D, true);
  for (int c = 0; c < 3; ++c) {   // q (pre-scaled), k, v into BIG[:, cD:]
    gemm<false>(t, t.H, LDX, rowmajor(w.wqkv, 3 * D, c * D, D, D),
                c < 2 ? rowmajor(w.wqkv, 3 * D, (c + 1) * D, D, D)
                      : rowmajor(w.wso, D, 0, D, D),
                acc);
    const float f = c == 0 ? scale : 1.0f;
    for_pairs(acc, [&](int r, int col, float v0, float v1) {
      store2(t.BIG + r * LDB + c * D + col, v0 * f, v1 * f);
    });
  }
  __syncthreads();
  // S = q k^T over the whole tile on the 3xTF32 tile (the warps of the
  // first 64 columns), masked to each chain's P keys by the softmax
  float* S = t.H;                  // (ROWS, LDS) logits; H is free now
  if (warp_col0() < ROWS)
    tile_product<true>(t.BIG, LDB, t.BIG + D, LDB, D, acc);
  else
    zero(acc);
  for_pairs(acc, [&](int r, int col, float v0, float v1) {
    if (col < ROWS) store2(S + r * LDS + col, v0, v1);
  });
  __syncthreads();
  for (int r = warp; r < ROWS; r += WARPS) {  // probabilities, 0 elsewhere
    const int base = (r / P) * P;
    const bool live = r < nrows && lane < P;
    const float s = live ? S[r * LDS + base + lane] : -INFINITY;
    const float m = warp_max(s);
    const float e = live ? expf(s - m) : 0.0f;
    const float sum = warp_sum(e);
    __syncwarp();
    for (int j = lane; j < ROWS; j += 32) S[r * LDS + j] = 0.0f;
    __syncwarp();
    if (live) S[r * LDS + base + lane] = e / sum;
  }
  __syncthreads();
  tile_product<false>(S, LDS, t.BIG + 2 * D, LDB, ROWS, acc);  // a = p v
  for_pairs(acc, [&](int r, int col, float v0, float v1) {
    store2(t.BIG + r * LDB + col, v0, v1);
  });
  gemm<false>(t, t.BIG, LDB, rowmajor(w.wso, D, 0, D, D),
              rowmajor(w.wcq, D, 0, D, D), acc);
  for_pairs(acc, [&](int r, int col, float v0, float v1) {
    add2(t.X + r * LDX + col, v0 + w.bso[col], v1 + w.bso[col + 1]);
  });
  __syncthreads();

  // ---- cross-attention to the condition's Lk keys ----
  norm_rows(t.X, t.H, mods + 2 * D, mods + 3 * D, true);
  gemm<false>(t, t.H, LDX, rowmajor(w.wcq, D, 0, D, D), keys_of(kc, 0, Lk),
              acc);
  for_pairs(acc, [&](int r, int col, float v0, float v1) {
    store2(t.BIG + r * LDB + col, v0 * scale, v1 * scale);
  });
  for (int n0 = 0; n0 < Lk; n0 += D) {  // logits q k^T into BIG[:, D:]
    gemm<true>(t, t.BIG, LDB, keys_of(kc, n0, Lk),
               n0 + D < Lk ? keys_of(kc, n0 + D, Lk)
                           : rowmajor(vc, D, 0, lk_pad, Lk),
               acc);
    // columns past Lk (at most BIG's row) hold the zero keys' logits,
    // which the softmax never reads
    for_pairs(acc, [&](int r, int col, float v0, float v1) {
      store2(t.BIG + r * LDB + D + n0 + col, v0, v1);
    });
  }
  __syncthreads();
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
  gemm<false>(t, t.BIG + D, LDB, rowmajor(vc, D, 0, lk_pad, Lk),
              rowmajor(w.wco, D, 0, D, D), acc);   // p v
  for_pairs(acc, [&](int r, int col, float v0, float v1) {
    store2(t.H + r * LDX + col, v0, v1);
  });
  gemm<false>(t, t.H, LDX, rowmajor(w.wco, D, 0, D, D),
              rowmajor(w.w1, 4 * D, 0, D, D), acc);
  for_pairs(acc, [&](int r, int col, float v0, float v1) {
    add2(t.X + r * LDX + col, v0 + w.bco[col], v1 + w.bco[col + 1]);
  });
  __syncthreads();

  // ---- MLP, hidden made and consumed in 128-column chunks ----
  norm_rows(t.X, t.H, mods + 4 * D, mods + 5 * D, true);
  for (int c = 0; c < 4; ++c) {
    const BSrc w2c = rowmajor(w.w2 + (size_t)c * D * D, D, 0, D, D);
    gemm<false>(t, t.H, LDX, rowmajor(w.w1, 4 * D, c * D, D, D), w2c, acc);
    for_pairs(acc, [&](int r, int col, float v0, float v1) {
      store2(t.BIG + r * LDB + col, gelu_tanh(v0 + w.b1[c * D + col]),
             gelu_tanh(v1 + w.b1[c * D + col + 1]));
    });
    gemm<false>(t, t.BIG, LDB, w2c,
                c < 3 ? rowmajor(w.w1, 4 * D, (c + 1) * D, D, D) : after,
                acc);
    for_pairs(acc, [&](int r, int col, float v0, float v1) {
      add2(t.X + r * LDX + col, v0 + (c == 0 ? w.b2[col] : 0.0f),
           v1 + (c == 0 ? w.b2[col + 1] : 0.0f));
    });
  }
  __syncthreads();
}

__device__ Tile make_tile(float* smem, int nrows, int P) {
  Tile t;
  t.X = smem;
  t.H = t.X + ROWS * LDX;
  t.BIG = t.H + ROWS * LDX;
  t.ring = t.BIG + ROWS * LDB;
  t.slot = 0;
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
  Tile t = make_tile(smem, nrows, a.P);
  stage_chunk(t.ring, first_product(a.w), 0);

  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {  // lift + pos
    const int r = e / D, c = e % D;
    t.X[r * LDX + c] = r < nrows ? a.x[row0 + r] * a.lw[c] + a.lb[c] +
                                       a.pe[(r % a.P) * D + c]
                                 : 0.0f;
  }
  __syncthreads();
  for (int i = 0; i < a.nb; ++i) {
    const size_t kv = ((size_t)b * a.nb + i) * a.Lk * D;
    const BSrc after = i + 1 < a.nb ? first_product(layer_at(a.w, i + 1))
                                    : BSrc{nullptr, 0, 0, 0, 0, false};
    core_layer(t, a.mods + ((size_t)b * a.nb * 6 + 6 * i) * D, a.k + kv,
               a.v + kv, a.Lk, layer_at(a.w, i), after);
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
  Tile t = make_tile(smem, nrows, a.P);
  stage_chunk(t.ring, first_product(a.w), 0);

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
             a.v + (size_t)b * a.Lk * D, a.Lk, a.w,
             BSrc{nullptr, 0, 0, 0, 0, false});
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
