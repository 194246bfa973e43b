// Flash attention with a key mask, forward and backward (sm_90a; the
// forward on fp32 FMA, the backward on 3xTF32 tensor cores).
//
// Replaces the TPU kernels of ertdx/ops/attention.py:
//   * flash_fwd_kernel     <- _flash_kernel (:53-91, call :108)
//   * flash_bwd_dq_kernel  <- _flash_bwd_dq_kernel (:146-176, call :235),
//                             plus delta = rowsum(dO o O) (:232-233)
//   * flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel (:178-215, call :261)
// Operands are (B H, L, DH) row-major, L a multiple of 128 and DH one of
// 64, 128, 256 (the JAX `_aligned` rule); the mask is (B, Lk), a key is
// valid where its entry is > 0 and otherwise gets the additive bias
// -1e30 (not -inf). The function is the TPU kernel's, step for step:
//   forward  s = (q scale) k^T + bias, online softmax over key tiles
//            (m, l, alpha as in :74-80), o = acc / max(l, 1e-30),
//            lse = m + log(max(l, 1e-30));
//   dQ       p = exp(s - lse) with s = (q k^T) scale + bias,
//            dS = p o (dO v^T - delta), dQ = scale dS K;
//   dK, dV   dV = P^T dO, dK = scale dS^T Q.
// A row whose keys are all masked therefore gets the uniform mean of V
// over all Lk keys (s - 1e30 rounds every logit to -1e30), lse = -1e30,
// and p = 1 in the backward, as in JAX.
//
// Key tiles that are all padding. Where a batch row has a valid key, its
// lse is finite, so a key tile whose mask entries are all <= 0 has
// p = exp(s scale - 1e30 - lse) = 0 and dS = 0 exactly against every
// query: it adds nothing to dQ, and its dK and dV rows are 0. The dQ
// kernel skips such tiles, and a dK/dV block whose key tile is one writes
// zeros and returns, and so does a warp whose 16 keys are all padding;
// each block decides from the (B, Lk) mask itself. A batch row with no
// valid key keeps every tile (p = 1 there). On the encoder's flash shape
// (147 of 256 keys valid) at DH=64 the dQ kernel skips 3 of its 8 key
// tiles of 32, and the dK/dV kernel 1 of its 4 blocks of 64 keys and 2 of
// the 4 warps of another: 6 of 16 key rows of 16 in both.
//
// What bounds it on an H100: operations. At the encoder's flash shape
// (B H = 1024, L = 256 padded from 147, DH = 64) the forward does
// 4 BH L^2 DH = 17.2 GFLOP against 268 MB, the backward 10 BH L^2 DH =
// 42.9 GFLOP against 537 MB: 0.256 and 0.641 ms at 67 TFLOP/s fp32; the
// backward's products as 3xTF32 are 129 GFLOP, 0.26 ms at 495 TFLOP/s.
//
// What the design does about it, and what it changes from the TPU kernel:
//   * The TPU kernel keeps a whole (Lk, DH) K and V of one (b, h) in VMEM
//     (and the dK/dV kernel a whole Q and dO). Here both loops are tiled
//     over shared-memory blocks of 16 to 128 rows, so any L fits; the
//     tile sizes (Tiles<DH> and BwdTiles<DH> below) are chosen per head
//     width to keep one to three blocks resident per SM.
//   * The forward's products are register-tiled fp32 FMA loops: 256
//     threads as a 16 x 16 grid, each owning RM rows of the output tile.
//     Its inner loops are bound by shared-memory loads, not FMAs, unless
//     each load is a 16-byte vector: tiles sit in shared memory with rows
//     padded to DH+4 (or BK+4) floats, S-type products (mm_nt) read both
//     operands 4 k at a time, and P V-type products (mm_nn) give each
//     thread 4 adjacent output columns per 64, read as one vector per k.
//     Its running max and sum live in shared memory per row; a warp
//     updates 1/8 of the tile's rows after each S tile.
//   * The backward's products run on the 3xTF32 tile of tf32x3.cuh:
//     warp-level mma.sync m16n8k8, each operand split into two TF32
//     halves, three MMAs a k step; fp32-class results, as the TPU
//     kernel's Precision.HIGHEST. A warp owns 16 rows of its block's
//     output; P and dS are computed on the S and dP accumulators in
//     registers and feed dQ, dV and dK from there. Tiles are staged with
//     16-byte cp.async, the next one while the current one is computed.
//   * The backward is two launches: dQ (a block per query tile, looping
//     over key tiles; it also computes delta and writes it out) and then
//     dK/dV (a block per key tile, looping over query tiles, reading
//     delta). Each block owns its outputs: no atomics, so reruns are
//     bit-identical.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "tf32x3.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TG = 16;                 // the thread grid is TG x TG
constexpr float NEG = -1e30f;          // the TPU kernel's mask bias

// Forward tile rows per head width (query, key); shared memory per block
// is in the launcher. The 128-row query tile at DH=64 gives each thread 8
// rows (fewer shared-memory loads per FMA) in 128 registers, 2 blocks of
// 106 KB an SM.
template <int DH> struct Tiles;
template <> struct Tiles<64> {
  static constexpr int FQ = 128, FK = 64;
};
template <> struct Tiles<128> {
  static constexpr int FQ = 64, FK = 32;
};
template <> struct Tiles<256> {
  static constexpr int FQ = 32, FK = 32;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ const float4& ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// ROWS contiguous rows of DH floats from global memory into shared memory
// rows of DH+4 floats (16-byte aligned), each value times `mul`.
template <int ROWS, int DH>
__device__ __forceinline__ void load_rows(float* __restrict__ s,
                                          const float* __restrict__ g,
                                          float mul) {
  constexpr int V = DH / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (int idx = threadIdx.x; idx < ROWS * V; idx += THREADS) {
    const int r = idx / V, c = (idx % V) * 4;
    float4 x = g4[idx];
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    *reinterpret_cast<float4*>(s + r * (DH + 4) + c) = x;
  }
}

// acc[i][j] += sum_k A[row_i][k] B[col_j][k], row_i = ty RM + i,
// col_j = tx + TG j: both operands hold the contraction along their rows,
// read 4 k at a time as 16-byte vectors (rows padded to a multiple of 4
// floats, and 4 banks apart, so 8 rows of a phase hit 32 banks).
template <int RM, int CN, int K>
__device__ __forceinline__ void mm_nt(float (&acc)[RM][CN],
                                      const float* __restrict__ A, int lda,
                                      const float* __restrict__ B, int ldb,
                                      int ty, int tx) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[RM], b[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = ld4(A + (ty * RM + i) * lda + k);
#pragma unroll
    for (int j = 0; j < CN; ++j) b[j] = ld4(B + (tx + TG * j) * ldb + k);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][4 jj + e] += sum_k A[row_i][k] B[k][64 jj + 4 tx + e]: a thread
// owns 4 adjacent columns in each group of 64, read as one 16-byte
// vector per k; A's rows are read 4 k at a time.
template <int RM, int CV, int K>
__device__ __forceinline__ void mm_nn(float (&acc)[RM][4 * CV],
                                      const float* __restrict__ A, int lda,
                                      const float* __restrict__ B, int ldb,
                                      int ty, int tx) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = ld4(A + (ty * RM + i) * lda + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int jj = 0; jj < CV; ++jj) {
        const float4 b = ld4(B + (k + e) * ldb + 64 * jj + 4 * tx);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float av = comp(a[i], e);
          acc[i][4 * jj + 0] = fmaf(av, b.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(av, b.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(av, b.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(av, b.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
}

// Store a thread's rows of an (rows, DH) accumulator (mm_nn's column
// layout) to global memory, times `mul`.
template <int RM, int CV>
__device__ __forceinline__ void store_rows(float* __restrict__ g, int DH,
                                           const float (&acc)[RM][4 * CV],
                                           int ty, int tx, float mul) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int jj = 0; jj < CV; ++jj)
      *reinterpret_cast<float4*>(g + (ty * RM + i) * DH + 64 * jj +
                                 4 * tx) =
          make_float4(acc[i][4 * jj] * mul, acc[i][4 * jj + 1] * mul,
                      acc[i][4 * jj + 2] * mul, acc[i][4 * jj + 3] * mul);
}

template <int DH, int BQ, int BK>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((BQ + 2 * BK) * (DH + 4) + BQ * (BK + 4) + BK +
                          3 * BQ);
}

// grid (B H, Lq / BQ): one block per (batch row and head, query tile).
template <int DH, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ mask, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Lq, int Lk,
                     float scale) {
  constexpr int LD = DH + 4, LS = BK + 4;
  constexpr int RM = BQ / TG, CN = BK / TG, CV = DH / 64;
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x LD, q scale
  float* Ks = Qs + BQ * LD;         // BK x LD
  float* Vs = Ks + BK * LD;         // BK x LD
  float* Ss = Vs + BK * LD;         // BQ x LS: logits, then p
  float* bias = Ss + BQ * LS;       // BK
  float* m_s = bias + BK;           // BQ: running max
  float* l_s = m_s + BQ;            // BQ: running sum
  float* a_s = l_s + BQ;            // BQ: this tile's rescale factor

  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, tx = tid % TG, ty = tid / TG;
  const int warp = tid / 32, lane = tid % 32;
  const float* kg = k + (size_t)bh * Lk * DH;
  const float* vg = v + (size_t)bh * Lk * DH;
  const float* mg = mask + (size_t)(bh / H) * Lk;

  load_rows<BQ, DH>(Qs, q + ((size_t)bh * Lq + q0) * DH, scale);
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = NEG;
    l_s[r] = 0.f;
  }
  float acc[RM][4 * CV];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * CV; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();                // the last tile's readers are done
    load_rows<BK, DH>(Ks, kg + (size_t)k0 * DH, 1.f);
    load_rows<BK, DH>(Vs, vg + (size_t)k0 * DH, 1.f);
    for (int j = tid; j < BK; j += THREADS)
      bias[j] = mg[k0 + j] > 0.f ? 0.f : NEG;
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
    mm_nt<RM, CN, DH>(s, Qs, LD, Ks, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        Ss[(ty * RM + i) * LS + tx + TG * j] = s[i][j] + bias[tx + TG * j];
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < BQ; r += WARPS) {
      float* row = Ss + r * LS;
      const float m_old = m_s[r];
      float mx = -3.0e38f;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, row[c]);
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float alpha = a_s[ty * RM + i];
#pragma unroll
      for (int j = 0; j < 4 * CV; ++j) acc[i][j] *= alpha;
    }
    mm_nn<RM, CV, BK>(acc, Ss, LS, Vs, LD, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float l = fmaxf(l_s[ty * RM + i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 4 * CV; ++j) acc[i][j] /= l;
  }
  store_rows<RM, CV>(o + ((size_t)bh * Lq + q0) * DH, DH, acc, ty, tx, 1.f);
  for (int r = tid; r < BQ; r += THREADS)
    lse[(size_t)bh * Lq + q0 + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

// The backward kernels run every product on the 3xTF32 tensor-core tile of
// tf32x3.cuh with 4 warps (128 threads) a block; a warp owns 16 rows of
// its block's outputs. Shared tiles have rows of DH+4 floats.
constexpr int BWD_THREADS = 128;

// Tiles of the backward per head width: dQ key tile BK (64 query rows a
// block); dK/dV column split CS (a warp owns 16 keys and DH/CS columns
// of dK and dV, so a block owns 64/CS keys and recomputes S^T and dP^T
// CS times) and query tile BQ. Chosen to keep the accumulators within
// 128 registers a thread and two blocks an SM where the budget allows:
// shared memory DH=64: 70 KB dQ and 70 KB dK/dV; DH=128: 101 KB and 102
// KB; DH=256: 200 KB and 133 KB (one block an SM). At DH=64 a 32-key dQ
// tile skips 3 of 8 key tiles on the flash arm's shape where a 64-key one
// skips 1 of 4.
template <int DH> struct BwdTiles;
template <> struct BwdTiles<64> {
  static constexpr int BK = 32, CS = 1, BQ = 32;
};
template <> struct BwdTiles<128> {
  static constexpr int BK = 16, CS = 2, BQ = 32;
};
template <> struct BwdTiles<256> {
  static constexpr int BK = 16, CS = 2, BQ = 16;
};

template <int DH, int BK>
size_t dq_smem(int Lk) {
  return sizeof(float) * ((2 * 64 + 4 * BK) * (DH + 4) + 2 * BK) +
         (size_t)(Lk / BK + 15) / 16 * 16;
}

// grid (B H, Lq / 64). Writes dQ and delta (B H, Lq). Loops over the key
// tiles that hold a valid key (all of them for a batch row with none),
// staging K, V and the mask of the next kept tile with cp.async while it
// computes on the current one.
template <int DH, int BK>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ mask,
                        const float* __restrict__ o,
                        const float* __restrict__ lse,
                        const float* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ delta,
                        int H, int Lq, int Lk, float scale) {
  using namespace tf32x3;
  constexpr int LD = DH + 4, BQ = 64, NB = BK / 8, NN = DH / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // BQ x LD
  float* dOs = Qs + BQ * LD;              // BQ x LD
  float* KV = dOs + BQ * LD;              // 2 stages x (K, V): BK x LD each
  float* Ms = KV + 4 * BK * LD;           // 2 stages x BK mask values
  unsigned char* keep = reinterpret_cast<unsigned char*>(Ms + 2 * BK);

  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  const size_t row0 = (size_t)bh * Lq + q0;
  const float* kg = k + (size_t)bh * Lk * DH;
  const float* vg = v + (size_t)bh * Lk * DH;
  const float* mg = mask + (size_t)(bh / H) * Lk;
  const int tiles = Lk / BK;

  stage<DH>(Qs, LD, q + row0 * DH, DH, BQ, BQ, 0, BWD_THREADS);
  stage<DH>(dOs, LD, dout + row0 * DH, DH, BQ, BQ, 0, BWD_THREADS);
  cp_commit();
  // which key tiles hold a valid key; a batch row with none keeps them all
  int any = 0;
  for (int kt = warp; kt < tiles; kt += BWD_THREADS / 32) {
    int a = 0;
    for (int c = lane; c < BK; c += 32) a |= mg[kt * BK + c] > 0.f;
    a = __any_sync(FULL, a);
    if (lane == 0) keep[kt] = (unsigned char)a;
    any |= a;
  }
  const bool live = __syncthreads_or(any);
  auto next = [&](int kt) {
    for (++kt; kt < tiles && live && !keep[kt]; ++kt) {
    }
    return kt;
  };
  auto load = [&](int kt, int st) {
    float* Ks = KV + st * 2 * BK * LD;
    stage<DH>(Ks, LD, kg + (size_t)kt * BK * DH, DH, BK, BK, 0,
              BWD_THREADS);
    stage<DH>(Ks + BK * LD, LD, vg + (size_t)kt * BK * DH, DH, BK, BK, 0,
              BWD_THREADS);
    for (int i = tid; i < BK / 4; i += BWD_THREADS)
      cp16(Ms + st * BK + 4 * i, mg + kt * BK + 4 * i, true);
  };
  int kt = next(-1);
  if (kt < tiles) load(kt, 0);
  cp_commit();
  cp_wait<1>();
  __syncthreads();

  // delta = rowsum(dO o O) of this warp's 16 rows; lse of rows g, g+8
  float dl[2] = {0.f, 0.f};
  for (int i = 0; i < 16; ++i) {
    const float* orow = o + (row0 + m0 + i) * DH;
    float sum = 0.f;
    for (int c = lane; c < DH; c += 32) sum += dOs[(m0 + i) * LD + c] * orow[c];
    sum = warp_sum(sum);
    if (lane == 0) delta[row0 + m0 + i] = sum;
    if (i == g) dl[0] = sum;
    if (i == g + 8) dl[1] = sum;
  }
  const float ls[2] = {lse[row0 + m0 + g], lse[row0 + m0 + g + 8]};

  float acc[NN][4] = {};
  for (int st = 0; kt < tiles; st ^= 1) {
    const int nx = next(kt);
    if (nx < tiles) load(nx, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* Ks = KV + st * 2 * BK * LD;
    const float* Vs = Ks + BK * LD;
    const float* bm = Ms + st * BK;
    float s[NB][4] = {}, dp[NB][4] = {};
    nt2<NB, DH>(s, Qs, Ks, dp, dOs, Vs, LD, m0, 0, lane);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bias = bm[8 * j + 2 * t + (e & 1)] > 0.f ? 0.f : NEG;
        const float p = expf(s[j][e] * scale + bias - ls[e >> 1]);
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);
      }
      FragA a;
      from_c(a, s[j]);
      nn<NN>(acc, a, Ks, LD, 8 * j, 0, lane);
    }
    __syncthreads();                  // stage st is refilled next
    kt = nx;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* d = dq + (row0 + m0 + g + 8 * r) * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < NN; ++n)
      *reinterpret_cast<float2*>(d + 8 * n) =
          make_float2(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

template <int DH, int CS, int BQ>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (2 * (64 / CS) * (DH + 4) + 2 * (2 * BQ * (DH + 4) + 2 * BQ));
}

// grid (B H, Lk / (64 / CS)): one block per (batch row and head, key
// tile), looping over the query tiles with the next one's Q, dO, lse and
// delta staged by cp.async during the current one. A key tile whose keys
// are all masked, in a batch row that has a valid key, has p = 0 exactly
// against every query: it writes zeros and returns.
template <int DH, int CS, int BQ>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ mask,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ dout,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Lq, int Lk, float scale) {
  using namespace tf32x3;
  constexpr int LD = DH + 4, BK = 64 / CS, NB = BQ / 8, NN = DH / CS / 8;
  constexpr int STAGE = 2 * BQ * LD + 2 * BQ;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                       // BK x LD
  float* Vs = Ks + BK * LD;               // BK x LD
  float* QS = Vs + BK * LD;               // 2 stages x (Q, dO, lse, delta)

  const int bh = blockIdx.x, k0 = blockIdx.y * BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp / CS) * 16, c0 = (warp % CS) * (DH / CS);
  const size_t krow0 = (size_t)bh * Lk + k0;
  const float* mg = mask + (size_t)(bh / H) * Lk;

  int tile_any = 0, row_any = 0;
  for (int i = tid; i < Lk; i += BWD_THREADS) {
    const int valid = mg[i] > 0.f;
    row_any |= valid;
    if (i >= k0 && i < k0 + BK) tile_any |= valid;
  }
  tile_any = __syncthreads_or(tile_any);
  row_any = __syncthreads_or(row_any);
  if (!tile_any && row_any) {
    for (int i = tid; i < BK * DH / 4; i += BWD_THREADS) {
      reinterpret_cast<float4*>(dk + krow0 * DH)[i] = make_float4(0, 0, 0, 0);
      reinterpret_cast<float4*>(dv + krow0 * DH)[i] = make_float4(0, 0, 0, 0);
    }
    return;
  }

  auto load = [&](int qt, int st) {
    float* Qs = QS + st * STAGE;
    const size_t r0 = (size_t)bh * Lq + qt * BQ;
    stage<DH>(Qs, LD, q + r0 * DH, DH, BQ, BQ, 0, BWD_THREADS);
    stage<DH>(Qs + BQ * LD, LD, dout + r0 * DH, DH, BQ, BQ, 0, BWD_THREADS);
    for (int i = tid; i < BQ / 4; i += BWD_THREADS) {
      cp16(Qs + 2 * BQ * LD + 4 * i, lse + r0 + 4 * i, true);
      cp16(Qs + 2 * BQ * LD + BQ + 4 * i, delta + r0 + 4 * i, true);
    }
  };
  stage<DH>(Ks, LD, k + krow0 * DH, DH, BK, BK, 0, BWD_THREADS);
  stage<DH>(Vs, LD, v + krow0 * DH, DH, BK, BK, 0, BWD_THREADS);
  load(0, 0);
  cp_commit();
  const float bias[2] = {mg[k0 + m0 + g] > 0.f ? 0.f : NEG,
                         mg[k0 + m0 + g + 8] > 0.f ? 0.f : NEG};
  // a warp whose 16 keys are all masked (in a live batch row) computes
  // nothing and writes the zeros it started from
  const bool work =
      !row_any || __ballot_sync(FULL, lane < 16 && mg[k0 + m0 + lane] > 0.f);

  float dka[NN][4] = {}, dva[NN][4] = {};
  const int qtiles = Lq / BQ;
  for (int qt = 0, st = 0; qt < qtiles; ++qt, st ^= 1) {
    if (qt + 1 < qtiles) load(qt + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* Qs = QS + st * STAGE;
    const float* dOs = Qs + BQ * LD;
    const float* ls = dOs + BQ * LD;
    const float* ds_ = ls + BQ;
    // S^T and dP^T of this (key tile, query tile): rows keys, cols queries
    if (work) {
      float s[NB][4] = {}, dp[NB][4] = {};
      nt2<NB, DH>(s, Ks, Qs, dp, Vs, dOs, LD, m0, 0, lane);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float pr[4], dsr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          pr[e] = expf(s[j][e] * scale + bias[e >> 1] - ls[c]);
          dsr[e] = pr[e] * (dp[j][e] - ds_[c]);
        }
        FragA pa, da;
        from_c(pa, pr);
        from_c(da, dsr);
        nn<NN>(dva, pa, dOs, LD, 8 * j, c0, lane);
        nn<NN>(dka, da, Qs, LD, 8 * j, c0, lane);
      }
    }
    __syncthreads();                  // stage st is refilled next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = krow0 + m0 + g + 8 * r;
    float* dkr = dk + row * DH + c0 + 2 * t;
    float* dvr = dv + row * DH + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      *reinterpret_cast<float2*>(dkr + 8 * n) =
          make_float2(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dvr + 8 * n) =
          make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

bool shape_ok(int BH, int H, int Lq, int Lk, int DH) {
  return BH >= 1 && H >= 1 && BH % H == 0 && Lq >= 128 && Lk >= 128 &&
         Lq % 128 == 0 && Lk % 128 == 0 && Lq / 32 <= 65535 &&
         (DH == 64 || DH == 128 || DH == 256);
}

template <typename Kern>
cudaError_t set_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DH>
cudaError_t fwd(const float* q, const float* k, const float* v,
                const float* mask, float* o, float* lse, int BH, int H,
                int Lq, int Lk, float scale, cudaStream_t s) {
  using T = Tiles<DH>;
  constexpr size_t bytes = fwd_smem<DH, T::FQ, T::FK>();
  auto kern = flash_fwd_kernel<DH, T::FQ, T::FK>;
  cudaError_t err = set_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(BH, Lq / T::FQ), THREADS, bytes, s>>>(q, k, v, mask, o, lse, H,
                                                    Lq, Lk, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t bwd_dq(const float* q, const float* k, const float* v,
                   const float* mask, const float* o, const float* lse,
                   const float* dout, float* dq, float* delta, int BH, int H,
                   int Lq, int Lk, float scale, cudaStream_t s) {
  constexpr int BK = BwdTiles<DH>::BK;
  const size_t bytes = dq_smem<DH, BK>(Lk);
  auto kern = flash_bwd_dq_kernel<DH, BK>;
  cudaError_t err = set_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(BH, Lq / 64), BWD_THREADS, bytes, s>>>(
      q, k, v, mask, o, lse, dout, dq, delta, H, Lq, Lk, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t bwd_dkv(const float* q, const float* k, const float* v,
                    const float* mask, const float* lse, const float* delta,
                    const float* dout, float* dk, float* dv, int BH, int H,
                    int Lq, int Lk, float scale, cudaStream_t s) {
  using T = BwdTiles<DH>;
  constexpr size_t bytes = dkv_smem<DH, T::CS, T::BQ>();
  auto kern = flash_bwd_dkv_kernel<DH, T::CS, T::BQ>;
  cudaError_t err = set_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(BH, Lk / (64 / T::CS)), BWD_THREADS, bytes, s>>>(
      q, k, v, mask, lse, delta, dout, dk, dv, H, Lq, Lk, scale);
  return cudaGetLastError();
}

bool aligned16(std::initializer_list<const float*> ptrs) {
  uintptr_t bits = 0;
  for (const float* p : ptrs) bits |= (uintptr_t)p;
  return (bits & 15) == 0;
}

}  // namespace

extern "C" {

// q (BH, Lq, DH), k and v (BH, Lk, DH), mask (BH / H, Lk) -> o (BH, Lq,
// DH) and lse (BH, Lq).
int ertdx_flash_fwd(const float* q, const float* k, const float* v,
                    const float* mask, float* o, float* lse, int BH, int H,
                    int Lq, int Lk, int DH, float scale, void* stream) {
  if (!shape_ok(BH, H, Lq, Lk, DH)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (DH) {
    case 64: return (int)fwd<64>(q, k, v, mask, o, lse, BH, H, Lq, Lk, scale, s);
    case 128: return (int)fwd<128>(q, k, v, mask, o, lse, BH, H, Lq, Lk, scale, s);
    default: return (int)fwd<256>(q, k, v, mask, o, lse, BH, H, Lq, Lk, scale, s);
  }
}

// The forward's operands, o, lse and dO (BH, Lq, DH) -> dQ (BH, Lq, DH)
// and delta (BH, Lq) for the dK/dV pass.
int ertdx_flash_bwd_dq(const float* q, const float* k, const float* v,
                       const float* mask, const float* o, const float* lse,
                       const float* dout, float* dq, float* delta, int BH,
                       int H, int Lq, int Lk, int DH, float scale,
                       void* stream) {
  if (!shape_ok(BH, H, Lq, Lk, DH)) return (int)cudaErrorInvalidValue;
  // the backward stages its tiles with 16-byte cp.async
  if (!aligned16({q, k, v, mask, o, lse, dout}))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (DH) {
    case 64: return (int)bwd_dq<64>(q, k, v, mask, o, lse, dout, dq, delta, BH, H, Lq, Lk, scale, s);
    case 128: return (int)bwd_dq<128>(q, k, v, mask, o, lse, dout, dq, delta, BH, H, Lq, Lk, scale, s);
    default: return (int)bwd_dq<256>(q, k, v, mask, o, lse, dout, dq, delta, BH, H, Lq, Lk, scale, s);
  }
}

// The forward's operands, lse, delta (from ertdx_flash_bwd_dq) and dO ->
// dK and dV (BH, Lk, DH).
int ertdx_flash_bwd_dkv(const float* q, const float* k, const float* v,
                        const float* mask, const float* lse,
                        const float* delta, const float* dout, float* dk,
                        float* dv, int BH, int H, int Lq, int Lk, int DH,
                        float scale, void* stream) {
  if (!shape_ok(BH, H, Lq, Lk, DH)) return (int)cudaErrorInvalidValue;
  if (!aligned16({q, k, v, mask, lse, delta, dout}))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (DH) {
    case 64: return (int)bwd_dkv<64>(q, k, v, mask, lse, delta, dout, dk, dv, BH, H, Lq, Lk, scale, s);
    case 128: return (int)bwd_dkv<128>(q, k, v, mask, lse, delta, dout, dk, dv, BH, H, Lq, Lk, scale, s);
    default: return (int)bwd_dkv<256>(q, k, v, mask, lse, delta, dout, dk, dv, BH, H, Lq, Lk, scale, s);
  }
}

// Keys of one skip in the backward at DH, written to out[0..1]: the dQ
// kernel's key tile and a dK/dV warp's rows (16, the MMA's m).
int ertdx_flash_bwd_tiles(int DH, int* out) {
  switch (DH) {
    case 64: out[0] = BwdTiles<64>::BK; break;
    case 128: out[0] = BwdTiles<128>::BK; break;
    case 256: out[0] = BwdTiles<256>::BK; break;
    default: return (int)cudaErrorInvalidValue;
  }
  out[1] = 16;
  return 0;
}

}  // extern "C"
