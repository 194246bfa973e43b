// Flash attention with a key mask, forward and backward (sm_90a, fp32 FMA).
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
// and p = 1 in the backward, as in JAX: no key tile is ever skipped.
//
// What bounds it on an H100: operations. At the encoder's flash shape
// (B H = 1024, L = 256 padded from 147, DH = 64) the forward does
// 4 BH L^2 DH = 17.2 GFLOP against 268 MB, the backward 10 BH L^2 DH =
// 42.9 GFLOP against 537 MB: 0.256 and 0.641 ms at 67 TFLOP/s fp32.
//
// What the design does about it, and what it changes from the TPU kernel:
//   * The TPU kernel keeps a whole (Lk, DH) K and V of one (b, h) in VMEM
//     (and the dK/dV kernel a whole Q and dO). Here both loops are tiled
//     over shared-memory blocks of 32 to 128 rows, so any L fits; the
//     tile sizes (Tiles<DH> below) are chosen per head width to keep one
//     to three blocks resident per SM.
//   * Every product is a register-tiled fp32 FMA loop: 256 threads as a
//     16 x 16 grid, each owning RM rows of the output tile. The inner
//     loops are bound by shared-memory loads, not FMAs, unless each load
//     is a 16-byte vector: tiles sit in shared memory with rows padded to
//     DH+4 (or BK+4) floats, S- and dP-type products (mm_nt) read both
//     operands 4 k at a time, and P V-type products (mm_nn) give each
//     thread 4 adjacent output columns per 64, read as one vector per k.
//     A k step then needs about 3 wavefronts of shared memory for 16
//     FMAs, where scalar loads needed 8. No TF32, no tensor cores: the
//     TPU kernel runs Precision.HIGHEST.
//   * The forward's running max and sum live in shared memory per row; a
//     warp updates 1/8 of the tile's rows after each S tile.
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

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TG = 16;                 // the thread grid is TG x TG
constexpr float NEG = -1e30f;          // the TPU kernel's mask bias

// Tile rows per head width: forward (query, key), dQ (query, key), dK/dV
// (key, query). Shared memory per block is in the launchers. The
// forward's 128-row query tile at DH=64 gives each thread 8 rows (fewer
// shared-memory loads per FMA) in 128 registers, 2 blocks of 106 KB an SM.
template <int DH> struct Tiles;
template <> struct Tiles<64> {
  static constexpr int FQ = 128, FK = 64, QQ = 64, QK = 64, KK = 64, KQ = 64;
};
template <> struct Tiles<128> {
  static constexpr int FQ = 64, FK = 32, QQ = 64, QK = 32, KK = 32, KQ = 32;
};
template <> struct Tiles<256> {
  static constexpr int FQ = 32, FK = 32, QQ = 32, QK = 32, KK = 32, KQ = 32;
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

template <int DH, int BQ, int BK>
constexpr size_t dq_smem() {
  return sizeof(float) * ((2 * BQ + 2 * BK) * (DH + 4) + BQ * (BK + 4) +
                          BK + 2 * BQ);
}

// grid (B H, Lq / BQ). Writes dQ and delta (B H, Lq).
template <int DH, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ mask,
                        const float* __restrict__ o,
                        const float* __restrict__ lse,
                        const float* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ delta,
                        int H, int Lq, int Lk, float scale) {
  constexpr int LD = DH + 4, LS = BK + 4;
  constexpr int RM = BQ / TG, CN = BK / TG, CV = DH / 64;
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x LD
  float* dOs = Qs + BQ * LD;        // BQ x LD
  float* Ks = dOs + BQ * LD;        // BK x LD
  float* Vs = Ks + BK * LD;         // BK x LD
  float* dSs = Vs + BK * LD;        // BQ x LS
  float* bias = dSs + BQ * LS;      // BK
  float* lse_s = bias + BK;         // BQ
  float* del_s = lse_s + BQ;        // BQ

  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, tx = tid % TG, ty = tid / TG;
  const int warp = tid / 32, lane = tid % 32;
  const size_t row0 = (size_t)bh * Lq + q0;
  const float* kg = k + (size_t)bh * Lk * DH;
  const float* vg = v + (size_t)bh * Lk * DH;
  const float* mg = mask + (size_t)(bh / H) * Lk;

  load_rows<BQ, DH>(Qs, q + row0 * DH, 1.f);
  load_rows<BQ, DH>(dOs, dout + row0 * DH, 1.f);
  for (int r = tid; r < BQ; r += THREADS) lse_s[r] = lse[row0 + r];
  __syncthreads();
  // delta = rowsum(dO o O), one warp per row
  for (int r = warp; r < BQ; r += WARPS) {
    const float* orow = o + (row0 + r) * DH;
    float sum = 0.f;
    for (int c = lane; c < DH; c += 32) sum += dOs[r * LD + c] * orow[c];
    sum = warp_sum(sum);
    if (lane == 0) {
      del_s[r] = sum;
      delta[row0 + r] = sum;
    }
  }
  float acc[RM][4 * CV];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * CV; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();
    load_rows<BK, DH>(Ks, kg + (size_t)k0 * DH, 1.f);
    load_rows<BK, DH>(Vs, vg + (size_t)k0 * DH, 1.f);
    for (int j = tid; j < BK; j += THREADS)
      bias[j] = mg[k0 + j] > 0.f ? 0.f : NEG;
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_nt<RM, CN, DH>(s, Qs, LD, Ks, LD, ty, tx);
    mm_nt<RM, CN, DH>(dp, dOs, LD, Vs, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + TG * j;
        const float p = expf(s[i][j] * scale + bias[c] - lse_s[r]);
        dSs[r * LS + c] = p * (dp[i][j] - del_s[r]);
      }
    }
    __syncthreads();
    mm_nn<RM, CV, BK>(acc, dSs, LS, Ks, LD, ty, tx);
  }

  store_rows<RM, CV>(dq + row0 * DH, DH, acc, ty, tx, scale);
}

template <int DH, int BK, int BQ>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((2 * BK + 2 * BQ) * (DH + 4) +
                          2 * BK * (BQ + 4) + BK + 2 * BQ);
}

// grid (B H, Lk / BK): one block per (batch row and head, key tile),
// looping over the query tiles. Reads delta from the dQ kernel.
template <int DH, int BK, int BQ>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ mask,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ dout,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Lq, int Lk, float scale) {
  constexpr int LD = DH + 4, LP = BQ + 4;
  constexpr int RM = BK / TG, CN = BQ / TG, CV = DH / 64;
  extern __shared__ float smem[];
  float* Ks = smem;                 // BK x LD
  float* Vs = Ks + BK * LD;         // BK x LD
  float* Qs = Vs + BK * LD;         // BQ x LD
  float* dOs = Qs + BQ * LD;        // BQ x LD
  float* Ps = dOs + BQ * LD;        // BK x LP: P^T
  float* dSs = Ps + BK * LP;        // BK x LP: dS^T
  float* bias = dSs + BK * LP;      // BK
  float* lse_s = bias + BK;         // BQ
  float* del_s = lse_s + BQ;        // BQ

  const int bh = blockIdx.x, k0 = blockIdx.y * BK;
  const int tid = threadIdx.x, tx = tid % TG, ty = tid / TG;
  const size_t krow0 = (size_t)bh * Lk + k0;
  const float* qg = q + (size_t)bh * Lq * DH;
  const float* dog = dout + (size_t)bh * Lq * DH;
  const float* mg = mask + (size_t)(bh / H) * Lk;

  load_rows<BK, DH>(Ks, k + krow0 * DH, 1.f);
  load_rows<BK, DH>(Vs, v + krow0 * DH, 1.f);
  for (int j = tid; j < BK; j += THREADS)
    bias[j] = mg[k0 + j] > 0.f ? 0.f : NEG;
  float dk_acc[RM][4 * CV], dv_acc[RM][4 * CV];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * CV; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    __syncthreads();
    load_rows<BQ, DH>(Qs, qg + (size_t)q0 * DH, 1.f);
    load_rows<BQ, DH>(dOs, dog + (size_t)q0 * DH, 1.f);
    for (int r = tid; r < BQ; r += THREADS) {
      lse_s[r] = lse[(size_t)bh * Lq + q0 + r];
      del_s[r] = delta[(size_t)bh * Lq + q0 + r];
    }
    __syncthreads();

    // S^T and dP^T of this (key tile, query tile): rows keys, cols queries
    float st[RM][CN], dpt[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) st[i][j] = dpt[i][j] = 0.f;
    mm_nt<RM, CN, DH>(st, Ks, LD, Qs, LD, ty, tx);
    mm_nt<RM, CN, DH>(dpt, Vs, LD, dOs, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + TG * j;
        const float p = expf(st[i][j] * scale + bias[r] - lse_s[c]);
        Ps[r * LP + c] = p;
        dSs[r * LP + c] = p * (dpt[i][j] - del_s[c]);
      }
    }
    __syncthreads();
    mm_nn<RM, CV, BQ>(dv_acc, Ps, LP, dOs, LD, ty, tx);
    mm_nn<RM, CV, BQ>(dk_acc, dSs, LP, Qs, LD, ty, tx);
  }

  store_rows<RM, CV>(dk + krow0 * DH, DH, dk_acc, ty, tx, scale);
  store_rows<RM, CV>(dv + krow0 * DH, DH, dv_acc, ty, tx, 1.f);
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
  using T = Tiles<DH>;
  constexpr size_t bytes = dq_smem<DH, T::QQ, T::QK>();
  auto kern = flash_bwd_dq_kernel<DH, T::QQ, T::QK>;
  cudaError_t err = set_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(BH, Lq / T::QQ), THREADS, bytes, s>>>(
      q, k, v, mask, o, lse, dout, dq, delta, H, Lq, Lk, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t bwd_dkv(const float* q, const float* k, const float* v,
                    const float* mask, const float* lse, const float* delta,
                    const float* dout, float* dk, float* dv, int BH, int H,
                    int Lq, int Lk, float scale, cudaStream_t s) {
  using T = Tiles<DH>;
  constexpr size_t bytes = dkv_smem<DH, T::KK, T::KQ>();
  auto kern = flash_bwd_dkv_kernel<DH, T::KK, T::KQ>;
  cudaError_t err = set_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(BH, Lk / T::KK), THREADS, bytes, s>>>(
      q, k, v, mask, lse, delta, dout, dk, dv, H, Lq, Lk, scale);
  return cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  switch (DH) {
    case 64: return (int)bwd_dkv<64>(q, k, v, mask, lse, delta, dout, dk, dv, BH, H, Lq, Lk, scale, s);
    case 128: return (int)bwd_dkv<128>(q, k, v, mask, lse, delta, dout, dk, dv, BH, H, Lq, Lk, scale, s);
    default: return (int)bwd_dkv<256>(q, k, v, mask, lse, delta, dout, dk, dv, BH, H, Lq, Lk, scale, s);
  }
}

}  // extern "C"
