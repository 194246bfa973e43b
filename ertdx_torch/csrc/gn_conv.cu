// Fused GroupNorm + SiLU + Conv1d(k=3, stride 1, SAME), forward and
// backward (sm_90a; the products on the 3xTF32 tensor-core tile of
// tf32x3.cuh).
//
// Replaces the TPU kernels of ertdx/ops/conv.py:
//   * the statistics (gn_stats_{staged,stream}_kernel), gn_affine_kernel
//     + tap3_gemm_kernel<true, false>
//                                  <- _gn_silu_conv3_kernel (:49-82)
//   * the statistics, gn_affine_kernel, conv_dw_kernel + sum_rows_kernel
//     (dW, db), tap3_gemm_kernel<false, true> (dh) and the GN backward
//     (gn_bwd_{staged,stream}_kernel, from those statistics) +
//     sum_rows_kernel (dx, dgamma, dbeta)
//                                  <- _gn_silu_conv3_bwd_kernel (:109-180)
// x (B, L, C), h = silu(GN(x)) with G groups, w (3, C, Cout), bias (Cout):
//   y[l] = h[l-1] w[0] + h[l] w[1] + h[l+1] w[2] + bias,
// h zero outside [0, L) ("SAME" padding of the conv's input). Backward:
//   dW[k] = sum_(b,l) h[l-1+k]^T g[l],  db = sum_(b,l) g[l],
//   dh[l] = g[l+1] w[0]^T + g[l] w[1]^T + g[l-1] w[2]^T,
// then the SiLU chain rule and the GN identity on dh (gn_common.cuh).
//
// What bounds it on an H100: operations. The products are 2 B L 3 C Cout
// FLOP: 29.6 GFLOP at the encoder's (256, 294, 256 -> 256), 0.180 ms at
// the 3xTF32 rate (494.7 / 3 TFLOP/s), 0.442 ms on the fp32 pipe; the
// backward does twice that (dW and dh). One TF32 rounding of each operand
// misses the 1e-4 x max(1, max|plain|) gate by about 3x, the 3xTF32 split
// passes it by orders of magnitude (tests/test_torch_conv_tf32x3.py).
//
// What the design does about it, and what it changes from the TPU kernel
// (the alternatives named here were timed by tools/conv_ab.py, PERF.md):
//   * The TPU kernel holds a whole (L, C) row in VMEM and runs three
//     shifted (L, C) @ (C, Cout) products on the MXU. Here the product is
//     a GEMM written out in the kernel (no cuBLAS, cuDNN or CUTLASS device
//     GEMM) on mma.sync m16n8k8 TF32, three MMAs a product. M is the
//     B L positions flattened over the batch, N the output channels, K the
//     3 taps x input channels. A block owns TM = 128 rows by TN = 128
//     columns, 8 warps of 64 x 32; at the encoder's lengths the tiles
//     waste no row (75,264 = 588 x 128; 37,632 = 294 x 128), where tiles
//     within a batch row (25-50 % slower) padded L=147 to 256. A tile may
//     span batch rows: tap 0 of a row with l = 0 and tap 2 of a row with
//     l = L-1 are zeroed in the A fragment (one bit a row, set once per
//     block).
//   * Tap j's A fragment is the same shared tile read j rows further
//     down; one A fragment serves every n tile of a warp, one B fragment
//     every m tile. Forward: B is w[j] (C x Cout, contiguous along Cout),
//     an nn operand. dh: B is w[2-j]^T, i.e. w[2-j] read as an nt
//     operand; no transposed copy of the weights (a transposed copy for
//     the forward was slower).
//   * A two-stage cp.async ring carries the A rows [m0-1, m0+TM] and the
//     three taps' weights for 32 input channels, so the next chunk is in
//     flight while the current one computes. In the forward, once a stage
//     has landed each thread applies GN+SiLU in place to the elements it
//     copied, from per-(row, channel) mean and rstd * gamma
//     (gn_affine_kernel, after the statistics) and the SFU's exp2 and
//     reciprocal; h never goes to device memory, as in the TPU kernel
//     (writing h first by an elementwise pass was no faster).
//   * Each chunk's MMAs sum from zero and are added to the accumulator in
//     fp32 (PR 11's rule for the fused core): with the whole K on the
//     MMA's accumulator the fused arm's train step missed phase 11's loss
//     gate. The accumulator and the chunk's partial take 128 registers; the
//     chunk's k steps stay rolled (and dh's taps), which keeps ptxas from
//     spilling. The epilogue adds the bias and stores (c0, c1) pairs as
//     8-byte stores.
//   * dW is a reduction over the B L rows into a (3 C, Cout) result that
//     is too small to fill the card by output tiles alone (8 tiles of
//     64 x 128 at 256 channels). The rows are split S ways into
//     contiguous ranges (S from the SM count, so that all blocks run in
//     one wave): a block owns 64 input by 128 output channels, all three
//     taps, and walks its range 32 rows a stage, each stage's h rows
//     (GN+SiLU applied in place) and g rows through a three-stage ring.
//     The A operand is h^T, read from the row-major (rows x channels)
//     tile by tf32x3::load_a_t; tap j reads it j rows further down, and
//     the rows whose tap crosses a batch row are zeroed by two 32-bit
//     masks a stage. Each tap's 32-row chunk sums from zero and is added
//     in fp32 (on the MMA's accumulator dW took 15 % less time but came
//     out 3.6x further from the plain version). db, the column sum of g,
//     is summed from the same B fragments. Each split writes its own
//     partial; a second launch adds the S partials in order. No float
//     atomics: two runs give the same bits. The TPU's per-row (B, 3, C,
//     Cout) partials (201 MB at the encoder shape) are not carried over.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError().

#include <stdint.h>

#include "bf16mma.cuh"
#include "gn_common.cuh"
#include "tf32x3.cuh"

namespace {

// the tap GEMM (forward and dh)
constexpr int TM = 128;               // flattened rows of a GEMM block
constexpr int TN = 128;               // output channels of a GEMM block
constexpr int KC = 32;                // input channels a stage
constexpr int STAGES = 2;             // depth of the cp.async ring
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = TM / WARPS_M, WN = TN / WARPS_N;
constexpr int MT = WM / 16, NT = WN / 8;   // a warp's m16 and n8 tiles
constexpr int A_ROWS = TM + 2;             // the taps' halo rows
constexpr int LDA = KC + 8;           // 8 (mod 32): load_a_perm
constexpr int LDB_NN = TN + 4;        // (KC, TN) forward tile: load_b_nn
constexpr int LDB_NT = KC + 8;        // (TN, KC) dh tile: load_b_nt_perm
constexpr int A_FLOATS = A_ROWS * LDA;
constexpr int A_UNITS = (A_ROWS * KC / 4 + THREADS - 1) / THREADS;

// floats of a ring stage: the A rows, then the three taps' weights
constexpr int STAGE_NN = A_FLOATS + 3 * KC * LDB_NN;    // forward
constexpr int STAGE_NT = A_FLOATS + 3 * TN * LDB_NT;    // dh

// dW and db
constexpr int DW_TC = 64;             // input channels of a dW block
constexpr int DW_TN = 128;            // output channels of a dW block
constexpr int DW_KR = 32;             // rows a stage (one mask bit each)
constexpr int DW_STAGES = 3;
constexpr int DW_WARPS_C = 2, DW_WARPS_N = 4;
constexpr int DW_THREADS = 32 * DW_WARPS_C * DW_WARPS_N;
constexpr int DW_WM = DW_TC / DW_WARPS_C, DW_WN = DW_TN / DW_WARPS_N;
constexpr int DW_MT = DW_WM / 16, DW_NT = DW_WN / 8;
constexpr int LDH = DW_TC + 4;        // 4 (mod 32): load_a_t
constexpr int LDG = DW_TN + 4;        // 4 (mod 32): load_b_nn
constexpr int H_FLOATS = (DW_KR + 2) * LDH;
constexpr int G_FLOATS = DW_KR * LDG;
constexpr int DW_SF = H_FLOATS + G_FLOATS + 4;   // + the two row masks
constexpr int H_UNITS =
    ((DW_KR + 2) * DW_TC / 4 + DW_THREADS - 1) / DW_THREADS;
constexpr int G_UNITS = (DW_KR * DW_TN / 4 + DW_THREADS - 1) / DW_THREADS;
static_assert(3 * KC * TN / 4 % THREADS == 0, "GEMM weight units");
static_assert(DW_KR <= 32, "one mask bit a row");
static_assert(DW_THREADS % (DW_TC / 4) == 0, "an h unit's channel is fixed");

// Where the (row, channel) affine table starts in the statistics
// scratch: after the (B, G, 2) statistics, on a 16-byte boundary.
inline size_t affine_offset(int B, int G) {
  return ((size_t)2 * B * G + 3) & ~(size_t)3;
}

// aff (B, C, 2): each (row, channel)'s group mean and rstd * gamma, from
// the statistics. Grid covers B C.
__global__ void gn_affine_kernel(const float* __restrict__ stats,
                                 const float* __restrict__ gamma,
                                 float* __restrict__ aff, int C, int G,
                                 int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int b = i / C, c = i % C;
  const size_t s = 2 * ((size_t)b * G + c / (C / G));
  aff[2 * (size_t)i] = stats[s];
  aff[2 * (size_t)i + 1] = stats[s + 1] * gamma[c];
}

// y / (1 + e^-y) by the SFU's exp2 and reciprocal (a few ulp; expf and
// an IEEE division made the GEMMs' prologue 0.06-0.1 ms slower at the
// encoder's shape, PERF.md)
__device__ __forceinline__ float fast_silu(float y) {
  return __fdividef(y, 1.f + __expf(-y));
}

// silu((v - mean) * scale + beta) of 4 consecutive channels; ms holds
// (mean, scale) pairs of the 4 channels, as in the affine table.
__device__ __forceinline__ float4 gn_silu4(float4 v, const float* ms,
                                           float4 be) {
  const float4 p = *reinterpret_cast<const float4*>(ms);
  const float4 q = *reinterpret_cast<const float4*>(ms + 4);
  return make_float4(fast_silu((v.x - p.x) * p.y + be.x),
                     fast_silu((v.y - p.z) * p.w + be.y),
                     fast_silu((v.z - q.x) * q.y + be.z),
                     fast_silu((v.w - q.z) * q.w + be.w));
}

__device__ __forceinline__ void zero_rows(tf32x3::FragA& f, bool top,
                                          bool bottom) {
  if (top) f.hi[0] = f.lo[0] = f.hi[2] = f.lo[2] = 0u;
  if (bottom) f.hi[1] = f.lo[1] = f.hi[3] = f.lo[3] = 0u;
}

// The first flattened row of GEMM tile `tile` and the end (exclusive) of
// the rows it writes: tiles of TM rows over the B L flattened rows, so a
// tile may span batch rows (the taps are masked at their edges).
__device__ __forceinline__ int2 tile_rows(int tile, int M, int L) {
  const int m0 = tile * TM;
  return make_int2(m0, min(M, m0 + TM));
}

int gemm_tiles(int M, int L) { return (M + TM - 1) / TM; }

// part += tap j's product over the 8 input channels from kk of a staged
// chunk, for the warp's WM x WN output. `first` / `last` hold a bit per
// fragment row (2 i + half) whose tap 0 / tap 2 crosses a batch row.
template <bool WT>
__device__ __forceinline__ void gemm_tap(float (&part)[MT][NT][4],
                                         const float* As, const float* Bs,
                                         int j, int kk, unsigned first,
                                         unsigned last, int wm, int wn,
                                         int lane) {
  using namespace tf32x3;
  FragB fb[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (WT)
      load_b_nt_perm(fb[n], Bs + j * TN * LDB_NT, LDB_NT, wn + 8 * n, kk,
                     lane);
    else
      load_b_nn(fb[n], Bs + j * KC * LDB_NN, LDB_NN, kk, wn + 8 * n, lane);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    FragA fa;
    load_a_perm(fa, As + j * LDA, LDA, wm + 16 * i, kk, lane);
    if (j != 1) {
      const unsigned dead = j == 0 ? first : last;
      zero_rows(fa, (dead >> (2 * i)) & 1u, (dead >> (2 * i + 1)) & 1u);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) mma3(part[i][n], fa, fb[n]);
  }
}

// part += one staged chunk: the three taps over KC input channels. The k
// steps stay rolled, and in dh the taps too: unrolled, ptxas spilled at
// the 255 registers the accumulator and the chunk's partial leave room
// for (PERF.md).
template <bool WT>
__device__ __forceinline__ void gemm_chunk(float (&part)[MT][NT][4],
                                           const float* As, const float* Bs,
                                           unsigned first, unsigned last,
                                           int wm, int wn, int lane) {
#pragma unroll 1
  for (int kk = 0; kk < KC; kk += 8) {
    if (WT) {
#pragma unroll 1
      for (int j = 0; j < 3; ++j)
        gemm_tap<WT>(part, As, Bs, j, kk, first, last, wm, wn, lane);
    } else {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        gemm_tap<WT>(part, As, Bs, j, kk, first, last, wm, wn, lane);
    }
  }
}

// out[m, :] = bias + sum_j A[m-1+j, :] @ W_j over the M = B L flattened
// rows, with A[m-1+j] = 0 where row m-1+j lies outside m's batch row.
// GN: A = silu(GN(a)) from the affine table `aff` and beta, else A = a.
// WT = false: W_j = w[j], w (3, K, N). WT = true: W_j = w[2-j]^T, w
// (3, N, K). Grid (gemm_tiles(M, L), ceil(N/TN)), THREADS threads,
// STAGES * (WT ? STAGE_NT : STAGE_NN) floats of dynamic shared memory.
template <bool GN, bool WT>
__global__ void __launch_bounds__(THREADS, 1)
    tap3_gemm_kernel(const float* __restrict__ a,
                     const float* __restrict__ aff,
                     const float* __restrict__ beta,
                     const float* __restrict__ w,
                     const float* __restrict__ bias,
                     float* __restrict__ out, int M, int L, int K, int N) {
  using namespace tf32x3;
  extern __shared__ __align__(16) float smem[];
  constexpr int SF = WT ? STAGE_NT : STAGE_NN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int2 rows = tile_rows(blockIdx.x, M, L);
  const int m0 = rows.x, n0 = blockIdx.y * TN;
  const int wm = WM * (warp % WARPS_M), wn = WN * (warp / WARPS_M);
  const int chunks = (K + KC - 1) / KC;

  unsigned first = 0u, last = 0u;
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    const int l = (m0 + wm + 16 * (r >> 1) + (lane >> 2) + 8 * (r & 1)) % L;
    first |= (unsigned)(l == 0) << r;
    last |= (unsigned)(l == L - 1) << r;
  }
  // the batch row of each A unit this thread copies (-1: outside [0, M))
  int arow[A_UNITS];
#pragma unroll
  for (int u = 0; u < A_UNITS; ++u) {
    const int m = m0 - 1 + (tid + u * THREADS) / (KC / 4);
    arow[u] = (m >= 0 && m < M) ? m / L : -1;
  }

  auto stage = [&](int ch) {
    float* As = smem + (ch % STAGES) * SF;
    float* Bs = As + A_FLOATS;
    const int k0 = ch * KC;
#pragma unroll
    for (int u = 0; u < A_UNITS; ++u) {
      const int i = tid + u * THREADS;
      if (i < A_ROWS * KC / 4) {
        const int r = i / (KC / 4), c = (i % (KC / 4)) * 4;
        const bool ok = arow[u] >= 0 && k0 + c < K;
        cp16(As + r * LDA + c,
             a + (ok ? (size_t)(m0 - 1 + r) * K + k0 + c : 0), ok);
      }
    }
#pragma unroll
    for (int u = 0; u < 3 * KC * TN / 4 / THREADS; ++u) {
      const int i = tid + u * THREADS;
      if (WT) {             // tap j's rows n of KC floats along k
        const int j = i / (TN * KC / 4), n = i / (KC / 4) % TN;
        const int c = (i % (KC / 4)) * 4;
        const bool ok = n0 + n < N && k0 + c < K;
        cp16(Bs + (j * TN + n) * LDB_NT + c,
             w + (ok ? ((size_t)(2 - j) * N + n0 + n) * K + k0 + c : 0), ok);
      } else {              // tap j's rows k of TN floats along n
        const int j = i / (KC * TN / 4), k = i / (TN / 4) % KC;
        const int c = (i % (TN / 4)) * 4;
        const bool ok = k0 + k < K && n0 + c < N;
        cp16(Bs + (j * KC + k) * LDB_NN + c,
             w + (ok ? ((size_t)j * K + k0 + k) * N + n0 + c : 0), ok);
      }
    }
    cp_commit();
  };

  // GN+SiLU in place on the A units this thread copied (its own cp.async
  // writes are visible to it after the wait)
  auto gn_silu_tile = [&](int ch) {
    float* As = smem + (ch % STAGES) * SF;
    const int k0 = ch * KC;
#pragma unroll
    for (int u = 0; u < A_UNITS; ++u) {
      const int i = tid + u * THREADS;
      const int r = i / (KC / 4), c = (i % (KC / 4)) * 4;
      if (i < A_ROWS * KC / 4 && arow[u] >= 0 && k0 + c < K) {
        float4* p = reinterpret_cast<float4*>(As + r * LDA + c);
        *p = gn_silu4(*p, aff + 2 * ((size_t)arow[u] * K + k0 + c),
                      *reinterpret_cast<const float4*>(beta + k0 + c));
      }
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks)
      stage(s);
    else
      cp_commit();
  }
  float acc[MT][NT][4] = {};
  for (int ch = 0; ch < chunks; ++ch) {
    cp_wait<STAGES - 2>();
    if (GN) gn_silu_tile(ch);
    __syncthreads();        // chunk ch is in place; ch - 1's slot is free
    if (ch + STAGES - 1 < chunks)
      stage(ch + STAGES - 1);
    else
      cp_commit();
    const float* As = smem + (ch % STAGES) * SF;
    float part[MT][NT][4] = {};
    gemm_chunk<WT>(part, As, As + A_FLOATS, first, last, wm, wn, lane);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] += part[i][n][e];
  }
  cp_wait<0>();

  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n0 + wn + 8 * n + 2 * t;
    if (col >= N) continue;      // N % 4 == 0: col and col + 1 share fate
    const float b0 = bias != nullptr ? bias[col] : 0.f;
    const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + (lane >> 2) + 8 * h;
        if (m < rows.y)
          *reinterpret_cast<float2*>(out + (size_t)m * N + col) =
              make_float2(acc[i][n][2 * h] + b0, acc[i][n][2 * h + 1] + b1);
      }
  }
}

// acc[j] += one staged dW chunk for tap j = 0, 1, 2: h^T (rows j ..
// j + DW_KR of the h tile) times g, each tap's MMAs summed from zero and
// added in fp32; dbp += g's column sums (db_warp only). `first` / `last`
// hold a bit per g row whose tap 0 / tap 2 crosses a batch row.
__device__ __forceinline__ void dw_chunk(
    float (&acc)[3][DW_MT][DW_NT][4], float (&dbp)[DW_NT], const float* Hs,
    const float* Gs, unsigned first, unsigned last, bool db_warp, int wc,
    int wn, int lane) {
  using namespace tf32x3;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float part[DW_MT][DW_NT][4] = {};
#pragma unroll 2         // fully unrolled, ptxas spilled (PERF.md)
    for (int kk = 0; kk < DW_KR; kk += 8) {
      FragB fb[DW_NT];
#pragma unroll
      for (int n = 0; n < DW_NT; ++n) {
        load_b_nn(fb[n], Gs, LDG, kk, wn + 8 * n, lane);
        if (j == 0 && db_warp)     // hi + lo is g exactly
          dbp[n] += (__uint_as_float(fb[n].hi[0]) +
                     __uint_as_float(fb[n].lo[0])) +
                    (__uint_as_float(fb[n].hi[1]) +
                     __uint_as_float(fb[n].lo[1]));
      }
      const int k = kk + 2 * (lane & 3);
      const unsigned dead = j == 0 ? first : j == 2 ? last : 0u;
#pragma unroll
      for (int i = 0; i < DW_MT; ++i) {
        FragA fa;
        load_a_t(fa, Hs + j * LDH, LDH, wc + 16 * i, kk, lane);
        if (j != 1) {      // fragment k columns 2t (a0, a1), 2t+1 (a2, a3)
          if ((dead >> k) & 1u) fa.hi[0] = fa.lo[0] = fa.hi[1] = fa.lo[1] = 0u;
          if ((dead >> (k + 1)) & 1u)
            fa.hi[2] = fa.lo[2] = fa.hi[3] = fa.lo[3] = 0u;
        }
#pragma unroll
        for (int n = 0; n < DW_NT; ++n) mma3(part[i][n], fa, fb[n]);
      }
    }
#pragma unroll
    for (int i = 0; i < DW_MT; ++i)
#pragma unroll
      for (int n = 0; n < DW_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][i][n][e] += part[i][n][e];
  }
}

// Partial dW and db of split s of the M = B L flattened rows (contiguous
// ranges of DW_KR-row chunks): part[s] = [dW (3, C, Cout) | db (Cout)].
// h = silu(GN(x)) from the affine table and beta. Grid (ceil(C/DW_TC),
// ceil(Cout/DW_TN), S), DW_THREADS threads, DW_STAGES * DW_SF floats of
// dynamic shared memory.
__global__ void __launch_bounds__(DW_THREADS, 1)
    conv_dw_kernel(const float* __restrict__ x,
                   const float* __restrict__ aff,
                   const float* __restrict__ beta,
                   const float* __restrict__ gy, float* __restrict__ part,
                   int M, int L, int C, int Cout, int S) {
  using namespace tf32x3;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * DW_TC, o0 = blockIdx.y * DW_TN;
  const int s = blockIdx.z;
  const int wc = DW_WM * (warp % DW_WARPS_C), wn = DW_WN * (warp / DW_WARPS_C);
  const int total = (M + DW_KR - 1) / DW_KR, per = (total + S - 1) / S;
  const int ch0 = min(total, s * per), ch1 = min(total, ch0 + per);
  const bool db_warp = blockIdx.x == 0 && wc == 0;
  // an h unit's channel is the same in every unit of a thread
  const int hc = (tid % (DW_TC / 4)) * 4;
  const bool hc_ok = c0 + hc < C;
  const float4 be = hc_ok ? *reinterpret_cast<const float4*>(beta + c0 + hc)
                          : make_float4(0.f, 0.f, 0.f, 0.f);

  auto stage = [&](int ch) {
    float* Hs = smem + (ch - ch0) % DW_STAGES * DW_SF;
    float* Gs = Hs + H_FLOATS;
    const int r0 = ch * DW_KR;
#pragma unroll
    for (int u = 0; u < H_UNITS; ++u) {
      const int i = tid + u * DW_THREADS;
      if (i < (DW_KR + 2) * DW_TC / 4) {
        const int r = i / (DW_TC / 4), m = r0 - 1 + r;
        const bool ok = hc_ok && m >= 0 && m < M;
        cp16(Hs + r * LDH + hc, x + (ok ? (size_t)m * C + c0 + hc : 0), ok);
      }
    }
#pragma unroll
    for (int u = 0; u < G_UNITS; ++u) {
      const int i = tid + u * DW_THREADS;
      const int r = i / (DW_TN / 4), c = (i % (DW_TN / 4)) * 4;
      const int m = r0 + r;
      const bool ok = m < M && o0 + c < Cout;
      if (i < DW_KR * DW_TN / 4)
        cp16(Gs + r * LDG + c, gy + (ok ? (size_t)m * Cout + o0 + c : 0), ok);
    }
    if (warp == 0) {      // one mask bit per g row: tap 0 / tap 2 crosses
      const int l = (r0 + lane) % L;
      const unsigned f = __ballot_sync(FULL, lane < DW_KR && l == 0);
      const unsigned e = __ballot_sync(FULL, lane < DW_KR && l == L - 1);
      if (lane == 0) {
        unsigned* masks = reinterpret_cast<unsigned*>(Gs + G_FLOATS);
        masks[0] = f;
        masks[1] = e;
      }
    }
    cp_commit();
  };

  auto gn_silu_tile = [&](int ch) {
    float* Hs = smem + (ch - ch0) % DW_STAGES * DW_SF;
    const int r0 = ch * DW_KR;
#pragma unroll
    for (int u = 0; u < H_UNITS; ++u) {
      const int i = tid + u * DW_THREADS;
      const int r = i / (DW_TC / 4), m = r0 - 1 + r;
      if (i < (DW_KR + 2) * DW_TC / 4 && hc_ok && m >= 0 && m < M) {
        float4* p = reinterpret_cast<float4*>(Hs + r * LDH + hc);
        *p = gn_silu4(*p, aff + 2 * ((size_t)(m / L) * C + c0 + hc), be);
      }
    }
  };

  for (int k = 0; k < DW_STAGES - 1; ++k) {
    if (ch0 + k < ch1)
      stage(ch0 + k);
    else
      cp_commit();
  }
  float acc[3][DW_MT][DW_NT][4] = {};
  float dbp[DW_NT] = {};
  for (int ch = ch0; ch < ch1; ++ch) {
    cp_wait<DW_STAGES - 2>();
    gn_silu_tile(ch);
    __syncthreads();        // chunk ch is in place; ch - 1's slot is free
    if (ch + DW_STAGES - 1 < ch1)
      stage(ch + DW_STAGES - 1);
    else
      cp_commit();
    const float* Hs = smem + (ch - ch0) % DW_STAGES * DW_SF;
    const float* Gs = Hs + H_FLOATS;
    const unsigned* masks = reinterpret_cast<const unsigned*>(Gs + G_FLOATS);
    dw_chunk(acc, dbp, Hs, Gs, masks[0], masks[1], db_warp, wc, wn, lane);
  }
  cp_wait<0>();

  float* ps = part + (size_t)s * (3 * (size_t)C * Cout + Cout);
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < DW_NT; ++n) {
    const int o = o0 + wn + 8 * n + 2 * t;
    if (o >= Cout) continue;     // Cout % 4 == 0
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int i = 0; i < DW_MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + wc + 16 * i + (lane >> 2) + 8 * h;
          if (c < C)
            *reinterpret_cast<float2*>(ps + ((size_t)j * C + c) * Cout + o) =
                make_float2(acc[j][i][n][2 * h], acc[j][i][n][2 * h + 1]);
        }
  }
  if (db_warp) {
#pragma unroll
    for (int n = 0; n < DW_NT; ++n) {
      const float v = quad_sum(dbp[n]);
      const int o = o0 + wn + 8 * n + (lane >> 2);
      if (t == 0 && o < Cout) ps[3 * (size_t)C * Cout + o] = v;
    }
  }
}

int conv_shape_ok(int B, int L, int C, int Cout, int G) {
  return gn_shape_ok(B, L, C, G) && Cout >= 4 && Cout % 4 == 0 &&
         B <= 65535 && C % 4 == 0;
}

// the statistics (by plan p, gn_common.cuh) and the affine table of x
template <typename TX>
cudaError_t gn_tables(const TX* x, const float* gamma, float* stats,
                      int B, int L, int C, int G, float eps, GnPlan p,
                      cudaStream_t s) {
  cudaError_t err = gn_stats(x, stats, B, L, C, G, eps, p, s);
  if (err != cudaSuccess) return err;
  const int n = B * C;
  gn_affine_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      stats, gamma, stats + affine_offset(B, G), C, G, n);
  return cudaGetLastError();
}

template <bool GN, bool WT>
cudaError_t tap3_gemm(const float* a, const float* aff, const float* beta,
                      const float* w, const float* bias, float* out, int B,
                      int L, int K, int N, cudaStream_t s) {
  const size_t bytes = STAGES * (WT ? STAGE_NT : STAGE_NN) * sizeof(float);
  cudaError_t err = set_smem(tap3_gemm_kernel<GN, WT>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(gemm_tiles(B * L, L), (N + TN - 1) / TN);
  tap3_gemm_kernel<GN, WT><<<grid, THREADS, bytes, s>>>(a, aff, beta, w,
                                                         bias, out, B * L,
                                                         L, K, N);
  return cudaGetLastError();
}


// ---- bf16 --------------------------------------------------------------
//
// The same function on a bf16 x (ertdx/ops/conv.py computes in float32
// from any input dtype, its taps at DEFAULT precision: one bf16 MXU pass
// a product on the TPU, conv.py:15-17), with the TPU's arithmetic: the
// statistics from bf16 x in float32 (gn_common.cuh); GN+SiLU applied in
// float32 in the A tile's prologue and rounded to bf16; the weights
// rounded to bf16 once a call (by the wrapper: 3 C Cout values); one
// mma.sync m16n8k16 bf16 a product with float32 accumulation; the bias
// added in float32 and the output rounded once to bf16. The backward: dW
// and db from h recomputed in float32 and rounded to bf16, h^T g on the
// bf16 MMA, float32 partials summed in order; dh = g W^T taps on the
// bf16 MMA, kept in float32 (as conv.py:166-171 keeps it in VMEM); then
// the GN backward from the float32 statistics, dx in bf16. One bf16 MMA
// a product (the float32 kernels above run three TF32 MMAs).
//
// Tiles as the float32 GEMM's (128 x 128 over the B L flattened rows, 8
// warps of 64 x 32, the taps masked at batch-row edges in the A
// fragment), 32 input channels a stage of a three-stage cp.async ring in
// 16-byte units of 8 values; A through bf16mma::load_a (tap j reads the
// tile j rows further down), the forward's B (w[j], rows k) through
// ldmatrix.x4.trans (load_b_nn2), dh's (w[2-j]^T, rows n) by load_b_nt.
// Row strides of KC + 8 and TN + 8 values keep both conflict-free
// (bf16mma.cuh). The k steps accumulate on the MMA's float32
// accumulator: the bf16 rounding of h and W is the class's error, far
// above the sum's. dW: a block owns 64 input by 128 output channels of a
// split of the rows, 32 rows a stage through a three-stage ring; h^T is
// the A operand through bf16mma::load_a_t (ldmatrix.x4.trans of the
// row-major h tile), g the nn B operand; a tap's rows that cross a batch
// row are zeroed by halves of the A registers (k = row in the stage).

namespace bf {

constexpr int KC = 32;                // input channels a stage
constexpr int STAGES = 3;
constexpr int LDA = KC + 8;           // A rows (conflict-free load_a)
constexpr int LDB_NN = TN + 8;        // (KC, TN) forward tile, ldmatrix
constexpr int LDB_NT = KC + 8;        // (TN, KC) dh tile, load_b_nt
constexpr int A_ELEMS = A_ROWS * LDA;
constexpr int A_UNITS = (A_ROWS * KC / 8 + THREADS - 1) / THREADS;
constexpr int B_UNITS = 3 * KC * TN / 8 / THREADS;
constexpr int STAGE_NN = A_ELEMS + 3 * KC * LDB_NN;     // bf16 values
constexpr int STAGE_NT = A_ELEMS + 3 * TN * LDB_NT;
static_assert(3 * KC * TN / 8 % THREADS == 0, "GEMM weight units");
static_assert(STAGE_NN % 8 == 0 && STAGE_NT % 8 == 0 && A_ELEMS % 8 == 0,
              "16-byte stage boundaries");

constexpr int DW_KR = 32;             // rows a stage (one mask bit each)
constexpr int DW_STAGES = 3;
constexpr int LDH = DW_TC + 8;        // ldmatrix.trans rows, 144 bytes
constexpr int LDG = DW_TN + 8;        // 272 bytes
constexpr int H_ELEMS = (DW_KR + 2) * LDH;
constexpr int G_ELEMS = DW_KR * LDG;
constexpr int DW_SE = H_ELEMS + G_ELEMS + 8;   // + the two row masks
constexpr int H_UNITS = ((DW_KR + 2) * DW_TC / 8 + DW_THREADS - 1) /
                        DW_THREADS;
constexpr int G_UNITS = (DW_KR * DW_TN / 8 + DW_THREADS - 1) / DW_THREADS;
static_assert(DW_THREADS % (DW_TC / 8) == 0, "an h unit's channel is fixed");
static_assert(H_ELEMS % 8 == 0 && G_ELEMS % 8 == 0 && DW_SE % 8 == 0,
              "16-byte stage boundaries");

// silu(GN(v)) of 8 consecutive channels of bf16 v (a uint4), in float32,
// rounded to bf16; ms holds the channels' (mean, scale) pairs, be their
// beta
__device__ __forceinline__ uint4 gn_silu8(uint4 v, const float* ms,
                                          const float* be) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 p = *reinterpret_cast<const float4*>(ms + 4 * i);
    const float2 b = *reinterpret_cast<const float2*>(be + 2 * i);
    r[i] = bf16mma::pack(fast_silu((bf_lo(u[i]) - p.x) * p.y + b.x),
                   fast_silu((bf_hi(u[i]) - p.z) * p.w + b.y));
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ void zero_rows(uint32_t (&a)[4], bool top,
                                          bool bottom) {
  if (top) a[0] = a[2] = 0u;       // fragment row g
  if (bottom) a[1] = a[3] = 0u;    // fragment row g + 8
}

// acc += the three taps of one k step of 16 input channels at kk of a
// staged chunk, for the warp's WM x WN output.
template <bool WT>
__device__ __forceinline__ void gemm_step(float (&acc)[MT][NT][4],
                                          const bf16* As, const bf16* Bs,
                                          int kk, unsigned first,
                                          unsigned last, int wm, int wn,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    uint32_t b[NT][2];
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      if (WT) {
        bf16mma::load_b_nt(b[n], Bs + j * TN * LDB_NT, LDB_NT, wn + 8 * n,
                           kk, lane);
        bf16mma::load_b_nt(b[n + 1], Bs + j * TN * LDB_NT, LDB_NT,
                           wn + 8 * n + 8, kk, lane);
      } else {
        uint32_t q[4];
        bf16mma::load_b_nn2(q, Bs + j * KC * LDB_NN, LDB_NN, kk, wn + 8 * n,
                            lane);
        b[n][0] = q[0]; b[n][1] = q[1];
        b[n + 1][0] = q[2]; b[n + 1][1] = q[3];
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t a[4];
      bf16mma::load_a(a, As + j * LDA, LDA, wm + 16 * i, kk, lane);
      if (j != 1) {
        const unsigned dead = j == 0 ? first : last;
        zero_rows(a, (dead >> (2 * i)) & 1u, (dead >> (2 * i + 1)) & 1u);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) bf16mma::mma(acc[i][n], a, b[n][0],
                                                b[n][1]);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = bf16mma::pack(a, b);
}

// out[m, :] = bias + sum_j A[m-1+j, :] @ W_j over the M = B L flattened
// rows of bf16 a, as tap3_gemm_kernel: GN: A = silu(GN(a)) from the
// affine table and beta (float32), rounded to bf16, else A = a. WT =
// false: W_j = w[j], w (3, K, N); WT = true: W_j = w[2-j]^T, w (3, N, K);
// w bf16, bias float32 or null, out TO. K and N multiples of 8. Grid
// (gemm_tiles(M, L), ceil(N/TN)), THREADS threads, STAGES * (WT ?
// STAGE_NT : STAGE_NN) bf16 values of dynamic shared memory.
template <bool GN, bool WT, typename TO>
__global__ void __launch_bounds__(THREADS, 1)
    tap3_gemm_bf16_kernel(const bf16* __restrict__ a,
                          const float* __restrict__ aff,
                          const float* __restrict__ beta,
                          const bf16* __restrict__ w,
                          const float* __restrict__ bias,
                          TO* __restrict__ out, int M, int L, int K, int N) {
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  bf16* smem = reinterpret_cast<bf16*>(gemm_smem);
  constexpr int SE = WT ? STAGE_NT : STAGE_NN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int2 rows = tile_rows(blockIdx.x, M, L);
  const int m0 = rows.x, n0 = blockIdx.y * TN;
  const int wm = WM * (warp % WARPS_M), wn = WN * (warp / WARPS_M);
  const int chunks = (K + KC - 1) / KC;

  unsigned first = 0u, last = 0u;
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    const int l = (m0 + wm + 16 * (r >> 1) + (lane >> 2) + 8 * (r & 1)) % L;
    first |= (unsigned)(l == 0) << r;
    last |= (unsigned)(l == L - 1) << r;
  }
  // the batch row of each A unit this thread copies (-1: outside [0, M))
  int arow[A_UNITS];
#pragma unroll
  for (int u = 0; u < A_UNITS; ++u) {
    const int m = m0 - 1 + (tid + u * THREADS) / (KC / 8);
    arow[u] = (m >= 0 && m < M) ? m / L : -1;
  }

  auto stage = [&](int ch) {
    bf16* As = smem + (ch % STAGES) * SE;
    bf16* Bs = As + A_ELEMS;
    const int k0 = ch * KC;
#pragma unroll
    for (int u = 0; u < A_UNITS; ++u) {
      const int i = tid + u * THREADS;
      if (i < A_ROWS * KC / 8) {
        const int r = i / (KC / 8), c = (i % (KC / 8)) * 8;
        const bool ok = arow[u] >= 0 && k0 + c < K;
        bf16mma::cp16(As + r * LDA + c,
                      a + (ok ? (size_t)(m0 - 1 + r) * K + k0 + c : 0), ok);
      }
    }
#pragma unroll
    for (int u = 0; u < B_UNITS; ++u) {
      const int i = tid + u * THREADS;
      if (WT) {             // tap j's rows n of KC values along k
        const int j = i / (TN * KC / 8), n = i / (KC / 8) % TN;
        const int c = (i % (KC / 8)) * 8;
        const bool ok = n0 + n < N && k0 + c < K;
        bf16mma::cp16(Bs + (j * TN + n) * LDB_NT + c,
                      w + (ok ? ((size_t)(2 - j) * N + n0 + n) * K + k0 + c
                              : 0), ok);
      } else {              // tap j's rows k of TN values along n
        const int j = i / (KC * TN / 8), k = i / (TN / 8) % KC;
        const int c = (i % (TN / 8)) * 8;
        const bool ok = k0 + k < K && n0 + c < N;
        bf16mma::cp16(Bs + (j * KC + k) * LDB_NN + c,
                      w + (ok ? ((size_t)j * K + k0 + k) * N + n0 + c : 0),
                      ok);
      }
    }
    bf16mma::cp_commit();
  };

  // GN+SiLU in place on the A units this thread copied (its own cp.async
  // writes are visible to it after the wait)
  auto gn_silu_tile = [&](int ch) {
    bf16* As = smem + (ch % STAGES) * SE;
    const int k0 = ch * KC;
#pragma unroll
    for (int u = 0; u < A_UNITS; ++u) {
      const int i = tid + u * THREADS;
      const int r = i / (KC / 8), c = (i % (KC / 8)) * 8;
      if (i < A_ROWS * KC / 8 && arow[u] >= 0 && k0 + c < K) {
        uint4* p = reinterpret_cast<uint4*>(As + r * LDA + c);
        *p = gn_silu8(*p, aff + 2 * ((size_t)arow[u] * K + k0 + c),
                      beta + k0 + c);
      }
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks)
      stage(s);
    else
      bf16mma::cp_commit();
  }
  float acc[MT][NT][4] = {};
  for (int ch = 0; ch < chunks; ++ch) {
    bf16mma::cp_wait<STAGES - 2>();
    if (GN) gn_silu_tile(ch);
    __syncthreads();        // chunk ch is in place; ch - 1's slot is free
    if (ch + STAGES - 1 < chunks)
      stage(ch + STAGES - 1);
    else
      bf16mma::cp_commit();
    const bf16* As = smem + (ch % STAGES) * SE;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16)
      gemm_step<WT>(acc, As, As + A_ELEMS, kk, first, last, wm, wn, lane);
  }
  bf16mma::cp_wait<0>();

  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n0 + wn + 8 * n + 2 * t;
    if (col >= N) continue;      // N % 8 == 0: col and col + 1 share fate
    const float b0 = bias != nullptr ? bias[col] : 0.f;
    const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + (lane >> 2) + 8 * h;
        if (m < rows.y)
          store2(out + (size_t)m * N + col, acc[i][n][2 * h] + b0,
                 acc[i][n][2 * h + 1] + b1);
      }
  }
}

// Zero the bf16 halves of A register a whose k (kk + 2t + 8 hi + half)
// is set in `dead`: registers 0, 1 hold k = 2t, 2t+1; 2, 3 hold 2t+8, 2t+9
__device__ __forceinline__ void mask_k(uint32_t (&a)[4], unsigned dead,
                                       int k) {
  const uint32_t lo = (dead >> k) & 1u ? 0xffff0000u : 0xffffffffu;
  const uint32_t hi = (dead >> (k + 1)) & 1u ? 0x0000ffffu : 0xffffffffu;
  const uint32_t lo8 = (dead >> (k + 8)) & 1u ? 0xffff0000u : 0xffffffffu;
  const uint32_t hi8 = (dead >> (k + 9)) & 1u ? 0x0000ffffu : 0xffffffffu;
  a[0] &= lo & hi;
  a[1] &= lo & hi;
  a[2] &= lo8 & hi8;
  a[3] &= lo8 & hi8;
}

// Partial dW and db of split s of the M = B L flattened rows, as
// conv_dw_kernel: part[s] = [dW (3, C, Cout) | db (Cout)], float32. h =
// silu(GN(x)) in float32 from the affine table and beta, rounded to bf16;
// x and gy bf16. Grid (ceil(C/DW_TC), ceil(Cout/DW_TN), S), DW_THREADS
// threads, DW_STAGES * DW_SE bf16 values of dynamic shared memory.
__global__ void __launch_bounds__(DW_THREADS, 1)
    conv_dw_bf16_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ aff,
                        const float* __restrict__ beta,
                        const bf16* __restrict__ gy, float* __restrict__ part,
                        int M, int L, int C, int Cout, int S) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  bf16* smem = reinterpret_cast<bf16*>(dw_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * DW_TC, o0 = blockIdx.y * DW_TN;
  const int s = blockIdx.z;
  const int wc = DW_WM * (warp % DW_WARPS_C), wn = DW_WN * (warp / DW_WARPS_C);
  const int total = (M + DW_KR - 1) / DW_KR, per = (total + S - 1) / S;
  const int ch0 = min(total, s * per), ch1 = min(total, ch0 + per);
  const bool db_warp = blockIdx.x == 0 && wc == 0;
  // an h unit's channel is the same in every unit of a thread
  const int hc = (tid % (DW_TC / 8)) * 8;
  const bool hc_ok = c0 + hc < C;

  auto stage = [&](int ch) {
    bf16* Hs = smem + (ch - ch0) % DW_STAGES * DW_SE;
    bf16* Gs = Hs + H_ELEMS;
    const int r0 = ch * DW_KR;
#pragma unroll
    for (int u = 0; u < H_UNITS; ++u) {
      const int i = tid + u * DW_THREADS;
      if (i < (DW_KR + 2) * DW_TC / 8) {
        const int r = i / (DW_TC / 8), m = r0 - 1 + r;
        const bool ok = hc_ok && m >= 0 && m < M;
        bf16mma::cp16(Hs + r * LDH + hc,
                      x + (ok ? (size_t)m * C + c0 + hc : 0), ok);
      }
    }
#pragma unroll
    for (int u = 0; u < G_UNITS; ++u) {
      const int i = tid + u * DW_THREADS;
      const int r = i / (DW_TN / 8), c = (i % (DW_TN / 8)) * 8;
      const int m = r0 + r;
      const bool ok = m < M && o0 + c < Cout;
      if (i < DW_KR * DW_TN / 8)
        bf16mma::cp16(Gs + r * LDG + c,
                      gy + (ok ? (size_t)m * Cout + o0 + c : 0), ok);
    }
    if (warp == 0) {      // one mask bit per g row: tap 0 / tap 2 crosses
      const int l = (r0 + lane) % L;
      const unsigned f = __ballot_sync(bf16mma::FULL, lane < DW_KR && l == 0);
      const unsigned e = __ballot_sync(bf16mma::FULL,
                                       lane < DW_KR && l == L - 1);
      if (lane == 0) {
        unsigned* masks = reinterpret_cast<unsigned*>(Gs + G_ELEMS);
        masks[0] = f;
        masks[1] = e;
      }
    }
    bf16mma::cp_commit();
  };

  auto gn_silu_tile = [&](int ch) {
    bf16* Hs = smem + (ch - ch0) % DW_STAGES * DW_SE;
    const int r0 = ch * DW_KR;
#pragma unroll
    for (int u = 0; u < H_UNITS; ++u) {
      const int i = tid + u * DW_THREADS;
      const int r = i / (DW_TC / 8), m = r0 - 1 + r;
      if (i < (DW_KR + 2) * DW_TC / 8 && hc_ok && m >= 0 && m < M) {
        uint4* p = reinterpret_cast<uint4*>(Hs + r * LDH + hc);
        *p = gn_silu8(*p, aff + 2 * ((size_t)(m / L) * C + c0 + hc),
                      beta + c0 + hc);
      }
    }
  };

  for (int k = 0; k < DW_STAGES - 1; ++k) {
    if (ch0 + k < ch1)
      stage(ch0 + k);
    else
      bf16mma::cp_commit();
  }
  float acc[3][DW_MT][DW_NT][4] = {};
  float dbp[DW_NT] = {};
  for (int ch = ch0; ch < ch1; ++ch) {
    bf16mma::cp_wait<DW_STAGES - 2>();
    gn_silu_tile(ch);
    __syncthreads();        // chunk ch is in place; ch - 1's slot is free
    if (ch + DW_STAGES - 1 < ch1)
      stage(ch + DW_STAGES - 1);
    else
      bf16mma::cp_commit();
    const bf16* Hs = smem + (ch - ch0) % DW_STAGES * DW_SE;
    const bf16* Gs = Hs + H_ELEMS;
    const unsigned* masks = reinterpret_cast<const unsigned*>(Gs + G_ELEMS);
    const unsigned first = masks[0], last = masks[1];
#pragma unroll
    for (int kk = 0; kk < DW_KR; kk += 16) {
      uint32_t b[DW_NT][2];
#pragma unroll
      for (int n = 0; n < DW_NT; n += 2) {
        uint32_t q[4];
        bf16mma::load_b_nn2(q, Gs, LDG, kk, wn + 8 * n, lane);
        b[n][0] = q[0]; b[n][1] = q[1];
        b[n + 1][0] = q[2]; b[n + 1][1] = q[3];
      }
      if (db_warp) {        // b0: g rows kk+2t, +1; b1: kk+2t+8, +9
#pragma unroll
        for (int n = 0; n < DW_NT; ++n)
          dbp[n] += (bf_lo(b[n][0]) + bf_hi(b[n][0])) +
                    (bf_lo(b[n][1]) + bf_hi(b[n][1]));
      }
      const int k = kk + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
#pragma unroll
        for (int i = 0; i < DW_MT; ++i) {
          uint32_t a[4];
          bf16mma::load_a_t(a, Hs + j * LDH, LDH, wc + 16 * i, kk, lane);
          if (j != 1) mask_k(a, j == 0 ? first : last, k);
#pragma unroll
          for (int n = 0; n < DW_NT; ++n)
            bf16mma::mma(acc[j][i][n], a, b[n][0], b[n][1]);
        }
      }
    }
  }
  bf16mma::cp_wait<0>();

  float* ps = part + (size_t)s * (3 * (size_t)C * Cout + Cout);
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < DW_NT; ++n) {
    const int o = o0 + wn + 8 * n + 2 * t;
    if (o >= Cout) continue;     // Cout % 8 == 0
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int i = 0; i < DW_MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + wc + 16 * i + (lane >> 2) + 8 * h;
          if (c < C)
            store2(ps + ((size_t)j * C + c) * Cout + o, acc[j][i][n][2 * h],
                   acc[j][i][n][2 * h + 1]);
        }
  }
  if (db_warp) {
#pragma unroll
    for (int n = 0; n < DW_NT; ++n) {
      const float v = bf16mma::quad_sum(dbp[n]);
      const int o = o0 + wn + 8 * n + (lane >> 2);
      if (t == 0 && o < Cout) ps[3 * (size_t)C * Cout + o] = v;
    }
  }
}

template <bool GN, bool WT, typename TO>
cudaError_t tap3_gemm(const bf16* a, const float* aff, const float* beta,
                      const bf16* w, const float* bias, TO* out, int B,
                      int L, int K, int N, cudaStream_t s) {
  const size_t bytes = STAGES * (WT ? STAGE_NT : STAGE_NN) * sizeof(bf16);
  cudaError_t err = set_smem(tap3_gemm_bf16_kernel<GN, WT, TO>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(gemm_tiles(B * L, L), (N + TN - 1) / TN);
  tap3_gemm_bf16_kernel<GN, WT, TO><<<grid, THREADS, bytes, s>>>(
      a, aff, beta, w, bias, out, B * L, L, K, N);
  return cudaGetLastError();
}

}  // namespace bf

int conv_shape_ok_bf16(int B, int L, int C, int Cout, int G) {
  return conv_shape_ok(B, L, C, Cout, G) && C % 8 == 0 && Cout % 8 == 0;
}

}  // namespace

extern "C" {

// x (B, L, C), gamma, beta (C), w (3, C, Cout), bias (Cout) -> out
// (B, L, Cout). stats is scratch of affine_offset(B, G) + 2 B C floats:
// the (B, G, 2) statistics, then the (B, C, 2) affine table. (st_staged,
// st_threads, st_smem) is the statistics' launch plan. x, beta, w and
// bias start on 16-byte boundaries.
int ertdx_gn_conv3_fwd(const float* x, const float* gamma, const float* beta,
                       const float* w, const float* bias, float* out,
                       float* stats, int B, int L, int C, int Cout, int G,
                       float eps, int st_staged, int st_threads,
                       int st_smem, void* stream) {
  if (!conv_shape_ok(B, L, C, Cout, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = gn_tables(x, gamma, stats, B, L, C, G, eps,
                              GnPlan{st_staged, st_threads, st_smem}, s);
  if (err != cudaSuccess) return (int)err;
  return (int)tap3_gemm<true, false>(x, stats + affine_offset(B, G), beta,
                                     w, bias, out, B, L, C, Cout, s);
}

// x (B, L, C), gamma, beta (C), w (3, C, Cout), gy (B, L, Cout) ->
// dx (B, L, C), dgb (2 C: dgamma, dbeta), dwb (3 C Cout + Cout: dW, db).
// Scratch: stats (as the forward's), dh (B, L, C), part_w (S, 3 C Cout +
// Cout), part_gn (B, 2, C). S splits the rows of the dW reduction, 1 <= S
// <= B. (st_*) and (bw_*) are the launch plans of the statistics and of
// the GN backward, which takes those statistics. x, beta, w and gy start
// on 16-byte boundaries.
int ertdx_gn_conv3_bwd(const float* x, const float* gamma, const float* beta,
                       const float* w, const float* gy, float* dx,
                       float* dgb, float* dwb, float* stats, float* dh,
                       float* part_w, float* part_gn, int B, int L, int C,
                       int Cout, int G, int S, float eps, int st_staged,
                       int st_threads, int st_smem, int bw_staged,
                       int bw_threads, int bw_smem, void* stream) {
  if (!conv_shape_ok(B, L, C, Cout, G) || S < 1 || S > B ||
      !gn_plan_ok<float>(GnPlan{bw_staged, bw_threads, bw_smem}, 2, L,
                         C / G))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = gn_tables(x, gamma, stats, B, L, C, G, eps,
                              GnPlan{st_staged, st_threads, st_smem}, s);
  if (err != cudaSuccess) return (int)err;
  const float* aff = stats + affine_offset(B, G);
  const size_t dw_bytes = DW_STAGES * DW_SF * sizeof(float);
  if ((err = set_smem(conv_dw_kernel, dw_bytes)) != cudaSuccess)
    return (int)err;
  const dim3 dw_grid((C + DW_TC - 1) / DW_TC, (Cout + DW_TN - 1) / DW_TN, S);
  conv_dw_kernel<<<dw_grid, DW_THREADS, dw_bytes, s>>>(x, aff, beta, gy, part_w,
                                                    B * L, L, C, Cout, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int nw = 3 * C * Cout + Cout;
  sum_rows_kernel<<<(nw + 255) / 256, 256, 0, s>>>(part_w, dwb, S, nw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = tap3_gemm<false, true>(gy, nullptr, nullptr, w, nullptr, dh, B, L,
                               Cout, C, s);
  if (err != cudaSuccess) return (int)err;
  return (int)gn_silu_bwd(x, gamma, beta, dh, stats, dx, part_gn, dgb, B, L,
                          C, G, eps, GnPlan{bw_staged, bw_threads, bw_smem},
                          s);
}

// bf16 x, w (already rounded to bf16: the wrapper casts it), gy, out and
// dx; gamma, beta, bias, stats, dgb, dwb, dh and the partials float32;
// otherwise as the float32 entry points. C and Cout multiples of 8; bw_*
// is the plan of the GN backward of a bf16 x and a float32 dh.
int ertdx_gn_conv3_fwd_bf16(const bf16* x, const float* gamma,
                            const float* beta, const bf16* w,
                            const float* bias, bf16* out, float* stats,
                            int B, int L, int C, int Cout, int G, float eps,
                            int st_staged, int st_threads, int st_smem,
                            void* stream) {
  if (!conv_shape_ok_bf16(B, L, C, Cout, G))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = gn_tables(x, gamma, stats, B, L, C, G, eps,
                              GnPlan{st_staged, st_threads, st_smem}, s);
  if (err != cudaSuccess) return (int)err;
  return (int)bf::tap3_gemm<true, false>(x, stats + affine_offset(B, G),
                                         beta, w, bias, out, B, L, C, Cout,
                                         s);
}

int ertdx_gn_conv3_bwd_bf16(const bf16* x, const float* gamma,
                            const float* beta, const bf16* w, const bf16* gy,
                            bf16* dx, float* dgb, float* dwb, float* stats,
                            float* dh, float* part_w, float* part_gn, int B,
                            int L, int C, int Cout, int G, int S, float eps,
                            int st_staged, int st_threads, int st_smem,
                            int bw_staged, int bw_threads, int bw_smem,
                            void* stream) {
  if (!conv_shape_ok_bf16(B, L, C, Cout, G) || S < 1 || S > B ||
      !gn_plan_ok<bf16, float>(GnPlan{bw_staged, bw_threads, bw_smem}, 2,
                               L, C / G))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = gn_tables(x, gamma, stats, B, L, C, G, eps,
                              GnPlan{st_staged, st_threads, st_smem}, s);
  if (err != cudaSuccess) return (int)err;
  const float* aff = stats + affine_offset(B, G);
  const size_t dw_bytes = bf::DW_STAGES * bf::DW_SE * sizeof(bf16);
  if ((err = set_smem(bf::conv_dw_bf16_kernel, dw_bytes)) != cudaSuccess)
    return (int)err;
  const dim3 dw_grid((C + DW_TC - 1) / DW_TC, (Cout + DW_TN - 1) / DW_TN, S);
  bf::conv_dw_bf16_kernel<<<dw_grid, DW_THREADS, dw_bytes, s>>>(
      x, aff, beta, gy, part_w, B * L, L, C, Cout, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int nw = 3 * C * Cout + Cout;
  sum_rows_kernel<<<(nw + 255) / 256, 256, 0, s>>>(part_w, dwb, S, nw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = bf::tap3_gemm<false, true>(gy, nullptr, nullptr, w,
                                   (const float*)nullptr, dh, B, L, Cout, C,
                                   s);
  if (err != cudaSuccess) return (int)err;
  return (int)gn_silu_bwd(x, gamma, beta, (const float*)dh, stats, dx,
                          part_gn, dgb, B, L, C, G, eps,
                          GnPlan{bw_staged, bw_threads, bw_smem}, s);
}

}  // extern "C"
