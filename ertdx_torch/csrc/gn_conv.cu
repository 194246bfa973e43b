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
#include "wgmma.cuh"

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
// float32 to the staged tile and rounded to bf16; the weights rounded to
// bf16 once a call (by the wrapper: 3 C Cout values); one bf16 tensor-core
// pass a product with float32 accumulation; the bias added in float32 and
// the output rounded once to bf16. The backward: dW and db from h
// recomputed in float32 and rounded to bf16, h^T g on the bf16 tensor
// cores, float32 partials summed in order; dh = g W^T taps on the bf16
// tensor cores, kept in float32 (as conv.py:166-171 keeps it in VMEM);
// then the GN backward from the float32 statistics, dx in bf16.
//
// What bounds the three GEMMs on an H100: operations, 2 B L 3 C Cout FLOP
// each (29.6 GFLOP at the encoder's (256, 294, 256 -> 256): 0.030 ms at
// 989 TFLOP/s). Measured there: 17-38 % of that rate, and the stages take
// about as long without their wgmmas (PERF.md §6). The design (Hopper's
// wgmma and TMA, wgmma.cuh):
//   * tap3_wgmma_kernel (forward: GN, B = w[j]; dh: B = w[2-j]^T). A tile
//     is TM = 128 flattened rows by BN = 64 NSUB output channels (NSUB 4
//     where N > 128, else 2: the encoder's Cout = 256 is one column
//     block, so A is staged, and in the forward transformed, once). Two
//     warpgroups of 64 rows each hold NSUB m64n64 float32 accumulators
//     (128 registers a thread at NSUB = 4). No producer warp: registers
//     are split per SM sub-partition, and a block of 9 or 12 warps gets at
//     most 168 a thread, where the 128 x 256 tile spilled and ptxas
//     serialised its wgmmas (setmaxnreg did not raise ptxas's
//     allocation); with 8 warps a thread may hold 255. The weights are
//     K-major in both GEMMs, (3, N, K): the forward's are a (3, Cout, C)
//     copy the wrapper writes in the pass that rounds them to bf16, dh's
//     are w as it is; so both read B the same way.
//   * A ring of STAGES slots, each 32 input channels of a tile: A rows
//     [m0 - 1, m0 + TM] (64-byte swizzled rows, TMA zero-fills the rows
//     outside [0, M) and the channels past K) and the three taps' (BN x
//     32) weight tiles (3-D TMA, zero past N), one full barrier a slot.
//     32 channels a stage, not 64 with 128-byte swizzle: three taps of
//     256 x 64 weights would take 96 KB a stage and leave room for two.
//   * A stage: tap j's A fragment is the tile read j rows further down by
//     ldmatrix (the 64-byte swizzle's XOR in the address); a row whose
//     tap crosses a batch row is zeroed in registers; 3 taps x 2 k16
//     steps x NSUB wgmma m64n64k16 in RS form, one commit group. While
//     it runs, the previous stage's group retires (wait_group 1; two
//     register buffers of A fragments alternate), the next stage lands
//     and, in the forward, every thread applies GN+SiLU in place to its
//     units of it (once a tile, from the (row, channel) affine table),
//     and after a barrier thread 0 refills the previous stage's slot by
//     TMA (each thread's fence.proxy.async orders its accesses to that
//     slot before the fill).
//   * Persistent: one block an SM walks its tiles' stages as one
//     sequence, so the ring stays full across tiles.
//   * conv_dw_wgmma_kernel: a block owns 64 input by 128 output channels
//     of a split of the rows, and walks its rows 64 a stage through a
//     four-slot ring: h rows [r0 - 1, r0 + 64] (x, 128-byte swizzled
//     rows of 64 channels) and g rows [r0, r0 + 64) (two 64-column
//     panels). Warpgroup j computes tap j: A = h^T rows j .. j + 63 of
//     the tile by ldmatrix.trans (rows whose tap crosses a batch row
//     zeroed in registers), B = g MN-major by descriptor (tnspB = 1), 4
//     k16 steps x 2 panels of wgmma m64n64k16; GN+SiLU is applied to the
//     h tile once, in place, by all threads while the previous stage's
//     group runs, as in the tap GEMM. So each staged (h, g) block feeds
//     all three taps; across the grid h is staged twice and g four times
//     at the encoder's shape, as before. db, the column sums of g, is
//     summed from the g tile by the blocks of the first channel tile in
//     a fixed order. Each split writes its own float32 partial;
//     sum_rows_kernel adds them in order. No float atomics: two runs give
//     the same bits.

namespace bf {

constexpr int KC = 32;                 // channels a stage (64-byte rows)
constexpr int GEMM_THREADS = 256;      // two warpgroups of 64 rows
constexpr int A_BYTES = A_ROWS * KC * 2;       // what TMA lands: 8,320
constexpr int A_SLOT = 9216;                   // rounded to 1 KB
constexpr int A_UNITS = (A_ROWS * KC / 8 + GEMM_THREADS - 1) / GEMM_THREADS;
static_assert(A_BYTES <= A_SLOT && A_SLOT % 1024 == 0, "A slot");

template <int NSUB>
struct Gemm {
  static constexpr int BN = 64 * NSUB;             // output channels
  static constexpr int B_TAP = BN * KC * 2;        // one tap's weights
  static constexpr int STAGE = A_SLOT + 3 * B_TAP;
  static constexpr int STAGES = NSUB == 4 ? 3 : 5;
  static constexpr uint32_t TX = A_BYTES + 3 * B_TAP;
  // + 1 KB to align the ring, + the full barriers
  static constexpr size_t SMEM = 1024 + STAGES * STAGE + 8 * STAGES;
};

constexpr int DW_KR = 64;              // rows a stage (one mask bit each)
constexpr int DW_THREADS_WG = 384;     // a warpgroup a tap
constexpr int H_ROWS = DW_KR + 2;
constexpr int H_BYTES = H_ROWS * 128;  // 64 channels a row
constexpr int H_SLOT = 9216;
constexpr int G_PANEL = DW_KR * 128;   // 64 rows x 64 output channels
constexpr int DW_STAGE = H_SLOT + 2 * G_PANEL;
constexpr int DW_STAGES = 4;
constexpr uint32_t DW_TX = H_BYTES + 2 * G_PANEL;
constexpr int DB_GROUPS = DW_THREADS_WG / 64;  // row groups of db's sums
constexpr int H_UNITS = (H_ROWS * 8 + DW_THREADS_WG - 1) / DW_THREADS_WG;
constexpr size_t DW_SMEM = 1024 + DW_STAGES * DW_STAGE +
                           DB_GROUPS * 64 * sizeof(float2) + 8 * DW_STAGES;
static_assert(H_BYTES <= H_SLOT && DW_STAGE % 1024 == 0, "dW slots");
static_assert(DW_TC == 64 && DW_TN == 128, "dW block tile");

// silu(GN(v)) in place on U shared 16-byte units of 8 bf16 channels, in
// float32, rounded to bf16: unit u at p[u] (null: none) in batch row
// b[u]; the units share their 8 channels, whose (mean, scale) pairs of
// batch row r are at ms + r * ld (the affine table) and whose beta is at
// be. A run of units in one batch row loads its pairs once.
template <int U>
__device__ __forceinline__ void gn_silu_units(uint4* const (&p)[U],
                                              const int (&b)[U],
                                              const float* ms, size_t ld,
                                              const float* be) {
  const float4 b0 = *reinterpret_cast<const float4*>(be);
  const float4 b1 = *reinterpret_cast<const float4*>(be + 4);
  const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  int row = -1;
  float4 a[4];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (p[u] == nullptr) continue;
    if (b[u] != row) {
      row = b[u];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(ms + row * ld + 4 * i);
    }
    const uint4 v = *p[u];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = bf16mma::pack(
          fast_silu((bf_lo(w[i]) - a[i].x) * a[i].y + bt[2 * i]),
          fast_silu((bf_hi(w[i]) - a[i].z) * a[i].w + bt[2 * i + 1]));
    *p[u] = make_uint4(r[0], r[1], r[2], r[3]);
  }
}

__device__ __forceinline__ void zero_rows(uint32_t (&a)[4], bool top,
                                          bool bottom) {
  if (top) a[0] = a[2] = 0u;       // fragment row g
  if (bottom) a[1] = a[3] = 0u;    // fragment row g + 8
}

// Zero the bf16 halves of A register a whose k (2t + 8 hi + half, from
// k) is set in `dead`: registers 0, 1 hold k, k+1; 2, 3 hold k+8, k+9
__device__ __forceinline__ void mask_k(uint32_t (&a)[4], uint64_t dead,
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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = bf16mma::pack(a, b);
}

// the dynamic shared memory from its first 1024-byte boundary
__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return p + ((1024u - (wg::saddr(p) & 1023u)) & 1023u);
}

// out[m, :] = bias + sum_j A[m-1+j, :] @ W_j over the M = B L flattened
// rows of bf16 a (map_a: (M, K), boxes of 32 x A_ROWS), with A[m-1+j] = 0
// where row m-1+j lies outside m's batch row. GN: A = silu(GN(a)) from
// the affine table `aff` and beta (float32), rounded to bf16, else A = a.
// W_j = b[j]^T for WT = false, b[2-j]^T for WT = true, b a bf16 (3, N, K)
// tensor (map_b: boxes of 32 x BN x 1). bias float32 or null, out TO.
// K and N multiples of 8. Persistent: block i takes tiles i, i + grid,
// ... of the ceil(M / TM) x ceil(N / BN) tiles, and walks their stages
// (KC channels of a tile each) as one sequence. GEMM_THREADS threads,
// Gemm<NSUB>::SMEM bytes of dynamic shared memory.
template <bool GN, bool WT, int NSUB, typename TO>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    tap3_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const float* __restrict__ aff,
                      const float* __restrict__ beta,
                      const float* __restrict__ bias,
                      TO* __restrict__ out, int M, int L, int K, int N) {
  using G = Gemm<NSUB>;
  extern __shared__ unsigned char gemm_raw[];
  unsigned char* smem = align1k(gemm_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::STAGES * G::STAGE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = (K + KC - 1) / KC, cols = (N + G::BN - 1) / G::BN;
  const int tiles = (M + TM - 1) / TM * cols;
  const int mine = tiles > (int)blockIdx.x
                       ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int stages = mine * chunks;    // this block's stages, in order
  // stage i: tile blockIdx.x + (i / chunks) gridDim.x, channels
  // (i % chunks) KC; slot i % STAGES, its full barrier's phase i / STAGES
  auto tile_of = [&](int i) {
    return (int)blockIdx.x + i / chunks * (int)gridDim.x;
  };
  auto load = [&](int i) {             // one thread: stage i's TMA loads
    const int s = i % G::STAGES, tile = tile_of(i), k0 = i % chunks * KC;
    unsigned char* st = smem + s * G::STAGE;
    wg::mbar_expect_tx(&full[s], G::TX);
    wg::tma_load_2d(st, &map_a, &full[s], k0, tile / cols * TM - 1);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      wg::tma_load_3d(st + A_SLOT + j * G::B_TAP, &map_b, &full[s], k0,
                      tile % cols * G::BN, WT ? 2 - j : j);
  };
  // stage i landed; GN: GN+SiLU in place on the A units of this thread
  auto land = [&](int i) {
    const int s = i % G::STAGES;
    wg::mbar_wait(&full[s], (i / G::STAGES) & 1);
    // a thread's units share their 8 channels (GEMM_THREADS % 4 == 0)
    const int c = tid % (KC / 8), k = i % chunks * KC + 8 * c;
    if (GN && k < K) {
      const int m0 = tile_of(i) / cols * TM;
      unsigned char* st = smem + s * G::STAGE;
      uint4* p[A_UNITS];
      int b[A_UNITS];
#pragma unroll
      for (int u = 0; u < A_UNITS; ++u) {
        const int r = (tid + u * GEMM_THREADS) / (KC / 8), m = m0 - 1 + r;
        const bool ok = r < A_ROWS && m >= 0 && m < M;
        p[u] = ok ? reinterpret_cast<uint4*>(st + wg::sw64(r, c)) : nullptr;
        b[u] = ok ? m / L : 0;
      }
      gn_silu_units(p, b, aff + 2 * k, 2 * (size_t)K, beta + k);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) wg::mbar_init(&full[s], 1);
    wg::mbar_init_fence();
    for (int i = 0; i < G::STAGES && i < stages; ++i) load(i);
  }
  __syncthreads();
  if (stages == 0) return;

  const int r0 = 16 * warp;            // the warp's first row of a tile
  const int g = lane >> 2, t = lane & 3;
  bool top[2], bottom[2];              // tap 0 / tap 2 of rows g, g + 8
  float acc[NSUB][32];
  land(0);
  wg::bar_sync(1, GEMM_THREADS);

  // Stage i: its tap j A fragments (the tile read j rows further down)
  // into `a`, 3 taps x 2 k16 steps x NSUB wgmmas as one group. While the
  // group runs: stage i - 1's group is retired, stage i + 1 lands and is
  // transformed, and after a barrier (every warpgroup is past stage i -
  // 1) thread 0 refills stage i - 1's slot with stage i - 1 + STAGES. The
  // caller alternates two register buffers of A fragments.
  auto step = [&](int i, uint32_t (&a)[2][3][4]) {
    const int ch = i % chunks;
    if (ch == 0) {                     // a new tile: its masks, acc = 0
      const int m0 = tile_of(i) / cols * TM;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = (m0 + r0 + g + 8 * h) % L;
        top[h] = l == 0;
        bottom[h] = l == L - 1;
      }
#pragma unroll
      for (int n = 0; n < NSUB; ++n) {
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[n][e] = 0.f;
        wg::fence_regs(acc[n]);
      }
    }
    const uint32_t a_base = wg::saddr(smem + i % G::STAGES * G::STAGE);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int r = r0 + (lane & 15) + j;
        wg::ldsm_x4(a[kk][j], a_base + wg::sw64(r, 2 * kk + (lane >> 4)));
        if (j == 0) zero_rows(a[kk][j], top[0], top[1]);
        if (j == 2) zero_rows(a[kk][j], bottom[0], bottom[1]);
      }
    wg::fence();
    const uint32_t b_base = a_base + A_SLOT;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int n = 0; n < NSUB; ++n)
          wg::mma_rs_n64<0>(
              acc[n], a[kk][j],
              wg::desc(b_base + j * G::B_TAP + n * 64 * KC * 2 + kk * 32, 16,
                       8 * KC * 2, wg::SWIZZLE_64B));
    wg::commit();
    wg::wait<1>();                     // stage i - 1's group is done
    wg::fence_proxy_async();           // before slot i - 1's next fill
    if (i + 1 < stages) land(i + 1);
    wg::bar_sync(1, GEMM_THREADS);
    if (tid == 0 && i > 0 && i - 1 + G::STAGES < stages)
      load(i - 1 + G::STAGES);
    if (ch == chunks - 1) {            // the tile's epilogue
      wg::wait<0>();
#pragma unroll
      for (int n = 0; n < NSUB; ++n) wg::fence_regs(acc[n]);
      const int tile = tile_of(i);
      const int m0 = tile / cols * TM, n0 = tile % cols * G::BN;
      const int rows_end = min(M, m0 + TM);
#pragma unroll
      for (int n = 0; n < NSUB; ++n)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = n0 + 64 * n + 8 * q + 2 * t;
          if (col >= N) continue;      // N % 8 == 0: col, col + 1 together
          const float b0 = bias != nullptr ? bias[col] : 0.f;
          const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + r0 + g + 8 * h;
            if (m < rows_end)
              store2(out + (size_t)m * N + col, acc[n][4 * q + 2 * h] + b0,
                     acc[n][4 * q + 2 * h + 1] + b1);
          }
        }
    }
  };
  uint32_t a0[2][3][4], a1[2][3][4];
#pragma unroll 1
  for (int i = 0; i < stages; i += 2) {
    step(i, a0);
    if (i + 1 < stages) step(i + 1, a1);
  }
}

// Partial dW and db of split s of the M = B L flattened rows (contiguous
// ranges of DW_KR-row chunks): part[s] = [dW (3, C, Cout) | db (Cout)],
// float32. h = silu(GN(x)) in float32 from the affine table and beta,
// rounded to bf16; x (map_h: (M, C), boxes of 64 x H_ROWS) and g (map_g:
// (M, Cout), boxes of 64 x DW_KR) bf16. Grid (ceil(C / 64), ceil(Cout /
// 128), S), DW_THREADS_WG threads (warpgroup j computes tap j), DW_SMEM
// bytes of dynamic shared memory.
__global__ void __launch_bounds__(DW_THREADS_WG, 1)
    conv_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_h,
                         const __grid_constant__ CUtensorMap map_g,
                         const float* __restrict__ aff,
                         const float* __restrict__ beta,
                         float* __restrict__ part, int M, int L, int C,
                         int Cout, int S) {
  extern __shared__ unsigned char dw_raw[];
  unsigned char* smem = align1k(dw_raw);
  float2* dbx = reinterpret_cast<float2*>(smem + DW_STAGES * DW_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(dbx + DB_GROUPS * 64);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * DW_TC, o0 = blockIdx.y * DW_TN;
  const int s = blockIdx.z;
  const int total = (M + DW_KR - 1) / DW_KR, per = (total + S - 1) / S;
  const int ch0 = min(total, s * per), ch1 = min(total, ch0 + per);
  const int stages = ch1 - ch0;        // stage i: rows (ch0 + i) DW_KR..
  const bool db_block = blockIdx.x == 0;
  const int cp = tid & 63, rg = tid >> 6;   // db: a column pair, rows
  auto load = [&](int i) {             // one thread: stage i's TMA loads
    const int slot = i % DW_STAGES, r0 = (ch0 + i) * DW_KR;
    unsigned char* st = smem + slot * DW_STAGE;
    wg::mbar_expect_tx(&full[slot], DW_TX);
    wg::tma_load_2d(st, &map_h, &full[slot], c0, r0 - 1);
    wg::tma_load_2d(st + H_SLOT, &map_g, &full[slot], o0, r0);
    wg::tma_load_2d(st + H_SLOT + G_PANEL, &map_g, &full[slot], o0 + 64, r0);
  };
  float2 dbp = make_float2(0.f, 0.f);
  // stage i landed: GN+SiLU in place on this thread's h units (rows
  // outside [0, M) stay zero), and db's sums of g column pair cp, rows rg
  // + 6 k
  auto land = [&](int i) {
    const int slot = i % DW_STAGES, r0 = (ch0 + i) * DW_KR;
    wg::mbar_wait(&full[slot], (i / DW_STAGES) & 1);
    unsigned char* st = smem + slot * DW_STAGE;
    // a thread's units share their 8 channels (DW_THREADS_WG % 8 == 0)
    const int c = tid & 7, k = c0 + 8 * c;
    if (k < C) {
      uint4* p[H_UNITS];
      int b[H_UNITS];
#pragma unroll
      for (int u = 0; u < H_UNITS; ++u) {
        const int r = (tid + u * DW_THREADS_WG) >> 3, m = r0 - 1 + r;
        const bool ok = r < H_ROWS && m >= 0 && m < M;
        p[u] = ok ? reinterpret_cast<uint4*>(st + wg::sw128(r, c)) : nullptr;
        b[u] = ok ? m / L : 0;
      }
      gn_silu_units(p, b, aff + 2 * k, 2 * (size_t)C, beta + k);
    }
    if (db_block) {
      const int col = 2 * cp;
      const unsigned char* gp = st + H_SLOT + (col >> 6) * G_PANEL +
                                (col & 7) * 2;
      for (int r = rg; r < DW_KR; r += DB_GROUPS) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            gp + wg::sw128(r, (col & 63) >> 3));
        dbp.x += bf_lo(w);
        dbp.y += bf_hi(w);
      }
    }
  };

  if (tid == 0) {
    for (int i = 0; i < DW_STAGES; ++i) wg::mbar_init(&full[i], 1);
    wg::mbar_init_fence();
    for (int i = 0; i < DW_STAGES && i < stages; ++i) load(i);
  }
  __syncthreads();

  const int j = warp >> 2, w4 = warp & 3;   // the tap; the warp in it
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3;                 // ldmatrix.trans's matrix
  const int want = j == 0 ? 0 : L - 1;      // a dead row's l, taps 0, 2
  float acc[2][32];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[n][e] = 0.f;
    wg::fence_regs(acc[n]);
  }
  if (stages > 0) land(0);
  wg::bar_sync(1, DW_THREADS_WG);

  // Stage i, as tap3_wgmma_kernel's: tap j's A = h^T rows j .. j + 63 of
  // the tile, 4 k16 steps x 2 panels of g; stage i + 1 lands and is
  // transformed while the group runs.
  auto step = [&](int i, uint32_t (&a)[4][4]) {
    const int r0 = (ch0 + i) * DW_KR;
    uint64_t dead = 0;                 // g rows whose tap j crosses
    if (j != 1) {
      const unsigned lo = __ballot_sync(bf16mma::FULL,
                                        (r0 + lane) % L == want);
      const unsigned hi = __ballot_sync(bf16mma::FULL,
                                        (r0 + 32 + lane) % L == want);
      dead = (uint64_t)lo | ((uint64_t)hi << 32);
    }
    const uint32_t h_base = wg::saddr(smem + i % DW_STAGES * DW_STAGE);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // A(c, k) = h tile row j + k
      const int r = j + 16 * kk + (lane & 7) + 8 * (mi >> 1);
      wg::ldsm_x4_t(a[kk], h_base + wg::sw128(r, 2 * w4 + (mi & 1)));
      if (j != 1) mask_k(a[kk], dead, 16 * kk + 2 * t);
    }
    wg::fence();
    const uint32_t g_base = h_base + H_SLOT;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        wg::mma_rs_n64<1>(acc[n], a[kk],
                          wg::desc(g_base + n * G_PANEL + kk * 16 * 128,
                                   1024, 1024, wg::SWIZZLE_128B));
    wg::commit();
    wg::wait<1>();                     // stage i - 1's group is done
    wg::fence_proxy_async();           // before slot i - 1's next fill
    if (i + 1 < stages) land(i + 1);
    wg::bar_sync(1, DW_THREADS_WG);
    if (tid == 0 && i > 0 && i - 1 + DW_STAGES < stages)
      load(i - 1 + DW_STAGES);
  };
  uint32_t a0[4][4], a1[4][4];
#pragma unroll 1
  for (int i = 0; i < stages; i += 2) {
    step(i, a0);
    if (i + 1 < stages) step(i + 1, a1);
  }
  wg::wait<0>();
#pragma unroll
  for (int n = 0; n < 2; ++n) wg::fence_regs(acc[n]);

  float* ps = part + (size_t)s * (3 * (size_t)C * Cout + Cout);
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int o = o0 + 64 * n + 8 * q + 2 * t;
      if (o >= Cout) continue;         // Cout % 8 == 0
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + 16 * w4 + g + 8 * h;
        if (c < C)
          store2(ps + ((size_t)j * C + c) * Cout + o, acc[n][4 * q + 2 * h],
                 acc[n][4 * q + 2 * h + 1]);
      }
    }
  if (db_block) {                      // the row groups added in order
    dbx[rg * 64 + cp] = dbp;
    wg::bar_sync(1, DW_THREADS_WG);
    if (tid < 64) {
      float2 v = dbx[tid];
      for (int q = 1; q < DB_GROUPS; ++q) {
        v.x += dbx[q * 64 + tid].x;
        v.y += dbx[q * 64 + tid].y;
      }
      const int o = o0 + 2 * tid;
      if (o < Cout) store2(ps + 3 * (size_t)C * Cout + o, v.x, v.y);
    }
  }
}

// the tensor maps of the tap GEMM: a (M, K) in boxes of KC x A_ROWS, b
// (3, N, K) in boxes of KC x BN x 1, 64-byte swizzle
inline cudaError_t gemm_maps(CUtensorMap* ma, CUtensorMap* mb, const bf16* a,
                             const bf16* b, int M, int K, int N, int BN) {
  const cuuint64_t da[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t sa[1] = {(cuuint64_t)K * 2};
  const cuuint32_t ba[2] = {KC, A_ROWS};
  cudaError_t err = wg::bf16_map(ma, a, 2, da, sa, ba,
                                 CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  const cuuint64_t db[3] = {(cuuint64_t)K, (cuuint64_t)N, 3};
  const cuuint64_t sb[2] = {(cuuint64_t)K * 2, (cuuint64_t)N * K * 2};
  const cuuint32_t bb[3] = {KC, (cuuint32_t)BN, 1};
  return wg::bf16_map(mb, b, 3, db, sb, bb, CU_TENSOR_MAP_SWIZZLE_64B);
}

template <bool GN, bool WT, int NSUB, typename TO>
cudaError_t tap3_gemm_n(const bf16* a, const float* aff, const float* beta,
                        const bf16* w, const float* bias, TO* out, int B,
                        int L, int K, int N, cudaStream_t s) {
  using G = Gemm<NSUB>;
  CUtensorMap ma, mb;
  cudaError_t err = gemm_maps(&ma, &mb, a, w, B * L, K, N, G::BN);
  if (err != cudaSuccess) return err;
  if ((err = set_smem(tap3_wgmma_kernel<GN, WT, NSUB, TO>, G::SMEM)) !=
      cudaSuccess)
    return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int tiles = gemm_tiles(B * L, L) * ((N + G::BN - 1) / G::BN);
  tap3_wgmma_kernel<GN, WT, NSUB, TO>
      <<<min(tiles, sms), GEMM_THREADS, G::SMEM, s>>>(
          ma, mb, aff, beta, bias, out, B * L, L, K, N);
  return cudaGetLastError();
}

// w: (3, N, K) bf16, K-major (see tap3_wgmma_kernel)
template <bool GN, bool WT, typename TO>
cudaError_t tap3_gemm(const bf16* a, const float* aff, const float* beta,
                      const bf16* w, const float* bias, TO* out, int B,
                      int L, int K, int N, cudaStream_t s) {
  return N > 128 ? tap3_gemm_n<GN, WT, 4>(a, aff, beta, w, bias, out, B, L,
                                          K, N, s)
                 : tap3_gemm_n<GN, WT, 2>(a, aff, beta, w, bias, out, B, L,
                                          K, N, s);
}

cudaError_t conv_dw(const bf16* x, const float* aff, const float* beta,
                    const bf16* gy, float* part, int B, int L, int C,
                    int Cout, int S, cudaStream_t s) {
  const int M = B * L;
  CUtensorMap mh, mg;
  const cuuint64_t dh[2] = {(cuuint64_t)C, (cuuint64_t)M};
  const cuuint64_t sh[1] = {(cuuint64_t)C * 2};
  const cuuint32_t bh[2] = {64, H_ROWS};
  cudaError_t err = wg::bf16_map(&mh, x, 2, dh, sh, bh,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const cuuint64_t dg[2] = {(cuuint64_t)Cout, (cuuint64_t)M};
  const cuuint64_t sg[1] = {(cuuint64_t)Cout * 2};
  const cuuint32_t bg[2] = {64, DW_KR};
  if ((err = wg::bf16_map(&mg, gy, 2, dg, sg, bg,
                          CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
    return err;
  if ((err = set_smem(conv_dw_wgmma_kernel, DW_SMEM)) != cudaSuccess)
    return err;
  const dim3 grid((C + DW_TC - 1) / DW_TC, (Cout + DW_TN - 1) / DW_TN, S);
  conv_dw_wgmma_kernel<<<grid, DW_THREADS_WG, DW_SMEM, s>>>(
      mh, mg, aff, beta, part, M, L, C, Cout, S);
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
// otherwise as the float32 entry points, except that the forward's w is
// K-major, (3, Cout, C): w[j] transposed (the backward's is (3, C,
// Cout)). C and Cout multiples of 8; bw_* is the plan of the GN backward
// of a bf16 x and a float32 dh. The GEMMs run on wgmma and TMA (namespace
// bf); a tensor map that cannot be encoded returns an error.
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
  if ((err = bf::conv_dw(x, aff, beta, gy, part_w, B, L, C, Cout, S, s)) !=
      cudaSuccess)
    return (int)err;
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
