// Fused GroupNorm + SiLU + Conv1d(k=3, stride 1, SAME), forward and
// backward, in the TPU kernel's one-pass arithmetic on Hopper's bf16
// warpgroup MMAs and TMA (sm_90a; wgmma.cuh).
//
// Replaces the TPU kernels of ertdx/ops/conv.py:
//   * the statistics (gn_stats_{staged,stream}_kernel), gn_affine_kernel
//     + tap3_wgmma_kernel<TX, true, false, ...>
//                                  <- _gn_silu_conv3_kernel (:49-82)
//   * the statistics, gn_affine_kernel, conv_dw_wgmma_kernel +
//     sum_rows_kernel (dW, db), tap3_wgmma_kernel<bf16, false, true, ...>
//     (dh) and the GN backward (gn_bwd_{staged,stream}_kernel, from those
//     statistics) + sum_rows_kernel (dx, dgamma, dbeta); on a float32 x
//     first round_colsum_kernel (bf16(g), db's partials) + sum_rows_kernel
//                                  <- _gn_silu_conv3_bwd_kernel (:109-180)
// x (B, L, C), h = silu(GN(x)) with G groups, w (3, C, Cout), bias (Cout):
//   y[l] = h[l-1] w[0] + h[l] w[1] + h[l+1] w[2] + bias,
// h zero outside [0, L) ("SAME" padding of the conv's input). Backward:
//   dW[k] = sum_(b,l) h[l-1+k]^T g[l],  db = sum_(b,l) g[l],
//   dh[l] = g[l+1] w[0]^T + g[l] w[1]^T + g[l-1] w[2]^T,
// then the SiLU chain rule and the GN identity on dh (gn_common.cuh).
//
// The arithmetic is the TPU kernel's. Its tap products run at DEFAULT
// precision (conv.py:15-17; no precision argument at :79-81, :153-161,
// :166-171), one bf16 MXU pass a product; its GroupNorm statistics run at
// HIGHEST. So, on a float32 or a bf16 x: the statistics and GN+SiLU in
// float32, h rounded to bf16 (to nearest even); the weights rounded to
// bf16 once a call (by the wrapper: 3 C Cout values); one bf16 wgmma pass
// a product with float32 accumulation; the bias added in float32 and y
// stored in x's dtype. The backward: dW from h recomputed in float32 and
// rounded, h^T bf16(g) on the bf16 tensor cores, float32 partials summed
// in order; db the plain sum of g as it comes (:150, no product); dh =
// bf16(g) bf16(W)^T taps kept in float32 (as :166-171 keeps it in VMEM);
// then the GN backward from the float32 statistics, dx in x's dtype.
//
// What bounds it on an H100: operations, 2 B L 3 C Cout FLOP a GEMM (29.6
// GFLOP at the encoder's (256, 294, 256 -> 256): 0.030 ms at 989 TFLOP/s)
// against x read and y written once (0.046 ms at 3.35 TB/s in float32,
// 0.023 in bf16): a float32 forward is bound by its bytes. The backward
// runs two GEMMs (dW, dh). Measured: PERF.md §6 rows 6b and 6f.
//
// The design:
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
//     [m0 - 1, m0 + TM] (64-byte swizzled bf16 rows) and the three taps'
//     (BN x 32) weight tiles (3-D TMA, zero past N), one full barrier a
//     slot. A bf16 A lands by TMA in its slot (zero-filled outside [0, M)
//     and past K). A float32 x cannot be rounded before GroupNorm, so it
//     lands by TMA in a float32 slot of its own (32 floats, 128-byte
//     swizzled rows; 17 KB, which leaves room for three stages at NSUB =
//     4, four at 2) and GN+SiLU writes it, rounded, into the bf16 slot
//     (zeros outside [0, M) and past K); the bf16 A slot is then never a
//     TMA target. 32 channels a stage, not 64 with 128-byte swizzle: three
//     taps of 256 x 64 weights would take 96 KB a stage and leave room for
//     two.
//   * A stage: tap j's A fragment is the tile read j rows further down by
//     ldmatrix (the 64-byte swizzle's XOR in the address); a row whose
//     tap crosses a batch row is zeroed in registers; 3 taps x 2 k16
//     steps x NSUB wgmma m64n64k16 in RS form, one commit group. While
//     it runs, the previous stage's group retires (wait_group 1; two
//     register buffers of A fragments alternate), the next stage lands
//     and, in the forward, every thread applies GN+SiLU to its units of
//     it (once a tile, from the (row, channel) affine table), and after a
//     barrier thread 0 refills the previous stage's slot by TMA (each
//     thread's fence.proxy.async orders its accesses to that slot before
//     the fill).
//   * Persistent: one block an SM walks its tiles' stages as one
//     sequence, so the ring stays full across tiles.
//   * conv_dw_wgmma_kernel: a block owns 64 input by 128 output channels
//     of a split of the rows, and walks its rows 64 a stage through a
//     four-slot ring: h rows [r0 - 1, r0 + 64] (128-byte swizzled bf16
//     rows of 64 channels; a float32 x lands in two 32-channel panels of
//     its own and is written, rounded, into that tile, as in the forward)
//     and
//     bf16 g rows [r0, r0 + 64) (two 64-column panels). Warpgroup j
//     computes tap j: A = h^T rows j .. j + 63 of the tile by
//     ldmatrix.trans (rows whose tap crosses a batch row zeroed in
//     registers), B = g MN-major by descriptor (tnspB = 1), 4 k16 steps x
//     2 panels of wgmma m64n64k16; GN+SiLU is applied to the h tile once
//     by all threads while the previous stage's group runs. So each staged
//     (h, g) block feeds all three taps; across the grid h is staged twice
//     and g four times at the encoder's shape. Each split writes its own
//     float32 partial; sum_rows_kernel adds them in order. No float
//     atomics: two runs give the same bits.
//   * db. On a bf16 g it is the column sums of the g tiles, by the dW
//     blocks of the first channel tile in a fixed order. A float32 g is
//     first rounded to bf16 into a scratch by round_colsum_kernel (one
//     pass: g read once, bf16(g) written once), which dW and dh then read
//     as they read a bf16 g; that pass sums db from the float32 values
//     (summing the rounded ones would be another function), one float32
//     partial a block, added in order by sum_rows_kernel.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError().

#include <stdint.h>

#include <type_traits>

#include "bf16mma.cuh"
#include "gn_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TM = 128;               // flattened rows of a GEMM tile
constexpr int A_ROWS = TM + 2;        // the taps' halo rows
constexpr int KC = 32;                // channels a stage (64-byte rows)
constexpr int GEMM_THREADS = 256;     // two warpgroups of 64 rows
constexpr int A_BYTES = A_ROWS * KC * 2;       // a bf16 A: 8,320
constexpr int A_SLOT = 9216;                   // rounded to 1 KB
constexpr int A_F32_BYTES = A_ROWS * KC * 4;   // a float32 A: 16,640
constexpr int A_F32_SLOT = 17408;
constexpr int A_UNITS = (A_ROWS * KC / 8 + GEMM_THREADS - 1) / GEMM_THREADS;
static_assert(A_BYTES <= A_SLOT && A_SLOT % 1024 == 0, "A slot");
static_assert(A_F32_BYTES <= A_F32_SLOT && A_F32_SLOT % 1024 == 0,
              "float32 A slot");
constexpr size_t SMEM_MAX = 232448;   // a block's dynamic shared memory

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

__host__ __device__ inline int gemm_tiles(int M) { return (M + TM - 1) / TM; }

template <int NSUB, typename TA>
struct Gemm {
  static constexpr bool F32 = std::is_same<TA, float>::value;
  static constexpr int BN = 64 * NSUB;             // output channels
  static constexpr int B_TAP = BN * KC * 2;        // one tap's weights
  // a float32 A's landing slot, after the weights
  static constexpr int F_OFF = A_SLOT + 3 * B_TAP;
  static constexpr int STAGE = F_OFF + (F32 ? A_F32_SLOT : 0);
  static constexpr int STAGES = NSUB == 4 ? 3 : F32 ? 4 : 5;
  static constexpr uint32_t TX = (F32 ? A_F32_BYTES : A_BYTES) + 3 * B_TAP;
  // + 1 KB to align the ring, + the full barriers
  static constexpr size_t SMEM = 1024 + STAGES * STAGE + 8 * STAGES;
  static_assert(SMEM <= SMEM_MAX && STAGE % 1024 == 0, "GEMM ring");
};

constexpr int DW_TC = 64;              // input channels of a dW block
constexpr int DW_TN = 128;             // output channels of a dW block
constexpr int DW_KR = 64;              // rows a stage (one mask bit each)
constexpr int DW_THREADS_WG = 384;     // a warpgroup a tap
constexpr int H_ROWS = DW_KR + 2;
constexpr int H_BYTES = H_ROWS * 128;  // 64 bf16 channels a row
constexpr int H_SLOT = 9216;
constexpr int G_PANEL = DW_KR * 128;   // 64 rows x 64 output channels
constexpr int DW_STAGES = 4;
constexpr int DB_GROUPS = DW_THREADS_WG / 64;  // row groups of db's sums
constexpr int H_UNITS = (H_ROWS * 8 + DW_THREADS_WG - 1) / DW_THREADS_WG;
static_assert(H_BYTES <= H_SLOT && H_SLOT % 1024 == 0, "dW h slot");

template <typename TX>
struct Dw {
  static constexpr bool F32 = std::is_same<TX, float>::value;
  // a float32 x's two 32-channel landing panels (128-byte rows), after g
  static constexpr int F_OFF = H_SLOT + 2 * G_PANEL;
  static constexpr int STAGE = F_OFF + (F32 ? 2 * H_SLOT : 0);
  static constexpr uint32_t TX_BYTES = (F32 ? 2 : 1) * H_BYTES + 2 * G_PANEL;
  static constexpr size_t SMEM = 1024 + DW_STAGES * STAGE +
                                 DB_GROUPS * 64 * sizeof(float2) +
                                 8 * DW_STAGES;
  static_assert(SMEM <= SMEM_MAX && STAGE % 1024 == 0, "dW ring");
};

constexpr int RC_THREADS = 512;        // round_colsum: 16 row groups

// silu((v - mean) * scale + beta) of a unit's 8 channels (v, in float32),
// rounded to bf16 and packed; a holds the 8 (mean, scale) pairs, bt the 8
// betas.
__device__ __forceinline__ uint4 gn_silu_pack(const float (&v)[8],
                                              const float4 (&a)[4],
                                              const float (&bt)[8]) {
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = bf16mma::pack(fast_silu((v[2 * i] - a[i].x) * a[i].y + bt[2 * i]),
                         fast_silu((v[2 * i + 1] - a[i].z) * a[i].w +
                                   bt[2 * i + 1]));
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// silu(GN(x)) of U units of 8 channels, in float32, rounded to bf16 into
// shared 16-byte units p[u] (null: none). TX = bf16: unit u is read from
// p[u] (in place) and skipped where b[u] < 0 (a row outside [0, M), which
// TMA zero-filled). TX = float: unit u is read from row r[u] of the
// 128-byte swizzled float32 tile f, chunks c2 and c2 + 1, and p[u] is
// written zero where b[u] < 0. Unit u lies in batch row b[u]; the units
// share their 8 channels, whose (mean, scale) pairs of batch row q are at
// ms + q * ld (the affine table) and whose beta is at be. A run of units
// in one batch row loads its pairs once.
template <typename TX, int U>
__device__ __forceinline__ void gn_silu_units(uint4* const (&p)[U],
                                              const int (&b)[U],
                                              const float* ms, size_t ld,
                                              const float* be,
                                              const unsigned char* f = nullptr,
                                              const int* r = nullptr,
                                              int c2 = 0) {
  const float4 b0 = *reinterpret_cast<const float4*>(be);
  const float4 b1 = *reinterpret_cast<const float4*>(be + 4);
  const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  int row = -1;
  float4 a[4];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (p[u] == nullptr) continue;
    if (b[u] < 0) {
      if (std::is_same<TX, float>::value) *p[u] = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    if (b[u] != row) {
      row = b[u];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(ms + row * ld + 4 * i);
    }
    float v[8];
    if constexpr (std::is_same<TX, float>::value) {
      const float4 v0 =
          *reinterpret_cast<const float4*>(f + wg::sw128(r[u], c2));
      const float4 v1 =
          *reinterpret_cast<const float4*>(f + wg::sw128(r[u], c2 + 1));
      const float w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = w[i];
    } else {
      const uint4 q = *p[u];
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = bf_lo(w[i]);
        v[2 * i + 1] = bf_hi(w[i]);
      }
    }
    *p[u] = gn_silu_pack(v, a, bt);
  }
}

// zeros into the units p[u] (null: none): a float32 x's channels past K,
// which no TMA fill of the bf16 slot zeroes
template <int U>
__device__ __forceinline__ void zero_units(uint4* const (&p)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (p[u] != nullptr) *p[u] = make_uint4(0u, 0u, 0u, 0u);
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
// rows of a (TA: bf16 or float; map_a: (M, K), boxes of 32 x A_ROWS),
// with A[m-1+j] = 0 where row m-1+j lies outside m's batch row. GN: A =
// silu(GN(a)) from the affine table `aff` and beta (float32), rounded to
// bf16, else A = a (bf16 only). W_j = b[j]^T for WT = false, b[2-j]^T for
// WT = true, b a bf16 (3, N, K) tensor (map_b: boxes of 32 x BN x 1).
// bias float32 or null, out TO. K and N multiples of 8. Persistent: block
// i takes tiles i, i + grid, ... of the ceil(M / TM) x ceil(N / BN)
// tiles, and walks their stages (KC channels of a tile each) as one
// sequence. GEMM_THREADS threads, Gemm<NSUB, TA>::SMEM bytes of dynamic
// shared memory.
template <typename TA, bool GN, bool WT, int NSUB, typename TO>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    tap3_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const float* __restrict__ aff,
                      const float* __restrict__ beta,
                      const float* __restrict__ bias,
                      TO* __restrict__ out, int M, int L, int K, int N) {
  using G = Gemm<NSUB, TA>;
  static_assert(GN || !G::F32, "a float32 A is x, through GN+SiLU");
  extern __shared__ unsigned char gemm_raw[];
  unsigned char* smem = align1k(gemm_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::STAGES * G::STAGE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = (K + KC - 1) / KC, cols = (N + G::BN - 1) / G::BN;
  const int tiles = gemm_tiles(M) * cols;
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
    wg::tma_load_2d(st + (G::F32 ? G::F_OFF : 0), &map_a, &full[s], k0,
                    tile / cols * TM - 1);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      wg::tma_load_3d(st + A_SLOT + j * G::B_TAP, &map_b, &full[s], k0,
                      tile % cols * G::BN, WT ? 2 - j : j);
  };
  // stage i landed; GN: GN+SiLU on the A units of this thread, into the
  // bf16 slot
  auto land = [&](int i) {
    const int s = i % G::STAGES;
    wg::mbar_wait(&full[s], (i / G::STAGES) & 1);
    if (!GN) return;
    // a thread's units share their 8 channels (GEMM_THREADS % 4 == 0)
    const int c = tid % (KC / 8), k = i % chunks * KC + 8 * c;
    const int m0 = tile_of(i) / cols * TM;
    unsigned char* st = smem + s * G::STAGE;
    uint4* p[A_UNITS];
    int b[A_UNITS], r[A_UNITS];
#pragma unroll
    for (int u = 0; u < A_UNITS; ++u) {
      r[u] = (tid + u * GEMM_THREADS) / (KC / 8);
      const int m = m0 - 1 + r[u];
      const bool ok = r[u] < A_ROWS && m >= 0 && m < M;
      // a float32 A writes every unit of the bf16 slot
      uint4* unit = reinterpret_cast<uint4*>(st + wg::sw64(r[u], c));
      p[u] = (G::F32 ? r[u] < A_ROWS : ok) ? unit : nullptr;
      b[u] = ok ? m / L : -1;
    }
    if (k < K)
      gn_silu_units<TA>(p, b, aff + 2 * k, 2 * (size_t)K, beta + k,
                        st + G::F_OFF, r, 2 * c);
    else if (G::F32)
      zero_units(p);
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

// Partial dW (and on a bf16 x db) of split s of the M = B L flattened
// rows (contiguous ranges of DW_KR-row chunks): part[s] = [dW (3, C,
// Cout) | db (Cout)], float32; on a float32 x the db part is written 0
// (round_colsum_kernel sums db). h = silu(GN(x)) in float32 from the
// affine table and beta, rounded to bf16; x (TX; map_h: (M, C), boxes of
// 64 (bf16) or 32 (float32) channels x H_ROWS) and the bf16 g (map_g: (M,
// Cout), boxes of 64 x DW_KR). Grid (ceil(C / 64), ceil(Cout / 128), S),
// DW_THREADS_WG threads (warpgroup j computes tap j), Dw<TX>::SMEM bytes
// of dynamic shared memory.
template <typename TX>
__global__ void __launch_bounds__(DW_THREADS_WG, 1)
    conv_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_h,
                         const __grid_constant__ CUtensorMap map_g,
                         const float* __restrict__ aff,
                         const float* __restrict__ beta,
                         float* __restrict__ part, int M, int L, int C,
                         int Cout, int S) {
  using D = Dw<TX>;
  extern __shared__ unsigned char dw_raw[];
  unsigned char* smem = align1k(dw_raw);
  float2* dbx = reinterpret_cast<float2*>(smem + DW_STAGES * D::STAGE);
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
    unsigned char* st = smem + slot * D::STAGE;
    wg::mbar_expect_tx(&full[slot], D::TX_BYTES);
    if (D::F32) {
      wg::tma_load_2d(st + D::F_OFF, &map_h, &full[slot], c0, r0 - 1);
      wg::tma_load_2d(st + D::F_OFF + H_SLOT, &map_h, &full[slot], c0 + 32,
                      r0 - 1);
    } else {
      wg::tma_load_2d(st, &map_h, &full[slot], c0, r0 - 1);
    }
    wg::tma_load_2d(st + H_SLOT, &map_g, &full[slot], o0, r0);
    wg::tma_load_2d(st + H_SLOT + G_PANEL, &map_g, &full[slot], o0 + 64, r0);
  };
  float2 dbp = make_float2(0.f, 0.f);
  // stage i landed: GN+SiLU on this thread's h units into the bf16 h
  // tile (rows outside [0, M) zero), and on a bf16 x db's sums of g
  // column pair cp, rows rg + 6 k
  auto land = [&](int i) {
    const int slot = i % DW_STAGES, r0 = (ch0 + i) * DW_KR;
    wg::mbar_wait(&full[slot], (i / DW_STAGES) & 1);
    unsigned char* st = smem + slot * D::STAGE;
    // a thread's units share their 8 channels (DW_THREADS_WG % 8 == 0)
    const int c = tid & 7, k = c0 + 8 * c;
    uint4* p[H_UNITS];
    int b[H_UNITS], r[H_UNITS];
#pragma unroll
    for (int u = 0; u < H_UNITS; ++u) {
      r[u] = (tid + u * DW_THREADS_WG) >> 3;
      const int m = r0 - 1 + r[u];
      const bool ok = r[u] < H_ROWS && m >= 0 && m < M;
      // a float32 x writes every unit of the bf16 tile
      uint4* unit = reinterpret_cast<uint4*>(st + wg::sw128(r[u], c));
      p[u] = (D::F32 ? r[u] < H_ROWS : ok) ? unit : nullptr;
      b[u] = ok ? m / L : -1;
    }
    if (k < C)
      gn_silu_units<TX>(p, b, aff + 2 * k, 2 * (size_t)C, beta + k,
                        st + D::F_OFF + (c >> 2) * H_SLOT, r, 2 * (c & 3));
    else if (D::F32)
      zero_units(p);
    if (!D::F32 && db_block) {
      const int col = 2 * cp;
      const unsigned char* gp = st + H_SLOT + (col >> 6) * G_PANEL +
                                (col & 7) * 2;
      for (int q = rg; q < DW_KR; q += DB_GROUPS) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            gp + wg::sw128(q, (col & 63) >> 3));
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
    const uint32_t h_base = wg::saddr(smem + i % DW_STAGES * D::STAGE);
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

// gq = bf16(g), to nearest even, for the (M, N) float32 g; part[p] = the
// column sums of g's rows [p per, (p + 1) per) in float32: each of the
// RC_THREADS / 32 row groups sums its rows in order, the groups are added
// in order. N % 4 == 0. Grid P, RC_THREADS threads.
__global__ void __launch_bounds__(RC_THREADS)
    round_colsum_kernel(const float* __restrict__ g, bf16* __restrict__ gq,
                        float* __restrict__ part, int M, int N, int per) {
  constexpr int GROUPS = RC_THREADS / 32;
  __shared__ float4 red[GROUPS][32];
  const int lane = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const int r0 = blockIdx.x * per, r1 = min(M, r0 + per);
  for (int c0 = 0; c0 < N; c0 += 128) {
    const int c = c0 + 4 * lane;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < N) {
#pragma unroll 4
      for (int r = r0 + rg; r < r1; r += GROUPS) {
        const size_t at = (size_t)r * N + c;
        const float4 v = *reinterpret_cast<const float4*>(g + at);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
        *reinterpret_cast<uint2*>(gq + at) =
            make_uint2(bf16mma::pack(v.x, v.y), bf16mma::pack(v.z, v.w));
      }
    }
    red[rg][lane] = s;
    __syncthreads();
    if (rg == 0 && c < N) {
      float4 v = red[0][lane];
      for (int q = 1; q < GROUPS; ++q) {
        v.x += red[q][lane].x;
        v.y += red[q][lane].y;
        v.z += red[q][lane].z;
        v.w += red[q][lane].w;
      }
      *reinterpret_cast<float4*>(part + (size_t)blockIdx.x * N + c) = v;
    }
    __syncthreads();
  }
}

int conv_shape_ok(int B, int L, int C, int Cout, int G) {
  return gn_shape_ok(B, L, C, G) && Cout >= 8 && Cout % 8 == 0 &&
         C % 8 == 0 && B <= 65535;
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

// a tensor map of the row-major (rows, cols) tensor t of TX in boxes of
// box_cols x box_rows with the given swizzle
template <typename TX>
cudaError_t rows_map(CUtensorMap* map, const TX* t, int rows, int cols,
                     int box_cols, int box_rows, CUtensorMapSwizzle sw) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(TX)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return wg::tensor_map(map,
                        std::is_same<TX, float>::value
                            ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        t, 2, dims, strides, box, sw);
}

template <typename TA, bool GN, bool WT, int NSUB, typename TO>
cudaError_t tap3_gemm_n(const TA* a, const float* aff, const float* beta,
                        const bf16* w, const float* bias, TO* out, int B,
                        int L, int K, int N, cudaStream_t s) {
  using G = Gemm<NSUB, TA>;
  CUtensorMap ma, mb;
  // a bf16 A in 64-byte rows of 32 values, a float32 one in 128-byte rows
  cudaError_t err = rows_map(&ma, a, B * L, K, KC, A_ROWS,
                             G::F32 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  const cuuint64_t db[3] = {(cuuint64_t)K, (cuuint64_t)N, 3};
  const cuuint64_t sb[2] = {(cuuint64_t)K * 2, (cuuint64_t)N * K * 2};
  const cuuint32_t bb[3] = {KC, (cuuint32_t)G::BN, 1};
  if ((err = wg::bf16_map(&mb, w, 3, db, sb, bb,
                          CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess)
    return err;
  if ((err = set_smem(tap3_wgmma_kernel<TA, GN, WT, NSUB, TO>, G::SMEM)) !=
      cudaSuccess)
    return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int tiles = gemm_tiles(B * L) * ((N + G::BN - 1) / G::BN);
  tap3_wgmma_kernel<TA, GN, WT, NSUB, TO>
      <<<min(tiles, sms), GEMM_THREADS, G::SMEM, s>>>(
          ma, mb, aff, beta, bias, out, B * L, L, K, N);
  return cudaGetLastError();
}

// w: (3, N, K) bf16, K-major (see tap3_wgmma_kernel)
template <typename TA, bool GN, bool WT, typename TO>
cudaError_t tap3_gemm(const TA* a, const float* aff, const float* beta,
                      const bf16* w, const float* bias, TO* out, int B,
                      int L, int K, int N, cudaStream_t s) {
  return N > 128 ? tap3_gemm_n<TA, GN, WT, 4>(a, aff, beta, w, bias, out, B,
                                              L, K, N, s)
                 : tap3_gemm_n<TA, GN, WT, 2>(a, aff, beta, w, bias, out, B,
                                              L, K, N, s);
}

template <typename TX>
cudaError_t conv_dw(const TX* x, const float* aff, const float* beta,
                    const bf16* gy, float* part, int B, int L, int C,
                    int Cout, int S, cudaStream_t s) {
  const int M = B * L;
  CUtensorMap mh, mg;
  // 128-byte rows: 64 bf16 or 32 float32 channels
  cudaError_t err = rows_map(&mh, x, M, C, 128 / (int)sizeof(TX), H_ROWS,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  if ((err = rows_map(&mg, gy, M, Cout, 64, DW_KR,
                      CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
    return err;
  if ((err = set_smem(conv_dw_wgmma_kernel<TX>, Dw<TX>::SMEM)) !=
      cudaSuccess)
    return err;
  const dim3 grid((C + DW_TC - 1) / DW_TC, (Cout + DW_TN - 1) / DW_TN, S);
  conv_dw_wgmma_kernel<TX><<<grid, DW_THREADS_WG, Dw<TX>::SMEM, s>>>(
      mh, mg, aff, beta, part, M, L, C, Cout, S);
  return cudaGetLastError();
}

template <typename TX>
int conv3_fwd(const TX* x, const float* gamma, const float* beta,
              const bf16* w, const float* bias, TX* out, float* stats, int B,
              int L, int C, int Cout, int G, float eps, GnPlan st,
              cudaStream_t s) {
  if (!conv_shape_ok(B, L, C, Cout, G)) return (int)cudaErrorInvalidValue;
  cudaError_t err = gn_tables(x, gamma, stats, B, L, C, G, eps, st, s);
  if (err != cudaSuccess) return (int)err;
  return (int)tap3_gemm<TX, true, false>(x, stats + affine_offset(B, G),
                                         beta, w, bias, out, B, L, C, Cout,
                                         s);
}

// gq / part_db / P: a float32 g's bf16 copy, db's partials and their
// count (round_colsum_kernel); unused on a bf16 x
template <typename TX>
int conv3_bwd(const TX* x, const float* gamma, const float* beta,
              const bf16* w, const TX* gy, TX* dx, float* dgb, float* dwb,
              float* stats, float* dh, float* part_w, float* part_gn,
              bf16* gq, float* part_db, int B, int L, int C, int Cout, int G,
              int S, int P, float eps, GnPlan st, GnPlan bw,
              cudaStream_t s) {
  constexpr bool F32 = std::is_same<TX, float>::value;
  if (!conv_shape_ok(B, L, C, Cout, G) || S < 1 || S > B ||
      (F32 && P < 1) || !gn_plan_ok<TX, float>(bw, 2, L, C / G))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = gn_tables(x, gamma, stats, B, L, C, G, eps, st, s);
  if (err != cudaSuccess) return (int)err;
  const int M = B * L, nw = 3 * C * Cout + Cout;
  const bf16* g16;
  if constexpr (F32) {
    round_colsum_kernel<<<P, RC_THREADS, 0, s>>>(gy, gq, part_db, M, Cout,
                                                 (M + P - 1) / P);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    g16 = gq;
  } else {
    g16 = gy;
  }
  const float* aff = stats + affine_offset(B, G);
  if ((err = conv_dw(x, aff, beta, g16, part_w, B, L, C, Cout, S, s)) !=
      cudaSuccess)
    return (int)err;
  sum_rows_kernel<<<(nw + 255) / 256, 256, 0, s>>>(part_w, dwb, S, nw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (F32) {                           // db from the float32 g
    sum_rows_kernel<<<(Cout + 255) / 256, 256, 0, s>>>(
        part_db, dwb + 3 * (size_t)C * Cout, P, Cout);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  err = tap3_gemm<bf16, false, true>(g16, nullptr, nullptr, w,
                                     (const float*)nullptr, dh, B, L, Cout,
                                     C, s);
  if (err != cudaSuccess) return (int)err;
  return (int)gn_silu_bwd(x, gamma, beta, (const float*)dh, stats, dx,
                          part_gn, dgb, B, L, C, G, eps, bw, s);
}

}  // namespace

extern "C" {

// x (B, L, C), gamma, beta (C), w (3, Cout, C) bf16: w[j] transposed,
// rounded to bf16 by the caller (K-major, see tap3_wgmma_kernel), bias
// (Cout) -> out (B, L, Cout). stats is scratch of affine_offset(B, G) + 2
// B C floats: the (B, G, 2) statistics, then the (B, C, 2) affine table.
// (st_staged, st_threads, st_smem) is the statistics' launch plan. C and
// Cout multiples of 8; x, beta and w start on 16-byte boundaries (TMA and
// the statistics' cp.async). A tensor map that cannot be encoded returns
// an error.
int ertdx_gn_conv3_fwd(const float* x, const float* gamma, const float* beta,
                       const bf16* w, const float* bias, float* out,
                       float* stats, int B, int L, int C, int Cout, int G,
                       float eps, int st_staged, int st_threads,
                       int st_smem, void* stream) {
  return conv3_fwd(x, gamma, beta, w, bias, out, stats, B, L, C, Cout, G,
                   eps, GnPlan{st_staged, st_threads, st_smem},
                   (cudaStream_t)stream);
}

// x (B, L, C), gamma, beta (C), w (3, C, Cout) bf16 (rounded by the
// caller), gy (B, L, Cout) -> dx (B, L, C), dgb (2 C: dgamma, dbeta), dwb
// (3 C Cout + Cout: dW, db). Scratch: stats (as the forward's), dh (B, L,
// C) float32, part_w (S, 3 C Cout + Cout), part_gn (B, 2, C), gq (B, L,
// Cout) bf16 and part_db (P, Cout): bf16(g) and db's partials. S splits
// the rows of the dW reduction, 1 <= S <= B; P those of db, P >= 1.
// (st_*) and (bw_*) are the launch plans of the statistics and of the GN
// backward, which takes those statistics. x, beta, w and gy start on
// 16-byte boundaries.
int ertdx_gn_conv3_bwd(const float* x, const float* gamma, const float* beta,
                       const bf16* w, const float* gy, float* dx, float* dgb,
                       float* dwb, float* stats, float* dh, float* part_w,
                       float* part_gn, bf16* gq, float* part_db, int B,
                       int L, int C, int Cout, int G, int S, int P,
                       float eps, int st_staged, int st_threads, int st_smem,
                       int bw_staged, int bw_threads, int bw_smem,
                       void* stream) {
  return conv3_bwd(x, gamma, beta, w, gy, dx, dgb, dwb, stats, dh, part_w,
                   part_gn, gq, part_db, B, L, C, Cout, G, S, P, eps,
                   GnPlan{st_staged, st_threads, st_smem},
                   GnPlan{bw_staged, bw_threads, bw_smem},
                   (cudaStream_t)stream);
}

// bf16 x, gy, out and dx; otherwise as the float32 entry points (gamma,
// beta, bias, stats, dgb, dwb, dh and the partials float32; bw_* the plan
// of the GN backward of a bf16 x and a float32 dh), with no gq, part_db
// or P: g is bf16 already, and db is summed from its tiles by dW.
int ertdx_gn_conv3_fwd_bf16(const bf16* x, const float* gamma,
                            const float* beta, const bf16* w,
                            const float* bias, bf16* out, float* stats,
                            int B, int L, int C, int Cout, int G, float eps,
                            int st_staged, int st_threads, int st_smem,
                            void* stream) {
  return conv3_fwd(x, gamma, beta, w, bias, out, stats, B, L, C, Cout, G,
                   eps, GnPlan{st_staged, st_threads, st_smem},
                   (cudaStream_t)stream);
}

int ertdx_gn_conv3_bwd_bf16(const bf16* x, const float* gamma,
                            const float* beta, const bf16* w, const bf16* gy,
                            bf16* dx, float* dgb, float* dwb, float* stats,
                            float* dh, float* part_w, float* part_gn, int B,
                            int L, int C, int Cout, int G, int S, float eps,
                            int st_staged, int st_threads, int st_smem,
                            int bw_staged, int bw_threads, int bw_smem,
                            void* stream) {
  return conv3_bwd(x, gamma, beta, w, gy, dx, dgb, dwb, stats, dh, part_w,
                   part_gn, (bf16*)nullptr, (float*)nullptr, B, L, C, Cout,
                   G, S, 0, eps, GnPlan{st_staged, st_threads, st_smem},
                   GnPlan{bw_staged, bw_threads, bw_smem},
                   (cudaStream_t)stream);
}

}  // extern "C"
