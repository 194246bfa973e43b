// Ensemble attention kernels for the per-block denoiser core (sm_90a), in
// JAX's one-pass mode.
//
// Replaces the TPU kernels of ertdx/ops/ensemble_attn.py:
//   * block_self_onepass_kernel   <- block_self_attention
//     (_block_self_kernel :89, called at :123): softmax(q k^T / sqrt(D)) v
//     for each of N chains of P <= 32 tokens;
//   * folded_cross_onepass_kernel <- folded_cross_attention
//     (_folded_cross_kernel :187, called at :221): the B x Lq folded chain
//     queries of each condition against that condition's Lk keys and
//     values.
//
// The function is JAX's kernel body at Precision.DEFAULT as its chip runs
// it: each product ONE bf16 pass, float32 accumulation. The operands are
// rounded to bf16 to nearest even where the body rounds them: q scaled by
// float32(1/sqrt(D)) and then rounded (at D = 128 the scale is no power of
// two, so it is not folded into the exponent), k and v rounded; the
// logits summed in float32, padding keys masked; the softmax in float32,
// max subtracted, exp, NORMALISED, then rounded for P V (not an online
// softmax rescaled at the end: JAX rounds normalised probabilities); P V
// summed in float32; the output written in q's dtype. That is
// ertdx_torch/ops/ensemble_attn.py::reference_attention_onepass. Both
// kernels are templates on the operand type T, float or __nv_bfloat16:
// q, k and v come in as the model holds them (float32 values are rounded
// as they are loaded, bf16 ones are the bf16 operands), no copy.
// Differences from the plain version: the sum order of the products and
// the exponential (ex2.approx of (s - max) log2 e) and the division (one
// reciprocal a row), each within a few float32 ulps, which move a bf16
// rounding now and then; chip_smoke.py phase 8 holds them by their rms
// error against the float32 function.
//
// What bounds them on an H100 (3.35 TB/s; 989 TFLOP/s bf16 dense):
//   * self: bytes. 4 N P^2 D flops on 4 N P D values read or written, i.e.
//     P / 2 = 14.5 flops a byte in bf16 at P = 29. At N = 2000, D = 128:
//     59.4 MB in bf16 (0.0177 ms), 118.8 MB in float32 (0.0355 ms); the
//     products 0.86 GFLOP, 0.0009 ms.
//   * cross: bytes. 4 B Lq Lk D flops; K and V are read once per condition.
//     At B = 2, Lq = 29,000, Lk = 147: 29.8 MB in bf16 (0.0089 ms), 59.4
//     MB in float32 (0.0178 ms); 4.37 GFLOP, 0.0044 ms on the tensor cores
//     at wgmma's rate (mma.sync's is lower; not measured here).
// So the bytes have to stream, on the m16n8k16 fragment (bf16mma.cuh),
// which fits P = 29 chains and 16-row q tiles better than wgmma's 64-row
// tile. Shared rows are D + 8 values of T (bf16 tiles: D + 8 bf16):
// 16-byte rows for cp.async and ldmatrix, and 32-bit (bf16) or 64-bit
// (float2) fragment loads of rows g, columns 2t hit distinct banks. Each
// warp puts its 16 output rows together in shared memory, in the q rows it
// has consumed, and writes them out in whole 128-byte lines (a fragment's
// 4-byte stores, 8 rows apart, cost each kernel up to 10 us at phase 8's
// shapes).
//   * block_self_onepass_kernel: a pair of warps takes a chain, one m16
//     tile of its rows each, the keys padded to 32 and masked, D / 16 k
//     steps. The pairs are independent: each has its own double-buffered
//     ring of (q, k, v) stages filled with 16-byte cp.async, chain c +
//     (pairs in the grid) staged while chain c computes, and meets on a
//     named barrier; the grid is persistent. bf16 stages are half the
//     bytes, so twice the pairs (chains in flight) fit an SM: 4 at D = 128
//     against 2 in float32. (One warp a chain, both m tiles, took 0.048 ms
//     in float32 against a pair's 0.0445.) Rows P .. 31 are zeroed once
//     (V's are read, times P = 0). q and k fragments are loaded from the
//     stage (32-bit bf16 pairs, or float2 rounded by the load; q scaled
//     first); V by ldmatrix.trans from bf16 rows (a float32 V is rounded
//     into a bf16 tile of the pair's first). The logits stay in registers;
//     the normalised P is rounded and fed to P V as the A fragments
//     straight from the C fragments.
//   * folded_cross_onepass_kernel: a block takes its condition's K and V
//     into bf16 tiles once (K rows 8 NT, V rows 16 ceil(NT / 2), zero past
//     Lk; 84,864 bytes at Lk = 147, D = 128, against 160,512 in float32
//     for the 3xTF32 kernel it replaces): bf16 rows by cp.async, float32
//     rows by cp.async into the q rings, not yet in use, and rounded from
//     there (rounded on their way in from global memory, they took 11 us
//     of the float32 kernel's 40). Its warps walk the condition's 16-row q
//     tiles with a stride, each through its own double-buffered cp.async
//     ring, so that the next tile's copy runs under this tile's products
//     and softmax. All NT x 8 <= 256 logits of a row are held in registers
//     for the one-pass normalised softmax (NT n tiles of 8 keys: buckets
//     8, 16, 19, 24 and, at D = 64, 32). K and V fragments come by
//     ldmatrix. With 8 warps an SM at up to 255 registers, a warp's
//     products, softmax and stores run one after another, and the kernel
//     takes about 2.5x its loads and stores alone.
//   * q, k and v may be row-strided views (the chunks of the fused
//     projections): rows must start on 16-byte boundaries (strides a
//     multiple of 4 floats or 8 bf16; the wrapper checks the base).
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError(); float32 entry points take float
// pointers, the _bf16 ones __nv_bfloat16 pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16mma.cuh"

namespace {

using bf16mma::bf16;

constexpr int ROWS = 32;               // a chain's rows, padded (self)
constexpr int SELF_WARPS = 8;          // at most, a block (self)
constexpr int CROSS_WARPS = 8;         // at most, a block (cross)
constexpr int CROSS_STAGES = 2;        // q tiles in a warp's ring (cross)
constexpr size_t SMEM_LIMIT = 232448;  // bytes a block may use on sm_90
constexpr float LOG2E = 1.4426950408889634f;

// ---- loads --------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte cp.async global -> shared; with full == false the 16 bytes are
// zero-filled and nothing is read.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two adjacent values of a row as floats.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Two adjacent values as a bf16x2 fragment register: float32 values
// rounded to nearest even, bf16 ones as they are.
__device__ __forceinline__ uint32_t frag2(const float* p) {
  const float2 x = load2(p);
  return bf16mma::pack(x.x, x.y);
}
__device__ __forceinline__ uint32_t frag2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The same for q: each value times the scale in float32, then rounded.
template <typename T>
__device__ __forceinline__ uint32_t frag2_scaled(const T* p, float scale) {
  const float2 x = load2(p);
  return bf16mma::pack(x.x * scale, x.y * scale);
}

// Eight adjacent values (16-byte aligned) as bf16, rounded where float.
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return make_uint4(bf16mma::pack(a.x, a.y), bf16mma::pack(a.z, a.w),
                    bf16mma::pack(b.x, b.y), bf16mma::pack(b.z, b.w));
}
__device__ __forceinline__ uint4 load8(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// cp.async rows 0 .. n - 1 of D values of T (global, row stride ld) into
// shared rows of D + 8; rows valid .. n - 1 zero-filled. Threads first ..
// first + count - 1 of the block take part.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* s, const T* g, long ld, int n,
                                           int valid, int first, int count) {
  constexpr int E = 16 / sizeof(T), C = D / E;
  for (int i = (int)threadIdx.x - first; i < n * C; i += count) {
    const int r = i / C, c = (i % C) * E;
    const bool ok = r < valid;
    cp16(s + r * (D + 8) + c, g + (ok ? (size_t)r * ld : 0) + c, ok);
  }
}

// Rows 0 .. n - 1 of D values of T (row stride ld) rounded into shared
// bf16 rows of D + 8; rows valid .. n - 1 zero. Threads first .. first +
// count - 1 take part.
template <typename T, int D>
__device__ __forceinline__ void round_rows(bf16* s, const T* g, long ld,
                                           int n, int valid, int first,
                                           int count) {
  constexpr int C = D / 8;
  for (int i = (int)threadIdx.x - first; i < n * C; i += count) {
    const int r = i / C, c = (i % C) * 8;
    *reinterpret_cast<uint4*>(s + r * (D + 8) + c) =
        r < valid ? load8(g + (size_t)r * ld + c) : make_uint4(0, 0, 0, 0);
  }
}

// The softmax of the 16 rows of NT n tiles of logits s (rows g and g + 8
// of the C fragments), keys >= nkeys masked, normalised and rounded into
// the A fragments of P V's (NT + 1) / 2 k steps (an odd NT's last k step
// padded with zeros).
template <int NT>
__device__ __forceinline__ void softmax_to_a(float (&s)[NT][4],
                                             uint32_t (&pa)[(NT + 1) / 2][4],
                                             int nkeys, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (8 * n + 2 * t + (e & 1) >= nkeys) s[n][e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) mx[r] = bf16mma::quad_max(mx[r]) * LOG2E;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = ex2(fmaf(s[n][e], LOG2E, -mx[e >> 1]));
      sum[e >> 1] += s[n][e];
    }
  const float inv[2] = {1.f / bf16mma::quad_sum(sum[0]),
                        1.f / bf16mma::quad_sum(sum[1])};
#pragma unroll
  for (int j = 0; j < (NT + 1) / 2; ++j) {
    const int n = 2 * j;
    pa[j][0] = bf16mma::pack(s[n][0] * inv[0], s[n][1] * inv[0]);
    pa[j][1] = bf16mma::pack(s[n][2] * inv[1], s[n][3] * inv[1]);
    if (n + 1 < NT) {
      pa[j][2] = bf16mma::pack(s[n + 1][0] * inv[0], s[n + 1][1] * inv[0]);
      pa[j][3] = bf16mma::pack(s[n + 1][2] * inv[1], s[n + 1][3] * inv[1]);
    } else {
      pa[j][2] = pa[j][3] = 0u;
    }
  }
}

// out rows 0 .. nrows - 1 (global, row stride D) = the 16 rows of P V for
// the KS k steps of P in pa and the bf16 V rows at Vb (row stride D + 8),
// each n tile's k steps summed on the MMA's accumulator. The rows are put
// together in `tile`, the warp's own 16 shared rows of D + 8 values of T
// (free once its q fragments are loaded), and written out from there in
// 16-byte pieces.
template <typename T, int D, int KS>
__device__ __forceinline__ void pv_store(const uint32_t (&pa)[KS][4],
                                         const bf16* Vb, T* tile, T* out,
                                         int nrows, int lane) {
  constexpr int NT = D / 8, LD = D + 8;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t vaddr = smem_addr(Vb + (lane & 15) * LD + 8 * (lane >> 4));
  float acc[NT][4] = {};
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      bf16mma::ldmatrix_x4_t(b, vaddr + 2 * (16 * j * LD + 8 * n));
      bf16mma::mma(acc[n], pa[j], b[0], b[1]);
      bf16mma::mma(acc[n + 1], pa[j], b[2], b[3]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      store2(tile + (g + 8 * r) * LD + 8 * n + 2 * t, acc[n][2 * r],
             acc[n][2 * r + 1]);
  __syncwarp();
  constexpr int E = 16 / sizeof(T), C = D / E;
  for (int i = lane; i < nrows * C; i += 32) {
    const int r = i / C, c = (i % C) * E;
    *reinterpret_cast<uint4*>(out + (size_t)r * D + c) =
        *reinterpret_cast<const uint4*>(tile + r * LD + c);
  }
}

// ---- self ----------------------------------------------------------------

// A pair of warps' shared memory (self): two stages of (q, k, v), ROWS rows
// of D + 8 values of T each, and for float32 operands a bf16 tile of V.
template <typename T, int D>
struct SelfLayout {
  static constexpr int TILE = ROWS * (D + 8);
  static constexpr size_t STAGE = 3 * TILE * sizeof(T);
  static constexpr size_t VB = sizeof(T) == 4 ? TILE * sizeof(bf16) : 0;
  static constexpr size_t PAIR = 2 * STAGE + VB;
};

// The 64 threads of warp pair `pair` meet (named barrier 1 + pair).
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
}

// Pair p of block x takes chains x W + p, x W + p + gridDim.x W, ... (W
// pairs a block), each chain's q, k and v staged into the pair's other
// stage while the chain before it computes; warp h of the pair computes
// query rows 16 h .. 16 h + 15 of the chain against its P keys.
template <typename T, int D>
__global__ void __launch_bounds__(32 * SELF_WARPS)
    block_self_onepass_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out,
                              long ldq, long ldk, long ldv, int N, int P,
                              float scale) {
  using L = SelfLayout<T, D>;
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pair = warp >> 1, h = warp & 1, first = pair * 64;
  const int g = lane >> 2, t = lane & 3;
  const int pt = threadIdx.x - first;              // 0 .. 63 in the pair
  unsigned char* mine = smem + pair * L::PAIR;
  T* stages = reinterpret_cast<T*>(mine);
  bf16* vround = reinterpret_cast<bf16*>(mine + 2 * L::STAGE);
  // rows P .. ROWS - 1 of every tile: read by the fragments, never staged
  constexpr int C16 = LD * (int)sizeof(T) / 16;
  for (int i = pt; i < 6 * (ROWS - P) * C16; i += 64) {
    const int tile = i / ((ROWS - P) * C16), rest = i % ((ROWS - P) * C16);
    reinterpret_cast<uint4*>(stages + tile * L::TILE +
                             (P + rest / C16) * LD)[rest % C16] =
        make_uint4(0, 0, 0, 0);
  }
  if constexpr (sizeof(T) == 4)
    for (int i = pt; i < (ROWS - P) * LD / 8; i += 64)
      reinterpret_cast<uint4*>(vround + P * LD)[i] = make_uint4(0, 0, 0, 0);

  const int pairs = blockDim.x >> 6, step = gridDim.x * pairs;
  auto issue = [&](int chain, int s) {
    if (chain < N) {
      T* st = stages + s * 3 * L::TILE;
      const size_t row = (size_t)chain * P;
      stage_rows<T, D>(st, q + row * ldq, ldq, P, P, first, 64);
      stage_rows<T, D>(st + L::TILE, k + row * ldk, ldk, P, P, first, 64);
      stage_rows<T, D>(st + 2 * L::TILE, v + row * ldv, ldv, P, P, first,
                       64);
    }
    cp_commit();
  };
  int chain = blockIdx.x * pairs + pair;
  issue(chain, 0);
  for (int s = 0; chain < N; chain += step, s ^= 1) {
    issue(chain + step, s ^ 1);
    cp_wait<1>();                          // this chain's group has landed
    pair_sync(pair);                       // ... the pair's copies too
    const T* Qs = stages + s * 3 * L::TILE;   // the output goes in its rows
    const T* Ks = Qs + L::TILE;
    const bf16* Vb = reinterpret_cast<const bf16*>(Qs + 2 * L::TILE);
    if constexpr (sizeof(T) == 4) {        // V rounded into the bf16 tile
      round_rows<T, D>(vround, Qs + 2 * L::TILE, LD, P, P, first, 64);
      Vb = vround;
    }
    const bool rows = 16 * h < P;
    float sacc[4][4] = {};
    if (rows) {
      // S = (q scale) k^T for this warp's m tile against the 4 key tiles
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 16) {
        uint32_t a[4];
        const T* r0 = Qs + (16 * h + g) * LD + k0 + 2 * t;
        a[0] = frag2_scaled(r0, scale);
        a[1] = frag2_scaled(r0 + 8 * LD, scale);
        a[2] = frag2_scaled(r0 + 8, scale);
        a[3] = frag2_scaled(r0 + 8 * LD + 8, scale);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const T* kr = Ks + (8 * n + g) * LD + k0 + 2 * t;
          bf16mma::mma(sacc[n], a, frag2(kr), frag2(kr + 8));
        }
      }
    }
    if constexpr (sizeof(T) == 4) pair_sync(pair);   // V is rounded
    if (rows) {
      uint32_t pa[2][4];
      softmax_to_a<4>(sacc, pa, P, t);
      pv_store<T, D, 2>(pa, Vb, stages + s * 3 * L::TILE + 16 * h * LD,
                        out + ((size_t)chain * P + 16 * h) * D,
                        min(16, P - 16 * h), lane);
    }
    pair_sync(pair);                       // stage s is free for reuse
  }
}

// ---- cross ---------------------------------------------------------------

template <int D, int NT>
__host__ __device__ constexpr size_t cross_kv_bytes() {
  return (size_t)(8 * NT + 16 * ((NT + 1) / 2)) * (D + 8) * sizeof(bf16);
}

template <typename T, int D>
__host__ __device__ constexpr size_t cross_warp_bytes() {
  return (size_t)CROSS_STAGES * 16 * (D + 8) * sizeof(T);
}

// gridDim.y = B conditions, gridDim.x blocks per condition (one wave):
// each rounds its condition's K and V into bf16 tiles once, then warp w
// of block x walks the condition's 16-row query tiles x W + w,
// x W + w + gridDim.x W, ... (W warps a block) through its ring.
template <typename T, int D, int NT>
__global__ void __launch_bounds__(32 * CROSS_WARPS, 1)
    folded_cross_onepass_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v, T* __restrict__ out,
                                long ldq, long ldk, long ldv, int Lq, int Lk,
                                float scale) {
  constexpr int LD = D + 8, KS = (NT + 1) / 2, ST = CROSS_STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, g = lane >> 2, t = lane & 3;
  const size_t b = blockIdx.y;
  bf16* Kb = reinterpret_cast<bf16*>(smem);              // 8 NT rows
  bf16* Vb = Kb + 8 * NT * LD;                           // 16 KS rows
  T* ring = reinterpret_cast<T*>(smem + cross_kv_bytes<D, NT>()) +
            warp * ST * 16 * LD;
  const T* qb = q + b * Lq * ldq;
  T* ob = out + b * Lq * D;
  const int tiles = (Lq + 15) / 16, step = gridDim.x * warps;
  const int tile0 = blockIdx.x * warps + warp;
  auto issue = [&](int tile, int slot) {
    if (tile < tiles)
      stage_rows<T, D>(ring + slot * 16 * LD, qb + (size_t)tile * 16 * ldq,
                       ldq, 16, Lq - tile * 16, warp * 32, 32);
    cp_commit();
  };
  // K and V: bf16 rows copied as they are, in a group of their own ahead
  // of the q tiles'; float32 rows copied the same way into the q rings,
  // still unused, K and then V, and rounded from there
  if constexpr (sizeof(T) == 2) {
    stage_rows<T, D>(Kb, k + b * Lk * ldk, ldk, 8 * NT, Lk, 0, blockDim.x);
    stage_rows<T, D>(Vb, v + b * Lk * ldv, ldv, 16 * KS, Lk, 0, blockDim.x);
    cp_commit();
  } else {
    T* rows = reinterpret_cast<T*>(smem + cross_kv_bytes<D, NT>());
    const T* src[2] = {k + b * Lk * ldk, v + b * Lk * ldv};
    const long ld[2] = {ldk, ldv};
    bf16* dst[2] = {Kb, Vb};
    const int n[2] = {8 * NT, 16 * KS};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      stage_rows<T, D>(rows, src[j], ld[j], n[j], Lk, 0, blockDim.x);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      round_rows<T, D>(dst[j], rows, LD, n[j], n[j], 0, blockDim.x);
      __syncthreads();
    }
  }
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) issue(tile0 + s * step, s);
  cp_wait<ST - 1>();                       // K and V have landed
  __syncthreads();

  // ldmatrix row addresses: K's n tiles 2j, 2j + 1 (rows 16 j + 0 .. 15)
  // at columns k0, k0 + 8
  const uint32_t kaddr = smem_addr(Kb + ((lane & 7) + 8 * (lane >> 4)) * LD +
                                   8 * ((lane >> 3) & 1));
  int i = 0;
  for (int tile = tile0; tile < tiles; tile += step, ++i) {
    issue(tile + (ST - 1) * step, (i + ST - 1) % ST);
    cp_wait<ST - 1>();                     // this tile's group has landed
    __syncwarp();
    const T* Qs = ring + (i % ST) * 16 * LD;

    float s[NT][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t a[4];
      const T* r0 = Qs + g * LD + k0 + 2 * t;
      a[0] = frag2_scaled(r0, scale);
      a[1] = frag2_scaled(r0 + 8 * LD, scale);
      a[2] = frag2_scaled(r0 + 8, scale);
      a[3] = frag2_scaled(r0 + 8 * LD + 8, scale);
#pragma unroll
      for (int n = 0; n + 1 < NT; n += 2) {
        uint32_t bk[4];
        bf16mma::ldmatrix_x4(bk, kaddr + 2 * (8 * n * LD + k0));
        bf16mma::mma(s[n], a, bk[0], bk[1]);
        bf16mma::mma(s[n + 1], a, bk[2], bk[3]);
      }
      if (NT % 2) {
        uint32_t bk[2];
        bf16mma::ldmatrix_x2(bk, kaddr + 2 * (8 * (NT - 1) * LD + k0));
        bf16mma::mma(s[NT - 1], a, bk[0], bk[1]);
      }
    }
    uint32_t pa[KS][4];
    softmax_to_a<NT>(s, pa, Lk, t);
    pv_store<T, D, KS>(pa, Vb, ring + (i % ST) * 16 * LD,
                       ob + (size_t)tile * 16 * D, min(16, Lq - 16 * tile),
                       lane);
    __syncwarp();                          // the slot is free for reuse
  }
}

constexpr int MAX_DEVICES = 64;

// Per device and kernel, what a launch needs from the runtime, queried
// once: the shared-memory limit is raised at the first launch and the SM
// count and blocks per SM are kept, so that a launch costs the host no
// more than the launch itself.
struct LaunchCache {
  bool raised = false;
  int sms = 0;
  int per_sm = 0;
};

template <typename K>
cudaError_t prepare(K kernel, LaunchCache* caches, int threads, size_t smem,
                    int* slots) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  LaunchCache& c = caches[dev];
  if (!c.raised) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    c.raised = true;
  }
  if (c.per_sm < 1) return cudaErrorInvalidConfiguration;
  *slots = c.sms * c.per_sm;
  return cudaSuccess;
}

float inv_sqrt(int d) { return (float)(1.0 / sqrt((double)d)); }

template <typename T, int D>
int launch_self(const T* q, const T* k, const T* v, T* out, long ldq,
                long ldk, long ldv, int N, int P, cudaStream_t stream) {
  static LaunchCache caches[MAX_DEVICES];
  constexpr size_t per_pair = SelfLayout<T, D>::PAIR;
  constexpr int pairs = SMEM_LIMIT / per_pair < SELF_WARPS / 2
                            ? (int)(SMEM_LIMIT / per_pair) : SELF_WARPS / 2;
  constexpr size_t smem = pairs * per_pair;
  int slots = 0;
  cudaError_t err = prepare(block_self_onepass_kernel<T, D>, caches,
                            64 * pairs, smem, &slots);
  if (err != cudaSuccess) return (int)err;
  const int blocks = min(slots, (N + pairs - 1) / pairs);
  block_self_onepass_kernel<T, D><<<blocks, 64 * pairs, smem, stream>>>(
      q, k, v, out, ldq, ldk, ldv, N, P, inv_sqrt(D));
  return (int)cudaGetLastError();
}

template <typename T, int D, int NT>
int launch_cross(const T* q, const T* k, const T* v, T* out, long ldq,
                 long ldk, long ldv, int B, int Lq, int Lk,
                 cudaStream_t stream) {
  static LaunchCache caches[MAX_DEVICES];
  constexpr size_t kv = cross_kv_bytes<D, NT>(), w = cross_warp_bytes<T, D>();
  static_assert(kv + w <= SMEM_LIMIT, "K and V leave no room for a warp");
  constexpr int fit = (int)((SMEM_LIMIT - kv) / w);
  constexpr int warps = fit < CROSS_WARPS ? fit : CROSS_WARPS;
  // float32 K and V pass through the q rings (the kernel's prologue)
  static_assert(sizeof(T) == 2 || warps * w >= (size_t)16 * ((NT + 1) / 2) *
                                                   (D + 8) * sizeof(T),
                "float32 V rows do not fit the q rings");
  constexpr size_t smem = kv + warps * w;
  int slots = 0;
  cudaError_t err = prepare(folded_cross_onepass_kernel<T, D, NT>, caches,
                            32 * warps, smem, &slots);
  if (err != cudaSuccess) return (int)err;
  // fill the card once; never more blocks than a condition has q tiles
  const int tiles = (Lq + 15) / 16;
  const int gx = max(1, min(slots / B, (tiles + warps - 1) / warps));
  folded_cross_onepass_kernel<T, D, NT>
      <<<dim3(gx, B), 32 * warps, smem, stream>>>(q, k, v, out, ldq, ldk,
                                                 ldv, Lq, Lk, inv_sqrt(D));
  return (int)cudaGetLastError();
}

// Key tiles of 8 that the cross kernel pads Lk to (0: not taken).
int cross_key_tiles(int Lk, int D) {
  const int n = (Lk + 7) / 8;
  return n <= 8 ? 8 : n <= 16 ? 16 : n <= 19 ? 19 : n <= 24 ? 24
         : n <= 32 && D == 64 ? 32 : 0;
}

template <typename T, int D>
int launch_cross_nt(const T* q, const T* k, const T* v, T* out, long ldq,
                    long ldk, long ldv, int B, int Lq, int Lk,
                    cudaStream_t s) {
  switch (cross_key_tiles(Lk, D)) {
    case 8:
      return launch_cross<T, D, 8>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
    case 16:
      return launch_cross<T, D, 16>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk,
                                    s);
    case 19:
      return launch_cross<T, D, 19>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk,
                                    s);
    case 24:
      return launch_cross<T, D, 24>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk,
                                    s);
    case 32:
      if constexpr (D == 64)
        return launch_cross<T, D, 32>(q, k, v, out, ldq, ldk, ldv, B, Lq,
                                      Lk, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
bool strides_ok(long ldq, long ldk, long ldv, int D) {
  constexpr long E = 16 / sizeof(T);
  return ldq >= D && ldk >= D && ldv >= D && ldq % E == 0 && ldk % E == 0 &&
         ldv % E == 0;
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

template <typename T>
int self_attn(const T* q, const T* k, const T* v, T* out, long ldq,
              long ldk, long ldv, int N, int P, int D, void* stream) {
  if (N < 1 || P < 1 || P > ROWS || !strides_ok<T>(ldq, ldk, ldv, D))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128)
    return launch_self<T, 128>(q, k, v, out, ldq, ldk, ldv, N, P, s);
  if (D == 64) return launch_self<T, 64>(q, k, v, out, ldq, ldk, ldv, N, P, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int cross_attn(const T* q, const T* k, const T* v, T* out, long ldq,
               long ldk, long ldv, int B, int Lq, int Lk, int D,
               void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || cross_key_tiles(Lk, D) == 0 ||
      !strides_ok<T>(ldq, ldk, ldv, D))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128)
    return launch_cross_nt<T, 128>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
  if (D == 64)
    return launch_cross_nt<T, 64>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int ertdx_block_self_attn(const float* q, const float* k, const float* v,
                          float* out, long ldq, long ldk, long ldv, int N,
                          int P, int D, void* stream) {
  return self_attn(q, k, v, out, ldq, ldk, ldv, N, P, D, stream);
}

int ertdx_block_self_attn_bf16(const bf16* q, const bf16* k, const bf16* v,
                               bf16* out, long ldq, long ldk, long ldv,
                               int N, int P, int D, void* stream) {
  return self_attn(q, k, v, out, ldq, ldk, ldv, N, P, D, stream);
}

int ertdx_folded_cross_attn(const float* q, const float* k, const float* v,
                            float* out, long ldq, long ldk, long ldv, int B,
                            int Lq, int Lk, int D, void* stream) {
  return cross_attn(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, D, stream);
}

int ertdx_folded_cross_attn_bf16(const bf16* q, const bf16* k,
                                 const bf16* v, bf16* out, long ldq,
                                 long ldk, long ldv, int B, int Lq, int Lk,
                                 int D, void* stream) {
  return cross_attn(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, D, stream);
}

}  // extern "C"
