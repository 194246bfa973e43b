// Packed-head slab attention in bfloat16, forward and backward, on
// Hopper's warpgroup MMA and tensor memory accelerator (sm_90a; every
// product one bf16 wgmma of wgmma.cuh, float32 accumulation).
//
// Replaces the TPU kernels of ertdx/ops/slab_attn.py on a bf16 slab, the
// encoder of a bfloat16 model (V5E8_DP):
//   * slab_fwd_wgmma_kernel   <- _slab_fwd_kernel (:147-168)
//   * slab_bwd_wgmma_kernel   <- _slab_bwd_kernel (:184-222), one launch
//     that emits the whole dQKV slab from one read of each input, as the
//     TPU kernel does
// The layout is slab_attn.cu's: the fused QKV slab (B, L, 3C) in, q at
// lanes [0, C), k at [C, 2C), v at [2C, 3C), head h at [h dh, (h+1) dh)
// of each third; the output (B, L, C) and dQ | dK | dV (B, L, 3C) out,
// all bf16. The math is the TPU kernel's at its DEFAULT precision, which
// on the TPU is one bf16 pass a product with float32 accumulation:
//   * S = Q K^T from the bf16 operands (exact products, float32 sums),
//     then scaled by 1/sqrt(dh) in float32;
//   * the softmax in float32 on the accumulators, keys >= L at -inf, as
//     2^x of the logits scaled by log2(e) (one FMA and one MUFU.EX2 a
//     value, ex2.approx.ftz: the library's expf took a fifth of the
//     backward's time);
//   * O = P V with P rounded to bf16 for the product (2^(S - max), the
//     running max of an online softmax over chunks of keys, divided by
//     the float32 row sum at the end); O rounded to bf16 on the way out;
//   * the backward: dP = dO V^T exact, dS = P o (dP - delta) in float32,
//     dQ = dS K scale, dK = dS^T Q scale, dV = P^T dO with dS and P
//     rounded to bf16 for their products; dQKV rounded to bf16. delta is
//     rowsum(dO o O), O = P V / rowsum as the forward forms it in float32
//     (unrounded): rowsum(P o dP) = rowsum(dO o P V) exactly, and O costs
//     one product where P o dP costs two (S and dP again); P = 2^(S scale
//     log2(e) - lse) is recomputed from the log-sum-exp (base 2).
//
// What bounds it on an H100: bytes, and the padded products close
// behind. At the encoder's training shape (B=256, L=147, C=256, H=4,
// dh=64) the forward reads the bf16 slab and writes the output, 77 MB,
// 0.023 ms at 3.35 TB/s, against 4 B H L^2 dh = 5.7 GFLOP (0.0057 ms at
// 989 TFLOP/s; 64-row query tiles and 32-key padding make it 8.1); the
// backward reads the slab and dO and writes dQKV, 135 MB (0.040 ms), for
// 10 B H L^2 dh = 14.2 GFLOP (0.014 ms; 9 padded products here, 36).
//
// The design:
//   * Persistent: one block an SM walks the (batch row, head) pairs
//     blockIdx.x, + gridDim.x, ... with three warpgroups (384 threads, up
//     to 168 registers a thread; no producer warp, as gn_conv.cu's wgmma
//     GEMMs). Three beat two (PERF.md §6, PR 18): a warpgroup waits for
//     each group of its products, and more warpgroups hide more of that.
//     A head's operands land by TMA (3-D tensor maps over the slab as
//     (3C, L, B) and dO as (C, L, B), a box of dh x Lp rows, Lp = L
//     rounded up to 32; rows past L land as zeros) in a ring of `stages`
//     head slots, rows of 128 bytes with 128-byte swizzle (dh = 64) or 64
//     with 64-byte swizzle (dh = 32); one full barrier a slot.
//   * Work items: the forward's items are the 64-row query tiles of each
//     head; the backward's are a head's query tiles (phase i) and then
//     its 64-row key tiles (phase ii). The warpgroups take the block's
//     items in turns, across heads. A slot's empty barrier counts its
//     items' threads; thread 0 refills a slot once its head is done, as
//     early as its own work lets it look (`pump`): it issues every load
//     whose slot is free without waiting, and waits only for the head its
//     warpgroup needs.
//   * A product: A from registers (Q, dO, K, V rows by ldmatrix from the
//     swizzled tile, again for each chunk, so that they hold no registers
//     between products; P and dS from the accumulators, rounded to bf16),
//     B by descriptor: K-major (K, V, Q, dO rows as B^T: S, dP, S^T,
//     dP^T) or MN-major (V, K, dO, Q rows as B: O, dQ, dV, dK). wgmma
//     m64n64k16 over chunks of 64 keys or queries, m64n32k16 over chunks
//     of 32; 64 x dh products with N = dh. The forward walks its keys 64
//     at a time (a last 32 where Lp % 64 == 32); the backward 32 at a
//     time, which keeps it within 168 registers.
//   * Forward (a query tile): the online softmax over the key chunks, P V
//     on the accumulator, rescaled a chunk; the output through a
//     swizzled staging tile in shared memory, 16-byte stores.
//   * Backward phase i (a query tile): the forward's pass gives O, the
//     row max and sum; lse and delta = rowsum(dO o O / sum) go to the
//     slot's shared lse / delta rows (rows past L: +inf / 0, so that P is
//     0 there in phase ii), and a ready barrier counts them; then per key
//     chunk S and dP again, P from lse, dS, and dQ += dS K.
//   * Backward phase ii (a key tile, after the head's ready barrier): per
//     query chunk S^T = K Q^T and dP^T = V dO^T, P^T and dS^T from the
//     shared lse and delta, dV += P^T dO and dK += dS^T Q. No global
//     scratch, no atomics: each item owns its output rows, and reruns
//     are bit-identical.
//   * The ragged edge: query and key tiles reach 64 T rows (T = ceil(L /
//     64)), up to 32 rows past a tile's Lp; they read the next tile of
//     the slot (or the staging tiles after the ring), which only feeds
//     rows >= L, never written. Rows past L are never written.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError(). The caller picks the ring's
// depth (ops/slab_attn.py::bf16_plan); the shared bytes follow from it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16mma.cuh"
#include "wgmma.cuh"

namespace {

using bf16mma::bf16;

constexpr int L_MAX = 256;             // longest sequence the kernels take
// Warpgroups a block (registers are split per SM sub-partition: three
// cap a thread at 168, four at 128), and whether a pass walks its keys
// (or queries) 64 at a time, else 32: the forward's, the backward's query
// tiles', its key tiles'.
constexpr int FWD_WARPGROUPS = 3, BWD_WARPGROUPS = 3;
constexpr bool FWD_WIDE = true, DQ_WIDE = false, DKV_WIDE = false;
constexpr int SMEM_MAX = 232448;       // an H100 block's shared memory

int lp_of(int L) { return (L + 31) / 32 * 32; }

// the forward's and the backward's dynamic shared memory: the ring of
// head slots (Q, K, V; Q, K, V, dO and the lse / delta rows), a 64-row
// staging tile a warpgroup, the barriers, and 1 KB to align the ring
size_t fwd_smem(int Lp, int DH, int stages) {
  return 1024 + (size_t)stages * 3 * Lp * DH * 2 +
         FWD_WARPGROUPS * 64 * DH * 2 + 16 * stages;
}

size_t bwd_smem(int Lp, int DH, int stages) {
  return 1024 + (size_t)stages * (4 * Lp * DH * 2 + 2 * Lp * 4) +
         BWD_WARPGROUPS * 64 * DH * 2 + 24 * stages;
}

__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return p + ((1024u - (wg::saddr(p) & 1023u)) & 1023u);
}

// The tiles of one head dimension: rows of DH bf16 values (RB bytes),
// swizzled as TMA writes them.
template <int DH>
struct Tile {
  static constexpr int RB = DH * 2;
  static constexpr int KS = DH / 16;   // k16 steps over dh
  static constexpr int NA = DH / 2;    // accumulators of a 64 x DH product
  static constexpr uint32_t SWIZZLE =
      DH == 64 ? wg::SWIZZLE_128B : wg::SWIZZLE_64B;

  // byte offset of 16-byte chunk c of row r
  __device__ static uint32_t sw(int r, int c) {
    return DH == 64 ? wg::sw128(r, c) : wg::sw64(r, c);
  }
  // B^T rows n0 .. of the tile (B(k, n) = tile[n0 + n, 16 kk + k])
  __device__ static uint64_t kmajor(uint32_t tile, int n0, int kk) {
    return wg::desc(tile + n0 * RB + kk * 32, 16, 8 * RB, SWIZZLE);
  }
  // B rows k0 .. of the tile (B(k, n) = tile[k0 + k, n]), all DH columns
  __device__ static uint64_t mnmajor(uint32_t tile, int k0) {
    return wg::desc(tile + k0 * RB, 8 * RB, 8 * RB, SWIZZLE);
  }
  // the A fragments of 16 rows from `row` of the tile, all dh
  __device__ static void load_a(uint32_t (&a)[KS][4], uint32_t tile,
                                int row, int lane) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wg::ldsm_x4(a[kk], tile + sw(row + (lane & 15), 2 * kk + (lane >> 4)));
  }
};

// a chunk's width (keys or queries) as a type: 64, or 32
template <int W>
struct Width {
  static constexpr int value = W;
};

// f(Width<W>(), c0) over the chunks of Lp keys (or queries) in order:
// 64 wide and a last one of 32 where Lp % 64 == 32, or with WIDE false
// all 32 wide.
template <bool WIDE, class F>
__device__ __forceinline__ void chunks(int Lp, F f) {
  int c0 = 0;
  if constexpr (WIDE) {
#pragma unroll 1
    for (; c0 + 64 <= Lp; c0 += 64) f(Width<64>(), c0);
  }
#pragma unroll 1
  for (; c0 < Lp; c0 += 32) f(Width<32>(), c0);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// 2^x on the MUFU (ftz; 2^-inf = 0): the softmax runs on the logits
// scaled by log2(e), one FMA and one MUFU.EX2 a value
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragment of k16 step kk from 64 x N accumulators (its n tiles 2
// kk and 2 kk + 1), rounded to bf16.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c)[N],
                                     int kk) {
  a[0] = bf16mma::pack(c[8 * kk], c[8 * kk + 1]);
  a[1] = bf16mma::pack(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = bf16mma::pack(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = bf16mma::pack(c[8 * kk + 6], c[8 * kk + 7]);
}

// Issue acc (64 x N) += A (64 x DH, registers) B^T, B^T rows n0 .. of a
// K-major tile (N / 2 accumulators a thread: N = 64 or 32).
template <int DH, int N>
__device__ __forceinline__ void issue_nt(float (&acc)[N],
                                         const uint32_t (&a)[DH / 16][4],
                                         uint32_t tile, int n0) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wg::mma_rs<0>(acc, a[kk], Tile<DH>::kmajor(tile, n0, kk));
}

// Issue acc (64 x DH) += A (64 x 16 KS2, registers) B, B rows k0 .. of an
// MN-major tile.
template <int DH, int KS2>
__device__ __forceinline__ void issue_nn(float (&acc)[DH / 2],
                                         const uint32_t (&a)[KS2][4],
                                         uint32_t tile, int k0) {
#pragma unroll
  for (int kk = 0; kk < KS2; ++kk)
    wg::mma_rs<1>(acc, a[kk], Tile<DH>::mnmajor(tile, k0 + 16 * kk));
}

// The products issued since the last fence as one group, waited for.
__device__ __forceinline__ void complete() {
  wg::commit();
  wg::wait<0>();
}

// The forward's pass over the keys of one 64-row query tile (this warp's
// 16 rows from `row` of the Q tile, whose A fragments it reloads a chunk,
// so that they take no registers between its products): o = sum_k
// bf16(2^(s_k - mx)) v_k, s the logits S scale log2(e) with the keys past
// L at -inf and mx their running max, and the row sums of 2^(s - mx),
// summed over the quad. Chunk 0 holds key 0, so mx is finite from it on.
template <int DH, bool WIDE>
struct Attend {
  float o[DH / 2];
  float mx[2], sum[2];

  __device__ __forceinline__ void run(uint32_t qt, int row, uint32_t kt,
                                      uint32_t vt, int L, int Lp,
                                      float scale2, int lane) {
    const int t = lane & 3;
    zero(o);
    mx[0] = mx[1] = -INFINITY;
    sum[0] = sum[1] = 0.f;
    chunks<WIDE>(Lp, [&](auto w, int c0) {
      constexpr int N = decltype(w)::value / 2;
      float s[N];
      {
        uint32_t qa[DH / 16][4];
        Tile<DH>::load_a(qa, qt, row, lane);
        zero(s);
        wg::fence_regs(s);
        wg::fence();
        issue_nt<DH>(s, qa, kt, c0);   // S = Q K^T
        complete();
        wg::fence_regs(s);
      }
      float cm[2] = {mx[0], mx[1]};
#pragma unroll
      for (int i = 0; i < N / 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c0 + 8 * i + 2 * t + (e & 1);
          s[4 * i + e] = key < L ? s[4 * i + e] * scale2 : -INFINITY;
          cm[e >> 1] = fmaxf(cm[e >> 1], s[4 * i + e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        cm[r] = bf16mma::quad_max(cm[r]);
        const float alpha = ex2(mx[r] - cm[r]);
        sum[r] *= alpha;
#pragma unroll
        for (int i = 0; i < DH / 8; ++i) {
          o[4 * i + 2 * r] *= alpha;
          o[4 * i + 2 * r + 1] *= alpha;
        }
        mx[r] = cm[r];
      }
#pragma unroll
      for (int i = 0; i < N / 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * i + e] = ex2(s[4 * i + e] - mx[e >> 1]);
          sum[e >> 1] += s[4 * i + e];
        }
      uint32_t pa[N / 8][4];
#pragma unroll
      for (int kk = 0; kk < N / 8; ++kk) to_a(pa[kk], s, kk);
      wg::fence_regs(o);
      wg::fence();
      issue_nn<DH>(o, pa, vt, c0);     // O += P V
      complete();
      wg::fence_regs(o);
    });
    sum[0] = bf16mma::quad_sum(sum[0]);
    sum[1] = bf16mma::quad_sum(sum[1]);
  }
};

// A warpgroup's 64 x DH accumulator (rows of fragment row h scaled by
// f[h]) through its staging tile to rows [0, rows) of dst (row stride ld
// values), 16-byte stores. Named barrier 1 + wgi guards the tile.
template <int DH>
__device__ __forceinline__ void store_tile(unsigned char* stg,
                                           const float (&acc)[DH / 2],
                                           float f0, float f1, int wgi,
                                           int wt, bf16* dst, size_t ld,
                                           int rows) {
  using T = Tile<DH>;
  const int lane = wt & 31, g = lane >> 2, t = lane & 3;
  const float f[2] = {f0, f1};
  wg::bar_sync(1 + wgi, 128);          // the last tile's stores are read
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(
          stg + T::sw(16 * (wt >> 5) + g + 8 * h, i) + 4 * t) =
          bf16mma::pack(acc[4 * i + 2 * h] * f[h],
                        acc[4 * i + 2 * h + 1] * f[h]);
  wg::bar_sync(1 + wgi, 128);
  constexpr int U = DH / 8;            // 16-byte units a row
#pragma unroll
  for (int u = wt; u < 64 * U; u += 128) {
    const int r = u / U, c = u % U;
    if (r < rows)
      *reinterpret_cast<uint4*>(dst + r * ld + 8 * c) =
          *reinterpret_cast<const uint4*>(stg + T::sw(r, c));
  }
}

// The ring of head slots: head j of this block (pair blockIdx.x + j
// gridDim.x) in slot j % stages, its full barrier's phase j / stages.
// Thread 0 alone loads; `issued` is its count of heads issued.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int stages, nh, issued;

  // Thread 0: issue the loads of heads `issued` .. whose slots are free,
  // waiting for a slot only while a head < need is not issued.
  template <typename Load>
  __device__ __forceinline__ void pump(int need, Load load) {
    while (issued < nh) {
      if (issued >= stages) {
        const int s = issued % stages;
        const uint32_t parity = (issued / stages - 1) & 1;
        if (issued < need)
          wg::mbar_wait(&empty[s], parity);
        else if (!wg::mbar_try_wait(&empty[s], parity))
          break;
      }
      load(issued);
      ++issued;
    }
  }
};

// log2(e): the logits' scale for the softmax on ex2
constexpr float LOG2E = 1.4426950408889634f;

// The forward: out rows of each (batch row, head) pair of this block.
// map_qkv: the slab as (3C, L, B) in boxes of DH x Lp x 1.
template <int DH>
__global__ void __launch_bounds__(128 * FWD_WARPGROUPS, 1)
    slab_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_qkv,
                          bf16* __restrict__ out, int BH, int L, int H,
                          int Lp, int stages, float scale) {
  using T = Tile<DH>;
  extern __shared__ unsigned char fwd_raw[];
  unsigned char* smem = align1k(fwd_raw);
  const int region = Lp * T::RB, slot = 3 * region;
  unsigned char* staging = smem + stages * slot;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      staging + FWD_WARPGROUPS * 64 * T::RB);
  const int tid = threadIdx.x, wgi = tid >> 7, wt = tid & 127;
  const int lane = tid & 31;
  const int C = H * DH, tiles = (L + 63) / 64;
  const int nh = BH > (int)blockIdx.x
                     ? (BH - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                     : 0;
  Ring ring{bars, bars + stages, stages, nh, 0};
  auto load = [&](int j) {             // thread 0: head j's Q, K, V
    const int s = j % stages, bh = (int)blockIdx.x + j * (int)gridDim.x;
    const int b = bh / H, h = bh % H;
    unsigned char* st = smem + s * slot;
    wg::mbar_expect_tx(&ring.full[s], slot);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      wg::tma_load_3d(st + p * region, &map_qkv, &ring.full[s],
                      p * C + h * DH, 0, b);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(&ring.full[s], 1);
      wg::mbar_init(&ring.empty[s], tiles * 128);
    }
    wg::mbar_init_fence();
    ring.pump(1, load);
  }
  __syncthreads();

  unsigned char* stg = staging + wgi * 64 * T::RB;
  Attend<DH, FWD_WIDE> at;
#pragma unroll 1
  for (int it = wgi; it < nh * tiles; it += FWD_WARPGROUPS) {
    const int j = it / tiles, m0 = it % tiles * 64, s = j % stages;
    if (tid == 0) ring.pump(j + 1, load);
    wg::mbar_wait(&ring.full[s], (j / stages) & 1);
    const uint32_t qt = wg::saddr(smem + s * slot);
    at.run(qt, m0 + 16 * (wt >> 5), qt + region, qt + 2 * region, L, Lp,
           scale * LOG2E, lane);
    wg::fence_proxy_async();           // before the slot's next fill
    wg::mbar_arrive(&ring.empty[s]);
    const int bh = (int)blockIdx.x + j * (int)gridDim.x;
    const int b = bh / H, h = bh % H;
    store_tile<DH>(stg, at.o, 1.f / at.sum[0], 1.f / at.sum[1], wgi, wt,
                   out + ((size_t)b * L + m0) * C + h * DH, C,
                   min(64, L - m0));
  }
  if (tid == 0) ring.pump(nh, load);   // heads only other groups need
}

// The backward: dQKV rows of each (batch row, head) pair of this block.
// map_qkv as the forward's, map_do: dO as (C, L, B) in boxes of DH x Lp
// x 1. A slot: Q, K, V, dO tiles, then (after the ring and the staging
// tiles) the slot's lse and delta rows (lse in the log2 domain of the
// forward's pass).
template <int DH>
__global__ void __launch_bounds__(128 * BWD_WARPGROUPS, 1)
    slab_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_qkv,
                          const __grid_constant__ CUtensorMap map_do,
                          bf16* __restrict__ dqkv, int BH, int L, int H,
                          int Lp, int stages, float scale) {
  using T = Tile<DH>;
  extern __shared__ unsigned char bwd_raw[];
  unsigned char* smem = align1k(bwd_raw);
  const int region = Lp * T::RB, slot = 4 * region;
  unsigned char* staging = smem + stages * slot;
  float* rows =
      reinterpret_cast<float*>(staging + BWD_WARPGROUPS * 64 * T::RB);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows + 2 * stages * Lp);
  uint64_t* ready = bars + 2 * stages;
  const int tid = threadIdx.x, wgi = tid >> 7, wt = tid & 127;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int C = H * DH, C3 = 3 * C, tiles = (L + 63) / 64;
  const int items = 2 * tiles;         // a head's query, then key tiles
  const float scale2 = scale * LOG2E;
  const int nh = BH > (int)blockIdx.x
                     ? (BH - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                     : 0;
  Ring ring{bars, bars + stages, stages, nh, 0};
  auto load = [&](int j) {             // thread 0: head j's Q, K, V, dO
    const int s = j % stages, bh = (int)blockIdx.x + j * (int)gridDim.x;
    const int b = bh / H, h = bh % H;
    unsigned char* st = smem + s * slot;
    wg::mbar_expect_tx(&ring.full[s], slot);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      wg::tma_load_3d(st + p * region, &map_qkv, &ring.full[s],
                      p * C + h * DH, 0, b);
    wg::tma_load_3d(st + 3 * region, &map_do, &ring.full[s], h * DH, 0, b);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(&ring.full[s], 1);
      wg::mbar_init(&ring.empty[s], items * 128);
      wg::mbar_init(&ready[s], tiles * 128);
    }
    wg::mbar_init_fence();
    ring.pump(1, load);
  }
  __syncthreads();

  unsigned char* stg = staging + wgi * 64 * T::RB;
  const int w16 = 16 * (wt >> 5);      // the warp's first row of a tile
#pragma unroll 1
  for (int it = wgi; it < nh * items; it += BWD_WARPGROUPS) {
    const int j = it / items, k = it % items, s = j % stages;
    const uint32_t phase = (j / stages) & 1;
    if (tid == 0) ring.pump(j + 1, load);
    wg::mbar_wait(&ring.full[s], phase);
    const uint32_t qt = wg::saddr(smem + s * slot), kt = qt + region;
    const uint32_t vt = qt + 2 * region, ot = qt + 3 * region;
    float* lse = rows + 2 * s * Lp;
    float* del = lse + Lp;
    const int bh = (int)blockIdx.x + j * (int)gridDim.x;
    const int b = bh / H, h = bh % H;
    bf16* base = dqkv + (size_t)b * L * C3 + h * DH;
    if (k < tiles) {
      // phase i: query rows m0 .. m0 + 63
      const int m0 = 64 * k, row = m0 + w16;
      float ls[2], dl[2];
      {
        Attend<DH, DQ_WIDE> at;
        at.run(qt, row, kt, vt, L, Lp, scale2, lane);
        // delta = rowsum(dO o O) with O = o / sum; dO's fragment of k
        // step kk holds n tiles 2 kk (registers 0, 1) and 2 kk + 1 (2, 3)
        uint32_t oa[T::KS][4];
        T::load_a(oa, ot, row, lane);
        dl[0] = dl[1] = 0.f;
#pragma unroll
        for (int kk = 0; kk < T::KS; ++kk)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int i = 2 * kk + (e >> 2), r = (e >> 1) & 1;
            const uint32_t w = oa[kk][2 * (e >> 2) + r];
            const float d = __uint_as_float(e & 1 ? w & 0xffff0000u
                                                  : w << 16);
            dl[r] = fmaf(at.o[4 * i + (e & 3)], d, dl[r]);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dl[r] = bf16mma::quad_sum(dl[r]) / at.sum[r];
          ls[r] = at.mx[r] + log2f(at.sum[r]);
        }
      }
      if (t == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = row + g + 8 * r;
          if (q < Lp) {
            lse[q] = q < L ? ls[r] : INFINITY;
            del[q] = q < L ? dl[r] : 0.f;
          }
        }
      }
      wg::mbar_arrive(&ready[s]);
      // dQ = sum over key chunks of dS K, dS = P o (dP - delta)
      float dq[T::NA];
      zero(dq);
      chunks<DQ_WIDE>(Lp, [&](auto w, int c0) {
        constexpr int N = decltype(w)::value / 2;
        float sc[N], dp[N];
        {
          uint32_t qa[T::KS][4], oa[T::KS][4];
          T::load_a(qa, qt, row, lane);
          T::load_a(oa, ot, row, lane);
          zero(sc);
          zero(dp);
          wg::fence_regs(sc);
          wg::fence_regs(dp);
          wg::fence();
          issue_nt<DH>(sc, qa, kt, c0);  // S = Q K^T
          issue_nt<DH>(dp, oa, vt, c0);  // dP = dO V^T
          complete();
          wg::fence_regs(sc);
          wg::fence_regs(dp);
        }
#pragma unroll
        for (int i = 0; i < N / 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = c0 + 8 * i + 2 * t + (e & 1), r = e >> 1;
            const float p =
                key < L ? ex2(fmaf(sc[4 * i + e], scale2, -ls[r])) : 0.f;
            sc[4 * i + e] = p * (dp[4 * i + e] - dl[r]);
          }
        uint32_t da[N / 8][4];
#pragma unroll
        for (int kk = 0; kk < N / 8; ++kk) to_a(da[kk], sc, kk);
        wg::fence_regs(dq);
        wg::fence();
        issue_nn<DH>(dq, da, kt, c0);  // dQ += dS K
        complete();
        wg::fence_regs(dq);
      });
      wg::fence_proxy_async();         // before the slot's next fill
      wg::mbar_arrive(&ring.empty[s]);
      store_tile<DH>(stg, dq, scale, scale, wgi, wt,
                     base + (size_t)m0 * C3, C3, min(64, L - m0));
    } else {
      // phase ii: key rows n0 .. n0 + 63, once the head's lse and delta
      // rows are in
      const int n0 = 64 * (k - tiles), row = n0 + w16;
      wg::mbar_wait(&ready[s], phase);
      float dk[T::NA], dv[T::NA];
      zero(dk);
      zero(dv);
      chunks<DKV_WIDE>(Lp, [&](auto w, int c0) {
        constexpr int N = decltype(w)::value / 2;
        float st[N], dpt[N];
        {
          uint32_t ka[T::KS][4], va[T::KS][4];
          T::load_a(ka, kt, row, lane);
          T::load_a(va, vt, row, lane);
          zero(st);
          zero(dpt);
          wg::fence_regs(st);
          wg::fence_regs(dpt);
          wg::fence();
          issue_nt<DH>(st, ka, qt, c0);   // S^T = K Q^T
          issue_nt<DH>(dpt, va, ot, c0);  // dP^T = V dO^T
          complete();
          wg::fence_regs(st);
          wg::fence_regs(dpt);
        }
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
          const int q = c0 + 8 * i + 2 * t;
          const float2 lq = *reinterpret_cast<const float2*>(lse + q);
          const float2 dlq = *reinterpret_cast<const float2*>(del + q);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                ex2(fmaf(st[4 * i + e], scale2, -(e & 1 ? lq.y : lq.x)));
            st[4 * i + e] = p;
            dpt[4 * i + e] = p * (dpt[4 * i + e] - (e & 1 ? dlq.y : dlq.x));
          }
        }
        uint32_t pa[N / 8][4], da[N / 8][4];
#pragma unroll
        for (int kk = 0; kk < N / 8; ++kk) {
          to_a(pa[kk], st, kk);
          to_a(da[kk], dpt, kk);
        }
        wg::fence_regs(dv);
        wg::fence_regs(dk);
        wg::fence();
        issue_nn<DH>(dv, pa, ot, c0);  // dV += P^T dO
        issue_nn<DH>(dk, da, qt, c0);  // dK += dS^T Q
        complete();
        wg::fence_regs(dv);
        wg::fence_regs(dk);
      });
      wg::fence_proxy_async();         // before the slot's next fill
      wg::mbar_arrive(&ring.empty[s]);
      const int rows_out = min(64, L - n0);
      store_tile<DH>(stg, dk, scale, scale, wgi, wt,
                     base + (size_t)n0 * C3 + C, C3, rows_out);
      store_tile<DH>(stg, dv, 1.f, 1.f, wgi, wt,
                     base + (size_t)n0 * C3 + 2 * C, C3, rows_out);
    }
  }
  if (tid == 0) ring.pump(nh, load);   // heads only other groups need
}

bool shape_ok(int B, int L, int H, int DH) {
  return B >= 1 && H >= 1 && L >= 1 && L <= L_MAX && (DH == 32 || DH == 64);
}

// A tensor map over a (B, L, width) bf16 tensor as (width, L, B), boxes
// of DH x Lp x 1, swizzled to DH's row.
template <int DH>
cudaError_t head_map(CUtensorMap* map, const void* base, int width, int L,
                     int B, int Lp) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)width * 2 * L};
  const cuuint32_t box[3] = {DH, (cuuint32_t)Lp, 1};
  return wg::bf16_map(map, base, 3, dims, strides, box,
                      DH == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaError_t grid_of(int BH, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = min(BH, sms);
  return err;
}

template <int DH>
cudaError_t fwd(const bf16* qkv, bf16* out, int B, int L, int H, int stages,
                cudaStream_t stream) {
  const int Lp = lp_of(L);
  const size_t smem = fwd_smem(Lp, DH, stages);
  if (stages < 1 || smem > SMEM_MAX) return cudaErrorInvalidValue;
  CUtensorMap map;
  int grid = 0;
  cudaError_t err;
  if ((err = head_map<DH>(&map, qkv, 3 * H * DH, L, B, Lp)) != cudaSuccess ||
      (err = set_smem(slab_fwd_wgmma_kernel<DH>, smem)) != cudaSuccess ||
      (err = grid_of(B * H, &grid)) != cudaSuccess)
    return err;
  slab_fwd_wgmma_kernel<DH><<<grid, 128 * FWD_WARPGROUPS, smem, stream>>>(
      map, out, B * H, L, H, Lp, stages, 1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <int DH>
cudaError_t bwd(const bf16* qkv, const bf16* dout, bf16* dqkv, int B, int L,
                int H, int stages, cudaStream_t stream) {
  const int Lp = lp_of(L);
  const size_t smem = bwd_smem(Lp, DH, stages);
  if (stages < 1 || smem > SMEM_MAX) return cudaErrorInvalidValue;
  CUtensorMap map_qkv, map_do;
  int grid = 0;
  cudaError_t err;
  if ((err = head_map<DH>(&map_qkv, qkv, 3 * H * DH, L, B, Lp)) !=
          cudaSuccess ||
      (err = head_map<DH>(&map_do, dout, H * DH, L, B, Lp)) != cudaSuccess ||
      (err = set_smem(slab_bwd_wgmma_kernel<DH>, smem)) != cudaSuccess ||
      (err = grid_of(B * H, &grid)) != cudaSuccess)
    return err;
  slab_bwd_wgmma_kernel<DH><<<grid, 128 * BWD_WARPGROUPS, smem, stream>>>(
      map_qkv, map_do, dqkv, B * H, L, H, Lp, stages,
      1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv (B, L, 3 H DH) -> out (B, L, H DH), both bf16; a ring of `stages`
// head slots.
int ertdx_slab_fwd_bf16(const void* qkv, void* out, int B, int L, int H,
                        int DH, int stages, void* stream) {
  if (!shape_ok(B, L, H, DH)) return (int)cudaErrorInvalidValue;
  // TMA reads from a 16-byte boundary; the output's 16-byte stores
  if (((uintptr_t)qkv | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(DH == 32 ? fwd<32>(q, o, B, L, H, stages, s)
                        : fwd<64>(q, o, B, L, H, stages, s));
}

// qkv (B, L, 3 H DH), dout (B, L, H DH) -> dqkv (B, L, 3 H DH), all bf16,
// in one launch; a ring of `stages` head slots.
int ertdx_slab_bwd_bf16(const void* qkv, const void* dout, void* dqkv,
                        int B, int L, int H, int DH, int stages,
                        void* stream) {
  if (!shape_ok(B, L, H, DH)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)qkv | (uintptr_t)dout | (uintptr_t)dqkv) & 15)
    return (int)cudaErrorMisalignedAddress;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* o = static_cast<const bf16*>(dout);
  bf16* d = static_cast<bf16*>(dqkv);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(DH == 32 ? bwd<32>(q, o, d, B, L, H, stages, s)
                        : bwd<64>(q, o, d, B, L, H, stages, s));
}

}  // extern "C"
