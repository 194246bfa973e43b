// Packed-head slab attention in JAX's one-pass mode, forward and backward,
// on Hopper's warpgroup MMA and tensor memory accelerator (sm_90a; every
// product one bf16 wgmma of wgmma.cuh, float32 accumulation), on a
// float32 or a bf16 slab: one templated body, T = float or bf16.
//
// Replaces the TPU kernels of ertdx/ops/slab_attn.py at their DEFAULT
// precision (`_dot` :85-92), which on the TPU is one bf16 pass a product
// with float32 accumulation: the CondUNet's encoder attention in either
// dtype (a float32 model calls it without `accurate`).
//   * slab_fwd_wgmma_kernel   <- _slab_fwd_kernel (:147-168)
//   * slab_bwd_wgmma_kernel   <- _slab_bwd_kernel (:184-222), one launch
//     that emits the whole dQKV slab from one read of each input, as the
//     TPU kernel does
// The layout is slab_attn.cu's: the fused QKV slab (B, L, 3C) in, q at
// lanes [0, C), k at [C, 2C), v at [2C, 3C), head h at [h dh, (h+1) dh)
// of each third; the output (B, L, C) and dQ | dK | dV (B, L, 3C) out, in
// the slab's dtype. The function is JAX's kernels' at DEFAULT, each
// operand rounded to bf16 (to nearest even) where their `_dot` rounds it:
//   * the forward: S = bf16(q scale) bf16(k)^T, scale = float32(1 /
//     sqrt(dh)), summed in float32; the softmax in float32 over the L
//     keys, normalised (`_block_softmax`, :143); O = bf16(P) bf16(v),
//     summed in float32;
//   * the backward: S and P as the forward; dV = bf16(P)^T bf16(dO), dP =
//     bf16(dO) bf16(v)^T, delta = rowsum(dP o P) and dS = P o (dP -
//     delta) in float32; dQ = (bf16(dS) bf16(k)) scale and dK =
//     (bf16(dS)^T bf16(q)) scale with q UNSCALED (:218-220).
// The softmax runs as 2^x of the logits scaled by log2(e) (one FMA and one
// MUFU.EX2 a value, ex2.approx.ftz: the library's expf took a fifth of
// the backward's time). It is normalised before P is rounded, so a query
// tile takes two passes over the keys: the first for the row max and sum
// (the log-sum-exp, base 2), the second for P = 2^(s - lse) and P V. Its
// logits do not stay in registers between the passes: a 64 x 160 tile is
// 80 registers a thread, a 64 x 256 one 128, and the kernels run at 168.
// delta comes from the backward's own first pass over the keys, which
// takes S and dP and sums 2^(s - max) dP beside 2^(s - max) with the same
// rescaling as the sum (an online softmax of one more row), so delta is
// rowsum(P o dP) from the products JAX multiplies, not rowsum(dO o O).
// At dh = 64 the scale is 1/8, a power of two: bf16(q scale) is bf16(q)
// scale exactly, so the Q tile holds bf16(q) and S is scaled after its
// product. At dh = 32 it is not: the S operand is bf16(q scale) itself,
// and the backward carries it in a tile of its own beside bf16(q).
//
// What bounds it on an H100: bytes, and the padded products close
// behind. At the encoder's training shape (B=256, L=147, C=256, H=4,
// dh=64) the forward reads the slab and writes the output, 77 MB in bf16
// (0.023 ms at 3.35 TB/s) or 154 MB in float32 (0.046 ms), against 4 B H
// L^2 dh = 5.7 GFLOP (0.0057 ms at 989 TFLOP/s; 64-row query tiles,
// 32-key padding and the second pass make it 12); the backward reads the
// slab and dO and writes dQKV, 135 or 270 MB (0.040 or 0.081 ms), for 10
// B H L^2 dh = 14.2 GFLOP (0.014 ms; 9 padded products here, 36).
//
// The design:
//   * Persistent: one block an SM walks the (batch row, head) pairs
//     blockIdx.x, + gridDim.x, ... with three warpgroups (384 threads, up
//     to 168 registers a thread; no producer warp, as gn_conv.cu's wgmma
//     GEMMs). Three beat two (PERF.md §6, PR 18): a warpgroup waits for
//     each group of its products, and more warpgroups hide more of that.
//     A head's operands land as bf16 in a ring of `stages` head slots,
//     rows of 128 bytes with 128-byte swizzle (dh = 64) or 64 with 64-byte
//     swizzle (dh = 32), Lp = L rounded up to 32 rows, the rows past L
//     zeros; one full barrier a slot.
//   * A bf16 slab lands by TMA (3-D tensor maps over the slab as (3C, L,
//     B) and dO as (C, L, B), a box of dh x Lp rows). A float32 slot (3
//     Lp rows of 256 bytes a tile in the forward) does not fit the ring
//     twice, so a float32 slab lands by 16-byte loads, rounded to bf16 in
//     registers and written in the swizzled layout TMA would write, then
//     `fence.proxy.async` before the slot's full barrier, so that the
//     wgmmas (the async proxy) see the generic-proxy writes. The
//     warpgroups fill the ring themselves: the heads up to `stages` - 1
//     ahead (at least one) are filled before the loop, and a warpgroup
//     that finishes its last item of head j fills its part of head j +
//     ahead (the parts split the head's rows among the warpgroups that
//     have items in head j), once the slot's previous head is done.
//   * Work items: the forward's items are the 64-row query tiles of each
//     head; the backward's are a head's query tiles (phase i) and then
//     its 64-row key tiles (phase ii). The warpgroups take the block's
//     items in turns, across heads. A slot's empty barrier counts its
//     items' threads; with TMA, thread 0 refills a slot once its head is
//     done, as early as its own work lets it look (`pump`): it issues
//     every load whose slot is free without waiting, and waits only for
//     the head its warpgroup needs.
//   * A product: A from registers (Q, dO, K, V rows by ldmatrix from the
//     swizzled tile, again for each chunk, so that they hold no registers
//     between products; at dh = 32 a bf16 q scaled and rounded there; P
//     and dS from the accumulators, rounded to bf16), B by descriptor:
//     K-major (K, V, Q, dO rows as B^T: S, dP, S^T, dP^T) or MN-major (V,
//     K, dO, Q rows as B: O, dQ, dV, dK). wgmma m64n64k16 over chunks of
//     64 keys or queries, m64n32k16 over chunks of 32; 64 x dh products
//     with N = dh. The forward walks its keys 64 at a time (a last 32
//     where Lp % 64 == 32); the backward 32 at a time, which keeps it
//     within 168 registers.
//   * Forward (a query tile): the first pass gives lse, the second P and
//     O = P V on the accumulator; the output through a swizzled staging
//     tile in shared memory, 16-byte stores (bf16), or straight from the
//     accumulators, a quad's 32 bytes a row (float32).
//   * Backward phase i (a query tile): the first pass gives lse and
//     delta, which go to the slot's shared lse / delta rows (rows past L:
//     +inf / 0, so that P is 0 there in phase ii), and (bf16 at dh = 32)
//     the tile's rows of bf16(q scale); a ready barrier counts them; then
//     per key chunk S and dP again, P from lse, dS, and dQ += dS K.
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
#include <string.h>

#include <type_traits>

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
// log2(e): the logits' scale for the softmax on ex2
constexpr float LOG2E = 1.4426950408889634f;

int lp_of(int L) { return (L + 31) / 32 * 32; }

// The backward's tiles a slot: Q, K, V, dO and, at dh = 32, bf16(q scale)
__host__ __device__ constexpr int bwd_tiles(int DH) {
  return DH == 32 ? 5 : 4;
}

// the forward's and the backward's dynamic shared memory: the ring of
// head slots (Q, K, V; Q, K, V, dO [, Q scaled] and the lse / delta rows),
// a 64-row staging tile a warpgroup, the barriers, and 1 KB to align the
// ring
size_t fwd_smem(int Lp, int DH, int stages) {
  return 1024 + (size_t)stages * 3 * Lp * DH * 2 +
         FWD_WARPGROUPS * 64 * DH * 2 + 16 * stages;
}

size_t bwd_smem(int Lp, int DH, int stages) {
  return 1024 + (size_t)stages * (bwd_tiles(DH) * Lp * DH * 2 + 2 * Lp * 4) +
         BWD_WARPGROUPS * 64 * DH * 2 + 24 * stages;
}

__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return p + ((1024u - (wg::saddr(p) & 1023u)) & 1023u);
}

// a pair of bf16 values (the low one first) times s, rounded to bf16
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float s) {
  return bf16mma::pack(__uint_as_float(w << 16) * s,
                       __uint_as_float(w & 0xffff0000u) * s);
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
  // the same, each value times s and rounded to bf16
  __device__ static void load_a_scaled(uint32_t (&a)[KS][4], uint32_t tile,
                                       int row, int lane, float s) {
    load_a(a, tile, row, lane);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[kk][i] = scale_pair(a[kk][i], s);
  }
};

// The S operand of a query tile, bf16(q scale) at dh = 32: a bf16 slab's q
// tile scaled in registers (SCALE), or a tile that holds it already (a
// float32 slab's fill rounds q scale itself); at dh = 64 the q tile as it
// is, S scaled after the product.
template <int DH, bool SCALE>
__device__ __forceinline__ void load_q(uint32_t (&a)[DH / 16][4],
                                       uint32_t tile, int row, int lane,
                                       float scale) {
  if constexpr (SCALE)
    Tile<DH>::load_a_scaled(a, tile, row, lane, scale);
  else
    Tile<DH>::load_a(a, tile, row, lane);
}

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

// S (64 x 2N, this warp's 16 rows from `row`) = Q K^T over keys c0 ..,
// the Q fragments loaded (and at dh = 32 from a bf16 q, scaled) for this
// chunk alone.
template <int DH, bool SCALE, int N>
__device__ __forceinline__ void logits(float (&s)[N], uint32_t qt, int row,
                                       uint32_t kt, int c0, int lane,
                                       float scale) {
  uint32_t qa[DH / 16][4];
  load_q<DH, SCALE>(qa, qt, row, lane, scale);
  zero(s);
  wg::fence_regs(s);
  wg::fence();
  issue_nt<DH>(s, qa, kt, c0);
  complete();
  wg::fence_regs(s);
}

// S and dP = dO V^T over keys c0 .., as one group of products.
template <int DH, bool SCALE, int N>
__device__ __forceinline__ void logits_dp(float (&sc)[N], float (&dp)[N],
                                          uint32_t qt, int row, uint32_t kt,
                                          uint32_t vt, uint32_t ot, int c0,
                                          int lane, float scale) {
  uint32_t qa[DH / 16][4], oa[DH / 16][4];
  load_q<DH, SCALE>(qa, qt, row, lane, scale);
  Tile<DH>::load_a(oa, ot, row, lane);
  zero(sc);
  zero(dp);
  wg::fence_regs(sc);
  wg::fence_regs(dp);
  wg::fence();
  issue_nt<DH>(sc, qa, kt, c0);        // S = Q K^T
  issue_nt<DH>(dp, oa, vt, c0);        // dP = dO V^T
  complete();
  wg::fence_regs(sc);
  wg::fence_regs(dp);
}

// A query tile's log-sum-exp (base 2) of the logits S f over the L keys,
// two rows a thread, and with DP also delta = rowsum(P o dP) of the
// normalised P: the online softmax's max and sum (and the sum of 2^(s -
// max) dP beside it), each rescaled as the max grows, the max reduced
// over the quad each chunk, the sums at the end. Chunk 0 holds key 0, so
// the max is finite from it on.
template <int DH, bool SCALE, bool WIDE, bool DP>
struct RowStats {
  float lse[2], delta[2];

  __device__ __forceinline__ void run(uint32_t qt, int row, uint32_t kt,
                                      uint32_t vt, uint32_t ot, int L,
                                      int Lp, float f, float scale,
                                      int lane) {
    const int t = lane & 3;
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
    float dacc[2] = {0.f, 0.f};
    chunks<WIDE>(Lp, [&](auto w, int c0) {
      constexpr int N = decltype(w)::value / 2;
      float s[N];
      [[maybe_unused]] float dp[DP ? N : 1];
      if constexpr (DP)
        logits_dp<DH, SCALE>(s, dp, qt, row, kt, vt, ot, c0, lane, scale);
      else
        logits<DH, SCALE>(s, qt, row, kt, c0, lane, scale);
      float cm[2] = {mx[0], mx[1]};
#pragma unroll
      for (int i = 0; i < N / 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c0 + 8 * i + 2 * t + (e & 1);
          s[4 * i + e] = key < L ? s[4 * i + e] * f : -INFINITY;
          cm[e >> 1] = fmaxf(cm[e >> 1], s[4 * i + e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        cm[r] = bf16mma::quad_max(cm[r]);
        const float alpha = ex2(mx[r] - cm[r]);
        sum[r] *= alpha;
        if constexpr (DP) dacc[r] *= alpha;
        mx[r] = cm[r];
      }
#pragma unroll
      for (int i = 0; i < N / 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[4 * i + e] - mx[e >> 1]);
          sum[e >> 1] += p;
          if constexpr (DP) dacc[e >> 1] = fmaf(p, dp[4 * i + e],
                                                dacc[e >> 1]);
        }
    });
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] = bf16mma::quad_sum(sum[r]);
      lse[r] = mx[r] + log2f(sum[r]);
      if constexpr (DP) delta[r] = bf16mma::quad_sum(dacc[r]) / sum[r];
    }
  }
};

// The forward's second pass over the keys of a query tile: o = sum_k
// bf16(P_k) v_k with P = 2^(S f - lse), normalised, 0 past L.
template <int DH, bool SCALE, bool WIDE>
__device__ __forceinline__ void attend(float (&o)[DH / 2], uint32_t qt,
                                       int row, uint32_t kt, uint32_t vt,
                                       int L, int Lp, float f, float scale,
                                       const float (&lse)[2], int lane) {
  const int t = lane & 3;
  zero(o);
  chunks<WIDE>(Lp, [&](auto w, int c0) {
    constexpr int N = decltype(w)::value / 2;
    float s[N];
    logits<DH, SCALE>(s, qt, row, kt, c0, lane, scale);
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + 8 * i + 2 * t + (e & 1);
        s[4 * i + e] =
            key < L ? ex2(fmaf(s[4 * i + e], f, -lse[e >> 1])) : 0.f;
      }
    uint32_t pa[N / 8][4];
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) to_a(pa[kk], s, kk);
    wg::fence_regs(o);
    wg::fence();
    issue_nn<DH>(o, pa, vt, c0);       // O += P V
    complete();
    wg::fence_regs(o);
  });
}

// A warpgroup's 64 x DH accumulator, times f, to rows [0, rows) of dst
// (row stride ld values): bf16 through its staging tile, 16-byte stores
// (named barrier 1 + wgi guards the tile); float32 straight from the
// accumulators, a quad's 32 bytes a row.
template <typename T, int DH>
__device__ __forceinline__ void store_tile(unsigned char* stg,
                                           const float (&acc)[DH / 2],
                                           float f, int wgi, int wt, T* dst,
                                           size_t ld, int rows) {
  using TL = Tile<DH>;
  const int lane = wt & 31, g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * (wt >> 5) + g + 8 * h;
      if (r < rows)
#pragma unroll
        for (int i = 0; i < DH / 8; ++i)
          *reinterpret_cast<float2*>(dst + r * ld + 8 * i + 2 * t) =
              make_float2(acc[4 * i + 2 * h] * f, acc[4 * i + 2 * h + 1] * f);
    }
  } else {
    wg::bar_sync(1 + wgi, 128);        // the last tile's stores are read
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(
            stg + TL::sw(16 * (wt >> 5) + g + 8 * h, i) + 4 * t) =
            bf16mma::pack(acc[4 * i + 2 * h] * f,
                          acc[4 * i + 2 * h + 1] * f);
    wg::bar_sync(1 + wgi, 128);
    constexpr int U = DH / 8;          // 16-byte units a row
#pragma unroll
    for (int u = wt; u < 64 * U; u += 128) {
      const int r = u / U, c = u % U;
      if (r < rows)
        *reinterpret_cast<uint4*>(dst + r * ld + 8 * c) =
            *reinterpret_cast<const uint4*>(stg + TL::sw(r, c));
    }
  }
}

// The ring of head slots: head j of this block (pair blockIdx.x + j
// gridDim.x) in slot j % stages, its full barrier's phase j / stages.
// With TMA thread 0 alone loads; `issued` is its count of heads issued.
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

  // A warpgroup before it fills head n's slot: wait until the slot's
  // previous head is done.
  __device__ __forceinline__ void wait_free(int n) const {
    if (n >= stages) wg::mbar_wait(&empty[n % stages], (n / stages - 1) & 1);
  }
};

// One tile of a float32 slot's fill: rows [0, Lp) of dh columns from
// `base` (row stride ld values, batch row b of L rows), times `mult`,
// rounded to bf16 into the swizzled tile; rows past L zeros.
struct Src {
  const float* base;
  int ld;
  float mult;
};

// A warpgroup's part `part` of `parts` of a float32 head's NT tiles: the
// 16-byte bf16 chunks (8 values) of all NT tiles in order, cut into
// `parts` even ranges; each thread loads up to 4 chunks' 32 bytes a round
// before it rounds and writes them.
template <int DH, int NT>
__device__ __forceinline__ void fill_part(unsigned char* slot, int region,
                                          const Src (&src)[NT], int b,
                                          int L, int Lp, int part, int parts,
                                          int wt) {
  constexpr int U = DH / 8, ROUND = 4;
  const int per = Lp * U, total = NT * per;
  const int u0 = total * part / parts, u1 = total * (part + 1) / parts;
#pragma unroll
  for (int tl = 0; tl < NT; ++tl) {
    const int lo = max(u0, tl * per) - tl * per;
    const int hi = min(u1, (tl + 1) * per) - tl * per;
    unsigned char* tile = slot + tl * region;
#pragma unroll 1
    for (int u = lo + wt; u < hi; u += 128 * ROUND) {
      float4 x[ROUND][2];
#pragma unroll
      for (int i = 0; i < ROUND; ++i) {
        const int v = u + 128 * i, row = v / U, c = v % U;
        x[i][0] = x[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (v < hi && row < L) {
          const float4* p = reinterpret_cast<const float4*>(
              src[tl].base + ((size_t)b * L + row) * src[tl].ld + 8 * c);
          x[i][0] = __ldg(p);
          x[i][1] = __ldg(p + 1);
        }
      }
      const float m = src[tl].mult;
#pragma unroll
      for (int i = 0; i < ROUND; ++i) {
        const int v = u + 128 * i;
        if (v < hi)
          *reinterpret_cast<uint4*>(tile + Tile<DH>::sw(v / U, v % U)) =
              make_uint4(bf16mma::pack(x[i][0].x * m, x[i][0].y * m),
                         bf16mma::pack(x[i][0].z * m, x[i][0].w * m),
                         bf16mma::pack(x[i][1].x * m, x[i][1].y * m),
                         bf16mma::pack(x[i][1].z * m, x[i][1].w * m));
      }
    }
  }
  wg::fence_proxy_async();             // the wgmmas read what was written
}

// The float32 fill's schedule: the heads `ahead` of the one a warpgroup
// finishes, and the parts a head splits into (the warpgroups that have an
// item of it); whether item `it` (head j, item k of `items`) is its
// warpgroup's last of head j, and which part that warpgroup fills.
struct FillPlan {
  int ahead, parts, items, nwg;

  __device__ FillPlan(int stages, int items_, int nwg_)
      : ahead(stages > 1 ? stages - 1 : 1),
        parts(items_ < nwg_ ? items_ : nwg_),
        items(items_),
        nwg(nwg_) {}
  __device__ bool last(int it, int j) const {
    return it + nwg >= (j + 1) * items;
  }
  __device__ int part(int it) const { return it % items % nwg; }
};

// The forward: out rows of each (batch row, head) pair of this block.
// map_qkv (a bf16 slab): the slab as (3C, L, B) in boxes of DH x Lp x 1;
// qkv (a float32 slab): the slab itself.
template <typename T, int DH>
__global__ void __launch_bounds__(128 * FWD_WARPGROUPS, 1)
    slab_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_qkv,
                          const T* __restrict__ qkv, T* __restrict__ out,
                          int BH, int L, int H, int Lp, int stages,
                          float scale) {
  using TL = Tile<DH>;
  constexpr bool TMA = std::is_same<T, bf16>::value;
  // at dh = 32 a bf16 q is scaled in registers; a float32 fill rounds
  // q scale into the Q tile itself
  constexpr bool SCALE = TMA && DH == 32;
  extern __shared__ unsigned char fwd_raw[];
  unsigned char* smem = align1k(fwd_raw);
  const int region = Lp * TL::RB, slot = 3 * region;
  unsigned char* staging = smem + stages * slot;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      staging + FWD_WARPGROUPS * 64 * TL::RB);
  const int tid = threadIdx.x, wgi = tid >> 7, wt = tid & 127;
  const int lane = tid & 31;
  const int C = H * DH, tiles = (L + 63) / 64;
  const float f = DH == 32 ? LOG2E : scale * LOG2E;
  const int nh = BH > (int)blockIdx.x
                     ? (BH - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                     : 0;
  Ring ring{bars, bars + stages, stages, nh, 0};
  const FillPlan plan(stages, tiles, FWD_WARPGROUPS);
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
  auto fill = [&](int n, int part) {   // a warpgroup: its part of head n
    const int bh = (int)blockIdx.x + n * (int)gridDim.x;
    const int b = bh / H, h = bh % H;
    const float* x = reinterpret_cast<const float*>(qkv) + h * DH;
    const Src src[3] = {{x, 3 * C, DH == 32 ? scale : 1.f},
                        {x + C, 3 * C, 1.f},
                        {x + 2 * C, 3 * C, 1.f}};
    fill_part<DH, 3>(smem + (n % stages) * slot, region, src, b, L, Lp,
                     part, plan.parts, wt);
    wg::mbar_arrive(&ring.full[n % stages]);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(&ring.full[s], TMA ? 1 : plan.parts * 128);
      wg::mbar_init(&ring.empty[s], tiles * 128);
    }
    wg::mbar_init_fence();
    if constexpr (TMA) ring.pump(1, load);
  }
  __syncthreads();
  if constexpr (!TMA) {
    if (wgi < plan.parts)
      for (int n = 0; n < plan.ahead && n < nh; ++n) fill(n, wgi);
  }

  unsigned char* stg = staging + wgi * 64 * TL::RB;
  const int w16 = 16 * (wt >> 5);      // the warp's first row of a tile
#pragma unroll 1
  for (int it = wgi; it < nh * tiles; it += FWD_WARPGROUPS) {
    const int j = it / tiles, m0 = it % tiles * 64, s = j % stages;
    if constexpr (TMA) {
      if (tid == 0) ring.pump(j + 1, load);
    }
    wg::mbar_wait(&ring.full[s], (j / stages) & 1);
    const uint32_t qt = wg::saddr(smem + s * slot);
    float o[TL::NA];
    {
      RowStats<DH, SCALE, FWD_WIDE, false> st;
      st.run(qt, m0 + w16, qt + region, 0, 0, L, Lp, f, scale, lane);
      attend<DH, SCALE, FWD_WIDE>(o, qt, m0 + w16, qt + region,
                                  qt + 2 * region, L, Lp, f, scale, st.lse,
                                  lane);
    }
    wg::fence_proxy_async();           // before the slot's next fill
    wg::mbar_arrive(&ring.empty[s]);
    const int bh = (int)blockIdx.x + j * (int)gridDim.x;
    const int b = bh / H, h = bh % H;
    store_tile<T, DH>(stg, o, 1.f, wgi, wt,
                      out + ((size_t)b * L + m0) * C + h * DH, C,
                      min(64, L - m0));
    if constexpr (!TMA) {
      if (plan.last(it, j) && j + plan.ahead < nh) {
        ring.wait_free(j + plan.ahead);
        fill(j + plan.ahead, plan.part(it));
      }
    }
  }
  if constexpr (TMA) {
    if (tid == 0) ring.pump(nh, load);  // heads only other groups need
  }
}

// The backward: dQKV rows of each (batch row, head) pair of this block.
// map_qkv as the forward's, map_do: dO as (C, L, B) in boxes of DH x Lp
// x 1 (a bf16 slab); qkv, dout: the slab and dO (a float32 slab). A slot:
// Q, K, V, dO tiles and at dh = 32 the Q tile scaled (QS), then (after
// the ring and the staging tiles) the slot's lse and delta rows (lse in
// the log2 domain of the logits S f).
template <typename T, int DH>
__global__ void __launch_bounds__(128 * BWD_WARPGROUPS, 1)
    slab_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_qkv,
                          const __grid_constant__ CUtensorMap map_do,
                          const T* __restrict__ qkv,
                          const T* __restrict__ dout, T* __restrict__ dqkv,
                          int BH, int L, int H, int Lp, int stages,
                          float scale) {
  using TL = Tile<DH>;
  constexpr bool TMA = std::is_same<T, bf16>::value;
  constexpr bool QS = DH == 32;        // bf16(q scale) apart from bf16(q)
  constexpr int NT = bwd_tiles(DH);
  // phase i's S operand: at dh = 32 a bf16 q scaled in registers, a
  // float32 one from the QS tile its fill wrote
  constexpr bool SCALE = TMA && QS;
  extern __shared__ unsigned char bwd_raw[];
  unsigned char* smem = align1k(bwd_raw);
  const int region = Lp * TL::RB, slot = NT * region;
  unsigned char* staging = smem + stages * slot;
  float* rows =
      reinterpret_cast<float*>(staging + BWD_WARPGROUPS * 64 * TL::RB);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows + 2 * stages * Lp);
  uint64_t* ready = bars + 2 * stages;
  const int tid = threadIdx.x, wgi = tid >> 7, wt = tid & 127;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int C = H * DH, C3 = 3 * C, tiles = (L + 63) / 64;
  const int items = 2 * tiles;         // a head's query, then key tiles
  const float f = QS ? LOG2E : scale * LOG2E;
  const int nh = BH > (int)blockIdx.x
                     ? (BH - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                     : 0;
  Ring ring{bars, bars + stages, stages, nh, 0};
  const FillPlan plan(stages, items, BWD_WARPGROUPS);
  auto load = [&](int j) {             // thread 0: head j's Q, K, V, dO
    const int s = j % stages, bh = (int)blockIdx.x + j * (int)gridDim.x;
    const int b = bh / H, h = bh % H;
    unsigned char* st = smem + s * slot;
    wg::mbar_expect_tx(&ring.full[s], 4 * region);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      wg::tma_load_3d(st + p * region, &map_qkv, &ring.full[s],
                      p * C + h * DH, 0, b);
    wg::tma_load_3d(st + 3 * region, &map_do, &ring.full[s], h * DH, 0, b);
  };
  auto fill = [&](int n, int part) {   // a warpgroup: its part of head n
    const int bh = (int)blockIdx.x + n * (int)gridDim.x;
    const int b = bh / H, h = bh % H;
    const float* x = reinterpret_cast<const float*>(qkv) + h * DH;
    const float* d = reinterpret_cast<const float*>(dout) + h * DH;
    Src src[NT] = {{x, C3, 1.f}, {x + C, C3, 1.f}, {x + 2 * C, C3, 1.f},
                   {d, C, 1.f}};
    if constexpr (QS) src[NT - 1] = {x, C3, scale};
    fill_part<DH, NT>(smem + (n % stages) * slot, region, src, b, L, Lp,
                      part, plan.parts, wt);
    wg::mbar_arrive(&ring.full[n % stages]);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(&ring.full[s], TMA ? 1 : plan.parts * 128);
      wg::mbar_init(&ring.empty[s], items * 128);
      wg::mbar_init(&ready[s], tiles * 128);
    }
    wg::mbar_init_fence();
    if constexpr (TMA) ring.pump(1, load);
  }
  __syncthreads();
  if constexpr (!TMA) {
    if (wgi < plan.parts)
      for (int n = 0; n < plan.ahead && n < nh; ++n) fill(n, wgi);
  }

  unsigned char* stg = staging + wgi * 64 * TL::RB;
  const int w16 = 16 * (wt >> 5);      // the warp's first row of a tile
#pragma unroll 1
  for (int it = wgi; it < nh * items; it += BWD_WARPGROUPS) {
    const int j = it / items, k = it % items, s = j % stages;
    const uint32_t phase = (j / stages) & 1;
    if constexpr (TMA) {
      if (tid == 0) ring.pump(j + 1, load);
    }
    wg::mbar_wait(&ring.full[s], phase);
    unsigned char* sl = smem + s * slot;
    const uint32_t qt = wg::saddr(sl), kt = qt + region;
    const uint32_t vt = qt + 2 * region, ot = qt + 3 * region;
    // the S operand's tile: bf16(q scale) at dh = 32 (phase ii's B, and
    // a float32 slab's phase i A), else bf16(q)
    const uint32_t st_q = QS ? qt + 4 * region : qt;
    float* lse = rows + 2 * s * Lp;
    float* del = lse + Lp;
    const int bh = (int)blockIdx.x + j * (int)gridDim.x;
    const int b = bh / H, h = bh % H;
    T* base = dqkv + (size_t)b * L * C3 + h * DH;
    if (k < tiles) {
      // phase i: query rows m0 .. m0 + 63
      const int m0 = 64 * k, row = m0 + w16;
      RowStats<DH, SCALE, DQ_WIDE, true> rs;
      rs.run(SCALE ? qt : st_q, row, kt, vt, ot, L, Lp, f, scale, lane);
      if (t == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = row + g + 8 * r;
          if (q < Lp) {
            lse[q] = q < L ? rs.lse[r] : INFINITY;
            del[q] = q < L ? rs.delta[r] : 0.f;
          }
        }
      }
      if constexpr (SCALE) {
        // phase ii's B operand: this tile's rows of bf16(q scale)
        constexpr int U = DH / 8;
        const int n_rows = min(64, Lp - m0);
        for (int u = wt; u < n_rows * U; u += 128) {
          const uint32_t off = TL::sw(m0 + u / U, u % U);
          uint4 w = *reinterpret_cast<const uint4*>(sl + off);
          w.x = scale_pair(w.x, scale);
          w.y = scale_pair(w.y, scale);
          w.z = scale_pair(w.z, scale);
          w.w = scale_pair(w.w, scale);
          *reinterpret_cast<uint4*>(sl + 4 * region + off) = w;
        }
        wg::fence_proxy_async();
      }
      wg::mbar_arrive(&ready[s]);
      // dQ = sum over key chunks of dS K, dS = P o (dP - delta)
      float dq[TL::NA];
      zero(dq);
      chunks<DQ_WIDE>(Lp, [&](auto w, int c0) {
        constexpr int N = decltype(w)::value / 2;
        float sc[N], dp[N];
        logits_dp<DH, SCALE>(sc, dp, SCALE ? qt : st_q, row, kt, vt, ot,
                             c0, lane, scale);
#pragma unroll
        for (int i = 0; i < N / 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = c0 + 8 * i + 2 * t + (e & 1), r = e >> 1;
            const float p =
                key < L ? ex2(fmaf(sc[4 * i + e], f, -rs.lse[r])) : 0.f;
            sc[4 * i + e] = p * (dp[4 * i + e] - rs.delta[r]);
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
      store_tile<T, DH>(stg, dq, scale, wgi, wt, base + (size_t)m0 * C3, C3,
                        min(64, L - m0));
    } else {
      // phase ii: key rows n0 .. n0 + 63, once the head's lse and delta
      // rows (and at dh = 32 its scaled Q) are in
      const int n0 = 64 * (k - tiles), row = n0 + w16;
      wg::mbar_wait(&ready[s], phase);
      float dk[TL::NA], dv[TL::NA];
      zero(dk);
      zero(dv);
      chunks<DKV_WIDE>(Lp, [&](auto w, int c0) {
        constexpr int N = decltype(w)::value / 2;
        float st[N], dpt[N];
        {
          uint32_t ka[TL::KS][4], va[TL::KS][4];
          TL::load_a(ka, kt, row, lane);
          TL::load_a(va, vt, row, lane);
          zero(st);
          zero(dpt);
          wg::fence_regs(st);
          wg::fence_regs(dpt);
          wg::fence();
          issue_nt<DH>(st, ka, st_q, c0);  // S^T = K Q^T
          issue_nt<DH>(dpt, va, ot, c0);   // dP^T = V dO^T
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
                ex2(fmaf(st[4 * i + e], f, -(e & 1 ? lq.y : lq.x)));
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
      store_tile<T, DH>(stg, dk, scale, wgi, wt, base + (size_t)n0 * C3 + C,
                        C3, rows_out);
      store_tile<T, DH>(stg, dv, 1.f, wgi, wt,
                        base + (size_t)n0 * C3 + 2 * C, C3, rows_out);
    }
    if constexpr (!TMA) {
      if (plan.last(it, j) && j + plan.ahead < nh) {
        ring.wait_free(j + plan.ahead);
        fill(j + plan.ahead, plan.part(it));
      }
    }
  }
  if constexpr (TMA) {
    if (tid == 0) ring.pump(nh, load);  // heads only other groups need
  }
}

bool shape_ok(int B, int L, int H, int DH) {
  return B >= 1 && H >= 1 && L >= 1 && L <= L_MAX && (DH == 32 || DH == 64);
}

// A tensor map over a (B, L, width) bf16 tensor as (width, L, B), boxes
// of DH x Lp x 1, swizzled to DH's row; a float32 slab takes none (its
// kernels load by hand): an empty map.
template <typename T, int DH>
cudaError_t head_map(CUtensorMap* map, const void* base, int width, int L,
                     int B, int Lp) {
  if constexpr (!std::is_same<T, bf16>::value) {
    memset(map, 0, sizeof(*map));
    return cudaSuccess;
  } else {
    const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)L,
                                (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)width * 2,
                                   (cuuint64_t)width * 2 * L};
    const cuuint32_t box[3] = {DH, (cuuint32_t)Lp, 1};
    return wg::bf16_map(map, base, 3, dims, strides, box,
                        DH == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B);
  }
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

template <typename T, int DH>
cudaError_t fwd(const T* qkv, T* out, int B, int L, int H, int stages,
                cudaStream_t stream) {
  const int Lp = lp_of(L);
  const size_t smem = fwd_smem(Lp, DH, stages);
  if (stages < 1 || smem > SMEM_MAX) return cudaErrorInvalidValue;
  CUtensorMap map;
  int grid = 0;
  cudaError_t err;
  if ((err = head_map<T, DH>(&map, qkv, 3 * H * DH, L, B, Lp)) !=
          cudaSuccess ||
      (err = set_smem(slab_fwd_wgmma_kernel<T, DH>, smem)) != cudaSuccess ||
      (err = grid_of(B * H, &grid)) != cudaSuccess)
    return err;
  slab_fwd_wgmma_kernel<T, DH><<<grid, 128 * FWD_WARPGROUPS, smem, stream>>>(
      map, qkv, out, B * H, L, H, Lp, stages, 1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t bwd(const T* qkv, const T* dout, T* dqkv, int B, int L, int H,
                int stages, cudaStream_t stream) {
  const int Lp = lp_of(L);
  const size_t smem = bwd_smem(Lp, DH, stages);
  if (stages < 1 || smem > SMEM_MAX) return cudaErrorInvalidValue;
  CUtensorMap map_qkv, map_do;
  int grid = 0;
  cudaError_t err;
  if ((err = head_map<T, DH>(&map_qkv, qkv, 3 * H * DH, L, B, Lp)) !=
          cudaSuccess ||
      (err = head_map<T, DH>(&map_do, dout, H * DH, L, B, Lp)) !=
          cudaSuccess ||
      (err = set_smem(slab_bwd_wgmma_kernel<T, DH>, smem)) != cudaSuccess ||
      (err = grid_of(B * H, &grid)) != cudaSuccess)
    return err;
  slab_bwd_wgmma_kernel<T, DH><<<grid, 128 * BWD_WARPGROUPS, smem, stream>>>(
      map_qkv, map_do, qkv, dout, dqkv, B * H, L, H, Lp, stages,
      1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename T>
int fwd_entry(const void* qkv, void* out, int B, int L, int H, int DH,
              int stages, void* stream) {
  if (!shape_ok(B, L, H, DH)) return (int)cudaErrorInvalidValue;
  // 16-byte loads (TMA or by hand) and 16-byte or 8-byte stores
  if (((uintptr_t)qkv | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  const T* q = static_cast<const T*>(qkv);
  T* o = static_cast<T*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(DH == 32 ? fwd<T, 32>(q, o, B, L, H, stages, s)
                        : fwd<T, 64>(q, o, B, L, H, stages, s));
}

template <typename T>
int bwd_entry(const void* qkv, const void* dout, void* dqkv, int B, int L,
              int H, int DH, int stages, void* stream) {
  if (!shape_ok(B, L, H, DH)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)qkv | (uintptr_t)dout | (uintptr_t)dqkv) & 15)
    return (int)cudaErrorMisalignedAddress;
  const T* q = static_cast<const T*>(qkv);
  const T* o = static_cast<const T*>(dout);
  T* d = static_cast<T*>(dqkv);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(DH == 32 ? bwd<T, 32>(q, o, d, B, L, H, stages, s)
                        : bwd<T, 64>(q, o, d, B, L, H, stages, s));
}

}  // namespace

extern "C" {

// qkv (B, L, 3 H DH) -> out (B, L, H DH), both bf16; a ring of `stages`
// head slots.
int ertdx_slab_fwd_bf16(const void* qkv, void* out, int B, int L, int H,
                        int DH, int stages, void* stream) {
  return fwd_entry<bf16>(qkv, out, B, L, H, DH, stages, stream);
}

// qkv (B, L, 3 H DH), dout (B, L, H DH) -> dqkv (B, L, 3 H DH), all bf16,
// in one launch; a ring of `stages` head slots.
int ertdx_slab_bwd_bf16(const void* qkv, const void* dout, void* dqkv,
                        int B, int L, int H, int DH, int stages,
                        void* stream) {
  return bwd_entry<bf16>(qkv, dout, dqkv, B, L, H, DH, stages, stream);
}

// The same on a float32 slab: float32 in and out, the operands rounded to
// bf16 in the kernels.
int ertdx_slab_fwd_onepass(const void* qkv, void* out, int B, int L, int H,
                           int DH, int stages, void* stream) {
  return fwd_entry<float>(qkv, out, B, L, H, DH, stages, stream);
}

int ertdx_slab_bwd_onepass(const void* qkv, const void* dout, void* dqkv,
                           int B, int L, int H, int DH, int stages,
                           void* stream) {
  return bwd_entry<float>(qkv, dout, dqkv, B, L, H, DH, stages, stream);
}

}  // extern "C"
