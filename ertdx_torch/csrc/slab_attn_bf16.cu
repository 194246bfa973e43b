// Packed-head slab attention in bfloat16, forward and backward (sm_90a;
// every product one bf16 MMA of bf16mma.cuh, float32 accumulation).
//
// Replaces the TPU kernels of ertdx/ops/slab_attn.py on a bf16 slab, the
// encoder of a bfloat16 model (V5E8_DP):
//   * slab_fwd_bf16_kernel          <- _slab_fwd_kernel (:147-168)
//   * slab_bwd_dq_bf16_kernel and
//     slab_bwd_dkv_bf16_kernel      <- _slab_bwd_kernel (:184-222)
// The layout is slab_attn.cu's: the fused QKV slab (B, L, 3C) in, q at
// lanes [0, C), k at [C, 2C), v at [2C, 3C), head h at [h dh, (h+1) dh)
// of each third; the output (B, L, C) and dQ | dK | dV (B, L, 3C) out,
// all bf16. The math is the TPU kernel's at its DEFAULT precision, which
// on the TPU is one bf16 pass a product with float32 accumulation:
//   * S = Q K^T from the bf16 operands (exact products, float32 sums),
//     then scaled by 1/sqrt(dh) in float32 (JAX's plain version scales
//     the logits; the TPU kernel scales q, the same for dh = 64);
//   * the softmax in float32 on the accumulators;
//   * O = P V with P rounded to bf16 for the product (the forward rounds
//     exp(S - max), the running max of an online softmax, and divides by
//     the float32 row sum at the end); O rounded to bf16 on the way out;
//   * the backward: dP = dO V^T exact, delta = rowsum(P o dP) and
//     dS = P o (dP - delta) in float32, dQ = dS K scale, dK = dS^T Q
//     scale, dV = P^T dO with dS and P rounded to bf16 for their
//     products; dQKV rounded to bf16.
//
// What bounds it on an H100: bytes. At the encoder's training shape
// (B=256, L=147, C=256, H=4, dh=64) the forward reads the bf16 slab and
// writes the output, 77 MB, 0.023 ms at 3.35 TB/s, against 4 B H L^2 dh
// = 5.7 GFLOP, 0.0057 ms at the 989 TFLOP/s of the bf16 tensor cores;
// the backward reads the slab and dO and writes dQKV, 135 MB (0.040 ms),
// for 10 B H L^2 dh = 14.2 GFLOP (0.014 ms). Half of the float32
// kernels' bytes, and a quarter of their tensor-core passes (one MMA a
// product where 3xTF32 takes three, at twice the rate a pass).
//
// The design is slab_attn.cu's, on the bf16 tile:
//   * One block per (batch row, head), 32 x block_warps(L) threads; warp
//     w takes the 16-row tiles w, w + warps, ... of the head. A head's two
//     resident operands are staged once, with 16-byte cp.async (8 bf16
//     values a copy: the slab's row stride 3C values and the head's
//     offset h dh are multiples of 8; the wrappers refuse a slab that
//     does not start on a 16-byte boundary). Shared rows hold DH + 8
//     values, so that fragment loads and ldmatrix hit 32 distinct banks.
//   * The forward (K, V resident) loads a warp's 16 q rows into A
//     fragments once and stages the warp's next q rows at once; it keeps
//     the row of S in registers (key_tiles(L) n tiles of 8 keys; above
//     160 keys two halves under an online softmax) and runs P V from the
//     accumulators, two n tiles a k step of 16.
//   * The backward is two launches. The dQ pass (K, V resident; query
//     rows) writes each row's log-sum-exp and delta to a float32 (B, H,
//     L) scratch, recomputing dP once for delta and once for dS, as the
//     float32 pass does; the dK/dV pass (Q, dO resident; key rows, k and
//     v held as A fragments) recomputes P from the log-sum-exp. No
//     atomics: each kernel owns its outputs, and reruns are
//     bit-identical.
//   * The ragged edge: staged rows past L are zero; keys past L get -inf
//     before the max (p = 0 exactly); queries past L get p = 0 in the
//     dK/dV pass; rows past L are never written.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16mma.cuh"

namespace {

using bf16mma::bf16;

constexpr int L_MAX = 256;             // longest sequence the kernels take

// Warps of a block at length L, and the key tiles L is padded to (8, 16,
// 20 or 32 n tiles of 8), as in slab_attn.cu.
constexpr int MAX_WARPS = 4;
int block_warps(int L) { return min(MAX_WARPS, ((L + 15) / 16 + 1) / 2); }

__host__ __device__ int key_tiles(int L) {
  const int n = (L + 7) / 8;
  return n <= 8 ? 8 : n <= 16 ? 16 : n <= 20 ? 20 : 32;
}

__host__ __device__ int Lp_of(int L) { return 8 * key_tiles(L); }

// Forward: out rows of one (batch row, head). K and V sit in shared
// memory ((8 NT, DH+8), zero rows past L); a warp holds its 16 q rows as
// A fragments, keeps a row of S = q k^T in registers in chunks of KC n
// tiles (one chunk up to 160 keys, two of 128 above, under an online
// softmax), and runs O += P V from them, P rounded to bf16.
template <int DH, int NT>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    slab_fwd_bf16_kernel(const bf16* __restrict__ qkv,
                         bf16* __restrict__ out, int L, int H,
                         float scale) {
  using namespace bf16mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DH + 8, NN = DH / 8, KS = DH / 16, Lp = 8 * NT;
  constexpr int KC = NT > 20 ? NT / 2 : NT;
  const int C = H * DH, C3 = 3 * C;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32, g = lane >> 2, t = lane & 3;
  const int tiles = (L + 15) / 16;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);     // (Lp, LD)
  bf16* Vs = Ks + Lp * LD;                          // (Lp, LD)
  bf16* W = Vs + Lp * LD + warp * 16 * LD;          // this warp's q rows
  const bf16* base = qkv + (size_t)b * L * C3 + h * DH;
  auto stage_q = [&](int tile) {
    if (tile < tiles)
      stage<DH>(W, LD, base + (size_t)tile * 16 * C3, C3, 16, L - tile * 16,
                warp * 32, 32);
    cp_commit();
  };
  stage<DH>(Ks, LD, base + C, C3, Lp, L, 0, blockDim.x);
  stage<DH>(Vs, LD, base + 2 * C, C3, Lp, L, 0, blockDim.x);
  stage_q(warp);
  cp_wait<0>();
  __syncthreads();

  for (int tile = warp; tile < tiles; tile += warps) {
    const int m0 = tile * 16;
    uint32_t qa[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) load_a(qa[ks], W, LD, 0, 16 * ks, lane);
    __syncwarp();                                   // q is read: stage next
    stage_q(tile + warps);

    // running max and sum of rows g and g+8 (the sum per thread, over its
    // keys, added up over the quad at the end); chunk 0 holds key 0, so
    // the max is finite from the first chunk on
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
    float acc[NN][4] = {};
#pragma unroll
    for (int c = 0; c < NT; c += KC) {
      float p[KC][4];
#pragma unroll
      for (int j = 0; j < KC; ++j)
        p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          uint32_t kb[2];
          load_b_nt(kb, Ks, LD, 8 * (c + j), 16 * ks, lane);
          mma(p[j], qa[ks], kb[0], kb[1]);          // S = q k^T
        }

      // scale, then the softmax over the keys < L: -inf before the max,
      // so p = 0 past L
      float cm[2] = {mx[0], mx[1]};
#pragma unroll
      for (int j = 0; j < KC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * (c + j) + 2 * t + (e & 1);
          p[j][e] = key < L ? p[j][e] * scale : -INFINITY;
          cm[e >> 1] = fmaxf(cm[e >> 1], p[j][e]);
        }
      cm[0] = quad_max(cm[0]);
      cm[1] = quad_max(cm[1]);
      if (c > 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float alpha = expf(mx[r] - cm[r]);
          sum[r] *= alpha;
#pragma unroll
          for (int n = 0; n < NN; ++n) {
            acc[n][2 * r] *= alpha;
            acc[n][2 * r + 1] *= alpha;
          }
        }
      }
      mx[0] = cm[0];
      mx[1] = cm[1];
#pragma unroll
      for (int j = 0; j < KC; j += 2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[j][e] = expf(p[j][e] - mx[e >> 1]);
          p[j + 1][e] = expf(p[j + 1][e] - mx[e >> 1]);
          sum[e >> 1] += p[j][e] + p[j + 1][e];
        }
        uint32_t pa[4];
        from_c2(pa, p[j], p[j + 1]);
#pragma unroll
        for (int n = 0; n < NN; n += 2) {
          uint32_t vb[4];
          load_b_nn2(vb, Vs, LD, 8 * (c + j), 8 * n, lane);
          mma(acc[n], pa, vb[0], vb[1]);            // O += P V
          mma(acc[n + 1], pa, vb[2], vb[3]);
        }
      }
    }
    const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + g + 8 * r;
      if (row < L) {
        bf16* o = out + ((size_t)b * L + row) * C + h * DH + 2 * t;
#pragma unroll
        for (int n = 0; n < NN; ++n)
          *reinterpret_cast<uint32_t*>(o + 8 * n) =
              pack(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
      }
    }
    cp_wait<0>();
    __syncwarp();                                   // the next q rows are in W
  }
}

// Backward pass 1: dQ rows, and each row's log-sum-exp and delta. K and V
// sit in shared memory ((8 NT, DH+8), zero rows past L); a warp loads its
// 16 q rows as A fragments, stages its dO rows in their place, keeps the
// row of P in registers (normalised, float32), and recomputes dP = dO V^T
// in chunks of CH n tiles twice: once for delta = rowsum(P o dP), once for
// dS = P o (dP - delta), which goes from the accumulators into dQ = dS K,
// two n tiles a k step of 16. The row of P takes 4 NT registers, 128 at
// NT = 32, so the rest is kept small: q's and dO's A fragments are read
// from shared memory at each k step (dO is staged once S is computed),
// the k-step loops are rolled where ptxas spilled them unrolled, and
// above 160 keys the chunks are 2 n tiles.
template <int DH, int NT>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    slab_bwd_dq_bf16_kernel(const bf16* __restrict__ qkv,
                            const bf16* __restrict__ dout,
                            bf16* __restrict__ dqkv,
                            float* __restrict__ lse,
                            float* __restrict__ delta, int L, int H,
                            float scale) {
  using namespace bf16mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DH + 8, NN = DH / 8, KS = DH / 16, Lp = 8 * NT;
  constexpr int CH = NT > 20 ? 2 : 4;
  // the k steps of dP rolled where unrolled ones spilled (ptxas, sm_90a)
  constexpr int KU = DH == 64 || NT > 20 ? 1 : KS;
  const int C = H * DH, C3 = 3 * C;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32, g = lane >> 2, t = lane & 3;
  const int tiles = (L + 15) / 16;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);     // (Lp, LD)
  bf16* Vs = Ks + Lp * LD;                          // (Lp, LD)
  bf16* W = Vs + Lp * LD + warp * 16 * LD;          // 16 q rows, then dO
  const bf16* base = qkv + (size_t)b * L * C3 + h * DH;
  const bf16* obase = dout + (size_t)b * L * C + h * DH;
  stage<DH>(Ks, LD, base + C, C3, Lp, L, 0, blockDim.x);
  stage<DH>(Vs, LD, base + 2 * C, C3, Lp, L, 0, blockDim.x);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  for (int tile = warp; tile < tiles; tile += warps) {
    const int m0 = tile * 16;
    stage<DH>(W, LD, base + (size_t)m0 * C3, C3, 16, L - m0, warp * 32, 32);
    cp_commit();
    cp_wait<0>();
    __syncwarp();
    float p[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      load_a(qa, W, LD, 0, 16 * ks, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t kb[2];
        load_b_nt(kb, Ks, LD, 8 * j, 16 * ks, lane);
        mma(p[j], qa, kb[0], kb[1]);                // S = q k^T
      }
    }
    __syncwarp();                                   // q is read: load dO
    stage<DH>(W, LD, obase + (size_t)m0 * C, C, 16, L - m0, warp * 32, 32);
    cp_commit();

    // softmax over the keys < L: -inf before the max, so p = 0 past L
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1);
        p[j][e] = key < L ? p[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], p[j][e]);
      }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] = expf(p[j][e] - mx[e >> 1]);
        sum[e >> 1] += p[j][e];
      }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] *= inv[e >> 1];
    cp_wait<0>();
    __syncwarp();                                   // dO is in W

    // delta = rowsum(P o dP)
    float dl[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NT / CH; ++c) {
      float dp[CH][4] = {};
#pragma unroll KU
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t oa[4];
        load_a(oa, W, LD, 0, 16 * ks, lane);
#pragma unroll
        for (int jj = 0; jj < CH; ++jj) {
          uint32_t vb[2];
          load_b_nt(vb, Vs, LD, 8 * (CH * c + jj), 16 * ks, lane);
          mma(dp[jj], oa, vb[0], vb[1]);            // dP = dO v^T
        }
      }
#pragma unroll
      for (int jj = 0; jj < CH; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dl[e >> 1] = fmaf(p[CH * c + jj][e], dp[jj][e], dl[e >> 1]);
    }
    dl[0] = quad_sum(dl[0]);
    dl[1] = quad_sum(dl[1]);

    // dS = P o (dP - delta), dQ = dS K
    float acc[NN][4] = {};
#pragma unroll
    for (int c = 0; c < NT / CH; ++c) {
      float dp[CH][4] = {};
#pragma unroll KU
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t oa[4];
        load_a(oa, W, LD, 0, 16 * ks, lane);
#pragma unroll
        for (int jj = 0; jj < CH; ++jj) {
          uint32_t vb[2];
          load_b_nt(vb, Vs, LD, 8 * (CH * c + jj), 16 * ks, lane);
          mma(dp[jj], oa, vb[0], vb[1]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < CH; jj += 2) {
        const int j = CH * c + jj;
        float ds0[4], ds1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds0[e] = p[j][e] * (dp[jj][e] - dl[e >> 1]);
          ds1[e] = p[j + 1][e] * (dp[jj + 1][e] - dl[e >> 1]);
        }
        uint32_t da[4];
        from_c2(da, ds0, ds1);
#pragma unroll
        for (int n = 0; n < NN; n += 2) {
          uint32_t kb[4];
          load_b_nn2(kb, Ks, LD, 8 * j, 8 * n, lane);
          mma(acc[n], da, kb[0], kb[1]);
          mma(acc[n + 1], da, kb[2], kb[3]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + g + 8 * r;
      if (row < L) {
        bf16* dq = dqkv + ((size_t)b * L + row) * C3 + h * DH + 2 * t;
#pragma unroll
        for (int n = 0; n < NN; ++n)
          *reinterpret_cast<uint32_t*>(dq + 8 * n) =
              pack(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
        if (t == 0) {
          const size_t i = ((size_t)b * H + h) * L + row;
          lse[i] = mx[r] + logf(sum[r]);
          delta[i] = dl[r];
        }
      }
    }
    __syncwarp();                                   // W is restaged next
  }
}

// Backward pass 2: dK and dV rows, P recomputed from the log-sum-exp. Q
// and dO of the head ((Lp, DH+8), Lp = 8 key_tiles(L), zero rows past L)
// and its lse and delta sit in shared memory; a warp holds its 16 key
// rows of k and v as A fragments (read once from the slab) and walks the
// queries 16 at a time: S^T = k q^T and dP^T = v dO^T, P^T and dS^T on
// the accumulators, then dV += P^T dO and dK += dS^T Q from them.
template <int DH>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    slab_bwd_dkv_bf16_kernel(const bf16* __restrict__ qkv,
                             const bf16* __restrict__ dout,
                             bf16* __restrict__ dqkv,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta, int L, int H,
                             float scale) {
  using namespace bf16mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DH + 8, NN = DH / 8, KS = DH / 16;
  const int C = H * DH, C3 = 3 * C;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32, g = lane >> 2, t = lane & 3;
  const int Lp = Lp_of(L), nt = Lp / 8, tiles = (L + 15) / 16;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);     // (Lp, LD)
  bf16* Os = Qs + Lp * LD;                          // (Lp, LD)
  float* LSE = reinterpret_cast<float*>(Os + Lp * LD);   // (Lp)
  float* DEL = LSE + Lp;                            // (Lp)
  const bf16* base = qkv + (size_t)b * L * C3 + h * DH;
  const bf16* obase = dout + (size_t)b * L * C + h * DH;
  const size_t row0 = ((size_t)b * H + h) * L;
  stage<DH>(Qs, LD, base, C3, Lp, L, 0, blockDim.x);
  stage<DH>(Os, LD, obase, C, Lp, L, 0, blockDim.x);
  cp_commit();
  for (int i = threadIdx.x; i < Lp; i += blockDim.x) {
    LSE[i] = i < L ? lse[row0 + i] : 0.f;
    DEL[i] = i < L ? delta[row0 + i] : 0.f;
  }
  cp_wait<0>();
  __syncthreads();

  for (int tile = warp; tile < tiles; tile += warps) {
    const int m0 = tile * 16;
    uint32_t ka[KS][4], va[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + g + 8 * (i & 1);
        const bf16* src =
            base + (size_t)row * C3 + 16 * ks + 2 * t + 8 * (i >> 1);
        ka[ks][i] = row < L ? ld32(src + C) : 0u;
        va[ks][i] = row < L ? ld32(src + 2 * C) : 0u;
      }
    float dk[NN][4] = {}, dv[NN][4] = {};
    for (int j0 = 0; j0 < nt; j0 += 2) {
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t qb[2], ob[2];
          load_b_nt(qb, Qs, LD, 8 * (j0 + jj), 16 * ks, lane);
          mma(s[jj], ka[ks], qb[0], qb[1]);         // S^T = k q^T
          load_b_nt(ob, Os, LD, 8 * (j0 + jj), 16 * ks, lane);
          mma(dp[jj], va[ks], ob[0], ob[1]);        // dP^T = v dO^T
        }
      float pr[2][4], ds[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 8 * (j0 + jj) + 2 * t + (e & 1);
          pr[jj][e] = q < L ? expf(s[jj][e] * scale - LSE[q]) : 0.f;
          ds[jj][e] = pr[jj][e] * (dp[jj][e] - DEL[q]);
        }
      uint32_t pa[4], da[4];
      from_c2(pa, pr[0], pr[1]);
      from_c2(da, ds[0], ds[1]);
#pragma unroll
      for (int n = 0; n < NN; n += 2) {
        uint32_t yb[4];
        load_b_nn2(yb, Os, LD, 8 * j0, 8 * n, lane);
        mma(dv[n], pa, yb[0], yb[1]);               // dV += P^T dO
        mma(dv[n + 1], pa, yb[2], yb[3]);
        load_b_nn2(yb, Qs, LD, 8 * j0, 8 * n, lane);
        mma(dk[n], da, yb[0], yb[1]);               // dK += dS^T Q
        mma(dk[n + 1], da, yb[2], yb[3]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + g + 8 * r;
      if (row < L) {
        bf16* d = dqkv + ((size_t)b * L + row) * C3 + h * DH + 2 * t;
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          *reinterpret_cast<uint32_t*>(d + C + 8 * n) =
              pack(dk[n][2 * r] * scale, dk[n][2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(d + 2 * C + 8 * n) =
              pack(dv[n][2 * r], dv[n][2 * r + 1]);
        }
      }
    }
  }
}

// The forward and the dQ pass: K and V, and 16 rows a warp.
size_t fwd_smem(int L, int DH) {
  const int lp = Lp_of(L), ld = DH + 8;
  return sizeof(bf16) * (2 * lp * ld + block_warps(L) * 16 * ld);
}

size_t dkv_smem(int L, int DH) {
  const int lp = Lp_of(L), ld = DH + 8;
  return sizeof(bf16) * 2 * lp * ld + sizeof(float) * 2 * lp;
}

template <int DH>
auto fwd_kernel(int L) {
  switch (key_tiles(L)) {
    case 8: return slab_fwd_bf16_kernel<DH, 8>;
    case 16: return slab_fwd_bf16_kernel<DH, 16>;
    case 20: return slab_fwd_bf16_kernel<DH, 20>;
    default: return slab_fwd_bf16_kernel<DH, 32>;
  }
}

template <int DH>
auto dq_kernel(int L) {
  switch (key_tiles(L)) {
    case 8: return slab_bwd_dq_bf16_kernel<DH, 8>;
    case 16: return slab_bwd_dq_bf16_kernel<DH, 16>;
    case 20: return slab_bwd_dq_bf16_kernel<DH, 20>;
    default: return slab_bwd_dq_bf16_kernel<DH, 32>;
  }
}

bool shape_ok(int B, int L, int H, int DH) {
  return B >= 1 && H >= 1 && L >= 1 && L <= L_MAX && (DH == 32 || DH == 64);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename K>
int resident(K kernel, int threads, size_t bytes) {
  int blocks = 0;
  if (set_smem(kernel, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    bytes) != cudaSuccess)
    return -1;
  return blocks;
}

template <int DH>
void occupancy(int L, int* out) {
  const int threads = 32 * block_warps(L);
  out[0] = resident(fwd_kernel<DH>(L), threads, fwd_smem(L, DH));
  out[1] = resident(dq_kernel<DH>(L), threads, fwd_smem(L, DH));
  out[2] = resident(slab_bwd_dkv_bf16_kernel<DH>, threads, dkv_smem(L, DH));
  out[3] = threads;
}

template <int DH>
int fwd(const bf16* qkv, bf16* out, int B, int L, int H,
        cudaStream_t stream) {
  const size_t smem = fwd_smem(L, DH);
  const auto kern = fwd_kernel<DH>(L);
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * H, 32 * block_warps(L), smem, stream>>>(
      qkv, out, L, H, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <int DH>
int bwd(const bf16* qkv, const bf16* dout, bf16* dqkv, float* lse,
        float* delta, int B, int L, int H, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)DH);
  const int threads = 32 * block_warps(L);
  size_t smem = fwd_smem(L, DH);
  const auto dq = dq_kernel<DH>(L);
  cudaError_t err = set_smem(dq, smem);
  if (err != cudaSuccess) return (int)err;
  dq<<<B * H, threads, smem, stream>>>(qkv, dout, dqkv, lse, delta, L, H,
                                      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  smem = dkv_smem(L, DH);
  err = set_smem(slab_bwd_dkv_bf16_kernel<DH>, smem);
  if (err != cudaSuccess) return (int)err;
  slab_bwd_dkv_bf16_kernel<DH><<<B * H, threads, smem, stream>>>(
      qkv, dout, dqkv, lse, delta, L, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv (B, L, 3 H DH) -> out (B, L, H DH), both bf16.
int ertdx_slab_fwd_bf16(const void* qkv, void* out, int B, int L, int H,
                        int DH, void* stream) {
  if (!shape_ok(B, L, H, DH)) return (int)cudaErrorInvalidValue;
  // the kernels stage rows with 16-byte cp.async
  if ((uintptr_t)qkv & 15) return (int)cudaErrorMisalignedAddress;
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  return DH == 32 ? fwd<32>(q, o, B, L, H, s) : fwd<64>(q, o, B, L, H, s);
}

// qkv (B, L, 3 H DH), dout (B, L, H DH) -> dqkv (B, L, 3 H DH), all
// bf16; lse and delta are float32 (B, H, L) scratch written by the first
// pass.
int ertdx_slab_bwd_bf16(const void* qkv, const void* dout, void* dqkv,
                        float* lse, float* delta, int B, int L, int H,
                        int DH, void* stream) {
  if (!shape_ok(B, L, H, DH)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)qkv | (uintptr_t)dout) & 15)
    return (int)cudaErrorMisalignedAddress;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* o = static_cast<const bf16*>(dout);
  bf16* d = static_cast<bf16*>(dqkv);
  cudaStream_t s = (cudaStream_t)stream;
  return DH == 32 ? bwd<32>(q, o, d, lse, delta, B, L, H, s)
                  : bwd<64>(q, o, d, lse, delta, B, L, H, s);
}

// Resident blocks per SM of the forward, dQ and dK/dV kernels at (L, DH),
// written to out[0..2] (-1 where the query fails), and the threads of a
// block of each, to out[3].
int ertdx_slab_bf16_blocks_per_sm(int L, int DH, int* out) {
  if (!shape_ok(1, L, 1, DH)) return (int)cudaErrorInvalidValue;
  if (DH == 32)
    occupancy<32>(L, out);
  else
    occupancy<64>(L, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
