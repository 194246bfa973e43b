// Packed-head slab attention, forward and backward (sm_90a; every
// product on the 3xTF32 tensor-core tile of tf32x3.cuh).
//
// Replaces the TPU kernels of ertdx/ops/slab_attn.py:
//   * slab_fwd_kernel            <- _slab_fwd_kernel (:147-168)
//   * slab_bwd_dq_kernel and
//     slab_bwd_dkv_kernel        <- _slab_bwd_kernel (:184-222)
// Input is the fused QKV slab (B, L, 3C) as the encoder's Dense emits it:
// q at lanes [0, C), k at [C, 2C), v at [2C, 3C); head h owns lanes
// [h dh, (h+1) dh) of each third. The forward writes softmax((q scale)
// k^T) v per head, scale = 1/sqrt(dh), into (B, L, C); the backward
// writes dQ | dK | dV into (B, L, 3C) in the same layout, with the JAX
// kernel's math: dS = P o (dP - rowsum(dP o P)), dQ = dS K scale, dK =
// dS^T Q scale, dV = P^T dO. No (B, H, L, dh) tensor and no logit matrix
// ever reaches device memory.
//
// What bounds it on an H100: bytes in the forward, operations (barely)
// in the backward. At the encoder's training shape
// (B=256, L=147, C=256, H=4, dh=64) the forward reads the slab and
// writes the output, 154 MB, 0.046 ms at 3.35 TB/s, against 4 B H L^2 dh
// = 5.7 GFLOP, 17 GFLOP as 3xTF32 (0.034 ms at 495 TFLOP/s); the
// backward moves 270 MB (0.081 ms) for 10 B H L^2 dh = 14.2 GFLOP, 42.6
// as 3xTF32 (0.086 ms). On the fp32 pipe (67 TFLOP/s) the products alone
// would take 0.085 and 0.211 ms.
//
// What the design does about it, and what it changes from the TPU kernel:
//   * Exact per-head attention. The TPU's block-diagonal head groups
//     (_packed_kv, _diag_blocks) exist only to fill 128 MXU lanes and are
//     not carried over: no masked logits are computed.
//   * Every product (forward S = q k^T and O = P V; backward S, dP, dQ =
//     dS K, dV = P^T dO, dK = dS^T Q) runs on the 3xTF32 tile of
//     tf32x3.cuh: warp-level mma.sync m16n8k8, each operand split into two
//     TF32 halves, three MMAs a k step; fp32-class results (the TPU kernel
//     runs Precision.HIGHEST), so `accurate` has no effect. The softmax
//     (and in the backward delta and dS) is computed on the accumulator
//     fragments in registers, and P and dS feed the next product from
//     there.
//   * Each kernel is one block per (batch row, head), so that a head's two
//     resident operands are staged once, with 16-byte cp.async (the
//     slab's row stride is 3C floats, 16-byte aligned since C is a
//     multiple of 4; the wrappers refuse a slab that does not start on a
//     16-byte boundary). A block has 32 x block_warps(L) threads; warp w
//     takes the 16-row tiles w, w + warps, ... of the head.
//   * The forward (K, V resident) stages a warp's 16 q rows, scales them,
//     keeps the whole row of S in registers (key_tiles(L) n tiles of 8
//     keys; above 160 keys two halves under an online softmax), takes
//     the softmax there and runs P V from the fragments, scaling by
//     1/rowsum at the end; the next tile's q rows are staged while it
//     does. P V sums each k step's MMAs from zero and adds them
//     to O in fp32 (tf32x3::nn_add): over L keys the MMA's own
//     accumulation drifts further from the fp32 plain version than
//     training's gates allow.
//   * The backward is two launches. A dQ pass (K, V resident; query rows)
//     also writes each row's log-sum-exp and delta = rowsum(dP o P) to a
//     (B, H, L) scratch, and a dK/dV pass (Q, dO resident; key rows)
//     recomputes P from the log-sum-exp. Each kernel owns its outputs
//     outright: no atomics, deterministic results. At L=147, dh=64 the
//     forward and the dQ pass take 104 KB of shared memory and the dK/dV
//     pass 88 KB: two blocks of 4 warps an SM. The dQ pass recomputes dP
//     once more for delta than the TPU kernel does (dP does not fit in
//     registers beside P at L=256): 8 products where the math has 5.
//   * The ragged edge: L need not be a multiple of 16. Staged rows past L
//     are zero; keys past L get -inf before the max (p = 0 exactly),
//     queries past L get p = 0 in the dK/dV pass; rows past L are never
//     written.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int L_MAX = 256;             // longest sequence the kernels take

// Warps of a block at length L: at least two 16-row tiles each, at most
// MAX_WARPS, so that two blocks fit an SM's registers at up to 255 a
// thread.
constexpr int MAX_WARPS = 4;
int block_warps(int L) { return min(MAX_WARPS, ((L + 15) / 16 + 1) / 2); }

// Key (and query) n tiles of 8 the kernels pad L to: 8, 16, 20 or 32
// (L <= 64, 128, 160, 256), so that their loops over them have a
// compile-time count and no branch. Padded rows are zero in shared memory
// and their keys and queries are masked.
__host__ __device__ int key_tiles(int L) {
  const int n = (L + 7) / 8;
  return n <= 8 ? 8 : n <= 16 ? 16 : n <= 20 ? 20 : 32;
}

__host__ __device__ int Lp_of(int L) { return 8 * key_tiles(L); }

// Forward: out rows of one (batch row, head). K and V of the head sit in
// shared memory ((8 NT, DH+4), zero rows past L); a warp stages its 16 q
// rows, scales them (the TPU kernel's q * scale), and keeps a row of S =
// q k^T, then of exp(S - max), in registers; O = P V runs from those
// fragments and is scaled by 1/rowsum on the way out. The row is taken
// in chunks of KC n tiles, up to 160 keys: one chunk for L <= 160; above
// that (NT = 32) two of 128 keys under an online softmax, as a whole row
// of 256 keys in registers beside O spills. The warp's next q rows are
// staged once its last chunk of S is computed.
template <int DH, int NT>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    slab_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                    int L, int H, float scale) {
  using namespace tf32x3;
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = DH + 4, NN = DH / 8, Lp = 8 * NT;
  constexpr int KC = NT > 20 ? NT / 2 : NT;
  const int C = H * DH, C3 = 3 * C;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32, g = lane >> 2, t = lane & 3;
  const int tiles = (L + 15) / 16;
  float* Ks = smem;                                // (Lp, LD)
  float* Vs = Ks + Lp * LD;                        // (Lp, LD)
  float* W = Vs + Lp * LD + warp * 16 * LD;        // this warp's 16 q rows
  const float* base = qkv + (size_t)b * L * C3 + h * DH;
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
    for (int i = lane; i < 16 * DH; i += 32) W[i / DH * LD + i % DH] *= scale;
    __syncwarp();
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
      nt1<KC, DH>(p, W, Ks, LD, 0, 8 * c, lane);   // S = (q scale) k^T
      if (c + KC == NT) {
        __syncwarp();                              // q is read: stage the next
        stage_q(tile + warps);
      }

      // softmax over the keys < L: -inf before the max, so p = 0 past L
      float cm[2] = {mx[0], mx[1]};
#pragma unroll
      for (int j = 0; j < KC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * (c + j) + 2 * t + (e & 1);
          if (key >= L) p[j][e] = -INFINITY;
          cm[e >> 1] = fmaxf(cm[e >> 1], p[j][e]);
        }
      if (c > 0) {
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          cm[r] = quad_max(cm[r]);
          alpha[r] = expf(mx[r] - cm[r]);
          sum[r] *= alpha[r];
        }
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      } else {
        cm[0] = quad_max(cm[0]);
        cm[1] = quad_max(cm[1]);
      }
      mx[0] = cm[0];
      mx[1] = cm[1];
#pragma unroll
      for (int j = 0; j < KC; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[j][e] = expf(p[j][e] - mx[e >> 1]);
          sum[e >> 1] += p[j][e];
        }
        FragA a;
        from_c(a, p[j]);
        nn_add<NN>(acc, a, Vs, LD, 8 * (c + j), 0, lane);  // O += P V
      }
    }
    const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + g + 8 * r;
      if (row < L) {
        float* o = out + ((size_t)b * L + row) * C + h * DH + 2 * t;
#pragma unroll
        for (int n = 0; n < NN; ++n)
          *reinterpret_cast<float2*>(o + 8 * n) = make_float2(
              acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
      }
    }
    cp_wait<0>();
    __syncwarp();                                  // the next q rows are in W
  }
}

// Backward pass 1: dQ rows, and each row's log-sum-exp and delta. K and V
// of the head sit in shared memory ((8 NT, DH+4), zero rows past L); a
// warp stages its 16 q rows, keeps the whole row of S (then P) in
// registers (NT = key_tiles(L) n tiles of 8 keys), stages its dO rows
// over the q rows, and recomputes dP in chunks of CH n tiles twice: once
// for delta = rowsum(P o dP), once for dS = P o (dP - delta), which goes
// straight from the accumulators into dQ = dS K.
template <int DH, int NT>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    slab_bwd_dq_kernel(const float* __restrict__ qkv,
                       const float* __restrict__ dout,
                       float* __restrict__ dqkv, float* __restrict__ lse,
                       float* __restrict__ delta, int L, int H,
                       float scale) {
  using namespace tf32x3;
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = DH + 4, NN = DH / 8, CH = 4, Lp = 8 * NT;
  const int C = H * DH, C3 = 3 * C;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32, g = lane >> 2, t = lane & 3;
  const int tiles = (L + 15) / 16;
  float* Ks = smem;                                // (Lp, LD)
  float* Vs = Ks + Lp * LD;                        // (Lp, LD)
  float* W = Vs + Lp * LD + warp * 16 * LD;        // 16 q rows, then dO
  const float* base = qkv + (size_t)b * L * C3 + h * DH;
  const float* obase = dout + (size_t)b * L * C + h * DH;
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
    nt1<NT, DH>(p, W, Ks, LD, 0, 0, lane);         // S = q k^T
    __syncwarp();                                  // q is read: load dO
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
    __syncwarp();                                  // dO is in W

    // delta = rowsum(P o dP)
    float dl[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NT / CH; ++c) {
      float dp[CH][4] = {};
      nt1<CH, DH>(dp, W, Vs, LD, 0, 8 * CH * c, lane);
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
      nt1<CH, DH>(dp, W, Vs, LD, 0, 8 * CH * c, lane);
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = CH * c + jj;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = p[j][e] * (dp[jj][e] - dl[e >> 1]);
        FragA a;
        from_c(a, ds);
        nn<NN>(acc, a, Ks, LD, 8 * j, 0, lane);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + g + 8 * r;
      if (row < L) {
        float* dq = dqkv + ((size_t)b * L + row) * C3 + h * DH + 2 * t;
#pragma unroll
        for (int n = 0; n < NN; ++n)
          *reinterpret_cast<float2*>(dq + 8 * n) = make_float2(
              acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
        if (t == 0) {
          const size_t i = ((size_t)b * H + h) * L + row;
          lse[i] = mx[r] + logf(sum[r]);
          delta[i] = dl[r];
        }
      }
    }
    __syncwarp();                                  // W is restaged next
  }
}

// Backward pass 2: dK and dV rows, P recomputed from the log-sum-exp. Q
// and dO of the head ((Lp, DH+4), Lp = 8 key_tiles(L), zero rows past L)
// and its lse and delta sit in shared memory; a warp holds its 16 key rows of k and v as A fragments in
// registers (read once from the slab) and walks the queries in chunks of
// CH n tiles: S^T = k q^T and dP^T = v dO^T, P^T and dS^T on the
// accumulators, then dV += P^T dO and dK += dS^T Q from them.
template <int DH>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    slab_bwd_dkv_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ dout,
                        float* __restrict__ dqkv,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, int L, int H,
                        float scale) {
  using namespace tf32x3;
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = DH + 4, NN = DH / 8, KS = DH / 8, CH = 2;
  const int C = H * DH, C3 = 3 * C;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32, g = lane >> 2, t = lane & 3;
  const int Lp = Lp_of(L), nt = Lp / 8, tiles = (L + 15) / 16;
  float* Qs = smem;                                // (Lp, LD)
  float* Os = Qs + Lp * LD;                        // (Lp, LD)
  float* LSE = Os + Lp * LD;                       // (Lp)
  float* DEL = LSE + Lp;                           // (Lp)
  const float* base = qkv + (size_t)b * L * C3 + h * DH;
  const float* obase = dout + (size_t)b * L * C + h * DH;
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
    float ka[KS][4], va[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + g + 8 * (i & 1);
        const float* src =
            base + (size_t)row * C3 + 8 * ks + t + 4 * (i >> 1);
        ka[ks][i] = row < L ? src[C] : 0.f;
        va[ks][i] = row < L ? src[2 * C] : 0.f;
      }
    float dk[NN][4] = {}, dv[NN][4] = {};
    for (int j0 = 0; j0 < nt; j0 += CH) {
      float s[CH][4] = {}, dp[CH][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        FragA a, a2;
        split_a(a, ka[ks]);
        split_a(a2, va[ks]);
#pragma unroll
        for (int jj = 0; jj < CH; ++jj) {
          FragB b;
          load_b_nt(b, Qs, LD, 8 * (j0 + jj), 8 * ks, lane);
          mma3(s[jj], a, b);
          load_b_nt(b, Os, LD, 8 * (j0 + jj), 8 * ks, lane);
          mma3(dp[jj], a2, b);
        }
      }
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = j0 + jj;
        float pr[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 8 * j + 2 * t + (e & 1);
          pr[e] = q < L ? expf(s[jj][e] * scale - LSE[q]) : 0.f;
          ds[e] = pr[e] * (dp[jj][e] - DEL[q]);
        }
        FragA pa, da;
        from_c(pa, pr);
        from_c(da, ds);
        nn<NN>(dv, pa, Os, LD, 8 * j, 0, lane);
        nn<NN>(dk, da, Qs, LD, 8 * j, 0, lane);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + g + 8 * r;
      if (row < L) {
        float* d = dqkv + ((size_t)b * L + row) * C3 + h * DH + 2 * t;
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          *reinterpret_cast<float2*>(d + C + 8 * n) = make_float2(
              dk[n][2 * r] * scale, dk[n][2 * r + 1] * scale);
          *reinterpret_cast<float2*>(d + 2 * C + 8 * n) =
              make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
        }
      }
    }
  }
}

// The forward and the dQ pass: K and V, and 16 rows a warp.
size_t fwd_smem(int L, int DH) {
  const int lp = Lp_of(L), ld = DH + 4;
  return sizeof(float) * (2 * lp * ld + block_warps(L) * 16 * ld);
}

size_t dkv_smem(int L, int DH) {
  const int lp = Lp_of(L), ld = DH + 4;
  return sizeof(float) * (2 * lp * ld + 2 * lp);
}

// The forward and the dQ pass instantiated for L's key tiles.
template <int DH>
auto fwd_kernel(int L) {
  switch (key_tiles(L)) {
    case 8: return slab_fwd_kernel<DH, 8>;
    case 16: return slab_fwd_kernel<DH, 16>;
    case 20: return slab_fwd_kernel<DH, 20>;
    default: return slab_fwd_kernel<DH, 32>;
  }
}

template <int DH>
auto dq_kernel(int L) {
  switch (key_tiles(L)) {
    case 8: return slab_bwd_dq_kernel<DH, 8>;
    case 16: return slab_bwd_dq_kernel<DH, 16>;
    case 20: return slab_bwd_dq_kernel<DH, 20>;
    default: return slab_bwd_dq_kernel<DH, 32>;
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
  out[2] = resident(slab_bwd_dkv_kernel<DH>, threads, dkv_smem(L, DH));
  out[3] = threads;
}

template <int DH>
int fwd(const float* qkv, float* out, int B, int L, int H,
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
int bwd(const float* qkv, const float* dout, float* dqkv, float* lse,
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
  err = set_smem(slab_bwd_dkv_kernel<DH>, smem);
  if (err != cudaSuccess) return (int)err;
  slab_bwd_dkv_kernel<DH><<<B * H, threads, smem, stream>>>(
      qkv, dout, dqkv, lse, delta, L, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv (B, L, 3 H DH) -> out (B, L, H DH).
int ertdx_slab_fwd(const float* qkv, float* out, int B, int L, int H, int DH,
                   void* stream) {
  if (!shape_ok(B, L, H, DH)) return (int)cudaErrorInvalidValue;
  // the kernels stage rows with 16-byte cp.async
  if ((uintptr_t)qkv & 15) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  return DH == 32 ? fwd<32>(qkv, out, B, L, H, s)
                  : fwd<64>(qkv, out, B, L, H, s);
}

// qkv (B, L, 3 H DH), dout (B, L, H DH) -> dqkv (B, L, 3 H DH); lse and
// delta are (B, H, L) scratch written by the first pass.
int ertdx_slab_bwd(const float* qkv, const float* dout, float* dqkv,
                   float* lse, float* delta, int B, int L, int H, int DH,
                   void* stream) {
  if (!shape_ok(B, L, H, DH)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)qkv | (uintptr_t)dout) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  return DH == 32 ? bwd<32>(qkv, dout, dqkv, lse, delta, B, L, H, s)
                  : bwd<64>(qkv, dout, dqkv, lse, delta, B, L, H, s);
}

// Resident blocks per SM of the forward, dQ and dK/dV kernels at (L, DH),
// written to out[0..2] (-1 where the query fails), and the threads of a
// block of each, to out[3].
int ertdx_slab_blocks_per_sm(int L, int DH, int* out) {
  if (!shape_ok(1, L, 1, DH)) return (int)cudaErrorInvalidValue;
  if (DH == 32)
    occupancy<32>(L, out);
  else
    occupancy<64>(L, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
