// Flash attention with a key mask, forward and backward (sm_90a; every
// product on the 3xTF32 tensor-core tile of tf32x3.cuh).
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
// Key tiles that are all padding. Where a batch row has a valid key, a
// key tile whose mask entries are all <= 0 adds nothing, exactly:
//   * forward: once a valid key has made the running max m finite, such
//     a tile has p = exp(s - 1e30 - m) = 0 and alpha = 1; one before the
//     first valid tile is zeroed by that tile's alpha = exp(-1e30 - m) =
//     0. So out and lse of a live row are the function of its valid keys
//     alone;
//   * backward: lse is finite, so p = exp(s scale - 1e30 - lse) = 0 and
//     dS = 0 against every query: the tile adds nothing to dQ, and its dK
//     and dV rows are 0.
// The forward and dQ kernels skip such tiles, and a dK/dV block whose key
// tile is one writes zeros and returns, and so does a warp whose 16 keys
// are all padding; each block decides from the (B, Lk) mask itself. A
// batch row with no valid key keeps every tile (the uniform mean, p = 1).
// On the encoder's flash shape (147 of 256 keys valid) at DH=64 the
// forward and the dQ kernel skip 3 of their 8 key tiles of 32, and the
// dK/dV kernel 1 of its 4 blocks of 64 keys and 2 of the 4 warps of
// another: 6 of 16 key rows of 16 in all three.
//
// What bounds it on an H100: bytes in the forward and dQ, operations in
// dK/dV. At the encoder's flash shape (B H = 1024, L = 256 padded from
// 147, DH = 64), counting every query row against the 147 valid keys the
// mask leaves, the forward reads q, k, v and writes o and lse, 213 MB,
// 0.064 ms at 3.35 TB/s, against 2 products of 4.9 GFLOP, 29.6 GFLOP as
// 3xTF32 (0.060 ms at 495 TFLOP/s); dQ moves 348 MB (0.104 ms) for 3
// products, dK/dV 4 products of 4.9 GFLOP, 59 GFLOP as 3xTF32 (0.120 ms).
// On the fp32 pipe (67 TFLOP/s) the forward's products alone would take
// 0.147 ms.
//
// What the design does about it, and what it changes from the TPU kernel:
//   * The TPU kernel keeps a whole (Lk, DH) K and V of one (b, h) in VMEM
//     (and the dK/dV kernel a whole Q and dO). Here every loop is tiled
//     over shared-memory tiles of 16 to 64 rows, so any L fits; the tile
//     sizes (FwdTiles<DH>, BwdTiles<DH> below) are chosen per head width
//     to keep the accumulators in registers and one to four blocks
//     resident per SM.
//   * Every product runs on the 3xTF32 tile of tf32x3.cuh: warp-level
//     mma.sync m16n8k8, each operand split into two TF32 halves, three
//     MMAs a k step; fp32-class results, as the TPU kernel's
//     Precision.HIGHEST. A warp owns 16 rows of its block's output. The
//     forward keeps its running max, sum and rescale factor per fragment
//     row in registers (quad shuffles, no shared-memory round trip) and
//     feeds P to O += P V from the S accumulators, each k step's MMAs
//     summed from zero and added to O in fp32 (tf32x3::nn_add: O runs
//     over every kept key, and the MMA's own accumulation drifts further
//     from the fp32 plain version than training's gates allow); the
//     backward computes P and dS on the S and dP accumulators and feeds
//     dQ, dV and dK from there. Tiles are staged with 16-byte cp.async,
//     the next one while the current one is computed; the wrappers
//     refuse operands that do not start on a 16-byte boundary.
//   * The forward (a block per 64 query rows, looping over the kept key
//     tiles) writes o and lse. The backward is two launches: dQ (a block
//     per query tile, looping over key tiles; it also computes delta and
//     writes it out) and then dK/dV (a block per key tile, looping over
//     query tiles, reading delta). Each block owns its outputs: no
//     atomics, so reruns are bit-identical.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "tf32x3.cuh"

namespace {

constexpr float NEG = -1e30f;          // the TPU kernel's mask bias

// Every kernel runs its products on the 3xTF32 tensor-core tile of
// tf32x3.cuh with 4 warps (128 threads) a block; a warp owns 16 rows of
// its block's outputs. Shared tiles have rows of DH+4 floats.
constexpr int THREADS = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Which key tiles of BK keys of a batch row's (Lk) mask hold a valid key,
// into keep[] (one byte a tile), by the block's warps; returns whether
// any does. A block whose batch row has none keeps every tile.
template <int BK>
__device__ bool find_kept(const float* mg, int tiles, unsigned char* keep) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int any = 0;
  for (int kt = warp; kt < tiles; kt += THREADS / 32) {
    int a = 0;
    for (int c = lane; c < BK; c += 32) a |= mg[kt * BK + c] > 0.f;
    a = __any_sync(tf32x3::FULL, a);
    if (lane == 0) keep[kt] = (unsigned char)a;
    any |= a;
  }
  return __syncthreads_or(any);
}

// The key tile of the forward per head width. 32 keys at DH = 64 and 128
// skip 3 of 8 tiles on the flash arm's shape (147 of 256 keys valid); at
// DH = 256 a warp's O accumulator alone is 16 x 256 floats, 128
// registers a thread, so 8 keys keep S small beside it (with 16, ptxas
// spills). No column split across warps: it would compute S twice.
template <int DH> struct FwdTiles { static constexpr int BK = 32; };
template <> struct FwdTiles<256> { static constexpr int BK = 8; };

template <int DH, int BK>
size_t fwd_smem(int Lk) {
  return sizeof(float) * ((64 + 4 * BK) * (DH + 4) + 2 * BK) +
         (size_t)(Lk / BK + 15) / 16 * 16;
}

// grid (B H, Lq / 64): one block per (batch row and head, tile of 64
// query rows), a warp per 16 rows. Loops over the key tiles that hold a
// valid key (all of them for a batch row with none), staging K, V and the
// mask of the next kept tile with cp.async while it computes on the
// current one: S = (q scale) k^T, the bias, the online softmax (m, l and
// alpha per fragment row in registers), and O += P V from the S
// fragments.
template <int DH, int BK>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ mask, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Lq, int Lk,
                     float scale) {
  using namespace tf32x3;
  constexpr int LD = DH + 4, BQ = 64, NB = BK / 8, NN = DH / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // BQ x LD
  float* KV = Qs + BQ * LD;               // 2 stages x (K, V): BK x LD each
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

  stage<DH>(Qs, LD, q + row0 * DH, DH, BQ, BQ, 0, THREADS);
  cp_commit();
  const bool live = find_kept<BK>(mg, tiles, keep);
  auto next = [&](int kt) {
    for (++kt; kt < tiles && live && !keep[kt]; ++kt) {
    }
    return kt;
  };
  auto load = [&](int kt, int st) {
    float* Ks = KV + st * 2 * BK * LD;
    stage<DH>(Ks, LD, kg + (size_t)kt * BK * DH, DH, BK, BK, 0, THREADS);
    stage<DH>(Ks + BK * LD, LD, vg + (size_t)kt * BK * DH, DH, BK, BK, 0,
              THREADS);
    for (int i = tid; i < BK / 4; i += THREADS)
      cp16(Ms + st * BK + 4 * i, mg + kt * BK + 4 * i, true);
  };
  int kt = next(-1);
  load(kt, 0);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  // q scale, as the TPU kernel: each warp scales the rows it reads
  for (int i = lane; i < 16 * DH; i += 32)
    Qs[(m0 + i / DH) * LD + i % DH] *= scale;
  __syncwarp();

  // running max and sum of rows g and g+8 (the sum per thread, over its
  // columns: alpha is the quad's, so the quad adds them up at the end)
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
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
    float s[NB][4] = {};
    nt1<NB, DH>(s, Qs, Ks, LD, m0, 0, lane);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] += bm[8 * j + 2 * t + (e & 1)] > 0.f ? 0.f : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
      FragA a;
      from_c(a, s[j]);
      nn_add<NN>(acc, a, Vs, LD, 8 * j, 0, lane);  // O += P V
    }
    __syncthreads();                  // stage st is refilled next
    kt = nx;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = fmaxf(quad_sum(l[r]), 1e-30f);
    const size_t row = row0 + m0 + g + 8 * r;
    float* d = o + row * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < NN; ++n)
      *reinterpret_cast<float2*>(d + 8 * n) =
          make_float2(acc[n][2 * r] / lr, acc[n][2 * r + 1] / lr);
    if (t == 0) lse[row] = m[r] + logf(lr);
  }
}

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

  stage<DH>(Qs, LD, q + row0 * DH, DH, BQ, BQ, 0, THREADS);
  stage<DH>(dOs, LD, dout + row0 * DH, DH, BQ, BQ, 0, THREADS);
  cp_commit();
  const bool live = find_kept<BK>(mg, tiles, keep);
  auto next = [&](int kt) {
    for (++kt; kt < tiles && live && !keep[kt]; ++kt) {
    }
    return kt;
  };
  auto load = [&](int kt, int st) {
    float* Ks = KV + st * 2 * BK * LD;
    stage<DH>(Ks, LD, kg + (size_t)kt * BK * DH, DH, BK, BK, 0,
              THREADS);
    stage<DH>(Ks + BK * LD, LD, vg + (size_t)kt * BK * DH, DH, BK, BK, 0,
              THREADS);
    for (int i = tid; i < BK / 4; i += THREADS)
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
  for (int i = tid; i < Lk; i += THREADS) {
    const int valid = mg[i] > 0.f;
    row_any |= valid;
    if (i >= k0 && i < k0 + BK) tile_any |= valid;
  }
  tile_any = __syncthreads_or(tile_any);
  row_any = __syncthreads_or(row_any);
  if (!tile_any && row_any) {
    for (int i = tid; i < BK * DH / 4; i += THREADS) {
      reinterpret_cast<float4*>(dk + krow0 * DH)[i] = make_float4(0, 0, 0, 0);
      reinterpret_cast<float4*>(dv + krow0 * DH)[i] = make_float4(0, 0, 0, 0);
    }
    return;
  }

  auto load = [&](int qt, int st) {
    float* Qs = QS + st * STAGE;
    const size_t r0 = (size_t)bh * Lq + qt * BQ;
    stage<DH>(Qs, LD, q + r0 * DH, DH, BQ, BQ, 0, THREADS);
    stage<DH>(Qs + BQ * LD, LD, dout + r0 * DH, DH, BQ, BQ, 0, THREADS);
    for (int i = tid; i < BQ / 4; i += THREADS) {
      cp16(Qs + 2 * BQ * LD + 4 * i, lse + r0 + 4 * i, true);
      cp16(Qs + 2 * BQ * LD + BQ + 4 * i, delta + r0 + 4 * i, true);
    }
  };
  stage<DH>(Ks, LD, k + krow0 * DH, DH, BK, BK, 0, THREADS);
  stage<DH>(Vs, LD, v + krow0 * DH, DH, BK, BK, 0, THREADS);
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
  constexpr int BK = FwdTiles<DH>::BK;
  const size_t bytes = fwd_smem<DH, BK>(Lk);
  auto kern = flash_fwd_kernel<DH, BK>;
  cudaError_t err = set_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(BH, Lq / 64), THREADS, bytes, s>>>(q, k, v, mask, o, lse, H,
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
  kern<<<dim3(BH, Lq / 64), THREADS, bytes, s>>>(
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
  kern<<<dim3(BH, Lk / (64 / T::CS)), THREADS, bytes, s>>>(
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
  // the kernels stage their tiles with 16-byte cp.async
  if (!aligned16({q, k, v, mask})) return (int)cudaErrorMisalignedAddress;
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

// Keys of one skip of all-padding keys at DH, written to out[0..2]: the
// forward's key tile, the dQ kernel's key tile and a dK/dV warp's rows
// (16, the MMA's m).
int ertdx_flash_skip_tiles(int DH, int* out) {
  switch (DH) {
    case 64: out[0] = FwdTiles<64>::BK; out[1] = BwdTiles<64>::BK; break;
    case 128: out[0] = FwdTiles<128>::BK; out[1] = BwdTiles<128>::BK; break;
    case 256: out[0] = FwdTiles<256>::BK; out[1] = BwdTiles<256>::BK; break;
    default: return (int)cudaErrorInvalidValue;
  }
  out[2] = 16;
  return 0;
}

}  // extern "C"
