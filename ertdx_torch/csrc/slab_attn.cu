// Packed-head slab attention, forward and backward (sm_90a, fp32 FMA).
//
// Replaces the TPU kernels of ertdx/ops/slab_attn.py:
//   * slab_fwd_kernel            <- _slab_fwd_kernel (:147-168)
//   * slab_bwd_dq_kernel and
//     slab_bwd_dkv_kernel        <- _slab_bwd_kernel (:184-222)
// Input is the fused QKV slab (B, L, 3C) as the encoder's Dense emits it:
// q at lanes [0, C), k at [C, 2C), v at [2C, 3C); head h owns lanes
// [h dh, (h+1) dh) of each third. The forward writes softmax(q k^T /
// sqrt(dh)) v per head into (B, L, C); the backward writes dQ | dK | dV
// into (B, L, 3C) in the same layout, with the JAX kernel's math:
// dS = P o (dP - rowsum(dP o P)), dQ = dS K scale, dK = dS^T Q scale,
// dV = P^T dO. No (B, H, L, dh) tensor and no logit matrix ever reaches
// device memory.
//
// What bounds it on an H100: operations. At the encoder's training shape
// (B=256, L=147, C=256, H=4, dh=64) the forward does 4 B H L^2 dh = 5.7
// GFLOP against 154 MB of traffic, the backward 10 B H L^2 dh = 14.2 GFLOP
// against 270 MB: 0.085 and 0.211 ms at 67 TFLOP/s fp32.
//
// What the design does about it, and what it changes from the TPU kernel:
//   * Exact per-head attention. The TPU's block-diagonal head groups
//     (_packed_kv, _diag_blocks) exist only to fill 128 MXU lanes and are
//     not carried over: no masked logits are computed.
//   * Grid: one CUDA block per (batch row, head, tile of 64 rows); 3,072
//     blocks at the training shape. Each block holds the two L x dh
//     operands it streams over (K and V, or Q and dO) in shared memory,
//     rows padded to dh+1 floats so that 32 lanes reading 32 rows hit 32
//     banks.
//   * The inner loops are bound by shared-memory bandwidth (128 bytes per
//     clock per SM), not by the FMA units, so every value read from
//     shared memory serves R = 4 rows: a warp owns 4 rows at a time, their
//     q (or k) values sit in shared memory as [dh][4] and arrive as one
//     16-byte broadcast, and the lanes split the L logits of all 4 rows.
//     Warp shuffles reduce max and sum; the 4 rows' logits live in a
//     per-warp [L][4] buffer, and the lanes then split dh for the P V-type
//     products, each V value serving 4 rows.
//   * The backward is two launches. A block that owned all of Q, K, V and
//     dO of one head, plus the dK and dV accumulators, would need over
//     220 KB of shared memory at L=147, dh=64, i.e. one block per SM. So
//     a dQ pass (K, V resident; query rows) also writes each row's
//     log-sum-exp and delta = rowsum(dP o P) to a (B, H, L) scratch, and a
//     dK/dV pass (Q, dO resident; key rows) recomputes P from the
//     log-sum-exp. Each pass owns its outputs outright: no atomics,
//     deterministic results.
//   * Every product is an fp32 FMA on the CUDA cores; `accurate` has no
//     effect until a tensor-core version exists.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;               // rows of one block
constexpr int R = 4;                   // rows a warp owns at a time
constexpr int L_MAX = 256;             // longest sequence the kernels take
constexpr int NJ = L_MAX / 32;         // logits of one row per lane, at most

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

__device__ __forceinline__ float get(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// Copy one head's (L, DH) third of the slab into a padded shared tile,
// scaled by `mul`.
template <int DH>
__device__ void load_head(float* dst, const float* src, int L, int stride,
                          float mul) {
  for (int e = threadIdx.x; e < L * DH; e += THREADS) {
    const int i = e / DH, d = e % DH;
    dst[i * (DH + 1) + d] = src[(size_t)i * stride + d] * mul;
  }
}

// Stage `nr` <= R rows of one head (row stride `stride`) as a [DH][R] tile
// for 16-byte broadcasts; rows past nr are zero. Called by a whole warp.
template <int DH>
__device__ void stage_rows(float* dst, const float* src, int nr, int stride,
                           float mul, int lane) {
  for (int e = lane; e < R * DH; e += 32) {
    const int r = e / DH, d = e % DH;
    dst[d * R + r] = r < nr ? src[(size_t)r * stride + d] * mul : 0.f;
  }
  __syncwarp();
}

// acc[r][u] = sum_j w[j][r] M[j][lane + 32 u]: the P V-type product of a
// warp's 4 rows against the L rows of a padded (L, DH+1) shared tile.
template <int DH>
__device__ __forceinline__ void rows_times(const float4* w, const float* M,
                                           int L, int lane,
                                           float (&acc)[R][DH / 32]) {
  constexpr int LD = DH + 1;
  constexpr int U = DH / 32;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int u = 0; u < U; ++u) acc[r][u] = 0.f;
  for (int j = 0; j < L; ++j) {
    const float4 wj = w[j];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float m = M[j * LD + lane + 32 * u];
      acc[0][u] = fmaf(wj.x, m, acc[0][u]);
      acc[1][u] = fmaf(wj.y, m, acc[1][u]);
      acc[2][u] = fmaf(wj.z, m, acc[2][u]);
      acc[3][u] = fmaf(wj.w, m, acc[3][u]);
    }
  }
}

struct Geometry {
  int b, h, r0, r1;
};

__device__ Geometry geometry(int L, int H) {
  const int tiles = (L + TILE - 1) / TILE;
  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  Geometry g;
  g.h = bh % H;
  g.b = bh / H;
  g.r0 = tile * TILE;
  g.r1 = min(L, g.r0 + TILE);
  return g;
}

// In each kernel's shared memory the 16-byte arrays come first, so that
// they stay aligned.
template <int DH>
__global__ void __launch_bounds__(THREADS)
    slab_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                    int L, int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = DH + 1;
  constexpr int U = DH / 32;
  const int C = H * DH, C3 = 3 * C;
  const Geometry g = geometry(L, H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4* p = reinterpret_cast<float4*>(smem) + warp * L;   // (L) x 4 rows
  float* qs = smem + WARPS * L * R + warp * DH * R;         // (DH) x 4
  float* Ks = smem + WARPS * L * R + WARPS * DH * R;        // (L, LD)
  float* Vs = Ks + L * LD;                                  // (L, LD)
  const float* base = qkv + (size_t)g.b * L * C3 + g.h * DH;
  load_head<DH>(Ks, base + C, L, C3, 1.0f);
  load_head<DH>(Vs, base + 2 * C, L, C3, 1.0f);
  __syncthreads();

  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  for (int r0 = g.r0 + warp * R; r0 < g.r1; r0 += WARPS * R) {
    const int nr = min(R, g.r1 - r0);
    stage_rows<DH>(qs, base + (size_t)r0 * C3, nr, C3, scale, lane);
    float mx[R] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int j = lane; j < L; j += 32) {
      const float* kr = Ks + j * LD;
      float s[R] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        const float kd = kr[d];
        const float4 q = qs4[d];
        s[0] = fmaf(q.x, kd, s[0]);
        s[1] = fmaf(q.y, kd, s[1]);
        s[2] = fmaf(q.z, kd, s[2]);
        s[3] = fmaf(q.w, kd, s[3]);
      }
      p[j] = make_float4(s[0], s[1], s[2], s[3]);
#pragma unroll
      for (int r = 0; r < R; ++r) mx[r] = fmaxf(mx[r], s[r]);
    }
    float sum[R] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = warp_max(mx[r]);
    for (int j = lane; j < L; j += 32) {
      const float4 s = p[j];
      const float4 e = make_float4(expf(s.x - mx[0]), expf(s.y - mx[1]),
                                   expf(s.z - mx[2]), expf(s.w - mx[3]));
      p[j] = e;
      sum[0] += e.x;
      sum[1] += e.y;
      sum[2] += e.z;
      sum[3] += e.w;
    }
    __syncwarp();
    float acc[R][U];
    rows_times<DH>(p, Vs, L, lane, acc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float inv = 1.f / warp_sum(sum[r]);
      if (r < nr) {
        float* o = out + ((size_t)g.b * L + r0 + r) * C + g.h * DH;
#pragma unroll
        for (int u = 0; u < U; ++u) o[lane + 32 * u] = acc[r][u] * inv;
      }
    }
    __syncwarp();
  }
}

// Backward pass 1: dQ rows, and each row's log-sum-exp and delta. A lane's
// dP values (at most NJ per row) stay in registers while the rows' deltas
// are reduced.
template <int DH>
__global__ void __launch_bounds__(THREADS)
    slab_bwd_dq_kernel(const float* __restrict__ qkv,
                       const float* __restrict__ dout,
                       float* __restrict__ dqkv, float* __restrict__ lse,
                       float* __restrict__ delta, int L, int H,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = DH + 1;
  constexpr int U = DH / 32;
  const int C = H * DH, C3 = 3 * C;
  const Geometry g = geometry(L, H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4* p = reinterpret_cast<float4*>(smem) + warp * L;   // P, then dS
  float* qs = smem + WARPS * L * R + warp * DH * R;         // q * scale
  float* os = smem + WARPS * L * R + WARPS * DH * R + warp * DH * R;
  float* Ks = smem + WARPS * L * R + 2 * WARPS * DH * R;    // (L, LD)
  float* Vs = Ks + L * LD;                                  // (L, LD)
  const float* base = qkv + (size_t)g.b * L * C3 + g.h * DH;
  const float* obase = dout + (size_t)g.b * L * C + g.h * DH;
  load_head<DH>(Ks, base + C, L, C3, 1.0f);
  load_head<DH>(Vs, base + 2 * C, L, C3, 1.0f);
  __syncthreads();

  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  const float4* os4 = reinterpret_cast<const float4*>(os);
  for (int r0 = g.r0 + warp * R; r0 < g.r1; r0 += WARPS * R) {
    const int nr = min(R, g.r1 - r0);
    stage_rows<DH>(qs, base + (size_t)r0 * C3, nr, C3, scale, lane);
    stage_rows<DH>(os, obase + (size_t)r0 * C, nr, C, 1.0f, lane);
    float mx[R] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    float dp[NJ][R];
#pragma unroll
    for (int m = 0; m < NJ; ++m) {
      const int j = lane + 32 * m;
      if (j < L) {
        const float* kr = Ks + j * LD;
        const float* vr = Vs + j * LD;
        float s[R] = {0.f, 0.f, 0.f, 0.f}, t[R] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          const float kd = kr[d], vd = vr[d];
          const float4 q = qs4[d], o = os4[d];
          s[0] = fmaf(q.x, kd, s[0]);
          s[1] = fmaf(q.y, kd, s[1]);
          s[2] = fmaf(q.z, kd, s[2]);
          s[3] = fmaf(q.w, kd, s[3]);
          t[0] = fmaf(o.x, vd, t[0]);
          t[1] = fmaf(o.y, vd, t[1]);
          t[2] = fmaf(o.z, vd, t[2]);
          t[3] = fmaf(o.w, vd, t[3]);
        }
        p[j] = make_float4(s[0], s[1], s[2], s[3]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          dp[m][r] = t[r];
          mx[r] = fmaxf(mx[r], s[r]);
        }
      }
    }
    float sum[R] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = warp_max(mx[r]);
#pragma unroll
    for (int m = 0; m < NJ; ++m) {
      const int j = lane + 32 * m;
      if (j < L) {
        const float4 s = p[j];
        const float4 e = make_float4(expf(s.x - mx[0]), expf(s.y - mx[1]),
                                     expf(s.z - mx[2]), expf(s.w - mx[3]));
        p[j] = e;
        sum[0] += e.x;
        sum[1] += e.y;
        sum[2] += e.z;
        sum[3] += e.w;
      }
    }
    float inv[R], dl[R] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sum[r] = warp_sum(sum[r]);
      inv[r] = 1.f / sum[r];
    }
#pragma unroll
    for (int m = 0; m < NJ; ++m) {
      const int j = lane + 32 * m;
      if (j < L) {
        const float4 e = p[j];
#pragma unroll
        for (int r = 0; r < R; ++r)
          dl[r] = fmaf(get(e, r) * inv[r], dp[m][r], dl[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) dl[r] = warp_sum(dl[r]);
#pragma unroll
    for (int m = 0; m < NJ; ++m) {
      const int j = lane + 32 * m;
      if (j < L) {
        const float4 e = p[j];
        float ds[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          ds[r] = get(e, r) * inv[r] * (dp[m][r] - dl[r]);
        p[j] = make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
    }
    __syncwarp();
    float acc[R][U];
    rows_times<DH>(p, Ks, L, lane, acc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        float* dq = dqkv + ((size_t)g.b * L + r0 + r) * C3 + g.h * DH;
#pragma unroll
        for (int u = 0; u < U; ++u) dq[lane + 32 * u] = acc[r][u] * scale;
        if (lane == 0) {
          const size_t row = ((size_t)g.b * H + g.h) * L + r0 + r;
          lse[row] = mx[r] + logf(sum[r]);
          delta[row] = dl[r];
        }
      }
    }
    __syncwarp();
  }
}

// Backward pass 2: dK and dV rows, P recomputed from the log-sum-exp.
template <int DH>
__global__ void __launch_bounds__(THREADS)
    slab_bwd_dkv_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ dout,
                        float* __restrict__ dqkv,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, int L, int H,
                        float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = DH + 1;
  constexpr int U = DH / 32;
  const int C = H * DH, C3 = 3 * C;
  const Geometry g = geometry(L, H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4* p = reinterpret_cast<float4*>(smem) + warp * L;             // P
  float4* ds = reinterpret_cast<float4*>(smem) + (WARPS + warp) * L;  // dS
  float* ks = smem + 2 * WARPS * L * R + warp * DH * R;
  float* vs = smem + 2 * WARPS * L * R + WARPS * DH * R + warp * DH * R;
  float* Qs = smem + 2 * WARPS * L * R + 2 * WARPS * DH * R;  // q * scale
  float* Os = Qs + L * LD;                                    // dO
  float* LSE = Os + L * LD;                                   // (L)
  float* DEL = LSE + L;                                       // (L)
  const float* base = qkv + (size_t)g.b * L * C3 + g.h * DH;
  const float* obase = dout + (size_t)g.b * L * C + g.h * DH;
  const size_t row0 = ((size_t)g.b * H + g.h) * L;
  load_head<DH>(Qs, base, L, C3, scale);
  load_head<DH>(Os, obase, L, C, 1.0f);
  for (int i = threadIdx.x; i < L; i += THREADS) {
    LSE[i] = lse[row0 + i];
    DEL[i] = delta[row0 + i];
  }
  __syncthreads();

  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const float4* vs4 = reinterpret_cast<const float4*>(vs);
  for (int j0 = g.r0 + warp * R; j0 < g.r1; j0 += WARPS * R) {
    const int nr = min(R, g.r1 - j0);
    stage_rows<DH>(ks, base + (size_t)j0 * C3 + C, nr, C3, 1.0f, lane);
    stage_rows<DH>(vs, base + (size_t)j0 * C3 + 2 * C, nr, C3, 1.0f, lane);
    for (int i = lane; i < L; i += 32) {
      const float* qr = Qs + i * LD;
      const float* orow = Os + i * LD;
      float s[R] = {0.f, 0.f, 0.f, 0.f}, t[R] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        const float qd = qr[d], od = orow[d];
        const float4 k = ks4[d], v = vs4[d];
        s[0] = fmaf(qd, k.x, s[0]);
        s[1] = fmaf(qd, k.y, s[1]);
        s[2] = fmaf(qd, k.z, s[2]);
        s[3] = fmaf(qd, k.w, s[3]);
        t[0] = fmaf(od, v.x, t[0]);
        t[1] = fmaf(od, v.y, t[1]);
        t[2] = fmaf(od, v.z, t[2]);
        t[3] = fmaf(od, v.w, t[3]);
      }
      float pr[R], dsr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pr[r] = expf(s[r] - LSE[i]);
        dsr[r] = pr[r] * (t[r] - DEL[i]);
      }
      p[i] = make_float4(pr[0], pr[1], pr[2], pr[3]);
      ds[i] = make_float4(dsr[0], dsr[1], dsr[2], dsr[3]);
    }
    __syncwarp();
    float dv[R][U], dk[R][U];
    rows_times<DH>(p, Os, L, lane, dv);
    rows_times<DH>(ds, Qs, L, lane, dk);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        float* drow = dqkv + ((size_t)g.b * L + j0 + r) * C3 + g.h * DH;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          drow[C + lane + 32 * u] = dk[r][u];
          drow[2 * C + lane + 32 * u] = dv[r][u];
        }
      }
    }
    __syncwarp();
  }
}

size_t fwd_smem(int L, int DH) {
  return sizeof(float) * (WARPS * L * R + WARPS * DH * R + 2 * L * (DH + 1));
}

size_t dq_smem(int L, int DH) {
  return sizeof(float) *
         (WARPS * L * R + 2 * WARPS * DH * R + 2 * L * (DH + 1));
}

size_t dkv_smem(int L, int DH) {
  return sizeof(float) *
         (2 * WARPS * L * R + 2 * WARPS * DH * R + 2 * L * (DH + 1) + 2 * L);
}

bool shape_ok(int B, int L, int H, int DH) {
  return B >= 1 && H >= 1 && L >= 1 && L <= L_MAX && (DH == 32 || DH == 64);
}

int grid_of(int B, int L, int H) { return B * H * ((L + TILE - 1) / TILE); }

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename K>
int resident(K kernel, size_t bytes) {
  int blocks = 0;
  if (set_smem(kernel, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS,
                                                    bytes) != cudaSuccess)
    return -1;
  return blocks;
}

template <int DH>
void occupancy(int L, int* out) {
  out[0] = resident(slab_fwd_kernel<DH>, fwd_smem(L, DH));
  out[1] = resident(slab_bwd_dq_kernel<DH>, dq_smem(L, DH));
  out[2] = resident(slab_bwd_dkv_kernel<DH>, dkv_smem(L, DH));
}

template <int DH>
int fwd(const float* qkv, float* out, int B, int L, int H,
        cudaStream_t stream) {
  const size_t smem = fwd_smem(L, DH);
  cudaError_t err = set_smem(slab_fwd_kernel<DH>, smem);
  if (err != cudaSuccess) return (int)err;
  slab_fwd_kernel<DH><<<grid_of(B, L, H), THREADS, smem, stream>>>(
      qkv, out, L, H, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <int DH>
int bwd(const float* qkv, const float* dout, float* dqkv, float* lse,
        float* delta, int B, int L, int H, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)DH);
  size_t smem = dq_smem(L, DH);
  cudaError_t err = set_smem(slab_bwd_dq_kernel<DH>, smem);
  if (err != cudaSuccess) return (int)err;
  slab_bwd_dq_kernel<DH><<<grid_of(B, L, H), THREADS, smem, stream>>>(
      qkv, dout, dqkv, lse, delta, L, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  smem = dkv_smem(L, DH);
  err = set_smem(slab_bwd_dkv_kernel<DH>, smem);
  if (err != cudaSuccess) return (int)err;
  slab_bwd_dkv_kernel<DH><<<grid_of(B, L, H), THREADS, smem, stream>>>(
      qkv, dout, dqkv, lse, delta, L, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv (B, L, 3 H DH) -> out (B, L, H DH).
int ertdx_slab_fwd(const float* qkv, float* out, int B, int L, int H, int DH,
                   void* stream) {
  if (!shape_ok(B, L, H, DH)) return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = (cudaStream_t)stream;
  return DH == 32 ? bwd<32>(qkv, dout, dqkv, lse, delta, B, L, H, s)
                  : bwd<64>(qkv, dout, dqkv, lse, delta, B, L, H, s);
}

// Resident blocks per SM of the forward, dQ and dK/dV kernels at (L, DH),
// written to out[0..2]; -1 where the query fails.
int ertdx_slab_blocks_per_sm(int L, int DH, int* out) {
  if (!shape_ok(1, L, 1, DH)) return (int)cudaErrorInvalidValue;
  if (DH == 32)
    occupancy<32>(L, out);
  else
    occupancy<64>(L, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
