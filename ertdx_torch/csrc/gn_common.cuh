// GroupNorm pieces shared by groupnorm.cu and gn_conv.cu (sm_90a, fp32).
//
// Layout is the JAX package's: x (B, L, C) feature-last, G groups of
// cg = C / G consecutive channels; the statistics of group g of row b run
// over its L x cg values, two-pass as ertdx/ops/groupnorm.py:57-69 takes
// them (the mean first, then the mean of squared deviations), eps inside
// the rsqrt.
//
// One CUDA block of GN_THREADS threads owns one (row, group). Its threads
// sweep the group as `lanes` channels by `rows` sequence positions at a
// time (lanes = min(cg, GN_THREADS), rows = GN_THREADS / lanes), so a
// warp reads whole runs of the group's channels; the sweeps over L are
// unrolled by 4 so that each thread has 4 loads in flight. Every
// reduction is a shared-memory tree in a fixed order, and per-channel sums
// over L are taken row by row in order: two runs give the same bits.
//
// Everything here is in an anonymous namespace: each translation unit
// that includes the header has its own copy.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int GN_THREADS = 256;

struct GroupLanes {
  int lanes;  // channels swept side by side
  int rows;   // sequence positions swept side by side
  int c;      // this thread's channel offset in the group (t % lanes)
  int r;      // this thread's row offset (t / lanes); >= rows: idle
};

__device__ __forceinline__ GroupLanes group_lanes(int cg) {
  GroupLanes q;
  q.lanes = cg < GN_THREADS ? cg : GN_THREADS;
  q.rows = GN_THREADS / q.lanes;
  q.c = threadIdx.x % q.lanes;
  q.r = threadIdx.x / q.lanes;
  return q;
}

// Sum of v over the block, fixed order; every thread gets it. `red` is
// GN_THREADS floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int s = GN_THREADS / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ float sigmoidf(float y) {
  return 1.f / (1.f + expf(-y));
}

// Mean and rstd of group g of batch row b of x (B, L, C), two passes.
__device__ __forceinline__ void group_stats(const float* __restrict__ x,
                                            int b, int g, int L, int C,
                                            int cg, float eps, float* red,
                                            float* mean_out,
                                            float* rstd_out) {
  const GroupLanes q = group_lanes(cg);
  const float* xb = x + (size_t)b * L * C + (size_t)g * cg;
  const float n = (float)L * (float)cg;
  float s = 0.f, ss = 0.f;
  if (q.r < q.rows) {
    for (int c = q.c; c < cg; c += q.lanes) {
#pragma unroll 4
      for (int l = q.r; l < L; l += q.rows) s += xb[(size_t)l * C + c];
    }
  }
  const float mean = block_sum(s, red) / n;
  if (q.r < q.rows) {
    for (int c = q.c; c < cg; c += q.lanes) {
#pragma unroll 4
      for (int l = q.r; l < L; l += q.rows) {
        const float d = xb[(size_t)l * C + c] - mean;
        ss += d * d;
      }
    }
  }
  const float var = block_sum(ss, red) / n;
  *mean_out = mean;
  *rstd_out = rsqrtf(var + eps);
}

// stats (B, G, 2): mean and rstd of every (row, group). Grid B * G.
__global__ void __launch_bounds__(GN_THREADS)
    gn_stats_kernel(const float* __restrict__ x, float* __restrict__ stats,
                    int L, int C, int G, float eps) {
  __shared__ float red[GN_THREADS];
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  float mean, rstd;
  group_stats(x, b, g, L, C, C / G, eps, red, &mean, &rstd);
  if (threadIdx.x == 0) {
    stats[2 * (size_t)blockIdx.x] = mean;
    stats[2 * (size_t)blockIdx.x + 1] = rstd;
  }
}

// GroupNorm + SiLU backward for one (row, group) per block, grid B * G.
// Recomputes the statistics, x_hat and y from x, applies the SiLU chain
// rule to the upstream gradient gy, then the GN identity
//   dx = rstd (dxh - mean_g(dxh) - x_hat mean_g(dxh x_hat)),  dxh = dy gamma
// (ertdx/ops/groupnorm.py:95-131). Per-row sums over L of dy x_hat and of
// dy go to part (B, 2, C); sum_rows_kernel reduces them over B.
__global__ void __launch_bounds__(GN_THREADS)
    gn_silu_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const float* __restrict__ gy, float* __restrict__ dx,
                       float* __restrict__ part, int L, int C, int G,
                       float eps) {
  __shared__ float red[GN_THREADS];
  __shared__ float sp[2][GN_THREADS];
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int cg = C / G;
  float mean, rstd;
  group_stats(x, b, g, L, C, cg, eps, red, &mean, &rstd);
  const GroupLanes q = group_lanes(cg);
  const size_t base = (size_t)b * L * C + (size_t)g * cg;
  const float n = (float)L * (float)cg;

  float s1 = 0.f, s2 = 0.f;
  // the channel loop has the same trip count in every thread: the
  // __syncthreads inside it are reached by all
  for (int c0 = 0; c0 < cg; c0 += q.lanes) {
    const int c = c0 + q.c;
    float pg = 0.f, pb = 0.f;
    if (q.r < q.rows && c < cg) {
      const float ga = gamma[g * cg + c], be = beta[g * cg + c];
#pragma unroll 4
      for (int l = q.r; l < L; l += q.rows) {
        const size_t i = base + (size_t)l * C + c;
        const float xh = (x[i] - mean) * rstd;
        const float y = xh * ga + be;
        const float sg = sigmoidf(y);
        const float dy = gy[i] * sg * (1.f + y * (1.f - sg));
        pg += dy * xh;
        pb += dy;
        const float dxh = dy * ga;
        s1 += dxh;
        s2 += dxh * xh;
      }
    }
    sp[0][threadIdx.x] = pg;
    sp[1][threadIdx.x] = pb;
    __syncthreads();
    if (q.r == 0 && c < cg) {
      float a = 0.f, bb = 0.f;
      for (int r = 0; r < q.rows; ++r) {
        a += sp[0][r * q.lanes + q.c];
        bb += sp[1][r * q.lanes + q.c];
      }
      part[((size_t)b * 2) * C + g * cg + c] = a;
      part[((size_t)b * 2 + 1) * C + g * cg + c] = bb;
    }
    __syncthreads();
  }
  const float m1 = block_sum(s1, red) / n;
  const float m2 = block_sum(s2, red) / n;
  if (q.r >= q.rows) return;
  for (int c = q.c; c < cg; c += q.lanes) {
    const float ga = gamma[g * cg + c], be = beta[g * cg + c];
#pragma unroll 4
    for (int l = q.r; l < L; l += q.rows) {
      const size_t i = base + (size_t)l * C + c;
      const float xh = (x[i] - mean) * rstd;
      const float y = xh * ga + be;
      const float sg = sigmoidf(y);
      const float dxh = gy[i] * sg * (1.f + y * (1.f - sg)) * ga;
      dx[i] = rstd * (dxh - m1 - xh * m2);
    }
  }
}

// out[j] = sum over r < rows of part[r n + j], r in order. Grid covers n.
__global__ void sum_rows_kernel(const float* __restrict__ part,
                                float* __restrict__ out, int rows, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(size_t)r * n + j];
  out[j] = s;
}

inline int gn_shape_ok(int B, int L, int C, int G) {
  return B >= 1 && L >= 1 && G >= 1 && C >= G && C % G == 0;
}

}  // namespace
