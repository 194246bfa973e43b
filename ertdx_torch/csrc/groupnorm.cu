// Fused GroupNorm + SiLU, forward and backward (sm_90a, fp32 FMA).
//
// Replaces the TPU kernels of ertdx/ops/groupnorm.py:
//   * gn_fwd_staged_kernel / gn_fwd_stream_kernel   <- _gn_silu_kernel
//                                                      (:47-76)
//   * gn_bwd_staged_kernel / gn_bwd_stream_kernel + sum_rows_kernel
//                                                   <- _gn_silu_bwd_kernel
//                                                      (:95-131)
// x (B, L, C) feature-last, G groups (8 in the model), eps 1e-5; the
// forward writes silu(gamma x_hat + beta); the backward writes dx and
// dgamma, dbeta already summed over the batch.
//
// What bounds it on an H100: bytes. At the stem (B=256, L=587, C=128) the
// forward must read x and write y, 154 MB, 0.046 ms at 3.35 TB/s; the
// backward reads x and dy and writes dx, 231 MB, 0.069 ms. Its operations
// (a few dozen a value) are far below the fp32 peak.
//
// What the design does about it, and what it changes from the TPU kernel
// (gn_common.cuh has the details; tools/gn_ab.py times the alternatives,
// PERF.md):
//   * On the TPU one program holds a whole (L, C) row in VMEM and reads it
//     once. One row of the stem is 300 KB, more than a block's 227 KB of
//     shared memory, so here one block owns one (row, group): 37.6 KB of
//     x at the stem, 2,048 blocks. The staged forward copies its group
//     into shared memory with 16-byte cp.async (4-byte where cg % 4 != 0),
//     takes the mean and then the variance from there (two-pass, as the
//     TPU kernel does) and writes y: device memory sees x once and y once.
//     The staged backward stages x and dy (75 KB at the stem) and takes
//     the statistics, both group sums, the per-channel sums and dx from
//     shared memory: x and dy once, dx once. The earlier design swept x
//     three times (four in the backward), scalar loads and shared-memory
//     trees of 8 barriers a sum, counting on L2 for the repeats.
//   * Groups too large to stage (launch_plan in ops/groupnorm.py decides
//     on the host) run the streamed kernels, that earlier design's sweeps.
//   * The backward's per-channel sums go to a (B, 2, C) scratch that a
//     second launch adds over B in order: no float atomics, so two runs
//     give the same bits.
//   * The TPU's one-hot group matmuls exist because Mosaic cannot reshape
//     (L, C) to (L, G, C/G); a block here simply indexes its group.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape or a plan the kernels do not take.

#include "gn_common.cuh"

namespace {

// silu(GroupNorm(x)) of one (row, group), x read once.
template <int W>
__global__ void __launch_bounds__(GN_MAX_THREADS)
    gn_fwd_staged_kernel(const float* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         float* __restrict__ out, int L, int C, int G,
                         float eps) {
  extern __shared__ __align__(16) float smem[];
  const GroupWalk w = group_walk<W>(L, C, G);
  float* red = smem + (size_t)L * (C / G);
  stage_group<W>(smem, x, w);
  cp_async_wait_all();
  const Moments m = tile_stats<W>(smem, x, w, eps, red);
  float sc[W], sh[W];   // y = (x - mean) sc + sh
#pragma unroll
  for (int k = 0; k < W; ++k) {
    sc[k] = m.rstd * gamma[w.ch + k];
    sh[k] = beta[w.ch + k];
  }
#pragma unroll 4
  for (int l = w.l0; l < w.L; l += w.R) {
    float v[W];
    load_w<W>(v, smem + (size_t)w.tile(l) * W);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float y = fmaf(m.centred(v[k]), sc[k], sh[k]);
      v[k] = y * gn_sigmoid(y);
    }
    store_w<W>(out + w.global(l), v);
  }
}

// The same by three sweeps over x in device memory.
__global__ void __launch_bounds__(GN_THREADS)
    gn_fwd_stream_kernel(const float* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         float* __restrict__ out, int L, int C, int G,
                         float eps) {
  __shared__ float red[GN_STREAM_RED];
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int cg = C / G;
  const Moments m = group_stats(x, b, g, L, C, cg, eps, red);
  const GroupLanes q = group_lanes(cg);
  if (q.r >= q.rows) return;
  const size_t base = (size_t)b * L * C + (size_t)g * cg;
  for (int c = q.c; c < cg; c += q.lanes) {
    const float sc = m.rstd * gamma[g * cg + c], sh = beta[g * cg + c];
#pragma unroll 4
    for (int l = q.r; l < L; l += q.rows) {
      const size_t i = base + (size_t)l * C + c;
      const float y = fmaf(m.centred(x[i]), sc, sh);
      out[i] = y * gn_sigmoid(y);
    }
  }
}

}  // namespace

extern "C" {

// x (B, L, C), gamma, beta (C) -> out (B, L, C). (staged, threads, smem)
// is the launch plan; x and out start on 16-byte boundaries.
int ertdx_gn_silu_fwd(const float* x, const float* gamma, const float* beta,
                      float* out, int B, int L, int C, int G, float eps,
                      int staged, int threads, int smem, void* stream) {
  const GnPlan p{staged, threads, smem};
  if (!gn_shape_ok(B, L, C, G) || !gn_plan_ok(p, 1, L, C / G))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (!p.staged) {
    gn_fwd_stream_kernel<<<B * G, GN_THREADS, 0, s>>>(x, gamma, beta, out,
                                                      L, C, G, eps);
  } else if (gn_width(C / G) == 4) {
    if ((err = set_smem(gn_fwd_staged_kernel<4>, p.smem)) != cudaSuccess)
      return (int)err;
    gn_fwd_staged_kernel<4><<<B * G, p.threads, p.smem, s>>>(
        x, gamma, beta, out, L, C, G, eps);
  } else {
    if ((err = set_smem(gn_fwd_staged_kernel<1>, p.smem)) != cudaSuccess)
      return (int)err;
    gn_fwd_staged_kernel<1><<<B * G, p.threads, p.smem, s>>>(
        x, gamma, beta, out, L, C, G, eps);
  }
  return (int)cudaGetLastError();
}

// x, gy (B, L, C), gamma, beta (C) -> dx (B, L, C) and dgb (2 C): dgamma
// then dbeta. part is (B, 2, C) scratch. (staged, threads, smem) is the
// launch plan; x, gy and dx start on 16-byte boundaries.
int ertdx_gn_silu_bwd(const float* x, const float* gamma, const float* beta,
                      const float* gy, float* dx, float* part, float* dgb,
                      int B, int L, int C, int G, float eps, int staged,
                      int threads, int smem, void* stream) {
  if (!gn_shape_ok(B, L, C, G)) return (int)cudaErrorInvalidValue;
  return (int)gn_silu_bwd(x, gamma, beta, gy, nullptr, dx, part, dgb, B, L,
                          C, G, eps, GnPlan{staged, threads, smem},
                          (cudaStream_t)stream);
}

}  // extern "C"
