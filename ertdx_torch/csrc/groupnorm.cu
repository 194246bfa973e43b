// Fused GroupNorm + SiLU, forward and backward (sm_90a, fp32 FMA).
//
// Replaces the TPU kernels of ertdx/ops/groupnorm.py:
//   * gn_silu_fwd_kernel                <- _gn_silu_kernel (:47-76)
//   * gn_silu_bwd_kernel + sum_rows     <- _gn_silu_bwd_kernel (:95-131)
// x (B, L, C) feature-last, G groups (8 in the model), eps 1e-5; the
// forward writes silu(gamma x_hat + beta); the backward writes dx and
// dgamma, dbeta already summed over the batch.
//
// What bounds it on an H100: bytes. At the stem (B=256, L=587, C=128) the
// forward must read x and write y, 154 MB, 0.046 ms at 3.35 TB/s; the
// backward reads x and dy and writes dx, 231 MB, 0.069 ms. Its operations
// (a few dozen a value) are far below the fp32 peak.
//
// What the design does about it, and what it changes from the TPU kernel:
//   * On the TPU one program holds a whole (L, C) row in VMEM. One row of
//     the stem is 300 KB, more than a block's 227 KB of shared memory, so
//     here one block owns one (row, group) instead: 37.6 KB of x at the
//     stem, 2,048 blocks. Its first two sweeps take the mean and the
//     variance (two-pass, as the TPU kernel does), the third normalises
//     and writes. The second and third sweeps find the group in L2 (50
//     MB), so device memory sees x about once.
//   * The backward block recomputes the statistics, then sweeps once for
//     the two group sums (of dxh and dxh x_hat) and the per-channel sums
//     of dy x_hat and dy, and once more for dx. The per-channel sums go to
//     a (B, 2, C) scratch that a second launch adds over B in order: no
//     float atomics, so two runs give the same bits, and no partials are
//     left for the caller to sum.
//   * The TPU's one-hot group matmuls exist because Mosaic cannot reshape
//     (L, C) to (L, G, C/G); a block here simply indexes its group.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError().

#include "gn_common.cuh"

namespace {

// silu(GroupNorm(x)), one block per (row, group), grid B * G.
__global__ void __launch_bounds__(GN_THREADS)
    gn_silu_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       float* __restrict__ out, int L, int C, int G,
                       float eps) {
  __shared__ float red[GN_THREADS];
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int cg = C / G;
  float mean, rstd;
  group_stats(x, b, g, L, C, cg, eps, red, &mean, &rstd);
  const GroupLanes q = group_lanes(cg);
  if (q.r >= q.rows) return;
  const size_t base = (size_t)b * L * C + (size_t)g * cg;
  for (int c = q.c; c < cg; c += q.lanes) {
    const float ga = gamma[g * cg + c], be = beta[g * cg + c];
#pragma unroll 4
    for (int l = q.r; l < L; l += q.rows) {
      const size_t i = base + (size_t)l * C + c;
      const float y = (x[i] - mean) * rstd * ga + be;
      out[i] = y * sigmoidf(y);
    }
  }
}

}  // namespace

extern "C" {

// x (B, L, C), gamma, beta (C) -> out (B, L, C).
int ertdx_gn_silu_fwd(const float* x, const float* gamma, const float* beta,
                      float* out, int B, int L, int C, int G, float eps,
                      void* stream) {
  if (!gn_shape_ok(B, L, C, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  gn_silu_fwd_kernel<<<B * G, GN_THREADS, 0, s>>>(x, gamma, beta, out, L, C,
                                                  G, eps);
  return (int)cudaGetLastError();
}

// x, gy (B, L, C), gamma, beta (C) -> dx (B, L, C) and dgb (2 C): dgamma
// then dbeta. part is (B, 2, C) scratch.
int ertdx_gn_silu_bwd(const float* x, const float* gamma, const float* beta,
                      const float* gy, float* dx, float* part, float* dgb,
                      int B, int L, int C, int G, float eps, void* stream) {
  if (!gn_shape_ok(B, L, C, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  gn_silu_bwd_kernel<<<B * G, GN_THREADS, 0, s>>>(x, gamma, beta, gy, dx,
                                                  part, L, C, G, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_rows_kernel<<<(2 * C + 255) / 256, 256, 0, s>>>(part, dgb, B, 2 * C);
  return (int)cudaGetLastError();
}

}  // extern "C"
