// Fused GroupNorm + SiLU, forward and backward (sm_90a, fp32 FMA), on
// float32 or bf16 x.
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
// bf16: the same kernels on a bf16 x (and upstream gradient) through
// the _bf16 entry points, as the TPU kernels take any input dtype: each
// value converts to float on load and rounds once on store, y and dx are
// bf16, the statistics and dgamma, dbeta float32 (gn_common.cuh). The
// group then stages in half the bytes: at the condition's length (2,
// 4693, 128) the forward stages (150 KB) where the float32 one streams.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape or a plan the kernels do not take.

#include "gn_common.cuh"

namespace {

// silu(GroupNorm(x)) of one (row, group), x read once.
template <int W, typename TX>
__global__ void __launch_bounds__(GN_MAX_THREADS)
    gn_fwd_staged_kernel(const TX* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         TX* __restrict__ out, int L, int C, int G,
                         float eps) {
  extern __shared__ __align__(16) unsigned char gn_smem[];
  TX* tile = reinterpret_cast<TX*>(gn_smem);
  const GroupWalk w = group_walk<W>(L, C, G);
  float* red = gn_red<TX, TX>(gn_smem, 1, L, C / G);
  stage_group<W>(tile, x, w);
  cp_async_wait_all();
  const Moments m = tile_stats<W>(tile, x, w, eps, red);
  float sc[W], sh[W];   // y = (x - mean) sc + sh
#pragma unroll
  for (int k = 0; k < W; ++k) {
    sc[k] = m.rstd * gamma[w.ch + k];
    sh[k] = beta[w.ch + k];
  }
#pragma unroll 4
  for (int l = w.l0; l < w.L; l += w.R) {
    float v[W];
    load_w<W>(v, tile + (size_t)w.tile(l) * W);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float y = fmaf(m.centred(v[k]), sc[k], sh[k]);
      v[k] = y * gn_sigmoid(y);
    }
    store_w<W>(out + w.global(l), v);
  }
}

// The same by three sweeps over x in device memory.
template <typename TX>
__global__ void __launch_bounds__(GN_THREADS)
    gn_fwd_stream_kernel(const TX* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         TX* __restrict__ out, int L, int C, int G,
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
      const float y = fmaf(m.centred(to_f(x[i])), sc, sh);
      out[i] = from_f<TX>(y * gn_sigmoid(y));
    }
  }
}

template <typename TX>
int gn_silu_fwd(const TX* x, const float* gamma, const float* beta, TX* out,
                int B, int L, int C, int G, float eps, GnPlan p,
                void* stream) {
  if (!gn_shape_ok(B, L, C, G) || !gn_plan_ok<TX>(p, 1, L, C / G))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!p.staged) {
    gn_fwd_stream_kernel<TX><<<B * G, GN_THREADS, 0, s>>>(x, gamma, beta,
                                                          out, L, C, G, eps);
    return (int)cudaGetLastError();
  }
  return (int)gn_by_width<TX>(C / G, [&](auto wc) {
    constexpr int W = decltype(wc)::value;
    cudaError_t err = set_smem(gn_fwd_staged_kernel<W, TX>, p.smem);
    if (err != cudaSuccess) return err;
    gn_fwd_staged_kernel<W, TX><<<B * G, p.threads, p.smem, s>>>(
        x, gamma, beta, out, L, C, G, eps);
    return cudaGetLastError();
  });
}

template <typename TX>
int gn_silu_bwd_entry(const TX* x, const float* gamma, const float* beta,
                      const TX* gy, TX* dx, float* part, float* dgb, int B,
                      int L, int C, int G, float eps, GnPlan p,
                      void* stream) {
  if (!gn_shape_ok(B, L, C, G)) return (int)cudaErrorInvalidValue;
  return (int)gn_silu_bwd<TX, TX>(x, gamma, beta, gy, nullptr, dx, part,
                                  dgb, B, L, C, G, eps, p,
                                  (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// x (B, L, C), gamma, beta (C) -> out (B, L, C). (staged, threads, smem)
// is the launch plan; x and out start on 16-byte boundaries.
int ertdx_gn_silu_fwd(const float* x, const float* gamma, const float* beta,
                      float* out, int B, int L, int C, int G, float eps,
                      int staged, int threads, int smem, void* stream) {
  return gn_silu_fwd(x, gamma, beta, out, B, L, C, G, eps,
                     GnPlan{staged, threads, smem}, stream);
}

// x, gy (B, L, C), gamma, beta (C) -> dx (B, L, C) and dgb (2 C): dgamma
// then dbeta. part is (B, 2, C) scratch. (staged, threads, smem) is the
// launch plan; x, gy and dx start on 16-byte boundaries.
int ertdx_gn_silu_bwd(const float* x, const float* gamma, const float* beta,
                      const float* gy, float* dx, float* part, float* dgb,
                      int B, int L, int C, int G, float eps, int staged,
                      int threads, int smem, void* stream) {
  return gn_silu_bwd_entry(x, gamma, beta, gy, dx, part, dgb, B, L, C, G,
                           eps, GnPlan{staged, threads, smem}, stream);
}

// The same on bf16 x, out, gy and dx (gamma, beta, dgb and part float32).
int ertdx_gn_silu_fwd_bf16(const bf16* x, const float* gamma,
                           const float* beta, bf16* out, int B, int L, int C,
                           int G, float eps, int staged, int threads,
                           int smem, void* stream) {
  return gn_silu_fwd(x, gamma, beta, out, B, L, C, G, eps,
                     GnPlan{staged, threads, smem}, stream);
}

int ertdx_gn_silu_bwd_bf16(const bf16* x, const float* gamma,
                           const float* beta, const bf16* gy, bf16* dx,
                           float* part, float* dgb, int B, int L, int C,
                           int G, float eps, int staged, int threads,
                           int smem, void* stream) {
  return gn_silu_bwd_entry(x, gamma, beta, gy, dx, part, dgb, B, L, C, G,
                           eps, GnPlan{staged, threads, smem}, stream);
}

}  // extern "C"
