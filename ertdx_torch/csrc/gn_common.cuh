// GroupNorm pieces shared by groupnorm.cu and gn_conv.cu (sm_90a, fp32).
//
// Layout is the JAX package's: x (B, L, C) feature-last, G groups of
// cg = C / G consecutive channels; the statistics of group g of row b run
// over its L x cg values, two-pass as ertdx/ops/groupnorm.py:57-69 takes
// them (the mean first, then the mean of squared deviations), eps inside
// the rsqrt. Both passes sum x - s, s the group's first value (a shift
// that changes no result but the rounding: a group of mean 1000 and
// spread 1 then loses nothing to the magnitude of its sums; x - mean is
// taken as (x - s) - mean(x - s)). One CUDA block owns one (row, group);
// grid B * G.
//
// What bounds these kernels on an H100: bytes (a few dozen operations a
// value). The design goal is one read of each input and one write of each
// output, and two kernels per function reach it by shape:
//   * Staged (every shape whose group fits in shared memory, all the
//     model's): the block copies its group's L x cg floats of x (and of
//     the upstream gradient, in the backward) into shared memory with
//     cp.async, the whole group in flight before the first barrier, and
//     takes the statistics, the backward's sums and its outputs from
//     there. Thread t owns one unit of W channels (W = 4, a float4, when
//     cg % 4 == 0, else W = 1) of the positions l = t / U, t / U + R, ...
//     (U = cg / W units a position, R = T / U, T a multiple of U and of
//     32): it stages them and is the only thread that reads them back, so
//     the copy needs cp.async.wait_all and no barrier, a warp moves whole
//     runs of a position's channels, and each thread's channel is fixed.
//     Staging 4-byte-wide for cg % 4 != 0 keeps one kernel for every cg;
//     the wrappers take 16-byte aligned x and upstream gradients only
//     (the autograd paths copy a misaligned one).
//   * Streamed (groups too large to stage, e.g. the condition's own length
//     of 4693 at cg = 16, 300 KB): the sweeps of the earlier design, which
//     read x from device memory once a pass and count on L2 for the rest.
//   ops/groupnorm.py::launch_plan picks the kernel, the block size and
//   the shared-memory bytes on the host; the entry points check the plan
//   (gn_plan_ok) and never fall back.
// Every reduction is in a fixed order, so two runs give the same bits:
// per-thread partials (a float4's four lanes kept apart, added pairwise
// at the end), a __shfl_xor tree within the warp, then one shared-memory
// step across warps (each thread adds the warps' sums in order): one
// barrier a sum. The per-channel sums of the backward reduce the same way
// over the threads of one channel, into a (B, 2, C) scratch that
// sum_rows_kernel adds over B in order; no float atomics.
//
// Everything here is in an anonymous namespace: each translation unit
// that includes the header has its own copy.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int GN_THREADS = 256;        // the streamed kernels' block
constexpr int GN_MAX_THREADS = 512;    // the staged kernels' largest block
constexpr int GN_SMEM_MAX = 232448;    // shared memory a block may use
constexpr int GN_STREAM_RED = 4 * GN_THREADS / 32;  // streamed sum slots

// The host's choice (ops/groupnorm.py::launch_plan): the staged or the
// streamed kernel, its block size and its dynamic shared-memory bytes.
struct GnPlan {
  int staged, threads, smem;
};

inline int gn_width(int cg) { return cg % 4 == 0 ? 4 : 1; }

// Floats of the staged backward's per-channel scratch: the entries each
// channel's sum adds in order (one a warp after the warp tree when the
// units of a position divide 32, else one a thread), for dgamma and dbeta.
inline size_t gn_chan_floats(int cg, int threads) {
  const int units = cg / gn_width(cg);
  return 2 * (size_t)cg * (32 % units == 0 ? threads / 32 : threads / units);
}

// Dynamic shared memory of a staged kernel that stages `tiles` groups
// (1: the forward and the statistics, two sums; 2: the backward, x and
// gy, four sums and the channel scratch): the tiles, then a slot of one
// float a warp for each sum, then the channel scratch.
inline size_t gn_staged_bytes(int tiles, int L, int cg, int threads) {
  return 4 * ((size_t)tiles * L * cg + (tiles == 2 ? 4 : 2) * (threads / 32) +
              (tiles == 2 ? gn_chan_floats(cg, threads) : 0));
}

// Whether plan p is one the kernels run for a group of L x cg values.
inline bool gn_plan_ok(GnPlan p, int tiles, int L, int cg) {
  if (!p.staged) return p.threads == GN_THREADS && p.smem == 0;
  const int units = cg / gn_width(cg);
  return p.threads >= 32 && p.threads <= GN_MAX_THREADS &&
         p.threads % 32 == 0 && p.threads % units == 0 &&
         p.smem <= GN_SMEM_MAX &&
         (size_t)p.smem == gn_staged_bytes(tiles, L, cg, p.threads);
}

inline int gn_shape_ok(int B, int L, int C, int G) {
  return B >= 1 && L >= 1 && G >= 1 && C >= G && C % G == 0;
}

template <typename Kern>
cudaError_t set_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// 1 / (1 + e^-y) by the SFU's exp2 and reciprocal (a few ulp)
__device__ __forceinline__ float gn_sigmoid(float y) {
  return __fdividef(1.f, 1.f + __expf(-y));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Slot i of the per-warp sums: one float a warp.
__device__ __forceinline__ float* slot(float* red, int i) {
  return red + i * (int)(blockDim.x >> 5);
}

// Sum of v over the block, fixed order; every thread gets it. `red` is a
// slot that no thread reads or writes again before the next barrier:
// callers give each sum of a kernel its own slot, so one barrier a sum
// suffices.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// A group's statistics: x - mean_g(x) = (x - shift) - mean, and rstd.
struct Moments {
  float shift, mean, rstd;
  __device__ __forceinline__ float centred(float v) const {
    return (v - shift) - mean;
  }
  __device__ __forceinline__ float group_mean() const { return shift + mean; }
};

// The moments of a (row, group) whose mean and rstd the caller has, at
// stats[2 i], stats[2 i + 1].
__device__ __forceinline__ Moments given_moments(const float* stats,
                                                 size_t i) {
  return Moments{stats[2 * i], 0.f, stats[2 * i + 1]};
}

// ---- the staged kernels ---------------------------------------------------

// W consecutive floats: a float4 or one float
template <int W>
__device__ __forceinline__ void load_w(float (&v)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void store_w(float* p, const float (&v)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

template <int W>
__device__ __forceinline__ float lanes_sum(const float (&a)[W]) {
  if constexpr (W == 4) return (a[0] + a[1]) + (a[2] + a[3]);
  else return a[0];
}

template <int W>
__device__ __forceinline__ void cp_async_w(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (W == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// This thread's part of the block's (row, group): channel unit cu of the
// positions l0, l0 + R, ... < L. Unit (l, cu) lies at tile[(l U + cu) W]
// in shared memory and at row + l C in device memory.
struct GroupWalk {
  size_t base;  // offset of (b, 0, g cg) in x
  size_t row;   // offset of (b, 0, g cg + cu W) in x
  int ch;       // channel g cg + cu W
  int U, cu, l0, R, L, C;
  __device__ __forceinline__ int tile(int l) const { return l * U + cu; }
  __device__ __forceinline__ size_t global(int l) const {
    return row + (size_t)l * C;
  }
};

template <int W>
__device__ __forceinline__ GroupWalk group_walk(int L, int C, int G) {
  GroupWalk w;
  const int b = blockIdx.x / G, g = blockIdx.x % G, cg = C / G;
  w.U = cg / W;
  w.cu = threadIdx.x % w.U;
  w.l0 = threadIdx.x / w.U;
  w.R = blockDim.x / w.U;
  w.L = L;
  w.C = C;
  w.ch = g * cg + w.cu * W;
  w.base = (size_t)b * L * C + (size_t)g * cg;
  w.row = w.base + w.cu * W;
  return w;
}

// Copy this thread's units of src's group into tile (cp.async, not waited
// for).
template <int W>
__device__ __forceinline__ void stage_group(float* tile, const float* src,
                                            const GroupWalk& w) {
  for (int l = w.l0; l < w.L; l += w.R)
    cp_async_w<W>(tile + (size_t)w.tile(l) * W, src + w.global(l));
}

// The moments of the staged group of x, two passes over shared memory
// (the shift, the group's first value, read from x); red slots 0 and 1.
template <int W>
__device__ __forceinline__ Moments tile_stats(const float* tile,
                                              const float* x,
                                              const GroupWalk& w, float eps,
                                              float* red) {
  const float n = (float)w.L * (float)(w.U * W);
  Moments m;
  m.shift = x[w.base];
  float a[W] = {};
#pragma unroll 4
  for (int l = w.l0; l < w.L; l += w.R) {
    float v[W];
    load_w<W>(v, tile + (size_t)w.tile(l) * W);
#pragma unroll
    for (int k = 0; k < W; ++k) a[k] += v[k] - m.shift;
  }
  m.mean = block_sum(lanes_sum<W>(a), red) / n;
  float q[W] = {};
#pragma unroll 4
  for (int l = w.l0; l < w.L; l += w.R) {
    float v[W];
    load_w<W>(v, tile + (size_t)w.tile(l) * W);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float d = m.centred(v[k]);
      q[k] = fmaf(d, d, q[k]);
    }
  }
  m.rstd = rsqrtf(block_sum(lanes_sum<W>(q), slot(red, 1)) / n + eps);
  return m;
}

// stats (B, G, 2): mean and rstd of every (row, group), x read once.
template <int W>
__global__ void __launch_bounds__(GN_MAX_THREADS)
    gn_stats_staged_kernel(const float* __restrict__ x,
                           float* __restrict__ stats, int L, int C, int G,
                           float eps) {
  extern __shared__ __align__(16) float smem[];
  const GroupWalk w = group_walk<W>(L, C, G);
  float* red = smem + (size_t)L * (C / G);
  stage_group<W>(smem, x, w);
  cp_async_wait_all();
  const Moments m = tile_stats<W>(smem, x, w, eps, red);
  if (threadIdx.x == 0) {
    stats[2 * (size_t)blockIdx.x] = m.group_mean();
    stats[2 * (size_t)blockIdx.x + 1] = m.rstd;
  }
}

// GroupNorm + SiLU backward of one (row, group), x and gy read once.
// Takes the statistics from stats (B, G, 2) where the caller has them
// (the fused conv's backward), else computes them from the staged x. Then
// one pass over the staged tiles applies the SiLU chain rule, keeps
// dxh = dy gamma in gy's place and sums dxh and dxh x_hat over the group
// and dy x_hat and dy over each channel's positions; a second writes the
// GN identity
//   dx = rstd (dxh - mean_g(dxh) - x_hat mean_g(dxh x_hat))
// (ertdx/ops/groupnorm.py:95-131). Per-row channel sums go to part
// (B, 2, C); sum_rows_kernel reduces them over B.
template <int W>
__global__ void __launch_bounds__(GN_MAX_THREADS)
    gn_bwd_staged_kernel(const float* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         const float* __restrict__ gy,
                         const float* __restrict__ stats,
                         float* __restrict__ dx, float* __restrict__ part,
                         int L, int C, int G, float eps) {
  extern __shared__ __align__(16) float smem[];
  const GroupWalk w = group_walk<W>(L, C, G);
  const int cg = C / G;
  float* xs = smem;
  float* ds = xs + (size_t)L * cg;
  float* red = ds + (size_t)L * cg;
  float* chan = slot(red, 4);
  stage_group<W>(xs, x, w);
  stage_group<W>(ds, gy, w);
  cp_async_wait_all();
  const Moments m = stats ? given_moments(stats, blockIdx.x)
                          : tile_stats<W>(xs, x, w, eps, red);
  float ga[W], be[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    ga[k] = gamma[w.ch + k];
    be[k] = beta[w.ch + k];
  }
  float s1[W] = {}, s2[W] = {}, pg[W] = {}, pb[W] = {};
#pragma unroll 2
  for (int l = w.l0; l < w.L; l += w.R) {
    const size_t i = (size_t)w.tile(l) * W;
    float v[W], d[W];
    load_w<W>(v, xs + i);
    load_w<W>(d, ds + i);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float xh = m.centred(v[k]) * m.rstd;
      const float y = fmaf(xh, ga[k], be[k]);
      const float sg = gn_sigmoid(y);
      const float dy = d[k] * sg * (1.f + y * (1.f - sg));
      pg[k] = fmaf(dy, xh, pg[k]);
      pb[k] += dy;
      d[k] = dy * ga[k];
      s1[k] += d[k];
      s2[k] = fmaf(d[k], xh, s2[k]);
    }
    store_w<W>(ds + i, d);
  }

  // the threads of one channel: a warp tree where the units of a position
  // divide 32 (each lane then holds its warp's sum), then the entries of
  // channel c at chan[c + j cg], j in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool tree = 32 % w.U == 0;
  if (tree) {
    for (int o = 16; o >= w.U; o >>= 1)
#pragma unroll
      for (int k = 0; k < W; ++k) {
        pg[k] += __shfl_xor_sync(0xffffffffu, pg[k], o);
        pb[k] += __shfl_xor_sync(0xffffffffu, pb[k], o);
      }
  }
  const int count = tree ? blockDim.x / 32 : blockDim.x / w.U;
  float* cgam = chan;
  float* cbet = chan + (size_t)count * cg;
  if (!tree || lane < w.U) {
    const int e = tree ? warp * w.U + lane : threadIdx.x;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      cgam[e * W + k] = pg[k];
      cbet[e * W + k] = pb[k];
    }
  }
  const float a1 = warp_sum(lanes_sum<W>(s1));
  const float a2 = warp_sum(lanes_sum<W>(s2));
  if (lane == 0) {
    slot(red, 2)[warp] = a1;
    slot(red, 3)[warp] = a2;
  }
  __syncthreads();
  float m1 = slot(red, 2)[0], m2 = slot(red, 3)[0];
  for (int k = 1; k < (int)(blockDim.x >> 5); ++k) {
    m1 += slot(red, 2)[k];
    m2 += slot(red, 3)[k];
  }
  const float n = (float)L * (float)cg;
  m1 /= n;
  m2 /= n;
  const size_t b = blockIdx.x / G;
  for (int c = threadIdx.x; c < cg; c += blockDim.x) {
    float sgm = cgam[c], sbe = cbet[c];
    for (int j = 1; j < count; ++j) {
      sgm += cgam[c + (size_t)j * cg];
      sbe += cbet[c + (size_t)j * cg];
    }
    const int ch = w.ch - w.cu * W + c;
    part[b * 2 * C + ch] = sgm;
    part[(b * 2 + 1) * C + ch] = sbe;
  }

#pragma unroll 2
  for (int l = w.l0; l < w.L; l += w.R) {
    const size_t i = (size_t)w.tile(l) * W;
    float v[W], d[W];
    load_w<W>(v, xs + i);
    load_w<W>(d, ds + i);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float xh = m.centred(v[k]) * m.rstd;
      d[k] = m.rstd * (d[k] - m1 - xh * m2);
    }
    store_w<W>(dx + w.global(l), d);
  }
}

// ---- the streamed kernels -------------------------------------------------
//
// GN_THREADS threads sweep the group as `lanes` channels by `rows`
// positions at a time (lanes = min(cg, GN_THREADS), rows = GN_THREADS /
// lanes), reading x from device memory on every sweep.

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

// The moments of group g of batch row b of x (B, L, C), two sweeps; red
// slots 0 and 1.
__device__ __forceinline__ Moments group_stats(const float* __restrict__ x,
                                               int b, int g, int L, int C,
                                               int cg, float eps,
                                               float* red) {
  const GroupLanes q = group_lanes(cg);
  const float* xb = x + (size_t)b * L * C + (size_t)g * cg;
  const float n = (float)L * (float)cg;
  Moments m;
  m.shift = xb[0];
  float s = 0.f, ss = 0.f;
  if (q.r < q.rows) {
    for (int c = q.c; c < cg; c += q.lanes) {
#pragma unroll 4
      for (int l = q.r; l < L; l += q.rows)
        s += xb[(size_t)l * C + c] - m.shift;
    }
  }
  m.mean = block_sum(s, red) / n;
  if (q.r < q.rows) {
    for (int c = q.c; c < cg; c += q.lanes) {
#pragma unroll 4
      for (int l = q.r; l < L; l += q.rows) {
        const float d = m.centred(xb[(size_t)l * C + c]);
        ss += d * d;
      }
    }
  }
  m.rstd = rsqrtf(block_sum(ss, slot(red, 1)) / n + eps);
  return m;
}

__global__ void __launch_bounds__(GN_THREADS)
    gn_stats_stream_kernel(const float* __restrict__ x,
                           float* __restrict__ stats, int L, int C, int G,
                           float eps) {
  __shared__ float red[GN_STREAM_RED];
  const Moments m = group_stats(x, blockIdx.x / G, blockIdx.x % G, L, C,
                                C / G, eps, red);
  if (threadIdx.x == 0) {
    stats[2 * (size_t)blockIdx.x] = m.group_mean();
    stats[2 * (size_t)blockIdx.x + 1] = m.rstd;
  }
}

// The staged backward's function by sweeps: the statistics (unless given),
// one sweep for the group and channel sums, one for dx.
__global__ void __launch_bounds__(GN_THREADS)
    gn_bwd_stream_kernel(const float* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         const float* __restrict__ gy,
                         const float* __restrict__ stats,
                         float* __restrict__ dx, float* __restrict__ part,
                         int L, int C, int G, float eps) {
  __shared__ float red[GN_STREAM_RED];
  __shared__ float sp[2][GN_THREADS];
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int cg = C / G;
  const Moments m = stats ? given_moments(stats, blockIdx.x)
                          : group_stats(x, b, g, L, C, cg, eps, red);
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
        const float xh = m.centred(x[i]) * m.rstd;
        const float y = xh * ga + be;
        const float sg = gn_sigmoid(y);
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
  const float m1 = block_sum(s1, slot(red, 2)) / n;
  const float m2 = block_sum(s2, slot(red, 3)) / n;
  if (q.r >= q.rows) return;
  for (int c = q.c; c < cg; c += q.lanes) {
    const float ga = gamma[g * cg + c], be = beta[g * cg + c];
#pragma unroll 4
    for (int l = q.r; l < L; l += q.rows) {
      const size_t i = base + (size_t)l * C + c;
      const float xh = m.centred(x[i]) * m.rstd;
      const float y = xh * ga + be;
      const float sg = gn_sigmoid(y);
      const float dxh = gy[i] * sg * (1.f + y * (1.f - sg)) * ga;
      dx[i] = m.rstd * (dxh - m1 - xh * m2);
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

// ---- launches (host) ------------------------------------------------------

// stats (B, G, 2) of x by plan p (one tile).
inline cudaError_t gn_stats(const float* x, float* stats, int B, int L,
                            int C, int G, float eps, GnPlan p,
                            cudaStream_t s) {
  const int cg = C / G;
  if (!gn_plan_ok(p, 1, L, cg)) return cudaErrorInvalidValue;
  if (!p.staged) {
    gn_stats_stream_kernel<<<B * G, GN_THREADS, 0, s>>>(x, stats, L, C, G,
                                                        eps);
    return cudaGetLastError();
  }
  cudaError_t err;
  if (gn_width(cg) == 4) {
    if ((err = set_smem(gn_stats_staged_kernel<4>, p.smem)) != cudaSuccess)
      return err;
    gn_stats_staged_kernel<4><<<B * G, p.threads, p.smem, s>>>(x, stats, L,
                                                               C, G, eps);
  } else {
    if ((err = set_smem(gn_stats_staged_kernel<1>, p.smem)) != cudaSuccess)
      return err;
    gn_stats_staged_kernel<1><<<B * G, p.threads, p.smem, s>>>(x, stats, L,
                                                               C, G, eps);
  }
  return cudaGetLastError();
}

// dx (B, L, C) and dgb (2 C: dgamma, dbeta) by plan p (two tiles); stats
// (B, G, 2) or null; part (B, 2, C) scratch.
inline cudaError_t gn_silu_bwd(const float* x, const float* gamma,
                               const float* beta, const float* gy,
                               const float* stats, float* dx, float* part,
                               float* dgb, int B, int L, int C, int G,
                               float eps, GnPlan p, cudaStream_t s) {
  const int cg = C / G;
  if (!gn_plan_ok(p, 2, L, cg)) return cudaErrorInvalidValue;
  cudaError_t err;
  if (!p.staged) {
    gn_bwd_stream_kernel<<<B * G, GN_THREADS, 0, s>>>(
        x, gamma, beta, gy, stats, dx, part, L, C, G, eps);
  } else if (gn_width(cg) == 4) {
    if ((err = set_smem(gn_bwd_staged_kernel<4>, p.smem)) != cudaSuccess)
      return err;
    gn_bwd_staged_kernel<4><<<B * G, p.threads, p.smem, s>>>(
        x, gamma, beta, gy, stats, dx, part, L, C, G, eps);
  } else {
    if ((err = set_smem(gn_bwd_staged_kernel<1>, p.smem)) != cudaSuccess)
      return err;
    gn_bwd_staged_kernel<1><<<B * G, p.threads, p.smem, s>>>(
        x, gamma, beta, gy, stats, dx, part, L, C, G, eps);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_rows_kernel<<<(2 * C + 255) / 256, 256, 0, s>>>(part, dgb, B, 2 * C);
  return cudaGetLastError();
}

}  // namespace
