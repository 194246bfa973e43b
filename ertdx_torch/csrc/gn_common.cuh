// GroupNorm pieces shared by groupnorm.cu and gn_conv.cu (sm_90a).
//
// Every piece takes x (TX) and, in the backward, the upstream gradient
// (TG) as float or __nv_bfloat16; the output (y, dx) is in x's type, as
// the TPU kernels write it (ertdx/ops/groupnorm.py:74, 163-170). Values
// convert to float on load and round once on store (to nearest even);
// the statistics, the affine table and the dgamma/dbeta partials are
// float32 whatever the inputs. The fused conv's backward runs the GN
// backward with a bf16 x and a float32 gradient (dh stays float32, as in
// ertdx/ops/conv.py:166-171).
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
//     there. Thread t owns one unit of W channels (float x: W = 4, a
//     float4, when cg % 4 == 0; bf16 x: W = 8 when cg % 8 == 0; else W =
//     1) of the positions l = t / U, t / U + R, ...
//     (U = cg / W units a position, R = T / U, T a multiple of U and of
//     32): it stages them and is the only thread that reads them back, so
//     the copy needs cp.async.wait_all and no barrier, a warp moves whole
//     runs of a position's channels, and each thread's channel is fixed.
//     Staging 4-byte-wide for cg % 4 != 0 keeps one kernel for every cg;
//     the wrappers take 16-byte aligned x and upstream gradients only
//     (the autograd paths copy a misaligned one). A bf16 unit is 8
//     values, one 16-byte cp.async.cg (the L2-only copy takes 16 bytes
//     and no fewer): at the stem a group is 16 channels, 32 bytes of a
//     256-byte position, i.e. two such units, so a warp moves 16 whole
//     group rows with one instruction a thread; 4-value units would take
//     8-byte cp.async.ca through L1, twice the copies. A bf16 value of
//     an odd group (W = 1) is copied by a plain load and store. A bf16
//     tile is half the float tile's bytes, so more shapes stage
//     (ops/groupnorm.py::launch_plan takes the element sizes). Where the
//     gradient is float32 the backward keeps dxh in its staged tile, as
//     the float kernel does; a bf16 tile cannot hold it, so the second
//     pass recomputes dxh from the staged x and gradient.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bf16mma.cuh"

namespace {

constexpr int GN_THREADS = 256;        // the streamed kernels' block
constexpr int GN_MAX_THREADS = 512;    // the staged kernels' largest block
constexpr int GN_SMEM_MAX = 232448;    // shared memory a block may use
constexpr int GN_STREAM_RED = 4 * GN_THREADS / 32;  // streamed sum slots

using bf16mma::bf16;

// The host's choice (ops/groupnorm.py::launch_plan): the staged or the
// streamed kernel, its block size and its dynamic shared-memory bytes.
struct GnPlan {
  int staged, threads, smem;
};

// The channels of a thread's unit: a float4 of float x, 16 bytes of bf16
template <typename TX>
inline int gn_width(int cg) {
  if (sizeof(TX) == 4) return cg % 4 == 0 ? 4 : 1;
  return cg % 8 == 0 ? 8 : 1;
}

// Floats of the staged backward's per-channel scratch: the entries each
// channel's sum adds in order (one a warp after the warp tree when the
// units of a position divide 32, else one a thread), for dgamma and dbeta.
template <typename TX>
inline size_t gn_chan_floats(int cg, int threads) {
  const int units = cg / gn_width<TX>(cg);
  return 2 * (size_t)cg * (32 % units == 0 ? threads / 32 : threads / units);
}

// Bytes of a staged tile of n values of `size` bytes: float tiles as they
// are, bf16 tiles rounded up to 16 so that what follows stays aligned.
__host__ __device__ inline size_t gn_tile_bytes(size_t n, size_t size) {
  return size == 4 ? 4 * n : (2 * n + 15) & ~(size_t)15;
}

// Dynamic shared memory of a staged kernel that stages `tiles` groups
// (1: the forward and the statistics, x, two sums; 2: the backward, x and
// the gradient, four sums and the channel scratch): the tiles, then a
// slot of one float a warp for each sum, then the channel scratch.
template <typename TX, typename TG = TX>
inline size_t gn_staged_bytes(int tiles, int L, int cg, int threads) {
  const size_t n = (size_t)L * cg;
  return gn_tile_bytes(n, sizeof(TX)) +
         (tiles == 2 ? gn_tile_bytes(n, sizeof(TG)) : 0) +
         4 * ((tiles == 2 ? 4 : 2) * (size_t)(threads / 32) +
              (tiles == 2 ? gn_chan_floats<TX>(cg, threads) : 0));
}

// Whether plan p is one the kernels run for a group of L x cg values.
template <typename TX, typename TG = TX>
inline bool gn_plan_ok(GnPlan p, int tiles, int L, int cg) {
  if (!p.staged) return p.threads == GN_THREADS && p.smem == 0;
  const int units = cg / gn_width<TX>(cg);
  return p.threads >= 32 && p.threads <= GN_MAX_THREADS &&
         p.threads % 32 == 0 && p.threads % units == 0 &&
         p.smem <= GN_SMEM_MAX &&
         (size_t)p.smem == gn_staged_bytes<TX, TG>(tiles, L, cg, p.threads);
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

// bf16 <-> float: a bf16 value is the upper half of its float, so the
// conversion up is exact; down rounds to nearest even.
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// the low and high bf16 halves of a 32-bit word, as floats
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
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

// W consecutive values of type T at p as floats: 16-byte loads where the
// unit is a multiple of 16 bytes (a float4, 8 bf16 values), else one value
template <int W>
__device__ __forceinline__ void load_w(float (&v)[W], const float* p) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
    v[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void load_w(float (&v)[W], const bf16* p) {
  if constexpr (W == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = bf_lo(u[i]);
      v[2 * i + 1] = bf_hi(u[i]);
    }
  } else {
    static_assert(W == 1, "bf16 units are 8 values or one");
    v[0] = to_f(*p);
  }
}

template <int W>
__device__ __forceinline__ void store_w(float* p, const float (&v)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
    *p = v[0];
  }
}

template <int W>
__device__ __forceinline__ void store_w(bf16* p, const float (&v)[W]) {
  if constexpr (W == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(bf16mma::pack(v[0], v[1]), bf16mma::pack(v[2], v[3]),
                   bf16mma::pack(v[4], v[5]), bf16mma::pack(v[6], v[7]));
  } else {
    static_assert(W == 1, "bf16 units are 8 values or one");
    *p = from_f<bf16>(v[0]);
  }
}

// The lanes of a thread's partial sums, added pairwise
template <int W>
__device__ __forceinline__ float lanes_sum(const float (&a)[W]) {
  if constexpr (W == 8)
    return ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
  else if constexpr (W == 4)
    return (a[0] + a[1]) + (a[2] + a[3]);
  else
    return a[0];
}

// Copy W values of type T from device to shared memory: cp.async of 16
// bytes (.cg) or of 4 (.ca), or a plain copy of one bf16 value.
template <typename T, int W>
__device__ __forceinline__ void cp_async_w(T* dst, const T* src) {
  constexpr int bytes = W * (int)sizeof(T);
  if constexpr (bytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < bytes / 16; ++i) {
      const unsigned s =
          (unsigned)__cvta_generic_to_shared(reinterpret_cast<char*>(dst) +
                                             16 * i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(reinterpret_cast<const char*>(src) + 16 * i));
    }
  } else if constexpr (bytes == 4) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  } else {
    *dst = *src;
  }
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

// Where the float sum slots start after `tiles` staged tiles at smem
template <typename TX, typename TG>
__device__ __forceinline__ float* gn_red(unsigned char* smem, int tiles,
                                         int L, int cg) {
  const size_t n = (size_t)L * cg;
  return reinterpret_cast<float*>(
      smem + gn_tile_bytes(n, sizeof(TX)) +
      (tiles == 2 ? gn_tile_bytes(n, sizeof(TG)) : 0));
}

// Copy this thread's units of src's group into tile (cp.async, not waited
// for).
template <int W, typename T>
__device__ __forceinline__ void stage_group(T* tile, const T* src,
                                            const GroupWalk& w) {
  for (int l = w.l0; l < w.L; l += w.R)
    cp_async_w<T, W>(tile + (size_t)w.tile(l) * W, src + w.global(l));
}

// The moments of the staged group of x, two passes over shared memory
// (the shift, the group's first value, read from x); red slots 0 and 1.
template <int W, typename TX>
__device__ __forceinline__ Moments tile_stats(const TX* tile, const TX* x,
                                              const GroupWalk& w, float eps,
                                              float* red) {
  const float n = (float)w.L * (float)(w.U * W);
  Moments m;
  m.shift = to_f(x[w.base]);
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
template <int W, typename TX>
__global__ void __launch_bounds__(GN_MAX_THREADS)
    gn_stats_staged_kernel(const TX* __restrict__ x,
                           float* __restrict__ stats, int L, int C, int G,
                           float eps) {
  extern __shared__ __align__(16) unsigned char gn_smem[];
  TX* tile = reinterpret_cast<TX*>(gn_smem);
  const GroupWalk w = group_walk<W>(L, C, G);
  float* red = gn_red<TX, TX>(gn_smem, 1, L, C / G);
  stage_group<W>(tile, x, w);
  cp_async_wait_all();
  const Moments m = tile_stats<W>(tile, x, w, eps, red);
  if (threadIdx.x == 0) {
    stats[2 * (size_t)blockIdx.x] = m.group_mean();
    stats[2 * (size_t)blockIdx.x + 1] = m.rstd;
  }
}

// dxh = dy gamma of one value, from x_hat, the upstream gradient d, and
// the channel's gamma and beta (the SiLU chain rule on y = x_hat gamma +
// beta); dy in *dyo.
__device__ __forceinline__ float gn_dxh(float xh, float d, float ga,
                                        float be, float* dyo) {
  const float y = fmaf(xh, ga, be);
  const float sg = gn_sigmoid(y);
  const float dy = d * sg * (1.f + y * (1.f - sg));
  *dyo = dy;
  return dy * ga;
}

// GroupNorm + SiLU backward of one (row, group), x and gy read once.
// Takes the statistics from stats (B, G, 2) where the caller has them
// (the fused conv's backward), else computes them from the staged x. Then
// one pass over the staged tiles applies the SiLU chain rule, keeps
// dxh = dy gamma in gy's place (a float32 gy; a bf16 tile cannot hold it
// and the second pass recomputes it) and sums dxh and dxh x_hat over the
// group and dy x_hat and dy over each channel's positions; a second
// writes the GN identity
//   dx = rstd (dxh - mean_g(dxh) - x_hat mean_g(dxh x_hat))
// (ertdx/ops/groupnorm.py:95-131). Per-row channel sums go to part
// (B, 2, C); sum_rows_kernel reduces them over B.
template <int W, typename TX, typename TG>
__global__ void __launch_bounds__(GN_MAX_THREADS)
    gn_bwd_staged_kernel(const TX* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         const TG* __restrict__ gy,
                         const float* __restrict__ stats,
                         TX* __restrict__ dx, float* __restrict__ part,
                         int L, int C, int G, float eps) {
  constexpr bool keep = sizeof(TG) == 4;   // dxh kept in gy's tile
  extern __shared__ __align__(16) unsigned char gn_smem[];
  const GroupWalk w = group_walk<W>(L, C, G);
  const int cg = C / G;
  TX* xs = reinterpret_cast<TX*>(gn_smem);
  TG* ds = reinterpret_cast<TG*>(gn_smem +
                                 gn_tile_bytes((size_t)L * cg, sizeof(TX)));
  float* red = gn_red<TX, TG>(gn_smem, 2, L, cg);
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
      float dy;
      d[k] = gn_dxh(xh, d[k], ga[k], be[k], &dy);
      pg[k] = fmaf(dy, xh, pg[k]);
      pb[k] += dy;
      s1[k] += d[k];
      s2[k] = fmaf(d[k], xh, s2[k]);
    }
    if constexpr (keep) store_w<W>(ds + i, d);
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
      if constexpr (!keep) {
        float dy;
        d[k] = gn_dxh(xh, d[k], ga[k], be[k], &dy);
      }
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
template <typename TX>
__device__ __forceinline__ Moments group_stats(const TX* __restrict__ x,
                                               int b, int g, int L, int C,
                                               int cg, float eps,
                                               float* red) {
  const GroupLanes q = group_lanes(cg);
  const TX* xb = x + (size_t)b * L * C + (size_t)g * cg;
  const float n = (float)L * (float)cg;
  Moments m;
  m.shift = to_f(xb[0]);
  float s = 0.f, ss = 0.f;
  if (q.r < q.rows) {
    for (int c = q.c; c < cg; c += q.lanes) {
#pragma unroll 4
      for (int l = q.r; l < L; l += q.rows)
        s += to_f(xb[(size_t)l * C + c]) - m.shift;
    }
  }
  m.mean = block_sum(s, red) / n;
  if (q.r < q.rows) {
    for (int c = q.c; c < cg; c += q.lanes) {
#pragma unroll 4
      for (int l = q.r; l < L; l += q.rows) {
        const float d = m.centred(to_f(xb[(size_t)l * C + c]));
        ss += d * d;
      }
    }
  }
  m.rstd = rsqrtf(block_sum(ss, slot(red, 1)) / n + eps);
  return m;
}

template <typename TX>
__global__ void __launch_bounds__(GN_THREADS)
    gn_stats_stream_kernel(const TX* __restrict__ x,
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
template <typename TX, typename TG>
__global__ void __launch_bounds__(GN_THREADS)
    gn_bwd_stream_kernel(const TX* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         const TG* __restrict__ gy,
                         const float* __restrict__ stats,
                         TX* __restrict__ dx, float* __restrict__ part,
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
        const float xh = m.centred(to_f(x[i])) * m.rstd;
        const float y = xh * ga + be;
        const float sg = gn_sigmoid(y);
        const float dy = to_f(gy[i]) * sg * (1.f + y * (1.f - sg));
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
      const float xh = m.centred(to_f(x[i])) * m.rstd;
      const float y = xh * ga + be;
      const float sg = gn_sigmoid(y);
      const float dxh = to_f(gy[i]) * sg * (1.f + y * (1.f - sg)) * ga;
      dx[i] = from_f<TX>(m.rstd * (dxh - m1 - xh * m2));
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

// Launch kernel<W> for the unit width of TX at cg (gn_width): W = 4 or 1
// for float x, 8 or 1 for bf16 x. `launch(std::integral_constant<int,
// W>)` sets the kernel's shared memory and launches it.
template <typename TX, typename Launch>
cudaError_t gn_by_width(int cg, Launch launch) {
  constexpr int wide = sizeof(TX) == 4 ? 4 : 8;
  if (gn_width<TX>(cg) == wide)
    return launch(std::integral_constant<int, wide>());
  return launch(std::integral_constant<int, 1>());
}

// stats (B, G, 2) of x by plan p (one tile).
template <typename TX>
inline cudaError_t gn_stats(const TX* x, float* stats, int B, int L, int C,
                            int G, float eps, GnPlan p, cudaStream_t s) {
  const int cg = C / G;
  if (!gn_plan_ok<TX>(p, 1, L, cg)) return cudaErrorInvalidValue;
  if (!p.staged) {
    gn_stats_stream_kernel<TX><<<B * G, GN_THREADS, 0, s>>>(x, stats, L, C,
                                                            G, eps);
    return cudaGetLastError();
  }
  return gn_by_width<TX>(cg, [&](auto wc) {
    constexpr int W = decltype(wc)::value;
    cudaError_t err = set_smem(gn_stats_staged_kernel<W, TX>, p.smem);
    if (err != cudaSuccess) return err;
    gn_stats_staged_kernel<W, TX><<<B * G, p.threads, p.smem, s>>>(
        x, stats, L, C, G, eps);
    return cudaGetLastError();
  });
}

// dx (B, L, C) and dgb (2 C: dgamma, dbeta) by plan p (two tiles); stats
// (B, G, 2) or null; part (B, 2, C) scratch.
template <typename TX, typename TG>
inline cudaError_t gn_silu_bwd(const TX* x, const float* gamma,
                               const float* beta, const TG* gy,
                               const float* stats, TX* dx, float* part,
                               float* dgb, int B, int L, int C, int G,
                               float eps, GnPlan p, cudaStream_t s) {
  const int cg = C / G;
  if (!gn_plan_ok<TX, TG>(p, 2, L, cg)) return cudaErrorInvalidValue;
  cudaError_t err;
  if (!p.staged) {
    gn_bwd_stream_kernel<TX, TG><<<B * G, GN_THREADS, 0, s>>>(
        x, gamma, beta, gy, stats, dx, part, L, C, G, eps);
    err = cudaGetLastError();
  } else {
    err = gn_by_width<TX>(cg, [&](auto wc) {
      constexpr int W = decltype(wc)::value;
      cudaError_t e = set_smem(gn_bwd_staged_kernel<W, TX, TG>, p.smem);
      if (e != cudaSuccess) return e;
      gn_bwd_staged_kernel<W, TX, TG><<<B * G, p.threads, p.smem, s>>>(
          x, gamma, beta, gy, stats, dx, part, L, C, G, eps);
      return cudaGetLastError();
    });
  }
  if (err != cudaSuccess) return err;
  sum_rows_kernel<<<(2 * C + 255) / 256, 256, 0, s>>>(part, dgb, B, 2 * C);
  return cudaGetLastError();
}

}  // namespace
