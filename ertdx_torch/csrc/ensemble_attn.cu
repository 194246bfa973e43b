// Ensemble attention kernels for the per-block denoiser core (sm_90a).
//
// Replaces the TPU kernels of ertdx/ops/ensemble_attn.py:
//   * block_self_kernel   <- block_self_attention (_block_self_kernel):
//     softmax(q k^T / sqrt(D)) v for each of N chains of P tokens;
//   * folded_cross_kernel <- folded_cross_attention (_folded_cross_kernel):
//     the B x Lq folded chain queries of each condition against that
//     condition's Lk keys and values.
// Both compute exactly the function of the TPU kernels and of
// ertdx_torch/ops/ensemble_attn.py::reference_attention, in fp32.
//
// What bounds them on an H100 (67 TFLOP/s fp32, 3.35 TB/s):
//   * self: bytes. 4 N P^2 D flops on 16 N P D bytes, i.e. P / 4 = 7 flops
//     a byte at P = 29, far below the card's 20. At N = 2000 chains the
//     bound is 119 MB / 3.35 TB/s = 0.035 ms.
//   * cross: operations. 4 B Lq Lk D flops; K and V are read once per
//     condition, so at B = 2, Lq = 29,000, Lk = 147 it is 4.37 GFLOP
//     against 60 MB: 0.065 ms.
//
// What the design does about it, and what it changes from the TPU kernels:
//   * No 8-chain block-diagonal (8P x 8P) logit tile with 7/8 of it masked
//     (_block_self_kernel), and no padding of Lk to 128 with a column mask
//     (_folded_cross_forward): the logits are computed for the valid keys
//     only.
//   * One CUDA block stages one key set in shared memory (a chain's P rows
//     of q, K and V for self; a condition's Lk rows of K and V, 2 x 147 x
//     132 x 4 B = 155 KB at D = 128, for cross), with coalesced 16-byte
//     loads. Rows are padded to D + 4 floats, so that 8 lanes reading 8
//     different K rows with 16-byte loads hit 32 different banks.
//   * A warp takes RW = 8 query rows at a time, from shared memory (the
//     cross kernel copies each group's q rows into the warp's buffer).
//     Lane j owns keys j, j + 32, ...: per 4-float slice of D it reads the
//     8 query slices as broadcasts and one slice of each of its keys, 32
//     FMAs per key slice. The softmax runs in registers with warp shuffles
//     (one pass: all keys are resident). The probabilities go to the
//     warp's buffer once, key-major, so that in p v, where lane c owns D/32
//     output columns, each key costs two 16-byte broadcasts and one V read
//     for 8 rows x D/32 columns of FMAs. That keeps both loops under one
//     shared-memory wavefront per four FMA instructions, the rate at
//     which the FMA pipe and not shared memory is the limit.
//   * The cross kernel runs as many blocks per condition as fill the card
//     once (one block per SM at Lk = 147), each walking query row groups
//     with a grid stride, so K and V are staged once per block, not once
//     per tile of queries.
//   * q, k and v may be row-strided views (the chunks of the fused
//     projections), so the wrapper copies nothing.
// Every product is an fp32 FMA on the CUDA cores; tensor cores and TMA are
// later work.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int RW = 8;                  // query rows a warp takes at a time
constexpr int SELF_THREADS = 128;      // 4 warps x 8 rows >= P
constexpr int CROSS_THREADS = 256;
constexpr int CROSS_WARPS = CROSS_THREADS / 32;
constexpr int MMAX = 8;                // key chunks of 32: Lk <= 256
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Copy nrows rows of D floats (global row stride ld) into shared memory at
// row stride lds, 16 bytes a load, spread over `threads` threads from
// `tid`; rows from nrows up to pad_rows are filled with zeros.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, int lds,
                                           const float* __restrict__ src,
                                           long ld, int nrows, int pad_rows,
                                           int tid, int threads) {
  constexpr int Q = D / 4;
  for (int e = tid; e < pad_rows * Q; e += threads) {
    const int r = e / Q, c = (e % Q) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows)
      val = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * ld + c));
    *reinterpret_cast<float4*>(dst + r * lds + c) = val;
  }
}

template <int N> struct Cols;
template <> struct Cols<2> {
  __device__ static void load(const float* p, float* o) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
  __device__ static void store(float* p, const float* o) {
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  }
};
template <> struct Cols<4> {
  __device__ static void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ static void store(float* p, const float* o) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};

// One warp: the RW query rows in shared memory at Qs (row stride ldq)
// against the nkeys keys and values in Ks / Vs (shared memory, row stride
// D + 4), out rows row0 .. row0 + RW - 1 of which those below nrows are
// written (global, row stride D). KC = key chunks of 32 (nkeys <= 32 KC).
// Pbuf is the warp's own buffer of 32 KC x RW floats; it may alias Qs.
template <int D, int KC>
__device__ __forceinline__ void attend_rows(const float* Qs, int ldq,
                                            const float* Ks, const float* Vs,
                                            int nkeys, float scale,
                                            float* Pbuf, int row0, int nrows,
                                            float* __restrict__ out) {
  constexpr int LDS = D + 4;
  constexpr int NC = D / 32;
  const int lane = threadIdx.x & 31;

  // logits: lane owns keys lane, lane + 32, ...; 8 rows x KC keys of FMAs
  // per 16-byte K read, the q slices read as broadcasts
  float s[RW][KC];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int m = 0; m < KC; ++m) s[r][m] = 0.0f;
  const float* krow[KC];
#pragma unroll
  for (int m = 0; m < KC; ++m)
    krow[m] = Ks + min(m * 32 + lane, nkeys - 1) * LDS;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qv[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r)
      qv[r] = *reinterpret_cast<const float4*>(Qs + r * ldq + d);
#pragma unroll
    for (int m = 0; m < KC; ++m) {
      const float4 kv = *reinterpret_cast<const float4*>(krow[m] + d);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        s[r][m] = fmaf(qv[r].x, kv.x, s[r][m]);
        s[r][m] = fmaf(qv[r].y, kv.y, s[r][m]);
        s[r][m] = fmaf(qv[r].z, kv.z, s[r][m]);
        s[r][m] = fmaf(qv[r].w, kv.w, s[r][m]);
      }
    }
  }

  // one-pass softmax per row in registers (every key is resident)
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int m = 0; m < KC; ++m) {
      s[r][m] = m * 32 + lane < nkeys ? s[r][m] * scale : -INFINITY;
      mx = fmaxf(mx, s[r][m]);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int m = 0; m < KC; ++m) {
      const float e = m * 32 + lane < nkeys ? expf(s[r][m] - mx) : 0.0f;
      s[r][m] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
#pragma unroll
    for (int m = 0; m < KC; ++m) s[r][m] *= inv;
  }
  __syncwarp();   // every lane is done with Qs, which Pbuf may alias
#pragma unroll
  for (int m = 0; m < KC; ++m) {
    float* pj = Pbuf + (m * 32 + lane) * RW;   // key j's RW probabilities
    *reinterpret_cast<float4*>(pj) =
        make_float4(s[0][m], s[1][m], s[2][m], s[3][m]);
    *reinterpret_cast<float4*>(pj + 4) =
        make_float4(s[4][m], s[5][m], s[6][m], s[7][m]);
  }
  __syncwarp();

  // p v: lane owns output columns [lane NC, lane NC + NC); per key one V
  // read serves the 8 rows, whose probabilities arrive as two broadcasts
  float acc[RW][NC];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < nkeys; ++j) {
    float vv[NC];
    Cols<NC>::load(Vs + j * LDS + lane * NC, vv);
    const float4 p0 = *reinterpret_cast<const float4*>(Pbuf + j * RW);
    const float4 p1 = *reinterpret_cast<const float4*>(Pbuf + j * RW + 4);
    const float pr[RW] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pr[r], vv[c], acc[r][c]);
  }
  __syncwarp();   // Pbuf is read by every lane before the warp reuses it
#pragma unroll
  for (int r = 0; r < RW; ++r)
    if (row0 + r < nrows)
      Cols<NC>::store(out + (size_t)(row0 + r) * D + lane * NC, acc[r]);
}

// One block per chain: the chain's P rows of q, K and V in shared memory;
// warp w takes query rows 8w .. 8w + 7.
template <int D>
__global__ void __launch_bounds__(SELF_THREADS)
    block_self_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      long ldq, long ldk, long ldv, int P, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDS = D + 4;
  constexpr int WARPS = SELF_THREADS / 32;
  float* Qs = smem;                       // WARPS * RW rows, zero padded
  float* Ks = Qs + WARPS * RW * LDS;
  float* Vs = Ks + P * LDS;
  float* Pb = Vs + P * LDS;               // WARPS x (32 x RW)
  const size_t chain = blockIdx.x;
  stage_rows<D>(Qs, LDS, q + chain * P * ldq, ldq, P, WARPS * RW,
                threadIdx.x, SELF_THREADS);
  stage_rows<D>(Ks, LDS, k + chain * P * ldk, ldk, P, P, threadIdx.x,
                SELF_THREADS);
  stage_rows<D>(Vs, LDS, v + chain * P * ldv, ldv, P, P, threadIdx.x,
                SELF_THREADS);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp * RW < P)
    attend_rows<D, 1>(Qs + warp * RW * LDS, LDS, Ks, Vs, P, scale,
                      Pb + warp * 32 * RW, warp * RW, P, out + chain * P * D);
}

// gridDim.y = B conditions, gridDim.x blocks per condition: each stages its
// condition's Lk keys and values once, then its warps walk the condition's
// Lq query rows in groups of RW with a grid stride, each group's q rows
// copied into the warp's buffer, which then holds its probabilities.
template <int D, int KC>
__global__ void __launch_bounds__(CROSS_THREADS)
    folded_cross_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        long ldq, long ldk, long ldv, int Lq, int Lk,
                        float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDS = D + 4;
  constexpr int BUF = RW * (D > 32 * KC ? D : 32 * KC);
  float* Ks = smem;
  float* Vs = Ks + Lk * LDS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* buf = Vs + Lk * LDS + warp * BUF;
  const size_t b = blockIdx.y;
  stage_rows<D>(Ks, LDS, k + b * Lk * ldk, ldk, Lk, Lk, threadIdx.x,
                CROSS_THREADS);
  stage_rows<D>(Vs, LDS, v + b * Lk * ldv, ldv, Lk, Lk, threadIdx.x,
                CROSS_THREADS);
  __syncthreads();
  const float* qb = q + b * Lq * ldq;
  const int groups = (Lq + RW - 1) / RW;
  for (int g = blockIdx.x * CROSS_WARPS + warp; g < groups;
       g += gridDim.x * CROSS_WARPS) {
    const int row0 = g * RW;
    stage_rows<D>(buf, D, qb + (size_t)row0 * ldq, ldq, min(RW, Lq - row0),
                  RW, lane, 32);
    __syncwarp();
    attend_rows<D, KC>(buf, D, Ks, Vs, Lk, scale, buf, row0, Lq,
                       out + b * Lq * D);
  }
}

size_t kv_smem_bytes(int rows, int D) {
  return (size_t)2 * rows * (D + 4) * sizeof(float);
}

constexpr size_t SMEM_LIMIT = 232448;  // bytes a block may use on sm_90

size_t self_smem_bytes(int P, int D) {
  constexpr int WARPS = SELF_THREADS / 32;
  return kv_smem_bytes(P, D) +
         (size_t)WARPS * RW * ((D + 4) + 32) * sizeof(float);
}

size_t cross_smem_bytes(int Lk, int D) {
  const int kc32 = (Lk + 31) / 32 * 32;
  return kv_smem_bytes(Lk, D) +
         (size_t)CROSS_WARPS * RW * (D > kc32 ? D : kc32) * sizeof(float);
}

constexpr int MAX_DEVICES = 64;

// Per device and kernel, what a launch needs from the runtime, queried
// once: the shared-memory limit is raised at the first launch and the SM
// count and blocks per SM are kept, so that a launch costs the host no
// more than the launch itself. Keyed by the kernel's shared memory, which
// is all the occupancy depends on here.
struct LaunchCache {
  bool raised = false;
  int sms = 0;
  size_t smem = 0;
  int per_sm = 0;
};

template <typename K>
cudaError_t prepare(K kernel, LaunchCache* caches, size_t smem_max,
                    int threads, size_t smem, int* slots) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  LaunchCache& c = caches[dev];
  if (!c.raised) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    c.raised = true;
  }
  if (slots != nullptr) {
    if (c.smem != smem) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kernel,
                                                          threads, smem);
      if (err != cudaSuccess) return err;
      c.smem = smem;
    }
    if (c.per_sm < 1) return cudaErrorInvalidConfiguration;
    *slots = c.sms * c.per_sm;
  }
  return cudaSuccess;
}

template <int D>
int launch_self(const float* q, const float* k, const float* v, float* out,
                long ldq, long ldk, long ldv, int N, int P,
                cudaStream_t stream) {
  static LaunchCache caches[MAX_DEVICES];
  const size_t smem = self_smem_bytes(P, D);
  cudaError_t err = prepare(block_self_kernel<D>, caches,
                            self_smem_bytes(32, D), SELF_THREADS, smem,
                            nullptr);
  if (err != cudaSuccess) return (int)err;
  block_self_kernel<D><<<N, SELF_THREADS, smem, stream>>>(
      q, k, v, out, ldq, ldk, ldv, P, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D, int KC>
int launch_cross(const float* q, const float* k, const float* v, float* out,
                 long ldq, long ldk, long ldv, int B, int Lq, int Lk,
                 cudaStream_t stream) {
  static LaunchCache caches[MAX_DEVICES];
  const size_t smem = cross_smem_bytes(Lk, D);
  int slots = 0;
  cudaError_t err = prepare(folded_cross_kernel<D, KC>, caches, SMEM_LIMIT,
                            CROSS_THREADS, smem, &slots);
  if (err != cudaSuccess) return (int)err;
  // fill the card once; never more blocks than a condition has row groups
  const int groups = (Lq + RW - 1) / RW;
  int gx = slots / B;
  gx = max(1, min(gx, (groups + CROSS_WARPS - 1) / CROSS_WARPS));
  folded_cross_kernel<D, KC><<<dim3(gx, B), CROSS_THREADS, smem, stream>>>(
      q, k, v, out, ldq, ldk, ldv, Lq, Lk, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_cross_kc(const float* q, const float* k, const float* v,
                    float* out, long ldq, long ldk, long ldv, int B, int Lq,
                    int Lk, cudaStream_t s) {
  switch ((Lk + 31) / 32) {
    case 1: return launch_cross<D, 1>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
    case 2: return launch_cross<D, 2>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
    case 3: return launch_cross<D, 3>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
    case 4: return launch_cross<D, 4>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
    case 5: return launch_cross<D, 5>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
    case 6: return launch_cross<D, 6>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
    case 7: return launch_cross<D, 7>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
    case 8: return launch_cross<D, 8>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool strides_ok(long ldq, long ldk, long ldv, int D) {
  return ldq >= D && ldk >= D && ldv >= D && ldq % 4 == 0 && ldk % 4 == 0 &&
         ldv % 4 == 0;
}

}  // namespace

extern "C" {

int ertdx_block_self_attn(const float* q, const float* k, const float* v,
                          float* out, long ldq, long ldk, long ldv, int N,
                          int P, int D, void* stream) {
  if (N < 1 || P < 1 || P > 32 || !strides_ok(ldq, ldk, ldv, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128) return launch_self<128>(q, k, v, out, ldq, ldk, ldv, N, P, s);
  if (D == 64) return launch_self<64>(q, k, v, out, ldq, ldk, ldv, N, P, s);
  return (int)cudaErrorInvalidValue;
}

int ertdx_folded_cross_attn(const float* q, const float* k, const float* v,
                            float* out, long ldq, long ldk, long ldv, int B,
                            int Lq, int Lk, int D, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Lk > 32 * MMAX ||
      cross_smem_bytes(Lk, D) > SMEM_LIMIT || !strides_ok(ldq, ldk, ldv, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128)
    return launch_cross_kc<128>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
  if (D == 64)
    return launch_cross_kc<64>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
