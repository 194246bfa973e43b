// Ensemble attention kernels for the per-block denoiser core (sm_90a).
//
// Replaces the TPU kernels of ertdx/ops/ensemble_attn.py:
//   * block_self_kernel   <- block_self_attention (_block_self_kernel):
//     softmax(q k^T / sqrt(D)) v for each of N chains of P tokens;
//   * folded_cross_kernel <- folded_cross_attention (_folded_cross_kernel):
//     the B x Lq folded chain queries of each condition against that
//     condition's Lk keys and values.
// Both compute exactly the function of the TPU kernels and of
// ertdx_torch/ops/ensemble_attn.py::reference_attention, fp32-class.
//
// What bounds them on an H100 (3.35 TB/s; 67 TFLOP/s on the fp32 pipe,
// 495 / 3 = 165 TFLOP/s for 3xTF32 products on the tensor cores):
//   * self: bytes. 4 N P^2 D flops on 16 N P D bytes, i.e. P / 4 = 7 flops
//     a byte at P = 29. At N = 2000 chains the bound is 119 MB / 3.35 TB/s
//     = 0.035 ms.
//   * cross: operations. 4 B Lq Lk D flops; K and V are read once per
//     condition, so at B = 2, Lq = 29,000, Lk = 147 it is 4.37 GFLOP
//     against 60 MB: 0.0265 ms as 3xTF32, 0.065 ms on the fp32 pipe.
//
// What the design does about it, and what it changes from the TPU kernels:
//   * No 8-chain block-diagonal (8P x 8P) logit tile with 7/8 of it masked
//     (_block_self_kernel), and no padding of Lk to 128
//     (_folded_cross_forward): the logits are computed for one chain's
//     keys padded to 32, or for Lk keys padded to a bucket of 8-key tiles
//     (8, 16, 19, 24, 32 of them), the padding masked.
//   * Both kernels run every product on the 3xTF32 tile of tf32x3.cuh
//     (mma.sync m16n8k8, each operand split into two TF32 halves, three
//     MMAs a k step) in one device function, attend_tile: a warp's 16 q
//     rows against a key set resident in shared memory. One TF32 rounding
//     misses the 1e-4 gate by 4-9x (tests/test_torch_ensemble_tf32x3.py).
//     The logits of a row stay in registers, in one pass up to 19 key
//     tiles, above that 8 at a time under an online softmax; the
//     softmax runs on the fragments and P feeds P V straight from them
//     (from_c). P V accumulates on the MMA: its error at phase 8's shapes
//     is 4.6e-6 against the 1e-4 gate, and summing each 32-key chunk from
//     zero (the fused core's choice) spilled at D = 128 and was slower
//     (tools/ensemble_ab.py; PERF.md). q is not scaled: the scale goes
//     into exp2's argument. Shared-memory rows are D + 4 floats
//     (conflict-free nt and nn loads), staged with 16-byte cp.async.
//   * folded_cross_kernel: a block stages one condition's K and V once
//     (160,512 bytes at Lk = 147, D = 128), and the grid is one wave of
//     one block an SM, up to 8 warps (16 rows of q each in the rest of
//     232,448 bytes) at up to 255 registers a thread; each warp walks
//     16-row query tiles of its condition with a stride. A warp's next q
//     tile is staged into its buffer with cp.async as soon as the current
//     tile's logits are computed, so the copy runs under the softmax and
//     P V.
//   * block_self_kernel: an FMA version's logits and p v set its pace
//     (0.061 ms without any load against 0.036 ms of loads alone on an
//     H100; PERF.md), so it runs on the same tile, and what matters is how
//     the bytes arrive. The grid is persistent (two blocks of 2 warps an
//     SM at D = 128), each block walks chains with a double-buffered
//     cp.async ring, staging chain c + grid's q, k and v while chain c
//     computes; rows P .. 31, which the tiles read, are zeroed once.
//   * q, k and v may be row-strided views (the chunks of the fused
//     projections), so the wrapper copies nothing; their rows must start
//     on 16-byte boundaries (strides a multiple of 4 floats; the wrapper
//     checks the base).
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

constexpr int SELF_THREADS = 64;       // 2 warps of 16 rows: P <= 32
constexpr int SELF_ROWS = 32;          // q, k and v rows a chain is padded to
constexpr int CROSS_WARPS = 8;         // at most, a block (cross)
constexpr float LOG2E = 1.4426950408889634f;

// One warp: softmax(q k^T scale) v for the 16 query rows at W (shared,
// row stride D + 4) against the nkeys keys and values in Ks / Vs (shared,
// row stride D + 4, 8 NT rows, zero past nkeys); out rows row0 + 0 .. 15
// of which those below nrows are written (global, row stride D).
//   * The logits are NT n tiles of 8 keys, taken in chunks of KC n tiles
//     (KC = NT: one pass; else an online softmax over the chunks), each
//     accumulated on the MMA over D. Once the last chunk's logits are
//     computed W is no longer read, and where qnext is not null the next
//     16 q rows (qnext, row stride ldq, qrows of them valid) are staged
//     into it with cp.async, to land while this tile runs its softmax and
//     P V.
//   * P V accumulates on the MMA, D / 8 independent chains a k step.
//   * scale_log2 = log2(e) / sqrt(D): the logits stay unscaled and the
//     scale goes into exp2's argument.
template <int D, int NT, int KC>
__device__ __forceinline__ void attend_tile(float* W, const float* Ks,
                                            const float* Vs, int nkeys,
                                            float scale_log2, float* out,
                                            int row0, int nrows,
                                            const float* qnext, long ldq,
                                            int qrows) {
  using namespace tf32x3;
  constexpr int LD = D + 4, NN = D / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // running max (of the raw logits) and sum of rows g and g+8, the sum per
  // thread over its keys, added up over the quad at the end; chunk 0
  // holds key 0, so the max is finite from the first chunk on
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  float acc[NN][4] = {};
#pragma unroll
  for (int c = 0; c < NT; c += KC) {
    // S = q k^T over the chunk's keys
    float p[KC][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 8) {
      FragA a;
      load_a(a, W, LD, 0, k0, lane);
#pragma unroll
      for (int j = 0; j < KC; ++j)
        if (c + j < NT) {
          FragB f;
          load_b_nt(f, Ks, LD, 8 * (c + j), k0, lane);
          mma3(p[j], a, f);
        }
    }
    if (c + KC >= NT && qnext != nullptr) {
      __syncwarp();                                // W is read
      stage<D>(W, LD, qnext, ldq, 16, qrows, threadIdx.x - lane, 32);
      cp_commit();
    }

    // softmax over the keys < nkeys: -inf before the max, so p = 0 past it
    float cm[2] = {mx[0], mx[1]};
#pragma unroll
    for (int j = 0; j < KC; ++j)
      if (c + j < NT)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * (c + j) + 2 * t + (e & 1);
          if (key >= nkeys) p[j][e] = -INFINITY;
          cm[e >> 1] = fmaxf(cm[e >> 1], p[j][e]);
        }
    cm[0] = quad_max(cm[0]);
    cm[1] = quad_max(cm[1]);
    if (c > 0) {
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[r] = exp2f((mx[r] - cm[r]) * scale_log2);
        sum[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    }
    mx[0] = cm[0];
    mx[1] = cm[1];
    const float off[2] = {mx[0] * scale_log2, mx[1] * scale_log2};
#pragma unroll
    for (int j = 0; j < KC; ++j)
      if (c + j < NT)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[j][e] = exp2f(fmaf(p[j][e], scale_log2, -off[e >> 1]));
          sum[e >> 1] += p[j][e];
        }

    // O += P V, accumulated on the MMA
#pragma unroll
    for (int j = 0; j < KC; ++j)
      if (c + j < NT) {
        FragA a;
        from_c(a, p[j]);
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          FragB f;
          load_b_nn(f, Vs, LD, 8 * (c + j), 8 * n, lane);
          mma3(acc[n], a, f);
        }
      }
  }
  const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row < nrows) {
      float* o = out + (size_t)row * D + 2 * t;
#pragma unroll
      for (int n = 0; n < NN; ++n)
        *reinterpret_cast<float2*>(o + 8 * n) =
            make_float2(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
    }
  }
}

// Persistent: block x takes chains x, x + gridDim.x, ... Two stages of
// (SELF_ROWS rows of q, of K, of V) in shared memory; chain c + gridDim.x
// is staged with cp.async into the other stage while chain c computes.
// Warp w takes query rows 16 w .. 16 w + 15 against the chain's P keys.
template <int D>
__global__ void __launch_bounds__(SELF_THREADS)
    block_self_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      long ldq, long ldk, long ldv, int N, int P,
                      float scale_log2) {
  using namespace tf32x3;
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = D + 4, STAGE = 3 * SELF_ROWS * LD;
  const int warp = threadIdx.x >> 5;
  // rows P .. SELF_ROWS - 1 of q, K and V in both stages: read by the
  // tiles, never staged
  for (int e = threadIdx.x; e < (SELF_ROWS - P) * D; e += SELF_THREADS) {
    const int r = P + e / D, c = e % D;
#pragma unroll
    for (int m = 0; m < 6; ++m) smem[(m * SELF_ROWS + r) * LD + c] = 0.0f;
  }
  auto issue = [&](int chain, int s) {
    if (chain < N) {
      float* Qs = smem + s * STAGE;
      const size_t row = (size_t)chain * P;
      stage<D>(Qs, LD, q + row * ldq, ldq, P, P, 0, SELF_THREADS);
      stage<D>(Qs + SELF_ROWS * LD, LD, k + row * ldk, ldk, P, P, 0,
               SELF_THREADS);
      stage<D>(Qs + 2 * SELF_ROWS * LD, LD, v + row * ldv, ldv, P, P, 0,
               SELF_THREADS);
    }
    cp_commit();
  };
  issue(blockIdx.x, 0);
  int s = 0;
  for (int chain = blockIdx.x; chain < N; chain += gridDim.x, s ^= 1) {
    issue(chain + gridDim.x, s ^ 1);
    cp_wait<1>();                          // this chain's group has landed
    __syncthreads();
    float* Qs = smem + s * STAGE;
    if (16 * warp < P)
      attend_tile<D, SELF_ROWS / 8, SELF_ROWS / 8>(
          Qs + 16 * warp * LD, Qs + SELF_ROWS * LD, Qs + 2 * SELF_ROWS * LD,
          P, scale_log2, out + (size_t)chain * P * D, 16 * warp, P, nullptr,
          0, 0);
    __syncthreads();                       // stage s is free for reuse
  }
}

// gridDim.y = B conditions, gridDim.x blocks per condition (one wave):
// each stages its condition's K and V once (8 NT rows, zero past Lk), then
// warp w of block x walks the condition's 16-row query tiles x W + w,
// x W + w + gridDim.x W, ... (W warps a block), each staged into the
// warp's buffer while the tile before it runs its softmax and P V.
template <int D, int NT, int KC>
__global__ void __launch_bounds__(32 * CROSS_WARPS, 1)
    folded_cross_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        long ldq, long ldk, long ldv, int Lq, int Lk,
                        float scale_log2) {
  using namespace tf32x3;
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = D + 4, KN = 8 * NT;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const size_t b = blockIdx.y;
  float* Ks = smem;                                // (KN, LD)
  float* Vs = Ks + KN * LD;                        // (KN, LD)
  float* W = Vs + KN * LD + warp * 16 * LD;        // this warp's 16 q rows
  const float* qb = q + b * Lq * ldq;
  const int tiles = (Lq + 15) / 16;
  const int step = gridDim.x * warps;
  stage<D>(Ks, LD, k + b * Lk * ldk, ldk, KN, Lk, 0, blockDim.x);
  stage<D>(Vs, LD, v + b * Lk * ldv, ldv, KN, Lk, 0, blockDim.x);
  int tile = blockIdx.x * warps + warp;
  if (tile < tiles)
    stage<D>(W, LD, qb + (size_t)tile * 16 * ldq, ldq, 16, Lq - tile * 16,
             warp * 32, 32);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  for (; tile < tiles; tile += step) {
    const int next = tile + step;
    attend_tile<D, NT, KC>(
        W, Ks, Vs, Lk, scale_log2, out + b * Lq * D, 16 * tile, Lq,
        next < tiles ? qb + (size_t)next * 16 * ldq : nullptr, ldq,
        Lq - next * 16);
    cp_wait<0>();
    __syncwarp();                                  // the next q rows are in W
  }
}

constexpr size_t SMEM_LIMIT = 232448;  // bytes a block may use on sm_90

// Key tiles of 8 that the cross kernel pads Lk to (0 where Lk > 256), and
// the chunk of them it takes per softmax pass.
int cross_key_tiles(int Lk) {
  const int n = (Lk + 7) / 8;
  return n <= 8 ? 8 : n <= 16 ? 16 : n <= 19 ? 19 : n <= 24 ? 24
         : n <= 32 ? 32 : 0;
}

size_t cross_kv_bytes(int Lk, int D) {
  return (size_t)2 * 8 * cross_key_tiles(Lk) * (D + 4) * sizeof(float);
}

size_t cross_warp_bytes(int D) { return (size_t)16 * (D + 4) * sizeof(float); }

// Warps a cross block has: 8, or as many as shared memory leaves room for.
int cross_warps(int Lk, int D) {
  const size_t kv = cross_kv_bytes(Lk, D);
  if (kv >= SMEM_LIMIT) return 0;
  const size_t w = (SMEM_LIMIT - kv) / cross_warp_bytes(D);
  return w < (size_t)CROSS_WARPS ? (int)w : CROSS_WARPS;
}

// The least shared memory a cross launch needs: K and V and one warp's q
// rows (ops/ensemble_attn.py::_cross_smem_bytes).
size_t cross_smem_bytes(int Lk, int D) {
  return cross_kv_bytes(Lk, D) + cross_warp_bytes(D);
}

size_t self_smem_bytes(int D) {
  return (size_t)2 * 3 * SELF_ROWS * (D + 4) * sizeof(float);
}

constexpr int MAX_DEVICES = 64;

// Per device and kernel, what a launch needs from the runtime, queried
// once: the shared-memory limit is raised at the first launch and the SM
// count and blocks per SM are kept, so that a launch costs the host no
// more than the launch itself. Keyed by the kernel's shared memory, which
// with the block size it fixes is all the occupancy depends on here.
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
  if (c.smem != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    c.smem = smem;
  }
  if (c.per_sm < 1) return cudaErrorInvalidConfiguration;
  *slots = c.sms * c.per_sm;
  return cudaSuccess;
}

template <int D>
int launch_self(const float* q, const float* k, const float* v, float* out,
                long ldq, long ldk, long ldv, int N, int P,
                cudaStream_t stream) {
  static LaunchCache caches[MAX_DEVICES];
  const size_t smem = self_smem_bytes(D);
  int slots = 0;
  cudaError_t err = prepare(block_self_kernel<D>, caches, smem, SELF_THREADS,
                            smem, &slots);
  if (err != cudaSuccess) return (int)err;
  block_self_kernel<D><<<min(N, slots), SELF_THREADS, smem, stream>>>(
      q, k, v, out, ldq, ldk, ldv, N, P, LOG2E / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D, int NT, int KC>
int launch_cross(const float* q, const float* k, const float* v, float* out,
                 long ldq, long ldk, long ldv, int B, int Lq, int Lk,
                 cudaStream_t stream) {
  static LaunchCache caches[MAX_DEVICES];
  const int warps = cross_warps(Lk, D);
  const size_t smem = cross_kv_bytes(Lk, D) + warps * cross_warp_bytes(D);
  int slots = 0;
  cudaError_t err = prepare(folded_cross_kernel<D, NT, KC>, caches,
                            SMEM_LIMIT, 32 * warps, smem, &slots);
  if (err != cudaSuccess) return (int)err;
  // fill the card once; never more blocks than a condition has q tiles
  const int tiles = (Lq + 15) / 16;
  int gx = slots / B;
  gx = max(1, min(gx, (tiles + warps - 1) / warps));
  folded_cross_kernel<D, NT, KC><<<dim3(gx, B), 32 * warps, smem, stream>>>(
      q, k, v, out, ldq, ldk, ldv, Lq, Lk,
      LOG2E / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_cross_nt(const float* q, const float* k, const float* v,
                    float* out, long ldq, long ldk, long ldv, int B, int Lq,
                    int Lk, cudaStream_t s) {
  switch (cross_key_tiles(Lk)) {
    case 8:
      return launch_cross<D, 8, 8>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
    case 16:
      return launch_cross<D, 16, 16>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk,
                                     s);
    case 19:
      return launch_cross<D, 19, 19>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk,
                                     s);
    case 24:
      return launch_cross<D, 24, 8>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk,
                                    s);
    case 32:   // K and V of 256 keys fit shared memory at D = 64 only
      if constexpr (D == 64)
        return launch_cross<D, 32, 8>(q, k, v, out, ldq, ldk, ldv, B, Lq,
                                      Lk, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

bool strides_ok(long ldq, long ldk, long ldv, int D) {
  return ldq >= D && ldk >= D && ldv >= D && ldq % 4 == 0 && ldk % 4 == 0 &&
         ldv % 4 == 0;
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

}  // namespace

extern "C" {

int ertdx_block_self_attn(const float* q, const float* k, const float* v,
                          float* out, long ldq, long ldk, long ldv, int N,
                          int P, int D, void* stream) {
  if (N < 1 || P < 1 || P > SELF_ROWS || !strides_ok(ldq, ldk, ldv, D))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128) return launch_self<128>(q, k, v, out, ldq, ldk, ldv, N, P, s);
  if (D == 64) return launch_self<64>(q, k, v, out, ldq, ldk, ldv, N, P, s);
  return (int)cudaErrorInvalidValue;
}

int ertdx_folded_cross_attn(const float* q, const float* k, const float* v,
                            float* out, long ldq, long ldk, long ldv, int B,
                            int Lq, int Lk, int D, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || cross_key_tiles(Lk) == 0 ||
      cross_warps(Lk, D) < 1 || !strides_ok(ldq, ldk, ldv, D))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128)
    return launch_cross_nt<128>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
  if (D == 64)
    return launch_cross_nt<64>(q, k, v, out, ldq, ldk, ldv, B, Lq, Lk, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
