// The fused core on Hopper's warpgroup MMA and tensor memory accelerator
// (sm_90a; bf16 wgmma of wgmma.cuh, float32 accumulation), in both of
// JAX's numeric modes (ertdx/ops/core_block.py::_dot, :76-108):
//   * one pass (`accurate=False`, the default): each product's two
//     operands rounded to bf16 to nearest even, one bf16 wgmma pass;
//   * bf16_3x (`accurate=True`): each operand split as hi = bf16(a), lo =
//     bf16(a - hi) (JAX's `_hilo`, the lo part rounded as the TPU's
//     DEFAULT pass rounds it), a b = a_hi b_lo + a_hi b_hi + a_lo b_hi,
//     three bf16 wgmma passes into one float32 accumulator (JAX sums the
//     three products in another float32 order).
//
// Replaces, in each mode, the TPU kernels of ertdx/ops/core_block.py:
//   * core_stack_wgmma_kernel (one pass), core_stack_bf16x3_kernel
//     (bf16_3x) <- fused_core_stack (_core_stack_kernel :440, call :489):
//     lift and positional embedding, nb CoreBlocks, out-norm and the
//     Dense(1) head, compact (chains, P) in, compact eps out;
//   * core_block_wgmma_kernel, core_block_bf16x3_kernel <- fused_core_block
//     (_core_block_kernel :281, call :314): one CoreBlock over
//     condition-major slabs.
// (csrc/core_block.cu's 3xTF32 kernels, which computed the float32
// function for `accurate=True`, are gone.)
//
// The operands of each product: the weights (rounded once a run on the
// host: ops/core_block.py::pack_core_weights, and with their lo parts
// pack_core_weights_3x), K and V (rounded, or split, once a run:
// ops/core_block.py::kv_operands), q after the 1/sqrt(D) scale, the normalised probabilities,
// the normed activations, the attention outputs and the MLP hidden after
// GELU (rounded, or split, in the kernel). The stack also leaves what
// JAX's one-hot relayout products leave: the chains' x, pos_emb, and eps
// plus the head bias rounded to bf16 (one pass; with the head's tokens
// and weights) or as hi + bf16(v - hi) (bf16_3x; the head a bf16_3x dot).
// The residual stream, LayerNorm's statistics, the softmaxes and GELU
// stay float32.
//
// What bounds it on an H100: operations, 2 D (14 D + 2 P + 2 Lk) flops a
// row and block (three times that in bf16_3x), 0.52 ms (1.55 ms) at 989
// TFLOP/s at the configs[3] shape (P=29, D=128, Lk=147, 232,000 rows, 4
// blocks); and bytes from L2: each block of 128 rows reads a CoreBlock's
// 14 D^2 bf16 weights (448 KB; twice that with the lo parts) and its
// condition's K and V (2 x 37 KB at Lk=147; twice) again, about 4.3 GB
// (8.5 GB) a configs[3] launch, some 0.8 ms (1.6 ms) at 5.5 TB/s.
//
// The design:
//   * A block is two consumer warpgroups of 64 rows each (256 threads, up
//     to 255 registers a thread, one block an SM). A warpgroup holds
//     floor(64 / P) whole chains (ops/core_block.py::tile_plan), so the
//     self-attention stays inside it; a block's 128 rows share every
//     weight and K/V stage, half the L2 bytes a row of 64-row tiles.
//   * The B operands (the 14 packed 128 x 128 weight tiles of a CoreBlock
//     in the order the products take them, and K and V in stages of 128
//     keys) arrive by TMA, 128-byte swizzled, in a ring of three 32 KB
//     stages with a full and an empty mbarrier each. In bf16_3x each tile
//     and each K / V stage comes as two ring items, its lo part, then its
//     hi part (Feed<true>): a product takes a_hi b_lo from the first,
//     waits and releases it, then a_hi b_hi and a_lo b_hi from the
//     second, so a product holds one stage at a time and the feeder
//     refills the other meanwhile. Thread 0 feeds the ring: before each
//     stage it needs, it issues every load whose slot is free without
//     waiting, and waits only for the stage it needs itself.
//     There is no producer warp: a ninth warp puts three warps on one of
//     the SM's four register files and caps every thread at 168
//     registers, and the kernels use 225-255. No __syncthreads after the
//     prologue; a consumer waits on its stage's full barrier and arrives
//     on its empty one.
//   * Every product is wgmma in the RS form (A from registers, B by a
//     shared-memory descriptor), but bf16_3x's q K^T and MLP input
//     products, whose A (q, the normed rows) it reads whole from the self
//     slot in the SS form (A by descriptor too, K-major). The six
//     projections m64n128k16 (K-major weight tiles); q k^T and q K^T
//     m64n64k16 over 64 keys (K-major); P v and P V two m64n64k16 a k
//     step, one per 64-column half of v or V (MN-major). Each warpgroup's
//     accumulator rows are its own.
//   * Intermediates stay in registers in the accumulator layout (lane 4 g
//     + t of warp w holds rows 16 w + g and + 8, columns 8 i + 2 t and + 1):
//     LayerNorm reduces a row over a thread's 32 values and its quad; its
//     output is rounded (split) into the A fragments of the next product
//     (the layout of two neighbouring n tiles packed is the A fragment of
//     one k step, bf16mma.cuh). The softmaxes run on the logits'
//     accumulators, the cross one over all Lk keys at once (up to 4 x 32
//     registers), so the probabilities are normalised before they are
//     rounded, as JAX's are; P, the attention outputs and GELU(hidden)
//     feed the next product from the registers they were computed in. The
//     MLP's normed rows, which four products read, go through shared
//     memory instead (see core_layer).
//   * Shared memory a block (the budget, 230,448 of 232,448 bytes, in both
//     modes): the ring, 3 x 32,768; each warpgroup's float32 residual X,
//     32,768, in the accumulator layout (thread-private: no barrier guards
//     it); each warpgroup's 32 KB self slot, four boxes of 64 rows x 64
//     bf16 written swizzled from the accumulators: in one pass self k and
//     v (then, in the MLP, the normed rows); in bf16_3x k's hi and lo
//     parts, then v's (q k^T's operands freed before v is made), then the
//     lo parts of q and P and the MLP's normed rows (core_layer3); the six
//     barriers, and 1,024 to align the rest. Fewer rows a block would have
//     doubled the L2 bytes again; a deeper ring would not leave the slot.
//   * Registers: a bf16_3x A operand held whole in registers is 64 a
//     thread (hi and lo). core_layer3 keeps no more live than core_layer:
//     the self-attention's normed rows are made again for v, v's
//     projection runs in two 64-column halves, P's lo parts wait in the
//     slot until their pass, and q K^T and the MLP's input products read
//     their A from the slot (with them in registers the kernels spilled
//     16 and 48 bytes at 255 registers). So each mode has its own layer
//     body (core_layer, core_layer3): they place A operands differently
//     at nearly every product (registers against the slot, v whole
//     against in halves), and one body templated on the pass count
//     would branch at each of them; what the modes share (the ring,
//     LayerNorm, softmax, GELU, the residual, the stack's and block's
//     set-up and epilogues) is one code, templated where it differs.
//   * K and V: the cross logits of up to 256 keys are made from one or two
//     K stages held together, then released; V's stages follow. A
//     CoreBlock takes 14 + 2 ceil(Lk / 128) stages (twice that in
//     bf16_3x).
//   * The two warpgroups are not scheduled against each other: they share
//     every stage, so they run within two stages of each other, and
//     while one waits for its wgmmas the other's LayerNorm, softmax or
//     GELU runs.
//   * No atomics: each output element is written by one thread; reruns are
//     bit-identical.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int D = 128;                 // hidden width the kernels take
constexpr int WG_ROWS = 64;            // rows of a consumer warpgroup
constexpr int WARPGROUPS = 2;          // consumer warpgroups a block
constexpr int THREADS = 128 * WARPGROUPS;
constexpr int P_MAX = 32;              // whole chains in 64 rows
constexpr int LK_MAX = 256;            // keys the cross logits hold
constexpr int TILES = 14;              // packed weight tiles a CoreBlock
constexpr int STAGES = 3;              // ring depth
constexpr int BOX = D * 128;           // a TMA box: 128 rows of 64 bf16
constexpr int STAGE_BYTES = 2 * BOX;   // a weight tile, or 128 keys of K / V
constexpr int KEYS_STAGE = 128;
constexpr int SELF_BOX = WG_ROWS * 128;          // 64 rows of 64 bf16
constexpr int SELF_BYTES = 2 * 2 * SELF_BOX;     // a warpgroup's k and v
constexpr int X_BYTES = WG_ROWS * D * 4;         // a warpgroup's residual
constexpr size_t SMEM_BYTES = 1024 + (size_t)STAGES * STAGE_BYTES +
                              (size_t)WARPGROUPS * (SELF_BYTES + X_BYTES) +
                              2 * STAGES * sizeof(uint64_t);
static_assert(SMEM_BYTES <= 232448, "an H100 block's shared memory");
constexpr float LN_EPS = 1e-6f;
constexpr float LOG2E = 1.4426950408889634f;

// The packed tiles of a CoreBlock (ops/core_block.py::PACK_ORDER): the k,
// v and q columns of wqkv, wso, wcq, wco, then w1's and w2's 128-wide
// chunks in turns. Item u of a CoreBlock's stages is tile u for u < 5,
// then the K stages and the V stages, then tile u - 2 nks.
constexpr int T_Q = 2, T_SO = 3, T_CQ = 4;    // k 0, v 1
constexpr int FIRST_KV = 5;
// The bf16_3x kernels take the first five tiles in the order k, q, v, so,
// cq (core_layer3): tile X3_FIRST >> 4 n & 15 is the n-th.
constexpr int X3_FIRST = 0x43120;

__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return p + ((1024u - (wg::saddr(p) & 1023u)) & 1023u);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// 2^x on the MUFU (ftz; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh-GELU as x sigmoid(2 u), u = sqrt(2 / pi) (x + 0.044715 x^3): the
// same function as 0.5 x (1 + tanh(u)), in float32 to a few ulps.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return __fdividef(x, 1.0f + ex2(-2.0f * LOG2E * u));
}

// The A fragments of the N / 16 k steps of 64 x N accumulators (N / 2
// a thread), each value times f, rounded to bf16.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&c)[N / 2], float f = 1.f) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = bf16mma::pack(c[8 * kk + 2 * r] * f,
                               c[8 * kk + 2 * r + 1] * f);
}

// B^T rows row0 .. of a K-major tile of two 64-column boxes of `box`
// bytes (B(k, n) = tile[row0 + n, 16 kk + k]), 128-byte swizzled.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int box, int row0,
                                           int kk) {
  return wg::desc(tile + (kk >> 2) * box + row0 * 128 + (kk & 3) * 32, 16,
                  1024, wg::SWIZZLE_128B);
}

// B rows k0 .. of one 64-column box (B(k, n) = box[k0 + k, n]), MN-major.
__device__ __forceinline__ uint64_t mnmajor(uint32_t box, int k0) {
  return wg::desc(box + k0 * 128, 1024, 1024, wg::SWIZZLE_128B);
}

// The products issued since the last fence as one group, waited for.
__device__ __forceinline__ void complete() {
  wg::commit();
  wg::wait<0>();
}

// acc (+)= A W for a 64-row A in registers and a packed 128 x 128 weight
// tile (the ring stage at `tile`); with zero, from 0.
template <bool ZERO>
__device__ __forceinline__ void project(float (&acc)[64],
                                        const uint32_t (&a)[8][4],
                                        uint32_t tile) {
  if (ZERO) zero(acc);
  wg::fence_regs(acc);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wg::mma_rs<0>(acc, a[kk], kmajor(tile, BOX, 0, kk));
  complete();
  wg::fence_regs(acc);
}

// o = P V over `chunks` (runtime, <= C) chunks of 64 keys: p[c] the A
// fragments of chunk c, its V rows at row 64 (c % 2) of the stage vt[c /
// 2] (two 64-column boxes of `box` bytes; o[h] the output's columns 64 h
// ..).
template <int C>
__device__ __forceinline__ void attend(float (&o)[2][32],
                                       const uint32_t (&p)[C][4][4],
                                       const uint32_t (&vt)[(C + 1) / 2],
                                       int box, int chunks) {
  zero(o[0]);
  zero(o[1]);
  wg::fence_regs(o[0]);
  wg::fence_regs(o[1]);
  wg::fence();
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c < chunks)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wg::mma_rs<1>(o[h], p[c][kk],
                        mnmajor(vt[c >> 1] + h * box, 64 * (c & 1) + 16 * kk));
  complete();
  wg::fence_regs(o[0]);
  wg::fence_regs(o[1]);
}

// The A fragments of a 64 x 128 output held as two 64-column halves.
__device__ __forceinline__ void halves_to_a(uint32_t (&a)[8][4],
                                            const float (&o)[2][32]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t part[4][4];
    to_a<64>(part, o[h]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[4 * h + kk][r] = part[kk][r];
  }
}

// The ring: item j (counted over the whole launch) in slot j % STAGES,
// phase (j / STAGES) & 1. Thread 0 alone loads (`feeder`); `issued` is
// its count of items issued. X3: the bf16_3x kernels' items, each weight
// tile and each K / V stage as its lo part, then its hi part (core_layer3).
template <bool X3>
struct Feed {
  const CUtensorMap* wmap;   // packed weights, (nb 14 [2] 128 rows, 128)
  const CUtensorMap* kmap;   // K, (B nb [2], Lk, 128)
  const CUtensorMap* vmap;   // V
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int kv0;                   // K/V index of this condition's block 0
  int nks;                   // K (and V) stages a CoreBlock
  int items;                 // stages a CoreBlock: TILES + 2 nks (X3: twice)
  int total, issued;
  bool feeder;

  __device__ void load(int j) {
    const int s = j % STAGES, i = j / items, u = j % items;
    unsigned char* st = ring + s * STAGE_BYTES;
    wg::mbar_expect_tx(&full[s], STAGE_BYTES);
    if constexpr (X3) {
      // u: the pairs of tiles k, q, v, so, cq (X3_FIRST), then K lo, K hi,
      // V lo, V hi (nks stages each), then the pairs of co, w1_0, w2_0,
      // ..., w2_3; a pair's lo is part 1 of the packed (hi, lo), its hi
      // part 0
      const int kv = u - 2 * FIRST_KV;
      if (kv >= 0 && kv < 4 * nks) {
        const int q = kv / nks, h = kv % nks;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          wg::tma_load_3d(st + c * BOX, q < 2 ? kmap : vmap, &full[s],
                          64 * c, KEYS_STAGE * h,
                          2 * (kv0 + i) + ((q & 1) ? 0 : 1));
      } else {
        const int v = kv < 0 ? u : u - 4 * nks;
        const int tile = kv < 0 ? (X3_FIRST >> (4 * (v >> 1))) & 15 : v >> 1;
        const int row = ((i * TILES + tile) * 2 + ((v & 1) ? 0 : 1)) * D;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          wg::tma_load_2d(st + c * BOX, wmap, &full[s], 64 * c, row);
      }
    } else {
      if (u >= FIRST_KV && u < FIRST_KV + 2 * nks) {
        const bool is_v = u >= FIRST_KV + nks;
        const int h = u - FIRST_KV - (is_v ? nks : 0);
#pragma unroll
        for (int c = 0; c < 2; ++c)
          wg::tma_load_3d(st + c * BOX, is_v ? vmap : kmap, &full[s], 64 * c,
                          KEYS_STAGE * h, kv0 + i);
      } else {
        const int tile = u < FIRST_KV ? u : u - 2 * nks;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          wg::tma_load_2d(st + c * BOX, wmap, &full[s], 64 * c,
                          (i * TILES + tile) * D);
      }
    }
  }

  // Issue the items whose slots are free, waiting for a slot only while
  // an item < need is not issued.
  __device__ void pump(int need) {
    while (issued < total) {
      if (issued >= STAGES) {
        const int s = issued % STAGES;
        const uint32_t parity = (issued / STAGES - 1) & 1;
        if (issued < need)
          wg::mbar_wait(&empty[s], parity);
        else if (!wg::mbar_try_wait(&empty[s], parity))
          break;
      }
      load(issued);
      ++issued;
    }
  }

  // The shared address of item j's stage once it has landed.
  __device__ uint32_t acquire(int j) {
    if (feeder) pump(j + 1);
    wg::mbar_wait(&full[j % STAGES], (j / STAGES) & 1);
    return wg::saddr(ring + (j % STAGES) * STAGE_BYTES);
  }

  __device__ void release(int j) { wg::mbar_arrive(&empty[j % STAGES]); }
};

// A consumer thread's place: its warpgroup's 64 rows, its residual and
// self k / v tiles, and where its accumulator values sit.
struct Rows {
  float4* X;           // the residual, X[i * 128 + wt]: n tile i's 4 values
  unsigned char* kv;   // self k (two boxes), then v (two boxes)
  int wt;              // thread in the warpgroup
  int bar;             // the warpgroup's named barrier
  int r0;              // its first row: 16 warp + g; the second r0 + 8
  int t;               // lane % 4: columns 8 i + 2 t, + 1
  int nrows;           // valid rows of the warpgroup (whole chains)
  int P;
};

__device__ __forceinline__ void load_x(float (&x)[64], const Rows& w) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float4 v = w.X[i * 128 + w.wt];
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void store_x(const Rows& w, const float (&x)[64]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w.X[i * 128 + w.wt] =
        make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}

// X += acc + bias (a (D) vector): an output projection's residual add.
__device__ __forceinline__ void add_x(const Rows& w, const float (&acc)[64],
                                      const float* __restrict__ bias) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * i +
                                                           2 * w.t));
    float4 v = w.X[i * 128 + w.wt];
    v.x += acc[4 * i] + b.x;
    v.y += acc[4 * i + 1] + b.y;
    v.z += acc[4 * i + 2] + b.x;
    v.w += acc[4 * i + 3] + b.y;
    w.X[i * 128 + w.wt] = v;
  }
}

// x = LN(X) (add + scale) + shift for the thread's values (eps 1e-6, the
// biased variance, as F.layer_norm); each row's sums over the thread's 32
// values and its quad.
__device__ __forceinline__ void norm(float (&x)[64], const Rows& w,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ shift,
                                     float add) {
  load_x(x, w);
  float mu[2] = {0.f, 0.f}, var[2] = {0.f, 0.f}, inv[2];
#pragma unroll
  for (int e = 0; e < 64; ++e) mu[(e >> 1) & 1] += x[e];
#pragma unroll
  for (int h = 0; h < 2; ++h) mu[h] = bf16mma::quad_sum(mu[h]) * (1.0f / D);
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    x[e] -= mu[(e >> 1) & 1];
    var[(e >> 1) & 1] += x[e] * x[e];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    inv[h] = 1.0f / sqrtf(bf16mma::quad_sum(var[h]) * (1.0f / D) + LN_EPS);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + 2 * w.t;
    const float2 s = __ldg(reinterpret_cast<const float2*>(scale + col));
    const float2 b = __ldg(reinterpret_cast<const float2*>(shift + col));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[4 * i + e] = x[4 * i + e] * inv[e >> 1] *
                         (add + ((e & 1) ? s.y : s.x)) +
                     ((e & 1) ? b.y : b.x);
  }
}

// The A fragments of LN(X) (1 + scale) + shift, rounded to bf16.
__device__ __forceinline__ void norm_a(uint32_t (&a)[8][4], const Rows& w,
                                       const float* scale,
                                       const float* shift) {
  float x[64];
  norm(x, w, scale, shift, 1.0f);
  to_a<128>(a, x);
}

// acc rounded to bf16 into the warpgroup's self tile `box0` (two boxes of
// 64 rows, swizzled as TMA would write them: B for q k^T, K-major, and
// for P v, MN-major; or the MLP's A, read back by `load_a`).
__device__ __forceinline__ void store_self(unsigned char* box0,
                                           const float (&acc)[64],
                                           const Rows& w) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(box0 + (i >> 3) * SELF_BOX +
                                   wg::sw128(w.r0 + 8 * h, i & 7) + 4 * w.t) =
          bf16mma::pack(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
}

// The A fragments of the warp's 16 rows of a self tile (16 K columns, four
// k steps a box) by ldmatrix: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15)
// of each k step.
template <int K>
__device__ __forceinline__ void load_a(uint32_t (&a)[K][4], uint32_t tile,
                                       const Rows& w) {
  const int lane = w.wt & 31, row = 16 * (w.wt >> 5) + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    wg::ldsm_x4(a[kk], tile + (kk >> 2) * SELF_BOX +
                           wg::sw128(row, 2 * (kk & 3) + (lane >> 4)));
}

// Softmax, in place, over the logits of C chunks of 64 keys a thread holds
// (s[c][4 i + e]: row e >> 1 of the thread's two, key 64 c + 8 i + 2 t +
// (e & 1)); keys where live(c, 4 i + e) is false get probability 0. Every
// row has a live key. The probabilities come out normalised, in float32.
template <int C, class Live>
__device__ __forceinline__ void softmax(float (&s)[C][32], Live live) {
  float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[c][e] = live(c, e) ? s[c][e] * LOG2E : -INFINITY;
      m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], s[c][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = bf16mma::quad_max(m[h]);
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[c][e] = ex2(s[c][e] - m[(e >> 1) & 1]);
      sum[(e >> 1) & 1] += s[c][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) sum[h] = 1.0f / bf16mma::quad_sum(sum[h]);
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) s[c][e] *= sum[(e >> 1) & 1];
}

// Per-CoreBlock weights read outside the packed tiles: the biases.
struct Biases {
  const float* bso;   // (D)
  const float* bco;   // (D)
  const float* b1;    // (4D)
  const float* b2;    // (D)
};

__device__ __forceinline__ Biases biases_at(const Biases& b, int i) {
  return Biases{b.bso + (size_t)i * D, b.bco + (size_t)i * D,
                b.b1 + (size_t)i * 4 * D, b.b2 + (size_t)i * D};
}

// One CoreBlock on the warpgroup's rows, in place. j0: the CoreBlock's
// first ring item; mods: its (6, D) AdaLN rows s1, h1, s2, h2, s3, h3.
__device__ __forceinline__ void core_layer(Feed<false>& f, const Rows& w, int j0,
                           const float* __restrict__ mods, const Biases& bs,
                           int Lk) {
  const float scale = 1.0f / sqrtf((float)D);
  const int nks = f.nks, nkc = (Lk + 63) / 64;
  float acc[64];
  uint32_t a[8][4];

  // ---- self-attention over each chain's P tokens ----
  norm_a(a, w, mods + 0 * D, mods + 1 * D);
  wg::bar_sync(w.bar, 128);          // the last block's P v has read k, v
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {      // k, then v, into the self tiles
    const uint32_t tile = f.acquire(j0 + c);
    project<true>(acc, a, tile);
    f.release(j0 + c);
    store_self(w.kv + c * 2 * SELF_BOX, acc, w);
  }
  uint32_t qa[8][4];
  {
    const uint32_t tile = f.acquire(j0 + T_Q);
    project<true>(acc, a, tile);
    f.release(j0 + T_Q);
    to_a<128>(qa, acc, scale);       // q after the 1/sqrt(D) scale
  }
  wg::fence_proxy_async();           // the self tiles, for the wgmmas
  wg::bar_sync(w.bar, 128);
  const uint32_t kt = wg::saddr(w.kv), vt = kt + 2 * SELF_BOX;
  {
    float s[1][32];
    zero(s[0]);
    wg::fence_regs(s[0]);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wg::mma_rs<0>(s[0], qa[kk], kmajor(kt, SELF_BOX, 0, kk));
    complete();
    wg::fence_regs(s[0]);
    // keys of the row's own chain: row r, key k live where r / P == k / P
    int base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) base[h] = (w.r0 + 8 * h) / w.P * w.P;
    softmax(s, [&](int, int e) {
      const int key = 8 * (e >> 2) + 2 * w.t + (e & 1);
      const int b = base[(e >> 1) & 1];
      return key >= b && key < b + w.P;
    });
    uint32_t p[1][4][4];
    to_a<64>(p[0], s[0]);
    const uint32_t vbox[1] = {vt};
    float o[2][32];
    attend<1>(o, p, vbox, SELF_BOX, 1);
    halves_to_a(a, o);
  }
  {
    const uint32_t tile = f.acquire(j0 + T_SO);
    project<true>(acc, a, tile);
    f.release(j0 + T_SO);
    add_x(w, acc, bs.bso);
  }

  // ---- cross-attention to the condition's Lk keys ----
  norm_a(a, w, mods + 2 * D, mods + 3 * D);
  {
    const uint32_t tile = f.acquire(j0 + T_CQ);
    project<true>(acc, a, tile);
    f.release(j0 + T_CQ);
    to_a<128>(qa, acc, scale);
  }
  {
    float s[4][32];
    uint32_t st[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      st[h] = h < nks ? f.acquire(j0 + FIRST_KV + h) : 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      zero(s[c]);
      wg::fence_regs(s[c]);
    }
    wg::fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < nkc)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wg::mma_rs<0>(s[c], qa[kk], kmajor(st[c >> 1], BOX, 64 * (c & 1),
                                             kk));
    complete();
#pragma unroll
    for (int c = 0; c < 4; ++c) wg::fence_regs(s[c]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < nks) f.release(j0 + FIRST_KV + h);
    // keys past Lk (zeros from TMA, or chunks not computed) at -inf
    softmax(s, [&](int c, int e) {
      return 64 * c + 8 * (e >> 2) + 2 * w.t + (e & 1) < Lk;
    });
    uint32_t p[4][4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) to_a<64>(p[c], s[c]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      st[h] = h < nks ? f.acquire(j0 + FIRST_KV + nks + h) : 0u;
    float o[2][32];
    attend<4>(o, p, st, BOX, nkc);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < nks) f.release(j0 + FIRST_KV + nks + h);
    halves_to_a(a, o);
  }
  const int jw = j0 + 2 * nks;       // tile u is item jw + u for u >= 5
  {
    const uint32_t tile = f.acquire(jw + T_CQ + 1);
    project<true>(acc, a, tile);
    f.release(jw + T_CQ + 1);
    add_x(w, acc, bs.bco);
  }

  // ---- MLP, the hidden made and consumed in 128-column chunks ----
  // The normed rows go to the (free) self k tile as bf16 and each chunk
  // reloads its A fragments from there: A registers held across the
  // rolled loop lost their values to the hidden's (nvcc 12.9 put both in
  // one register range; PERF.md, PR 24).
  {
    float x[64];
    norm(x, w, mods + 4 * D, mods + 5 * D, 1.0f);
    store_self(w.kv, x, w);
    __syncwarp();                    // a warp reads the rows it wrote
  }
  float out[64];
  zero(out);
#pragma unroll 1
  for (int c = 0; c < 4; ++c) {
    const int j1 = jw + T_CQ + 2 + 2 * c;
    uint32_t ha[8][4];
    {
      load_a(a, kt, w);
      const uint32_t tile = f.acquire(j1);
      project<true>(acc, a, tile);
      f.release(j1);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float2 b = __ldg(reinterpret_cast<const float2*>(
            bs.b1 + c * D + 8 * i + 2 * w.t));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * i + e] = gelu_tanh(acc[4 * i + e] + ((e & 1) ? b.y : b.x));
      }
      to_a<128>(ha, acc);
    }
    const uint32_t tile = f.acquire(j1 + 1);
    project<false>(out, ha, tile);
    f.release(j1 + 1);
  }
  add_x(w, out, bs.b2);
}

// ---- bf16_3x (`accurate=True`) ------------------------------------------

// x - y with subnormal operands and difference flushed to zeros of their
// sign, as XLA computes `_hilo`'s a - hi
__device__ __forceinline__ float sub_ftz(float x, float y) {
  float d;
  asm("sub.rn.ftz.f32 %0, %1, %2;\n" : "=f"(d) : "f"(x), "f"(y));
  return d;
}

// hi = bf16(x), lo = bf16(x - hi) of a pair, each packed as bf16x2 (x in
// the low half): JAX's `_hilo` with the lo part rounded as the TPU's
// DEFAULT pass rounds it.
__device__ __forceinline__ void split_pack(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 hx = __float2bfloat16(x), hy = __float2bfloat16(y);
  hi = (uint32_t)__bfloat16_as_ushort(hx) |
       ((uint32_t)__bfloat16_as_ushort(hy) << 16);
  lo = bf16mma::pack(sub_ftz(x, __bfloat162float(hx)),
                     sub_ftz(y, __bfloat162float(hy)));
}

// x as a bf16_3x product with a one-hot matrix leaves it: hi + bf16(x - hi)
__device__ __forceinline__ float round3(float x) {
  const float h = bf16mma::round_bf16(x);
  return h + bf16mma::round_bf16(sub_ftz(x, h));
}

// to_a's hi and lo fragments: the A operand of a bf16_3x product.
template <int N>
__device__ __forceinline__ void to_a3(uint32_t (&hi)[N / 16][4],
                                      uint32_t (&lo)[N / 16][4],
                                      const float (&c)[N / 2],
                                      float f = 1.f) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_pack(c[8 * kk + 2 * r] * f, c[8 * kk + 2 * r + 1] * f, hi[kk][r],
                 lo[kk][r]);
}

// to_a3's hi fragments in registers; the lo parts go to the warp's rows of
// the self slot at box0 (N / 64 boxes), where `load_a` reads them back.
template <int N>
__device__ __forceinline__ void split_to_a(uint32_t (&hi)[N / 16][4],
                                           unsigned char* box0,
                                           const float (&c)[N / 2],
                                           const Rows& w, float f = 1.f) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t lo;
      split_pack(c[8 * kk + 2 * r] * f, c[8 * kk + 2 * r + 1] * f,
                 hi[kk][r], lo);
      const int i = 2 * kk + (r >> 1);      // n tile i, row half r & 1
      *reinterpret_cast<uint32_t*>(box0 + (i >> 3) * SELF_BOX +
                                   wg::sw128(w.r0 + 8 * (r & 1), i & 7) +
                                   4 * w.t) = lo;
    }
}

// halves_to_a for bf16_3x.
__device__ __forceinline__ void halves_to_a3(uint32_t (&hi)[8][4],
                                             uint32_t (&lo)[8][4],
                                             const float (&o)[2][32]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t ph[4][4], pl[4][4];
    to_a3<64>(ph, pl, o[h]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hi[4 * h + kk][r] = ph[kk][r];
        lo[4 * h + kk][r] = pl[kk][r];
      }
  }
}

// One 64-column half of a 64 x 128 output (acc: 32 a thread, columns
// 64 h ..) into the self slot at box0 in store_self's layout: its hi
// parts to box h, its lo parts to box 2 + h.
__device__ __forceinline__ void store_split_half(unsigned char* box0, int h,
                                                 const float (&acc)[32],
                                                 const Rows& w) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t hi, lo;
      split_pack(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1], hi, lo);
      unsigned char* at = box0 + h * SELF_BOX +
                          wg::sw128(w.r0 + 8 * r, i) + 4 * w.t;
      *reinterpret_cast<uint32_t*>(at) = hi;
      *reinterpret_cast<uint32_t*>(at + 2 * SELF_BOX) = lo;
    }
}

// A 64 x 128 output into the self slot: hi parts in boxes 0-1, lo parts
// in 2-3 (its two halves are columns 0-63 and 64-127 of acc's layout).
__device__ __forceinline__ void store_split(unsigned char* box0,
                                            const float (&acc)[64],
                                            const Rows& w) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    store_split_half(box0, h,
                     *reinterpret_cast<const float(*)[32]>(&acc[32 * h]), w);
}

// Shared addresses the compiler must take as new values: a product's
// descriptors are then made where it is issued, not kept in registers
// from an earlier issue on the same stage across a wait (a bf16_3x
// product issues on a stage twice).
template <int N>
__device__ __forceinline__ void opaque(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i]));
}

// Issue s[c] += q B(c) over the C chunks of 64 keys below `chunks` (B the
// K-major rows 64 (c % 2) .. of the stage st[c / 2], two boxes of `box`
// bytes). No fence, no wait.
template <int C>
__device__ __forceinline__ void issue_qk(float (&s)[C][32],
                                         const uint32_t (&q)[8][4],
                                         const uint32_t (&st)[(C + 1) / 2],
                                         int box, int chunks) {
  uint32_t b[(C + 1) / 2];
#pragma unroll
  for (int i = 0; i < (C + 1) / 2; ++i) b[i] = st[i];
  opaque(b);
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c < chunks)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wg::mma_rs<0>(s[c], q[kk], kmajor(b[c >> 1], box, 64 * (c & 1), kk));
}

// Issue o += P V as `attend` does, without zeroing o, fence or wait.
template <int C>
__device__ __forceinline__ void issue_pv(float (&o)[2][32],
                                         const uint32_t (&p)[C][4][4],
                                         const uint32_t (&vt)[(C + 1) / 2],
                                         int box, int chunks) {
  uint32_t b[(C + 1) / 2];
#pragma unroll
  for (int i = 0; i < (C + 1) / 2; ++i) b[i] = vt[i];
  opaque(b);
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c < chunks)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wg::mma_rs<1>(o[h], p[c][kk],
                        mnmajor(b[c >> 1] + h * box, 64 * (c & 1) + 16 * kk));
}

// acc (+)= A W in bf16_3x for a 64-row A as hi and lo fragments and a
// weight tile's pair (its lo at item j, its hi at j + 1): a_hi W_lo, then
// a_hi W_hi and a_lo W_hi, in one float32 accumulator.
template <bool ZERO>
__device__ __forceinline__ void project3(float (&acc)[64],
                                         const uint32_t (&ah)[8][4],
                                         const uint32_t (&al)[8][4],
                                         Feed<true>& f, int j) {
  if (ZERO) zero(acc);
  uint32_t tile = f.acquire(j);
  wg::fence_regs(acc);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wg::mma_rs<0>(acc, ah[kk], kmajor(tile, BOX, 0, kk));
  complete();
  f.release(j);
  tile = f.acquire(j + 1);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wg::mma_rs<0>(acc, ah[kk], kmajor(tile, BOX, 0, kk));
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wg::mma_rs<0>(acc, al[kk], kmajor(tile, BOX, 0, kk));
  complete();
  wg::fence_regs(acc);
  f.release(j + 1);
}

// The A fragments (hi and lo) of LN(X) (1 + scale) + shift.
__device__ __forceinline__ void norm_a3(uint32_t (&hi)[8][4],
                                        uint32_t (&lo)[8][4], const Rows& w,
                                        const float* scale,
                                        const float* shift) {
  float x[64];
  norm(x, w, scale, shift, 1.0f);
  to_a3<128>(hi, lo, x);
}

// project3 of a weight tile whose output goes to the self slot at box0
// (store_split's layout), made in two 64-column halves (an accumulator of
// 32 a thread): the v projection, beside the A operands and P in
// registers. Holds the pair's two stages together.
__device__ __forceinline__ void project3_store(const uint32_t (&ah)[8][4],
                                              const uint32_t (&al)[8][4],
                                              Feed<true>& f, int j,
                                              unsigned char* box0,
                                              const Rows& w) {
  const uint32_t lo = f.acquire(j), hi = f.acquire(j + 1);
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    uint32_t st[2] = {lo, hi};
    opaque(st);
    float acc[32];
    zero(acc);
    wg::fence_regs(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wg::mma_rs<0>(acc, ah[kk], kmajor(st[0], BOX, 64 * h, kk));
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wg::mma_rs<0>(acc, ah[kk], kmajor(st[1], BOX, 64 * h, kk));
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wg::mma_rs<0>(acc, al[kk], kmajor(st[1], BOX, 64 * h, kk));
    complete();
    wg::fence_regs(acc);
    store_split_half(box0, h, acc, w);
  }
  f.release(j);
  f.release(j + 1);
}

// Issue s[c] += A B(c) as issue_qk does, A (64 x 128) from the self slot
// at `a` (two boxes, K-major) by descriptors: the SS form.
template <int C>
__device__ __forceinline__ void issue_qk_ss(float (&s)[C][32], uint32_t a,
                                            const uint32_t (&st)[(C + 1) / 2],
                                            int box, int chunks) {
  uint32_t b[(C + 1) / 2];
#pragma unroll
  for (int i = 0; i < (C + 1) / 2; ++i) b[i] = st[i];
  opaque(b);
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c < chunks)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wg::mma_ss<0>(s[c], kmajor(a, SELF_BOX, 0, kk),
                      kmajor(b[c >> 1], box, 64 * (c & 1), kk));
}

// One CoreBlock in bf16_3x on the warpgroup's rows, in place: every
// product a_hi b_lo + a_hi b_hi + a_lo b_hi in one accumulator (JAX's
// `_dot(accurate=True)` in another float32 order). j0: the CoreBlock's
// first ring item (Feed<true>'s order); mods: its (6, D) AdaLN rows.
// The warpgroup's 32 KB self slot holds, in turns: self k, then self v
// (hi and lo, the B operands); the cross-attention's q (hi and lo, A by
// descriptor: the SS form); P's lo parts (A fragments read back by
// ldmatrix, each warp its own rows); the MLP's normed rows (hi and lo, A
// by descriptor). A thread holds at most 128 values of operands and
// accumulators at once (the cross logits; the MLP's output and hidden):
// the self-attention's normed rows are made again for v, whose
// projection runs in 64-column halves; with q and the normed rows in
// registers, the kernels spilled.
__device__ __forceinline__ void core_layer3(Feed<true>& f, const Rows& w,
                                            int j0,
                                            const float* __restrict__ mods,
                                            const Biases& bs, int Lk) {
  const float scale = 1.0f / sqrtf((float)D);
  const int nks = f.nks, nkc = (Lk + 63) / 64;
  const uint32_t kt = wg::saddr(w.kv), kt_lo = kt + 2 * SELF_BOX;
  const int jk = j0 + 2 * FIRST_KV;  // K lo, K hi, V lo, V hi stages
  float acc[64];
  uint32_t ah[8][4], al[8][4];

  // ---- self-attention over each chain's P tokens: k, q, then v ----
  norm_a3(ah, al, w, mods + 0 * D, mods + 1 * D);
  wg::bar_sync(w.bar, 128);          // the slot's last readers are done
  project3<true>(acc, ah, al, f, j0);
  store_split(w.kv, acc, w);         // k
  uint32_t ph[1][4][4], pl[1][4][4];
  {
    uint32_t qh[8][4], ql[8][4];
    project3<true>(acc, ah, al, f, j0 + 2);
    to_a3<128>(qh, ql, acc, scale);  // q after the 1/sqrt(D) scale
    wg::fence_proxy_async();         // k, for the wgmmas
    wg::bar_sync(w.bar, 128);
    float s[1][32];
    zero(s[0]);
    wg::fence_regs(s[0]);
    wg::fence();
    issue_qk<1>(s, qh, {kt_lo}, SELF_BOX, 1);
    issue_qk<1>(s, qh, {kt}, SELF_BOX, 1);
    issue_qk<1>(s, ql, {kt}, SELF_BOX, 1);
    complete();
    wg::fence_regs(s[0]);
    int base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) base[h] = (w.r0 + 8 * h) / w.P * w.P;
    softmax(s, [&](int, int e) {
      const int key = 8 * (e >> 2) + 2 * w.t + (e & 1);
      const int b = base[(e >> 1) & 1];
      return key >= b && key < b + w.P;
    });
    to_a3<64>(ph[0], pl[0], s[0]);
  }
  wg::bar_sync(w.bar, 128);          // every warp's q k^T has read k
  norm_a3(ah, al, w, mods + 0 * D, mods + 1 * D);
  project3_store(ah, al, f, j0 + 4, w.kv, w);   // v
  wg::fence_proxy_async();
  wg::bar_sync(w.bar, 128);
  {
    float o[2][32];
    zero(o[0]);
    zero(o[1]);
    wg::fence_regs(o[0]);
    wg::fence_regs(o[1]);
    wg::fence();
    issue_pv<1>(o, ph, {kt_lo}, SELF_BOX, 1);
    issue_pv<1>(o, ph, {kt}, SELF_BOX, 1);
    issue_pv<1>(o, pl, {kt}, SELF_BOX, 1);
    complete();
    wg::fence_regs(o[0]);
    wg::fence_regs(o[1]);
    halves_to_a3(ah, al, o);
  }
  project3<true>(acc, ah, al, f, j0 + 6);
  add_x(w, acc, bs.bso);

  // ---- cross-attention to the condition's Lk keys ----
  norm_a3(ah, al, w, mods + 2 * D, mods + 3 * D);
  project3<true>(acc, ah, al, f, j0 + 8);
  {
    wg::bar_sync(w.bar, 128);        // every warp's P v has read v
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] *= scale;
    store_split(w.kv, acc, w);       // q's hi and lo parts, A of q K^T
    wg::fence_proxy_async();
    wg::bar_sync(w.bar, 128);
    float s[4][32];
    uint32_t st[2];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      zero(s[c]);
      wg::fence_regs(s[c]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) st[h] = h < nks ? f.acquire(jk + h) : 0u;
    wg::fence();
    issue_qk_ss<4>(s, kt, st, BOX, nkc);       // q_hi K_lo
    complete();
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < nks) f.release(jk + h);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      st[h] = h < nks ? f.acquire(jk + nks + h) : 0u;
    wg::fence();
    issue_qk_ss<4>(s, kt, st, BOX, nkc);       // q_hi K_hi
    issue_qk_ss<4>(s, kt_lo, st, BOX, nkc);    // q_lo K_hi
    complete();
#pragma unroll
    for (int c = 0; c < 4; ++c) wg::fence_regs(s[c]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < nks) f.release(jk + nks + h);
    softmax(s, [&](int c, int e) {
      return 64 * c + 8 * (e >> 2) + 2 * w.t + (e & 1) < Lk;
    });
    uint32_t p[4][4][4];
    wg::bar_sync(w.bar, 128);        // every warp's q K^T has read q
#pragma unroll
    for (int c = 0; c < 4; ++c)      // P's lo parts to the slot
      split_to_a<64>(p[c], w.kv + c * SELF_BOX, s[c], w);
    __syncwarp();
    float o[2][32];
    zero(o[0]);
    zero(o[1]);
    wg::fence_regs(o[0]);
    wg::fence_regs(o[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      st[h] = h < nks ? f.acquire(jk + 2 * nks + h) : 0u;
    wg::fence();
    issue_pv<4>(o, p, st, BOX, nkc);           // P_hi V_lo
    complete();
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < nks) f.release(jk + 2 * nks + h);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      st[h] = h < nks ? f.acquire(jk + 3 * nks + h) : 0u;
    wg::fence();
    issue_pv<4>(o, p, st, BOX, nkc);           // P_hi V_hi
    complete();
#pragma unroll
    for (int c = 0; c < 4; ++c) load_a(p[c], kt + c * SELF_BOX, w);
    wg::fence();
    issue_pv<4>(o, p, st, BOX, nkc);           // P_lo V_hi
    complete();
    wg::fence_regs(o[0]);
    wg::fence_regs(o[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < nks) f.release(jk + 3 * nks + h);
    halves_to_a3(ah, al, o);
  }
  const int jw = jk + 4 * nks;       // co, then w1_c and w2_c in turns
  project3<true>(acc, ah, al, f, jw);
  add_x(w, acc, bs.bco);

  // ---- MLP, the hidden made and consumed in 128-column chunks; the
  // normed rows' hi and lo parts in the slot, reloaded by each chunk ----
  {
    float x[64];
    norm(x, w, mods + 4 * D, mods + 5 * D, 1.0f);
    __syncwarp();                    // the warp has read P's lo parts
    store_split(w.kv, x, w);
    wg::fence_proxy_async();         // the normed rows, for the wgmmas
    wg::bar_sync(w.bar, 128);
  }
  float out[64];
  zero(out);
#pragma unroll 1
  for (int c = 0; c < 4; ++c) {
    const int j1 = jw + 2 + 4 * c;
    uint32_t hh[8][4], hl[8][4];
    {
      uint32_t tile = f.acquire(j1);
      zero(acc);
      wg::fence_regs(acc);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)         // a_hi W_lo
        wg::mma_ss<0>(acc, kmajor(kt, SELF_BOX, 0, kk),
                      kmajor(tile, BOX, 0, kk));
      complete();
      f.release(j1);
      tile = f.acquire(j1 + 1);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)         // a_hi W_hi
        wg::mma_ss<0>(acc, kmajor(kt, SELF_BOX, 0, kk),
                      kmajor(tile, BOX, 0, kk));
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)         // a_lo W_hi
        wg::mma_ss<0>(acc, kmajor(kt_lo, SELF_BOX, 0, kk),
                      kmajor(tile, BOX, 0, kk));
      complete();
      wg::fence_regs(acc);
      f.release(j1 + 1);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float2 b = __ldg(reinterpret_cast<const float2*>(
            bs.b1 + c * D + 8 * i + 2 * w.t));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * i + e] = gelu_tanh(acc[4 * i + e] + ((e & 1) ? b.y : b.x));
      }
      to_a3<128>(hh, hl, acc);
    }
    project3<false>(out, hh, hl, f, j1 + 2);
  }
  add_x(w, out, bs.b2);
}

struct StackArgs {
  const float* x;     // (B*R, P) compact chains, condition-major
  const float* mods;  // (B, 6 nb, D)
  Biases b;           // stacks with leading dim nb
  const float* lw;    // (D) lift kernel
  const float* lb;    // (D) lift bias
  const float* pe;    // (P, D) positional embedding
  const float* ons;   // (D) out-norm scale
  const float* onb;   // (D) out-norm bias
  const float* hw;    // (D) head kernel
  const float* hb;    // (1) head bias
  float* out;         // (B*R, P)
  int R, P, nb, Lk, cpw, tiles;
};

struct BlockArgs {
  const float* x;     // (B*R*P, D) condition-major slab rows
  const float* mods;  // (B, 6, D)
  Biases b;
  float* out;         // (B*R*P, D)
  int R, P, Lk, cpw, tiles;
};

// The block's shared memory and its consumer's place; thread 0 sets up
// the barriers and issues the first stages, then the block syncs once.
template <bool X3>
struct Block {
  Feed<X3> f;
  Rows w;
  size_t grow0;       // the warpgroup's first row in the condition-major
                      // chain order
  int cond;
};

template <bool X3>
__device__ __forceinline__ Block<X3> setup(unsigned char* raw,
                                           const CUtensorMap* wmap,
                                           const CUtensorMap* kmap,
                                           const CUtensorMap* vmap, int R,
                                           int P, int nb, int Lk, int cpw,
                                           int tiles) {
  unsigned char* smem = align1k(raw);
  const int tid = threadIdx.x, wgi = tid >> 7, wt = tid & 127;
  const int lane = tid & 31;
  Block<X3> k;
  k.cond = blockIdx.x / tiles;
  const int chain0 = (blockIdx.x % tiles) * WARPGROUPS * cpw + wgi * cpw;
  k.grow0 = ((size_t)k.cond * R + chain0) * P;
  unsigned char* rest = smem + STAGES * STAGE_BYTES;
  k.w.X = reinterpret_cast<float4*>(rest + wgi * X_BYTES);
  k.w.kv = rest + WARPGROUPS * X_BYTES + wgi * SELF_BYTES;
  k.w.wt = wt;
  k.w.bar = 1 + wgi;
  k.w.r0 = 16 * (wt >> 5) + (lane >> 2);
  k.w.t = lane & 3;
  k.w.nrows = max(0, min(cpw, R - chain0)) * P;
  k.w.P = P;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      rest + WARPGROUPS * (X_BYTES + SELF_BYTES));
  const int nks = (Lk + KEYS_STAGE - 1) / KEYS_STAGE;
  const int items = (X3 ? 2 : 1) * (TILES + 2 * nks);
  k.f = Feed<X3>{wmap, kmap, vmap, smem, bars, bars + STAGES, k.cond * nb,
                 nks, items, nb * items, 0, tid == 0};
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&k.f.full[s], 1);
      wg::mbar_init(&k.f.empty[s], THREADS);
    }
    wg::mbar_init_fence();
    k.f.pump(1);
  }
  __syncthreads();
  return k;
}

// The stack: lift and positional embedding, nb CoreBlocks, out-norm and
// the head. One-pass: x, pos_emb, the head's tokens and weights and eps
// plus the head bias rounded to bf16, as JAX's one-hot relayouts round
// them; X3 (bf16_3x): x, pos_emb and eps plus the bias as hi + bf16(v -
// hi) (round3), the head a bf16_3x dot.
template <bool X3>
__device__ __forceinline__ void core_stack(unsigned char* raw,
                                           const CUtensorMap* wmap,
                                           const CUtensorMap* kmap,
                                           const CUtensorMap* vmap,
                                           const StackArgs& a) {
  Block<X3> k = setup<X3>(raw, wmap, kmap, vmap, a.R, a.P, a.nb, a.Lk,
                          a.cpw, a.tiles);
  const Rows& w = k.w;
  auto rnd = [](float v) {
    if constexpr (X3) return round3(v);
    else return bf16mma::round_bf16(v);
  };
  {                                  // lift and positional embedding
    float x[64];
    float xr[2];
    const float* pe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w.r0 + 8 * h;
      const bool ok = r < w.nrows;
      xr[h] = ok ? rnd(a.x[k.grow0 + r]) : 0.f;
      pe[h] = a.pe + (ok ? r % a.P : 0) * D;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = 8 * i + 2 * w.t + (e & 1);
        x[4 * i + e] = w.r0 + 8 * h < w.nrows
                           ? xr[h] * a.lw[col] + a.lb[col] + rnd(pe[h][col])
                           : 0.f;
      }
    store_x(w, x);
  }
#pragma unroll 1
  for (int i = 0; i < a.nb; ++i) {
    const float* mods = a.mods + ((size_t)k.cond * a.nb * 6 + 6 * i) * D;
    if constexpr (X3)
      core_layer3(k.f, w, i * k.f.items, mods, biases_at(a.b, i), a.Lk);
    else
      core_layer(k.f, w, i * k.f.items, mods, biases_at(a.b, i), a.Lk);
  }
  // out-norm, then the head: eps = rnd(tok . hw + hb), the dot one pass
  // (bf16(tok) bf16(hw)) or bf16_3x
  float x[64];
  norm(x, w, a.ons, a.onb, 0.0f);
  float dot[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 hw = __ldg(reinterpret_cast<const float2*>(a.hw + 8 * i +
                                                            2 * w.t));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float th = bf16mma::round_bf16(x[4 * i + e]);
      const float wv = (e & 1) ? hw.y : hw.x;
      const float wh = bf16mma::round_bf16(wv);
      dot[e >> 1] += th * wh;
      if constexpr (X3) {
        dot[e >> 1] += bf16mma::round_bf16(sub_ftz(x[4 * i + e], th)) * wh;
        dot[e >> 1] += th * bf16mma::round_bf16(sub_ftz(wv, wh));
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float s = bf16mma::quad_sum(dot[h]);
    const int r = w.r0 + 8 * h;
    if (w.t == 0 && r < w.nrows) a.out[k.grow0 + r] = rnd(s + a.hb[0]);
  }
}

// One CoreBlock over condition-major slab rows, float32 in and out.
template <bool X3>
__device__ __forceinline__ void core_block(unsigned char* raw,
                                           const CUtensorMap* wmap,
                                           const CUtensorMap* kmap,
                                           const CUtensorMap* vmap,
                                           const BlockArgs& a) {
  Block<X3> k = setup<X3>(raw, wmap, kmap, vmap, a.R, a.P, 1, a.Lk, a.cpw,
                          a.tiles);
  const Rows& w = k.w;
  {
    float x[64];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = w.r0 + 8 * h;
        const float2 v =
            r < w.nrows ? *reinterpret_cast<const float2*>(
                              a.x + (k.grow0 + r) * D + 8 * i + 2 * w.t)
                        : make_float2(0.f, 0.f);
        x[4 * i + 2 * h] = v.x;
        x[4 * i + 2 * h + 1] = v.y;
      }
    store_x(w, x);
  }
  const float* mods = a.mods + (size_t)k.cond * 6 * D;
  if constexpr (X3)
    core_layer3(k.f, w, 0, mods, a.b, a.Lk);
  else
    core_layer(k.f, w, 0, mods, a.b, a.Lk);
  float x[64];
  load_x(x, w);
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w.r0 + 8 * h;
      if (r < w.nrows)
        *reinterpret_cast<float2*>(a.out + (k.grow0 + r) * D + 8 * i +
                                   2 * w.t) =
            make_float2(x[4 * i + 2 * h], x[4 * i + 2 * h + 1]);
    }
}

__global__ void __launch_bounds__(THREADS, 1)
    core_stack_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const StackArgs a) {
  extern __shared__ unsigned char stack_raw[];
  core_stack<false>(stack_raw, &wmap, &kmap, &vmap, a);
}

__global__ void __launch_bounds__(THREADS, 1)
    core_block_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const BlockArgs a) {
  extern __shared__ unsigned char block_raw[];
  core_block<false>(block_raw, &wmap, &kmap, &vmap, a);
}

__global__ void __launch_bounds__(THREADS, 1)
    core_stack_bf16x3_kernel(const __grid_constant__ CUtensorMap wmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const StackArgs a) {
  extern __shared__ unsigned char stack3_raw[];
  core_stack<true>(stack3_raw, &wmap, &kmap, &vmap, a);
}

__global__ void __launch_bounds__(THREADS, 1)
    core_block_bf16x3_kernel(const __grid_constant__ CUtensorMap wmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const BlockArgs a) {
  extern __shared__ unsigned char block3_raw[];
  core_block<true>(block3_raw, &wmap, &kmap, &vmap, a);
}

// The tile plan ops/core_block.py::tile_plan gives: cpw = floor(64 / P)
// chains a warpgroup, `tiles` blocks a condition covering its R chains.
bool plan_ok(int B, int R, int P, int Lk, int cpw, int tiles) {
  return B >= 1 && R >= 1 && P >= 1 && P <= P_MAX && Lk >= 1 &&
         Lk <= LK_MAX && cpw == WG_ROWS / P &&
         tiles == (R + WARPGROUPS * cpw - 1) / (WARPGROUPS * cpw);
}

// The packed weights as (nb 14 parts 128 rows, 128) in boxes of 64 x 128,
// and K or V as (B nb parts, Lk, 128) in boxes of 64 x 128 x 1 (keys past
// Lk land as zeros); 128-byte swizzle. parts: 1 (one-pass), 2 (bf16_3x:
// each tile or K / V slab as its hi, then its lo part).
cudaError_t maps(CUtensorMap* wmap, CUtensorMap* kmap, CUtensorMap* vmap,
                 const void* packed, const void* k, const void* v, int nb,
                 int nkv, int Lk, int parts) {
  const cuuint64_t wdims[2] = {D, (cuuint64_t)nb * TILES * parts * D};
  const cuuint64_t wstr[1] = {D * 2};
  const cuuint32_t wbox[2] = {64, D};
  const cuuint64_t kdims[3] = {D, (cuuint64_t)Lk, (cuuint64_t)nkv * parts};
  const cuuint64_t kstr[2] = {D * 2, (cuuint64_t)Lk * D * 2};
  const cuuint32_t kbox[3] = {64, KEYS_STAGE, 1};
  cudaError_t err;
  if ((err = wg::bf16_map(wmap, packed, 2, wdims, wstr, wbox,
                          CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = wg::bf16_map(kmap, k, 3, kdims, kstr, kbox,
                          CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
    return err;
  return wg::bf16_map(vmap, v, 3, kdims, kstr, kbox,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

template <class K>
cudaError_t set_smem(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
}

// Launch the stack kernel of the mode (x3: bf16_3x) on the stream.
int launch_stack(bool x3, const float* x, const float* mods, const void* k,
                 const void* v, const void* packed, const float* bso,
                 const float* bco, const float* b1, const float* b2,
                 const float* lw, const float* lb, const float* pe,
                 const float* ons, const float* onb, const float* hw,
                 const float* hb, float* out, int B, int R, int P, int nb,
                 int Lk, int cpw, int tiles, void* stream) {
  if (!plan_ok(B, R, P, Lk, cpw, tiles) || nb < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap wmap, kmap, vmap;
  cudaError_t err =
      maps(&wmap, &kmap, &vmap, packed, k, v, nb, B * nb, Lk, x3 ? 2 : 1);
  if (err == cudaSuccess)
    err = x3 ? set_smem(core_stack_bf16x3_kernel)
             : set_smem(core_stack_wgmma_kernel);
  if (err != cudaSuccess) return (int)err;
  StackArgs a{x,  mods, Biases{bso, bco, b1, b2}, lw, lb, pe, ons, onb, hw,
              hb, out,  R, P, nb, Lk, cpw, tiles};
  if (x3)
    core_stack_bf16x3_kernel<<<B * tiles, THREADS, SMEM_BYTES,
                               (cudaStream_t)stream>>>(wmap, kmap, vmap, a);
  else
    core_stack_wgmma_kernel<<<B * tiles, THREADS, SMEM_BYTES,
                              (cudaStream_t)stream>>>(wmap, kmap, vmap, a);
  return (int)cudaGetLastError();
}

// Launch the block kernel of the mode (x3: bf16_3x) on the stream.
int launch_block(bool x3, const float* x, const float* mods, const void* k,
                 const void* v, const void* packed, const float* bso,
                 const float* bco, const float* b1, const float* b2,
                 float* out, int B, int R, int P, int Lk, int cpw, int tiles,
                 void* stream) {
  if (!plan_ok(B, R, P, Lk, cpw, tiles)) return (int)cudaErrorInvalidValue;
  CUtensorMap wmap, kmap, vmap;
  cudaError_t err =
      maps(&wmap, &kmap, &vmap, packed, k, v, 1, B, Lk, x3 ? 2 : 1);
  if (err == cudaSuccess)
    err = x3 ? set_smem(core_block_bf16x3_kernel)
             : set_smem(core_block_wgmma_kernel);
  if (err != cudaSuccess) return (int)err;
  BlockArgs a{x, mods, Biases{bso, bco, b1, b2}, out, R, P, Lk, cpw, tiles};
  if (x3)
    core_block_bf16x3_kernel<<<B * tiles, THREADS, SMEM_BYTES,
                               (cudaStream_t)stream>>>(wmap, kmap, vmap, a);
  else
    core_block_wgmma_kernel<<<B * tiles, THREADS, SMEM_BYTES,
                              (cudaStream_t)stream>>>(wmap, kmap, vmap, a);
  return (int)cudaGetLastError();
}

// out[0]: dynamic shared memory a block; out[1], out[2]: resident blocks
// an SM of the stack and the block kernel; out[3]: threads a block.
template <class S, class B>
int occupancy(S stack, B block, int* out) {
  cudaError_t err = set_smem(stack);
  if (err == cudaSuccess) err = set_smem(block);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], stack,
                                                        THREADS, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], block,
                                                        THREADS, SMEM_BYTES);
  out[0] = (int)SMEM_BYTES;
  out[3] = THREADS;
  return (int)err;
}

}  // namespace

extern "C" {

// x (B R, P) float32 chains -> out (B R, P) eps, bf16 values in float32.
// k, v: (B nb, Lk, D) bf16; packed: (nb, 14, D, D) bf16
// (ops/core_block.py::pack_core_weights); the biases and the lift, pos,
// out-norm and head parameters float32; cpw and tiles from
// ops/core_block.py::tile_plan.
int ertdx_core_stack_onepass(
    const float* x, const float* mods, const void* k, const void* v,
    const void* packed, const float* bso, const float* bco, const float* b1,
    const float* b2, const float* lw, const float* lb, const float* pe,
    const float* ons, const float* onb, const float* hw, const float* hb,
    float* out, int B, int R, int P, int nb, int Lk, int cpw, int tiles,
    void* stream) {
  return launch_stack(false, x, mods, k, v, packed, bso,
                      bco, b1, b2, lw, lb, pe, ons, onb, hw, hb, out, B, R,
                      P, nb, Lk, cpw, tiles, stream);
}

// The stack in bf16_3x (`accurate=True`): k, v (B nb, 2, Lk, D) bf16, each
// slab's hi then its lo part (ops/core_block.py::split_bf16); packed (nb,
// 14, 2, D, D) (ops/core_block.py::pack_core_weights_3x); the rest as
// ertdx_core_stack_onepass.
int ertdx_core_stack_bf16x3(
    const float* x, const float* mods, const void* k, const void* v,
    const void* packed, const float* bso, const float* bco, const float* b1,
    const float* b2, const float* lw, const float* lb, const float* pe,
    const float* ons, const float* onb, const float* hw, const float* hb,
    float* out, int B, int R, int P, int nb, int Lk, int cpw, int tiles,
    void* stream) {
  return launch_stack(true, x, mods, k, v, packed,
                      bso, bco, b1, b2, lw, lb, pe, ons, onb, hw, hb, out, B,
                      R, P, nb, Lk, cpw, tiles, stream);
}

// One CoreBlock: x (B R P, D) float32 slab -> out. k, v: (B, Lk, D) bf16;
// packed: (1, 14, D, D) bf16.
int ertdx_core_block_onepass(const float* x, const float* mods,
                             const void* k, const void* v,
                             const void* packed, const float* bso,
                             const float* bco, const float* b1,
                             const float* b2, float* out, int B, int R,
                             int P, int Lk, int cpw, int tiles,
                             void* stream) {
  return launch_block(false, x, mods, k, v, packed, bso,
                      bco, b1, b2, out, B, R, P, Lk, cpw, tiles, stream);
}

// One CoreBlock in bf16_3x: k, v (B, 2, Lk, D) bf16; packed (1, 14, 2, D,
// D).
int ertdx_core_block_bf16x3(const float* x, const float* mods,
                            const void* k, const void* v, const void* packed,
                            const float* bso, const float* bco,
                            const float* b1, const float* b2, float* out,
                            int B, int R, int P, int Lk, int cpw, int tiles,
                            void* stream) {
  return launch_block(true, x, mods, k, v, packed,
                      bso, bco, b1, b2, out, B, R, P, Lk, cpw, tiles, stream);
}

// out[0]: dynamic shared memory a block; out[1], out[2]: resident blocks
// an SM of the one-pass stack and block kernels; out[3]: threads a block.
int ertdx_core_onepass_occupancy(int* out) {
  return occupancy(core_stack_wgmma_kernel, core_block_wgmma_kernel, out);
}

// The same of the bf16_3x kernels.
int ertdx_core_bf16x3_occupancy(int* out) {
  return occupancy(core_stack_bf16x3_kernel, core_block_bf16x3_kernel, out);
}

}  // extern "C"
