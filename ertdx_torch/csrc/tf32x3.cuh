// The 3xTF32 tensor-core tile of the attention kernels, forward and
// backward (slab_attn.cu, flash_attn.cu, ensemble_attn.cu), of the fused
// denoiser core (core_block.cu) and of the fused conv's GEMMs
// (gn_conv.cu). Device code only; sm_80 and later, built for sm_90a.
//
// An fp32 product a b runs on the TF32 tensor cores as
//     a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi,   a = a_hi + a_lo,
// the small terms first. a_hi is a rounded to TF32, to nearest with ties
// away from zero: the value cvt.rna.tf32.f32 gives for a finite a, made
// with one integer add and mask. a_lo = a - a_hi is exact in fp32 and
// goes to the tensor core as it is; the MMA reads its top 19 bits, i.e.
// truncates it to TF32. This is CUTLASS's OpMultiplyAddFastF32 split
// (round_half_ulp_truncate big, round_toward_zero small). The error of a
// product is about 2^-21 |a b| (the truncated a_lo, the dropped a_lo b_lo
// at 2^-22): fp32-class, as the JAX kernels' Precision.HIGHEST, where one
// TF32 rounding (2^-11) misses the JAX tests' bounds on the attention
// forward and backward (tests/test_torch_tf32x3.py emulates both splits
// and the one rounding). cvt.rna for both halves costs more
// instructions, and the backward kernels are bound by issued
// instructions, of which the split is a large share (PERF.md). Three MMAs
// per k step run at up to 495 / 3 = 165 TFLOP/s on an H100 SXM, against
// 67 for the fp32 FMA pipe.
//
// The split is done as a fragment is loaded from shared memory: tiles stay
// fp32 (one footprint, not two), and an A fragment, loaded once per k
// step, serves every n tile of a warp's row.
//
// Warp-level mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. With
// lane = 4 g + t, the fragments are (PTX ISA, "Matrix Fragments for
// mma.m16n8k8", .tf32):
//     A (16 x 8):  a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//     B (8 x 8):   b0 (t, g)   b1 (t+4, g)
//     C (16 x 8):  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//
// Attention needs two kinds of product:
//   * "nt": C = X Y^T, X and Y row-major shared tiles along the head dim:
//     S = Q K^T and dP = dO V^T (and S^T = K Q^T, dP^T = V dO^T). A comes
//     from rows of X, B from rows of Y.
//   * "nn": C = P Y, P an earlier product's C fragment (P, dS, P^T, dS^T)
//     and Y a row-major shared tile along the key or query axis: O = P V
//     (nn_add), dQ = dS K, dV = P^T dO, dK = dS^T Q. A k step takes its 8
//     contraction indices in the order 0 2 4 6 1 3 5 7: then A's (g, t)
//     is C's (g, 2t) and A's (g, t+4) is C's (g, 2t+1), so a C fragment
//     is an A fragment with no data movement (from_c), and B reads rows
//     2t and 2t+1 of Y.
// Shared tiles have a row stride LD = 4 (mod 32) floats: an A or nt load
// (rows g, column t) hits bank 4g + t, an nn load (rows 2t + h, column g)
// bank 8t + 4h + g; 32 distinct banks either way.
//
// The core's products take the nn order for every operand read from shared
// memory (load_a_perm, load_b_nt_perm): A's (g, t) and (g, t+4) are then
// columns 2t and 2t+1 of a row, one 8-byte load, and so are an nt B's. Its
// activation and K tiles have LD = 8 (mod 32): a half warp's 8-byte loads
// (rows g < 4, columns 2t, 2t+1) hit banks 8g + 2t + {0, 1}, all distinct.
//
// The fused conv's dW reads its A operand transposed (load_a_t): A = X^T
// for a row-major tile X whose rows run along k, in the nn order, so A's
// (g, t) is X's (2t, g) and A's (g, t+4) is X's (2t+1, g), like an nn B.
// With LD = 4 (mod 32) a load hits bank 8t + g (+ 4 for row 2t+1, + 8 for
// column g+8): 32 distinct banks, and a shift of the tile by j rows (the
// conv's taps) adds the same 4j to every lane.
#pragma once

#include <stdint.h>

namespace tf32x3 {

constexpr unsigned FULL = 0xffffffffu;

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

// x = hi + lo: hi rounded to TF32 (to nearest, ties away), lo the rest.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A: rows [m0, m0+16), columns [k0, k0+8) of a row-major shared tile.
__device__ __forceinline__ void load_a(FragA& f, const float* s, int ld,
                                       int m0, int k0, int lane) {
  const float* p = s + (m0 + (lane >> 2)) * ld + k0 + (lane & 3);
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * ld], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * ld + 4], f.hi[3], f.lo[3]);
}

// A from a fragment already in registers, in the A layout (raw floats).
__device__ __forceinline__ void split_a(FragA& f, const float (&x)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], f.hi[i], f.lo[i]);
}

// A from a C fragment, for an nn product (k order 0 2 4 6 1 3 5 7).
__device__ __forceinline__ void from_c(FragA& f, const float (&c)[4]) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

// nt B: B(k, n) = Y(n0 + n, k0 + k), Y a row-major shared tile.
__device__ __forceinline__ void load_b_nt(FragB& f, const float* s, int ld,
                                          int n0, int k0, int lane) {
  const float* p = s + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
}

// A with k in the order 0 2 4 6 1 3 5 7: rows [m0, m0+16), columns
// [k0, k0+8) of a row-major shared tile (ld even, k0 even).
__device__ __forceinline__ void load_a_perm(FragA& f, const float* s, int ld,
                                            int m0, int k0, int lane) {
  const float* p = s + (m0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  const float2 top = *reinterpret_cast<const float2*>(p);
  const float2 bot = *reinterpret_cast<const float2*>(p + 8 * ld);
  split(top.x, f.hi[0], f.lo[0]);
  split(bot.x, f.hi[1], f.lo[1]);
  split(top.y, f.hi[2], f.lo[2]);
  split(bot.y, f.hi[3], f.lo[3]);
}

// nt B with k in the order 0 2 4 6 1 3 5 7: B(k, n) = Y(n0 + n, k0 + k),
// Y a row-major shared tile (ld even, k0 even).
__device__ __forceinline__ void load_b_nt_perm(FragB& f, const float* s,
                                               int ld, int n0, int k0,
                                               int lane) {
  const float2 v = *reinterpret_cast<const float2*>(
      s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3));
  split(v.x, f.hi[0], f.lo[0]);
  split(v.y, f.hi[1], f.lo[1]);
}

// A = X^T with k in the order 0 2 4 6 1 3 5 7: A(m, k) = X(k0 + k, m0 + m),
// X a row-major shared tile along m (rows k0 + 2t, k0 + 2t + 1; columns
// m0 + g, m0 + g + 8).
__device__ __forceinline__ void load_a_t(FragA& f, const float* s, int ld,
                                         int m0, int k0, int lane) {
  const float* p = s + (k0 + 2 * (lane & 3)) * ld + m0 + (lane >> 2);
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8], f.hi[1], f.lo[1]);
  split(p[ld], f.hi[2], f.lo[2]);
  split(p[ld + 8], f.hi[3], f.lo[3]);
}

// nn B: B(k, n) = Y(k0 + k, n0 + n) with k in the order 0 2 4 6 1 3 5 7.
__device__ __forceinline__ void load_b_nn(FragB& f, const float* s, int ld,
                                          int k0, int n0, int lane) {
  const float* p = s + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  split(p[0], f.hi[0], f.lo[0]);
  split(p[ld], f.hi[1], f.lo[1]);
}

// d += a b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// The loops below have no data-dependent branch inside: padding is
// handled by the callers' tile sizes and masks, so each k step is
// straight-line code that the scheduler can interleave (per-tile
// branches there cost more than the work they skipped; PERF.md).

// acc[j] += X Y_j^T for the NB n tiles j of 8 rows from row y0, over k in
// [0, K): an nt product of one warp's 16 rows (from x0).
template <int NB, int K>
__device__ __forceinline__ void nt1(float (&acc)[NB][4], const float* X,
                                    const float* Y, int ld, int x0, int y0,
                                    int lane) {
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    FragA a;
    load_a(a, X, ld, x0, k0, lane);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      FragB b;
      load_b_nt(b, Y, ld, y0 + 8 * j, k0, lane);
      mma3(acc[j], a, b);
    }
  }
}

// acc[j] += X Y_j^T and acc2[j] += X2 Y2_j^T for the NB n tiles j of 8
// rows from row y0, over k in [0, K): two nt products of one warp's 16
// rows (from x0) that share the loop.
template <int NB, int K>
__device__ __forceinline__ void nt2(float (&acc)[NB][4], const float* X,
                                    const float* Y, float (&acc2)[NB][4],
                                    const float* X2, const float* Y2,
                                    int ld, int x0, int y0, int lane) {
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    FragA a, a2;
    load_a(a, X, ld, x0, k0, lane);
    load_a(a2, X2, ld, x0, k0, lane);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      FragB b;
      load_b_nt(b, Y, ld, y0 + 8 * j, k0, lane);
      mma3(acc[j], a, b);
      load_b_nt(b, Y2, ld, y0 + 8 * j, k0, lane);
      mma3(acc2[j], a2, b);
    }
  }
}

// acc[n] += P Y[k0 .. k0+8, c0 + 8n ..]: one nn k step into NN n tiles.
template <int NN>
__device__ __forceinline__ void nn(float (&acc)[NN][4], const FragA& a,
                                   const float* Y, int ld, int k0, int c0,
                                   int lane) {
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    FragB b;
    load_b_nn(b, Y, ld, k0, c0 + 8 * n, lane);
    mma3(acc[n], a, b);
  }
}

// d += a b in 3xTF32, the k step's three MMAs summed from zero and added
// to d by one fp32 add (round to nearest). The MMA's own accumulation is
// coarser than an fp32 add: over a product that runs over many k steps
// into one accumulator (the forwards' O = P V, over every key) its error
// builds up with |d|; summed from zero it stays within one k step's
// partial. The forwards need it: with P V on mma3, a b256 train step on
// the flash arm came out further from the fp32 plain version than its
// gate allows (PERF.md). One FADD per accumulator a k step.
__device__ __forceinline__ void mma3_add(float (&d)[4], const FragA& a,
                                         const FragB& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// nn with mma3_add.
template <int NN>
__device__ __forceinline__ void nn_add(float (&acc)[NN][4], const FragA& a,
                                       const float* Y, int ld, int k0,
                                       int c0, int lane) {
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    FragB b;
    load_b_nn(b, Y, ld, k0, c0 + 8 * n, lane);
    mma3_add(acc[n], a, b);
  }
}

// Reductions over the 4 lanes of a quad (one row of a C fragment).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// 16-byte cp.async global -> shared; with full == false the 16 bytes are
// zero-filled and nothing is read.
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy n rows of DH floats (row stride `stride` floats, 16-byte aligned)
// into shared rows of ld floats with cp.async; rows >= valid are zero.
// Threads `first` .. `first + count` of the block take part.
template <int DH>
__device__ __forceinline__ void stage(float* s, int ld, const float* g,
                                      size_t stride, int n, int valid,
                                      int first, int count) {
  constexpr int V = DH / 4;
  for (int i = (int)threadIdx.x - first; i < n * V; i += count) {
    const int r = i / V, c = (i % V) * 4;
    const bool ok = r < valid;
    cp16(s + r * ld + c, g + (ok ? (size_t)r * stride : 0) + c, ok);
  }
}

}  // namespace tf32x3
