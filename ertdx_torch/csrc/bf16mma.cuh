// The bf16 tensor-core tile of the bfloat16 slab attention kernels
// (slab_attn_bf16.cu; gn_conv.cu's bf16 GEMMs, on wgmma.cuh, take its
// pack). Device code only; sm_80 and later, built for sm_90a.
//
// One product a b of bf16 operands runs as one warp-level
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// with float32 accumulation: each product of two bf16 values is exact in
// float32, so a product whose operands are bf16 already (S = Q K^T,
// dP = dO V^T) is exact up to the sum's order; an operand computed in
// float32 (P, dS) is rounded to bf16 for its product, to nearest even
// (__float2bfloat16), as the TPU kernel's DEFAULT precision rounds it.
// That is the TPU kernel's class (ertdx/ops/slab_attn.py:85-93): one bf16
// pass a product, float32 accumulation. 989 TFLOP/s dense on an H100 SXM.
//
// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k16", .bf16), with
// lane = 4 g + t; each 32-bit register holds two bf16 values adjacent
// along k, the lower k in the lower half:
//     A (16 x 16): a0 (g, 2t..2t+1)    a1 (g+8, 2t..2t+1)
//                  a2 (g, 2t+8..2t+9)  a3 (g+8, 2t+8..2t+9)
//     B (16 x 8):  b0 (2t..2t+1, g)    b1 (2t+8..2t+9, g)
//     C (16 x 8):  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// So the C fragments of two neighbouring n tiles (columns 0-7, 8-15) are
// the A fragment of a k step of 16 with no data movement (from_c2): the
// P of S = Q K^T feeds O = P V from the registers it was computed in.
//
// Operands come from row-major shared tiles of bf16 with a row stride of
// LD = DH + 8 values (DH 32 or 64: 80 or 144 bytes, 20 or 36 words):
//   * "nt" (B(k, n) = Y(n0 + n, k0 + k): S = Q K^T, dP = dO V^T) and A
//     read one 32-bit word a register; lane (g, t) hits bank
//     LD/2 g + t (mod 32), 32 distinct banks for both strides;
//   * "nn" (B(k, n) = Y(k0 + k, n0 + n): O = P V, dQ = dS K, dV = P^T dO,
//     dK = dS^T Q) needs Y transposed: ldmatrix.x4.trans loads the B
//     fragments of two n tiles, 8 rows of 16 bytes a matrix, rows at
//     distinct 4-bank groups for both strides.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16mma {

using bf16 = __nv_bfloat16;
constexpr unsigned FULL = 0xffffffffu;

// d += a b, bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats as bf16x2, each rounded to nearest even; lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// A: rows [m0, m0+16), columns [k0, k0+16) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int ld, int m0, int k0, int lane) {
  const bf16* p = s + (m0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// The A fragment of a k step of 16 from the C fragments of two n tiles
// (columns k0 .. k0+7 in c0, k0+8 .. k0+15 in c1), rounded to bf16.
__device__ __forceinline__ void from_c2(uint32_t (&a)[4],
                                        const float (&c0)[4],
                                        const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// nt B: B(k, n) = Y(n0 + n, k0 + k), Y a row-major tile.
__device__ __forceinline__ void load_b_nt(uint32_t (&b)[2], const bf16* s,
                                          int ld, int n0, int k0,
                                          int lane) {
  const bf16* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// nn B of two n tiles: B(k, n) = Y(k0 + k, n0 + n) for n in [0, 16), Y a
// row-major shared tile: b[0], b[1] for columns n0 .. n0+7 and b[2],
// b[3] for n0+8 .. n0+15. Lanes 0-15 give rows k0 .. k0+15 at column
// n0, lanes 16-31 the same rows at n0 + 8; .trans hands lane (g, t)
// rows 2t, 2t+1 of column g of each 8 x 8 matrix.
__device__ __forceinline__ void load_b_nn2(uint32_t (&b)[4], const bf16* s,
                                           int ld, int k0, int n0,
                                           int lane) {
  const bf16* p = s + (k0 + (lane & 15)) * ld + n0 + 8 * (lane >> 4);
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
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
__device__ __forceinline__ void cp16(void* dst, const void* src,
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

// Copy n rows of DH bf16 values (row stride `stride` values, 16-byte
// aligned) into shared rows of ld values with cp.async, 8 values a copy;
// rows >= valid are zero. Threads `first` .. `first + count` of the
// block take part.
template <int DH>
__device__ __forceinline__ void stage(bf16* s, int ld, const bf16* g,
                                      size_t stride, int n, int valid,
                                      int first, int count) {
  constexpr int V = DH / 8;
  for (int i = (int)threadIdx.x - first; i < n * V; i += count) {
    const int r = i / V, c = (i % V) * 8;
    const bool ok = r < valid;
    cp16(s + r * ld + c, g + (ok ? (size_t)r * stride : 0) + c, ok);
  }
}

}  // namespace bf16mma
