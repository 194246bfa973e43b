// The bf16 helpers the bfloat16 kernels share (slab_attn_bf16.cu,
// gn_conv.cu's bf16 GEMMs, gn_common.cuh's bf16 units, core_block.cu's
// one-pass mode): the rounding of float32 pairs to bf16x2, the quad
// reductions of a fragment row, and the warp-level m16n8k16 MMA with its
// fragments loaded from float32 shared tiles. Device code only; built
// for sm_90a.
//
// An operand computed in float32 (P, dS, GN+SiLU's output) is rounded to
// bf16 for its product, to nearest even (__float2bfloat16), as the TPU
// kernels' DEFAULT precision rounds it; each product of two bf16 values
// is exact in float32, and the tensor cores sum them in float32. That is
// the TPU kernels' class (ertdx/ops/slab_attn.py:85-93): one bf16 pass a
// product, float32 accumulation.
//
// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k16", .bf16; a
// warpgroup MMA repeats them, warp w of the warpgroup holding rows 16 w
// .. 16 w + 15, see wgmma.cuh), with lane = 4 g + t; each 32-bit register
// holds two bf16 values adjacent along k, the lower k in the lower half:
//     A (16 x 16): a0 (g, 2t..2t+1)    a1 (g+8, 2t..2t+1)
//                  a2 (g, 2t+8..2t+9)  a3 (g+8, 2t+8..2t+9)
//     C (16 x 8):  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// So the C fragments of two neighbouring n tiles (columns 0-7, 8-15),
// packed, are the A fragment of a k step of 16 with no data movement: the
// P of S = Q K^T feeds O = P V from the registers it was computed in. A
// row of C is spread over the 4 lanes of a quad (quad_max, quad_sum).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16mma {

using bf16 = __nv_bfloat16;
constexpr unsigned FULL = 0xffffffffu;

// Two floats as bf16x2, each rounded to nearest even; lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// x rounded to bf16 to nearest even, as a float.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// d += a b: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A: rows [m0, m0+16), columns [k0, k0+16) of a row-major float32 shared
// tile (ld and k0 even), rounded to bf16.
__device__ __forceinline__ void load_a_f32(uint32_t (&a)[4], const float* s,
                                           int ld, int m0, int k0,
                                           int lane) {
  const float* p = s + (m0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float2 x2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 x3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
  a[0] = pack(x0.x, x0.y);
  a[1] = pack(x1.x, x1.y);
  a[2] = pack(x2.x, x2.y);
  a[3] = pack(x3.x, x3.y);
}

// nn B: B(k, n) = Y(k0 + k, n0 + n), Y a row-major float32 shared tile,
// rounded to bf16.
__device__ __forceinline__ void load_b_nn_f32(uint32_t (&b)[2],
                                              const float* s, int ld,
                                              int k0, int n0, int lane) {
  const float* p = s + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  b[0] = pack(p[0], p[ld]);
  b[1] = pack(p[8 * ld], p[9 * ld]);
}

// nt B: B(k, n) = Y(n0 + n, k0 + k), Y a row-major float32 shared tile
// (ld and k0 even), rounded to bf16.
__device__ __forceinline__ void load_b_nt_f32(uint32_t (&b)[2],
                                              const float* s, int ld,
                                              int n0, int k0, int lane) {
  const float* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8);
  b[0] = pack(x0.x, x0.y);
  b[1] = pack(x1.x, x1.y);
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

}  // namespace bf16mma
