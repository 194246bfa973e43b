// The bf16 helpers the bfloat16 kernels share (slab_attn_bf16.cu,
// gn_conv.cu's bf16 GEMMs, gn_common.cuh's bf16 units, core_onepass.cu,
// ensemble_attn.cu): the rounding of float32 values and pairs to bf16,
// the quad reductions of a fragment row, the fragment layouts, and the
// warp-level mma.sync m16n8k16 and ldmatrix that ensemble_attn.cu runs
// its products on. Device code only; built for sm_90a.
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
//     B (16 x 8):  b0 (2t..2t+1, g)    b1 (2t+8..2t+9, g)
//     C (16 x 8):  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// ldmatrix gives lane 4 g + t row g, columns 2t, 2t+1 of an 8 x 8 b16
// matrix (.trans: rows 2t, 2t+1 of column g). So for C = X Y^T, X and Y
// row-major along k, A is ldmatrix of X's rows and B of Y's rows; for
// C = X Y with Y row-major along n, B is ldmatrix.trans of Y's rows.
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

// Reductions over the 4 lanes of a quad (one row of a C fragment).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// d += a b: mma.sync.m16n8k16 with bf16 A and B, float32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix of four (two) 8 x 8 b16 matrices at a shared-window address:
// lanes 8 i .. 8 i + 7 give matrix i's row addresses (for .x2, lanes
// 0-15), register i holds matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_t(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

}  // namespace bf16mma
