// The bf16 helpers the bfloat16 kernels share (slab_attn_bf16.cu,
// gn_conv.cu's bf16 GEMMs, gn_common.cuh's bf16 units): the rounding of
// float32 pairs to bf16x2 and the quad reductions of a fragment row.
// Device code only; built for sm_90a.
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
