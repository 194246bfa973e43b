// Hopper's warpgroup tensor-core product and tensor memory accelerator
// for the bf16 GEMMs of the fused GN+SiLU+conv3 (gn_conv.cu) and the bf16
// slab attention (slab_attn_bf16.cu): hand-written PTX wrappers, in the
// idiom of bf16mma.cuh and tf32x3.cuh. sm_90a only
// (wgmma exists for that target alone). Device code, and the host code
// that encodes a TMA tensor map.
//
// * wgmma.mma_async m64n64k16 and m64n32k16, f32 += bf16 x bf16, in the
//   RS form: A (64 x 16) from registers, B (16 x N) from shared memory by
//   a matrix descriptor. Four warps issue it together; warp w of the
//   warpgroup holds rows 16 w .. 16 w + 15 of A and of the accumulator, in the
//   mma.m16n8k16 layouts (bf16mma.cuh) repeated along N: with lane = 4 g
//   + t, accumulator register 4 i + e is row g + 8 (e >> 1), column 8 i +
//   2 t + (e & 1). The product is asynchronous: fence before the first
//   wgmma that reads registers written since (`fence`, and `fence_regs`
//   so that the compiler keeps its own accesses on the right side),
//   `commit` the issued ones as a group, `wait<N>` until at most N groups
//   are in flight. Until then neither the accumulator nor A's registers
//   may be touched. 989 TFLOP/s dense on an H100 SXM.
// * Matrix descriptors for 64- and 128-byte swizzled tiles (`desc`).
//   K-major (B(k, n) at row n, k contiguous; tnspB = 0): rows of the
//   swizzle's width, SBO = the stride of 8-row groups (8 x the row bytes),
//   LBO unused (1, CUTLASS's value); a k16 step advances the start address
//   by 32 bytes within the row. MN-major (B(k, n) at row k, n contiguous;
//   tnspB = 1) with 128-byte swizzle: rows of 64 n values, 8-row groups
//   along k; each wgmma here reads one 64-wide panel, so the stride
//   between 64-wide atoms along n is never used, and LBO = SBO = 1024
//   (the 8-row group stride) holds whichever of the two the hardware
//   reads for it; with 64-byte swizzle the same for rows of 32 n values
//   (LBO = SBO = 512). Tiles start on 1024-byte boundaries (base offset
//   0).
// * TMA: `cp.async.bulk.tensor` 2-D and 3-D loads into shared memory,
//   completing on an mbarrier with a transaction count; out-of-range
//   elements, negative coordinates included, land as zeros. Tensor maps
//   are encoded on the host (`bf16_map`) by cuTensorMapEncodeTiled,
//   reached through cudaGetDriverEntryPoint(ByVersion) so the library
//   needs no -lcuda, and passed as __grid_constant__ kernel parameters.
//   With a 64- or 128-byte swizzle the box's inner extent is the
//   swizzle's width, and TMA writes 16-byte chunk c of row r at chunk c ^
//   (r >> 1 & 3) (64-byte rows) or c ^ (r & 7) (128-byte rows): what
//   `sw64` / `sw128` give for an ldmatrix row address.
// * mbarriers (init, arrive, arrive with an expected transaction count,
//   try_wait on a phase parity), a named barrier, and
//   `fence.proxy.async`, which orders a thread's generic accesses to a
//   tile before a later TMA fill of it.
//   `mbar_wait` gives up with a trap after 2^22 failed tries (seconds),
//   so a barrier that never completes ends the kernel with an error
//   instead of hanging the card.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(saddr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// a plain arrival (no transaction count)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   saddr(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 22)) __trap();
}

// ---- TMA ----------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// orders this thread's generic-proxy accesses to shared memory before
// later async-proxy ones (a TMA fill of the same slot)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier among `threads` threads (a multiple of 32) under id 1-15
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The byte offset of 16-byte chunk c of row r in a swizzled tile of
// 64-byte or 128-byte rows, as TMA writes it.
__device__ __forceinline__ uint32_t sw64(int r, int c) {
  return (uint32_t)(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
}
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// ---- ldmatrix -----------------------------------------------------------

// Four 8 x 8 b16 matrices, lanes 8 i .. 8 i + 7 giving matrix i's row
// addresses; lane 4 g + t gets row g, columns 2t, 2t+1 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The same, transposed: lane 4 g + t gets rows 2t, 2t+1 of column g.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ---- wgmma --------------------------------------------------------------

constexpr uint32_t SWIZZLE_128B = 1, SWIZZLE_64B = 2;

// A shared-memory matrix descriptor: start address (shared window), the
// leading and stride byte offsets, the swizzle mode.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) |
         ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving its own reads or writes of the
// accumulator across this point (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, float32) += a (64 x 16 bf16, registers) b (16 x 64 bf16,
// shared memory by descriptor); TNSP_B = 0: b K-major, 1: MN-major.
template <int TNSP_B>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TNSP_B),
        "r"(1));
}

// d (64 x 32, float32) += a (64 x 16 bf16, registers) b (16 x 32 bf16,
// shared memory by descriptor); the accumulator layout of mma_rs_n64 cut
// to 4 n tiles.
template <int TNSP_B>
__device__ __forceinline__ void mma_rs_n32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %21;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TNSP_B),
        "r"(1));
}

// The RS product by the accumulator's width: 32 registers a thread are
// N = 64, 16 are N = 32.
template <int TNSP_B>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  mma_rs_n64<TNSP_B>(d, a, b);
}
template <int TNSP_B>
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t b) {
  mma_rs_n32<TNSP_B>(d, a, b);
}

// ---- host: TMA tensor maps ----------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry
// point query; null where it is missing.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess && p)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of a bf16 tensor of `rank` (2 or 3) dimensions, innermost
// first (`dims`), with the byte strides of dimensions 1.. (`strides`,
// multiples of 16), loaded in boxes of `box` elements with the given
// swizzle; out-of-range elements are read as zeros. The base must start
// on a 16-byte boundary.
inline cudaError_t bf16_map(CUtensorMap* map, const void* base, int rank,
                            const cuuint64_t* dims,
                            const cuuint64_t* strides, const cuuint32_t* box,
                            CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16) return cudaErrorInvalidValue;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        (cuuint32_t)rank, const_cast<void*>(base), dims,
                        strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg
