// Fused GroupNorm + SiLU + Conv1d(k=3, stride 1, SAME), forward and
// backward (sm_90a, fp32 FMA).
//
// Replaces the TPU kernels of ertdx/ops/conv.py:
//   * gn_stats_kernel + tap3_gemm_kernel<true, false>
//                                  <- _gn_silu_conv3_kernel (:49-82)
//   * gn_stats_kernel, conv_dw_kernel + sum_rows_kernel (dW, db),
//     tap3_gemm_kernel<false, true> (dh) and gn_silu_bwd_kernel +
//     sum_rows_kernel (dx, dgamma, dbeta)
//                                  <- _gn_silu_conv3_bwd_kernel (:109-180)
// x (B, L, C), h = silu(GN(x)) with G groups, w (3, C, Cout), bias (Cout):
//   y[l] = h[l-1] w[0] + h[l] w[1] + h[l+1] w[2] + bias,
// h zero outside [0, L) ("SAME" padding of the conv's input). Backward:
//   dW[k] = sum_(b,l) h[l-1+k]^T g[l],  db = sum_(b,l) g[l],
//   dh[l] = g[l+1] w[0]^T + g[l] w[1]^T + g[l-1] w[2]^T,
// then the SiLU chain rule and the GN identity on dh (gn_common.cuh).
//
// What bounds it on an H100: operations. The products are 2 B L 3 C Cout
// FLOP: 29.6 GFLOP at the encoder's (256, 294, 256 -> 256), 0.442 ms at
// 67 TFLOP/s fp32; 14.8 GFLOP and 0.221 ms at L=147. The backward does
// twice that (dW and dh), 0.884 and 0.442 ms.
//
// What the design does about it, and what it changes from the TPU kernel:
//   * The TPU kernel holds a whole (L, C) row in VMEM and runs three
//     shifted (L, C) @ (C, Cout) products on the MXU. Here the product is
//     a tiled GEMM written out in the kernel (no cuBLAS, cuDNN or CUTLASS
//     device GEMM): a block owns 64 positions of one batch row by 64
//     output channels and walks the input channels 16 at a time. Its
//     prologue loads input rows [l0-1, l0+64] (the halo the taps need),
//     applies GN+SiLU on the way into shared memory from per-(row, group)
//     mean and rstd that a small statistics launch wrote first, and zeroes
//     the rows outside the sequence. Each thread keeps a 4 x 4 output tile;
//     per input channel it reads the 6 input rows its 4 outputs' taps
//     touch and the three taps' 4 weights, i.e. 6 shared-memory loads feed
//     48 FMAs, so the FMA pipe and not shared memory is the limit. (A
//     64 x 128 tile with 4 x 8 outputs a thread measured slower: 2 blocks
//     an SM instead of 4.) A step's loads are gathered into registers
//     together before any is transformed and stored; issuing them before
//     the previous step's FMAs instead measured slower: at the 128
//     registers that two blocks an SM allow, the kernel spilled.
//   * dh is the same GEMM with g as input, no prologue, and the taps
//     reversed and transposed (w[2-j]^T); the GN backward then runs on dh
//     as in kernel 5 (gn_silu_bwd_kernel).
//   * dW is a reduction over B L rows into a (3 C, Cout) result that is
//     too small to fill the card by output tiles alone (48 tiles of 64 x
//     64 at 256 channels). The rows are split S ways (S from the SM
//     count, so that all blocks run in one wave): a block owns 64 input
//     by 64 output channels, all three taps, of every S-th batch row, and
//     slides a 3-row window of h down the sequence so that one h load and
//     one g load feed 48 FMAs. Each split
//     writes its own partial; a second launch adds the S partials in
//     order. No float atomics: two runs give the same bits. The TPU's
//     per-row (B, 3, C, Cout) partials (201 MB at the encoder shape) are
//     not carried over.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError().

#include "gn_common.cuh"

namespace {

constexpr int TM = 64;            // sequence positions of a GEMM block
constexpr int TN = 64;            // output channels of a GEMM block
constexpr int TK = 16;            // input channels per shared-memory step
constexpr int AS_LD = TM + 4;     // TM + 2 halo rows, padded to 16 bytes
constexpr int BS_LD = TN + 4;
constexpr int TR = 32;            // sequence positions per dW step
constexpr int TC = 64;            // input channels of a dW block
// loads a thread issues per shared-memory step, all before any is used
constexpr int A_LOADS = (TK * (TM + 2) + 255) / 256;
constexpr int B_LOADS = 3 * TK * TN / 256;
constexpr int H_LOADS = ((TR + 2) * TC + 255) / 256;
constexpr int G_LOADS = TR * TN / 256;

__device__ __forceinline__ float gn_silu_at(float v, const float* stats,
                                            int b, int G, int cg, int c,
                                            const float* gamma,
                                            const float* beta) {
  const int grp = c / cg;
  const float mean = stats[2 * ((size_t)b * G + grp)];
  const float rstd = stats[2 * ((size_t)b * G + grp) + 1];
  const float y = (v - mean) * rstd * gamma[c] + beta[c];
  return y * sigmoidf(y);
}

// out[b, l, :] = bias + sum_j A[b, l-1+j, :] @ W_j, with A[b, l] = 0
// outside [0, L). GN: A = silu(GN(a)) from `stats`, else A = a.
// WT = false: W_j = w[j], w (3, K, N). WT = true: W_j = w[2-j]^T, w
// (3, N, K). Grid (ceil(N/TN), ceil(L/TM), B), 256 threads; thread
// (ty, tx) owns rows ty*4..+3 and columns tx*4..+3.
template <bool GN, bool WT>
__global__ void __launch_bounds__(256, 2)   // <= 128 registers: 2 an SM
    tap3_gemm_kernel(const float* __restrict__ a,
                     const float* __restrict__ stats,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const float* __restrict__ w,
                     const float* __restrict__ bias,
                     float* __restrict__ out, int L, int K, int N, int G) {
  __shared__ __align__(16) float As[TK][AS_LD];
  __shared__ __align__(16) float Bs[3][TK][BS_LD];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int n0 = blockIdx.x * TN, l0 = blockIdx.y * TM, b = blockIdx.z;
  const int cg = GN ? K / G : 1;
  const float* ab = a + (size_t)b * L * K;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    // gather the step's inputs into registers first, so that the loads
    // are in flight together, then transform and store them
    float ra[A_LOADS], rb[B_LOADS];
#pragma unroll
    for (int r = 0; r < A_LOADS; ++r) {
      const int e = t + 256 * r;
      const int kk = e % TK, row = e / TK;
      const int l = l0 - 1 + row, c = k0 + kk;
      ra[r] = (e < TK * (TM + 2) && l >= 0 && l < L && c < K)
                  ? ab[(size_t)l * K + c] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < B_LOADS; ++r) {
      const int e = t + 256 * r;
      int j, kk, n;
      if (WT) {          // consecutive threads read consecutive k
        kk = e % TK;
        n = (e / TK) % TN;
        j = e / (TK * TN);
      } else {           // consecutive threads read consecutive n
        n = e % TN;
        kk = (e / TN) % TK;
        j = e / (TN * TK);
      }
      const int c = k0 + kk, col = n0 + n;
      rb[r] = 0.f;
      if (c < K && col < N)
        rb[r] = WT ? w[((size_t)(2 - j) * N + col) * K + c]
                   : w[((size_t)j * K + c) * N + col];
    }
#pragma unroll
    for (int r = 0; r < A_LOADS; ++r) {
      const int e = t + 256 * r;
      if (e >= TK * (TM + 2)) continue;
      const int kk = e % TK, row = e / TK;
      const int l = l0 - 1 + row, c = k0 + kk;
      float v = ra[r];
      if (GN && l >= 0 && l < L && c < K)
        v = gn_silu_at(v, stats, b, G, cg, c, gamma, beta);
      As[kk][row] = v;
    }
#pragma unroll
    for (int r = 0; r < B_LOADS; ++r) {
      const int e = t + 256 * r;
      if (WT)
        Bs[e / (TK * TN)][e % TK][(e / TK) % TN] = rb[r];
      else
        Bs[e / (TN * TK)][(e / TN) % TK][e % TN] = rb[r];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < TK; ++kk) {
      const float2 p0 = *reinterpret_cast<const float2*>(&As[kk][ty * 4]);
      const float2 p1 =
          *reinterpret_cast<const float2*>(&As[kk][ty * 4 + 2]);
      const float2 p2 =
          *reinterpret_cast<const float2*>(&As[kk][ty * 4 + 4]);
      const float a6[6] = {p0.x, p0.y, p1.x, p1.y, p2.x, p2.y};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 bv =
            *reinterpret_cast<const float4*>(&Bs[j][kk][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = a6[i + j];
          acc[i][0] += av * bv.x;
          acc[i][1] += av * bv.y;
          acc[i][2] += av * bv.z;
          acc[i][3] += av * bv.w;
        }
      }
    }
    __syncthreads();
  }

  const int col = n0 + tx * 4;
  if (col >= N) return;     // N % 4 == 0: a thread's 4 columns share fate
  float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bias != nullptr)
    bv = make_float4(bias[col], bias[col + 1], bias[col + 2], bias[col + 3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + ty * 4 + i;
    if (l < L)
      *reinterpret_cast<float4*>(&out[((size_t)b * L + l) * N + col]) =
          make_float4(acc[i][0] + bv.x, acc[i][1] + bv.y, acc[i][2] + bv.z,
                      acc[i][3] + bv.w);
  }
}

// Partial dW and db of split s over batch rows b = s, s + S, ...:
// part[s] = [dW (3, C, Cout) | db (Cout)]. h = silu(GN(x)) from `stats`.
// Grid (ceil(Cout/64), ceil(C/TC), S), 256 threads; each thread owns 4
// input channels x 4 output channels x 3 taps.
__global__ void __launch_bounds__(256)
    conv_dw_kernel(const float* __restrict__ x,
                   const float* __restrict__ stats,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   const float* __restrict__ gy, float* __restrict__ part,
                   int B, int L, int C, int Cout, int G, int S) {
  __shared__ __align__(16) float Hs[TR + 2][TC];
  __shared__ __align__(16) float Gs[TR][TN];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int o0 = blockIdx.x * TN, c0 = blockIdx.y * TC, s = blockIdx.z;
  const int cg = C / G;

  float acc[3][4][4];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][i][j] = 0.f;
  float dbacc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int b = s; b < B; b += S) {
    const float* xb = x + (size_t)b * L * C;
    const float* gb = gy + (size_t)b * L * Cout;
    for (int l0 = 0; l0 < L; l0 += TR) {
      // all of the step's loads first, as in tap3_gemm_kernel
      float rh[H_LOADS], rg[G_LOADS];
#pragma unroll
      for (int r = 0; r < H_LOADS; ++r) {
        const int e = t + 256 * r;
        const int cc = e % TC, row = e / TC;
        const int l = l0 - 1 + row, c = c0 + cc;
        rh[r] = (e < (TR + 2) * TC && l >= 0 && l < L && c < C)
                    ? xb[(size_t)l * C + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < G_LOADS; ++r) {
        const int e = t + 256 * r;
        const int oo = e % TN, row = e / TN;
        const int l = l0 + row, o = o0 + oo;
        rg[r] = (l < L && o < Cout) ? gb[(size_t)l * Cout + o] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < H_LOADS; ++r) {
        const int e = t + 256 * r;
        if (e >= (TR + 2) * TC) continue;
        const int cc = e % TC, row = e / TC;
        const int l = l0 - 1 + row, c = c0 + cc;
        Hs[row][cc] = (l >= 0 && l < L && c < C)
                          ? gn_silu_at(rh[r], stats, b, G, cg, c, gamma,
                                       beta)
                          : 0.f;
      }
#pragma unroll
      for (int r = 0; r < G_LOADS; ++r) {
        const int e = t + 256 * r;
        Gs[e / TN][e % TN] = rg[r];
      }
      __syncthreads();
      float4 hp = *reinterpret_cast<const float4*>(&Hs[0][ty * 4]);
      float4 hc = *reinterpret_cast<const float4*>(&Hs[1][ty * 4]);
#pragma unroll 4
      for (int r = 0; r < TR; ++r) {
        const float4 hn =
            *reinterpret_cast<const float4*>(&Hs[r + 2][ty * 4]);
        const float4 gv = *reinterpret_cast<const float4*>(&Gs[r][tx * 4]);
        const float hv[3][4] = {{hp.x, hp.y, hp.z, hp.w},
                                {hc.x, hc.y, hc.z, hc.w},
                                {hn.x, hn.y, hn.z, hn.w}};
        const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[k][i][j] += hv[k][i] * g4[j];
#pragma unroll
        for (int j = 0; j < 4; ++j) dbacc[j] += g4[j];
        hp = hc;
        hc = hn;
      }
      __syncthreads();
    }
  }

  float* ps = part + (size_t)s * (3 * (size_t)C * Cout + Cout);
  const int o = o0 + tx * 4;
  if (o >= Cout) return;    // Cout % 4 == 0
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + ty * 4 + i;
      if (c < C)
        *reinterpret_cast<float4*>(&ps[((size_t)k * C + c) * Cout + o]) =
            make_float4(acc[k][i][0], acc[k][i][1], acc[k][i][2],
                        acc[k][i][3]);
    }
  if (blockIdx.y == 0 && ty == 0)
    *reinterpret_cast<float4*>(&ps[3 * (size_t)C * Cout + o]) =
        make_float4(dbacc[0], dbacc[1], dbacc[2], dbacc[3]);
}

int conv_shape_ok(int B, int L, int C, int Cout, int G) {
  return gn_shape_ok(B, L, C, G) && Cout >= 4 && Cout % 4 == 0 &&
         B <= 65535 && C % 4 == 0;
}

dim3 gemm_grid(int B, int L, int N) {
  return dim3((N + TN - 1) / TN, (L + TM - 1) / TM, B);
}

}  // namespace

extern "C" {

// x (B, L, C), gamma, beta (C), w (3, C, Cout), bias (Cout) -> out
// (B, L, Cout). stats is (B, G, 2) scratch.
int ertdx_gn_conv3_fwd(const float* x, const float* gamma, const float* beta,
                       const float* w, const float* bias, float* out,
                       float* stats, int B, int L, int C, int Cout, int G,
                       float eps, void* stream) {
  if (!conv_shape_ok(B, L, C, Cout, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  gn_stats_kernel<<<B * G, GN_THREADS, 0, s>>>(x, stats, L, C, G, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tap3_gemm_kernel<true, false><<<gemm_grid(B, L, Cout), 256, 0, s>>>(
      x, stats, gamma, beta, w, bias, out, L, C, Cout, G);
  return (int)cudaGetLastError();
}

// x (B, L, C), gamma, beta (C), w (3, C, Cout), gy (B, L, Cout) ->
// dx (B, L, C), dgb (2 C: dgamma, dbeta), dwb (3 C Cout + Cout: dW, db).
// Scratch: stats (B, G, 2), dh (B, L, C), part_w (S, 3 C Cout + Cout),
// part_gn (B, 2, C). S splits the batch rows of the dW reduction, 1 <= S
// <= B.
int ertdx_gn_conv3_bwd(const float* x, const float* gamma, const float* beta,
                       const float* w, const float* gy, float* dx,
                       float* dgb, float* dwb, float* stats, float* dh,
                       float* part_w, float* part_gn, int B, int L, int C,
                       int Cout, int G, int S, float eps, void* stream) {
  if (!conv_shape_ok(B, L, C, Cout, G) || S < 1 || S > B)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  gn_stats_kernel<<<B * G, GN_THREADS, 0, s>>>(x, stats, L, C, G, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 dw_grid((Cout + TN - 1) / TN, (C + TC - 1) / TC, S);
  conv_dw_kernel<<<dw_grid, 256, 0, s>>>(x, stats, gamma, beta, gy, part_w,
                                         B, L, C, Cout, G, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int nw = 3 * C * Cout + Cout;
  sum_rows_kernel<<<(nw + 255) / 256, 256, 0, s>>>(part_w, dwb, S, nw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tap3_gemm_kernel<false, true><<<gemm_grid(B, L, C), 256, 0, s>>>(
      gy, nullptr, nullptr, nullptr, w, nullptr, dh, L, Cout, C, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gn_silu_bwd_kernel<<<B * G, GN_THREADS, 0, s>>>(x, gamma, beta, dh, dx,
                                                  part_gn, L, C, G, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_rows_kernel<<<(2 * C + 255) / 256, 256, 0, s>>>(part_gn, dgb, B,
                                                      2 * C);
  return (int)cudaGetLastError();
}

}  // extern "C"
