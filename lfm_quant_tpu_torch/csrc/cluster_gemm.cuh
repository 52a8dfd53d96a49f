// The bf16 tensor-core GEMM xw = hin @ W_x + b into an f32 scratch, shared
// by the fused forward (csrc/rnn_fwd_cluster.cu, its kernel 0) and the
// fused backward (csrc/rnn_bwd_cluster.cu, which recomputes the scratch
// with it where the forward's is gone), so that the two agree bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"
#include "tf32_common.cuh"

namespace lfm_cluster {
namespace {

using namespace lfm_mma;
using lfm_tf32::cp_async_wait;

// Kernel 0: output rows and columns per block, k per stage, stages,
// threads; the tiles' row strides in bf16 elements (16 bytes of padding:
// the eight row addresses of each ldmatrix fall in distinct banks).
constexpr int kGmRows = 128;
constexpr int kGmCols = 128;
constexpr int kGmK = 32;
constexpr int kGmStages = 3;
constexpr int kGmThreads = 256;
constexpr int kGmLA = kGmK + 8;
constexpr int kGmLB = kGmCols + 8;
constexpr int kGmStage = kGmRows * kGmLA + kGmK * kGmLB;

inline size_t gemm_smem_bytes() { return (size_t)kGmStages * kGmStage * 2; }

// Kernel 0, per seed (blockIdx.z): C[M, N] = A[M, K] @ W[K, N] + bias[N];
// A, W, bias bf16 row-major, C f32; K and N multiples of 16. Block
// (blockIdx.x, blockIdx.y) makes rows [128 x, +128) and columns [128 y,
// +128); warp w rows 64 (w % 2) + [0, 64) and columns 32 (w / 2) + [0, 32).
// Stages past M, N or K are zero-filled.
__global__ void __launch_bounds__(kGmThreads, 2)
xw_gemm_kernel(const __nv_bfloat16* __restrict__ A,
               const __nv_bfloat16* __restrict__ W,
               const __nv_bfloat16* __restrict__ bias,
               float* __restrict__ Cout, int M, int N, int K, long long sA,
               long long sW, long long sBias, long long sC) {
  extern __shared__ __align__(16) unsigned char gsm[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(gsm);
  {
    const size_t seed = blockIdx.z;
    A += seed * sA;
    W += seed * sW;
    bias += seed * sBias;
    Cout += seed * sC;
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * kGmRows;
  const int n0 = blockIdx.y * kGmCols;
  const int wm = (warp & 1) * 64;
  const int wn = (warp >> 1) * 32;
  const int nk = (K + kGmK - 1) / kGmK;

  auto load_stage = [&](int kt) {
    __nv_bfloat16* as = smem + (kt % kGmStages) * kGmStage;
    __nv_bfloat16* bs = as + kGmRows * kGmLA;
    const int k0 = kt * kGmK;
    for (int i = tid; i < kGmRows * (kGmK / 8); i += kGmThreads) {
      const int r = i / (kGmK / 8);
      const int kc = (i - r * (kGmK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + kc < K;
      cp_async16(as + r * kGmLA + kc,
                 ok ? A + (size_t)(m0 + r) * K + k0 + kc : A, ok ? 16 : 0);
    }
    for (int i = tid; i < kGmK * (kGmCols / 8); i += kGmThreads) {
      const int k = i / (kGmCols / 8);
      const int nc = (i - k * (kGmCols / 8)) * 8;
      const bool ok = k0 + k < K && n0 + nc < N;
      cp_async16(bs + k * kGmLB + nc,
                 ok ? W + (size_t)(k0 + k) * N + n0 + nc : W, ok ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  // ldmatrix row addresses: lanes 8i .. 8i + 7 give matrix i's rows (A:
  // rows 0-7 / 8-15 at k 0 / 8; W: k rows 0-7 / 8-15 at columns 0 / 8).
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;

#pragma unroll
  for (int i = 0; i < kGmStages - 1; ++i) {
    if (i < nk) load_stage(i);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kGmStages - 2>();
    // Stage kt is in place; every warp is done with stage kt - 1's slot.
    __syncthreads();
    if (kt + kGmStages - 1 < nk) load_stage(kt + kGmStages - 1);
    cp_async_commit();
    const __nv_bfloat16* as = smem + (kt % kGmStages) * kGmStage;
    const __nv_bfloat16* bs = as + kGmRows * kGmLA;
#pragma unroll
    for (int kk = 0; kk < kGmK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], as + (wm + mt * 16 + lrow) * kGmLA + kk + lcol);
      uint2 bw[4];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + lrow) * kGmLB + wn + np * 16 + lcol);
        bw[2 * np] = make_uint2(r[0], r[1]);
        bw[2 * np + 1] = make_uint2(r[2], r[3]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], bw[nt]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn + nt * 8 + c2;
    if (col >= N) continue;
    const float b0 = __bfloat162float(bias[col]);
    const float b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mt * 16 + g + 8 * half;
        if (row < M)
          *reinterpret_cast<float2*>(Cout + (size_t)row * N + col) =
              make_float2(acc[mt][nt][2 * half] + b0,
                          acc[mt][nt][2 * half + 1] + b1);
      }
  }
}

inline cudaError_t launch_gemm(const void* A, const void* W, const void* bias,
                        float* Cout, int M, int N, int K, int seeds,
                        long long sA, long long sW, long long sBias,
                        long long sC, cudaStream_t stream) {
  const size_t smem = gemm_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      xw_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  xw_gemm_kernel<<<dim3((M + kGmRows - 1) / kGmRows,
                        (N + kGmCols - 1) / kGmCols, seeds),
                   kGmThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(A),
      static_cast<const __nv_bfloat16*>(W),
      static_cast<const __nv_bfloat16*>(bias), Cout, M, N, K, sA, sW, sBias,
      sC);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lfm_cluster
