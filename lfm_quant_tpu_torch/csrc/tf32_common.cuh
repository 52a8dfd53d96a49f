// The float32 tensor-core machinery shared by the 3xTF32 recurrence kernels
// (rnn_bwd_tf32.cu, rnn_fwd_tf32.cu): the split of an f32 operand into two
// TF32 terms, the m16n8k8 .tf32 fragments and products, the cluster
// barriers, the per-operand seed strides, and the backward's 3xTF32 GEMM
// with its launcher (xw = hin @ W_x + b and dhin = d_xw @ W_x^T).
//
// Numerics (3xTF32). Every product with an f32 operand splits it, x = hi +
// lo with hi = tf32(x) (10 mantissa bits, rounded to nearest, ties away
// from zero: the bits of cvt.rna.tf32.f32) and lo = x - hi truncated to
// TF32 (the backward) or rounded to it like hi (RN_LO: the forward), and
// runs three mma.sync per product, a_lo b_hi and a_hi b_lo before a_hi
// b_hi into one f32 accumulator; the dropped a_lo b_lo term and the
// rounding of lo leave a relative error near 2^-21 per product (half that
// with lo rounded; one TF32 term alone keeps about 11 bits: 2^-11). The
// tensor cores add into their f32 accumulator with truncation, so no
// accumulator takes more than 64 of k (24 mma.sync) before its sum is added
// to an f32 register (the backward's recurrence: kChainK; the forward's:
// its own, shorter chain; the GEMM: one stage, kGmK). The truncation also
// biases each sum toward zero: on the c2 train step's xw the GEMM's mean
// error toward |xw| is -7.5e-8 (-3.3e-8 with a chain of 8), where an f32
// FMA sum's is -3e-11.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace lfm_tf32 {
namespace {

using lfm_mma::cp_async16;
using lfm_mma::cp_async_commit;

// k per mma chain of the backward's recurrence before its sum is added to
// an f32 register (the tensor cores' f32 accumulation truncates, so long
// chains drift toward zero).
constexpr int kChainK = 64;
// The GEMM: output rows and columns per tile, k per stage, shared-memory
// stages, tiles per block, threads.
constexpr int kGmRows = 128;
constexpr int kGmCols = 64;
constexpr int kGmK = 32;
constexpr int kGmStages = 3;
constexpr int kGmTiles = 4;
constexpr int kGmThreads = 256;

__device__ __forceinline__ float sigmoid(float v) {
  return __frcp_rn(1.0f + expf(-v));
}

// v = hi + lo: hi = tf32(v), rounded to nearest with ties away from zero
// (half a TF32 ulp added to the magnitude's bits, then the low 13 bits
// cleared: the bits cvt.rna.tf32.f32 gives), and lo = v - hi (exact in f32)
// truncated to TF32, or (RN_LO) rounded as hi is. Integer operations, at
// the ALUs' full rate: forming both halves by the conversion instruction
// made the fused LSTM backward 18% slower at the c2 train step
// (scripts/torch_mma_variants.py --kernel bwd_tf32, variant cvt_rna).
template <bool RN_LO = false>
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
  lo = (RN_LO ? lo + 0x1000u : lo) & 0xFFFFE000u;
}

// The m16n8k8 A fragment (a0 (g, k0), a1 (g + 8, k0), a2 (g, k1), a3 (g + 8,
// k1)) and B fragment (b0 (k0, g), b1 (k1, g)), split.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

template <bool RN_LO = false>
__device__ __forceinline__ void frag_a(FragA& f, float a0, float a1, float a2,
                                       float a3) {
  split_tf32<RN_LO>(a0, f.hi[0], f.lo[0]);
  split_tf32<RN_LO>(a1, f.hi[1], f.lo[1]);
  split_tf32<RN_LO>(a2, f.hi[2], f.lo[2]);
  split_tf32<RN_LO>(a3, f.hi[3], f.lo[3]);
}

template <bool RN_LO = false>
__device__ __forceinline__ void frag_b(FragB& f, float b0, float b1) {
  split_tf32<RN_LO>(b0, f.hi[0], f.lo[0]);
  split_tf32<RN_LO>(b1, f.hi[1], f.lo[1]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two small terms, then the large one.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Seed strides in elements of the operands that may be shared (0: shared).
struct SeedStrides {
  long long xw, wh, m;
};

// The GEMM's shared memory: kGmStages stages of A [kGmRows][kGmK + 4] and
// of B ([kGmK][kGmCols + 8], or transposed [kGmCols][kGmK + 4]: the larger).
inline size_t gemm_smem_bytes() {
  const size_t b = (size_t)kGmK * (kGmCols + 8) > (size_t)kGmCols * (kGmK + 4)
                       ? (size_t)kGmK * (kGmCols + 8)
                       : (size_t)kGmCols * (kGmK + 4);
  return 4 * kGmStages * ((size_t)kGmRows * (kGmK + 4) + b);
}

// Per seed (blockIdx.z): C[M, N] = A[M, K] @ B (+ bias[N]), with B = W [K,
// N] row-major, or (TRANS_B) B = W^T for W [N, K] row-major. Output tiles
// kGmRows x kGmCols, 8 warps of 32 x 32; a block walks kGmTiles tiles down
// M (blockIdx.y) for one column tile (blockIdx.x), its (tile, k-stage)
// sequence streamed through kGmStages shared-memory stages by cp.async
// (zero-filled past M, N and K), so one tile's loads overlap the previous
// tile's products and stores. K and N are multiples of 4.
template <bool TRANS_B>
__global__ void __launch_bounds__(kGmThreads, 2)
tf32_gemm_kernel(const float* __restrict__ A, const float* __restrict__ W,
                 const float* __restrict__ bias, float* __restrict__ Cout,
                 int M, int N, int K, long long sA, long long sW,
                 long long sBias, long long sC) {
  constexpr int LA = kGmK + 4;
  constexpr int LB = TRANS_B ? kGmK + 4 : kGmCols + 8;
  constexpr int A_EL = kGmRows * LA;
  constexpr int STAGE = A_EL + (TRANS_B ? kGmCols : kGmK) * LB;
  extern __shared__ __align__(16) float smem[];
  {
    const size_t seed = blockIdx.z;
    A += seed * sA;
    W += seed * sW;
    if (bias != nullptr) bias += seed * sBias;
    Cout += seed * sC;
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int n0 = blockIdx.x * kGmCols;
  const int tile0 = blockIdx.y * kGmTiles;
  const int tiles = min(kGmTiles, (M + kGmRows - 1) / kGmRows - tile0);
  const int nk = (K + kGmK - 1) / kGmK;
  const int count = tiles * nk;  // (tile, k-stage) pairs of this block
  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * 32;

  auto load_stage = [&](int idx) {
    float* dst = smem + (idx % kGmStages) * STAGE;
    const int m0 = (tile0 + idx / nk) * kGmRows;
    const int k0 = (idx % nk) * kGmK;
    for (int i = tid; i < kGmRows * (kGmK / 4); i += kGmThreads) {
      const int r = i / (kGmK / 4);
      const int kc = (i - r * (kGmK / 4)) * 4;
      const bool ok = m0 + r < M && k0 + kc < K;
      cp_async16(dst + r * LA + kc,
                 ok ? A + (size_t)(m0 + r) * K + k0 + kc : A, ok ? 16 : 0);
    }
    float* bd = dst + A_EL;
    if (TRANS_B) {
      for (int i = tid; i < kGmCols * (kGmK / 4); i += kGmThreads) {
        const int n = i / (kGmK / 4);
        const int kc = (i - n * (kGmK / 4)) * 4;
        const bool ok = n0 + n < N && k0 + kc < K;
        cp_async16(bd + n * LB + kc,
                   ok ? W + (size_t)(n0 + n) * K + k0 + kc : W, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kGmK * (kGmCols / 4); i += kGmThreads) {
        const int k = i / (kGmCols / 4);
        const int nc = (i - k * (kGmCols / 4)) * 4;
        const bool ok = k0 + k < K && n0 + nc < N;
        cp_async16(bd + k * LB + nc,
                   ok ? W + (size_t)(k0 + k) * N + n0 + nc : W, ok ? 16 : 0);
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

#pragma unroll
  for (int i = 0; i < kGmStages - 1; ++i) {
    if (i < count) load_stage(i);
    cp_async_commit();
  }
  for (int idx = 0; idx < count; ++idx) {
    cp_async_wait<kGmStages - 2>();
    // Stage idx is in place; every warp is done with stage idx - 1's slot.
    __syncthreads();
    if (idx + kGmStages - 1 < count) load_stage(idx + kGmStages - 1);
    cp_async_commit();
    const float* cur = smem + (idx % kGmStages) * STAGE;
    const float* bs = cur + A_EL;
    float sacc[2][4][4];  // the stage's sums, added to acc in f32
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sacc[mt][nt][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kGmK; kk += 8) {
      FragA a[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = cur + (wm + mt * 16 + g) * LA + kk + c4;
        frag_a(a[mt], p[0], p[8 * LA], p[4], p[8 * LA + 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        FragB b;
        if (TRANS_B) {
          const float* p = bs + (wn + nt * 8 + g) * LB + kk + c4;
          frag_b(b, p[0], p[4]);
        } else {
          const float* p = bs + (kk + c4) * LB + wn + nt * 8 + g;
          frag_b(b, p[0], p[4 * LB]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma3(sacc[mt][nt], a[mt], b);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += sacc[mt][nt][i];
    if (idx % nk != nk - 1) continue;
    // The tile's last stage: store it and start the next one from zero.
    const int m0 = (tile0 + idx / nk) * kGmRows;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + wm + mt * 16 + g + 8 * half;
          const int col = n0 + wn + nt * 8 + 2 * c4;
          if (row < M && col < N) {
            float2 v = make_float2(acc[mt][nt][2 * half],
                                   acc[mt][nt][2 * half + 1]);
            if (bias != nullptr) {
              v.x += bias[col];
              v.y += bias[col + 1];
            }
            *reinterpret_cast<float2*>(Cout + (size_t)row * N + col) = v;
          }
          acc[mt][nt][2 * half] = 0.0f;
          acc[mt][nt][2 * half + 1] = 0.0f;
        }
  }
  cp_async_wait<0>();
}

template <bool TRANS_B>
cudaError_t launch_gemm(const float* A, const float* W, const float* bias,
                        float* Cout, int M, int N, int K, int seeds,
                        long long sA, long long sW, long long sBias,
                        long long sC, cudaStream_t stream) {
  auto kern = tf32_gemm_kernel<TRANS_B>;
  const size_t smem = gemm_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (M + kGmRows - 1) / kGmRows;
  kern<<<dim3((N + kGmCols - 1) / kGmCols, (tiles + kGmTiles - 1) / kGmTiles,
              seeds),
         kGmThreads, smem, stream>>>(A, W, bias, Cout, M, N, K, sA, sW, sBias,
                                     sC);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lfm_tf32
