// The float32 tensor-core machinery shared by the 3xTF32 recurrence kernels
// (rnn_bwd_tf32.cu, rnn_bwd_tf32_grid.cu, rnn_fwd_tf32.cu,
// rnn_fwd_tf32_grid.cu): the split of an f32 operand into two TF32 terms,
// the m16n8k8 .tf32 fragments and products, the cluster barriers, the
// per-operand seed strides, the backward's 3xTF32 GEMM with its launcher
// (xw = hin @ W_x + b, dhin = d_xw @ W_x^T and, in its gates mode, every
// step's gate pre-activations), the forwards' f32 FMA GEMM on the CUDA
// cores (their xw, unbiased: see rnn_fwd_tf32.cu), the cell's backward, and
// the backwards' weight-gradient kernels with their fixed-order slice
// sum.
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
using lfm_mma::cp_async_wait_all;

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

constexpr int kLstm = 0;
constexpr int kGru = 1;
// The weight-gradient kernel: gate columns and output rows per block, rows
// per stage, threads.
constexpr int kWgCols = 64;
constexpr int kWgOut = 128;
constexpr int kWgRows = 32;
constexpr int kWgThreads = 256;

// Seed strides in elements of the operands that may be shared (0: shared).
struct SeedStrides {
  long long xw, wh, m;
};

// The GEMM's gates mode (GATES): the rows of A are read one step back
// within each sequence of Tn rows, zero at a sequence's first step (A =
// h_all: row m is h_{t-1}), and the product is stored split at column nx:
// C[:, :nx] = X[:, :nx] + the product (X the x side [M, N], its seed
// stride sX; null: C itself, in place), hn[:, :N - nx] = the product's
// other columns (the GRU's h side of n, seed stride sHn) and C[:, nx:] =
// X[:, nx:].
struct GatesArgs {
  const float* x;
  float* hn;
  int Tn, nx;
  long long sX, sHn;
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
// N] row-major, or (TRANS_B) B = W^T for W [N, K] row-major; GATES as
// GatesArgs says (no bias). Output tiles
// kGmRows x kGmCols, 8 warps of 32 x 32; a block walks kGmTiles tiles down
// M (blockIdx.y) for one column tile (blockIdx.x), its (tile, k-stage)
// sequence streamed through kGmStages shared-memory stages by cp.async
// (zero-filled past M, N and K), so one tile's loads overlap the previous
// tile's products and stores. K and N are multiples of 4.
template <bool TRANS_B, bool GATES>
__global__ void __launch_bounds__(kGmThreads, 2)
tf32_gemm_kernel(const float* __restrict__ A, const float* __restrict__ W,
                 const float* __restrict__ bias, float* __restrict__ Cout,
                 int M, int N, int K, long long sA, long long sW,
                 long long sBias, long long sC, GatesArgs ga) {
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
    if (GATES) {
      if (ga.x != nullptr) ga.x += seed * ga.sX;
      if (ga.hn != nullptr) ga.hn += seed * ga.sHn;
    }
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
      // GATES: row m reads A's row m - 1, none at a sequence's first step.
      const bool ok = m0 + r < M && k0 + kc < K &&
                      (!GATES || (m0 + r) % ga.Tn != 0);
      const int ar = GATES ? m0 + r - 1 : m0 + r;
      cp_async16(dst + r * LA + kc,
                 ok ? A + (size_t)ar * K + k0 + kc : A, ok ? 16 : 0);
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
          if (GATES && row < M && col < N) {
            float2 v = make_float2(acc[mt][nt][2 * half],
                                   acc[mt][nt][2 * half + 1]);
            if (col < ga.nx) {
              // The x side plus the h side: xw + hw, the plain order.
              const size_t at = (size_t)row * N + col;
              const float2 x =
                  ga.x != nullptr
                      ? *reinterpret_cast<const float2*>(ga.x + at)
                      : *reinterpret_cast<const float2*>(Cout + at);
              *reinterpret_cast<float2*>(Cout + at) =
                  make_float2(x.x + v.x, x.y + v.y);
            } else {
              *reinterpret_cast<float2*>(
                  ga.hn + (size_t)row * (N - ga.nx) + col - ga.nx) = v;
              // The x side of these columns, copied where C is not X.
              if (ga.x != nullptr) {
                const size_t at = (size_t)row * N + col;
                *reinterpret_cast<float2*>(Cout + at) =
                    *reinterpret_cast<const float2*>(ga.x + at);
              }
            }
          } else if (row < M && col < N) {
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

template <bool TRANS_B, bool GATES = false>
cudaError_t launch_gemm(const float* A, const float* W, const float* bias,
                        float* Cout, int M, int N, int K, int seeds,
                        long long sA, long long sW, long long sBias,
                        long long sC, cudaStream_t stream,
                        GatesArgs ga = GatesArgs{}) {
  auto kern = tf32_gemm_kernel<TRANS_B, GATES>;
  const size_t smem = gemm_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (M + kGmRows - 1) / kGmRows;
  kern<<<dim3((N + kGmCols - 1) / kGmCols, (tiles + kGmTiles - 1) / kGmTiles,
              seeds),
         kGmThreads, smem, stream>>>(A, W, bias, Cout, M, N, K, sA, sW, sBias,
                                     sC, ga);
  return cudaGetLastError();
}

// The forwards' x-side GEMM on the CUDA cores (rnn_fwd_tf32.cu's and
// rnn_fwd_tf32_grid.cu's kernel 0): output rows and columns per block, k
// per stage, threads.
constexpr int kSgRows = 128;
constexpr int kSgCols = 128;
constexpr int kSgK = 16;
constexpr int kSgThreads = 256;

// Per seed (blockIdx.z): C[M, N] = A[M, K] @ W[K, N] + bias[N],
// all row-major f32, K and N multiples of 4. Block (blockIdx.x, blockIdx.y)
// makes the rows and columns [128 x, +128) x [128 y, +128); thread (ty, tx)
// of 16 x 16 the rows 4 ty + {0..3, 64..67} and the columns 4 tx + {0..3,
// 64..67}, each an FMA sum over k from zero, then + bias. A's stage is
// stored transposed (As[k][row]), so both operands are read as float4.
__global__ void __launch_bounds__(kSgThreads, 2)
fwd_sgemm_kernel(const float* __restrict__ A, const float* __restrict__ W,
                 const float* __restrict__ bias, float* __restrict__ Cout,
                 int M, int N, int K, long long sA, long long sW,
                 long long sBias, long long sC) {
  __shared__ __align__(16) float As[2][kSgK][kSgRows];
  __shared__ __align__(16) float Ws[2][kSgK][kSgCols];
  {
    const size_t seed = blockIdx.z;
    A += seed * sA;
    W += seed * sW;
    bias += seed * sBias;
    Cout += seed * sC;
  }
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * kSgRows;
  const int n0 = blockIdx.y * kSgCols;
  // A stage: 128 rows x 16 k, 4 float4 a row; a W stage: 16 k x 128
  // columns, 32 float4 a row: two float4 of each per thread.
  float4 ra[2], rw[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = tid + r * kSgThreads;
      const int row = m0 + (i & 127), k = k0 + 4 * (i >> 7);
      ra[r] = row < M && k < K
                  ? *reinterpret_cast<const float4*>(A + (size_t)row * K + k)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int kw = k0 + (i >> 5), col = n0 + 4 * (i & 31);
      rw[r] = kw < K && col < N
                  ? *reinterpret_cast<const float4*>(W + (size_t)kw * N + col)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = tid + r * kSgThreads;
      const int row = i & 127, k = 4 * (i >> 7);
      As[buf][k][row] = ra[r].x;
      As[buf][k + 1][row] = ra[r].y;
      As[buf][k + 2][row] = ra[r].z;
      As[buf][k + 3][row] = ra[r].w;
      *reinterpret_cast<float4*>(&Ws[buf][i >> 5][4 * (i & 31)]) = rw[r];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  load(0);
  store(0);
  __syncthreads();
  const int nk = (K + kSgK - 1) / kSgK;
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * kSgK);
#pragma unroll
    for (int k = 0; k < kSgK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][4 * ty + 64]);
      const float4 w0 = *reinterpret_cast<const float4*>(&Ws[buf][k][4 * tx]);
      const float4 w1 =
          *reinterpret_cast<const float4*>(&Ws[buf][k][4 * tx + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    // Every thread read buffer buf ^ 1 before the last barrier.
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + 4 * ty + (i & 3) + 64 * (i >> 2);
    if (row >= M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int col = n0 + 4 * tx + 64 * jh;
      if (col >= N) continue;
      const float4 bv = *reinterpret_cast<const float4*>(bias + col);
      *reinterpret_cast<float4*>(Cout + (size_t)row * N + col) =
          make_float4(acc[i][4 * jh] + bv.x, acc[i][4 * jh + 1] + bv.y,
                      acc[i][4 * jh + 2] + bv.z, acc[i][4 * jh + 3] + bv.w);
    }
  }
}

cudaError_t launch_sgemm(const float* A, const float* W, const float* bias,
                         float* Cout, int M, int N, int K, int seeds,
                         long long sA, long long sW, long long sBias,
                         long long sC, cudaStream_t stream) {
  fwd_sgemm_kernel<<<dim3((M + kSgRows - 1) / kSgRows,
                          (N + kSgCols - 1) / kSgCols, seeds),
                     kSgThreads, 0, stream>>>(A, W, bias, Cout, M, N, K, sA,
                                              sW, sBias, sC);
  return cudaGetLastError();
}

// The weight-gradient kernel's shared memory: two stages of the A tile
// [kWgRows][min(H, 128) + 8] and the D tile [kWgRows][kWgCols + 8], f32.
inline size_t wgrad_smem_bytes(int H) {
  const size_t KW = H < kWgOut ? H : kWgOut;
  return 4 * 2 * ((size_t)kWgRows * (KW + 8) + (size_t)kWgRows * (kWgCols + 8));
}

// The cell's backward at one (row, unit), in registers, from its gate
// pre-activations a: LSTM x + h of i, f (without the forget bias), g, o;
// GRU x + h of z and r, then n's x side and its h side. dup: the upstream
// dh_t; kp 1 on a valid step, else 0; c_t, c_prev (LSTM) and h_prev (GRU)
// the saved states. Out: dg the G gate gradients (d_xw; the GRU's dg[3]
// = dn r, the h side of n's), and the carries dhc (and dcc) updated but
// for the carry's product. csrc/rnn_bwd.cu's formulas and rounding points
// (shared by the float32 backwards' recurrences).
template <int CELL>
__device__ __forceinline__ void cell_bwd(const float (&a)[4], float dup,
                                         float kp, float c_t, float c_prev,
                                         float h_prev, float forget_bias,
                                         float& dhc, float& dcc,
                                         float (&dg)[4]) {
  const float dh_t = dup + dhc;
  const float dh_new = kp * dh_t;
  if (CELL == kLstm) {
    const float ig = sigmoid(a[0]);
    const float fg = sigmoid(a[1] + forget_bias);
    const float gg = tanhf(a[2]);
    const float og = sigmoid(a[3]);
    const float dc_t = dcc;
    const float dc_new = kp * dc_t;
    const float tc = tanhf(c_t);
    const float do_ = dh_new * tc;
    const float dc_tot = dc_new + dh_new * og * (1.0f - tc * tc);
    dg[0] = (dc_tot * gg) * ig * (1.0f - ig);
    dg[1] = (dc_tot * c_prev) * fg * (1.0f - fg);
    dg[2] = (dc_tot * ig) * (1.0f - gg * gg);
    dg[3] = do_ * og * (1.0f - og);
    dhc = (1.0f - kp) * dh_t;
    dcc = (1.0f - kp) * dc_t + dc_tot * fg;
  } else {
    const float z = sigmoid(a[0]);
    const float rg = sigmoid(a[1]);
    const float hn = a[3];
    const float n = tanhf(a[2] + rg * hn);
    const float dz = dh_new * (h_prev - n);
    const float dn_raw = dh_new * (1.0f - z) * (1.0f - n * n);
    const float dr = dn_raw * hn;
    dg[0] = dz * z * (1.0f - z);
    dg[1] = dr * rg * (1.0f - rg);
    dg[2] = dn_raw;
    dg[3] = dn_raw * rg;
    dhc = (1.0f - kp) * dh_t + dh_new * z;
  }
}

// The weight gradients (rnn_bwd_tf32.cu's kernel 2): per seed (blockIdx.z)
// and row slice s, partial[seed][s] = [dW_x [H, G H], db [G H], dW_h [H, G
// H]] (fused) or dW_h alone (hoisted) over the rows m_lo .. m_hi - 1 of the
// seed's B T. A block computes one product (fused: blockIdx.x % 2 = 0 dW_x
// and db, 1 dW_h; hoisted: dW_h) for the 64 gate columns of column tile ct
// and the 128 output rows of row tile ot (blockIdx.x / 2, hoisted
// blockIdx.x, = ct + ot * column tiles), each of its 8 warps 16 output rows
// (warps past H idle). Its A operand is hin [M, H] (seed
// stride s_hin) or h_all [M, H] read shifted (row m takes m - 1 within its
// sequence of Tn rows, zero at the first step); its D operand d_xw = dgx
// [M, G H] or d_hw (the GRU's n slice from dhn [M, H], dn r; the LSTM's
// d_hw is d_xw). Per stage of kWgRows rows both arrive by cp.async in f32
// and are split at fragment load. (Splitting d_gates once into hi and lo
// planes instead measured slower: its fragments double the shared-memory
// traffic per mma.)
template <int CELL, bool FUSED>
__global__ void __launch_bounds__(kWgThreads, 2)
rnn_bwd_tf32_wgrad_kernel(const float* __restrict__ hin,
                          const float* __restrict__ h_all,
                          const float* __restrict__ dgx,
                          const float* __restrict__ dhn, int M, int Tn, int H,
                          int rows_per_slice, long long s_hin,
                          float* __restrict__ partial) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int LDD = kWgCols + 8;
  const int GH = G * H;
  const int KW = min(H, kWgOut);  // A columns staged: the block's rows
  const int LA = KW + 8;
  const int a_elems = kWgRows * LA;
  const int stage_elems = a_elems + kWgRows * LDD;
  const size_t hg = (size_t)H * GH;
  const size_t total = FUSED ? 2 * hg + GH : hg;

  extern __shared__ __align__(16) float smem[];

  {
    const size_t seed = blockIdx.z;
    if (FUSED) hin += seed * s_hin;
    h_all += seed * M * (size_t)H;
    dgx += seed * M * (size_t)GH;
    if (dhn != nullptr) dhn += seed * M * (size_t)H;
    partial += (seed * gridDim.y) * total;
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  // 0: dW_x and db (hin, d_xw); 1: dW_h (h_{t-1}, d_hw).
  const int prod = FUSED ? blockIdx.x & 1 : 1;
  const int tile = FUSED ? blockIdx.x >> 1 : blockIdx.x;
  const int nct = (GH + kWgCols - 1) / kWgCols;
  const int j0 = (tile % nct) * kWgCols;
  const int k0 = (tile / nct) * kWgOut;  // the block's first output row
  const int s = blockIdx.y;
  const int m_lo = min(M, s * rows_per_slice);
  const int m_hi = min(M, m_lo + rows_per_slice);
  const int ko = warp * 16;  // the warp's first output row in the block
  const bool active = k0 + ko < H;
  const bool with_db = prod == 0 && k0 == 0;

  auto load_stage = [&](int mb, float* dst) {
    const int CA = KW / 4;
    for (int i = tid; i < kWgRows * CA; i += kWgThreads) {
      const int mm = i / CA;
      const int k = (i - mm * CA) * 4;
      const int mrow = mb + mm;
      bool ok = mrow < m_hi && k0 + k < H;
      const float* src = h_all;
      if (prod == 0) {
        if (ok) src = hin + (size_t)mrow * H + k0 + k;
      } else {
        ok = ok && mrow % Tn != 0;
        if (ok) src = h_all + (size_t)(mrow - 1) * H + k0 + k;
      }
      cp_async16(dst + mm * LA + k, src, ok ? 16 : 0);
    }
    constexpr int CD = kWgCols / 4;
    for (int i = tid; i < kWgRows * CD; i += kWgThreads) {
      const int mm = i / CD;
      const int jc = (i - mm * CD) * 4;
      const int j = j0 + jc;
      const int mrow = mb + mm;
      const bool ok = mrow < m_hi && j < GH;
      const bool nside = CELL == kGru && prod == 1 && j >= 2 * H;
      const float* src =
          !ok ? dgx
              : nside ? dhn + (size_t)mrow * H + j - 2 * H
                      : dgx + (size_t)mrow * GH + j;
      cp_async16(dst + a_elems + mm * LDD + jc, src, ok ? 16 : 0);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
  float dbs = 0.0f;  // column tid % 64, rows tid / 64 + 4 i of each stage

  if (m_lo < m_hi) load_stage(m_lo, smem);
  cp_async_commit();
  int it = 0;
  for (int mb = m_lo; mb < m_hi; mb += kWgRows, ++it) {
    const float* cur = smem + (it & 1) * stage_elems;
    float* nxt = smem + ((it & 1) ^ 1) * stage_elems;
    cp_async_wait_all();
    __syncthreads();  // this stage is in place; the other one is free
    if (mb + kWgRows < m_hi) load_stage(mb + kWgRows, nxt);
    cp_async_commit();
    if (with_db)
      for (int rr = tid / kWgCols; rr < kWgRows; rr += kWgThreads / kWgCols)
        dbs += cur[a_elems + rr * LDD + tid % kWgCols];
    if (active) {
      const float* A = cur + ko + g;
      const float* D = cur + a_elems + g;
      // The stage's sums in a fresh accumulator, added to acc in f32 (the
      // tensor cores' accumulation truncates: chains stay 12 mma long).
      float sacc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sacc[nt][i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kWgRows; kk += 8) {
        const float* p = A + (kk + c4) * LA;
        FragA a;
        frag_a(a, p[0], p[8], p[4 * LA], p[4 * LA + 8]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* q = D + (kk + c4) * LDD + nt * 8;
          FragB b;
          frag_b(b, q[0], q[4 * LDD]);
          mma3(sacc[nt], a, b);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] += sacc[nt][i];
    }
  }

  float* out = partial + (size_t)s * total;
  if (active) {
    float* o = out + (prod == 1 && FUSED ? hg + GH : 0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = k0 + ko + g + 8 * half;
        const int jj = j0 + nt * 8 + 2 * c4;
        if (jj < GH)
          *reinterpret_cast<float2*>(o + (size_t)k * GH + jj) =
              make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
      }
  }
  if (!with_db) return;
  // db: the 4 row classes' sums added in a fixed order.
  cp_async_wait_all();
  __syncthreads();
  smem[tid] = dbs;
  __syncthreads();
  if (tid < kWgCols && j0 + tid < GH) {
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < kWgThreads / kWgCols; ++q) sum += smem[q * kWgCols + tid];
    out[hg + j0 + tid] = sum;
  }
}

// Their slices' sum (rnn_bwd_tf32.cu's kernel 3), per seed (blockIdx.y):
// out[seed][i] = sum_{s = 0 .. S-1} partial[seed][s][i], in that order.
__global__ void rnn_bwd_tf32_slices_kernel(const float* __restrict__ partial,
                                           int S, int count,
                                           float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const size_t seed = blockIdx.y;
  partial += seed * S * (size_t)count;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += partial[(size_t)s * count + i];
  out[seed * count + i] = acc;
}

}  // namespace
}  // namespace lfm_tf32
