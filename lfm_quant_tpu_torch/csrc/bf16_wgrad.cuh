// The bf16 backwards' weight gradients and dhin, shared by the cluster
// backward (csrc/rnn_bwd_cluster.cu, kernels 2-4) and the grid backward
// past it (csrc/rnn_bwd_grid.cu, kernels 3-5): GEMMs with nothing
// sequential in them, at the TPU kernels' rounding points (every product
// with d_gates split into a bf16 hi and lo, f32 accumulation, per-slice
// partial sums added in a fixed order, no atomics; dhin in bf16). They take
// any hidden width that is a multiple of 16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace lfm_bf16 {
namespace {

using namespace lfm_mma;

constexpr int kLstm = 0;
constexpr int kGru = 1;
// Terms of the split of d_gates in the backward products (hi, lo).
constexpr int kSplit = 2;
// The weight gradients: gate columns and output rows per block, B T rows per stage,
// threads.
constexpr int kWgCols = 64;
constexpr int kWgOut = 256;
constexpr int kWgRows = 32;
constexpr int kWgThreads = 256;
// dhin: output rows and columns per block, k per stage, threads.
constexpr int kDhRows = 128;
constexpr int kDhCols = 128;
constexpr int kDhK = 32;
constexpr int kDhThreads = 256;
constexpr int kDhLA = kDhK + 8;

inline size_t wgrad_smem_bytes() {
  return 2 * 2 *
         ((size_t)kWgRows * (kWgOut + 8) +
          (size_t)kSplit * kWgRows * (kWgCols + 8));
}

inline size_t dhin_smem_bytes() {
  return 2 * 2 * (size_t)(kSplit * kDhRows + kDhCols) * kDhLA;
}

// (v0, v1) = hi + lo: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split_bf16(float v0, float v1,
                                           __nv_bfloat162& hi,
                                           __nv_bfloat162& lo) {
  hi = __floats2bfloat162_rn(v0, v1);
  const float2 h = __bfloat1622float2(hi);
  lo = __floats2bfloat162_rn(v0 - h.x, v1 - h.y);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The weight gradients: per seed (blockIdx.z) and row slice s (blockIdx.y), one
// product's partial sums over the rows m_lo .. m_hi - 1 of the seed's B T,
// for the 64 gate columns and 256 output rows of this block (blockIdx.x =
// column tile + tiles (row tile + row tiles product)). Product 0: dW_x =
// hin^T d_xw and (row tile 0) db = sum d_xw; product 1: dW_h = h_{t-1}^T
// d_hw, A the saved h_all read shifted (zero at each sequence's first
// step). d_xw = dgx [M, G H] f32; d_hw: the LSTM's d_xw, the GRU's d_xw
// with the n slice from dhn [M, H] f32. partial[seed][s] = [dW_x [H, G H],
// db [G H], dW_h [H, G H]]. HOIST: product 1 alone, d_hw = dgx, and
// partial[seed][s] = dW_h [H, G H]. Each of the 8 warps sums 32 output
// rows by 64 columns.
template <int CELL, bool HOIST>
__global__ void __launch_bounds__(kWgThreads, 2)
rnn_bwd_cluster_wgrad_kernel(const __nv_bfloat16* __restrict__ hin,
                             const __nv_bfloat16* __restrict__ h_all,
                             const float* __restrict__ dgx,
                             const float* __restrict__ dhn, int M, int Tn,
                             int H, int rows_per_slice, long long s_hin,
                             float* __restrict__ partial) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int MT = 2;  // 16-row output tiles per warp
  constexpr int LA = kWgOut + 8;
  constexpr int LDD = kWgCols + 8;
  constexpr int kLoads = kWgRows * kWgCols / 4 / kWgThreads;  // float4 each
  constexpr int CA = kWgOut / 8;  // 16-byte chunks per A row
  const int GH = G * H;
  const int a_elems = kWgRows * LA;
  const int stage_elems = a_elems + kSplit * kWgRows * LDD;
  const size_t total = HOIST ? (size_t)H * GH : (size_t)(2 * H * GH + GH);
  const int nct = (GH + kWgCols - 1) / kWgCols;
  const int nrt = (H + kWgOut - 1) / kWgOut;
  const int ct = blockIdx.x % nct;
  const int ot = (blockIdx.x / nct) % nrt;
  const int prod = HOIST ? 1 : blockIdx.x / (nct * nrt);

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);

  {
    const size_t seed = blockIdx.z;
    if (hin != nullptr) hin += seed * s_hin;
    h_all += seed * M * (size_t)H;
    dgx += seed * M * (size_t)GH;
    if (dhn != nullptr) dhn += seed * M * (size_t)H;
    partial += (seed * gridDim.y) * total;
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = ct * kWgCols;
  const int k0 = ot * kWgOut;  // the block's first output row
  const int s = blockIdx.y;
  const int m_lo = min(M, s * rows_per_slice);
  const int m_hi = min(M, m_lo + rows_per_slice);
  const int ko = warp * 32;  // the warp's first output row in the block
  const bool active = k0 + ko < H;
  const bool with_db = !HOIST && prod == 0 && ot == 0;

  // The thread's 4 columns of d and its rows dr, dr + 16 of a stage.
  const int dc = (tid & 15) * 4;
  const int dr = tid >> 4;
  const int j = j0 + dc;
  const bool jin = j < GH;
  // d_hw's n slice of the fused GRU: dn r.
  const bool nside = CELL == kGru && !HOIST && prod == 1 && j >= 2 * H;

  auto load_a = [&](int mb, __nv_bfloat16* dst) {
    for (int i = tid; i < kWgRows * CA; i += kWgThreads) {
      const int mm = i / CA;
      const int k = (i - mm * CA) * 8;
      const int mrow = mb + mm;
      bool ok = mrow < m_hi && k0 + k < H;
      const __nv_bfloat16* src = h_all;
      if (prod == 0) {
        if (ok) src = hin + (size_t)mrow * H + k0 + k;
      } else {
        ok = ok && mrow % Tn != 0;
        if (ok) src = h_all + (size_t)(mrow - 1) * H + k0 + k;
      }
      cp_async16(dst + mm * LA + k, src, ok ? 16 : 0);
    }
  };

  float4 dv[kLoads];
  auto fetch_d = [&](int mb) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int mrow = mb + dr + 16 * q;
      const bool ok = jin && mrow < m_hi;
      dv[q] = !ok ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
              : nside
                  ? *reinterpret_cast<const float4*>(dhn + (size_t)mrow * H +
                                                     j - 2 * H)
                  : *reinterpret_cast<const float4*>(dgx + (size_t)mrow * GH +
                                                     j);
    }
  };

  // db from the f32 values (fixed order: stage by stage, q by q), then
  // the split into the stage's D tiles.
  float dbs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto store_d = [&](__nv_bfloat16* stage) {
    __nv_bfloat16* dt = stage + a_elems;
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      if (with_db) {
        dbs[0] += dv[q].x;
        dbs[1] += dv[q].y;
        dbs[2] += dv[q].z;
        dbs[3] += dv[q].w;
      }
      const int off = (dr + 16 * q) * LDD + dc;
      __nv_bfloat162 h01, l01, h23, l23;
      split_bf16(dv[q].x, dv[q].y, h01, l01);
      split_bf16(dv[q].z, dv[q].w, h23, l23);
      *reinterpret_cast<uint2*>(dt + off) =
          make_uint2(as_u32(h01), as_u32(h23));
      *reinterpret_cast<uint2*>(dt + kWgRows * LDD + off) =
          make_uint2(as_u32(l01), as_u32(l23));
    }
  };

  // ldmatrix.trans addresses: A^T fragments (output rows x stage rows)
  // and D fragments (stage rows x two n8 column tiles).
  const int ta_row = (lane & 7) + (lane >> 4) * 8;
  const int ta_col = ((lane >> 3) & 1) * 8;
  const int tb_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int tb_col = (lane >> 4) * 8;

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  if (m_lo < m_hi) {
    load_a(m_lo, stages);
    cp_async_commit();
    fetch_d(m_lo);
    store_d(stages);
  }
  int it = 0;
  for (int mb = m_lo; mb < m_hi; mb += kWgRows, ++it) {
    __nv_bfloat16* cur = stages + (it & 1) * stage_elems;
    __nv_bfloat16* nxt = stages + ((it & 1) ^ 1) * stage_elems;
    cp_async_wait_all();
    __syncthreads();  // this stage is in place; the other one is free
    const bool more = mb + kWgRows < m_hi;
    if (more) {
      load_a(mb + kWgRows, nxt);
      fetch_d(mb + kWgRows);
    }
    cp_async_commit();
    if (active) {
      const __nv_bfloat16* A = cur + ko;
      const __nv_bfloat16* D = cur + a_elems;
#pragma unroll
      for (int kk = 0; kk < kWgRows / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4_trans(a[mt], A + (kk * 16 + ta_row) * LA + mt * 16 +
                                       ta_col);
#pragma unroll
        for (int p = 0; p < kSplit; ++p)
#pragma unroll
          for (int n2 = 0; n2 < 4; ++n2) {
            uint32_t bq[4];
            ldmatrix_x4_trans(bq, D + p * kWgRows * LDD +
                                      (kk * 16 + tb_row) * LDD + n2 * 16 +
                                      tb_col);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[mt][2 * n2], a[mt], make_uint2(bq[0], bq[1]));
              mma_bf16(acc[mt][2 * n2 + 1], a[mt], make_uint2(bq[2], bq[3]));
            }
          }
      }
    }
    if (more) store_d(nxt);
  }

  const size_t hg = (size_t)H * GH;
  float* out = partial + (size_t)s * total;
  if (active) {
    float* o = out + (prod == 0 || HOIST ? 0 : hg + GH);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = k0 + ko + mt * 16 + (lane >> 2) + 8 * half;
          const int jj = j0 + nt * 8 + 2 * (lane & 3);
          if (k < H && jj < GH)
            *reinterpret_cast<float2*>(o + (size_t)k * GH + jj) = make_float2(
                acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
  }
  if (!with_db) return;
  // db: the 16 row classes' sums added in a fixed order.
  cp_async_wait_all();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [16][kWgCols]
#pragma unroll
  for (int c = 0; c < 4; ++c) red[dr * kWgCols + dc + c] = dbs[c];
  __syncthreads();
  if (tid < kWgCols && j0 + tid < GH) {
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < 16; ++q) sum += red[q * kWgCols + tid];
    out[hg + j0 + tid] = sum;
  }
}

// Their slices' sum, per seed (blockIdx.y): out[seed][i] = sum_{s = 0 .. S-1}
// partial[seed][s][i], in that order.
__global__ void rnn_bwd_cluster_slices_kernel(const float* __restrict__ partial,
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

// dhin, per seed (blockIdx.z): out[M, N] = bf16(D[M, K] @ Wx[N, K]^T),
// D f32 (d_xw, split into hi and lo as it is staged), Wx bf16 row-major
// (W_x [H, G H]: N = H, K = G H), both multiples of 16. Block (blockIdx.x,
// blockIdx.y) makes rows [128 x, +128) and columns [128 y, +128); warp w
// rows 64 (w % 2) + [0, 64) and columns 32 (w / 2) + [0, 32). Two stages:
// W_x by cp.async, D through registers one stage ahead.
__global__ void __launch_bounds__(kDhThreads, 2)
dhin_gemm_kernel(const float* __restrict__ D,
                 const __nv_bfloat16* __restrict__ Wx,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K,
                 long long sW) {
  constexpr int kStage = (kSplit * kDhRows + kDhCols) * kDhLA;
  constexpr int kLoads = kDhRows * kDhK / 4 / kDhThreads;  // float4 each
  extern __shared__ __align__(16) unsigned char dsm[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(dsm);
  {
    const size_t seed = blockIdx.z;
    D += seed * (size_t)M * K;
    Wx += seed * sW;
    out += seed * (size_t)M * N;
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * kDhRows;
  const int n0 = blockIdx.y * kDhCols;
  const int wm = (warp & 1) * 64;
  const int wn = (warp >> 1) * 32;
  const int nk = (K + kDhK - 1) / kDhK;

  float4 dv[kLoads];
  auto fetch_a = [&](int kt) {
    const int k0 = kt * kDhK;
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = tid + q * kDhThreads;
      const int r = i / (kDhK / 4);
      const int kc = (i - r * (kDhK / 4)) * 4;
      const bool ok = m0 + r < M && k0 + kc < K;
      dv[q] = ok ? *reinterpret_cast<const float4*>(D + (size_t)(m0 + r) * K +
                                                    k0 + kc)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto store_a = [&](__nv_bfloat16* st) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = tid + q * kDhThreads;
      const int r = i / (kDhK / 4);
      const int kc = (i - r * (kDhK / 4)) * 4;
      __nv_bfloat162 h01, l01, h23, l23;
      split_bf16(dv[q].x, dv[q].y, h01, l01);
      split_bf16(dv[q].z, dv[q].w, h23, l23);
      *reinterpret_cast<uint2*>(st + r * kDhLA + kc) =
          make_uint2(as_u32(h01), as_u32(h23));
      *reinterpret_cast<uint2*>(st + (kDhRows + r) * kDhLA + kc) =
          make_uint2(as_u32(l01), as_u32(l23));
    }
  };
  auto load_b = [&](int kt, __nv_bfloat16* st) {
    __nv_bfloat16* bs = st + kSplit * kDhRows * kDhLA;
    const int k0 = kt * kDhK;
    for (int i = tid; i < kDhCols * (kDhK / 8); i += kDhThreads) {
      const int n = i / (kDhK / 8);
      const int kc = (i - n * (kDhK / 8)) * 8;
      const bool ok = n0 + n < N && k0 + kc < K;
      cp_async16(bs + n * kDhLA + kc,
                 ok ? Wx + (size_t)(n0 + n) * K + k0 + kc : Wx, ok ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  // ldmatrix row addresses: A rows 0-7 / 8-15 at k 0 / 8; W_x rows (the
  // output columns) 0-7 at k 0 / 8, then rows 8-15.
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8;
  const int bcol = ((lane >> 3) & 1) * 8;

  load_b(0, smem);
  cp_async_commit();
  fetch_a(0);
  store_a(smem);
  for (int kt = 0; kt < nk; ++kt) {
    __nv_bfloat16* cur = smem + (kt & 1) * kStage;
    __nv_bfloat16* nxt = smem + ((kt & 1) ^ 1) * kStage;
    cp_async_wait_all();
    __syncthreads();  // stage kt is in place; the other stage is free
    const bool more = kt + 1 < nk;
    if (more) {
      load_b(kt + 1, nxt);
      fetch_a(kt + 1);
    }
    cp_async_commit();
    const __nv_bfloat16* bs = cur + kSplit * kDhRows * kDhLA;
#pragma unroll
    for (int kk = 0; kk < kDhK; kk += 16) {
      uint2 bw[4];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + (wn + np * 16 + brow) * kDhLA + kk + bcol);
        bw[2 * np] = make_uint2(r[0], r[1]);
        bw[2 * np + 1] = make_uint2(r[2], r[3]);
      }
#pragma unroll
      for (int p = 0; p < kSplit; ++p)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, cur + (p * kDhRows + wm + mt * 16 + lrow) * kDhLA +
                             kk + lcol);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, bw[nt]);
        }
    }
    if (more) store_a(nxt);
  }
  cp_async_wait_all();

  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn + nt * 8 + c2;
    if (col >= N) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mt * 16 + g + 8 * half;
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(acc[mt][nt][2 * half],
                                    acc[mt][nt][2 * half + 1]);
      }
  }
}

// The weight gradients and their slices' sum into dw.
template <int CELL, bool HOIST>
cudaError_t launch_wgrad(const void* hin, const void* h_all, const float* dgx,
                         const float* dhn, float* partial, int slices,
                         float* dw, int S, int B, int Tn, int H,
                         long long s_hin, cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  const int GH = G * H;
  const int M = B * Tn;
  const size_t smem = wgrad_smem_bytes();
  auto wgrad = rnn_bwd_cluster_wgrad_kernel<CELL, HOIST>;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = ((GH + kWgCols - 1) / kWgCols) *
                     ((H + kWgOut - 1) / kWgOut) * (HOIST ? 1 : 2);
  wgrad<<<dim3(blocks, slices, S), kWgThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(hin),
      static_cast<const __nv_bfloat16*>(h_all), dgx, dhn, M, Tn, H,
      (M + slices - 1) / slices, s_hin, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = HOIST ? H * GH : 2 * H * GH + GH;
  rnn_bwd_cluster_slices_kernel<<<dim3((total + 255) / 256, S), 256, 0,
                                  stream>>>(partial, slices, total, dw);
  return cudaGetLastError();
}

cudaError_t launch_dhin(const float* dgx, const void* wx, void* dhin, int S,
                        int M, int H, int GH, long long s_wx,
                        cudaStream_t stream) {
  const size_t smem = dhin_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      dhin_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dhin_gemm_kernel<<<dim3((M + kDhRows - 1) / kDhRows,
                          (H + kDhCols - 1) / kDhCols, S),
                     kDhThreads, smem, stream>>>(
      dgx, static_cast<const __nv_bfloat16*>(wx),
      static_cast<__nv_bfloat16*>(dhin), M, H, GH, s_wx);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lfm_bf16
