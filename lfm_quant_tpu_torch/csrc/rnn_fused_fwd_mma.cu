// Masked LSTM/GRU recurrence, fused forward, in bfloat16 on Hopper's tensor
// cores (mma.sync m16n8k16, f32 accumulation), for sm_90a.
//
// Replaces the Pallas TPU kernels _lstm_fused_fwd_kernel
// (lfm_quant_tpu/ops/pallas_rnn.py:626) and _gru_fused_fwd_kernel (:652),
// reached through _fused_fwd_call (:793). For every step t:
//
//   gates = hin_t @ W_x + b + bf16(h_{t-1}) @ W_h     (f32 accumulation)
//   LSTM: i, f, g, o = sig(gi), sig(gf + forget_bias), tanh(gg), sig(go)
//         c = f * c + i * g;  h = o * tanh(c)
//   GRU:  z = sig(xz + hz);  r = sig(xr + hr);  n = tanh(xn + r * hn)
//         h = (1 - z) * n + z * h                 (reset after projection)
//
// and on a masked step h (and c) are held. h and c are carried in f32, h is
// rounded to bf16 before the recurrent product and h_t (and c_t when asked)
// are stored in bf16: the TPU kernels' rounding points. Only the order of
// the f32 sums differs from csrc/rnn_fused_fwd.cu.
//
// Route (ops/rnn.py _mma_route): bfloat16 with H % 16 == 0 and
// 16 <= H <= 128, so that W_h (G * H * H bf16, 128 KB for the LSTM at
// H = 128) fits in shared memory. float32, any other H and the hoisted
// form stay on the CUDA-core kernel in csrc/rnn_fused_fwd.cu.
//
// Bound. At the c2 serving dispatch (B = 16384, T = 60, H = 128, LSTM) the
// work is 2 * B * T * H * 2 * 4H = 2.58e11 operations against 0.25 GB of
// hin in and h out: bound by operations, 0.26 ms at 989 TFLOP/s.
//
// Design:
//
// * One block owns 16 * RT batch rows for all T steps; warp w owns all of
//   them and the UW hidden units u0 = w * UW .. u0 + UW - 1, with all G
//   gates of those units: its n8 tiles of gate q sit at columns
//   q * H + u0 + 8j. So the gate sums of one (row, unit) land in the same
//   thread's accumulators (the GRU keeps the x and h sums of n apart and
//   sums z and r together: four sums, as the LSTM's four gates), the cell
//   math runs in registers, and there is one barrier per step. UW is 8
//   (kUnits, so H / 8 warps); the rows per block (16, 32 or 64) are
//   picked per call from B by ops/rnn.py _mma_rows: 64 for the serving
//   dispatches, 16 for the c2 train step.
// * A fragments come by ldmatrix from [rows, H + 8] bf16 tiles of hin_t
//   and of bf16(h_{t-1}) in shared memory (the 16-byte row padding puts
//   the eight row addresses of each 8 x 8 matrix in distinct banks). Both
//   tiles are double-buffered: hin_{t+1} arrives by cp.async while step t
//   computes, and step t writes h_t into the other h tile, which the next
//   step copies to h_out with 16-byte stores.
// * B fragments: the wrapper permutes W_x and W_h into fragment order
//   ([k-step][warp][n8 tile][lane][4], ops/rnn.py _fragment_index), so a
//   lane's fragment of one tile is one 8-byte load and a warp's 32 loads
//   are 256 contiguous bytes. W_h is copied once into shared memory in
//   that order (conflict-free 8-byte reads); W_x does not fit beside it
//   and is read through L2 every step, once per block (128 KB per block
//   and step for the c2 LSTM). On an H100 that stream costs little: the
//   products and the cell's transcendentals (accurate expf and tanhf,
//   which keep the numerics of csrc/rnn_fused_fwd.cu) take most of a
//   step, one after the other (PERF.md, port PR 4).
// * h and c carries stay in f32 registers; the LSTM needs no f32 h carry
//   because it only ever reads bf16(h), which the h tile holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using namespace lfm_mma;

constexpr int kLstm = 0;
constexpr int kGru = 1;
// Hidden units per warp: H / 8 warps spread each step's products and cell
// math over the most threads (PERF.md, port PR 4).
constexpr int kUnits = 8;

// __frcp_rn is the correctly rounded reciprocal: the same value as
// 1.0f / x, without the division's slow path.
__device__ __forceinline__ float sigmoid(float v) {
  return __frcp_rn(1.0f + expf(-v));
}

// Shared memory: packed W_h [H * G * H] bf16, the hin and h tiles (two
// each, [rows, H + 8] bf16) and the bias [G * H] f32.
inline size_t smem_bytes(int gates, int H, int rows) {
  return (size_t)H * gates * H * 2 + 4 * (size_t)rows * (H + 8) * 2 +
         (size_t)gates * H * 4;
}

// hin [B, T, H]; wxp, whp: W_x, W_h packed in fragment order; b [G * H];
// m uint8 [B, T]; h_out, c_out [B, T, H] (c_out may be null). The block
// owns 16 * RT rows; blockDim.x = (H / kUnits) * 32.
template <int CELL, int RT>
__global__ void __launch_bounds__(128 * 32 / kUnits, 1)
rnn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ hin,
                   const uint2* __restrict__ wxp,
                   const __nv_bfloat16* __restrict__ b,
                   const uint2* __restrict__ whp,
                   const uint8_t* __restrict__ m,
                   __nv_bfloat16* __restrict__ h_out,
                   __nv_bfloat16* __restrict__ c_out, int B, int Tn, int H,
                   float forget_bias) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int BB = 16 * RT;  // rows per block
  constexpr int UW = kUnits;
  constexpr int NJ = UW / 8;   // n8 tiles per gate and warp
  constexpr int NT = G * NJ;   // n8 tiles per warp
  const int GH = G * H;
  const int KT = H / 16;       // k-steps
  const int S = H / UW;        // warps
  const int LD = H + 8;        // tile row stride, elements
  const int C8 = H / 8;        // 16-byte chunks per row

  extern __shared__ __align__(16) unsigned char smem[];
  uint2* wh_s = reinterpret_cast<uint2*>(smem);
  __nv_bfloat16* hin_s =
      reinterpret_cast<__nv_bfloat16*>(smem + (size_t)H * GH * 2);
  __nv_bfloat16* h_s = hin_s + 2 * BB * LD;
  float* bias_s = reinterpret_cast<float*>(h_s + 2 * BB * LD);

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * BB;
  const int nr = min(BB, B - r0);

  // Rows past B are zero-filled and never stored.
  auto load_hin = [&](int t, int buf) {
    __nv_bfloat16* dst = hin_s + buf * BB * LD;
    for (int i = tid; i < BB * C8; i += nth) {
      const int r = i / C8;
      const int k = (i - r * C8) * 8;
      const bool in = r < nr;
      const __nv_bfloat16* src =
          in ? hin + ((size_t)(r0 + r) * Tn + t) * H + k : hin;
      cp_async16(dst + r * LD + k, src, in ? 16 : 0);
    }
  };
  auto store_h = [&](int t, const __nv_bfloat16* tile) {
    for (int i = tid; i < nr * C8; i += nth) {
      const int r = i / C8;
      const int k = (i - r * C8) * 8;
      *reinterpret_cast<uint4*>(h_out + ((size_t)(r0 + r) * Tn + t) * H + k) =
          *reinterpret_cast<const uint4*>(tile + r * LD + k);
    }
  };

  {
    const int n16 = H * GH * 2 / 16;
    const char* src = reinterpret_cast<const char*>(whp);
    for (int i = tid; i < n16; i += nth)
      cp_async16(smem + 16 * (size_t)i, src + 16 * (size_t)i, 16);
  }
  load_hin(0, 0);
  cp_async_commit();
  for (int i = tid; i < GH; i += nth) bias_s[i] = __bfloat162float(b[i]);
  {
    uint32_t* z = reinterpret_cast<uint32_t*>(h_s);
    for (int i = tid; i < BB * LD; i += nth) z[i] = 0u;  // both h tiles
  }

  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix address
  const int acol = (lane >> 4) * 8;
  const int row_l = lane >> 2;       // + 16 rt + 8 half
  const int unit_l = 2 * (lane & 3);  // + u0 + 8 j + e
  const int u0 = warp * UW;
  const uint2* wx_w = wxp + (size_t)warp * NT * 32 + lane;
  const uint2* wh_w = wh_s + warp * NT * 32 + lane;

  // f32 carry: c for the LSTM, h for the GRU. [rt][j][half * 2 + e]
  float carry[RT][NJ][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) carry[rt][j][i] = 0.0f;

  for (int t = 0; t < Tn; ++t) {
    const int cur = t & 1;
    cp_async_wait_all();
    __syncthreads();  // hin_t and h_{t-1} are in place; the other buffers free
    if (t + 1 < Tn) load_hin(t + 1, cur ^ 1);
    cp_async_commit();
    const __nv_bfloat16* xt = hin_s + cur * BB * LD;
    const __nv_bfloat16* ht = h_s + cur * BB * LD;
    if (t > 0) store_h(t - 1, ht);

    bool keep[RT][2];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + row_l + 8 * half;
        keep[rt][half] = r < nr && m[(size_t)(r0 + r) * Tn + t] != 0;
      }

    // Slots: the G x-side gates; the GRU's slot 3 is the h side of n.
    float acc[RT][4][NJ][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[rt][q][j][i] =
                q < G ? bias_s[q * H + u0 + 8 * j + unit_l + (i & 1)] : 0.0f;

    for (int kk = 0; kk < KT; ++kk) {
      const size_t koff = (size_t)kk * S * NT * 32;
      uint2 bx[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) bx[n] = __ldg(wx_w + koff + n * 32);
      {
        uint2 bh[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n) bh[n] = wh_w[koff + n * 32];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          uint32_t a[4];
          ldmatrix_x4(a, ht + (rt * 16 + arow) * LD + kk * 16 + acol);
#pragma unroll
          for (int q = 0; q < G; ++q)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              mma_bf16(acc[rt][CELL == kGru && q == 2 ? 3 : q][j], a,
                       bh[q * NJ + j]);
        }
      }
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        uint32_t a[4];
        ldmatrix_x4(a, xt + (rt * 16 + arow) * LD + kk * 16 + acol);
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mma_bf16(acc[rt][q][j], a, bx[q * NJ + j]);
      }
    }

    // The cell, in registers; h_t into the other h tile.
    __nv_bfloat16* hn = h_s + (cur ^ 1) * BB * LD;
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rt * 16 + row_l + 8 * half;
          const int u = u0 + 8 * j + unit_l;
          const bool k = keep[rt][half];
          float hv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = half * 2 + e;
            float& cr = carry[rt][j][i];
            if (CELL == kLstm) {
              const float ig = sigmoid(acc[rt][0][j][i]);
              const float fg = sigmoid(acc[rt][1][j][i] + forget_bias);
              const float gg = tanhf(acc[rt][2][j][i]);
              const float og = sigmoid(acc[rt][3][j][i]);
              const float c = fg * cr + ig * gg;
              const float h = og * tanhf(c);
              if (k) cr = c;
              // A held LSTM h is only ever read as bf16: the tile has it.
              hv[e] = k ? h : __bfloat162float(ht[r * LD + u + e]);
            } else {
              const float z = sigmoid(acc[rt][0][j][i]);
              const float rg = sigmoid(acc[rt][1][j][i]);
              const float n = tanhf(acc[rt][2][j][i] + rg * acc[rt][3][j][i]);
              const float h = (1.0f - z) * n + z * cr;
              if (k) cr = h;
              hv[e] = cr;
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(hn + r * LD + u) =
              __floats2bfloat162_rn(hv[0], hv[1]);
          if (CELL == kLstm && c_out != nullptr && r < nr) {
            *reinterpret_cast<__nv_bfloat162*>(
                c_out + ((size_t)(r0 + r) * Tn + t) * H + u) =
                __floats2bfloat162_rn(carry[rt][j][half * 2],
                                      carry[rt][j][half * 2 + 1]);
          }
        }
  }
  cp_async_wait_all();
  __syncthreads();
  store_h(Tn - 1, h_s + (Tn & 1) * BB * LD);
}

template <int CELL, int RT>
cudaError_t launch(const void* hin, const void* wxp, const void* b,
                   const void* whp, const void* m, void* h_out, void* c_out,
                   int B, int Tn, int H, float forget_bias,
                   cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int rows = 16 * RT;
  const size_t smem = smem_bytes(G, H, rows);
  auto kernel = rnn_fwd_mma_kernel<CELL, RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + rows - 1) / rows;
  kernel<<<blocks, (H / kUnits) * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(hin), static_cast<const uint2*>(wxp),
      static_cast<const __nv_bfloat16*>(b), static_cast<const uint2*>(whp),
      static_cast<const uint8_t*>(m), static_cast<__nv_bfloat16*>(h_out),
      CELL == kLstm ? static_cast<__nv_bfloat16*>(c_out) : nullptr, B, Tn, H,
      forget_bias);
  return cudaGetLastError();
}

template <int CELL>
cudaError_t launch_rows(int rows, const void* hin, const void* wxp,
                        const void* b, const void* whp, const void* m,
                        void* h_out, void* c_out, int B, int Tn, int H,
                        float fb, cudaStream_t s) {
  if (rows == 16)
    return launch<CELL, 1>(hin, wxp, b, whp, m, h_out, c_out, B, Tn, H, fb, s);
  if (rows == 32)
    return launch<CELL, 2>(hin, wxp, b, whp, m, h_out, c_out, B, Tn, H, fb, s);
  return launch<CELL, 4>(hin, wxp, b, whp, m, h_out, c_out, B, Tn, H, fb, s);
}

// The shapes the kernel takes: 16 <= H <= 128, H % 16 == 0, and 16, 32 or
// 64 rows per block.
bool supported(int H, int rows) {
  if (H < 16 || H > 128 || H % 16 != 0) return false;
  return rows == 16 || rows == 32 || rows == 64;
}

}  // namespace

// Shared memory one launch needs, in bytes; -1 for a shape the kernel does
// not take. cell: 0 = LSTM, 1 = GRU; rows: rows per block.
extern "C" long long lfm_rnn_fused_fwd_mma_smem(int cell, int H, int rows) {
  if (!supported(H, rows)) return -1;
  return (long long)smem_bytes(cell == kLstm ? 4 : 3, H, rows);
}

// The fused forward in bfloat16 on the tensor cores. hin [B, T, H], b
// [G * H], h_out and c_out [B, T, H] bf16; wxp and whp are W_x and W_h
// [H, G * H] permuted into fragment order (ops/rnn.py pack_fragments); m
// uint8 [B, T]; rows: rows per block (16, 32 or 64); c_out may be null.
// Returns cudaGetLastError().
extern "C" int lfm_rnn_fused_fwd_mma(int cell, const void* hin,
                                     const void* wxp, const void* b,
                                     const void* whp, const void* m,
                                     void* h_out, void* c_out, int B, int Tn,
                                     int H, int rows, float forget_bias,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Tn <= 0 || !supported(H, rows))
    return (int)cudaErrorInvalidValue;
  if (cell == kLstm)
    return (int)launch_rows<kLstm>(rows, hin, wxp, b, whp, m, h_out, c_out,
                                   B, Tn, H, forget_bias, s);
  if (cell == kGru)
    return (int)launch_rows<kGru>(rows, hin, wxp, b, whp, m, h_out, c_out,
                                  B, Tn, H, forget_bias, s);
  return (int)cudaErrorInvalidValue;
}
