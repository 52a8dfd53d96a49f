// Masked LSTM/GRU recurrence, forward, for sm_90a: the fused form (the gate
// input projection computed in the kernel) and the hoisted form (the
// projection given as an input).
//
// Replaces the Pallas TPU kernels _lstm_fused_fwd_kernel and
// _gru_fused_fwd_kernel, reached through _fused_fwd_call, and (hoisted form)
// _lstm_fwd_kernel and _gru_fwd_kernel, reached through _fwd_call, all in
// lfm_quant_tpu/ops/pallas_rnn.py. For every step t:
//
//   gates = xw_t + h_{t-1} @ W_h                     (f32 accumulation)
//           xw_t = hin_t @ W_x + b  (fused)  or  read from xw (hoisted)
//   LSTM: i, f, g, o = sig(gi), sig(gf + forget_bias), tanh(gg), sig(go)
//         c = f * c + i * g;  h = o * tanh(c)
//   GRU:  z = sig(xz + hz);  r = sig(xr + hr);  n = tanh(xn + r * hn)
//         h = (1 - z) * n + z * h                 (reset after projection)
//
// and on a masked step h (and c) are held. h and c are carried in f32; h
// is rounded to the weights' type before the recurrent product, and the
// stored h_t (and c_t) are in the input's type, at the same points as the
// TPU kernels.
//
// Bound. At the c2 serving dispatch (B = 32768, T = 60, H = 128, bf16)
// the fused work is 2 * B * T * H * 2 * G * H operations (G = 4 for the
// LSTM: 5.15e11) against about 1 GB of hin in and h out, so the kernel is
// bound by operations: 0.52 ms on the tensor cores at 989 TFLOP/s. The
// hoisted form does half the operations but streams the G-times wider xw,
// so at the c2 train shape it is bound by bytes. This first kernel does
// not reach either bound: it runs the products on the CUDA cores in f32.
// Its design:
//
// * One thread block owns BB batch rows for all T steps; h and c stay in
//   shared memory between steps and never go back to device memory.
// * Each thread owns gate columns j: per step it reads column j of W_x and
//   W_h once (through L1/L2; W_x and W_h together are 256 KB in bf16, more
//   than a block's 227 KB of shared memory, so neither is staged) and uses
//   each weight for all BB rows, so the weights' L2 traffic is divided by
//   BB. The rows' inputs sit in shared memory and are read as broadcasts,
//   four values of k per load.
// * A second phase applies the gate math elementwise over [BB, H]; the
//   hoisted form reads xw_t there, straight from device memory.
//
// Making it fast (wgmma on the tensor cores, W_h resident in shared memory
// or split across a cluster) is later work; see PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;        // batch rows per block (BB)
constexpr int kMaxThreads = 512;
constexpr int kLstm = 0;
constexpr int kGru = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Shared memory (floats): hq_s, h_s, c_s [kRows, H] and the h-side gate
// sums hs_s [kRows, G*H]; the fused form adds hin_s [kRows, H] and the
// x-side gate sums xs_s [kRows, G*H].
inline size_t smem_bytes(int gates, int H, bool hoist) {
  return sizeof(float) * (size_t)kRows * H *
         (hoist ? 3 + gates : 4 + 2 * gates);
}

// xin: hin [B, T, H] (fused) or xw [B, T, G*H] (hoisted). wx and b are
// read only by the fused form.
template <int CELL, bool HOIST, typename T>
__global__ void __launch_bounds__(kMaxThreads)
rnn_fwd_kernel(const T* __restrict__ xin, const T* __restrict__ wx,
               const T* __restrict__ b, const T* __restrict__ wh,
               const uint8_t* __restrict__ m, T* __restrict__ h_out,
               T* __restrict__ c_out, int B, int Tn, int H,
               float forget_bias) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  const int GH = G * H;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* hq_s = smem;              // h rounded to the weights' type
  float* h_s = hq_s + kRows * H;   // f32 carry
  float* c_s = h_s + kRows * H;    // f32 carry (LSTM)
  float* hs_s = c_s + kRows * H;   // h @ W_h
  float* hin_s = hs_s + kRows * GH;  // fused: this step's inputs
  float* xs_s = hin_s + kRows * H;   // fused: hin @ W_x + b
  __shared__ uint8_t keep_s[kRows];

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, B - r0);

  for (int i = tid; i < kRows * H; i += nth) {
    hq_s[i] = 0.0f;
    h_s[i] = 0.0f;
    c_s[i] = 0.0f;
  }

  for (int t = 0; t < Tn; ++t) {
    if (!HOIST) {
      for (int i = tid; i < kRows * H; i += nth) {
        const int r = i / H;
        const int k = i - r * H;
        hin_s[i] = r < nr ? to_f(xin[((size_t)(r0 + r) * Tn + t) * H + k])
                          : 0.0f;
      }
    }
    if (tid < kRows) {
      keep_s[tid] = tid < nr ? m[(size_t)(r0 + tid) * Tn + t] : 0;
    }
    __syncthreads();

    for (int j = tid; j < GH; j += nth) {
      float ax[kRows], ah[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        ax[r] = 0.0f;
        ah[r] = 0.0f;
      }
      int k = 0;
      if ((H & 3) == 0) {
        for (; k < H; k += 4) {
          float wxv[4], whv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            wxv[q] = HOIST ? 0.0f : to_f(wx[(size_t)(k + q) * GH + j]);
            whv[q] = to_f(wh[(size_t)(k + q) * GH + j]);
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 q = *reinterpret_cast<const float4*>(
                hq_s + r * H + k);
            ah[r] = fmaf(q.x, whv[0], ah[r]);
            ah[r] = fmaf(q.y, whv[1], ah[r]);
            ah[r] = fmaf(q.z, whv[2], ah[r]);
            ah[r] = fmaf(q.w, whv[3], ah[r]);
            if (!HOIST) {
              const float4 a = *reinterpret_cast<const float4*>(
                  hin_s + r * H + k);
              ax[r] = fmaf(a.x, wxv[0], ax[r]);
              ax[r] = fmaf(a.y, wxv[1], ax[r]);
              ax[r] = fmaf(a.z, wxv[2], ax[r]);
              ax[r] = fmaf(a.w, wxv[3], ax[r]);
            }
          }
        }
      }
      for (; k < H; ++k) {  // H not a multiple of 4
        const float wxv = HOIST ? 0.0f : to_f(wx[(size_t)k * GH + j]);
        const float whv = to_f(wh[(size_t)k * GH + j]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          ah[r] = fmaf(hq_s[r * H + k], whv, ah[r]);
          if (!HOIST) ax[r] = fmaf(hin_s[r * H + k], wxv, ax[r]);
        }
      }
      const float bj = HOIST ? 0.0f : to_f(b[j]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        hs_s[r * GH + j] = ah[r];
        if (!HOIST) xs_s[r * GH + j] = ax[r] + bj;
      }
    }
    __syncthreads();

    for (int i = tid; i < nr * H; i += nth) {
      const int r = i / H;
      const int u = i - r * H;
      const size_t row_t = (size_t)(r0 + r) * Tn + t;
      // The x-side gate inputs of this row and step, gate q at q * H + u.
      const T* xw_row = HOIST ? xin + row_t * GH + u : xin;
      const float* xs = xs_s + r * GH + u;
      const float* hs = hs_s + r * GH + u;
      auto xv = [&](int q) {
        return HOIST ? to_f(xw_row[q * H]) : xs[q * H];
      };
      float h = h_s[i];
      if (keep_s[r]) {
        if (CELL == kLstm) {
          const float ig = sigmoid(xv(0) + hs[0]);
          const float fg = sigmoid((xv(1) + hs[H]) + forget_bias);
          const float gg = tanhf(xv(2) + hs[2 * H]);
          const float og = sigmoid(xv(3) + hs[3 * H]);
          const float c = fg * c_s[i] + ig * gg;
          h = og * tanhf(c);
          c_s[i] = c;
        } else {
          const float z = sigmoid(xv(0) + hs[0]);
          const float rg = sigmoid(xv(1) + hs[H]);
          const float n = tanhf(xv(2) + rg * hs[2 * H]);
          h = (1.0f - z) * n + z * h;
        }
        h_s[i] = h;
        hq_s[i] = to_f(from_f<T>(h));
      }
      const size_t o = row_t * H + u;
      h_out[o] = from_f<T>(h);
      if (CELL == kLstm && c_out != nullptr) c_out[o] = from_f<T>(c_s[i]);
    }
    __syncthreads();
  }
}

template <int CELL, bool HOIST, typename T>
cudaError_t launch(const void* xin, const void* wx, const void* b,
                   const void* wh, const void* m, void* h_out, void* c_out,
                   int B, int Tn, int H, float forget_bias,
                   cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  const size_t smem = smem_bytes(G, H, HOIST);
  auto kernel = rnn_fwd_kernel<CELL, HOIST, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int threads = ((G * H + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int blocks = (B + kRows - 1) / kRows;
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(xin), static_cast<const T*>(wx),
      static_cast<const T*>(b), static_cast<const T*>(wh),
      static_cast<const uint8_t*>(m), static_cast<T*>(h_out),
      CELL == kLstm ? static_cast<T*>(c_out) : nullptr, B, Tn, H,
      forget_bias);
  return cudaGetLastError();
}

template <bool HOIST>
int dispatch(int cell, int dtype, const void* xin, const void* wx,
             const void* b, const void* wh, const void* m, void* h_out,
             void* c_out, int B, int Tn, int H, float forget_bias,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Tn <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (cell == kLstm && dtype == 0)
    return (int)launch<kLstm, HOIST, float>(xin, wx, b, wh, m, h_out, c_out,
                                            B, Tn, H, forget_bias, s);
  if (cell == kLstm && dtype == 1)
    return (int)launch<kLstm, HOIST, __nv_bfloat16>(
        xin, wx, b, wh, m, h_out, c_out, B, Tn, H, forget_bias, s);
  if (cell == kGru && dtype == 0)
    return (int)launch<kGru, HOIST, float>(xin, wx, b, wh, m, h_out, c_out,
                                           B, Tn, H, forget_bias, s);
  if (cell == kGru && dtype == 1)
    return (int)launch<kGru, HOIST, __nv_bfloat16>(
        xin, wx, b, wh, m, h_out, c_out, B, Tn, H, forget_bias, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shared memory one launch needs, in bytes (the wrapper checks it against
// the card's limit before launching). hoist: 0 = fused, 1 = hoisted.
extern "C" long long lfm_rnn_fwd_smem(int cell, int hoist, int H) {
  return (long long)smem_bytes(cell == kLstm ? 4 : 3, H, hoist != 0);
}

// The fused form. cell: 0 = LSTM, 1 = GRU. dtype: 0 = float32,
// 1 = bfloat16 (hin, wx, b, wh, h_out and c_out all in it). m is uint8
// [B, T]. c_out may be null: the cell state is written only when asked
// (the backward needs it). Returns cudaGetLastError().
extern "C" int lfm_rnn_fused_fwd(int cell, int dtype, const void* hin,
                                 const void* wx, const void* b,
                                 const void* wh, const void* m, void* h_out,
                                 void* c_out, int B, int Tn, int H,
                                 float forget_bias, void* stream) {
  return dispatch<false>(cell, dtype, hin, wx, b, wh, m, h_out, c_out, B, Tn,
                         H, forget_bias, stream);
}

// The hoisted form: xw [B, T, G*H] in place of hin, W_x and b; the rest as
// lfm_rnn_fused_fwd.
extern "C" int lfm_rnn_scan_fwd(int cell, int dtype, const void* xw,
                                const void* wh, const void* m, void* h_out,
                                void* c_out, int B, int Tn, int H,
                                float forget_bias, void* stream) {
  return dispatch<true>(cell, dtype, xw, nullptr, nullptr, wh, m, h_out,
                        c_out, B, Tn, H, forget_bias, stream);
}
