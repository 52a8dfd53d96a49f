// Window gather over the packed panel, for sm_90a.
//
// Replaces the Pallas TPU kernel _gather_kernel, reached through
// _make_gather.call_flat in lfm_quant_tpu/ops/pallas_gather.py, together
// with the XLA-side slice, roll and mask its wrapper runs after it. For
// each date d and firm slot b it writes
//
//   x[d, b, j, :] = xm[f, t - W + 1 + j, :F]   and   m[d, b, j] = valid
//
// with f = firm_idx[d, b], t = time_idx[d], valid = (validity column
// fp - 1 != 0) and (t - W + 1 + j >= 0); x is zero wherever m is false.
// So the anchor sits last and a young anchor's missing history is masked,
// as in the TPU kernel's clamp, slice and roll.
//
// Bound. The gather moves bytes and computes nothing: at the c2 serving
// dispatch (D = 8, Bf = 4096, W = 60, F = 20, bf16) it reads about 83 MB
// and writes about 80 MB, 0.049 ms at 3.35 TB/s. The TPU kernel's 128-lane
// padding and its 8-month aligned superwindow were Mosaic's DMA
// constraints; here the panel is stored unpadded and each window is read
// exactly. One packed month row is (F + 1) * 2 = 42 bytes in bf16, which
// is not 16-byte aligned, so this simple kernel copies element by element:
// one block per (date, block of firms), each block loads its own indices,
// and neighbouring threads write neighbouring output elements, so writes
// coalesce and each firm's window is read from one contiguous span.
// Indices outside the panel are clamped, as XLA clamps a gather.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFirms = 8;  // firm slots per block
constexpr int kThreads = 256;

__device__ __forceinline__ bool nonzero(float v) { return v != 0.0f; }
__device__ __forceinline__ bool nonzero(__nv_bfloat16 v) {
  return __bfloat162float(v) != 0.0f;
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const T* __restrict__ xm,
                     const int32_t* __restrict__ firm_idx,
                     const int32_t* __restrict__ time_idx,
                     T* __restrict__ x, uint8_t* __restrict__ m, int N,
                     int Tn, int Fp, int fp, int Bf, int W) {
  const int F = fp - 1;
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * kFirms;
  const int nb = min(kFirms, Bf - b0);
  const int first = time_idx[d] - (W - 1);  // month at window position 0
  __shared__ int firms[kFirms];
  if (threadIdx.x < nb) {
    const int f = firm_idx[(size_t)d * Bf + b0 + threadIdx.x];
    firms[threadIdx.x] = min(max(f, 0), N - 1);
  }
  __syncthreads();
  const size_t row0 = (size_t)d * Bf + b0;  // first output (d, b) row

  for (int i = threadIdx.x; i < nb * W; i += blockDim.x) {
    const int s = i / W;
    const int mon = first + (i - s * W);
    bool ok = false;
    if (mon >= 0) {
      const size_t src = ((size_t)firms[s] * Tn + min(mon, Tn - 1)) * Fp;
      ok = nonzero(xm[src + F]);
    }
    m[row0 * W + i] = ok ? 1 : 0;
  }

  for (int i = threadIdx.x; i < nb * W * F; i += blockDim.x) {
    const int step = i / F;  // s * W + j
    const int e = i - step * F;
    const int s = step / W;
    const int mon = first + (step - s * W);
    T v = zero<T>();
    if (mon >= 0) {
      const T* row = xm + ((size_t)firms[s] * Tn + min(mon, Tn - 1)) * Fp;
      if (nonzero(row[F])) v = row[e];
    }
    x[row0 * W * F + i] = v;
  }
}

template <typename T>
cudaError_t launch(const void* xm, const void* firm_idx, const void* time_idx,
                   void* x, void* m, int N, int Tn, int Fp, int fp, int D,
                   int Bf, int W, cudaStream_t stream) {
  const dim3 grid((Bf + kFirms - 1) / kFirms, D);
  window_gather_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xm), static_cast<const int32_t*>(firm_idx),
      static_cast<const int32_t*>(time_idx), static_cast<T*>(x),
      static_cast<uint8_t*>(m), N, Tn, Fp, fp, Bf, W);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xm and x). xm is [N, T, Fp] with the
// logical packed width fp <= Fp (validity at column fp - 1); firm_idx is
// int32 [D, Bf], time_idx int32 [D]; x is [D, Bf, W, fp - 1] and m is
// uint8 [D, Bf, W]. Returns cudaGetLastError().
extern "C" int lfm_window_gather(int dtype, const void* xm,
                                 const void* firm_idx, const void* time_idx,
                                 void* x, void* m, int N, int Tn, int Fp,
                                 int fp, int D, int Bf, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || Tn <= 0 || fp < 2 || fp > Fp || D <= 0 || D > 65535 ||
      Bf <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(xm, firm_idx, time_idx, x, m, N, Tn, Fp, fp, D,
                              Bf, W, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(xm, firm_idx, time_idx, x, m, N, Tn, Fp,
                                      fp, D, Bf, W, s);
  return (int)cudaErrorInvalidValue;
}

// The CUDA runtime's message for an error code the entry points return.
extern "C" const char* lfm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
