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
// Bound. The gather moves bytes and computes nothing: at the widest
// serving dispatch (D = 8, Bf = 4096, W = 60, F = 20, bf16) it reads about
// 83 MB and writes about 80 MB, 0.049 ms at 3.35 TB/s if every window's
// rows were read apart (chip_smoke.py gather_bound counts each touched
// panel row once). The TPU kernel's 128-lane padding and its 8-month
// aligned superwindow were Mosaic's DMA constraints; here the panel is
// stored unpadded and each window is read exactly.
//
// Design: one warp per window (d, b), two store widths in one kernel.
//
// * Span copies. A window that lies inside the panel reads
//   xm[f, t - W + 1 .. t, :], one contiguous span of W Fp elements (2520
//   bytes at c2 in bf16). The warp copies the span, aligned down and up to
//   16 bytes, with 16-byte ld.global.nc loads into its own shared buffer;
//   the span starts `shift` elements into the buffer. (One bulk copy by
//   the TMA instead, cp.async.bulk, is 1% faster at the c5 seed fold and
//   50% slower at the serving dispatches, whose pad columns repeat one
//   firm's span hundreds of times: those loads hit in L1, the bulk copies
//   go to one L2 slice each; scripts/torch_gather_variants.py.) Its
//   validity bytes
//   go to m and to a per-warp flag array. Then each lane builds 16-byte
//   output vectors: output element (j, k) of x[d, b] is buffer element
//   shift + j Fp + k. A vector of V = 16 / itemsize elements that stays in
//   row j is one funnel shift of the two aligned 16-byte words around it
//   (ld.shared.v4, __byte_perm); one that crosses into row j + 1 (n1 of its
//   elements in row j) blends that with a second funnel shift taken Fp - F
//   elements further on, which skips the validity column (and any lane
//   padding); each part is zero where its row is invalid. A lane walks its
//   vectors with incrementing (j, k), so there are no per-element
//   divisions. The output window is W F contiguous elements starting at
//   (d Bf + b) W F: with W F itemsize % 16 == 0 every vector store is
//   16-byte aligned.
// * Narrow stores, in the same kernel, for everything else: young anchors
//   (t - W + 1 < 0), indices outside the panel (clamped: the firm to
//   [0, N - 1], the month to <= T - 1, as XLA clamps a gather), and shapes
//   the span copy does not take (W F itemsize % 16 != 0, F < V, a panel
//   not 16-byte aligned, or a buffer over kMaxWarpBytes). The warp copies
//   element by element, neighbouring lanes on neighbouring output
//   elements, with the same incremental (j, k).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                // windows (warps) per block
constexpr int kMaxWarpBytes = 6 * 1024;  // one warp's buffer, at most
// The block's buffers stay within the default 48 KB of shared memory.
static_assert(kWarps * kMaxWarpBytes <= 48 * 1024, "shared memory");

__device__ __forceinline__ bool nonzero(float v) { return v != 0.0f; }
__device__ __forceinline__ bool nonzero(__nv_bfloat16 v) {
  return __bfloat162float(v) != 0.0f;
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// The 16 bytes of shared memory that start at byte `bq` (a multiple of the
// element size): the aligned words around them, funnel-shifted.
__device__ __forceinline__ uint4 funnel16(const unsigned char* buf, int bq) {
  const uint4 a = *reinterpret_cast<const uint4*>(buf + (bq & ~15));
  const uint4 b = *reinterpret_cast<const uint4*>(buf + (bq & ~15) + 16);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int ow = (bq >> 2) & 3;                     // whole words
  const uint32_t sel = (bq & 2) ? 0x5432u : 0x3210u;  // half a word (bf16)
  uint32_t s[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    s[i] = ow == 0 ? w[i] : ow == 1 ? w[i + 1] : ow == 2 ? w[i + 2] : w[i + 3];
  return make_uint4(__byte_perm(s[0], s[1], sel), __byte_perm(s[1], s[2], sel),
                    __byte_perm(s[2], s[3], sel), __byte_perm(s[3], s[4], sel));
}

// Elements 0 .. n1 - 1 from a (zero unless va), the rest from b (zero
// unless vb).
template <typename T>
__device__ __forceinline__ uint4 blend(uint4 a, uint4 b, int n1, bool va,
                                       bool vb) {
  constexpr int EPW = 4 / sizeof(T);  // elements per 32-bit word
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
  const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
  uint32_t o[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t ma = 0, mb = 0;
#pragma unroll
    for (int e = 0; e < EPW; ++e) {
      const uint32_t bits = EPW == 1 ? 0xFFFFFFFFu : (0xFFFFu << (16 * e));
      if (w * EPW + e < n1) {
        if (va) ma |= bits;
      } else if (vb) {
        mb |= bits;
      }
    }
    o[w] = (aw[w] & ma) | (bw[w] & mb);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// grid (ceil(Bf / kWarps), D), kWarps * 32 threads; `span`: the span copy
// is taken for windows inside the panel, with warp_bytes of dynamic shared
// memory per warp: the row flags, then the span's buffer.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
window_gather_kernel(const T* __restrict__ xm,
                     const int32_t* __restrict__ firm_idx,
                     const int32_t* __restrict__ time_idx,
                     T* __restrict__ x, uint8_t* __restrict__ m, int N,
                     int Tn, int Fp, int fp, int Bf, int W, bool span,
                     int warp_bytes) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = fp - 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d = blockIdx.y;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= Bf) return;
  const size_t row = (size_t)d * Bf + b;  // output window (d, b)
  const int f = firm_idx[row];
  const int t = time_idx[d];
  const int first = t - (W - 1);  // month at window position 0
  const int n = W * F;            // output elements of the window
  T* xo = x + row * n;
  uint8_t* mo = m + row * W;

  if (span && first >= 0 && t < Tn && f >= 0 && f < N) {
    unsigned char* flags = smem + warp * warp_bytes;
    unsigned char* buf = flags + ((W + 15) & ~15);
    // The span, aligned down and up to 16 bytes.
    const size_t a = (((size_t)f * Tn + first) * Fp) * sizeof(T);
    const int lead = (int)(a & 15);
    const uint4* src = reinterpret_cast<const uint4*>(
        reinterpret_cast<const unsigned char*>(xm) + (a - lead));
    const int chunks = (lead + W * Fp * (int)sizeof(T) + 15) >> 4;
    for (int c = lane; c < chunks; c += 32)
      reinterpret_cast<uint4*>(buf)[c] = __ldg(src + c);
    __syncwarp();
    const T* bt = reinterpret_cast<const T*>(buf);
    const int shift = lead / (int)sizeof(T);
    for (int j = lane; j < W; j += 32) {
      const uint8_t ok = nonzero(bt[shift + j * Fp + F]) ? 1 : 0;
      flags[j] = ok;
      mo[j] = ok;
    }
    __syncwarp();
    // Vector v = lane + 32 i starts at output element V v = (j, k).
    const int gap = Fp - F;
    const int dj = (32 * V) / F, dk = (32 * V) % F;
    int j = (V * lane) / F, k = (V * lane) % F;
    for (int v = lane; v < n / V; v += 32) {
      const int q = shift + j * Fp + k;  // buffer element of (j, k)
      const int n1 = k + V <= F ? V : F - k;  // elements in row j
      const uint4 lo = funnel16(buf, q * (int)sizeof(T));
      const uint4 hi = funnel16(buf, (q + gap) * (int)sizeof(T));
      reinterpret_cast<uint4*>(xo)[v] =
          blend<T>(lo, hi, n1, flags[j] != 0, n1 < V && flags[j + 1] != 0);
      k += dk;
      j += dj;
      if (k >= F) {
        k -= F;
        ++j;
      }
    }
    return;
  }

  // Narrow stores, with the clamping rules.
  const int fc = min(max(f, 0), N - 1);
  for (int j = lane; j < W; j += 32) {
    const int mon = first + j;
    bool ok = false;
    if (mon >= 0)
      ok = nonzero(xm[((size_t)fc * Tn + min(mon, Tn - 1)) * Fp + F]);
    mo[j] = ok ? 1 : 0;
  }
  const int dj = 32 / F, dk = 32 % F;
  int j = lane / F, k = lane % F;
  for (int i = lane; i < n; i += 32) {
    const int mon = first + j;
    T v = zero<T>();
    if (mon >= 0) {
      const T* r = xm + ((size_t)fc * Tn + min(mon, Tn - 1)) * Fp;
      if (nonzero(r[F])) v = r[k];
    }
    xo[i] = v;
    k += dk;
    j += dj;
    if (k >= F) {
      k -= F;
      ++j;
    }
  }
}

template <typename T>
cudaError_t launch(const void* xm, const void* firm_idx, const void* time_idx,
                   void* x, void* m, int N, int Tn, int Fp, int fp, int D,
                   int Bf, int W, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int F = fp - 1;
  // One warp's shared memory: the row flags, then the span's buffer (the
  // span, its alignment and the 16 bytes the last funnel shift reads past).
  const long long warp_bytes = ((W + 15) & ~15) +
                               (((long long)W * Fp * sizeof(T) + 32 + 15) &
                                ~15LL);
  const bool span = ((long long)W * F * sizeof(T)) % 16 == 0 && F >= V &&
                    reinterpret_cast<uintptr_t>(xm) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    warp_bytes <= kMaxWarpBytes;
  const size_t smem = span ? (size_t)kWarps * warp_bytes : 0;
  const dim3 grid((Bf + kWarps - 1) / kWarps, D);
  window_gather_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(xm), static_cast<const int32_t*>(firm_idx),
      static_cast<const int32_t*>(time_idx), static_cast<T*>(x),
      static_cast<uint8_t*>(m), N, Tn, Fp, fp, Bf, W, span,
      (int)warp_bytes);
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
