// Masked LSTM/GRU recurrence, backward, for sm_90a: the fused form (input
// gradient dhin and dW_x, dW_h, db) and the hoisted form (dxw and dW_h).
//
// Replaces the Pallas TPU kernels _lstm_fused_bwd_kernel and
// _gru_fused_bwd_kernel, reached through _fused_bwd_call, and (hoisted form)
// _lstm_bwd_kernel and _gru_bwd_kernel, reached through _bwd_call, all in
// lfm_quant_tpu/ops/pallas_rnn.py. Walking t = T-1 .. 0, with the carries
// dh and dc (f32) starting at zero:
//
//   recompute the gates from the saved states (h_{t-1} and c_{t-1} are zero
//   at t = 0; the saved masked c_t stands in for c_new, which is exact
//   because every term that uses it carries the mask), then
//   LSTM: dh_new = keep * (dh_up_t + dh);  dc_new = keep * dc
//         dc_tot = dc_new + dh_new * o * (1 - tanh(c_t)^2)
//         d_gates = [dc_tot g i(1-i), dc_tot c_{t-1} f(1-f), dc_tot i (1-g^2),
//                    dh_new tanh(c_t) o(1-o)]
//         dh <- (1 - keep) * dh_t + d_gates @ W_h^T
//         dc <- (1 - keep) * dc + dc_tot * f
//   GRU:  dz = dh_new (h_{t-1} - n);  dn = dh_new (1-z)(1-n^2);  dr = dn * hn
//         d_hw = [dz z(1-z), dr r(1-r), dn * r];  d_xw = [.., .., dn]
//         dh <- (1 - keep) * dh_t + dh_new * z + d_hw @ W_h^T
//   fused: dhin_t = d_xw @ W_x^T  (in hin's type)
//   dW_x = sum hin^T d_xw;  dW_h = sum h_{t-1}^T d_hw;  db = sum d_xw  (f32)
//
// Rounding points as the TPU kernels: h_{t-1} is rounded to W_h's type for
// the recomputed product (the saved states already are in the input's
// type) and the products with W^T and the weight gradients run in f32.
//
// Bound. At the c2 train step (B = 2048, T = 60, H = 128, G*H = 512, bf16)
// the fused form does 12 * H * G*H * B * T = 9.7e10 operations (two
// recomputed products, two backward products, two weight gradients)
// against about 0.16 GB of inputs and outputs, so it is bound by
// operations: 0.10 ms at 989 TFLOP/s. The hoisted form does half the
// operations and moves the G-times wider xw and dxw: bound by bytes. This
// first version runs every product on the CUDA cores in f32. Design:
//
// * Kernel 1, the reverse recurrence: one block owns ROWS rows for all T
//   steps, the dh/dc carries in shared memory. ROWS (16, 8, 4, 2 or 1, a
//   template parameter) is chosen per launch: the most whose shared
//   memory fits the card's per-block limit, so every hidden width the TPU
//   kernels take runs (the fused LSTM at H 256 takes 8, at H 512 4); a
//   row's sums do not depend on ROWS, so neither do its bits. Per step it
//   recomputes the gates (threads own gate columns, as the forward
//   kernel), forms d_gates in shared memory and writes them to device
//   memory in f32 (the weight gradients need them), then carries dh
//   through d_gates @ W_h^T and, in the fused form, writes dhin = d_xw @
//   W_x^T (threads own output columns; W^T is given transposed in f32 so
//   those reads coalesce).
// * Kernel 2, the weight gradients: A^T D over all B*T rows, one 128 x 128
//   output tile per block and a fixed chunk of rows per grid slice,
//   written as per-slice partial sums. Kernel 3 adds the bias column sums
//   the same way, and kernel 4 adds the slices in a fixed order. No atomics:
//   the gradients are bitwise the same from run to run. (On the TPU the
//   batch blocks ran in order and revisited one output block in VMEM; on
//   the card the blocks run concurrently, hence the partials.)
// * Seeds (pallas_rnn.py _bwd_vmap :951 and _make_scan._bwd_vmap :541):
//   the seed is blockIdx.y of kernels 1 and 4 and the high part of the
//   slice axis of kernels 2 and 3. Each operand has its own seed stride
//   (SeedStrides, 0 for one shared by every seed; W^T takes W's); the
//   saved states, dh and every output and scratch array are per seed,
//   partial [seeds, S, total] and dw [seeds, total]. The slices are per
//   seed and summed in the same fixed order, so a seed's gradients are
//   bitwise those of a one-seed launch. Every per-seed offset is 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kLstm = 0;
constexpr int kGru = 1;
constexpr int kTile = 128;       // kernel 2 output tile edge
constexpr int kTileM = 8;        // kernel 2 rows per shared-memory stage

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

// acc[r] += sum_{k < n} S[r * lds + k] * W[k * ldw]  for all ROWS rows:
// S in shared memory (read as broadcasts, four values of k per load when
// aligned), W in device memory (one value per k, used for every row).
template <int ROWS, typename TW>
__device__ __forceinline__ void rows_dot(const float* __restrict__ S, int lds,
                                         int n, const TW* __restrict__ W,
                                         size_t ldw, float* acc) {
  int k = 0;
  if (((lds | n) & 3) == 0) {
    for (; k < n; k += 4) {
      float w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = to_f(W[(size_t)(k + q) * ldw]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 s = *reinterpret_cast<const float4*>(S + r * lds + k);
        acc[r] = fmaf(s.x, w[0], acc[r]);
        acc[r] = fmaf(s.y, w[1], acc[r]);
        acc[r] = fmaf(s.z, w[2], acc[r]);
        acc[r] = fmaf(s.w, w[3], acc[r]);
      }
    }
  }
  for (; k < n; ++k) {
    const float w = to_f(W[(size_t)k * ldw]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(S[r * lds + k], w, acc[r]);
  }
}

// Shared memory of kernel 1 (floats, each [rows, .]): hp_s, dh_s, dc_s
// [H]; hs_s, dg_s [G*H]; fused: hin_s [H], xs_s [G*H]; GRU: dhn_s [H];
// then the rows' step validity, one byte each, rounded up to 16 bytes.
inline size_t recur_smem_bytes(int cell, bool fused, int H, int rows) {
  const int G = cell == kLstm ? 4 : 3;
  size_t per_row = 3 * H + 2 * G * H;
  if (fused) per_row += H + G * H;
  if (cell == kGru) per_row += H;
  return sizeof(float) * rows * per_row + (size_t)((rows + 15) / 16) * 16;
}

// Seed strides of the operands that may be shared, in elements of each (0:
// shared by every seed). W_x^T and W_h^T take W_x's and W_h's.
struct SeedStrides {
  long long xin, wx, b, wh, m;
};

// Kernel 1, per seed (blockIdx.y), ROWS batch rows (blockIdx.x). Per seed:
// xin: hin [B, T, H] (fused) or xw [B, T, G*H]. wxT, whT: [G*H, H] f32.
// dx_out: dhin [B, T, H] (fused) or dxw [B, T, G*H] (may be null: the
// caller then reads dgx). dgx: d_xw [B, T, G*H] f32. dhn (GRU): the h side
// of d_gates' n slice, [B, T, H] f32.
template <int CELL, bool FUSED, int ROWS, typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
rnn_bwd_recur_kernel(const T* __restrict__ xin, const T* __restrict__ wx,
                     const T* __restrict__ b, const T* __restrict__ wh,
                     const float* __restrict__ wxT,
                     const float* __restrict__ whT,
                     const uint8_t* __restrict__ m,
                     const T* __restrict__ h_all,
                     const T* __restrict__ c_all, const T* __restrict__ dh,
                     T* __restrict__ dx_out, float* __restrict__ dgx,
                     float* __restrict__ dhn, int B, int Tn, int H,
                     SeedStrides st, float forget_bias) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  const int GH = G * H;
  {
    const size_t seed = blockIdx.y;
    const size_t seq = (size_t)B * Tn * H;
    xin += seed * st.xin;
    if (FUSED) {
      wx += seed * st.wx;
      b += seed * st.b;
      wxT += seed * st.wx;
    }
    wh += seed * st.wh;
    whT += seed * st.wh;
    m += seed * st.m;
    h_all += seed * seq;
    if (c_all != nullptr) c_all += seed * seq;
    dh += seed * seq;
    if (dx_out != nullptr) dx_out += seed * (FUSED ? seq : seq * G);
    dgx += seed * seq * G;
    if (dhn != nullptr) dhn += seed * seq;
  }
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* hp_s = smem;                 // h_{t-1}, in W_h's type
  float* dh_s = hp_s + ROWS * H;      // f32 carry
  float* dc_s = dh_s + ROWS * H;      // f32 carry (LSTM)
  float* hs_s = dc_s + ROWS * H;      // h_{t-1} @ W_h
  float* dg_s = hs_s + ROWS * GH;     // d_xw of this step
  float* hin_s = dg_s + ROWS * GH;    // fused: hin_t
  float* xs_s = hin_s + (FUSED ? ROWS * H : 0);  // fused: hin_t @ W_x + b
  float* dhn_s = xs_s + (FUSED ? ROWS * GH : 0);  // GRU
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(
      dhn_s + (CELL == kGru ? ROWS * H : 0));

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int r0 = blockIdx.x * ROWS;
  const int nr = min(ROWS, B - r0);

  for (int i = tid; i < ROWS * H; i += nth) {
    dh_s[i] = 0.0f;
    dc_s[i] = 0.0f;
    if (CELL == kGru) dhn_s[i] = 0.0f;
  }
  for (int i = tid; i < ROWS * GH; i += nth) dg_s[i] = 0.0f;

  for (int t = Tn - 1; t >= 0; --t) {
    for (int i = tid; i < ROWS * H; i += nth) {
      const int r = i / H;
      const int k = i - r * H;
      const size_t row = (size_t)(r0 + r) * Tn;
      // h_all is stored in W_h's type, so h_{t-1} needs no rounding.
      hp_s[i] = (r < nr && t > 0) ? to_f(h_all[(row + t - 1) * H + k])
                                  : 0.0f;
      if (FUSED) hin_s[i] = r < nr ? to_f(xin[(row + t) * H + k]) : 0.0f;
    }
    if (tid < ROWS) {
      keep_s[tid] = tid < nr ? m[(size_t)(r0 + tid) * Tn + t] : 0;
    }
    __syncthreads();

    // The gates, recomputed: threads own gate columns j.
    for (int j = tid; j < GH; j += nth) {
      float ah[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) ah[r] = 0.0f;
      rows_dot<ROWS>(hp_s, H, H, wh + j, GH, ah);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) hs_s[r * GH + j] = ah[r];
      if (FUSED) {
        float ax[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) ax[r] = 0.0f;
        rows_dot<ROWS>(hin_s, H, H, wx + j, GH, ax);
        const float bj = to_f(b[j]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) xs_s[r * GH + j] = ax[r] + bj;
      }
    }
    __syncthreads();

    // d_gates and the elementwise parts of the carries over [nr, H].
    for (int i = tid; i < nr * H; i += nth) {
      const int r = i / H;
      const int u = i - r * H;
      const size_t row_t = (size_t)(r0 + r) * Tn + t;
      const T* xw_row = FUSED ? xin : xin + row_t * GH + u;
      const float* xs = xs_s + r * GH + u;
      const float* hs = hs_s + r * GH + u;
      auto xv = [&](int q) {
        return FUSED ? xs[q * H] : to_f(xw_row[q * H]);
      };
      const float keep = keep_s[r] ? 1.0f : 0.0f;
      const float dh_t = to_f(dh[row_t * H + u]) + dh_s[i];
      const float dh_new = keep * dh_t;
      float* dg = dg_s + r * GH + u;
      float* dgx_row = dgx + row_t * GH + u;
      if (CELL == kLstm) {
        const float ig = sigmoid(xv(0) + hs[0]);
        const float fg = sigmoid((xv(1) + hs[H]) + forget_bias);
        const float gg = tanhf(xv(2) + hs[2 * H]);
        const float og = sigmoid(xv(3) + hs[3 * H]);
        const float c_prev =
            t > 0 ? to_f(c_all[(row_t - 1) * H + u]) : 0.0f;
        const float c_cur = to_f(c_all[row_t * H + u]);
        const float dc_t = dc_s[i];
        const float dc_new = keep * dc_t;
        const float tc = tanhf(c_cur);
        const float do_ = dh_new * tc;
        const float dc_tot = dc_new + dh_new * og * (1.0f - tc * tc);
        dg[0] = (dc_tot * gg) * ig * (1.0f - ig);
        dg[H] = (dc_tot * c_prev) * fg * (1.0f - fg);
        dg[2 * H] = (dc_tot * ig) * (1.0f - gg * gg);
        dg[3 * H] = do_ * og * (1.0f - og);
        dh_s[i] = (1.0f - keep) * dh_t;
        dc_s[i] = (1.0f - keep) * dc_t + dc_tot * fg;
      } else {
        const float h_prev = hp_s[i];
        const float z = sigmoid(xv(0) + hs[0]);
        const float rg = sigmoid(xv(1) + hs[H]);
        const float hn = hs[2 * H];
        const float n = tanhf(xv(2) + rg * hn);
        const float dz = dh_new * (h_prev - n);
        const float dn_raw = dh_new * (1.0f - z) * (1.0f - n * n);
        const float dr = dn_raw * hn;
        dg[0] = dz * z * (1.0f - z);
        dg[H] = dr * rg * (1.0f - rg);
        dg[2 * H] = dn_raw;
        const float d_hn = dn_raw * rg;
        dhn_s[i] = d_hn;
        dhn[row_t * H + u] = d_hn;
        dh_s[i] = (1.0f - keep) * dh_t + dh_new * z;
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
        dgx_row[q * H] = dg[q * H];
        if (!FUSED && dx_out != nullptr)
          dx_out[row_t * GH + q * H + u] = from_f<T>(dg[q * H]);
      }
    }
    __syncthreads();

    // The backward products: threads own output columns k of dh (p = 0)
    // and, fused, of dhin (p = 1).
    const int n_out = (FUSED ? 2 : 1) * H;
    for (int c = tid; c < n_out; c += nth) {
      const int p = c / H;
      const int k = c - p * H;
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
      if (p == 0) {
        if (CELL == kLstm) {
          rows_dot<ROWS>(dg_s, GH, GH, whT + k, H, acc);
        } else {  // d_hw: d_xw with the n slice from the h side
          rows_dot<ROWS>(dg_s, GH, 2 * H, whT + k, H, acc);
          rows_dot<ROWS>(dhn_s, H, H, whT + (size_t)2 * H * H + k, H, acc);
        }
        for (int r = 0; r < nr; ++r) dh_s[r * H + k] += acc[r];
      } else {
        rows_dot<ROWS>(dg_s, GH, GH, wxT + k, H, acc);
        for (int r = 0; r < nr; ++r)
          dx_out[((size_t)(r0 + r) * Tn + t) * H + k] = from_f<T>(acc[r]);
      }
    }
    __syncthreads();
  }
}

// Kernel 2: out[s, k, j] = sum over rows m of slice s of A(m, k) * D(m, j),
// A [M, K] (shift: row m reads m - 1 within its sequence of Tn rows, zero at
// the sequence's first step — the h_{t-1} of the saved h_t), D [M, N] f32
// with columns j >= n_split read from Dn [M, K] at j - n_split when Dn is
// given (the GRU's d_hw). blockIdx.z is seed * slices + s: per seed, A
// moves by sA elements (0: shared), D, Dn and out by their own sizes. 256
// threads, each an 8 x 8 patch of the 128 x 128 tile: per stage row a thread loads 8 + 8 operands for 64 FMAs, and the
// next stage's device-memory loads are in flight during this stage's.
template <typename TA>
__global__ void __launch_bounds__(256)
wgrad_partial_kernel(const TA* __restrict__ A, int shift,
                     const float* __restrict__ D,
                     const float* __restrict__ Dn, int n_split, int M, int K,
                     int N, int Tn, int rows_per_slice, int slices,
                     long long sA, float* __restrict__ out,
                     size_t slice_stride) {
  __shared__ float4 As4[kTileM][kTile / 4];
  __shared__ float4 Ds4[kTileM][kTile / 4];
  float (*As)[kTile] = reinterpret_cast<float (*)[kTile]>(As4);
  float (*Ds)[kTile] = reinterpret_cast<float (*)[kTile]>(Ds4);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int j0 = blockIdx.x * kTile;
  const int k0 = blockIdx.y * kTile;
  const int s = blockIdx.z % slices;
  {
    const size_t seed = blockIdx.z / slices;
    A += seed * sA;
    D += seed * (size_t)M * N;
    if (Dn != nullptr) Dn += seed * (size_t)M * K;
    out += seed * slices * slice_stride;
  }
  const int m_lo = s * rows_per_slice;
  const int m_hi = min(M, m_lo + rows_per_slice);
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.0f;

  // This thread's share of one stage: kLoads values of A and of D, fetched
  // into registers one stage ahead so their latency overlaps the FMAs.
  constexpr int kLoads = (kTileM * kTile) / 256;
  float ra[kLoads], rd[kLoads];
  auto fetch = [&](int mb) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int idx = tid + q * 256;
      const int mm = idx / kTile;
      const int cc = idx - mm * kTile;
      const int mrow = mb + mm;
      float av = 0.0f, dv = 0.0f;
      if (mrow < m_hi) {
        const int k = k0 + cc;
        if (k < K) {
          if (!shift) {
            av = to_f(A[(size_t)mrow * K + k]);
          } else if (mrow % Tn != 0) {
            av = to_f(A[(size_t)(mrow - 1) * K + k]);
          }
        }
        const int j = j0 + cc;
        if (j < N) {
          dv = (Dn != nullptr && j >= n_split)
                   ? Dn[(size_t)mrow * K + (j - n_split)]
                   : D[(size_t)mrow * N + j];
        }
      }
      ra[q] = av;
      rd[q] = dv;
    }
  };

  if (m_lo < m_hi) fetch(m_lo);
  for (int mb = m_lo; mb < m_hi; mb += kTileM) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int idx = tid + q * 256;
      const int mm = idx / kTile;
      const int cc = idx - mm * kTile;
      As[mm][cc] = ra[q];
      Ds[mm][cc] = rd[q];
    }
    __syncthreads();
    if (mb + kTileM < m_hi) fetch(mb + kTileM);
#pragma unroll
    for (int mm = 0; mm < kTileM; ++mm) {
      const float4 a0 = As4[mm][ty * 2];
      const float4 a1 = As4[mm][ty * 2 + 1];
      const float4 d0 = Ds4[mm][tx * 2];
      const float4 d1 = Ds4[mm][tx * 2 + 1];
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[q][c] = fmaf(a[q], d[c], acc[q][c]);
    }
    __syncthreads();
  }
  float* o = out + (size_t)s * slice_stride;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int k = k0 + ty * 8 + q;
    if (k >= K) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = j0 + tx * 8 + c;
      if (j < N) o[(size_t)k * N + j] = acc[q][c];
    }
  }
}

// Kernel 3: out[s, j] = sum over rows m of slice s of D[m, j]. A block of
// 32 x 8 threads owns 32 columns: each thread sums every 8th row, then
// the 8 partial sums are added in a fixed order. blockIdx.y is seed *
// slices + s.
__global__ void __launch_bounds__(256)
colsum_partial_kernel(const float* __restrict__ D, int M, int N,
                      int rows_per_slice, int slices, float* __restrict__ out,
                      size_t slice_stride) {
  __shared__ float part[8][32];
  const int j = blockIdx.x * 32 + threadIdx.x;
  const int s = blockIdx.y % slices;
  {
    const size_t seed = blockIdx.y / slices;
    D += seed * (size_t)M * N;
    out += seed * slices * slice_stride;
  }
  const int m_lo = s * rows_per_slice;
  const int m_hi = min(M, m_lo + rows_per_slice);
  float acc = 0.0f;
  if (j < N) {
    for (int mrow = m_lo + threadIdx.y; mrow < m_hi; mrow += 8)
      acc += D[(size_t)mrow * N + j];
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < N) {
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) sum += part[q][threadIdx.x];
    out[(size_t)s * slice_stride + j] = sum;
  }
}

// Kernel 4, per seed (blockIdx.y): out[seed][i] = sum_{s = 0 .. S-1}
// partial[seed][s][i], in that order.
__global__ void reduce_slices_kernel(const float* __restrict__ partial,
                                     int S, int count,
                                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const size_t seed = blockIdx.y;
  partial += seed * S * (size_t)count;
  out += seed * count;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += partial[(size_t)s * count + i];
  out[i] = acc;
}

template <typename TA>
cudaError_t launch_wgrad(const void* A, int shift, long long sA,
                         const float* D, const float* Dn, int n_split, int M,
                         int K, int N, int Tn, int S, int seeds, float* out,
                         size_t slice_stride, cudaStream_t stream) {
  const int rows = (M + S - 1) / S;
  dim3 grid((N + kTile - 1) / kTile, (K + kTile - 1) / kTile, S * seeds);
  wgrad_partial_kernel<TA><<<grid, 256, 0, stream>>>(
      static_cast<const TA*>(A), shift, D, Dn, n_split, M, K, N, Tn, rows, S,
      sA, out, slice_stride);
  return cudaGetLastError();
}

template <int CELL, bool FUSED, int ROWS, typename T>
cudaError_t launch_recur(const void* xin, const void* wx, const void* b,
                         const void* wh, const void* wxT, const void* whT,
                         const void* m, const void* h_all, const void* c_all,
                         const void* dh, void* dx_out, void* dgx, void* dhn,
                         int seeds, int B, int Tn, int H, SeedStrides st,
                         float forget_bias, cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  const int GH = G * H;
  const size_t smem = recur_smem_bytes(CELL, FUSED, H, ROWS);
  auto kernel = rnn_bwd_recur_kernel<CELL, FUSED, ROWS, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int threads = ((GH + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  kernel<<<dim3((B + ROWS - 1) / ROWS, seeds), threads, smem, stream>>>(
      static_cast<const T*>(xin), static_cast<const T*>(wx),
      static_cast<const T*>(b), static_cast<const T*>(wh),
      static_cast<const float*>(wxT), static_cast<const float*>(whT),
      static_cast<const uint8_t*>(m), static_cast<const T*>(h_all),
      static_cast<const T*>(c_all), static_cast<const T*>(dh),
      static_cast<T*>(dx_out), static_cast<float*>(dgx),
      static_cast<float*>(dhn), B, Tn, H, st, forget_bias);
  return cudaGetLastError();
}

template <int CELL, bool FUSED, typename T>
cudaError_t launch_all(const void* xin, const void* wx, const void* b,
                       const void* wh, const void* wxT, const void* whT,
                       const void* m, const void* h_all, const void* c_all,
                       const void* dh, void* dx_out, void* dgx, void* dhn,
                       void* partial, int S, void* dw, int seeds, int B,
                       int Tn, int H, int rows, SeedStrides st,
                       float forget_bias, cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  const int GH = G * H;
  cudaError_t err = cudaErrorInvalidValue;
#define LFM_RECUR(R)                                                        \
  if (rows == R)                                                            \
    err = launch_recur<CELL, FUSED, R, T>(xin, wx, b, wh, wxT, whT, m,      \
                                          h_all, c_all, dh, dx_out, dgx,    \
                                          dhn, seeds, B, Tn, H, st,         \
                                          forget_bias, stream)
  LFM_RECUR(16);
  LFM_RECUR(8);
  LFM_RECUR(4);
  LFM_RECUR(2);
  LFM_RECUR(1);
#undef LFM_RECUR
  if (err != cudaSuccess) return err;

  // Partial sums, seed- then slice-major: [seeds, S, (dW_x [H, GH], db
  // [GH] if fused,) dW_h [H, GH]].
  const int M = B * Tn;
  const size_t hg = (size_t)H * GH;
  const size_t total = FUSED ? 2 * hg + GH : hg;
  float* part = static_cast<float*>(partial);
  const float* d_x = static_cast<const float*>(dgx);
  const float* d_n = CELL == kGru ? static_cast<const float*>(dhn) : nullptr;
  if (FUSED) {
    err = launch_wgrad<T>(xin, 0, st.xin, d_x, nullptr, GH, M, H, GH, Tn, S,
                          seeds, part, total, stream);
    if (err != cudaSuccess) return err;
    const int rows_per = (M + S - 1) / S;
    colsum_partial_kernel<<<dim3((GH + 31) / 32, S * seeds), dim3(32, 8), 0,
                            stream>>>(d_x, M, GH, rows_per, S, part + hg,
                                      total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = launch_wgrad<T>(h_all, 1, (long long)M * H, d_x, d_n, 2 * H, M, H,
                        GH, Tn, S, seeds, part + (FUSED ? hg + GH : 0), total,
                        stream);
  if (err != cudaSuccess) return err;
  reduce_slices_kernel<<<dim3((int)((total + 255) / 256), seeds), 256, 0,
                         stream>>>(part, S, (int)total,
                                   static_cast<float*>(dw));
  return cudaGetLastError();
}

// This translation unit's element type (see the entry points below).
#ifdef LFM_RNN_BWD_BF16
using Elem = __nv_bfloat16;
constexpr int kDtype = 1;
#else
using Elem = float;
constexpr int kDtype = 0;
#endif

template <bool FUSED>
int dispatch(int cell, int dtype, const void* xin, const void* wx,
             const void* b, const void* wh, const void* wxT,
             const void* whT, const void* m, const void* h_all,
             const void* c_all, const void* dh, void* dx_out, void* dgx,
             void* dhn, void* partial, int S, void* dw, int seeds, int B,
             int Tn, int H, int rows, SeedStrides st, float forget_bias,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != kDtype || seeds <= 0 || seeds > 65535 || B <= 0 || Tn <= 0 ||
      H <= 0 || S <= 0 || (long long)S * seeds > 65535)
    return (int)cudaErrorInvalidValue;
#define LFM_BWD(C)                                                          \
  return (int)launch_all<C, FUSED, Elem>(xin, wx, b, wh, wxT, whT, m, h_all, \
                                         c_all, dh, dx_out, dgx, dhn,       \
                                         partial, S, dw, seeds, B, Tn, H,   \
                                         rows, st, forget_bias, s)
  if (cell == kLstm) LFM_BWD(kLstm);
  if (cell == kGru) LFM_BWD(kGru);
#undef LFM_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The entry points. Each form's kernels build in one translation unit per
// dtype, so the four compile in parallel: this file the fused form in
// float32, csrc/rnn_fused_bwd_bf16.cu, rnn_scan_bwd.cu and
// rnn_scan_bwd_bf16.cu the others (each includes this file with
// LFM_RNN_BWD_HOISTED and/or LFM_RNN_BWD_BF16 set). The float32 unit of a
// form holds its public entry point, which hands bfloat16 on to the twin of
// the same signature (the name with _bf16) in the other unit.
#ifdef LFM_RNN_BWD_BF16
#define LFM_FUSED_BWD lfm_rnn_fused_bwd_bf16
#define LFM_SCAN_BWD lfm_rnn_scan_bwd_bf16
#else
#define LFM_FUSED_BWD lfm_rnn_fused_bwd
#define LFM_SCAN_BWD lfm_rnn_scan_bwd
#endif

#ifndef LFM_RNN_BWD_HOISTED
#ifndef LFM_RNN_BWD_BF16
// Shared memory of the reverse-recurrence kernel with `rows` batch rows
// per block, in bytes (the wrapper picks the most rows of 16, 8, 4, 2, 1
// whose count fits the card's limit). fused: 1 = fused, 0 = hoisted.
extern "C" long long lfm_rnn_bwd_smem(int cell, int fused, int H, int rows) {
  return (long long)recur_smem_bytes(cell, fused != 0, H, rows);
}

extern "C" int lfm_rnn_fused_bwd_bf16(
    int cell, int dtype, const void* hin, const void* wx, const void* b,
    const void* wh, const void* wxT, const void* whT, const void* m,
    const void* h_all, const void* c_all, const void* dh, void* dhin,
    void* dgx, void* dhn, void* partial, int S, void* dw, int seeds, int B,
    int Tn, int H, int rows, long long s_hin, long long s_wx, long long s_b,
    long long s_wh, long long s_m, float forget_bias, void* stream);
#endif

// The fused backward, for `seeds` seeds in one call. cell: 0 = LSTM, 1 =
// GRU; dtype: 0 = float32, 1 = bfloat16 (hin, wx, b, wh, h_all, c_all, dh
// and dhin in it). Per seed: hin [B, T, H]; wx, wh [H, G*H]; b [G*H];
// wxT, whT [G*H, H] f32 (at wx's and wh's seed strides); m uint8 [B, T];
// s_*: the seed strides of hin, wx, b, wh and m in their elements (0:
// shared). h_all, c_all (LSTM only), dh, dhin: [seeds, B, T, H]. Scratch
// the caller allocates: dgx [seeds, B, T, G*H] f32, dhn [seeds, B, T, H]
// f32 (GRU), partial [seeds, S, 2*H*G*H + G*H] f32. Output dw [seeds,
// 2*H*G*H + G*H] f32: dW_x, db, dW_h. rows: batch rows per block of the
// recurrence, 16, 8, 4, 2 or 1. Returns the first CUDA error of its four
// launches.
extern "C" int LFM_FUSED_BWD(int cell, int dtype, const void* hin,
                             const void* wx, const void* b, const void* wh,
                             const void* wxT, const void* whT, const void* m,
                             const void* h_all, const void* c_all,
                             const void* dh, void* dhin, void* dgx,
                             void* dhn, void* partial, int S, void* dw,
                             int seeds, int B, int Tn, int H, int rows,
                             long long s_hin, long long s_wx, long long s_b,
                             long long s_wh, long long s_m, float forget_bias,
                             void* stream) {
#ifndef LFM_RNN_BWD_BF16
  if (dtype == 1)
    return lfm_rnn_fused_bwd_bf16(cell, dtype, hin, wx, b, wh, wxT, whT, m,
                                  h_all, c_all, dh, dhin, dgx, dhn, partial,
                                  S, dw, seeds, B, Tn, H, rows, s_hin, s_wx,
                                  s_b, s_wh, s_m, forget_bias, stream);
#endif
  const SeedStrides st{s_hin, s_wx, s_b, s_wh, s_m};
  return dispatch<true>(cell, dtype, hin, wx, b, wh, wxT, whT, m, h_all,
                        c_all, dh, dhin, dgx, dhn, partial, S, dw, seeds, B,
                        Tn, H, rows, st, forget_bias, stream);
}

#else

#ifndef LFM_RNN_BWD_BF16
extern "C" int lfm_rnn_scan_bwd_bf16(
    int cell, int dtype, const void* xw, const void* wh, const void* whT,
    const void* m, const void* h_all, const void* c_all, const void* dh,
    void* dxw, void* dgx, void* dhn, void* partial, int S, void* dw,
    int seeds, int B, int Tn, int H, int rows, long long s_xw, long long s_wh,
    long long s_m, float forget_bias, void* stream);
#endif

// The hoisted backward: xw [B, T, G*H] per seed in place of hin, W_x and b.
// dxw [seeds, B, T, G*H] in xw's type may be null (float32: dgx is dxw).
// partial [seeds, S, H*G*H]; dw [seeds, H*G*H] f32: dW_h.
extern "C" int LFM_SCAN_BWD(int cell, int dtype, const void* xw,
                            const void* wh, const void* whT, const void* m,
                            const void* h_all, const void* c_all,
                            const void* dh, void* dxw, void* dgx, void* dhn,
                            void* partial, int S, void* dw, int seeds, int B,
                            int Tn, int H, int rows, long long s_xw,
                            long long s_wh, long long s_m, float forget_bias,
                            void* stream) {
#ifndef LFM_RNN_BWD_BF16
  if (dtype == 1)
    return lfm_rnn_scan_bwd_bf16(cell, dtype, xw, wh, whT, m, h_all, c_all,
                                 dh, dxw, dgx, dhn, partial, S, dw, seeds, B,
                                 Tn, H, rows, s_xw, s_wh, s_m, forget_bias,
                                 stream);
#endif
  const SeedStrides st{s_xw, 0, 0, s_wh, s_m};
  return dispatch<false>(cell, dtype, xw, nullptr, nullptr, wh, nullptr, whT,
                         m, h_all, c_all, dh, dxw, dgx, dhn, partial, S, dw,
                         seeds, B, Tn, H, rows, st, forget_bias, stream);
}

#endif  // LFM_RNN_BWD_HOISTED
