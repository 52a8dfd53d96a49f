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
// Route (ops/rnn.py _mma_route): bfloat16 at every H <= 128, so that W_h
// (G * H * H bf16, 128 KB for the LSTM at H = 128) fits in shared memory.
// A width that is not a multiple of 16 comes in zero-padded per gate block
// to the next one (ops/rnn.py padded_launch; exact, see there). float32
// runs on csrc/rnn_fwd_tf32.cu; bfloat16 above 128 on csrc/rnn_fwd_cluster.cu
// (W_h split across a cluster), past 512 on csrc/rnn_fused_fwd.cu.
//
// Hoisted mode (template flag HOIST, entry lfm_rnn_scan_fwd_mma): replaces
// _lstm_fwd_kernel (pallas_rnn.py:135) and _gru_fwd_kernel (:158), reached
// through _fwd_call (:365). The gate sums start from xw_t [B, T, G H] bf16
// (read as f32; the bias is in it), so there is no W_x product, no hin
// tile and no bias; W_h stays in shared memory in fragment order and the
// rounding points are the fused mode's (h and c carried in f32, bf16(h)
// the recurrent product's operand; the GRU keeps the x and h sums of n
// apart). xw_t is the design problem: at 64 rows a double-buffered
// [rows, G H + 8] bf16 tile is 133 KB, which does not fit beside W_h's
// 128 KB. Each thread instead loads its own xw_t pairs (row, gate, units
// u, u + 1: the accumulator's layout) from device memory into registers a
// step ahead (8 x 4 bytes per 16 rows for the LSTM), as the hoisted
// backward in csrc/rnn_fused_bwd_mma.cu does, and the mode takes 16 or 32
// rows per block (ops/rnn.py _mma_rows, hoisted): 64 would hold 32 more
// registers a thread over the products at 512 threads. Shared memory is
// W_h and the two h tiles: 139,776 bytes for the LSTM at H = 128 and 16
// rows (the fused mode's 150,528). Bound at the c2 train step (B 2048,
// T 60, H 128, LSTM): 1.6e10 operations against 0.16 GB of xw in and h
// out, bound by bytes, 0.047 ms.
//
// Bound. At the c2 serving dispatch (B = 16384, T = 60, H = 128, LSTM) the
// work is 2 * B * T * H * 2 * 4H = 2.58e11 operations against 0.25 GB of
// hin in and h out: bound by operations, 0.26 ms at 989 TFLOP/s. At the
// c5 ensemble's train step (64 seeds of B = 2048) it is 2.1 ms.
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
//   picked per call from the block count S * ceil(B / rows) by ops/rnn.py
//   _mma_rows: 64 for the serving dispatches and the c5 ensemble step, 16
//   for the c2 train step.
// * Seeds (the JAX kernels' seed grid dimension, pallas_rnn.py _fwd_vmap
//   :919): blockIdx.y is the seed. Each operand has its own seed stride
//   (SeedStrides), 0 for an operand of seed extent 1, which every seed
//   reads at seed 0 (JAX's _sidx); the outputs are per seed. A block
//   loads its own seed's W_h; every per-seed base offset is 64-bit. A
//   seed's rows take the same path as in a one-seed launch with the same
//   rows per block, so its outputs are bitwise those of that launch.
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

// Seed strides of the operands, in elements of each (W_x and W_h in bf16
// elements of their packed form); 0 for an operand shared by every seed.
struct SeedStrides {
  long long hin, wx, b, wh, m;
};

// Shared memory: packed W_h [H * G * H] bf16, the hin and h tiles (two
// each, [rows, H + 8] bf16) and the bias [G * H] f32; the hoisted mode
// keeps only W_h and the h tiles.
inline size_t smem_bytes(int gates, int H, int rows, bool hoist) {
  return (size_t)H * gates * H * 2 +
         (hoist ? 2 : 4) * (size_t)rows * (H + 8) * 2 +
         (hoist ? 0 : (size_t)gates * H * 4);
}

// Per seed (blockIdx.y, operands offset by their SeedStrides): hin [B, T,
// H]; wxp, whp: W_x, W_h packed in fragment order; b [G * H]; m uint8 [B,
// T]; h_out, c_out [B, T, H] (c_out may be null), stride B T H. The block
// owns 16 * RT rows; blockDim.x = (H / kUnits) * 32. HOIST: hin is xw [B,
// T, G * H] (its seed stride st.hin), and wxp and b are unused.
template <int CELL, int RT, bool HOIST>
__global__ void __launch_bounds__(128 * 32 / kUnits, 1)
rnn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ hin,
                   const uint2* __restrict__ wxp,
                   const __nv_bfloat16* __restrict__ b,
                   const uint2* __restrict__ whp,
                   const uint8_t* __restrict__ m,
                   __nv_bfloat16* __restrict__ h_out,
                   __nv_bfloat16* __restrict__ c_out, int B, int Tn, int H,
                   SeedStrides st, float forget_bias) {
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
  __nv_bfloat16* h_s = HOIST ? hin_s : hin_s + 2 * BB * LD;
  float* bias_s = reinterpret_cast<float*>(h_s + 2 * BB * LD);

  {
    const size_t seed = blockIdx.y;
    const size_t seq = (size_t)B * Tn * H;
    hin += seed * st.hin;
    wxp = reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(wxp) + seed * st.wx);
    b += seed * st.b;
    whp = reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(whp) + seed * st.wh);
    m += seed * st.m;
    h_out += seed * seq;
    if (c_out != nullptr) c_out += seed * seq;
  }

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
  if (!HOIST) load_hin(0, 0);
  cp_async_commit();
  if (!HOIST)
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
  const uint2* wx_w = HOIST ? nullptr : wxp + (size_t)warp * NT * 32 + lane;
  const uint2* wh_w = wh_s + warp * NT * 32 + lane;

  // HOIST: the thread's xw_t pairs (row, gate q, units u, u + 1 of tile
  // j), loaded into registers a step ahead; rows past B read 0.
  __nv_bfloat162 xwn[RT][2][G][NJ];
  auto load_xw = [&](int t) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + row_l + 8 * half;
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            xwn[rt][half][q][j] =
                r < nr ? *reinterpret_cast<const __nv_bfloat162*>(
                             hin + ((size_t)(r0 + r) * Tn + t) * GH + q * H +
                             u0 + 8 * j + unit_l)
                       : __floats2bfloat162_rn(0.0f, 0.0f);
      }
  };
  if (HOIST) load_xw(0);

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
    if (!HOIST && t + 1 < Tn) load_hin(t + 1, cur ^ 1);
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

    // Slots: the G x-side gates (from the bias, HOIST: from xw_t); the
    // GRU's slot 3 is the h side of n.
    float acc[RT][4][NJ][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (HOIST) {
              const float2 v = __bfloat1622float2(
                  xwn[rt][i >> 1][q < G ? q : 0][j]);
              acc[rt][q][j][i] = q < G ? ((i & 1) ? v.y : v.x) : 0.0f;
            } else {
              acc[rt][q][j][i] =
                  q < G ? bias_s[q * H + u0 + 8 * j + unit_l + (i & 1)]
                        : 0.0f;
            }
          }
    if (HOIST && t + 1 < Tn) load_xw(t + 1);

    for (int kk = 0; kk < KT; ++kk) {
      const size_t koff = (size_t)kk * S * NT * 32;
      uint2 bx[NT];
      if (!HOIST)
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
      if (!HOIST)
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

template <int CELL, int RT, bool HOIST>
cudaError_t launch(const void* hin, const void* wxp, const void* b,
                   const void* whp, const void* m, void* h_out, void* c_out,
                   int S, int B, int Tn, int H, SeedStrides st,
                   float forget_bias, cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int rows = 16 * RT;
  const size_t smem = smem_bytes(G, H, rows, HOIST);
  auto kernel = rnn_fwd_mma_kernel<CELL, RT, HOIST>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + rows - 1) / rows;
  kernel<<<dim3(blocks, S), (H / kUnits) * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(hin), static_cast<const uint2*>(wxp),
      static_cast<const __nv_bfloat16*>(b), static_cast<const uint2*>(whp),
      static_cast<const uint8_t*>(m), static_cast<__nv_bfloat16*>(h_out),
      CELL == kLstm ? static_cast<__nv_bfloat16*>(c_out) : nullptr, B, Tn, H,
      st, forget_bias);
  return cudaGetLastError();
}

template <int CELL, bool HOIST>
cudaError_t launch_rows(int rows, const void* hin, const void* wxp,
                        const void* b, const void* whp, const void* m,
                        void* h_out, void* c_out, int S, int B, int Tn,
                        int H, SeedStrides st, float fb, cudaStream_t s) {
  if (rows == 16)
    return launch<CELL, 1, HOIST>(hin, wxp, b, whp, m, h_out, c_out, S, B,
                                  Tn, H, st, fb, s);
  if (rows == 32)
    return launch<CELL, 2, HOIST>(hin, wxp, b, whp, m, h_out, c_out, S, B,
                                  Tn, H, st, fb, s);
  if constexpr (!HOIST)
    return launch<CELL, 4, HOIST>(hin, wxp, b, whp, m, h_out, c_out, S, B,
                                  Tn, H, st, fb, s);
  return cudaErrorInvalidValue;
}

// The shapes the kernel takes: 16 <= H <= 128, H % 16 == 0, and 16, 32 or
// (the fused mode) 64 rows per block.
bool supported(int H, int rows, bool hoist) {
  if (H < 16 || H > 128 || H % 16 != 0) return false;
  return rows == 16 || rows == 32 || (rows == 64 && !hoist);
}

}  // namespace

// Shared memory one launch needs, in bytes; -1 for a shape the kernel does
// not take. cell: 0 = LSTM, 1 = GRU; rows: rows per block.
extern "C" long long lfm_rnn_fused_fwd_mma_smem(int cell, int H, int rows) {
  if (!supported(H, rows, false)) return -1;
  return (long long)smem_bytes(cell == kLstm ? 4 : 3, H, rows, false);
}

// The fused forward in bfloat16 on the tensor cores, for S seeds in one
// launch. Per seed: hin [B, T, H], b [G * H], h_out and c_out [B, T, H]
// bf16; wxp and whp are W_x and W_h [H, G * H] permuted into fragment
// order (ops/rnn.py pack_fragments); m uint8 [B, T]. s_*: each operand's
// seed stride in its elements (0: shared by every seed); h_out and c_out
// are [S, B, T, H]. rows: rows per block (16, 32 or 64); c_out may be
// null. Returns cudaGetLastError().
extern "C" int lfm_rnn_fused_fwd_mma(int cell, const void* hin,
                                     const void* wxp, const void* b,
                                     const void* whp, const void* m,
                                     void* h_out, void* c_out, int S, int B,
                                     int Tn, int H, int rows,
                                     long long s_hin, long long s_wx,
                                     long long s_b, long long s_wh,
                                     long long s_m, float forget_bias,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0 || S > 65535 || B <= 0 || Tn <= 0 ||
      !supported(H, rows, false))
    return (int)cudaErrorInvalidValue;
  const SeedStrides st{s_hin, s_wx, s_b, s_wh, s_m};
  if (cell == kLstm)
    return (int)launch_rows<kLstm, false>(rows, hin, wxp, b, whp, m, h_out,
                                          c_out, S, B, Tn, H, st,
                                          forget_bias, s);
  if (cell == kGru)
    return (int)launch_rows<kGru, false>(rows, hin, wxp, b, whp, m, h_out,
                                         c_out, S, B, Tn, H, st, forget_bias,
                                         s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one launch of the hoisted mode, in bytes; -1 for a shape
// it does not take (rows: 16 or 32).
extern "C" long long lfm_rnn_scan_fwd_mma_smem(int cell, int H, int rows) {
  if (!supported(H, rows, true)) return -1;
  return (long long)smem_bytes(cell == kLstm ? 4 : 3, H, rows, true);
}

// The hoisted forward in bfloat16 on the tensor cores (the hoisted mode),
// for S seeds in one launch. Per seed: xw [B, T, G * H] bf16 (the gates' x
// side with its bias), h_out and c_out [B, T, H] bf16; whp is W_h [H, G *
// H] in fragment order (ops/rnn.py pack_fragments); m uint8 [B, T]. s_*:
// each operand's seed stride in its elements (0: shared); h_out and c_out
// are [S, B, T, H]. rows: rows per block (16 or 32); c_out may be null.
// Returns cudaGetLastError().
extern "C" int lfm_rnn_scan_fwd_mma(int cell, const void* xw,
                                    const void* whp, const void* m,
                                    void* h_out, void* c_out, int S, int B,
                                    int Tn, int H, int rows, long long s_xw,
                                    long long s_wh, long long s_m,
                                    float forget_bias, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0 || S > 65535 || B <= 0 || Tn <= 0 || !supported(H, rows, true))
    return (int)cudaErrorInvalidValue;
  const SeedStrides st{s_xw, 0, 0, s_wh, s_m};
  if (cell == kLstm)
    return (int)launch_rows<kLstm, true>(rows, xw, nullptr, nullptr, whp, m,
                                         h_out, c_out, S, B, Tn, H, st,
                                         forget_bias, s);
  if (cell == kGru)
    return (int)launch_rows<kGru, true>(rows, xw, nullptr, nullptr, whp, m,
                                        h_out, c_out, S, B, Tn, H, st,
                                        forget_bias, s);
  return (int)cudaErrorInvalidValue;
}
