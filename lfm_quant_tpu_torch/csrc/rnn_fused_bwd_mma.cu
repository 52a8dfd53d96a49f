// Masked LSTM/GRU recurrence, fused backward, in bfloat16 on Hopper's
// tensor cores (mma.sync m16n8k16, f32 accumulation), for sm_90a.
//
// Replaces the Pallas TPU kernels _lstm_fused_bwd_kernel
// (lfm_quant_tpu/ops/pallas_rnn.py:673) and _gru_fused_bwd_kernel (:739),
// reached through _fused_bwd_call (:835). It computes what csrc/rnn_bwd.cu
// computes in its fused form (the formulas are written out there): walking
// t = T-1 .. 0 with f32 carries dh and dc, it recomputes the gates from the
// saved states, forms d_gates, carries dh <- (1 - keep) dh_t (+ dh_new z
// for the GRU) + d_hw @ W_h^T and writes dhin_t = d_xw @ W_x^T; then
// dW_x = sum hin^T d_xw, dW_h = sum h_{t-1}^T d_hw and db = sum d_xw.
//
// Numerics. The recomputed gates are those of the forward kernels (bf16
// operands, f32 sums), and d_gates, the carries and the cell's accurate
// expf/tanhf are f32 with the rounding points of csrc/rnn_bwd.cu. The TPU
// kernel multiplies the f32 d_gates by W cast to f32; here every product
// with d_gates splits it, d = hi + lo with hi = bf16(d) and lo = bf16(d -
// hi), and issues one mma.sync per term (kSplit = 2). The other operands
// (W, hin, h_{t-1}) are exactly bf16, so the products keep about 16
// significant bits of d_gates (relative error near 2^-17 per term) and
// differ from f32 products by little more than the order of the sums.
//
// Route (ops/rnn.py _mma_route): bfloat16 with H % 16 == 0 and
// 16 <= H <= 128. float32 and every other H stay on csrc/rnn_bwd.cu.
//
// Bound. At the c2 train step (B = 2048, T = 60, H = 128, LSTM) the
// function is 6 products of 2 H G H per row and step (two recomputed, dh,
// dhin, dW_x, dW_h): 9.7e10 operations, 0.098 ms at 989 TFLOP/s, against
// 0.16 GB of inputs and outputs: bound by operations; 6.3 ms at the c5
// ensemble's train step (64 seeds of that shape). The split's second term
// is this kernel's cost, not the function's work.
//
// Design:
//
// * Kernel 1, the reverse recurrence. One block owns 16 rows for all T
//   steps and has H / 8 warps; warp w owns all the rows and the 8 hidden
//   units u0 = 8 w .. u0 + 7 with all G gates, as the forward kernel, so
//   the gate sums, the cell's backward and the dh, dc carries of one
//   (row, unit) sit in one thread's registers. W_h is resident in shared
//   memory once, row-major [H, G H + 8] bf16 (133 KB for the LSTM at
//   H = 128; the 16-byte row padding keeps ldmatrix free of bank
//   conflicts) and serves both of its products: ldmatrix.trans on it gives
//   the B fragments of h_{t-1} @ W_h (K = H, N = G H), plain ldmatrix the B
//   fragments of d_hw @ W_h^T (K = G H, N = H), whose B stored N-major with
//   K contiguous is W_h's rows. So the carried product never leaves the
//   SM. W_x does not fit beside it: its forward packing (fragment order,
//   ops/rnn.py pack_fragments) serves the recompute and a packing of W_x^T
//   serves dhin, both read through L2. hin_t and h_{t-1} arrive in
//   [rows, H + 8] bf16 tiles by cp.async, double-buffered. Per step the
//   cell writes d_gates in f32 to device memory (the GRU also its h-side n
//   slice dn r) for kernel 2, and its hi and lo into [rows, 4 H + 8] bf16
//   tiles (LSTM: the G H gate columns; GRU: z, r, n of d_xw, then dn r),
//   which the warps read back as A fragments: the backward products need
//   all G H columns of a row. Two barriers per step.
// * Kernel 2, the weight gradients in one pass over d_gates. A block owns
//   64 gate columns and a slice of rows and computes dW_x, dW_h and db for
//   them: warps 0-3 dW_x (A = hin), warps 4-7 dW_h (A = h_{t-1}, the saved
//   h_all shifted, zero at each sequence's first step), each 32 output rows
//   by 64 columns. Per stage of 32 rows, hin and h_{t-1} arrive by
//   cp.async; d_gates (f32) is loaded into registers one stage ahead,
//   split into hi and lo and stored as bf16 tiles; ldmatrix.trans gives
//   both operands (A^T and D, stored row by row). db is summed in f32 from
//   the same registers. Each slice writes partial sums; kernel 3 adds the
//   slices in a fixed order. No atomics: the weight gradients are bitwise
//   the same from run to run.
// * Seeds (the JAX kernels' seed grid dimension, pallas_rnn.py _bwd_vmap
//   :951): the seed is blockIdx.y of kernel 1 and kernel 3 and blockIdx.z
//   of kernel 2. Each operand has its own seed stride (SeedStrides), 0 for
//   one shared by every seed; the saved states, dh and every output and
//   scratch array are per seed, partial [S, slices, total] and dw [S,
//   total]. The slices are per seed and summed in the same fixed order, so
//   a seed's gradients are bitwise those of a one-seed launch. Every
//   per-seed base offset is 64-bit: d_gates over 64 seeds at the c5 train
//   step is 4.0e9 f32 values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using namespace lfm_mma;

constexpr int kLstm = 0;
constexpr int kGru = 1;
constexpr int kUnits = 8;  // hidden units per warp of kernel 1
// Terms of the split of d_gates in the backward products (hi, lo).
constexpr int kSplit = 2;
// Kernel 1: 16-row tiles per block. One: with W_h and the split d_gates
// tiles, 32 rows of the LSTM at H = 128 do not fit in shared memory.
constexpr int kRowTiles = 1;
// Kernel 2: gate columns per block, rows per stage, threads.
constexpr int kWgCols = 64;
constexpr int kWgRows = 32;
constexpr int kWgThreads = 256;

// __frcp_rn is the correctly rounded reciprocal: the same value as
// 1.0f / x, without the division's slow path.
__device__ __forceinline__ float sigmoid(float v) {
  return __frcp_rn(1.0f + expf(-v));
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

// Seed strides of the operands that may be shared, in elements of each (W_x
// in bf16 elements of its packed forms, both packings alike); 0 for an
// operand shared by every seed.
struct SeedStrides {
  long long hin, wx, b, wh, m;
};

// Kernel 1's shared memory: W_h [H, G H + 8], the hin and h_{t-1} tiles
// (two each, [rows, H + 8]) and the kSplit d_gates tiles [rows, 4 H + 8],
// all bf16, and the bias [G H] f32.
inline size_t recur_smem_bytes(int G, int H) {
  const size_t rows = 16 * kRowTiles;
  return 2 * ((size_t)H * (G * H + 8) + 4 * (size_t)rows * (H + 8) +
              (size_t)kSplit * rows * (4 * H + 8)) +
         4 * (size_t)G * H;
}

// Kernel 2's: two stages of the A tiles [2][kWgRows][HP + 8] and the D
// tiles [ND][kSplit][kWgRows][kWgCols + 8], bf16 (HP: H rounded up to 32).
inline size_t wgrad_smem_bytes(int cell, int H) {
  const int HP = (H + 31) / 32 * 32;
  const int ND = cell == kGru ? 2 : 1;
  return 2 * 2 * ((size_t)2 * kWgRows * (HP + 8) +
                  (size_t)ND * kSplit * kWgRows * (kWgCols + 8));
}

// Kernel 1, per seed (blockIdx.y). hin, h_all, c_all (LSTM), dh [B, T, H]
// bf16; wxp: W_x packed in the forward's fragment order; wxtp: W_x^T packed
// ([G H / 16][H / 8][32][4], ops/rnn.py pack_fragments(transpose=True)); b
// [G H]; wh [H, G H] row-major; m uint8 [B, T]. Out: dhin [B, T, H] bf16;
// dgx (d_xw) [B, T, G H] f32; dhn (GRU: dn r) [B, T, H] f32.
template <int CELL>
__global__ void __launch_bounds__(128 * 32 / kUnits, 1)
rnn_bwd_mma_recur_kernel(const __nv_bfloat16* __restrict__ hin,
                         const uint2* __restrict__ wxp,
                         const uint2* __restrict__ wxtp,
                         const __nv_bfloat16* __restrict__ b,
                         const __nv_bfloat16* __restrict__ wh,
                         const uint8_t* __restrict__ m,
                         const __nv_bfloat16* __restrict__ h_all,
                         const __nv_bfloat16* __restrict__ c_all,
                         const __nv_bfloat16* __restrict__ dh,
                         __nv_bfloat16* __restrict__ dhin,
                         float* __restrict__ dgx, float* __restrict__ dhn,
                         int B, int Tn, int H, SeedStrides st,
                         float forget_bias) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int RT = kRowTiles;
  constexpr int BB = 16 * RT;  // rows per block
  const int GH = G * H;
  const int KT = H / 16;       // k-steps of the recomputed products
  const int KB = GH / 16;      // k-steps of the backward products
  const int S = H / kUnits;    // warps
  const int LD = H + 8;        // hin / h tile row stride, elements
  const int LW = GH + 8;       // W_h row stride
  const int LG = 4 * H + 8;    // d_gates tile row stride
  const int C8 = H / 8;        // 16-byte chunks per tile row

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* hin_s = wh_s + (size_t)H * LW;
  __nv_bfloat16* h_s = hin_s + 2 * BB * LD;
  __nv_bfloat16* dg_s = h_s + 2 * BB * LD;
  float* bias_s = reinterpret_cast<float*>(dg_s + kSplit * BB * LG);

  {
    const size_t seed = blockIdx.y;
    const size_t seq = (size_t)B * Tn * H;
    hin += seed * st.hin;
    wxp = reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(wxp) + seed * st.wx);
    wxtp = reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(wxtp) + seed * st.wx);
    b += seed * st.b;
    wh += seed * st.wh;
    m += seed * st.m;
    h_all += seed * seq;
    if (c_all != nullptr) c_all += seed * seq;
    dh += seed * seq;
    dhin += seed * seq;
    dgx += seed * seq * G;
    if (dhn != nullptr) dhn += seed * seq;
  }

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * BB;
  const int nr = min(BB, B - r0);

  // hin_t and h_{t-1} into tile pair `buf`; rows past B and h_{-1} are 0.
  auto load_tiles = [&](int t, int buf) {
    __nv_bfloat16* xd = hin_s + buf * BB * LD;
    __nv_bfloat16* hd = h_s + buf * BB * LD;
    for (int i = tid; i < BB * C8; i += nth) {
      const int r = i / C8;
      const int k = (i - r * C8) * 8;
      const bool in = r < nr;
      const bool hv = in && t > 0;
      const size_t row = (size_t)(r0 + r) * Tn + t;
      cp_async16(xd + r * LD + k, in ? hin + row * H + k : hin, in ? 16 : 0);
      cp_async16(hd + r * LD + k, hv ? h_all + (row - 1) * H + k : h_all,
                 hv ? 16 : 0);
    }
  };

  {
    const int CW = GH / 8;
    for (int i = tid; i < H * CW; i += nth) {
      const int k = i / CW;
      const int c = (i - k * CW) * 8;
      cp_async16(wh_s + (size_t)k * LW + c, wh + (size_t)k * GH + c, 16);
    }
  }
  load_tiles(Tn - 1, (Tn - 1) & 1);
  cp_async_commit();
  for (int i = tid; i < GH; i += nth) bias_s[i] = __bfloat162float(b[i]);

  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;  // A, ldmatrix
  const int acol = (lane >> 4) * 8;
  const int row_l = lane >> 2;        // + 16 rt + 8 half
  const int unit_l = 2 * (lane & 3);  // + u0 + e
  const int u0 = warp * kUnits;
  const int u = u0 + unit_l;
  const uint2* wx_w = wxp + (size_t)warp * G * 32 + lane;
  const uint2* wxt_w = wxtp + (size_t)warp * 32 + lane;
  // B of h @ W_h: W_h rows k (ldmatrix.trans); lanes 16-31 the next tile.
  const __nv_bfloat16* whf_l =
      wh_s + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * LW + u0;
  // B of d @ W_h^T: W_h rows u0 .. u0 + 7 (ldmatrix), k-offset 0 or 8.
  const __nv_bfloat16* whb_l =
      wh_s + (size_t)(u0 + (lane & 7)) * LW + ((lane >> 3) & 1) * 8;

  // Carries, [rt][half * 2 + e] as the accumulators: dh, and for the LSTM
  // dc and c_t (the next step's c_{t-1} is read one step ahead).
  float dhc[RT][4], dcc[RT][4], ccur[RT][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rt * 16 + row_l + 8 * half;
      float2 c = make_float2(0.0f, 0.0f);
      if (CELL == kLstm && r < nr)
        c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            c_all + ((size_t)(r0 + r) * Tn + Tn - 1) * H + u));
      ccur[rt][2 * half] = c.x;
      ccur[rt][2 * half + 1] = c.y;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dhc[rt][2 * half + e] = 0.0f;
        dcc[rt][2 * half + e] = 0.0f;
      }
    }

  for (int t = Tn - 1; t >= 0; --t) {
    const int cur = t & 1;
    cp_async_wait_all();
    // hin_t and h_{t-1} are in place; every warp is done with the last
    // step's d_gates tiles and with the other tile pair.
    __syncthreads();
    if (t > 0) load_tiles(t - 1, cur ^ 1);
    cp_async_commit();
    const __nv_bfloat16* xt = hin_s + cur * BB * LD;
    const __nv_bfloat16* ht = h_s + cur * BB * LD;

    // This step's elementwise inputs, loaded ahead of the products.
    bool keep[RT][2];
    float dup[RT][4], cprev[RT][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + row_l + 8 * half;
        const bool in = r < nr;
        const size_t row = (size_t)(r0 + r) * Tn + t;
        keep[rt][half] = in && m[row] != 0;
        float2 d = make_float2(0.0f, 0.0f), c = make_float2(0.0f, 0.0f);
        if (in) {
          d = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dh + row * H + u));
          if (CELL == kLstm && t > 0)
            c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                c_all + (row - 1) * H + u));
        }
        dup[rt][2 * half] = d.x;
        dup[rt][2 * half + 1] = d.y;
        cprev[rt][2 * half] = c.x;
        cprev[rt][2 * half + 1] = c.y;
      }

    // The gates, recomputed as the forward kernel does. Slots: the G
    // x-side gates with the bias; the GRU's slot 3 is the h side of n.
    float acc[RT][4][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[rt][q][i] = q < G ? bias_s[q * H + u + (i & 1)] : 0.0f;

    for (int kk = 0; kk < KT; ++kk) {
      uint2 bx[G], bh[G];
#pragma unroll
      for (int q = 0; q < G; ++q)
        bx[q] = __ldg(wx_w + (size_t)kk * S * G * 32 + q * 32);
      {
        const __nv_bfloat16* p = whf_l + (size_t)kk * 16 * LW;
        uint32_t r[4];
        ldmatrix_x4_trans(r, p + (lane >> 4) * H);
        bh[0] = make_uint2(r[0], r[1]);
        bh[1] = make_uint2(r[2], r[3]);
        if (G == 4) {
          ldmatrix_x4_trans(r, p + (2 + (lane >> 4)) * H);
          bh[2] = make_uint2(r[0], r[1]);
          bh[G - 1] = make_uint2(r[2], r[3]);
        } else {
          uint32_t r2[2];
          ldmatrix_x2_trans(r2, p + 2 * H);
          bh[2] = make_uint2(r2[0], r2[1]);
        }
      }
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        uint32_t a[4];
        ldmatrix_x4(a, ht + (rt * 16 + arow) * LD + kk * 16 + acol);
#pragma unroll
        for (int q = 0; q < G; ++q)
          mma_bf16(acc[rt][CELL == kGru && q == 2 ? 3 : q], a, bh[q]);
        ldmatrix_x4(a, xt + (rt * 16 + arow) * LD + kk * 16 + acol);
#pragma unroll
        for (int q = 0; q < G; ++q) mma_bf16(acc[rt][q], a, bx[q]);
      }
    }

    // The cell's backward, in registers: d_gates to device memory (f32)
    // and, split, to the tiles; the elementwise parts of the carries.
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + row_l + 8 * half;
        const size_t row = (size_t)(r0 + r) * Tn + t;
        const float kp = keep[rt][half] ? 1.0f : 0.0f;
        float dg[4][2];  // [gate column block][e]; GRU: 3 = dn r
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * half + e;
          const float dh_t = dup[rt][i] + dhc[rt][i];
          const float dh_new = kp * dh_t;
          if (CELL == kLstm) {
            const float ig = sigmoid(acc[rt][0][i]);
            const float fg = sigmoid(acc[rt][1][i] + forget_bias);
            const float gg = tanhf(acc[rt][2][i]);
            const float og = sigmoid(acc[rt][3][i]);
            const float dc_t = dcc[rt][i];
            const float dc_new = kp * dc_t;
            const float tc = tanhf(ccur[rt][i]);
            const float do_ = dh_new * tc;
            const float dc_tot = dc_new + dh_new * og * (1.0f - tc * tc);
            dg[0][e] = (dc_tot * gg) * ig * (1.0f - ig);
            dg[1][e] = (dc_tot * cprev[rt][i]) * fg * (1.0f - fg);
            dg[2][e] = (dc_tot * ig) * (1.0f - gg * gg);
            dg[3][e] = do_ * og * (1.0f - og);
            dhc[rt][i] = (1.0f - kp) * dh_t;
            dcc[rt][i] = (1.0f - kp) * dc_t + dc_tot * fg;
            ccur[rt][i] = cprev[rt][i];
          } else {
            const float h_prev = __bfloat162float(ht[r * LD + u + e]);
            const float z = sigmoid(acc[rt][0][i]);
            const float rg = sigmoid(acc[rt][1][i]);
            const float hn = acc[rt][3][i];
            const float n = tanhf(acc[rt][2][i] + rg * hn);
            const float dz = dh_new * (h_prev - n);
            const float dn_raw = dh_new * (1.0f - z) * (1.0f - n * n);
            const float dr = dn_raw * hn;
            dg[0][e] = dz * z * (1.0f - z);
            dg[1][e] = dr * rg * (1.0f - rg);
            dg[2][e] = dn_raw;
            dg[3][e] = dn_raw * rg;
            dhc[rt][i] = (1.0f - kp) * dh_t + dh_new * z;
          }
        }
        if (r < nr) {
#pragma unroll
          for (int q = 0; q < G; ++q)
            *reinterpret_cast<float2*>(dgx + row * GH + q * H + u) =
                make_float2(dg[q][0], dg[q][1]);
          if (CELL == kGru)
            *reinterpret_cast<float2*>(dhn + row * H + u) =
                make_float2(dg[3][0], dg[3][1]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          __nv_bfloat162 hi, lo;
          split_bf16(dg[q][0], dg[q][1], hi, lo);
          __nv_bfloat16* d = dg_s + r * LG + q * H + u;
          *reinterpret_cast<__nv_bfloat162*>(d) = hi;
          if (kSplit == 2)
            *reinterpret_cast<__nv_bfloat162*>(d + BB * LG) = lo;
        }
      }
    __syncthreads();  // the d_gates tiles are complete

    // The backward products over K = G H: dh += d_hw @ W_h^T (W_h from
    // shared memory) and dhin = d_xw @ W_x^T (packed, through L2), one
    // accumulator per split term so that the serial mma chains are half
    // as long; dh's hi term starts from the carry's elementwise part.
    float hacc[kSplit][RT][4], xacc[kSplit][RT][4];
#pragma unroll
    for (int p = 0; p < kSplit; ++p)
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hacc[p][rt][i] = p == 0 ? dhc[rt][i] : 0.0f;
          xacc[p][rt][i] = 0.0f;
        }
    for (int ks = 0; ks < KB; ++ks) {
      const int k0 = ks * 16;
      uint32_t r2[2];
      ldmatrix_x2(r2, whb_l + k0);
      const uint2 bhk = make_uint2(r2[0], r2[1]);
      const uint2 bxk = __ldg(wxt_w + (size_t)ks * S * 32);
      // The GRU's h side reads dn r (tile columns 3H ..) for gate n.
      const bool hsplit = CELL == kGru && k0 >= 2 * H;
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int p = 0; p < kSplit; ++p) {
          const __nv_bfloat16* ab =
              dg_s + p * BB * LG + (rt * 16 + arow) * LG + acol;
          uint32_t a[4];
          ldmatrix_x4(a, ab + k0);
          mma_bf16(xacc[p][rt], a, bxk);
          if (hsplit) ldmatrix_x4(a, ab + k0 + H);
          mma_bf16(hacc[p][rt], a, bhk);
        }
    }
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int p = 1; p < kSplit; ++p) {
          hacc[0][rt][i] += hacc[p][rt][i];
          xacc[0][rt][i] += xacc[p][rt][i];
        }
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + row_l + 8 * half;
        dhc[rt][2 * half] = hacc[0][rt][2 * half];
        dhc[rt][2 * half + 1] = hacc[0][rt][2 * half + 1];
        if (r < nr)
          *reinterpret_cast<__nv_bfloat162*>(
              dhin + ((size_t)(r0 + r) * Tn + t) * H + u) =
              __floats2bfloat162_rn(xacc[0][rt][2 * half],
                                    xacc[0][rt][2 * half + 1]);
      }
  }
}

// Kernel 2: per seed (blockIdx.z) and row slice s, partial[seed][s] =
// [dW_x [H, G H], db [G H], dW_h [H, G H]] over the rows m_lo .. m_hi - 1
// of the seed's B * T, for the 64 gate columns j0 .. j0 + 63 of this
// block. A = hin [M, H] (seed stride s_hin) and h_all [M, H]
// (read shifted: row m takes m - 1 within its sequence of Tn rows, zero at
// the first step); dgx = d_xw [M, G H] f32; dhn (GRU) the n slice of d_hw
// [M, H] f32 (the LSTM's d_hw is d_xw).
template <int CELL>
__global__ void __launch_bounds__(kWgThreads, 2)
rnn_bwd_mma_wgrad_kernel(const __nv_bfloat16* __restrict__ hin,
                         const __nv_bfloat16* __restrict__ h_all,
                         const float* __restrict__ dgx,
                         const float* __restrict__ dhn, int M, int Tn, int H,
                         int rows_per_slice, long long s_hin,
                         float* __restrict__ partial) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int ND = CELL == kGru ? 2 : 1;  // D tiles: d_xw (, d_hw)
  constexpr int LDD = kWgCols + 8;
  constexpr int kLoads = kWgRows * kWgCols / 4 / kWgThreads;  // float4 each
  const int GH = G * H;
  const int HP = (H + 31) / 32 * 32;
  const int LA = HP + 8;
  const int CA = HP / 8;  // 16-byte chunks per A row
  const int a_elems = 2 * kWgRows * LA;
  const int stage_elems = a_elems + ND * kSplit * kWgRows * LDD;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);

  {
    const size_t seed = blockIdx.z;
    hin += seed * s_hin;
    h_all += seed * M * (size_t)H;
    dgx += seed * M * (size_t)GH;
    if (dhn != nullptr) dhn += seed * M * (size_t)H;
    partial += (seed * gridDim.y) * (size_t)(2 * H * GH + GH);
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = blockIdx.x * kWgCols;
  const int s = blockIdx.y;
  const int m_lo = min(M, s * rows_per_slice);
  const int m_hi = min(M, m_lo + rows_per_slice);
  const int prod = warp >> 2;       // 0: dW_x (hin, d_xw); 1: dW_h
  const int ko = (warp & 3) * 32;   // the warp's first output row
  const bool active = ko < H;

  // The thread's 4 columns of d_gates and its rows dr, dr + 16 of a stage.
  const int dc = (tid & 15) * 4;
  const int dr = tid >> 4;
  const int j = j0 + dc;
  const bool jin = j < GH;
  const bool nside = CELL == kGru && j >= 2 * H;  // d_hw's n slice: dn r

  auto load_a = [&](int mb, __nv_bfloat16* dst) {
    for (int i = tid; i < 2 * kWgRows * CA; i += kWgThreads) {
      const int p = i / (kWgRows * CA);
      const int rem = i - p * kWgRows * CA;
      const int mm = rem / CA;
      const int k = (rem - mm * CA) * 8;
      const int mrow = mb + mm;
      bool ok = mrow < m_hi && k < H;
      const __nv_bfloat16* src = hin;
      if (p == 0) {
        if (ok) src = hin + (size_t)mrow * H + k;
      } else {
        ok = ok && mrow % Tn != 0;
        if (ok) src = h_all + (size_t)(mrow - 1) * H + k;
      }
      cp_async16(dst + (p * kWgRows + mm) * LA + k, src, ok ? 16 : 0);
    }
  };

  float4 dx[kLoads], dhv[kLoads];
  auto fetch_d = [&](int mb) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int mrow = mb + dr + 16 * q;
      const bool ok = jin && mrow < m_hi;
      dx[q] = ok ? *reinterpret_cast<const float4*>(dgx + (size_t)mrow * GH + j)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ND == 2)
        dhv[q] = ok && nside ? *reinterpret_cast<const float4*>(
                                   dhn + (size_t)mrow * H + j - 2 * H)
                             : dx[q];
    }
  };

  // db from the f32 values (fixed order: stage by stage, q by q), then
  // the split into the stage's D tiles.
  float dbs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto store_d = [&](__nv_bfloat16* stage) {
    __nv_bfloat16* dt = stage + a_elems;
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      dbs[0] += dx[q].x;
      dbs[1] += dx[q].y;
      dbs[2] += dx[q].z;
      dbs[3] += dx[q].w;
      const int off = (dr + 16 * q) * LDD + dc;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const float4 v = d == 0 ? dx[q] : dhv[q];
        __nv_bfloat162 h01, l01, h23, l23;
        split_bf16(v.x, v.y, h01, l01);
        split_bf16(v.z, v.w, h23, l23);
        __nv_bfloat16* t = dt + d * kSplit * kWgRows * LDD + off;
        *reinterpret_cast<uint2*>(t) = make_uint2(as_u32(h01), as_u32(h23));
        if (kSplit == 2)
          *reinterpret_cast<uint2*>(t + kWgRows * LDD) =
              make_uint2(as_u32(l01), as_u32(l23));
      }
    }
  };

  // ldmatrix.trans addresses: A^T fragments (output rows x stage rows)
  // and D fragments (stage rows x two n8 column tiles).
  const int ta_row = (lane & 7) + (lane >> 4) * 8;
  const int ta_col = ((lane >> 3) & 1) * 8;
  const int tb_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int tb_col = (lane >> 4) * 8;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
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
      const __nv_bfloat16* A = cur + prod * kWgRows * LA + ko;
      const __nv_bfloat16* D =
          cur + a_elems + (ND == 2 ? prod : 0) * kSplit * kWgRows * LDD;
#pragma unroll
      for (int kk = 0; kk < kWgRows / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
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
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(acc[mt][2 * n2], a[mt], make_uint2(bq[0], bq[1]));
              mma_bf16(acc[mt][2 * n2 + 1], a[mt], make_uint2(bq[2], bq[3]));
            }
          }
      }
    }
    if (more) store_d(nxt);
  }

  const size_t hg = (size_t)H * GH;
  float* out = partial + (size_t)s * (2 * hg + GH);
  if (active) {
    float* o = out + (prod == 0 ? 0 : hg + GH);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = ko + mt * 16 + (lane >> 2) + 8 * half;
          const int jj = j0 + nt * 8 + 2 * (lane & 3);
          if (k < H && jj < GH)
            *reinterpret_cast<float2*>(o + (size_t)k * GH + jj) = make_float2(
                acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
  }
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

// Kernel 3, per seed (blockIdx.y): out[seed][i] = sum_{s = 0 .. S-1}
// partial[seed][s][i], in that order.
__global__ void rnn_bwd_mma_slices_kernel(const float* __restrict__ partial,
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

template <int CELL>
cudaError_t launch(const void* hin, const void* wxp, const void* wxtp,
                   const void* b, const void* wh, const void* m,
                   const void* h_all, const void* c_all, const void* dh,
                   void* dhin, void* dgx, void* dhn, void* partial, int S,
                   void* dw, int seeds, int B, int Tn, int H, SeedStrides st,
                   float forget_bias, cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int rows = 16 * kRowTiles;
  const int GH = G * H;
  const size_t smem1 = recur_smem_bytes(G, H);
  auto recur = rnn_bwd_mma_recur_kernel<CELL>;
  cudaError_t err = cudaFuncSetAttribute(
      recur, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  recur<<<dim3((B + rows - 1) / rows, seeds), (H / kUnits) * 32, smem1,
          stream>>>(
      static_cast<const __nv_bfloat16*>(hin), static_cast<const uint2*>(wxp),
      static_cast<const uint2*>(wxtp), static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(wh), static_cast<const uint8_t*>(m),
      static_cast<const __nv_bfloat16*>(h_all),
      static_cast<const __nv_bfloat16*>(c_all),
      static_cast<const __nv_bfloat16*>(dh),
      static_cast<__nv_bfloat16*>(dhin), static_cast<float*>(dgx),
      static_cast<float*>(dhn), B, Tn, H, st, forget_bias);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int M = B * Tn;
  const size_t smem2 = wgrad_smem_bytes(CELL, H);
  auto wgrad = rnn_bwd_mma_wgrad_kernel<CELL>;
  err = cudaFuncSetAttribute(
      wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;
  wgrad<<<dim3((GH + kWgCols - 1) / kWgCols, S, seeds), kWgThreads, smem2,
          stream>>>(static_cast<const __nv_bfloat16*>(hin),
                    static_cast<const __nv_bfloat16*>(h_all),
                    static_cast<const float*>(dgx),
                    static_cast<const float*>(dhn), M, Tn, H, (M + S - 1) / S,
                    st.hin, static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = 2 * H * GH + GH;
  rnn_bwd_mma_slices_kernel<<<dim3((total + 255) / 256, seeds), 256, 0,
                              stream>>>(
      static_cast<const float*>(partial), S, total, static_cast<float*>(dw));
  return cudaGetLastError();
}

// The widths the kernels take: 16 <= H <= 128, H % 16 == 0.
bool supported(int H) { return H >= 16 && H <= 128 && H % 16 == 0; }

}  // namespace

// Shared memory of the larger of the launches (kernel 1's), in bytes; -1
// for a shape the kernels do not take. cell: 0 = LSTM, 1 = GRU.
extern "C" long long lfm_rnn_fused_bwd_mma_smem(int cell, int H) {
  if (!supported(H)) return -1;
  const size_t r = recur_smem_bytes(cell == kLstm ? 4 : 3, H);
  const size_t w = wgrad_smem_bytes(cell, H);
  return (long long)(r > w ? r : w);
}

// The fused backward in bfloat16 on the tensor cores, for `seeds` seeds in
// one call. Per seed: hin, h_all, c_all (LSTM; the GRU passes null), dh,
// dhin [B, T, H] bf16; wxp and wxtp: W_x packed for the forward and W_x^T
// for dhin (ops/rnn.py pack_fragments); b [G H], wh [H, G H] bf16; m uint8
// [B, T]. s_*: the seed strides of hin, W_x (both packings), b, wh and m
// in their elements (0: shared by every seed); h_all, c_all, dh and dhin
// are [seeds, B, T, H]. Scratch the caller allocates: dgx [seeds, B, T,
// G H] f32, dhn [seeds, B, T, H] f32 (GRU), partial [seeds, S, 2 H G H +
// G H] f32. Output dw [seeds, 2 H G H + G H] f32: dW_x, db, dW_h. Returns
// the first CUDA error of its three launches.
extern "C" int lfm_rnn_fused_bwd_mma(int cell, const void* hin,
                                     const void* wxp, const void* wxtp,
                                     const void* b, const void* wh,
                                     const void* m, const void* h_all,
                                     const void* c_all, const void* dh,
                                     void* dhin, void* dgx, void* dhn,
                                     void* partial, int S, void* dw,
                                     int seeds, int B, int Tn, int H,
                                     long long s_hin, long long s_wx,
                                     long long s_b, long long s_wh,
                                     long long s_m, float forget_bias,
                                     void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (seeds <= 0 || seeds > 65535 || B <= 0 || Tn <= 0 || S <= 0 ||
      S > 65535 || !supported(H))
    return (int)cudaErrorInvalidValue;
  const SeedStrides st{s_hin, s_wx, s_b, s_wh, s_m};
  if (cell == kLstm)
    return (int)launch<kLstm>(hin, wxp, wxtp, b, wh, m, h_all, c_all, dh,
                              dhin, dgx, dhn, partial, S, dw, seeds, B, Tn, H,
                              st, forget_bias, cs);
  if (cell == kGru)
    return (int)launch<kGru>(hin, wxp, wxtp, b, wh, m, h_all, c_all, dh,
                             dhin, dgx, dhn, partial, S, dw, seeds, B, Tn, H,
                             st, forget_bias, cs);
  return (int)cudaErrorInvalidValue;
}
