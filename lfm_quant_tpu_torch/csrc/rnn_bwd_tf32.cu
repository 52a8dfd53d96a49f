// Masked LSTM/GRU recurrence, fused and hoisted backward, in float32 on
// Hopper's tensor cores: 3xTF32 products (mma.sync m16n8k8 .tf32, f32
// accumulation), with W_h split across a thread-block cluster at H = 128
// (2 CTAs) and above (2 or 4 CTAs).
//
// Replaces, in float32 with 16 <= Hp <= 176 (Hp the width padded to a
// multiple of 16; ops/rnn.py _mma_route "tf32"; past it the grid,
// csrc/rnn_bwd_tf32_grid.cu, ran faster on an H100), the Pallas TPU
// kernels
// _lstm_fused_bwd_kernel (lfm_quant_tpu/ops/pallas_rnn.py:673) and
// _gru_fused_bwd_kernel (:739), reached through _fused_bwd_call (:835), and
// _lstm_bwd_kernel (:184) and _gru_bwd_kernel (:243), reached through
// _bwd_call (:407), with their seed rules (_bwd_vmap :951,
// _make_scan._bwd_vmap :541). It computes what csrc/rnn_bwd.cu computes in
// float32 (the formulas are written out there).
//
// Numerics: 3xTF32, as csrc/tf32_common.cuh sets out (the split, the
// fragments, the GEMM and the cluster barriers live there, shared with
// csrc/rnn_fwd_tf32.cu). No accumulator takes more than 64 of k before its
// sum is added to an f32 register (the recurrence's products: kChainK; the
// weight gradients and the GEMM: one stage). The cell's arithmetic is f32
// with the accurate expf/tanhf and the rounding points of csrc/rnn_bwd.cu
// (the header's cell_bwd, shared by both recurrence kernels here and by
// csrc/rnn_bwd_tf32_grid.cu, which also takes kernels 2 and 3 from it).
//
// Bound. At the c2 train step (B 2048, T 60, H 128, LSTM, f32) the fused
// function is 6 products of 2 H G H per row and step: 9.7e10 operations,
// 1.44 ms at 67 TFLOP/s outside the tensor cores and 0.585 ms at the 3xTF32
// rate (495 / 3 TFLOP/s), against 0.3 GB of inputs and outputs; the hoisted
// form does 3 of the 6 (0.72 and 0.29 ms). Bound by operations either way,
// and more so above 128 (at H 176: 1.1 ms fused at the 3xTF32 rate).
//
// Design: the fused form is GEMM + the hoisted recurrence + GEMM.
//
// * Kernel 0 (fused form), a 3xTF32 GEMM: xw = hin @ W_x + b in f32 into the
//   d_gates buffer, which kernel 1 then overwrites in place: each thread
//   reads its xw_t a step ahead and writes d_xw_t at the same addresses.
// * Kernel 1, the hoisted reverse recurrence, in one of two forms.
//   At H <= 128 (rnn_bwd_tf32_recur_kernel): a cluster of C CTAs (C = 2
//   at H = 128 in both cells; C = 1 where W_h fits beside the tiles) owns
//   kRowTiles x 16 rows for all T steps. CTA j owns the hidden units [j
//   H/C, (j + 1) H/C) with all G gates, and holds their W_h columns once in
//   shared memory, f32, row-major [H, G H/C + 4] (133 KB for the LSTM at
//   H = 128): warp w owns 8 of them, so the gate sums, the cell's backward
//   and the dh, dc carries of a (row, unit) sit in one thread's registers.
//   Per step: the recompute xw_t + h_{t-1} @ W_h[:, own] (h_{t-1} for all H
//   units from the saved h_all, double-buffered by cp.async; xw_t loaded
//   into registers a step ahead); the cell writes d_xw_t (f32; the GRU
//   also its h-side n slice dn r) to device memory and d_hw into a shared
//   tile;
//   the carry's product d_hw @ W_h^T over the CTA's own columns gives a
//   partial [rows, H]; each CTA stores the peer's units of it into the
//   peer's shared memory (distributed shared memory, double-buffered, one
//   cluster barrier per step) and adds what it received, rank 0's partial
//   first, so the sums are bitwise repeatable. Fragments are read with
//   32-bit shared loads; the recompute's k order within an 8-step is
//   permuted (lane c takes k = 2c, 2c + 1: one 64-bit load of h) so that
//   one padding of W_h (4 floats) serves both products without bank
//   conflicts.
//   Above 128 (rnn_bwd_tf32_cluster_kernel, up to Hp 176): W_h, 16 Hp^2
//   bytes for the LSTM (0.5 MB at 176), is split over a cluster of 2 or 4
//   CTAs (ops/rnn.py _tf32_cluster: the fewest that fit) owning 16 or 32
//   rows (RT 16-row tiles a warp). The Hp / 8 warps of units are dealt out
//   as the bf16 cluster kernels deal them (ops/rnn.py _cluster_units): CTA
//   j owns warps [j W / C, (j + 1) W / C), NW = ceil(W / C) or one fewer,
//   and holds those units' W_h columns as above, [Hp, G U + 4] with U = 8
//   NW (column q U + i is gate q of local unit i). The recompute and the
//   cell are the H <= 128 kernel's. The carry's product is
//   reduce-scattered as csrc/rnn_bwd_cluster.cu does it: warp w makes the
//   output chunks (8 units each) w, w + NW, .. over the CTA's own columns
//   and stores each into the owning CTA's single receive buffer [C][rows]
//   [LR] f32 at the slot of its own rank; each owner adds its units' C
//   partials in rank order, rank 0 first (bitwise repeatable). While the
//   partials travel the CTA recomputes the next step's gates, which do not
//   need the carry. One h tile is loaded during the carry's product.
// * Kernel 2, the weight gradients: a block owns one product (dW_x = hin^T
//   d_xw with db = sum d_xw, or dW_h = h_{t-1}^T d_hw), 64 gate columns,
//   128 output rows (a grid axis tiles H past 128) and a slice of rows;
//   per-slice partial sums, and kernel 3 adds the slices in a fixed order.
//   No atomics.
// * Kernel 4 (fused form), the GEMM of kernel 0: dhin = d_xw @ W_x^T.
// * Seeds (pallas_rnn.py _bwd_vmap :951): the seed is blockIdx.y of kernels
//   1 and 3 and blockIdx.z of kernels 0, 2 and 4; each shared operand has
//   its own seed stride (0: shared), every per-seed offset is 64-bit, and a
//   seed's outputs are bitwise those of a one-seed launch.
// * Clusters go through cudaLaunchKernelEx; a cluster the card cannot hold
//   (cudaOccupancyMaxActiveClusters 0) is refused, never run another way.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"
#include "tf32_common.cuh"

namespace cg = cooperative_groups;

namespace {

using lfm_mma::cp_async16;
using lfm_mma::cp_async_commit;
using lfm_mma::cp_async_wait_all;
using lfm_tf32::cell_bwd;
using lfm_tf32::cluster_arrive;
using lfm_tf32::cluster_wait;
using lfm_tf32::frag_a;
using lfm_tf32::frag_b;
using lfm_tf32::FragA;
using lfm_tf32::FragB;
using lfm_tf32::kChainK;
using lfm_tf32::kGru;
using lfm_tf32::kLstm;
using lfm_tf32::kWgCols;
using lfm_tf32::kWgOut;
using lfm_tf32::kWgThreads;
using lfm_tf32::launch_gemm;
using lfm_tf32::mma3;
using lfm_tf32::rnn_bwd_tf32_slices_kernel;
using lfm_tf32::rnn_bwd_tf32_wgrad_kernel;
using lfm_tf32::SeedStrides;
using lfm_tf32::sigmoid;
using lfm_tf32::wgrad_smem_bytes;

constexpr int kUnits = 8;     // hidden units per warp of kernel 1
constexpr int kRowTiles = 2;  // 16-row tiles per CTA of kernel 1 at H <= 128
// Kernel 1 above 128: the widest Hp, the largest cluster, and the output
// chunks a warp holds in registers per pass of the carry's product (4 beat
// 2 by 2-12% at 32 rows and 8 lost to 4 by 11-58% at 16 rows:
// scripts/torch_cluster_variants.py --direction bwd_tf32, chunk_regs_8).
constexpr int kMaxWidth = 176;
constexpr int kMaxCluster = 4;
constexpr int kChunks = 4;

// Kernel 1's threads per CTA at most above 128, by 16-row tiles: the
// registers of the recompute's sums, xw_t, the carries and the carry
// product's chunks.
__host__ __device__ constexpr int max_threads(int rt) {
  return rt == 1 ? 384 : 256;
}

// Above 128: warps per CTA (ceil(W / C) of the W = H / 8) and the receive
// buffer's row stride in floats (8 NW rounded up to an odd multiple of 8,
// so eight rows of float2 pairs fall in distinct banks).
inline int warps_per_cta(int H, int C) {
  return (H / kUnits + C - 1) / C;
}
inline int recv_ld(int H, int C) { return kUnits * (warps_per_cta(H, C) | 1); }

// Kernel 1's shared memory, f32. At H <= 128 (rows 32): W_h's own columns
// [H, G H/C + 4], two h_{t-1} tiles [rows, H + 8], the d_hw tile [rows,
// G H/C + 4] and (C > 1) two receive buffers [rows, H/C + 8]. Above 128:
// the share [H, G U + 4] (U = 8 NW), one h tile [rows, H + 8], the d_hw
// tile [rows, G U + 4] and the receive buffer [C][rows][LR]. ops/rnn.py
// _tf32_smem mirrors it.
inline size_t recur_smem_bytes(int G, int H, int C, int rows) {
  if (H <= 128) {
    const size_t Hc = H / C, GHc = G * Hc;
    return 4 * ((size_t)H * (GHc + 4) + 2 * (size_t)rows * (H + 8) +
                rows * (GHc + 4) + (C > 1 ? 2 * rows * (Hc + 8) : 0));
  }
  const size_t LW = (size_t)G * kUnits * warps_per_cta(H, C) + 4;
  return 4 * ((size_t)H * LW + (size_t)rows * (H + 8) + (size_t)rows * LW +
              (size_t)C * rows * recv_ld(H, C));
}



// Kernel 1, per seed (blockIdx.y), CTA rank j of a cluster of C along x.
// xw [B, T, G H] f32, the gates' x side with the bias (fused form: the
// d_gates buffer itself, overwritten in place); wh [H, G H]; m uint8 [B,
// T]; h_all, c_all (LSTM), dh [B, T, H] f32. Out: dgx = d_xw [B, T, G H]
// f32 (the hoisted form's dxw); dhn (GRU) = dn r [B, T, H] f32. xw and dgx
// may alias: no __restrict__ on them.
template <int CELL, int C>
__global__ void __launch_bounds__(C == 1 ? 448 : 256, 1)
rnn_bwd_tf32_recur_kernel(const float* xw, const float* __restrict__ wh,
                          const uint8_t* __restrict__ m,
                          const float* __restrict__ h_all,
                          const float* __restrict__ c_all,
                          const float* __restrict__ dh, float* dgx,
                          float* __restrict__ dhn, int B, int Tn, int H,
                          SeedStrides st, float forget_bias) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int RT = kRowTiles;
  constexpr int BB = 16 * RT;  // rows per CTA
  const int GH = G * H;
  const int Hc = H / C;        // units per CTA
  const int GHc = G * Hc;      // own W_h columns
  const int LW = GHc + 4;      // W_h row stride
  const int LD = H + 8;        // h tile row stride
  const int LG = GHc + 4;      // d_hw tile row stride
  const int LR = Hc + 8;       // receive buffer row stride

  extern __shared__ __align__(16) float smem[];
  float* wh_s = smem;
  float* h_s = wh_s + (size_t)H * LW;
  float* dg_s = h_s + 2 * BB * LD;
  float* recv_s = dg_s + BB * LG;  // C > 1

  {
    const size_t seed = blockIdx.y;
    const size_t seq = (size_t)B * Tn * H;
    xw += seed * st.xw;
    wh += seed * st.wh;
    m += seed * st.m;
    h_all += seed * seq;
    if (c_all != nullptr) c_all += seed * seq;
    dh += seed * seq;
    dgx += seed * seq * G;
    if (dhn != nullptr) dhn += seed * seq;
  }

  int rank = 0;
  if constexpr (C > 1) rank = (int)cg::this_cluster().block_rank();
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int r0 = (blockIdx.x / C) * BB;
  const int nr = min(BB, B - r0);
  const int ul = warp * kUnits + 2 * c4;  // local unit (+ e)
  const int u = rank * Hc + ul;           // unit of the states and W_h rows

  // W_h's columns of this CTA's units, every gate: wh_s[k][q Hc + i] =
  // W_h[k][q H + j Hc + i].
  {
    const int CW = Hc / 4;
    for (int i = tid; i < H * G * CW; i += nth) {
      const int k = i / (G * CW);
      const int rem = i - k * G * CW;
      const int q = rem / CW;
      const int j = (rem - q * CW) * 4;
      cp_async16(wh_s + (size_t)k * LW + q * Hc + j,
                 wh + (size_t)k * GH + q * H + rank * Hc + j, 16);
    }
  }
  // h_{t-1} for every unit into tile `buf`; rows past B and h_{-1} are 0.
  auto load_h = [&](int t, int buf) {
    float* hd = h_s + buf * BB * LD;
    const int CH = H / 4;
    for (int i = tid; i < BB * CH; i += nth) {
      const int r = i / CH;
      const int k = (i - r * CH) * 4;
      const bool hv = r < nr && t > 0;
      cp_async16(hd + r * LD + k,
                 hv ? h_all + ((size_t)(r0 + r) * Tn + t - 1) * H + k : h_all,
                 hv ? 16 : 0);
    }
  };
  load_h(Tn - 1, (Tn - 1) & 1);
  cp_async_commit();
  // Every CTA of the cluster runs before any stores into another's memory.
  if constexpr (C > 1) cluster_arrive();

  // Carries, [rt][half * 2 + e] as the accumulators: dh, and for the LSTM
  // dc and c_t (the next step's c_{t-1} is read one step ahead).
  float dhc[RT][4], dcc[RT][4], ccur[RT][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rt * 16 + g + 8 * half;
      float2 c = make_float2(0.0f, 0.0f);
      if (CELL == kLstm && r < nr)
        c = *reinterpret_cast<const float2*>(
            c_all + ((size_t)(r0 + r) * Tn + Tn - 1) * H + u);
      ccur[rt][2 * half] = c.x;
      ccur[rt][2 * half + 1] = c.y;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dhc[rt][2 * half + e] = 0.0f;
        dcc[rt][2 * half + e] = 0.0f;
      }
    }

  // The thread's xw pairs (row, gate q, units u, u + 1), a step ahead.
  float2 xwn[RT][2][G];
  auto load_xw = [&](int t) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + g + 8 * half;
        const size_t row = (size_t)(r0 + r) * Tn + t;
#pragma unroll
        for (int q = 0; q < G; ++q)
          xwn[rt][half][q] =
              r < nr ? *reinterpret_cast<const float2*>(xw + row * GH +
                                                        q * H + u)
                     : make_float2(0.0f, 0.0f);
      }
  };
  load_xw(Tn - 1);
  if constexpr (C > 1) cluster_wait();

  for (int t = Tn - 1; t >= 0; --t) {
    const int cur = t & 1;
    cp_async_wait_all();
    // h_{t-1} is in place; every warp is done with the other tile.
    __syncthreads();
    if (t > 0) load_h(t - 1, cur ^ 1);
    cp_async_commit();
    const float* ht = h_s + cur * BB * LD;

    // This step's elementwise inputs, loaded ahead of the products.
    bool keep[RT][2];
    float dup[RT][4], cprev[RT][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + g + 8 * half;
        const bool in = r < nr;
        const size_t row = (size_t)(r0 + r) * Tn + t;
        keep[rt][half] = in && m[row] != 0;
        float2 d = make_float2(0.0f, 0.0f), c = make_float2(0.0f, 0.0f);
        if (in) {
          d = *reinterpret_cast<const float2*>(dh + row * H + u);
          if (CELL == kLstm && t > 0)
            c = *reinterpret_cast<const float2*>(c_all + (row - 1) * H + u);
        }
        dup[rt][2 * half] = d.x;
        dup[rt][2 * half + 1] = d.y;
        cprev[rt][2 * half] = c.x;
        cprev[rt][2 * half + 1] = c.y;
      }

    // The h side of the gates: h_{t-1} @ W_h[:, own], lane c taking k0 + 2c
    // and k0 + 2c + 1 of each 8-step in both operands.
    float acc[RT][G][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[rt][q][i] = 0.0f;
    for (int kc = 0; kc < H; kc += kChainK) {
      float cacc[RT][G][4];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) cacc[rt][q][i] = 0.0f;
      for (int k0 = kc; k0 < min(H, kc + kChainK); k0 += 8) {
        FragB bw[G];
        const float* wp =
            wh_s + (size_t)(k0 + 2 * c4) * LW + warp * kUnits + g;
#pragma unroll
        for (int q = 0; q < G; ++q)
          frag_b(bw[q], wp[q * Hc], wp[q * Hc + LW]);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          const float* hp = ht + (rt * 16 + g) * LD + k0 + 2 * c4;
          const float2 x0 = *reinterpret_cast<const float2*>(hp);
          const float2 x1 = *reinterpret_cast<const float2*>(hp + 8 * LD);
          FragA a;
          frag_a(a, x0.x, x1.x, x0.y, x1.y);
#pragma unroll
          for (int q = 0; q < G; ++q) mma3(cacc[rt][q], a, bw[q]);
        }
      }
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[rt][q][i] += cacc[rt][q][i];
    }

    // The cell's backward, in registers: d_xw (and the GRU's dn r) to
    // device memory, d_hw to the shared tile; the carries' elementwise part.
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + g + 8 * half;
        const size_t row = (size_t)(r0 + r) * Tn + t;
        const float kp = keep[rt][half] ? 1.0f : 0.0f;
        float dg[4][2];  // [gate][e]; GRU: 3 = dn r
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * half + e;
          float xq[G];
#pragma unroll
          for (int q = 0; q < G; ++q)
            xq[q] = e ? xwn[rt][half][q].y : xwn[rt][half][q].x;
          // The x side added after the h side (the plain order).
          const float a[4] = {
              xq[0] + acc[rt][0][i], xq[1] + acc[rt][1][i],
              CELL == kLstm ? xq[2] + acc[rt][2][i] : xq[2],
              CELL == kLstm ? xq[G - 1] + acc[rt][G - 1][i] : acc[rt][2][i]};
          float d[4];
          cell_bwd<CELL>(a, dup[rt][i], kp, ccur[rt][i], cprev[rt][i],
                         CELL == kGru ? ht[r * LD + u + e] : 0.0f,
                         forget_bias, dhc[rt][i], dcc[rt][i], d);
#pragma unroll
          for (int q = 0; q < 4; ++q) dg[q][e] = d[q];
          if (CELL == kLstm) ccur[rt][i] = cprev[rt][i];
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
        for (int q = 0; q < G; ++q) {
          const int qh = CELL == kGru && q == 2 ? 3 : q;
          *reinterpret_cast<float2*>(dg_s + r * LG + q * Hc + ul) =
              make_float2(dg[qh][0], dg[qh][1]);
        }
      }
    if (t > 0) load_xw(t - 1);
    __syncthreads();  // the d_hw tile is complete

    // The carry's product over the CTA's own columns: the partial d_hw @
    // W_h^T for the units of each CTA rank rr (warp w: units rr Hc + 8 w ..).
    float pacc[C][RT][4];
#pragma unroll
    for (int rr = 0; rr < C; ++rr)
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int i = 0; i < 4; ++i) pacc[rr][rt][i] = 0.0f;
    for (int jc = 0; jc < GHc; jc += kChainK) {
      float cacc[C][RT][4];
#pragma unroll
      for (int rr = 0; rr < C; ++rr)
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int i = 0; i < 4; ++i) cacc[rr][rt][i] = 0.0f;
      for (int j0 = jc; j0 < min(GHc, jc + kChainK); j0 += 8) {
        FragB bw[C];
#pragma unroll
        for (int rr = 0; rr < C; ++rr) {
          const float* p =
              wh_s + (size_t)(rr * Hc + warp * kUnits + g) * LW + j0 + c4;
          frag_b(bw[rr], p[0], p[4]);
        }
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          const float* p = dg_s + (rt * 16 + g) * LG + j0 + c4;
          FragA a;
          frag_a(a, p[0], p[8 * LG], p[4], p[8 * LG + 4]);
#pragma unroll
          for (int rr = 0; rr < C; ++rr) mma3(cacc[rr][rt], a, bw[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < C; ++rr)
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int i = 0; i < 4; ++i) pacc[rr][rt][i] += cacc[rr][rt][i];
    }

    if constexpr (C > 1) {
      // The peer's units to the peer's receive buffer, then one cluster
      // barrier, then rank 0's partial + rank 1's, in that order.
      float* mine_buf = recv_s + cur * BB * LR;
      float* peer_buf = cg::this_cluster().map_shared_rank(mine_buf, rank ^ 1);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rt * 16 + g + 8 * half;
          const int i = 2 * half;
          *reinterpret_cast<float2*>(peer_buf + r * LR + ul) =
              rank == 0 ? make_float2(pacc[1][rt][i], pacc[1][rt][i + 1])
                        : make_float2(pacc[0][rt][i], pacc[0][rt][i + 1]);
        }
      cluster_arrive();
      cluster_wait();
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rt * 16 + g + 8 * half;
          const float2 p =
              *reinterpret_cast<const float2*>(mine_buf + r * LR + ul);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * half + e;
            const float got = e ? p.y : p.x;
            const float sum = rank == 0 ? pacc[0][rt][i] + got
                                        : got + pacc[C - 1][rt][i];
            dhc[rt][i] = dhc[rt][i] + sum;
          }
        }
    } else {
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int i = 0; i < 4; ++i) dhc[rt][i] = dhc[rt][i] + pacc[0][rt][i];
    }
  }
  // No CTA leaves while a peer could still touch its shared memory.
  if constexpr (C > 1) {
    cluster_arrive();
    cluster_wait();
  }
}

// Kernel 1 above 128, per seed (blockIdx.y), CTA rank j of a cluster of C
// along x, blockDim.x = 32 NW, 16 RT rows a cluster. Operands as kernel 1
// at H <= 128 (xw and dgx may alias: no __restrict__ on them).
template <int CELL, int RT>
__global__ void __launch_bounds__(max_threads(RT), 1)
rnn_bwd_tf32_cluster_kernel(const float* xw, const float* __restrict__ wh,
                            const uint8_t* __restrict__ m,
                            const float* __restrict__ h_all,
                            const float* __restrict__ c_all,
                            const float* __restrict__ dh, float* dgx,
                            float* __restrict__ dhn, int B, int Tn, int H,
                            SeedStrides st, float forget_bias) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int BB = 16 * RT;            // rows per cluster
  constexpr int NCH = kChunks;           // output chunks per pass
  const int GH = G * H;
  const int NW = blockDim.x / 32;
  const int U = NW * kUnits;             // share units (gate block width)
  const int LW = G * U + 4;              // share and d tile row stride
  const int LD = H + 8;                  // h tile row stride
  const int LR = kUnits * (NW | 1);      // receive buffer row stride
  const int W = H / kUnits;              // 8-unit chunks of Hp
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  extern __shared__ __align__(16) float smem[];
  float* wh_s = smem;
  float* h_s = wh_s + (size_t)H * LW;
  float* dg_s = h_s + BB * LD;
  float* recv_s = dg_s + BB * LW;

  {
    const size_t seed = blockIdx.y;
    const size_t seq = (size_t)B * Tn * H;
    xw += seed * st.xw;
    wh += seed * st.wh;
    m += seed * st.m;
    h_all += seed * seq;
    if (c_all != nullptr) c_all += seed * seq;
    dh += seed * seq;
    dgx += seed * seq * G;
    if (dhn != nullptr) dhn += seed * seq;
  }

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int r0 = (blockIdx.x / C) * BB;
  const int nr = min(BB, B - r0);
  const int w0 = rank * W / C;                           // first own warp
  const int own = ((rank + 1) * W / C - w0) * kUnits;    // own units
  const bool active = warp * kUnits < own;               // warp-uniform
  const int ul = warp * kUnits + 2 * c4;  // local unit (+ e)
  const int u = w0 * kUnits + ul;         // unit of the states and W_h rows

  // The share: wh_s[k][q U + i] = W_h[k][q H + 8 w0 + i] for the own units
  // i, zero past them.
  {
    const int CW = U / 4;
    for (int i = tid; i < H * G * CW; i += nth) {
      const int k = i / (G * CW);
      const int rem = i - k * G * CW;
      const int q = rem / CW;
      const int j = (rem - q * CW) * 4;
      const bool in = j < own;
      cp_async16(wh_s + (size_t)k * LW + q * U + j,
                 in ? wh + (size_t)k * GH + q * H + w0 * kUnits + j : wh,
                 in ? 16 : 0);
    }
  }
  // h_{t-1}, the h side of step t, for every unit into the h tile; rows
  // past B and h_{-1} are 0.
  auto load_h = [&](int t) {
    const int CH = H / 4;
    for (int i = tid; i < BB * CH; i += nth) {
      const int r = i / CH;
      const int k = (i - r * CH) * 4;
      const bool hv = r < nr && t > 0;
      cp_async16(h_s + r * LD + k,
                 hv ? h_all + ((size_t)(r0 + r) * Tn + t - 1) * H + k : h_all,
                 hv ? 16 : 0);
    }
  };
  load_h(Tn - 1);
  cp_async_commit();

  // Carries, [rt][half * 2 + e] as the accumulators: dh, and for the LSTM
  // dc and c_t (the next step's c_{t-1} is read one step ahead).
  float dhc[RT][4], dcc[RT][4], ccur[RT][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rt * 16 + g + 8 * half;
      float2 c = make_float2(0.0f, 0.0f);
      if (CELL == kLstm && active && r < nr)
        c = *reinterpret_cast<const float2*>(
            c_all + ((size_t)(r0 + r) * Tn + Tn - 1) * H + u);
      ccur[rt][2 * half] = c.x;
      ccur[rt][2 * half + 1] = c.y;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dhc[rt][2 * half + e] = 0.0f;
        dcc[rt][2 * half + e] = 0.0f;
      }
    }

  // The thread's xw pairs (row, gate q, units u, u + 1), a step ahead.
  float2 xs[RT][2][G];
  auto load_x = [&](int t) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + g + 8 * half;
        const bool in = r < nr && active;
        const size_t row = (size_t)(r0 + r) * Tn + t;
#pragma unroll
        for (int q = 0; q < G; ++q)
          xs[rt][half][q] =
              in ? *reinterpret_cast<const float2*>(xw + row * GH + q * H + u)
                 : make_float2(0.0f, 0.0f);
      }
  };
  // A step's elementwise inputs, loaded a step ahead of its cell.
  bool keep[RT][2];
  float dup[RT][4], cprev[RT][4];
  auto load_step = [&](int t) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + g + 8 * half;
        const bool in = r < nr && active;
        const size_t row = (size_t)(r0 + r) * Tn + t;
        keep[rt][half] = in && m[row] != 0;
        float2 d = make_float2(0.0f, 0.0f), c = make_float2(0.0f, 0.0f);
        if (in) {
          d = *reinterpret_cast<const float2*>(dh + row * H + u);
          if (CELL == kLstm && t > 0)
            c = *reinterpret_cast<const float2*>(c_all + (row - 1) * H + u);
        }
        dup[rt][2 * half] = d.x;
        dup[rt][2 * half + 1] = d.y;
        cprev[rt][2 * half] = c.x;
        cprev[rt][2 * half + 1] = c.y;
      }
  };
  // A step's gate pre-activations (cell_bwd's a), from the h tile and xw_t:
  // the h side h_{t-1} @ W_h[:, own] in chains of kChainK (lane c taking
  // k0 + 2c and k0 + 2c + 1 of each 8-step in both operands), then the x
  // side added (the plain order); then xw_{t-1} is loaded.
  float acc[RT][4][4];
  auto recompute = [&](int t) {
    if (!active) return;
    float hs[RT][G][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) hs[rt][q][i] = 0.0f;
    for (int kc = 0; kc < H; kc += kChainK) {
      float cacc[RT][G][4];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) cacc[rt][q][i] = 0.0f;
      for (int k0 = kc; k0 < min(H, kc + kChainK); k0 += 8) {
        FragB hb[G];
        const float* wp =
            wh_s + (size_t)(k0 + 2 * c4) * LW + warp * kUnits + g;
#pragma unroll
        for (int q = 0; q < G; ++q)
          frag_b(hb[q], wp[q * U], wp[q * U + LW]);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          const float* hp = h_s + (rt * 16 + g) * LD + k0 + 2 * c4;
          const float2 x0 = *reinterpret_cast<const float2*>(hp);
          const float2 x1 = *reinterpret_cast<const float2*>(hp + 8 * LD);
          FragA a;
          frag_a(a, x0.x, x1.x, x0.y, x1.y);
#pragma unroll
          for (int q = 0; q < G; ++q) mma3(cacc[rt][q], a, hb[q]);
        }
      }
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) hs[rt][q][i] += cacc[rt][q][i];
    }
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float xq[G];
#pragma unroll
        for (int q = 0; q < G; ++q)
          xq[q] = (i & 1) ? xs[rt][i >> 1][q].y : xs[rt][i >> 1][q].x;
        acc[rt][0][i] = xq[0] + hs[rt][0][i];
        acc[rt][1][i] = xq[1] + hs[rt][1][i];
        acc[rt][2][i] = CELL == kLstm ? xq[2] + hs[rt][2][i] : xq[2];
        acc[rt][3][i] = CELL == kLstm ? xq[G - 1] + hs[rt][G - 1][i]
                                      : hs[rt][2][i];
      }
    if (t > 0) load_x(t - 1);
  };

  load_x(Tn - 1);
  cp_async_wait_all();  // the share and h_{T-2} are in place
  __syncthreads();
  load_step(Tn - 1);
  recompute(Tn - 1);
  // Every CTA of the cluster runs before any stores into another's memory:
  // the first step's wait before its stores pairs with this arrival.
  cluster_arrive();

  for (int t = Tn - 1; t >= 0; --t) {
    if (active) {
      // The cell's backward, in registers: d_xw (and the GRU's dn r) to
      // device memory, d_hw to the shared tile; the carries' elementwise
      // part.
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rt * 16 + g + 8 * half;
          const size_t row = (size_t)(r0 + r) * Tn + t;
          const float kp = keep[rt][half] ? 1.0f : 0.0f;
          float dg[4][2];  // [gate][e]; GRU: 3 = dn r
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * half + e;
            const float a[4] = {acc[rt][0][i], acc[rt][1][i], acc[rt][2][i],
                                acc[rt][3][i]};
            float d[4];
            cell_bwd<CELL>(a, dup[rt][i], kp, ccur[rt][i], cprev[rt][i],
                           CELL == kGru ? h_s[r * LD + u + e] : 0.0f,
                           forget_bias, dhc[rt][i], dcc[rt][i], d);
#pragma unroll
            for (int q = 0; q < 4; ++q) dg[q][e] = d[q];
            if (CELL == kLstm) ccur[rt][i] = cprev[rt][i];
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
          for (int q = 0; q < G; ++q) {
            const int qh = CELL == kGru && q == 2 ? 3 : q;
            *reinterpret_cast<float2*>(dg_s + r * LW + q * U + ul) =
                make_float2(dg[qh][0], dg[qh][1]);
          }
        }
    }
    __syncthreads();  // the d_hw tile is complete; the h tile is read
    if (t > 0) load_h(t - 1);
    cp_async_commit();

    // The carry's product over the CTA's own gate columns, d_hw[:, own] @
    // W_h[:, own]^T, for the output chunks c = warp + NW i (units 8 c ..
    // 8 c + 7), NCH of them at a time; each chunk into the receive buffer
    // of the CTA that owns it, at this rank's slot. Each gate's own
    // columns in chains of at most kChainK; an idle warp's columns (past
    // `own`) are skipped.
    const int nch = (W - warp + NW - 1) / NW;  // >= 1: NW <= W
    for (int pass = 0; pass * NCH < nch; ++pass) {
      float pacc[NCH][RT][4];
#pragma unroll
      for (int s = 0; s < NCH; ++s)
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int i = 0; i < 4; ++i) pacc[s][rt][i] = 0.0f;
      for (int q = 0; q < G; ++q)
        for (int jc = 0; jc < own; jc += kChainK) {
          float cacc[NCH][RT][4];
#pragma unroll
          for (int s = 0; s < NCH; ++s)
#pragma unroll
            for (int rt = 0; rt < RT; ++rt)
#pragma unroll
              for (int i = 0; i < 4; ++i) cacc[s][rt][i] = 0.0f;
          for (int j0 = q * U + jc; j0 < q * U + min(own, jc + kChainK);
               j0 += 8) {
            FragA a[RT];
#pragma unroll
            for (int rt = 0; rt < RT; ++rt) {
              const float* p = dg_s + (rt * 16 + g) * LW + j0 + c4;
              frag_a(a[rt], p[0], p[8 * LW], p[4], p[8 * LW + 4]);
            }
#pragma unroll
            for (int s = 0; s < NCH; ++s) {
              // Branch-free: a slot past the last chunk repeats it (not
              // stored).
              const int c = min(warp + NW * (pass * NCH + s), W - 1);
              const float* p = wh_s + (size_t)(c * kUnits + g) * LW + j0 + c4;
              FragB b;
              frag_b(b, p[0], p[4]);
#pragma unroll
              for (int rt = 0; rt < RT; ++rt) mma3(cacc[s][rt], a[rt], b);
            }
          }
#pragma unroll
          for (int s = 0; s < NCH; ++s)
#pragma unroll
            for (int rt = 0; rt < RT; ++rt)
#pragma unroll
              for (int i = 0; i < 4; ++i) pacc[s][rt][i] += cacc[s][rt][i];
        }
      // Every peer is done reading its buffer of the last step.
      if (pass == 0) cluster_wait();
#pragma unroll
      for (int s = 0; s < NCH; ++s) {
        const int c = warp + NW * (pass * NCH + s);
        if (c >= W) continue;  // warp-uniform: a repeated chunk
        const int p = ((c + 1) * C - 1) / W;  // the CTA that owns chunk c
        const int lu = (c - p * W / C) * kUnits + 2 * c4;
        float* dst = cluster.map_shared_rank(recv_s + (size_t)rank * BB * LR,
                                             p);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = rt * 16 + g + 8 * half;
            *reinterpret_cast<float2*>(dst + r * LR + lu) = make_float2(
                pacc[s][rt][2 * half], pacc[s][rt][2 * half + 1]);
          }
      }
    }
    cluster_arrive();
    // While the partials travel: the next step's inputs and gates, which
    // do not need the carry.
    if (t > 0) {
      cp_async_wait_all();  // h_{t-2} is in place
      __syncthreads();
      load_step(t - 1);
      recompute(t - 1);
    }
    cluster_wait();  // every rank's partial of this CTA's units is here
    if (active) {
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rt * 16 + g + 8 * half;
          const float* in = recv_s + r * LR + ul;
          float2 sum = *reinterpret_cast<const float2*>(in);
          for (int j = 1; j < C; ++j) {
            const float2 v =
                *reinterpret_cast<const float2*>(in + (size_t)j * BB * LR);
            sum.x += v.x;
            sum.y += v.y;
          }
          dhc[rt][2 * half] = dhc[rt][2 * half] + sum.x;
          dhc[rt][2 * half + 1] = dhc[rt][2 * half + 1] + sum.y;
        }
    }
    cluster_arrive();  // this CTA's buffer is read
  }
  // No CTA leaves while a peer could still store into its shared memory.
  cluster_wait();
}


// Kernel 1 at H <= 128 through cudaLaunchKernelEx with a cluster of C
// CTAs along x; refused (cudaErrorLaunchOutOfResources) when the card
// cannot hold one such cluster.
template <int CELL, int C>
cudaError_t launch_recur(const float* xw, const float* wh, const uint8_t* m,
                         const float* h_all, const float* c_all,
                         const float* dh, float* dgx, float* dhn, int seeds,
                         int B, int Tn, int H, SeedStrides st,
                         float forget_bias, cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int rows = 16 * kRowTiles;
  auto kern = rnn_bwd_tf32_recur_kernel<CELL, C>;
  const size_t smem = recur_smem_bytes(G, H, C, rows);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + rows - 1) / rows), seeds);
  cfg.blockDim = dim3(H / C * 4);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  if (C > 1) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters == 0) return cudaErrorLaunchOutOfResources;
  }
  err = cudaLaunchKernelEx(&cfg, kern, xw, wh, m, h_all, c_all, dh, dgx, dhn,
                           B, Tn, H, st, forget_bias);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launch configuration of kernel 1 above 128 (grid, block, cluster,
// shared memory), with the attributes it needs set on the kernel.
template <int CELL, int RT>
cudaError_t cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                           int seeds, int B, int H, int C,
                           cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int rows = 16 * RT;
  auto kern = rnn_bwd_tf32_cluster_kernel<CELL, RT>;
  const size_t smem = recur_smem_bytes(G, H, C, rows);
  cfg = {};
  cfg.gridDim = dim3(C * ((B + rows - 1) / rows), seeds);
  cfg.blockDim = dim3(warps_per_cta(H, C) * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Clusters of kernel 1 above 128 the card holds at once (0: none).
template <int CELL, int RT>
cudaError_t cluster_count(int* clusters, int H, int C) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      cluster_config<CELL, RT>(cfg, attr, 1, 16 * RT, H, C, nullptr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(
      clusters, rnn_bwd_tf32_cluster_kernel<CELL, RT>, &cfg);
}

// Kernel 1 above 128 through cudaLaunchKernelEx; refused
// (cudaErrorLaunchOutOfResources) when the card cannot hold one cluster.
template <int CELL, int RT>
cudaError_t launch_cluster(const float* xw, const float* wh, const uint8_t* m,
                           const float* h_all, const float* c_all,
                           const float* dh, float* dgx, float* dhn, int seeds,
                           int B, int Tn, int H, int C, SeedStrides st,
                           float forget_bias, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      cluster_config<CELL, RT>(cfg, attr, seeds, B, H, C, stream);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, rnn_bwd_tf32_cluster_kernel<CELL, RT>, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters == 0) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, rnn_bwd_tf32_cluster_kernel<CELL, RT>, xw,
                           wh, m, h_all, c_all, dh, dgx, dhn, B, Tn, H, st,
                           forget_bias);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Kernel 1 of the shape: at H <= 128 the C-CTA form, above it the cluster
// form with `rows` rows.
template <int CELL>
cudaError_t launch_kernel1(const float* xw, const float* wh, const uint8_t* m,
                           const float* h_all, const float* c_all,
                           const float* dh, float* dgx, float* dhn, int seeds,
                           int B, int Tn, int H, int C, int rows,
                           SeedStrides st, float fb, cudaStream_t stream) {
  if (H <= 128)
    return C == 1 ? launch_recur<CELL, 1>(xw, wh, m, h_all, c_all, dh, dgx,
                                          dhn, seeds, B, Tn, H, st, fb,
                                          stream)
                  : launch_recur<CELL, 2>(xw, wh, m, h_all, c_all, dh, dgx,
                                          dhn, seeds, B, Tn, H, st, fb,
                                          stream);
  return rows == 16
             ? launch_cluster<CELL, 1>(xw, wh, m, h_all, c_all, dh, dgx, dhn,
                                       seeds, B, Tn, H, C, st, fb, stream)
             : launch_cluster<CELL, 2>(xw, wh, m, h_all, c_all, dh, dgx, dhn,
                                       seeds, B, Tn, H, C, st, fb, stream);
}

// fused: GEMM (xw into dgx; skipped when xw_ready, dgx holding it
// already), recurrence, weight gradients, slice sum, GEMM (dhin); hoisted:
// the middle three, xw the caller's.
template <int CELL>
cudaError_t launch(bool fused, bool xw_ready, const float* xin, const float* wx,
                   const float* b, const float* wh, const uint8_t* m,
                   const float* h_all, const float* c_all, const float* dh,
                   float* dx, float* dgx, float* dhn, float* partial, int S,
                   float* dw, int seeds, int B, int Tn, int H, int C,
                   int rows, long long s_xin, long long s_wx, long long s_b,
                   long long s_wh, long long s_m, float forget_bias,
                   cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  const int GH = G * H;
  const int M = B * Tn;
  const long long s_gates = (long long)M * GH;
  cudaError_t err;
  if (fused && !xw_ready) {
    err = launch_gemm<false>(xin, wx, b, dgx, M, GH, H, seeds, s_xin, s_wx,
                             s_b, s_gates, stream);
    if (err != cudaSuccess) return err;
  }
  const SeedStrides st{fused ? s_gates : s_xin, s_wh, s_m};
  const float* xw = fused ? dgx : xin;
  err = launch_kernel1<CELL>(xw, wh, m, h_all, c_all, dh, dgx, dhn, seeds, B,
                             Tn, H, C, rows, st, forget_bias, stream);
  if (err != cudaSuccess) return err;

  const size_t smem2 = wgrad_smem_bytes(H);
  auto wgrad = fused ? rnn_bwd_tf32_wgrad_kernel<CELL, true>
                     : rnn_bwd_tf32_wgrad_kernel<CELL, false>;
  err = cudaFuncSetAttribute(
      wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;
  const int tiles =
      (GH + kWgCols - 1) / kWgCols * ((H + kWgOut - 1) / kWgOut);
  wgrad<<<dim3(tiles * (fused ? 2 : 1), S, seeds), kWgThreads, smem2,
          stream>>>(xin, h_all, dgx, dhn, M, Tn, H, (M + S - 1) / S, s_xin,
                    partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = fused ? 2 * H * GH + GH : H * GH;
  rnn_bwd_tf32_slices_kernel<<<dim3((total + 255) / 256, seeds), 256, 0,
                               stream>>>(partial, S, total, dw);
  err = cudaGetLastError();
  if (err != cudaSuccess || !fused) return err;
  return launch_gemm<true>(dgx, wx, nullptr, dx, M, H, GH, seeds, s_gates,
                           s_wx, 0, (long long)M * H, stream);
}

// The shapes the kernels take: 16 <= H <= 128 with C 1 or 2 and 32 rows;
// 128 < H <= kMaxWidth with C in {2, 4}, 16 or 32 rows and the
// CTA's warps within the rows' thread limit; H % 16 == 0.
bool supported(int H, int C, int rows) {
  if (H < 16 || H > kMaxWidth || H % 16 != 0) return false;
  if (H <= 128) return (C == 1 || C == 2) && rows == 16 * kRowTiles;
  if (C != 2 && C != kMaxCluster) return false;
  if (rows != 16 && rows != 32) return false;
  return warps_per_cta(H, C) * 32 <= max_threads(rows / 16);
}

}  // namespace

// Shared memory of kernel 1 (the largest of the launches) with a cluster of
// C CTAs and `rows` rows a cluster, in bytes; -1 for a shape the kernels do
// not take. cell: 0 = LSTM, 1 = GRU.
extern "C" long long lfm_rnn_bwd_tf32_smem(int cell, int H, int C, int rows) {
  if (!supported(H, C, rows) || (cell != kLstm && cell != kGru)) return -1;
  return (long long)recur_smem_bytes(cell == kLstm ? 4 : 3, H, C, rows);
}

// Clusters of kernel 1 above 128 the current card holds at once for this
// shape; -1 for a shape the cluster form does not take or a CUDA error.
extern "C" int lfm_rnn_bwd_tf32_clusters(int cell, int H, int C, int rows) {
  if (H <= 128 || !supported(H, C, rows) || (cell != kLstm && cell != kGru))
    return -1;
  int n = 0;
  cudaError_t err;
  if (cell == kLstm)
    err = rows == 16 ? cluster_count<kLstm, 1>(&n, H, C)
                     : cluster_count<kLstm, 2>(&n, H, C);
  else
    err = rows == 16 ? cluster_count<kGru, 1>(&n, H, C)
                     : cluster_count<kGru, 2>(&n, H, C);
  return err == cudaSuccess ? n : -1;
}

// The float32 backward on the tensor cores, for `seeds` seeds in one call.
// fused = 1: xin is hin [B, T, H], and wx [H, G H], b [G H] are used; out
// dx = dhin [seeds, B, T, H] and dw [seeds, 2 H G H + G H] (dW_x, db,
// dW_h). fused = 2: as 1, with dgx holding xw = hin @ W_x + b already (the
// forward's scratch, csrc/rnn_fwd_tf32.cu): no xw GEMM. fused = 0: xin is
// xw [B, T, G H] (wx, b, dx unused); out dgx = dxw and dw [seeds, H G H]
// (dW_h). Per seed: wh [H, G H]; m uint8 [B, T]; h_all, c_all (LSTM; the
// GRU passes null), dh [seeds, B, T, H]. s_*: the seed strides of xin, wx,
// b, wh and m in their elements (0: shared). Scratch the caller allocates:
// dgx [seeds, B, T, G H] (the fused form's d_xw), dhn [seeds, B, T, H]
// (GRU), partial [seeds, S, total]. C: CTAs per cluster (1 or 2 at H <=
// 128; 2, 4, 8 or 16 above), rows: batch rows per cluster (32 at H <= 128;
// 16 or 32 above). All f32. Returns the first CUDA error of its launches.
extern "C" int lfm_rnn_bwd_tf32(int cell, int fused, const void* xin,
                                const void* wx, const void* b, const void* wh,
                                const void* m, const void* h_all,
                                const void* c_all, const void* dh, void* dx,
                                void* dgx, void* dhn, void* partial, int S,
                                void* dw, int seeds, int B, int Tn, int H,
                                int C, int rows, long long s_xin,
                                long long s_wx, long long s_b, long long s_wh,
                                long long s_m, float forget_bias,
                                void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (seeds <= 0 || seeds > 65535 || B <= 0 || Tn <= 0 || S <= 0 ||
      S > 65535 || !supported(H, C, rows))
    return (int)cudaErrorInvalidValue;
#define LFM_TF32(CELLV)                                                     \
  return (int)launch<CELLV>(                                                \
      fused != 0, fused == 2, static_cast<const float*>(xin),               \
      static_cast<const float*>(wx), static_cast<const float*>(b),          \
      static_cast<const float*>(wh), static_cast<const uint8_t*>(m),        \
      static_cast<const float*>(h_all), static_cast<const float*>(c_all),   \
      static_cast<const float*>(dh), static_cast<float*>(dx),               \
      static_cast<float*>(dgx), static_cast<float*>(dhn),                   \
      static_cast<float*>(partial), S, static_cast<float*>(dw), seeds, B,   \
      Tn, H, C, rows, s_xin, s_wx, s_b, s_wh, s_m, forget_bias, cs)
  if (cell == kLstm) LFM_TF32(kLstm);
  if (cell == kGru) LFM_TF32(kGru);
#undef LFM_TF32
  return (int)cudaErrorInvalidValue;
}
