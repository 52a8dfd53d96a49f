// Masked LSTM/GRU recurrence, fused and hoisted backward, in bfloat16 above
// hidden 128 on Hopper's tensor cores (mma.sync m16n8k16, f32
// accumulation), with W_h split across a thread-block cluster.
//
// Replaces, in bfloat16 with 128 < Hp <= 512 (Hp the width padded to a
// multiple of 16; ops/rnn.py _mma_route "cluster"), the Pallas TPU kernels
// _lstm_fused_bwd_kernel (lfm_quant_tpu/ops/pallas_rnn.py:673) and
// _gru_fused_bwd_kernel (:739), reached through _fused_bwd_call (:835), and
// _lstm_bwd_kernel (:184) and _gru_bwd_kernel (:243), reached through
// _bwd_call (:407), with their seed rules (_bwd_vmap :952,
// _make_scan._bwd_vmap :541). It computes what csrc/rnn_bwd.cu computes
// (its formulas are written out there), at the TPU kernels' rounding
// points: dh and dc carried in f32, d_gates f32, every product with d_gates
// split into a bf16 hi and lo (kSplit = 2, as csrc/rnn_fused_bwd_mma.cu
// does, so its numerics carry over), dhin and dxw stored in bf16, dW_x,
// dW_h and db in f32.
//
// Why a cluster. W_h is G Hp^2 bf16 (2 MB for the LSTM at H 512), past one
// CTA's 227 KB. csrc/rnn_bwd.cu re-reads it from L2 in every block and
// step and runs every product in f32 on the CUDA cores (67 TFLOP/s); here
// each CTA of a cluster keeps its share of W_h in shared memory for all T
// steps and runs the products at the bf16 rate.
//
// Bound. At B 2048, T 60, H 512 (LSTM) the fused function is 6 products of
// 2 H G H per row and step (the recompute, dh, dhin, dW_x, dW_h, and the
// x side's recompute): 1.5e12 operations, 1.56 ms at 989 TFLOP/s, against
// 0.75 GB of inputs and outputs (0.22 ms): bound by operations. The hoisted
// form does 3 of the 6 and moves the G-times wider xw and dxw.
//
// Design: the fused form is GEMM + the hoisted reverse recurrence + GEMMs.
//
// * Kernel 0 (fused form, only where the forward's scratch is gone): xw =
//   hin @ W_x + b into the f32 d_gates buffer [S, B, T, G Hp], the GEMM of
//   the cluster forward (csrc/cluster_gemm.cuh), so the recompute below
//   matches the forward bit for bit. Under autograd the forward's scratch
//   is that buffer, and kernel 0 does not run.
// * Kernel 1, the reverse recurrence. A cluster of C CTAs owns 16 RT batch
//   rows for all T steps. The Hp / 8 warps of units are dealt out as in the
//   forward (ops/rnn.py _cluster_units): CTA j owns warps [j W / C, (j + 1)
//   W / C), NW = ceil(W / C) or one fewer. It holds those units' W_h
//   columns once in shared memory, row-major [Hp, GUP + 8] bf16 (GUP = G U
//   rounded up to 16, U = 8 NW; column q U + i is gate q of local unit i;
//   ops/rnn.py pack_cluster_bwd), and one copy serves both per-step
//   products: ldmatrix.trans gives the B fragments of the recompute
//   h_{t-1} @ W_h[:, own], plain ldmatrix those of d_hw[:, own] @
//   W_h[:, own]^T. Per step: h_{t-1} for all Hp units arrives from the
//   saved h_all by cp.async into a double-buffered tile; the gates are
//   recomputed from xw_t (loaded into registers a step ahead) plus the h
//   side, in the forward's k order, so bitwise the forward's sums; the cell
//   writes d_xw (fused: in place over xw_t in the f32 buffer, and the GRU's
//   dn r apart; hoisted: dxw in bf16 and d_hw in f32) and splits its d_hw
//   into a bf16 hi and lo tile [rows, GUP + 8]. The carry's product gives
//   each CTA a partial [rows, Hp] over its own gate columns; warp w makes
//   the output chunks (8 units each) w, w + NW, .. and stores each into
//   the owning CTA's receive buffer [C][rows][LR] f32 through distributed
//   shared memory, at the slot of its own rank (a reduce-scatter). While
//   the partials travel, the CTA loads the next step's inputs and
//   recomputes its gates (they do not need the carry; the h tiles are
//   loaded two steps ahead). Then one cluster barrier, and each CTA adds
//   its units' C partials in rank order, rank 0 first, so the sums are
//   bitwise repeatable, and arrives again; the next step waits on that
//   arrival just before its stores (the exchange is single-buffered: a
//   second buffer does not fit beside the LSTM's share at H 512).
// * Kernel 2, the weight gradients: a block owns one product (dW_x = hin^T
//   d_xw with db = sum d_xw, or dW_h = h_{t-1}^T d_hw), 64 gate columns,
//   256 output rows and a slice of B T rows; d split into hi and lo as it
//   is staged. Per-slice partial sums; kernel 3 adds the slices in a fixed
//   order. No atomics.
// * Kernel 4 (fused form): dhin = d_xw @ W_x^T, tiles of 128 x 128, d_xw
//   split as it is staged, W_x's rows read by plain ldmatrix.
//   Kernels 2-4 live in csrc/bf16_wgrad.cuh, shared with the grid
//   backward past 512 (csrc/rnn_bwd_grid.cu).
// * Seeds: the seed is blockIdx.y of kernels 1 and 3 and blockIdx.z of
//   kernels 0, 2 and 4; each shared operand has its own seed stride (0:
//   shared), every per-seed offset is 64-bit, and a seed's outputs are
//   bitwise those of its one-seed launch.
// * The recurrence goes through cudaLaunchKernelEx with clusterDim.x = C
//   (non-portable sizes allowed past 8); a cluster the card cannot hold
//   (cudaOccupancyMaxActiveClusters 0) is refused.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_wgrad.cuh"
#include "cluster_gemm.cuh"
#include "mma_common.cuh"
#include "tf32_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace lfm_mma;
using lfm_bf16::kSplit;
using lfm_bf16::launch_dhin;
using lfm_bf16::launch_wgrad;
using lfm_bf16::split_bf16;
using lfm_cluster::launch_gemm;
using lfm_tf32::cluster_arrive;
using lfm_tf32::cluster_wait;
using lfm_tf32::cp_async_wait;
using lfm_tf32::sigmoid;

constexpr int kLstm = 0;
constexpr int kGru = 1;
constexpr int kUnits = 8;       // hidden units per warp of kernel 1
constexpr int kMaxWidth = 512;  // the widest Hp the kernels take
constexpr int kMaxCluster = 16;
// Kernel 1: output chunks a warp holds in registers per pass of the
// carry's product, over its 16-row tiles.
constexpr int kChunkRegs = 8;

// Kernel 1's threads per CTA at most, by 16-row tiles: the registers of
// the recompute's sums, the carries, xw_t and the carry product's chunks.
__host__ __device__ constexpr int max_threads(int rt) {
  return rt == 1 ? 384 : 256;
}

struct SeedStrides {
  long long xw, wh, m;
};

inline int warps_per_cta(int H, int C) {
  const int W = H / kUnits;
  return (W + C - 1) / C;
}

// The share's columns: G U rounded up to a multiple of 16 (the carry's
// product steps k by 16).
inline int share_cols(int G, int H, int C) {
  const int gu = G * kUnits * warps_per_cta(H, C);
  return (gu + 15) / 16 * 16;
}

// The receive buffer's row stride in floats: 8 NW rounded up to an odd
// multiple of 8, so eight rows of float2 pairs fall in distinct banks.
inline int recv_ld(int H, int C) { return kUnits * (warps_per_cta(H, C) | 1); }

// Kernel 1's shared memory: the W_h share [H, GUP + 8] bf16, two h tiles
// [rows, H + 8] bf16, the kSplit d_hw tiles [rows, GUP + 8] bf16 and the
// receive buffer [C][rows][LR] f32. ops/rnn.py _cluster_bwd_smem mirrors
// it.
inline size_t recur_smem_bytes(int G, int H, int C, int rows) {
  const size_t LW = share_cols(G, H, C) + 8;
  return (size_t)H * LW * 2 + 2 * (size_t)rows * (H + 8) * 2 +
         (size_t)kSplit * rows * LW * 2 + (size_t)C * rows * recv_ld(H, C) * 4;
}

__device__ __forceinline__ float2 as_float2(float2 v) { return v; }
__device__ __forceinline__ float2 as_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

// A pair of xw values of the thread's (row, gate, unit pair): f32 for the
// fused form's buffer, bf16 for the hoisted form's xw.
template <typename XW>
struct XwPair;
template <>
struct XwPair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 zero() {
    return make_float2(0.0f, 0.0f);
  }
};
template <>
struct XwPair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ __nv_bfloat162 zero() {
    return __floats2bfloat162_rn(0.0f, 0.0f);
  }
};

// Kernel 1, per seed (blockIdx.y), CTA rank j of a cluster of C along x,
// blockDim.x = 32 NW. xw [B, T, G H]: the gates' x side with the bias
// (fused: the f32 d_gates buffer itself, overwritten in place with d_xw;
// hoisted: bf16); whp: W_h packed per CTA (ops/rnn.py pack_cluster_bwd), C
// slices [H][GUP] bf16; m uint8 [B, T]; h_all, c_all (LSTM), dh [B, T, H]
// bf16. Out, fused: dgx = d_xw (aliases xw) and (GRU) dhn = dn r [B, T, H]
// f32; hoisted: dgx = d_hw [B, T, G H] f32 and dxw = d_xw [B, T, G H]
// bf16. xw and dgx may alias: no __restrict__ on them.
template <int CELL, int RT, typename XW>
__global__ void __launch_bounds__(max_threads(RT), 1)
rnn_bwd_cluster_kernel(const XW* xw, const __nv_bfloat16* __restrict__ whp,
                       const uint8_t* __restrict__ m,
                       const __nv_bfloat16* __restrict__ h_all,
                       const __nv_bfloat16* __restrict__ c_all,
                       const __nv_bfloat16* __restrict__ dh, float* dgx,
                       float* __restrict__ dhn,
                       __nv_bfloat16* __restrict__ dxw, int B, int Tn, int H,
                       SeedStrides st, float forget_bias) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int BB = 16 * RT;  // rows per cluster
  constexpr bool HOIST = sizeof(XW) == 2;
  constexpr int NCH = kChunkRegs / RT;  // output chunks per pass
  using XW2 = typename XwPair<XW>::type;
  const int GH = G * H;
  const int KT = H / 16;
  const int NW = blockDim.x / 32;
  const int U = NW * kUnits;                // share units (gate block width)
  const int GUP = (G * U + 15) / 16 * 16;   // share columns
  const int LW = GUP + 8;                   // share and d tile row stride
  const int LD = H + 8;                     // h tile row stride
  const int LR = kUnits * (NW | 1);         // receive buffer row stride
  const int W = H / kUnits;                 // 8-unit chunks of Hp
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* h_s = wh_s + (size_t)H * LW;
  __nv_bfloat16* dg_s = h_s + 2 * BB * LD;
  float* recv_s = reinterpret_cast<float*>(dg_s + kSplit * BB * LW);

  {
    const size_t seed = blockIdx.y;
    const size_t seq = (size_t)B * Tn * H;
    xw += seed * st.xw;
    whp += seed * st.wh;
    m += seed * st.m;
    h_all += seed * seq;
    if (c_all != nullptr) c_all += seed * seq;
    dh += seed * seq;
    dgx += seed * seq * G;
    if (dhn != nullptr) dhn += seed * seq;
    if (dxw != nullptr) dxw += seed * seq * G;
  }

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = (blockIdx.x / C) * BB;
  const int nr = min(BB, B - r0);
  const int cta_w0 = rank * W / C;
  const int cta_chunks = (rank + 1) * W / C - cta_w0;  // its warps
  const int ul0 = warp * kUnits;                       // local first unit
  const int u0 = cta_w0 * kUnits + ul0;
  const bool active = warp < cta_chunks;  // warp-uniform
  const int row_l = lane >> 2;            // + 16 rt + 8 half
  const int c4 = lane & 3;
  const int u = u0 + 2 * c4;    // the thread's units u, u + 1
  const int ul = ul0 + 2 * c4;  // and their local index

  // The CTA's slice of the packed share into rows of LW.
  {
    const __nv_bfloat16* src = whp + (size_t)rank * H * GUP;
    const int CW = GUP / 8;
    for (int i = tid; i < H * CW; i += nth) {
      const int k = i / CW;
      const int c = (i - k * CW) * 8;
      cp_async16(wh_s + (size_t)k * LW + c, src + (size_t)k * GUP + c, 16);
    }
  }
  // h_{t-1} for every unit into tile `buf`; rows past B and h_{-1} are 0.
  auto load_h = [&](int t, int buf) {
    __nv_bfloat16* hd = h_s + buf * BB * LD;
    const int C8 = H / 8;
    for (int i = tid; i < BB * C8; i += nth) {
      const int r = i / C8;
      const int k = (i - r * C8) * 8;
      const bool hv = r < nr && t > 0;
      cp_async16(hd + r * LD + k,
                 hv ? h_all + ((size_t)(r0 + r) * Tn + t - 1) * H + k : h_all,
                 hv ? 16 : 0);
    }
  };
  load_h(Tn - 1, (Tn - 1) & 1);
  cp_async_commit();
  if (Tn > 1) load_h(Tn - 2, Tn & 1);
  cp_async_commit();
  {
    // The d tiles' columns of an idle warp and past G U are never written:
    // zero, as the share's are.
    uint32_t* z = reinterpret_cast<uint32_t*>(dg_s);
    for (int i = tid; i < kSplit * BB * LW / 2; i += nth) z[i] = 0u;
  }

  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix address
  const int acol = (lane >> 4) * 8;
  // B of h @ W_h[:, own]: share rows k (ldmatrix.trans) at gate q's column
  // q U + ul0; lanes 16-31 the next gate.
  const __nv_bfloat16* whf_l = wh_s + (size_t)arow * LW + ul0;

  // Carries, [rt][half * 2 + e] as the accumulators: dh, and for the LSTM
  // dc and c_t (the next step's c_{t-1} is read one step ahead).
  float dhc[RT][4], dcc[RT][4], ccur[RT][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rt * 16 + row_l + 8 * half;
      float2 c = make_float2(0.0f, 0.0f);
      if (CELL == kLstm && active && r < nr)
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

  // The thread's xw_t pairs, loaded a step ahead; rows past B read 0.
  XW2 xs[RT][2][G];
  auto load_x = [&](int t) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + row_l + 8 * half;
        const bool in = r < nr && active;
        const size_t row = (size_t)(r0 + r) * Tn + t;
#pragma unroll
        for (int q = 0; q < G; ++q)
          xs[rt][half][q] =
              in ? *reinterpret_cast<const XW2*>(xw + row * GH + q * H + u)
                 : XwPair<XW>::zero();
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
        const int r = rt * 16 + row_l + 8 * half;
        const bool in = r < nr && active;
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
  };
  // A step's gates, recomputed as the forward kernel sums them: xw_t, then
  // the h side in its k order, from the step's h tile. Slots: the G x-side
  // gates; the GRU's slot 3 is the h side of n.
  float acc[RT][4][4];
  auto recompute = [&](int t) {
    const __nv_bfloat16* ht = h_s + (t & 1) * BB * LD;
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = as_float2(xs[rt][i >> 1][q < G ? q : 0]);
          acc[rt][q][i] = q < G ? ((i & 1) ? v.y : v.x) : 0.0f;
        }
    if (t > 0) load_x(t - 1);

    if (active) {
      for (int kk = 0; kk < KT; ++kk) {
        uint2 bh[G];
        const __nv_bfloat16* p = whf_l + (size_t)kk * 16 * LW;
        uint32_t r[4];
        ldmatrix_x4_trans(r, p + (lane >> 4) * U);
        bh[0] = make_uint2(r[0], r[1]);
        bh[1] = make_uint2(r[2], r[3]);
        if (G == 4) {
          ldmatrix_x4_trans(r, p + (2 + (lane >> 4)) * U);
          bh[2] = make_uint2(r[0], r[1]);
          bh[G - 1] = make_uint2(r[2], r[3]);
        } else {
          uint32_t r2[2];
          ldmatrix_x2_trans(r2, p + 2 * U);
          bh[2] = make_uint2(r2[0], r2[1]);
        }
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          uint32_t a[4];
          ldmatrix_x4(a, ht + (rt * 16 + arow) * LD + kk * 16 + acol);
#pragma unroll
          for (int q = 0; q < G; ++q)
            mma_bf16(acc[rt][CELL == kGru && q == 2 ? 3 : q], a, bh[q]);
        }
      }
    }
  };

  load_x(Tn - 1);
  cp_async_wait<1>();  // the share and h_{T-2}'s tile are in place
  __syncthreads();
  load_step(Tn - 1);
  recompute(Tn - 1);
  // Every CTA of the cluster runs before any stores into another's memory:
  // the first step's wait before its stores pairs with this arrival.
  cluster_arrive();

  for (int t = Tn - 1; t >= 0; --t) {
    const __nv_bfloat16* ht = h_s + (t & 1) * BB * LD;  // h_{t-1}
    if (active) {
      // The cell's backward, in registers: d_xw (and d_hw) to device
      // memory, d_hw split into the tiles; the carries' elementwise part.
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rt * 16 + row_l + 8 * half;
          const size_t row = (size_t)(r0 + r) * Tn + t;
          const float kp = keep[rt][half] ? 1.0f : 0.0f;
          float dg[4][2];  // [gate][e]; GRU: 3 = dn r
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
            for (int q = 0; q < G; ++q) {
              const int qh = CELL == kGru && q == 2 ? 3 : q;
              float* o = dgx + row * GH + q * H + u;
              if (HOIST) {
                // d_hw (f32, the GRU's n slice dn r) for dW_h, d_xw out.
                *reinterpret_cast<float2*>(o) =
                    make_float2(dg[qh][0], dg[qh][1]);
                *reinterpret_cast<__nv_bfloat162*>(dxw + row * GH + q * H +
                                                   u) =
                    __floats2bfloat162_rn(dg[q][0], dg[q][1]);
              } else {
                *reinterpret_cast<float2*>(o) =
                    make_float2(dg[q][0], dg[q][1]);
              }
            }
            if (CELL == kGru && !HOIST)
              *reinterpret_cast<float2*>(dhn + row * H + u) =
                  make_float2(dg[3][0], dg[3][1]);
          }
#pragma unroll
          for (int q = 0; q < G; ++q) {
            const int qh = CELL == kGru && q == 2 ? 3 : q;
            __nv_bfloat162 hi, lo;
            split_bf16(dg[qh][0], dg[qh][1], hi, lo);
            __nv_bfloat16* d = dg_s + r * LW + q * U + ul;
            *reinterpret_cast<__nv_bfloat162*>(d) = hi;
            *reinterpret_cast<__nv_bfloat162*>(d + BB * LW) = lo;
          }
        }
    }
    __syncthreads();  // the d tiles are complete; tile t & 1 is free
    if (t >= 2) load_h(t - 2, t & 1);
    cp_async_commit();

    // The carry's product over the CTA's own gate columns, d_hw[:, own] @
    // W_h[:, own]^T, for the output chunks c = warp + NW i (units 8 c ..
    // 8 c + 7), NCH of them at a time; each chunk into the receive buffer
    // of the CTA that owns it, at this rank's slot.
    const int nch = (W - warp + NW - 1) / NW;  // >= 1: NW <= W
    for (int pass = 0; pass * NCH < nch; ++pass) {
      float pacc[NCH][RT][4];
#pragma unroll
      for (int s = 0; s < NCH; ++s)
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int i = 0; i < 4; ++i) pacc[s][rt][i] = 0.0f;
      for (int ks = 0; ks < GUP / 16; ++ks) {
        uint32_t a[RT][kSplit][4];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int p = 0; p < kSplit; ++p)
            ldmatrix_x4(a[rt][p], dg_s + p * BB * LW +
                                      (rt * 16 + arow) * LW + ks * 16 + acol);
#pragma unroll
        for (int s = 0; s < NCH; ++s) {
          // Branch-free: a slot past the last chunk repeats it (not
          // stored), so the slots' loads and products interleave.
          const int c = min(warp + NW * (pass * NCH + s), W - 1);
          // B of d @ W_h^T: share rows 8 c .. 8 c + 7, k-offset 0 or 8.
          uint32_t r2[2];
          ldmatrix_x2(r2, wh_s + (size_t)(8 * c + (lane & 7)) * LW + ks * 16 +
                              ((lane >> 3) & 1) * 8);
          const uint2 bk = make_uint2(r2[0], r2[1]);
#pragma unroll
          for (int rt = 0; rt < RT; ++rt)
#pragma unroll
            for (int p = 0; p < kSplit; ++p)
              mma_bf16(pacc[s][rt], a[rt][p], bk);
        }
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
            const int r = rt * 16 + row_l + 8 * half;
            *reinterpret_cast<float2*>(dst + r * LR + lu) = make_float2(
                pacc[s][rt][2 * half], pacc[s][rt][2 * half + 1]);
          }
      }
    }
    cluster_arrive();
    // While the partials travel: the next step's inputs and gates, which
    // do not need the carry.
    if (t > 0) {
      cp_async_wait<1>();  // h_{t-2}'s tile is in place
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
          const int r = rt * 16 + row_l + 8 * half;
          const float* in = recv_s + r * LR + ul;
          float2 sum = *reinterpret_cast<const float2*>(in);
          for (int j = 1; j < C; ++j) {
            const float2 v =
                *reinterpret_cast<const float2*>(in + (size_t)j * BB * LR);
            sum.x += v.x;
            sum.y += v.y;
          }
          dhc[rt][2 * half] += sum.x;
          dhc[rt][2 * half + 1] += sum.y;
        }
    }
    cluster_arrive();  // this CTA's buffer is read
  }
  // No CTA leaves while a peer could still store into its shared memory.
  cluster_wait();
}

// The launch configuration of kernel 1 (grid, block, cluster, shared
// memory), with the attributes it needs set on the kernel.
template <int CELL, int RT, typename XW>
cudaError_t recur_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                         int S, int B, int H, int C, cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int rows = 16 * RT;
  auto kern = rnn_bwd_cluster_kernel<CELL, RT, XW>;
  const size_t smem = recur_smem_bytes(G, H, C, rows);
  cfg = {};
  cfg.gridDim = dim3(C * ((B + rows - 1) / rows), S);
  cfg.blockDim = dim3(warps_per_cta(H, C) * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (C > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// Clusters of kernel 1 the card can hold at once (0: none).
template <int CELL, int RT, typename XW>
cudaError_t recur_clusters(int* clusters, int H, int C) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      recur_config<CELL, RT, XW>(cfg, attr, 1, 16 * RT, H, C, nullptr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(
      clusters, rnn_bwd_cluster_kernel<CELL, RT, XW>, &cfg);
}

// Kernel 1 through cudaLaunchKernelEx; refused
// (cudaErrorLaunchOutOfResources) when the card cannot hold one cluster.
template <int CELL, int RT, typename XW>
cudaError_t launch_recur(const XW* xw, const void* whp, const uint8_t* m,
                         const void* h_all, const void* c_all, const void* dh,
                         float* dgx, float* dhn, void* dxw, int S, int B,
                         int Tn, int H, int C, SeedStrides st,
                         float forget_bias, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = recur_config<CELL, RT, XW>(cfg, attr, S, B, H, C, stream);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, rnn_bwd_cluster_kernel<CELL, RT, XW>, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters == 0) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(
      &cfg, rnn_bwd_cluster_kernel<CELL, RT, XW>, xw,
      static_cast<const __nv_bfloat16*>(whp), m,
      static_cast<const __nv_bfloat16*>(h_all),
      CELL == kLstm ? static_cast<const __nv_bfloat16*>(c_all) : nullptr,
      static_cast<const __nv_bfloat16*>(dh), dgx, dhn,
      static_cast<__nv_bfloat16*>(dxw), B, Tn, H, st, forget_bias);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The shapes the kernels take: 128 < H <= 512, H % 16 == 0, C in {2, 4,
// 8, 16}, 16 or 32 rows, and the CTA's warps within the row count's thread
// limit.
bool supported(int H, int C, int rows) {
  if (H <= 128 || H > kMaxWidth || H % 16 != 0) return false;
  if (C != 2 && C != 4 && C != 8 && C != kMaxCluster) return false;
  if (rows != 16 && rows != 32) return false;
  return warps_per_cta(H, C) * 32 <= max_threads(rows / 16);
}

template <int CELL, typename XW>
cudaError_t dispatch_rows(int rows, const XW* xw, const void* whp,
                          const uint8_t* m, const void* h_all,
                          const void* c_all, const void* dh, float* dgx,
                          float* dhn, void* dxw, int S, int B, int Tn, int H,
                          int C, SeedStrides st, float fb, cudaStream_t s) {
  if (rows == 16)
    return launch_recur<CELL, 1, XW>(xw, whp, m, h_all, c_all, dh, dgx, dhn,
                                     dxw, S, B, Tn, H, C, st, fb, s);
  return launch_recur<CELL, 2, XW>(xw, whp, m, h_all, c_all, dh, dgx, dhn,
                                   dxw, S, B, Tn, H, C, st, fb, s);
}

template <int CELL, typename XW>
cudaError_t clusters_rows(int* n, int rows, int H, int C) {
  if (rows == 16) return recur_clusters<CELL, 1, XW>(n, H, C);
  return recur_clusters<CELL, 2, XW>(n, H, C);
}

template <int CELL>
cudaError_t launch_fused(const void* hin, const void* wx, const void* b,
                         const void* whp, const uint8_t* m, const void* h_all,
                         const void* c_all, const void* dh, void* dhin,
                         float* dgx, float* dhn, float* partial, int slices,
                         float* dw, int S, int B, int Tn, int H, int C,
                         int rows, bool have_xw, long long s_hin,
                         long long s_wx, long long s_b, long long s_wh,
                         long long s_m, float fb, cudaStream_t cs) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  const int M = B * Tn;
  const long long s_gates = (long long)M * G * H;
  cudaError_t err;
  if (!have_xw) {
    err = launch_gemm(hin, wx, b, dgx, M, G * H, H, S, s_hin, s_wx, s_b,
                      s_gates, cs);
    if (err != cudaSuccess) return err;
  }
  const SeedStrides st{s_gates, s_wh, s_m};
  err = dispatch_rows<CELL, float>(rows, dgx, whp, m, h_all, c_all, dh, dgx,
                                   dhn, nullptr, S, B, Tn, H, C, st, fb, cs);
  if (err != cudaSuccess) return err;
  err = launch_wgrad<CELL, false>(hin, h_all, dgx, dhn, partial, slices, dw,
                                  S, B, Tn, H, s_hin, cs);
  if (err != cudaSuccess) return err;
  return launch_dhin(dgx, wx, dhin, S, M, H, G * H, s_wx, cs);
}

template <int CELL>
cudaError_t launch_hoisted(const void* xw, const void* whp, const uint8_t* m,
                           const void* h_all, const void* c_all,
                           const void* dh, void* dxw, float* dgx,
                           float* partial, int slices, float* dw, int S,
                           int B, int Tn, int H, int C, int rows,
                           long long s_xw, long long s_wh, long long s_m,
                           float fb, cudaStream_t cs) {
  const SeedStrides st{s_xw, s_wh, s_m};
  cudaError_t err = dispatch_rows<CELL, __nv_bfloat16>(
      rows, static_cast<const __nv_bfloat16*>(xw), whp, m, h_all, c_all, dh,
      dgx, nullptr, dxw, S, B, Tn, H, C, st, fb, cs);
  if (err != cudaSuccess) return err;
  return launch_wgrad<CELL, true>(nullptr, h_all, dgx, nullptr, partial,
                                  slices, dw, S, B, Tn, H, 0, cs);
}

}  // namespace

// Shared memory of kernel 1 (the largest of the launches) in bytes; -1 for
// a shape the kernels do not take. cell: 0 = LSTM, 1 = GRU; C: CTAs per
// cluster; rows: batch rows per cluster (16 or 32).
extern "C" long long lfm_rnn_bwd_cluster_smem(int cell, int H, int C,
                                              int rows) {
  if (!supported(H, C, rows) || (cell != kLstm && cell != kGru)) return -1;
  return (long long)recur_smem_bytes(cell == kLstm ? 4 : 3, H, C, rows);
}

// Clusters of kernel 1 the current card holds at once for this shape (the
// fused form's kernel 1 reads f32 xw, the hoisted form's bf16); -1 for a
// shape the kernels do not take or a CUDA error.
extern "C" int lfm_rnn_bwd_cluster_clusters(int cell, int fused, int H,
                                            int C, int rows) {
  if (!supported(H, C, rows) || (cell != kLstm && cell != kGru)) return -1;
  int n = 0;
  cudaError_t err;
  if (cell == kLstm)
    err = fused ? clusters_rows<kLstm, float>(&n, rows, H, C)
                : clusters_rows<kLstm, __nv_bfloat16>(&n, rows, H, C);
  else
    err = fused ? clusters_rows<kGru, float>(&n, rows, H, C)
                : clusters_rows<kGru, __nv_bfloat16>(&n, rows, H, C);
  return err == cudaSuccess ? n : -1;
}

// The bfloat16 backward above hidden 128 for S seeds in one call.
// fused = 1: xin is hin [B, T, H] bf16 per seed, wx [H, G H] and b [G H]
// bf16 are used; dgx [S, B, T, G H] f32 is the d_gates buffer, which holds
// the forward's xw (have_xw = 1: kernel 0 is skipped) or is filled by
// kernel 0, and leaves holding d_xw; dhn [S, B, T, H] f32 is the GRU's
// scratch for dn r (LSTM: null); out dx = dhin [S, B, T, H] bf16 and dw
// [S, 2 H G H + G H] f32 (dW_x, db, dW_h). fused = 0: xin is xw [B, T,
// G H] bf16 (wx, b, dhn unused); out dx = dxw [S, B, T, G H] bf16 and dw
// [S, H G H] f32 (dW_h); dgx [S, B, T, G H] f32 is scratch for d_hw. Per
// seed: whp, W_h packed per CTA for a cluster of C (ops/rnn.py
// pack_cluster_bwd); m uint8 [B, T]; h_all, c_all (LSTM; the GRU passes
// null), dh [S, B, T, H] bf16. partial [S, slices, total] f32 is scratch.
// rows: batch rows per cluster (16 or 32). s_*: the seed strides of xin,
// wx, b, whp and m in their elements (0: shared). Returns the first CUDA
// error of its launches.
extern "C" int lfm_rnn_bwd_cluster(
    int cell, int fused, const void* xin, const void* wx, const void* b,
    const void* whp, const void* m, const void* h_all, const void* c_all,
    const void* dh, void* dx, void* dgx, void* dhn, void* partial,
    int slices, void* dw, int S, int B, int Tn, int H, int C, int rows,
    int have_xw, long long s_xin, long long s_wx, long long s_b,
    long long s_wh, long long s_m, float forget_bias, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (S <= 0 || S > 65535 || B <= 0 || Tn <= 0 || slices <= 0 ||
      slices > 65535 || !supported(H, C, rows) ||
      (cell != kLstm && cell != kGru))
    return (int)cudaErrorInvalidValue;
  const auto* mm = static_cast<const uint8_t*>(m);
  float* g = static_cast<float*>(dgx);
  float* p = static_cast<float*>(partial);
  float* w = static_cast<float*>(dw);
  if (fused) {
    float* n = static_cast<float*>(dhn);
    if (cell == kLstm)
      return (int)launch_fused<kLstm>(
          xin, wx, b, whp, mm, h_all, c_all, dh, dx, g, n, p, slices, w, S,
          B, Tn, H, C, rows, have_xw != 0, s_xin, s_wx, s_b, s_wh, s_m,
          forget_bias, cs);
    return (int)launch_fused<kGru>(
        xin, wx, b, whp, mm, h_all, c_all, dh, dx, g, n, p, slices, w, S, B,
        Tn, H, C, rows, have_xw != 0, s_xin, s_wx, s_b, s_wh, s_m,
        forget_bias, cs);
  }
  if (cell == kLstm)
    return (int)launch_hoisted<kLstm>(xin, whp, mm, h_all, c_all, dh, dx, g,
                                      p, slices, w, S, B, Tn, H, C, rows,
                                      s_xin, s_wh, s_m, forget_bias, cs);
  return (int)launch_hoisted<kGru>(xin, whp, mm, h_all, c_all, dh, dx, g, p,
                                   slices, w, S, B, Tn, H, C, rows, s_xin,
                                   s_wh, s_m, forget_bias, cs);
}
