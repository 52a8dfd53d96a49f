// Masked LSTM/GRU recurrence, fused and hoisted backward, in float32 on
// Hopper's tensor cores (3xTF32 mma.sync) past the widths a cluster holds:
// every step's gates recomputed by one GEMM ahead of the recurrence, and the
// carry's product spread over the whole card, W_h resident across a group
// of up to 132 co-resident CTAs that meet at a barrier in device memory.
//
// Replaces, in float32 with 176 < Hp <= kMaxWidth (Hp the width padded to a
// multiple of 16; ops/rnn.py _mma_route "grid"), the Pallas TPU kernels
// _lstm_fused_bwd_kernel (lfm_quant_tpu/ops/pallas_rnn.py:673) and
// _gru_fused_bwd_kernel (:739), reached through _fused_bwd_call (:835), and
// _lstm_bwd_kernel (:184) and _gru_bwd_kernel (:243), reached through
// _bwd_call (:407), with their seed rules (_bwd_vmap :952,
// _make_scan._bwd_vmap :541). It computes what csrc/rnn_bwd.cu computes in
// float32 (the formulas are written out there; the cell's backward is
// csrc/tf32_common.cuh's cell_bwd, shared with csrc/rnn_bwd_tf32.cu).
//
// Bound. At Hp 400, B 2048, T 60 the fused LSTM is 6 products of 2 H G H a
// row and step: 9.4e11 operations, 5.72 ms at the 3xTF32 rate (495 / 3
// TFLOP/s) and 14.1 ms at 67 TFLOP/s outside the tensor cores, against 2 GB
// of inputs and outputs (0.6 ms at 3.35 TB/s); the hoisted form does 3 of
// the 6 (2.86 ms). Bound by operations, and more so at wider H (Hp 1024:
// 37.5 ms fused).
//
// Design: five of the six products are GEMMs with nothing sequential in
// them, on PR 22's 3xTF32 GEMM (csrc/tf32_common.cuh); only the carry's is
// left inside the sequential loop, and it is spread over every SM.
//
// * Kernel 0 (fused form, unless the float32 grid forward's xw scratch is
//   handed over, csrc/rnn_fwd_tf32_grid.cu):
//   xw = hin @ W_x + b into the f32 d_gates buffer dgx [S, B, T, G Hp].
// * Kernel 1, the gates: h_all shifted one step (zero at t = 0) is every
//   h_{t-1}, so the h side of every step's pre-activations is one GEMM,
//   h_prev @ W_h, added to the x side (xw + hw, the plain order) into dgx;
//   the GRU's h side of n goes apart into dhn [S, B, T, Hp], since r
//   multiplies it. The recurrence then overwrites both in place, with d_xw
//   and with dn r (the GRU's d_hw of n).
// * Kernel 2, the reverse recurrence, a cooperative launch of up to one CTA
//   an SM: groups of n CTAs; each group walks its (seed, block of `rows`
//   rows) work items in turn. CTA j of a group owns the 8-unit chunks [j W
//   / n, (j + 1) W / n) of the W = Hp / 8 (NC = ceil(W / n) at most) and
//   holds, resident in shared memory, the W_h rows of those units across
//   all G Hp gate columns (f32, [8 NC][G Hp + 4]). Warp w owns chunk w % NC
//   of the CTA and the 16 rows w / NC of the item, so a (row, unit)'s
//   carries, its cell and its share of the carry's product sit in one
//   thread's registers. Per step: the cell's backward from the recomputed
//   gates (read a step ahead), d_xw written in place, d_hw (the LSTM's
//   d_xw; the GRU's n slice dn r) to device memory; then one barrier of the
//   group (a counter in device memory: release on arrive, acquire on wait);
//   then the group's whole d_hw_t row block is read back from L2 (cp.async
//   .cg, 64 columns a stage, double-buffered): that read is the
//   all-gather; each CTA forms dh for its own units, d_hw_t @ W_h[own]^T,
//   in one fixed k order (chains of kChainK), so the sums are bitwise
//   repeatable and do not depend on n or on the rows of an item. No
//   atomics but the barrier's counter, no partial sums. The last step's
//   carry (into h_{-1}) is not formed. A barrier that waits past about two
//   seconds traps instead of hanging (a CTA of the group is not running).
// * Kernels 3 and 4, csrc/rnn_bwd_tf32.cu's weight gradients (dW_x with db,
//   dW_h; per-slice partial sums added in a fixed order), and kernel 5
//   (fused form) its GEMM dhin = d_xw @ W_x^T.
// * Seeds (pallas_rnn.py _bwd_vmap :952): the GEMMs' blockIdx.z; kernel 2's
//   work items run over seeds and row blocks, the CTA reloading its W_h
//   rows where the seed's W_h differs; each shared operand has its own
//   seed stride (0: shared), every per-seed offset is 64-bit, and a seed's
//   outputs are bitwise those of a one-seed launch.
// * The grid is launched with cudaLaunchCooperativeKernel, so every CTA of
//   a group is resident while the others wait for it; a grid the card
//   cannot hold is refused (cudaErrorCooperativeLaunchTooLarge), never run
//   another way. The dealing of chunks, the barrier, the capacity and the
//   launch are csrc/grid_common.cuh's, shared with csrc/rnn_bwd_grid.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"
#include "mma_common.cuh"
#include "tf32_common.cuh"

namespace {

using lfm_grid::chunks_per_cta;
using lfm_grid::group_barrier;
using lfm_grid::group_pos;
using lfm_grid::GroupPos;
using lfm_grid::kUnits;
using lfm_grid::threads_of;
using lfm_mma::cp_async16;
using lfm_mma::cp_async_commit;
using lfm_mma::cp_async_wait_all;
using lfm_tf32::cell_bwd;
using lfm_tf32::cp_async_wait;
using lfm_tf32::frag_a;
using lfm_tf32::frag_b;
using lfm_tf32::FragA;
using lfm_tf32::FragB;
using lfm_tf32::GatesArgs;
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
using lfm_tf32::wgrad_smem_bytes;

constexpr int kMaxWidth = 1024; // the widest Hp
// d_hw columns per stage of the carry, and stages in shared memory (one
// in flight while the other is multiplied): 64 columns in 2 stages beat 32
// in 4 (3 in flight) by 5-15% of the recurrence at H 400 and 1024, and
// more stages in flight did not help (scripts/torch_cluster_variants.py
// --direction bwd_grid, variants stage_k32_4, stage_k32_2, stage_k64_3).
constexpr int kStageK = 64;
constexpr int kStages = 2;
constexpr int kMaxThreads = 512;

// Kernel 2's shared memory, f32: the W_h rows [8 NC][G H + 4] and
// kStages stages of d_hw [rows][kStageK + 4]. ops/rnn.py _grid_smem
// mirrors it.
inline size_t grid_smem_bytes(int G, int H, int n, int rows) {
  return 4 * ((size_t)kUnits * chunks_per_cta(H, n) * (G * H + 4) +
              (size_t)kStages * rows * (kStageK + 4));
}

// The shapes kernel 2 takes: 128 < H <= kMaxWidth, H % 16 == 0 (the route
// gives it H > 176; at 176 and below it is timed beside the cluster form);
// rows 64 or 128; 1 <= n <= W with every CTA owning a chunk and at most
// kMaxThreads threads.
bool supported(int H, int n, int rows) {
  if (H <= 128 || H > kMaxWidth || H % 16 != 0) return false;
  if (rows != 64 && rows != 128) return false;
  if (n < 1 || n > H / kUnits) return false;
  return threads_of(H, n, rows) <= kMaxThreads;
}

// Kernel 2. grid = groups * n CTAs of threads_of(H, n, rows) threads.
// dgx [S, B, T, G H] f32: the gates' pre-activations on entry, d_xw on
// exit; dhn (GRU) [S, B, T, H]: the h side of n on entry, dn r on exit;
// wh [., H, G H] (seed stride s_wh, 0: shared); m uint8 [., B, T] (s_m);
// h_all, c_all (LSTM), dh [S, B, T, H]; sync: one zeroed counter a group;
// stats (null: none) [grid][2]: each CTA's SM cycles waiting at the
// barriers and in all.
template <int CELL>
__global__ void __launch_bounds__(kMaxThreads, 1)
rnn_bwd_tf32_grid_kernel(const float* __restrict__ wh,
                         const uint8_t* __restrict__ m,
                         const float* __restrict__ h_all,
                         const float* __restrict__ c_all,
                         const float* __restrict__ dh, float* dgx, float* dhn,
                         unsigned* sync, long long* stats, int seeds, int B,
                         int Tn, int H, int n, int rows, long long s_wh,
                         long long s_m, float forget_bias) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int LA = kStageK + 4;  // d_hw stage row stride
  const int GH = G * H;
  const int LW = GH + 4;           // W_h row stride
  const int W = H / kUnits;
  const int NC = blockDim.x / (32 * (rows / 16));
  const GroupPos gp = group_pos(n, W);
  const int groups = gp.groups;
  const int w0 = gp.w0;    // first own chunk
  const int own = gp.own;  // own chunks
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int chunk = warp % NC;
  const int ra = (warp / NC) * 16 + g;  // the thread's rows ra, ra + 8
  const bool active = chunk < own;      // warp-uniform
  const int u = (w0 + chunk) * kUnits + 2 * c4;  // its units u, u + 1
  const int NS = (GH + kStageK - 1) / kStageK;   // stages of the carry

  extern __shared__ __align__(16) float smem[];
  float* wh_s = smem;
  float* a_s = wh_s + (size_t)NC * kUnits * LW;

  const size_t M = (size_t)B * Tn;
  const int nblk = (B + rows - 1) / rows;
  const int items = seeds * nblk;
  unsigned* ctr = sync + gp.group;
  unsigned target = 0;
  int loaded = -1;
  const long long started = clock64();
  long long waited = 0;  // thread 0's

  for (int item = gp.group; item < items; item += groups) {
    const int seed = item / nblk;
    const int r0 = (item - seed * nblk) * rows;
    const int nr = min(rows, B - r0);
    const int wseed = s_wh != 0 ? seed : 0;
    if (wseed != loaded) {
      // Every warp is done with the rows of the last seed's W_h.
      __syncthreads();
      const float* src =
          wh + (size_t)wseed * s_wh + (size_t)w0 * kUnits * GH;
      const int CW = GH / 4;
      for (int i = tid; i < own * kUnits * CW; i += nth) {
        const int uu = i / CW;
        const int j = (i - uu * CW) * 4;
        cp_async16(wh_s + (size_t)uu * LW + j, src + (size_t)uu * GH + j,
                   16);
      }
      cp_async_commit();
      loaded = wseed;
    }
    const float* hs = h_all + (size_t)seed * M * H;
    const float* cs = CELL == kLstm ? c_all + (size_t)seed * M * H : nullptr;
    const float* ds = dh + (size_t)seed * M * H;
    const uint8_t* ms = m + (size_t)seed * s_m;
    float* gs = dgx + (size_t)seed * M * GH;
    float* ns = CELL == kGru ? dhn + (size_t)seed * M * H : nullptr;

    // A step's inputs at rows ra + 8 half, units u, u + 1, read a step
    // ahead of its cell: the gates' pre-activations (LSTM i, f, g, o; GRU
    // z, r, n's x side, then n's h side), dh_t, c_{t-1} (LSTM) or h_{t-1}
    // (GRU), and the step's validity.
    float2 pre[2][4], dup[2], prev[2];
    bool keep[2];
    auto load_step = [&](int t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = ra + 8 * half;
        const bool in = active && r < nr;
        const size_t row = (size_t)(r0 + r) * Tn + t;
        const float2 z = make_float2(0.0f, 0.0f);
        keep[half] = in && ms[row] != 0;
#pragma unroll
        for (int q = 0; q < G; ++q)
          pre[half][q] =
              in ? *reinterpret_cast<const float2*>(gs + row * GH + q * H + u)
                 : z;
        if (CELL == kGru)
          pre[half][3] =
              in ? *reinterpret_cast<const float2*>(ns + row * H + u) : z;
        dup[half] = in ? *reinterpret_cast<const float2*>(ds + row * H + u)
                       : z;
        const float* pv = CELL == kLstm ? cs : hs;
        prev[half] = in && t > 0 ? *reinterpret_cast<const float2*>(
                                       pv + (row - 1) * H + u)
                                 : z;
      }
    };

    // Carries, [half * 2 + e] as the accumulators: dh, and for the LSTM dc
    // and c_t (the next step's c_{t-1} is read a step ahead).
    float dhc[4], dcc[4], ccur[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ra + 8 * half;
      float2 c = make_float2(0.0f, 0.0f);
      if (CELL == kLstm && active && r < nr)
        c = *reinterpret_cast<const float2*>(
            cs + ((size_t)(r0 + r) * Tn + Tn - 1) * H + u);
      ccur[2 * half] = c.x;
      ccur[2 * half + 1] = c.y;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dhc[2 * half + e] = 0.0f;
        dcc[2 * half + e] = 0.0f;
      }
    }
    load_step(Tn - 1);
    cp_async_wait_all();  // this seed's W_h rows are in place
    __syncthreads();

    for (int t = Tn - 1; t >= 0; --t) {
      if (active) {
        // The cell's backward, in registers: d_xw (and the GRU's dn r) in
        // place of the pre-activations; the carries' elementwise part.
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = ra + 8 * half;
          const size_t row = (size_t)(r0 + r) * Tn + t;
          const float kp = keep[half] ? 1.0f : 0.0f;
          float dg[4][2];  // [gate][e]; GRU: 3 = dn r
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * half + e;
            float a[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              a[q] = e ? pre[half][q].y : pre[half][q].x;
            const float pv = e ? prev[half].y : prev[half].x;
            float d[4];
            cell_bwd<CELL>(a, e ? dup[half].y : dup[half].x, kp, ccur[i],
                           CELL == kLstm ? pv : 0.0f,
                           CELL == kGru ? pv : 0.0f, forget_bias, dhc[i],
                           dcc[i], d);
#pragma unroll
            for (int q = 0; q < 4; ++q) dg[q][e] = d[q];
            if (CELL == kLstm) ccur[i] = pv;
          }
          if (r < nr) {
#pragma unroll
            for (int q = 0; q < G; ++q)
              *reinterpret_cast<float2*>(gs + row * GH + q * H + u) =
                  make_float2(dg[q][0], dg[q][1]);
            if (CELL == kGru)
              *reinterpret_cast<float2*>(ns + row * H + u) =
                  make_float2(dg[3][0], dg[3][1]);
          }
        }
      }
      if (t == 0) break;  // no carry into h_{-1}
      load_step(t - 1);

      // The group's barrier: this CTA's d_hw_t is written; wait for the
      // other CTAs' (the counter counts every CTA's arrivals).
      group_barrier(ctr, target, n, waited);

      // The carry's product: the group's d_hw_t [rows, G H] read back from
      // L2 in stages of kStageK columns (the all-gather), kStages - 1 of
      // them in flight, times the own units' W_h rows, in chains of
      // kChainK of k.
      const size_t base = (size_t)r0 * Tn + t;
      auto load_stage = [&](int s) {
        float* dst = a_s + (s % kStages) * rows * LA;
        const int j0 = s * kStageK;
        constexpr int CK = kStageK / 4;
        for (int i = tid; i < rows * CK; i += nth) {
          const int r = i / CK;
          const int kc = (i - r * CK) * 4;
          const bool ok = r < nr && j0 + kc < GH;
          // The GRU's n columns (from 2 H, a multiple of 32) from dhn.
          const bool nside = CELL == kGru && j0 + kc >= 2 * H;
          const size_t row = base + (size_t)r * Tn;
          const float* src = !ok ? gs
                             : nside ? ns + row * H + j0 - 2 * H + kc
                                     : gs + row * GH + j0 + kc;
          cp_async16(dst + r * LA + kc, src, ok ? 16 : 0);
        }
      };
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float cacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < NS) load_stage(s);
        cp_async_commit();
      }
      for (int s = 0; s < NS; ++s) {
        cp_async_wait<kStages - 2>();
        // Stage s is in place; every warp is done with stage s - 1's slot.
        __syncthreads();
        if (s + kStages - 1 < NS) load_stage(s + kStages - 1);
        cp_async_commit();
        if (!active) continue;
        const int j0 = s * kStageK;
        const float* ap = a_s + (s % kStages) * rows * LA + ra * LA + c4;
        const float* bp =
            wh_s + (size_t)(chunk * kUnits + g) * LW + j0 + c4;
        const int kn = min(kStageK, GH - j0);
        for (int kk = 0; kk < kn; kk += 8) {
          FragA a;
          frag_a(a, ap[kk], ap[8 * LA + kk], ap[kk + 4], ap[8 * LA + kk + 4]);
          FragB b;
          frag_b(b, bp[kk], bp[kk + 4]);
          mma3(cacc, a, b);
        }
        if ((j0 + kStageK) % kChainK == 0 || s == NS - 1) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i] += cacc[i];
            cacc[i] = 0.0f;
          }
        }
      }
      if (active) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dhc[i] = dhc[i] + acc[i];
      }
    }
  }
  cp_async_wait_all();
  if (stats != nullptr && tid == 0) {
    stats[2 * blockIdx.x] = waited;
    stats[2 * blockIdx.x + 1] = clock64() - started;
  }
}

// CTAs of kernel 2 the current card holds at once for this shape, with
// the shared memory it needs set on the kernel.
template <int CELL>
cudaError_t grid_capacity(int* ctas, int H, int n, int rows) {
  return lfm_grid::capacity(rnn_bwd_tf32_grid_kernel<CELL>, ctas,
                            threads_of(H, n, rows),
                            grid_smem_bytes(CELL == kLstm ? 4 : 3, H, n, rows));
}

// fused: kernel 0 (skipped when xw_ready, dgx holding xw already), the
// gates, the recurrence, the weight gradients, their slices' sum, dhin;
// hoisted: the gates (x side from xin), the recurrence, the weight
// gradients and their sum. *kernels (null: not counted) adds one a kernel
// launched.
template <int CELL>
cudaError_t launch(bool fused, bool xw_ready, int* kernels,
                   const float* xin, const float* wx,
                   const float* b, const float* wh, const uint8_t* m,
                   const float* h_all, const float* c_all, const float* dh,
                   float* dx, float* dgx, float* dhn, float* partial, int S,
                   float* dw, unsigned* sync, long long* stats, int seeds,
                   int B, int Tn, int H,
                   int n, int rows, int groups, long long s_xin,
                   long long s_wx, long long s_b, long long s_wh,
                   long long s_m, float forget_bias, cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  const int GH = G * H;
  const int M = B * Tn;
  const long long s_gates = (long long)M * GH;
  const long long s_seq = (long long)M * H;
  const int threads = threads_of(H, n, rows);
  const size_t smem = grid_smem_bytes(G, H, n, rows);
  // A grid the card cannot hold at once is refused before any launch.
  cudaError_t err = lfm_grid::check_fits(rnn_bwd_tf32_grid_kernel<CELL>,
                                         groups, n, threads, smem);
  if (err != cudaSuccess) return err;
  int launched = 0;
  auto counted = [&](cudaError_t e, int n_kernels) {
    if (e == cudaSuccess) launched += n_kernels;
    if (kernels != nullptr) *kernels = launched;
    return e;
  };
  if (fused && !xw_ready) {
    err = counted(launch_gemm<false>(xin, wx, b, dgx, M, GH, H, seeds, s_xin,
                                     s_wx, s_b, s_gates, stream),
                  1);
    if (err != cudaSuccess) return err;
  }
  const GatesArgs ga{fused ? nullptr : xin, dhn, Tn,
                     CELL == kLstm ? GH : 2 * H, fused ? 0 : s_xin, s_seq};
  err = counted(launch_gemm<false, true>(h_all, wh, nullptr, dgx, M, GH, H,
                                         seeds, s_seq, s_wh, 0, s_gates,
                                         stream, ga),
                1);
  if (err != cudaSuccess) return err;

  float fb = forget_bias;
  void* args[] = {(void*)&wh,    (void*)&m,    (void*)&h_all, (void*)&c_all,
                  (void*)&dh,    (void*)&dgx,  (void*)&dhn,   (void*)&sync,
                  (void*)&stats, (void*)&seeds, (void*)&B,    (void*)&Tn,
                  (void*)&H,     (void*)&n,    (void*)&rows,  (void*)&s_wh,
                  (void*)&s_m,   (void*)&fb};
  err = counted(lfm_grid::launch(rnn_bwd_tf32_grid_kernel<CELL>, groups, n,
                                 threads, smem, args, stream),
                1);
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
  err = counted(cudaGetLastError(), 1);
  if (err != cudaSuccess) return err;
  const int total = fused ? 2 * H * GH + GH : H * GH;
  rnn_bwd_tf32_slices_kernel<<<dim3((total + 255) / 256, seeds), 256, 0,
                               stream>>>(partial, S, total, dw);
  err = counted(cudaGetLastError(), 1);
  if (err != cudaSuccess || !fused) return err;
  return counted(launch_gemm<true>(dgx, wx, nullptr, dx, M, H, GH, seeds,
                                   s_gates, s_wx, 0, s_seq, stream),
                 1);
}

}  // namespace

// Kernel 2's shared memory with a group of n CTAs and `rows` rows a work
// item, in bytes; -1 for a shape it does not take. cell: 0 = LSTM, 1 = GRU.
extern "C" long long lfm_rnn_bwd_grid_smem(int cell, int H, int n, int rows) {
  if (!supported(H, n, rows) || (cell != kLstm && cell != kGru)) return -1;
  return (long long)grid_smem_bytes(cell == kLstm ? 4 : 3, H, n, rows);
}

// CTAs of kernel 2 the current card holds at once for this shape (one an
// SM where its shared memory allows no more); -1 for a shape it does not
// take or a CUDA error.
extern "C" int lfm_rnn_bwd_grid_ctas(int cell, int H, int n, int rows) {
  if (!supported(H, n, rows) || (cell != kLstm && cell != kGru)) return -1;
  int ctas = 0;
  const cudaError_t err = cell == kLstm
                              ? grid_capacity<kLstm>(&ctas, H, n, rows)
                              : grid_capacity<kGru>(&ctas, H, n, rows);
  return err == cudaSuccess ? ctas : -1;
}

// The float32 backward past a cluster's widths, for `seeds` seeds in one
// call. fused = 1: xin is hin [B, T, H], and wx [H, G H], b [G H] are used;
// out dx = dhin [seeds, B, T, H] and dw [seeds, 2 H G H + G H] (dW_x, db,
// dW_h). fused = 2: as 1, with dgx holding xw = hin @ W_x + b already (the
// forward's scratch): no xw GEMM. fused = 0: xin is xw [B, T, G H] (wx, b,
// dx unused); out dgx = dxw and dw [seeds, H G H] (dW_h). Per seed: wh [H,
// G H]; m uint8 [B, T]; h_all, c_all (LSTM; the GRU passes null), dh
// [seeds, B, T, H]. s_*: the seed strides of xin, wx, b, wh and m in their
// elements (0: shared). Scratch the caller allocates: dgx [seeds, B, T, G
// H] (the fused form's d_xw), dhn [seeds, B, T, H] (GRU), partial [seeds,
// S, total], sync [groups] uint32 zeroed; stats (null, or [groups n][2]
// int64: each CTA's cycles at the barriers and in all). n: CTAs a group,
// rows: batch rows a work item, groups: the groups launched (at most what
// the card holds: lfm_rnn_bwd_grid_ctas / n). All f32. kernels (null, or
// one host int): the kernels launched. Returns the first CUDA error of its
// launches.
extern "C" int lfm_rnn_bwd_tf32_grid(
    int cell, int fused, const void* xin, const void* wx, const void* b,
    const void* wh, const void* m, const void* h_all, const void* c_all,
    const void* dh, void* dx, void* dgx, void* dhn, void* partial, int S,
    void* dw, void* sync, void* stats, int seeds, int B, int Tn, int H, int n,
    int rows, int groups, long long s_xin, long long s_wx, long long s_b,
    long long s_wh, long long s_m, float forget_bias, void* kernels,
    void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (seeds <= 0 || seeds > 65535 || B <= 0 || Tn <= 0 || S <= 0 ||
      S > 65535 || groups <= 0 || fused < 0 || fused > 2 ||
      !supported(H, n, rows))
    return (int)cudaErrorInvalidValue;
  int* nk = static_cast<int*>(kernels);
  if (nk != nullptr) *nk = 0;
#define LFM_GRID(CELLV)                                                     \
  return (int)launch<CELLV>(                                                \
      fused != 0, fused == 2, nk, static_cast<const float*>(xin),           \
      static_cast<const float*>(wx), static_cast<const float*>(b),          \
      static_cast<const float*>(wh), static_cast<const uint8_t*>(m),        \
      static_cast<const float*>(h_all), static_cast<const float*>(c_all),   \
      static_cast<const float*>(dh), static_cast<float*>(dx),               \
      static_cast<float*>(dgx), static_cast<float*>(dhn),                   \
      static_cast<float*>(partial), S, static_cast<float*>(dw),             \
      static_cast<unsigned*>(sync), static_cast<long long*>(stats), seeds, \
      B, Tn, H, n, rows, groups, s_xin, s_wx, s_b, s_wh, s_m, forget_bias,  \
      cs)
  if (cell == kLstm) LFM_GRID(kLstm);
  if (cell == kGru) LFM_GRID(kGru);
#undef LFM_GRID
  return (int)cudaErrorInvalidValue;
}
