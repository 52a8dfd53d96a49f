// Masked LSTM/GRU recurrence, fused and hoisted backward, in bfloat16 on
// Hopper's tensor cores (mma.sync m16n8k16, f32 accumulation) past the
// widths a cluster holds: every step's gates recomputed by one GEMM ahead
// of the recurrence, and the carry's product spread over the whole card,
// W_h resident in bf16 across a group of up to 132 co-resident CTAs that
// meet at a barrier in device memory.
//
// Replaces, in bfloat16 with 512 < Hp <= kMaxWidth (Hp the width padded to
// a multiple of 16; ops/rnn.py _mma_route "grid"), the Pallas TPU kernels
// _lstm_fused_bwd_kernel (lfm_quant_tpu/ops/pallas_rnn.py:673) and
// _gru_fused_bwd_kernel (:739), reached through _fused_bwd_call (:835), and
// _lstm_bwd_kernel (:184) and _gru_bwd_kernel (:243), reached through
// _bwd_call (:407), with their seed rules (_bwd_vmap :952,
// _make_scan._bwd_vmap :541). It computes what csrc/rnn_bwd.cu computes
// (the formulas are written out there; the cell's backward is
// csrc/tf32_common.cuh's cell_bwd), at the TPU kernels' rounding points as
// csrc/rnn_bwd_cluster.cu keeps them: dh and dc carried in f32, d_gates
// f32, every product with d_gates split into a bf16 hi and lo (kSplit = 2),
// dhin and dxw stored in bf16, dW_x, dW_h and db in f32.
//
// Bound. At Hp 528, B 2048, T 60 the fused LSTM is 6 products of 2 H G H a
// row and step: 1.6e12 operations, 1.66 ms at 989 TFLOP/s, against 0.8 GB
// of inputs and outputs (0.24 ms at 3.35 TB/s); the hoisted form does 3 of
// the 6 (0.83 ms). Bound by operations.
//
// Design: csrc/rnn_bwd_tf32_grid.cu's, with csrc/rnn_bwd_cluster.cu's
// numerics. Five of the six products are GEMMs with nothing sequential in
// them; only the carry's is left inside the sequential loop, and it is
// spread over every SM.
//
// * Kernel 0 (fused form): xw = hin @ W_x + b into the f32 d_gates buffer
//   dgx [S, B, T, G Hp], the bf16 GEMM of csrc/cluster_gemm.cuh; skipped
//   (fused = 2) where the caller hands over the grid forward's xw scratch
//   (csrc/rnn_fwd_grid.cu's kernel 0 is the same call, so the bits are
//   the same), which then is dgx.
// * Kernel 1, the gates: the same GEMM in its gates mode, h_all read one
//   step back (zero at t = 0) times W_h, f32 accumulation, added to the x
//   side (xw + hw, the plain order) into dgx; the GRU's h side of n goes
//   apart into dhn [S, B, T, Hp], since r multiplies it.
// * Kernel 2, the reverse recurrence, a cooperative launch of up to one CTA
//   an SM: groups of n CTAs (csrc/grid_common.cuh); each group walks its
//   (seed, block of `rows` rows) work items in turn. CTA j of a group owns
//   the 8-unit chunks [j W / n, (j + 1) W / n) of the W = Hp / 8 (NC =
//   ceil(W / n) at most) and holds, resident in shared memory, the W_h rows
//   of those units across all G Hp gate columns in bf16 ([8 NC][G Hp + 8]).
//   Warp w owns chunk w % NC of the CTA and the 16 rows w / NC of the item,
//   so a (row, unit)'s carries, its cell and its share of the carry's
//   product sit in one thread's registers. Per step: the cell's backward
//   from the recomputed gates (read a step ahead); d_xw written in place
//   (fused; the GRU's dn r into dhn) or as bf16 dxw with the f32 d_hw in
//   dgx (hoisted); d_hw split into a bf16 hi and lo pair and stored to the
//   group's exchange buffer in device memory (two buffers, alternating by
//   barrier); then one barrier of the group; then the group's whole d_hw_t
//   row block, hi and lo, is read back from L2 (cp.async.cg, 64 columns a
//   stage, double-buffered): that read is the all-gather; each CTA forms
//   dh for its own units, d_hw_t @ W_h[own]^T, two mma.sync a k-step (hi,
//   then lo) into an f32 accumulator, each stage's sum added to an f32
//   register in k order, so the sums are bitwise repeatable and depend on
//   neither n nor the rows of an item. No atomics but the barrier's
//   counter, no partial sums. The last step's carry (into h_{-1}) is not
//   formed. A barrier that waits past about two seconds traps instead of
//   hanging.
// * Kernels 3-5, csrc/bf16_wgrad.cuh's (csrc/rnn_bwd_cluster.cu's): dW_x
//   with db and dW_h (d split hi/lo as it is staged; per-slice partial sums
//   added in a fixed order), and (fused) dhin = d_xw @ W_x^T.
// * Seeds (pallas_rnn.py _bwd_vmap :952): the GEMMs' blockIdx.z; kernel 2's
//   work items run over seeds and row blocks, the CTA reloading its W_h
//   rows where the seed's W_h differs; each shared operand has its own
//   seed stride (0: shared), every per-seed offset is 64-bit, and a seed's
//   outputs are bitwise those of a one-seed launch.
// * A grid the card cannot hold at once is refused
//   (cudaErrorCooperativeLaunchTooLarge) before any launch, never run
//   another way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_wgrad.cuh"
#include "cluster_gemm.cuh"
#include "grid_common.cuh"
#include "mma_common.cuh"
#include "tf32_common.cuh"

namespace {

using lfm_bf16::split_bf16;
using lfm_grid::chunks_per_cta;
using lfm_grid::group_barrier;
using lfm_grid::group_pos;
using lfm_grid::GroupPos;
using lfm_grid::kUnits;
using lfm_grid::threads_of;
using lfm_mma::cp_async16;
using lfm_mma::cp_async_commit;
using lfm_mma::cp_async_wait_all;
using lfm_mma::ldmatrix_x2;
using lfm_mma::ldmatrix_x4;
using lfm_mma::mma_bf16;
using lfm_tf32::cell_bwd;
using lfm_tf32::cp_async_wait;
using lfm_tf32::kGru;
using lfm_tf32::kLstm;

// The widest Hp: the LSTM's W_h rows of two 8-unit chunks take 16 (4 Hp +
// 8) bytes, which beside the two 64-row stages fit an H100's 232,448 bytes
// up to Hp 1520 (a group of 95 CTAs); past it a CTA would hold three
// chunks, W past 132 CTAs' two.
constexpr int kMaxWidth = 1520;
// d_hw columns per stage of the carry (hi and lo tiles each), and stages
// in shared memory (one in flight while the other is multiplied).
constexpr int kStageK = 64;
constexpr int kStages = 2;
constexpr int kMaxThreads = 512;

// Kernel 2's shared memory, bf16: the W_h rows [8 NC][G H + 8] and kStages
// stages of the d_hw hi and lo tiles [2][rows][kStageK + 8]. ops/rnn.py
// _grid_smem mirrors it.
inline size_t grid_smem_bytes(int G, int H, int n, int rows) {
  return 2 * ((size_t)kUnits * chunks_per_cta(H, n) * (G * H + 8) +
              (size_t)kStages * 2 * rows * (kStageK + 8));
}

// The shapes kernel 2 takes: 128 < H <= kMaxWidth, H % 16 == 0 (the route
// gives it H > 512); rows 64 or 128; 1 <= n <= W with every CTA owning a
// chunk and at most kMaxThreads threads.
bool supported(int H, int n, int rows) {
  if (H <= 128 || H > kMaxWidth || H % 16 != 0) return false;
  if (rows != 64 && rows != 128) return false;
  if (n < 1 || n > H / kUnits) return false;
  return threads_of(H, n, rows) <= kMaxThreads;
}

// Kernel 2. grid = groups * n CTAs of threads_of(H, n, rows) threads.
// The hoisted form passes dxw, the fused form null. dgx [S, B, T, G H]
// f32: the gates' pre-activations on entry; on exit d_xw (fused) or d_hw
// (hoisted); dhn (GRU) [S, B, T, H]: the h side of n on entry, dn r on exit
// (fused); dxw [S, B, T, G H] bf16: d_xw out (hoisted);
// wh [., H, G H] bf16 (seed stride s_wh, 0: shared); m uint8 [., B, T]
// (s_m); h_all, c_all (LSTM), dh [S, B, T, H] bf16; xch: the exchange,
// [groups][2][2][rows][G H] bf16 (buffer, hi/lo); sync: one zeroed counter
// a group; stats (null: none) [grid][2]: each CTA's SM cycles waiting at
// the barriers and in all.
template <int CELL>
__global__ void __launch_bounds__(kMaxThreads, 1)
rnn_bwd_grid_kernel(const __nv_bfloat16* __restrict__ wh,
                    const uint8_t* __restrict__ m,
                    const __nv_bfloat16* __restrict__ h_all,
                    const __nv_bfloat16* __restrict__ c_all,
                    const __nv_bfloat16* __restrict__ dh, float* dgx,
                    float* dhn, __nv_bfloat16* __restrict__ dxw,
                    __nv_bfloat16* xch, unsigned* sync, long long* stats,
                    int seeds, int B, int Tn, int H, int n, int rows,
                    long long s_wh, long long s_m, float forget_bias) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int LA = kStageK + 8;  // d_hw stage row stride
  const int GH = G * H;
  const int LW = GH + 8;           // W_h row stride
  const int W = H / kUnits;
  const int NC = blockDim.x / (32 * (rows / 16));
  const GroupPos gp = group_pos(n, W);
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int chunk = warp % NC;
  const int rw = (warp / NC) * 16;       // the warp's first row
  const int ra = rw + g;                 // the thread's rows ra, ra + 8
  const bool active = chunk < gp.own;    // warp-uniform
  const int u = (gp.w0 + chunk) * kUnits + 2 * c4;  // its units u, u + 1
  const int NS = (GH + kStageK - 1) / kStageK;      // stages of the carry
  const bool hoist = dxw != nullptr;
  // ldmatrix row addresses: A rows 0-7 / 8-15 at k 0 / 8; W_h's unit rows
  // at k 0 / 8.
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = (lane >> 4) * 8;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* a_s = wh_s + (size_t)NC * kUnits * LW;

  const size_t M = (size_t)B * Tn;
  const int nblk = (B + rows - 1) / rows;
  const int items = seeds * nblk;
  unsigned* ctr = sync + gp.group;
  __nv_bfloat16* xg = xch + (size_t)gp.group * 4 * rows * GH;
  unsigned target = 0;
  int barriers = 0;  // the group's barriers passed: the exchange's buffer
  int loaded = -1;
  const long long started = clock64();
  long long waited = 0;  // thread 0's

  for (int item = gp.group; item < items; item += gp.groups) {
    const int seed = item / nblk;
    const int r0 = (item - seed * nblk) * rows;
    const int nr = min(rows, B - r0);
    const int wseed = s_wh != 0 ? seed : 0;
    if (wseed != loaded) {
      // Every warp is done with the rows of the last seed's W_h.
      __syncthreads();
      const __nv_bfloat16* src =
          wh + (size_t)wseed * s_wh + (size_t)gp.w0 * kUnits * GH;
      const int CW = GH / 8;
      for (int i = tid; i < gp.own * kUnits * CW; i += nth) {
        const int uu = i / CW;
        const int j = (i - uu * CW) * 8;
        cp_async16(wh_s + (size_t)uu * LW + j, src + (size_t)uu * GH + j,
                   16);
      }
      cp_async_commit();
      loaded = wseed;
    }
    const __nv_bfloat16* hs = h_all + (size_t)seed * M * H;
    const __nv_bfloat16* cs =
        CELL == kLstm ? c_all + (size_t)seed * M * H : nullptr;
    const __nv_bfloat16* ds = dh + (size_t)seed * M * H;
    const uint8_t* ms = m + (size_t)seed * s_m;
    float* gs = dgx + (size_t)seed * M * GH;
    float* ns = CELL == kGru ? dhn + (size_t)seed * M * H : nullptr;
    __nv_bfloat16* xs = hoist ? dxw + (size_t)seed * M * GH : nullptr;

    auto pair = [](const __nv_bfloat16* p) {
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    };
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
        dup[half] = in ? pair(ds + row * H + u) : z;
        const __nv_bfloat16* pv = CELL == kLstm ? cs : hs;
        prev[half] = in && t > 0 ? pair(pv + (row - 1) * H + u) : z;
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
        c = pair(cs + ((size_t)(r0 + r) * Tn + Tn - 1) * H + u);
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
      // The exchange buffer of this step's barrier: hi, then lo.
      __nv_bfloat16* xb = xg + (size_t)(barriers & 1) * 2 * rows * GH;
      if (active) {
        // The cell's backward, in registers: d_xw (and d_hw) out, d_hw
        // split into the exchange; the carries' elementwise part.
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
            for (int q = 0; q < G; ++q) {
              // d_hw's gate q: the GRU's n slice is dn r.
              const int qh = CELL == kGru && q == 2 ? 3 : q;
              float* o = gs + row * GH + q * H + u;
              if (hoist) {
                *reinterpret_cast<float2*>(o) =
                    make_float2(dg[qh][0], dg[qh][1]);
                *reinterpret_cast<__nv_bfloat162*>(xs + row * GH + q * H +
                                                   u) =
                    __floats2bfloat162_rn(dg[q][0], dg[q][1]);
              } else {
                *reinterpret_cast<float2*>(o) =
                    make_float2(dg[q][0], dg[q][1]);
              }
              if (t > 0) {
                __nv_bfloat162 hi, lo;
                split_bf16(dg[qh][0], dg[qh][1], hi, lo);
                __nv_bfloat16* x = xb + (size_t)r * GH + q * H + u;
                *reinterpret_cast<__nv_bfloat162*>(x) = hi;
                *reinterpret_cast<__nv_bfloat162*>(x + (size_t)rows * GH) =
                    lo;
              }
            }
            if (CELL == kGru && !hoist)
              *reinterpret_cast<float2*>(ns + row * H + u) =
                  make_float2(dg[3][0], dg[3][1]);
          }
        }
      }
      if (t == 0) break;  // no carry into h_{-1}
      load_step(t - 1);

      // The group's barrier: this CTA's d_hw_t is in the exchange; wait
      // for the other CTAs' (the counter counts every CTA's arrivals).
      group_barrier(ctr, target, n, waited);
      ++barriers;

      // The carry's product: the group's d_hw_t [rows, G H], hi and lo,
      // read back from L2 in stages of kStageK columns (the all-gather),
      // kStages - 1 of them in flight, times the own units' W_h rows; each
      // stage's sum added to an f32 register in k order.
      auto load_stage = [&](int s) {
        __nv_bfloat16* dst = a_s + (s % kStages) * 2 * rows * LA;
        const int j0 = s * kStageK;
        constexpr int CK = kStageK / 8;
        for (int i = tid; i < 2 * rows * CK; i += nth) {
          const int pr = i / CK;  // p * rows + r
          const int kc = (i - pr * CK) * 8;
          const int r = pr % rows;
          const bool ok = r < nr && j0 + kc < GH;
          const __nv_bfloat16* src = xb + (size_t)pr * GH + j0 + kc;
          cp_async16(dst + pr * LA + kc, ok ? src : xb, ok ? 16 : 0);
        }
      };
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
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
        const __nv_bfloat16* ap =
            a_s + (s % kStages) * 2 * rows * LA + (rw + arow) * LA + acol;
        const __nv_bfloat16* bp =
            wh_s + (size_t)(chunk * kUnits + (lane & 7)) * LW + j0 +
            ((lane >> 3) & 1) * 8;
        const int kn = min(kStageK, GH - j0);
        float cacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int kk = 0; kk < kn; kk += 16) {
          uint32_t ahi[4], alo[4], b2[2];
          ldmatrix_x4(ahi, ap + kk);
          ldmatrix_x4(alo, ap + rows * LA + kk);
          ldmatrix_x2(b2, bp + kk);
          const uint2 b = make_uint2(b2[0], b2[1]);
          mma_bf16(cacc, ahi, b);
          mma_bf16(cacc, alo, b);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += cacc[i];
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
  return lfm_grid::capacity(rnn_bwd_grid_kernel<CELL>, ctas,
                            threads_of(H, n, rows),
                            grid_smem_bytes(CELL == kLstm ? 4 : 3, H, n, rows));
}

// fused: the xw GEMM (not where xw_given: dgx holds xw), the gates, the
// recurrence, the weight gradients, their slices' sum, dhin; hoisted: the
// gates (x side from the bf16 xw), the recurrence, the weight gradients
// and their sum. *kernels (null: not counted) adds one a kernel launched.
template <int CELL, bool HOIST>
cudaError_t launch(bool xw_given, int* kernels,
                   const __nv_bfloat16* xin, const void* wx, const void* b,
                   const __nv_bfloat16* wh, const uint8_t* m,
                   const __nv_bfloat16* h_all, const __nv_bfloat16* c_all,
                   const __nv_bfloat16* dh, void* dx, float* dgx, float* dhn,
                   __nv_bfloat16* xch, float* partial, int S, float* dw,
                   unsigned* sync, long long* stats, int seeds, int B, int Tn,
                   int H, int n, int rows, int groups, long long s_xin,
                   long long s_wx, long long s_b, long long s_wh,
                   long long s_m, float forget_bias, cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  const int GH = G * H;
  const int M = B * Tn;
  const long long s_gates = (long long)M * GH;
  const long long s_seq = (long long)M * H;
  const int threads = threads_of(H, n, rows);
  const size_t smem = grid_smem_bytes(G, H, n, rows);
  auto kern = rnn_bwd_grid_kernel<CELL>;
  // A grid the card cannot hold at once is refused before any launch.
  cudaError_t err = lfm_grid::check_fits(kern, groups, n, threads, smem);
  if (err != cudaSuccess) return err;
  int launched = 0;
  auto counted = [&](cudaError_t e, int n_kernels) {
    if (e == cudaSuccess) launched += n_kernels;
    if (kernels != nullptr) *kernels = launched;
    return e;
  };
  if (!HOIST && !xw_given) {
    err = counted(lfm_cluster::launch_gemm(xin, wx, b, dgx, M, GH, H, seeds,
                                           s_xin, s_wx, s_b, s_gates,
                                           stream),
                  1);
    if (err != cudaSuccess) return err;
  }
  const lfm_cluster::GatesArgs ga{HOIST ? xin : nullptr, dhn, Tn,
                                  CELL == kLstm ? GH : 2 * H,
                                  HOIST ? s_xin : 0, s_seq};
  err = counted(lfm_cluster::launch_gemm<true>(h_all, wh, nullptr, dgx, M,
                                               GH, H, seeds, s_seq, s_wh, 0,
                                               s_gates, stream, ga),
                1);
  if (err != cudaSuccess) return err;

  __nv_bfloat16* dxw = HOIST ? static_cast<__nv_bfloat16*>(dx) : nullptr;
  float fb = forget_bias;
  void* args[] = {(void*)&wh,    (void*)&m,    (void*)&h_all, (void*)&c_all,
                  (void*)&dh,    (void*)&dgx,  (void*)&dhn,   (void*)&dxw,
                  (void*)&xch,   (void*)&sync, (void*)&stats, (void*)&seeds,
                  (void*)&B,     (void*)&Tn,   (void*)&H,     (void*)&n,
                  (void*)&rows,  (void*)&s_wh, (void*)&s_m,   (void*)&fb};
  err = counted(lfm_grid::launch(kern, groups, n, threads, smem, args,
                                 stream),
                1);
  if (err != cudaSuccess) return err;

  // The weight gradients and their slices' sum.
  err = counted(lfm_bf16::launch_wgrad<CELL, HOIST>(
                    HOIST ? nullptr : xin, h_all, dgx, HOIST ? nullptr : dhn,
                    partial, S, dw, seeds, B, Tn, H, s_xin, stream),
                2);
  if (err != cudaSuccess || HOIST) return err;
  return counted(
      lfm_bf16::launch_dhin(dgx, wx, dx, seeds, M, H, GH, s_wx, stream), 1);
}

}  // namespace

// Kernel 2's shared memory with a group of n CTAs and `rows` rows a work
// item, in bytes; -1 for a shape it does not take. cell: 0 = LSTM, 1 = GRU.
extern "C" long long lfm_rnn_bwd_grid_bf16_smem(int cell, int H, int n,
                                                int rows) {
  if (!supported(H, n, rows) || (cell != kLstm && cell != kGru)) return -1;
  return (long long)grid_smem_bytes(cell == kLstm ? 4 : 3, H, n, rows);
}

// CTAs of kernel 2 the current card holds at once for this shape (one an
// SM where its shared memory allows no more); -1 for a shape it does not
// take or a CUDA error.
extern "C" int lfm_rnn_bwd_grid_bf16_ctas(int cell, int H, int n, int rows) {
  if (!supported(H, n, rows) || (cell != kLstm && cell != kGru)) return -1;
  int ctas = 0;
  const cudaError_t err = cell == kLstm
                              ? grid_capacity<kLstm>(&ctas, H, n, rows)
                              : grid_capacity<kGru>(&ctas, H, n, rows);
  return err == cudaSuccess ? ctas : -1;
}

// The bfloat16 backward past a cluster's widths, for `seeds` seeds in one
// call. fused = 1: xin is hin [B, T, H], and wx [H, G H], b [G H] are used;
// out dx = dhin [seeds, B, T, H] bf16 and dw [seeds, 2 H G H + G H] f32
// (dW_x, db, dW_h). fused = 2: the same, with dgx holding xw = hin @ W_x +
// b on entry (the grid forward's scratch; the xw GEMM is skipped). fused =
// 0: xin is xw [B, T, G H] (wx, b unused); out dx = dxw [seeds, B, T, G H]
// bf16 and dw [seeds, H G H] f32 (dW_h). Per seed: wh [H, G H]; m uint8
// [B, T]; h_all, c_all (LSTM; the GRU passes null), dh [seeds, B, T, H];
// all bf16 but m. s_*: the seed strides of xin, wx, b, wh and m in their
// elements (0: shared). Scratch the caller allocates: dgx [seeds, B, T, G
// H] f32, dhn [seeds, B, T, H] f32 (GRU), xch [groups, 2, 2, rows, G H]
// bf16, partial [seeds, S, total] f32, sync [groups] uint32 zeroed; stats
// (null, or [groups n][2] int64: each CTA's cycles at the barriers and in
// all). n: CTAs a group, rows: batch rows a work item, groups: the groups
// launched (at most what the card holds: lfm_rnn_bwd_grid_bf16_ctas / n).
// kernels (null, or one host int): the kernels launched. Returns the first
// CUDA error of its launches.
extern "C" int lfm_rnn_bwd_grid_bf16(
    int cell, int fused, const void* xin, const void* wx, const void* b,
    const void* wh, const void* m, const void* h_all, const void* c_all,
    const void* dh, void* dx, void* dgx, void* dhn, void* xch, void* partial,
    int S, void* dw, void* sync, void* stats, int seeds, int B, int Tn, int H,
    int n, int rows, int groups, long long s_xin, long long s_wx,
    long long s_b, long long s_wh, long long s_m, float forget_bias,
    void* kernels, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (seeds <= 0 || seeds > 65535 || B <= 0 || Tn <= 0 || S <= 0 ||
      S > 65535 || groups <= 0 || fused < 0 || fused > 2 ||
      !supported(H, n, rows))
    return (int)cudaErrorInvalidValue;
  int* nk = static_cast<int*>(kernels);
  if (nk != nullptr) *nk = 0;
#define LFM_GRID(CELLV, HOISTV)                                             \
  return (int)launch<CELLV, HOISTV>(                                        \
      fused == 2, nk, static_cast<const __nv_bfloat16*>(xin), wx, b,        \
      static_cast<const __nv_bfloat16*>(wh), static_cast<const uint8_t*>(m), \
      static_cast<const __nv_bfloat16*>(h_all),                             \
      static_cast<const __nv_bfloat16*>(c_all),                             \
      static_cast<const __nv_bfloat16*>(dh), dx, static_cast<float*>(dgx),  \
      static_cast<float*>(dhn), static_cast<__nv_bfloat16*>(xch),           \
      static_cast<float*>(partial), S, static_cast<float*>(dw),             \
      static_cast<unsigned*>(sync), static_cast<long long*>(stats), seeds,  \
      B, Tn, H, n, rows, groups, s_xin, s_wx, s_b, s_wh, s_m, forget_bias,  \
      cs)
  if (cell == kLstm && fused) LFM_GRID(kLstm, false);
  if (cell == kLstm) LFM_GRID(kLstm, true);
  if (cell == kGru && fused) LFM_GRID(kGru, false);
  if (cell == kGru) LFM_GRID(kGru, true);
#undef LFM_GRID
  return (int)cudaErrorInvalidValue;
}
