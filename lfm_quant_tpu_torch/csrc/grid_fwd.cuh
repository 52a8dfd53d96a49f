// The grid forward's recurrence, shared by rnn_fwd_grid.cu (bfloat16,
// mma.sync m16n8k16) and rnn_fwd_tf32_grid.cu (float32, 3xTF32 mma.sync
// m16n8k8): one kernel template over an operand policy that each source
// defines (its element type T of W_h, h_all and c_all; a stage's
// products; the cell's rounding; the stores). The rest is written once
// here: the work items, the transposed per-seed W_h load, the x side read
// a step ahead, the cp.async staged all-gather of h_{t-1} from h_all, the
// group barrier, the stats, the capacity check and the cooperative launch.
// The design is set out at the top of rnn_fwd_grid.cu.
//
// An operand policy Ops provides:
//   using T;                      W_h, h_all, c_all element type
//   template <int G> stage(acc, a_st, w_s, rw, lane, chunk, NC, LW, j0, kn)
//                                 acc[q] += the h tile's rows [rw, rw + 16)
//                                 (stage a_st, k from j0, kn of it) times
//                                 the chunk's gate-q W_h columns, in k
//                                 order, from acc's own value
//   lstm_c(f, c, i, g)            f c + i g, rounded as the dtype's plain
//                                 version rounds it
//   gru_n(x, r, hn), gru_h(z, n, h)
//                                 x + r hn and (1 - z) n + z h, likewise
//   stored(h)                     the LSTM's h as h_all holds it
//   store(v, lane, base, at, down, in0, in1)
//                                 the thread's units' values v of rows ra
//                                 (v[0], v[1]; if in0) and ra + 8 (v[2],
//                                 v[3]; if in1): base + at is row ra's
//                                 first unit of the thread, down 8 rows'
//                                 stride

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"
#include "mma_common.cuh"
#include "tf32_common.cuh"

namespace lfm_grid_fwd {
namespace {

using lfm_grid::chunks_per_cta;
using lfm_grid::group_barrier;
using lfm_grid::group_pos;
using lfm_grid::GroupPos;
using lfm_grid::kUnits;
using lfm_grid::threads_of;
using lfm_mma::as_float2;
using lfm_mma::cp_async16;
using lfm_mma::cp_async_commit;
using lfm_mma::cp_async_wait_all;
using lfm_mma::XwPair;
using lfm_tf32::cp_async_wait;
using lfm_tf32::kLstm;
using lfm_tf32::sigmoid;

// h_{t-1} columns per stage of the product, and stages in shared memory
// (one in flight while the other is multiplied).
constexpr int kStageK = 64;
constexpr int kStages = 2;
constexpr int kMaxThreads = 512;
constexpr int kTileLd = kStageK + 8;  // h tile row stride

// Kernel 1's shared memory: the W_h columns [G 8 NC][H + 8] and kStages
// stages of the h tile [rows][kStageK + 8], in T. ops/rnn.py
// _fwd_grid_smem mirrors it.
template <typename T>
inline size_t fwd_grid_smem_bytes(int G, int H, int n, int rows) {
  return sizeof(T) * ((size_t)G * kUnits * chunks_per_cta(H, n) * (H + 8) +
                      (size_t)kStages * rows * (kStageK + 8));
}

// The shapes kernel 1 takes: 128 < H <= max_width, H % 16 == 0; rows 64
// or 128; 1 <= n <= W with every CTA owning a chunk and at most
// kMaxThreads threads.
inline bool takes(int H, int n, int rows, int max_width) {
  if (H <= 128 || H > max_width || H % 16 != 0) return false;
  if (rows != 64 && rows != 128) return false;
  if (n < 1 || n > H / kUnits) return false;
  return threads_of(H, n, rows) <= kMaxThreads;
}

// Kernel 1. grid = groups * n CTAs of threads_of(H, n, rows) threads.
// xw [., B, T, G H] (the gates' x side with the bias; f32, or bf16 in the
// bf16 hoisted form; seed stride s_xw); wh [., H, G H] T (s_wh, 0:
// shared); m uint8 [., B, T] (s_m). Out: h_all, c_all (LSTM, may be null)
// [S, B, T, H] T; h_all is also the exchange. sync: one zeroed counter a
// group; stats (null: none) [grid][2]: each CTA's SM cycles waiting at the
// barriers and in all.
template <int CELL, class Ops, typename XW>
__global__ void __launch_bounds__(kMaxThreads, 1)
rnn_fwd_grid_kernel(const XW* __restrict__ xw,
                    const typename Ops::T* __restrict__ wh,
                    const uint8_t* __restrict__ m, typename Ops::T* h_all,
                    typename Ops::T* __restrict__ c_all, unsigned* sync,
                    long long* stats, int seeds, int B, int Tn, int H, int n,
                    int rows, long long s_xw, long long s_wh, long long s_m,
                    float forget_bias) {
  using T = typename Ops::T;
  using XW2 = typename XwPair<XW>::type;
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int LA = kTileLd;
  constexpr int E = 16 / sizeof(T);  // elements a 16-byte copy
  const int GH = G * H;
  const int LW = H + 8;            // W_h column row stride
  const int W = H / kUnits;
  const int NC = blockDim.x / (32 * (rows / 16));
  const GroupPos gp = group_pos(n, W);
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunk = warp % NC;
  const int rw = (warp / NC) * 16;       // the warp's first row
  const int ra = rw + (lane >> 2);       // the thread's rows ra, ra + 8
  const bool active = chunk < gp.own;    // warp-uniform
  const int u = (gp.w0 + chunk) * kUnits + 2 * (lane & 3);  // u, u + 1
  const int NS = (H + kStageK - 1) / kStageK;  // stages of the product

  // Declared in T, not bytes: a cast from bytes cost the float32 form
  // registers (ptxas --resource-usage: its LSTM spilled 52 bytes, not 24).
  extern __shared__ __align__(16) T smem_t[];
  T* wh_s = smem_t;
  T* a_s = wh_s + (size_t)G * NC * kUnits * LW;

  const size_t M = (size_t)B * Tn;
  const int nblk = (B + rows - 1) / rows;
  const int items = seeds * nblk;
  unsigned* ctr = sync + gp.group;
  unsigned target = 0;
  int loaded = -1;
  const long long started = clock64();
  long long waited = 0;  // thread 0's

  for (int item = gp.group; item < items; item += gp.groups) {
    const int seed = item / nblk;
    const int r0 = (item - seed * nblk) * rows;
    const int nr = min(rows, B - r0);
    const int wseed = s_wh != 0 ? seed : 0;
    if (wseed != loaded) {
      // Every warp is done with the last seed's W_h; this seed's own
      // columns, transposed: 8 units of one gate at one k a thread,
      // consecutive threads on consecutive k.
      __syncthreads();
      const T* src = wh + (size_t)wseed * s_wh + (size_t)gp.w0 * kUnits;
      for (int i = tid; i < G * gp.own * H; i += nth) {
        const int k = i % H;
        const int qc = i / H;  // q * own + c
        const int q = qc / gp.own;
        const int c = qc - q * gp.own;
        const T* e = src + (size_t)k * GH + q * H + c * kUnits;
        T* dst = wh_s + (size_t)(q * NC + c) * kUnits * LW + k;
#pragma unroll
        for (int j = 0; j < kUnits; ++j) dst[(size_t)j * LW] = e[j];
      }
      loaded = wseed;
    }
    T* hs = h_all + (size_t)seed * M * H;
    T* cs = CELL == kLstm && c_all != nullptr ? c_all + (size_t)seed * M * H
                                              : nullptr;
    const XW* xs = xw + (size_t)seed * s_xw;
    const uint8_t* ms = m + (size_t)seed * s_m;

    // The step's x side at rows ra + 8 half, units u, u + 1 (LSTM i, f, g,
    // o; GRU z, r, n) and its validity, read a step ahead.
    XW2 xv[2][G];
    bool keep[2];
    auto load_x = [&](int t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = ra + 8 * half;
        const bool in = active && r < nr;
        const size_t row = (size_t)(r0 + r) * Tn + t;
        keep[half] = in && ms[row] != 0;
#pragma unroll
        for (int q = 0; q < G; ++q)
          xv[half][q] =
              in ? *reinterpret_cast<const XW2*>(xs + row * GH + q * H + u)
                 : XwPair<XW>::zero();
      }
    };
    // The h_{t-1} tile's stage s: rows past the item's and columns past H
    // zero-filled.
    auto load_stage = [&](int t, int s) {
      T* dst = a_s + (s % kStages) * rows * LA;
      const int j0 = s * kStageK;
      constexpr int CK = kStageK / E;
      for (int i = tid; i < rows * CK; i += nth) {
        const int r = i / CK;
        const int kc = (i - r * CK) * E;
        const bool ok = r < nr && j0 + kc < H;
        const T* src = hs + ((size_t)(r0 + r) * Tn + t - 1) * H + j0 + kc;
        cp_async16(dst + r * LA + kc, ok ? src : hs, ok ? 16 : 0);
      }
    };

    // The f32 carries, [half * 2 + e] as the accumulators: c (LSTM) or h
    // (GRU); the LSTM's h as it was stored, which a masked step holds.
    float carry[4], hb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      carry[i] = 0.0f;
      hb[i] = 0.0f;
    }
    load_x(0);
    __syncthreads();  // this seed's W_h columns are in place

    for (int t = 0; t < Tn; ++t) {
      // The products: slot q the gate q's h side (GRU slot 2: n's).
      float acc[G][4];
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][i] = 0.0f;
      if (t > 0) {
#pragma unroll
        for (int s = 0; s < kStages - 1; ++s) {
          if (s < NS) load_stage(t, s);
          cp_async_commit();
        }
        for (int s = 0; s < NS; ++s) {
          cp_async_wait<kStages - 2>();
          // Stage s is in place; every warp is done with stage s - 1's
          // slot.
          __syncthreads();
          if (s + kStages - 1 < NS) load_stage(t, s + kStages - 1);
          cp_async_commit();
          if (!active) continue;
          const int j0 = s * kStageK;
          Ops::template stage<G>(acc, a_s + (s % kStages) * rows * LA,
                                 wh_s, rw, lane, chunk, NC, LW, j0,
                                 min(kStageK, H - j0));
        }
      }

      // The cell, in registers: xw + hw, then the mask.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * half + e;
          float x[G];
#pragma unroll
          for (int q = 0; q < G; ++q) {
            const float2 p = as_float2(xv[half][q]);
            x[q] = e ? p.y : p.x;
          }
          if constexpr (CELL == kLstm) {
            const float ig = sigmoid(x[0] + acc[0][i]);
            const float fg = sigmoid((x[1] + acc[1][i]) + forget_bias);
            const float gg = tanhf(x[2] + acc[2][i]);
            const float og = sigmoid(x[3] + acc[3][i]);
            const float c = Ops::lstm_c(fg, carry[i], ig, gg);
            const float h = og * tanhf(c);
            if (keep[half]) {
              carry[i] = c;
              hb[i] = Ops::stored(h);
            }
          } else {
            const float z = sigmoid(x[0] + acc[0][i]);
            const float rg = sigmoid(x[1] + acc[1][i]);
            const float nn = tanhf(Ops::gru_n(x[2], rg, acc[2][i]));
            const float h = Ops::gru_h(z, nn, carry[i]);
            if (keep[half]) carry[i] = h;
          }
        }
      }
      if (active) {
        // h_t (the LSTM's as stored) and the LSTM's c_t.
        const size_t at = ((size_t)(r0 + ra) * Tn + t) * H + u;
        const size_t down = (size_t)8 * Tn * H;
        const bool in0 = ra < nr, in1 = ra + 8 < nr;
        if constexpr (CELL == kLstm) {
          Ops::store(hb, lane, hs, at, down, in0, in1);
          if (cs != nullptr) Ops::store(carry, lane, cs, at, down, in0, in1);
        } else {
          Ops::store(carry, lane, hs, at, down, in0, in1);
        }
      }
      // The next step's x side, in flight under the barrier (read after
      // the stores: read before them, it kept the float32 GRU's registers
      // past the cap, 28 bytes spilled, not 8).
      if (t + 1 < Tn) load_x(t + 1);
      // The group's barrier: h_t of every unit is in h_all for the next
      // step's product (none after the item's last step: the next item's
      // first step reads nothing).
      if (t + 1 < Tn) group_barrier(ctr, target, n, waited);
    }
  }
  cp_async_wait_all();
  if (stats != nullptr && tid == 0) {
    stats[2 * blockIdx.x] = waited;
    stats[2 * blockIdx.x + 1] = clock64() - started;
  }
}

template <int CELL, class Ops>
size_t smem_of(int H, int n, int rows) {
  return fwd_grid_smem_bytes<typename Ops::T>(CELL == kLstm ? 4 : 3, H, n,
                                              rows);
}

// CTAs of kernel 1 the current card holds at once for this shape, with
// the shared memory it needs set on the kernel.
template <int CELL, class Ops, typename XW>
cudaError_t grid_capacity(int* ctas, int H, int n, int rows) {
  return lfm_grid::capacity(rnn_fwd_grid_kernel<CELL, Ops, XW>, ctas,
                            threads_of(H, n, rows),
                            smem_of<CELL, Ops>(H, n, rows));
}

// The forward: refused before any launch where `groups` groups of n CTAs
// are more than the card holds at once; then, fused, kernel0() (the xw
// GEMM into the scratch that xw points to); then the recurrence on xw.
// *kernels (null: not counted): the kernels launched.
template <int CELL, class Ops, typename XW, class Kernel0>
cudaError_t launch(int* kernels, bool fused, Kernel0 kernel0, const XW* xw,
                   long long s_xw, const typename Ops::T* wh,
                   const uint8_t* m, typename Ops::T* h_all,
                   typename Ops::T* c_all, unsigned* sync, long long* stats,
                   int seeds, int B, int Tn, int H, int n, int rows,
                   int groups, long long s_wh, long long s_m,
                   float forget_bias, cudaStream_t stream) {
  const int threads = threads_of(H, n, rows);
  const size_t smem = smem_of<CELL, Ops>(H, n, rows);
  auto kern = rnn_fwd_grid_kernel<CELL, Ops, XW>;
  cudaError_t err = lfm_grid::check_fits(kern, groups, n, threads, smem);
  if (err != cudaSuccess) return err;
  if (fused) {
    err = kernel0();
    if (err != cudaSuccess) return err;
    if (kernels != nullptr) *kernels += 1;
  }
  float fb = forget_bias;
  void* args[] = {(void*)&xw,    (void*)&wh,   (void*)&m,     (void*)&h_all,
                  (void*)&c_all, (void*)&sync, (void*)&stats, (void*)&seeds,
                  (void*)&B,     (void*)&Tn,   (void*)&H,     (void*)&n,
                  (void*)&rows,  (void*)&s_xw, (void*)&s_wh,  (void*)&s_m,
                  (void*)&fb};
  err = lfm_grid::launch(kern, groups, n, threads, smem, args, stream);
  if (err == cudaSuccess && kernels != nullptr) *kernels += 1;
  return err;
}

}  // namespace
}  // namespace lfm_grid_fwd
