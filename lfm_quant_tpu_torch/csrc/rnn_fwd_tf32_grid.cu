// Masked LSTM/GRU recurrence, fused and hoisted forward, in float32 on
// Hopper's tensor cores (3xTF32 mma.sync m16n8k8, f32 accumulation) above
// the widths a 2-CTA cluster holds: W_h's columns resident in f32 across a
// group of up to 132 co-resident CTAs that meet once a step at a barrier in
// device memory; the fused form's x side an f32 FMA GEMM on the CUDA cores.
//
// Replaces, in float32 with 128 < Hp <= kMaxWidth (Hp the width padded to a
// multiple of 16; ops/rnn.py _mma_route "grid"), the Pallas TPU kernels
// _lstm_fused_fwd_kernel (lfm_quant_tpu/ops/pallas_rnn.py:626) and
// _gru_fused_fwd_kernel (:652), reached through _fused_fwd_call (:793), and
// _lstm_fwd_kernel (:135) and _gru_fwd_kernel (:158), reached through
// _fwd_call (:365), with their seed rules (_fwd_vmap :920,
// _make_scan._fwd_vmap :504). It computes what csrc/rnn_fused_fwd.cu
// computes in float32 (the formulas are written out there), with
// csrc/rnn_fwd_tf32.cu's numerics: the product 3xTF32 (csrc/tf32_common.cuh)
// with lo rounded to nearest (kRoundLo), each k-step of 8 leaving the
// tensor cores' truncating accumulator for the f32 gate sums at once
// (kRecurChainK), xw_t added after the h side as the plain version adds its
// two products; the cell with the accurate expf/tanhf and each product and
// sum of the carries' updates rounded as the plain version rounds them (no
// fused multiply-add); h and c carried and stored in f32.
//
// Why a grid. Above Hp 128 the f32 W_h (4 G Hp^2 bytes: 2.6 MB for the
// LSTM at 400, 16.8 MB at 1024) does not fit two CTAs, so
// csrc/rnn_fused_fwd.cu re-read it from L2 in every block and step and ran
// the products on the CUDA cores. Here each CTA of a group holds its
// units' columns of W_h for all T steps, and the products run at the
// 3xTF32 rate.
//
// Bound. At Hp 400, B 2048, T 60 the fused LSTM is 2 products of 2 H G H a
// row and step: 3.1e11 operations, 1.9 ms at the 3xTF32 rate (495 / 3
// TFLOP/s), against 0.4 GB of hin in and h, c out (0.12 ms at 3.35 TB/s):
// bound by operations. The recurrence's half takes 0.95 ms of that; the x
// side, kept on the CUDA cores, at least 2.35 ms at their 67 TFLOP/s. The
// hoisted form does the recurrence's product alone but reads the G-times
// wider xw.
//
// Design: csrc/rnn_fwd_grid.cu's, with csrc/rnn_bwd_tf32_grid.cu's f32
// operands. Kernel 1 is csrc/grid_fwd.cuh's template, shared with the
// bf16 grid forward; this source gives it its f32 operands (Tf32Ops: the
// 3xTF32 products, the cell's rounding, the stores).
//
// * Kernel 0 (fused form): xw = hin @ W_x + b into the caller's f32 scratch
//   [S, B, T, G Hp], csrc/tf32_common.cuh's f32 FMA GEMM on the CUDA cores
//   (the one csrc/rnn_fwd_tf32.cu runs: a 3xTF32 xw's truncation bias took
//   c_all over 1e-5 at the c2 step). The float32 backwards take the scratch
//   as their d_gates buffer (ops/rnn.py _FusedScan) and skip their own xw
//   GEMM.
// * Kernel 1, the recurrence, as the bf16 grid forward runs it (its steps
//   are set out in csrc/rnn_fwd_grid.cu): W_h's columns in f32, the
//   all-gather of the f32 h_{t-1} from h_all, the own units' products by
//   3xTF32 mma.sync (each k-step of 8 from zero, added to the f32 sums in
//   k order), xw_t added after them, h_t and c_t stored in f32. A (row,
//   unit)'s bits depend neither on the group size nor on the rows of an
//   item, and a seed's outputs are bitwise those of a one-seed launch.
// * A grid the card cannot hold at once is refused
//   (cudaErrorCooperativeLaunchTooLarge) before any launch, never run
//   another way. A barrier that waits past about two seconds traps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_fwd.cuh"
#include "tf32_common.cuh"

namespace {

using lfm_grid::kUnits;
using lfm_grid_fwd::grid_capacity;
using lfm_grid_fwd::kStageK;
using lfm_grid_fwd::kTileLd;
using lfm_tf32::frag_a;
using lfm_tf32::frag_b;
using lfm_tf32::FragA;
using lfm_tf32::FragB;
using lfm_tf32::kGru;
using lfm_tf32::kLstm;
using lfm_tf32::launch_sgemm;
using lfm_tf32::mma3;

// The widest Hp, as the float32 grid backward's (csrc/rnn_bwd_tf32_grid.cu):
// the LSTM's f32 W_h columns of one 8-unit chunk take 132 KB at Hp 1024, so
// a group there is 128 CTAs.
constexpr int kMaxWidth = 1024;
constexpr int kRecurChainK = 8;  // k per mma chain before the f32 sums
constexpr bool kRoundLo = true;  // lo rounded to nearest (split_tf32)

static_assert(kStageK % kRecurChainK == 0 && kRecurChainK % 8 == 0,
              "a chain is whole k-steps of 8 within one stage");

bool supported(int H, int n, int rows) {
  return lfm_grid_fwd::takes(H, n, rows, kMaxWidth);
}

// The f32 operands of csrc/grid_fwd.cuh's kernel: h_{t-1} times W_h, each
// product 3xTF32 with lo rounded to nearest, each k-step of 8 from zero
// and then added to the f32 sums in k order; each product and sum of the
// carries' updates rounded as the plain version rounds them (no fused
// multiply-add); h and c stored in f32.
struct Tf32Ops {
  using T = float;

  // Lane c takes k = 2c, 2c + 1 of each 8-step in both operands (one
  // 64-bit load each, free of bank conflicts).
  template <int G>
  static __device__ __forceinline__ void stage(float (&acc)[G][4],
                                               const float* a_st,
                                               const float* w_s, int rw,
                                               int lane, int chunk, int NC,
                                               int LW, int j0, int kn) {
    const int g = lane >> 2;
    const int c4 = lane & 3;
    const float* ap = a_st + (rw + g) * kTileLd + 2 * c4;
    const float* bp = w_s + (size_t)(chunk * kUnits + g) * LW + j0 + 2 * c4;
    // Four k-steps unrolled: the same operations in the same order, for
    // the compiler to overlap one k-step's loads and splits with another's
    // mma (5-11% off rows 3 and 1 at Hp 400 on an H100,
    // scripts/torch_cluster_variants.py --direction fwd_grid_tf32 --diag
    // base,unroll2,unroll4,unroll8).
#pragma unroll 4
    for (int kc = 0; kc < kn; kc += kRecurChainK) {
      float cacc[G][4];
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) cacc[q][i] = 0.0f;
#pragma unroll
      for (int kk = kc; kk < kc + kRecurChainK && kk < kn; kk += 8) {
        const float2 x0 = *reinterpret_cast<const float2*>(ap + kk);
        const float2 x1 =
            *reinterpret_cast<const float2*>(ap + 8 * kTileLd + kk);
        FragA a;
        frag_a<kRoundLo>(a, x0.x, x1.x, x0.y, x1.y);
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const float2 w = *reinterpret_cast<const float2*>(
              bp + (size_t)q * NC * kUnits * LW + kk);
          FragB b;
          frag_b<kRoundLo>(b, w.x, w.y);
          mma3(cacc[q], a, b);
        }
      }
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][i] += cacc[q][i];
    }
  }
  static __device__ __forceinline__ float lstm_c(float fg, float c, float ig,
                                                 float gg) {
    return __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, gg));
  }
  static __device__ __forceinline__ float gru_n(float x, float rg,
                                                float hn) {
    return __fadd_rn(x, __fmul_rn(rg, hn));
  }
  static __device__ __forceinline__ float gru_h(float z, float nn, float h) {
    return __fadd_rn(__fmul_rn(1.0f - z, nn), __fmul_rn(z, h));
  }
  static __device__ __forceinline__ float stored(float h) { return h; }
  // The thread's units u, u + 1 of rows ra and ra + 8, one 8-byte store
  // each.
  static __device__ __forceinline__ void store(const float (&v)[4], int lane,
                                               float* base, size_t at,
                                               size_t down, bool in0,
                                               bool in1) {
    if (in0) *reinterpret_cast<float2*>(base + at) = make_float2(v[0], v[1]);
    if (in1)
      *reinterpret_cast<float2*>(base + at + down) = make_float2(v[2], v[3]);
  }
};

// fused: the xw GEMM into the scratch, then the recurrence on it; hoisted:
// the recurrence on the given xw. *kernels (null: not counted): the
// kernels launched.
template <int CELL>
cudaError_t launch(int* kernels, bool fused, const float* xin,
                   const float* wx, const float* b, const float* wh,
                   const uint8_t* m, float* h_all, float* c_all,
                   float* xw_scratch, unsigned* sync, long long* stats,
                   int seeds, int B, int Tn, int H, int n, int rows,
                   int groups, long long s_xin, long long s_wx,
                   long long s_b, long long s_wh, long long s_m,
                   float forget_bias, cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  const int GH = G * H;
  const int M = B * Tn;
  const long long s_gates = (long long)M * GH;
  auto gemm = [&]() {
    return launch_sgemm(xin, wx, b, xw_scratch, M, GH, H, seeds, s_xin, s_wx,
                        s_b, s_gates, stream);
  };
  return lfm_grid_fwd::launch<CELL, Tf32Ops, float>(
      kernels, fused, gemm, fused ? xw_scratch : xin,
      fused ? s_gates : s_xin, wh, m, h_all, c_all, sync, stats, seeds, B,
      Tn, H, n, rows, groups, s_wh, s_m, forget_bias, stream);
}

}  // namespace

// Kernel 1's shared memory with a group of n CTAs and `rows` rows a work
// item, in bytes; -1 for a shape it does not take. cell: 0 = LSTM, 1 = GRU.
extern "C" long long lfm_rnn_fwd_tf32_grid_smem(int cell, int H, int n,
                                                int rows) {
  if (!supported(H, n, rows) || (cell != kLstm && cell != kGru)) return -1;
  return (long long)lfm_grid_fwd::fwd_grid_smem_bytes<float>(
      cell == kLstm ? 4 : 3, H, n, rows);
}

// CTAs of kernel 1 the current card holds at once for this shape (both
// forms read an f32 xw); -1 for a shape it does not take or a CUDA error.
extern "C" int lfm_rnn_fwd_tf32_grid_ctas(int cell, int H, int n, int rows) {
  if (!supported(H, n, rows) || (cell != kLstm && cell != kGru)) return -1;
  int ctas = 0;
  const cudaError_t err =
      cell == kLstm ? grid_capacity<kLstm, Tf32Ops, float>(&ctas, H, n, rows)
                    : grid_capacity<kGru, Tf32Ops, float>(&ctas, H, n, rows);
  return err == cudaSuccess ? ctas : -1;
}

// The float32 forward past a cluster's widths, for `seeds` seeds in one
// call. fused = 1: xin is hin [B, T, H] per seed, and wx [H, G H], b [G H]
// are used; xw_scratch [seeds, B, T, G H] is the caller's scratch for xw
// (the float32 backwards' d_gates buffer after). fused = 0: xin is xw [B,
// T, G H] (wx, b, xw_scratch unused). Per seed: wh [H, G H]; m uint8 [B,
// T]. Out h_all, c_all (LSTM; null: not written) [seeds, B, T, H]. All
// f32 but m. s_*: the seed strides of xin, wx, b, wh and m in their
// elements (0: shared). Scratch the caller allocates: sync [groups] uint32
// zeroed; stats (null, or [groups n][2] int64: each CTA's cycles at the
// barriers and in all). n: CTAs a group, rows: batch rows a work item (64
// or 128), groups: the groups launched (at most what the card holds:
// lfm_rnn_fwd_tf32_grid_ctas / n). kernels (null, or one host int): the
// kernels launched. Returns the first CUDA error of its launches.
extern "C" int lfm_rnn_fwd_tf32_grid(
    int cell, int fused, const void* xin, const void* wx, const void* b,
    const void* wh, const void* m, void* h_all, void* c_all,
    void* xw_scratch, void* sync, void* stats, int seeds, int B, int Tn,
    int H, int n, int rows, int groups, long long s_xin, long long s_wx,
    long long s_b, long long s_wh, long long s_m, float forget_bias,
    void* kernels, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (seeds <= 0 || seeds > 65535 || B <= 0 || Tn <= 0 || groups <= 0 ||
      !supported(H, n, rows) || (cell != kLstm && cell != kGru))
    return (int)cudaErrorInvalidValue;
  int* nk = static_cast<int*>(kernels);
  if (nk != nullptr) *nk = 0;
#define LFM_FWD_TF32_GRID(CELLV)                                             \
  return (int)launch<CELLV>(                                                 \
      nk, fused != 0, static_cast<const float*>(xin),                        \
      static_cast<const float*>(wx), static_cast<const float*>(b),           \
      static_cast<const float*>(wh), static_cast<const uint8_t*>(m),         \
      static_cast<float*>(h_all), static_cast<float*>(c_all),                \
      static_cast<float*>(xw_scratch), static_cast<unsigned*>(sync),         \
      static_cast<long long*>(stats), seeds, B, Tn, H, n, rows, groups,      \
      s_xin, s_wx, s_b, s_wh, s_m, forget_bias, cs)
  if (cell == kLstm) LFM_FWD_TF32_GRID(kLstm);
  LFM_FWD_TF32_GRID(kGru);
#undef LFM_FWD_TF32_GRID
}
