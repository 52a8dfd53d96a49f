// Masked LSTM/GRU recurrence, fused and hoisted forward, in bfloat16 on
// Hopper's tensor cores (mma.sync m16n8k16, f32 accumulation) past the
// widths a cluster holds: W_h resident in bf16 across a group of up to 132
// co-resident CTAs that meet once a step at a barrier in device memory.
//
// Replaces, in bfloat16 with 512 < Hp <= kMaxWidth (Hp the width padded to
// a multiple of 16; ops/rnn.py _mma_route "grid"), the Pallas TPU kernels
// _lstm_fused_fwd_kernel (lfm_quant_tpu/ops/pallas_rnn.py:626) and
// _gru_fused_fwd_kernel (:652), reached through _fused_fwd_call (:793), and
// _lstm_fwd_kernel (:135) and _gru_fwd_kernel (:158), reached through
// _fwd_call (:365), with their seed rules (_fwd_vmap :920,
// _make_scan._fwd_vmap :504). It computes what csrc/rnn_fused_fwd.cu
// computes (the formulas are written out there), at the TPU kernels'
// rounding points as csrc/rnn_fwd_cluster.cu keeps them: h and c carried in
// f32, bf16(h_{t-1}) the recurrent product's operand (pallas_rnn.py:638,
// h.astype(wh_ref.dtype)), h_t and c_t stored in bf16. The fused form's x
// side is an f32 sum that is never rounded to bf16.
//
// Why a grid. Past Hp 512 a cluster's 16 CTAs cannot hold W_h (G Hp^2
// bf16: 2.2 MB for the LSTM at 528, 18.5 MB at 1520), so
// csrc/rnn_fused_fwd.cu re-read it from L2 in every block and step and ran
// the products in f32 on the CUDA cores. Here W_h stays in shared memory
// across a group of CTAs for all T steps, and the products run at the
// bf16 rate.
//
// Bound. At Hp 528, B 2048, T 60 the fused LSTM is 2 products of 2 H G H a
// row and step: 5.5e11 operations, 0.55 ms at 989 TFLOP/s, against 0.4 GB
// of hin in and h, c out (0.12 ms at 3.35 TB/s): bound by operations. The
// hoisted form does one of the two products but reads the G-times wider
// xw.
//
// Design: csrc/rnn_bwd_grid.cu's, with csrc/rnn_fwd_cluster.cu's numerics.
// Kernel 1 is csrc/grid_fwd.cuh's template, shared with the float32 grid
// forward (csrc/rnn_fwd_tf32_grid.cu); this source gives it its bf16
// operands (Bf16Ops: the products, the cell's rounding, the stores).
//
// * Kernel 0 (fused form): xw = hin @ W_x + b into the caller's f32 scratch
//   [S, B, T, G Hp], the bf16 GEMM of csrc/cluster_gemm.cuh, the same call
//   as the grid backward's kernel 0, so the backward gets the same bits
//   whether it forms xw itself or takes this scratch (ops/rnn.py
//   _FusedScan hands it over).
// * Kernel 1, the recurrence, a cooperative launch of up to one CTA an SM:
//   groups of n CTAs (csrc/grid_common.cuh); each group walks its (seed,
//   block of `rows` rows) work items in turn. CTA j of a group owns the
//   8-unit chunks [j W / n, (j + 1) W / n) of the W = Hp / 8 (NC =
//   ceil(W / n) at most) and holds, resident in shared memory, the W_h
//   columns of those units across all G gates, transposed to one row of
//   Hp k-values a column ([G 8 NC][Hp + 8] bf16, loaded once a seed).
//   Warp w owns chunk w % NC of the CTA and the 16 rows w / NC of the item,
//   so a (row, unit)'s G gate sums, its f32 carries and its cell sit in one
//   thread's registers. Per step t:
//   1. the group's whole bf16 h_{t-1} row block is read from L2 (cp.async.cg,
//      64 columns a stage, double-buffered): that read is the all-gather;
//   2. the own units' h_{t-1} @ W_h[:, own] by mma.sync into f32, one chain
//      over k from 0 in k order (the order of the backward's gates GEMM);
//   3. xw_t added (the f32 scratch fused, the bf16 xw hoisted; read into
//      registers a step ahead, under the barrier's wait): xw + hw, the plain
//      order; the GRU keeps n's h side apart, since r multiplies it;
//   4. the cell, with the accurate expf/tanhf, and the mask: on a masked
//      step h and c are held;
//   5. h_t and c_t stored in bf16 to h_all and c_all, each quad's 8 units
//      of a row as one 16-byte store;
//   6. one barrier of the group (none after a work item's last step).
//   h_all is the exchange: bf16(h_t) is both the stored state and the next
//   step's product operand, and every step has its own place in it, so no
//   CTA ever overwrites what a slower one still reads and one bf16 an
//   element is the whole exchange.
// * A (row, unit)'s sums run over the same k in the same order whatever
//   the group size n or the rows of an item, so its bits depend on neither.
// * Seeds (pallas_rnn.py _fwd_vmap :920): kernel 0's blockIdx.z; kernel 1's
//   work items run over seeds and row blocks, the CTA reloading its W_h
//   columns where the seed's W_h differs; each operand has its own seed
//   stride (0: shared), every per-seed offset is 64-bit, and a seed's
//   outputs are bitwise those of a one-seed launch.
// * A grid the card cannot hold at once is refused
//   (cudaErrorCooperativeLaunchTooLarge) before any launch, never run
//   another way. A barrier that waits past about two seconds traps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_gemm.cuh"
#include "grid_fwd.cuh"
#include "mma_common.cuh"

namespace {

using lfm_grid::kUnits;
using lfm_grid_fwd::grid_capacity;
using lfm_grid_fwd::kTileLd;
using lfm_mma::bf16x2_bits;
using lfm_mma::ldmatrix_x2;
using lfm_mma::ldmatrix_x4;
using lfm_mma::mma_bf16;
using lfm_tf32::kGru;
using lfm_tf32::kLstm;

// The widest Hp, as the bf16 grid backward's (csrc/rnn_bwd_grid.cu): the
// LSTM's W_h columns of two 8-unit chunks take 64 (Hp + 8) bf16, which
// beside the stages fit an H100's 232,448 bytes up to Hp 1520 (a group of
// 95 CTAs); past it a CTA would hold three chunks, W past 132 CTAs' two.
constexpr int kMaxWidth = 1520;

bool supported(int H, int n, int rows) {
  return lfm_grid_fwd::takes(H, n, rows, kMaxWidth);
}

// Each quad's 8 units of a row, one bf16 pair a lane (v[half]), as one
// 16-byte store: lane c4 < 2 stores row half c4 at `dst[c4]` (null: a row
// past the item's).
__device__ __forceinline__ void store_quad(const uint32_t (&v)[2], int lane,
                                           __nv_bfloat16* dst0,
                                           __nv_bfloat16* dst1) {
  const int quad = lane & ~3;
  uint4 row16[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    row16[half].x = __shfl_sync(0xffffffffu, v[half], quad);
    row16[half].y = __shfl_sync(0xffffffffu, v[half], quad + 1);
    row16[half].z = __shfl_sync(0xffffffffu, v[half], quad + 2);
    row16[half].w = __shfl_sync(0xffffffffu, v[half], quad + 3);
  }
  const int c4 = lane & 3;
  __nv_bfloat16* dst = c4 == 0 ? dst0 : dst1;
  if (c4 < 2 && dst != nullptr)
    *reinterpret_cast<uint4*>(dst) = c4 ? row16[1] : row16[0];
}

// The bf16 operands of csrc/grid_fwd.cuh's kernel: bf16(h_{t-1}) times
// W_h in bf16, one mma.sync m16n8k16 a gate and k-step of 16 into the f32
// sums; the carries' updates as the compiler contracts them; h and c
// stored in bf16, the LSTM's h carried as it was stored.
struct Bf16Ops {
  using T = __nv_bfloat16;

  template <int G>
  static __device__ __forceinline__ void stage(float (&acc)[G][4],
                                               const T* a_st, const T* w_s,
                                               int rw, int lane, int chunk,
                                               int NC, int LW, int j0,
                                               int kn) {
    // ldmatrix row addresses: A rows 0-7 / 8-15 at k 0 / 8; a gate's W_h
    // columns of the chunk's 8 units at k 0 / 8.
    const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int acol = (lane >> 4) * 8;
    const T* ap = a_st + (rw + arow) * kTileLd + acol;
    const T* bp = w_s + (size_t)(chunk * kUnits + (lane & 7)) * LW + j0 +
                  ((lane >> 3) & 1) * 8;
    for (int kk = 0; kk < kn; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, ap + kk);
#pragma unroll
      for (int q = 0; q < G; ++q) {
        uint32_t b2[2];
        ldmatrix_x2(b2, bp + (size_t)q * NC * kUnits * LW + kk);
        mma_bf16(acc[q], a, make_uint2(b2[0], b2[1]));
      }
    }
  }
  static __device__ __forceinline__ float lstm_c(float fg, float c, float ig,
                                                 float gg) {
    return fg * c + ig * gg;
  }
  static __device__ __forceinline__ float gru_n(float x, float rg,
                                                float hn) {
    return x + rg * hn;
  }
  static __device__ __forceinline__ float gru_h(float z, float nn, float h) {
    return (1.0f - z) * nn + z * h;
  }
  static __device__ __forceinline__ float stored(float h) {
    return __bfloat162float(__float2bfloat16_rn(h));
  }
  // Each quad's 8 units of a row as one 16-byte store from the quad's
  // first unit: lane c4 = 0 row ra, lane 1 row ra + 8.
  static __device__ __forceinline__ void store(const float (&v)[4], int lane,
                                               T* base, size_t at,
                                               size_t down, bool in0,
                                               bool in1) {
    const uint32_t p[2] = {bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3])};
    T* q = base + at - 2 * (lane & 3);
    store_quad(p, lane, in0 ? q : nullptr, in1 ? q + down : nullptr);
  }
};

// fused (XW float): the xw GEMM into the scratch, then the recurrence on
// it; hoisted (XW bf16): the recurrence on the given xw. *kernels (null:
// not counted): the kernels launched.
template <int CELL, typename XW>
cudaError_t launch(int* kernels, const void* xin, const void* wx, const void* b,
                   const __nv_bfloat16* wh, const uint8_t* m,
                   __nv_bfloat16* h_all, __nv_bfloat16* c_all,
                   float* xw_scratch, unsigned* sync, long long* stats,
                   int seeds, int B, int Tn, int H, int n, int rows,
                   int groups, long long s_xin, long long s_wx,
                   long long s_b, long long s_wh, long long s_m,
                   float forget_bias, cudaStream_t stream) {
  constexpr bool FUSED = sizeof(XW) == sizeof(float);
  constexpr int G = CELL == kLstm ? 4 : 3;
  const int GH = G * H;
  const int M = B * Tn;
  const long long s_gates = (long long)M * GH;
  auto gemm = [&]() {
    return lfm_cluster::launch_gemm(xin, wx, b, xw_scratch, M, GH, H, seeds,
                                    s_xin, s_wx, s_b, s_gates, stream);
  };
  const XW* xw = FUSED ? reinterpret_cast<const XW*>(xw_scratch)
                       : static_cast<const XW*>(xin);
  return lfm_grid_fwd::launch<CELL, Bf16Ops, XW>(
      kernels, FUSED, gemm, xw, FUSED ? s_gates : s_xin, wh, m, h_all, c_all,
      sync, stats, seeds, B, Tn, H, n, rows, groups, s_wh, s_m, forget_bias,
      stream);
}

}  // namespace

// Kernel 1's shared memory with a group of n CTAs and `rows` rows a work
// item, in bytes; -1 for a shape it does not take. cell: 0 = LSTM, 1 = GRU.
extern "C" long long lfm_rnn_fwd_grid_smem(int cell, int H, int n, int rows) {
  if (!supported(H, n, rows) || (cell != kLstm && cell != kGru)) return -1;
  return (long long)lfm_grid_fwd::fwd_grid_smem_bytes<__nv_bfloat16>(
      cell == kLstm ? 4 : 3, H, n, rows);
}

// CTAs of kernel 1 the current card holds at once for this shape (the
// fused form's reads f32 xw, the hoisted form's bf16); -1 for a shape it
// does not take or a CUDA error.
extern "C" int lfm_rnn_fwd_grid_ctas(int cell, int fused, int H, int n,
                                     int rows) {
  if (!supported(H, n, rows) || (cell != kLstm && cell != kGru)) return -1;
  int ctas = 0;
  cudaError_t err;
  if (cell == kLstm)
    err = fused
              ? grid_capacity<kLstm, Bf16Ops, float>(&ctas, H, n, rows)
              : grid_capacity<kLstm, Bf16Ops, __nv_bfloat16>(&ctas, H, n,
                                                             rows);
  else
    err = fused ? grid_capacity<kGru, Bf16Ops, float>(&ctas, H, n, rows)
                : grid_capacity<kGru, Bf16Ops, __nv_bfloat16>(&ctas, H, n,
                                                              rows);
  return err == cudaSuccess ? ctas : -1;
}

// The bfloat16 forward past a cluster's widths, for `seeds` seeds in one
// call. fused = 1: xin is hin [B, T, H] bf16 per seed, and wx [H, G H],
// b [G H] bf16 are used; xw_scratch [seeds, B, T, G H] f32 is the caller's
// scratch for xw (the grid backward's d_gates buffer after). fused = 0:
// xin is xw [B, T, G H] bf16 (wx, b, xw_scratch unused). Per seed: wh
// [H, G H] bf16; m uint8 [B, T]. Out h_all, c_all (LSTM; null: not
// written) [seeds, B, T, H] bf16. s_*: the seed strides of xin, wx, b, wh
// and m in their elements (0: shared). Scratch the caller allocates: sync
// [groups] uint32 zeroed; stats (null, or [groups n][2] int64: each CTA's
// cycles at the barriers and in all). n: CTAs a group, rows: batch rows a
// work item (64 or 128), groups: the groups launched (at most what the
// card holds: lfm_rnn_fwd_grid_ctas / n). kernels (null, or one host
// int): the kernels launched. Returns the first CUDA error of its
// launches.
extern "C" int lfm_rnn_fwd_grid(int cell, int fused, const void* xin,
                                const void* wx, const void* b,
                                const void* wh, const void* m, void* h_all,
                                void* c_all, void* xw_scratch, void* sync,
                                void* stats, int seeds, int B, int Tn, int H,
                                int n, int rows, int groups, long long s_xin,
                                long long s_wx, long long s_b, long long s_wh,
                                long long s_m, float forget_bias,
                                void* kernels, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (seeds <= 0 || seeds > 65535 || B <= 0 || Tn <= 0 || groups <= 0 ||
      !supported(H, n, rows) || (cell != kLstm && cell != kGru))
    return (int)cudaErrorInvalidValue;
  int* nk = static_cast<int*>(kernels);
  if (nk != nullptr) *nk = 0;
#define LFM_FWD_GRID(CELLV, XWT)                                             \
  return (int)launch<CELLV, XWT>(                                            \
      nk, xin, wx, b, static_cast<const __nv_bfloat16*>(wh),                 \
      static_cast<const uint8_t*>(m), static_cast<__nv_bfloat16*>(h_all),    \
      static_cast<__nv_bfloat16*>(c_all), static_cast<float*>(xw_scratch),   \
      static_cast<unsigned*>(sync), static_cast<long long*>(stats), seeds, B, \
      Tn, H, n, rows, groups, s_xin, s_wx, s_b, s_wh, s_m, forget_bias, cs)
  if (cell == kLstm && fused) LFM_FWD_GRID(kLstm, float);
  if (cell == kLstm) LFM_FWD_GRID(kLstm, __nv_bfloat16);
  if (cell == kGru && fused) LFM_FWD_GRID(kGru, float);
  LFM_FWD_GRID(kGru, __nv_bfloat16);
#undef LFM_FWD_GRID
}
