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
using lfm_mma::as_float2;
using lfm_mma::bf16x2_bits;
using lfm_mma::cp_async16;
using lfm_mma::cp_async_commit;
using lfm_mma::cp_async_wait_all;
using lfm_mma::ldmatrix_x2;
using lfm_mma::ldmatrix_x4;
using lfm_mma::mma_bf16;
using lfm_mma::XwPair;
using lfm_tf32::cp_async_wait;
using lfm_tf32::kGru;
using lfm_tf32::kLstm;
using lfm_tf32::sigmoid;

// The widest Hp, as the bf16 grid backward's (csrc/rnn_bwd_grid.cu): the
// LSTM's W_h columns of two 8-unit chunks take 64 (Hp + 8) bf16, which
// beside the stages fit an H100's 232,448 bytes up to Hp 1520 (a group of
// 95 CTAs); past it a CTA would hold three chunks, W past 132 CTAs' two.
constexpr int kMaxWidth = 1520;
// h_{t-1} columns per stage of the product, and stages in shared memory
// (one in flight while the other is multiplied).
constexpr int kStageK = 64;
constexpr int kStages = 2;
constexpr int kMaxThreads = 512;

// Kernel 1's shared memory, bf16: the W_h columns [G 8 NC][H + 8] and
// kStages stages of the h tile [rows][kStageK + 8]. ops/rnn.py
// _fwd_grid_smem mirrors it.
inline size_t fwd_grid_smem_bytes(int G, int H, int n, int rows) {
  return 2 * ((size_t)G * kUnits * chunks_per_cta(H, n) * (H + 8) +
              (size_t)kStages * rows * (kStageK + 8));
}

// The shapes kernel 1 takes: 128 < H <= kMaxWidth, H % 16 == 0 (the route
// gives it H > 512); rows 64 or 128; 1 <= n <= W with every CTA owning a
// chunk and at most kMaxThreads threads.
bool supported(int H, int n, int rows) {
  if (H <= 128 || H > kMaxWidth || H % 16 != 0) return false;
  if (rows != 64 && rows != 128) return false;
  if (n < 1 || n > H / kUnits) return false;
  return threads_of(H, n, rows) <= kMaxThreads;
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

// Kernel 1. grid = groups * n CTAs of threads_of(H, n, rows) threads.
// xw [., B, T, G H] (the gates' x side with the bias; f32 or bf16; seed
// stride s_xw); wh [., H, G H] bf16 (s_wh, 0: shared); m uint8 [., B, T]
// (s_m). Out: h_all, c_all (LSTM, may be null) [S, B, T, H] bf16; h_all is
// also the exchange. sync: one zeroed counter a group; stats (null: none)
// [grid][2]: each CTA's SM cycles waiting at the barriers and in all.
template <int CELL, typename XW>
__global__ void __launch_bounds__(kMaxThreads, 1)
rnn_fwd_grid_kernel(const XW* __restrict__ xw,
                    const __nv_bfloat16* __restrict__ wh,
                    const uint8_t* __restrict__ m, __nv_bfloat16* h_all,
                    __nv_bfloat16* __restrict__ c_all, unsigned* sync,
                    long long* stats, int seeds, int B, int Tn, int H, int n,
                    int rows, long long s_xw, long long s_wh, long long s_m,
                    float forget_bias) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int LA = kStageK + 8;  // h tile row stride
  using XW2 = typename XwPair<XW>::type;
  const int GH = G * H;
  const int LW = H + 8;            // W_h column row stride
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
  const int u0 = (gp.w0 + chunk) * kUnits;  // its chunk's first unit
  const int u = u0 + 2 * c4;                // its units u, u + 1
  const int NS = (H + kStageK - 1) / kStageK;  // stages of the product
  // ldmatrix row addresses: A rows 0-7 / 8-15 at k 0 / 8; a gate's W_h
  // columns of the chunk's 8 units at k 0 / 8.
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = (lane >> 4) * 8;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* a_s = wh_s + (size_t)G * NC * kUnits * LW;

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
      // columns, transposed: 8 units of one gate at one k a 16-byte load,
      // consecutive threads on consecutive k.
      __syncthreads();
      const __nv_bfloat16* src =
          wh + (size_t)wseed * s_wh + (size_t)gp.w0 * kUnits;
      for (int i = tid; i < G * gp.own * H; i += nth) {
        const int k = i % H;
        const int qc = i / H;  // q * own + c
        const int q = qc / gp.own;
        const int c = qc - q * gp.own;
        const uint4 v = *reinterpret_cast<const uint4*>(
            src + (size_t)k * GH + q * H + c * kUnits);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
        __nv_bfloat16* dst = wh_s + (size_t)(q * NC + c) * kUnits * LW + k;
#pragma unroll
        for (int j = 0; j < kUnits; ++j) dst[(size_t)j * LW] = e[j];
      }
      loaded = wseed;
    }
    __nv_bfloat16* hs = h_all + (size_t)seed * M * H;
    __nv_bfloat16* cs =
        CELL == kLstm && c_all != nullptr ? c_all + (size_t)seed * M * H
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
      __nv_bfloat16* dst = a_s + (s % kStages) * rows * LA;
      const int j0 = s * kStageK;
      constexpr int CK = kStageK / 8;
      for (int i = tid; i < rows * CK; i += nth) {
        const int r = i / CK;
        const int kc = (i - r * CK) * 8;
        const bool ok = r < nr && j0 + kc < H;
        const __nv_bfloat16* src =
            hs + ((size_t)(r0 + r) * Tn + t - 1) * H + j0 + kc;
        cp_async16(dst + r * LA + kc, ok ? src : hs, ok ? 16 : 0);
      }
    };

    // The f32 carries, [half * 2 + e] as the accumulators: c (LSTM) or h
    // (GRU); the LSTM's h as it was stored (bf16), which a masked step
    // holds.
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
          const __nv_bfloat16* ap =
              a_s + (s % kStages) * rows * LA + (rw + arow) * LA + acol;
          const __nv_bfloat16* bp =
              wh_s + (size_t)(chunk * kUnits + (lane & 7)) * LW + j0 +
              ((lane >> 3) & 1) * 8;
          const int kn = min(kStageK, H - j0);
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
      }

      // The cell, in registers: xw + hw, then the mask.
      uint32_t hv[2], cv[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[2], cc[2];
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
            const float c = fg * carry[i] + ig * gg;
            const float h = og * tanhf(c);
            if (keep[half]) {
              carry[i] = c;
              hb[i] = __bfloat162float(__float2bfloat16_rn(h));
            }
            v[e] = hb[i];
            cc[e] = carry[i];
          } else {
            const float z = sigmoid(x[0] + acc[0][i]);
            const float rg = sigmoid(x[1] + acc[1][i]);
            const float nn = tanhf(x[2] + rg * acc[2][i]);
            const float h = (1.0f - z) * nn + z * carry[i];
            if (keep[half]) carry[i] = h;
            v[e] = carry[i];
            cc[e] = 0.0f;
          }
        }
        hv[half] = bf16x2_bits(v[0], v[1]);
        cv[half] = bf16x2_bits(cc[0], cc[1]);
      }
      if (t + 1 < Tn) load_x(t + 1);  // in flight under the barrier

      if (active) {
        // h_t (and c_t) of the thread's quad's 8 units: lane c4 = 0 row
        // ra, lane 1 row ra + 8.
        __nv_bfloat16* h0 = nullptr;
        __nv_bfloat16* h1 = nullptr;
        const size_t row0 = (size_t)(r0 + ra) * Tn + t;
        if (ra < nr) h0 = hs + row0 * H + u0;
        if (ra + 8 < nr) h1 = hs + (row0 + (size_t)8 * Tn) * H + u0;
        store_quad(hv, lane, h0, h1);
        if (cs != nullptr)
          store_quad(cv, lane,
                     h0 == nullptr ? nullptr : cs + row0 * H + u0,
                     h1 == nullptr ? nullptr
                                   : cs + (row0 + (size_t)8 * Tn) * H + u0);
      }
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

template <int CELL, typename XW>
size_t smem_of(int H, int n, int rows) {
  return fwd_grid_smem_bytes(CELL == kLstm ? 4 : 3, H, n, rows);
}

// CTAs of kernel 1 the current card holds at once for this shape, with
// the shared memory it needs set on the kernel.
template <int CELL, typename XW>
cudaError_t grid_capacity(int* ctas, int H, int n, int rows) {
  return lfm_grid::capacity(rnn_fwd_grid_kernel<CELL, XW>, ctas,
                            threads_of(H, n, rows),
                            smem_of<CELL, XW>(H, n, rows));
}

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
  const int threads = threads_of(H, n, rows);
  const size_t smem = smem_of<CELL, XW>(H, n, rows);
  auto kern = rnn_fwd_grid_kernel<CELL, XW>;
  // A grid the card cannot hold at once is refused before any launch.
  cudaError_t err = lfm_grid::check_fits(kern, groups, n, threads, smem);
  if (err != cudaSuccess) return err;
  const XW* xw;
  long long s_xw;
  if (FUSED) {
    err = lfm_cluster::launch_gemm(xin, wx, b, xw_scratch, M, GH, H, seeds,
                                   s_xin, s_wx, s_b, s_gates, stream);
    if (err != cudaSuccess) return err;
    if (kernels != nullptr) *kernels += 1;
    xw = reinterpret_cast<const XW*>(xw_scratch);
    s_xw = s_gates;
  } else {
    xw = static_cast<const XW*>(xin);
    s_xw = s_xin;
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

// Kernel 1's shared memory with a group of n CTAs and `rows` rows a work
// item, in bytes; -1 for a shape it does not take. cell: 0 = LSTM, 1 = GRU.
extern "C" long long lfm_rnn_fwd_grid_smem(int cell, int H, int n, int rows) {
  if (!supported(H, n, rows) || (cell != kLstm && cell != kGru)) return -1;
  return (long long)fwd_grid_smem_bytes(cell == kLstm ? 4 : 3, H, n, rows);
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
    err = fused ? grid_capacity<kLstm, float>(&ctas, H, n, rows)
                : grid_capacity<kLstm, __nv_bfloat16>(&ctas, H, n, rows);
  else
    err = fused ? grid_capacity<kGru, float>(&ctas, H, n, rows)
                : grid_capacity<kGru, __nv_bfloat16>(&ctas, H, n, rows);
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
