// Masked LSTM/GRU recurrence, fused and hoisted forward, in bfloat16 above
// hidden 128 on Hopper's tensor cores (mma.sync m16n8k16, f32
// accumulation), with W_h split across a thread-block cluster.
//
// Replaces, in bfloat16 with 128 < Hp <= 512 (Hp the width padded to a
// multiple of 16; ops/rnn.py _mma_route "cluster"), the Pallas TPU kernels
// _lstm_fused_fwd_kernel (lfm_quant_tpu/ops/pallas_rnn.py:626) and
// _gru_fused_fwd_kernel (:652), reached through _fused_fwd_call (:793), and
// _lstm_fwd_kernel (:135) and _gru_fwd_kernel (:158), reached through
// _fwd_call (:365), with their seed rules (_fwd_vmap :920,
// _make_scan._fwd_vmap :504). It computes what csrc/rnn_fused_fwd_mma.cu
// computes at H <= 128 (the formulas are written out there), at the TPU
// kernels' rounding points: h and c carried in f32, bf16(h_{t-1}) the
// recurrent product's operand, h_t and c_t stored in bf16. The fused
// form's x side is an f32 sum that is never rounded to bf16 (the JAX
// fused kernel sums hin W_x + b + h W_h in f32).
//
// Why a cluster. W_h is G Hp^2 bf16: 512 KB for the LSTM at H 256, 2 MB at
// H 512, past one CTA's 227 KB. The CUDA-core kernels (rnn_fused_fwd.cu)
// re-read it from L2 in every block and step and run the products in f32
// at 67 TFLOP/s; here each CTA of a cluster keeps its share of W_h in
// shared memory for all T steps and runs its products at the bf16 rate.
//
// Bound. At B 2048, T 60, H 256 (LSTM) the fused function is 2 products of
// 2 H G H per row and step: 6.4e10 operations, 0.065 ms at 989 TFLOP/s,
// against 0.13 GB of hin in and h, c out (0.039 ms): bound by operations.
// The hoisted form reads the G-times wider xw (bytes).
//
// Design: the fused form is a GEMM followed by the hoisted recurrence.
//
// * Kernel 0 (fused form), a bf16 tensor-core GEMM: xw = hin @ W_x + b
//   into an f32 scratch [S, B, T, G Hp] the caller allocates (503 MB at B
//   2048, H 256, LSTM), so the x side runs off the dependent chain. Tiles
//   of 128 x 128 outputs, 8 warps of 64 x 32, k in stages of 32 through
//   three cp.async shared-memory stages; A by ldmatrix, W_x (row-major
//   [Hp, G Hp]) by ldmatrix.trans; the bias added in f32 at the store
//   (csrc/cluster_gemm.cuh, which the fused backward shares).
// * Kernel 1, the recurrence. A cluster of C CTAs owns 16 RT batch rows
//   for all T steps. The Hp / 8 warps of units are dealt out evenly: CTA j
//   owns warps [j W / C, (j + 1) W / C) of W = Hp / 8 (floor), so
//   NW = ceil(W / C) or one fewer, with all G gates (a CTA with fewer
//   warps leaves its last one idle but for the barriers), and holds their
//   W_h columns once in shared memory in mma fragment order ([KT k-steps]
//   [NW warps][G n8 tiles][32 lanes][4], the wrapper's packing: ops/rnn.py
//   pack_cluster). Warp w owns 8 units, so the gate sums, the cell and the
//   carries of a (row, unit) sit in one thread's registers. Per step:
//   bf16(h_{t-1}) for all Hp units is read by ldmatrix from the step's h
//   tile [rows, Hp + 8]; the products accumulate in f32 onto xw_t, which
//   waits in registers (loaded a step ahead); the cell runs with the
//   accurate expf/tanhf; each quad of lanes gathers its 8 units of a row by
//   shuffles and writes them as one 16-byte store into every CTA's other h
//   tile through distributed shared memory (its own included); then one
//   cluster barrier, split into its arrive and its wait around the stores
//   of c_t to device memory. h_t goes out after the next wait, each CTA its
//   own columns from the tile with 16-byte stores. The tiles are
//   double-buffered, so a step's writes never race the last step's reads.
// * A row's gate sums do not depend on C or on the rows per CTA (the same
//   k order from the same start), so neither do its bits.
// * Seeds: blockIdx.y is the seed (blockIdx.z of kernel 0); each operand
//   has its own seed stride (0: shared), every per-seed offset is 64-bit,
//   and a seed's outputs are bitwise those of its one-seed launch.
// * The launch goes through cudaLaunchKernelEx with clusterDim.x = C
//   (non-portable sizes allowed past 8); a cluster the card cannot hold
//   (cudaOccupancyMaxActiveClusters 0) is refused.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_gemm.cuh"
#include "mma_common.cuh"
#include "tf32_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace lfm_mma;
using lfm_cluster::launch_gemm;
using lfm_tf32::cluster_arrive;
using lfm_tf32::cluster_wait;
using lfm_tf32::sigmoid;

constexpr int kLstm = 0;
constexpr int kGru = 1;
constexpr int kUnits = 8;       // hidden units per warp of kernel 1
constexpr int kMaxWidth = 512;  // the widest Hp kernel 1 takes
constexpr int kMaxCluster = 16;

// Kernel 1's threads per CTA at most, by 16-row tiles: the registers of
// RT tiles' sums and xw_t (168 a thread at 384 threads).
__host__ __device__ constexpr int max_threads(int rt) {
  return rt == 1 ? 512 : 384;
}

struct SeedStrides {
  long long xw, wh, m;
};

inline int warps_per_cta(int H, int C) {
  const int W = H / kUnits;
  return (W + C - 1) / C;
}

// Kernel 1's shared memory: the CTA's W_h share [H, G U] bf16 and two h
// tiles [rows, H + 8] bf16. ops/rnn.py _cluster_smem mirrors it.
inline size_t recur_smem_bytes(int G, int H, int C, int rows) {
  const size_t U = (size_t)kUnits * warps_per_cta(H, C);
  return (size_t)H * G * U * 2 + 2 * (size_t)rows * (H + 8) * 2;
}

// Kernel 1, per seed (blockIdx.y), CTA rank j of a cluster of C along x,
// blockDim.x = 32 NW. xw [B, T, G H] (the gates' x side with the bias; f32
// or bf16); whp: W_h packed per CTA (ops/rnn.py pack_cluster), C slices of
// H/16 x NW x G x 32 uint2; m uint8 [B, T]. Out: h_out, c_out (LSTM, may
// be null) [B, T, H] bf16.
template <int CELL, int RT, typename XW>
__global__ void __launch_bounds__(max_threads(RT), 1)
rnn_fwd_cluster_kernel(const XW* __restrict__ xw,
                       const uint2* __restrict__ whp,
                       const uint8_t* __restrict__ m,
                       __nv_bfloat16* __restrict__ h_out,
                       __nv_bfloat16* __restrict__ c_out, int B, int Tn,
                       int H, SeedStrides st, float forget_bias) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int BB = 16 * RT;  // rows per cluster
  using XW2 = typename XwPair<XW>::type;
  const int GH = G * H;
  const int KT = H / 16;
  const int NW = blockDim.x / 32;
  const int LD = H + 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t slice = (size_t)KT * NW * G * 32;  // uint2 per CTA
  uint2* wh_s = reinterpret_cast<uint2*>(smem);
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem + slice * 8);

  {
    const size_t seed = blockIdx.y;
    const size_t seq = (size_t)B * Tn * H;
    xw += seed * st.xw;
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
  const int r0 = (blockIdx.x / C) * BB;
  const int nr = min(BB, B - r0);
  const int W = H / kUnits;
  const int cta_u0 = rank * W / C * kUnits;
  const int cta_chunks = (rank + 1) * W / C - rank * W / C;  // its warps
  const int u0 = cta_u0 + warp * kUnits;
  const bool active = warp < cta_chunks;  // warp-uniform

  {
    const char* src = reinterpret_cast<const char*>(whp + rank * slice);
    for (size_t i = tid; i < slice / 2; i += nth)
      cp_async16(smem + 16 * i, src + 16 * i, 16);
  }
  cp_async_commit();
  {
    uint32_t* z = reinterpret_cast<uint32_t*>(h_s);
    for (int i = tid; i < BB * LD; i += nth) z[i] = 0u;  // both h tiles
  }

  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix address
  const int acol = (lane >> 4) * 8;
  const int row_l = lane >> 2;        // + 16 rt + 8 half
  const int c4 = lane & 3;
  const int u = u0 + 2 * c4;          // the thread's units u, u + 1
  const uint2* wh_w = wh_s + warp * G * 32 + lane;

  // The thread's xw_t pairs and step validity, loaded a step ahead; rows
  // past B read 0 and are never kept.
  XW2 xs[RT][2][G];
  bool keep[RT][2];
  auto load_x = [&](int t) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + row_l + 8 * half;
        const bool in = r < nr;
        const size_t row = (size_t)(r0 + r) * Tn + t;
        keep[rt][half] = in && m[row] != 0;
#pragma unroll
        for (int q = 0; q < G; ++q)
          xs[rt][half][q] =
              in && active
                  ? *reinterpret_cast<const XW2*>(xw + row * GH + q * H + u)
                  : XwPair<XW>::zero();
      }
  };
  // Each CTA stores its own units' columns of h_t from a tile.
  auto store_h = [&](int t, const __nv_bfloat16* tile) {
    for (int i = tid; i < nr * cta_chunks; i += nth) {
      const int r = i / cta_chunks;
      const int k = cta_u0 + (i - r * cta_chunks) * 8;
      *reinterpret_cast<uint4*>(h_out + ((size_t)(r0 + r) * Tn + t) * H + k) =
          *reinterpret_cast<const uint4*>(tile + r * LD + k);
    }
  };
  load_x(0);

  // The f32 carry of the thread's (row, unit) pairs: c for the LSTM, h for
  // the GRU. [rt][half * 2 + e]
  float carry[RT][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int i = 0; i < 4; ++i) carry[rt][i] = 0.0f;

  cp_async_wait_all();
  // W_h and the zero tiles are in place; every CTA of the cluster runs
  // before any stores into another's memory.
  cluster_arrive();

  for (int t = 0; t < Tn; ++t) {
    cluster_wait();  // h_{t-1} of every unit is in this step's tile
    const int cur = t & 1;
    const __nv_bfloat16* ht = h_s + cur * BB * LD;
    if (t > 0) store_h(t - 1, ht);

    // Slots: the G x-side gates from xw_t; the GRU's slot 3 is the h side
    // of n.
    float acc[RT][4][4];
    bool kp[RT][2];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      kp[rt][0] = keep[rt][0];
      kp[rt][1] = keep[rt][1];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = as_float2(xs[rt][i >> 1][q < G ? q : 0]);
          acc[rt][q][i] = q < G ? ((i & 1) ? v.y : v.x) : 0.0f;
        }
    }
    if (t + 1 < Tn) load_x(t + 1);

    if (active) {
      for (int kk = 0; kk < KT; ++kk) {
        uint2 bh[G];
#pragma unroll
        for (int q = 0; q < G; ++q)
          bh[q] = wh_w[(size_t)kk * NW * G * 32 + q * 32];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          uint32_t a[4];
          ldmatrix_x4(a, ht + (rt * 16 + arow) * LD + kk * 16 + acol);
#pragma unroll
          for (int q = 0; q < G; ++q)
            mma_bf16(acc[rt][CELL == kGru && q == 2 ? 3 : q], a, bh[q]);
        }
      }

      // The cell, in registers; each quad's 8 units of a row into every
      // CTA's other tile, one 16-byte store each.
      __nv_bfloat16* hn = h_s + (cur ^ 1) * BB * LD;
      const int quad = lane & ~3;
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        uint32_t hv[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rt * 16 + row_l + 8 * half;
          const bool k = kp[rt][half];
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = half * 2 + e;
            float& cr = carry[rt][i];
            if (CELL == kLstm) {
              const float ig = sigmoid(acc[rt][0][i]);
              const float fg = sigmoid(acc[rt][1][i] + forget_bias);
              const float gg = tanhf(acc[rt][2][i]);
              const float og = sigmoid(acc[rt][3][i]);
              const float c = fg * cr + ig * gg;
              const float h = og * tanhf(c);
              if (k) cr = c;
              // A held LSTM h is only ever read as bf16: the tile has it.
              v[e] = k ? h : __bfloat162float(ht[r * LD + u + e]);
            } else {
              const float z = sigmoid(acc[rt][0][i]);
              const float rg = sigmoid(acc[rt][1][i]);
              const float n =
                  tanhf(acc[rt][2][i] + rg * acc[rt][3][i]);
              const float h = (1.0f - z) * n + z * cr;
              if (k) cr = h;
              v[e] = cr;
            }
          }
          hv[half] = bf16x2_bits(v[0], v[1]);
        }
        uint4 row16[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          row16[half].x = __shfl_sync(0xffffffffu, hv[half], quad);
          row16[half].y = __shfl_sync(0xffffffffu, hv[half], quad + 1);
          row16[half].z = __shfl_sync(0xffffffffu, hv[half], quad + 2);
          row16[half].w = __shfl_sync(0xffffffffu, hv[half], quad + 3);
        }
        // (half, CTA) pairs shared out over the quad's four lanes.
        for (int i = c4; i < 2 * C; i += 4) {
          const int half = i >= C;
          const int p = i - half * C;
          const int r = rt * 16 + row_l + 8 * half;
          uint4* dst = cluster.map_shared_rank(
              reinterpret_cast<uint4*>(hn + r * LD + u0), p);
          *dst = half ? row16[1] : row16[0];
        }
      }
    }
    cluster_arrive();

    // Off the chain until the next step's wait: c_t to device memory, each
    // quad's 8 units of a row in one 16-byte store (lane c4 < 2: row half
    // c4).
    if (CELL == kLstm && c_out != nullptr && active) {
      const int quad = lane & ~3;
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        uint32_t cv[2];
#pragma unroll
        for (int half = 0; half < 2; ++half)
          cv[half] = bf16x2_bits(carry[rt][2 * half], carry[rt][2 * half + 1]);
        uint4 row16[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          row16[half].x = __shfl_sync(0xffffffffu, cv[half], quad);
          row16[half].y = __shfl_sync(0xffffffffu, cv[half], quad + 1);
          row16[half].z = __shfl_sync(0xffffffffu, cv[half], quad + 2);
          row16[half].w = __shfl_sync(0xffffffffu, cv[half], quad + 3);
        }
        const int r = rt * 16 + row_l + 8 * (c4 & 1);
        if (c4 < 2 && r < nr)
          *reinterpret_cast<uint4*>(c_out + ((size_t)(r0 + r) * Tn + t) * H +
                                    u0) = c4 ? row16[1] : row16[0];
      }
    }
  }
  // No CTA leaves while a peer could still store into its shared memory.
  cluster_wait();
  store_h(Tn - 1, h_s + (Tn & 1) * BB * LD);
}

// The launch configuration of kernel 1 (grid, block, cluster, shared
// memory), with the attributes it needs set on the kernel.
template <int CELL, int RT, typename XW>
cudaError_t recur_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                         int S, int B, int H, int C, cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int rows = 16 * RT;
  auto kern = rnn_fwd_cluster_kernel<CELL, RT, XW>;
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
  return cudaOccupancyMaxActiveClusters(clusters,
                                        rnn_fwd_cluster_kernel<CELL, RT, XW>,
                                        &cfg);
}

// Kernel 1 through cudaLaunchKernelEx; refused
// (cudaErrorLaunchOutOfResources) when the card cannot hold one cluster.
template <int CELL, int RT, typename XW>
cudaError_t launch_recur(const XW* xw, const void* whp, const uint8_t* m,
                         void* h_out, void* c_out, int S, int B, int Tn,
                         int H, int C, SeedStrides st, float forget_bias,
                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = recur_config<CELL, RT, XW>(cfg, attr, S, B, H, C, stream);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, rnn_fwd_cluster_kernel<CELL, RT, XW>, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters == 0) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(
      &cfg, rnn_fwd_cluster_kernel<CELL, RT, XW>, xw,
      static_cast<const uint2*>(whp), m, static_cast<__nv_bfloat16*>(h_out),
      CELL == kLstm ? static_cast<__nv_bfloat16*>(c_out) : nullptr, B, Tn, H,
      st, forget_bias);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The shapes kernel 1 takes: 128 < H <= 512, H % 16 == 0, C in {2, 4, 8,
// 16}, 16 or 32 rows, and the CTA's warps within the row count's thread
// limit.
bool supported(int H, int C, int rows) {
  if (H <= 128 || H > kMaxWidth || H % 16 != 0) return false;
  if (C != 2 && C != 4 && C != 8 && C != kMaxCluster) return false;
  if (rows != 16 && rows != 32) return false;
  return warps_per_cta(H, C) * 32 <= max_threads(rows / 16);
}

template <int CELL, typename XW>
cudaError_t dispatch_rows(int rows, const XW* xw, const void* whp,
                          const uint8_t* m, void* h_out, void* c_out, int S,
                          int B, int Tn, int H, int C, SeedStrides st,
                          float fb, cudaStream_t s) {
  if (rows == 16)
    return launch_recur<CELL, 1, XW>(xw, whp, m, h_out, c_out, S, B, Tn, H,
                                     C, st, fb, s);
  return launch_recur<CELL, 2, XW>(xw, whp, m, h_out, c_out, S, B, Tn, H, C,
                                   st, fb, s);
}

template <int CELL, typename XW>
cudaError_t clusters_rows(int* n, int rows, int H, int C) {
  if (rows == 16) return recur_clusters<CELL, 1, XW>(n, H, C);
  return recur_clusters<CELL, 2, XW>(n, H, C);
}

}  // namespace

// Shared memory of kernel 1 (the larger of the two launches) in bytes; -1
// for a shape the kernels do not take. cell: 0 = LSTM, 1 = GRU; C: CTAs
// per cluster; rows: batch rows per cluster (16 or 32).
extern "C" long long lfm_rnn_fwd_cluster_smem(int cell, int H, int C,
                                              int rows) {
  if (!supported(H, C, rows) || (cell != kLstm && cell != kGru)) return -1;
  return (long long)recur_smem_bytes(cell == kLstm ? 4 : 3, H, C, rows);
}

// Clusters of kernel 1 the current card holds at once for this shape (the
// fused form's kernel 1 reads f32 xw, the hoisted form's bf16); -1 for a
// shape the kernels do not take or a CUDA error.
extern "C" int lfm_rnn_fwd_cluster_clusters(int cell, int fused, int H,
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

// The bfloat16 forward above hidden 128 for S seeds in one call. fused =
// 1: xin is hin [B, T, H] bf16 per seed, and wx [H, G H], b [G H] bf16 are
// used; xw_scratch [S, B, T, G H] f32 is the caller's scratch for xw.
// fused = 0: xin is xw [B, T, G H] bf16 (wx, b, xw_scratch unused). Per
// seed: whp, W_h packed per CTA for a cluster of C (ops/rnn.py
// pack_cluster); m uint8 [B, T]. Out h_out, c_out (LSTM; null: not
// written) [S, B, T, H] bf16. rows: batch rows per cluster (16 or 32).
// s_*: the seed strides of xin, wx, b, whp and m in their elements (0:
// shared). Returns the first CUDA error of its launches.
extern "C" int lfm_rnn_fwd_cluster(int cell, int fused, const void* xin,
                                   const void* wx, const void* b,
                                   const void* whp, const void* m,
                                   void* h_out, void* c_out,
                                   void* xw_scratch, int S, int B, int Tn,
                                   int H, int C, int rows, long long s_xin,
                                   long long s_wx, long long s_b,
                                   long long s_wh, long long s_m,
                                   float forget_bias, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (S <= 0 || S > 65535 || B <= 0 || Tn <= 0 || !supported(H, C, rows) ||
      (cell != kLstm && cell != kGru))
    return (int)cudaErrorInvalidValue;
  const int G = cell == kLstm ? 4 : 3;
  const auto* mm = static_cast<const uint8_t*>(m);
  if (fused) {
    const int M = B * Tn;
    const long long s_gates = (long long)M * G * H;
    float* xw = static_cast<float*>(xw_scratch);
    cudaError_t err = launch_gemm(xin, wx, b, xw, M, G * H, H, S, s_xin,
                                  s_wx, s_b, s_gates, cs);
    if (err != cudaSuccess) return (int)err;
    const SeedStrides st{s_gates, s_wh, s_m};
    if (cell == kLstm)
      return (int)dispatch_rows<kLstm, float>(rows, xw, whp, mm, h_out,
                                              c_out, S, B, Tn, H, C, st,
                                              forget_bias, cs);
    return (int)dispatch_rows<kGru, float>(rows, xw, whp, mm, h_out, c_out,
                                           S, B, Tn, H, C, st, forget_bias,
                                           cs);
  }
  const auto* xw = static_cast<const __nv_bfloat16*>(xin);
  const SeedStrides st{s_xin, s_wh, s_m};
  if (cell == kLstm)
    return (int)dispatch_rows<kLstm, __nv_bfloat16>(
        rows, xw, whp, mm, h_out, c_out, S, B, Tn, H, C, st, forget_bias, cs);
  return (int)dispatch_rows<kGru, __nv_bfloat16>(
      rows, xw, whp, mm, h_out, c_out, S, B, Tn, H, C, st, forget_bias, cs);
}
