// Masked LSTM/GRU recurrence, fused and hoisted forward, in float32 on
// Hopper: the recurrence on the tensor cores, 3xTF32 products (mma.sync
// m16n8k8 .tf32, f32 accumulation) with W_h split across a 2-CTA cluster
// and h_t all-gathered through distributed shared memory; the fused form's
// x-side GEMM on the CUDA cores.
//
// Replaces, in float32 with 16 <= H <= 128 and H % 16 == 0 (ops/rnn.py
// _mma_route), the Pallas TPU kernels _lstm_fused_fwd_kernel
// (lfm_quant_tpu/ops/pallas_rnn.py:626) and _gru_fused_fwd_kernel (:652),
// reached through _fused_fwd_call (:793), and _lstm_fwd_kernel (:135) and
// _gru_fwd_kernel (:158), reached through _fwd_call (:365). It computes what
// csrc/rnn_fused_fwd.cu computes in float32 (the formulas are written out
// there): the LSTM (i, f, g, o; forget_bias on f) or the GRU (z, r, n, the
// reset after the projection) with an f32 carry, h (and c) held on a masked
// step, out h_all and, when asked, c_all.
//
// Numerics. The recurrence's product is 3xTF32, as csrc/tf32_common.cuh
// sets out, with lo rounded to nearest (kRoundLo); each k-step of 8 leaves
// the tensor cores' truncating accumulator for the f32 gate sums at once
// (kRecurChainK), and xw_t is added last, as the plain version adds its two
// products (kXwLast). The fused form's xw is an f32 FMA sum on the CUDA
// cores, as the plain version's matmul rounds: the tensor cores'
// truncation biases a 3xTF32 xw toward zero (a mean error of -3.3e-8 to
// -7.5e-8 toward |xw| at the c2 train step, where an f32 sum's is 3e-11),
// and over 60 steps that bias alone took c_all (|c| up to 43) 1.7e-5 to
// 2.3e-5 from the plain version, over the JAX f32 bound of 1e-5; on the
// plain version's xw the same recurrence reads 7.6e-6 (NVIDIA H100 80GB
// HBM3; scripts/torch_mma_variants.py --kernel fwd_tf32 measures every
// variant). The cell uses the accurate expf/tanhf and rounds each product
// and sum of its carries' updates as the plain version does (no fused
// multiply-add).
//
// Bound. At the c2 train step (B 2048, T 60, H 128, LSTM, f32, saving
// c_all) the fused function is 2 products of 2 H G H per row and step:
// 3.2e10 operations, 0.195 ms at the 3xTF32 rate (495 / 3 TFLOP/s) and
// 0.481 ms at the CUDA cores' 67 TFLOP/s, against 0.19 GB of inputs and
// outputs; the hoisted form does one of the two products and reads the
// G-times wider xw, 0.38 GB: bound by bytes (0.113 ms).
//
// Design: the fused form is a GEMM followed by the hoisted recurrence.
//
// * Kernel 0 (fused form), an f32 GEMM on the CUDA cores: xw = hin @ W_x +
//   b into an f32 scratch [S, B, T, G H] that the caller allocates (252 MB
//   at the c2 train step; 64 times that for a c5-shaped float32 stack; in
//   training the backward takes it as its d_gates buffer), so the x-side
//   product runs off the dependent chain. Blocks of 128 x 128 outputs,
//   each thread 8 x 8 of them, k in stages of 16 through two shared-memory
//   buffers (the next stage's loads held in registers over the products).
// * Kernel 1, the recurrence. A cluster of kCluster = 2 CTAs owns
//   kRowTiles x 16 rows for all T steps, at every width: where all of W_h
//   would fit one CTA (H <= 96 LSTM, <= 112 GRU), two CTAs of half the
//   units were still 1.3-1.6x faster at B 2048 (twice the SMs busy). CTA j
//   owns the hidden units [j H/2, (j + 1) H/2) with all G gates and holds
//   their W_h columns once in shared memory, f32, row-major [H, G H/2 + 4]
//   (133 KB for the LSTM at H = 128): warp w owns 8 of them, so the gate
//   sums, the cell and the c carry of a (row, unit) sit in one thread's
//   registers. Per step: h_{t-1} @ W_h[:, own] is summed from zero, h_{t-1}
//   for all H units read from a shared h tile, and xw_t (loaded into
//   registers a step ahead) is added last, as the plain version adds its
//   two products (kXwLast); the cell runs; the all-gather writes h_t of
//   the CTA's units into the peer's tile (first, through distributed
//   shared memory) and into its own; one cluster
//   barrier, split into its arrive and its wait around the stores of h_t
//   (and c_t) to device memory and the next step's loads, is the only
//   cross-CTA wait. The h tile is double-buffered, so the writes of step t
//   never race the reads of step t - 1. The fragment loads are those of
//   csrc/rnn_bwd_tf32.cu's recompute (lane c takes k = 2c, 2c + 1 of each
//   8-step: one 64-bit load of h), free of bank conflicts.
// * Seeds (pallas_rnn.py _fwd_vmap :919): the seed is blockIdx.y of
//   kernel 1 and blockIdx.z of kernel 0; each shared operand has its own
//   seed stride (0: shared), every per-seed offset is 64-bit, and a seed's
//   outputs are bitwise those of a one-seed launch.

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
using lfm_tf32::cluster_arrive;
using lfm_tf32::cluster_wait;
using lfm_tf32::frag_a;
using lfm_tf32::frag_b;
using lfm_tf32::FragA;
using lfm_tf32::FragB;
using lfm_tf32::mma3;
using lfm_tf32::SeedStrides;
using lfm_tf32::sigmoid;

constexpr int kLstm = 0;
constexpr int kGru = 1;
constexpr int kUnits = 8;     // hidden units per warp of kernel 1
constexpr int kRowTiles = 2;  // 16-row tiles per CTA of kernel 1
constexpr int kCluster = 2;   // CTAs per cluster of kernel 1
constexpr int kRecurChainK = 8;   // k per mma chain of kernel 1
constexpr bool kRoundLo = true;   // lo rounded to nearest (split_tf32)
constexpr bool kXwLast = true;    // gates = xw_t + h side, summed apart
// Kernel 1's threads per CTA at most: 128 / kCluster units, kUnits a warp.
constexpr int kMaxThreads = 128 / kCluster * 32 / kUnits;

// Kernel 0: output rows and columns per block, k per stage, threads.
constexpr int kSgRows = 128;
constexpr int kSgCols = 128;
constexpr int kSgK = 16;
constexpr int kSgThreads = 256;

// Kernel 0, per seed (blockIdx.z): C[M, N] = A[M, K] @ W[K, N] + bias[N],
// all row-major f32, K and N multiples of 4. Block (blockIdx.x, blockIdx.y)
// makes the rows and columns [128 x, +128) x [128 y, +128); thread (ty, tx)
// of 16 x 16 the rows 4 ty + {0..3, 64..67} and the columns 4 tx + {0..3,
// 64..67}, each an FMA sum over k from zero, then + bias. A's stage is
// stored transposed (As[k][row]), so both operands are read as float4.
__global__ void __launch_bounds__(kSgThreads, 2)
fwd_sgemm_kernel(const float* __restrict__ A, const float* __restrict__ W,
                 const float* __restrict__ bias, float* __restrict__ Cout,
                 int M, int N, int K, long long sA, long long sW,
                 long long sBias, long long sC) {
  __shared__ __align__(16) float As[2][kSgK][kSgRows];
  __shared__ __align__(16) float Ws[2][kSgK][kSgCols];
  {
    const size_t seed = blockIdx.z;
    A += seed * sA;
    W += seed * sW;
    bias += seed * sBias;
    Cout += seed * sC;
  }
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * kSgRows;
  const int n0 = blockIdx.y * kSgCols;
  // A stage: 128 rows x 16 k, 4 float4 a row; a W stage: 16 k x 128
  // columns, 32 float4 a row: two float4 of each per thread.
  float4 ra[2], rw[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = tid + r * kSgThreads;
      const int row = m0 + (i & 127), k = k0 + 4 * (i >> 7);
      ra[r] = row < M && k < K
                  ? *reinterpret_cast<const float4*>(A + (size_t)row * K + k)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int kw = k0 + (i >> 5), col = n0 + 4 * (i & 31);
      rw[r] = kw < K && col < N
                  ? *reinterpret_cast<const float4*>(W + (size_t)kw * N + col)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = tid + r * kSgThreads;
      const int row = i & 127, k = 4 * (i >> 7);
      As[buf][k][row] = ra[r].x;
      As[buf][k + 1][row] = ra[r].y;
      As[buf][k + 2][row] = ra[r].z;
      As[buf][k + 3][row] = ra[r].w;
      *reinterpret_cast<float4*>(&Ws[buf][i >> 5][4 * (i & 31)]) = rw[r];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  load(0);
  store(0);
  __syncthreads();
  const int nk = (K + kSgK - 1) / kSgK;
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * kSgK);
#pragma unroll
    for (int k = 0; k < kSgK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][4 * ty + 64]);
      const float4 w0 = *reinterpret_cast<const float4*>(&Ws[buf][k][4 * tx]);
      const float4 w1 =
          *reinterpret_cast<const float4*>(&Ws[buf][k][4 * tx + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    // Every thread read buffer buf ^ 1 before the last barrier.
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + 4 * ty + (i & 3) + 64 * (i >> 2);
    if (row >= M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int col = n0 + 4 * tx + 64 * jh;
      if (col >= N) continue;
      const float4 bv = *reinterpret_cast<const float4*>(bias + col);
      *reinterpret_cast<float4*>(Cout + (size_t)row * N + col) =
          make_float4(acc[i][4 * jh] + bv.x, acc[i][4 * jh + 1] + bv.y,
                      acc[i][4 * jh + 2] + bv.z, acc[i][4 * jh + 3] + bv.w);
    }
  }
}

cudaError_t launch_sgemm(const float* A, const float* W, const float* bias,
                         float* Cout, int M, int N, int K, int seeds,
                         long long sA, long long sW, long long sBias,
                         long long sC, cudaStream_t stream) {
  fwd_sgemm_kernel<<<dim3((M + kSgRows - 1) / kSgRows,
                          (N + kSgCols - 1) / kSgCols, seeds),
                     kSgThreads, 0, stream>>>(A, W, bias, Cout, M, N, K, sA,
                                              sW, sBias, sC);
  return cudaGetLastError();
}

// Kernel 1's shared memory, f32: W_h's own columns [H, G H/2 + 4] and two
// h tiles [rows, H + 8]. ops/rnn.py _tf32_smem(direction="fwd") mirrors it.
inline size_t recur_smem_bytes(int G, int H) {
  const size_t rows = 16 * kRowTiles;
  const size_t GHc = (size_t)G * (H / kCluster);
  return 4 * ((size_t)H * (GHc + 4) + 2 * rows * (H + 8));
}

// Kernel 1, per seed (blockIdx.y), CTA rank j of a cluster of kCluster
// along x. xw [B, T, G H] f32, the gates' x side with the bias; wh [H, G
// H]; m uint8 [B, T]. Out: h_out, c_out (LSTM, may be null) [B, T, H] f32.
template <int CELL>
__global__ void __launch_bounds__(kMaxThreads, 1)
rnn_fwd_tf32_recur_kernel(const float* __restrict__ xw,
                          const float* __restrict__ wh,
                          const uint8_t* __restrict__ m,
                          float* __restrict__ h_out,
                          float* __restrict__ c_out, int B, int Tn, int H,
                          SeedStrides st, float forget_bias) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int RT = kRowTiles;
  constexpr int BB = 16 * RT;  // rows per CTA
  constexpr int C = kCluster;
  const int GH = G * H;
  const int Hc = H / C;        // units per CTA
  const int GHc = G * Hc;      // own W_h columns
  const int LW = GHc + 4;      // W_h row stride
  const int LD = H + 8;        // h tile row stride

  extern __shared__ __align__(16) float smem[];
  float* wh_s = smem;
  float* h_s = wh_s + (size_t)H * LW;

  {
    const size_t seed = blockIdx.y;
    const size_t seq = (size_t)B * Tn * H;
    xw += seed * st.xw;
    wh += seed * st.wh;
    m += seed * st.m;
    h_out += seed * seq;
    if (c_out != nullptr) c_out += seed * seq;
  }

  const int rank = (int)cg::this_cluster().block_rank();
  float* peer_s = cg::this_cluster().map_shared_rank(h_s, rank ^ 1);
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
  cp_async_commit();
  for (int i = tid; i < BB * LD; i += nth) h_s[i] = 0.0f;  // h_{-1} = 0

  // The x side of step t, loaded a step ahead, and the gate sums,
  // [rt][q][half * 2 + e] as the accumulators: h_{t-1} @ W_h, then (all
  // but the GRU's candidate, n = tanh(xn + r hn)) + the x side.
  float xs[RT][G][4];
  float acc[RT][G][4];
  bool keep[RT][2];
  auto load_x = [&](int t) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + g + 8 * half;
        const bool in = r < nr;
        const size_t row = (size_t)(r0 + r) * Tn + t;
        keep[rt][half] = in && m[row] != 0;
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const float2 v =
              in ? *reinterpret_cast<const float2*>(xw + row * GH + q * H + u)
                 : make_float2(0.0f, 0.0f);
          xs[rt][q][2 * half] = v.x;
          xs[rt][q][2 * half + 1] = v.y;
        }
      }
  };
  // Where the x side joins the sums: first (not kXwLast) or last.
  const auto x_first = [](int q) {
    return !kXwLast && !(CELL == kGru && q == 2);
  };
  const auto x_last = [](int q) {
    return kXwLast && !(CELL == kGru && q == 2);
  };
  load_x(0);

  // The carries h and (LSTM) c of the thread's (row, unit) pairs.
  float hc[RT][4], cc[RT][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hc[rt][i] = 0.0f;
      cc[rt][i] = 0.0f;
    }

  cp_async_wait_all();
  // W_h and the zero tile are in place; every CTA of the cluster runs
  // before any stores into another's memory.
  cluster_arrive();

  for (int t = 0; t < Tn; ++t) {
    cluster_wait();  // h_{t-1} of every unit is in
    const int cur = t & 1;
    const float* ht = h_s + cur * BB * LD;
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[rt][q][i] = x_first(q) ? xs[rt][q][i] : 0.0f;

    // The h side of the gates: h_{t-1} @ W_h[:, own], lane c taking k0 + 2c
    // and k0 + 2c + 1 of each 8-step in both operands.
    for (int kc = 0; kc < H; kc += kRecurChainK) {
      float cacc[RT][G][4];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) cacc[rt][q][i] = 0.0f;
      for (int k0 = kc; k0 < min(H, kc + kRecurChainK); k0 += 8) {
        FragB bw[G];
        const float* wp =
            wh_s + (size_t)(k0 + 2 * c4) * LW + warp * kUnits + g;
#pragma unroll
        for (int q = 0; q < G; ++q)
          frag_b<kRoundLo>(bw[q], wp[q * Hc], wp[q * Hc + LW]);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          const float* hp = ht + (rt * 16 + g) * LD + k0 + 2 * c4;
          const float2 x0 = *reinterpret_cast<const float2*>(hp);
          const float2 x1 = *reinterpret_cast<const float2*>(hp + 8 * LD);
          FragA a;
          frag_a<kRoundLo>(a, x0.x, x1.x, x0.y, x1.y);
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
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (x_last(q)) acc[rt][q][i] = xs[rt][q][i] + acc[rt][q][i];

    // The cell, in registers; h_t of the thread's units into the peer's
    // tile as soon as each row's pair is done, then into its own.
    float* hn_own = h_s + (cur ^ 1) * BB * LD;
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * half + e;
          if (CELL == kLstm) {
            const float ig = sigmoid(acc[rt][0][i]);
            const float fg = sigmoid(acc[rt][1][i] + forget_bias);
            const float gg = tanhf(acc[rt][2][i]);
            const float og = sigmoid(acc[rt][3][i]);
            const float c =
                __fadd_rn(__fmul_rn(fg, cc[rt][i]), __fmul_rn(ig, gg));
            const float h = og * tanhf(c);
            if (keep[rt][half]) {
              cc[rt][i] = c;
              hc[rt][i] = h;
            }
          } else {
            const float z = sigmoid(acc[rt][0][i]);
            const float rg = sigmoid(acc[rt][1][i]);
            const float n =
                tanhf(__fadd_rn(xs[rt][2][i], __fmul_rn(rg, acc[rt][2][i])));
            const float h =
                __fadd_rn(__fmul_rn(1.0f - z, n), __fmul_rn(z, hc[rt][i]));
            if (keep[rt][half]) hc[rt][i] = h;
          }
        }
        const int r = rt * 16 + g + 8 * half;
        *reinterpret_cast<float2*>(peer_s + (cur ^ 1) * BB * LD + r * LD +
                                   u) =
            make_float2(hc[rt][2 * half], hc[rt][2 * half + 1]);
      }
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + g + 8 * half;
        *reinterpret_cast<float2*>(hn_own + r * LD + u) =
            make_float2(hc[rt][2 * half], hc[rt][2 * half + 1]);
      }
    cluster_arrive();

    // Off the chain until the next step's wait: h_t (and c_t) to device
    // memory, and the next step's x side.
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + g + 8 * half;
        if (r >= nr) continue;
        const size_t o = ((size_t)(r0 + r) * Tn + t) * H + u;
        *reinterpret_cast<float2*>(h_out + o) =
            make_float2(hc[rt][2 * half], hc[rt][2 * half + 1]);
        if (CELL == kLstm && c_out != nullptr)
          *reinterpret_cast<float2*>(c_out + o) =
              make_float2(cc[rt][2 * half], cc[rt][2 * half + 1]);
      }
    if (t + 1 < Tn) load_x(t + 1);
  }
  // No CTA leaves while a peer could still store into its shared memory.
  cluster_wait();
}

// Kernel 1 through cudaLaunchKernelEx with a cluster of kCluster CTAs
// along x; refused (cudaErrorLaunchOutOfResources) when the card cannot
// hold one such cluster. The attribute and the cluster check are made once
// per shared-memory size and device.
template <int CELL>
cudaError_t launch_recur(const float* xw, const float* wh, const uint8_t* m,
                         float* h_out, float* c_out, int seeds, int B, int Tn,
                         int H, SeedStrides st, float forget_bias,
                         cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  constexpr int C = kCluster;
  auto kern = rnn_fwd_tf32_recur_kernel<CELL>;
  const size_t smem = recur_smem_bytes(G, H);
  constexpr int rows = 16 * kRowTiles;
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
  cfg.numAttrs = 1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static size_t ready_smem = 0;
  static int ready_device = -1;
  if (ready_smem != smem || ready_device != device) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters == 0) return cudaErrorLaunchOutOfResources;
    ready_smem = smem;
    ready_device = device;
  }
  err = cudaLaunchKernelEx(&cfg, kern, xw, wh, m, h_out, c_out, B, Tn, H, st,
                           forget_bias);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// fused: GEMM (xw into the scratch), then the recurrence; hoisted: the
// recurrence on the caller's xw.
template <int CELL>
cudaError_t launch(bool fused, const float* xin, const float* wx,
                   const float* b, const float* wh, const uint8_t* m,
                   float* h_out, float* c_out, float* xw_scratch, int seeds,
                   int B, int Tn, int H, long long s_xin,
                   long long s_wx, long long s_b, long long s_wh,
                   long long s_m, float forget_bias, cudaStream_t stream) {
  constexpr int G = CELL == kLstm ? 4 : 3;
  const int GH = G * H;
  const int M = B * Tn;
  const long long s_gates = (long long)M * GH;
  if (fused) {
    const cudaError_t err =
        launch_sgemm(xin, wx, b, xw_scratch, M, GH, H, seeds, s_xin, s_wx,
                     s_b, s_gates, stream);
    if (err != cudaSuccess) return err;
  }
  const SeedStrides st{fused ? s_gates : s_xin, s_wh, s_m};
  const float* xw = fused ? xw_scratch : xin;
  return launch_recur<CELL>(xw, wh, m, h_out, c_out, seeds, B, Tn, H, st,
                           forget_bias, stream);
}

// The widths the kernels take.
bool supported(int H) { return H >= 16 && H <= 128 && H % 16 == 0; }

}  // namespace

// Shared memory of kernel 1 (the larger of the two launches) in bytes; -1
// for a shape the kernels do not take. cell: 0 = LSTM, 1 = GRU.
extern "C" long long lfm_rnn_fwd_tf32_smem(int cell, int H) {
  if (!supported(H) || (cell != kLstm && cell != kGru)) return -1;
  return (long long)recur_smem_bytes(cell == kLstm ? 4 : 3, H);
}

// The float32 forward on the tensor cores, for `seeds` seeds in one call.
// fused = 1: xin is hin [B, T, H] per seed, and wx [H, G H], b [G H] are
// used; xw_scratch [seeds, B, T, G H] f32 is the caller's scratch for xw.
// fused = 0: xin is xw [B, T, G H] (wx, b, xw_scratch unused). Per seed:
// wh [H, G H]; m uint8 [B, T]. Out h_out, c_out (LSTM; null: not written)
// [seeds, B, T, H]. s_*: the seed strides of xin, wx, b, wh and m in their
// elements (0: shared). All f32. Returns the first CUDA error of its
// launches.
extern "C" int lfm_rnn_fwd_tf32(int cell, int fused, const void* xin,
                                const void* wx, const void* b, const void* wh,
                                const void* m, void* h_out, void* c_out,
                                void* xw_scratch, int seeds, int B, int Tn,
                                int H, long long s_xin, long long s_wx,
                                long long s_b, long long s_wh, long long s_m,
                                float forget_bias, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (seeds <= 0 || seeds > 65535 || B <= 0 || Tn <= 0 || !supported(H))
    return (int)cudaErrorInvalidValue;
#define LFM_FWD_TF32(CELLV)                                                  \
  return (int)launch<CELLV>(                                                 \
      fused != 0, static_cast<const float*>(xin),                            \
      static_cast<const float*>(wx), static_cast<const float*>(b),           \
      static_cast<const float*>(wh), static_cast<const uint8_t*>(m),         \
      static_cast<float*>(h_out), static_cast<float*>(c_out),                \
      static_cast<float*>(xw_scratch), seeds, B, Tn, H, s_xin, s_wx, s_b,    \
      s_wh, s_m, forget_bias, cs)
  if (cell == kLstm) LFM_FWD_TF32(kLstm);
  if (cell == kGru) LFM_FWD_TF32(kGru);
#undef LFM_FWD_TF32
  return (int)cudaErrorInvalidValue;
}
