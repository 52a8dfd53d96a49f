// The cooperative grid shared by the backwards past a cluster's widths
// (rnn_bwd_tf32_grid.cu in float32, rnn_bwd_grid.cu in bfloat16): a
// group of n co-resident CTAs holds W_h, CTA j owning the 8-unit chunks
// [j W / n, (j + 1) W / n) of the W = H / 8 and one warp per (own chunk,
// 16 rows of a work item); the groups walk their (seed, row block) work
// items in turn and meet once a step at a counter in device memory; the
// grid is launched cooperatively, so every CTA of a group is resident
// while the others wait for it, and a grid the card cannot hold at once
// is refused (cudaErrorCooperativeLaunchTooLarge), never run another way.

#pragma once

#include <cuda_runtime.h>

namespace lfm_grid {
namespace {

constexpr int kUnits = 8;  // hidden units per chunk (one n8 tile)
// A barrier's wait, in SM clock cycles, past which the CTA traps.
constexpr long long kSpinLimit = 1ll << 32;

// Chunks per CTA at most with n CTAs a group (ceil(W / n)), and the CTA's
// threads: one warp per (chunk, 16 rows).
inline int chunks_per_cta(int H, int n) {
  return (H / kUnits + n - 1) / n;
}
inline int threads_of(int H, int n, int rows) {
  return 32 * chunks_per_cta(H, n) * (rows / 16);
}

// Where a CTA stands: its group and rank in it, the groups, its first own
// chunk and how many it owns.
struct GroupPos {
  int group, rank, groups, w0, own;
};

__device__ __forceinline__ GroupPos group_pos(int n, int W) {
  GroupPos p;
  p.group = blockIdx.x / n;
  p.rank = blockIdx.x - p.group * n;
  p.groups = gridDim.x / n;
  p.w0 = p.rank * W / n;
  p.own = (p.rank + 1) * W / n - p.w0;
  return p;
}

__device__ __forceinline__ void arrive_release(unsigned* ctr) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(ctr)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* ctr) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(ctr)
               : "memory");
  return v;
}

// The group's barrier: every thread's writes to device memory before it
// are seen by every CTA of the group after it. `target` counts the
// group's arrivals so far (n a barrier); `waited` adds thread 0's SM
// cycles spent waiting. A wait past kSpinLimit traps: a CTA of the group
// is not running.
__device__ __forceinline__ void group_barrier(unsigned* ctr, unsigned& target,
                                              int n, long long& waited) {
  target += n;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    arrive_release(ctr);
    const long long t0 = clock64();
    while (load_acquire(ctr) < target)
      if (clock64() - t0 > kSpinLimit) __trap();
    waited += clock64() - t0;
  }
  __syncthreads();
}

// CTAs of `kernel` the current card holds at once with `threads` threads
// and `smem` bytes of dynamic shared memory, which are set on it.
template <typename Kernel>
cudaError_t capacity(Kernel kernel, int* ctas, int threads, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  *ctas = per_sm * sms;
  return err;
}

// Refused before any launch where `groups` groups of n CTAs are more than
// the card holds at once.
template <typename Kernel>
cudaError_t check_fits(Kernel kernel, int groups, int n, int threads,
                       size_t smem) {
  int ctas = 0;
  const cudaError_t err = capacity(kernel, &ctas, threads, smem);
  if (err != cudaSuccess) return err;
  if ((long long)groups * n > ctas) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

// The recurrence, `groups` groups of n CTAs, launched cooperatively.
template <typename Kernel>
cudaError_t launch(Kernel kernel, int groups, int n, int threads,
                   size_t smem, void** args, cudaStream_t stream) {
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)kernel, dim3(groups * n), dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace lfm_grid
