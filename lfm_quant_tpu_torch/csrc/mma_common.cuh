// PTX helpers shared by the tensor-core recurrence kernels
// (rnn_fused_fwd_mma.cu, rnn_fused_bwd_mma.cu and the cluster and grid
// sources): cp.async copies into shared memory, ldmatrix fragment loads,
// the bf16 mma.sync m16n8k16 product with f32 accumulation (PTX ISA,
// warp-level matrix instructions), and the bf16 recurrences' x-side pairs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lfm_mma {

// 16 bytes from device to shared memory; src_bytes < 16 zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices, lanes 8i .. 8i + 7 giving the row addresses of
// matrix i; lane l receives row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1
// of each. With row-major A tiles: the A fragment of one m16n8k16 product.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// Two matrices (lanes 0 .. 15 give the addresses).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
}

// The transposed loads: lane l receives elements (2 (l % 4), l / 4) and
// (2 (l % 4) + 1, l / 4) of each matrix, (row, element) as stored.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a)
      : "memory");
}

// A pair of xw values of a thread's (row, gate, unit pair), as the bf16
// recurrences read their x side: f32 from a fused form's scratch, bf16 from
// a hoisted form's xw; and as two floats.
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

__device__ __forceinline__ float2 as_float2(float2 v) { return v; }
__device__ __forceinline__ float2 as_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

// Two floats rounded to nearest bf16, as the pair's bits.
__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b: a the 16 x 16 A fragment (row), b the 16 x 8 B fragment (col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

}  // namespace lfm_mma
