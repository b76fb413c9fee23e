// wgmma_tf32.cuh — the Hopper pieces of row_products.cu: 3xTF32 products on
// wgmma (A in registers, B K-major in shared memory under the 128-byte
// swizzle), the fences around them, and cp.async copies with zero fill.
// The same helpers as kernels/rbf/csrc/xcov_diag.cu, which holds the notes
// on each; kept beside this family's sources so that its libraries' hash
// covers them.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace rows_sm90 {

// Shared-memory matrix descriptor of a K-major tile stored with the
// 128-byte swizzle: rows of 128 bytes (32 floats) whose 16-byte chunks are
// XORed with the row's index mod 8, 8-row groups 1024 bytes apart (stride
// byte offset), the leading byte offset unused (16); the tile starts on a
// 1024-byte boundary (a k slice of it 32 bytes further per 8 floats).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Word offset of (row, col) in a [rows][32] float tile under that swizzle.
__device__ __forceinline__ int sw128(int row, int col) {
  return row * 32 + ((((col >> 2) ^ (row & 7))) << 2) + (col & 3);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// a thread's completed shared-memory writes (ordinary stores and its
// waited cp.async copies) become visible to wgmma (the async proxy) once a
// barrier follows
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep registers that an asynchronous product reads or writes where they
// are until it has completed.
template <int N>
__device__ __forceinline__ void hold(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 32, f32) += A (64 x 8, tf32, registers: per warp the m16n8k8
// fragment of its 16 rows) B (32 x 8, tf32, K-major, shared). The tensor
// core reads the top 19 bits of each 32-bit register or word.
__device__ __forceinline__ void wgmma_m64n32k8(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// x = hi + lo for 3xTF32. hi is x itself: the tensor core reads its top 19
// bits, x truncated to TF32. lo = x - trunc(x) is exact in float32 and below
// 2^-10 |x|; the tensor core truncates it in turn, an error below 2^-20 |x|.
__device__ __forceinline__ uint32_t tf32_lo(float x) {
  return __float_as_uint(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u));
}

// Asynchronous copies, global to shared, zero-filled past the first
// `bytes` (src is not read when bytes is 0): 16 bytes (both addresses
// 16-byte aligned), or one 4- or 8-byte element.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_elem(float* dst, const float* src,
                                              bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_elem(double* dst, const double* src,
                                              bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               ::"r"(d), "l"(src), "r"(ok ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's copies of all but the newest N committed groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace rows_sm90
