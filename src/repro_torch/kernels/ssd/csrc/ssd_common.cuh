// ssd_common.cuh — building blocks shared by the SSD intra-chunk kernels
// (ssd_intra_chunk.cu's forward, ssd_intra_chunk_bwd.cu's backward), so
// that the two round alike: the compensated warp scan of cum, the 3xTF32
// mma.sync m16n8k8 warp product, and cp.async staging of padded tiles by a
// block of THREADS threads. Include once per translation unit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 256;   // 8 warps, every block of both kernels

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// cum = cumsum(dA_row[0..cs)) by one warp: lane l sums its stretch of
// ceil(cs / 32) values, the lanes scan those sums, and each lane then runs
// through its stretch, handing (i, cum[i]) to put. The running sums are
// compensated (Kahan), so a stretch of up to 32 values rounds about as
// little as one addition. Every block that needs a row scans it this way,
// so all of them round cum alike.
template <typename T, typename Put>
__device__ __forceinline__ void warp_scan(const T* __restrict__ dA_row,
                                          int cs, Put put) {
  const int lane = threadIdx.x % 32, per = (cs + 31) / 32;
  const int i0 = lane * per, i1 = min(i0 + per, cs);
  float local = 0.f, lost = 0.f;
  for (int i = i0; i < i1; ++i) {
    const float y = to_f32(dA_row[i]) - lost, sum = local + y;
    lost = (sum - local) - y;
    local = sum;
  }
  float inc = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  float run = inc - local;
  lost = 0.f;
  for (int i = i0; i < i1; ++i) {
    const float y = to_f32(dA_row[i]) - lost, sum = run + y;
    lost = (sum - run) - y;
    run = sum;
    put(i, run);
  }
}

// d += a b on one m16n8k8 tile: TF32 operands (the tensor core reads the
// top 19 bits of each 32-bit register), float32 accumulator.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo for 3xTF32. hi is x itself: the tensor core reads its top 19
// bits, x truncated to TF32. lo = x - hi is exact in float32 and below
// 2^-10 |x|; the tensor core truncates it in turn, an error below 2^-20 |x|.
// CUTLASS relies on the same truncation: its 3xTF32 warp MMA
// (cutlass/gemm/warp/mma_tensor_op_fast_f32.h, MmaFastF32) takes the big
// part round_toward_zero, and its float -> tfloat32_t conversions
// (cutlass/tfloat32.h round_half_ulp_truncate, the round_to_nearest
// converter in cutlass/numeric_conversion.h) leave the low 13 bits in the
// register, "TF32 does not define the low order bits". cvt.rna.tf32.f32
// rounds hi to nearest instead, at several more instructions per operand,
// for no gain in the error bound of hi + lo.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// One warp: acc[MT][NT] += A (16 MT x K) B (K x 8 NT) in 3xTF32, K a
// multiple of 8. a(m, k) returns A's element in float32; B(k, n) is
// B[n * ldb + k], or B[k * ldb + n] with B_KN. acc[.][.][c] holds row
// g + 8 (c / 2) and column 2 t + c % 2 of its 16 x 8 tile, with
// g = lane / 4, t = lane % 4: the m16n8k8 accumulator layout. Each product
// is hi hi' + lo hi' + hi lo'; lo lo' (below 2^-20 of it) is dropped.
// A's fragments are split once per k-step, each B fragment just before its
// products, which keeps few of them live.
template <int MT, int NT, int K, bool B_KN, typename AFn>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], AFn a,
                                         const float* B, int ldb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        split_tf32(a(mt * 16 + g + 8 * (v % 2), k0 + t + 4 * (v / 2)),
                   ah[mt][v], al[mt][v]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int n = nt * 8 + g, k = k0 + t + 4 * v;
        split_tf32(B_KN ? B[k * ldb + n] : B[n * ldb + k], bh[v], bl[v]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_tf32(acc[mt][nt], ah[mt], bh);
        mma_tf32(acc[mt][nt], al[mt], bh);
        mma_tf32(acc[mt][nt], ah[mt], bl);
      }
    }
  }
}

// Asynchronous copies, global to shared: W floats (1 or 4), or zeros
// where !ok (src is then not read).
template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (W == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage a ROWS x COLS tile of src (rows `stride` elements apart; rows past
// rows_left and columns past cols_left read as 0) into dst (row stride
// ld), by the whole block. float32 is copied asynchronously, in 16-byte
// pieces when VEC (then every row start and cols_left are multiples of 4
// floats); bfloat16 is loaded, converted and stored at once.
template <int ROWS, int COLS, bool VEC, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long stride, int rows_left,
                                      int cols_left) {
  constexpr int W = std::is_same<T, float>::value && VEC ? 4 : 1;
  constexpr int PIECES = ROWS * COLS / W;
  static_assert(PIECES % THREADS == 0, "tile not a multiple of the block");
#pragma unroll
  for (int u = 0; u < PIECES / THREADS; ++u) {
    const int e = threadIdx.x + u * THREADS;
    const int r = e / (COLS / W), c = e % (COLS / W) * W;
    const bool ok = r < rows_left && c < cols_left;
    if constexpr (std::is_same<T, float>::value)
      cp_async<W>(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    else
      dst[r * ld + c] = ok ? to_f32(src[r * stride + c]) : 0.f;
  }
}

}  // namespace
