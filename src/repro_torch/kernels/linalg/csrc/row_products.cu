// row_products.cu — the per-block program of pPIC's routed serving diag
// (eqs. 12-14 in the whitened form of core/ppic.py) as products and row
// reductions whose arithmetic, for every output element, is fixed by
// construction: it does not depend on the number of rows, on the row's
// slot, on the batch of blocks or on the layout.
//
// Replaces no Pallas kernel: the reference computes this program in jnp
// under jit (src/repro/core/ppic.py:141-167). The port's earlier route took
// each stage to cuBLAS (trsm, batched GEMM), which picks its blocking and
// split-K from the row count, so the two-bucket and capacity-|U| layouts
// of a routed request, whose batches differ, parted in the last bits
// (first at A = K_US L^-T). Here the order of every sum is part of the
// kernel.
//
// rows_mm: Y[k] = X[k] op(B_e) or C0[k] - X[k] op(B_e), e = idx[k] (or k,
// or the one shared B), X[k] (u, K) row-major query rows, op(B) = B or
// B^T, B_e one (P, Q) entry of a per-state table read in place through its
// strides, so overflow groups read their owner block's entry and nothing
// is copied. With
// `lower`, B_e is lower triangular and K tiles that are zero for a whole
// output tile are skipped (which tiles depends on the output columns
// only).
//  * float32: 3xTF32 on the tensor cores (mma.sync m16n8k8: hi hi' + lo hi'
//    + hi lo', f32 accumulators, the split of ssd_common.cuh). An output
//    element is summed over K in k-steps of 8, taken in order from the
//    first K tile its column tile needs; no split-K, no atomics. Each
//    element of an m16n8k8 tile is the same dot product of its row of A
//    and column of B, whatever its slot.
//  * float64: FP64 on the CUDA cores, each product and sum correctly
//    rounded (the _rn intrinsics, never contracted to an FMA): a k-step's
//    8 products p_0..p_7 summed as ((p0+p4)+(p2+p6)) + ((p1+p5)+(p3+p7)),
//    then added to the element's running sum. The plain version
//    (ref.rows_mm) does the same operations in the same order, so the two
//    agree bit for bit.
// rows_reduce: per row, the dots and sums of squares of eqs. (12)-(13),
//    mean = Phi.alpha + R.Wy_e and var = ((kdiag - |A|^2) - |V|^2) + |Z|^2
//    (R.W in place of |V|^2 with a cached C^-1), in one launch. One warp a
//    row: lane l sums elements l, l + 32, ... in order, then a fixed
//    butterfly (xor 16, 8, 4, 2, 1); lane 0 writes. Correctly rounded
//    products and sums, in both types: bitwise ref.rows_reduce.
//
// What bounds it (roofline/kernels.py rows_mm_flops / rows_mm_bytes): at
// the 256-row request (M = 20, 32 rows a block, s = 2048, b = 1600) the
// stages read each block's Q_m, K_{S D_m} and C_Lm^-1 once, 0.73 GB, so
// the bytes bound it (0.22 ms at 3.35 TB/s); the capacity-|U| layout (5120
// rows) is bound by its 3xTF32 operations. This first version is simple:
// tiles of 32 rows x 64 columns staged through shared memory in K tiles of
// 32, one barrier pair a tile, no cp.async or TMA ring.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 32;        // output rows a block
constexpr int BN = 64;        // output columns a block
constexpr int BK = 32;        // K of a staged tile
constexpr int KS = 8;         // a k-step: one mma's depth, one tree
constexpr int THREADS = 128;  // 4 warps
constexpr int REDUCE_WARPS = 8;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

__device__ __forceinline__ void set_nan(float& x) {
  x = __int_as_float(0x7fc00000);
}
__device__ __forceinline__ void set_nan(double& x) {
  x = __longlong_as_double(0x7ff8000000000000LL);
}

// d += a b on one m16n8k8 tile: TF32 operands (the tensor core reads the
// top 19 bits of each register), float32 accumulator.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo for 3xTF32, as ssd_common.cuh splits it: hi is x, which the
// tensor core truncates to TF32; lo = x - trunc(x) is exact in float32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// The K range of output columns [n0, n0 + BN): all of it, or with a lower
// triangular B the tiles that are not zero for every column of the tile.
// op(B)[k][n] = B[n][k] (trans) is zero for k > n; B[k][n] for n > k.
__device__ __forceinline__ void k_range(int K, int n0, bool trans,
                                        bool lower, int& lo, int& hi) {
  lo = 0;
  hi = K;
  if (lower) {
    if (trans)
      hi = min(K, n0 + BN);
    else
      lo = n0 / BK * BK;
  }
}

// Stage the K tile [k0, k0 + BK) of X's rows [r0, r0 + BM) and of op(B)'s
// columns [n0, n0 + BN), zero past u, K and N; op(B)[k][n] lies at
// Be[k sk + n sn]. T is float or double; Xs is [BM][BK + XPAD]; Bs is
// [BN][BK + BPAD] (n-major) when NMAJOR, else [BK][BN + BPAD] (k-major).
template <typename T, int XPAD, int BPAD, bool NMAJOR>
__device__ __forceinline__ void stage(T* Xs, T* Bs, const T* __restrict__ Xk,
                                      const T* __restrict__ Be, int u, int K,
                                      int N, long long sk, long long sn,
                                      int r0, int n0, int k0) {
  for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
    const int r = e / BK, k = e % BK, gr = r0 + r, gk = k0 + k;
    Xs[r * (BK + XPAD) + k] =
        gr < u && gk < K ? Xk[static_cast<long long>(gr) * K + gk] : T(0);
  }
  for (int e = threadIdx.x; e < BN * BK; e += THREADS) {
    // consecutive threads along B's unit-stride axis
    int n, k;
    if (sn == 1) {
      k = e / BN;
      n = e % BN;
    } else {
      n = e / BK;
      k = e % BK;
    }
    const int gn = n0 + n, gk = k0 + k;
    const T v = gn < N && gk < K ? Be[gk * sk + gn * sn] : T(0);
    if (NMAJOR)
      Bs[n * (BK + BPAD) + k] = v;
    else
      Bs[k * (BN + BPAD) + n] = v;
  }
}

// A block whose index lies outside the table writes NaN over its output
// tile (the wrapper cannot check a device index without a sync).
template <typename T>
__device__ __forceinline__ void nan_tile(T* Y, int blk, int u, int N, int r0,
                                         int n0) {
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = r0 + e / BN, n = n0 + e % BN;
    if (r < u && n < N)
      set_nan(Y[(static_cast<long long>(blk) * u + r) * N + n]);
  }
}

// float32: each of the 4 warps computes the tile's 32 rows x its 16
// columns as 2 x 2 m16n8 tiles. op(B) is staged n-major when trans (B's
// rows are k-contiguous) and k-major otherwise; both pads leave the
// fragment loads free of bank conflicts.
template <bool TRANS>
__global__ void __launch_bounds__(THREADS)
    rows_mm_f32(const float* __restrict__ X, const float* __restrict__ B,
                const long long* __restrict__ idx, long long nt,
                long long bstride, long long sk, long long sn,
                const float* __restrict__ C0, float* __restrict__ Y, int u,
                int K, int N, bool lower) {
  constexpr int XPAD = 4, BPAD = TRANS ? 4 : 8;
  __shared__ float Xs[BM * (BK + XPAD)];
  __shared__ float Bs[TRANS ? BN * (BK + BPAD) : BK * (BN + BPAD)];
  const int n0 = blockIdx.x * BN, r0 = blockIdx.y * BM, blk = blockIdx.z;
  const long long e = idx ? idx[blk] : bstride ? blk : 0;
  if (e < 0 || e >= nt) {
    nan_tile(Y, blk, u, N, r0, n0);
    return;
  }
  const float* Xk = X + static_cast<long long>(blk) * u * K;
  const float* Be = B + e * bstride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float acc[2][2][4] = {};
  int lo, hi;
  k_range(K, n0, TRANS, lower, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BK) {
    stage<float, XPAD, BPAD, TRANS>(Xs, Bs, Xk, Be, u, K, N, sk, sn, r0, n0,
                                    k0);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += KS) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          split_tf32(Xs[(mt * 16 + g + 8 * (v % 2)) * (BK + XPAD) + ks + t +
                        4 * (v / 2)],
                     ah[mt][v], al[mt][v]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t bh[2], bl[2];
        const int n = warp * 16 + nt * 8 + g;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int k = ks + t + 4 * v;
          split_tf32(TRANS ? Bs[n * (BK + BPAD) + k] : Bs[k * (BN + BPAD) + n],
                     bh[v], bl[v]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][nt], ah[mt], bh);
          mma_tf32(acc[mt][nt], al[mt], bh);
          mma_tf32(acc[mt][nt], ah[mt], bl);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = r0 + mt * 16 + g + 8 * (c / 2);
        const int n = n0 + warp * 16 + nt * 8 + 2 * t + c % 2;
        if (r < u && n < N) {
          const long long o = (static_cast<long long>(blk) * u + r) * N + n;
          Y[o] = C0 ? sub_rn(C0[o], acc[mt][nt][c]) : acc[mt][nt][c];
        }
      }
}

// The 8 products of a k-step, summed by the fixed tree.
__device__ __forceinline__ double tree8(const double* x, const double* b,
                                        int bstep) {
  double p[KS];
#pragma unroll
  for (int q = 0; q < KS; ++q) p[q] = mul_rn(x[q], b[q * bstep]);
  const double s0 = add_rn(p[0], p[4]), s1 = add_rn(p[1], p[5]);
  const double s2 = add_rn(p[2], p[6]), s3 = add_rn(p[3], p[7]);
  return add_rn(add_rn(s0, s2), add_rn(s1, s3));
}

// float64: thread (tr, tc) computes rows tr + 8 i and columns tc + 16 j
// (i, j < 4) of the tile, op(B) staged k-major.
template <bool TRANS>
__global__ void __launch_bounds__(THREADS)
    rows_mm_f64(const double* __restrict__ X, const double* __restrict__ B,
                const long long* __restrict__ idx, long long nt,
                long long bstride, long long sk, long long sn,
                const double* __restrict__ C0, double* __restrict__ Y, int u,
                int K, int N, bool lower) {
  constexpr int XPAD = 1, BPAD = 1;
  __shared__ double Xs[BM * (BK + XPAD)];
  __shared__ double Bs[BK * (BN + BPAD)];
  const int n0 = blockIdx.x * BN, r0 = blockIdx.y * BM, blk = blockIdx.z;
  const long long e = idx ? idx[blk] : bstride ? blk : 0;
  if (e < 0 || e >= nt) {
    nan_tile(Y, blk, u, N, r0, n0);
    return;
  }
  const double* Xk = X + static_cast<long long>(blk) * u * K;
  const double* Be = B + e * bstride;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  double acc[4][4] = {};
  int lo, hi;
  k_range(K, n0, TRANS, lower, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BK) {
    stage<double, XPAD, BPAD, false>(Xs, Bs, Xk, Be, u, K, N, sk, sn, r0,
                                     n0, k0);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += KS)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        double x[KS];
#pragma unroll
        for (int q = 0; q < KS; ++q)
          x[q] = Xs[(tr + 8 * i) * (BK + XPAD) + ks + q];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = add_rn(
              acc[i][j], tree8(x, Bs + ks * (BN + BPAD) + tc + 16 * j,
                               BN + BPAD));
      }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + tr + 8 * i, n = n0 + tc + 16 * j;
      if (r < u && n < N) {
        const long long o = (static_cast<long long>(blk) * u + r) * N + n;
        Y[o] = C0 ? sub_rn(C0[o], acc[i][j]) : acc[i][j];
      }
    }
}

// sum_i x[i] y[i] over one row by one warp, in the fixed order above; the
// result is lane 0's.
template <typename T>
__device__ __forceinline__ T warp_dot(const T* __restrict__ x,
                                      const T* __restrict__ y, int n) {
  const int lane = threadIdx.x % 32;
  T acc = T(0);
  for (int i = lane; i < n; i += 32) acc = add_rn(acc, mul_rn(x[i], y[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = add_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(REDUCE_WARPS * 32)
    rows_reduce_kernel(long long rows, int u, int s, int b,
                       const T* __restrict__ kdiag, const T* __restrict__ Phi,
                       const T* __restrict__ alpha, const T* __restrict__ R,
                       const T* __restrict__ Wy,
                       const long long* __restrict__ idx, long long nt,
                       const T* __restrict__ A, const T* __restrict__ V,
                       bool cinv, const T* __restrict__ Z,
                       T* __restrict__ mean, T* __restrict__ var) {
  const long long row =
      static_cast<long long>(blockIdx.x) * REDUCE_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const long long blk = row / u, e = idx ? idx[blk] : blk;
  if (e < 0 || e >= nt) {
    if (threadIdx.x % 32 == 0) {
      set_nan(mean[row]);
      set_nan(var[row]);
    }
    return;
  }
  const T* r = R + row * b;
  const T* v = V + row * b;
  const T pa = warp_dot(Phi + row * s, alpha, s);
  const T rw = warp_dot(r, Wy + e * b, b);
  const T a2 = warp_dot(A + row * s, A + row * s, s);
  const T t2 = cinv ? warp_dot(r, v, b) : warp_dot(v, v, b);
  const T z2 = warp_dot(Z + row * s, Z + row * s, s);
  if (threadIdx.x % 32 == 0) {
    mean[row] = add_rn(pa, rw);
    var[row] = add_rn(sub_rn(sub_rn(kdiag[row], a2), t2), z2);
  }
}

}  // namespace

// Y (nblk, u, N) = X (nblk, u, K) op(B_e), or C0 - X op(B_e) where C0 is
// not null, on `stream`; dtype 0 = float32, 1 = float64. B_e = B + e
// bstride, e = idx[k] (int64, nblk entries) or k where idx is null, for
// a table of nt entries (nt 1 and bstride 0: one shared B, e = 0; an e
// outside [0, nt) gives NaN rows); B_e's element (p, q) at p sp + q sq (any
// strides: the tables are read in place); op(B) = B_e^T where trans, else
// B_e; lower: B_e lower triangular. X, C0 and Y row-major and contiguous;
// nblk, u / 32 <= 65535; K, N >= 1. Returns the launch's error, else
// cudaGetLastError().
extern "C" int rows_mm(int dtype, const void* X, const void* B,
                       const void* idx, long long nt, long long bstride,
                       long long sp, long long sq, const void* C0, void* Y,
                       int nblk, int u, int K, int N, int trans, int lower,
                       void* stream) {
  const dim3 grid((N + BN - 1) / BN, (u + BM - 1) / BM, nblk);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const long long*>(idx);
  // op(B)[k][n] = B_e[n][k] (trans) or B_e[k][n]
  const long long sk = trans ? sq : sp, sn = trans ? sp : sq;
  if (dtype == 0) {
    const auto* x = static_cast<const float*>(X);
    const auto* b = static_cast<const float*>(B);
    const auto* c = static_cast<const float*>(C0);
    auto* y = static_cast<float*>(Y);
    if (trans)
      rows_mm_f32<true><<<grid, THREADS, 0, st>>>(
          x, b, ix, nt, bstride, sk, sn, c, y, u, K, N, lower);
    else
      rows_mm_f32<false><<<grid, THREADS, 0, st>>>(
          x, b, ix, nt, bstride, sk, sn, c, y, u, K, N, lower);
  } else {
    const auto* x = static_cast<const double*>(X);
    const auto* b = static_cast<const double*>(B);
    const auto* c = static_cast<const double*>(C0);
    auto* y = static_cast<double*>(Y);
    if (trans)
      rows_mm_f64<true><<<grid, THREADS, 0, st>>>(
          x, b, ix, nt, bstride, sk, sn, c, y, u, K, N, lower);
    else
      rows_mm_f64<false><<<grid, THREADS, 0, st>>>(
          x, b, ix, nt, bstride, sk, sn, c, y, u, K, N, lower);
  }
  return static_cast<int>(cudaGetLastError());
}

// mean, var (rows,) of the rows' (rows = nblk u) dots and sums of squares:
// Phi, A, Z (rows, s); R, V (rows, b), V holding W = R C^-1 where cinv;
// alpha (s,); Wy a table of nt (b,) entries, row's entry idx[row / u] or
// row / u where idx is null (an entry outside [0, nt): NaN); kdiag
// (rows,). dtype as rows_mm.
extern "C" int rows_reduce(int dtype, long long rows, int u, int s, int b,
                           const void* kdiag, const void* Phi,
                           const void* alpha, const void* R, const void* Wy,
                           const void* idx, long long nt, const void* A,
                           const void* V,
                           int cinv, const void* Z, void* mean, void* var,
                           void* stream) {
  const auto grid = static_cast<unsigned>((rows + REDUCE_WARPS - 1) /
                                          REDUCE_WARPS);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const long long*>(idx);
  if (dtype == 0)
    rows_reduce_kernel<float><<<grid, REDUCE_WARPS * 32, 0, st>>>(
        rows, u, s, b, static_cast<const float*>(kdiag),
        static_cast<const float*>(Phi), static_cast<const float*>(alpha),
        static_cast<const float*>(R), static_cast<const float*>(Wy), ix, nt,
        static_cast<const float*>(A), static_cast<const float*>(V), cinv,
        static_cast<const float*>(Z), static_cast<float*>(mean),
        static_cast<float*>(var));
  else
    rows_reduce_kernel<double><<<grid, REDUCE_WARPS * 32, 0, st>>>(
        rows, u, s, b, static_cast<const double*>(kdiag),
        static_cast<const double*>(Phi), static_cast<const double*>(alpha),
        static_cast<const double*>(R), static_cast<const double*>(Wy), ix, nt,
        static_cast<const double*>(A), static_cast<const double*>(V), cinv,
        static_cast<const double*>(Z), static_cast<double*>(mean),
        static_cast<double*>(var));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
