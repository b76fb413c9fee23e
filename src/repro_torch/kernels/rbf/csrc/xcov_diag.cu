// xcov_diag.cu — fused serving diag for the S-space GP methods, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rbf/xcov.py:103
// (xcov_diag_pallas, body _xcov_diag_kernel). For queries Xq (n, d) against
// the support set Xk (s, d), lengthscale-scaled:
//
//   K_US = sig2 * exp(-0.5 ||u - x_k||^2)                  (n, s)
//   mean = K_US alpha
//   var  = sig2 - ||K_US L1^{-T}||^2_row  (+ ||K_US L2^{-T}||^2_row)
//
// L1inv/L2inv are the lower-triangular inverses of the cached Cholesky
// factors (chol K_SS, chol Sdd), built by the wrapper once per factor;
// entries above their diagonals are never read. Each quadratic form is a
// sum of squares of V = K_US L^{-T}, so it stays non-negative, as on the
// TPU.
//
// What bounds it on the card: the two triangular products, 2 n s^2 flops
// in all (two factors, each half zero), against reading the lower triangle
// of both inverses once, 2 s (s + 1) / 2 4 bytes in float32. At the serving
// bucket n = 256, s = 2048 that is 2.15 GFLOP against 16.8 MB. In 3xTF32
// on the tensor cores (three TF32 products for each float32 one) the
// operations take 6.44 GFLOP / 495 TFLOP/s = 0.0130 ms and the bytes
// 0.0050 ms at 3.35 TB/s; on the f32 CUDA cores the operations alone would
// take 0.0321 ms. At n = 8 the bytes bound it (0.0050 ms).
//
// float32, on the tensor cores (xcov_tc_kernel, one warpgroup a block):
//  * Support points on M, queries on N: a block computes one 64-row panel
//    of V^T = L^{-1} K_US^T for BN = 8, 16, 32 or 64 queries with
//    wgmma m64nBNk8 (tf32). L^{-1} is A, row-major in k exactly as stored,
//    read from shared memory into registers (each warp its 16 rows); the
//    K_US tile is B, K-major in shared memory. wgmma takes N = 8, so an
//    8-row bucket wastes nothing, and V1 and V2 share every K_US tile.
//  * 3xTF32: each product is hi hi' + lo hi' + hi lo' with f32
//    accumulators (see tf32_lo), as ssd_intra_chunk.cu does. One TF32
//    product errs by up to 40% of the smallest posterior variance on a
//    fitted pPITC state (tests/test_torch_xcov.py emulates both).
//  * Every element is split once. The K_US tile is generated once per
//    block and k-step from the staged query and support rows (one exp per
//    entry) straight into hi and lo planes. Each L^{-1} element is read by
//    the one warp that owns its row, and split there, in registers, as it
//    is read.
//  * The L^{-1} tiles of both factors and the next k-step's support rows
//    come in by cp.async (16 bytes at a time where s % 4 == 0) into a
//    2-stage ring, one barrier a step; the warps generate the K_US tile of
//    step t + 1 while step t's products run asynchronously. Tiles above
//    the diagonal are never visited; the diagonal tile is masked by the
//    copy itself (its source size stops at the diagonal, the rest is
//    zero-filled).
//  * L^{-1} tiles are [row][32] floats with the 16-byte chunks of odd rows
//    swapped by halves (swz), so every 16-byte fragment load of a quarter
//    warp hits 32 distinct banks; lane t takes k = 16 h + 4 t .. + 3, and
//    the K_US planes store k in the same permuted order (bcol) under
//    wgmma's 128-byte swizzle.
//  * Balance: panel j runs j + 1 k-tiles of 64 (panel 31 runs 64 steps of
//    32 at s = 2048, panel 0 two). For small batches the wrapper cuts each
//    panel's k-range into chunks of kc (128 for n <= 8, 256 for n <= 64,
//    512 for n <= 256): 272 blocks at n = 8, no chain longer than 16 steps
//    (python -m repro_torch.launch.xcov_sweep times each kc). A split
//    panel's blocks write their partial V^T tiles to scratch, and a second
//    kernel adds them in chunk order before squaring. Blocks are numbered
//    longest first (last panel first), queries fastest. No float atomics:
//    a repeated launch gives the same bits.
//  * The panel that owns a support point adds its K_US alpha share to the
//    mean; a last small kernel adds the panels' shares in a fixed order.

// float64 keeps the FP64 FMA kernel (xcov_panel_kernel): a block owns BQ
// query rows and one 64-column panel of V, recomputes each (BQ, 32) K_US
// tile and accumulates in float64 (the 1e-10 parity gate). Same panels,
// same partial-sum layout, same final reduction.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// float64: FP64 FMA panels
// ---------------------------------------------------------------------------

constexpr int BJ = 64;    // columns of V per panel (one block); also TC_BM
constexpr int BK = 32;    // support points per k-panel
constexpr int NT = 256;   // threads per block

// part is (3, n_panels, n): per-panel ||V1||^2, ||V2||^2 and mean shares.
template <typename T, int BQ, bool WITH_L2>
__global__ void __launch_bounds__(NT)
xcov_panel_kernel(const T* __restrict__ xq, const T* __restrict__ xk,
                  const T* __restrict__ l1inv, const T* __restrict__ l2inv,
                  const T* __restrict__ alpha, const T* __restrict__ sig2,
                  T* __restrict__ part, int n, int s, int d) {
  constexpr int TQ = BQ >= 32 ? 2 : 1;   // query rows per thread
  constexpr int TYN = BQ / TQ;           // thread rows
  constexpr int TXN = NT / TYN;          // threads per row (16 or 32)
  constexpr int TJ = BJ / TXN;           // V columns per thread
  static_assert(TYN * TXN == NT && TJ * TXN == BJ, "tile shape");
  static_assert(32 % TXN == 0, "a query row's lanes lie within one warp");

  __shared__ T ks[BQ][BK + 1];
  __shared__ T l1s[BJ][BK + 1];
  __shared__ T l2s[WITH_L2 ? BJ : 1][BK + 1];

  const int jp = blockIdx.x;
  const int n_panels = gridDim.x;
  const int j0 = jp * BJ;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / TXN;
  const int tx = tid % TXN;
  const T s2 = sig2[0];

  T v1[TQ][TJ], v2[TQ][TJ];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int jj = 0; jj < TJ; ++jj) v1[i][jj] = v2[i][jj] = T(0);
  T mean_share = T(0);

  const int k_end = min(j0 + BJ, s);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous k-panel's tiles are consumed
    for (int e = tid; e < BQ * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const int q = q0 + r, k = k0 + c;
      T val = T(0);
      if (q < n && k < s) {
        T qq = T(0), kk = T(0), qk = T(0);
        for (int t = 0; t < d; ++t) {
          const T a = xq[static_cast<long long>(q) * d + t];
          const T b = xk[static_cast<long long>(k) * d + t];
          qq += a * a;
          kk += b * b;
          qk += a * b;
        }
        const T d2 = qq + kk - T(2) * qk;
        val = s2 * exp(T(-0.5) * (d2 > T(0) ? d2 : T(0)));
      }
      ks[r][c] = val;
    }
    for (int e = tid; e < BJ * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const int j = j0 + r, k = k0 + c;
      const bool lower = j < s && k <= j;   // k < s follows from k <= j
      const long long at = static_cast<long long>(j) * s + k;
      l1s[r][c] = lower ? l1inv[at] : T(0);
      if (WITH_L2) l2s[r][c] = lower ? l2inv[at] : T(0);
    }
    __syncthreads();

    // the k-panels inside panel j carry this block's share of the mean
    if (k0 >= j0 && tid < BQ) {
      for (int c = 0; c < BK && k0 + c < s; ++c)
        mean_share += ks[tid][c] * alpha[k0 + c];
    }

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      T a[TQ];
#pragma unroll
      for (int i = 0; i < TQ; ++i) a[i] = ks[ty * TQ + i][c];
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) {
        const T b1 = l1s[tx + TXN * jj][c];
#pragma unroll
        for (int i = 0; i < TQ; ++i) v1[i][jj] += a[i] * b1;
        if (WITH_L2) {
          const T b2 = l2s[tx + TXN * jj][c];
#pragma unroll
          for (int i = 0; i < TQ; ++i) v2[i][jj] += a[i] * b2;
        }
      }
    }
  }

  // row sums of squares over this panel's columns: reduce across the TXN
  // consecutive lanes that share a query row
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    T p1 = T(0), p2 = T(0);
#pragma unroll
    for (int jj = 0; jj < TJ; ++jj) {
      p1 += v1[i][jj] * v1[i][jj];
      p2 += v2[i][jj] * v2[i][jj];
    }
#pragma unroll
    for (int off = TXN / 2; off > 0; off >>= 1) {
      p1 += __shfl_xor_sync(0xffffffffu, p1, off);
      p2 += __shfl_xor_sync(0xffffffffu, p2, off);
    }
    const int q = q0 + ty * TQ + i;
    if (tx == 0 && q < n) {
      part[(static_cast<long long>(0) * n_panels + jp) * n + q] = p1;
      part[(static_cast<long long>(1) * n_panels + jp) * n + q] = p2;
    }
  }
  if (tid < BQ && q0 + tid < n)
    part[(static_cast<long long>(2) * n_panels + jp) * n + q0 + tid] =
        mean_share;
}

// mean = sum of the panels' mean shares, var = (sig2 - sum ||V1||^2) +
// sum ||V2||^2, each summed over the panels in order.
template <typename T>
__global__ void xcov_reduce_kernel(const T* __restrict__ part,
                                   const T* __restrict__ sig2,
                                   T* __restrict__ mean, T* __restrict__ var,
                                   int n, int n_panels) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  T p1 = T(0), p2 = T(0), pm = T(0);
  for (int j = 0; j < n_panels; ++j) {
    p1 += part[(static_cast<long long>(0) * n_panels + j) * n + q];
    p2 += part[(static_cast<long long>(1) * n_panels + j) * n + q];
    pm += part[(static_cast<long long>(2) * n_panels + j) * n + q];
  }
  mean[q] = pm;
  var[q] = (sig2[0] - p1) + p2;
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BM = BJ;        // rows of V^T (support points) per panel
constexpr int TC_BK = 32;        // k per step
constexpr int TC_WARPS = 4;      // each 16 rows of the panel, all queries
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int SUM_THREADS = 256; // xcov_tc_sum_chunks
static_assert(TC_BM == 16 * TC_WARPS, "one m16 tile per warp");

// Word offset of (row, col) in a [rows][32] float tile. The eight 16-byte
// chunks of a row are swapped by halves in odd rows, so the quarter warp of
// a 16-byte fragment load (lanes 4g + t, g = 0..1, t = 0..3: rows r and
// r + 1, chunks h4 + t) covers all 32 banks.
__device__ __forceinline__ int swz(int row, int col) {
  return row * TC_BK + ((((col >> 2) ^ ((row & 1) << 2))) << 2) + (col & 3);
}

// Word offset of (row q, column c) in a K_US plane: [BN][32] floats with
// the 128-byte swizzle that wgmma reads (chunk c / 4 XORed with q mod 8).
__device__ __forceinline__ int bpos(int q, int c) {
  return q * TC_BK + ((((c >> 2) ^ (q & 7))) << 2) + (c & 3);
}

// The plane column of a step's support point k. Lane t of a warp reads
// its L^{-1} fragments 16 bytes at a time (k = 16 h + 4 t .. + 3), so k
// slice kk = 2 h + sub of the products takes k = 16 h + 4 t + 2 sub as its
// index t and k + 1 as its index t + 4; the K_US tile is stored in the same
// order, which leaves each product unchanged.
__device__ __forceinline__ int bcol(int k) {
  const int h = k >> 4, t = (k >> 2) & 3, sub = (k >> 1) & 1, e = k & 1;
  return 8 * (2 * h + sub) + t + 4 * e;
}

// chunks of the k-range [0, min(64 (p + 1), s)) of panel p, kc apiece
__host__ __device__ __forceinline__ int panel_chunks(int p, int s, int kc) {
  const int k_end = (p + 1) * TC_BM < s ? (p + 1) * TC_BM : s;
  return (k_end + kc - 1) / kc;
}

// Shared-memory matrix descriptor of a K-major tile stored with the
// 128-byte swizzle: rows of 128 bytes (32 floats) whose 16-byte chunks are
// XORed with the row's index mod 8, 8-row groups 1024 bytes apart (stride
// byte offset), the leading byte offset unused (16); the tile starts on a
// 1024-byte boundary.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
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
// the block's ordinary shared-memory stores become visible to wgmma (the
// async proxy) once a barrier follows
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

// D (64 x N, f32) += A (64 x 8, tf32, registers: per warp the m16n8k8
// fragment of its 16 rows) B (N x 8, tf32, K-major, shared). The tensor
// core reads the top 19 bits of each 32-bit register or word.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t db);
template <>
__device__ __forceinline__ void wgmma_tf32<8>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float* d, const uint32_t* a,
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

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// x = hi + lo for 3xTF32. hi is x itself: the tensor core reads its top 19
// bits, x truncated to TF32. lo = x - trunc(x) is exact in float32 and below
// 2^-10 |x|; the tensor core truncates it in turn, an error below 2^-20 |x|.
// CUTLASS's 3xTF32 warp MMA (cutlass/gemm/warp/mma_tensor_op_fast_f32.h)
// relies on the same truncation for its big part (round_toward_zero).
__device__ __forceinline__ uint32_t tf32_lo(float x) {
  return __float_as_uint(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u));
}

__device__ __forceinline__ float elem(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Asynchronous copies, global to shared: 16 bytes of which the first
// `bytes` are read from src and the rest zero-filled, or 4 bytes (0 or 4
// read). src is not read when bytes is 0.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// dynamic shared memory of xcov_tc_kernel, in floats
__host__ __device__ __forceinline__ int tc_smem_floats(int bn, int nf, int d) {
  return 256                         // up to the first 1024-byte boundary
         + 2 * nf * TC_BM * TC_BK    // L^{-1} tiles: [stage][factor]
         + 2 * 2 * bn * TC_BK        // K_US tiles: [stage][hi, lo]
         + 2 * TC_BK * d             // support rows: [stage]
         + bn * d + bn               // queries and their squared norms
         + TC_WARPS * nf * bn;       // the warps' sums of squares
}

// Block (blockIdx.x = query tile, blockIdx.y = unit): unit u is chunk c of
// panel p, numbered from the last panel down, chunks in order. An unsplit
// panel writes part[0..1][p][q] itself; a split one writes its partial V^T
// tile to vpart[u] (2, 64, n), summed by xcov_tc_sum_chunks. The chunk
// holding the panel's own 64 support points writes part[2][p][q].
template <int BN, bool WITH_L2, bool VEC>
__global__ void __launch_bounds__(TC_THREADS, 2)
xcov_tc_kernel(const float* __restrict__ xq, const float* __restrict__ xk,
               const float* __restrict__ l1inv,
               const float* __restrict__ l2inv,
               const float* __restrict__ alpha,
               const float* __restrict__ sig2, float* __restrict__ part,
               float* __restrict__ vpart, int n, int s, int d, int kc) {
  constexpr int NF = WITH_L2 ? 2 : 1;
  constexpr int NTL = BN / 8;              // n8 tiles, all in every warp
  constexpr int QPT = BN / TC_WARPS;       // K_US rows a thread generates
  constexpr int A_STAGE = NF * TC_BM * TC_BK;
  constexpr int B_PLANE = BN * TC_BK;
  static_assert(BN % 8 == 0 && QPT >= 1, "query tile");

  extern __shared__ __align__(16) float smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  float* Bs = smem_raw + ((1024 - (raw & 1023)) & 1023) / 4;
                                           // [2][hi, lo][BN x 32], swizzled
  float* As = Bs + 4 * B_PLANE;            // [2][NF][64 x 32]
  float* Xs = As + 2 * A_STAGE;            // [2][32 x d]
  float* Us = Xs + 2 * TC_BK * d;          // [d x BN], queries transposed
  float* Uq = Us + BN * d;                 // [BN]
  float* red = Uq + BN;                    // [TC_WARPS][NF][BN]

  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int P = (s + TC_BM - 1) / TC_BM;
  const int unit = blockIdx.y;
  int p = P - 1, c = unit, C = panel_chunks(p, s, kc);
  while (c >= C) {
    c -= C;
    C = panel_chunks(--p, s, kc);
  }
  const int j0 = p * TC_BM;
  const int k_end = min(j0 + TC_BM, s);
  const int k_lo = c * kc, k_hi = min(k_lo + kc, k_end);
  const int steps = (k_hi - k_lo + TC_BK - 1) / TC_BK;
  const bool split = C > 1;
  const int q0 = blockIdx.x * BN;
  const float s2 = sig2[0];

  // L^{-1}[j0 + r, k0 + col] of both factors into stage buf; entries past
  // the diagonal (k > j) and rows past s read as zero. The 16-byte copies
  // of a thread are column a_col of rows a_row + 16 i, in every step.
  const int a_col = 4 * (tid % 8), a_row = tid / 8;
  const long long a_off = static_cast<long long>(j0 + a_row) * s + a_col;
  auto stage_a = [&](int buf, int k0) {
    float* dst = As + buf * A_STAGE;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < TC_BM / 16; ++i) {
        const int r = a_row + 16 * i, j = j0 + r;
        const int valid = j < s ? max(0, min(4, j + 1 - k0 - a_col)) : 0;
        const long long at = a_off + 16LL * i * s + k0;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const float* L = f == 0 ? l1inv : l2inv;
          cp_async16(dst + f * TC_BM * TC_BK + swz(r, a_col),
                     valid ? L + at : L, 4 * valid);
        }
      }
    } else {
      for (int e = tid; e < NF * TC_BM * TC_BK; e += TC_THREADS) {
        const int f = e / (TC_BM * TC_BK), rem = e % (TC_BM * TC_BK);
        const int r = rem / TC_BK, col = rem % TC_BK;
        const int j = j0 + r, k = k0 + col;
        const bool ok = j < s && k <= j;
        const float* L = f == 0 ? l1inv : l2inv;
        cp_async4(dst + f * TC_BM * TC_BK + swz(r, col),
                  ok ? L + static_cast<long long>(j) * s + k : L, ok);
      }
    }
  };
  // support rows [k0, k0 + 32) into stage buf, rows past s as zero
  auto stage_x = [&](int buf, int k0) {
    float* dst = Xs + buf * TC_BK * d;
    const long long base = static_cast<long long>(k0) * d;
    const long long end = static_cast<long long>(s) * d;
    for (int e = tid; e < TC_BK * d; e += TC_THREADS) {
      const bool ok = base + e < end;
      cp_async4(dst + e, ok ? xk + base + e : xk, ok);
    }
  };
  // the K_US tile [q][k0 + lane] from support-row stage xbuf into K_US
  // stage buf, as hi (the float itself) and lo planes: lane = k, the warp's
  // rows q = QPT w .. QPT w + QPT - 1 (their coordinates read 16 bytes at
  // a time, the same for every lane)
  auto gen_b = [&](int buf, int xbuf) {
    const float* xr = Xs + xbuf * TC_BK * d + lane * d;
    const float* ur = Us + QPT * w;
    float dot[QPT];
#pragma unroll
    for (int i = 0; i < QPT; ++i) dot[i] = 0.f;
    float kk = 0.f;
    for (int u = 0; u < d; ++u, ur += BN) {
      const float xv = xr[u];
      kk += xv * xv;
      if constexpr (QPT % 4 == 0) {
#pragma unroll
        for (int i = 0; i < QPT; i += 4) {
          const float4 u4 = *reinterpret_cast<const float4*>(ur + i);
          dot[i] += xv * u4.x;
          dot[i + 1] += xv * u4.y;
          dot[i + 2] += xv * u4.z;
          dot[i + 3] += xv * u4.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < QPT; ++i) dot[i] += xv * ur[i];
      }
    }
    float* bh = Bs + buf * 2 * B_PLANE;
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int q = QPT * w + i;
      const float d2 = Uq[q] + kk - 2.f * dot[i];
      const float v = s2 * expf(-0.5f * fmaxf(d2, 0.f));
      bh[bpos(q, bcol(lane))] = v;
      bh[B_PLANE + bpos(q, bcol(lane))] = __uint_as_float(tf32_lo(v));
    }
    fence_proxy_async();
  };

  // prologue: the queries, the first L^{-1} tiles, two support-row stages
  for (int e = tid; e < BN * d; e += TC_THREADS) {
    const int q = e / d, u = e % d;
    Us[u * BN + q] =
        q0 + q < n ? xq[static_cast<long long>(q0) * d + e] : 0.f;
  }
  stage_a(0, k_lo);
  stage_x(0, k_lo);
  if (steps > 1) stage_x(1, k_lo + TC_BK);
  cp_async_commit();
  __syncthreads();
  if (tid < BN) {
    float qq = 0.f;
    for (int u = 0; u < d; ++u) qq += Us[u * BN + tid] * Us[u * BN + tid];
    Uq[tid] = qq;
  }
  cp_async_wait_all();
  __syncthreads();
  gen_b(0, 0);

  float acc[NF][NTL][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[f][nt][v] = 0.f;
  float mean_share = 0.f;

  for (int step = 0; step < steps; ++step) {
    const int cur = step % 2, k0 = k_lo + step * TC_BK;
    // L^{-1} tiles of this step, support rows of the next, and the K_US
    // tile of this step have landed; every warp is done with the last step
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < steps) stage_a(cur ^ 1, k0 + TC_BK);
    if (step + 2 < steps) stage_x(cur, k0 + 2 * TC_BK);
    cp_async_commit();
    // A fragments of the step's four k slices, both factors, split once
    const float* A = As + cur * A_STAGE;
    uint32_t ah[NF][4][4], al[NF][4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 16 * h + 4 * t;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float* Af = A + f * TC_BM * TC_BK;
        const float4 r0 =
            *reinterpret_cast<const float4*>(Af + swz(w * 16 + g, col));
        const float4 r1 =
            *reinterpret_cast<const float4*>(Af + swz(w * 16 + g + 8, col));
#pragma unroll
        for (int sub = 0; sub < 2; ++sub) {
          const float v[4] = {elem(r0, 2 * sub), elem(r1, 2 * sub),
                              elem(r0, 2 * sub + 1), elem(r1, 2 * sub + 1)};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[f][2 * h + sub][i] = __float_as_uint(v[i]);
            al[f][2 * h + sub][i] = tf32_lo(v[i]);
          }
        }
      }
    }
    // hi hi' + lo hi' + hi lo' for both factors, on the tensor cores while
    // the warps generate the next K_US tile
    float* bh = Bs + cur * 2 * B_PLANE;
    const uint32_t b_addr = static_cast<uint32_t>(__cvta_generic_to_shared(bh));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dh = sw128_desc(b_addr + kk * 32);
      const uint64_t dl = sw128_desc(b_addr + B_PLANE * 4 + kk * 32);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wgmma_tf32<BN>(&acc[f][0][0], ah[f][kk], dh);
        wgmma_tf32<BN>(&acc[f][0][0], al[f][kk], dh);
        wgmma_tf32<BN>(&acc[f][0][0], ah[f][kk], dl);
      }
    }
    wgmma_commit();
    if (step + 1 < steps) gen_b(cur ^ 1, cur ^ 1);
    // the panel's own support points carry its share of the mean
    if (k0 >= j0 && tid < BN) {
      for (int k = 0; k < TC_BK && k0 + k < s; ++k)
        mean_share += bh[bpos(tid, bcol(k))] * alpha[k0 + k];
    }
    wgmma_wait_all();
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      hold<NTL * 4>(&acc[f][0][0]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hold<4>(ah[f][kk]);
        hold<4>(al[f][kk]);
      }
    }
  }

  const long long pn = static_cast<long long>(P) * n;
  if (k_hi == k_end && tid < BN && q0 + tid < n)
    part[2 * pn + static_cast<long long>(p) * n + q0 + tid] = mean_share;
  if (split) {
    // acc[f][nt][v] is row w 16 + g + 8 (v / 2), query nt 8 + 2 t + v % 2
    float* out = vpart + static_cast<long long>(unit) * 2 * TC_BM * n;
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int jl = w * 16 + g + 8 * (v / 2);
          const int q = q0 + nt * 8 + 2 * t + v % 2;
          if (q < n)
            out[static_cast<long long>(f * TC_BM + jl) * n + q] = acc[f][nt][v];
        }
    return;
  }
  // sums of squares over the warp's 16 rows (the 8 lanes of one t), then
  // over the four warps in order
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      float s0 = acc[f][nt][0] * acc[f][nt][0] + acc[f][nt][2] * acc[f][nt][2];
      float s1 = acc[f][nt][1] * acc[f][nt][1] + acc[f][nt][3] * acc[f][nt][3];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (g == 0) {
        red[(w * NF + f) * BN + nt * 8 + 2 * t] = s0;
        red[(w * NF + f) * BN + nt * 8 + 2 * t + 1] = s1;
      }
    }
  __syncthreads();
  if (tid < BN && q0 + tid < n) {
    const long long o = static_cast<long long>(p) * n + q0 + tid;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      float sum = 0.f;
      if (f < NF)
        for (int ww = 0; ww < TC_WARPS; ++ww)
          sum += red[(ww * NF + f) * BN + tid];
      part[f * pn + o] = sum;
    }
  }
}

// part[f][p][q] = sum over the panel's 64 rows of (sum over its chunks, in
// order, of vpart[unit][f][row][q])^2, for the split panels (grid: query
// tiles of qt = 8, 16 or 32, panels). Thread t owns query t % qt and every
// (SUM_THREADS / qt)-th row from t / qt, so a small batch still spreads its
// loads over the whole block; the rows' sums are added in order.
template <bool WITH_L2>
__global__ void __launch_bounds__(SUM_THREADS)
xcov_tc_sum_chunks(const float* __restrict__ vpart, float* __restrict__ part,
                   int n, int s, int kc, int qt) {
  constexpr int NF = WITH_L2 ? 2 : 1;
  const int P = (s + TC_BM - 1) / TC_BM, p = blockIdx.y;
  const int C = panel_chunks(p, s, kc);
  if (C == 1) return;   // written by xcov_tc_kernel
  int base = 0;         // the unit of the panel's first chunk
  for (int pp = P - 1; pp > p; --pp) base += panel_chunks(pp, s, kc);
  __shared__ float red[2][SUM_THREADS];
  const int tid = threadIdx.x, rstep = SUM_THREADS / qt;
  const int q = blockIdx.x * qt + tid % qt;
  const long long chunk = 2LL * TC_BM * n;   // one unit's partial tiles
  for (int f = 0; f < NF; ++f) {
    float acc = 0.f;
    if (q < n)
      for (int jl = tid / qt; jl < TC_BM; jl += rstep) {
        const float* src = vpart + base * chunk +
                           static_cast<long long>(f * TC_BM + jl) * n + q;
        float v = 0.f;
        for (int c = 0; c < C; ++c) v += src[c * chunk];
        acc += v * v;
      }
    red[f][tid] = acc;
  }
  __syncthreads();
  if (tid < qt && q < n) {
    const long long pn = static_cast<long long>(P) * n;
    for (int f = 0; f < 2; ++f) {
      float sum = 0.f;
      if (f < NF)
        for (int r = 0; r < rstep; ++r) sum += red[f][r * qt + tid];
      part[f * pn + static_cast<long long>(p) * n + q] = sum;
    }
  }
}

int tc_units(int s, int kc) {
  int units = 0;
  for (int p = 0; p < (s + TC_BM - 1) / TC_BM; ++p)
    units += panel_chunks(p, s, kc);
  return units;
}

template <int BN, bool WITH_L2, bool VEC>
cudaError_t launch_tc3(const float* xq, const float* xk, const float* l1inv,
                       const float* l2inv, const float* alpha,
                       const float* sig2, float* part, float* vpart, int n,
                       int s, int d, int kc, cudaStream_t stream) {
  const int smem = tc_smem_floats(BN, WITH_L2 ? 2 : 1, d) * 4;
  const cudaError_t attr = cudaFuncSetAttribute(
      xcov_tc_kernel<BN, WITH_L2, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int units = tc_units(s, kc);
  const dim3 grid((n + BN - 1) / BN, units);
  xcov_tc_kernel<BN, WITH_L2, VEC><<<grid, TC_THREADS, smem, stream>>>(
      xq, xk, l1inv, l2inv, alpha, sig2, part, vpart, n, s, d, kc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || units == (s + TC_BM - 1) / TC_BM) return err;
  const int qt = n <= 8 ? 8 : n <= 16 ? 16 : 32;
  const dim3 sgrid((n + qt - 1) / qt, (s + TC_BM - 1) / TC_BM);
  xcov_tc_sum_chunks<WITH_L2><<<sgrid, SUM_THREADS, 0, stream>>>(
      vpart, part, n, s, kc, qt);
  return cudaGetLastError();
}

template <int BN, bool WITH_L2>
cudaError_t launch_tc2(bool vec, const float* xq, const float* xk,
                       const float* l1inv, const float* l2inv,
                       const float* alpha, const float* sig2, float* part,
                       float* vpart, int n, int s, int d, int kc,
                       cudaStream_t stream) {
  return vec ? launch_tc3<BN, WITH_L2, true>(xq, xk, l1inv, l2inv, alpha,
                                             sig2, part, vpart, n, s, d, kc,
                                             stream)
             : launch_tc3<BN, WITH_L2, false>(xq, xk, l1inv, l2inv, alpha,
                                              sig2, part, vpart, n, s, d, kc,
                                              stream);
}

template <bool WITH_L2>
cudaError_t launch_tc(int bn, bool vec, const float* xq, const float* xk,
                      const float* l1inv, const float* l2inv,
                      const float* alpha, const float* sig2, float* part,
                      float* vpart, int n, int s, int d, int kc,
                      cudaStream_t stream) {
  switch (bn) {
    case 8:
      return launch_tc2<8, WITH_L2>(vec, xq, xk, l1inv, l2inv, alpha, sig2,
                                    part, vpart, n, s, d, kc, stream);
    case 16:
      return launch_tc2<16, WITH_L2>(vec, xq, xk, l1inv, l2inv, alpha, sig2,
                                     part, vpart, n, s, d, kc, stream);
    case 32:
      return launch_tc2<32, WITH_L2>(vec, xq, xk, l1inv, l2inv, alpha, sig2,
                                     part, vpart, n, s, d, kc, stream);
    case 64:
      return launch_tc2<64, WITH_L2>(vec, xq, xk, l1inv, l2inv, alpha, sig2,
                                     part, vpart, n, s, d, kc, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int BQ, bool WITH_L2>
void launch_panels(const double* xq, const double* xk, const double* l1inv,
                   const double* l2inv, const double* alpha,
                   const double* sig2, double* part, int n, int s, int d,
                   cudaStream_t stream) {
  const dim3 grid((s + BJ - 1) / BJ, (n + BQ - 1) / BQ);
  xcov_panel_kernel<double, BQ, WITH_L2><<<grid, NT, 0, stream>>>(
      xq, xk, l1inv, l2inv, alpha, sig2, part, n, s, d);
}

template <bool WITH_L2>
bool launch_f64(int block_q, const double* xq, const double* xk,
                const double* l1inv, const double* l2inv,
                const double* alpha, const double* sig2, double* part, int n,
                int s, int d, cudaStream_t stream) {
  switch (block_q) {
    case 8:
      launch_panels<8, WITH_L2>(xq, xk, l1inv, l2inv, alpha, sig2, part, n,
                                s, d, stream);
      return true;
    case 16:
      launch_panels<16, WITH_L2>(xq, xk, l1inv, l2inv, alpha, sig2, part, n,
                                 s, d, stream);
      return true;
    case 32:
      launch_panels<32, WITH_L2>(xq, xk, l1inv, l2inv, alpha, sig2, part, n,
                                 s, d, stream);
      return true;
    default:
      return false;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = float64, for every input, output, sig2 and the
// scratch (the accumulation type is the input type). Xq (n, d), Xk (s, d),
// L1inv/L2inv (s, s) and alpha (s,) are contiguous; mean and var are (n,);
// part is scratch of 3 * ceil(s/64) * n values. L2inv is ignored when
// with_l2 is 0.
//  * float32 (tensor cores): block_q is the query tile, 8, 16, 32 or 64;
//    kc, a positive multiple of 64, is the k-range of a block (kc >= s:
//    panels are not split); vpart is scratch of 2 * 64 * n values for
//    each unit (tc_units: blocks per query tile) when some panel is split,
//    else unused.
//  * float64 (FP64 FMA): block_q is 8, 16 or 32; kc and vpart are unused.
// *tensor_cores is set to 1 once the tensor-core kernel (xcov_tc_kernel) has
// been launched, else to 0. Returns cudaGetLastError() of the launches (two
// or three kernels).
extern "C" int xcov_diag(int dtype, int block_q, int kc, int with_l2,
                         const void* xq, const void* xk, const void* l1inv,
                         const void* l2inv, const void* alpha,
                         const void* sig2, void* part, void* vpart,
                         void* mean, void* var, int n, int s, int d,
                         void* stream, int* tensor_cores) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_panels = (s + BJ - 1) / BJ;
  *tensor_cores = 0;
  if (n < 1 || s < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (kc < TC_BM || kc % TC_BM != 0 || tc_units(s, kc) > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = s % 4 == 0 && aligned16(l1inv) && aligned16(l2inv);
    const auto f = [](const void* p) { return static_cast<const float*>(p); };
    cudaError_t err =
        with_l2 ? launch_tc<true>(block_q, vec, f(xq), f(xk), f(l1inv),
                                  f(l2inv), f(alpha), f(sig2),
                                  static_cast<float*>(part),
                                  static_cast<float*>(vpart), n, s, d, kc, st)
                : launch_tc<false>(block_q, vec, f(xq), f(xk), f(l1inv),
                                   f(l2inv), f(alpha), f(sig2),
                                   static_cast<float*>(part),
                                   static_cast<float*>(vpart), n, s, d, kc,
                                   st);
    if (err != cudaSuccess) return static_cast<int>(err);
    *tensor_cores = 1;
    xcov_reduce_kernel<float><<<(n + 255) / 256, 256, 0, st>>>(
        f(part), f(sig2), static_cast<float*>(mean), static_cast<float*>(var),
        n, n_panels);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 1) {
    const auto f = [](const void* p) { return static_cast<const double*>(p); };
    double* pt = static_cast<double*>(part);
    const bool ok =
        with_l2 ? launch_f64<true>(block_q, f(xq), f(xk), f(l1inv), f(l2inv),
                                   f(alpha), f(sig2), pt, n, s, d, st)
                : launch_f64<false>(block_q, f(xq), f(xk), f(l1inv),
                                    f(l2inv), f(alpha), f(sig2), pt, n, s, d,
                                    st);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    xcov_reduce_kernel<double><<<(n + 255) / 256, 256, 0, st>>>(
        f(part), f(sig2), static_cast<double*>(mean),
        static_cast<double*>(var), n, n_panels);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
