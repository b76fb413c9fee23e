// row_products.cu — the per-block program of pPIC's routed serving diag
// (eqs. 12-14 in the whitened form of core/ppic.py) as products and row
// reductions whose arithmetic, for every output element, is fixed by
// construction: it does not depend on the number of rows, on the row's
// slot, on the batch of blocks, on the layout or on the table's strides.
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
// is copied. With `lower`, B_e is lower triangular and the K tiles that are
// zero for a whole panel of 64 output columns are skipped (which tiles
// depends on the panel only).
//
// What bounds it (roofline/kernels.py rows_mm_flops / rows_mm_bytes):
//  * the 256-row request, (M, u, s, b) = (20, 32, 2048, 1600): the six
//    stages read each block's Q_m, K_{S D_m} and C_Lm^-1, 0.81 GB, against
//    17.0 GFLOP, so the bytes bound it (0.26 ms at 3.35 TB/s; the 3xTF32
//    operations 0.10 ms). What matters is keeping copies in flight.
//  * the 3200-row request, 20 blocks of u = 336: the same tables against
//    178.9 GFLOP, so the 3xTF32 operations bound it (1.08 ms at 495
//    TFLOP/s). What matters is the tensor cores' rate and reusing each
//    table element over many query rows.
//
// float32 (rows_mm_f32): 3xTF32 on wgmma, tables on M and queries on N.
//  * A warpgroup computes Y^T = op(B_e)^T X^T for a panel of 64 output
//    columns (wgmma's M) and the block's QT tiles of 32 query rows
//    (wgmma's N): one m64n32k8 shape for every u, so nothing in a row's
//    arithmetic depends on u. More rows are more instructions over the
//    same table fragment, never a wider one. A block of one tile (u <= 32)
//    is one warpgroup; a larger one is two warpgroups on 128 columns that
//    share its query tiles (u = 336: 11 tiles, blocks of 6 and 5), which
//    halves the query bytes each product needs, the limit at that size.
//  * A is the panel, staged in shared memory and read into registers, each
//    element by one thread and split there into hi and lo once; B is the
//    query tile, K-major under the 128-byte swizzle, its hi plane the
//    staged floats and its lo plane written once by the thread that copied
//    them. Per k slice of 8, hi hi' + lo hi' + hi lo', in that order.
//  * Every stage comes in by cp.async into a ring of 3 stages (K tiles of
//    32), 16 bytes a copy along the table's unit-stride axis (k-contiguous
//    and n-contiguous entries each have their shared layout, both free of
//    bank conflicts for the fragment loads) and along the query rows; other
//    strides, ragged K and unaligned bases copy one element at a time into
//    the k-contiguous layout. One barrier a K tile; the lo plane of tile
//    t + 1 is split while tile t's products run.
//  * Blocks are numbered by table block, then panel (longest k range first
//    under `lower`), then query group, so a block's groups share each table
//    tile through L2. Under `lower`, where every table block's queries fit
//    in L2 together, by panel rank first (panel_major): the longest panels
//    of all table blocks start first and only short ones are left for the
//    tail.
//  * Fixed order: an output element is the sum over its 64-column panel's
//    K tiles in order (each warpgroup multiplies only its own panel's
//    range, whatever the block's width), k slices in order, the three
//    products in order, on one accumulator; no split-K, no atomics. Every
//    staging path puts the same values in the same fragment slots, so
//    every stride gives the same bits; a row's slot inside its tile only
//    picks the accumulator lane.
// float64 (rows_mm_f64): FP64 on the CUDA cores, each product and sum
//    correctly rounded (the _rn intrinsics, never contracted to an FMA): a
//    k-step's 8 products p_0..p_7 summed as ((p0+p4)+(p2+p6)) +
//    ((p1+p5)+(p3+p7)), then added to the element's running sum. The plain
//    version (ref.rows_mm) does the same operations in the same order, so
//    the two agree bit for bit. Tiles of 32 rows x 64 columns, a thread 4 x
//    4 of them; the same 3-stage cp.async ring (one element a copy), and a
//    k-step's 32 table values held in registers over the thread's 4 rows.
// rows_reduce: per row, the dots and sums of squares of eqs. (12)-(13),
//    mean = Phi.alpha + R.Wy_e and var = ((kdiag - |A|^2) - |V|^2) + |Z|^2
//    (R.W in place of |V|^2 with a cached C^-1), in one launch. One warp a
//    row: lane l sums elements l, l + 32, ... in order, then a fixed
//    butterfly (xor 16, 8, 4, 2, 1); lane 0 writes. Correctly rounded
//    products and sums, in both types: bitwise ref.rows_reduce.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "wgmma_tf32.cuh"

namespace {

using namespace rows_sm90;

constexpr int PM = 64;        // output columns a panel: wgmma's M
constexpr int QN = 32;        // query rows a tile: wgmma's N
constexpr int BK = 32;        // K of a stage
constexpr int STAGES = 3;     // the copy ring
constexpr int KS = 8;         // a k-step: one product's depth, one tree
constexpr int THREADS = 128;  // one warpgroup; 4 warps for float64
constexpr int BM64 = 32;      // float64: output rows a block
constexpr int REDUCE_WARPS = 8;

// How the f32 kernel stages a table panel: entries with k-contiguous rows
// (16-byte copies along k), n-contiguous rows (16-byte copies along n), or
// any other strides (4-byte copies). The wrapper picks (ops.rows_plan).
enum Layout { KMAJ = 0, NMAJ = 1, ANY = 2 };

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

// The K range of output columns [n0, n0 + PM): all of it, or with a lower
// triangular B the tiles that are not zero for every column of the panel.
// op(B)[k][n] = B[n][k] (trans) is zero for k > n; B[k][n] for n > k.
__device__ __forceinline__ void k_range(int K, int n0, bool trans,
                                        bool lower, int& lo, int& hi) {
  lo = 0;
  hi = K;
  if (lower) {
    if (trans)
      hi = min(K, n0 + PM);
    else
      lo = n0 / BK * BK;
  }
}

// Y's rows [r0, r0 + rows) x columns [n0, n0 + cols) of block blk as NaN:
// a block whose index lies outside the table (the wrapper cannot check a
// device index without a sync).
template <typename T>
__device__ __forceinline__ void nan_tile(T* Y, int blk, int u, int N, int r0,
                                         int rows, int n0, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int r = r0 + e / cols, n = n0 + e % cols;
    if (r < u && n < N)
      set_nan(Y[(static_cast<long long>(blk) * u + r) * N + n]);
  }
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 wgmma
// ---------------------------------------------------------------------------

constexpr int X_TILE = QN * BK;  // a stage's query tile (one plane), floats

// dynamic shared memory of rows_mm_f32<WG, QT>, in floats: the alignment
// slack, the ring ([stage][panel of 64 WG columns | QT query tiles]) and
// two lo planes of QT tiles
__host__ __device__ constexpr int f32_smem_floats(int wg, int qt) {
  return 256 + STAGES * (wg * PM * BK + qt * X_TILE) + 2 * qt * X_TILE;
}

// Word offset of (k, n) in an n-contiguous panel [32 k][cols n]: its 16-byte
// chunks XORed with 2 (k mod 4), so the fragment loads (8 rows n by 4 k of
// one k mod 4 each) hit 32 distinct banks.
template <int COLS>
__device__ __forceinline__ int nmaj(int k, int n) {
  return k * COLS + ((((n >> 2) ^ (2 * (k & 3)))) << 2) + (n & 3);
}

// WG warpgroups, each its own 64 output columns of the block's panel of 64
// WG, over the block's QT query tiles, which they share. Block blockIdx.x:
// (table block blk, panel rank, query group), the group fastest, then the
// panel rank, or then the table block where panel_major; panel p = rank,
// or P - 1 - rank where the last panel has the longest k range (lower and
// trans).
template <int WG, int QT, int LAYOUT>
__global__ void __launch_bounds__(128 * WG)
    rows_mm_f32(const float* __restrict__ X, const float* __restrict__ B,
                const long long* __restrict__ idx, long long nt,
                long long bstride, long long sk, long long sn,
                const float* __restrict__ C0, float* __restrict__ Y, int u,
                int K, int N, bool trans, bool lower, bool xvec,
                bool panel_major, int P, int NG) {
  constexpr int NT = 128 * WG;          // threads
  constexpr int CM = PM * WG;           // output columns a block
  constexpr int T_TILE = CM * BK;       // a stage's panel, floats
  constexpr int STAGE = T_TILE + QT * X_TILE;
  constexpr int XPASS = QT * X_TILE / 4 / NT;  // a thread's query chunks
  static_assert(XPASS * NT * 4 == QT * X_TILE, "query chunks");
  extern __shared__ __align__(16) float smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  float* ring = smem_raw + ((1024 - (raw & 1023)) & 1023) / 4;
  float* lo_planes = ring + STAGES * STAGE;   // [2][QT][32 x 32]

  long long id = blockIdx.x;
  const int grp = static_cast<int>(id % NG);
  id /= NG;
  const int nblk = static_cast<int>(gridDim.x / (1LL * P * NG));
  const int rank = static_cast<int>(panel_major ? id / nblk : id % P);
  const int blk = static_cast<int>(panel_major ? id % nblk : id / P);
  const int p = lower && trans ? P - 1 - rank : rank;
  const int n0 = p * CM, q0 = grp * QT * QN;
  const long long e = idx ? idx[blk] : bstride ? blk : 0;
  if (e < 0 || e >= nt) {
    nan_tile(Y, blk, u, N, q0, QT * QN, n0, CM);
    return;
  }
  const float* Xk = X + static_cast<long long>(blk) * u * K;
  const float* Be = B + e * bstride;
  // the warpgroup's index broadcast from lane 0, so that the compiler
  // knows it (and the branch on its k range below) to be warp-uniform
  const int tid = threadIdx.x, w = tid / 32 % 4;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const bool nfast = sn <= sk;   // ANY: copy along the faster axis
  // this warpgroup's 64 columns and the K tiles it multiplies (its own
  // k_range, whatever WG); the block stages the union, from its first
  // panel's start to its last panel's end
  const int nw = n0 + PM * wg;
  int wlo, whi, klo, khi, unused;
  k_range(K, nw, trans, lower, wlo, whi);
  k_range(K, n0, trans, lower, klo, unused);
  k_range(K, n0 + CM - PM, trans, lower, unused, khi);
  const bool active = nw < N;
  const int steps = (khi - klo + BK - 1) / BK;

  // The thread's query chunks: 16 bytes at k 4 (tid % 8) of rows
  // tid / 8 + NT / 8 i of the group, the same in every stage.
  const int xc = tid % 8;
  auto x_off = [&](int row) {
    return (row / QN) * X_TILE + sw128(row % QN, 4 * xc);
  };

  // stage buf <- the panel's and the group's K tile [k0, k0 + 32), zero
  // past N, K and u
  auto stage = [&](int buf, int k0) {
    float* Ts = ring + buf * STAGE;
    float* Xs = Ts + T_TILE;
    if constexpr (LAYOUT == KMAJ) {
      const int c = tid % 8, k = k0 + 4 * c;
      const int kb = 4 * max(0, min(4, K - k));
#pragma unroll
      for (int i = 0; i < CM * 8 / NT; ++i) {
        const int r = tid / 8 + NT / 8 * i, n = n0 + r;
        const bool ok = n < N && kb > 0;
        cp_async16(Ts + sw128(r, 4 * c), ok ? Be + n * sn + k : Be,
                   ok ? kb : 0);
      }
    } else if constexpr (LAYOUT == NMAJ) {
      const int c = tid % (CM / 4), n = n0 + 4 * c;
      const int nb = 4 * max(0, min(4, N - n));
#pragma unroll
      for (int i = 0; i < BK * CM / 4 / NT; ++i) {
        const int kr = tid / (CM / 4) + NT / (CM / 4) * i, k = k0 + kr;
        const bool ok = k < K && nb > 0;
        cp_async16(Ts + nmaj<CM>(kr, 4 * c), ok ? Be + k * sk + n : Be,
                   ok ? nb : 0);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < T_TILE / NT; ++j) {
        const int f = tid + NT * j;
        const int r = nfast ? f % CM : f / BK, kc = nfast ? f / CM : f % BK;
        const int n = n0 + r, k = k0 + kc;
        const bool ok = n < N && k < K;
        cp_async_elem(Ts + sw128(r, kc), ok ? Be + k * sk + n * sn : Be, ok);
      }
    }
    const int k = k0 + 4 * xc;
#pragma unroll
    for (int i = 0; i < XPASS; ++i) {
      const int row = tid / 8 + NT / 8 * i, q = q0 + row;
      float* dst = Xs + x_off(row);
      const float* src = Xk + static_cast<long long>(q) * K + k;
      if (xvec) {
        const int kb = q < u ? 4 * max(0, min(4, K - k)) : 0;
        cp_async16(dst, kb ? src : Xk, kb);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const bool ok = q < u && k + v < K;
          cp_async_elem(dst + v, ok ? src + v : Xk, ok);
        }
      }
    }
  };
  // lo plane lbuf <- tf32_lo of the query chunks this thread copied into
  // stage buf (its own copies: its cp.async wait covers them)
  auto split_lo = [&](int buf, int lbuf) {
    const float* Xs = ring + buf * STAGE + T_TILE;
    float* Ls = lo_planes + lbuf * QT * X_TILE;
#pragma unroll
    for (int i = 0; i < XPASS; ++i) {
      const int o = x_off(tid / 8 + NT / 8 * i);
      const float4 h = *reinterpret_cast<const float4*>(Xs + o);
      *reinterpret_cast<float4*>(Ls + o) = make_float4(
          __uint_as_float(tf32_lo(h.x)), __uint_as_float(tf32_lo(h.y)),
          __uint_as_float(tf32_lo(h.z)), __uint_as_float(tf32_lo(h.w)));
    }
    fence_proxy_async();
  };

  float acc[QT][QN / 2];
#pragma unroll
  for (int j = 0; j < QT; ++j)
#pragma unroll
    for (int v = 0; v < QN / 2; ++v) acc[j][v] = 0.f;

  // prologue: stages 0 .. STAGES - 2 in flight, stage 0's lo plane
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) stage(s, klo + s * BK);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  split_lo(0, 0);

  for (int step = 0; step < steps; ++step) {
    const int cur = step % STAGES, k0 = klo + step * BK;
    // every thread's copies of this stage and its lo plane have landed;
    // every warp is done with the last stage's products
    __syncthreads();
    if (step + STAGES - 1 < steps)
      stage((step + STAGES - 1) % STAGES, k0 + (STAGES - 1) * BK);
    cp_async_commit();
    const float* Ts = ring + cur * STAGE;
    if (active && k0 >= wlo && k0 < whi) {
      // A fragments of the stage's four k slices: rows 16 w + g (+ 8) of
      // the warpgroup's 64, k 8 kk + t (+ 4), each read and split once
      uint32_t ah[BK / KS][4], al[BK / KS][4];
#pragma unroll
      for (int kk = 0; kk < BK / KS; ++kk) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = PM * wg + 16 * w + g + 8 * (v % 2);
          const int k = 8 * kk + t + 4 * (v / 2);
          const float x =
              LAYOUT == NMAJ ? Ts[nmaj<CM>(k, r)] : Ts[sw128(r, k)];
          ah[kk][v] = __float_as_uint(x);
          al[kk][v] = tf32_lo(x);
        }
      }
      const uint32_t xh =
          static_cast<uint32_t>(__cvta_generic_to_shared(Ts + T_TILE));
      const uint32_t xl = static_cast<uint32_t>(__cvta_generic_to_shared(
          lo_planes + (step % 2) * QT * X_TILE));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / KS; ++kk)
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          const uint64_t dh = sw128_desc(xh + 4 * j * X_TILE + 32 * kk);
          const uint64_t dl = sw128_desc(xl + 4 * j * X_TILE + 32 * kk);
          wgmma_m64n32k8(acc[j], ah[kk], dh);
          wgmma_m64n32k8(acc[j], al[kk], dh);
          wgmma_m64n32k8(acc[j], ah[kk], dl);
        }
      wgmma_commit();
      // the next stage's lo plane while the products run
      if (step + 1 < steps) {
        cp_async_wait<STAGES - 2>();
        split_lo((step + 1) % STAGES, (step + 1) % 2);
      }
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < QT; ++j) hold<QN / 2>(acc[j]);
#pragma unroll
      for (int kk = 0; kk < BK / KS; ++kk) {
        hold<4>(ah[kk]);
        hold<4>(al[kk]);
      }
    } else if (step + 1 < steps) {
      cp_async_wait<STAGES - 2>();
      split_lo((step + 1) % STAGES, (step + 1) % 2);
    }
  }

  // acc[j][4 nt + v] is output column nw + 16 w + g + 8 (v / 2), query row
  // q0 + 32 j + 8 nt + 2 t + v % 2
#pragma unroll
  for (int j = 0; j < QT; ++j) {
#pragma unroll
    for (int v = 0; v < QN / 2; ++v) {
      const int n = nw + 16 * w + g + 8 * ((v % 4) / 2);
      const int q = q0 + QN * j + 8 * (v / 4) + 2 * t + v % 2;
      if (n < N && q < u) {
        const long long o = (static_cast<long long>(blk) * u + q) * N + n;
        Y[o] = C0 ? sub_rn(C0[o], acc[j][v]) : acc[j][v];
      }
    }
  }
}

template <int WG, int QT, int LAYOUT>
cudaError_t launch_f32(const float* X, const float* B, const long long* idx,
                       long long nt, long long bstride, long long sk,
                       long long sn, const float* C0, float* Y, int nblk,
                       int u, int K, int N, bool trans, bool lower, bool xvec,
                       bool panel_major, cudaStream_t st) {
  constexpr int smem = f32_smem_floats(WG, QT) * 4;
  const cudaError_t attr = cudaFuncSetAttribute(
      rows_mm_f32<WG, QT, LAYOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int P = (N + PM * WG - 1) / (PM * WG);
  const int NG = ((u + QN - 1) / QN + QT - 1) / QT;
  const long long blocks = static_cast<long long>(nblk) * P * NG;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  rows_mm_f32<WG, QT, LAYOUT><<<static_cast<unsigned>(blocks), 128 * WG,
                                smem, st>>>(X, B, idx, nt, bstride, sk, sn,
                                            C0, Y, u, K, N, trans, lower,
                                            xvec, panel_major, P, NG);
  return cudaGetLastError();
}

// qt 1: one warpgroup a block (64 columns); qt 2 .. 6: two (128 columns)
template <int LAYOUT>
cudaError_t launch_f32_qt(int qt, const float* X, const float* B,
                          const long long* idx, long long nt,
                          long long bstride, long long sk, long long sn,
                          const float* C0, float* Y, int nblk, int u, int K,
                          int N, bool trans, bool lower, bool xvec,
                          bool panel_major, cudaStream_t st) {
#define ROWS_F32(WG, QT)                                                   \
  launch_f32<WG, QT, LAYOUT>(X, B, idx, nt, bstride, sk, sn, C0, Y, nblk, \
                             u, K, N, trans, lower, xvec, panel_major, st)
  switch (qt) {
    case 1:
      return ROWS_F32(1, 1);
    case 2:
      return ROWS_F32(2, 2);
    case 3:
      return ROWS_F32(2, 3);
    case 4:
      return ROWS_F32(2, 4);
    case 5:
      return ROWS_F32(2, 5);
    case 6:
      return ROWS_F32(2, 6);
    default:
      return cudaErrorInvalidValue;
  }
#undef ROWS_F32
}

// ---------------------------------------------------------------------------
// float64: correctly rounded FP64 in the plain version's order
// ---------------------------------------------------------------------------

constexpr int XP64 = BK + 1;   // a staged row of X, doubles
constexpr int BP64 = PM + 1;   // a staged k row of op(B), doubles
constexpr int STAGE64 = BM64 * XP64 + BK * BP64;

// The 8 products of a k-step, summed by the fixed tree.
__device__ __forceinline__ double tree8(const double* x, const double* b) {
  double p[KS];
#pragma unroll
  for (int q = 0; q < KS; ++q) p[q] = mul_rn(x[q], b[q]);
  const double s0 = add_rn(p[0], p[4]), s1 = add_rn(p[1], p[5]);
  const double s2 = add_rn(p[2], p[6]), s3 = add_rn(p[3], p[7]);
  return add_rn(add_rn(s0, s2), add_rn(s1, s3));
}

// Thread (tr, tc) computes rows tr + 8 i and columns tc + 16 j (i, j < 4)
// of a 32 x 64 tile; op(B) staged k-major ([32 k][64 + 1 n]), X row-major.
__global__ void __launch_bounds__(THREADS)
    rows_mm_f64(const double* __restrict__ X, const double* __restrict__ B,
                const long long* __restrict__ idx, long long nt,
                long long bstride, long long sk, long long sn,
                const double* __restrict__ C0, double* __restrict__ Y, int u,
                int K, int N, bool trans, bool lower) {
  extern __shared__ __align__(16) double dsm[];
  const int n0 = blockIdx.x * PM, r0 = blockIdx.y * BM64, blk = blockIdx.z;
  const long long e = idx ? idx[blk] : bstride ? blk : 0;
  if (e < 0 || e >= nt) {
    nan_tile(Y, blk, u, N, r0, BM64, n0, PM);
    return;
  }
  const double* Xk = X + static_cast<long long>(blk) * u * K;
  const double* Be = B + e * bstride;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const bool nfast = sn <= sk;
  int klo, khi;
  k_range(K, n0, trans, lower, klo, khi);
  const int steps = (khi - klo + BK - 1) / BK;

  auto stage = [&](int buf, int k0) {
    double* Xs = dsm + buf * STAGE64;
    double* Bs = Xs + BM64 * XP64;
    for (int f = tid; f < BM64 * BK; f += THREADS) {
      const int r = f / BK, k = f % BK, gr = r0 + r, gk = k0 + k;
      const bool ok = gr < u && gk < K;
      cp_async_elem(Xs + r * XP64 + k,
                    ok ? Xk + static_cast<long long>(gr) * K + gk : Xk, ok);
    }
    for (int f = tid; f < PM * BK; f += THREADS) {
      const int n = nfast ? f % PM : f / BK, k = nfast ? f / PM : f % BK;
      const int gn = n0 + n, gk = k0 + k;
      const bool ok = gn < N && gk < K;
      cp_async_elem(Bs + k * BP64 + n, ok ? Be + gk * sk + gn * sn : Be, ok);
    }
  };

  double acc[4][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) stage(s, klo + s * BK);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (step + STAGES - 1 < steps)
      stage((step + STAGES - 1) % STAGES, klo + (step + STAGES - 1) * BK);
    cp_async_commit();
    const double* Xs = dsm + (step % STAGES) * STAGE64;
    const double* Bs = Xs + BM64 * XP64;
#pragma unroll
    for (int ks = 0; ks < BK; ks += KS) {
      double b[4][KS];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < KS; ++q)
          b[j][q] = Bs[(ks + q) * BP64 + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        double x[KS];
#pragma unroll
        for (int q = 0; q < KS; ++q) x[q] = Xs[(tr + 8 * i) * XP64 + ks + q];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = add_rn(acc[i][j], tree8(x, b[j]));
      }
    }
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

cudaError_t launch_f64(const double* X, const double* B, const long long* idx,
                       long long nt, long long bstride, long long sk,
                       long long sn, const double* C0, double* Y, int nblk,
                       int u, int K, int N, bool trans, bool lower,
                       cudaStream_t st) {
  constexpr int smem = STAGES * STAGE64 * 8;
  const cudaError_t attr = cudaFuncSetAttribute(
      rows_mm_f64, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + PM - 1) / PM, (u + BM64 - 1) / BM64, nblk);
  rows_mm_f64<<<grid, THREADS, smem, st>>>(X, B, idx, nt, bstride, sk, sn,
                                           C0, Y, u, K, N, trans, lower);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
// K, N >= 1. float32: qt (1 .. 6) query tiles of 32 rows a block, the
// table's staging (0: k-contiguous rows, 16-byte aligned; 1: n-contiguous
// rows, aligned; 2: any) and the blocks' order (panel_major), all from
// ops.rows_plan; nblk x ceil(N / (64 or 128)) x ceil(ceil(u / 32) / qt)
// blocks <= INT_MAX. float64: qt, layout and panel_major unused; nblk,
// u / 32 <= 65535. Returns the launch's error, else cudaGetLastError().
extern "C" int rows_mm(int dtype, const void* X, const void* B,
                       const void* idx, long long nt, long long bstride,
                       long long sp, long long sq, const void* C0, void* Y,
                       int nblk, int u, int K, int N, int trans, int lower,
                       int qt, int layout, int panel_major, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const long long*>(idx);
  // op(B)[k][n] = B_e[n][k] (trans) or B_e[k][n]
  const long long sk = trans ? sq : sp, sn = trans ? sp : sq;
  if (dtype == 1)
    return static_cast<int>(launch_f64(
        static_cast<const double*>(X), static_cast<const double*>(B), ix, nt,
        bstride, sk, sn, static_cast<const double*>(C0),
        static_cast<double*>(Y), nblk, u, K, N, trans, lower, st));
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool base = aligned16(B) && bstride % 4 == 0;
  if ((layout == KMAJ && !(base && sk == 1 && sn % 4 == 0)) ||
      (layout == NMAJ && !(base && sn == 1 && sk % 4 == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool xvec = K % 4 == 0 && aligned16(X);
  const auto* x = static_cast<const float*>(X);
  const auto* b = static_cast<const float*>(B);
  const auto* c = static_cast<const float*>(C0);
  auto* y = static_cast<float*>(Y);
  cudaError_t err;
  switch (layout) {
    case KMAJ:
      err = launch_f32_qt<KMAJ>(qt, x, b, ix, nt, bstride, sk, sn, c, y, nblk,
                                u, K, N, trans, lower, xvec, panel_major, st);
      break;
    case NMAJ:
      err = launch_f32_qt<NMAJ>(qt, x, b, ix, nt, bstride, sk, sn, c, y, nblk,
                                u, K, N, trans, lower, xvec, panel_major, st);
      break;
    case ANY:
      err = launch_f32_qt<ANY>(qt, x, b, ix, nt, bstride, sk, sn, c, y, nblk,
                               u, K, N, trans, lower, xvec, panel_major, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
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
