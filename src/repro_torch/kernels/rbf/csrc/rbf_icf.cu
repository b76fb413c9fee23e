// rbf_icf.cu — the pivoted incomplete Cholesky factorization of the SE
// kernel matrix (all R pivot steps of select_support) as one cooperative
// persistent kernel for Hopper, with the rbf column fused into the update.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rbf/rbf.py:55
// (rbf_pallas) where src/repro/core/icf.py:42-55 calls it: once per pivot
// step, for one kernel column K(x_p, X), inside one jax.lax.fori_loop, so
// that on the TPU the whole pivot loop is one compiled program. Over inputs
// X (n, d) already scaled by the lengthscale, with d_0 = sig2 everywhere,
// for i = 0 .. R-1:
//
//   p      = the first index of max(d)              (argmax's tie rule)
//   col_j  = sig2 exp(-0.5 max(|x_p|^2 + |x_j|^2 - 2 x_p.x_j, 0))
//   f      = (col - F[:i]^T F[:i, p]) / sqrt(max(d_p, 1e-30))
//   F[i]   = f,   d = max(d - f^2, 0),   d_p = 0,   piv[i] = p,
//   dpv[i] = d_p   (the pivot value; pICF's pivot triangle has sqrt(d_p)
//                   on its diagonal)
//
// col is the rbf kernel's function computed with fmaf norms and cross term,
// max and expf (rbf.cu folds the same function into one approximate exp2,
// within its float32 tolerance of this). The float64 instance computes in
// float64 throughout, the column too; it exists for the parity tests (the
// reference's float64 loop), and in float32 the two contracts coincide.
//
// What bounds it on the card: each step depends on the previous step's
// argmax, so the R steps are R grid-wide reductions in sequence. The work
// of step i is a GEMV over i x n values of F; over the run that is
// n R (R - 1) flops (34.3 GFLOP at n = 8192, R = 2048: 0.51 ms at 67
// TFLOP/s of f32) and, streamed from device memory, 4 n R (R - 1) / 2
// bytes (68.7 GB: 20.5 ms at 3.35 TB/s). L2 (50 MB), shared memory and
// registers beat the streaming time; the floor is then R barriers (a probe
// entry below times R empty ones) plus the operations. On an H100 (700 W)
// it takes 13.4-14.1 ms there: 6.6 us a step on average, of which an
// empty barrier is 1.0 us; the L2 round trips for the candidates and for
// F[:i, p], the update and the GEMV make up the rest.
//
// What the design does about it:
//  * One launch (cudaLaunchCooperativeKernel, so all blocks are resident),
//    one block an SM, each block owning a contiguous slice of W columns (64
//    at n = 8192: 128 blocks). No block returns early, so every block
//    reaches every barrier (ragged slices are masked).
//  * Each step ends in one grid barrier (grid_barrier: a release add and
//    acquire loads on one counter, by one thread a block). Empty, it took
//    1.0 us on the card, against 1.13 us for a cooperative-groups grid
//    sync, 1.49 us with every warp polling the counter, and 1.56 us for a
//    barrier made of the candidate slots themselves, each polled for its
//    step's tag.
//  * The argmax without a second barrier: at the end of step i each block
//    writes its slice's (max d, first index) to a candidate array,
//    double-buffered on i's parity; after the barrier warp 0 of every block
//    loads all candidates at once and reduces them in the same fixed
//    order, the lowest index winning ties, so all arrive at the same p.
//    d_p is the winning candidate's value, never d[p], which the owner
//    block overwrites during the step.
//  * F[:i, p] as one contiguous read: a transposed copy Ft (n, Rp) in
//    scratch (zeroed by the wrapper) holds column j's factor entries in
//    row j. F[:i, p] = Ft[p, :i] is staged into shared memory (8 KB at
//    R = 2048 in f32) by 16-byte loads all issued at once. F (R, n) itself
//    is written once, from Ft at the end, with streaming stores.
//  * The GEMV over the block's slice: warp w owns W / 8 columns and reads
//    each column's Ft row with 16-byte loads, lanes along k, 8 columns at
//    once and two vectors a column (64 KB in flight an SM), every load
//    issued before the first is used; the lane sums are added by a fixed
//    shuffle tree. No atomics anywhere, so repeated launches are bitwise
//    equal.
//  * F's leading rows on chip: the first K entries of each of the block's
//    Ft rows are also kept in shared memory, K sized from the opt-in
//    shared-memory limit (868 rows at W = 64 in f32, half in f64), and in
//    float32 the next 2 x 128 in registers (each lane holds the vectors it
//    reads), so the GEMV reads its first 1124 terms on chip: 1 - ((R -
//    1124) / R)^2 = 80% of its bytes at R = 2048. The on-chip and the
//    global values are the same stored numbers summed in the same order,
//    so the result does not depend on how many rows are kept (the
//    wrapper's ``cached_rows`` can set it to 0).
//  * The data every block writes and others read during the run
//    (candidates, Ft rows) is read with ld.global.cg (L2, never a stale
//    L1 line); the grid barrier orders the writes before the reads.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int NT = 256;              // threads per block
constexpr int NWARPS = NT / 32;      // warps per block; W is a multiple
constexpr int NC = 8;                // columns a warp sums at once
constexpr int RALIGN = 4;            // Ft's row stride is R rounded up to it
constexpr int FP_UNROLL = 4;         // 16-byte loads a thread stages at once
constexpr int CAND_UNROLL = 8;       // candidates a lane loads at once

template <typename T>
struct Num;
template <>
struct Num<float> {
  using Vec = float4;
  static constexpr int VEC = 4;
  static constexpr int RR = 2;   // vectors a column keeps in registers
  // the first m components of q (m >= 4: all), the rest zero
  static __device__ __forceinline__ float4 head(float4 q, int m) {
    return make_float4(q.x, m > 1 ? q.y : 0.f, m > 2 ? q.z : 0.f,
                       m > 3 ? q.w : 0.f);
  }
  static __device__ __forceinline__ void set(float4& q, int c, float v) {
    q.x = c == 0 ? v : q.x;
    q.y = c == 1 ? v : q.y;
    q.z = c == 2 ? v : q.z;
    q.w = c == 3 ? v : q.w;
  }
  static __device__ __forceinline__ float lowest() { return -FLT_MAX; }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return fmaf(a, b, c);
  }
  static __device__ __forceinline__ float exp(float x) { return expf(x); }
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float max(float a, float b) {
    return fmaxf(a, b);
  }
  // d - f * f rounded twice, as PyTorch's two elementwise passes round it
  static __device__ __forceinline__ float sub_sq(float d, float f) {
    return __fsub_rn(d, __fmul_rn(f, f));
  }
  static __device__ __forceinline__ float dot(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
  }
};
template <>
struct Num<double> {
  using Vec = double2;
  static constexpr int VEC = 2;
  static constexpr int RR = 0;   // the parity instance: no register rows
  static __device__ __forceinline__ double2 head(double2 q, int m) {
    return make_double2(q.x, m > 1 ? q.y : 0.0);
  }
  static __device__ __forceinline__ double lowest() { return -DBL_MAX; }
  static __device__ __forceinline__ double fma(double a, double b, double c) {
    return ::fma(a, b, c);
  }
  static __device__ __forceinline__ double exp(double x) { return ::exp(x); }
  static __device__ __forceinline__ double sqrt(double x) {
    return ::sqrt(x);
  }
  static __device__ __forceinline__ double max(double a, double b) {
    return fmax(a, b);
  }
  static __device__ __forceinline__ double sub_sq(double d, double f) {
    return __dsub_rn(d, __dmul_rn(f, f));
  }
  static __device__ __forceinline__ double dot(double2 a, double2 b,
                                               double acc) {
    acc = ::fma(a.x, b.x, acc);
    return ::fma(a.y, b.y, acc);
  }
};

template <typename T>
struct IcfArgs {
  const T* x;         // (n, d) lengthscale-scaled inputs
  const T* sig2;      // one value, device memory
  T* F;               // (R, n) output
  T* Ft;              // (n, Rp) scratch, zeroed: Ft[j, k] = F[k, j]
  long long* piv;     // (R,) output
  T* resid;           // (n,) output: the residual diagonal
  T* dpv;             // (R,) output: each step's pivot value d_p
  T* cand_v;          // (2, blocks) candidates: max d of a slice
  int* cand_i;        // (2, blocks) and its first index
  unsigned* sync;     // the grid barrier's arrival count, zeroed
  int n, R, Rp, d;
  int W;              // columns a block owns, a multiple of NWARPS
  int K;              // leading Ft entries a column keeps in shared memory
  int RRon;           // then RRon x 32 VEC entries in registers (<= RR)
};

// Grid-wide barrier of a cooperative launch: thread 0 of each block adds
// one to *count with release semantics (after the block's barrier, so the
// whole block's writes are ordered before it) and waits, with acquire
// loads, until all `target` arrivals of this generation are in. The
// pattern of CUTLASS's GenericBarrier; lighter than a cooperative-groups
// grid sync's two sequentially consistent fences and returning atomic.
__device__ __forceinline__ void grid_barrier(unsigned* count,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                 :
                 : "l"(count)
                 : "memory");
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// (v, i) beats (bv, bi): larger value, or the same value at a lower index
template <typename T>
__device__ __forceinline__ void take_better(T v, int i, T& bv, int& bi) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

template <typename T>
__device__ __forceinline__ void warp_argmax(T& bv, int& bi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T v = __shfl_xor_sync(0xffffffffu, bv, o);
    const int i = __shfl_xor_sync(0xffffffffu, bi, o);
    take_better(v, i, bv, bi);
  }
}

// warp 0: this block's (max d, first index) over its slice -> cand[slot]
template <typename T>
__device__ __forceinline__ void post_candidate(const IcfArgs<T>& a,
                                               const T* dres, int wn, int j0,
                                               int slot, int lane) {
  T bv = Num<T>::lowest();
  int bi = INT32_MAX;
  for (int c = lane; c < wn; c += 32) take_better(dres[c], j0 + c, bv, bi);
  warp_argmax(bv, bi);
  if (lane == 0) {
    a.cand_v[slot] = bv;
    a.cand_i[slot] = bi;
  }
}

// warp 0: the winner of all nb candidates in cv/ci, in every lane; a lane's
// first CAND_UNROLL loaded at once (one L2 round trip)
template <typename T>
__device__ __forceinline__ void gather(const T* cv, const int* ci, int nb,
                                       int lane, T& bv, int& bi) {
  T v[CAND_UNROLL];
  int id[CAND_UNROLL];
#pragma unroll
  for (int q = 0; q < CAND_UNROLL; ++q) {
    const int c = lane + 32 * q;
    v[q] = c < nb ? __ldcg(cv + c) : Num<T>::lowest();
    id[q] = c < nb ? __ldcg(ci + c) : INT32_MAX;
  }
  bv = v[0];
  bi = id[0];
#pragma unroll
  for (int q = 1; q < CAND_UNROLL; ++q) take_better(v[q], id[q], bv, bi);
  for (int c = lane + 32 * CAND_UNROLL; c < nb; c += 32)
    take_better(__ldcg(cv + c), __ldcg(ci + c), bv, bi);
  warp_argmax(bv, bi);
}

// Shared memory: fp (Rp) | cache (W x K) | x slice (W x d) | |x_j|^2 (W) |
// residual d (W) | x_p (d)
template <typename T>
__host__ __device__ inline size_t icf_smem_bytes(int Rp, int W, int K,
                                                 int d) {
  return sizeof(T) * (static_cast<size_t>(Rp) + static_cast<size_t>(W) * K +
                      static_cast<size_t>(W) * (d + 2) + d);
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) icf_kernel(IcfArgs<T> a) {
  using V = typename Num<T>::Vec;
  constexpr int VEC = Num<T>::VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* fp_s = reinterpret_cast<T*>(smem_raw);
  T* cache = fp_s + a.Rp;
  T* xs = cache + static_cast<size_t>(a.W) * a.K;
  T* k2s = xs + a.W * a.d;
  T* dres = k2s + a.W;
  T* xp_s = dres + a.W;
  __shared__ int p_s;
  __shared__ T dp_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = gridDim.x, b = blockIdx.x;
  const int n = a.n, d = a.d, W = a.W, K = a.K;
  const int j0 = b * W;
  const int wn = min(W, n - j0);       // >= 1: the wrapper sizes the grid
  const int cw = W / NWARPS;           // columns of each warp
  const T s2 = a.sig2[0];
  constexpr int S = 32 * VEC;          // a warp's stride along k
  constexpr int RR = Num<T>::RR;
  // rows [K, K + RRon S) of the warp's first NC columns, in registers:
  // lane l holds the vectors at k = l VEC (mod S), as it reads them
  V rg[NC][RR > 0 ? RR : 1];
#pragma unroll
  for (int u = 0; u < NC; ++u)
#pragma unroll
    for (int r = 0; r < (RR > 0 ? RR : 1); ++r) rg[u][r] = V{};
  const int kr = K + a.RRon * S;       // end of the rows kept on chip

  for (int e = tid; e < W * d; e += NT) {
    const int c = e / d;
    xs[e] = c < wn ? a.x[static_cast<size_t>(j0) * d + e] : T(0);
  }
  for (size_t e = tid; e < static_cast<size_t>(W) * K; e += NT) cache[e] = 0;
  __syncthreads();
  for (int c = tid; c < W; c += NT) {
    T acc = 0;
    for (int t = 0; t < d; ++t) acc = Num<T>::fma(xs[c * d + t], xs[c * d + t],
                                                  acc);
    k2s[c] = acc;
    dres[c] = c < wn ? s2 : T(0);
  }
  __syncthreads();
  if (warp == 0) post_candidate(a, dres, wn, j0, b, lane);
  grid_barrier(a.sync, nb);

  for (int i = 0; i < a.R; ++i) {
    const int buf = i & 1;
    // 1. the pivot: every block reduces every candidate the same way
    if (warp == 0) {
      T bv;
      int bi;
      gather(a.cand_v + buf * nb, a.cand_i + buf * nb, nb, lane, bv, bi);
      if (lane == 0) {
        p_s = bi;
        dp_s = bv;
      }
    }
    __syncthreads();
    const int p = p_s;
    const T dp = dp_s;
    const T rdp = Num<T>::sqrt(Num<T>::max(dp, T(1e-30)));

    // 2. stage F[:i, p] = Ft[p, :i] (zero up to the next vector) and x_p:
    //    16-byte loads, FP_UNROLL a thread issued before the first store, so
    //    the row costs one L2 round trip, not one a load
    const T* ftp = a.Ft + static_cast<size_t>(p) * a.Rp;
    const int iv = (i + VEC - 1) / VEC * VEC;
    for (int k0 = tid * VEC; k0 < iv; k0 += FP_UNROLL * NT * VEC) {
      V v[FP_UNROLL];
#pragma unroll
      for (int q = 0; q < FP_UNROLL; ++q) {
        const int k = k0 + q * NT * VEC;
        v[q] = k < iv ? __ldcg(reinterpret_cast<const V*>(ftp + k)) : V{};
      }
#pragma unroll
      for (int q = 0; q < FP_UNROLL; ++q) {
        const int k = k0 + q * NT * VEC;
        if (k < iv)
          *reinterpret_cast<V*>(fp_s + k) = Num<T>::head(v[q], i - k);
      }
    }
    for (int t = tid; t < d; t += NT)
      xp_s[t] = a.x[static_cast<size_t>(p) * d + t];
    __syncthreads();
    T q2p = 0;
    for (int t = 0; t < d; ++t) q2p = Num<T>::fma(xp_s[t], xp_s[t], q2p);

    // 3. s_j = Ft[j, :i] . fp for the warp's columns, then the update.
    //    Lane l sums k = l VEC + m S in ascending m, whatever K and RRon
    //    are: shared memory, then registers (first group only), then L2 /
    //    device memory, two vectors a column in flight. A column past the
    //    slice reads column 0's rows and is discarded, so no load waits
    //    behind a branch.
    for (int u0 = 0; u0 < cw; u0 += NC) {
      const T* srow[NC];
      const T* grow[NC];
      T acc[NC];
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        int c = warp * cw + u0 + u;
        if (u0 + u >= cw || c >= wn) c = 0;
        srow[u] = cache + static_cast<size_t>(c) * K;
        grow[u] = a.Ft + static_cast<size_t>(j0 + c) * a.Rp;
        acc[u] = 0;
      }
      int k = lane * VEC;
      for (const int kc = min(i, K); k < kc; k += S) {
        const V f = *reinterpret_cast<const V*>(fp_s + k);
#pragma unroll
        for (int u = 0; u < NC; ++u)
          acc[u] = Num<T>::dot(*reinterpret_cast<const V*>(srow[u] + k), f,
                               acc[u]);
      }
      if constexpr (RR > 0) {
        if (u0 == 0) {
#pragma unroll
          for (int r = 0; r < RR; ++r) {
            if (r < a.RRon) {
              if (k < i) {
                const V f = *reinterpret_cast<const V*>(fp_s + k);
#pragma unroll
                for (int u = 0; u < NC; ++u)
                  acc[u] = Num<T>::dot(rg[u][r], f, acc[u]);
              }
              k += S;
            }
          }
        }
      }
      for (; k + S < i; k += 2 * S) {
        const V f0 = *reinterpret_cast<const V*>(fp_s + k);
        const V f1 = *reinterpret_cast<const V*>(fp_s + k + S);
        V g0[NC], g1[NC];
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          g0[u] = __ldcg(reinterpret_cast<const V*>(grow[u] + k));
          g1[u] = __ldcg(reinterpret_cast<const V*>(grow[u] + k + S));
        }
#pragma unroll
        for (int u = 0; u < NC; ++u)
          acc[u] = Num<T>::dot(g1[u], f1, Num<T>::dot(g0[u], f0, acc[u]));
      }
      if (k < i) {
        const V f = *reinterpret_cast<const V*>(fp_s + k);
#pragma unroll
        for (int u = 0; u < NC; ++u)
          acc[u] = Num<T>::dot(
              __ldcg(reinterpret_cast<const V*>(grow[u] + k)), f, acc[u]);
      }
      T mine = 0;
#pragma unroll
      for (int u = 0; u < NC; ++u) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
        if (lane == u) mine = acc[u];
      }
      const int c = warp * cw + u0 + lane;
      T f = 0;
      if (lane < NC && u0 + lane < cw && c < wn) {
        const int j = j0 + c;
        T cross = 0;
        for (int t = 0; t < d; ++t)
          cross = Num<T>::fma(xp_s[t], xs[c * d + t], cross);
        const T d2 = Num<T>::max(q2p + k2s[c] - T(2) * cross, T(0));
        const T col = s2 * Num<T>::exp(T(-0.5) * d2);
        f = (col - mine) / rdp;
        a.Ft[static_cast<size_t>(j) * a.Rp + i] = f;
        if (i < K) cache[static_cast<size_t>(c) * K + i] = f;
        dres[c] = j == p ? T(0) : Num<T>::max(Num<T>::sub_sq(dres[c], f), T(0));
      }
      if constexpr (RR > 0) {
        // row i of the register rows: to the lane that reads it
        if (u0 == 0 && i >= K && i < kr) {
          const int owner = i % S / VEC;
          const int first = K + ((owner * VEC - K % S) + S) % S;
          const int slot = (i - first) / S, comp = i % VEC;
#pragma unroll
          for (int u = 0; u < NC; ++u) {
            const T v = __shfl_sync(0xffffffffu, f, u);
#pragma unroll
            for (int r = 0; r < RR; ++r)
              if (lane == owner && r == slot) Num<T>::set(rg[u][r], comp, v);
          }
        }
      }
    }
    __syncthreads();

    // 4. this slice's candidate for step i + 1; the pivot's record
    if (warp == 0) post_candidate(a, dres, wn, j0, (buf ^ 1) * nb + b, lane);
    if (b == 0 && tid == 0) {
      a.piv[i] = p;
      a.dpv[i] = dp;
    }
    grid_barrier(a.sync, static_cast<unsigned>(nb) * (i + 2));
  }
  for (int c = tid; c < wn; c += NT) a.resid[j0 + c] = dres[c];
  // F = Ft^T over the slice, written once: a warp writes 32 columns of a
  // row, reading 32 Ft rows whose sectors serve the next k too (L1)
#pragma unroll 4
  for (size_t e = tid; e < static_cast<size_t>(a.R) * W; e += NT) {
    const int k = static_cast<int>(e / W), c = static_cast<int>(e % W);
    if (c < wn)
      __stcs(a.F + static_cast<size_t>(k) * n + j0 + c,
             a.Ft[static_cast<size_t>(j0 + c) * a.Rp + k]);
  }
}

// R empty grid barriers: the floor of the factorization's step.
__global__ void __launch_bounds__(NT, 1) icf_barrier_probe(unsigned* sync,
                                                           int R) {
  for (int i = 0; i < R; ++i)
    grid_barrier(sync, gridDim.x * static_cast<unsigned>(i + 1));
}

struct Plan {
  int blocks, width;
  int smem_rows, regs;  // Ft entries a column keeps in shared memory, then
                        // vectors a lane keeps in registers
  int cached;           // the rows so kept on chip
  int smem, max_rank, rp;
};

// Blocks, slice width, cached rows and shared memory of the launch: one
// block an SM with as many of Ft's leading entries kept on chip as the
// opt-in limit leaves room for (at most max_cached, if >= 0).
template <typename T>
cudaError_t make_plan(int n, int R, int d, int max_cached, Plan* pl) {
  constexpr int VEC = Num<T>::VEC;
  int dev = 0, sms = 0, optin = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop || n < 1 || R < 0 || d < 0) return cudaErrorInvalidValue;
  const int per_block = (n + sms - 1) / sms;
  pl->width = (per_block + NWARPS - 1) / NWARPS * NWARPS;
  pl->blocks = (n + pl->width - 1) / pl->width;
  pl->rp = (R + RALIGN - 1) / RALIGN * RALIGN;
  // static shared memory (p_s, dp_s) and alignment slack
  const long long reserve = 64;
  const long long fixed = static_cast<long long>(
      icf_smem_bytes<T>(0, pl->width, 0, d)) + reserve;
  pl->max_rank = static_cast<int>(
      (optin - fixed) / static_cast<long long>(sizeof(T)) / RALIGN * RALIGN);
  if (pl->rp > pl->max_rank) return cudaErrorInvalidValue;
  const long long room =
      optin - fixed - static_cast<long long>(sizeof(T)) * pl->rp;
  long long k = room / (static_cast<long long>(sizeof(T)) * pl->width);
  k = k / VEC * VEC;
  if (k > pl->rp) k = pl->rp;
  if (max_cached >= 0 && k > max_cached) k = max_cached / VEC * VEC;
  // then up to RR vectors a lane in registers, within max_cached and R
  constexpr int S = 32 * VEC;
  long long rr = (pl->rp - k + S - 1) / S;
  if (rr > Num<T>::RR) rr = Num<T>::RR;
  if (max_cached >= 0 && rr > (max_cached - k) / S) rr = (max_cached - k) / S;
  pl->smem_rows = static_cast<int>(k);
  pl->regs = static_cast<int>(rr);
  pl->cached = static_cast<int>(k + rr * S < pl->rp ? k + rr * S : pl->rp);
  pl->smem = static_cast<int>(
      icf_smem_bytes<T>(pl->rp, pl->width, pl->smem_rows, d));
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_icf(const void* x, const void* sig2, void* F, void* Ft,
                       void* piv, void* resid, void* dpv, void* cand_v,
                       void* cand_i,
                       void* sync, int n, int R, int d, int max_cached,
                       cudaStream_t stream) {
  Plan pl;
  cudaError_t err = make_plan<T>(n, R, d, max_cached, &pl);
  if (err != cudaSuccess) return err;
  if (reinterpret_cast<uintptr_t>(Ft) % 16 != 0) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(icf_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl.smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, icf_kernel<T>,
                                                      NT, pl.smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < pl.blocks) return cudaErrorCooperativeLaunchTooLarge;
  IcfArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.sig2 = static_cast<const T*>(sig2);
  a.F = static_cast<T*>(F);
  a.Ft = static_cast<T*>(Ft);
  a.piv = static_cast<long long*>(piv);
  a.resid = static_cast<T*>(resid);
  a.dpv = static_cast<T*>(dpv);
  a.cand_v = static_cast<T*>(cand_v);
  a.cand_i = static_cast<int*>(cand_i);
  a.sync = static_cast<unsigned*>(sync);
  a.n = n;
  a.R = R;
  a.Rp = pl.rp;
  a.d = d;
  a.W = pl.width;
  a.K = pl.smem_rows;
  a.RRon = pl.regs;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(icf_kernel<T>), dim3(pl.blocks), dim3(NT),
      args, pl.smem, stream);
}

cudaError_t plan_for(int dtype, int n, int R, int d, int max_cached,
                     Plan* pl) {
  switch (dtype) {
    case 0:
      return make_plan<float>(n, R, d, max_cached, pl);
    case 1:
      return make_plan<double>(n, R, d, max_cached, pl);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch's shape for dtype (0 = float32, 1 = float64), n candidates, R
// pivots, d features: blocks, columns a block, the leading factor entries a
// column keeps on chip (in all, and of them in shared memory), dynamic
// shared memory in bytes, Ft's row stride, and the largest R the shared
// memory takes (reported even when R exceeds it, which returns an error).
extern "C" int rbf_icf_plan(int dtype, int n, int R, int d, int max_cached,
                            int* blocks, int* width, int* cached,
                            int* smem_rows, int* smem, int* row_stride,
                            int* max_rank) {
  Plan pl{0, 0, 0, 0, 0, 0, 0, 0};
  const cudaError_t err = plan_for(dtype, n, R, d, max_cached, &pl);
  *blocks = pl.blocks;
  *width = pl.width;
  *cached = pl.cached;
  *smem_rows = pl.smem_rows;
  *smem = pl.smem;
  *row_stride = pl.rp;
  *max_rank = pl.max_rank;
  return static_cast<int>(err);
}

// All R pivot steps in one cooperative launch on `stream`. x (n, d) and
// sig2 (one value) in dtype; F (R, n), resid (n,), dpv (R,: each step's
// pivot value d_p) and cand_v (2 x blocks) in dtype; Ft (n, row_stride)
// zeroed and 16-byte aligned; piv (R,) int64; cand_i (2 x blocks) int32;
// sync one zeroed uint32. max_cached < 0 keeps as many rows on chip as
// fit.
// Returns the launch's error, else cudaGetLastError().
extern "C" int rbf_icf(int dtype, const void* x, const void* sig2, void* F,
                       void* Ft, void* piv, void* resid, void* dpv,
                       void* cand_v, void* cand_i, void* sync, int n, int R,
                       int d,
                       int max_cached, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_icf<float>(x, sig2, F, Ft, piv, resid, dpv, cand_v,
                              cand_i, sync, n, R, d, max_cached, st);
      break;
    case 1:
      err = launch_icf<double>(x, sig2, F, Ft, piv, resid, dpv, cand_v,
                               cand_i, sync, n, R, d, max_cached, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// R empty grid barriers (sync: one zeroed uint32) on the grid rbf_icf
// would launch for (dtype, n, d): the barrier floor of the factorization,
// timed by chip_smoke.py.
extern "C" int rbf_icf_barrier_probe(int dtype, int n, int R, int d,
                                     void* sync, void* stream) {
  Plan pl;
  cudaError_t err = plan_for(dtype, n, R, d, 0, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&sync, &R};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(icf_barrier_probe), dim3(pl.blocks),
      dim3(NT), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
