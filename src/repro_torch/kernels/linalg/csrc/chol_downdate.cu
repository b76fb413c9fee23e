// chol_downdate.cu — the rank-b Cholesky downdate chol(L L^T - W W^T) of
// the streaming GP stores (a machine's retirement: Sdd_L by F_m, pICF's
// Phi_L by F_m / sigma) as one cooperative kernel for Hopper.
//
// Replaces no Pallas kernel: the reference computes this in
// src/repro/core/linalg.py:89-136 (_chol_rank1 chained over W's columns
// by chol_update_rank, jitted, outside any Pallas kernel). It is the port's
// own kernel on the path of retire: as plain PyTorch the sweeps are n b
// dependent steps of a few launches each (3.3 M steps at the paper's
// (n, b) = (2048, 1600)), and no library call computes a downdate.
//
// The function, for lower L (n, n) and W (n, b), sweep j = 0 .. b-1 over
// w = W[:, j], step k = 0 .. n-1, with l = L[k, k]:
//
//   r = sqrt(max(l^2 - w_k^2, tiny)),  c = r / l,  s = w_k / l,
//   L[i, k] = (L[i, k] - s w_i) / c,  w_i = c w_i - s L[i, k]   (i > k),
//   L[k, k] = r.
//
// Every operation rounds as the plain version's (ref.py) does: the
// products, sums and quotients are written with the _rn intrinsics, so
// nvcc contracts nothing into an FMA, and the clamp lets a NaN through as
// torch.clamp does. On the same inputs the two agree bit for bit.
//
// What bounds it on the card: step k of sweep j reads only column k of L as
// sweep j-1 left it and w_j as its own step k-1 left it. So the pairs
// (j, k) on one anti-diagonal d = j + k are independent, and the run is a
// chain of n + b - 1 diagonals (3647 at (2048, 1600), against n b = 3.3 M
// steps in the reference's order). Each pair updates n - k - 1 rows of one
// column of L and of one w_j, 6 flops a row: 3 n^2 b flops in all (20.1
// GFLOP at (2048, 1600), 0.3 ms at 67 TFLOP/s of f32); the function reads
// L's triangle and W once and writes L's triangle once (29.9 MB in f32,
// 8.9 us at 3.35 TB/s).
// The floor is then the n + b - 1 grid barriers (about 1 us each on an
// H100, from rbf_icf.cu's probe; this file has its own), plus each
// diagonal's L2 round trips. On an H100 (700 W) it takes 25.0-25.2 ms in
// float32 and 41.0-41.1 ms in float64 at (2048, 1600): 6.9 / 11.3 us a
// diagonal, of which an empty barrier is 1.06 us (chip_smoke.py).
//
// What the design does about it:
//  * One launch (cudaLaunchCooperativeKernel, one block of 1024 threads an
//    SM, all resident), a grid barrier after each diagonal (release add,
//    acquire poll: rbf_icf.cu's). No block returns early.
//  * L^T and W^T: the wrapper passes transposed copies, so column k of L
//    and w_j are rows: a warp's 32 lanes read and write 32 consecutive
//    entries. L (16.8 MB) and W (13.1 MB) at (2048, 1600) in f32 stay in
//    the 50 MB L2 across diagonals.
//  * A task is (pair, chunk of 256 rows); warps take tasks round robin,
//    pair-major, so neighbouring warps read neighbouring rows. A task
//    issues its 2 + 16 loads a lane at once (the diagonal entry, w_k, 8
//    rows of each), so a task costs about one L2 round trip. (A
//    chunk-major order, which mixes long and short columns in each
//    warp's tasks, measured slower.)
//  * L[k, k] is read by all of a pair's chunks and rewritten by the pair:
//    the diagonal lives in a separate array, double-buffered on d's parity
//    (read d & 1, write (d + 1) & 1), and is copied into L at the end.
//  * Data other blocks wrote is read with ld.global.cg (L2, never a stale
//    L1 line) and written with st.global.cg; the barrier orders them.
//  * No atomics on data: repeated launches are bitwise equal.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int NT = 1024;             // threads per block, one block an SM
constexpr int NWARPS = NT / 32;
constexpr int U = 8;                 // rows a lane updates in a task
constexpr int CH = 32 * U;           // rows a task updates

template <typename T>
struct Op;
template <>
struct Op<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float sqrt(float a) {
    return __fsqrt_rn(a);
  }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
};
template <>
struct Op<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double sqrt(double a) {
    return __dsqrt_rn(a);
  }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
};

template <typename T>
struct Args {
  T* Lt;            // (n, n): Lt[k n + i] = L[i, k], updated in place
  T* Wt;            // (b, n): Wt[j n + i] = W[i, j], scratch
  T* dg;            // (2, n): diag(L), both rows; double-buffered on d
  unsigned* sync;   // the grid barrier's arrival count, zeroed
  int n, b;
  int nch;          // chunks a pair has at most: max(1, ceil((n-1)/CH))
};

// Grid-wide barrier of a cooperative launch (rbf_icf.cu's): thread 0 of
// each block adds one to *count with release semantics, after the block's
// barrier, and waits with acquire loads until all `target` arrivals of this
// generation are in.
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

template <typename T>
__global__ void __launch_bounds__(NT, 1) downdate_kernel(Args<T> a) {
  using O = Op<T>;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  const int nw = gridDim.x * NWARPS;
  const int n = a.n, b = a.b, nch = a.nch;
  const T tiny = O::tiny();
  for (int d = 0; d < n + b - 1; ++d) {
    const int jlo = d - n + 1 > 0 ? d - n + 1 : 0;
    const int jhi = d < b - 1 ? d : b - 1;
    const int ntask = (jhi - jlo + 1) * nch;
    const T* dcur = a.dg + static_cast<size_t>(d & 1) * n;
    T* dnext = a.dg + static_cast<size_t>((d + 1) & 1) * n;
    for (int t = gw; t < ntask; t += nw) {
      const int q = t / nch;
      const int c = t - q * nch;
      const int j = jlo + q;
      const int k = d - j;
      const int i0 = k + 1 + c * CH;
      if (c > 0 && i0 >= n) continue;   // chunk 0 always sets L[k, k]
      T* lrow = a.Lt + static_cast<size_t>(k) * n;
      T* wrow = a.Wt + static_cast<size_t>(j) * n;
      const T lk = __ldcg(dcur + k);
      const T wk = __ldcg(wrow + k);
      T lv[U], wv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + lane + 32 * u;
        if (i < n) {
          lv[u] = __ldcg(lrow + i);
          wv[u] = __ldcg(wrow + i);
        }
      }
      T r2 = O::sub(O::mul(lk, lk), O::mul(wk, wk));
      if (r2 < tiny) r2 = tiny;         // max(., tiny); a NaN stays NaN
      const T r = O::sqrt(r2);
      const T cc = O::div(r, lk);
      const T s = O::div(wk, lk);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + lane + 32 * u;
        if (i < n) {
          const T col = O::div(O::sub(lv[u], O::mul(s, wv[u])), cc);
          const T wn = O::sub(O::mul(cc, wv[u]), O::mul(s, col));
          __stcg(lrow + i, col);
          __stcg(wrow + i, wn);
        }
      }
      if (c == 0 && lane == 0) __stcg(dnext + k, r);
    }
    grid_barrier(a.sync, gridDim.x * static_cast<unsigned>(d + 1));
  }
  // column k's last sweep (d = k + b - 1) wrote its diagonal to row
  // (k + b) & 1
  for (int k = blockIdx.x * NT + threadIdx.x; k < n; k += gridDim.x * NT)
    a.Lt[static_cast<size_t>(k) * n + k] =
        __ldcg(a.dg + static_cast<size_t>((k + b) & 1) * n + k);
}

// `steps` empty grid barriers on the downdate's grid: the floor of its
// n + b - 1 diagonals.
__global__ void __launch_bounds__(NT, 1) barrier_probe(unsigned* sync,
                                                       int steps) {
  for (int i = 0; i < steps; ++i)
    grid_barrier(sync, gridDim.x * static_cast<unsigned>(i + 1));
}

// One block an SM (the kernel needs all blocks resident).
template <typename K>
cudaError_t grid_for(K kernel, int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        0);
  if (err != cudaSuccess) return err;
  if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(void* Lt, void* Wt, void* dg, void* sync, int n, int b,
                   cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = grid_for(downdate_kernel<T>, &blocks);
  if (err != cudaSuccess) return err;
  Args<T> a;
  a.Lt = static_cast<T*>(Lt);
  a.Wt = static_cast<T*>(Wt);
  a.dg = static_cast<T*>(dg);
  a.sync = static_cast<unsigned*>(sync);
  a.n = n;
  a.b = b;
  a.nch = n > 1 ? (n - 1 + CH - 1) / CH : 1;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(downdate_kernel<T>), dim3(blocks),
      dim3(NT), args, 0, stream);
}

}  // namespace

// chol(L L^T - W W^T) in place of Lt on `stream`, dtype 0 = float32,
// 1 = float64. Lt (n, n) holds L^T (row k = column k of L); Wt (b, n) holds
// W^T and is overwritten; dg (2, n) holds diag(L) twice; sync one zeroed
// uint32; n >= 1, b >= 1. Returns the launch's error, else
// cudaGetLastError().
extern "C" int chol_downdate(int dtype, void* Lt, void* Wt, void* dg,
                             void* sync, int n, int b, void* stream) {
  if (n < 1 || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch<float>(Lt, Wt, dg, sync, n, b, st);
      break;
    case 1:
      err = launch<double>(Lt, Wt, dg, sync, n, b, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// `steps` empty grid barriers (sync: one zeroed uint32) on the grid
// chol_downdate launches: its barrier floor, timed by chip_smoke.py.
extern "C" int chol_downdate_barrier_probe(int steps, void* sync,
                                           void* stream) {
  int blocks = 0;
  cudaError_t err = grid_for(barrier_probe, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&sync, &steps};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(barrier_probe), dim3(blocks), dim3(NT),
      args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
