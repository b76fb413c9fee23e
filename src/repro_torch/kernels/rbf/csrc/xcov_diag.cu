// xcov_diag.cu — fused serving diag for the S-space GP methods, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rbf/xcov.py::
// xcov_diag_pallas (body _xcov_diag_kernel). For queries Xq (n, d) against
// the support set Xk (s, d), lengthscale-scaled:
//
//   K_US = sig2 * exp(-0.5 ||u - x_k||^2)                  (n, s)
//   mean = K_US alpha
//   var  = sig2 - ||K_US L1^{-T}||^2_row  (+ ||K_US L2^{-T}||^2_row)
//
// L1inv/L2inv are the lower-triangular inverses of the cached Cholesky
// factors (chol K_SS, chol Sdd), built by the wrapper outside the kernel.
//
// What bounds it on the card: the quadratic form, about 2*n*s^2 flops (two
// factors, each half zero), against reading both inverses once,
// 2*s^2*itemsize bytes. At the serving shapes (s = 2048, f32, n >= 64) the
// flops dominate: n = 256 is 2.1 GFLOP, 32 us at 67 TFLOP/s, against 10 us
// for the 33.5 MB of inverses.
//
// What the design does about it:
//  * The TPU kernel kept both inverses resident in VMEM and capped s at
//    1024. Here nothing is resident: a block owns BQ query rows and one
//    column panel j (BJ = 64 columns) of V = K_US L^{-T}, and streams the
//    L^{-1} tiles of that panel from device memory (L2-resident across the
//    query tiles at s = 2048), so any s works.
//  * L^{-1} is lower-triangular, so panel j only visits the k-panels with
//    k <= j: half the flops and half the bytes of a dense product.
//  * The (BQ, BK) K_US tile is recomputed from Xq/Xk for every k-panel (3d
//    FMAs and one exp per entry, about a tenth of the panel's FMAs) instead
//    of staging the whole (BQ, s) row block, which would cap s by shared
//    memory again. V1 and V2 share each tile.
//  * The grid is (panels, query tiles): at n = 256, s = 2048 that is
//    32 x 8 = 256 blocks for 132 SMs. Each block writes its panel's partial
//    sums; a second small kernel adds them in a fixed order, so the result
//    is deterministic (no atomics).
//  * float64 inputs accumulate in float64 on the FP64 units (the 1e-10
//    parity gate); float32 in float32.
// The FMA loops run from shared memory on the CUDA cores; moving them onto
// the tensor cores (wgmma) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int BJ = 64;    // columns of V per panel (one block)
constexpr int BK = 32;    // support points per k-panel
constexpr int NT = 256;   // threads per block

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

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
        val = s2 * exp_t(T(-0.5) * (d2 > T(0) ? d2 : T(0)));
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

template <typename T, int BQ, bool WITH_L2>
void launch_panels(const void* xq, const void* xk, const void* l1inv,
                   const void* l2inv, const void* alpha, const void* sig2,
                   void* part, int n, int s, int d, cudaStream_t stream) {
  const dim3 grid((s + BJ - 1) / BJ, (n + BQ - 1) / BQ);
  xcov_panel_kernel<T, BQ, WITH_L2><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(xq), static_cast<const T*>(xk),
      static_cast<const T*>(l1inv), static_cast<const T*>(l2inv),
      static_cast<const T*>(alpha), static_cast<const T*>(sig2),
      static_cast<T*>(part), n, s, d);
}

template <typename T, bool WITH_L2>
bool launch_tile(int block_q, const void* xq, const void* xk,
                 const void* l1inv, const void* l2inv, const void* alpha,
                 const void* sig2, void* part, int n, int s, int d,
                 cudaStream_t stream) {
  switch (block_q) {
    case 8:
      launch_panels<T, 8, WITH_L2>(xq, xk, l1inv, l2inv, alpha, sig2,
                                        part, n, s, d, stream);
      return true;
    case 16:
      launch_panels<T, 16, WITH_L2>(xq, xk, l1inv, l2inv, alpha, sig2,
                                         part, n, s, d, stream);
      return true;
    case 32:
      launch_panels<T, 32, WITH_L2>(xq, xk, l1inv, l2inv, alpha, sig2,
                                         part, n, s, d, stream);
      return true;
    default:
      return false;
  }
}

template <typename T>
int launch(int block_q, int with_l2, const void* xq, const void* xk,
           const void* l1inv, const void* l2inv, const void* alpha,
           const void* sig2, void* part, void* mean, void* var, int n, int s,
           int d, cudaStream_t stream) {
  const bool ok =
      with_l2 ? launch_tile<T, true>(block_q, xq, xk, l1inv, l2inv,
                                          alpha, sig2, part, n, s, d, stream)
              : launch_tile<T, false>(block_q, xq, xk, l1inv, l2inv,
                                           alpha, sig2, part, n, s, d, stream);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_panels = (s + BJ - 1) / BJ;
  xcov_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(part), static_cast<const T*>(sig2),
      static_cast<T*>(mean), static_cast<T*>(var), n, n_panels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64, for every input, output, sig2 and the
// scratch part (the accumulation type is the input type). block_q is 8, 16
// or 32. Xq (n, d), Xk (s, d), L1inv/L2inv (s, s) and
// alpha (s,) are contiguous; part is scratch of 3 * ceil(s/64) * n values; mean and var are (n,). L2inv is ignored when with_l2
// is 0. Returns cudaGetLastError() of the launches (two kernels).
extern "C" int xcov_diag(int dtype, int block_q, int with_l2, const void* xq,
                         const void* xk, const void* l1inv,
                         const void* l2inv, const void* alpha,
                         const void* sig2, void* part, void* mean, void* var,
                         int n, int s, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(block_q, with_l2, xq, xk, l1inv, l2inv, alpha,
                           sig2, part, mean, var, n, s, d, st);
    case 1:
      return launch<double>(block_q, with_l2, xq, xk, l1inv, l2inv, alpha,
                            sig2, part, mean, var, n, s, d, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
