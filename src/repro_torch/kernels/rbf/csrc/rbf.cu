// rbf.cu — fused pairwise squared distance + exp (SE covariance) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rbf/rbf.py::rbf_pallas
// (body _rbf_kernel): out[i, j] = sig2 * exp(-0.5 * max(|q_i|^2 + |k_j|^2
// - 2 q_i.k_j, 0)) over lengthscale-scaled inputs, f32 accumulation for
// every input type, output in the input type. These are the covariance
// blocks (K_SS, K_{S,D_m}, K_{D_m,D_m}, K_US); the ICF pivot columns of
// select_support run inside rbf_icf.cu.
//
// What bounds it on the card: each output costs about 2d+6 flops (d = 5 for
// AIMPEAK, 21 for SARCOS) against 4 bytes written (f32), so the kernel is
// bound by writing the n x m output to device memory: n*m*itemsize / HBM
// bandwidth. The inputs are (n+m)*d values and do not matter.
//
// What the design does about it:
//  * one block per 64 x 128 output tile, 256 threads, 8 rows x 4
//    consecutive columns each;
//  * the Xq/Xk tiles are staged in shared memory in chunks of 8 features
//    (Xk read back as float4, a thread's 4 columns at once); the squared
//    norms are computed once per row of the tile;
//  * the cross term is an FMA loop over d in registers: d is far too small
//    a reduction depth for the tensor cores;
//  * the epilogue is one exp2 an output: sig2 and both norms fold into
//    a_i = log2(sig2) - log2(e)/2 |q_i|^2 and b_j = -log2(e)/2 |k_j|^2, so
//    out = exp2(min(a_i + b_j + log2(e) q_i.k_j, log2(sig2))), the min
//    keeping the clamp of the squared distance at 0 (ex2.approx: relative
//    error ~2^-22, within the float32 tolerance of 1e-5);
//  * each thread writes its 4 columns of a row as one vector store (16
//    bytes in f32), a warp 512 contiguous bytes of one row; rows that are
//    not 16-byte aligned (m % 4 != 0) and ragged column tiles store
//    element by element;
//  * the feature axis is NOT padded to 128 as on the TPU: zero-filled chunk
//    entries add nothing, and ragged rows/columns are masked at the store;
//  * a leading batch dimension with a per-operand batch stride (0 for a
//    broadcast operand) builds K_{S,D_m} for all M machines in one launch,
//    as vmap over pallas_call did.
//
// The exact instance (rbf_covariance_exact, float32 and float64) computes
// the same function in the input type throughout, with the arithmetic of
// rbf_icf.cu's pivot column: fma norms and cross term, max, exp. It builds
// the pivot column K(x_p, D_m) of the collective ICF loop
// (core/picf.py icf_factor_local), so that a float64 loop over processes
// picks the ICF kernel's pivots. One thread an output; a column is (1, b).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;           // output rows per block
constexpr int BN = 128;          // output columns per block
constexpr int TX = 32;           // threads along columns (one warp)
constexpr int TY = 8;            // threads along rows
constexpr int RM = BM / TY;      // rows per thread
constexpr int RN = BN / TX;      // columns per thread
constexpr int DK = 8;            // features staged per chunk
constexpr float L2E = 1.4426950408889634f;   // log2(e)

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a thread's 4 consecutive outputs of one row as one vector store
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const float (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(double x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ double from_f32<double>(float x) {
  return static_cast<double>(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(TX * TY)
rbf_kernel(const T* __restrict__ xq, const T* __restrict__ xk,
           const float* __restrict__ sig2, T* __restrict__ out, int n, int m,
           int d, long long q_bstride, long long k_bstride, bool vec) {
  __shared__ float qs[DK][BM];
  __shared__ __align__(16) float ks[DK][BN];
  __shared__ float alpha[BM];     // log2(sig2) - log2(e)/2 |q_i|^2
  __shared__ float beta[BN];      // -log2(e)/2 |k_j|^2

  const long long b = blockIdx.z;
  xq += b * q_bstride;
  xk += b * k_bstride;
  out += b * static_cast<long long>(n) * m;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;

  // exponent terms a_i (with log2 sig2) and b_j, once per row (threads
  // 0..BM-1) / column (BM..BM+BN-1)
  const float l2s2 = log2f(sig2[0]);
  if (tid < BM) {
    const int r = row0 + tid;
    float acc = 0.f;
    if (r < n) {
      for (int t = 0; t < d; ++t) {
        const float v = to_f32(xq[static_cast<long long>(r) * d + t]);
        acc = fmaf(v, v, acc);
      }
    }
    alpha[tid] = fmaf(-0.5f * L2E, acc, l2s2);
  } else if (tid < BM + BN) {
    const int c = col0 + tid - BM;
    float acc = 0.f;
    if (c < m) {
      for (int t = 0; t < d; ++t) {
        const float v = to_f32(xk[static_cast<long long>(c) * d + t]);
        acc = fmaf(v, v, acc);
      }
    }
    beta[tid - BM] = -0.5f * L2E * acc;
  }

  float cross[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) cross[i][j] = 0.f;

  for (int t0 = 0; t0 < d; t0 += DK) {
    for (int e = tid; e < BM * DK; e += TX * TY) {
      const int r = e / DK, t = e % DK;
      const int gr = row0 + r, gt = t0 + t;
      qs[t][r] = (gr < n && gt < d)
                     ? to_f32(xq[static_cast<long long>(gr) * d + gt])
                     : 0.f;
    }
    for (int e = tid; e < BN * DK; e += TX * TY) {
      const int c = e / DK, t = e % DK;
      const int gc = col0 + c, gt = t0 + t;
      ks[t][c] = (gc < m && gt < d)
                     ? to_f32(xk[static_cast<long long>(gc) * d + gt])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < DK; ++t) {
      float a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = qs[t][ty + TY * i];
      const float4 b4 = *reinterpret_cast<const float4*>(&ks[t][RN * tx]);
      const float bk[RN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) cross[i][j] = fmaf(a[i], bk[j], cross[i][j]);
    }
    __syncthreads();
  }

  const int c0 = RN * tx;           // the thread's first column in the tile
  float bj[RN];
#pragma unroll
  for (int j = 0; j < RN; ++j) bj[j] = beta[c0 + j];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + TY * i;
    const int gr = row0 + r;
    if (gr >= n) continue;
    float o[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j)
      o[j] = ex2(fminf(fmaf(L2E, cross[i][j], alpha[r] + bj[j]), l2s2));
    T* row = out + static_cast<long long>(gr) * m + col0 + c0;
    if (vec && col0 + c0 < m) {
      store4(row, o);
    } else {
#pragma unroll
      for (int j = 0; j < RN; ++j)
        if (col0 + c0 + j < m) row[j] = from_f32<T>(o[j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
rbf_exact_kernel(const T* __restrict__ xq, const T* __restrict__ xk,
                 const T* __restrict__ sig2, T* __restrict__ out, int batch,
                 int n, int m, int d, long long q_bstride,
                 long long k_bstride) {
  const long long total = static_cast<long long>(batch) * n * m;
  const T s2 = sig2[0];
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = e / (static_cast<long long>(n) * m);
    const int r = static_cast<int>((e / m) % n);
    const int c = static_cast<int>(e % m);
    const T* q = xq + b * q_bstride + static_cast<long long>(r) * d;
    const T* k = xk + b * k_bstride + static_cast<long long>(c) * d;
    T q2 = 0, k2 = 0, cross = 0;
    for (int t = 0; t < d; ++t) q2 = fma(q[t], q[t], q2);
    for (int t = 0; t < d; ++t) k2 = fma(k[t], k[t], k2);
    for (int t = 0; t < d; ++t) cross = fma(q[t], k[t], cross);
    const T d2 = max(q2 + k2 - T(2) * cross, T(0));
    out[e] = s2 * exp(T(-0.5) * d2);
  }
}

template <typename T>
void launch_exact(const void* xq, const void* xk, const void* sig2,
                  void* out, int batch, int n, int m, int d,
                  long long q_bstride, long long k_bstride,
                  cudaStream_t stream) {
  const long long total = static_cast<long long>(batch) * n * m;
  const int blocks = static_cast<int>(
      total / 256 + 1 < 65536 ? total / 256 + 1 : 65536);
  rbf_exact_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(xq), static_cast<const T*>(xk),
      static_cast<const T*>(sig2), static_cast<T*>(out), batch, n, m, d,
      q_bstride, k_bstride);
}

template <typename T>
void launch(const void* xq, const void* xk, const void* sig2, void* out,
            int batch, int n, int m, int d, long long q_bstride,
            long long k_bstride, cudaStream_t stream) {
  const dim3 block(TX, TY);
  const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM, batch);
  // whole rows of 4-output vectors: m % 4 == 0 and an aligned base
  const bool vec = m % RN == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (RN * sizeof(T)) == 0;
  rbf_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(xq), static_cast<const T*>(xk),
      static_cast<const float*>(sig2), static_cast<T*>(out), n, m, d,
      q_bstride, k_bstride, vec);
}

}  // namespace

// dtype: 0 = float32, 1 = float64, 2 = bfloat16. Xq is (batch, n, d) and Xk
// (batch, m, d), row-major, with the given batch strides in elements (0 for
// an operand shared by every batch entry); out is (batch, n, m) contiguous;
// sig2 is one float32 in device memory. Returns cudaGetLastError().
extern "C" int rbf_covariance(int dtype, const void* xq, const void* xk,
                              const void* sig2, void* out, int batch, int n,
                              int m, int d, long long q_bstride,
                              long long k_bstride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(xq, xk, sig2, out, batch, n, m, d, q_bstride, k_bstride, s);
      break;
    case 1:
      launch<double>(xq, xk, sig2, out, batch, n, m, d, q_bstride, k_bstride,
                     s);
      break;
    case 2:
      launch<__nv_bfloat16>(xq, xk, sig2, out, batch, n, m, d, q_bstride,
                            k_bstride, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The exact instance: dtype 0 = float32, 1 = float64, computed in that
// type; sig2 is one value of the same type in device memory. Otherwise as
// rbf_covariance.
extern "C" int rbf_covariance_exact(int dtype, const void* xq,
                                    const void* xk, const void* sig2,
                                    void* out, int batch, int n, int m,
                                    int d, long long q_bstride,
                                    long long k_bstride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch_exact<float>(xq, xk, sig2, out, batch, n, m, d, q_bstride,
                          k_bstride, s);
      break;
    case 1:
      launch_exact<double>(xq, xk, sig2, out, batch, n, m, d, q_bstride,
                           k_bstride, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
