// rbf.cu — fused pairwise squared distance + exp (SE covariance) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rbf/rbf.py::rbf_pallas
// (body _rbf_kernel): out[i, j] = sig2 * exp(-0.5 * max(|q_i|^2 + |k_j|^2
// - 2 q_i.k_j, 0)) over lengthscale-scaled inputs, f32 accumulation for
// every input type, output in the input type.
//
// What bounds it on the card: each output costs about 2d+6 flops (d = 5 for
// AIMPEAK, 21 for SARCOS) against 4 bytes written (f32), so the kernel is
// bound by writing the n x m output to device memory: n*m*itemsize / HBM
// bandwidth. The inputs are (n+m)*d values and do not matter.
//
// What the design does about it:
//  * one block per 64 x 128 output tile, 256 threads, 8 x 4 outputs each;
//  * the Xq/Xk tiles are staged in shared memory in chunks of 8 features;
//    the squared norms are computed once per row of the tile;
//  * the cross term is an FMA loop over d in registers: d is far too small
//    a reduction depth for the tensor cores;
//  * the exp is the epilogue, and each warp stores 32 consecutive columns of
//    one row, so every store is one coalesced 128-byte transaction (f32);
//  * the feature axis is NOT padded to 128 as on the TPU: zero-filled chunk
//    entries add nothing, and ragged rows/columns are masked at the store;
//  * a leading batch dimension with a per-operand batch stride (0 for a
//    broadcast operand) builds K_{S,D_m} for all M machines in one launch,
//    as vmap over pallas_call did.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;           // output rows per block
constexpr int BN = 128;          // output columns per block
constexpr int TX = 32;           // threads along columns (one warp)
constexpr int TY = 8;            // threads along rows
constexpr int RM = BM / TY;      // rows per thread
constexpr int RN = BN / TX;      // columns per thread
constexpr int DK = 8;            // features staged per chunk

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
           int d, long long q_bstride, long long k_bstride) {
  __shared__ float qs[DK][BM];
  __shared__ float ks[DK][BN];
  __shared__ float q2s[BM];
  __shared__ float k2s[BN];

  const long long b = blockIdx.z;
  xq += b * q_bstride;
  xk += b * k_bstride;
  out += b * static_cast<long long>(n) * m;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;

  // squared norms, once per row (threads 0..BM-1) / column (BM..BM+BN-1)
  if (tid < BM) {
    const int r = row0 + tid;
    float acc = 0.f;
    if (r < n) {
      for (int t = 0; t < d; ++t) {
        const float v = to_f32(xq[static_cast<long long>(r) * d + t]);
        acc = fmaf(v, v, acc);
      }
    }
    q2s[tid] = acc;
  } else if (tid < BM + BN) {
    const int c = col0 + tid - BM;
    float acc = 0.f;
    if (c < m) {
      for (int t = 0; t < d; ++t) {
        const float v = to_f32(xk[static_cast<long long>(c) * d + t]);
        acc = fmaf(v, v, acc);
      }
    }
    k2s[tid - BM] = acc;
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
      float a[RM], bk[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = qs[t][ty + TY * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) bk[j] = ks[t][tx + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) cross[i][j] = fmaf(a[i], bk[j], cross[i][j]);
    }
    __syncthreads();
  }

  const float s2 = sig2[0];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + TY * i;
    const int gr = row0 + r;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = tx + TX * j;
      const int gc = col0 + c;
      if (gc < m) {
        const float d2 = fmaxf(q2s[r] + k2s[c] - 2.f * cross[i][j], 0.f);
        out[static_cast<long long>(gr) * m + gc] =
            from_f32<T>(s2 * expf(-0.5f * d2));
      }
    }
  }
}

template <typename T>
void launch(const void* xq, const void* xk, const void* sig2, void* out,
            int batch, int n, int m, int d, long long q_bstride,
            long long k_bstride, cudaStream_t stream) {
  const dim3 block(TX, TY);
  const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM, batch);
  rbf_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(xq), static_cast<const T*>(xk),
      static_cast<const float*>(sig2), static_cast<T*>(out), n, m, d,
      q_bstride, k_bstride);
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

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
