// ssd_intra_chunk.cu — Mamba-2 SSD intra-chunk block for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/ssd.py:57
// (ssd_intra_chunk, body _ssd_kernel). For every (batch*chunk bc, head h):
//   cum = cumsum(dA)                                  (cs,)
//   L[i, j] = exp(cum[i] - cum[j]) for j <= i, else 0 (cs, cs)
//   Y = (C B^T o L) xdt                               (cs, P)
//   S = xdt^T (B o exp(cum[-1] - cum))                (P, N)
// Inputs float32 or bfloat16, cast to float32; Y, S and cum are float32.
//
// What bounds it on the card: at the mamba2-130m prefill shape (BC = 64,
// cs = 256, H = 24, P = 64, N = 128) the function's work is
// 2 BC N cs (cs + 1) / 2 for the causal half of G = C B^T (which does
// not depend on h; L zeroes the rest), 2 BC H P cs (cs + 1) / 2 for the
// causal Y product and 2 BC H P N cs for S: 13.4 GFLOP in float32
// against 0.27 GB read and written, ~50 flops per byte, above the ~20 flops/byte where the f32 CUDA cores (67 TFLOP/s)
// overtake HBM (3.35 TB/s). It is bound by float32 operations.
//
// What the design does about it:
//  * the TPU kernel keeps the whole cs x cs tile of G o L in VMEM; at
//    cs = 256 in f32 that is 256 KB, more than the 227 KB a block may use.
//    Here one block of 256 threads owns one (bc, h), scans dA once (block
//    scan, shuffles), keeps cum in shared memory, and walks the chunk in
//    strips of 64 rows. For each strip it builds 64 x 64 tiles of G o L
//    from 16-wide slabs of C and B in shared memory and multiplies them
//    into the strip's 64 x 64 output at once: no tile larger than 17 KB.
//  * the decay mask is causal: a strip only visits the column tiles at or
//    left of its diagonal (10 of 16 tiles at cs = 256).
//  * every product is an FMA loop from shared memory with a 4 x 4 (Y, G)
//    or 4 x 8 (S) register tile per thread, in full float32: the
//    reference's tolerance (3e-4) leaves no room for TF32.
//  * G is recomputed for each head, as on the TPU (simple first): the
//    kernel does ~31 GFLOP at the mamba2 shape where the function needs
//    13.4. Sharing G across the H heads of a chunk is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ST = 64;       // strip rows
constexpr int JT = 64;       // columns of a G o L tile
constexpr int NK = 16;       // N slab of C/B per G step
constexpr int PT = 64;       // P columns per output tile
constexpr int SJ = 32;       // rows per S step
constexpr int SN = 128;      // N columns per S tile
constexpr int MAXCS = 1024;
// shared memory (floats): cum, then either the Y phase's
// Cs[NK][ST+1], Bs[NK][JT+1], Gt[ST][JT+1], Xs[JT][PT] or the S phase's
// Xs2[SJ][PT], Bs2[SJ][SN]
constexpr int Y_FLOATS = NK * (ST + 1) + NK * (JT + 1) + ST * (JT + 1) +
                         JT * PT;
constexpr int S_FLOATS = SJ * PT + SJ * SN;
constexpr int WORK = Y_FLOATS > S_FLOATS ? Y_FLOATS : S_FLOATS;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// In-place inclusive scan of cum[0..cs) by the whole block.
__device__ void block_scan(float* cum, int cs, float* wsum) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per = (cs + THREADS - 1) / THREADS;
  const int i0 = tid * per;
  float local = 0.f;
  for (int i = i0; i < i0 + per && i < cs; ++i) local += cum[i];
  float inc = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    float w = lane < THREADS / 32 ? wsum[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < THREADS / 32) wsum[lane] = w;
  }
  __syncthreads();
  float run = inc - local + (warp > 0 ? wsum[warp - 1] : 0.f);
  for (int i = i0; i < i0 + per && i < cs; ++i) {
    run += cum[i];
    cum[i] = run;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ xdt, const T* __restrict__ dA,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           float* __restrict__ Y, float* __restrict__ S,
           float* __restrict__ cum_out, int cs, int H, int P, int N) {
  __shared__ float cum[MAXCS];
  __shared__ float wsum[THREADS / 32];
  __shared__ float work[WORK];
  float* Cs = work;                       // NK x (ST + 1)
  float* Bs = Cs + NK * (ST + 1);         // NK x (JT + 1)
  float* Gt = Bs + NK * (JT + 1);         // ST x (JT + 1)
  float* Xs = Gt + ST * (JT + 1);         // JT x PT
  float* Xs2 = work;                      // SJ x PT
  float* Bs2 = Xs2 + SJ * PT;             // SJ x SN

  const int h = blockIdx.x;
  const long long bc = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long row_base = bc * cs;     // first row of this chunk
  const long long HP = static_cast<long long>(H) * P;
  auto X = [&](int j, int p) -> float {
    return to_f32(xdt[(row_base + j) * HP + static_cast<long long>(h) * P +
                      p]);
  };

  // 1. cum = cumsum(dA[bc, h, :])
  const T* dA_row = dA + (bc * H + h) * cs;
  for (int i = tid; i < cs; i += THREADS) cum[i] = to_f32(dA_row[i]);
  __syncthreads();
  block_scan(cum, cs, wsum);
  float* cum_row = cum_out + (bc * H + h) * cs;
  for (int i = tid; i < cs; i += THREADS) cum_row[i] = cum[i];

  // 2. Y = (G o L) xdt, strip by strip
  for (int r0 = 0; r0 < cs; r0 += ST) {
    const int r_last = min(r0 + ST, cs) - 1;
    for (int p0 = 0; p0 < P; p0 += PT) {
      float yacc[4][4] = {};
      for (int j0 = 0; j0 <= r_last; j0 += JT) {
        float gacc[4][4] = {};
        for (int n0 = 0; n0 < N; n0 += NK) {
          __syncthreads();
          for (int e = tid; e < ST * NK; e += THREADS) {
            const int i = e / NK, n = e % NK;
            const bool okn = n0 + n < N;
            Cs[n * (ST + 1) + i] =
                (r0 + i < cs && okn)
                    ? to_f32(Cm[(row_base + r0 + i) * N + n0 + n]) : 0.f;
            Bs[n * (JT + 1) + i] =
                (j0 + i < cs && okn)
                    ? to_f32(Bm[(row_base + j0 + i) * N + n0 + n]) : 0.f;
          }
          __syncthreads();
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            float c[4], b[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) c[a] = Cs[n * (ST + 1) + ty + 16 * a];
#pragma unroll
            for (int q = 0; q < 4; ++q) b[q] = Bs[n * (JT + 1) + tx + 16 * q];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int q = 0; q < 4; ++q) gacc[a][q] = fmaf(c[a], b[q],
                                                            gacc[a][q]);
          }
        }
        // G o L into shared memory, with this column block of xdt
        __syncthreads();
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = r0 + ty + 16 * a;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tx + 16 * q;
            Gt[(ty + 16 * a) * (JT + 1) + tx + 16 * q] =
                (j <= i && i < cs) ? gacc[a][q] * expf(cum[i] - cum[j]) : 0.f;
          }
        }
        for (int e = tid; e < JT * PT; e += THREADS) {
          const int j = e / PT, p = e % PT;
          Xs[e] = (j0 + j < cs && p0 + p < P) ? X(j0 + j, p0 + p) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int j = 0; j < JT; ++j) {
          float g[4], x[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) g[a] = Gt[(ty + 16 * a) * (JT + 1) + j];
#pragma unroll
          for (int q = 0; q < 4; ++q) x[q] = Xs[j * PT + tx + 16 * q];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) yacc[a][q] = fmaf(g[a], x[q],
                                                          yacc[a][q]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = r0 + ty + 16 * a;
        if (i >= cs) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = p0 + tx + 16 * q;
          if (p < P)
            Y[(row_base + i) * HP + static_cast<long long>(h) * P + p] =
                yacc[a][q];
        }
      }
    }
  }

  // 3. S = xdt^T (B o exp(cum[-1] - cum))
  const float c_end = cum[cs - 1];
  float* S_bh = S + (bc * H + h) * static_cast<long long>(P) * N;
  for (int p0 = 0; p0 < P; p0 += PT) {
    for (int n0 = 0; n0 < N; n0 += SN) {
      float sacc[4][8] = {};
      for (int j0 = 0; j0 < cs; j0 += SJ) {
        __syncthreads();
        for (int e = tid; e < SJ * PT; e += THREADS) {
          const int j = e / PT, p = e % PT;
          Xs2[e] = (j0 + j < cs && p0 + p < P) ? X(j0 + j, p0 + p) : 0.f;
        }
        for (int e = tid; e < SJ * SN; e += THREADS) {
          const int j = e / SN, n = e % SN;
          Bs2[e] = (j0 + j < cs && n0 + n < N)
                       ? to_f32(Bm[(row_base + j0 + j) * N + n0 + n]) *
                             expf(c_end - cum[j0 + j])
                       : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < SJ; ++j) {
          float x[4], b[8];
#pragma unroll
          for (int a = 0; a < 4; ++a) x[a] = Xs2[j * PT + ty + 16 * a];
#pragma unroll
          for (int q = 0; q < 8; ++q) b[q] = Bs2[j * SN + tx + 16 * q];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 8; ++q) sacc[a][q] = fmaf(x[a], b[q],
                                                          sacc[a][q]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int p = p0 + ty + 16 * a;
        if (p >= P) continue;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int n = n0 + tx + 16 * q;
          if (n < N) S_bh[static_cast<long long>(p) * N + n] = sacc[a][q];
        }
      }
    }
  }
}

template <typename T>
void launch(const void* xdt, const void* dA, const void* Bm, const void* Cm,
            float* Y, float* S, float* cum, int BC, int cs, int H, int P,
            int N, cudaStream_t stream) {
  const dim3 grid(H, BC);
  ssd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(xdt), static_cast<const T*>(dA),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), Y, S, cum, cs, H,
      P, N);
}

}  // namespace

// dtype: 0 = float32, 2 = bfloat16, for all four inputs. xdt is
// (BC, cs, H, P), dA (BC, H, cs), Bm/Cm (BC, cs, N), all contiguous; Y
// (BC, cs, H, P), S (BC, H, P, N) and cum (BC, H, cs) are float32 and
// contiguous. Needs 1 <= cs <= 1024 and BC <= 65535. Returns
// cudaGetLastError().
extern "C" int ssd_intra_chunk(int dtype, const void* xdt, const void* dA,
                               const void* Bm, const void* Cm, void* Y,
                               void* S, void* cum, int BC, int cs, int H,
                               int P, int N, void* stream) {
  if (cs < 1 || cs > MAXCS || BC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* y = static_cast<float*>(Y);
  float* st = static_cast<float*>(S);
  float* c = static_cast<float*>(cum);
  switch (dtype) {
    case 0:
      launch<float>(xdt, dA, Bm, Cm, y, st, c, BC, cs, H, P, N, s);
      break;
    case 2:
      launch<__nv_bfloat16>(xdt, dA, Bm, Cm, y, st, c, BC, cs, H, P, N, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
