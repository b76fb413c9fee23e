// ssd_intra_chunk_bwd.cu — backward of the Mamba-2 SSD intra-chunk block.
//
// The port's own kernel: the JAX package defines no backward for
// src/repro/kernels/ssd/ssd.py:57 (ssd_intra_chunk); its training tests
// differentiate the jnp reference. For every (batch*chunk b, head h) the
// forward (ssd_intra_chunk.cu) computes
//   cum = cumsum(dA),  L_ij = exp(cum_i - cum_j) (j <= i),  G = C B^T,
//   Y_i = sum_j G_ij L_ij xdt_j,  S = sum_j w_j xdt_j B_j^T,
//   w_j = exp(cum_end - cum_j).
// Given dY, dS and dcum this kernel returns
//   dxdt_j = sum_{i >= j} G_ij L_ij dY_i + w_j dS B_j,
//   dG_ij  = sum_h L_hij (dY_ih . xdt_jh)                    (j <= i),
//   dC     = dG B,  dB = dG^T C + sum_h w_hj dS_h^T xdt_jh,
//   dcum_i = dcum_i + sum_j M_ij - sum_k M_ki - w_i dw_i
//            + [i = end] sum_j w_j dw_j,
//     with M_ij = G_ij L_ij (dY_i . xdt_j), dw_j = xdt_j . (dS B_j),
//   ddA    = the reverse cumsum of dcum.
// cum and L are recomputed (one warp scans each head's dA as the forward
// does, with the same compensated sums); L is exp(cum_i - cum_j) per
// element, never a product of exps.
//
// Three kernels, in order on one stream, all float32 on the CUDA cores:
//  1. gram: G = C B^T, the causal tiles, into scratch (BC, cs, cs);
//  2. heads: a block owns (b, a group of heads) and, head by head, forms
//     the M tiles (their row and column sums go to dcum), adds L o E into
//     its group's dG partial, forms xdt_h dS_h (into its group's dB
//     partial and dw), then dxdt_h as one product over K = cs + N, and
//     scans dcum into ddA;
//  3. combine: dC and dB tiles from the groups' partials, summed in group
//     order.
// dB and dC sum over heads without atomics: each group writes its own
// partial, each element has one writer, and the combine adds the groups
// in a fixed order, so two launches on the same inputs give the same bits.
// Every product is one 64 x 64 output tile a 256-thread block (4 x 4 a
// thread), staged through shared memory 16 steps of K at a time.
//
// What bounds it: at mamba2-130m's prefill shape (BC = 64, cs = 256,
// H = 24, P = 64, N = 128) the function needs G's causal half, E's and the
// dxdt product's causal halves per head, xdt dS and dS B per head, and
// dC, dB over the causal half: 27.4 GFLOP; its bytes (xdt, dA, B, C, dY,
// dS, dcum read, dxdt, ddA, dB, dC written, 391 MB) take 0.117 ms at
// 3.35 TB/s. On the tensor cores in 3xTF32 (as the forward) the operations
// take 0.166 ms, on the f32 CUDA cores 0.41 ms. This first version runs on the
// CUDA cores with whole tiles on the diagonal; a tensor-core redesign is
// later work (ROADMAP.md).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int TT = 64;        // output tile
constexpr int TK = 16;        // K step
constexpr int SLD = TT + 4;   // shared row stride (16-byte aligned rows)

struct Args {
  const float *xdt, *dA, *Bm, *Cm, *dY, *dS, *dcum;
  float *dxdt, *ddA, *dB, *dC;
  float *G, *dGp, *dBp;   // scratch: (BC, cs, cs), (BC, NG, cs, cs),
                          // (BC, NG, cs, N)
  int BC, cs, H, P, N, hpg, ng;
};

// acc (4 x 4 a thread; rows 4 ty + r, columns 4 tx + c of the tile) =
// sum over k in [k_begin, K) of fa(row, k) fb(k, col), row and col local
// to the tile. fa / fb return 0 outside the operands.
template <class FA, class FB>
__device__ __forceinline__ void tile_mm(float (&acc)[4][4], int k_begin,
                                        int K, FA fa, FB fb, float* sA,
                                        float* sB) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int k0 = k_begin; k0 < K; k0 += TK) {
    for (int e = tid; e < TT * TK; e += THREADS) {
      const int i = e / TK, kk = e % TK;
      sA[kk * SLD + i] = k0 + kk < K ? fa(i, k0 + kk) : 0.f;
      const int kb = e / TT, j = e % TT;
      sB[kb * SLD + j] = k0 + kb < K ? fb(k0 + kb, j) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(sA + kk * SLD + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(sB + kk * SLD + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
}

// cum = cumsum(row[0..cs)) by warp 0, as ssd_intra_chunk.cu's warp_scan
// rounds it: lane l sums its stretch of ceil(cs / 32) values with Kahan
// compensation, the lanes scan those sums, then each lane runs through its
// stretch again from its offset.
__device__ void warp_cumsum(const float* row, float* cum, int cs) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, per = (cs + 31) / 32;
  const int i0 = min(lane * per, cs), i1 = min(i0 + per, cs);
  float local = 0.f, lost = 0.f;
  for (int i = i0; i < i1; ++i) {
    const float y = row[i] - lost, sum = local + y;
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
    const float y = row[i] - lost, sum = run + y;
    lost = (sum - run) - y;
    run = sum;
    cum[i] = run;
  }
}

// ---- 1. G = C B^T, tiles with a causal part ----
__global__ void __launch_bounds__(THREADS) ssd_bwd_gram(Args a) {
  __shared__ __align__(16) float sA[TK * SLD], sB[TK * SLD];
  const int i0 = blockIdx.y * TT, j0 = blockIdx.x * TT, b = blockIdx.z;
  if (j0 > i0 + TT - 1) return;   // nothing below the diagonal
  const float* C = a.Cm + static_cast<long long>(b) * a.cs * a.N;
  const float* B = a.Bm + static_cast<long long>(b) * a.cs * a.N;
  const int cs = a.cs, N = a.N;
  float acc[4][4];
  tile_mm(
      acc, 0, N,
      [&](int i, int k) { return i0 + i < cs ? C[(i0 + i) * N + k] : 0.f; },
      [&](int k, int j) { return j0 + j < cs ? B[(j0 + j) * N + k] : 0.f; },
      sA, sB);
  float* G = a.G + static_cast<long long>(b) * cs * cs;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + 4 * ty + r, j = j0 + 4 * tx + c;
      if (i < cs && j < cs) G[i * cs + j] = acc[r][c];
    }
}

// Sum of v over the 16 threads of a tile row (consecutive lanes), in a
// fixed order; every one of them gets it.
__device__ __forceinline__ float row16(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- 2. per (b, head group): dG and dB partials, dxdt, ddA ----
__global__ void __launch_bounds__(THREADS) ssd_bwd_heads(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* sA = sm;                   // TK x SLD
  float* sB = sA + TK * SLD;        // TK x SLD
  float* part = sB + TK * SLD;      // 16 x TT column partials
  float* cum = part + 16 * TT;      // cs
  float* w = cum + a.cs;            // cs: exp(cum_end - cum_j)
  float* rowM = w + a.cs;           // cs: sum_j M_ij
  float* colM = rowM + a.cs;        // cs: sum_i M_ij
  float* dw = colM + a.cs;          // cs: xdt_j . (dS B_j)
  float* dcs = dw + a.cs;           // cs: the final dcum

  const int b = blockIdx.y, grp = blockIdx.x;
  const int cs = a.cs, H = a.H, P = a.P, N = a.N;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long bcs = static_cast<long long>(b) * cs;
  const float* G = a.G + bcs * cs;
  const float* Bm = a.Bm + bcs * N;
  float* dGp = a.dGp + (static_cast<long long>(b) * a.ng + grp) * cs * cs;
  float* dBp = a.dBp + (static_cast<long long>(b) * a.ng + grp) * cs * N;
  const int nt = (cs + TT - 1) / TT;

  for (int h = grp * a.hpg; h < min(H, (grp + 1) * a.hpg); ++h) {
    const long long bh = static_cast<long long>(b) * H + h;
    // x(j, p) of head h in a (BC, cs, H, P) array
    auto at = [&](const float* base, int j, int p) {
      return base[((bcs + j) * H + h) * P + p];
    };
    const float* dS = a.dS + bh * P * N;      // (P, N)
    warp_cumsum(a.dA + bh * cs, cum, cs);
    __syncthreads();
    for (int i = tid; i < cs; i += THREADS) {
      w[i] = expf(cum[cs - 1] - cum[i]);
      rowM[i] = colM[i] = dw[i] = 0.f;
    }
    __syncthreads();

    // M and L o E over the causal tiles: E = dY_h xdt_h^T (K = P)
    for (int it = 0; it < nt; ++it)
      for (int jt = 0; jt <= it; ++jt) {
        const int i0 = it * TT, j0 = jt * TT;
        float acc[4][4];
        tile_mm(
            acc, 0, P,
            [&](int i, int k) {
              return i0 + i < cs ? at(a.dY, i0 + i, k) : 0.f;
            },
            [&](int k, int j) {
              return j0 + j < cs ? at(a.xdt, j0 + j, k) : 0.f;
            },
            sA, sB);
        float rs[4] = {0.f, 0.f, 0.f, 0.f}, cl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = i0 + 4 * ty + r, j = j0 + 4 * tx + c;
            if (i < cs && j <= i) {
              const float t = expf(cum[i] - cum[j]) * acc[r][c];
              dGp[i * cs + j] += t;
              const float m = G[i * cs + j] * t;
              rs[r] += m;
              cl[c] += m;
            }
          }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = row16(rs[r]);
          const int i = i0 + 4 * ty + r;
          if (tx == 0 && i < cs) rowM[i] += v;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) part[ty * TT + 4 * tx + c] = cl[c];
        __syncthreads();
        if (tid < TT && j0 + tid < cs) {
          float v = 0.f;
          for (int y = 0; y < 16; ++y) v += part[y * TT + tid];
          colM[j0 + tid] += v;
        }
        __syncthreads();
      }

    // U = xdt_h dS_h (cs x N, K = P): w_j U_j into dB's partial,
    // dw_j = B_j . U_j
    for (int jt = 0; jt < nt; ++jt)
      for (int n0 = 0; n0 < N; n0 += TT) {
        const int j0 = jt * TT;
        float acc[4][4];
        tile_mm(
            acc, 0, P,
            [&](int j, int k) {
              return j0 + j < cs ? at(a.xdt, j0 + j, k) : 0.f;
            },
            [&](int k, int n) { return n0 + n < N ? dS[k * N + n0 + n] : 0.f; },
            sA, sB);
        float rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + 4 * ty + r, n = n0 + 4 * tx + c;
            if (j < cs && n < N) {
              dBp[j * N + n] += w[j] * acc[r][c];
              rs[r] += Bm[j * N + n] * acc[r][c];
            }
          }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = row16(rs[r]);
          const int j = j0 + 4 * ty + r;
          if (tx == 0 && j < cs) dw[j] += v;
        }
        __syncthreads();
      }

    // dxdt_h = (G o L_h)^T dY_h + diag(w) B dS_h^T: one product over
    // K = cs + N, from row j0 of the first part (k < j is masked)
    for (int jt = 0; jt < nt; ++jt)
      for (int p0 = 0; p0 < P; p0 += TT) {
        const int j0 = jt * TT;
        float acc[4][4];
        tile_mm(
            acc, j0, cs + N,
            [&](int j, int k) {
              const int jj = j0 + j;
              if (jj >= cs) return 0.f;
              if (k < cs)
                return k >= jj ? G[k * cs + jj] * expf(cum[k] - cum[jj]) : 0.f;
              return w[jj] * Bm[jj * N + (k - cs)];
            },
            [&](int k, int p) {
              if (p0 + p >= P) return 0.f;
              return k < cs ? at(a.dY, k, p0 + p) : dS[(p0 + p) * N + k - cs];
            },
            sA, sB);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + 4 * ty + r, p = p0 + 4 * tx + c;
            if (j < cs && p < P)
              a.dxdt[((bcs + j) * H + h) * P + p] = acc[r][c];
          }
      }
    __syncthreads();

    // dcum, then ddA = its reverse cumsum (warp 0, fixed order)
    for (int i = tid; i < cs; i += THREADS)
      dcs[i] = a.dcum[bh * cs + i] + rowM[i] - colM[i] - w[i] * dw[i];
    __syncthreads();
    if (tid < 32) {
      float s = 0.f;
      for (int j = tid; j < cs; j += 32) s += w[j] * dw[j];
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (tid == 0) dcs[cs - 1] += s;
      // reverse scan: segments from the end
      const int seg = (cs + 31) / 32;
      const int hi = cs - min(tid * seg, cs), lo = max(hi - seg, 0);
      float run = 0.f;
      __syncwarp();
      for (int i = hi - 1; i >= lo; --i) {
        run += dcs[i];
        a.ddA[bh * cs + i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += y;
      }
      const float excl = incl - run;
      for (int i = lo; i < hi; ++i) a.ddA[bh * cs + i] += excl;
    }
    __syncthreads();
  }
}

// ---- 3. dC = dG B and dB = dG^T C + sum of the groups' partials ----
__global__ void __launch_bounds__(THREADS) ssd_bwd_combine(Args a) {
  __shared__ __align__(16) float sA[TK * SLD], sB[TK * SLD];
  const int r0 = blockIdx.y * TT, n0 = blockIdx.x * TT, b = blockIdx.z;
  const int cs = a.cs, N = a.N, ng = a.ng;
  const long long bcs = static_cast<long long>(b) * cs;
  const float* dGp = a.dGp + static_cast<long long>(b) * ng * cs * cs;
  const float* dBp = a.dBp + static_cast<long long>(b) * ng * cs * N;
  const float* Bm = a.Bm + bcs * N;
  const float* Cm = a.Cm + bcs * N;
  const long long gstride = static_cast<long long>(cs) * cs;
  auto dG = [&](int i, int j) {   // sum over the groups, in order
    float s = 0.f;
    for (int g = 0; g < ng; ++g) s += dGp[g * gstride + i * cs + j];
    return s;
  };
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4];
  // dC rows r0..: sum over j <= i of dG_ij B_j
  tile_mm(
      acc, 0, min(cs, r0 + TT),
      [&](int i, int k) {
        return (r0 + i < cs && k <= r0 + i) ? dG(r0 + i, k) : 0.f;
      },
      [&](int k, int n) { return n0 + n < N ? Bm[k * N + n0 + n] : 0.f; },
      sA, sB);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = r0 + 4 * ty + r, n = n0 + 4 * tx + c;
      if (i < cs && n < N) a.dC[(bcs + i) * N + n] = acc[r][c];
    }
  // dB rows r0..: sum over i >= j of dG_ij C_i, plus the partials
  tile_mm(
      acc, r0, cs,
      [&](int j, int k) {
        return (r0 + j < cs && k >= r0 + j) ? dG(k, r0 + j) : 0.f;
      },
      [&](int k, int n) { return n0 + n < N ? Cm[k * N + n0 + n] : 0.f; },
      sA, sB);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = r0 + 4 * ty + r, n = n0 + 4 * tx + c;
      if (j < cs && n < N) {
        float s = acc[r][c];
        for (int g = 0; g < ng; ++g)
          s += dBp[static_cast<long long>(g) * cs * N + j * N + n];
        a.dB[(bcs + j) * N + n] = s;
      }
    }
}

}  // namespace

// All float32, contiguous: xdt, dY, dxdt (BC, cs, H, P); dA, dcum, ddA
// (BC, H, cs); Bm, Cm, dB, dC (BC, cs, N); dS (BC, H, P, N). Scratch G
// (BC, cs, cs) any contents; dGp (BC, ng, cs, cs) and dBp (BC, ng, cs, N)
// zero on entry. Heads go in ng groups of hpg (ng = ceil(H / hpg)).
// Returns the first CUDA error of the three launches, or 0.
extern "C" int ssd_intra_chunk_bwd(const float* xdt, const float* dA,
                                   const float* Bm, const float* Cm,
                                   const float* dY, const float* dS,
                                   const float* dcum, float* dxdt, float* ddA,
                                   float* dB, float* dC, float* G, float* dGp,
                                   float* dBp, int BC, int cs, int H, int P,
                                   int N, int hpg, void* stream) {
  if (BC < 1 || BC > 65535 || cs < 1 || cs > 1024 || H < 1 || P < 1 ||
      N < 1 || hpg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ng = (H + hpg - 1) / hpg;
  Args a{xdt, dA, Bm, Cm, dY, dS, dcum, dxdt, ddA, dB, dC, G, dGp, dBp,
         BC, cs, H, P, N, hpg, ng};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (cs + TT - 1) / TT;
  ssd_bwd_gram<<<dim3(nt, nt, BC), THREADS, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = (2 * TK * SLD + 16 * TT + 6 * cs) * sizeof(float);
  e = cudaFuncSetAttribute(ssd_bwd_heads,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_heads<<<dim3(ng, BC), THREADS, smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_combine<<<dim3((N + TT - 1) / TT, nt, BC), THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
