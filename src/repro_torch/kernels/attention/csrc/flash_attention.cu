// flash_attention.cu — forward flash attention (online softmax) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention/flash.py:79
// (flash_attention_flat, body _flash_kernel) together with the head
// broadcast and padding of src/repro/kernels/attention/ops.py:
//   out[b, h, i] = sum_j softmax_j(scale * q[b,h,i] . k[b,h/G,j]) v[b,h/G,j]
// over the keys j that the causal and/or sliding-window mask leaves to the
// query at absolute position i + q_offset. Running max, denominator and
// accumulator are float32; a row with no valid key returns 0
// (acc / max(l, 1e-30)), never NaN. Output in the input type.
//
// What bounds it on the card: at the prefill shape (B = 4, Hq = 16,
// Hkv = 8, T = 4096, D = 128, causal) it does 4*B*Hq*T*T*D/2 = 275 GFLOP
// on 0.2 GB of q, k, v and out, ~1300 flops per byte, far above the
// ~295 flops/byte where the bf16 tensor cores (989 TFLOP/s) overtake
// HBM (3.35 TB/s): it is bound by bf16 operations on the tensor cores.
//
// What the design does about it:
//  * bf16: the two products (Q K^T and P V) run on the tensor cores with
//    mma.sync.m16n8k16 (bf16 in, f32 accumulate). One block of 4 warps owns
//    64 query rows of one (b, h); each warp owns 16 rows, keeps its scores
//    and its output accumulator in mma fragments and does the online
//    softmax on them in registers (quad shuffles for the row max). The score
//    fragment is re-packed as the A operand of P V without leaving the
//    registers. Q, K and V^T tiles (64 keys) are staged in padded shared
//    memory so that every fragment load is free of bank conflicts.
//  * KV tiles that the mask empties (above the causal diagonal, before the
//    window) are never loaded: the loop runs only over the tiles a query
//    tile can see, so a decode step (Tq = 1, q_offset = cache length)
//    reads the filled prefix of the cache and not the whole buffer.
//  * GQA without the copy: query head h reads KV head h / (Hq / Hkv).
//  * No padding: D (1..256) is zero-filled to the next of 16/32/64/128/256
//    inside shared memory, and ragged Tq/Tk are masked in the kernel.
//  * float32 has no tensor-core path of full precision, so f32 inputs take
//    an FMA kernel on the CUDA cores (32 x 32 tiles, f32 softmax via expf):
//    the consistency checks in f32 use it, the bf16 serving path does not.
//  Later work (not here): wgmma + TMA, a producer warp, FA3's pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, G, Tq, Tk, D;
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot;
  float scale;
  int q_offset, causal, window;  // window <= 0: none
};

// Range of KV positions [lo, hi) that queries [q0, q1) can see.
__device__ __forceinline__ void kv_range(const Args& a, int q0, int q1,
                                         int* lo, int* hi) {
  long long first = 0, last = a.Tk;
  const long long p_lo = static_cast<long long>(q0) + a.q_offset;
  const long long p_hi = static_cast<long long>(q1) - 1 + a.q_offset;
  if (a.causal) last = p_hi + 1 < last ? p_hi + 1 : last;
  if (a.window > 0) {
    const long long w0 = p_lo - a.window + 1;
    first = w0 > 0 ? w0 : 0;
  }
  if (last < 0) last = 0;
  if (first > last) first = last;
  *lo = static_cast<int>(first);
  *hi = static_cast<int>(last);
}

__device__ __forceinline__ bool visible(const Args& a, int qrow, int kpos) {
  const long long qp = static_cast<long long>(qrow) + a.q_offset;
  if (kpos >= a.Tk) return false;
  if (a.causal && kpos > qp) return false;
  if (a.window > 0 && kpos <= qp - a.window) return false;
  return true;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MQ = 64;         // query rows per block (16 per warp)
constexpr int MK = 64;         // keys per tile
constexpr int MTHREADS = 128;

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows x DP tile of a (rows, D) slab with row stride `st` into shared memory
// (row stride LD), zero-filled beyond `nrows` valid rows and D columns.
// vec: D % 8 == 0 and 16-byte aligned rows, so 8 values move per load.
template <int DP, int LD, bool TRANS>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, long long st,
                                      int nrows, int rows, int D, bool vec) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (vec) {
    constexpr int CH = DP / 8;
    for (int e = threadIdx.x; e < rows * CH; e += MTHREADS) {
      const int r = e / CH, c = (e % CH) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < nrows && c < D)
        val = *reinterpret_cast<const uint4*>(src + r * st + c);
      if (TRANS) {
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[(c + i) * LD + r] = h[i];
      } else {
        *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * DP; e += MTHREADS) {
      const int r = e / DP, c = e % DP;
      const __nv_bfloat16 val =
          (r < nrows && c < D) ? src[r * st + c] : zero;
      if (TRANS)
        dst[c * LD + r] = val;
      else
        dst[r * LD + c] = val;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(MTHREADS)
flash_bf16(Args a, int vec) {
  constexpr int LDQ = DP + 8;       // bf16 row stride of Qs/Ks
  constexpr int LDV = MK + 8;       // bf16 row stride of Vt (d-major)
  constexpr int NT = MK / 8;        // score n-tiles per warp
  constexpr int OT = DP / 8;        // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + MQ * LDQ;
  __nv_bfloat16* Vt = Ks + MK * LDQ;

  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.G;
  const int q0 = blockIdx.x * MQ;
  const int q1 = min(q0 + MQ, a.Tq);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) +
                           b * a.sqb + h * a.sqh + q0 * a.sqt;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) +
                            b * a.skb + hk * a.skh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) +
                            b * a.svb + hk * a.svh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = warp * 16;                       // warp's first row
  const int row0 = q0 + wrow + g, row1 = row0 + 8;  // this thread's 2 rows

  stage<DP, LDQ, false>(Qs, q, a.sqt, q1 - q0, MQ, a.D, vec);

  float o[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  const float sl2 = a.scale * LOG2E;

  int lo, hi;
  kv_range(a, q0, q1, &lo, &hi);
  for (int k0 = (lo / MK) * MK; k0 < hi; k0 += MK) {
    __syncthreads();
    const int nk = min(MK, a.Tk - k0);
    stage<DP, LDQ, false>(Ks, kb + k0 * a.skt, a.skt, nk, MK, a.D, vec);
    stage<DP, LDV, true>(Vt, vb + k0 * a.svt, a.svt, nk, MK, a.D, vec);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + (wrow + g) * LDQ + kk * 16 + 2 * t;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * LDQ);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * LDQ + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* kp = Ks + (j * 8 + g) * LDQ + kk * 16 + 2 * t;
        mma16816(s[j], a0, a1, a2, a3, ld32(kp), ld32(kp + 8));
      }
    }

    // mask, scale into the log2 domain, running max
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const float val = visible(a, row, kpos) ? s[j][e] * sl2 : NEG;
        s[j][e] = val;
        if (e < 2)
          mx0 = fmaxf(mx0, val);
        else
          mx1 = fmaxf(mx1, val);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int i = 0; i < OT; ++i) {
      o[i][0] *= al0;
      o[i][1] *= al0;
      o[i][2] *= al1;
      o[i][3] *= al1;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mm = e < 2 ? mn0 : mn1;
        const float p = s[j][e] > 0.5f * NEG ? exp2f(s[j][e] - mm) : 0.f;
        s[j][e] = p;
        if (e < 2)
          l0 += p;
        else
          l1 += p;
      }
    }

    // O += P V: the score fragments of n-tiles 2kk, 2kk+1 are the A operand
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int i = 0; i < OT; ++i) {
        const __nv_bfloat16* vp = Vt + (i * 8 + g) * LDV + kk * 16 + 2 * t;
        mma16816(o[i], a0, a1, a2, a3, ld32(vp), ld32(vp + 8));
      }
    }
  }

  // the row sums are spread over the quad
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + b * a.sob +
                       h * a.soh;
#pragma unroll
  for (int i = 0; i < OT; ++i) {
    const int d = i * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row0 : row1;
      const int dd = d + (e & 1);
      if (row < a.Tq && dd < a.D)
        out[row * a.sot + dd] =
            __float2bfloat16(o[i][e] * (e < 2 ? inv0 : inv1));
    }
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int FQ = 32;         // query rows per block
constexpr int FK = 32;         // keys per tile
constexpr int FTHREADS = 128;  // 4 threads (a quad) per query row

template <int DP>
__global__ void __launch_bounds__(FTHREADS)
flash_f32(Args a) {
  constexpr int LD = DP + 1;
  constexpr int PER = DP / 4;      // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // FQ x LD
  float* Ks = Qs + FQ * LD;                         // FK x LD
  float* Vs = Ks + FK * LD;                         // FK x DP
  float* Ps = Vs + FK * DP;                         // FQ x (FK + 1)

  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.G;
  const int q0 = blockIdx.x * FQ;
  const int q1 = min(q0 + FQ, a.Tq);
  const float* q = static_cast<const float*>(a.q) + b * a.sqb + h * a.sqh;
  const float* kb = static_cast<const float*>(a.k) + b * a.skb + hk * a.skh;
  const float* vb = static_cast<const float*>(a.v) + b * a.svb + hk * a.svh;
  const int r = threadIdx.x / 4, c = threadIdx.x % 4;
  const int row = q0 + r;

  for (int e = threadIdx.x; e < FQ * DP; e += FTHREADS) {
    const int rr = e / DP, d = e % DP;
    Qs[rr * LD + d] = (q0 + rr < a.Tq && d < a.D)
                          ? q[(q0 + rr) * a.sqt + d] : 0.f;
  }
  float o[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) o[i] = 0.f;
  float m = NEG, l = 0.f;

  int lo, hi;
  kv_range(a, q0, q1, &lo, &hi);
  for (int k0 = (lo / FK) * FK; k0 < hi; k0 += FK) {
    __syncthreads();
    for (int e = threadIdx.x; e < FK * DP; e += FTHREADS) {
      const int kr = e / DP, d = e % DP;
      const bool ok = k0 + kr < a.Tk && d < a.D;
      Ks[kr * LD + d] = ok ? kb[(k0 + kr) * a.skt + d] : 0.f;
      Vs[kr * DP + d] = ok ? vb[(k0 + kr) * a.svt + d] : 0.f;
    }
    __syncthreads();
    float s[FK / 4];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < FK / 4; ++j) {
      const int kc = c + 4 * j;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d)
        acc = fmaf(Qs[r * LD + d], Ks[kc * LD + d], acc);
      s[j] = visible(a, row, k0 + kc) ? acc * a.scale : NEG;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float al = expf(m - mn);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < FK / 4; ++j) {
      const float p = s[j] > 0.5f * NEG ? expf(s[j] - mn) : 0.f;
      Ps[r * (FK + 1) + c + 4 * j] = p;
      ls += p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * al + ls;
    m = mn;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = c + 4 * i;
      float acc = o[i] * al;
#pragma unroll 8
      for (int kc = 0; kc < FK; ++kc)
        acc = fmaf(Ps[r * (FK + 1) + kc], Vs[kc * DP + d], acc);
      o[i] = acc;
    }
  }
  if (row < a.Tq) {
    float* out = static_cast<float*>(a.o) + b * a.sob + h * a.soh +
                 row * a.sot;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = c + 4 * i;
      if (d < a.D) out[d] = o[i] * inv;
    }
  }
}

template <int DP>
int launch_dp(int dtype, const Args& a, int vec, int batch_heads,
              cudaStream_t stream) {
  if (dtype == 2) {
    const size_t smem =
        (2 * MQ * (DP + 8) + DP * (MK + 8)) * sizeof(__nv_bfloat16);
    cudaFuncSetAttribute(flash_bf16<DP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    const dim3 grid((a.Tq + MQ - 1) / MQ, batch_heads);
    flash_bf16<DP><<<grid, MTHREADS, smem, stream>>>(a, vec);
  } else {
    const size_t smem =
        (FQ * (DP + 1) + FK * (DP + 1) + FK * DP + FQ * (FK + 1)) *
        sizeof(float);
    cudaFuncSetAttribute(flash_f32<DP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    const dim3 grid((a.Tq + FQ - 1) / FQ, batch_heads);
    flash_f32<DP><<<grid, FTHREADS, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 2 = bfloat16. q is (B, Hq, Tq, D), k/v (B, Hkv, Tk, D)
// and out (B, Hq, Tq, D), each with the given element strides for its first
// three axes and unit stride over D. G = Hq / Hkv. window <= 0 means none.
// vec (bf16 only): D % 8 == 0 and every row start 16-byte aligned. The
// grid's second axis is B * Hq. Returns cudaGetLastError().
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int Hq,
                               int Hkv, int Tq, int Tk, int D,
                               const long long* strides, float scale,
                               int q_offset, int causal, int window, int vec,
                               void* stream) {
  if ((dtype != 0 && dtype != 2) || D < 1 || D > 256 || Hkv < 1 ||
      Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, out, Hq, Hq / Hkv, Tq, Tk, D,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], strides[8], strides[9],
         strides[10], strides[11], scale, q_offset, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = B * Hq;
  if (D <= 16) return launch_dp<16>(dtype, a, vec, bh, s);
  if (D <= 32) return launch_dp<32>(dtype, a, vec, bh, s);
  if (D <= 64) return launch_dp<64>(dtype, a, vec, bh, s);
  if (D <= 128) return launch_dp<128>(dtype, a, vec, bh, s);
  return launch_dp<256>(dtype, a, vec, bh, s);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
