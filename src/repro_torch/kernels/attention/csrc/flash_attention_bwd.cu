// flash_attention_bwd.cu — backward of flash attention.
//
// The port's own kernels: the JAX package defines no backward for
// src/repro/kernels/attention/flash.py:90 (flash_attention_flat); its
// training tests differentiate the jnp reference. Given q, k, v, the
// forward's output o and the incoming dO, with s = scale q.k over the keys
// the causal and/or sliding-window mask leaves to each query (as in
// flash_attention.cu), they compute
//   LSE_i = log sum_j exp(s_ij),  P_ij = exp(s_ij - LSE_i),
//   D_i   = rowsum(dO_i o O_i),   dS_ij = P_ij (dO_i . v_j - D_i),
//   dq_i  = scale sum_j dS_ij k_j,
//   dk_j  = scale sum_{h in j's group, i} dS_ij q_i,  dv_j = sum P_ij dO_i.
// A row with no valid key has LSE = -inf, P = 0 and zero gradients, never
// NaN. GQA: query head h reads KV head h / G; a dk/dv block loops over the
// G query heads of its KV head, so nothing is repeated in memory. No float
// atomics: every output element has one writer, and two launches on the
// same inputs give the same bits.
//
// What bounds it: with the LSE from the forward the function needs five
// products over the causal half (S, dP, dq, dk, dv): at qwen3-1.7b's
// training shape (B = 2, Hq = 16, Hkv = 8, T = 4096, D = 128, causal)
// 344 GFLOP, 0.347 ms at 989 TFLOP/s bf16 (0.695 ms at the prefill's
// B = 4); its bytes (q, k, v, o, dO, LSE read, dq, dk, dv written) take
// ~0.06 ms at 3.35 TB/s.
//
// Two routes (ops.bwd_route picks one from the inputs alone):
//  * flash_attention_bwd_sm90, bfloat16 at D = 64 or 128 that TMA can
//    address (training's path): bwd_prep, then bwd_dq_sm90 and
//    bwd_dkdv_sm90 (below), wgmma fed by TMA after flash_sm90's model,
//    reading the LSE the forward wrote. They run 7 products where the
//    function needs 5: S and dP in both kernels.
//  * flash_attention_bwd, everything else (D = 256, D % 8 != 0 after the
//    wrapper's padding, misaligned views, float32): FA2's two passes. A dq
//    kernel (a block owns 64 query rows, 16 a warp) forms D_i, passes once
//    over the visible keys to recompute each row's LSE, then again for dq,
//    and writes LSE and D; a dk/dv kernel (64 keys, 32 at D = 256) loops
//    over (query head, 32-row query tile) pairs reading them. bfloat16
//    runs every product on mma.sync m16n8k16 with f32 accumulators
//    (operands staged by cp.async into row-padded tiles, double buffered;
//    a B operand whose rows are the contraction gathered as bf16 pairs);
//    float32 the same two passes on the CUDA cores (FMA).
// Both round P and dS to bf16 for their products, as FlashAttention does.

#include <math.h>

#include "flash_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

enum { Q, K, V, O, DO, DQ, DK, DV, NARR };

struct Args {
  const void* in[5];  // q, k, v, o, dO
  void* out[3];       // dq, dk, dv
  float* lse;         // mma.sync route: (B, Hq, Tq), natural log, written
                      // by dq; wgmma route: the forward's, read by prep
  float* dsum;        // (B, Hq, Tq), D_i, written by dq; wgmma route:
                      // (B, Hq, Tqp), written by prep
  float* lse2;        // wgmma route: (B, Hq, Tqp) LSE in log2, by prep
  int Tqp;            // wgmma route: Tq rounded up to 128
  int Hq, Hkv, G, Tq, Tk, D;
  long long s[NARR][3];  // (b, h, t) element strides
  float scale;
  int q_offset, causal, window;  // window <= 0: none
};

// Keys [lo, hi) that queries [q0, q1) can see (as flash_attention.cu).
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

// Queries [lo, hi) that can see some key of [k0, k1): query i (at absolute
// position i + q_offset) sees key j iff j <= i + q_offset (causal) and
// j > i + q_offset - window.
__device__ __forceinline__ void q_range(const Args& a, int k0, int k1,
                                        int* lo, int* hi) {
  long long first = 0, last = a.Tq;
  if (a.causal) {
    const long long f = static_cast<long long>(k0) - a.q_offset;
    first = f > 0 ? f : 0;
  }
  if (a.window > 0) {
    const long long l =
        static_cast<long long>(k1) - 1 + a.window - a.q_offset;
    last = l < last ? l : last;
  }
  if (last < 0) last = 0;
  if (first > last) first = last;
  *lo = static_cast<int>(first);
  *hi = static_cast<int>(last);
}

__device__ __forceinline__ bool visible(const Args& a, int qrow, int kpos) {
  const long long qp = static_cast<long long>(qrow) + a.q_offset;
  if (qrow >= a.Tq || kpos >= a.Tk) return false;
  if (a.causal && kpos > qp) return false;
  if (a.window > 0 && kpos <= qp - a.window) return false;
  return true;
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;  // 4 warps

// 16 bytes global -> shared; zero fill (nothing read) when !ok.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, rows) x columns [0, DP) of a (t, d) slab with row stride st into
// a shared tile of row stride DP + 8; rows >= nvalid and columns >= D are
// zero. `base` is any valid address, the source of the zero fills.
template <int DP>
__device__ __forceinline__ void stage(bf16* s, const bf16* g, long long st,
                                      int rows, int nvalid, int D,
                                      const void* base) {
  constexpr int CPR = DP / 8;
  for (int c = threadIdx.x; c < rows * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool ok = r < nvalid && col < D;
    cp16(s + r * (DP + 8) + col, ok ? g + r * st + col : base, ok);
  }
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// A fragment (16 x 16) at the top left of a row-major shared tile.
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* s, int ld,
                                       int g, int t) {
  a[0] = ld32(s + g * ld + 2 * t);
  a[1] = ld32(s + (g + 8) * ld + 2 * t);
  a[2] = ld32(s + g * ld + 8 + 2 * t);
  a[3] = ld32(s + (g + 8) * ld + 8 + 2 * t);
}
// B fragment (16 x 8) whose element (k, n) is s[n * ld + k].
__device__ __forceinline__ void frag_b_nk(uint32_t* b, const bf16* s, int ld,
                                          int g, int t) {
  b[0] = ld32(s + g * ld + 2 * t);
  b[1] = ld32(s + g * ld + 8 + 2 * t);
}
// B fragment (16 x 8) whose element (k, n) is s[k * ld + n].
__device__ __forceinline__ void frag_b_kn(uint32_t* b, const bf16* s, int ld,
                                          int g, int t) {
  b[0] = pack2(s[(2 * t) * ld + g], s[(2 * t + 1) * ld + g]);
  b[1] = pack2(s[(2 * t + 8) * ld + g], s[(2 * t + 9) * ld + g]);
}
// The A fragment of columns 16 kk .. 16 kk + 15 of an accumulator tile
// (m16 x n8 tiles 2 kk and 2 kk + 1), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*c)[4],
                                         int kk) {
  a[0] = pack_f(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_f(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_f(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_f(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// acc (16 x 8 NT) = A (16 rows of sa) x B^T, B's rows at sb, over DP.
template <int DP, int NT>
__device__ __forceinline__ void mm_abt(float (*acc)[4], const bf16* sa,
                                       const bf16* sb, int g, int t) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t af[4];
    frag_a(af, sa + 16 * kk, LD, g, t);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bf[2];
      frag_b_nk(bf, sb + 8 * n * LD + 16 * kk, LD, g, t);
      mma(acc[n], af, bf[0], bf[1]);
    }
  }
}

// acc (16 x 8 NT) += A (16 x 16 KT, the accumulator tile c) x B, B's rows
// (the contraction) at sb, its columns starting there.
template <int DP, int KT, int NT>
__device__ __forceinline__ void mm_cb(float (*acc)[4], const float (*c)[4],
                                      const bf16* sb, int g, int t) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t af[4];
    acc_to_a(af, c, kk);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bf[2];
      frag_b_kn(bf, sb + 16 * kk * LD + 8 * n, LD, g, t);
      mma(acc[n], af, bf[0], bf[1]);
    }
  }
}

template <int DP>
struct DqTile {
  static constexpr int BM = 64;                  // query rows, 16 a warp
  static constexpr int BK = DP <= 128 ? 64 : 32; // keys a step
  static constexpr int LD = DP + 8;
  static constexpr int SMEM = (2 * BM + 4 * BK) * LD * 2;  // Q dO K[2] V[2]
};

template <int DP>
__global__ void __launch_bounds__(THREADS) bwd_dq_bf16(Args a) {
  using T = DqTile<DP>;
  constexpr int BM = T::BM, BK = T::BK, LD = T::LD, NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + BM * LD;           // dO
  bf16* sK = sO + BM * LD;           // 2 stages
  bf16* sV = sK + 2 * BK * LD;       // 2 stages

  const int bh = blockIdx.y, b = bh / a.Hq, h = bh % a.Hq, hk = h / a.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp + g;  // this thread's rows r0, r0 + 8
  const bf16* q = static_cast<const bf16*>(a.in[Q]) + b * a.s[Q][0] +
                  h * a.s[Q][1];
  const bf16* k = static_cast<const bf16*>(a.in[K]) + b * a.s[K][0] +
                  hk * a.s[K][1];
  const bf16* v = static_cast<const bf16*>(a.in[V]) + b * a.s[V][0] +
                  hk * a.s[V][1];
  const bf16* o = static_cast<const bf16*>(a.in[O]) + b * a.s[O][0] +
                  h * a.s[O][1];
  const bf16* dO = static_cast<const bf16*>(a.in[DO]) + b * a.s[DO][0] +
                   h * a.s[DO][1];

  stage<DP>(sQ, q + q0 * a.s[Q][2], a.s[Q][2], BM, a.Tq - q0, a.D, q);
  stage<DP>(sO, dO + q0 * a.s[DO][2], a.s[DO][2], BM, a.Tq - q0, a.D, dO);
  cp_commit();

  int lo, hi;
  kv_range(a, q0, min(q0 + BM, a.Tq), &lo, &hi);
  const int k_first = (lo / BK) * BK;
  const int n_tiles = hi > k_first ? (hi - k_first + BK - 1) / BK : 0;
  auto stage_kv = [&](int it, bool with_v) {
    const int k0 = k_first + it * BK, st = it & 1;
    stage<DP>(sK + st * BK * LD, k + k0 * a.s[K][2], a.s[K][2], BK,
              a.Tk - k0, a.D, k);
    if (with_v)
      stage<DP>(sV + st * BK * LD, v + k0 * a.s[V][2], a.s[V][2], BK,
                a.Tk - k0, a.D, v);
    cp_commit();
  };

  // D_i = rowsum(dO o O) in float32, a warp's 16 rows from global memory
  float di0 = 0.f, di1 = 0.f;
  for (int rr = 0; rr < 16; ++rr) {
    const int row = q0 + 16 * warp + rr;
    float sum = 0.f;
    if (row < a.Tq)
      for (int d = 2 * lane; d < a.D; d += 64) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
            o + row * a.s[O][2] + d);
        const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(
            dO + row * a.s[DO][2] + d);
        sum += __low2float(x) * __low2float(y) +
               __high2float(x) * __high2float(y);
      }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (rr == g) di0 = sum;
    if (rr == g + 8) di1 = sum;
  }

  const float sl2 = a.scale * LOG2E;
  const bf16* qw = sQ + 16 * warp * LD;
  const bf16* ow = sO + 16 * warp * LD;
  float sc[NT][4];

  // ---- pass 1: each row's log-sum-exp over its visible keys (log2) ----
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  if (n_tiles > 0) stage_kv(0, false);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage_kv(it + 1, false);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k0 = k_first + it * BK;
    mm_abt<DP, NT>(sc, qw, sK + (it & 1) * BK * LD, g, t);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = k0 + 8 * n + 2 * t + (e & 1);
        const float x = visible(a, e < 2 ? r0 : r0 + 8, kc)
                            ? sc[n][e] * sl2 : -INFINITY;
        sc[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float b0 = mx0 == -INFINITY ? 0.f : mx0;
    const float b1 = mx1 == -INFINITY ? 0.f : mx1;
    l0 *= exp2f(m0 - b0);
    l1 *= exp2f(m1 - b1);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      l0 += exp2f(sc[n][0] - b0) + exp2f(sc[n][1] - b0);
      l1 += exp2f(sc[n][2] - b1) + exp2f(sc[n][3] - b1);
    }
    m0 = mx0;
    m1 = mx1;
    __syncthreads();   // stage it & 1 is refilled next
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float lse0 = m0 == -INFINITY ? -INFINITY : m0 + log2f(l0);
  const float lse1 = m1 == -INFINITY ? -INFINITY : m1 + log2f(l1);

  // ---- pass 2: dq = scale sum_j P_ij (dO_i . v_j - D_i) k_j ----
  float dq[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  float dp[NT][4];
  if (n_tiles > 0) stage_kv(0, true);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage_kv(it + 1, true);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k0 = k_first + it * BK;
    const bf16* kt = sK + (it & 1) * BK * LD;
    mm_abt<DP, NT>(sc, qw, kt, g, t);                          // S
    mm_abt<DP, NT>(dp, ow, sV + (it & 1) * BK * LD, g, t);     // dO V^T
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r0 + 8;
        const float lse = e < 2 ? lse0 : lse1;
        const int kc = k0 + 8 * n + 2 * t + (e & 1);
        const float p = (visible(a, row, kc) && lse != -INFINITY)
                            ? exp2f(sc[n][e] * sl2 - lse) : 0.f;
        sc[n][e] = p * (dp[n][e] - (e < 2 ? di0 : di1));       // dS
      }
    mm_cb<DP, BK / 16, DP / 8>(dq, sc, kt, g, t);              // += dS K
    __syncthreads();
  }
  cp_wait<0>();

  bf16* dqo = static_cast<bf16*>(a.out[0]) + b * a.s[DQ][0] + h * a.s[DQ][1];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = 8 * n + 2 * t;   // D % 8 == 0: col + 1 < D too
    if (col < a.D) {
      if (r0 < a.Tq)
        *reinterpret_cast<uint32_t*>(dqo + r0 * a.s[DQ][2] + col) =
            pack_f(dq[n][0] * a.scale, dq[n][1] * a.scale);
      if (r0 + 8 < a.Tq)
        *reinterpret_cast<uint32_t*>(dqo + (r0 + 8) * a.s[DQ][2] + col) =
            pack_f(dq[n][2] * a.scale, dq[n][3] * a.scale);
    }
  }
  if (t == 0) {
    const long long base = static_cast<long long>(bh) * a.Tq;
    if (r0 < a.Tq) {
      a.lse[base + r0] = lse0 * LN2;
      a.dsum[base + r0] = di0;
    }
    if (r0 + 8 < a.Tq) {
      a.lse[base + r0 + 8] = lse1 * LN2;
      a.dsum[base + r0 + 8] = di1;
    }
  }
}

template <int DP>
struct KvTile {
  static constexpr int NSPLIT = DP > 128 ? 2 : 1;  // warps on 16 keys
  static constexpr int BN = 64 / NSPLIT;           // keys a block
  static constexpr int DW = DP / NSPLIT;           // dk/dv columns a warp
  static constexpr int BQ = DP <= 64 ? 64 : 32;    // query rows a step
  static constexpr int LD = DP + 8;
  static constexpr int SMEM = (2 * BN + 4 * BQ) * LD * 2 + 4 * BQ * 4;
};

template <int DP>
__global__ void __launch_bounds__(THREADS) bwd_dkdv_bf16(Args a) {
  using T = KvTile<DP>;
  constexpr int BN = T::BN, BQ = T::BQ, LD = T::LD, DW = T::DW;
  constexpr int NT = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BN * LD;
  bf16* sQ = sV + BN * LD;            // 2 stages
  bf16* sO = sQ + 2 * BQ * LD;        // dO, 2 stages
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ * LD);  // LSE (log2), 2
  float* sD = sL + 2 * BQ;                                 // D_i, 2

  const int bh = blockIdx.y, b = bh / a.Hkv, hk = bh % a.Hkv;
  const int k0 = blockIdx.x * BN;
  const int k1 = min(k0 + BN, a.Tk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kr = warp / T::NSPLIT, ch = warp % T::NSPLIT;
  const int j0 = k0 + 16 * kr + g;    // this thread's keys j0, j0 + 8
  const bf16* k = static_cast<const bf16*>(a.in[K]) + b * a.s[K][0] +
                  hk * a.s[K][1];
  const bf16* v = static_cast<const bf16*>(a.in[V]) + b * a.s[V][0] +
                  hk * a.s[V][1];
  stage<DP>(sK, k + k0 * a.s[K][2], a.s[K][2], BN, a.Tk - k0, a.D, k);
  stage<DP>(sV, v + k0 * a.s[V][2], a.s[V][2], BN, a.Tk - k0, a.D, v);
  cp_commit();

  int lo, hi;
  q_range(a, k0, k1, &lo, &hi);
  const int q_first = (lo / BQ) * BQ;
  const int nq = hi > q_first ? (hi - q_first + BQ - 1) / BQ : 0;
  const int n_steps = a.G * nq;
  auto stage_q = [&](int it) {
    const int h = hk * a.G + it / nq, q0 = q_first + (it % nq) * BQ;
    const int st = it & 1;
    const bf16* q = static_cast<const bf16*>(a.in[Q]) + b * a.s[Q][0] +
                    h * a.s[Q][1];
    const bf16* dO = static_cast<const bf16*>(a.in[DO]) + b * a.s[DO][0] +
                     h * a.s[DO][1];
    stage<DP>(sQ + st * BQ * LD, q + q0 * a.s[Q][2], a.s[Q][2], BQ,
              a.Tq - q0, a.D, q);
    stage<DP>(sO + st * BQ * LD, dO + q0 * a.s[DO][2], a.s[DO][2], BQ,
              a.Tq - q0, a.D, dO);
    cp_commit();
    const long long base = (static_cast<long long>(b) * a.Hq + h) * a.Tq;
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const bool ok = q0 + r < a.Tq;
      sL[st * BQ + r] = ok ? a.lse[base + q0 + r] * LOG2E : -INFINITY;
      sD[st * BQ + r] = ok ? a.dsum[base + q0 + r] : 0.f;
    }
  };

  const float sl2 = a.scale * LOG2E;
  float dk[DW / 8][4], dv[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  float pt[NT][4], dpt[NT][4];
  const bf16* kw = sK + 16 * kr * LD;
  const bf16* vw = sV + 16 * kr * LD;

  if (n_steps > 0) stage_q(0);
  for (int it = 0; it < n_steps; ++it) {
    if (it + 1 < n_steps) {
      stage_q(it + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int st = it & 1, q0 = q_first + (it % nq) * BQ;
    const bf16* qt = sQ + st * BQ * LD;
    const bf16* ot = sO + st * BQ * LD;
    mm_abt<DP, NT>(pt, kw, qt, g, t);      // S^T = K Q^T
    mm_abt<DP, NT>(dpt, vw, ot, g, t);     // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * n + 2 * t + (e & 1);
        const int key = e < 2 ? j0 : j0 + 8;
        const float lse = sL[st * BQ + qc];
        const float p = (visible(a, q0 + qc, key) && lse != -INFINITY)
                            ? exp2f(pt[n][e] * sl2 - lse) : 0.f;
        pt[n][e] = p;                                        // P^T
        dpt[n][e] = p * (dpt[n][e] - sD[st * BQ + qc]);      // dS^T
      }
    mm_cb<DP, BQ / 16, DW / 8>(dv, pt, ot + ch * DW, g, t);    // += P^T dO
    mm_cb<DP, BQ / 16, DW / 8>(dk, dpt, qt + ch * DW, g, t);   // += dS^T Q
    __syncthreads();
  }
  cp_wait<0>();

  bf16* dko = static_cast<bf16*>(a.out[1]) + b * a.s[DK][0] + hk * a.s[DK][1];
  bf16* dvo = static_cast<bf16*>(a.out[2]) + b * a.s[DV][0] + hk * a.s[DV][1];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    const int col = ch * DW + 8 * n + 2 * t;
    if (col < a.D) {
      if (j0 < a.Tk) {
        *reinterpret_cast<uint32_t*>(dko + j0 * a.s[DK][2] + col) =
            pack_f(dk[n][0] * a.scale, dk[n][1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvo + j0 * a.s[DV][2] + col) =
            pack_f(dv[n][0], dv[n][1]);
      }
      if (j0 + 8 < a.Tk) {
        *reinterpret_cast<uint32_t*>(dko + (j0 + 8) * a.s[DK][2] + col) =
            pack_f(dk[n][2] * a.scale, dk[n][3] * a.scale);
        *reinterpret_cast<uint32_t*>(dvo + (j0 + 8) * a.s[DV][2] + col) =
            pack_f(dv[n][2], dv[n][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at D in {64, 128} on Hopper: wgmma fed by TMA
// ---------------------------------------------------------------------------
//
// Three launches: bwd_prep (D_i = rowsum(dO o O) and the forward's LSE in
// log2, one warp a row, into (B, Hq, Tqp) rows padded to 128 with D = 0,
// LSE = -inf), then bwd_dq_sm90 and bwd_dkdv_sm90, which read only those and
// the inputs. Each of the two is a block of 3 warpgroups modelled on
// flash_attention.cu's flash_sm90: warpgroup 0 issues the TMA copies after
// setmaxnreg (24 registers), warpgroups 1 and 2 own 64 rows each of a
// resident 128-row pair of tiles and run the products (240 registers);
// a ring of STAGES 64-row pairs, full / empty mbarriers as in the forward.
// The tensor maps are 4-D over the (B, H, T, D) views with their own
// strides and the 128-byte swizzle, encoded in the C entry as the forward
// encodes them, so training's (B, T, H, D) buffers are read in place; every
// box is 64 rows x 64 columns. Per step, the two SS products are issued
// together and P (or P^T) is formed on the CUDA cores while the second
// runs (in dk/dv, dv's RS product also runs while dS^T is formed); a stage
// is released once its last product is done. Fully masked tiles are never
// loaded, and the heaviest tiles go first.


constexpr int SM90_THREADS = 384;  // producer + 2 consumer warpgroups
constexpr int BOX = 64 * 128;      // bytes of a 64-row x 64-column bf16 box

template <int DP>
struct Sm90 {
  static constexpr int CH = DP / 64;           // 64-column boxes a row
  static constexpr int SMALL = CH * BOX;       // a 64-row tile
  static constexpr int BIG = 2 * SMALL;        // a 128-row tile
  static constexpr int STAGES = 4;             // ring depth
  static constexpr int STATS = 2 * 64 * 4;     // LSE and D of 64 rows
  static constexpr int SMEM =                  // + room to align the base
      2 * BIG + STAGES * (2 * SMALL + STATS) + 1024;
  static constexpr int NACC = DP / 2;          // dq, dk or dv registers
};

// A 128-row tile (rows row..row + 127 of head h, batch b): box c of rows
// half * 64.. lands at c * BIG / CH + half * BOX, so that its 64-column
// boxes are 2 BOX apart and a warpgroup's 64 rows start at + cw * BOX.
template <int DP>
__device__ __forceinline__ void load_big(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int h,
                                         int b) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      tma_load(dst + c * 2 * BOX + half * BOX, map, bar, 64 * c,
               row + 64 * half, h, b);
}

// A 64-row tile: its 64-column boxes BOX apart.
template <int DP>
__device__ __forceinline__ void load_small(uint32_t dst,
                                           const CUtensorMap* map,
                                           uint32_t bar, int row, int h,
                                           int b) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
    tma_load(dst + c * BOX, map, bar, 64 * c, row, h, b);
}

// d (64 x 64, f32) = A B^T over DP: A the 64 rows at `a` (K-major, boxes
// a_chunk bytes apart), B the 64-row tile at `b` (K-major).
template <int DP>
__device__ __forceinline__ void mm_ss(float* d, uint32_t a, uint32_t a_chunk,
                                      uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss<64>(d, sw128_desc(a + (kk / 4) * a_chunk + (kk % 4) * 32, 16),
                 sw128_desc(b + (kk / 4) * BOX + (kk % 4) * 32, 16), kk > 0);
}

// acc (64 x DP) += A B: A (64 x 64) bf16 from registers, B the 64-row tile
// at `b` read MN-major (the transpose bit): its rows are the contraction,
// 16 of them 2048 bytes on, its boxes BOX apart.
template <int DP>
__device__ __forceinline__ void mm_rs(float* acc, const uint32_t (*pa)[4],
                                      uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<DP>(acc, pa[kk], sw128_desc(b + kk * 2048, BOX));
}

// The m64n64 accumulator in bf16 as the A operand of the next product:
// columns 16 kk .. 16 kk + 15 are its step kk (flash_attention.cu's pack_p).
__device__ __forceinline__ void to_a(const float* sc, uint32_t (*pa)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// Keys [k0, k0 + 64) against a warpgroup's queries at absolute positions
// [p_lo, p_hi]: some pair is masked (causal diagonal, window, key end).
__device__ __forceinline__ bool cut_keys(const Args& a, int k0,
                                         long long p_lo, long long p_hi) {
  return k0 + 64 > a.Tk || (a.causal && k0 + 63 > p_lo) ||
         (a.window > 0 && k0 <= p_hi - a.window);
}

// Queries [q0, q0 + 64) against keys [k0, k0 + 64): some pair is masked.
__device__ __forceinline__ bool cut_queries(const Args& a, int k0, int q0) {
  const long long p_lo = static_cast<long long>(q0) + a.q_offset;
  return k0 + 64 > a.Tk || q0 + 64 > a.Tq ||
         (a.causal && k0 + 63 > p_lo) ||
         (a.window > 0 && k0 <= p_lo + 63 - a.window);
}

// One warp a padded row r of (B, Hq, Tqp): D_r and the LSE in log2.
__global__ void __launch_bounds__(256) bwd_prep(Args a, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const long long bh = r / a.Tqp;
  const int t = static_cast<int>(r % a.Tqp);
  const int b = static_cast<int>(bh / a.Hq), h = static_cast<int>(bh % a.Hq);
  float sum = 0.f;
  if (t < a.Tq) {
    const bf16* o = static_cast<const bf16*>(a.in[O]) + b * a.s[O][0] +
                    h * a.s[O][1] + t * a.s[O][2];
    const bf16* dO = static_cast<const bf16*>(a.in[DO]) + b * a.s[DO][0] +
                     h * a.s[DO][1] + t * a.s[DO][2];
    for (int d = 2 * lane; d < a.D; d += 64) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(o + d);
      const __nv_bfloat162 y =
          *reinterpret_cast<const __nv_bfloat162*>(dO + d);
      sum += __low2float(x) * __low2float(y) +
             __high2float(x) * __high2float(y);
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    a.dsum[r] = sum;
    a.lse2[r] = t < a.Tq ? a.lse[bh * a.Tq + t] * LOG2E : -INFINITY;
  }
}

// dq for 128 query rows of one (b, h): K and V tiles of 64 keys through the
// ring; per tile S = Q K^T and dP = dO V^T (SS), P = exp2(S scale log2 e -
// LSE2), dS = P (dP - D), dq += dS K (RS, K read MN-major): 3 products.
template <int DP>
__global__ void __launch_bounds__(SM90_THREADS, 1)
bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo, Args a) {
  using T = Sm90<DP>;
  constexpr int ST = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * ST];
  // 128-byte swizzled tiles need 1024-byte aligned bases
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sO = sQ + T::BIG;                 // dO
  const uint32_t sK = sO + T::BIG;                 // + s * SMALL
  const uint32_t sV = sK + ST * T::SMALL;          // + s * SMALL
  const uint32_t full_q = smem_u32(&bars[0]);
  const uint32_t full_k = smem_u32(&bars[1]);            // + 8 s
  const uint32_t full_v = smem_u32(&bars[1 + ST]);       // + 8 s
  const uint32_t empty = smem_u32(&bars[1 + 2 * ST]);    // + 8 s

  const int bh = blockIdx.x, b = bh / a.Hq, h = bh % a.Hq, hk = h / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;  // heaviest tiles first
  int lo, hi;
  kv_range(a, q0, min(q0 + 128, a.Tq), &lo, &hi);
  const int k_first = (lo / 64) * 64;
  const int n_tiles = hi > k_first ? (hi - k_first + 63) / 64 : 0;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, 2 * T::BIG);
      load_big<DP>(sQ, &tq, full_q, q0, h, b);
      load_big<DP>(sO, &tdo, full_q, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        const uint32_t ph = (it / ST) & 1;
        const int k0 = k_first + it * 64;
        mbar_wait(empty + 8 * s, ph ^ 1);  // the first round passes at once
        mbar_expect_tx(full_k + 8 * s, T::SMALL);
        load_small<DP>(sK + s * T::SMALL, &tk, full_k + 8 * s, k0, hk, b);
        mbar_expect_tx(full_v + 8 * s, T::SMALL);
        load_small<DP>(sV + s * T::SMALL, &tv, full_v + 8 * s, k0, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1, tid = threadIdx.x - 128 * wg, lane = tid % 32;
    const int wq0 = q0 + 64 * cw;
    const int r0 = wq0 + 16 * (tid / 32) + lane / 4;  // rows r0, r0 + 8
    const int t2 = 2 * (lane % 4);
    if (wq0 >= a.Tq) {
      // no row of this warpgroup exists: keep the ring turning
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        const uint32_t ph = (it / ST) & 1;
        mbar_wait(full_k + 8 * s, ph);
        mbar_wait(full_v + 8 * s, ph);
        mbar_arrive(empty + 8 * s);
      }
    } else {
      const long long row0 = static_cast<long long>(bh) * a.Tqp;
      const float lse0 = a.lse2[row0 + r0], lse1 = a.lse2[row0 + r0 + 8];
      const float di0 = a.dsum[row0 + r0], di1 = a.dsum[row0 + r0 + 8];
      const float sl2 = a.scale * LOG2E;
      const long long p_lo = static_cast<long long>(wq0) + a.q_offset;
      const long long p_hi = p_lo + 63;
      float dq[T::NACC];
#pragma unroll
      for (int i = 0; i < T::NACC; ++i) dq[i] = 0.f;
      float sc[32], dp[32];
      uint32_t pa[4][4];
      const uint32_t qa = sQ + cw * BOX, oa = sO + cw * BOX;
      mbar_wait(full_q, 0);

      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        const uint32_t ph = (it / ST) & 1;
        const int k0 = k_first + it * 64;
        const uint32_t kt = sK + s * T::SMALL;
        mbar_wait(full_k + 8 * s, ph);
        wgmma_fence();
        mm_ss<DP>(sc, qa, 2 * BOX, kt);                  // S = Q K^T
        wgmma_commit();
        mbar_wait(full_v + 8 * s, ph);
        mm_ss<DP>(dp, oa, 2 * BOX, sV + s * T::SMALL);   // dP = dO V^T
        wgmma_commit();
        wgmma_wait<1>();                                 // S is done
        fence_regs<32>(sc);
        // P (value 4 j + e: row r0 + 8 (e / 2), key k0 + t2 + 8 j + e % 2);
        // a row without a visible key (LSE -inf) gets 0, never NaN
        const bool masked = cut_keys(a, k0, p_lo, p_hi);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lse = e < 2 ? lse0 : lse1;
            const bool ok = lse != -INFINITY &&
                            (!masked || visible(a, e < 2 ? r0 : r0 + 8,
                                                k0 + t2 + 8 * j + (e & 1)));
            sc[4 * j + e] = ok ? exp2f(sc[4 * j + e] * sl2 - lse) : 0.f;
          }
        wgmma_wait<0>();                                 // dP is done
        fence_regs<32>(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sc[i] *= dp[i] - ((i & 2) ? di1 : di0);         // dS
        to_a(sc, pa);
        wgmma_fence();
        mm_rs<DP>(dq, pa, kt);                           // dq += dS K
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<T::NACC>(dq);
        mbar_arrive(empty + 8 * s);    // all three products are done with s
      }

      bf16* dqo = static_cast<bf16*>(a.out[0]) + b * a.s[DQ][0] +
                  h * a.s[DQ][1];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + t2;
        if (r0 < a.Tq)
          *reinterpret_cast<uint32_t*>(dqo + r0 * a.s[DQ][2] + col) =
              pack_bf16(dq[4 * j] * a.scale, dq[4 * j + 1] * a.scale);
        if (r0 + 8 < a.Tq)
          *reinterpret_cast<uint32_t*>(dqo + (r0 + 8) * a.s[DQ][2] + col) =
              pack_bf16(dq[4 * j + 2] * a.scale, dq[4 * j + 3] * a.scale);
      }
    }
  }
}

// dk, dv for 128 keys of one (b, hk): the G query heads' 64-row Q / dO
// tiles that can see them (with their LSE and D rows, by bulk copy) through
// the ring; per tile the transposed scores S^T = K Q^T and dP^T = V dO^T
// (SS), P^T and dS^T = P^T (dP^T - D) in registers, dv += P^T dO and
// dk += dS^T Q (RS, dO and Q read MN-major): 4 products, nothing
// transposed in shared memory.
template <int DP>
__global__ void __launch_bounds__(SM90_THREADS, 1)
bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo, Args a) {
  using T = Sm90<DP>;
  constexpr int ST = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * ST];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + T::BIG;
  const uint32_t sQ = sV + T::BIG;                 // + s * SMALL
  const uint32_t sO = sQ + ST * T::SMALL;          // dO, + s * SMALL
  const uint32_t sL = sO + ST * T::SMALL;          // + s * STATS
  const float* stats = reinterpret_cast<const float*>(smem_raw + (sL - raw));
  const uint32_t full_kv = smem_u32(&bars[0]);
  const uint32_t full = smem_u32(&bars[1]);              // + 8 s
  const uint32_t empty = smem_u32(&bars[1 + ST]);        // + 8 s

  const int bh = blockIdx.x, b = bh / a.Hkv, hk = bh % a.Hkv;
  const int k0 = blockIdx.y * 128;   // causal: the first keys see the most
  int lo, hi;
  q_range(a, k0, min(k0 + 128, a.Tk), &lo, &hi);
  const int q_first = (lo / 64) * 64;
  const int nq = hi > q_first ? (hi - q_first + 63) / 64 : 0;
  const int n_steps = a.G * nq;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_kv, 2 * T::BIG);
      load_big<DP>(sK, &tk, full_kv, k0, hk, b);
      load_big<DP>(sV, &tv, full_kv, k0, hk, b);
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % ST;
        const uint32_t ph = (it / ST) & 1;
        const int h = hk * a.G + it / nq, q0 = q_first + (it % nq) * 64;
        const long long row =
            (static_cast<long long>(b) * a.Hq + h) * a.Tqp + q0;
        mbar_wait(empty + 8 * s, ph ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * T::SMALL + T::STATS);
        load_small<DP>(sQ + s * T::SMALL, &tq, full + 8 * s, q0, h, b);
        load_small<DP>(sO + s * T::SMALL, &tdo, full + 8 * s, q0, h, b);
        bulk_load(sL + s * T::STATS, a.lse2 + row, 256, full + 8 * s);
        bulk_load(sL + s * T::STATS + 256, a.dsum + row, 256, full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1, tid = threadIdx.x - 128 * wg, lane = tid % 32;
    const int wk0 = k0 + 64 * cw;
    const int r0 = wk0 + 16 * (tid / 32) + lane / 4;  // keys r0, r0 + 8
    const int t2 = 2 * (lane % 4);
    if (wk0 >= a.Tk) {
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % ST;
        mbar_wait(full + 8 * s, (it / ST) & 1);
        mbar_arrive(empty + 8 * s);
      }
    } else {
      const float sl2 = a.scale * LOG2E;
      float dk[T::NACC], dv[T::NACC];
#pragma unroll
      for (int i = 0; i < T::NACC; ++i) dk[i] = dv[i] = 0.f;
      float st[32], dpt[32];
      uint32_t pa[4][4], pb[4][4];
      const uint32_t ka = sK + cw * BOX, va = sV + cw * BOX;
      mbar_wait(full_kv, 0);

      for (int it = 0; it < n_steps; ++it) {
        const int s = it % ST;
        const uint32_t ph = (it / ST) & 1;
        const int q0 = q_first + (it % nq) * 64;
        const uint32_t qt = sQ + s * T::SMALL, ot = sO + s * T::SMALL;
        const float* L = stats + s * (T::STATS / 4);   // LSE2, then D
        mbar_wait(full + 8 * s, ph);
        wgmma_fence();
        mm_ss<DP>(st, ka, 2 * BOX, qt);                  // S^T = K Q^T
        wgmma_commit();
        mm_ss<DP>(dpt, va, 2 * BOX, ot);                 // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<32>(st);
        // P^T (value 4 j + e: key r0 + 8 (e / 2), query q0 + t2 + 8 j +
        // e % 2); a query without a visible key (LSE -inf) gives 0
        const bool masked = cut_queries(a, wk0, q0);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = t2 + 8 * j + (e & 1);
            const float lse = L[qc];
            const bool ok = lse != -INFINITY &&
                            (!masked || visible(a, q0 + qc,
                                                e < 2 ? r0 : r0 + 8));
            st[4 * j + e] = ok ? exp2f(st[4 * j + e] * sl2 - lse) : 0.f;
          }
        to_a(st, pa);
        wgmma_fence();
        mm_rs<DP>(dv, pa, ot);                           // dv += P^T dO
        wgmma_commit();
        wgmma_wait<1>();                                 // dP^T is done
        fence_regs<32>(dpt);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * j + e] = st[4 * j + e] *
                             (dpt[4 * j + e] - L[64 + t2 + 8 * j + (e & 1)]);
        to_a(dpt, pb);
        wgmma_fence();
        mm_rs<DP>(dk, pb, qt);                           // dk += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<T::NACC>(dk);
        fence_regs<T::NACC>(dv);
        fence_regs_u32<16>(&pa[0][0]);   // read by the products until here
        fence_regs_u32<16>(&pb[0][0]);
        mbar_arrive(empty + 8 * s);
      }

      bf16* dko = static_cast<bf16*>(a.out[1]) + b * a.s[DK][0] +
                  hk * a.s[DK][1];
      bf16* dvo = static_cast<bf16*>(a.out[2]) + b * a.s[DV][0] +
                  hk * a.s[DV][1];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + t2;
        if (r0 < a.Tk) {
          *reinterpret_cast<uint32_t*>(dko + r0 * a.s[DK][2] + col) =
              pack_bf16(dk[4 * j] * a.scale, dk[4 * j + 1] * a.scale);
          *reinterpret_cast<uint32_t*>(dvo + r0 * a.s[DV][2] + col) =
              pack_bf16(dv[4 * j], dv[4 * j + 1]);
        }
        if (r0 + 8 < a.Tk) {
          *reinterpret_cast<uint32_t*>(dko + (r0 + 8) * a.s[DK][2] + col) =
              pack_bf16(dk[4 * j + 2] * a.scale, dk[4 * j + 3] * a.scale);
          *reinterpret_cast<uint32_t*>(dvo + (r0 + 8) * a.s[DV][2] + col) =
              pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int FR = 32;    // rows a block (queries in dq, keys in dkdv)
constexpr int FC = 32;    // columns a step (keys in dq, queries in dkdv)

// Rows [r0, r0 + FR) of a float32 (t, d) slab into a shared tile of row
// stride DP + 1, zero past nvalid rows and D columns.
template <int DP>
__device__ __forceinline__ void stage_f32(float* s, const float* g,
                                          long long st, int nvalid, int D) {
  for (int e = threadIdx.x; e < FR * DP; e += THREADS) {
    const int r = e / DP, d = e % DP;
    s[r * (DP + 1) + d] = (r < nvalid && d < D) ? g[r * st + d] : 0.f;
  }
}

template <int DP>
__device__ __forceinline__ float dot_f32(const float* x, const float* y) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < DP; ++d) acc = fmaf(x[d], y[d], acc);
  return acc;
}

// 4 threads (a quad) a query row; thread c owns keys c + 4 j of a step and
// columns c + 4 i of dq.
template <int DP>
__global__ void __launch_bounds__(THREADS) bwd_dq_f32(Args a) {
  constexpr int LD = DP + 1, PER = DP / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // FR x LD
  float* sO = sQ + FR * LD;                        // dO
  float* sK = sO + FR * LD;                        // FC x LD
  float* sV = sK + FC * LD;
  float* sP = sV + FC * LD;                        // FR x (FC + 1)

  const int bh = blockIdx.y, b = bh / a.Hq, h = bh % a.Hq, hk = h / a.G;
  const int q0 = blockIdx.x * FR;
  const int r = threadIdx.x / 4, c = threadIdx.x % 4, row = q0 + r;
  const float* q = static_cast<const float*>(a.in[Q]) + b * a.s[Q][0] +
                   h * a.s[Q][1];
  const float* k = static_cast<const float*>(a.in[K]) + b * a.s[K][0] +
                   hk * a.s[K][1];
  const float* v = static_cast<const float*>(a.in[V]) + b * a.s[V][0] +
                   hk * a.s[V][1];
  const float* o = static_cast<const float*>(a.in[O]) + b * a.s[O][0] +
                   h * a.s[O][1];
  const float* dO = static_cast<const float*>(a.in[DO]) + b * a.s[DO][0] +
                    h * a.s[DO][1];
  stage_f32<DP>(sQ, q + q0 * a.s[Q][2], a.s[Q][2], a.Tq - q0, a.D);
  stage_f32<DP>(sO, dO + q0 * a.s[DO][2], a.s[DO][2], a.Tq - q0, a.D);
  __syncthreads();

  float di = 0.f;
  if (row < a.Tq)
    for (int d = c; d < a.D; d += 4) di += o[row * a.s[O][2] + d] * sO[r * LD + d];
  di += __shfl_xor_sync(0xffffffffu, di, 1);
  di += __shfl_xor_sync(0xffffffffu, di, 2);

  int lo, hi;
  kv_range(a, q0, min(q0 + FR, a.Tq), &lo, &hi);
  const int first = (lo / FC) * FC;
  auto stage_kv = [&](int k0, bool with_v) {
    __syncthreads();
    stage_f32<DP>(sK, k + k0 * a.s[K][2], a.s[K][2], a.Tk - k0, a.D);
    if (with_v)
      stage_f32<DP>(sV, v + k0 * a.s[V][2], a.s[V][2], a.Tk - k0, a.D);
    __syncthreads();
  };

  float m = -INFINITY, l = 0.f;
  for (int k0 = first; k0 < hi; k0 += FC) {
    stage_kv(k0, false);
    float s[FC / 4], mx = m;
#pragma unroll
    for (int j = 0; j < FC / 4; ++j) {
      const int kc = c + 4 * j;
      s[j] = visible(a, row, k0 + kc)
                 ? dot_f32<DP>(sQ + r * LD, sK + kc * LD) * a.scale
                 : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float base = mx == -INFINITY ? 0.f : mx;
    l *= expf(m - base);
#pragma unroll
    for (int j = 0; j < FC / 4; ++j) l += expf(s[j] - base);
    m = mx;
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const float lse = m == -INFINITY ? -INFINITY : m + logf(l);

  float dq[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) dq[i] = 0.f;
  for (int k0 = first; k0 < hi; k0 += FC) {
    stage_kv(k0, true);
#pragma unroll
    for (int j = 0; j < FC / 4; ++j) {
      const int kc = c + 4 * j;
      float ds = 0.f;
      if (visible(a, row, k0 + kc) && lse != -INFINITY) {
        const float p = expf(
            dot_f32<DP>(sQ + r * LD, sK + kc * LD) * a.scale - lse);
        ds = p * (dot_f32<DP>(sO + r * LD, sV + kc * LD) - di);
      }
      sP[r * (FC + 1) + kc] = ds;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = c + 4 * i;
      float acc = dq[i];
#pragma unroll 8
      for (int kc = 0; kc < FC; ++kc)
        acc = fmaf(sP[r * (FC + 1) + kc], sK[kc * LD + d], acc);
      dq[i] = acc;
    }
  }
  if (row < a.Tq) {
    float* dqo = static_cast<float*>(a.out[0]) + b * a.s[DQ][0] +
                 h * a.s[DQ][1] + row * a.s[DQ][2];
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (c + 4 * i < a.D) dqo[c + 4 * i] = dq[i] * a.scale;
    if (c == 0) {
      a.lse[static_cast<long long>(bh) * a.Tq + row] = lse;
      a.dsum[static_cast<long long>(bh) * a.Tq + row] = di;
    }
  }
}

// 4 threads a key; thread c owns queries c + 4 j of a step and columns
// c + 4 i of dk and dv.
template <int DP>
__global__ void __launch_bounds__(THREADS) bwd_dkdv_f32(Args a) {
  constexpr int LD = DP + 1, PER = DP / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // FR x LD
  float* sV = sK + FR * LD;
  float* sQ = sV + FR * LD;                        // FC x LD
  float* sO = sQ + FC * LD;                        // dO
  float* sP = sO + FC * LD;                        // FR x (FC + 1): P^T
  float* sS = sP + FR * (FC + 1);                  // dS^T
  float* sL = sS + FR * (FC + 1);                  // FC: LSE
  float* sD = sL + FC;                             // FC: D_i

  const int bh = blockIdx.y, b = bh / a.Hkv, hk = bh % a.Hkv;
  const int k0 = blockIdx.x * FR;
  const int r = threadIdx.x / 4, c = threadIdx.x % 4, key = k0 + r;
  const float* k = static_cast<const float*>(a.in[K]) + b * a.s[K][0] +
                   hk * a.s[K][1];
  const float* v = static_cast<const float*>(a.in[V]) + b * a.s[V][0] +
                   hk * a.s[V][1];
  stage_f32<DP>(sK, k + k0 * a.s[K][2], a.s[K][2], a.Tk - k0, a.D);
  stage_f32<DP>(sV, v + k0 * a.s[V][2], a.s[V][2], a.Tk - k0, a.D);

  int lo, hi;
  q_range(a, k0, min(k0 + FR, a.Tk), &lo, &hi);
  const int first = (lo / FC) * FC;
  float dk[PER], dv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) dk[i] = dv[i] = 0.f;
  for (int gi = 0; gi < a.G; ++gi) {
    const int h = hk * a.G + gi;
    const float* q = static_cast<const float*>(a.in[Q]) + b * a.s[Q][0] +
                     h * a.s[Q][1];
    const float* dO = static_cast<const float*>(a.in[DO]) + b * a.s[DO][0] +
                      h * a.s[DO][1];
    const long long base = (static_cast<long long>(b) * a.Hq + h) * a.Tq;
    for (int q0 = first; q0 < hi; q0 += FC) {
      __syncthreads();
      stage_f32<DP>(sQ, q + q0 * a.s[Q][2], a.s[Q][2], a.Tq - q0, a.D);
      stage_f32<DP>(sO, dO + q0 * a.s[DO][2], a.s[DO][2], a.Tq - q0, a.D);
      for (int e = threadIdx.x; e < FC; e += THREADS) {
        const bool ok = q0 + e < a.Tq;
        sL[e] = ok ? a.lse[base + q0 + e] : -INFINITY;
        sD[e] = ok ? a.dsum[base + q0 + e] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < FC / 4; ++j) {
        const int qc = c + 4 * j;
        float p = 0.f, ds = 0.f;
        if (visible(a, q0 + qc, key) && sL[qc] != -INFINITY) {
          p = expf(dot_f32<DP>(sK + r * LD, sQ + qc * LD) * a.scale - sL[qc]);
          ds = p * (dot_f32<DP>(sV + r * LD, sO + qc * LD) - sD[qc]);
        }
        sP[r * (FC + 1) + qc] = p;
        sS[r * (FC + 1) + qc] = ds;
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int d = c + 4 * i;
        float av = dv[i], ak = dk[i];
#pragma unroll 8
        for (int qc = 0; qc < FC; ++qc) {
          av = fmaf(sP[r * (FC + 1) + qc], sO[qc * LD + d], av);
          ak = fmaf(sS[r * (FC + 1) + qc], sQ[qc * LD + d], ak);
        }
        dv[i] = av;
        dk[i] = ak;
      }
    }
  }
  if (key < a.Tk) {
    float* dko = static_cast<float*>(a.out[1]) + b * a.s[DK][0] +
                 hk * a.s[DK][1] + key * a.s[DK][2];
    float* dvo = static_cast<float*>(a.out[2]) + b * a.s[DV][0] +
                 hk * a.s[DV][1] + key * a.s[DV][2];
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (c + 4 * i < a.D) {
        dko[c + 4 * i] = dk[i] * a.scale;
        dvo[c + 4 * i] = dv[i];
      }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const Args& a,
                   cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
int launch_bf16(const Args& a, int B, cudaStream_t s) {
  const dim3 g1((a.Tq + DqTile<DP>::BM - 1) / DqTile<DP>::BM, B * a.Hq);
  cudaError_t e = launch(bwd_dq_bf16<DP>, g1, DqTile<DP>::SMEM, a, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g2((a.Tk + KvTile<DP>::BN - 1) / KvTile<DP>::BN, B * a.Hkv);
  return static_cast<int>(
      launch(bwd_dkdv_bf16<DP>, g2, KvTile<DP>::SMEM, a, s));
}

template <int DP>
int launch_f32(const Args& a, int B, cudaStream_t s) {
  const size_t s1 = (4 * FR * (DP + 1) + FR * (FC + 1)) * sizeof(float);
  cudaError_t e = launch(bwd_dq_f32<DP>, dim3((a.Tq + FR - 1) / FR, B * a.Hq),
                         s1, a, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t s2 =
      (4 * FR * (DP + 1) + 2 * FR * (FC + 1) + 2 * FC) * sizeof(float);
  return static_cast<int>(launch(
      bwd_dkdv_f32<DP>, dim3((a.Tk + FR - 1) / FR, B * a.Hkv), s2, a, s));
}

template <int DP>
int launch_sm90(const Args& a, int B, cudaStream_t s) {
  using T = Sm90<DP>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv, mdo;   // boxes of 64 rows x 64 columns
  const bool ok =
      encode(enc, &mq, a.in[Q], a.D, a.Tq, a.Hq, B, a.s[Q][0], a.s[Q][1],
             a.s[Q][2], 64) &&
      encode(enc, &mk, a.in[K], a.D, a.Tk, a.Hkv, B, a.s[K][0], a.s[K][1],
             a.s[K][2], 64) &&
      encode(enc, &mv, a.in[V], a.D, a.Tk, a.Hkv, B, a.s[V][0], a.s[V][1],
             a.s[V][2], 64) &&
      encode(enc, &mdo, a.in[DO], a.D, a.Tq, a.Hq, B, a.s[DO][0],
             a.s[DO][1], a.s[DO][2], 64);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * a.Hq * a.Tqp;
  bwd_prep<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(a, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(bwd_dq_sm90<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dq_sm90<DP><<<dim3(B * a.Hq, a.Tqp / 128), SM90_THREADS, T::SMEM, s>>>(
      mq, mk, mv, mdo, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(bwd_dkdv_sm90<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dkdv_sm90<DP><<<dim3(B * a.Hkv, (a.Tk + 127) / 128), SM90_THREADS,
                      T::SMEM, s>>>(mq, mk, mv, mdo, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 2 = bfloat16. q, o, dO and dq are (B, Hq, Tq, D),
// k, v, dk and dv (B, Hkv, Tk, D), each with the element strides given for
// its first three axes (in the order q, k, v, o, dO, dq, dk, dv: 24 values)
// and unit stride over D. lse and dsum are contiguous (B, Hq, Tq) float32
// scratch, written by the first kernel and read by the second. bfloat16
// needs D % 8 == 0, 16-byte aligned base pointers and strides that are
// multiples of 8 elements (the wrapper pads anything else). window <= 0
// means none. Returns the first CUDA error of the two launches, or 0.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* dsum, int B,
                                   int Hq, int Hkv, int Tq, int Tk, int D,
                                   const long long* strides, float scale,
                                   int q_offset, int causal, int window,
                                   void* stream) {
  if ((dtype != 0 && dtype != 2) || D < 1 || D > 256 || Hkv < 1 ||
      Hq % Hkv != 0 || B * Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.in[0] = q; a.in[1] = k; a.in[2] = v; a.in[3] = o; a.in[4] = dout;
  a.out[0] = dq; a.out[1] = dk; a.out[2] = dv;
  a.lse = static_cast<float*>(lse);
  a.dsum = static_cast<float*>(dsum);
  a.Hq = Hq; a.Hkv = Hkv; a.G = Hq / Hkv; a.Tq = Tq; a.Tk = Tk; a.D = D;
  for (int i = 0; i < NARR; ++i)
    for (int j = 0; j < 3; ++j) a.s[i][j] = strides[3 * i + j];
  a.scale = scale; a.q_offset = q_offset; a.causal = causal;
  a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 2) {
    bool aligned = D % 8 == 0;
    for (const void* p : {q, k, v, o, dout, static_cast<const void*>(dq),
                          static_cast<const void*>(dk),
                          static_cast<const void*>(dv)})
      aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    for (int i = 0; i < 3 * NARR; ++i) aligned = aligned && strides[i] % 8 == 0;
    if (!aligned) return static_cast<int>(cudaErrorMisalignedAddress);
    if (D <= 64) return launch_bf16<64>(a, B, s);
    if (D <= 128) return launch_bf16<128>(a, B, s);
    return launch_bf16<256>(a, B, s);
  }
  if (D <= 16) return launch_f32<16>(a, B, s);
  if (D <= 32) return launch_f32<32>(a, B, s);
  if (D <= 64) return launch_f32<64>(a, B, s);
  if (D <= 128) return launch_f32<128>(a, B, s);
  return launch_f32<256>(a, B, s);
}

// The wgmma route: bfloat16 at D = 64 or 128, what TMA can address (16-byte
// aligned base pointers, strides of q, k, v, dO multiples of 8 elements;
// the wrapper routes anything else to flash_attention_bwd). Arguments as
// flash_attention_bwd's, but lse is the forward's (B, Hq, Tq) natural-log
// LSE (read), and lse2, dsum are float32 (B, Hq, Tqp) scratch with Tqp = Tq
// rounded up to 128, written by the first of the three launches. Returns
// the first CUDA error of the three, or 0.
extern "C" int flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* lse2, void* dsum, int B, int Hq, int Hkv, int Tq, int Tk, int D,
    const long long* strides, float scale, int q_offset, int causal,
    int window, void* stream) {
  if ((D != 64 && D != 128) || Hkv < 1 || Hq % Hkv != 0 || Tq < 1 ||
      Tk < 1 || static_cast<long long>(B) * Hq > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  bool aligned = true;
  for (const void* p : {q, k, v, o, dout, static_cast<const void*>(dq),
                        static_cast<const void*>(dk),
                        static_cast<const void*>(dv),
                        static_cast<const void*>(lse2),
                        static_cast<const void*>(dsum)})
    aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (int i = 0; i < 3 * NARR; ++i) aligned = aligned && strides[i] % 8 == 0;
  if (!aligned) return static_cast<int>(cudaErrorMisalignedAddress);
  Args a{};
  a.in[0] = q; a.in[1] = k; a.in[2] = v; a.in[3] = o; a.in[4] = dout;
  a.out[0] = dq; a.out[1] = dk; a.out[2] = dv;
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.dsum = static_cast<float*>(dsum);
  a.lse2 = static_cast<float*>(lse2);
  a.Hq = Hq; a.Hkv = Hkv; a.G = Hq / Hkv; a.Tq = Tq; a.Tk = Tk; a.D = D;
  a.Tqp = (Tq + 127) / 128 * 128;
  for (int i = 0; i < NARR; ++i)
    for (int j = 0; j < 3; ++j) a.s[i][j] = strides[3 * i + j];
  a.scale = scale; a.q_offset = q_offset; a.causal = causal;
  a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_sm90<64>(a, B, s) : launch_sm90<128>(a, B, s);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
