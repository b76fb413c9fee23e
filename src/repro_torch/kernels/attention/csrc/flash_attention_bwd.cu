// flash_attention_bwd.cu — backward of flash attention (FA2's two passes).
//
// The port's own kernel: the JAX package defines no backward for
// src/repro/kernels/attention/flash.py:90 (flash_attention_flat); its
// training tests differentiate the jnp reference. Given q, k, v, the
// forward's output o and the incoming dO, with s = scale q.k over the keys
// the causal and/or sliding-window mask leaves to each query (as in
// flash_attention.cu), it computes
//   LSE_i = log sum_j exp(s_ij),  P_ij = exp(s_ij - LSE_i),
//   D_i   = rowsum(dO_i o O_i),   dS_ij = P_ij (dO_i . v_j - D_i),
//   dq_i  = scale sum_j dS_ij k_j,
//   dk_j  = scale sum_{h in j's group, i} dS_ij q_i,  dv_j = sum P_ij dO_i.
// A row with no valid key has LSE = -inf, P = 0 and zero gradients, never
// NaN. GQA: query head h reads KV head h / G; a dk/dv block loops over the
// G query heads of its KV head, so nothing is repeated in memory.
//
// Two kernels, launched in order on one stream; no float atomics, so two
// launches on the same inputs give the same bits:
//  * dq (query-tile-major): a block owns 64 query rows of one (b, h), 16 a
//    warp. It forms D_i from o and dO, passes once over the visible keys to
//    recompute each row's LSE (the forward does not write it), then again
//    for dq; it writes dq, LSE and D.
//  * dkdv (key-tile-major): a block owns 64 keys (32 at D = 256) of one
//    (b, hk) and loops over (query head, 32-row query tile) pairs that can
//    see them, reading LSE and D; it writes dk and dv.
//
// bfloat16 (dtype 2): every product is mma.sync m16n8k16 bf16 with f32
// accumulators (P and dS rounded to bf16 for their products, as FA2 does).
// Operands are staged by cp.async (16 bytes, zero fill past the rows and D)
// into row-padded shared tiles (rows of D + 8 elements: fragment loads hit
// distinct banks), double buffered: tile t + 1 copies while tile t
// computes. A score accumulator's layout is the A layout of the next
// product, so P and dS go from registers to the tensor cores directly; a
// B operand whose rows are the contraction (K, Q, dO in dq += dS K,
// dk += dS^T Q, dv += P^T dO) is gathered as bf16 pairs from shared memory.
// float32 (dtype 0): the same two passes on the CUDA cores (FMA), for the
// consistency checks and float32 training.
//
// What bounds it: at qwen3-1.7b's prefill shape (B = 4, Hq = 16, Hkv = 8,
// T = 4096, D = 128, causal) the function needs five products over the
// causal half (S, dP, dq, dk, dv) plus the LSE recompute's one: 825 GFLOP
// at 989 TFLOP/s bf16 = 0.83 ms; bytes (q, k, v, o, dO read, dq, dk, dv
// written) take 0.12 ms. This design runs eight products (S in both
// kernels and in the LSE pass, dP in both), on mma.sync rather than wgmma,
// and gathers transposed B operands element by element: later work (a
// wgmma redesign, an LSE output from the forward) is in ROADMAP.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

enum { Q, K, V, O, DO, DQ, DK, DV, NARR };

struct Args {
  const void* in[5];  // q, k, v, o, dO
  void* out[3];       // dq, dk, dv
  float* lse;         // (B, Hq, Tq), natural log; written by dq
  float* dsum;        // (B, Hq, Tq), D_i; written by dq
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
