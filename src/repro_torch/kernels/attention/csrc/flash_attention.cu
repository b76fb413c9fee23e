// flash_attention.cu — forward flash attention (online softmax) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention/flash.py:90
// (flash_attention_flat, body _flash_kernel) together with the head
// broadcast and padding of src/repro/kernels/attention/ops.py:
//   out[b, h, i] = sum_j softmax_j(scale * q[b,h,i] . k[b,h/G,j]) v[b,h/G,j]
// over the keys j that the causal and/or sliding-window mask leaves to the
// query at absolute position i + q_offset. Running max, denominator and
// accumulator are float32; a row with no valid key returns 0
// (acc / max(l, 1e-30)), never NaN. Output in the input type. Given an
// LSE buffer (training records the graph), each kernel also writes every
// row's natural-log log-sum-exp over its visible keys, -inf for a row with
// none, as float32 (B, Hq, Tq): the backward reads it instead of
// recomputing it. Serving passes none and skips that store.
//
// What bounds it on the card: at the prefill shape (B = 4, Hq = 16,
// Hkv = 8, T = 4096, D = 128, causal) it does 4*B*Hq*T*T*D/2 = 275 GFLOP
// on 0.2 GB of q, k, v and out, ~1300 flops per byte, far above the
// ~295 flops/byte where the bf16 tensor cores (989 TFLOP/s) overtake
// HBM (3.35 TB/s): it is bound by bf16 operations on the tensor cores,
// 0.278 ms at that shape.
//
// What the design does about it (bf16, flash_sm90):
//  * One block of 3 warpgroups owns 128 query rows of one (b, h). Warpgroup
//    0 is the producer: after setmaxnreg gives its registers to the others
//    (24 left), one of its threads issues every TMA copy. Warpgroups 1 and
//    2 are consumers (240 registers each) of 64 rows each; both read every
//    K/V tile, so a tile loaded once serves 128 rows.
//  * TMA: Q is loaded once; K and V go through a ring in shared memory
//    of 3 stages (2 at D = 256; 224 and 192 KB in all). full_k[s] /
//    full_v[s] mbarriers carry the transaction bytes of stage s; empty[s]
//    is released by all 256 consumer threads after the wgmma that reads
//    stage s has completed (wgmma.wait_group), so the producer refills a
//    stage only when both products are done with it. The tensor maps are
//    4-D over the (B, H, T, D) views with their own strides (the
//    projections' (B, T, H, D) buffers are read without a copy) and use
//    the 128-byte swizzle: a D-wide row loads as D / 64 boxes of 64
//    columns. Ragged Tq / Tk and D below the tile width come from TMA's
//    zero fill out of bounds; nothing is padded in memory.
//  * S = Q K^T: wgmma m64n{Bk}k16, Q and K both K-major from shared
//    memory, f32 accumulate. Bk = 128 keys for D <= 128, 64 for D = 256
//    (so that the 64 x 256 f32 accumulator fits).
//  * Online softmax on the accumulator registers: exp2f with
//    scale * log2(e) folded into one multiply, row max and sum over the
//    quad that shares a row (shuffles). Only tiles that the causal
//    diagonal, the window or the end of the keys cut are masked; tiles
//    that the mask empties for the whole block are never loaded.
//  * O += P V: wgmma with A from registers. The m64nNk16 accumulator
//    layout of S is the register-A layout of the next product, so P is
//    converted to bf16 in place. V is the B operand read MN-major (the
//    transpose bit), never transposed in shared memory.
//  * Heaviest query tiles first: blockIdx.y runs over query tiles in
//    reverse, so the longest causal rows start in the first wave.
//  * GQA without the copy: query head h reads KV head h / (Hq / Hkv).
//  * Decode (Tq = 1, q_offset = cache length) is the same kernel: the loop
//    covers the filled prefix of the cache only; the consumer warpgroup
//    whose 64 rows lie past Tq only keeps the ring turning.
//  * The tensor maps are encoded on the host inside the C entry point
//    (cuTensorMapEncodeTiled, taken through cudaGetDriverEntryPoint so
//    that no libcuda link is needed) and passed as __grid_constant__
//    parameters: one launch is still one ctypes call.
//  float32 has no tensor-core path of full precision, so f32 inputs take
//  an FMA kernel on the CUDA cores (flash_f32: 32 x 32 tiles, f32 softmax
//  via expf): the consistency checks in f32 use it, the bf16 serving path
//  does not.
//  What holds it back (0.66 ms at the prefill shape on an H100 SXM at
//  700 W, 42% of the bf16 peak): each consumer runs its products and its
//  softmax in turn, and the two consumers drift into step, so the softmax
//  on the CUDA cores (exp2, max, sums, the bf16 packing: about as long as
//  the products) rarely overlaps the tensor cores. Later work (not here):
//  FA3's ping-pong, which orders the consumers with named barriers so that
//  one's softmax runs under the other's products; a split-KV decode; a
//  persistent scheduler.

#include <math.h>

#include <chrono>

#include "flash_sm90.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, Hq, Tq) natural-log LSE, or null: not written
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
// bf16 on Hopper: TMA ring, producer warpgroup, wgmma for both products
// ---------------------------------------------------------------------------

constexpr int SM90_THREADS = 384;  // producer + 2 consumer warpgroups
constexpr int BM = 128;            // query rows per block, 64 per consumer

template <int DP>
struct Tile {
  static constexpr int BK = DP <= 128 ? 128 : 64;  // keys per tile
  static constexpr int STAGES = DP <= 128 ? 3 : 2;  // K/V ring depth
  static constexpr int CH = DP / 64;               // 128-byte column boxes
  static constexpr int Q_CHUNK = BM * 128;         // bytes of one Q box
  static constexpr int KV_CHUNK = BK * 128;        // bytes of one K/V box
  static constexpr int Q_BYTES = CH * Q_CHUNK;
  static constexpr int KV_BYTES = CH * KV_CHUNK;   // one K (or V) stage
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES;  // <= 224 KB
  static constexpr int NS = BK / 2;                // score registers
  static constexpr int NO = DP / 2;                // output registers
  static constexpr int PV_N = DP <= 128 ? DP : 128;  // width of one P.V
  static constexpr int PV_PARTS = DP / PV_N;
};


// S (64 x Bk) = Q K^T for one consumer warpgroup: Q at `qa` (its 64 rows)
// and the stage's K at `k`, both K-major in 64-column boxes.
template <int DP>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t qa, uint32_t k) {
  using T = Tile<DP>;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss<T::BK>(
        sc, sw128_desc(qa + (kk / 4) * T::Q_CHUNK + (kk % 4) * 32, 16),
        sw128_desc(k + (kk / 4) * T::KV_CHUNK + (kk % 4) * 32, 16), kk > 0);
}

// O (64 x D) += P V: P from registers, the stage's V at `v` read MN-major
// (keys 16 kk .. 16 kk + 15 are 2048 bytes on; its 64-column boxes are
// KV_CHUNK apart).
template <int DP>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t (*pa)[4],
                                         uint32_t v) {
  using T = Tile<DP>;
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk)
#pragma unroll
    for (int p = 0; p < T::PV_PARTS; ++p)
      wgmma_rs<T::PV_N>(
          o + p * (T::PV_N / 2), pa[kk],
          sw128_desc(v + p * (T::PV_N / 64) * T::KV_CHUNK + kk * 2048,
                     T::KV_CHUNK));
}

// A key tile [k0, k0 + bk) needs a mask when the causal diagonal, the
// window or the end of the keys cuts it for some row of a warpgroup whose
// rows sit at absolute positions [p_lo, p_hi].
__device__ __forceinline__ bool cut(const Args& a, int k0, int bk,
                                    long long p_lo, long long p_hi) {
  return k0 + bk > a.Tk || (a.causal && k0 + bk - 1 > p_lo) ||
         (a.window > 0 && k0 <= p_hi - a.window);
}

// P in bf16, in place of the score accumulator: keys 16 kk .. 16 kk + 15
// are the register-A operand of step kk of P V.
template <int BK>
__device__ __forceinline__ void pack_p(const float* sc, uint32_t (*pa)[4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// Online softmax state of a thread's two rows (r0 and r0 + 8), in the log2
// domain: running max m, partial sum l over this thread's columns (the
// quad's four partial sums are added at the end), sl2 = scale * log2(e).
struct Softmax {
  float m0, m1, l0, l1, sl2;

  // Scores of one tile (accumulator layout of m64n{BK}: value 4 j + e is
  // row r0 + 8 (e / 2), key kc + 8 j + (e % 2)) in, probabilities out;
  // returns the factors that rescale the accumulator.
  template <int BK>
  __device__ __forceinline__ void tile(float* sc, const Args& a, bool cut,
                                       int r0, int kc, float* al0,
                                       float* al1) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] *= sl2;
    if (cut) {       // only tiles that the diagonal, window or end cut
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(a, e < 2 ? r0 : r0 + 8, kc + 8 * j + (e & 1)))
            sc[4 * j + e] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // a row that has seen no key yet keeps max -inf: subtract 0 there, so
    // that exp2f gives 0 and never NaN
    const float b0 = mx0 == -INFINITY ? 0.f : mx0;
    const float b1 = mx1 == -INFINITY ? 0.f : mx1;
    *al0 = exp2f(m0 - b0);
    *al1 = exp2f(m1 - b1);
    m0 = mx0;
    m1 = mx1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[4 * j] = exp2f(sc[4 * j] - b0);
      sc[4 * j + 1] = exp2f(sc[4 * j + 1] - b0);
      sc[4 * j + 2] = exp2f(sc[4 * j + 2] - b1);
      sc[4 * j + 3] = exp2f(sc[4 * j + 3] - b1);
      ls0 += sc[4 * j] + sc[4 * j + 1];
      ls1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * *al0 + ls0;
    l1 = l1 * *al1 + ls1;
  }
};

template <int DP>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_sm90(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, Args a) {
  using T = Tile<DP>;
  constexpr int BK = T::BK, STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  // 128-byte swizzled tiles need 1024-byte aligned bases
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + T::Q_BYTES;               // + s * KV_BYTES
  const uint32_t sV = sK + STAGES * T::KV_BYTES;     // + s * KV_BYTES
  const uint32_t full_q = smem_u32(&bars[0]);
  const uint32_t full_k = smem_u32(&bars[1]);           // + 8 s
  const uint32_t full_v = smem_u32(&bars[1 + STAGES]);  // + 8 s
  const uint32_t empty = smem_u32(&bars[1 + 2 * STAGES]);

  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest tiles first
  int lo, hi;
  kv_range(a, q0, min(q0 + BM, a.Tq), &lo, &hi);
  const int k_first = (lo / BK) * BK;
  const int n_tiles = hi > k_first ? (hi - k_first + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
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
      mbar_expect_tx(full_q, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::CH; ++c)
        tma_load(sQ + c * T::Q_CHUNK, &tq, full_q, 64 * c, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int k0 = k_first + it * BK;
        mbar_wait(empty + 8 * s, ph ^ 1);  // the first round passes at once
        mbar_expect_tx(full_k + 8 * s, T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::CH; ++c)
          tma_load(sK + s * T::KV_BYTES + c * T::KV_CHUNK, &tk,
                   full_k + 8 * s, 64 * c, k0, hk, b);
        mbar_expect_tx(full_v + 8 * s, T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::CH; ++c)
          tma_load(sV + s * T::KV_BYTES + c * T::KV_CHUNK, &tv,
                   full_v + 8 * s, 64 * c, k0, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid % 32;
    const int wq0 = q0 + 64 * cw;                       // warpgroup's row 0
    const int r0 = wq0 + 16 * (tid / 32) + lane / 4;    // rows r0, r0 + 8
    const int t2 = 2 * (lane % 4);
    if (wq0 >= a.Tq) {
      // no row of this warpgroup exists (decode, ragged Tq): only release
      // each stage once its tiles have landed, so the ring keeps turning
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        mbar_wait(full_k + 8 * s, ph);
        mbar_wait(full_v + 8 * s, ph);
        mbar_arrive(empty + 8 * s);
      }
    } else {
      float o[T::NO];
#pragma unroll
      for (int i = 0; i < T::NO; ++i) o[i] = 0.f;
      Softmax sm{-INFINITY, -INFINITY, 0.f, 0.f, a.scale * LOG2E};
      const uint32_t qa = sQ + 64 * cw * 128;
      // absolute positions of the warpgroup's first and last rows
      const long long p_lo = static_cast<long long>(wq0) + a.q_offset;
      const long long p_hi = p_lo + 63;
      float sc[T::NS];
      uint32_t pa[BK / 16][4];
      mbar_wait(full_q, 0);

      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int k0 = k_first + it * BK;

        mbar_wait(full_k + 8 * s, ph);
        wgmma_fence();
        issue_qk<DP>(sc, qa, sK + s * T::KV_BYTES);     // S = Q K^T
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<T::NS>(sc);

        float al0, al1;
        sm.tile<BK>(sc, a, cut(a, k0, BK, p_lo, p_hi), r0, k0 + t2, &al0,
                    &al1);
        pack_p<BK>(sc, pa);
#pragma unroll
        for (int i = 0; i < T::NO / 4; ++i) {
          o[4 * i] *= al0;
          o[4 * i + 1] *= al0;
          o[4 * i + 2] *= al1;
          o[4 * i + 3] *= al1;
        }

        mbar_wait(full_v + 8 * s, ph);
        fence_regs<T::NO>(o);
        wgmma_fence();
        issue_pv<DP>(o, pa, sV + s * T::KV_BYTES);      // O += P V
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<T::NO>(o);
        mbar_arrive(empty + 8 * s);   // both products are done with stage s
      }
      float l0 = sm.l0, l1 = sm.l1;

      // epilogue: the row sums are spread over the quad
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      if (a.lse != nullptr && t2 == 0) {
        // the quad shares m and l: LSE = (m + log2 l) ln 2 in natural log
        float* lrow = a.lse + static_cast<long long>(bh) * a.Tq;
        if (r0 < a.Tq)
          lrow[r0] = sm.m0 == -INFINITY ? -INFINITY
                                        : (sm.m0 + log2f(l0)) * LN2;
        if (r0 + 8 < a.Tq)
          lrow[r0 + 8] = sm.m1 == -INFINITY ? -INFINITY
                                            : (sm.m1 + log2f(l1)) * LN2;
      }
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + b * a.sob +
                           h * a.soh;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + t2;      // D % 8 == 0: col + 1 < D too
        if (col < a.D) {
          if (r0 < a.Tq)
            *reinterpret_cast<uint32_t*>(out + r0 * a.sot + col) =
                pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
          if (r0 + 8 < a.Tq)
            *reinterpret_cast<uint32_t*>(out + (r0 + 8) * a.sot + col) =
                pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
        }
      }
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
    if (a.lse != nullptr && c == 0)   // m is the row's max once l > 0
      a.lse[static_cast<long long>(bh) * a.Tq + row] =
          l > 0.f ? m + logf(l) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

double g_encode_us = 0.0;  // host time of the last launch's three encodes

template <int DP>
int launch_sm90(const Args& a, int B, int Hkv, cudaStream_t stream) {
  using T = Tile<DP>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const auto t0 = std::chrono::steady_clock::now();
  CUtensorMap mq, mk, mv;
  const bool ok =
      encode(enc, &mq, a.q, a.D, a.Tq, a.Hq, B, a.sqb, a.sqh, a.sqt, BM) &&
      encode(enc, &mk, a.k, a.D, a.Tk, Hkv, B, a.skb, a.skh, a.skt, T::BK) &&
      encode(enc, &mv, a.v, a.D, a.Tk, Hkv, B, a.svb, a.svh, a.svt, T::BK);
  g_encode_us = std::chrono::duration<double, std::micro>(
                    std::chrono::steady_clock::now() - t0)
                    .count();
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = T::SMEM + 1024;  // + room to align the base
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_sm90<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * a.Hq, (a.Tq + BM - 1) / BM);
  flash_sm90<DP><<<grid, SM90_THREADS, smem, stream>>>(mq, mk, mv, a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_f32(const Args& a, int batch_heads, cudaStream_t stream) {
  const size_t smem =
      (FQ * (DP + 1) + FK * (DP + 1) + FK * DP + FQ * (FK + 1)) *
      sizeof(float);
  cudaFuncSetAttribute(flash_f32<DP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 grid((a.Tq + FQ - 1) / FQ, batch_heads);
  flash_f32<DP><<<grid, FTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 2 = bfloat16. q is (B, Hq, Tq, D), k/v (B, Hkv, Tk, D)
// and out (B, Hq, Tq, D), each with the given element strides for its first
// three axes and unit stride over D. G = Hq / Hkv. window <= 0 means none.
// bfloat16 takes flash_sm90 and needs what TMA can address: D % 8 == 0,
// 16-byte aligned base pointers and strides that are multiples of 8
// elements (the wrapper pads anything else). Its grid is (B * Hq, query
// tiles); float32's is (query tiles, B * Hq). lse: a contiguous float32
// (B, Hq, Tq) buffer for each row's natural-log log-sum-exp, or null.
// Returns cudaGetLastError().
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int Hq,
                               int Hkv, int Tq, int Tk, int D,
                               const long long* strides, float scale,
                               int q_offset, int causal, int window,
                               void* lse, void* stream) {
  if ((dtype != 0 && dtype != 2) || D < 1 || D > 256 || Hkv < 1 ||
      Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, out, static_cast<float*>(lse), Hq, Hq / Hkv, Tq, Tk, D,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], strides[8], strides[9],
         strides[10], strides[11], scale, q_offset, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 2) {
    bool aligned = D % 8 == 0;
    for (const void* p : {q, k, v, static_cast<const void*>(out)})
      aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    for (int i = 0; i < 12; ++i) aligned = aligned && strides[i] % 8 == 0;
    if (!aligned) return static_cast<int>(cudaErrorMisalignedAddress);
    if (D <= 64) return launch_sm90<64>(a, B, Hkv, s);
    if (D <= 128) return launch_sm90<128>(a, B, Hkv, s);
    return launch_sm90<256>(a, B, Hkv, s);
  }
  const int bh = B * Hq;
  if (D <= 16) return launch_f32<16>(a, bh, s);
  if (D <= 32) return launch_f32<32>(a, bh, s);
  if (D <= 64) return launch_f32<64>(a, bh, s);
  if (D <= 128) return launch_f32<128>(a, bh, s);
  return launch_f32<256>(a, bh, s);
}

// Host microseconds that the last bf16 launch spent encoding its three
// tensor maps.
extern "C" double flash_last_encode_us() { return g_encode_us; }

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
