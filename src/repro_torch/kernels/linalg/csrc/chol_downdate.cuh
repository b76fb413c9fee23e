// chol_downdate.cuh — the device code of the Cholesky downdate, shared by
// the kernel's library (chol_downdate.cu, whose header sets out the design)
// and its probes' (chol_downdate_probe.cu). The kernel is a template on
// PROBE: the shipped library instantiates only PROBE = false, the downdate;
// the probes' library the chain probe (PROBE = true: the diagonal and
// sub-diagonal items alone).

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int TILE = 32;             // rows of a row tile, columns of a
                                     // column tile, lanes of a warp
constexpr int NWARPS = 4;            // warps a block
constexpr int NT = 32 * NWARPS;      // threads a block
constexpr unsigned FULL = 0xffffffffu;
using Word = unsigned long long;     // a 32-bit half and its 32-bit tag

template <typename T>
struct Op;
template <>
struct Op<float> {
  static constexpr int MINB = 3;     // blocks an SM: <= 168 registers
  // |x| in [2^-40, 2^40): biased exponent field in [87, 167)
  static constexpr unsigned LO = 87u << 23, SPAN = 80u << 23;
  static __device__ __forceinline__ unsigned ebits(float x) {
    return __float_as_uint(x) & 0x7f800000u;
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float rcp(float a) {
    return __frcp_rn(a);
  }
  static __device__ __forceinline__ float sqrt(float a) {
    return __fsqrt_rn(a);
  }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
};
template <>
struct Op<double> {
  static constexpr int MINB = 2;     // blocks an SM: <= 255 registers
  // |x| in [2^-500, 2^500): biased exponent field in [523, 1523)
  static constexpr unsigned LO = 523u << 20, SPAN = 1000u << 20;
  static __device__ __forceinline__ unsigned ebits(double x) {
    return static_cast<unsigned>(__double2hiint(x)) & 0x7ff00000u;
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double fma(double a, double b,
                                               double c) {
    return __fma_rn(a, b, c);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double rcp(double a) {
    return __drcp_rn(a);
  }
  static __device__ __forceinline__ double sqrt(double a) {
    return __dsqrt_rn(a);
  }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
};

// A rotation: (c, s, 1/c).
template <typename T>
struct Rot {
  T c, s, y;
};

// Relaxed 64- and 128-bit accesses at GPU scope: strong, so each 64-bit
// word is single-copy atomic (a vector access is one per word), and a poll
// reads L2 afresh.
__device__ __forceinline__ void ld_words(const Word* p, Word& a) {
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(a) : "l"(p));
}
__device__ __forceinline__ void ld_words(const Word* p, Word& a, Word& b) {
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(a), "=l"(b)
               : "l"(p));
}
__device__ __forceinline__ void st_words(Word* p, Word a) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" : : "l"(p), "l"(a)
               : "memory");
}
__device__ __forceinline__ void st_words(Word* p, Word a, Word b) {
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};"
               :
               : "l"(p), "l"(a), "l"(b)
               : "memory");
}
__device__ __forceinline__ Word tagged(unsigned half, unsigned tag) {
  return (static_cast<Word>(tag) << 32) | half;
}
__device__ __forceinline__ unsigned tag_of(Word w) {
  return static_cast<unsigned>(w >> 32);
}

// How a value of W and a rotation of R lie in tagged words: a float in one
// word, a double in two (low half, high half); a rotation in 4 (float:
// c, s, 1/c and one unused) or 6 words.
template <typename T>
struct Tags;
template <>
struct Tags<float> {
  static constexpr int WW = 1, RW = 4;
  struct W {
    Word a;
  };
  struct R {
    Word a, b, c, d;
  };
  static __device__ __forceinline__ void load(const Word* p, W& w) {
    ld_words(p, w.a);
  }
  static __device__ __forceinline__ bool ready(const W& w, unsigned tag) {
    return tag_of(w.a) == tag;
  }
  static __device__ __forceinline__ float value(const W& w) {
    return __uint_as_float(static_cast<unsigned>(w.a));
  }
  static __device__ __forceinline__ void store(Word* p, float v,
                                               unsigned tag) {
    st_words(p, tagged(__float_as_uint(v), tag));
  }
  static __device__ __forceinline__ void load(const Word* p, R& r) {
    ld_words(p, r.a, r.b);
    ld_words(p + 2, r.c, r.d);
  }
  static __device__ __forceinline__ bool ready(const R& r, unsigned tag) {
    return tag_of(r.a) == tag && tag_of(r.b) == tag && tag_of(r.c) == tag;
  }
  static __device__ __forceinline__ Rot<float> value(const R& r) {
    return {__uint_as_float(static_cast<unsigned>(r.a)),
            __uint_as_float(static_cast<unsigned>(r.b)),
            __uint_as_float(static_cast<unsigned>(r.c))};
  }
  static __device__ __forceinline__ void store(Word* p, Rot<float> r,
                                               unsigned tag) {
    st_words(p, tagged(__float_as_uint(r.c), tag),
             tagged(__float_as_uint(r.s), tag));
    st_words(p + 2, tagged(__float_as_uint(r.y), tag), 0);
  }
};
template <>
struct Tags<double> {
  static constexpr int WW = 2, RW = 6;
  struct W {
    Word lo, hi;
  };
  struct R {
    Word w[6];
  };
  static __device__ __forceinline__ void load(const Word* p, W& w) {
    ld_words(p, w.lo, w.hi);
  }
  static __device__ __forceinline__ bool ready(const W& w, unsigned tag) {
    return tag_of(w.lo) == tag && tag_of(w.hi) == tag;
  }
  static __device__ __forceinline__ double join(Word lo, Word hi) {
    return __hiloint2double(static_cast<int>(static_cast<unsigned>(hi)),
                            static_cast<int>(static_cast<unsigned>(lo)));
  }
  static __device__ __forceinline__ double value(const W& w) {
    return join(w.lo, w.hi);
  }
  static __device__ __forceinline__ void store(Word* p, double v,
                                               unsigned tag) {
    st_words(p, tagged(static_cast<unsigned>(__double2loint(v)), tag),
             tagged(static_cast<unsigned>(__double2hiint(v)), tag));
  }
  static __device__ __forceinline__ void load(const Word* p, R& r) {
    ld_words(p, r.w[0], r.w[1]);
    ld_words(p + 2, r.w[2], r.w[3]);
    ld_words(p + 4, r.w[4], r.w[5]);
  }
  static __device__ __forceinline__ bool ready(const R& r, unsigned tag) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < 6; ++i) ok &= tag_of(r.w[i]) == tag;
    return ok;
  }
  static __device__ __forceinline__ Rot<double> value(const R& r) {
    return {join(r.w[0], r.w[1]), join(r.w[2], r.w[3]),
            join(r.w[4], r.w[5])};
  }
  static __device__ __forceinline__ void store(Word* p, Rot<double> r,
                                               unsigned tag) {
    store(p, r.c, tag);
    store(p + 2, r.s, tag);
    store(p + 4, r.y, tag);
  }
};

// Poll the tagged words at p (reloading `got`) until they show `tag`. A
// wait of 2^26 polls (over half a minute) can only be a fault: it traps,
// and the launch fails instead of hanging.
template <typename T, typename G>
__device__ __forceinline__ void await(const Word* p, G& got, unsigned tag) {
  for (unsigned polls = 0; !Tags<T>::ready(got, tag);) {
    if (++polls == 1u << 26) __trap();
    __nanosleep(32);
    Tags<T>::load(p, got);
  }
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static __device__ __forceinline__ void split(float4 v, float* w) {
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
  static __device__ __forceinline__ float4 join(const float* w) {
    return make_float4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Vec<double> {
  using type = double2;
  static __device__ __forceinline__ void split(double2 v, double* w) {
    w[0] = v.x;
    w[1] = v.y;
  }
  static __device__ __forceinline__ double2 join(const double* w) {
    return make_double2(w[0], w[1]);
  }
};

// w moves one lane on each step through the warp's exchange rows in shared
// memory: lane k writes its 32 slots (slot s: row s of the tile) to row k,
// and lane k + 1 reads them back; lane 0 reads the sweep that comes in,
// from the warp's input row. Rows are stored in 16-byte pieces, piece m of
// row r at position m ^ key(r), key(r) = r mod 8 (the input row takes key
// 7, the key of row 31, which lane 0 stands in for), so that the 8 lanes of
// each quarter-warp access hit 8 distinct bank groups.
template <typename T>
struct Swz {
  using V = typename Vec<T>::type;
  static constexpr int E = sizeof(V) / sizeof(T);   // values a piece
  // where value i of a row with key `key` lies
  static __device__ __forceinline__ int at(int i, int key) {
    return ((i / E) ^ key) * E + i % E;
  }
  static __device__ __forceinline__ void put(T* row, int key,
                                             const T (&wv)[TILE]) {
#pragma unroll
    for (int m = 0; m < TILE / E; ++m)
      reinterpret_cast<V*>(row)[m ^ key] = Vec<T>::join(wv + E * m);
  }
  static __device__ __forceinline__ void get(const T* row, int key,
                                             T (&wv)[TILE]) {
#pragma unroll
    for (int m = 0; m < TILE / E; ++m)
      Vec<T>::split(reinterpret_cast<const V*>(row)[m ^ key], wv + E * m);
  }
};

// a / c correctly rounded from y = RN(1/c) (see the header): two
// corrections by FMA, no branch.
template <typename T>
__device__ __forceinline__ T quot(T a, T c, T y) {
  using O = Op<T>;
  const T q0 = O::mul(a, y);
  const T q1 = O::fma(O::fma(-c, q0, a), y, q0);
  return O::fma(O::fma(-c, q1, a), y, q1);
}

// One step of a lane's column on its 32 slots, in three passes so that
// the rows' chains interleave: the numerators L - s w (and the range of
// every operand the fast quotient needs; slots outside `mask` are rows that
// do not exist or lie on or above the diagonal, and are left out), the
// quotients, the new w.
template <typename T, bool MASKED>
__device__ __forceinline__ unsigned numerators(T (&lv)[TILE],
                                               const T (&wv)[TILE],
                                               Rot<T> rt, unsigned mask) {
  using O = Op<T>;
  unsigned worst = O::ebits(rt.c) - O::LO;
#pragma unroll
  for (int s = 0; s < TILE; ++s) {
    lv[s] = O::sub(lv[s], O::mul(rt.s, wv[s]));
    const unsigned e = O::ebits(lv[s]) - O::LO;
    if (!MASKED || ((mask >> s) & 1u)) worst = worst > e ? worst : e;
  }
  return worst;   // < SPAN: every operand in range
}
template <typename T>
__device__ __forceinline__ void quotients(T (&lv)[TILE], Rot<T> rt,
                                          bool fast) {
  using O = Op<T>;
  if (fast) {
#pragma unroll
    for (int s = 0; s < TILE; ++s) lv[s] = quot(lv[s], rt.c, rt.y);
  } else {
#pragma unroll
    for (int s = 0; s < TILE; ++s) lv[s] = O::div(lv[s], rt.c);
  }
}
template <typename T>
__device__ __forceinline__ void new_w(const T (&lv)[TILE], T (&wv)[TILE],
                                      Rot<T> rt) {
  using O = Op<T>;
#pragma unroll
  for (int s = 0; s < TILE; ++s)
    wv[s] = O::sub(O::mul(rt.c, wv[s]), O::mul(rt.s, lv[s]));
}
template <typename T, bool MASKED>
__device__ __forceinline__ void apply(T (&lv)[TILE], T (&wv)[TILE],
                                      Rot<T> rt, unsigned mask) {
  const unsigned worst = numerators<T, MASKED>(lv, wv, rt, mask);
  quotients<T>(lv, rt, worst < Op<T>::SPAN);
  new_w<T>(lv, wv, rt);
}

template <typename T>
struct Args {
  T* L;             // (n, n) row-major, updated in place (lower triangle)
  Word* Wt;         // (b, 32 nt) values of W^T as tagged words, rows >= n
                    // zero; scratch
  Word* R;          // (nt, b + 31, 32) rotations as tagged words, zeroed
  unsigned* ticket; // zeroed
  int n, b, nt;
};

// Item (I, K) on one warp (DIAG: I == K; MASKED: some slot is a row that
// does not exist, or lies on or above the diagonal; PROBE: the chain probe).
// xin: the warp's input row, xbuf its exchange rows, in shared memory.
template <typename T, bool DIAG, bool MASKED, bool PROBE>
__device__ void run_item(const Args<T>& a, int I, int K, int lane, T* xin,
                         T (*xbuf)[TILE]) {
  using O = Op<T>;
  using G = Tags<T>;
  const int n = a.n, b = a.b, nt = a.nt;
  const int r0 = TILE * I, col = TILE * K + lane;
  const int steps = b + TILE - 1;    // steps at which some lane has a sweep
  // the tag of the W this item takes in: (I, K - 1)'s, or the input's (the
  // chain probe runs no (I, K - 1) below the sub-diagonal); and of the W
  // it hands on
  const unsigned wtag = K > 0 && (DIAG || !PROBE) ? K : 0;
  const unsigned otag = K + 1;
  // this lane's row of W^T, and its column of R, at sweep / step 0
  Word* const wrow = a.Wt + static_cast<size_t>(r0 + lane) * G::WW;
  const size_t wstride = static_cast<size_t>(TILE) * nt * G::WW;
  Word* const rcol = a.R + (static_cast<size_t>(K) * steps * TILE + lane) *
                               G::RW;
  const size_t rstride = static_cast<size_t>(TILE) * G::RW;

  // slot s: row r0 + s of column col; the diagonal item keeps its lane's
  // diagonal entry L[col, col] apart, in ldg
  T lv[TILE], wv[TILE];
  unsigned mask = 0;
#pragma unroll
  for (int s = 0; s < TILE; ++s) {
    const bool ok = r0 + s < n && col < n && (!DIAG || s > lane);
    mask |= ok ? 1u << s : 0u;
    lv[s] = ok ? a.L[static_cast<size_t>(r0 + s) * n + col] : T(0);
    wv[s] = T(0);
  }
  T ldg = DIAG && col < n ? a.L[static_cast<size_t>(col) * n + col] : T(0);
  // this lane's row of the next sweep, and (below the diagonal) its
  // rotation of the next step, loaded a step ahead
  typename G::W win{};
  typename G::R rin{};
  G::load(wrow, win);
  if (!DIAG) G::load(rcol, rin);
  for (int t = 0;; ++t) {
    // every lane's w after step t - 1 into its exchange row; this lane's
    // row of sweep t into the input row, once (I, K - 1) has handed it on
    __syncwarp();
    Swz<T>::put(xbuf[lane], lane & 7, wv);
    if (t < b) {
      await<T>(wrow + t * wstride, win, wtag);
      xin[Swz<T>::at(lane, 7)] = G::value(win);
      if (t + 1 < b) G::load(wrow + (t + 1) * wstride, win);
    }
    __syncwarp();
    // hand on sweep t - 32: lane 31's slots, a row a lane
    const int jo = t - TILE;
    if (!DIAG && jo >= 0 && jo < b)
      G::store(wrow + jo * wstride,
               xbuf[TILE - 1][Swz<T>::at(lane, (TILE - 1) & 7)], otag);
    if (t == steps) break;
    // w in: lane k from lane k - 1's row, lane 0 sweep t from the input row
    const int key = lane ? (lane - 1) & 7 : 7;
    const T* const src = lane ? xbuf[lane - 1] : xin;
    Swz<T>::get(src, key, wv);
    const int j = t - lane;
    const bool act = j >= 0 && j < b && col < n;
    if (DIAG) {
      // this lane's own row: its w_j[col] is slot `lane`
      const T wk = src[Swz<T>::at(lane, key)];
      if (act) {
        T r2 = O::sub(O::mul(ldg, ldg), O::mul(wk, wk));
        if (r2 < O::tiny()) r2 = O::tiny();   // max(., tiny); NaN stays
        const T r = O::sqrt(r2);
        Rot<T> rt;
        rt.c = O::div(r, ldg);
        rt.s = O::div(wk, ldg);
        rt.y = O::rcp(rt.c);
        ldg = r;
        G::store(rcol + t * rstride, rt, t + 1);
        apply<T, true>(lv, wv, rt, mask);
      }
    } else {
      Rot<T> rt{};
      if (act) {
        await<T>(rcol + t * rstride, rin, t + 1);
        rt = G::value(rin);
      }
      if (t + 1 < steps) G::load(rcol + (t + 1) * rstride, rin);
      if (act) apply<T, MASKED>(lv, wv, rt, mask);
    }
  }
  // the store addresses anew: kept from the loads, they would hold 32
  // address pairs live through the whole item
  T* out = a.L;
  int k = lane;
  asm volatile("" : "+l"(out), "+r"(k));
#pragma unroll
  for (int s = 0; s < TILE; ++s)
    if ((mask >> s) & 1u)
      out[static_cast<size_t>(r0 + s) * n + TILE * K + k] = lv[s];
  if (DIAG && col < n) out[static_cast<size_t>(col) * n + col] = ldg;
}

// the items of a launch: the triangle of tiles, or the probe's chain
template <bool PROBE>
__host__ __device__ __forceinline__ long item_count(int nt) {
  return PROBE ? 2L * nt - 1 : static_cast<long>(nt) * (nt + 1) / 2;
}

template <typename T, bool PROBE>
__global__ void __launch_bounds__(NT, Op<T>::MINB) downdate_kernel(Args<T> a) {
  __shared__ __align__(16) T xin[NWARPS][TILE];
  __shared__ __align__(16) T xbuf[NWARPS][TILE][TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned items = static_cast<unsigned>(item_count<PROBE>(a.nt));
  for (;;) {
    unsigned x = 0;
    if (lane == 0) x = atomicAdd(a.ticket, 1u);
    x = __shfl_sync(FULL, x, 0);
    if (x >= items) return;
    // column-major: column tile K's rows K .. nt-1, diagonal first; the
    // probe's chain (0,0), (1,0), (1,1), (2,1), ...
    int I, K;
    if constexpr (PROBE) {
      I = static_cast<int>((x + 1) / 2);
      K = static_cast<int>(x / 2);
    } else {
      K = 0;
      while (x >= static_cast<unsigned>(a.nt - K)) {
        x -= a.nt - K;
        ++K;
      }
      I = K + static_cast<int>(x);
    }
    T* const in = xin[warp];
    T(*const ex)[TILE] = xbuf[warp];
    if (I == K)
      run_item<T, true, true, PROBE>(a, I, K, lane, in, ex);
    else if (TILE * (I + 1) <= a.n)
      run_item<T, false, false, PROBE>(a, I, K, lane, in, ex);
    else
      run_item<T, false, true, PROBE>(a, I, K, lane, in, ex);
  }
}

template <typename T, bool PROBE>
cudaError_t launch(void* L, void* Wt, void* R, void* ticket, int n, int b,
                   cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, downdate_kernel<T, PROBE>, NT, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  Args<T> a;
  a.L = static_cast<T*>(L);
  a.Wt = static_cast<Word*>(Wt);
  a.R = static_cast<Word*>(R);
  a.ticket = static_cast<unsigned*>(ticket);
  a.n = n;
  a.b = b;
  a.nt = (n + TILE - 1) / TILE;
  const long wanted = (item_count<PROBE>(a.nt) + NWARPS - 1) / NWARPS;
  const long resident = static_cast<long>(sms) * per_sm;
  const int blocks = static_cast<int>(wanted < resident ? wanted : resident);
  downdate_kernel<T, PROBE><<<blocks, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

// One launch of the downdate (PROBE = false) or of its chain probe, dtype
// 0 = float32, 1 = float64; the arguments of chol_downdate (chol_downdate.cu).
template <bool PROBE>
int run(int dtype, void* L, void* Wt, void* R, void* ticket, int n, int b,
        void* stream) {
  if (n < 1 || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch<float, PROBE>(L, Wt, R, ticket, n, b, st));
    case 1:
      return static_cast<int>(
          launch<double, PROBE>(L, Wt, R, ticket, n, b, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
