// chol_downdate_probe.cu — probes of the Cholesky downdate kernel
// (chol_downdate.cu), in a library of their own so that the shipped kernel
// carries none of them. kernels/linalg/ops.py binds them:
//
//  * the chain probe: the downdate's kernel with PROBE = true, on the
//    downdate's arguments, runs only the diagonal items and the
//    sub-diagonal ones between them (the chain that carries the rotations
//    from column tile to column tile), each waiting as in the downdate:
//    the launch's serial floor. L's result is not the downdate.
//  * update_issue_probe: one step of a full off-diagonal item on its common
//    path, never launched, for its instructions in the SASS (chip_smoke.py
//    counts them with cuobjdump): the model behind the issue bound.
//  * the quotient probe: a row update's range check and quotients (the
//    header's numerators and quotients, as apply runs them) on operands
//    the caller gives, so that the branch-free quotient, and the choice of
//    it, can be held against IEEE division.

#include "chol_downdate.cuh"

namespace {

// Group g is one lane's step: numerators a[32 g + s] over c[g], with s = 0
// and w = 0, so that the numerators L - s w are a itself; slots outside
// mask[g] are left out of the range check, as rows that do not exist are;
// y = 1/c as the diagonal item forms it. Writes the 32 quotients and
// whether the step took the fast quotient (1) or the IEEE division (0).
template <typename T>
__global__ void quotient_probe(const T* a, const T* c, const unsigned* mask,
                               T* q, unsigned* fast, int groups) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  T lv[TILE], wv[TILE];
#pragma unroll
  for (int s = 0; s < TILE; ++s) {
    lv[s] = a[static_cast<size_t>(g) * TILE + s];
    wv[s] = T(0);
  }
  Rot<T> rt;
  rt.c = c[g];
  rt.s = T(0);
  rt.y = Op<T>::rcp(rt.c);
  const bool f = numerators<T, true>(lv, wv, rt, mask[g]) < Op<T>::SPAN;
  quotients<T>(lv, rt, f);
  fast[g] = f ? 1u : 0u;
#pragma unroll
  for (int s = 0; s < TILE; ++s) q[static_cast<size_t>(g) * TILE + s] = lv[s];
}

template <typename T>
cudaError_t launch_quotient(const void* a, const void* c, const void* mask,
                            void* q, void* fast, int groups,
                            cudaStream_t stream) {
  quotient_probe<T><<<(groups + NT - 1) / NT, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(c),
      static_cast<const unsigned*>(mask), static_cast<T*>(q),
      static_cast<unsigned*>(fast), groups);
  return cudaGetLastError();
}

}  // namespace

// One step of a full off-diagonal item on its common path (w in through
// the exchange rows, the numerators and their range, the fast quotients,
// the new w). Never launched; outside the anonymous namespace so that the
// library keeps it.
template <typename T>
__global__ void update_issue_probe(T* lw, const T* rot, unsigned* worst) {
  __shared__ __align__(16) T xbuf[TILE][TILE];
  const int lane = threadIdx.x & 31, prev = (lane + TILE - 1) & (TILE - 1);
  T lv[TILE], wv[TILE];
#pragma unroll
  for (int s = 0; s < TILE; ++s) {
    lv[s] = lw[s * TILE + lane];
    wv[s] = lw[(TILE + s) * TILE + lane];
  }
  Swz<T>::put(xbuf[lane], lane & 7, wv);
  __syncwarp();
  Swz<T>::get(xbuf[prev], prev & 7, wv);
  const Rot<T> rt = {rot[3 * lane], rot[3 * lane + 1], rot[3 * lane + 2]};
  worst[lane] = numerators<T, false>(lv, wv, rt, 0u);
  quotients<T>(lv, rt, true);
  new_w<T>(lv, wv, rt);
#pragma unroll
  for (int s = 0; s < TILE; ++s) {
    lw[s * TILE + lane] = lv[s];
    lw[(TILE + s) * TILE + lane] = wv[s];
  }
}
template __global__ void update_issue_probe<float>(float*, const float*,
                                                   unsigned*);
template __global__ void update_issue_probe<double>(double*, const double*,
                                                    unsigned*);

// The chain probe, on chol_downdate's arguments (chol_downdate.cu).
extern "C" int chol_downdate_chain_probe(int dtype, void* L, void* Wt,
                                         void* R, void* ticket, int n, int b,
                                         void* stream) {
  return run<true>(dtype, L, Wt, R, ticket, n, b, stream);
}

// The quotient probe on `groups` groups, dtype 0 = float32, 1 = float64:
// a (groups, 32) and c (groups,) of the dtype, mask (groups,) uint32;
// writes q (groups, 32) of the dtype and fast (groups,) uint32.
extern "C" int chol_downdate_quotient_probe(int dtype, const void* a,
                                            const void* c, const void* mask,
                                            void* q, void* fast, int groups,
                                            void* stream) {
  if (groups < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_quotient<float>(a, c, mask, q, fast, groups, st));
    case 1:
      return static_cast<int>(
          launch_quotient<double>(a, c, mask, q, fast, groups, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
