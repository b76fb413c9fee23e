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
//   dxdt_j = Z_j + w_j dS B_j,  Z_j = sum_{i >= j} G_ij L_ij dY_i,
//   dG_ij  = sum_h L_hij E_hij,  E_h = dY_h xdt_h^T          (j <= i),
//   dC     = dG B,  dB = dG^T C + sum_h w_hj dS_h^T xdt_jh,
//   dcum_i = dcum_i + sum_j M_ij - sum_k M_ki - w_i dw_i
//            + [i = end] sum_j w_j dw_j,
//     with M_ij = G_ij L_ij E_ij, dw_j = xdt_j . (dS B_j),
//   ddA    = the reverse cumsum of dcum.
// cum is recomputed by the forward's compensated warp scan (ssd_common.cuh),
// so both round it alike; L is exp(cum_i - cum_j) per element, never a
// product of exps.
//
// What bounds it: at mamba2-130m's training shape (BC = 128, cs = 256,
// H = 24, P = 64, N = 128) the function needs G's causal half, per head E
// and Z over the causal half, xdt dS and B dS^T, then dC and dB over the
// causal half: 54.9 GFLOP; 3xTF32 on the tensor cores (as the forward)
// makes that 0.333 ms at 495 TFLOP/s; its bytes (xdt, dA, B, C, dY, dS,
// dcum read, dxdt, ddA, dB, dC written, 0.78 GB) take 0.23 ms at 3.35 TB/s.
//
// The design: every product is mma.sync m16n8k8 in 3xTF32 (the forward's
// warp_mma, split_tf32 and mma_tf32), operands staged by cp.async into
// padded tiles in their natural layouts, double buffered. Four launches,
// in order on one stream; 256-thread blocks:
//  1. u: a block owns (chunk, strip of 64 rows j, head group), 64 values
//     of K a step through a 3-stage ring. Per head: U = xdt_h dS_h (K = P)
//     for dw_j = B_j . U_j and the group's dB partial sum_h w_j U_j (kept
//     in registers over the heads, written once), and w_j B_j dS_h^T
//     (K = N), which it writes as dxdt. One warp a head scans cum; the
//     first strip's blocks also write it for e.
//  2. e: a block owns (chunk, strip of 64 columns j, head group) and
//     computes the strip's causal G[i >= j0, strip] = C B^T once into
//     shared memory (at most 256 rows: 72 KB; longer chunks go in blocks of
//     256 rows), with the group's dG partial beside it. Each head's cum
//     comes from u by cp.async, the next head's while the last tile's Z
//     product runs, so no warp waits on a scan. Per head and tile
//     of 64 rows i: E = dY xdt^T in registers; L (one exp per element),
//     G o L (formed in f32) into a shared tile, T = L o E into dG, and the
//     row sums (per strip, a partial) and column sums of M = (G o L) o E;
//     then Z += (G o L)^T dY reads that tile as its A operand, and
//     dxdt += Z. E, M and G o L never leave the chip.
//  3. dbdc: dC and dB tiles from the groups' dG partials, added in group
//     order while staged, and the dB partials of 1.
//  4. dda: per (chunk, head), dcum's sums added in a fixed order (the
//     strips' row sums of M in strip order), then ddA by a reverse scan.
// No atomics: every partial has one writer and is read in a fixed order,
// so two launches on the same inputs give the same bits.

#include "ssd_common.cuh"

namespace {

constexpr int TJ = 64;          // strip of chunk rows j (G's columns)
constexpr int TI = 64;          // tile of chunk rows i
constexpr int RB = 256;         // rows i an e block holds G for at once
constexpr int KC = 32;          // K of a staged step
constexpr int NK = 64;          // N slab of C and B per G step
constexpr int MAXCS = 1024;

// Shared-memory row strides (floats): a [row][k] operand read by fragments
// wants 4 mod 32 and a [k][col] operand 8 mod 32 (32 distinct banks).
constexpr int LDA = KC + 4;     // [row][k] staged chunks
constexpr int LDK = 64 + 8;     // [k][col] staged chunks
constexpr int LD_CB = NK + 4;   // C and B slabs of the G step
constexpr int CB2 = 2 * TI * LD_CB;              // one G step
constexpr int LDG = TJ + 8;     // G block [i][j], read as (G o L)^T
constexpr int LDD = TJ + 8;     // dG block [i][j]
constexpr int LDX = 64 + 4;     // xdt_h strip [j][p], E's B
constexpr int LDY = 64 + 8;     // dY tile [i][p], Z's B
constexpr int LDL = TJ + 8;     // G o L tile [i][j], read as Z's A^T
constexpr int UKC = 64;         // K of a staged u step
constexpr int LDUA = UKC + 4;   // u's [row][k] staged chunks
constexpr int UBUF = TJ * LDUA + UKC * LDK;      // one u step
constexpr int YBUF = TI * LDY;                   // one dY tile (e)
constexpr int E_FLOATS = RB * LDG + RB * LDD + TJ * LDX + 2 * YBUF +
                         TI * LDL + (MAXCS + TJ) + 2 * RB + 4 * TJ;
constexpr int CBUF = 64 * LDA + KC * LDK;        // one dbdc step
static_assert(64 * LDUA <= UKC * LDK &&
              2 * CB2 <= TJ * LDX + 2 * YBUF + TI * LDL &&
              TJ * LDY <= 2 * YBUF && CBUF == KC * LDK + KC * LDK,
              "staging regions hold each step's operands");
static_assert(RB * LDG % 4 == 0 && TJ * LDX % 4 == 0 && YBUF % 4 == 0 &&
              TI * LDL % 4 == 0 &&
              UBUF % 4 == 0 && TJ * LDUA % 4 == 0 && CB2 % 4 == 0,
              "shared regions must stay 16-byte aligned");

struct Args {
  const float *xdt, *dA, *Bm, *Cm, *dY, *dS, *dcum;
  float *dxdt, *ddA, *dB, *dC;
  float *rowMp, *colM, *wdw;   // (BC, H, ns, cs), (BC, H, cs), (BC, H, cs)
  float* cumg;                 // (BC, H, cs): cum, by u's first strips
  float *dGp, *dBp;            // (BC, ng, cs, cs), (BC, ng, cs, N)
  int BC, cs, H, P, N, hpg, ng, ns;
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void zero(float (&acc)[1][4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[0][nt][c] = 0.f;
}

// ---- 1. per (chunk, strip j, group): U, dw, dB partial; w B dS^T ----
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2) ssd_bwd_u(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int bc = blockIdx.x;
  const int jt = blockIdx.y / a.ng, grp = blockIdx.y % a.ng;
  const int cs = a.cs, H = a.H, P = a.P, N = a.N;
  const int j0 = jt * TJ, rows = min(TJ, cs - j0);
  const int h0 = grp * a.hpg, hn = min(a.hpg, H - h0);
  float* buf = sm;                      // 3 x UBUF: a ring of steps
  float* w = buf + 3 * UBUF;            // hpg x TJ: exp(cum_end - cum_j)
  float* dw = w + a.hpg * TJ;           // hpg x TJ: B_j . U_j
  float* red = dw + a.hpg * TJ;         // 2 x TJ
  float* cend = red + 2 * TJ;           // hpg4: cum_end of each head
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 4, wh = warp / 4;   // the warp's 16 rows; its half
  const long long HP = static_cast<long long>(H) * P;
  const float* x_bc = a.xdt + static_cast<long long>(bc) * cs * HP;
  const float* B_bc = a.Bm + static_cast<long long>(bc) * cs * N;
  const float* dS_g = a.dS + (static_cast<long long>(bc) * H + h0) * P * N;

  // warp hl scans head h0 + hl: w over the strip
  for (int hl = warp; hl < hn; hl += THREADS / 32) {
    float* wr = w + hl * TJ;
    warp_scan(a.dA + (static_cast<long long>(bc) * H + h0 + hl) * cs, cs,
              [&](int i, float c) {
                if (i >= j0 && i < j0 + TJ) wr[i - j0] = c;
                if (i == cs - 1) cend[hl] = c;
                if (jt == 0)   // the e kernel reads it from here
                  a.cumg[(static_cast<long long>(bc) * H + h0 + hl) * cs +
                         i] = c;
              });
    __syncwarp();
    for (int m = lane; m < TJ; m += 32) {
      wr[m] = m < rows ? expf(cend[hl] - wr[m]) : 0.f;
      dw[hl * TJ + m] = 0.f;
    }
  }

  // U = xdt_h dS_h, 64 columns of N a pass: dw and the dB partial
  const int pchunks = (P + UKC - 1) / UKC;
  const int usteps = hn * pchunks;
  for (int n0 = 0; n0 < N; n0 += 64) {
    float bval[4][4];          // B at this thread's U positions
    float dbacc[1][4][4];
    zero(dbacc);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jr = wm * 16 + g + 8 * (c / 2);
        const int n = n0 + wh * 32 + nt * 8 + 2 * t + c % 2;
        bval[nt][c] = jr < rows && n < N ? B_bc[(j0 + jr) * N + n] : 0.f;
      }
    auto stage_u = [&](int step) {
      const int hl = step / pchunks, p0 = step % pchunks * UKC;
      float* X = buf + (step % 3) * UBUF;            // xdt [j][p]
      stage<TJ, UKC, VEC>(X, LDUA, x_bc + j0 * HP + (h0 + hl) * P + p0, HP,
                         rows, P - p0);
      stage<UKC, 64, VEC>(X + TJ * LDUA, LDK,           // dS [p][n]
                         dS_g + (hl * P + p0) * static_cast<long long>(N) +
                             n0,
                         N, P - p0, N - n0);
      cp_async_commit();
    };
    __syncthreads();   // w is complete; no warp still reads buf
    stage_u(0);
    if (usteps > 1) stage_u(1);
    float uacc[1][4][4];
    for (int step = 0; step < usteps; ++step) {
      const int hl = step / pchunks, pc = step % pchunks;
      if (pc == 0) zero(uacc);
      if (step + 1 < usteps) cp_async_wait<1>(); else cp_async_wait_all();
      __syncthreads();
      if (step + 2 < usteps) stage_u(step + 2);
      const float* X = buf + (step % 3) * UBUF;
      const float* Xw = X + wm * 16 * LDUA;
      warp_mma<1, 4, UKC, true>(
          uacc, [&](int m, int k) { return Xw[m * LDUA + k]; },
          X + TJ * LDUA + wh * 32, LDK);
      if (pc == pchunks - 1) {
        const float* wr = w + hl * TJ + wm * 16;
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            rs[c / 2] += bval[nt][c] * uacc[0][nt][c];
            dbacc[0][nt][c] += wr[g + 8 * (c / 2)] * uacc[0][nt][c];
          }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          rs[0] += __shfl_xor_sync(0xffffffffu, rs[0], off);
          rs[1] += __shfl_xor_sync(0xffffffffu, rs[1], off);
        }
        if (t == 0) {
          red[wh * TJ + wm * 16 + g] = rs[0];
          red[wh * TJ + wm * 16 + g + 8] = rs[1];
        }
        __syncthreads();
        if (tid < TJ) dw[hl * TJ + tid] += red[tid] + red[TJ + tid];
      }
    }
    float* dbp = a.dBp + ((static_cast<long long>(bc) * a.ng + grp) * cs +
                          j0) * N;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jr = wm * 16 + g + 8 * (c / 2);
        const int n = n0 + wh * 32 + nt * 8 + 2 * t + c % 2;
        if (jr < rows && n < N) dbp[jr * N + n] = dbacc[0][nt][c];
      }
  }

  // dxdt = w_j B_j dS_h^T (K = N), 64 columns of P a pass; the e kernel
  // adds Z to it
  const int pblocks = (P + 63) / 64, nchunks = (N + UKC - 1) / UKC;
  const int xsteps = hn * pblocks * nchunks;
  auto stage_x = [&](int step) {
    const int nc = step % nchunks, pb = step / nchunks % pblocks;
    const int hl = step / (nchunks * pblocks);
    float* Bs = buf + (step % 3) * UBUF;             // B [j][n]
    stage<TJ, UKC, VEC>(Bs, LDUA, B_bc + j0 * static_cast<long long>(N) +
                                    nc * UKC,
                       N, rows, N - nc * UKC);
    stage<64, UKC, VEC>(Bs + TJ * LDUA, LDUA,            // dS [p][n]
                       dS_g + (hl * P + pb * 64) * static_cast<long long>(N) +
                           nc * UKC,
                       N, P - pb * 64, N - nc * UKC);
    cp_async_commit();
  };
  __syncthreads();   // no warp still reads buf
  stage_x(0);
  if (xsteps > 1) stage_x(1);
  float xacc[1][4][4];
  for (int step = 0; step < xsteps; ++step) {
    const int nc = step % nchunks, pb = step / nchunks % pblocks;
    const int hl = step / (nchunks * pblocks);
    if (nc == 0) zero(xacc);
    if (step + 1 < xsteps) cp_async_wait<1>(); else cp_async_wait_all();
    __syncthreads();
    if (step + 2 < xsteps) stage_x(step + 2);
    const float* Bs = buf + (step % 3) * UBUF;
    const float* Bw = Bs + wm * 16 * LDUA;
    const float* wr = w + hl * TJ + wm * 16;
    // A = w_j B_j, formed in f32 before the split
    warp_mma<1, 4, UKC, false>(
        xacc, [&](int m, int k) { return wr[m] * Bw[m * LDUA + k]; },
        Bs + TJ * LDUA + wh * 32 * LDUA, LDUA);
    if (nc == nchunks - 1) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jr = wm * 16 + g + 8 * (c / 2);
          const int p = pb * 64 + wh * 32 + nt * 8 + 2 * t + c % 2;
          if (jr < rows && p < P)
            a.dxdt[(static_cast<long long>(bc) * cs + j0 + jr) * HP +
                   (h0 + hl) * P + p] = xacc[0][nt][c];
        }
    }
  }
  __syncthreads();   // the last dw update is visible
  for (int e = tid; e < hn * TJ; e += THREADS) {
    const int hl = e / TJ, m = e % TJ;
    if (m < rows)
      a.wdw[(static_cast<long long>(bc) * H + h0 + hl) * cs + j0 + m] =
          w[e] * dw[e];
  }
}

// ---- 2. per (chunk, strip j, group): G block, E, M, dG partial, Z ----
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_e(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* Gs = sm;                      // RB x LDG
  float* dGs = Gs + RB * LDG;          // RB x LDD
  float* XS = dGs + RB * LDD;          // TJ x LDX
  float* ybuf = XS + TJ * LDX;         // 2 x YBUF
  float* GL = ybuf + 2 * YBUF;         // TI x LDL: the tile's G o L_h
  float* cum = GL + TI * LDL;          // MAXCS + TJ (zero past cs)
  float* rowMs = cum + MAXCS + TJ;     // 2 x RB: row sums by column half
  float* redc = rowMs + 2 * RB;        // 4 x TJ: column sums by row group

  const int bc = blockIdx.x;
  const int jt = blockIdx.y / a.ng, grp = blockIdx.y % a.ng;  // long first
  const int cs = a.cs, H = a.H, P = a.P, N = a.N;
  const int j0 = jt * TJ, jn = min(TJ, cs - j0);
  const int h0 = grp * a.hpg, hn = min(a.hpg, H - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 4, wh = warp / 4;
  const long long HP = static_cast<long long>(H) * P;
  const long long bcs = static_cast<long long>(bc) * cs;
  const float* x_bc = a.xdt + bcs * HP;
  const float* y_bc = a.dY + bcs * HP;
  float* dx_bc = a.dxdt + bcs * HP;
  const float* C_bc = a.Cm + bcs * N;
  const float* B_bc = a.Bm + bcs * N;
  const int slabs = max(1, (N + NK - 1) / NK);   // N = 0: G = 0
  const int pblocks = (P + 63) / 64;

  for (int ib = j0; ib < cs; ib += RB) {
    const int ilen = min(RB, cs - ib), itiles = (ilen + TI - 1) / TI;
    // ---- G[ib + il, j0 + jl] = C B^T, tile by tile over N slabs ----
    __syncthreads();   // no warp still reads the previous block's G, dG
    auto stage_cb = [&](int step) {   // in XS, ybuf and GL, free here
      float* Cs = XS + (step % 2) * CB2;
      const int i0 = ib + step / slabs * TI, n0 = step % slabs * NK;
      stage<TI, NK, VEC>(Cs, LD_CB, C_bc + i0 * static_cast<long long>(N) +
                                        n0,
                         N, cs - i0, N - n0);
      stage<TJ, NK, VEC>(Cs + TI * LD_CB, LD_CB,
                         B_bc + j0 * static_cast<long long>(N) + n0, N, jn,
                         N - n0);
      cp_async_commit();
    };
    const int gsteps = itiles * slabs;
    stage_cb(0);
    float acc[1][4][4];
    for (int step = 0; step < gsteps; ++step) {
      const int tt = step / slabs, sl = step % slabs;
      if (sl == 0) zero(acc);
      cp_async_wait_all();
      __syncthreads();
      if (step + 1 < gsteps) stage_cb(step + 1);
      const float* Cs = XS + (step % 2) * CB2;
      const float* Cw = Cs + wm * 16 * LD_CB;
      warp_mma<1, 4, NK, false>(
          acc, [&](int m, int k) { return Cw[m * LD_CB + k]; },
          Cs + TI * LD_CB + wh * 32 * LD_CB, LD_CB);
      if (sl == slabs - 1) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int row = tt * TI + wm * 16 + g;
          const int col = wh * 32 + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(Gs + row * LDG + col) =
              make_float2(acc[0][nt][0], acc[0][nt][1]);
          *reinterpret_cast<float2*>(Gs + (row + 8) * LDG + col) =
              make_float2(acc[0][nt][2], acc[0][nt][3]);
        }
      }
    }
    for (int e = tid; e < RB * LDD / 4; e += THREADS)
      reinterpret_cast<float4*>(dGs)[e] = make_float4(0.f, 0.f, 0.f, 0.f);

    // head hh's cum, as u's warp scan wrote it, by cp.async
    auto load_cum = [&](int hh) {
      const float* src = a.cumg + (static_cast<long long>(bc) * H + hh) * cs;
      for (int i = tid; i < cs; i += THREADS) cp_async<1>(cum + i, src + i, true);
      cp_async_commit();
    };
    for (int hl = 0; hl < hn; ++hl) {
      const int h = h0 + hl;
      __syncthreads();   // G is complete; the last head's reads are done
      if (hl == 0) load_cum(h);     // later heads' come in under the last
      for (int e = tid; e < TJ; e += THREADS) cum[cs + e] = 0.f;
      for (int e = tid; e < 2 * RB; e += THREADS) rowMs[e] = 0.f;
      float colacc[4][2];   // this thread's M column sums over its rows
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) colacc[nt][0] = colacc[nt][1] = 0.f;

      for (int pb = 0; pb < pblocks; ++pb) {
        const int p0 = pb * 64;
        auto stage_y = [&](int it) {
          const int i0 = ib + it * TI;
          stage<TI, 64, VEC>(ybuf + (it % 2) * YBUF, LDY,
                             y_bc + i0 * HP + h * P + p0, HP, cs - i0,
                             P - p0);
          cp_async_commit();
        };
        __syncthreads();   // cum and rowMs are set; no warp reads ybuf, XS
        stage<TJ, 64, VEC>(XS, LDX, x_bc + j0 * HP + h * P + p0, HP, jn,
                           P - p0);
        stage_y(0);
        // Z (rows j of the warp's 16, all 64 columns p): the warps of a
        // row group take halves of each tile's rows i and add at the end;
        // the first half starts from the dxdt written so far
        float zacc[1][8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int jr = wm * 16 + g + 8 * (c / 2);
            const int p = p0 + nt * 8 + 2 * t + c % 2;
            zacc[0][nt][c] = wh == 0 && jr < jn && p < P
                                 ? dx_bc[(j0 + jr) * HP + h * P + p] : 0.f;
          }
        for (int it = 0; it < itiles; ++it) {
          const int i0 = ib + it * TI, il0 = it * TI;
          cp_async_wait_all();
          __syncthreads();
          if (it + 1 < itiles) stage_y(it + 1);
          const float* Ys = ybuf + (it % 2) * YBUF;
          const bool masked = i0 == j0 || i0 + TI > cs;

          // E (rows i of the warp's 16, columns j of its half) = dY xdt^T
          float eacc[1][4][4];
          zero(eacc);
          const float* Yw = Ys + wm * 16 * LDY;
          warp_mma<1, 4, 64, false>(
              eacc, [&](int m, int k) { return Yw[m * LDY + k]; },
              XS + wh * 32 * LDX, LDX);
          // L (0 where masked), G o L into the tile for Z, T = L o E into
          // dG, and M = (G o L) o E's row and column sums
#pragma unroll
          for (int cp = 0; cp < 2; ++cp) {
            const int r = wm * 16 + g + 8 * cp;      // row in the tile
            const int il = il0 + r, i = ib + il;
            const float ci = cum[i];
            float rs = 0.f;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int jl = wh * 32 + nt * 8 + 2 * t, j = j0 + jl;
              const float2 gv =
                  *reinterpret_cast<const float2*>(Gs + il * LDG + jl);
              float2* dgp = reinterpret_cast<float2*>(dGs + il * LDD + jl);
              float2 dg = *dgp;
              const float l0 = expf(ci - cum[j]), l1 = expf(ci - cum[j + 1]);
              const float L0 = !masked || (i >= j && i < cs) ? l0 : 0.f;
              const float L1 = !masked || (i > j && i < cs) ? l1 : 0.f;
              const float gl0 = gv.x * L0, gl1 = gv.y * L1;
              *reinterpret_cast<float2*>(GL + r * LDL + jl) =
                  make_float2(gl0, gl1);
              const float e0 = eacc[0][nt][2 * cp], e1 = eacc[0][nt][2 * cp + 1];
              dg.x += L0 * e0;
              dg.y += L1 * e1;
              *dgp = dg;
              const float m0 = gl0 * e0, m1 = gl1 * e1;
              rs += m0 + m1;
              colacc[nt][0] += m0;
              colacc[nt][1] += m1;
            }
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1)
              rs += __shfl_xor_sync(0xffffffffu, rs, off);
            if (t == 0) rowMs[wh * RB + il] += rs;   // one writer per slot
          }

          // Z += (G o L)^T dY over the warp's half of the tile's rows
          __syncthreads();   // the tile's G o L is complete
          if (it == itiles - 1 && pb == pblocks - 1 && hl + 1 < hn)
            load_cum(h + 1);   // no warp reads this head's cum any more
          const int kb = wh * 32;
          const float* GLk = GL + kb * LDL + wm * 16;
          warp_mma<1, 8, 32, true>(
              zacc, [&](int m, int k) { return GLk[k * LDL + m]; },
              Ys + kb * LDY, LDY);
        }

        // dxdt = the first half + the second, through ybuf
        __syncthreads();
        float* red = ybuf;
        if (wh == 1) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int row = wm * 16 + g, col = nt * 8 + 2 * t;
            *reinterpret_cast<float2*>(red + row * LDY + col) =
                make_float2(zacc[0][nt][0], zacc[0][nt][1]);
            *reinterpret_cast<float2*>(red + (row + 8) * LDY + col) =
                make_float2(zacc[0][nt][2], zacc[0][nt][3]);
          }
        }
        __syncthreads();
        if (wh == 0) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int jr = wm * 16 + g + 8 * (c / 2);
              const int col = nt * 8 + 2 * t + c % 2, p = p0 + col;
              if (jr < jn && p < P)
                dx_bc[(j0 + jr) * HP + h * P + p] =
                    zacc[0][nt][c] + red[jr * LDY + col];
            }
        }
      }

      // M's column sums: over the warp's rows (lanes of one t), then the
      // four row groups in order; row sums: the two column halves in order
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int off = 4; off <= 16; off <<= 1)
            colacc[nt][e] += __shfl_xor_sync(0xffffffffu, colacc[nt][e], off);
      if (g == 0) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = wh * 32 + nt * 8 + 2 * t;
          redc[wm * TJ + col] = colacc[nt][0];
          redc[wm * TJ + col + 1] = colacc[nt][1];
        }
      }
      __syncthreads();
      const long long bh = static_cast<long long>(bc) * H + h;
      if (tid < jn) {
        const float s = redc[tid] + redc[TJ + tid] + redc[2 * TJ + tid] +
                        redc[3 * TJ + tid];
        float* cm = a.colM + bh * cs + j0 + tid;
        *cm = ib == j0 ? s : *cm + s;
      }
      float* rmp = a.rowMp + (bh * a.ns + jt) * cs + ib;
      for (int il = tid; il < ilen; il += THREADS)
        rmp[il] = rowMs[il] + rowMs[RB + il];
    }

    // the group's dG partial of this block
    __syncthreads();
    float* dgp = a.dGp + ((static_cast<long long>(bc) * a.ng + grp) * cs +
                          ib) * cs + j0;
    for (int e = tid; e < ilen * TJ; e += THREADS) {
      const int il = e / TJ, jl = e % TJ;
      if (jl < jn) dgp[static_cast<long long>(il) * cs + jl] =
          dGs[il * LDD + jl];
    }
  }
}

// ---- 3. dC = dG B and dB = dG^T C + the groups' dB partials ----
// A block owns 64 rows (i for dC, j for dB) and 64 columns of N of one
// chunk; dG = sum of the groups' partials, in group order, as it is staged.
template <bool VEC>
__global__ void __launch_bounds__(THREADS) ssd_bwd_dbdc(Args a) {
  __shared__ __align__(16) float sm[2 * KC * LDK];
  float* S = sm;                 // dG chunk
  float* V = sm + KC * LDK;      // B or C chunk [k][n]
  const int n0 = blockIdx.x * 64, r = blockIdx.y, bc = blockIdx.z;
  const int cs = a.cs, N = a.N, ng = a.ng, r0 = r * 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, wm = warp % 4, wh = warp / 4;
  const long long bcs = static_cast<long long>(bc) * cs;
  const float* dGp = a.dGp + bcs * ng * cs;
  const long long gstride = static_cast<long long>(cs) * cs;
  auto dG = [&](int i, int j) {
    float s = 0.f;
    if (i < cs && j < cs)
      for (int q = 0; q < ng; ++q) s += dGp[q * gstride + i * cs + j];
    return s;
  };
  float acc[1][4][4];

  // dC rows r0..: K = the columns j < r0 + 64 (dG is 0 above the diagonal)
  zero(acc);
  for (int k0 = 0; k0 < min(cs, r0 + 64); k0 += KC) {
    __syncthreads();
    for (int e = tid; e < 64 * KC; e += THREADS) {
      const int m = e / KC, k = e % KC;
      S[m * LDA + k] = dG(r0 + m, k0 + k);
    }
    stage<KC, 64, VEC>(V, LDK, a.Bm + (bcs + k0) * N + n0, N, cs - k0,
                       N - n0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const float* Sw = S + wm * 16 * LDA;
    warp_mma<1, 4, KC, true>(
        acc, [&](int m, int k) { return Sw[m * LDA + k]; }, V + wh * 32,
        LDK);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = r0 + wm * 16 + g + 8 * (c / 2);
      const int n = n0 + wh * 32 + nt * 8 + 2 * t + c % 2;
      if (i < cs && n < N) a.dC[(bcs + i) * N + n] = acc[0][nt][c];
    }

  // dB rows r0..: K = the rows i >= r0 (dG is 0 above the diagonal)
  zero(acc);
  for (int k0 = r0; k0 < cs; k0 += KC) {
    __syncthreads();
    for (int e = tid; e < KC * 64; e += THREADS) {
      const int k = e / 64, m = e % 64;
      S[k * LDK + m] = dG(k0 + k, r0 + m);
    }
    stage<KC, 64, VEC>(V, LDK, a.Cm + (bcs + k0) * N + n0, N, cs - k0,
                       N - n0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const float* Sw = S + wm * 16;
    warp_mma<1, 4, KC, true>(
        acc, [&](int m, int k) { return Sw[k * LDK + m]; }, V + wh * 32,
        LDK);
  }
  const float* dBp = a.dBp + bcs * ng * N;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = r0 + wm * 16 + g + 8 * (c / 2);
      const int n = n0 + wh * 32 + nt * 8 + 2 * t + c % 2;
      if (j < cs && n < N) {
        float s = acc[0][nt][c];
        for (int q = 0; q < ng; ++q)
          s += dBp[(static_cast<long long>(q) * cs + j) * N + n];
        a.dB[(bcs + j) * N + n] = s;
      }
    }
}

// ---- 4. per (chunk, head), one warp: dcum's sums, ddA = reverse cumsum ----
__global__ void __launch_bounds__(THREADS) ssd_bwd_dda(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, cs = a.cs;
  const long long bh = static_cast<long long>(blockIdx.x) * 8 + warp;
  if (bh >= static_cast<long long>(a.BC) * a.H) return;
  float* dcs = sm + warp * cs;
  const long long row = bh * cs;
  float swdw = 0.f;
  for (int i = lane; i < cs; i += 32) {
    float v = a.dcum[row + i] - a.colM[row + i] - a.wdw[row + i];
    for (int s = 0; s <= i / TJ; ++s)    // the strips j0 <= i, in order
      v += a.rowMp[(bh * a.ns + s) * cs + i];
    dcs[i] = v;
    swdw += a.wdw[row + i];
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    swdw += __shfl_xor_sync(0xffffffffu, swdw, off);
  __syncwarp();
  if (lane == 0) dcs[cs - 1] += swdw;
  __syncwarp();
  // reverse scan: lane l takes the l-th segment from the end
  const int seg = (cs + 31) / 32;
  const int hi = cs - min(lane * seg, cs), lo = max(hi - seg, 0);
  float run = 0.f;
  for (int i = hi - 1; i >= lo; --i) {
    run += dcs[i];
    a.ddA[row + i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  const float excl = incl - run;
  for (int i = lo; i < hi; ++i) a.ddA[row + i] += excl;
}

template <bool VEC>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const int hpg4 = (a.hpg + 3) / 4 * 4;
  const int u_smem = (3 * UBUF + 2 * a.hpg * TJ + 2 * TJ + hpg4) *
                     static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_u<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, u_smem);
  if (e != cudaSuccess) return e;
  const dim3 strips(a.BC, a.ns * a.ng);
  ssd_bwd_u<VEC><<<strips, THREADS, u_smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int e_smem = E_FLOATS * static_cast<int>(sizeof(float));
  e = cudaFuncSetAttribute(ssd_bwd_e<VEC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           e_smem);
  if (e != cudaSuccess) return e;
  ssd_bwd_e<VEC><<<strips, THREADS, e_smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_dbdc<VEC><<<dim3((a.N + 63) / 64, a.ns, a.BC), THREADS, 0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long rows = static_cast<long long>(a.BC) * a.H;
  ssd_bwd_dda<<<static_cast<unsigned>((rows + 7) / 8), THREADS,
                8 * a.cs * sizeof(float), s>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// All float32, contiguous: xdt, dY, dxdt (BC, cs, H, P); dA, dcum, ddA
// (BC, H, cs); Bm, Cm, dB, dC (BC, cs, N); dS (BC, H, P, N). Scratch, any
// contents on entry: stats (BC, H, ns + 3, cs) with ns = ceil(cs / 64) (the
// strips' row sums of M, then M's column sums, w_j dw_j and cum), dGp
// (BC, ng, cs, cs) and dBp (BC, ng, cs, N). Heads go in ng groups of hpg
// (ng = ceil(H / hpg)). Returns the first CUDA error of the four launches,
// or 0.
extern "C" int ssd_intra_chunk_bwd(const float* xdt, const float* dA,
                                   const float* Bm, const float* Cm,
                                   const float* dY, const float* dS,
                                   const float* dcum, float* dxdt, float* ddA,
                                   float* dB, float* dC, float* stats,
                                   float* dGp, float* dBp, int BC, int cs,
                                   int H, int P, int N, int hpg,
                                   void* stream) {
  if (BC < 1 || cs < 1 || cs > MAXCS || H < 1 || P < 1 || N < 1 ||
      hpg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ng = (H + hpg - 1) / hpg, ns = (cs + TJ - 1) / TJ;
  if (static_cast<long long>(ns) * ng > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long plane = static_cast<long long>(BC) * H * cs;
  Args a{xdt, dA, Bm, Cm, dY, dS, dcum, dxdt, ddA, dB, dC,
         stats, stats + plane * ns, stats + plane * (ns + 1),
         stats + plane * (ns + 2), dGp, dBp, BC, cs, H, P, N, hpg, ng, ns};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies when every staged row starts 16-byte aligned
  const bool vec = P % 4 == 0 && N % 4 == 0 && aligned16(xdt) &&
                   aligned16(dY) && aligned16(Bm) && aligned16(Cm) &&
                   aligned16(dS);
  return static_cast<int>(vec ? launch<true>(a, s) : launch<false>(a, s));
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
