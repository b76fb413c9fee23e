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
// 2 BC N cs (cs + 1) / 2 for the causal half of G = C B^T (which does not
// depend on h; L zeroes the rest), 2 BC H P cs (cs + 1) / 2 for the causal
// Y product and 2 BC H P N cs for S: 13.45 GFLOP, against 271.6 MB read
// and written once. Two bounds:
//  * on the tensor cores in 3xTF32 (three TF32 products for each float32
//    one) 40.3 GFLOP at 495 TFLOP/s is 0.0815 ms, and the bytes at
//    3.35 TB/s take 0.0811 ms: the two meet, ~0.081 ms;
//  * on the f32 CUDA cores (67 TFLOP/s) it would be 0.201 ms.
//
// Work split: one launch, two kinds of 256-thread block (blockIdx.y = bc).
//  * A Y block owns (bc, 64-row strip r, group of GROUP = 8 heads). It
//    computes the strip's causal part of G = C B^T once into shared memory
//    (64 x 64 (r + 1) f32, at most 65 KB with padding; a chunk longer than
//    256 goes in blocks of 256 columns, each adding to the Y the same
//    threads wrote before), then multiplies G o L_h by xdt_h for each head
//    of its group, tile by tile. At the mamba2 shape: 64 x 4 x 3 = 768
//    blocks, longest strips first.
//  * An S block owns (bc, SH = 2 heads, 64 columns of N): S_h =
//    (xdt_h o decay_h)^T B over the whole chunk, each staged B tile shared
//    by both heads. The block with the first columns alone writes its
//    heads' cum rows. At the mamba2 shape: 64 x 12 x 2 = 1536 blocks.
// Counted from these tiles, the kernel executes 16.5 GFLOP at that shape
// (G 2.0, Y 8.05, S 6.44) where the function needs 13.45: G once per group
// of 8 heads, and whole 64 x 64 tiles on the diagonal.
// One warp scans each head's dA row (<= 1024 values) in every block that
// needs it, the same way in all of them, so they round cum alike.
// L is exp(cum_i - cum_j) per element, never exp(cum_i) exp(-cum_j): |cum|
// passes 88 at real dt A and f32 would overflow. No atomics: each output
// element has one writer, and two launches on the same inputs give the
// same bits.
//
// Precision: all three products (C B^T with K = N, (G o L_h) xdt_h with
// K = the 64 columns of a tile, (xdt_h o decay_h)^T B with K = the chunk's
// rows) run as mma.sync m16n8k8 TF32 with f32 accumulators, in 3xTF32:
// each f32 operand x is split into hi (x, which the tensor core truncates
// to TF32, as CUTLASS's 3xTF32 relies on: see split_tf32) and
// lo = x - trunc(x), and the product is hi hi' + lo hi' +
// hi lo' (error ~2^-20 of the product). One TF32 product (~2^-11 per
// operand) misses the reference's 3e-4 by ~10x (tests/test_torch_ssd.py
// shows it in an emulation). G o L_h and xdt_h o decay_h are formed in f32
// before the split, as each A fragment is read from the G and xdt tiles
// in shared memory (the accumulator's layout is not A's, so G goes through
// shared memory first). The two warps of a row group each take 32 of a
// tile's 64 columns of G o L_h, so every exp is taken once, and add their
// sums once per head. Shared tiles are padded (row strides 4 or 8 mod 32)
// so every fragment load hits 32 distinct banks.
//
// Staging: every global tile (C and B slabs, xdt tiles, B tiles) comes in
// by cp.async, 16 bytes at a time where the rows are aligned, into a
// double buffer: step s + 1 copies while the warps compute step s, with
// one barrier a step. bfloat16 inputs are converted on the way (plain
// loads). No TMA and no wgmma yet.

#include "ssd_common.cuh"

namespace {

constexpr int TILE = 64;       // strip rows, G columns, xdt rows, P columns
constexpr int GROUP = 8;       // heads per Y block, sharing one G
constexpr int JB = 256;        // G columns a Y block keeps at once
constexpr int NK = 32;         // N slab of C and B per G step
constexpr int SH = 2;          // heads per S block
constexpr int SJ = 32;         // chunk rows per S step
constexpr int SN = 64;         // N columns per S block
constexpr int MAXCS = 1024;

// Shared-memory row strides (floats). A [row][k] operand read by fragments
// needs a stride of 4 mod 32 and a [k][col] operand 8 mod 32, so that the
// 32 lanes of a fragment load hit 32 banks; all are multiples of 4 for the
// 16-byte copies.
constexpr int LD_CB = NK + 4;        // C and B slabs, [row][n]
constexpr int LD_G = JB + 4;         // G strip, [i][j]
constexpr int LD_X = TILE + 8;       // xdt tile, [j][p]
constexpr int LD_SX = SH * TILE + 8; // S step's xdt, [j][hl * TILE + p]
constexpr int LD_SB = SN + 8;        // S step's B, [j][n]

// Y block: G, two xdt tiles (each also the C and B slabs of a G step, and
// the sum of the two column halves), and per head cum over the block's
// columns and over its rows. S block: two (xdt, B) steps, cum, decay.
// Every region starts 16-byte aligned.
constexpr int CB_FLOATS = 2 * TILE * LD_CB;
constexpr int XBUF = TILE * LD_X > CB_FLOATS ? TILE * LD_X : CB_FLOATS;
constexpr int CUM_Y = JB + TILE;     // cum[jb + k], then cum[i0 + m]
constexpr int Y_FLOATS = TILE * LD_G + 2 * XBUF + GROUP * CUM_Y;
constexpr int SBUF = SJ * LD_SX + SJ * LD_SB;
constexpr int S_FLOATS = 2 * SBUF + 2 * SH * MAXCS;
constexpr int SMEM_FLOATS = Y_FLOATS > S_FLOATS ? Y_FLOATS : S_FLOATS;
static_assert(GROUP <= THREADS / 32 && SH <= THREADS / 32,
              "one warp scans each head");
static_assert(TILE * LD_G % 4 == 0 && XBUF % 4 == 0 && SBUF % 4 == 0 &&
              SJ * LD_SX % 4 == 0 && TILE * LD_CB % 4 == 0,
              "shared regions must stay 16-byte aligned");

// Y for rows [64 r, 64 r + 64) of chunk bc and heads [GROUP q, ...).
template <typename T, bool VEC>
__device__ void y_block(const T* __restrict__ xdt, const T* __restrict__ dA,
                        const T* __restrict__ Bm, const T* __restrict__ Cm,
                        float* __restrict__ Y, float* smem, long long bc,
                        int r, int q, int cs, int H, int P, int N) {
  float* Gs = smem;                    // TILE x LD_G
  float* buf = Gs + TILE * LD_G;       // 2 x XBUF
  float* cum = buf + 2 * XBUF;         // GROUP x CUM_Y
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 4, wh = warp / 4;  // the warp's 16 rows; its half
  const long long HP = static_cast<long long>(H) * P;
  const T* x_bc = xdt + bc * cs * HP;      // row j of head h: x_bc + j HP + h P
  const T* C_strip = Cm + (bc * cs + r * TILE) * N;
  const T* B_bc = Bm + bc * cs * N;
  float* Y_strip = Y + (bc * cs + r * TILE) * HP;
  const int i0 = r * TILE;
  const int rows = min(TILE, cs - i0);     // strip rows below cs
  const int jend = i0 + rows;              // causal: columns j < jend
  const int h0 = q * GROUP, hn = min(GROUP, H - h0);
  const int slabs = max(1, (N + NK - 1) / NK);   // N = 0: G = 0
  const int pblocks = (P + TILE - 1) / TILE;

  for (int jb = 0; jb < jend; jb += JB) {
    const int tiles = (min(JB, jend - jb) + TILE - 1) / TILE;
    __syncthreads();   // the last step of the previous block is done
    // warp hl: cum of head h0 + hl over columns [jb, jb + JB) and rows
    // [i0, i0 + 64), read once the G steps' barriers have passed
    if (warp < hn)
      warp_scan(dA + (bc * H + h0 + warp) * cs, cs, [&](int i, float c) {
        float* ch = cum + warp * CUM_Y;
        if (i >= jb && i < jb + JB) ch[i - jb] = c;
        if (i >= i0 && i < jend) ch[JB + i - i0] = c;
      });
    // G[:, jb + 64 tt ...] = C[strip] B[tile]^T, once for all the heads.
    // Step (tt, sl) multiplies N slab sl of both; the next step's slabs
    // copy in while the warps compute.
    auto stage_cb = [&](int step) {
      float* Cs = buf + (step % 2) * XBUF;
      const int j0 = jb + step / slabs * TILE, n0 = step % slabs * NK;
      stage<TILE, NK, VEC>(Cs, LD_CB, C_strip + n0, N, rows, N - n0);
      stage<TILE, NK, VEC>(Cs + TILE * LD_CB, LD_CB, B_bc + j0 * N + n0, N,
                           cs - j0, N - n0);
      cp_async_commit();
    };
    const int gsteps = tiles * slabs;
    if (gsteps > 0) stage_cb(0);
    float acc[1][4][4];
    for (int step = 0; step < gsteps; ++step) {
      const int tt = step / slabs, sl = step % slabs;
      if (sl == 0) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[0][nt][c] = 0.f;
      }
      cp_async_wait_all();
      __syncthreads();
      if (step + 1 < gsteps) stage_cb(step + 1);
      const float* Cs = buf + (step % 2) * XBUF;
      const float* Bs = Cs + TILE * LD_CB + wh * 32 * LD_CB;
      const float* Cw = Cs + wm * 16 * LD_CB;
      warp_mma<1, 4, NK, false>(
          acc, [&](int m, int k) { return Cw[m * LD_CB + k]; }, Bs, LD_CB);
      if (sl == slabs - 1) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int row = wm * 16 + g;
          const int col = tt * TILE + wh * 32 + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(Gs + row * LD_G + col) =
              make_float2(acc[0][nt][0], acc[0][nt][1]);
          *reinterpret_cast<float2*>(Gs + (row + 8) * LD_G + col) =
              make_float2(acc[0][nt][2], acc[0][nt][3]);
        }
      }
    }

    // Y, head by head. Step (hl, pb, tt) multiplies tile tt of G o L_h by
    // the xdt tile of rows jb + 64 tt.., columns 64 pb..; the warps of a
    // row group split the tile's 64 columns of G o L_h (its rows of xdt)
    // in halves, and add their sums once the head's tiles are done.
    auto stage_x = [&](int step) {
      const int tt = step % tiles, pb = step / tiles % pblocks;
      const int h = h0 + step / (tiles * pblocks), j0 = jb + tt * TILE;
      stage<TILE, TILE, VEC>(buf + (step % 2) * XBUF, LD_X,
                             x_bc + j0 * HP + h * P + pb * TILE, HP, cs - j0,
                             P - pb * TILE);
      cp_async_commit();
    };
    __syncthreads();   // G is complete; no warp still reads the slabs
    const int ysteps = hn * pblocks * tiles;
    stage_x(0);
    float yacc[1][8][4];
    for (int step = 0; step < ysteps; ++step) {
      const int tt = step % tiles, pb = step / tiles % pblocks;
      const int hl = step / (tiles * pblocks), h = h0 + hl;
      const int p0 = pb * TILE, j0 = jb + tt * TILE;
      if (tt == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            // a later block of columns adds to what this thread wrote
            const int i = wm * 16 + g + 8 * (c / 2);
            const int p = p0 + nt * 8 + 2 * t + c % 2;
            yacc[0][nt][c] = (jb > 0 && wh == 0 && i < rows && p < P)
                                 ? Y_strip[i * HP + h * P + p] : 0.f;
          }
      }
      cp_async_wait_all();
      __syncthreads();
      if (step + 1 < ysteps) stage_x(step + 1);
      const float* Xs = buf + (step % 2) * XBUF;
      // A(m, k) = G[i, j] exp(cum[i] - cum[j]) for j <= i, i < cs: G o L_h
      // formed in f32, per element, before the split
      const int ib = wm * 16, kb = wh * 32;
      const float* Gw = Gs + ib * LD_G + tt * TILE + kb;
      const float* cum_i = cum + hl * CUM_Y + JB + ib;
      const float* cum_j = cum + hl * CUM_Y + j0 - jb + kb;
      const bool masked = j0 == i0 || rows < TILE;
      const int dj = j0 + kb - i0 - ib;    // j - i = dj + k - m
      warp_mma<1, 8, 32, true>(
          yacc,
          [&](int m, int k) {
            const float e = Gw[m * LD_G + k] * expf(cum_i[m] - cum_j[k]);
            return !masked || (dj + k <= m && ib + m < rows) ? e : 0.f;
          },
          Xs + kb * LD_X, LD_X);
      if (tt == tiles - 1) {
        // the two halves' sums meet in this step's xdt buffer
        float* red = buf + (step % 2) * XBUF;
        __syncthreads();
        if (wh == 1) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int row = wm * 16 + g, col = nt * 8 + 2 * t;
            *reinterpret_cast<float2*>(red + row * LD_X + col) =
                make_float2(yacc[0][nt][0], yacc[0][nt][1]);
            *reinterpret_cast<float2*>(red + (row + 8) * LD_X + col) =
                make_float2(yacc[0][nt][2], yacc[0][nt][3]);
          }
        }
        __syncthreads();
        if (wh == 0) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int i = wm * 16 + g + 8 * (c / 2);
              const int col = nt * 8 + 2 * t + c % 2, p = p0 + col;
              if (i < rows && p < P)
                Y_strip[i * HP + h * P + p] =
                    yacc[0][nt][c] + red[i * LD_X + col];
            }
        }
      }
    }
  }
}

// S for heads [SH pair, ...) of chunk bc, columns [SN nb, ...) of N; the
// block with nb = 0 also writes those heads' cum rows. Step (pb, js)
// stages rows SJ js.. of xdt (columns 64 pb.. of both heads) and of B; the
// next step's copy runs while the warps compute.
template <typename T, bool VEC>
__device__ void s_block(const T* __restrict__ xdt, const T* __restrict__ dA,
                        const T* __restrict__ Bm, float* __restrict__ S,
                        float* __restrict__ cum_out, float* smem,
                        long long bc, int pair, int nb, int cs, int H, int P,
                        int N) {
  float* buf = smem;                   // 2 x SBUF: xdt SJ x LD_SX, B
  float* cum = buf + 2 * SBUF;         // SH x MAXCS
  float* dec = cum + SH * MAXCS;       // SH x MAXCS, exp(cum[-1] - cum)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the warp's head, 32 rows of P and 32 columns of N
  const int hw = warp / 4, pw = (warp / 2) % 2, nw = warp % 2;
  const long long HP = static_cast<long long>(H) * P;
  const int h0 = pair * SH, hn = min(SH, H - h0), n0 = nb * SN;
  const T* x_bc = xdt + bc * cs * HP;
  const T* B_bc = Bm + bc * cs * N + n0;
  const int jsteps = (cs + SJ - 1) / SJ, pblocks = (P + TILE - 1) / TILE;
  const int steps = jsteps * pblocks;
  auto stage_s = [&](int step) {
    float* Xd = buf + (step % 2) * SBUF;
    const int j0 = step % jsteps * SJ, p0 = step / jsteps * TILE;
#pragma unroll
    for (int hl = 0; hl < SH; ++hl)
      stage<SJ, TILE, VEC>(Xd + hl * TILE, LD_SX,
                           x_bc + j0 * HP + (h0 + min(hl, hn - 1)) * P + p0,
                           HP, hl < hn ? cs - j0 : 0, P - p0);
    stage<SJ, SN, VEC>(Xd + SJ * LD_SX, LD_SB, B_bc + j0 * N, N, cs - j0,
                       N - n0);
    cp_async_commit();
  };
  stage_s(0);

  // warp hl scans head h0 + hl
  if (warp < hn)
    warp_scan(dA + (bc * H + h0 + warp) * cs, cs,
              [&](int i, float c) { cum[warp * MAXCS + i] = c; });
  __syncthreads();
  for (int hl = 0; hl < SH; ++hl) {
    const float* c = cum + hl * MAXCS;
    const float c_end = hl < hn ? c[cs - 1] : 0.f;
    float* out = cum_out + (bc * H + h0 + hl) * cs;
    // the decay is 0 past the chunk and for a missing head, so the zeros
    // staged there stay zeros
    for (int i = tid; i < jsteps * SJ; i += THREADS) {
      const bool ok = hl < hn && i < cs;
      if (ok && nb == 0) out[i] = c[i];
      dec[hl * MAXCS + i] = ok ? expf(c_end - c[i]) : 0.f;
    }
  }
  float acc[2][4][4];
  for (int step = 0; step < steps; ++step) {
    const int js = step % jsteps, p0 = step / jsteps * TILE, j0 = js * SJ;
    if (js == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < steps) stage_s(step + 1);
    // S_h = (xdt_h o decay_h)^T B: the decay goes on xdt in f32, before
    // the split
    const float* Xw = buf + (step % 2) * SBUF + hw * TILE + pw * 32;
    const float* dw = dec + hw * MAXCS + j0;
    warp_mma<2, 4, SJ, true>(
        acc, [&](int m, int k) { return Xw[k * LD_SX + m] * dw[k]; },
        buf + (step % 2) * SBUF + SJ * LD_SX + nw * 32, LD_SB);
    if (js == jsteps - 1 && hw < hn) {
      float* S_h = S + (bc * H + h0 + hw) * static_cast<long long>(P) * N;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = p0 + pw * 32 + mt * 16 + g + 8 * (c / 2);
            const int n = n0 + nw * 32 + nt * 8 + 2 * t + c % 2;
            if (p < P && n < N)
              S_h[static_cast<long long>(p) * N + n] = acc[mt][nt][c];
          }
    }
  }
}

// Blocks per chunk: the Y blocks, longest strips first, then the S blocks.
__host__ __device__ inline int y_blocks(int cs, int H) {
  return ((cs + TILE - 1) / TILE) * ((H + GROUP - 1) / GROUP);
}
__host__ __device__ inline int s_col_blocks(int N) {
  return N > SN ? (N + SN - 1) / SN : 1;
}

// blockIdx.y = bc; blockIdx.x < y_blocks: a Y block, else an S block.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
ssd_kernel(const T* __restrict__ xdt, const T* __restrict__ dA,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           float* __restrict__ Y, float* __restrict__ S,
           float* __restrict__ cum_out, int cs, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  const long long bc = blockIdx.y;
  const int x = blockIdx.x, n_y = y_blocks(cs, H);
  const int n_groups = (H + GROUP - 1) / GROUP;
  if (x < n_y) {
    const int n_strips = n_y / n_groups;
    y_block<T, VEC>(xdt, dA, Bm, Cm, Y, smem, bc,
                    n_strips - 1 - x / n_groups, x % n_groups, cs, H, P, N);
  } else {
    const int sx = x - n_y, n_nb = s_col_blocks(N);
    s_block<T, VEC>(xdt, dA, Bm, S, cum_out, smem, bc, sx / n_nb,
                    sx % n_nb, cs, H, P, N);
  }
}

template <typename T, bool VEC>
cudaError_t launch(const void* xdt, const void* dA, const void* Bm,
                   const void* Cm, float* Y, float* S, float* cum, int BC,
                   int cs, int H, int P, int N, cudaStream_t stream) {
  constexpr int smem = SMEM_FLOATS * static_cast<int>(sizeof(float));
  const cudaError_t attr = cudaFuncSetAttribute(
      ssd_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(y_blocks(cs, H) + ((H + SH - 1) / SH) * s_col_blocks(N),
                  BC);
  ssd_kernel<T, VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(xdt), static_cast<const T*>(dA),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), Y, S, cum, cs, H,
      P, N);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 2 = bfloat16, for all four inputs. xdt is
// (BC, cs, H, P), dA (BC, H, cs), Bm/Cm (BC, cs, N), all contiguous; Y
// (BC, cs, H, P), S (BC, H, P, N) and cum (BC, H, cs) are float32 and
// contiguous. Needs 1 <= cs <= 1024 and BC <= 65535. Returns the launch's
// CUDA error code.
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
      // 16-byte copies when every row of every tile starts 16-byte aligned
      if (P % 4 == 0 && N % 4 == 0 && aligned16(xdt) && aligned16(Bm) &&
          aligned16(Cm))
        return static_cast<int>(launch<float, true>(
            xdt, dA, Bm, Cm, y, st, c, BC, cs, H, P, N, s));
      return static_cast<int>(launch<float, false>(xdt, dA, Bm, Cm, y, st, c,
                                                   BC, cs, H, P, N, s));
    case 2:
      return static_cast<int>(launch<__nv_bfloat16, false>(
          xdt, dA, Bm, Cm, y, st, c, BC, cs, H, P, N, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
