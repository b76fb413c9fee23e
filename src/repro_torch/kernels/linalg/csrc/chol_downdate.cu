// chol_downdate.cu — the rank-b Cholesky downdate chol(L L^T - W W^T) of
// the streaming GP stores (a machine's retirement: Sdd_L by F_m, pICF's
// Phi_L by F_m / sigma) as one kernel for Hopper.
//
// Replaces no Pallas kernel: the reference computes this in
// src/repro/core/linalg.py:89-136 (_chol_rank1 chained over W's columns
// by chol_update_rank, jitted, outside any Pallas kernel). It is the port's
// own kernel on the path of retire: as plain PyTorch the sweeps are n b
// dependent steps of a few launches each (3.3 M steps at the paper's
// (n, b) = (2048, 1600)), and no library call computes a downdate.
//
// The function, for lower L (n, n) and W (n, b), sweep j = 0 .. b-1 over
// w = W[:, j], step k = 0 .. n-1, with l = L[k, k]:
//
//   r = sqrt(max(l^2 - w_k^2, tiny)),  c = r / l,  s = w_k / l,
//   L[i, k] = (L[i, k] - s w_i) / c,  w_i = c w_i - s L[i, k]   (i > k),
//   L[k, k] = r.
//
// Every operation rounds as the plain version's (ref.py) does: each is
// correctly rounded (the _rn intrinsics, no FMA contraction of the
// formula), and the clamp lets a NaN through as torch.clamp does. On the
// same inputs the two agree bit for bit.
//
// What held the previous design. It ran the n + b - 1 anti-diagonals
// d = j + k of the (sweep, column) plane with a grid barrier after each
// (3647 at (2048, 1600)); on each, every pair (j, k) read column k of L and
// w_j from L2, applied its rotation to the n - k - 1 rows below k and wrote
// both back: 4 b n (n - 1) / 2 element accesses, 107 GB in float64, all
// through L2, one dependent L2 round trip per diagonal, and 3.9 ms of
// empty barriers. Each row update also took a full IEEE division, whose
// slow-path branch kept the compiler from overlapping one row's division
// with the next. On an H100 (700 W) it took 25.0 ms in float32 and 41.0 ms
// in float64 at (2048, 1600), against bounds of 0.30 / 0.59 ms.
//
// What this design does about it.
//  * The rotation (c, s) of pair (j, k) needs only L[k, k] after sweep
//    j - 1 and w_j[k] after column k - 1; given the rotations, each row
//    i > k updates on its own, and each element sees the same operations
//    in the same (j, k) order in any schedule that respects those two
//    dependencies. So: tiles of 32 rows and 32 columns. A work item is
//    (row tile I, column tile K <= I), and one warp runs it over all b
//    sweeps: splitting the sweeps into blocks, so that early column tiles
//    hold fewer warps, gained a few percent at most for a hand-off of the
//    tile between blocks, and was left out.
//  * Within an item the warp is a systolic array: lane k holds column k of
//    the tile (slot s: row s, 32 rows in registers) and, at step t,
//    applies sweep j = t - k to it; w moves one lane on each step through
//    the warp's exchange rows in shared memory (16-byte pieces, swizzled:
//    no bank conflict; 16 stores and 16 loads a step in float64 where
//    shuffles took 64), so a row is its own (j, k) wavefront and all 32
//    rows run at once. L[I, K] stays in registers from the item's start
//    to its end; W[I, :] comes in at lane 0 as item (I, K - 1) left it and
//    leaves lane 31 for item (I, K + 1), in place in W^T. L2 sees each
//    tile of L once, each tile of W once an item, and the rotations.
//  * The diagonal item (K, K) computes the rotations: lane k keeps L[k, k]
//    apart and reads its own row's w_j[k] from the exchange, so it forms
//    (c, s) and 1/c for column k, sweep t - k, once, applies them to its
//    rows below and publishes them to scratch R, by step, for every item
//    below it.
//  * No grid barrier and no fence. Each item waits only on its
//    predecessors, (I, K - 1) for W and (K, K) for R, and it waits on the
//    data itself: every value of W^T and R travels in 64-bit words of a
//    32-bit half and a 32-bit tag (W: the column tile that wrote it plus
//    one, 0 for the input; R: the step plus one, R zeroed first), each
//    word stored and polled with relaxed GPU-scope accesses, which are
//    single-copy atomic per 64-bit word. A word that shows its tag holds
//    its value, so no producer waits on a memory fence (per-tile flags put
//    a release, and so a fence, on the chain of diagonal tiles every few
//    sweeps), and a reader waits only for the very words it needs. Items
//    are handed out by a ticket counter (an atomic on the counter, never
//    on data) in column-major order: column tile K's items after column
//    tile K - 1's, the diagonal first. That order is topological, and a
//    warp takes a ticket only while it runs, so the lowest unfinished
//    ticket has all its predecessors done and is held by a running warp:
//    it always progresses, and the launch cannot deadlock however few
//    warps are resident.
//  * The row update divides by the step's c: the diagonal item publishes
//    y = 1/c correctly rounded beside (c, s), and each row computes
//    q0 = a y, q1 = q0 + (a - c q0) y, q = q1 + (a - c q1) y with FMAs,
//    branch-free. q1 is a faithful rounding of a / c, so a - c q1 is exact
//    and, y being correctly rounded, q is a / c correctly rounded
//    (Markstein's theorem) while a, c and the quotient stay far from
//    overflow and underflow: |a| and c within [2^-500, 2^500) in float64,
//    [2^-40, 2^40) in float32. A step whose operands leave that range
//    (zeros, the clamp's tiny c, NaN) divides its rows with __ddiv_rn /
//    __fdiv_rn instead. The fast quotient is the IEEE quotient bit for bit
//    (held against IEEE division on hard operands through the quotient
//    probe of chol_downdate_probe.cu).
//  * No atomics on data: repeated launches are bitwise equal.
//
// What holds it now, on an H100 (700 W) at (2048, 1600) (chip_smoke.py):
// 7.3-7.6 ms in float64 and 5.7 ms in float32. Its chain alone (the
// diagonal items and the sub-diagonal ones between them, the chain probe)
// takes 4.6-5.1 / 3.7-4.4 ms: each column tile adds ~32 systolic steps of
// ~1.3 us to it
// (the rotation's sqrt and two divisions, then a step of 32 rows), and the
// items of later column tiles wait for warps that earlier tiles hold.
// The update's issue bound, a model from its SASS (update_issue_probe in
// chol_downdate_probe.cu: 10 FP64 instructions a row update), is 2.0 /
// 1.4 ms.
//
// The device code is in chol_downdate.cuh, which chol_downdate_probe.cu
// (the chain, issue and quotient probes, a library of their own) shares.
//
// Budgets: 4 warps (128 threads) a block, each warp its own items; each
// warp's 32 x 32 exchange rows and input row in shared memory (8.25 KB a
// warp in float64, 4.1 KB in float32). float64: 2 blocks an SM at most 255
// registers a thread (240 used: the tile and w take 128); float32: 3
// blocks at most 168 (161 used). Scratch (the wrapper's): W^T as tagged
// words, 32-row tiles; R (nt, b + 31, 32, 6 or 4 words), zeroed; the
// ticket.

#include "chol_downdate.cuh"

// chol(L L^T - W W^T) in place of L's lower triangle on `stream`, dtype
// 0 = float32, 1 = float64. L (n, n) row-major; Wt (b, 32 nt) values of
// W^T as tagged words (a float in one 64-bit word, a double in two: low
// half, high half; each half in the word's low 32 bits, tag 0 above), nt
// = ceil(n / 32), zero from row n on, overwritten; R (nt, b + 31, 32, 4
// or 6) zeroed words; ticket one zeroed uint32; n >= 1, b >= 1. Returns the
// launch's error, else cudaGetLastError().
extern "C" int chol_downdate(int dtype, void* L, void* Wt, void* R,
                             void* ticket, int n, int b, void* stream) {
  return run<false>(dtype, L, Wt, R, ticket, n, b, stream);
}

// The rows of a row tile and the columns of a column tile (the 32 above),
// which the wrapper's scratch follows.
extern "C" int chol_downdate_tile() { return TILE; }

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
