"""Each hand-written kernel's work, counted from its shapes: the FLOP and
the bytes its function needs, whatever implements it, and the least time
the card could take for them (``bound_ms``).

The byte counts read each input once and write each output once; the FLOP
counts are multiply-adds x 2 of the function (a causal product counts its
causal half), except where a docstring says it counts a kernel's tiles (a
model of what the kernel executes, not a measurement). Where a kernel's
products run in 3xTF32 on the tensor cores, its bound takes three TF32
products for each of the function's (``3 * flops`` at ``PEAK_FLOPS_TF32``).

``chip_smoke.py`` prints each kernel's bound from these, and the profiling
launchers (``launch.profile``, ``launch.train_profile``,
``launch.xcov_sweep``) print them beside the times they trace.
"""
from __future__ import annotations

from repro_torch.roofline import hw


def bound_ms(nbytes: float, flops: float,
             peak_flops: float = hw.PEAK_FLOPS_F32) -> tuple[float, str]:
    """(the larger of bytes over the HBM rate and FLOP over ``peak_flops``,
    in ms; which of the two it is: "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / hw.HBM_BW, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- rbf.cu: covariance blocks and the exact pivot column -------------------

def rbf_flops(n_out: int, d: int) -> int:
    """An SE covariance block of ``n_out`` entries over d dimensions: the
    squared distance (3 operations a dimension less one multiply-add:
    2 d), then the scale, exp and sig2 (6)."""
    return n_out * (2 * d + 6)


def rbf_bytes(n_q: int, n_k: int, n_out: int, d: int,
              itemsize: int = 4) -> int:
    """The queries (n_q, d) and keys (n_k, d) read once, the block written
    once."""
    return (n_q * d + n_k * d + n_out) * itemsize


def rbf_exact_flops(n_out: int, d: int) -> int:
    """The exact instance's column (the ICF kernel's arithmetic: each
    dimension's difference, square and sum, 3 x 2 d), then 6 more."""
    return n_out * (3 * 2 * d + 6)


# -- rbf_icf.cu: the pivoted incomplete Cholesky in one launch ---------------

def icf_flops(n: int, R: int) -> int:
    """The R steps' GEMVs: 2 i n at step i, n R (R - 1) in all."""
    return n * R * (R - 1)


def icf_bytes(n: int, R: int, d: int, itemsize: int = 4) -> int:
    """The candidates (n, d) read once; the factor (R, n), the residual
    diagonal (n) and the pivots' values (R) written once, the pivots (R,
    int64) too; sig2 read once."""
    return itemsize * (n * d + R * n + n + R + 1) + 8 * R


def icf_gemv_bytes(n: int, R: int, itemsize: int = 4) -> int:
    """Bytes of F[:i] the GEMVs read over the run when none is kept on
    chip (a model of streaming them from HBM)."""
    return itemsize * n * R * (R - 1) // 2


def icf_stream_bytes(plan: dict, n: int, R: int, itemsize: int) -> int:
    """Bytes the ICF kernel's GEMVs read from L2 or device memory over the
    run, from its plan (a model): column j keeps its first c_j factor
    entries on chip (``smem_rows`` in shared memory; the first NC = 8
    columns of each warp also the register rows, ``cached_rows`` in all),
    and step i reads the other max(i - c_j, 0) of the i it sums
    (rbf_icf.cu, step 3)."""
    W, K, C = plan["width"], plan["smem_rows"], plan["cached_rows"]
    cw = W // 8                                   # columns a warp (NWARPS)
    total = 0
    for j in range(n):
        c = C if (j % W) % cw < 8 else K
        c = min(c, R)
        total += (R - c) * (R - c - 1) // 2
    return total * itemsize


# -- xcov_diag.cu: the fused serving diag ------------------------------------

def xcov_flops(n: int, s: int, with_l2: bool = True) -> int:
    """K_US's n rows through each s x s triangular inverse, s^2 / 2
    multiply-adds a row: n s^2 a triangle, 2 n s^2 with L2."""
    return n * s * s * (2 if with_l2 else 1)


def xcov_bytes(n: int, s: int, d: int, with_l2: bool,
               itemsize: int = 4) -> int:
    """Bytes xcov_diag must move: the lower triangle of each inverse
    (entries above the diagonal are never read), the queries, the support
    set, alpha and sig2 once, mean and var written once."""
    tri = s * (s + 1) // 2 * itemsize
    return tri * (2 if with_l2 else 1) + (n + s) * d * itemsize \
        + s * itemsize + itemsize + 2 * n * itemsize


# -- flash_attention.cu / flash_attention_bwd.cu -----------------------------

def attention_pairs(Tq: int, Tk: int, causal: bool) -> int:
    """(query, key) pairs a head computes: the causal half T (T + 1) / 2 of
    a square, else every pair."""
    if causal:
        if Tq != Tk:
            raise ValueError(f"a causal count takes Tq == Tk; got {Tq}, {Tk}")
        return Tq * (Tq + 1) // 2
    return Tq * Tk


def flash_flops(B: int, Hq: int, Tq: int, Tk: int, D: int,
                causal: bool) -> int:
    """The forward's two products, Q K^T and P V: 4 D a pair a head."""
    return 4 * B * Hq * D * attention_pairs(Tq, Tk, causal)


def flash_bytes(B: int, Hq: int, Hkv: int, Tq: int, Tk: int, D: int,
                itemsize: int = 2) -> int:
    """q and o (B, Hq, Tq, D), k and v (B, Hkv, Tk, D), each once."""
    return itemsize * (2 * B * Hq * Tq * D + 2 * B * Hkv * Tk * D)


def flash_bwd_flops(B: int, Hq: int, T: int, D: int) -> int:
    """The causal backward's five products (S, dP, dq, dk, dv), 2 D a pair
    each, over the causal half. The LSE the forward writes is read, not
    recomputed."""
    return 5 * 2 * B * Hq * D * attention_pairs(T, T, True)


def flash_bwd_bytes(B: int, Hq: int, Hkv: int, T: int, D: int) -> int:
    """q, o, dO, k, v and the float32 LSE read once, dq, dk, dv written
    once, bf16."""
    return 2 * 4 * B * T * D * (Hq + Hkv) + 4 * B * Hq * T


# -- ssd_intra_chunk.cu / ssd_intra_chunk_bwd.cu -----------------------------

def ssd_flops(BC: int, cs: int, H: int, P: int, N: int) -> tuple[int, int]:
    """(the function's flops, the flops the kernel's products execute) of
    one intra-chunk call, both in multiply-adds x 2, before 3xTF32 triples
    the tensor-core work. The function: the causal half (j <= i) of
    G = C B^T once per chunk (it does not depend on the head; L zeroes the
    rest), the causal Y product, the state S. The kernel's figure is a
    model, counted from the tiles of ssd_intra_chunk.cu, not a measurement:
    G once per (chunk, 64-row strip, group of 8 heads) over whole 64 x 64
    tiles, Y over the same tiles, S per pair of heads and 64 columns of N;
    P, N and the chunk padded to the tiles."""
    fn = 2 * BC * N * cs * (cs + 1) // 2 \
        + 2 * BC * H * P * cs * (cs + 1) // 2 + 2 * BC * H * P * N * cs

    def up(x, m):
        return -(-x // m) * m

    tiles = sum(-(-min(64 * (r + 1), cs) // 64) for r in range(-(-cs // 64)))
    g = 2 * BC * tiles * 64 * 64 * up(N, 32) * -(-H // 8)
    y = 2 * BC * tiles * 64 * 64 * up(P, 64) * H
    s = 2 * BC * up(H, 2) * up(P, 64) * up(N, 64) * up(cs, 32)
    return fn, g + y + s


def ssd_bytes(BC: int, cs: int, H: int, P: int, N: int) -> int:
    """xdt and Y (BC, cs, H, P), dA and cum (BC, H, cs), B and C (BC, cs,
    N), S (BC, H, P, N): each read or written once, float32."""
    return 4 * (2 * BC * cs * H * P + 2 * BC * H * cs + 2 * BC * cs * N
                + BC * H * P * N)


def ssd_bwd_flops(BC: int, cs: int, H: int, P: int, N: int) -> int:
    """The SSD backward's flops (multiply-adds x 2): G's causal half
    (recomputed), per head the causal halves of E = dY xdt^T and of
    (G o L)^T dY, the products xdt dS and B dS^T, then dC = dG B and
    dB = dG^T C over the causal half."""
    half = cs * (cs + 1) // 2
    return 2 * BC * N * half + BC * H * (2 * 2 * P * half
                                         + 2 * 2 * P * N * cs) \
        + 2 * 2 * BC * N * half


def ssd_bwd_bytes(BC: int, cs: int, H: int, P: int, N: int) -> int:
    """xdt, dY, dxdt; dA, dcum, ddA; B, C, dB, dC; dS: each read or written
    once, float32."""
    return 4 * (3 * BC * cs * H * P + 3 * BC * H * cs + 4 * BC * cs * N
                + BC * H * P * N)


# -- chol_downdate.cu ---------------------------------------------------------

def downdate_bytes(n: int, b: int, itemsize: int) -> int:
    """Bytes the downdate must move: L's lower triangle and W read once,
    the new triangle written once."""
    return itemsize * (n * (n + 1) + n * b)


def downdate_flops(n: int, b: int) -> int:
    """Six operations a row for each (sweep, step) pair: 3 b n (n - 1)."""
    return 3 * b * n * (n - 1)


# -- row_products.cu: pPIC's routed diag --------------------------------------

def rows_mm_flops(rows: int, K: int, N: int, lower: bool = False) -> int:
    """X (rows, K) op(B) (K, N): 2 rows K N; with a lower triangular B
    (square, K = N) the products with its triangle, rows K (K + 1)."""
    return rows * K * (K + 1) if lower else 2 * rows * K * N


def rows_mm_bytes(rows: int, K: int, N: int, entries: int, lower: bool,
                  with_c0: bool, itemsize: int = 4) -> int:
    """X read once, each table entry it reads once (a triangle of a lower
    B), C0 read and Y written once."""
    entry = K * (K + 1) // 2 if lower else K * N
    return itemsize * (rows * K + entries * entry
                       + rows * N * (2 if with_c0 else 1))


def rows_reduce_flops(rows: int, s: int, b: int) -> int:
    """A row's five dots (Phi.alpha, |A|^2, |Z|^2 over s; R.Wy and |V|^2
    over b), 2 operations an element."""
    return 2 * rows * (3 * s + 2 * b)


def rows_reduce_bytes(rows: int, s: int, b: int, entries: int,
                      itemsize: int = 4) -> int:
    """Phi, A, Z, R, V and kdiag read once, alpha and the Wy entries once,
    mean and var written once."""
    return itemsize * (rows * (3 * s + 2 * b + 3) + s + entries * b)


def ppic_diag_stages(nblk: int, u: int, s: int, b: int,
                     cinv: bool = False) -> list[tuple]:
    """The rows_mm launches of one routed request's diag program over nblk
    blocks of u rows (``core.ppic._diag_stages``): (stage, rows, K, N,
    table entries read, lower, with C0)."""
    rows = nblk * u
    solve = [("W = R C^-1", rows, b, b, nblk, False, False)] if cinv else [
        ("V = R C_L^-T", rows, b, b, nblk, True, False),
        ("W = V C_L^-1", rows, b, b, nblk, True, False)]
    return [("A = K_US L^-T", rows, s, s, 1, True, False),
            ("R = K_UD - A Q", rows, s, b, nblk, False, True), *solve,
            ("Phi = K_US - W K_DS", rows, b, s, nblk, False, True),
            ("Z = Phi L2^-T", rows, s, s, 1, True, False)]
