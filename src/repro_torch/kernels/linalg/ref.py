"""Plain PyTorch versions of the linear-algebra kernels: the Cholesky
downdate (``csrc/chol_downdate.cu``) and the fixed-order row products
(``csrc/row_products.cu``). The wrappers' path for CPU and meta tensors,
and what the kernels are held against on the card."""
from __future__ import annotations

import torch
import torch.nn.functional as F

KSTEP = 8      # the products one tree sums (row_products.cu's k-step)
LANES = 32     # the lanes of a row's dot (row_products.cu's warp)


def chol_downdate(L: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of L Lᵀ − W Wᵀ for lower L (n, n) and W (n, b).

    The reference's sweeps (``repro.core.linalg._chol_rank1`` with sign −1,
    chained over W's columns): at step k of sweep j, with l = L[k, k] and
    w = w_j,

        r = sqrt(max(l² − w_k², tiny)),   c = r / l,   s = w_k / l,
        L[i, k] = (L[i, k] − s w_i) / c,   w_i = c w_i − s L[i, k]   (i > k),
        L[k, k] = r.

    Step k of sweep j reads only column k as sweep j − 1 left it and w_j as
    its own step k − 1 left it, so the pairs (j, k) with j + k = d depend
    only on diagonal d − 1. This version runs the n + b − 1 diagonals in
    order, each as one batched update of its pairs: the same operations on
    the same values as the chained sweeps, rounding for rounding, in the
    order the kernel runs them. Zero columns of W leave L as it is, bit for
    bit (c = 1, s = 0). Where the difference is not positive definite the
    clamp gives r = sqrt(tiny) and the result is garbage, as in the
    reference: callers downdate only what was folded in.
    """
    n, b = W.shape
    Lt = L.mT.clone()                      # row k: column k of L
    Wt = W.mT.clone()                      # row j: w_j
    dg = torch.diagonal(L).clone()         # the diagonal as the sweeps leave it
    tiny = torch.finfo(L.dtype).tiny
    rows = torch.arange(n, device=L.device)
    for d in range(n + b - 1):
        j = torch.arange(max(0, d - n + 1), min(d, b - 1) + 1,
                         device=L.device)
        k = d - j
        lk, wk = dg[k], Wt[j, k]
        r = torch.sqrt(torch.clamp(lk * lk - wk * wk, min=tiny))
        c, s = (r / lk)[:, None], (wk / lk)[:, None]
        Lr, wr = Lt[k], Wt[j]
        below = rows > k[:, None]
        col = torch.where(below, (Lr - s * wr) / c, Lr)
        Lt[k] = col
        Wt[j] = torch.where(below, c * wr - s * col, wr)
        dg[k] = r
    Lt.diagonal().copy_(dg)
    return Lt.mT.contiguous()


def _tree(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum ``p`` over ``dim`` (a power of two long) by halves: element i of
    the first half plus element i of the second, until one is left."""
    while p.shape[dim] > 1:
        h = p.shape[dim] // 2
        p = p.narrow(dim, 0, h) + p.narrow(dim, h, h)
    return p.squeeze(dim)


def rows_mm(X: torch.Tensor, B: torch.Tensor, idx: torch.Tensor | None = None,
            *, trans: bool = False, lower: bool = False,
            C0: torch.Tensor | None = None) -> torch.Tensor:
    """Y[k] = X[k] op(B_e), or C0[k] - X[k] op(B_e) where C0 is given, for
    X (nblk, u, K): B_e = B[idx[k]] (or B[k]) of a table B (nt, P, Q), or B
    itself (P, Q) for every block; op(B_e) = B_eᵀ with ``trans``. With
    ``lower`` B_e is lower triangular.

    Every element is summed over K in k-steps of KSTEP products taken in
    order, each step's products summed by halves (``_tree``), then added to
    the running sum; each product and sum rounded once. In float64 that is
    the kernel's arithmetic, bit for bit; in float32 the kernel runs each
    k-step's products in 3xTF32 on the tensor cores instead. A row's
    result depends only on its row of X and on B_e. With ``lower`` the
    columns a k-step cannot reach are left out (their products are zeros);
    K is padded with zeros to whole k-steps. Each k-step reads KSTEP rows
    of each block's op(B_e): the table is not copied."""
    nblk, u, K = X.shape
    if idx is None and B.dim() == 3:
        idx = torch.arange(nblk, device=X.device)
    N = B.shape[-2] if trans else B.shape[-1]
    acc = torch.zeros((nblk, u, N), dtype=X.dtype, device=X.device)
    for k0 in range(0, K, KSTEP):
        k1 = min(k0 + KSTEP, K)
        # the output columns this k-step reaches
        c0, c1 = (k0, N) if lower and trans else (0, k1) if lower else (0, N)
        if c0 >= c1:
            continue
        if B.dim() == 2:
            b = B[c0:c1, k0:k1].mT if trans else B[k0:k1, c0:c1]
        else:
            b = B[idx, c0:c1, k0:k1].mT if trans else B[idx, k0:k1, c0:c1]
        x = X[..., k0:k1]
        if k1 - k0 < KSTEP:
            x = F.pad(x, (0, KSTEP - (k1 - k0)))
            b = F.pad(b, (0, 0, 0, KSTEP - (k1 - k0)))
        p = x[..., :, None] * (b[None] if B.dim() == 2 else b[:, None])
        acc[..., c0:c1] = acc[..., c0:c1] + _tree(p, -2)
    return acc if C0 is None else C0 - acc


def _row_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_i x[..., i] y[..., i] in the kernel's order: lane l of LANES sums
    elements l, l + LANES, ... in turn, then the lanes by halves."""
    p = x * y
    n = p.shape[-1]
    p = F.pad(p, (0, -n % LANES)).unflatten(-1, (-1, LANES))
    acc = p[..., 0, :]
    for c in range(1, p.shape[-2]):
        acc = acc + p[..., c, :]
    return _tree(acc, -1)


def rows_reduce(kdiag: torch.Tensor, Phi: torch.Tensor, alpha: torch.Tensor,
                R: torch.Tensor, Wy: torch.Tensor, idx: torch.Tensor | None,
                A: torch.Tensor, V: torch.Tensor, Z: torch.Tensor, *,
                cinv: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) (nblk, u) of eqs. (12)-(13) from the per-block program's
    rows: mean = Phi.alpha + R.Wy_e, var = ((kdiag - |A|²) - |V|²) + |Z|²,
    with R.V in place of |V|² where ``cinv`` (V then holds W = R C⁻¹).
    Phi, A, Z (nblk, u, s); R, V (nblk, u, b); alpha (s,); Wy a table
    (nt, b), block k's entry idx[k] (or k); kdiag (nblk, u). Each dot in
    ``_row_dot``'s order, as the kernel sums it."""
    w = Wy if idx is None else Wy[idx]
    mean = _row_dot(Phi, alpha) + _row_dot(R, w[:, None, :])
    t2 = _row_dot(R, V) if cinv else _row_dot(V, V)
    var = ((kdiag - _row_dot(A, A)) - t2) + _row_dot(Z, Z)
    return mean, var
