"""Plain PyTorch version of the Cholesky downdate kernel
(``csrc/chol_downdate.cu``): the wrapper's path for CPU tensors, and what
the kernel is held against on the card."""
from __future__ import annotations

import torch


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
