"""Pivoted incomplete Cholesky factorization (paper Sec. 4) — port of
``repro.core.icf.icf_factor``. The ICF-based predictors come with the pICF
slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import covariance as cov


class ICFFactor(NamedTuple):
    F: torch.Tensor          # (R, n) incomplete Cholesky factor, K ~= F^T F
    pivots: torch.Tensor     # (R,) pivot indices in selection order
    residual: torch.Tensor   # (n,) remaining diagonal residual (trace error)


def icf_factor(kfn, params, X: torch.Tensor, R: int) -> ICFFactor:
    """Pivoted incomplete Cholesky of the signal kernel matrix.

    Never forms K_DD: only diag(K) and one kernel column per pivot step
    (O(R |D|) kernel evaluations, O(R^2 |D|) flops). The pivot stays on the
    device (index_select/index_fill with a 0-dim index tensor), so the loop
    never waits for the card. F is filled in place, row by row.
    """
    n = X.shape[0]
    d = cov.kdiag(kfn, params, X)                      # diag of K (signal)
    F = torch.zeros((R, n), dtype=d.dtype, device=X.device)
    piv = torch.zeros((R,), dtype=torch.long, device=X.device)
    for i in range(R):
        p = torch.argmax(d).reshape(1)                  # first max, as jnp
        xp = X.index_select(0, p)                       # (1, dim)
        col = kfn(params, xp, X)[0]                     # K[p, :]
        fp = F[:i].index_select(1, p)[:, 0]             # F[:i, p]
        dp = d.index_select(0, p)
        f = (col - F[:i].T @ fp) / torch.sqrt(torch.clamp(dp, min=1e-30))
        F[i] = f
        d = torch.clamp(d - f * f, min=0.0)
        d.index_fill_(0, p, 0.0)
        piv[i] = p[0]
    return ICFFactor(F, piv, d)
