"""Plain PyTorch versions of the rbf CUDA kernels (covariance, the ICF
pivot loop, serving diag) — port of ``repro.kernels.rbf.ref``.

The wrappers in ``ops.py`` take these for CPU tensors; the tests hold them
against the JAX oracles, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card. Nothing on the main path calls them when a card is present.
"""
from __future__ import annotations

import torch


def rbf_covariance(Xq: torch.Tensor, Xk: torch.Tensor, sig2) -> torch.Tensor:
    """sig2 * exp(-0.5 ||x - z||^2) for pre-lengthscale-scaled inputs.

    Xq: (..., n, d), Xk: (..., m, d) -> (..., n, m), batch dimensions
    broadcasting. Accumulates in float32 whatever the input dtype (the
    kernel's contract) and returns Xq's dtype.
    """
    Xq32 = Xq.to(torch.float32)
    Xk32 = Xk.to(torch.float32)
    q2 = torch.sum(Xq32 * Xq32, dim=-1)[..., :, None]
    k2 = torch.sum(Xk32 * Xk32, dim=-1)[..., None, :]
    cross = Xq32 @ Xk32.mT
    d2 = torch.clamp(q2 + k2 - 2.0 * cross, min=0.0)
    sig2 = torch.as_tensor(sig2, dtype=torch.float32, device=Xq.device)
    return (sig2 * torch.exp(-0.5 * d2)).to(Xq.dtype)


def rbf_covariance_exact(Xq: torch.Tensor, Xk: torch.Tensor,
                         sig2) -> torch.Tensor:
    """``rbf_covariance`` in the inputs' dtype throughout, as the ICF
    loop computes its pivot column (``icf_factor`` below)."""
    q2 = torch.sum(Xq * Xq, dim=-1)[..., :, None]
    k2 = torch.sum(Xk * Xk, dim=-1)[..., None, :]
    d2 = torch.clamp(q2 + k2 - 2.0 * (Xq @ Xk.mT), min=0.0)
    sig2 = torch.as_tensor(sig2, dtype=Xq.dtype, device=Xq.device)
    return sig2 * torch.exp(-0.5 * d2)


def icf_factor(Xs: torch.Tensor, sig2, R: int,
               pivots: torch.Tensor | None = None, *,
               pivot_values: bool = False):
    """Pivoted incomplete Cholesky of the SE kernel matrix over pre-scaled
    candidates Xs (n, d), step by step: ``repro.core.icf.icf_factor``'s
    loop for the SE kernel, in Xs's dtype (the column too). Returns
    (F (R, n), pivots (R,) int64, residual (n,)), and with
    ``pivot_values`` also (R,) d_p, the residual each step pivoted on
    (before the step). Given ``pivots`` (R,), it
    takes them in place of the argmax (to replay another implementation's
    choices). The pivot stays on the device (index_select/index_fill with a
    one-element index tensor), so the loop never waits for the card; F is
    filled in place, row by row.
    """
    n = Xs.shape[0]
    dev, dt = Xs.device, Xs.dtype
    sig2 = torch.as_tensor(sig2, dtype=dt, device=dev)
    k2 = torch.sum(Xs * Xs, dim=-1)
    d = sig2.expand(n).clone()                          # diag of K
    F = torch.zeros((R, n), dtype=dt, device=dev)
    piv = torch.zeros((R,), dtype=torch.long, device=dev)
    dpv = torch.zeros((R,), dtype=dt, device=dev)
    for i in range(R):
        p = torch.argmax(d).reshape(1) if pivots is None \
            else pivots[i:i + 1]                        # first max, as jnp
        xp = Xs.index_select(0, p)                      # (1, dim)
        q2 = torch.sum(xp * xp, dim=-1)
        cross = (xp @ Xs.T)[0]
        col = sig2 * torch.exp(-0.5 * torch.clamp(q2 + k2 - 2.0 * cross,
                                                  min=0.0))   # K[p, :]
        fp = F[:i].index_select(1, p)[:, 0]             # F[:i, p]
        dp = d.index_select(0, p)
        f = (col - F[:i].T @ fp) / torch.sqrt(torch.clamp(dp, min=1e-30))
        F[i] = f
        d = torch.clamp(d - f * f, min=0.0)
        d.index_fill_(0, p, 0.0)
        piv[i] = p[0]
        dpv[i] = dp[0]
    return (F, piv, d, dpv) if pivot_values else (F, piv, d)


def icf_slack(F: torch.Tensor, pivots: torch.Tensor, sig2) -> torch.Tensor:
    """(R,) max(d) - d[p_i] before each step i of the loop that produced F
    along ``pivots``, its residual d replayed with ``icf_factor``'s own
    operations (so bit for bit the loop's). For ``icf_factor``'s own output
    it is 0 at every step; along the pivots another implementation chose
    (``icf_factor(..., pivots=...)``) it says how far below the plain
    loop's largest residual each of its choices fell."""
    R, n = F.shape
    d = torch.as_tensor(sig2, dtype=F.dtype, device=F.device).expand(n) \
        .clone()
    slack = torch.empty((R,), dtype=F.dtype, device=F.device)
    for i in range(R):
        p = pivots[i:i + 1]
        slack[i] = d.max() - d.index_select(0, p)[0]
        f = F[i]
        d = torch.clamp(d - f * f, min=0.0)
        d.index_fill_(0, p, 0.0)
    return slack


def xcov_diag(Xq: torch.Tensor, Xk: torch.Tensor, L1: torch.Tensor,
              alpha: torch.Tensor, sig2, L2: torch.Tensor | None = None):
    """Compose-path version of the fused serving kernel.

    Builds K_US dense, applies the cached triangular solves and reduces the
    variance quadratic form — the math ``ppitc.predict_batch_diag`` (L2 =
    chol Sdd) and ``gp.predict_batch_diag`` (L2 = None) perform, over
    pre-lengthscale-scaled inputs. Accumulates in float64 for float64 inputs
    and float32 otherwise, like the kernel.
    """
    acc = torch.float64 if Xq.dtype == torch.float64 else torch.float32
    Xqa, Xka = Xq.to(acc), Xk.to(acc)
    q2 = torch.sum(Xqa * Xqa, dim=-1)[:, None]
    k2 = torch.sum(Xka * Xka, dim=-1)[None, :]
    d2 = torch.clamp(q2 + k2 - 2.0 * (Xqa @ Xka.T), min=0.0)
    sig2 = torch.as_tensor(sig2, dtype=acc, device=Xq.device)
    kus = sig2 * torch.exp(-0.5 * d2)                  # (n, s)
    mean = torch.sum(kus * alpha.to(acc)[None, :], dim=1)
    # V = K_US L^{-T}: the right-sided solve X Lᵀ = K_US
    v1 = torch.linalg.solve_triangular(L1.to(acc).T, kus, upper=True,
                                       left=False)
    var = sig2 - torch.sum(v1 * v1, dim=1)
    if L2 is not None:
        v2 = torch.linalg.solve_triangular(L2.to(acc).T, kus, upper=True,
                                           left=False)
        var = var + torch.sum(v2 * v2, dim=1)
    return mean.to(Xq.dtype), var.to(Xq.dtype)
