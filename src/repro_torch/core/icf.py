"""Centralized ICF-approximated GP regression (paper Sec. 4) — port of
``repro.core.icf``.

* ``icf_factor`` — pivoted incomplete Cholesky factorization of the
  *signal* kernel matrix K_DD (noise-free): F (R x |D|) with K_DD ~= F^T F,
  never forming K_DD;
* ``icf_predict_literal`` — eqs. (28)-(29) with a dense |D|x|D| solve; the
  oracle of the Theorem 3 equivalence test;
* ``icf_predict`` — the Woodbury form
    (F^T F + s^2 I)^{-1} = s^{-2} I - s^{-4} F^T Phi^{-1} F,
    Phi = I + s^{-2} F F^T                       (R x R),
  which is what pICF's steps 3-6 compute (``core/picf.py``).

On the card, the SE kernel's factorization is one launch of the ICF
kernel (``kernels/rbf/csrc/rbf_icf.cu``: every pivot step, with the kernel
column computed in the update), as the reference runs its loop as one
``fori_loop`` program; ``uses_kernel`` says which calls take it. Every
other call runs the step loop below.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import covariance as cov
from repro_torch.core import linalg
from repro_torch.core.gp import GPPosterior


class ICFFactor(NamedTuple):
    F: torch.Tensor          # (R, n) incomplete Cholesky factor, K ~= F^T F
    pivots: torch.Tensor     # (R,) pivot indices in selection order
    residual: torch.Tensor   # (n,) remaining diagonal residual (trace error)


def uses_kernel(kfn, device: torch.device, dtype: torch.dtype) -> bool:
    """Does ``icf_factor`` run as the ICF kernel for ``kfn`` over inputs on
    ``device`` in ``dtype``? For the SE family through the CUDA kernels (a
    ``KernelSpec`` "se"/"se_pallas" whose impl resolves to "cuda", or the
    bare ``se_ard_kernel``) on a CUDA device, in float32 or float64. Not
    for CPU tensors, impl "torch", Matern, RQ, the bare ``se_ard``, or
    bfloat16: those run the step loop."""
    if device.type != "cuda" or dtype not in (torch.float32, torch.float64):
        return False
    if isinstance(kfn, cov.KernelSpec):
        return kfn.name in cov._SE_FAMILY \
            and kfn.resolved_impl(device) == "cuda"
    return kfn is cov.se_ard_kernel


def icf_factor(kfn, params, X: torch.Tensor, R: int, *,
               pivot_values: bool = False):
    """Pivoted incomplete Cholesky of the signal kernel matrix: an
    ``ICFFactor``, and with ``pivot_values`` also the (R,) pivot values d_p
    (the residual each step pivoted on; pICF's pivot triangle has
    sqrt(d_p) on its diagonal), as ``(ICFFactor, d_p)``.

    Never forms K_DD: only diag(K) and one kernel column per pivot step
    (O(R |D|) kernel evaluations, O(R^2 |D|) flops). Where ``uses_kernel``
    says so, all R steps are one launch of the ICF kernel (which raises
    rather than fall back to the loop). Otherwise the loop: the pivot stays
    on the device (index_select/index_fill with a 0-dim index tensor), so
    it never waits for the card, and F is filled in place, row by row.
    """
    if uses_kernel(kfn, X.device, X.dtype):
        from repro_torch.kernels.rbf import ops as rbf_ops
        Xs = cov._scale(params, X).to(X.dtype)
        out = rbf_ops.icf_factor(Xs, cov.signal_var(params), R,
                                 pivot_values=pivot_values)
        return (ICFFactor(*out[:3]), out[3]) if pivot_values \
            else ICFFactor(*out)
    n = X.shape[0]
    d = cov.kdiag(kfn, params, X)                      # diag of K (signal)
    F = torch.zeros((R, n), dtype=d.dtype, device=X.device)
    piv = torch.zeros((R,), dtype=torch.long, device=X.device)
    dpv = torch.zeros((R,), dtype=d.dtype, device=X.device)
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
        dpv[i] = dp[0]
    fac = ICFFactor(F, piv, d)
    return (fac, dpv) if pivot_values else fac


def icf_predict_literal(kfn, params, X_train, y_train, X_test,
                        F: torch.Tensor) -> GPPosterior:
    """Eqs. (28)-(29) with the dense (F^T F + s^2 I) solve. Test oracle."""
    s2 = cov.noise_var(params)
    n = X_train.shape[0]
    A = F.T @ F + s2 * torch.eye(n, dtype=F.dtype, device=F.device)
    A_L = linalg.chol(A, jitter=0.0)
    K_ud = kfn(params, X_test, X_train)
    mean = (K_ud @ linalg.chol_solve(A_L, y_train[:, None]))[:, 0]
    K_uu = kfn(params, X_test, X_test)
    covm = K_uu - K_ud @ linalg.chol_solve(A_L, K_ud.T)
    return GPPosterior(mean, covm)


def icf_predict(kfn, params, X_train, y_train, X_test,
                F: torch.Tensor) -> GPPosterior:
    """Woodbury form — O(R^2 |D| + R |U| |D|), Table 1 row "ICF-based"."""
    s2 = cov.noise_var(params)
    R = F.shape[0]
    Phi = torch.eye(R, dtype=F.dtype, device=F.device) + F @ F.T / s2
    Phi_L = linalg.chol(Phi, jitter=0.0)

    K_ud = kfn(params, X_test, X_train)                       # (u, n)
    ydot = F @ y_train                                        # (R,)
    Sdot = F @ K_ud.T                                         # (R, u)
    ydd = linalg.chol_solve(Phi_L, ydot[:, None])[:, 0]       # eq. (22)
    Sdd = linalg.chol_solve(Phi_L, Sdot)                      # eq. (23)

    mean = (K_ud @ y_train) / s2 - (Sdot.T @ ydd) / s2**2     # eqs. (24),(26)
    K_uu = kfn(params, X_test, X_test)
    covm = K_uu - (K_ud @ K_ud.T) / s2 + (Sdot.T @ Sdd) / s2**2   # (25),(27)
    return GPPosterior(mean, covm)
