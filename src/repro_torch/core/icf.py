"""Pivoted incomplete Cholesky factorization (paper Sec. 4) — port of
``repro.core.icf.icf_factor``. The ICF-based predictors come with the pICF
slice.

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


def icf_factor(kfn, params, X: torch.Tensor, R: int) -> ICFFactor:
    """Pivoted incomplete Cholesky of the signal kernel matrix.

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
        return ICFFactor(*rbf_ops.icf_factor(Xs, cov.signal_var(params), R))
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
