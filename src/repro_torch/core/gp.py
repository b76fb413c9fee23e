"""Full (exact) Gaussian process regression — paper Sec. 2, eqs. (1)-(2);
port of ``repro.core.gp``.

FGP is the O(|D|^3) centralized baseline: ``fit`` caches the |D|x|D|
Cholesky in an ``api.FGPState`` and ``predict_batch`` costs O(|U||D|) per
query batch; ``predict`` is the one-shot wrapper over the two.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import api
from repro_torch.core import covariance as cov
from repro_torch.core import linalg


class GPPosterior(NamedTuple):
    """Predictive Gaussian N(mean, cov); ``var`` is diag(cov)."""
    mean: torch.Tensor
    cov: torch.Tensor

    @property
    def var(self) -> torch.Tensor:
        return torch.diagonal(self.cov, dim1=-2, dim2=-1)


def fit(kfn: cov.KernelFn, params: dict, X_train: torch.Tensor,
        y_train: torch.Tensor, **_) -> api.FGPState:
    """Cache chol(K_DD + noise) and its solve against y (zero prior mean)."""
    K_dd = cov.add_noise(kfn(params, X_train, X_train), params)
    L = linalg.chol(K_dd)
    alpha = linalg.chol_solve(L, y_train[:, None])[:, 0]
    return api.FGPState(X_train, L, alpha)


def predict_batch(kfn: cov.KernelFn, params: dict, state: api.FGPState,
                  X_test: torch.Tensor, *,
                  diag_only: bool = False) -> GPPosterior:
    """Eqs. (1)-(2) from the cached factors: no |D|^3 work per query."""
    K_ud = kfn(params, X_test, state.X)
    mean = K_ud @ state.alpha
    V = linalg.tri_solve(state.L, K_ud.T)     # L^{-1} K_du
    if diag_only:
        var = cov.kdiag(kfn, params, X_test) - torch.sum(V * V, dim=0)
        return GPPosterior(mean, torch.diag(var))
    K_uu = kfn(params, X_test, X_test)
    return GPPosterior(mean, K_uu - V.T @ V)


def predict_batch_diag(kfn, params, state: api.FGPState, X_test):
    """(mean, var) vectors — no |U|x|U| intermediates (serving hot path).

    With a CUDA ``cov.KernelSpec`` this is one ``xcov_diag`` dispatch: FGP
    is the L2-less case of the fused serving kernel (var = sig2 - q(L))."""
    if isinstance(kfn, cov.KernelSpec) and kfn.fuse(state.X.device):
        return kfn.fused_diag(params, X_test, state.X, state.L, state.alpha)
    K_ud = kfn(params, X_test, state.X)
    mean = K_ud @ state.alpha
    V = linalg.tri_solve(state.L, K_ud.T)
    var = cov.kdiag(kfn, params, X_test) - torch.sum(V * V, dim=0)
    return mean, var


def predict(kfn: cov.KernelFn, params: dict, X_train: torch.Tensor,
            y_train: torch.Tensor, X_test: torch.Tensor, mean_fn=None, *,
            diag_only: bool = False) -> GPPosterior:
    """One-shot eqs. (1)-(2): fit + predict_batch, or, with a prior
    ``mean_fn`` (not state-cacheable), the reference's inline path."""
    if mean_fn is None:
        state = fit(kfn, params, X_train, y_train)
        return predict_batch(kfn, params, state, X_test, diag_only=diag_only)

    mu_d = _mean(mean_fn, X_train, y_train.dtype)
    mu_u = _mean(mean_fn, X_test, y_train.dtype)
    K_dd = cov.add_noise(kfn(params, X_train, X_train), params)
    K_ud = kfn(params, X_test, X_train)
    L = linalg.chol(K_dd)
    alpha = linalg.chol_solve(L, (y_train - mu_d)[:, None])[:, 0]
    mean = mu_u + K_ud @ alpha
    V = linalg.tri_solve(L, K_ud.T)           # L^{-1} K_du
    if diag_only:
        var = cov.kdiag(kfn, params, X_test) - torch.sum(V * V, dim=0)
        return GPPosterior(mean, torch.diag(var))
    K_uu = kfn(params, X_test, X_test)
    return GPPosterior(mean, K_uu - V.T @ V)


def nlml(kfn: cov.KernelFn, params: dict, X_train: torch.Tensor,
         y_train: torch.Tensor, mean_fn=None) -> torch.Tensor:
    """Negative log marginal likelihood -log p(y_D | theta) for MLE."""
    n = X_train.shape[0]
    mu_d = _mean(mean_fn, X_train, y_train.dtype)
    K = cov.add_noise(kfn(params, X_train, X_train), params)
    L = linalg.chol(K)
    r = (y_train - mu_d)[:, None]
    alpha = linalg.chol_solve(L, r)
    return 0.5 * (r.T @ alpha)[0, 0] + 0.5 * linalg.logdet_from_chol(L) \
        + 0.5 * n * math.log(2.0 * math.pi)


def _mean(mean_fn, X: torch.Tensor, dtype) -> torch.Tensor:
    """The prior mean at X: ``mean_fn(X)``, or zeros in ``dtype``."""
    if mean_fn is None:
        return torch.zeros((X.shape[0],), dtype=dtype, device=X.device)
    return mean_fn(X)


api.register(api.GPMethod("fgp", fit, predict_fn=predict_batch,
                          predict_diag_fn=predict_batch_diag))
