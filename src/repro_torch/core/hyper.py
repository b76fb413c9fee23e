"""Hyperparameter learning via maximum likelihood (paper Sec. 6: MLE on a
random 10k subset; Rasmussen & Williams 2006 ch. 5) — port of
``repro.core.hyper``.

Two objectives:
* ``gp.nlml``      — exact marginal likelihood (what the paper uses, on a
  subset small enough for O(n^3));
* ``pitc_nlml``    — the PITC approximate marginal likelihood, distributable
  with the same summary trick as prediction: per-block terms + one |S|x|S|
  sum over machines, so hyperparameters can be fit on all the data.

The gradient is ``torch.autograd``'s. The objectives take the plain
``covariance.make_kernel("se")``, as the reference's take plain ``jnp``:
none of the CUDA kernels has a backward, and their wrappers refuse a graph
(``kernels/rbf/ops.refuse_grad``), so MLE runs as plain PyTorch on the card.

The global S-space matrix Sdd = K_SS + Σ_m Σ̇_m is factored from its square
root, never formed: at the paper's scale (|D| = 32000, M = 20, |S| = 2048)
it is too ill-conditioned for a float32 Cholesky (ROADMAP §3), which the
reference takes.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import covariance as cov
from repro_torch.core import gp, linalg
from repro_torch.optim.adam import Adam
from repro_torch.parallel.runner import Runner


def _sdd_chol(Kss: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """chol(Sdd + j I), Sdd = K_SS + Σ_m G_mᵀ G_m, with the reference's
    jitter for ``chol(Kss + Sdot)``: j = default_jitter x mean diag(Sdd).
    The diagonal of Σ_m G_mᵀ G_m is the squared column norms of the G_m,
    so Sdd is never formed: the factor is ``linalg.chol_from_root`` of the
    stacked square root [chol(K_SS + j I)ᵀ; G_1; ...; G_M]."""
    s = Kss.shape[-1]
    j = linalg.default_jitter(Kss.dtype) * (
        torch.diagonal(Kss).mean() + torch.sum(G * G) / s)
    eye = torch.eye(s, dtype=Kss.dtype, device=Kss.device)
    return linalg.chol_from_root(linalg.cholesky_nan(Kss + j * eye), G.mT)


def pitc_nlml_machine(kfn, params, S, Xm, ym) -> torch.Tensor:
    """-log p(y|theta) under the PITC model N(0, Gamma_DD + Lambda), for
    the machine blocks Xm (M, b, d), ym (M, b), all machines at once.

    The matrix-determinant and inversion lemmas keep everything global in
    S-space: with C_m = Sigma_{D_m D_m|S} and G_m = C_{L,m}⁻¹ K_{D_m S},

      log|Gamma + Lambda| = log|Sdd| - log|K_SS| + Σ_m log|C_m|,
      yᵀ(Gamma + Lambda)⁻¹y = Σ_m |C_{L,m}⁻¹ y_m|² - yddᵀ Sdd⁻¹ ydd,

    ydd = Σ_m G_mᵀ C_{L,m}⁻¹ y_m, Sdd = K_SS + Σ_m G_mᵀ G_m. Sdd's factor
    comes from the QR of its square root (``_sdd_chol``): the same matrix,
    jitter included, that the reference factors as ``chol(Kss + Sdot)``.
    Its log-determinant is the factor's, its solve two triangular
    solves."""
    Kss = kfn(params, S, S)
    Kss_L = linalg.chol(Kss)
    Ksd = kfn(params, S, Xm)                                # (M, s, b)
    V = linalg.tri_solve(Kss_L, Ksd)                        # Kss^{-1/2} K_SD
    Kdd = cov.add_noise(kfn(params, Xm, Xm), params)
    C_L = linalg.chol(Kdd - V.mT @ V)                       # chol C_m
    G = linalg.tri_solve(C_L, Ksd.mT)                       # (M, b, s)
    z = linalg.tri_solve(C_L, ym[..., None])[..., 0]        # C_L⁻¹ y_m
    quad = torch.sum(z * z)
    ydd = torch.einsum("mbs,mb->s", G, z)
    logdet_blocks = linalg.logdet_from_chol(C_L).sum()
    n = Xm.shape[0] * Xm.shape[1]
    Sdd_L = _sdd_chol(Kss, G)
    logdet = (linalg.logdet_from_chol(Sdd_L)
              - linalg.logdet_from_chol(Kss_L) + logdet_blocks)
    w = linalg.chol_solve(Sdd_L, ydd[:, None])[:, 0]        # Sdd⁻¹ ydd
    quad_total = quad - ydd @ w
    return 0.5 * (quad_total + logdet + n * math.log(2 * math.pi))


def pitc_nlml(kfn, params, S, X, y, runner: Runner) -> torch.Tensor:
    Xb, yb = runner.shard_blocks(X), runner.shard_blocks(y)
    return runner.map(lambda Xm, ym, params, S: pitc_nlml_machine(
        kfn, params, S, Xm, ym), (Xb, yb), (params, S))


def fit(kfn, params, X=None, y=None, *, steps: int = 200, lr: float = 0.05,
        objective=None) -> tuple[dict, torch.Tensor]:
    """Adam on the (exact, by default) negative log marginal likelihood;
    returns the final hyperparameters and the (steps,) losses, each taken
    before its step's update, as the reference's jitted loop returns them.

    ``objective`` overrides the data-bound default entirely; (X, y) are
    only consulted — and only then required — when no objective is given."""
    if objective is None:
        if X is None or y is None:
            raise ValueError(
                "hyper.fit needs (X, y) for the default exact-NLML "
                "objective; pass data or a custom objective")
        objective = lambda p: gp.nlml(kfn, p, X, y)
    opt = Adam(lr=lr)
    params = {k: v.detach() for k, v in params.items()}
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = objective(leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        params, state = opt.update(dict(zip(leaves, grads)), state, params)
        losses.append(loss.detach())
    return params, torch.stack(losses)


def fit_parallel(kfn, params, S, X, y, runner: Runner, *, steps: int = 200,
                 lr: float = 0.05) -> tuple[dict, torch.Tensor]:
    """MLE on ALL data via the distributable PITC likelihood. The data is
    bound inside the objective; ``fit`` never sees it."""
    obj = lambda p: pitc_nlml(kfn, p, S, X, y, runner)
    return fit(kfn, params, steps=steps, lr=lr, objective=obj)
