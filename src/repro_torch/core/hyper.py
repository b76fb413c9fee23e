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


def _sdd_chol(Kss: torch.Tensor, G: torch.Tensor, gg=None,
              axis=None) -> torch.Tensor:
    """chol(Sdd + j I), Sdd = K_SS + Σ_m G_mᵀ G_m, with the reference's
    jitter for ``chol(Kss + Sdot)``: j = default_jitter x mean diag(Sdd).
    The diagonal of Σ_m G_mᵀ G_m is the squared column norms of the G_m
    (their sum ``gg``, Σ_m |G_m|², by default that of the G given), so Sdd
    is never formed: the factor is ``linalg.chol_from_root`` of the stacked
    square root [chol(K_SS + j I)ᵀ; G_1; ...; G_M], a TSQR across ranks
    when ``axis`` is a ``DistAxis``."""
    s = Kss.shape[-1]
    if gg is None:
        gg = torch.sum(G * G)
    j = linalg.default_jitter(Kss.dtype) * (torch.diagonal(Kss).mean()
                                            + gg / s)
    eye = torch.eye(s, dtype=Kss.dtype, device=Kss.device)
    return linalg.chol_from_root(linalg.cholesky_nan(Kss + j * eye), G.mT,
                                 axis=axis)


def pitc_nlml_machine(kfn, params, S, Xm, ym, *,
                      axis_name=None) -> torch.Tensor:
    """-log p(y|theta) under the PITC model N(0, Gamma_DD + Lambda), for
    this process's machine blocks Xm (L, b, d), ym (L, b); ``axis_name`` is
    the runner's machine axis (None: every machine is here). Every process
    returns the same scalar.

    The matrix-determinant and inversion lemmas keep everything global in
    S-space: with C_m = Sigma_{D_m D_m|S} and G_m = C_{L,m}⁻¹ K_{D_m S},

      log|Gamma + Lambda| = log|Sdd| - log|K_SS| + Σ_m log|C_m|,
      yᵀ(Gamma + Lambda)⁻¹y = Σ_m |C_{L,m}⁻¹ y_m|² - yddᵀ Sdd⁻¹ ydd,

    ydd = Σ_m G_mᵀ C_{L,m}⁻¹ y_m, Sdd = K_SS + Σ_m G_mᵀ G_m. Sdd's factor
    comes from the QR of its square root (``_sdd_chol``): the same matrix,
    jitter included, that the reference factors as ``chol(Kss + Sdot)``.
    Its log-determinant is the factor's, its solve two triangular
    solves.

    Across ranks the rank's sums (ydd, the quadratic term, the blocks'
    log-determinants, |D| and Σ|G_m|², Sdd's jitter) travel in one fused
    psum, and Sdd's factor is a TSQR (one all-gather of |S| x |S|
    triangles). Both are differentiable: each rank's backward sums their
    gradients over ranks, so the objective's gradient is the mean of the
    ranks' (``Runner.reduce_grads``)."""
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
    gg = axis = None
    if axis_name is not None and axis_name.distributed:
        axis, s = axis_name, ydd.shape[0]
        gg = torch.sum(G * G)
        packed = axis.psum_ranks(torch.cat([ydd, torch.stack([
            quad, logdet_blocks, gg, torch.ones_like(quad) * n])]))
        ydd, quad, logdet_blocks, gg, n = (packed[:s], packed[s],
                                          packed[s + 1], packed[s + 2],
                                          packed[s + 3])
    Sdd_L = _sdd_chol(Kss, G, gg, axis)
    logdet = (linalg.logdet_from_chol(Sdd_L)
              - linalg.logdet_from_chol(Kss_L) + logdet_blocks)
    w = linalg.chol_solve(Sdd_L, ydd[:, None])[:, 0]        # Sdd⁻¹ ydd
    quad_total = quad - ydd @ w
    return 0.5 * (quad_total + logdet + n * math.log(2 * math.pi))


def pitc_nlml(kfn, params, S, X, y, runner: Runner) -> torch.Tensor:
    """The PITC NLML over a Runner's machines; the same scalar on every
    process."""
    Xb, yb = runner.shard_blocks(X), runner.shard_blocks(y)
    return runner.map(lambda Xm, ym, params, S: pitc_nlml_machine(
        kfn, params, S, Xm, ym, axis_name=runner.axis), (Xb, yb), (params, S))


def value_and_grad(objective, params: dict, grad_reduce=None):
    """(objective(params), its gradient by leaf) through ``torch.autograd``;
    ``grad_reduce`` turns a process's gradients into the objective's (a
    runner's ``reduce_grads``)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = objective(leaves)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    if grad_reduce is not None:
        grads = grad_reduce(grads)
    return loss.detach(), grads


def fit(kfn, params, X=None, y=None, *, steps: int = 200, lr: float = 0.05,
        objective=None, grad_reduce=None) -> tuple[dict, torch.Tensor]:
    """Adam on the (exact, by default) negative log marginal likelihood;
    returns the final hyperparameters and the (steps,) losses, each taken
    before its step's update, as the reference's jitted loop returns them.

    ``objective`` overrides the data-bound default entirely; (X, y) are
    only consulted — and only then required — when no objective is given.
    ``grad_reduce``: see ``value_and_grad``."""
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
        loss, grads = value_and_grad(objective, params, grad_reduce)
        params, state = opt.update(grads, state, params)
        losses.append(loss)
    return params, torch.stack(losses)


def fit_parallel(kfn, params, S, X, y, runner: Runner, *, steps: int = 200,
                 lr: float = 0.05) -> tuple[dict, torch.Tensor]:
    """MLE on ALL data via the distributable PITC likelihood. The data is
    bound inside the objective; ``fit`` never sees it. Over ranks every
    process takes the same steps (its gradients reduced by the runner)."""
    obj = lambda p: pitc_nlml(kfn, p, S, X, y, runner)
    return fit(kfn, params, steps=steps, lr=lr, objective=obj,
               grad_reduce=runner.reduce_grads)
