"""pPITC — parallel PITC approximation of FGP (paper Sec. 3, Defs. 1-4);
port of ``repro.core.ppitc``.

Per-machine program, batched over the leading axis of the machines one
process holds (``parallel.runner``: all M on a ``VmapRunner``, L a rank on
a ``ShardMapRunner``):

  Step 1  data arrives block-sharded: machine m holds (D_m, y_{D_m});
  Step 2  local summary  (eqs. 3-4)  — O((|D|/M)^3) local Cholesky;
  Step 3  global summary (eqs. 5-6)  — the one all-reduce of the algorithm,
          a psum over the machine axis (Table 1: O(|S|^2 log M));
  Step 4  predict (eqs. 7-8) from the cached S-space factors.

``fit`` runs steps 1-3 and caches ``api.PITCState`` (Kss_L, Sdd_L, alpha =
Sdd^{-1} ydd); ``predict_batch``/``predict_batch_diag`` are then
O(|U||S| + |S|^2) per query batch; ``predict`` is the one-shot wrapper
(fit + ``predict_blocks``). ``machine_step``/``predict_distributed`` keep
the fully-collective execution the paper describes, with the psum inside
each machine's program. Zero prior mean assumed (the data pipeline centers
y). ``init_store`` is the streaming entry point (``online.PITCStore``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import api
from repro_torch.core import covariance as cov
from repro_torch.core import linalg
from repro_torch.core.gp import GPPosterior
from repro_torch.parallel.runner import Runner


class LocalSummary(NamedTuple):
    """(eqs. 3-4) restricted to B = B' = S — what crosses the network.
    Stacked over machines: (M, s) and (M, s, s)."""
    ydot: torch.Tensor   # (..., s)    y-dot_S^m
    Sdot: torch.Tensor   # (..., s, s) Sigma-dot_SS^m


class GlobalSummary(NamedTuple):
    """(eqs. 5-6)."""
    ydd: torch.Tensor    # (s,)
    Sdd: torch.Tensor    # (s, s)  ( = K_SS + sum_m Sdot^m )


class ParallelPosterior(NamedTuple):
    """Block posterior: machine m owns mean/cov of its U_m slice."""
    mean: torch.Tensor      # (u,)
    blocks: torch.Tensor    # (M, u/M, u/M) diagonal covariance blocks

    @property
    def var(self) -> torch.Tensor:
        return torch.diagonal(self.blocks, dim1=-2, dim2=-1).reshape(-1)

    @property
    def cov(self) -> torch.Tensor:   # dense block-diagonal view (small U only)
        return torch.block_diag(*self.blocks)


def local_summary(kfn, params, S, Kss_L, Xm, ym):
    """Eqs. (3)-(4) with B=B'=S, for machine blocks Xm (..., b, d) and
    ym (..., b). Also returns the pieces pPIC/hyper reuse:
    (Ksd, C_L = chol Sigma_{DmDm|S}, Wy = C^{-1} y_m)."""
    Ksd = kfn(params, S, Xm)                          # (..., s, b)
    V = linalg.tri_solve(Kss_L, Ksd)                  # Kss^{-1/2} K_SD_m
    Kdd = cov.add_noise(kfn(params, Xm, Xm), params)
    C_L = linalg.chol(Kdd - V.mT @ V)                 # chol Sigma_{DmDm|S}
    Wy = linalg.chol_solve(C_L, ym[..., None])[..., 0]
    ydot = (Ksd @ Wy[..., None])[..., 0]
    Sdot = Ksd @ linalg.chol_solve(C_L, Ksd.mT)
    return LocalSummary(ydot, Sdot), (Ksd, C_L, Wy)


def global_summary(kfn, params, S, local: LocalSummary, *,
                   axis_name) -> GlobalSummary:
    """Eqs. (5)-(6): the single all-reduce of the algorithm — a psum over
    the machine axis ``axis_name`` (a runner's axis object) of ``local``,
    the (L, ...) stack of this process's summaries."""
    Kss = kfn(params, S, S)
    return GlobalSummary(axis_name.psum(local.ydot),
                         Kss + axis_name.psum(local.Sdot))


def machine_step(kfn, params, S, Xm, ym, Um, *, axis_name):
    """The full pPITC per-machine program, steps 2-4, for this process's
    machine blocks Xm (L, b, d), ym (L, b) and query blocks Um (L, u, d);
    ``axis_name`` is the runner's machine axis, over which step 3 psums.
    Returns (mean (L, u), cov (L, u, u)). Its step 4 is
    ``predict_from_summary``: the reference's Cholesky of the formed Sdd,
    which breaks down in float32 at the paper's scale (see there)."""
    Kss_L = linalg.chol(kfn(params, S, S))
    local, _ = local_summary(kfn, params, S, Kss_L, Xm, ym)
    glob = global_summary(kfn, params, S, local, axis_name=axis_name)
    return predict_from_summary(kfn, params, S, Kss_L, glob, Um)


def predict_from_summary(kfn, params, S, Kss_L, glob: GlobalSummary, Um):
    """Eqs. (7)-(8) from the global summary, as the reference writes them:
    Sdd is the formed ``glob.Sdd``, factored by Cholesky with its own
    jitter (default jitter x its mean diagonal).

    In float32 at the paper's scale (|D| = 32000, M = 20, |S| = 2048) that
    Cholesky breaks down (cond Sdd ~2.4e9; ROADMAP §3): the result is NaN.
    What serves is the fitted state (``fit`` -> ``predict_batch``/the plan),
    whose Sdd factor is the QR of its square root."""
    Sdd_L = linalg.chol(glob.Sdd)
    Kus = kfn(params, Um, S)
    mean = Kus @ linalg.chol_solve(Sdd_L, glob.ydd[:, None])[:, 0]
    Kuu = kfn(params, Um, Um)
    covm = Kuu - Kus @ (linalg.chol_solve(Kss_L, Kus.mT)
                        - linalg.chol_solve(Sdd_L, Kus.mT))
    return mean, covm


def fit(kfn, params, X, y, *, S, runner: Runner) -> api.PITCState:
    """Steps 1-3 over a Runner, cached as an ``api.PITCState`` through the
    summary store (``online.build``/``online.to_state``), as the reference
    does."""
    from repro_torch.core import online
    return online.to_state(online.build(kfn, params, S, X, y, runner), S)


def predict_batch(kfn, params, state: api.PITCState, U) -> GPPosterior:
    """Eqs. (7)-(8) from cached factors: O(|U||S| + |S|^2) per call."""
    Kus = kfn(params, U, state.S)
    mean = Kus @ state.alpha
    Kuu = kfn(params, U, U)
    covm = Kuu - Kus @ (linalg.chol_solve(state.Kss_L, Kus.mT)
                        - linalg.chol_solve(state.Sdd_L, Kus.mT))
    return GPPosterior(mean, covm)


def predict_batch_diag(kfn, params, state: api.PITCState, U):
    """(mean, var) without forming the |U|x|U| posterior covariance.

    The serving hot path: with a CUDA ``cov.KernelSpec`` the K_US tile, both
    cached triangular solves and the variance quadratic form collapse into
    the fused ``xcov_diag`` kernel, at any |S|. The compose path below is
    the math it is held against.
    """
    if isinstance(kfn, cov.KernelSpec) and kfn.fuse(state.S.device):
        return kfn.fused_diag(params, U, state.S, state.Kss_L, state.alpha,
                              L2=state.Sdd_L)
    Kus = kfn(params, U, state.S)
    mean = Kus @ state.alpha
    A = linalg.chol_solve(state.Kss_L, Kus.T)         # Kss^{-1} K_SU
    B = linalg.chol_solve(state.Sdd_L, Kus.T)         # Sdd^{-1} K_SU
    var = (cov.kdiag(kfn, params, U)
           - torch.sum(Kus.T * A, dim=0) + torch.sum(Kus.T * B, dim=0))
    return mean, var


def predict_blocks(kfn, params, state: api.PITCState, U,
                   M: int) -> ParallelPosterior:
    """Per-machine prediction layout (step 4) from the cached state; U's
    length must divide among the M machines."""
    u = U.shape[0]
    Ub = U.reshape(M, u // M, -1)
    post = predict_batch(kfn, params, state, Ub)
    return ParallelPosterior(post.mean.reshape(u), post.cov)


def predict(kfn, params, S, X, y, U, runner: Runner) -> ParallelPosterior:
    """End-to-end pPITC: fit + predict_blocks (U's length must divide among
    the runner's machines)."""
    state = fit(kfn, params, X, y, S=S, runner=runner)
    return predict_blocks(kfn, params, state, U, runner.num_machines)


def predict_distributed(kfn, params, S, X, y, U,
                        runner: Runner) -> ParallelPosterior:
    """Fully-collective pPITC (the psum inside each machine's program), the
    execution the paper describes. U's length must divide among the
    machines. Every process returns the whole posterior (the blocks
    gathered in machine order), as the ``VmapRunner`` does."""
    Xb, yb, Ub = (runner.shard_blocks(a) for a in (X, y, U))
    fn = lambda Xm, ym, Um, params, S: machine_step(
        kfn, params, S, Xm, ym, Um, axis_name=runner.axis)
    means, covs = runner.gather(runner.map(fn, (Xb, yb, Ub), (params, S)))
    return ParallelPosterior(runner.unshard(means), covs)


def summaries(kfn, params, S, X, y, runner: Runner):
    """Stacked (M, ...) per-machine local summaries (gathered to every
    process) + the global summary (Sec. 5.2: the global summary is a sum,
    so machines fold in and out)."""
    Xb, yb = runner.shard_blocks(X), runner.shard_blocks(y)

    def fn(Xm, ym, params, S):
        Kss_L = linalg.chol(kfn(params, S, S))
        local, _ = local_summary(kfn, params, S, Kss_L, Xm, ym)
        return local

    locals_ = runner.map(fn, (Xb, yb), (params, S))
    glob = global_summary(kfn, params, S, locals_, axis_name=runner.axis)
    return runner.gather(locals_), glob


def init_store(kfn, params, X, y, *, S, runner: Runner):
    """``api.StateStore`` entry point: the same summaries ``fit`` builds,
    kept mutable through the Sec. 5.2 algebra (``online.PITCStore``)."""
    from repro_torch.core import online
    return online.init_pitc_store(kfn, params, X, y, S=S, runner=runner)


api.register(api.GPMethod("ppitc", fit, predict_fn=predict_batch,
                          predict_diag_fn=predict_batch_diag,
                          init_store=init_store))
