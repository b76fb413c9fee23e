"""pPIC — parallel PIC approximation of FGP (paper Sec. 3, Def. 5, Thm. 2);
port of ``repro.core.ppic``.

Extends pPITC with the worker-local correction: machine m blends the global
summary with exact covariance against its own block (eqs. 12-14), recovering
centralized PIC (Snelson 2007) exactly.

``fit`` caches, per block, the factors the local correction needs (Ksd,
chol Sigma_{DmDm|S}, C^{-1}y, Kss^{-1}-projected summaries) plus the global
S-space factors, in an ``api.PICState``. A query batch then costs only
cross-covariances and cached triangular solves. Two query-to-block
assignment policies:

* positional (``predict_batch``/``predict_batch_diag``) — query blocks are
  slices of the batch in arrival order, zero-padded when |U| doesn't divide
  M;
* routed (``predict_routed``/``predict_routed_diag``) — each query goes to
  the block whose fit-time centroid it is nearest (Remark 2 at serving
  time), so its posterior depends only on the query point and the fitted
  state, never on the batch's order or composition. The diag variant serves
  through the two-bucket capacity layout (``runner.scatter_two_bucket``).

Every per-block function here runs all blocks of a layout at once, over the
leading block axis, as the port's ``VmapRunner`` does. The collective
per-machine program (``machine_step``, ``predict_distributed``) runs the
psum inside each machine's program, over a runner's machine axis: the L
machines of one process (``parallel.runner``).

NB eq. (13) as printed drops a `Phi Sdd^{-1} Phi^T` term; the form
implemented here is re-derived from Theorem 2 (see core/pitc.py) and held
against the literal PIC oracle.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import api, clustering
from repro_torch.core import covariance as cov
from repro_torch.core import linalg
from repro_torch.core.gp import GPPosterior
from repro_torch.core.ppitc import (GlobalSummary, LocalSummary,
                                    ParallelPosterior, global_summary,
                                    local_summary)
from repro_torch.parallel.runner import (ROUTED_ALPHA, Runner,
                                         gather_by_block, gather_two_bucket,
                                         pad_blocks, routed_capacity,
                                         scatter_by_block, scatter_two_bucket)


def machine_step(kfn, params, S, Xm, ym, Um, *, axis_name):
    """The full pPIC per-machine program, steps 2-4 with the local
    correction, for this process's machine blocks Xm (L, b, d), ym (L, b)
    and query blocks Um (L, u, d); ``axis_name`` is the runner's machine
    axis, over which step 3 psums. Returns (mean (L, u), cov (L, u,
    u)): the fitted state's posterior over these blocks, Sdd factored from
    its square root with K_SS's jitter (``predict_from_summary``), where
    the reference's program factors Sdd with a share of its own mean
    diagonal."""
    Kss_L = linalg.chol(kfn(params, S, S))
    local, (Ksd, C_L, _) = local_summary(kfn, params, S, Kss_L, Xm, ym)
    glob = global_summary(kfn, params, S, local, axis_name=axis_name)
    return predict_from_summary(kfn, params, S, Kss_L, local, glob,
                                Xm, ym, Um, Ksd=Ksd, C_L=C_L,
                                axis_name=axis_name)


def predict_from_summary(kfn, params, S, Kss_L, local: LocalSummary,
                         glob: GlobalSummary, Xm, ym, Um, *, Ksd=None,
                         C_L=None, axis_name=None):
    """Eqs. (12)-(14) for the machine blocks Xm (L, b, d), ym (L, b) and
    query blocks Um (L, u, d), from the global summary; ``Ksd``/``C_L`` are
    reusable from local_summary.

    The port runs a process's machines at once over the leading axis: all
    M of them with ``axis_name`` None, this process's L of the runner's
    machine axis otherwise. This is the whitened form below, which of the
    summaries reads only ``glob.ydd``. Sdd is factored from its square root
    [Lᵀ; F_1ᵀ; ...; F_Mᵀ], F_m = K_{S,D_m} C_m⁻ᵀ, as the store factors it
    (``online._sdd_chol``; a TSQR across ranks over an axis of several),
    not from the formed ``glob.Sdd``, whose float32 Cholesky breaks at the
    paper's scale. The result is then the fitted state's posterior
    (``predict_blocks``), with K_SS's jitter; the reference's
    ``chol(glob.Sdd)`` adds a share of Sdd's own mean diagonal instead
    (ROADMAP §3). ``local`` is kept for the reference's signature and not
    read."""
    from repro_torch.core import online
    if Xm.dim() != 3:
        raise ValueError(f"Xm must stack the machines' blocks as (L, b, d); "
                         f"got shape {tuple(Xm.shape)}")
    if Ksd is None:
        Ksd = kfn(params, S, Xm)
    Q = linalg.tri_solve(Kss_L, Ksd)
    if C_L is None:
        Kdd = cov.add_noise(kfn(params, Xm, Xm), params)
        C_L = linalg.chol(Kdd - Q.mT @ Q)
    Sdd_L = online._sdd_chol(Kss_L, linalg.tri_solve(C_L, Ksd.mT).mT,
                             axis_name)
    alpha = linalg.chol_solve(Sdd_L, glob.ydd[:, None])[:, 0]
    Wy = linalg.chol_solve(C_L, ym[..., None])[..., 0]
    return _block_posterior(kfn, params, api.PITCState(S, Kss_L, Sdd_L, alpha),
                            Um, BlockFields(Xm, Ksd, C_L, Wy, Q))


# ---------------------------------------------------------------------------
# fit -> PICState -> predict (core/api.py architecture)
# ---------------------------------------------------------------------------

def fit(kfn, params, X, y, *, S, runner: Runner) -> api.PICState:
    """Steps 1-3 over a Runner + per-block caches for eqs. (12)-(14): the
    initial state of ``online.PICStore``, as in the reference."""
    from repro_torch.core import online
    return online.init_pic_store(kfn, params, X, y, S=S,
                                 runner=runner).to_state()


def _rowdot(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row-wise multiply-reduce: A (..., u, n), v (..., n) -> (..., u)."""
    return torch.sum(A * v[..., None, :], dim=-1)


def _rows(solve, L: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """A right-sided ``solve`` against one shared (s, s) factor L for A
    (..., u, s): all rows of all blocks as one solve (the query axis on
    rows). The result is made row-major: the library returns it
    column-major, and a reduction over a strided last axis sums in an order
    that depends on the row count, which would break the layouts' bitwise
    equality."""
    return solve(L, A.reshape(-1, A.shape[-1])).reshape(A.shape).contiguous()


def _solve_rows(L: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """A (L Lᵀ)⁻¹ for one shared (s, s) factor L and A (..., u, s)."""
    return _rows(linalg.chol_solve_right, L, A)


def _kdiag(kfn, params, U: torch.Tensor) -> torch.Tensor:
    """diag k(U, U) for U (..., u, d)."""
    d = cov.kdiag(kfn, params, U.reshape(-1, U.shape[-1]))
    return d.reshape(U.shape[:-1])


# ---------------------------------------------------------------------------
# The per-block program, in the whitened form.
#
# The reference evaluates eqs. (12)-(14) as written: Phi = K_US + K_US B -
# Sdot_US with B = K_SS^{-1} Sdot_m, mean = Phi alpha - K_US beta + ydot_U,
# and a variance of four S- and D-space quadratic forms. Each of those sums
# cancels terms far larger than its result: K_US B and Sdot_US agree to
# within Phi - K_US, and K_SS^{-1} (jitter 1e-6 of its mean diagonal) makes
# their entries large. In float32 at the paper's scale (|S| = 2048) that
# cancellation leaves the posterior mean wrong by more than the noise (the
# test RMSE falls well behind pPITC's on the same data). The port computes
# the same matrices from whitened factors, whose entries are bounded by the
# prior's:
#
#   A   = K_US L^{-T}                     (L = chol K_SS; rows of norm <= k)
#   Q_m = L^{-1} K_{S,D_m}                (per block, cached per state)
#   R   = K_{U,D_m} - A Q_m = Sigma_{U D_m | S}   (the Nystrom residual)
#   Phi = K_US - R C^{-1} K_{D_m,S}                       (eq. 14)
#   mean = Phi alpha + R C^{-1} y_m                       (eq. 12)
#   cov  = K_UU - A A^T - R C^{-1} R^T + Phi Sdd^{-1} Phi^T   (eq. 13)
#
# which is eqs. (12)-(14) with K_US K_SS^{-1} Sdot_m - Sdot_US = -R C^{-1}
# K_DS and K_US K_SS^{-1} ydot_m - ydot_U = -R C^{-1} y_m multiplied out.
# The state keeps the reference's fields (B, beta and Sdot among them); the
# serving program reads Q_m in place of B and beta. A plan builds Q once per
# state (``PICServePlan._rebuild_caches``, again on ``rebind``); the free
# functions below build it per call.
# ---------------------------------------------------------------------------

class BlockFields(NamedTuple):
    """What the per-block program reads of each block (leading axis: the
    blocks of a layout); an overflow group gathers its owner block's."""
    Xb: torch.Tensor       # (K, b, d)
    Ksd: torch.Tensor      # (K, s, b)
    C_L: torch.Tensor      # (K, b, b)
    Wy: torch.Tensor       # (K, b)
    Q: torch.Tensor        # (K, s, b) L^{-1} K_{S,D_m}


class PICCaches(NamedTuple):
    """A plan's per-state serving caches (``ServePlan.caches``)."""
    Q: torch.Tensor               # (M, s, b) L^{-1} K_{S,D_m}
    Cinv: torch.Tensor | None     # (M, b, b) C⁻¹ with ``cached_cinv``


def whitened_ksd(state: api.PICState) -> torch.Tensor:
    """(M, s, b) Q_m = L^{-1} K_{S,D_m}, L = chol K_SS: the blocks' whitened
    cross-covariances."""
    return linalg.tri_solve(state.Kss_L, state.Ksd)


def _block_fields(state: api.PICState, Q=None) -> BlockFields:
    return BlockFields(state.Xb, state.Ksd, state.C_L, state.Wy,
                       whitened_ksd(state) if Q is None else Q)


def _residual(kfn, params, state: api.PICState, Um, f: BlockFields):
    """K_US, A = K_US L^{-T} and R = K_{U,D_m} - A Q_m for query blocks Um
    (K, u, d), queries on rows."""
    Kus = kfn(params, Um, state.S)
    Kud = kfn(params, Um, f.Xb)
    A = _rows(linalg.tri_solve_right, state.Kss_L, Kus)
    return Kus, A, Kud - A @ f.Q


def _block_posterior(kfn, params, state: api.PICState, Um,
                     f: BlockFields):
    """Eqs. (12)-(14) for query blocks Um (K, u, d) from cached factors, in
    the whitened form above; ``f`` holds the K blocks' fields."""
    Kus, A, R = _residual(kfn, params, state, Um, f)
    W = linalg.chol_solve_right(f.C_L, R)              # R C^{-1}
    Phi = Kus - W @ f.Ksd.mT                           # eq. (14)
    mean = _rowdot(Phi, state.alpha) + _rowdot(R, f.Wy)  # eq. (12)
    Kuu = kfn(params, Um, Um)
    covm = Kuu - A @ A.mT - W @ R.mT \
        + Phi @ linalg.chol_solve(state.Sdd_L, Phi.mT)  # eq. (13)
    return mean, covm


def _diag_terms(kfn, params, state: api.PICState, Um, f: BlockFields, Kus,
                A, R, W):
    """Mean and variance of eqs. (12)-(13) from the block solve W = R C⁻¹
    (shared by the trsm and the cached-C⁻¹ programs)."""
    Phi = Kus - W @ f.Ksd.mT                           # (K, u, s)
    mean = _rowdot(Phi, state.alpha) + _rowdot(R, f.Wy)
    var = (_kdiag(kfn, params, Um)
           - torch.sum(A * A, -1)
           - torch.sum(R * W, -1)
           + torch.sum(Phi * _solve_rows(state.Sdd_L, Phi), -1))
    return mean, var


def _block_posterior_diag(kfn, params, state: api.PICState, Um,
                          f: BlockFields):
    """Diagonal of eqs. (12)-(13) for query blocks Um (K, u, d), no
    |U_m|^2 buffers.

    Every contraction keeps the query axis on matrix ROWS (row-wise
    multiply-reduce instead of gemv, right-sided solves instead of a
    left-sided solve on Kᵀ, row-major products), as the reference does: a
    query-column form lets the library's choice of panels depend on a row's
    slot and on the buffer width, which would break routed permutation
    invariance and the two-bucket layout's equality with the capacity-|U|
    layout.
    """
    Kus, A, R = _residual(kfn, params, state, Um, f)
    W = linalg.chol_solve_right(f.C_L, R)              # R C^{-1}
    return _diag_terms(kfn, params, state, Um, f, Kus, A, R, W)


def _block_posterior_diag_cinv(kfn, params, state: api.PICState, Um,
                               f: BlockFields, Cinv_m):
    """``_block_posterior_diag`` with the per-block solve served from a
    precomputed dense inverse: R C⁻¹ is one batched matmul instead of the
    two-sided batched triangular solve. The plan-owned cache of
    ``ServeSpec(cached_cinv=True)``; a different float path than the trsm
    (same math), hence opt-in."""
    Kus, A, R = _residual(kfn, params, state, Um, f)
    return _diag_terms(kfn, params, state, Um, f, Kus, A, R, R @ Cinv_m)


def predict_blocks(kfn, params, state: api.PICState,
                   U) -> ParallelPosterior:
    """Block-layout posterior from cached state (|U| must divide M;
    queries are assigned to blocks in order)."""
    M = state.Xb.shape[0]
    u = U.shape[0]
    if u % M != 0:
        raise ValueError(
            f"|U|={u} must divide M={M} for the block layout; use "
            f"predict_batch/predict_batch_diag for arbitrary batch sizes")
    means, covs = _block_posterior(
        kfn, params, state, U.reshape((M, u // M) + tuple(U.shape[1:])),
        _block_fields(state))
    return ParallelPosterior(means.reshape(-1), covs)


def predict_batch(kfn, params, state: api.PICState, U) -> GPPosterior:
    """Blockwise posterior from cached state for any |U|: pads the query
    batch to the block layout, assembles the dense block-diagonal
    covariance, and trims."""
    M = state.Xb.shape[0]
    u = U.shape[0]
    Ub, _ = pad_blocks(U, M)
    means, covs = _block_posterior(kfn, params, state, Ub,
                                   _block_fields(state))
    post = ParallelPosterior(means.reshape(-1), covs)
    return GPPosterior(post.mean[:u], post.cov[:u, :u])


def predict_batch_diag(kfn, params, state: api.PICState, U):
    """(mean, var) for any |U|: pads to the block layout, trims after."""
    M = state.Xb.shape[0]
    u = U.shape[0]
    Ub, _ = pad_blocks(U, M)
    means, vars_ = _block_posterior_diag(kfn, params, state, Ub,
                                         _block_fields(state))
    return means.reshape(-1)[:u], vars_.reshape(-1)[:u]


# ---------------------------------------------------------------------------
# Routed prediction (Remark 2 at serving time): nearest-centroid assignment.
# ---------------------------------------------------------------------------

def route_queries(state: api.PICState, U) -> torch.Tensor:
    """(u,) block id per query: nearest fit-time block centroid — a pure
    function of (query point, state)."""
    d2 = torch.sum((U[:, None, :] - state.centroids[None, :, :]) ** 2,
                   dim=-1)
    return torch.argmin(d2, dim=1)


def cinv_blocks(C_L: torch.Tensor) -> torch.Tensor:
    """(M, b, b) dense symmetric inverses ``(C_L C_Lᵀ)⁻¹`` per block — the
    one-time plan-build cost behind ``ServeSpec(cached_cinv=True)``."""
    eye = torch.eye(C_L.shape[-1], dtype=C_L.dtype, device=C_L.device)
    return linalg.chol_solve(C_L, eye.expand(C_L.shape))


def _routed_diag_program(kfn, params, state: api.PICState,
                         caches: PICCaches | None, U, assign=None, *,
                         alpha: int, tile: int, n_groups: int | None):
    """The routed serving program: two-bucket scatter -> per-block
    posterior -> gather, for one overflow-group count, from a plan's
    ``caches`` (Q, and C⁻¹ or None) or, with None, from Q built here.
    ``predict_routed_diag`` is this program at its
    worst-case defaults (assignment derived on the device);
    ``PICServePlan`` runs one per selected group count and passes its host
    assignment in — the SAME assignment that sized the group count, so the
    scatter never sees a row the selection did not provision for (a device
    re-derivation could flip a near-boundary argmin and drop the row)."""
    M = state.Xb.shape[0]
    if assign is None:
        assign = route_queries(state, U)
    lay = scatter_two_bucket(U, assign, M, alpha=alpha, tile=tile,
                             max_groups=n_groups)

    def run(Ub, fields, Ci):
        if Ci is None:
            return _block_posterior_diag(kfn, params, state, Ub, fields)
        return _block_posterior_diag_cinv(kfn, params, state, Ub, fields,
                                          Ci)

    fields = _block_fields(state, None if caches is None else caches.Q)
    Cinv = None if caches is None else caches.Cinv
    means, vars_ = run(lay.Xb, fields, Cinv)
    means_o = vars_o = None
    if lay.Xo is not None:
        # overflow groups: the owning block's cached factors per group
        mf_o = BlockFields(*(a[lay.o_blk] for a in fields))
        means_o, vars_o = run(lay.Xo, mf_o,
                              None if Cinv is None else Cinv[lay.o_blk])
    return (gather_two_bucket(means, means_o, lay),
            gather_two_bucket(vars_, vars_o, lay))


def global_diag(kfn, params, state: api.PICState, U):
    """The pPITC (eqs. 7-8) diag posterior from a PIC state's GLOBAL
    factors only — no per-block cache touched.

    ``PICState``'s first four fields ARE a ``PITCState``, so a query whose
    nearest block is unavailable is still answered, from the global
    posterior (PIC minus its local correction): the bounded-degradation
    serving path. On the card it is the fused ``xcov_diag`` kernel."""
    from repro_torch.core import ppitc
    gstate = api.PITCState(state.S, state.Kss_L, state.Sdd_L, state.alpha)
    return ppitc.predict_batch_diag(kfn, params, gstate, U)


def _routed_deg_program(kfn, params, state: api.PICState,
                        caches: PICCaches | None, U, assign, dead_row, *,
                        alpha: int, tile: int, n_groups: int | None):
    """``_routed_diag_program`` with per-row bounded degradation: rows whose
    target block is dead (``dead_row``, a (|U|,) bool tensor) are answered
    from the global S-space posterior by a per-row select, which also keeps
    NaN/Inf from a poisoned block's factors out of the output
    (``torch.where`` never propagates the unselected branch)."""
    mean_r, var_r = _routed_diag_program(kfn, params, state, caches, U,
                                         assign, alpha=alpha, tile=tile,
                                         n_groups=n_groups)
    mean_g, var_g = global_diag(kfn, params, state, U)
    return (torch.where(dead_row, mean_g, mean_r),
            torch.where(dead_row, var_g, var_r))


def predict_routed_diag(kfn, params, state: api.PICState, U, *,
                        alpha: int = ROUTED_ALPHA, tile: int | None = None):
    """Batch-composition-invariant (mean, var) for any |U|, through the
    two-bucket layout at its worst-case group count: shapes depend only on
    (|U|, M), and balanced traffic computes ~(alpha+1)*|U| rows instead of
    the capacity-|U| layout's M*|U|, with the same per-row posteriors.
    ``tile`` aligns the bucket width to the serving tile (a KernelSpec's
    ``block_q``; 1 for bare kernel functions)."""
    if tile is None:
        tile = getattr(kfn, "block_q", None) or 1
    return _routed_diag_program(kfn, params, state, None, U, None,
                                alpha=alpha, tile=tile, n_groups=None)


def predict_routed_diag_capacity(kfn, params, state: api.PICState, U):
    """Capacity-|U| routed reference (the pre-two-bucket layout): every block
    gets a (|U|,)-slot buffer via ``scatter_by_block``; the yardstick the
    two-bucket path is held to."""
    M = state.Xb.shape[0]
    assign = route_queries(state, U)
    Ub, order, block_of, slot = scatter_by_block(U, assign, M)
    means, vars_ = _block_posterior_diag(kfn, params, state, Ub,
                                         _block_fields(state))
    return (gather_by_block(means, order, block_of, slot),
            gather_by_block(vars_, order, block_of, slot))


def predict_routed(kfn, params, state: api.PICState, U) -> GPPosterior:
    """Routed posterior with the dense within-block covariance view:
    covariance entries are filled for query pairs routed to the same block
    (eqs. 12-14) and zero across blocks."""
    M = state.Xb.shape[0]
    assign = route_queries(state, U)
    Ub, order, block_of, slot = scatter_by_block(U, assign, M)
    means, covs = _block_posterior(kfn, params, state, Ub,
                                   _block_fields(state))
    mean = gather_by_block(means, order, block_of, slot)
    slot_q = torch.zeros_like(slot)
    slot_q[order] = slot                               # slot in caller order
    same = assign[:, None] == assign[None, :]
    covm = torch.where(same,
                       covs[assign[:, None], slot_q[:, None], slot_q[None, :]],
                       torch.zeros((), dtype=covs.dtype, device=covs.device))
    return GPPosterior(mean, covm)


def predict(kfn, params, S, X, y, U, runner: Runner) -> ParallelPosterior:
    """End-to-end pPIC: fit + predict_blocks. For best accuracy X/U should
    be co-clustered first (core/clustering.py — Remark 2 after Def. 5)."""
    state = fit(kfn, params, X, y, S=S, runner=runner)
    return predict_blocks(kfn, params, state, U)


# ---------------------------------------------------------------------------
# PICServePlan — the PIC family's serving plan (api.GPMethod.plan).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PICServePlan(api.ServePlan):
    """``api.ServePlan`` with the PIC-specific assets:

    * backend caches — ``caches`` (``PICCaches``) holds the blocks'
      whitened cross-covariances Q and, when the spec asks for it
      (``cached_cinv=True``), the per-block dense ``C⁻¹``; both are built
      once per state and rebuilt on ``rebind``;
    * a routed program LADDER — one program per overflow-group count
      g ∈ {0, 1, 2, 4, ..., G_worst}, selected per request from the host
      occupancy: balanced traffic runs the G=0 program (main bucket only),
      mild skew a 1-2 group program, adversarial skew the worst case. The
      selection is exact (counts), never under-provisioned;
    * bounded degradation — ``routed_diag(U, block_alive)`` answers rows
      whose block is dead from the global posterior.

    Routing is on the host: each request syncs once, to read its staged
    batch (the reference's design); the centroids are read once per state.
    """

    def _rebuild_caches(self, state):
        return PICCaches(whitened_ksd(state),
                         cinv_blocks(state.C_L) if self.spec.cached_cinv
                         else None)

    @functools.cached_property
    def _centroids_host(self) -> np.ndarray:
        """The state's routing targets on the host, read once per plan (a
        rebind makes a new plan, so they follow the state)."""
        return self.state.centroids.cpu().numpy()

    def _routed_exec(self, g: int):
        kfn, alpha, tile = self.kfn, self.spec.alpha, self.block_q
        return self._program(
            ("routed", g), lambda: lambda params, state, caches, U, assign:
                _routed_diag_program(kfn, params, state, caches, U, assign,
                                     alpha=alpha, tile=tile, n_groups=g))

    def _routed_deg_exec(self, g: int):
        """The degraded sibling of ``_routed_exec``: the same program plus
        the per-row global-posterior select (``_routed_deg_program``)."""
        kfn, alpha, tile = self.kfn, self.spec.alpha, self.block_q
        return self._program(
            ("routed_deg", g),
            lambda: lambda params, state, caches, U, assign, dead:
                _routed_deg_program(kfn, params, state, caches, U, assign,
                                    dead, alpha=alpha, tile=tile,
                                    n_groups=g))

    def routed_diag(self, U, block_alive=None):
        """Batch-composition-invariant (mean, var): pad to the bucket
        ladder, route on the host, pick the overflow program from the
        occupancy, dispatch.

        The host's nearest-centroid assignment of the STAGED padded batch
        is authoritative for both the group-count selection and the device
        scatter (it is passed into the program): one float path.

        Pad rows are not routed by centroid: they are packed into blocks
        with spare main-bucket capacity, after the real rows, so a partial
        batch padded to a large bucket still runs G=0 on balanced traffic.

        ``block_alive`` (optional (M,) bool) marks dead blocks: their rows
        are answered from the global S-space posterior (``global_diag``)
        through the degraded program; ``stats.last_degraded`` says which
        (None on fully-healthy requests, which run the baseline program)."""
        Up, u = self._padded(U)
        assign, g = self._route(Up.cpu().numpy(), u)
        dev = Up.device
        assign_t = torch.as_tensor(assign).to(dev)
        self.stats.last_degraded = None
        dead = None
        if block_alive is not None:
            alive = np.asarray(block_alive, bool)
            M = self._centroids_host.shape[0]
            if alive.shape != (M,):
                raise ValueError(
                    f"block_alive must be an ({M},) bool mask over the "
                    f"state's blocks; got shape {alive.shape}")
            dead = ~alive[assign]
        if dead is not None and dead.any():
            mean, var = self._routed_deg_exec(g)(
                self.params, self.state, self.caches, Up, assign_t,
                torch.as_tensor(dead).to(dev))
            self.stats.last_degraded = dead[:u].copy()
            self.stats.n_degraded_rows += int(dead[:u].sum())
        else:
            mean, var = self._routed_exec(g)(self.params, self.state,
                                             self.caches, Up, assign_t)
        self.stats.n_routed_batches += 1
        self.stats.last_g = g
        if g == 0:
            self.stats.n_g0_batches += 1
        return mean[:u], var[:u]

    def _route(self, Up: np.ndarray, u: int) -> tuple[np.ndarray, int]:
        """(assign, g) for a staged padded batch whose first ``u`` rows are
        real — the one host-side routing decision behind ``routed_diag``."""
        centroids = self._centroids_host
        M = centroids.shape[0]
        assign = clustering.nearest_center_np(Up[:u], centroids).astype(
            np.int64)
        counts = np.bincount(assign, minlength=M)
        cap, G_full = routed_capacity(Up.shape[0], M, alpha=self.spec.alpha,
                                      tile=self.block_q)
        pad = Up.shape[0] - u
        if pad:
            spare = (cap - np.minimum(counts, cap)).astype(np.int64)
            pad_assign = np.repeat(np.arange(M, dtype=np.int64), spare)[:pad]
            if pad_assign.shape[0] != pad:     # M*cap >= bucket invariant
                raise RuntimeError(
                    f"{pad} pad rows but {pad_assign.shape[0]} spare slots")
            assign = np.concatenate([assign, pad_assign])
        g = 0
        if G_full:
            over = np.maximum(counts - cap, 0)
            g = _snap_groups(int(np.sum(-(-over // cap))), G_full,
                             self.spec.max_overflow_groups)
        return assign, g

    def warmup(self, d: int, *, dtype=torch.float32,
               degraded: bool = True) -> "PICServePlan":
        """Run the FULL routed program ladder per bucket — every (bucket, g)
        program a request can select, and with ``degraded`` each one's
        degraded sibling — so kernel builds, library handles and first
        launches are paid before traffic."""
        if not self.spec.routed:
            return super().warmup(d, dtype=dtype)
        dev = self.state.centroids.device
        M = self.state.Xb.shape[0]
        for b in self.buckets or ():
            U0 = torch.zeros((b, d), dtype=dtype, device=dev)
            _, G = routed_capacity(b, M, alpha=self.spec.alpha,
                                   tile=self.block_q)
            gs, g = {0, G}, 1
            while g < G:                      # the _snap_groups ladder
                gs.add(g)
                g *= 2
            if self.spec.max_overflow_groups is not None:
                gs = {g for g in gs
                      if g <= self.spec.max_overflow_groups} | {G}
            a0 = torch.zeros((b,), dtype=torch.long, device=dev)
            d0 = torch.zeros((b,), dtype=torch.bool, device=dev)
            for g in sorted(gs):
                self._routed_exec(g)(self.params, self.state, self.caches,
                                     U0, a0)
                if degraded:
                    self._routed_deg_exec(g)(self.params, self.state,
                                             self.caches, U0, a0, d0)
        if self.buckets and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return self


def _snap_groups(needed: int, G_full: int, max_groups: int | None) -> int:
    """Snap an exact group demand onto the program ladder {0, 1, 2, 4,
    ...}: a bounded program count without ever serving a program too small
    for the request. Demands above ``max_groups`` fall back to the
    always-sufficient worst-case program."""
    if needed <= 0:
        return 0
    g = 1
    while g < needed:
        g *= 2
    if max_groups is not None and g > max_groups:
        return G_full
    return min(g, G_full)


def make_plan(method: api.GPMethod, kfn, params, state: api.PICState,
              spec: api.ServeSpec) -> PICServePlan:
    """``GPMethod.plan_fn`` for ppic/pic."""
    plan = PICServePlan(method, spec.resolve_kfn(kfn), params, state, spec,
                        spec.resolve_block_q(kfn), spec.resolve_buckets(kfn))
    return dataclasses.replace(plan, caches=plan._rebuild_caches(state))


def init_store(kfn, params, X, y, *, S, runner: Runner):
    """``api.StateStore`` entry point (``online.PICStore``): streamed and
    retired blocks keep emitting routed-servable PICStates with fresh
    centroids."""
    from repro_torch.core import online
    return online.init_pic_store(kfn, params, X, y, S=S, runner=runner)


def predict_distributed(kfn, params, S, X, y, U,
                        runner: Runner) -> ParallelPosterior:
    """Fully-collective pPIC (the psum inside each machine's program). U's
    length must divide among the machines. Every process returns the whole
    posterior (the blocks gathered in machine order), as the
    ``VmapRunner`` does."""
    Xb, yb, Ub = (runner.shard_blocks(a) for a in (X, y, U))
    fn = lambda Xm, ym, Um, params, S: machine_step(
        kfn, params, S, Xm, ym, Um, axis_name=runner.axis)
    means, covs = runner.gather(runner.map(fn, (Xb, yb, Ub), (params, S)))
    return ParallelPosterior(runner.unshard(means), covs)


api.register(api.GPMethod("ppic", fit, predict_fn=predict_batch,
                          predict_diag_fn=predict_batch_diag,
                          predict_routed_diag_fn=predict_routed_diag,
                          init_store=init_store, plan_fn=make_plan))
