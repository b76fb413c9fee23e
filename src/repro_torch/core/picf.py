"""pICF-based GP — parallel incomplete Cholesky factorization GP (paper
Sec. 4, eqs. 19-27); port of ``repro.core.picf``.

Step 2 is the row-based parallel ICF (Chang et al. 2007). Its collective
form is ``icf_factor_local``: each step all-gathers the machines' largest
residuals, the first machine with the global largest owns the pivot, and
the owner broadcasts the pivot's input and factor column as a masked psum
(the owner contributes, the others zeros); every machine then updates its
own columns, the pivot's kernel column K[p, D_m] from one covariance
launch. O(d + R) a step on the wire, O(R(d + R)) in all (Table 1).
``factor`` runs it over a ``ShardMapRunner``'s machine axis. When one process holds every machine, the same factor
is one ICF over all the training inputs: the per-step pivot (the first
machine with the largest local residual, that machine's first index of
it) is ``argmax`` over the machines' blocks in order, so the centralized
factor cut into the machines' column blocks is the distributed one, pivot
for pivot (Theorem 3); for the SE spec on the card that is one launch of
the ICF kernel (``kernels/rbf/csrc/rbf_icf.cu``), which cannot run a
collective inside its loop.

Steps 3-6 (eqs. 19-27) need one sum over machines of (R, R+1+u')
quantities and an R x R solve. ``fit`` caches the rank-R factor F and the
R-space solves Phi_L / ydd (eqs. 21-22) in an ``api.PICFState``;
``predict_batch``/``predict_batch_diag`` recompute only the
query-dependent Sigma-dot (eq. 20) and the predictive combine (eqs.
24-27), with K_{U,D_m} for all machines from one covariance launch.

The formulas are the reference's. At low rank they are unstable: the
predictive variance K_UU - K_UD K_DU / s2 + Sdot^T Phi^{-1} Sdot / s2^2
subtracts terms of size |D| from one another, with the exact K_UD against
a rank-R factor, so variances go negative as |D| grows at a fixed R, in
float64 as in float32 (ROADMAP §3). The port reproduces that.

``PICFStore`` streams as the reference's: a new block's factor columns are
the Nyström extension in the frozen pivot basis and Phi_L takes a rank
update; retiring a machine downdates Phi_L by its columns (the
``chol_downdate`` kernel on the card).

The R-space algebra (Phi_L, yF, ydd and the sums and solves of eqs. 20-27
that meet them) runs in float64 whatever the data's dtype; the factor F,
the data and the covariance K_{U,D_m} keep theirs, and the outputs take
the queries'. The variance adds Sdotᵀ Phi⁻¹ Sdot / s2² to terms of size
|D| / s2, so near zero its sign rests on digits float32 does not hold: at
AIMPEAK (cond Phi 2.3e4), streamed in two waves and with one machine
retired, the reference's float32 R-space put 0.73 of the test variances
below zero against float64's 0.19, and the float64 R-space with float32
data 0.18 (``chip_smoke.py`` phase 4d on an H100; ROADMAP §3). A state
whose Phi_L is float32 (one converted from the reference) is served in
float32, as the reference serves it.

The collective prediction layouts, batched over the L machines a process
holds, with ``axis_name`` the runner's machine axis:

* ``machine_step`` — steps 3-6 with U replicated (Defs. 8-9): one fused
  psum of [Phi_m | ydot_m | Sdot_m], R(R + 1 + |U|) values, then the
  predictive components psummed;
* ``machine_step_sharded_u`` — U sharded (the Remark after Def. 7): one
  (R, R + 1) psum, and Sdot's chunks and the predictive components
  reduce-scattered, R(R + 1) + R|U|/M values a machine receives.

Their R-space (Phi formed from the psum and factored by Cholesky, as the
reference does, ydd, Sdd) is float64, as above. Zero prior mean assumed.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.core import covariance as cov
from repro_torch.core import icf, linalg
from repro_torch.core.gp import GPPosterior
from repro_torch.core.ppitc import ParallelPosterior
from repro_torch.parallel.runner import Runner


class ICFLocal(NamedTuple):
    """The distributed factor, stacked over the M machines."""
    F: torch.Tensor         # (M, R, b) each machine's factor columns
    residual: torch.Tensor  # (M, b)    local diagonal residual
    pivots: torch.Tensor    # (M, R, d) pivot INPUTS in selection order
    #                         (replicated)
    Lp: torch.Tensor        # (M, R, R) lower factor at the pivots: chol K_PP
    #                         (replicated) — row i is pivot i's factor
    #                         column, which extends the factor to unseen rows


def _pivot_column(kfn, params, xp, Xm) -> torch.Tensor:
    """(L, b) K[p, D_m] for the pivot input xp (1, d) and the machine
    blocks Xm (L, b, d). Where ``icf.uses_kernel`` says the ICF kernel
    factors these inputs, one launch of rbf.cu's exact instance: the ICF
    kernel's column arithmetic in the data's dtype (the plain
    ``rbf_covariance`` sums in float32 for every dtype, and a float64 loop
    on its columns picks other pivots than the kernel once two residuals
    are within float32's reach). Otherwise ``kfn``."""
    if icf.uses_kernel(kfn, Xm.device, Xm.dtype):
        from repro_torch.kernels.rbf import ops as rbf_ops
        return rbf_ops.rbf_covariance_exact(
            cov._scale(params, xp).to(Xm.dtype),
            cov._scale(params, Xm).to(Xm.dtype),
            cov.signal_var(params))[:, 0]
    return kfn(params, xp, Xm)[:, 0]


def icf_factor_local(kfn, params, Xm, R: int, *, axis_name) -> ICFLocal:
    """Distributed pivoted incomplete Cholesky of the signal kernel, for
    this process's machine blocks Xm (L, b, d); ``axis_name`` is the
    runner's machine axis.

    Each step all-gathers the L machines' largest residuals (``argmax``:
    the first of equal ones), takes the first machine with the global
    largest as the owner, and psums the owner's pivot input and factor
    column F[:i, p] with the others' zeros (one message; exact, one nonzero
    term an entry). Every machine then takes its column K[p, D_m] (one
    covariance launch for the L machines, ``_pivot_column``), its new
    factor row and its residual. Concatenating F over machines in machine
    order is the centralized ``icf.icf_factor`` of the concatenated data,
    pivot for pivot: in float64 on the card too, where the column takes the
    ICF kernel's arithmetic. In float32 the kernel sums F[:i, p]'s
    products in another order, so the loop and the kernel part at the
    first near tie; the loop over ranks stays bit for bit the loop on one
    process (each machine's arithmetic is the same wherever it runs). The pivot inputs and the triangle at the pivots (row i = pivot
    i's factor column: F[:i, p] and sqrt(d_p)) are recorded, replicated,
    for the streaming row append (``PICFStore``)."""
    ax = axis_name
    L, b, dim = Xm.shape
    dev = Xm.device
    m_idx = ax.index(dev)
    d = cov.kdiag(kfn, params, Xm.reshape(-1, dim)).reshape(L, b)
    F = torch.zeros((L, R, b), dtype=d.dtype, device=dev)
    Xp = torch.zeros((R, dim), dtype=d.dtype, device=dev)
    Lp = torch.zeros((R, R), dtype=d.dtype, device=dev)
    rows = torch.arange(L, device=dev)
    cols = torch.arange(b, device=dev)
    for i in range(R):
        # global pivot: the first machine whose largest residual is largest
        arg = torch.argmax(d, dim=1)                         # (L,)
        gmax = ax.all_gather(d[rows, arg])                   # (M,)
        owner = torch.argmax(gmax)
        dp = gmax[owner]
        is_owner = (m_idx == owner)[:, None]                 # (L, 1)
        # the owner broadcasts x_p and F[:i, p]: one masked psum
        mine = torch.cat([Xm[rows, arg].to(d.dtype), F[rows, :i, arg]], 1)
        got = ax.psum(torch.where(is_owner, mine, torch.zeros_like(mine)))
        xp, fp = got[:dim], got[dim:]
        rp = torch.sqrt(torch.clamp(dp, min=1e-30))
        Xp[i] = xp
        Lp[i, :i] = fp
        Lp[i, i] = rp
        # each machine's rank-1 update of its own columns, one product a
        # machine: its bits then do not depend on how many machines its
        # process holds (a batched product may sum in another order)
        col = _pivot_column(kfn, params, xp[None].to(Xm.dtype), Xm)
        prod = torch.stack([fp @ F[m, :i] for m in range(L)])
        f = (col.to(d.dtype) - prod) / rp
        F[:, i] = f
        d = torch.clamp(d - f * f, min=0.0)
        d = torch.where(is_owner & (cols == arg[:, None]),
                        torch.zeros_like(d), d)
    return ICFLocal(F, d, Xp.expand(L, R, dim), Lp.expand(L, R, R))


def _global_pieces(params, Fm, ym, Sdot_m, *, axis_name):
    """Steps 3-4 (eqs. 19-23): one fused psum of [Phi_m | ydot_m | Sdot_m]
    over this process's machines Fm (L, R, b), ym (L, b), Sdot_m (L, R, u),
    in the R-space dtype (float64). Returns (ydd (R,), Sdd (R, u))."""
    # pICF's R-space in float64 for any data dtype, on purpose (the module
    # docstring; ROADMAP §3 item 7)
    # analysis: ignore[DTY001]
    rd = torch.promote_types(Fm.dtype, torch.float64)
    s2 = cov.noise_var(params).to(rd)
    Fr = Fm.to(rd)
    R = Fm.shape[-2]
    ydot = (Fr @ ym.to(rd)[..., None])[..., 0]              # (L, R) eq. 19
    Phi_m = Fr @ Fr.mT                                      # (L, R, R) eq. 21
    packed = axis_name.psum(torch.cat(
        [Phi_m, ydot[..., None], Sdot_m.to(rd)], -1))       # (R, R+1+u)
    eye = torch.eye(R, dtype=rd, device=Fm.device)
    Phi_L = linalg.chol(eye + packed[:, :R] / s2, jitter=0.0)
    ydd = linalg.chol_solve(Phi_L, packed[:, R:R + 1])[:, 0]        # eq. 22
    Sdd = linalg.chol_solve(Phi_L, packed[:, R + 1:])               # eq. 23
    return ydd, Sdd


def machine_step(kfn, params, Xm, ym, U, Fm, *, axis_name):
    """Steps 3-6 with U replicated, for this process's machines Xm (L, b,
    d), ym (L, b), Fm (L, R, b); ``axis_name`` is the runner's machine axis.
    Returns the replicated (mean (u,), cov (u, u)) in U's dtype."""
    # pICF's R-space in float64 for any data dtype, on purpose (the module
    # docstring; ROADMAP §3 item 7)
    # analysis: ignore[DTY001]
    rd = torch.promote_types(Fm.dtype, torch.float64)
    s2 = cov.noise_var(params).to(rd)
    Kud = kfn(params, U, Xm).to(rd)                         # (L, u, b)
    Sdot_m = Fm.to(rd) @ Kud.mT                             # (L, R, u) eq. 20
    ydd, Sdd = _global_pieces(params, Fm, ym, Sdot_m, axis_name=axis_name)
    # eqs. (24)-(25): predictive components; (26)-(27): psum-combine
    mu_m = ((Kud @ ym.to(rd)[..., None])[..., 0] / s2
            - (Sdot_m.mT @ ydd) / s2**2)
    Sig_m = Kud @ Kud.mT / s2 - Sdot_m.mT @ Sdd / s2**2
    mean = axis_name.psum(mu_m)
    covm = kfn(params, U, U).to(rd) - axis_name.psum(Sig_m)
    return mean.to(U.dtype), covm.to(U.dtype)


def machine_step_sharded_u(kfn, params, Xm, ym, Ub_all, Fm, *, axis_name):
    """Steps 3-6 with U sharded (Remark after Def. 7), reduce-scatter form,
    for this process's machines Xm (L, b, d), ym (L, b), Fm (L, R, b).

    ``Ub_all``: (M, u/M, d), every machine's chunk of U (inputs only).
    Machine m computes Sigma-dot against all of U, but only chunk-sized
    pieces reach each machine:

      * Phi, ydot — one (R, R+1) psum (the paper's O(R^2 log M));
      * Sdot — ``psum_scatter``: machine i receives S_i = sum_m Sdot_m^(i);
      * the cross terms fold algebraically: sum_m (Sdot_m^i)ᵀ ydd = S_iᵀ
        ydd and sum_m (Sdot_m^i)ᵀ Sdd^i = S_iᵀ Phi⁻¹ S_i.

    Returns this process's (mean (L, u/M), cov (L, u/M, u/M)) in U's
    dtype."""
    ax = axis_name
    # pICF's R-space in float64 for any data dtype, on purpose (the module
    # docstring; ROADMAP §3 item 7)
    # analysis: ignore[DTY001]
    rd = torch.promote_types(Fm.dtype, torch.float64)
    s2 = cov.noise_var(params).to(rd)
    M, bu, dim = Ub_all.shape
    L, R, b = Fm.shape
    U = Ub_all.reshape(M * bu, dim)
    Fr, yr = Fm.to(rd), ym.to(rd)
    Kud = kfn(params, U, Xm).to(rd)                         # (L, u, b)
    Sdot_m = Fr @ Kud.mT                                    # (L, R, u)
    packed = ax.psum(torch.cat(
        [Fr @ Fr.mT, (Fr @ yr[..., None])], -1))            # (R, R+1)
    eye = torch.eye(R, dtype=rd, device=Fm.device)
    Phi_L = linalg.chol(eye + packed[:, :R] / s2, jitter=0.0)
    ydd = linalg.chol_solve(Phi_L, packed[:, R:])[:, 0]     # eq. 22
    # reduce-scatter the Sdot chunks: machine i gets S_i = sum_m Sdot_m^i
    S_i = ax.psum_scatter(
        Sdot_m.reshape(L, R, M, bu).permute(0, 2, 1, 3))    # (L, R, bu)
    Sdd_i = linalg.chol_solve(Phi_L, S_i)                   # eq. 23, chunk i
    Ky = (Kud @ yr[..., None])[..., 0] / s2                 # (L, u)
    mean_chunk = (ax.psum_scatter(Ky.reshape(L, M, bu))
                  - (S_i.mT @ ydd) / s2**2)                 # eqs. 24/26
    Kud_c = Kud.reshape(L, M, bu, b)
    blocks = Kud_c @ Kud_c.mT / s2                          # (L, M, bu, bu)
    Sig_chunk = (ax.psum_scatter(blocks)
                 - S_i.mT @ Sdd_i / s2**2)                  # eqs. 25/27
    Um = Ub_all[ax.index(Ub_all.device)]                    # (L, bu, d)
    covm = kfn(params, Um, Um).to(rd) - Sig_chunk
    return mean_chunk.to(Ub_all.dtype), covm.to(Ub_all.dtype)


def pivot_triangle(F: torch.Tensor, pivots: torch.Tensor,
                   dp: torch.Tensor) -> torch.Tensor:
    """The (R, R) lower factor at the pivots from a finished factorization:
    row i is pivot i's factor column as step i saw it, F[:i, p_i] below the
    diagonal and sqrt(max(d_p, 1e-30)) on it (the reference records
    ``fp.at[i].set(rp)``). F[:i, p_i] is never written after step i, so it
    is read from the final F; the diagonal comes from the pivot values
    themselves, since F[i, p_i] equals sqrt(d_p) only up to rounding, which
    for a small d_p is far from the reference's 1e-10."""
    below = torch.tril(F.index_select(1, pivots).mT, diagonal=-1)
    return below + torch.diag(torch.sqrt(torch.clamp(dp, min=1e-30)))


def factor(kfn, params, X, R: int, runner: Runner) -> ICFLocal:
    """Distributed ICF over a Runner's machines; returns this process's
    stacked (L, R, b) factors. When one process holds every machine (a
    ``VmapRunner``), one ``icf.icf_factor`` over X cut into the machines'
    column blocks (the ICF kernel for the SE spec on the card; see the
    module docstring); over a ``ShardMapRunner``, of any number of ranks,
    ``icf_factor_local`` over the runner's axis."""
    Xb = runner.shard_blocks(X)
    if runner.axis.distributed:
        return runner.map(lambda Xm, params: icf_factor_local(
            kfn, params, Xm, R, axis_name=runner.axis), (Xb,), (params,))
    M = runner.num_machines
    fac, dp = icf.icf_factor(kfn, params, X, R, pivot_values=True)
    n, d = X.shape
    b = n // M
    F = fac.F.reshape(R, M, b).permute(1, 0, 2)
    Xp = X.index_select(0, fac.pivots)
    Lp = pivot_triangle(fac.F, fac.pivots, dp)
    return ICFLocal(F, fac.residual.reshape(M, b), Xp.expand(M, R, d),
                    Lp.expand(M, R, R))


# ---------------------------------------------------------------------------
# fit -> PICFState -> predict_batch (core/api.py architecture)
# ---------------------------------------------------------------------------

def fit(kfn, params, X, y, *, rank: int, runner: Runner) -> api.PICFState:
    """Distributed ICF (the O(R^2 |D|/M) part) + cached R-space solves,
    through the store, as the reference does."""
    return init_picf_store(kfn, params, X, y, rank=rank,
                           runner=runner).to_state()


def _cross(kfn, params, state: api.PICFState, U):
    """Each machine's terms, then their sum over machines, as the
    reference's ``vmap(per_m)`` and ``jnp.sum(., 0)``: K_{U,D_m} for all
    machines from one covariance launch (M, u, b), sum_m K_{U,D_m} y_m
    (u,) and Sdot = sum_m F_m K_{D_m,U} (R, u), eq. (20), all in the
    state's R-space dtype (Phi_L's; see the module docstring). Summing
    within a machine first matters in float32: the variance cancels terms
    of size |D| / s2, and one |D|-term dot product a query loses to
    rounding what M shorter sums keep."""
    rd = state.Phi_L.dtype
    Kud = kfn(params, U, state.Xb).to(rd)                   # (M, u, b)
    Ky = (Kud @ state.yb.to(rd)[..., None])[..., 0].sum(0)
    Sdot = (state.F.to(rd) @ Kud.mT).sum(0)
    return Kud, Ky, Sdot


def _k2(Kud: torch.Tensor) -> torch.Tensor:
    """sum_m |K_{u,D_m}|^2 per query: within each machine, then over
    machines (see ``_cross``)."""
    return (Kud * Kud).sum(-1).sum(0)


def predict_batch(kfn, params, state: api.PICFState, U, *,
                  diag_only: bool = False) -> GPPosterior:
    """Eqs. (20), (23)-(27) from the cached factor — no rank loop per
    query."""
    rd = state.Phi_L.dtype
    s2 = cov.noise_var(params).to(rd)
    Kud, Ky, Sdot = _cross(kfn, params, state, U)
    mean = Ky / s2 - Sdot.T @ state.ydd / s2**2             # eqs. 24/26
    Sdd = linalg.chol_solve(state.Phi_L, Sdot)              # eq. 23
    if diag_only:
        var = (cov.kdiag(kfn, params, U).to(rd) - _k2(Kud) / s2
               + torch.sum(Sdot * Sdd, 0) / s2**2)
        return GPPosterior(mean.to(U.dtype), torch.diag(var.to(U.dtype)))
    Kuu = kfn(params, U, U).to(rd)
    Sig = (Kud @ Kud.mT).sum(0) / s2 - Sdot.T @ Sdd / s2**2  # eqs. 25/27
    return GPPosterior(mean.to(U.dtype), (Kuu - Sig).to(U.dtype))


def predict_batch_diag(kfn, params, state: api.PICFState, U):
    """(mean, var) vectors — no |U|x|U| intermediates (serving hot path)."""
    rd = state.Phi_L.dtype
    s2 = cov.noise_var(params).to(rd)
    Kud, Ky, Sdot = _cross(kfn, params, state, U)
    mean = Ky / s2 - Sdot.T @ state.ydd / s2**2
    Sdd = linalg.chol_solve(state.Phi_L, Sdot)              # eq. 23
    var = (cov.kdiag(kfn, params, U).to(rd) - _k2(Kud) / s2
           + torch.sum(Sdot * Sdd, 0) / s2**2)
    return mean.to(U.dtype), var.to(U.dtype)


def predict(kfn, params, X, y, U, R: int, runner: Runner, *,
            shard_u: bool = False):
    """End-to-end pICF-based GP regression over a Runner.

    The replicated-U layout is fit + predict_batch (a ``GPPosterior``); the
    sharded-U layout stays fully collective (``machine_step_sharded_u``; its
    point is the communication pattern) and returns the block posterior
    (``ParallelPosterior``) gathered in machine order. Every process
    returns the whole posterior."""
    if shard_u:
        Xb, yb = runner.shard_blocks(X), runner.shard_blocks(y)
        local = factor(kfn, params, X, R, runner)
        Ub = runner.block_layout(U)
        fn = lambda Xm, ym, Fm, params, Ub_all: machine_step_sharded_u(
            kfn, params, Xm, ym, Ub_all, Fm, axis_name=runner.axis)
        means, covs = runner.gather(
            runner.map(fn, (Xb, yb, local.F), (params, Ub)))
        return ParallelPosterior(runner.unshard(means), covs)
    state = fit(kfn, params, X, y, rank=R, runner=runner)
    return predict_batch(kfn, params, state, U)


def predict_distributed(kfn, params, X, y, U, R: int,
                        runner: Runner) -> GPPosterior:
    """Fully-collective replicated-U pICF (Defs. 8-9 as written): the
    factor over the runner, then ``machine_step``. Every process returns
    the same posterior."""
    Xb, yb = runner.shard_blocks(X), runner.shard_blocks(y)
    local = factor(kfn, params, X, R, runner)
    fn = lambda Xm, ym, Fm, params, U: machine_step(
        kfn, params, Xm, ym, U, Fm, axis_name=runner.axis)
    return GPPosterior(*runner.map(fn, (Xb, yb, local.F), (params, U)))


# ---------------------------------------------------------------------------
# The store (fit-side producer of the state).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PICFStore:
    """pICF's ``api.StateStore`` over the distributed rank-R factor.

    The fit-time pivot basis is FROZEN: a streamed block's factor columns
    are the Nyström-consistent extension ``F_new = Lp⁻¹ K_{P,D'}`` (the
    forward solve the rank loop performs per pivot, batched over the new
    rows; K_{P,D'} from one covariance launch), so appending b rows costs
    O(R²·b) and the R-space factor takes a rank update of ``Phi_L`` (eq.
    21) — the QR of [Phi_Lᵀ; F_newᵀ/σ], the form the cold fit factors Phi
    with — instead of an O(R³) refactorization. Retiring a machine
    downdates Phi_L by F_m/σ (the summary algebra of eqs. 19/21 is a sum
    over machines, as pPITC's).

    The retired/streamed posterior lives in the ORIGINAL pivot basis; a
    from-scratch refit would re-pivot greedily (the standard streaming
    trade). ``to_state`` emits an ``api.PICFState`` over the alive
    machines.
    """
    kfn: object
    params: dict
    runner: Runner
    Xb: torch.Tensor      # (M, b, d)
    yb: torch.Tensor      # (M, b)
    F: torch.Tensor       # (M, R, b)
    Xp: torch.Tensor      # (R, d) pivot inputs
    Lp: torch.Tensor      # (R, R) pivot triangle (chol K_PP)
    alive: torch.Tensor   # (M,) bool
    Phi_L: torch.Tensor   # (R, R) cached chol(I + Σ_alive F_m F_mᵀ / s2),
    #                       float64 (the R-space dtype)
    yF: torch.Tensor      # (R,)   cached Σ_alive F_m y_m, float64

    @property
    def block_size(self) -> int:
        return int(self.Xb.shape[1])

    def _scaled(self, Fm: torch.Tensor) -> torch.Tensor:
        """Factor columns as Phi update vectors, Phi += (F/σ)(F/σ)ᵀ, in the
        R-space dtype."""
        rd = self.Phi_L.dtype
        return Fm.to(rd) / torch.sqrt(cov.noise_var(self.params).to(rd))

    def _yF(self, Fm: torch.Tensor, ym: torch.Tensor) -> torch.Tensor:
        """Σ_m F_m y_m over the leading axis of (M, R, b) Fm and (M, b)
        ym, in the R-space dtype."""
        rd = self.Phi_L.dtype
        return (Fm.to(rd) @ ym.to(rd)[..., None])[..., 0].sum(0)

    def assimilate(self, X_new, y_new,
                   runner: Runner | None = None) -> "PICFStore":
        runner = runner or self.runner
        M_new = runner.num_machines
        b = X_new.shape[0] // M_new
        if X_new.shape[0] % M_new or b != self.block_size:
            raise ValueError(
                f"pICF streaming keeps the fit-time block size: got "
                f"|D'|={X_new.shape[0]} over M={M_new} machines but the "
                f"store's blocks are b={self.block_size}; re-chunk the wave.")
        dev = self.Xb.device
        Xb_new = runner.block_layout(X_new.to(dev))
        yb_new = runner.block_layout(y_new.to(dev))
        # Nyström extension in the frozen pivot basis, one forward solve
        F_new = linalg.tri_solve(self.Lp,
                                 self.kfn(self.params, self.Xp, Xb_new))
        R = self.Phi_L.shape[0]
        W = self._scaled(F_new).permute(1, 0, 2).reshape(R, -1)
        return dataclasses.replace(
            self,
            Xb=torch.cat([self.Xb, Xb_new]),
            yb=torch.cat([self.yb, yb_new]),
            F=torch.cat([self.F, F_new]),
            alive=torch.cat([self.alive,
                             torch.ones(M_new, dtype=torch.bool,
                                        device=dev)]),
            Phi_L=linalg.chol_update_rank(self.Phi_L, W),
            yF=self.yF + self._yF(F_new, yb_new))

    def _flip(self, machine: int, to: bool) -> "PICFStore":
        api.check_machine_index(self.alive.shape[0], machine)
        if bool(api.concrete_alive_mask(self.alive)[machine]) == to:
            return self
        alive = self.alive.clone()
        alive[machine] = to
        yFm = self._yF(self.F[machine][None], self.yb[machine][None])
        return dataclasses.replace(
            self, alive=alive,
            Phi_L=linalg.chol_update_rank(
                self.Phi_L, self._scaled(self.F[machine]),
                sign=1.0 if to else -1.0),
            yF=self.yF + yFm if to else self.yF - yFm)

    def retire(self, machine: int) -> "PICFStore":
        """Downdate Phi_L by F_m/σ (the ``chol_downdate`` kernel on the
        card); the same store if the machine is already retired."""
        return self._flip(machine, False)

    def revive(self, machine: int) -> "PICFStore":
        """Update Phi_L by F_m/σ (the QR route); the same store if the
        machine is alive."""
        return self._flip(machine, True)

    def to_state(self) -> api.PICFState:
        """The state over the alive machines; its F in the R-space dtype,
        which the serving sums meet (a copy for float32 data, none for
        float64)."""
        ydd = linalg.chol_solve(self.Phi_L, self.yF[:, None])[:, 0]  # eq. 22
        F = self.F.to(self.Phi_L.dtype)
        alive = api.concrete_alive_mask(self.alive)
        if alive.all():
            # the common case: the block tensors passed by reference
            return api.PICFState(self.Xb, self.yb, F, self.Phi_L, ydd)
        idx = torch.as_tensor(np.flatnonzero(alive), device=self.Xb.device)
        return api.PICFState(self.Xb[idx], self.yb[idx], F[idx],
                             self.Phi_L, ydd)


def init_picf_store(kfn, params, X, y, *, rank: int, runner: Runner,
                    local: ICFLocal | None = None) -> PICFStore:
    """The store of a cold fit: the distributed ICF + the R-space factors
    (eqs. 19, 21), factorized once. Over ranks, Phi's root is factored by
    a TSQR and yF psummed, and the machines' blocks are gathered, so every
    process holds the whole store.

    Phi_L = chol(I + Σ_m F_m F_mᵀ / s2), the reference's factor of the
    same matrix, is taken from its square root [I; F_1ᵀ/σ; ...; F_Mᵀ/σ]
    (``linalg.chol_from_root``), not from the formed Phi. At AIMPEAK (|D| =
    32000, R = 2048) cond(Phi) is 2.3e4 and many variances lie near zero;
    with the float32 Cholesky of the formed sum, the share of negative
    ones was 0.14 against float64's 0.34 (``chip_smoke.py`` phase 4c on an
    H100), from the square root 0.36. Both Phi_L and yF are float64 for
    any data dtype (the module docstring says why). ``local``: this
    process's factor, where the caller has it (``factor(kfn, params, X,
    rank, runner)``)."""
    Xb, yb = runner.shard_blocks(X), runner.shard_blocks(y)
    if local is None:
        local = factor(kfn, params, X, rank, runner)        # (L, R, b)
    # the R-space algebra in float64 (the module docstring says why;
    # ROADMAP §3 item 7)
    # analysis: ignore[DTY001]
    rd = torch.promote_types(local.F.dtype, torch.float64)
    Fr, s2 = local.F.to(rd), cov.noise_var(params).to(rd)
    R = local.F.shape[1]
    eye = torch.eye(R, dtype=rd, device=local.F.device)
    ax = runner.axis
    Phi_L = linalg.chol_from_root(eye, Fr / torch.sqrt(s2),
                                  axis=ax)                  # eq. 21
    yF = ax.psum((Fr @ yb.to(rd)[..., None])[..., 0])       # eq. 19
    # every process keeps every machine's blocks (serving is local)
    Xb, yb, F = runner.gather((Xb, yb, local.F))
    alive = torch.ones((runner.num_machines,), dtype=torch.bool,
                       device=local.F.device)
    # pivots/Lp are replicated across machines: take machine 0's copy
    return PICFStore(kfn, params, runner, Xb, yb, F,
                     local.pivots[0], local.Lp[0], alive, Phi_L, yF)


api.register(api.GPMethod("picf", fit, predict_fn=predict_batch,
                          predict_diag_fn=predict_batch_diag,
                          init_store=init_picf_store))
