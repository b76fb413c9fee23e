"""pICF-based GP — parallel incomplete Cholesky factorization GP (paper
Sec. 4, eqs. 19-27); port of ``repro.core.picf``.

Step 2, the row-based parallel ICF, runs on one device as one ICF over all
the training inputs (``factor``): the reference's per-step global pivot is
the first machine with the largest local residual and that machine's first
index of it, which is ``argmax`` over the machines' blocks in order, so the
centralized factor cut into the machines' column blocks is the
distributed one, pivot for pivot (Theorem 3). For the SE spec on the card
that is one launch of the ICF kernel (``kernels/rbf/csrc/rbf_icf.cu``).

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

Not ported yet: the collective programs (``icf_factor_local``,
``machine_step``, ``machine_step_sharded_u``, ``predict_distributed``,
``predict(shard_u=True)``; ROADMAP §1 item 12). Each raises
``NotImplementedError`` naming its item. Zero prior mean assumed.
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


_COLLECTIVE = ("picf.{} is a collective program (psums inside each "
               "machine's step); the collective programs are not yet "
               "ported to repro_torch (ROADMAP §1 item 12: multi-device, "
               "via torch.distributed). On one device, fit + predict_batch "
               "computes the replicated-U posterior")


def icf_factor_local(*args, **kwargs):
    """The per-machine pivot loop with its all-gathers and psums: waits for
    the multi-device slice (ROADMAP §1 item 12) and raises; ``factor`` is
    the same factor on one device."""
    raise NotImplementedError(_COLLECTIVE.format("icf_factor_local"))


def machine_step(*args, **kwargs):
    """Steps 3-6 with replicated U, collective: ROADMAP §1 item 12."""
    raise NotImplementedError(_COLLECTIVE.format("machine_step"))


def machine_step_sharded_u(*args, **kwargs):
    """Steps 3-6 with U sharded, reduce-scatter form: ROADMAP §1 item 12."""
    raise NotImplementedError(_COLLECTIVE.format("machine_step_sharded_u"))


def predict_distributed(*args, **kwargs):
    """Fully-collective replicated-U pICF: ROADMAP §1 item 12."""
    raise NotImplementedError(_COLLECTIVE.format("predict_distributed"))


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
    """Distributed ICF over a Runner's machines; returns the stacked
    (M, R, b) factors. One ``icf.icf_factor`` over X, cut into the
    machines' column blocks (see the module docstring)."""
    runner.shard_blocks(X)                     # the reference's shape check
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
            shard_u: bool = False) -> GPPosterior:
    """End-to-end pICF-based GP regression over a Runner: fit +
    predict_batch (the replicated-U layout). The sharded-U layout is a
    collective program (ROADMAP §1 item 12) and raises."""
    if shard_u:
        raise NotImplementedError(_COLLECTIVE.format("predict(shard_u=True)"))
    state = fit(kfn, params, X, y, rank=R, runner=runner)
    return predict_batch(kfn, params, state, U)


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
        Xb_new = runner.shard_blocks(X_new.to(dev))
        yb_new = runner.shard_blocks(y_new.to(dev))
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


def init_picf_store(kfn, params, X, y, *, rank: int,
                    runner: Runner) -> PICFStore:
    """The store of a cold fit: the distributed ICF + the R-space factors
    (eqs. 19, 21), factorized once.

    Phi_L = chol(I + Σ_m F_m F_mᵀ / s2), the reference's factor of the
    same matrix, is taken from its square root [I; F_1ᵀ/σ; ...; F_Mᵀ/σ]
    (``linalg.chol_from_root``), not from the formed Phi. At AIMPEAK (|D| =
    32000, R = 2048) cond(Phi) is 2.3e4 and many variances lie near zero;
    with the float32 Cholesky of the formed sum, the share of negative
    ones was 0.14 against float64's 0.34 (``chip_smoke.py`` phase 4c on an
    H100), from the square root 0.36. Both Phi_L and yF are float64 for
    any data dtype (the module docstring says why)."""
    Xb, yb = runner.shard_blocks(X), runner.shard_blocks(y)
    local = factor(kfn, params, X, rank, runner)            # (M, R, b)
    # the R-space algebra in float64 (the module docstring says why)
    rd = torch.promote_types(local.F.dtype, torch.float64)
    Fr, s2 = local.F.to(rd), cov.noise_var(params).to(rd)
    R = local.F.shape[1]
    eye = torch.eye(R, dtype=rd, device=local.F.device)
    Phi_L = linalg.chol_from_root(eye, Fr / torch.sqrt(s2))  # eq. 21
    yF = (Fr @ yb.to(rd)[..., None])[..., 0].sum(0)         # eq. 19
    alive = torch.ones((runner.num_machines,), dtype=torch.bool,
                       device=local.F.device)
    # pivots/Lp are replicated across machines: take machine 0's copy
    return PICFStore(kfn, params, runner, Xb, yb, local.F,
                     local.pivots[0], local.Lp[0], alive, Phi_L, yF)


api.register(api.GPMethod("picf", fit, predict_fn=predict_batch,
                          predict_diag_fn=predict_batch_diag,
                          init_store=init_picf_store))
