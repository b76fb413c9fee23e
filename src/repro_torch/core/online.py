"""Summary store of the pPITC fit (Sec. 5.2 algebra) — port of the fit half
of ``repro.core.online``.

The pPITC global summary (eqs. 5-6) is an algebraic SUM of per-machine local
summaries. ``SummaryStore`` holds the stacked summaries, the low-rank factors
F_m (Σ-dot^m = F_m F_mᵀ) and the cached global factors; ``ppitc.fit`` is
``to_state(build(...))``, as in the reference. The streaming half (assimilate,
retire, revive and the ``PITCStore``/``PICStore`` containers) comes with the
rank-update slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import api, linalg
from repro_torch.core.ppitc import GlobalSummary, LocalSummary, local_summary
from repro_torch.parallel.runner import Runner


class SummaryStore(NamedTuple):
    locals_: LocalSummary     # stacked (M, ...) per-machine summaries
    F: torch.Tensor           # (M, s, b) low-rank factors: Sdot_m = F_m F_mᵀ
    alive: torch.Tensor       # (M,) bool — machine participation mask
    Kss: torch.Tensor         # (s, s) prior support covariance
    Kss_L: torch.Tensor       # (s, s) chol K_SS
    Sdd_L: torch.Tensor       # (s, s) chol of the alive Σ-dot-dot
    ydd: torch.Tensor         # (s,)   alive Σ_m y-dot^m


def _sdd_chol(Kss_L: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """chol(Sdd + jitter·I), from Sdd's square root, never forming Sdd.

    The reference anchors Sdd's jitter to K_SS (default_jitter · mean diag
    K_SS, so that cold and incrementally-updated factors factor the same
    matrix) and factorizes the formed Sdd. ``chol(K_SS)`` carries that very
    jitter, so

        Sdd + jitter·I = Kss_L Kss_Lᵀ + Σ_m F_m F_mᵀ = Aᵀ A,
        A = [Kss_Lᵀ; F_1ᵀ; ...; F_Mᵀ]   ((|S| + M b) x |S|),

    and the factor is Rᵀ of A's QR, rows signed so the diagonal is positive:
    the batched form of the reference's own rank-b fold-in
    (``linalg.chol_update_rank`` over every machine). Why not form Sdd: at
    the paper's scale (|D| = 32000, M = 20, |S| = 2048) its eigenvalues span
    about 1e-3 to 2e6, and the float32 sum and Cholesky break down (NaN);
    A's condition number is the square root of Sdd's.
    """
    A = torch.cat([Kss_L.mT, F.mT.reshape(-1, F.shape[-2])])
    R = torch.linalg.qr(A, mode="r").R
    sign = torch.where(torch.diagonal(R) < 0, -1.0, 1.0).to(R.dtype)
    return (R * sign[:, None]).mT


def _summarize(kfn, params, S, X, y, runner: Runner):
    """Per-machine local summaries + low-rank factors (paper Steps 1-2)."""
    Xb, yb = runner.shard_blocks(X), runner.shard_blocks(y)

    def fn(Xm, ym, params, S):
        Kss_L = linalg.chol(kfn(params, S, S))
        loc, (Ksd, C_L, _) = local_summary(kfn, params, S, Kss_L, Xm, ym)
        F = linalg.tri_solve(C_L, Ksd.mT).mT       # (M, s, b): Sdot = F Fᵀ
        return loc, F

    return runner.map(fn, (Xb, yb), (params, S))


def _cold_store(kfn, params, S, locals_: LocalSummary,
                F: torch.Tensor) -> SummaryStore:
    """Assemble a SummaryStore from freshly-summarized blocks: the one place
    the global factor is factorized from scratch (O((|S| + M b) |S|²))."""
    alive = torch.ones(locals_.ydot.shape[0], dtype=torch.bool,
                       device=F.device)
    Kss = kfn(params, S, S)
    Kss_L = linalg.chol(Kss)
    ydd = locals_.ydot.sum(0)
    return SummaryStore(locals_, F, alive, Kss, Kss_L, _sdd_chol(Kss_L, F),
                        ydd)


def build(kfn, params, S, X, y, runner: Runner) -> SummaryStore:
    """Initial store from blocked data (paper Steps 1-3)."""
    locals_, F = _summarize(kfn, params, S, X, y, runner)
    return _cold_store(kfn, params, S, locals_, F)


def global_summary(store: SummaryStore) -> GlobalSummary:
    """Eqs. (5)-(6) from whatever machines are alive — the full
    (non-incremental) reference for the cached ``Sdd_L``/``ydd``."""
    w = store.alive.to(store.locals_.ydot.dtype)
    ydd = torch.einsum("m,ms->s", w, store.locals_.ydot)
    Sdd = store.Kss + torch.einsum("m,mst->st", w, store.locals_.Sdot)
    return GlobalSummary(ydd, Sdd)


def to_state(store: SummaryStore, S: torch.Tensor) -> api.PITCState:
    """The cached prediction factors (eqs. 7-8 precomputation): one
    O(|S|²) weight solve against the store's ``Sdd_L``."""
    alpha = linalg.chol_solve(store.Sdd_L, store.ydd[:, None])[:, 0]
    return api.PITCState(S, store.Kss_L, store.Sdd_L, alpha)
