"""Summary store of the pPITC and pPIC fits (Sec. 5.2 algebra) — port of
the fit half of ``repro.core.online``.

The pPITC global summary (eqs. 5-6) is an algebraic SUM of per-machine local
summaries. ``SummaryStore`` holds the stacked summaries, the low-rank factors
F_m (Σ-dot^m = F_m F_mᵀ) and the cached global factors; ``ppitc.fit`` is
``to_state(build(...))``, as in the reference. ``PICStore`` adds pPIC's
per-block caches (eqs. 12-14); ``ppic.fit`` is ``init_pic_store(...)
.to_state()``. The streaming half (assimilate, retire, revive and the
``PITCStore``) needs the rank-b Cholesky updates and comes with them
(ROADMAP §1 item 6).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import api, clustering, linalg
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

    and the factor is ``linalg.chol_from_root``'s (Rᵀ of A's QR): the
    batched form of the reference's own rank-b fold-in
    (``linalg.chol_update_rank`` over every machine). Why not form Sdd: at
    the paper's scale (|D| = 32000, M = 20, |S| = 2048) its eigenvalues span
    about 1e-3 to 2e6, and the float32 sum and Cholesky break down (NaN);
    A's condition number is the square root of Sdd's.
    """
    return linalg.chol_from_root(Kss_L, F)


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


class PICBlocks(NamedTuple):
    """Per-block caches for the pPIC local correction (eqs. 12-14); the
    global algebra lives in the shared SummaryStore. Leading axis M."""
    Xb: torch.Tensor      # (M, b, d)
    yb: torch.Tensor      # (M, b)
    Ksd: torch.Tensor     # (M, s, b)
    C_L: torch.Tensor     # (M, b, b)
    Wy: torch.Tensor      # (M, b)
    beta: torch.Tensor    # (M, s)
    B: torch.Tensor       # (M, s, s)


def _summarize_pic(kfn, params, S, X, y, runner: Runner):
    """Per-machine summaries + the eqs. (12)-(14) caches, one map."""
    Xb, yb = runner.shard_blocks(X), runner.shard_blocks(y)

    def fn(Xm, ym, params, S):
        Kss_L = linalg.chol(kfn(params, S, S))
        loc, (Ksd, C_L, Wy) = local_summary(kfn, params, S, Kss_L, Xm, ym)
        F = linalg.tri_solve(C_L, Ksd.mT).mT
        beta = linalg.chol_solve(Kss_L, loc.ydot[..., None])[..., 0]
        B = linalg.chol_solve(Kss_L, loc.Sdot)
        return loc, F, Ksd, C_L, Wy, beta, B

    loc, F, Ksd, C_L, Wy, beta, B = runner.map(fn, (Xb, yb), (params, S))
    return loc, F, PICBlocks(Xb, yb, Ksd, C_L, Wy, beta, B)


_STREAMING = ("the pPIC store's {} needs the rank-b Cholesky updates, "
              "which are not yet ported to repro_torch (ROADMAP §1 item 6: "
              "streaming stores)")


@dataclasses.dataclass(frozen=True)
class PICStore:
    """pPIC's store: the PITC global algebra + per-block local caches;
    ``to_state`` emits an ``api.PICState`` over the ALIVE blocks with
    refreshed centroids (routing targets are exactly the blocks that can
    serve a local correction). ``assimilate``/``retire``/``revive`` wait for
    the rank-b updates (ROADMAP §1 item 6) and raise."""
    kfn: object
    params: dict
    S: torch.Tensor
    runner: Runner
    store: SummaryStore
    blocks: PICBlocks

    @property
    def block_size(self) -> int:
        return int(self.blocks.Xb.shape[1])

    def assimilate(self, X_new, y_new, runner: Runner | None = None):
        raise NotImplementedError(_STREAMING.format("assimilate"))

    def retire(self, machine: int):
        raise NotImplementedError(_STREAMING.format("retire"))

    def revive(self, machine: int):
        raise NotImplementedError(_STREAMING.format("revive"))

    def to_state(self) -> api.PICState:
        st = self.store
        glob = to_state(st, self.S)      # shared O(|S|²) global-factor path
        if bool(st.alive.all()):
            # common case: no gather, every block cache passed by reference
            blk, loc = self.blocks, st.locals_
        else:
            idx = torch.nonzero(st.alive).flatten()
            blk = PICBlocks(*(a[idx] for a in self.blocks))
            loc = LocalSummary(st.locals_.ydot[idx], st.locals_.Sdot[idx])
        return api.PICState(
            self.S, glob.Kss_L, glob.Sdd_L, glob.alpha, blk.Xb, blk.yb,
            blk.Ksd, blk.C_L, blk.Wy, loc.ydot, blk.beta, blk.B, loc.Sdot,
            clustering.block_centroids(blk.Xb))


def init_pic_store(kfn, params, X, y, *, S, runner: Runner) -> PICStore:
    """The pPIC store of a cold fit; its Sdd factor is the QR of the
    stacked square root (``_cold_store``), as pPITC's."""
    loc, F, blocks = _summarize_pic(kfn, params, S, X, y, runner)
    return PICStore(kfn, params, S, runner,
                    _cold_store(kfn, params, S, loc, F), blocks)
