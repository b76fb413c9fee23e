"""Online/incremental learning (Sec. 5.2) and summary-algebra fault
tolerance — port of ``repro.core.online``.

The pPITC/pPIC global summary (eqs. 5-6) is an algebraic SUM of per-machine
local summaries, so:

* new data blocks fold in with an add (no recompute of old blocks' O(b³)
  factorizations) — the paper's streaming argument;
* a failed machine folds OUT with a subtract — the survivors' work is kept
  and the posterior is the PITC/PIC posterior of the surviving data
  (``runtime/fault.py`` builds on this);
* elastic scale-up/down is re-blocking and re-summing cached summaries.

Two layers here:

* ``SummaryStore`` — the stacked per-machine summaries plus the global
  factors kept up to date. Every local summary Σ-dot^m is PSD with the
  explicit factor F_m = K_SDm chol(Σ_{DmDm|S})⁻ᵀ (Σ-dot^m = F_m F_mᵀ), so
  folding a machine in or out is a rank-b update or downdate of ``Sdd_L``
  (``linalg.chol_update_rank``: an update is the QR of the stacked square
  root, a downdate the CUDA kernel ``chol_downdate`` on the card, run in
  float64 for any store dtype, ``_downdate``), and ``to_state`` is one
  O(|S|²) solve.
* ``PITCStore`` / ``PICStore`` — the methods' ``api.StateStore``s
  (registered through ``GPMethod.init_store`` by core/ppitc.py, ppic.py and
  pitc.py). ``PITCStore`` emits ``api.PITCState``; ``PICStore`` also
  carries the per-block caches of eqs. (12)-(14) and emits ``api.PICState``
  over the alive blocks with their centroids, so routed serving takes
  streamed data too.

Where the port differs from the reference: the cold factor and the refold
of ``with_alive`` come from Sdd's square root (``_sdd_chol``), never from
the formed Sdd, whose float32 Cholesky breaks down at the paper's scale
(ROADMAP §3); a retire downdates in float64 whatever the store's dtype
(``_downdate``); the mutators read the alive mask on the host once a call
(``api.concrete_alive_mask``), since the port has no tracing.

Over a ``ShardMapRunner`` each rank summarizes its own machines; the cold
factor's machine sums go through the runner's axis (ydd a psum, Sdd's
factor a TSQR across ranks), and the per-machine fields are then gathered,
so every rank holds the whole store and its state, and serves on its own.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import api, clustering, linalg
from repro_torch.core.ppitc import (GlobalSummary, LocalSummary,
                                    local_summary, predict_batch)
from repro_torch.parallel.runner import Runner


class SummaryStore(NamedTuple):
    locals_: LocalSummary     # stacked (M, ...) per-machine summaries
    F: torch.Tensor           # (M, s, b) low-rank factors: Sdot_m = F_m F_mᵀ
    alive: torch.Tensor       # (M,) bool — machine participation mask
    Kss: torch.Tensor         # (s, s) prior support covariance
    Kss_L: torch.Tensor       # (s, s) chol K_SS
    Sdd_L: torch.Tensor       # (s, s) chol of the alive Σ-dot-dot, kept up
    #                           to date by rank-b updates
    ydd: torch.Tensor         # (s,)   alive Σ_m y-dot^m


def _sdd_chol(Kss_L: torch.Tensor, F: torch.Tensor,
              axis=None) -> torch.Tensor:
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

    With ``axis`` (a runner's machine axis) and F this process's (L, s, b)
    stack, the QR is a TSQR across ranks (``linalg.chol_from_root``).
    """
    return linalg.chol_from_root(Kss_L, F, axis=axis)


def _summarize(kfn, params, S, X, y, runner: Runner):
    """Per-machine local summaries + low-rank factors (paper Steps 1-2)."""
    Xb, yb = runner.shard_blocks(X), runner.shard_blocks(y)

    def fn(Xm, ym, params, S):
        Kss_L = linalg.chol(kfn(params, S, S))
        loc, (Ksd, C_L, _) = local_summary(kfn, params, S, Kss_L, Xm, ym)
        F = linalg.tri_solve(C_L, Ksd.mT).mT       # (M, s, b): Sdot = F Fᵀ
        return loc, F

    return runner.map(fn, (Xb, yb), (params, S))


def _pad_factor(F: torch.Tensor, b: int) -> torch.Tensor:
    """Zero-pad the block axis of an (M, s, b') factor to width b. Padded
    columns contribute 0·0ᵀ to F Fᵀ (and leave the rank-b updates as they
    are), so waves of different block sizes share one stacked store."""
    if F.shape[-1] >= b:
        return F
    return torch.nn.functional.pad(F, (0, b - F.shape[-1]))


def _cold_store(kfn, params, S, locals_: LocalSummary, F: torch.Tensor,
                runner: Runner) -> SummaryStore:
    """Assemble a SummaryStore from freshly-summarized blocks: the one place
    the global factor is factorized from scratch (O((|S| + M b) |S|²)).

    With the ``runner`` the blocks were summarized over, ``locals_`` and F
    are this process's (L, ...) stacks: ydd is a psum over the machine axis,
    Sdd's factor a TSQR across ranks, and the stacks are then gathered, so
    every process holds the whole store (its later steps run replicated)."""
    Kss = kfn(params, S, S)
    Kss_L = linalg.chol(Kss)
    ax = runner.axis
    ydd, Sdd_L = ax.psum(locals_.ydot), _sdd_chol(Kss_L, F, ax)
    locals_, F = runner.gather((locals_, F))
    alive = torch.ones(locals_.ydot.shape[0], dtype=torch.bool,
                       device=F.device)
    return SummaryStore(locals_, F, alive, Kss, Kss_L, Sdd_L, ydd)


def build(kfn, params, S, X, y, runner: Runner) -> SummaryStore:
    """Initial store from blocked data (paper Steps 1-3)."""
    locals_, F = _summarize(kfn, params, S, X, y, runner)
    return _cold_store(kfn, params, S, locals_, F, runner)


def global_summary(store: SummaryStore) -> GlobalSummary:
    """Eqs. (5)-(6) from whatever machines are alive — the full
    (non-incremental) reference for the cached ``Sdd_L``/``ydd``."""
    w = store.alive.to(store.locals_.ydot.dtype)
    ydd = torch.einsum("m,ms->s", w, store.locals_.ydot)
    Sdd = store.Kss + torch.einsum("m,mst->st", w, store.locals_.Sdot)
    return GlobalSummary(ydd, Sdd)


def to_state(store: SummaryStore, S: torch.Tensor) -> api.PITCState:
    """The cached prediction factors (eqs. 7-8 precomputation): one
    O(|S|²) weight solve against the store's ``Sdd_L``, which assimilate,
    retire and revive keep up to date."""
    alpha = linalg.chol_solve(store.Sdd_L, store.ydd[:, None])[:, 0]
    return api.PITCState(S, store.Kss_L, store.Sdd_L, alpha)


def _fold_in(store: SummaryStore, locals_new: LocalSummary,
             F_new: torch.Tensor) -> SummaryStore:
    """Append new machine blocks and rank-update the cached global
    factors: one update of rank M'·b (the QR of [Sdd_Lᵀ; F_1ᵀ; ...])."""
    b = max(store.F.shape[-1], F_new.shape[-1])
    merged = LocalSummary(
        torch.cat([store.locals_.ydot, locals_new.ydot]),
        torch.cat([store.locals_.Sdot, locals_new.Sdot]))
    F = torch.cat([_pad_factor(store.F, b), _pad_factor(F_new, b)])
    alive = torch.cat([store.alive,
                       torch.ones(F_new.shape[0], dtype=torch.bool,
                                  device=store.alive.device)])
    s = store.Sdd_L.shape[0]
    W = F_new.permute(1, 0, 2).reshape(s, -1)           # (s, M'·b')
    Sdd_L = linalg.chol_update_rank(store.Sdd_L, W)
    ydd = store.ydd + locals_new.ydot.sum(0)
    return SummaryStore(merged, F, alive, store.Kss, store.Kss_L, Sdd_L, ydd)


def assimilate(store: SummaryStore, kfn, params, S, X_new, y_new,
               runner: Runner) -> SummaryStore:
    """Fold a new data stream (D', y_D') in — Sec. 5.2. The new blocks are
    summarized together and appended; old summaries are reused as they
    are, and the global factor takes one rank-(M'·b) update."""
    locals_new, F_new = runner.gather(
        _summarize(kfn, params, S, X_new, y_new, runner))
    return _fold_in(store, locals_new, F_new)


def _set_alive(alive: torch.Tensor, machine: int, value: bool):
    out = alive.clone()
    out[machine] = value
    return out


def _downdate(L: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """L's factor with W Wᵀ taken out (a retire): the rank-b downdate in
    float64 whatever the store's dtype (the ``chol_downdate`` kernel's f64
    instance on the card), rounded back to L's dtype.

    The reference downdates in the store's dtype. In float32 at the
    paper's scale (|D| = 32000, M = 20, |S| = 2048; cond Sdd ~2.4e9) the
    hyperbolic rotations' own rounding lets the served posterior drift ~9x
    further from float64 than a refold's, and two downdates in a row leave
    the limit the cold fit's own float32 error sets (``chip_smoke.py``
    phase 4d on an H100; ROADMAP §3). Run in float64, the downdate of the
    float32 factor adds only the final rounding to it."""
    # float64 whatever the store's dtype, on purpose (above; ROADMAP §3 6)
    # analysis: ignore[DTY001]
    rd = torch.promote_types(L.dtype, torch.float64)
    return linalg.chol_update_rank(L.to(rd), W.to(rd),
                                   sign=-1.0).to(L.dtype)


def retire(store: SummaryStore, machine: int) -> SummaryStore:
    """Drop a machine's contribution (failure or decommission): a rank-b
    downdate of the cached factor by F_m in float64 (``_downdate``; the
    ``chol_downdate`` kernel on the card). The same store if the machine
    is already retired."""
    api.check_machine_index(store.alive.shape[0], machine)
    if not api.concrete_alive_mask(store.alive)[machine]:
        return store
    return store._replace(alive=_set_alive(store.alive, machine, False),
                          Sdd_L=_downdate(store.Sdd_L, store.F[machine]),
                          ydd=store.ydd - store.locals_.ydot[machine])


def revive(store: SummaryStore, machine: int) -> SummaryStore:
    """Fold a retired machine back in: a rank-b update by F_m (the QR
    route). The same store if the machine is alive."""
    api.check_machine_index(store.alive.shape[0], machine)
    if api.concrete_alive_mask(store.alive)[machine]:
        return store
    Sdd_L = linalg.chol_update_rank(store.Sdd_L, store.F[machine])
    return store._replace(alive=_set_alive(store.alive, machine, True),
                          Sdd_L=Sdd_L,
                          ydd=store.ydd + store.locals_.ydot[machine])


def with_alive(store: SummaryStore, alive, *,
               mode: str = "auto") -> SummaryStore:
    """Any alive-mask view (straggler deadlines flip many machines at
    once) — the one sanctioned way to set ``alive`` wholesale (a raw
    ``_replace`` would leave the cached factor stale). Two realizations:

    * ``incremental`` — one retire or revive per FLIPPED machine:
      O(|S|²·b·h) for Hamming distance h, no |S|³ anywhere;
    * ``refold``      — the factor of the alive sum anew, from its square
      root: ``_sdd_chol(Kss_L, F[alive])``, as the cold fit factors it
      (the reference's refold takes the Cholesky of the formed Sdd, which
      fails in float32 at the paper's scale).

    ``mode="auto"`` picks by the Hamming distance of the mask, with the
    reference's crossover: h·b rank-1 sweeps at O(|S|²) each against the
    refold's O(|S|³) — incremental while h·b <= |S|/3 + M. Both factor the
    same matrix; they differ only in rounding. A mask equal to the store's
    returns the same store.
    """
    if mode not in ("auto", "incremental", "refold"):
        raise ValueError(f"unknown with_alive mode {mode!r}")
    alive = torch.as_tensor(alive, dtype=torch.bool,
                            device=store.alive.device)
    if alive.shape != store.alive.shape:
        raise ValueError(f"alive must be a {tuple(store.alive.shape)} "
                         f"mask; got shape {tuple(alive.shape)}")
    new = api.concrete_alive_mask(alive)
    flips = np.flatnonzero(api.concrete_alive_mask(store.alive) != new)
    if mode == "auto":
        s = store.Sdd_L.shape[0]
        b = store.F.shape[-1]
        M = store.alive.shape[0]
        mode = ("incremental" if len(flips) * b <= s // 3 + M
                else "refold")
    if mode == "incremental":
        for m in flips:
            m = int(m)
            store = revive(store, m) if new[m] else retire(store, m)
        return store
    idx = torch.as_tensor(np.flatnonzero(new), device=alive.device)
    ydd = torch.einsum("m,ms->s", alive.to(store.locals_.ydot.dtype),
                       store.locals_.ydot)
    return store._replace(alive=alive,
                          Sdd_L=_sdd_chol(store.Kss_L, store.F[idx]),
                          ydd=ydd)


def replace_block(store: SummaryStore, kfn, params, S, machine: int,
                  Xm, ym) -> SummaryStore:
    """Recompute ONE machine's summary from its (re-read) data shard and
    fold it in alive — the fault-recovery reassign path: at most one
    downdate (if the stale summary was still folded in) plus one update."""
    api.check_machine_index(store.alive.shape[0], machine)
    store = retire(store, machine)
    loc, (Ksd, C_L, _) = local_summary(kfn, params, S, store.Kss_L, Xm, ym)
    F_m = linalg.tri_solve(C_L, Ksd.mT).mT
    b = max(store.F.shape[-1], F_m.shape[-1])
    F_m = _pad_factor(F_m[None], b)[0]
    ydot, Sdot = store.locals_.ydot.clone(), store.locals_.Sdot.clone()
    ydot[machine], Sdot[machine] = loc.ydot, loc.Sdot
    F = _pad_factor(store.F, b).clone()
    F[machine] = F_m
    store = store._replace(locals_=LocalSummary(ydot, Sdot), F=F)
    return revive(store, machine)


def predict_ppitc(store: SummaryStore, kfn, params, S, U) -> tuple:
    """pPITC prediction (eqs. 7-8) straight from the store: ``to_state`` +
    ``ppitc.predict_batch``; returns (mean, cov)."""
    post = predict_batch(kfn, params, to_state(store, S), U)
    return post.mean, post.cov


# ---------------------------------------------------------------------------
# Method-owned StateStore implementations (api.StateStore protocol).
# ---------------------------------------------------------------------------

def _on(device, *tensors):
    return tuple(t.to(device) for t in tensors)


@dataclasses.dataclass(frozen=True)
class PITCStore:
    """pPITC's ``api.StateStore``: owns the fit context, emits PITCState.

    Immutable — every mutation returns a new store sharing the untouched
    tensors (the same store where nothing changes), so serving can keep
    the previous one until a hot-swap commits. A wave is moved to the
    store's device first.
    """
    kfn: object
    params: dict
    S: torch.Tensor
    runner: Runner
    store: SummaryStore

    # -- protocol -----------------------------------------------------------

    def assimilate(self, X_new, y_new, runner: Runner | None = None
                   ) -> "PITCStore":
        """Fold a new stream in. ``runner`` sets how the WAVE is blocked
        (elastic scale-up arrives on however many machines it arrives on);
        the fit-time runner by default."""
        X_new, y_new = _on(self.S.device, X_new, y_new)
        return dataclasses.replace(self, store=assimilate(
            self.store, self.kfn, self.params, self.S, X_new, y_new,
            runner or self.runner))

    def retire(self, machine: int) -> "PITCStore":
        new = retire(self.store, machine)
        return self if new is self.store else \
            dataclasses.replace(self, store=new)

    def revive(self, machine: int) -> "PITCStore":
        new = revive(self.store, machine)
        return self if new is self.store else \
            dataclasses.replace(self, store=new)

    def to_state(self) -> api.PITCState:
        return to_state(self.store, self.S)

    # -- beyond-protocol surface (fault/straggler runtimes) -----------------

    @property
    def alive(self) -> torch.Tensor:
        return self.store.alive

    @property
    def num_machines(self) -> int:
        return int(self.store.alive.shape[0])

    def with_alive(self, alive, *, mode: str = "auto") -> "PITCStore":
        new = with_alive(self.store, alive, mode=mode)
        return self if new is self.store else \
            dataclasses.replace(self, store=new)

    def reassign(self, machine: int, Xm, ym) -> "PITCStore":
        Xm, ym = _on(self.S.device, Xm, ym)
        return dataclasses.replace(self, store=replace_block(
            self.store, self.kfn, self.params, self.S, machine, Xm, ym))

    def global_summary(self) -> GlobalSummary:
        return global_summary(self.store)

    def predict(self, U) -> tuple:
        """(mean, cov) over U from the current alive set."""
        return predict_ppitc(self.store, self.kfn, self.params, self.S, U)


def init_pitc_store(kfn, params, X, y, *, S, runner: Runner) -> PITCStore:
    """``GPMethod.init_store`` for ppitc/pitc (registered in core/ppitc.py
    and core/pitc.py)."""
    return PITCStore(kfn, params, S, runner,
                     build(kfn, params, S, X, y, runner))


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


@dataclasses.dataclass(frozen=True)
class PICStore:
    """pPIC's ``api.StateStore``: the PITC global algebra + per-block local
    caches; ``to_state`` emits an ``api.PICState`` over the ALIVE blocks
    with their centroids, so routed serving takes streamed data (Remark 2
    keeps holding: routing targets are exactly the blocks that can serve a
    local correction).

    Streamed waves must keep the fit-time block size (|D'|/M' == b): the
    block caches are stacked tensors, and zero-padding *data* rows would
    inject spurious noise-only observations into Σ_{DmDm|S} (see
    ``Runner.shard_blocks``). Retiring a machine shrinks the state's block
    axis at the next ``to_state``.
    """
    kfn: object
    params: dict
    S: torch.Tensor
    runner: Runner
    store: SummaryStore
    blocks: PICBlocks

    @property
    def block_size(self) -> int:
        return int(self.blocks.Xb.shape[1])

    def assimilate(self, X_new, y_new, runner: Runner | None = None
                   ) -> "PICStore":
        runner = runner or self.runner
        M_new = runner.num_machines
        b_new = X_new.shape[0] // M_new
        if X_new.shape[0] % M_new or b_new != self.block_size:
            raise ValueError(
                f"pPIC streaming keeps the fit-time block size: got "
                f"|D'|={X_new.shape[0]} over M={M_new} machines "
                f"(b={X_new.shape[0] / M_new:g}) but the store's blocks are "
                f"b={self.block_size}. Re-chunk the wave (or use the pPITC "
                f"store, which accepts any block size).")
        X_new, y_new = _on(self.S.device, X_new, y_new)
        loc, F, blocks_new = runner.gather(_summarize_pic(
            self.kfn, self.params, self.S, X_new, y_new, runner))
        merged = PICBlocks(*(torch.cat([a, b]) for a, b in
                             zip(self.blocks, blocks_new)))
        return dataclasses.replace(
            self, store=_fold_in(self.store, loc, F), blocks=merged)

    def retire(self, machine: int) -> "PICStore":
        new = retire(self.store, machine)
        return self if new is self.store else \
            dataclasses.replace(self, store=new)

    def revive(self, machine: int) -> "PICStore":
        new = revive(self.store, machine)
        return self if new is self.store else \
            dataclasses.replace(self, store=new)

    def to_state(self) -> api.PICState:
        st = self.store
        glob = to_state(st, self.S)      # shared O(|S|²) global-factor path
        alive = api.concrete_alive_mask(st.alive)
        if alive.all():
            # the streaming common case: no gather, every block cache (the
            # data included) passed by reference
            blk, loc = self.blocks, st.locals_
        else:
            idx = torch.as_tensor(np.flatnonzero(alive),
                                  device=st.alive.device)
            blk = PICBlocks(*(a[idx] for a in self.blocks))
            loc = LocalSummary(st.locals_.ydot[idx], st.locals_.Sdot[idx])
        return api.PICState(
            self.S, glob.Kss_L, glob.Sdd_L, glob.alpha, blk.Xb, blk.yb,
            blk.Ksd, blk.C_L, blk.Wy, loc.ydot, blk.beta, blk.B, loc.Sdot,
            clustering.block_centroids(blk.Xb))


def init_pic_store(kfn, params, X, y, *, S, runner: Runner) -> PICStore:
    """``GPMethod.init_store`` for ppic/pic (registered in core/ppic.py and
    core/pitc.py); its Sdd factor is the QR of the stacked square root
    (``_cold_store``), as pPITC's."""
    loc, F, blocks = _summarize_pic(kfn, params, S, X, y, runner)
    return PICStore(kfn, params, S, runner,
                    _cold_store(kfn, params, S, loc, F, runner),
                    runner.gather(blocks))
