"""Centralized PITC and PIC approximations of FGP — port of
``repro.core.pitc``.

These are the centralized counterparts that Theorems 1 and 2 prove the
parallel methods equal:

  PITC — eqs. (9)-(11)  (Quinonero-Candela & Rasmussen 2005)
  PIC  — eqs. (15)-(18) (Snelson 2007)

Two implementations each:
  * ``*_literal``  — builds Gamma_DD + Lambda as a dense |D|x|D| matrix exactly
    as written in the theorem statements. O(|D|^2) memory; the oracle the
    parallel methods are held against.
  * ``*_blockwise`` — the efficient centralized algorithm: the same math as
    the parallel methods, so thin wrappers over the shared ``fit ->
    state -> predict_batch`` path with a single-process VmapRunner standing
    in for the M machines.
"""
from __future__ import annotations

import torch

from repro_torch.core import api
from repro_torch.core import covariance as cov
from repro_torch.core import linalg
from repro_torch.core.gp import GPPosterior
from repro_torch.parallel.runner import VmapRunner


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _gamma(kfn, params, S, A, B, Kss_L):
    """Gamma_AB = K_AS K_SS^{-1} K_SB   (eq. 11), via cholesky of K_SS."""
    Vas = linalg.tri_solve(Kss_L, kfn(params, S, A)).mT  # K_AS Kss^{-1/2}
    Vbs = linalg.tri_solve(Kss_L, kfn(params, S, B))     # Kss^{-1/2} K_SB
    return Vas @ Vbs


def _blocks(n: int, M: int) -> list[slice]:
    if n % M != 0:
        raise ValueError(
            f"|D|={n} must divide among M={M} machines (Def. 1); pad the "
            f"data or pick M dividing n — query batches go through "
            f"parallel.runner.pad_blocks instead")
    b = n // M
    return [slice(m * b, (m + 1) * b) for m in range(M)]


def _lambda(Sig_dd_s: torch.Tensor, M: int) -> torch.Tensor:
    """Lambda: the M diagonal blocks of Sigma_DD|S, zero elsewhere."""
    Lam = torch.zeros_like(Sig_dd_s)
    for blk in _blocks(Sig_dd_s.shape[0], M):
        Lam[blk, blk] = Sig_dd_s[blk, blk]
    return Lam


def _literal_posterior(kfn, params, X_test, y_train, G_dd, Lam,
                       Gt_ud) -> GPPosterior:
    """Mean and covariance from Gamma_DD + Lambda and the test-train
    cross term ``Gt_ud`` (Gamma_UD for PITC, Gamma~_UD for PIC)."""
    A_L = linalg.chol(G_dd + Lam)
    mean = (Gt_ud @ linalg.chol_solve(A_L, y_train[:, None]))[:, 0]
    K_uu = kfn(params, X_test, X_test)
    covm = K_uu - Gt_ud @ linalg.chol_solve(A_L, Gt_ud.mT)
    return GPPosterior(mean, covm)


# ---------------------------------------------------------------------------
# PITC — literal (theorem oracle)
# ---------------------------------------------------------------------------

def pitc_predict_literal(kfn, params, S, X_train, y_train, X_test,
                         M: int) -> GPPosterior:
    """Eqs. (9)-(10) built dense, Lambda from the M diagonal blocks of
    Sigma_DD|S (noise included, as Sigma_xx' carries the delta term)."""
    Kss_L = linalg.chol(kfn(params, S, S))
    G_dd = _gamma(kfn, params, S, X_train, X_train, Kss_L)
    G_ud = _gamma(kfn, params, S, X_test, X_train, Kss_L)
    K_dd = cov.add_noise(kfn(params, X_train, X_train), params)
    Lam = _lambda(K_dd - G_dd, M)                # blocks of Sigma_DD|S
    return _literal_posterior(kfn, params, X_test, y_train, G_dd, Lam, G_ud)


# ---------------------------------------------------------------------------
# PIC — literal (theorem oracle)
# ---------------------------------------------------------------------------

def pic_predict_literal(kfn, params, S, X_train, y_train, X_test,
                        M: int) -> GPPosterior:
    """Eqs. (15)-(18): Gamma~ replaces the (U_i, D_i) blocks of Gamma_UD with
    the exact cross-covariance Sigma_{U_i D_i}."""
    n, u = X_train.shape[0], X_test.shape[0]
    Kss_L = linalg.chol(kfn(params, S, S))
    G_dd = _gamma(kfn, params, S, X_train, X_train, Kss_L)
    G_ud = _gamma(kfn, params, S, X_test, X_train, Kss_L)
    K_ud = kfn(params, X_test, X_train)
    K_dd = cov.add_noise(kfn(params, X_train, X_train), params)
    Lam = _lambda(K_dd - G_dd, M)
    Gt_ud = G_ud.clone()
    for db, ub in zip(_blocks(n, M), _blocks(u, M)):
        Gt_ud[ub, db] = K_ud[ub, db]              # eq. (18), i = m branch
    return _literal_posterior(kfn, params, X_test, y_train, G_dd, Lam, Gt_ud)


def pic_predict_literal_routed(kfn, params, S, X_train, y_train, X_test,
                               M: int, assign) -> GPPosterior:
    """Eqs. (15)-(18) with the i = m branch of eq. (18) chosen per query by
    ``assign`` (u,) — the centralized oracle for centroid-routed pPIC:
    query i takes the exact cross-covariance against training block
    ``assign[i]`` and the low-rank Gamma against every other block."""
    n = X_train.shape[0]
    assign = torch.as_tensor(assign, device=X_train.device)
    Kss_L = linalg.chol(kfn(params, S, S))
    G_dd = _gamma(kfn, params, S, X_train, X_train, Kss_L)
    G_ud = _gamma(kfn, params, S, X_test, X_train, Kss_L)
    K_ud = kfn(params, X_test, X_train)
    K_dd = cov.add_noise(kfn(params, X_train, X_train), params)
    Lam = _lambda(K_dd - G_dd, M)

    # eq. (18): routed i = m branch — data column j belongs to block j // b
    b = n // M
    cols = torch.arange(n, device=X_train.device) // b
    Gt_ud = torch.where(assign[:, None] == cols[None, :], K_ud, G_ud)
    return _literal_posterior(kfn, params, X_test, y_train, G_dd, Lam, Gt_ud)


# ---------------------------------------------------------------------------
# Efficient centralized PITC/PIC — thin wrappers over the shared state path.
# ---------------------------------------------------------------------------

def fit(kfn, params, X, y, *, S, M: int) -> api.PITCState:
    """Centralized PITC fit: identical state to ``ppitc.fit`` by
    construction (the block loop is the batched simulation of M machines)."""
    from repro_torch.core import ppitc
    return ppitc.fit(kfn, params, X, y, S=S, runner=VmapRunner(M=M))


def fit_pic(kfn, params, X, y, *, S, M: int) -> api.PICState:
    """Centralized PIC fit over the shared pPIC state path."""
    from repro_torch.core import ppic
    return ppic.fit(kfn, params, X, y, S=S, runner=VmapRunner(M=M))


def pitc_predict_blockwise(kfn, params, S, X_train, y_train, X_test,
                           M: int) -> GPPosterior:
    from repro_torch.core import ppitc
    state = fit(kfn, params, X_train, y_train, S=S, M=M)
    return ppitc.predict_batch(kfn, params, state, X_test)


def pic_predict_blockwise(kfn, params, S, X_train, y_train, X_test,
                          M: int) -> GPPosterior:
    """Efficient centralized PIC: summary term + per-block local correction
    (eqs. 12-14 blockwise), with the dense block-diagonal cov view."""
    from repro_torch.core import ppic
    state = fit_pic(kfn, params, X_train, y_train, S=S, M=M)
    return ppic.predict_batch(kfn, params, state, X_test)


def _pitc_predict(kfn, params, state, U):
    from repro_torch.core import ppitc
    return ppitc.predict_batch(kfn, params, state, U)


def _pitc_predict_diag(kfn, params, state, U):
    from repro_torch.core import ppitc
    return ppitc.predict_batch_diag(kfn, params, state, U)


def _pic_predict(kfn, params, state, U):
    from repro_torch.core import ppic
    return ppic.predict_batch(kfn, params, state, U)


def _pic_predict_diag(kfn, params, state, U):
    from repro_torch.core import ppic
    return ppic.predict_batch_diag(kfn, params, state, U)


def _pic_predict_routed_diag(kfn, params, state, U, *, tile=None):
    from repro_torch.core import ppic
    return ppic.predict_routed_diag(kfn, params, state, U, tile=tile)


def _pic_plan(method, kfn, params, state, spec):
    """Centralized PIC serves through pPIC's plan (same PICState, same
    backend caches and overflow-program ladder)."""
    from repro_torch.core import ppic
    return ppic.make_plan(method, kfn, params, state, spec)


def _pitc_init_store(kfn, params, X, y, *, S, M: int):
    """Centralized PITC shares pPITC's StateStore (one-process blocks)."""
    from repro_torch.core import online
    return online.init_pitc_store(kfn, params, X, y, S=S,
                                  runner=VmapRunner(M=M))


def _pic_init_store(kfn, params, X, y, *, S, M: int):
    from repro_torch.core import online
    return online.init_pic_store(kfn, params, X, y, S=S,
                                 runner=VmapRunner(M=M))


api.register(api.GPMethod("pitc", fit, predict_fn=_pitc_predict,
                          predict_diag_fn=_pitc_predict_diag,
                          init_store=_pitc_init_store))
api.register(api.GPMethod("pic", fit_pic, predict_fn=_pic_predict,
                          predict_diag_fn=_pic_predict_diag,
                          predict_routed_diag_fn=_pic_predict_routed_diag,
                          init_store=_pic_init_store, plan_fn=_pic_plan))
