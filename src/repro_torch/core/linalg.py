"""Shared PSD linear-algebra helpers — port of ``repro.core.linalg``.

All solves of the GP stack go through these helpers so that the jitter policy
and dtype behaviour are uniform. Every helper broadcasts over leading batch
dimensions (the machine axis of ``parallel.runner.VmapRunner``).

The rank-1/rank-b Cholesky updates of the streaming stores (Sec. 5.2) take
two routes (``chol_update_rank``): an update is the QR of the stacked square
root (``chol_from_root``), on every device, the form the cold fits factor
with; a downdate is the CUDA kernel ``kernels/linalg/csrc/chol_downdate.cu``
for CUDA tensors and its plain version, the reference's sweeps, for CPU
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.linalg import ops as linalg_ops

# Jitter scaled to dtype: float64 paths need far less regularisation.
_JITTER = {torch.float64: 1e-10, torch.float32: 1e-6}


def default_jitter(dtype) -> float:
    return _JITTER.get(dtype, 1e-6)


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def add_jitter(K: torch.Tensor, jitter: float | None = None) -> torch.Tensor:
    """K + jitter * mean(diag(K)) * I — relative jitter keeps scale-invariance
    (the mean is taken per matrix of a batch)."""
    if jitter is None:
        jitter = default_jitter(K.dtype)
    scale = torch.diagonal(K, dim1=-2, dim2=-1).mean(-1)[..., None, None]
    return K + (jitter * scale) * _eye_like(K)


def cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; a NaN lower triangle where the matrix is not
    positive definite.

    ``jnp.linalg.cholesky`` returns NaN on a non-PD matrix, while
    ``torch.linalg.cholesky`` raises. The port keeps the reference's NaN:
    raising would need the device to report back to the host after every
    factorization (a sync on the fit path), and a NaN factor propagates to
    every output, where the callers' finiteness checks catch it.
    """
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")).tril(), L)


def chol(K: torch.Tensor, jitter: float | None = None) -> torch.Tensor:
    """Lower Cholesky factor of a PSD matrix with relative jitter (NaN if it
    is still not positive definite; see ``cholesky_nan``)."""
    return cholesky_nan(add_jitter(K, jitter))


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) X = B given lower Cholesky L."""
    return torch.cholesky_solve(B, L, upper=False)


def tri_solve_right(L: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Solve X Lᵀ = A for lower triangular L — A L⁻ᵀ with A's ROWS as the
    batch axis (= ``tri_solve(L, A.T).T`` mathematically)."""
    return torch.linalg.solve_triangular(L.mT, A, upper=True, left=False)


def chol_solve_right(L: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Solve X (L Lᵀ) = A given lower Cholesky L — A (L Lᵀ)⁻¹ with A's ROWS
    as the batch axis (= ``chol_solve(L, A.T).T`` mathematically)."""
    return torch.linalg.solve_triangular(L, tri_solve_right(L, A),
                                         upper=False, left=False)


def psd_solve(K: torch.Tensor, B: torch.Tensor,
              jitter: float | None = None) -> torch.Tensor:
    """Solve K X = B for PSD K via jittered Cholesky."""
    return chol_solve(chol(K, jitter), B)


def psd_inv(K: torch.Tensor, jitter: float | None = None) -> torch.Tensor:
    """K⁻¹ for PSD K via jittered Cholesky (batched over leading axes)."""
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return psd_solve(K, eye.expand(K.shape), jitter)


def tri_solve(L: torch.Tensor, B: torch.Tensor, *, lower: bool = True,
              trans: bool = False) -> torch.Tensor:
    """Solve L X = B (or Lᵀ X = B with ``trans``) for triangular L."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, B, upper=lower)
    return torch.linalg.solve_triangular(L, B, upper=not lower)


def _qr_r(A: torch.Tensor) -> torch.Tensor:
    """R of A's QR. Autograd goes through the QR when A requires grad
    (``mode="reduced"``: its backward needs Q); otherwise Q is not
    formed."""
    mode = "reduced" if torch.is_grad_enabled() and A.requires_grad else "r"
    return torch.linalg.qr(A, mode=mode).R


def chol_from_root(L0: torch.Tensor, F: torch.Tensor, *,
                   axis=None) -> torch.Tensor:
    """Lower Cholesky factor of L0 L0ᵀ + Σ_m F_m F_mᵀ for lower L0 (s, s)
    and F (M, s, b) (or (s, b)), from its square root, never forming the
    sum: Rᵀ of the QR of A = [L0ᵀ; F_1ᵀ; ...; F_Mᵀ], rows signed so that
    the diagonal is positive (then Rᵀ is the Cholesky factor of AᵀA). A's
    condition number is the square root of the sum's, which is what keeps
    the factor of an ill-conditioned sum accurate in float32.

    ``axis`` (a runner's machine axis) with F this process's (L, s, b)
    stack of a ``DistAxis`` (one rank or more): a TSQR. Each rank takes the QR of
    its own rows [F_1ᵀ; ...; F_Lᵀ] to an (s, s) triangle T_p (zero rows
    added first if it has fewer than s), one all-gather brings every T_p to
    every rank, and the factor is that of [L0ᵀ; T_1; ...; T_P]: the same
    AᵀA, since T_pᵀ T_p = Σ_{m of p} F_m F_mᵀ. On a ``StackedAxis`` (a
    ``VmapRunner``), or with none, it is the QR above."""
    s = L0.shape[-1]
    rows = F.mT.reshape(-1, s)
    if axis is not None and axis.distributed:
        if rows.shape[0] < s:
            rows = torch.cat([rows, rows.new_zeros((s - rows.shape[0], s))])
        rows = axis.gather_ranks(_qr_r(rows)).reshape(-1, s)
    R = _qr_r(torch.cat([L0.mT, rows]))
    sign = torch.where(torch.diagonal(R) < 0, -1.0, 1.0).to(R.dtype)
    return (R * sign[:, None]).mT


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                           dim=-1)


# ---------------------------------------------------------------------------
# Rank-1 / rank-b Cholesky updates (paper Sec. 5.2 incremental summaries).
# ---------------------------------------------------------------------------

def chol_update_rank(L: torch.Tensor, W: torch.Tensor, *,
                     sign: float = 1.0) -> torch.Tensor:
    """Lower Cholesky factor of L Lᵀ + sign·W Wᵀ for lower L (n, n) and an
    (n, b) factor W, sign +1 (update) or −1 (downdate).

    The reference chains b LINPACK sweeps of (hyperbolic) rotations, n b
    dependent steps. The port takes another route for each sign:

    * update: ``chol_from_root(L, W)``, the QR of [Lᵀ; Wᵀ] (cuSOLVER on
      the card), O((n + b) n²). It is how the cold fits factor Sdd and
      pICF's Phi, so a streamed factor and a cold one come from the same
      matrix by the same method, and it stays accurate in float32 where the
      formed sum is ill-conditioned;
    * downdate: ``kernels.linalg.ops.chol_downdate``, the reference's sweeps
      as one cooperative CUDA launch of n + b − 1 wavefront steps for CUDA
      tensors, the same sweeps in plain PyTorch for CPU tensors. It needs
      L Lᵀ − W Wᵀ positive definite, which holds when W was folded in
      before (the summary algebra).

    Zero columns of W change nothing: the padding convention of
    ``online._pad_factor`` relies on it."""
    if sign == 1.0:
        return chol_from_root(L, W)
    if sign == -1.0:
        return linalg_ops.chol_downdate(L, W)
    raise ValueError(f"sign must be 1.0 (update) or -1.0 (downdate); got "
                     f"{sign!r}")


def cholupdate(L: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of L Lᵀ + w wᵀ (the QR route)."""
    return chol_update_rank(L, w[:, None])


def choldowndate(L: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of L Lᵀ − w wᵀ; requires the difference to stay
    positive definite (it does when w was folded in before)."""
    return chol_update_rank(L, w[:, None], sign=-1.0)
