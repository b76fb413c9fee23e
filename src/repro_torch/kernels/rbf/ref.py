"""Plain PyTorch versions of the two CUDA kernels (covariance + serving
diag) — port of ``repro.kernels.rbf.ref``.

The wrappers in ``ops.py`` take these for CPU tensors; the tests hold them
against the JAX oracles, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card. Nothing on the main path calls them when a card is present.
"""
from __future__ import annotations

import torch


def rbf_covariance(Xq: torch.Tensor, Xk: torch.Tensor, sig2) -> torch.Tensor:
    """sig2 * exp(-0.5 ||x - z||^2) for pre-lengthscale-scaled inputs.

    Xq: (..., n, d), Xk: (..., m, d) -> (..., n, m), batch dimensions
    broadcasting. Accumulates in float32 whatever the input dtype (the
    kernel's contract) and returns Xq's dtype.
    """
    Xq32 = Xq.to(torch.float32)
    Xk32 = Xk.to(torch.float32)
    q2 = torch.sum(Xq32 * Xq32, dim=-1)[..., :, None]
    k2 = torch.sum(Xk32 * Xk32, dim=-1)[..., None, :]
    cross = Xq32 @ Xk32.mT
    d2 = torch.clamp(q2 + k2 - 2.0 * cross, min=0.0)
    sig2 = torch.as_tensor(sig2, dtype=torch.float32, device=Xq.device)
    return (sig2 * torch.exp(-0.5 * d2)).to(Xq.dtype)


def xcov_diag(Xq: torch.Tensor, Xk: torch.Tensor, L1: torch.Tensor,
              alpha: torch.Tensor, sig2, L2: torch.Tensor | None = None):
    """Compose-path version of the fused serving kernel.

    Builds K_US dense, applies the cached triangular solves and reduces the
    variance quadratic form — the math ``ppitc.predict_batch_diag`` (L2 =
    chol Sdd) and ``gp.predict_batch_diag`` (L2 = None) perform, over
    pre-lengthscale-scaled inputs. Accumulates in float64 for float64 inputs
    and float32 otherwise, like the kernel.
    """
    acc = torch.float64 if Xq.dtype == torch.float64 else torch.float32
    Xqa, Xka = Xq.to(acc), Xk.to(acc)
    q2 = torch.sum(Xqa * Xqa, dim=-1)[:, None]
    k2 = torch.sum(Xka * Xka, dim=-1)[None, :]
    d2 = torch.clamp(q2 + k2 - 2.0 * (Xqa @ Xka.T), min=0.0)
    sig2 = torch.as_tensor(sig2, dtype=acc, device=Xq.device)
    kus = sig2 * torch.exp(-0.5 * d2)                  # (n, s)
    mean = torch.sum(kus * alpha.to(acc)[None, :], dim=1)
    # V = K_US L^{-T}: the right-sided solve X Lᵀ = K_US
    v1 = torch.linalg.solve_triangular(L1.to(acc).T, kus, upper=True,
                                       left=False)
    var = sig2 - torch.sum(v1 * v1, dim=1)
    if L2 is not None:
        v2 = torch.linalg.solve_triangular(L2.to(acc).T, kus, upper=True,
                                           left=False)
        var = var + torch.sum(v2 * v2, dim=1)
    return mean.to(Xq.dtype), var.to(Xq.dtype)
