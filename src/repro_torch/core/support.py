"""Support-set selection (remark after Def. 2) — port of
``repro.core.support.select_support``.

Greedy differential-entropy-score selection: repeatedly add the candidate
with the largest posterior variance Sigma_{xx|S}, which is exactly the pivot
order of pivoted incomplete Cholesky on the candidate kernel matrix. The
distributed selection comes with the pICF slice.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.core.icf import icf_factor


def select_support(kfn, params, candidates: torch.Tensor, size: int, *,
                   device=None) -> torch.Tensor:
    """Centralized greedy selection on ``device`` (the CUDA card unless
    named); returns the (size, d) support inputs."""
    dev = _device.resolve(device)
    params = {k: v.to(dev) for k, v in params.items()}
    candidates = candidates.to(dev)
    fac = icf_factor(kfn, params, candidates, size)
    return candidates.index_select(0, fac.pivots)
