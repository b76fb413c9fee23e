"""Support-set selection (remark after Def. 2) — port of
``repro.core.support``.

Greedy differential-entropy-score selection: repeatedly add the candidate
with the largest posterior variance Sigma_{xx|S}, which is exactly the pivot
order of pivoted incomplete Cholesky on the candidate kernel matrix.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.core.icf import icf_factor
from repro_torch.parallel.runner import Runner


def select_support(kfn, params, candidates: torch.Tensor, size: int, *,
                   device=None) -> torch.Tensor:
    """Centralized greedy selection on ``device`` (the CUDA card unless
    named); returns the (size, d) support inputs."""
    dev = _device.resolve(device)
    params = {k: v.to(dev) for k, v in params.items()}
    candidates = candidates.to(dev)
    fac = icf_factor(kfn, params, candidates, size)
    return candidates.index_select(0, fac.pivots)


def select_support_parallel(kfn, params, candidates: torch.Tensor, size: int,
                            runner: Runner, *, device=None) -> torch.Tensor:
    """Greedy selection over machine-sharded candidates; returns the
    (size, d) support inputs.

    The reference runs the pivot loop per machine: each step takes the
    first machine whose local largest residual is the global largest, and
    that machine's first index of it, then every machine updates its shard.
    That is the first index of the largest residual over the machines'
    blocks in order, which is ``argmax`` on their concatenation, so on one
    device the M machines' loop is one ICF over the candidates (one launch
    of the ICF kernel for the SE spec on the card), pivot for pivot the
    reference's. The candidates must divide among the machines, as there.
    """
    runner.shard_blocks(candidates)            # the reference's shape check
    return select_support(kfn, params, candidates, size, device=device)
