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
    (size, d) support inputs, on every process. The candidates must divide
    among the machines, as in the reference. The route follows the runner:

    * a ``VmapRunner`` (one process holds every machine): the reference's
      per-step pivot, the first machine whose local largest residual is the
      global largest and that machine's first index of it, is the first
      index of the largest residual over the machines' blocks in order,
      which is ``argmax`` on their concatenation. So the M machines' loop
      is one ICF over the candidates (one launch of the ICF kernel for the
      SE spec on the card), pivot for pivot the reference's; on ``device``
      (the card unless named).
    * a ``ShardMapRunner`` (the machines spread over its ranks, one or
      more): the reference's collective pivot loop,
      ``picf.icf_factor_local`` over the runner's machine axis: per step
      an all-gather of the machines' largest
      residuals, the owner's input broadcast as a masked psum, and each
      machine's rank-1 update of its shard. On the runner's device. In
      float64 its pivots are the ICF kernel's (the column takes the
      kernel's arithmetic, ``picf._pivot_column``); in float32 the two
      part at the first near tie (the kernel sums another order), so the
      selections differ.
    """
    if not runner.axis.distributed:
        runner.shard_blocks(candidates)        # the reference's shape check
        return select_support(kfn, params, candidates, size, device=device)
    from repro_torch.core import picf
    dev = runner.axis.device if device is None else _device.resolve(device)
    params = {k: v.to(dev) for k, v in params.items()}
    Cb = runner.shard_blocks(candidates.to(dev))
    local = runner.map(lambda Cm, params: picf.icf_factor_local(
        kfn, params, Cm, size, axis_name=runner.axis), (Cb,), (params,))
    return local.pivots[0].to(candidates.dtype)
