"""Straggler mitigation by deadline-based partial aggregation — port of
``repro.runtime.straggler``.

The global summary is a sum whose partial sums are themselves VALID
posteriors (over the blocks that arrived). So instead of backup workers or
re-execution, the aggregation stops waiting at the deadline: predictions
proceed with the K <= M summaries present, and the stragglers fold in later
as an online update (Sec. 5.2 algebra).

``simulate`` measures the accuracy/latency trade: per-machine latency draws
-> deadline sweep -> (fraction of blocks included, posterior RMSE). A
deadline view is ``store.with_alive(arrived_mask)``: many machines flip at
once, so the store picks the incremental or the refold path by the number
of flips.

The random draws come from a ``torch.Generator`` where the reference takes a
JAX key: the same latency model, not the same numbers. Callers that compare
with the reference pass both the same latencies.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import online


class DeadlineResult(NamedTuple):
    deadline: float
    included: torch.Tensor    # (M,) bool
    fraction: torch.Tensor
    mean: torch.Tensor        # posterior mean over U
    var: torch.Tensor


def sample_latencies(gen: torch.Generator, M: int, *, base: float = 1.0,
                     straggle_p: float = 0.1,
                     straggle_factor: float = 10.0) -> torch.Tensor:
    """Bimodal latency model: an exp(1) body + a straggler tail, drawn on
    the generator's device."""
    dev = gen.device
    body = torch.empty(M, device=dev).exponential_(generator=gen)
    lat = base * (1.0 + body * 0.2)
    slow = torch.rand(M, generator=gen, device=dev) < straggle_p
    tail = torch.rand(M, generator=gen, device=dev)
    return torch.where(slow, lat * straggle_factor * (1 + tail), lat)


def aggregate_with_deadline(store: online.PITCStore, latencies,
                            deadline: float, U) -> DeadlineResult:
    """The posterior over U from the machines whose latency is within the
    deadline (and alive). ``latencies`` is an (M,) tensor (or array)."""
    lat = torch.as_tensor(latencies, device=store.alive.device)
    included = (lat <= deadline) & store.alive
    mean, covm = store.with_alive(included).predict(U)
    return DeadlineResult(deadline, included,
                          included.to(torch.float32).mean(), mean,
                          torch.diagonal(covm))


def simulate(gen: torch.Generator, store: online.PITCStore, U, y_true,
             deadlines):
    """RMSE and inclusion fraction per deadline."""
    lat = sample_latencies(gen, store.num_machines)
    rows = []
    for d in deadlines:
        r = aggregate_with_deadline(store, lat, d, U)
        rmse = torch.sqrt(torch.mean((r.mean - y_true) ** 2))
        rows.append({"deadline": float(d), "fraction": float(r.fraction),
                     "rmse": float(rmse)})
    return rows
