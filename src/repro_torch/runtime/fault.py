"""Fault tolerance built on the paper's summary algebra — port of
``repro.runtime.fault``.

The global summary (eqs. 5-6 / 22-23) is a SUM of per-machine terms, so when
machine m dies, the posterior over the SURVIVING data comes from the cached
local summaries: no recomputation of the survivors' O((|D|/M)³) work, and
the result is the PITC/PIC posterior of the surviving blocks
(tests/test_torch_runtime.py).

Recovery ladder:
  1. degrade     — drop the lost block (a rank-b downdate of the cached
                   global factor via ``StateStore.retire``; the
                   ``chol_downdate`` kernel on the card);
  2. reassign    — a standby or surviving machine recomputes ONLY the lost
                   block's summary from the (replicated or re-readable)
                   data shard and folds it back in;
  3. checkpoint  — summaries are small (M x (|S| + |S|²)), so a master loss
                   replays the sum (``core/serialize.py``, not ported yet).

Built on the ``api.StateStore`` protocol (``online.PITCStore``); the cluster
adds only the block→machine assignment a scheduler needs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import online
from repro_torch.core.ppitc import GlobalSummary
from repro_torch.parallel.runner import Runner


class ClusterState(NamedTuple):
    store: online.PITCStore
    # block -> machine assignment (simulation bookkeeping)
    owner: torch.Tensor       # (n_blocks,) int32


def build(kfn, params, S, X, y, runner: Runner) -> ClusterState:
    """Fit the store on (X, y) over ``runner``'s machines, each block owned
    by its own machine. Runs where X lies."""
    store = online.init_pitc_store(kfn, params, X, y, S=S, runner=runner)
    return ClusterState(store, torch.arange(store.num_machines,
                                            dtype=torch.int32,
                                            device=X.device))


def fail(state: ClusterState, machine: int) -> ClusterState:
    """Machine loss: fold its contribution out — one O(|S|² b) downdate of
    the cached global factor, no recompute of the survivors."""
    return state._replace(store=state.store.retire(machine))


def recover_degraded(state: ClusterState) -> GlobalSummary:
    """Posterior ingredients over the surviving blocks only."""
    return state.store.global_summary()


def recover_reassign(state: ClusterState, Xm, ym, *, machine: int,
                     new_owner: int) -> ClusterState:
    """A standby machine recomputes ONLY the lost block's summary (the
    paper's Step 2 for one block) and folds it back in. The store owns the
    fit context (kernel, hyperparameters, S), so recovery needs just the
    re-read shard."""
    store = state.store.reassign(machine, Xm, ym)
    owner = state.owner.clone()
    owner[machine] = new_owner
    return ClusterState(store, owner)
