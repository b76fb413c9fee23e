"""Elastic scaling: decouple LOGICAL blocks from PHYSICAL machines — port of
``repro.runtime.elastic``.

The data is partitioned into a fixed number of logical blocks B >> M (the
paper's Def. 1 applied at block granularity). Machines own contiguous runs
of blocks; the PITC/PIC posterior is a function of the BLOCK partition
only, so changing M:

  * never changes predictions (tests/test_torch_runtime.py),
  * needs no summary recomputation — blocks move, their cached summaries
    move with them (a gather over the stacked tensors),
  * keeps the all-reduce payload constant (|S|², independent of B and M).

``plan_assignment`` balances blocks over machines; ``reshard`` reshapes the
stacked block tensors for a new machine count. Both ``reshard`` and
``unshard`` map over tensors and over NamedTuples, dicts, lists and tuples
of them (the reference maps over JAX pytrees).
"""
from __future__ import annotations

from typing import Callable

import torch


def _tree_map(fn: Callable, tree):
    """``fn`` on every tensor of a nest of NamedTuples, dicts, lists and
    tuples; the nest's structure kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"cannot map over a {type(tree).__name__}: need tensors "
                    f"in NamedTuples, dicts, lists or tuples")


def plan_assignment(n_blocks: int, n_machines: int) -> list[range]:
    """Contiguous balanced assignment; machine i owns blocks plan[i]."""
    base, extra = divmod(n_blocks, n_machines)
    out, start = [], 0
    for i in range(n_machines):
        size = base + (1 if i < extra else 0)
        out.append(range(start, start + size))
        start += size
    return out


def blocks_per_machine(n_blocks: int, n_machines: int) -> int:
    if n_blocks % n_machines:
        raise ValueError(f"{n_blocks} logical blocks do not divide among "
                         f"{n_machines} machines (the stacked layout needs "
                         f"it)")
    return n_blocks // n_machines


def reshard(block_tree, n_machines_new: int):
    """(B, ...) stacked per-block tensors -> (M', B/M', ...) machine-major.

    Machines process their owned blocks with an inner batch or loop; the
    collective code is unchanged because summaries stay per-block.
    """
    def one(a):
        k = blocks_per_machine(a.shape[0], n_machines_new)
        return a.reshape((n_machines_new, k) + tuple(a.shape[1:]))

    return _tree_map(one, block_tree)


def machine_view(block_tree, n_machines: int):
    """Convenience: ``reshard``."""
    return reshard(block_tree, n_machines)


def unshard(machine_tree):
    """(M, k, ...) -> (M k, ...) on every tensor."""
    return _tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])),
                     machine_tree)
