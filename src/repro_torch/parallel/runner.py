"""The machine axis of the per-machine GP programs — port of
``repro.parallel.runner`` (single-device part).

The reference writes each algorithm once as a per-machine function and lets
``jax.vmap``/``shard_map`` realize the machine axis, with ``lax.psum`` as the
paper's all-reduce. The port writes that axis out: per-machine functions take
stacked (M, ...) tensors and run every machine in one batched call (the
covariance kernel builds all M blocks in one launch), and a collective over
machines is a sum over the leading dimension.

The routed scatters of pPIC serving (``scatter_by_block`` and the
two-bucket ``scatter_two_bucket``) are here too. The reference drops a
row that no slot takes (``.at[...].set(mode="drop")``); the port writes it
into a spare trash row of a buffer one larger and slices that off, so every
shape depends on the batch size alone and nothing syncs with the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import torch

ROUTED_ALPHA = 2   # main-bucket capacity multiplier alpha (headroom vs skew)


@dataclasses.dataclass(frozen=True)
class Runner:
    """Machine-axis executor."""

    @property
    def num_machines(self) -> int:
        raise NotImplementedError

    def map(self, fn: Callable, sharded: Sequence, replicated: Sequence = ()):
        """Run ``fn(*sharded, *replicated)``, where every ``sharded`` tensor
        carries the leading (M, ...) machine axis and ``fn`` is written
        batched over it. Returns ``fn``'s stacked outputs."""
        raise NotImplementedError

    def shard_blocks(self, X: torch.Tensor) -> torch.Tensor:
        """(n, ...) -> (M, n/M, ...) block layout (paper Def. 1).

        Training data must divide exactly — zero-padding data rows would
        corrupt the local summaries (a padded row adds a spurious noise-only
        observation to Sigma_{DmDm|S}). Query batches are row-independent and
        go through ``pad_blocks`` instead.
        """
        M = self.num_machines
        n = X.shape[0]
        if n % M != 0:
            raise ValueError(
                f"n={n} does not divide among M={M} machines (Def. 1). "
                f"Either trim/re-block the data so M | n, or — for query "
                f"batches — use parallel.runner.pad_blocks(X, M), which "
                f"zero-pads and returns the valid count for trimming.")
        return X.reshape((M, n // M) + tuple(X.shape[1:]))

    def pad_blocks(self, X: torch.Tensor) -> tuple[torch.Tensor, int]:
        """Zero-padded (M, ceil(n/M), ...) block layout; see ``pad_blocks``."""
        return pad_blocks(X, self.num_machines)

    def unshard(self, Xb: torch.Tensor) -> torch.Tensor:
        return Xb.reshape((-1,) + tuple(Xb.shape[2:]))


@dataclasses.dataclass(frozen=True)
class VmapRunner(Runner):
    """All M machines on one device, as one batched program."""
    M: int = 4

    @property
    def num_machines(self) -> int:
        return self.M

    def map(self, fn, sharded, replicated=()):
        return fn(*sharded, *replicated)


def pad_blocks(X: torch.Tensor, M: int) -> tuple[torch.Tensor, int]:
    """(n, ...) -> ((M, ceil(n/M), ...), n): zero-pad to the block layout.

    For *query* batches only: query rows are independent in every predictive
    equation, so padded rows produce garbage predictions for themselves and
    affect nothing else — callers slice outputs back to the returned valid
    count ``n``. (Training data must not be padded; see Runner.shard_blocks.)
    """
    n = X.shape[0]
    b = -(-n // M)
    pad = M * b - n
    if pad:
        X = torch.cat([X, X.new_zeros((pad,) + tuple(X.shape[1:]))])
    return X.reshape((M, b) + tuple(X.shape[1:])), n


def scatter_by_block(X: torch.Tensor, assign: torch.Tensor, M: int):
    """Scatter (n, ...) rows into an (M, n, ...) block layout by assignment.

    The routed-serving counterpart of ``pad_blocks``: row i lands in block
    ``assign[i]`` at the next free slot (original order preserved within a
    block — stable sort). Capacity is ``n`` per block, so the output shape
    depends only on (n, M), and a fully-skewed batch (all rows on one block)
    still fits. Unoccupied slots stay zero; per-row independence of the
    predictive equations makes them inert (see ``pad_blocks``).

    Returns ``(Xb, order, block_of, slot)`` where ``Xb[block_of[j], slot[j]]
    == X[order[j]]``; pass the triple to ``gather_by_block`` to restore
    caller order.
    """
    n = X.shape[0]
    order = torch.argsort(assign, stable=True)             # group by block
    block_of = assign[order]                               # (n,) sorted ids
    starts = torch.searchsorted(
        block_of, torch.arange(M, dtype=block_of.dtype, device=X.device))
    slot = torch.arange(n, device=X.device) - starts[block_of]
    Xb = X.new_zeros((M, n) + tuple(X.shape[1:]))
    Xb[block_of, slot] = X[order]
    return Xb, order, block_of, slot


def _unsort(picked: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``out[order] = picked``: sorted order back to caller order."""
    out = torch.zeros_like(picked)
    out[order] = picked
    return out


def gather_by_block(vals: torch.Tensor, order: torch.Tensor,
                    block_of: torch.Tensor,
                    slot: torch.Tensor) -> torch.Tensor:
    """Invert ``scatter_by_block`` on per-row outputs: (M, n, ...) -> (n, ...)
    in the original caller order."""
    return _unsort(vals[block_of, slot], order)


# ---------------------------------------------------------------------------
# Two-bucket routed scatter: capacity-bounded main bucket + skew overflow.
#
# ``scatter_by_block``'s capacity-n layout is shape-stable and skew-proof but
# computes M*n rows to serve n queries. The two-bucket scheme keeps both
# properties at ~(1 + 1/alpha) x:
#
#   * main bucket    — (M, cap) per-block layout with cap = alpha*ceil(n/M):
#     each block keeps its first cap routed rows (stable order);
#   * overflow bucket — (G, cap) groups for the rows a skewed batch pushes
#     past a block's capacity, one BLOCK per group; each group records the
#     block whose cached factors serve it, so an overflow row computes the
#     same per-row program as in the capacity-n layout.
#
# G is static: at most n/cap <= M/alpha blocks overflow, so G =
# ceil(M/alpha). When cap >= n no row can overflow and G = 0.
# ---------------------------------------------------------------------------


class RoutedLayout(NamedTuple):
    """Two-bucket scatter result + the bookkeeping to invert it.

    ``Xb[block_of[j], rank[j]] == X[order[j]]`` for main rows
    (``in_main[j]``); overflow row j sits at ``Xo[group[j], slot_o[j]]`` and
    must be served with block ``block_of[j]``'s factors (= ``o_blk`` of its
    group). Pass per-row outputs to ``gather_two_bucket``.
    """
    Xb: torch.Tensor               # (M, cap, ...) main routed bucket
    Xo: torch.Tensor | None        # (G, cap, ...) overflow (None: G == 0)
    o_blk: torch.Tensor | None     # (G,) block id served by each group
    order: torch.Tensor            # (n,) argsort(assign), stable
    block_of: torch.Tensor         # (n,) assignment in sorted order
    rank: torch.Tensor             # (n,) intra-block arrival rank
    group: torch.Tensor            # (n,) overflow group (junk if in_main)
    slot_o: torch.Tensor           # (n,) slot within the overflow group
    in_main: torch.Tensor          # (n,) bool: row landed in the main bucket

    @property
    def padded_rows(self) -> int:
        """Total computed rows (both buckets) — the compute the layout pays."""
        go = 0 if self.Xo is None else self.Xo.shape[0]
        return (self.Xb.shape[0] + go) * self.Xb.shape[1]


def routed_capacity(n: int, M: int, *, alpha: int = ROUTED_ALPHA,
                    tile: int = 1,
                    max_groups: int | None = None) -> tuple[int, int]:
    """(cap, G) of the two-bucket layout — static given (n, M, alpha).

    ``tile`` rounds cap up to a multiple of the serving query tile.
    ``max_groups`` selects a SMALLER overflow program (lazy overflow
    dispatch): the routed ServePlan counts the per-block occupancy on the
    host and runs the G=0 program on balanced traffic. The caller owns the
    sufficiency contract: rows past the declared groups' capacity are
    dropped by the scatter, so the count and the assignment driving the
    scatter must come from one float path (``ppic.PICServePlan`` passes its
    host assignment into the program). Values above the worst case are
    clamped."""
    cap = min(alpha * (-(-n // M)), n)
    cap = -(-cap // tile) * tile
    G = 0 if cap >= n else -(-M // alpha)
    if max_groups is not None:
        G = min(G, max_groups)
    return cap, G


def scatter_two_bucket(X: torch.Tensor, assign: torch.Tensor, M: int, *,
                       alpha: int = ROUTED_ALPHA, tile: int = 1,
                       max_groups: int | None = None) -> RoutedLayout:
    """Scatter (n, ...) rows into the two-bucket routed layout by assignment.

    Shape-stable: every tensor depends only on (n, M, alpha, tile,
    max_groups). Unoccupied slots stay zero (inert, see ``pad_blocks``). A
    row that no slot takes (past ``max_groups``' capacity) goes to the trash
    row of a buffer one larger, which is sliced off: the reference's drop.
    """
    n = X.shape[0]
    dev = X.device
    cap, G = routed_capacity(n, M, alpha=alpha, tile=tile,
                             max_groups=max_groups)
    order = torch.argsort(assign, stable=True)             # group by block
    block_of = assign[order]                               # (n,) sorted ids
    starts = torch.searchsorted(
        block_of, torch.arange(M + 1, dtype=block_of.dtype, device=dev))
    counts = torch.diff(starts)                            # (M,) block loads
    rank = torch.arange(n, device=dev) - starts[block_of]  # intra-block rank
    in_main = rank < cap
    rows = X[order]

    Xb = X.new_zeros((M + 1, cap) + tuple(X.shape[1:]))    # row M: trash
    Xb[torch.where(in_main, block_of, M),
       torch.where(in_main, rank, 0)] = rows
    Xb = Xb[:M]

    if G == 0:
        zero = torch.zeros((n,), dtype=rank.dtype, device=dev)
        return RoutedLayout(Xb, None, None, order, block_of, rank,
                            zero, zero, in_main)

    # overflow: block m's surplus o_m fills ceil(o_m/cap) exclusive groups
    om = torch.clamp(counts - cap, min=0)
    gm = -(-om // cap)                                     # groups per block
    gstart = torch.cumsum(gm, 0) - gm                      # exclusive prefix
    orank = torch.clamp(rank - cap, min=0)                 # > 0 iff overflow
    group = gstart[block_of] + orank // cap
    slot_o = orank % cap
    gi = torch.where(in_main | (group >= G), G, group)     # group G: trash
    Xo = X.new_zeros((G + 1, cap) + tuple(X.shape[1:]))
    Xo[gi, torch.where(gi == G, 0, slot_o)] = rows
    o_blk = block_of.new_zeros((G + 1,))
    o_blk[gi] = block_of                  # one block a group: same values
    return RoutedLayout(Xb, Xo[:G], o_blk[:G], order, block_of, rank,
                        group, slot_o, in_main)


def gather_two_bucket(vals_main: torch.Tensor,
                      vals_over: torch.Tensor | None,
                      lay: RoutedLayout) -> torch.Tensor:
    """Invert ``scatter_two_bucket`` on per-row outputs: (M, cap, ...) +
    (G, cap, ...) -> (n, ...) in the original caller order."""
    picked = vals_main[lay.block_of,
                       torch.clamp(lay.rank, max=vals_main.shape[1] - 1)]
    if vals_over is not None:
        over = vals_over[torch.clamp(lay.group, max=vals_over.shape[0] - 1),
                         lay.slot_o]
        cond = lay.in_main.reshape((-1,) + (1,) * (picked.ndim - 1))
        picked = torch.where(cond, picked, over)
    return _unsort(picked, lay.order)
