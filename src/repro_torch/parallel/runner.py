"""The machine axis of the per-machine GP programs — port of
``repro.parallel.runner`` (single-device part).

The reference writes each algorithm once as a per-machine function and lets
``jax.vmap``/``shard_map`` realize the machine axis, with ``lax.psum`` as the
paper's all-reduce. The port writes that axis out: per-machine functions take
stacked (M, ...) tensors and run every machine in one batched call (the
covariance kernel builds all M blocks in one launch), and a collective over
machines is a sum over the leading dimension.

The routed scatter of pPIC serving comes with the pPIC slice; only
``ROUTED_ALPHA`` (a default of ``api.ServeSpec``) is here already.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

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
