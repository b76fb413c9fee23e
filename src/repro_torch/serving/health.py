"""Per-block health tracking + the self-healing policy ladder — port of
``repro.serving.health`` (host-side bookkeeping, as the reference).

The paper's cluster-of-20 premise means every serving posterior is a SUM of
per-machine contributions — and a serving runtime that assumes all M blocks
are forever healthy turns one straggling or NaN-producing block into a
tenant-wide outage. This module is the scheduler's health brain: it watches
every flush (latency, output finiteness, dispatch failures), attributes
trouble to blocks, and walks the policy ladder

    flush timeout ──► retry with exponential backoff + jitter
                 ──► auto-retire the offending block (ROUTING-MASK only:
                     the store is untouched and the state keeps its block
                     axis, so the degraded programs — the dead-row mask an
                     argument — serve stranded queries from the global
                     S-space posterior with no new serving callable)
                 ──► background revive from the last ``save_store``
                     checkpoint (``TenantScheduler.pump``), restoring the
                     block bitwise.

Retirement here is deliberately NOT ``StateStore.retire``: the store-level
retire gathers alive blocks and SHRINKS the state's block axis — exact
posterior, but a changed state shape and routing space. The
health layer instead keeps the fitted state intact and masks the block out
of routing (``PICServePlan.routed_diag(block_alive=...)``), trading a
bounded accuracy loss on the stranded queries (pPITC-level, property-tested
against the ``with_alive`` oracle) for uninterrupted serving on the same
callables. Store-level retire remains the right tool for PERMANENT
decommission.

All counters surface through ``ServeStats`` (``n_retries``,
``n_auto_retired``, ``n_revives``, ...); per-block detail through
``HealthTracker.snapshot()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.runtime.monitor import Ema


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """The self-healing knobs, declared once per tenant (frozen).

    * ``flush_timeout_ms`` — per-flush latency budget. A flush exceeding it
      counts a timeout failure against the participating block with the
      WORST latency EMA (a single fused dispatch has one aggregate latency;
      the per-block EMA is what localizes the straggler over repeated
      flushes). ``None`` disables timeout tracking.
    * ``max_retries`` — failed/NaN flushes are retried this many times
      before the dispatch loop escalates; each retry re-routes around any
      block retired in between, so a retry after an auto-retire serves the
      stranded rows degraded instead of failing again.
    * ``backoff_base_ms`` / ``backoff_jitter`` — retry n sleeps
      ``backoff_base_ms * 2^n``, jittered by ``±backoff_jitter`` fraction
      (seeded: chaos runs are reproducible). The scheduler's injectable
      ``sleep`` makes this virtual-time-testable.
    * ``max_consecutive_failures`` — consecutive failures attributed to one
      block before it is auto-retired (routing mask, see module docstring).
      A successful flush the block participates in resets its counter.
    * ``checkpoint`` — path of the last known-good ``save_store`` artifact;
      enables background revive. A corrupt/truncated artifact is DETECTED
      (``serialize.CheckpointError``, counted in ``n_revive_failures``) and
      never loaded.
    * ``revive_after_ms`` — how long a block stays retired before the
      scheduler's ``pump`` attempts a checkpoint revive (also the re-arm
      delay after a failed revive attempt).
    * ``seed`` — jitter RNG seed.
    """
    flush_timeout_ms: Optional[float] = None
    max_retries: int = 2
    backoff_base_ms: float = 1.0
    backoff_jitter: float = 0.5
    max_consecutive_failures: int = 2
    checkpoint: Optional[object] = None
    revive_after_ms: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0 or self.max_consecutive_failures < 1:
            raise ValueError(
                f"HealthPolicy needs max_retries >= 0 and "
                f"max_consecutive_failures >= 1; got {self}")
        if self.backoff_base_ms < 0 or not 0 <= self.backoff_jitter <= 1:
            raise ValueError(
                f"HealthPolicy needs backoff_base_ms >= 0 and jitter in "
                f"[0, 1]; got {self}")


@dataclasses.dataclass
class BlockHealth:
    """One block's health ledger."""
    latency: Ema = dataclasses.field(
        default_factory=lambda: Ema(alpha=0.7))
    consecutive_failures: int = 0
    n_failures: int = 0
    n_nonfinite: int = 0
    alive: bool = True
    retired_at: Optional[float] = None

    def snapshot(self) -> dict:
        return {"alive": self.alive,
                "latency_ms": self.latency.value,
                "consecutive_failures": self.consecutive_failures,
                "n_failures": self.n_failures,
                "n_nonfinite": self.n_nonfinite}


class HealthTracker:
    """Per-block health state for one tenant's M serving blocks.

    Pure bookkeeping — the POLICY decisions (when to retry, retire, revive)
    live in ``TenantScheduler``'s dispatch loop; this object answers "what
    does the evidence say about block m" and owns the routing mask.
    """

    def __init__(self, n_blocks: int, policy: HealthPolicy):
        if n_blocks < 1:
            raise ValueError(f"HealthTracker needs >= 1 block; got "
                             f"{n_blocks}")
        self.policy = policy
        self.blocks = [BlockHealth() for _ in range(n_blocks)]
        self._rng = np.random.RandomState(policy.seed)
        self.revive_due: float = -np.inf

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    # -- routing mask --------------------------------------------------------

    def alive_mask(self) -> np.ndarray:
        return np.array([b.alive for b in self.blocks], bool)

    def dead_blocks(self) -> list[int]:
        return [m for m, b in enumerate(self.blocks) if not b.alive]

    def mark_dead(self, m: int, now: float) -> bool:
        """Retire block ``m`` from routing. Returns True if it was alive."""
        b = self.blocks[m]
        if not b.alive:
            return False
        b.alive = False
        b.retired_at = now
        self.revive_due = max(self.revive_due,
                              now + self.policy.revive_after_ms * 1e-3)
        return True

    def revive_all(self, now: float) -> list[int]:
        """Mark every dead block routable again (post checkpoint-restore);
        failure ledgers reset — the restored factors are known-good."""
        revived = self.dead_blocks()
        for m in revived:
            b = self.blocks[m]
            b.alive = True
            b.retired_at = None
            b.consecutive_failures = 0
        self.revive_due = -np.inf
        return revived

    def defer_revive(self, now: float) -> None:
        """Re-arm the revive timer after a failed attempt (e.g. a corrupt
        checkpoint) so pump doesn't hot-loop on a bad artifact."""
        self.revive_due = now + self.policy.revive_after_ms * 1e-3

    # -- evidence ------------------------------------------------------------

    def observe_latency(self, blocks, latency_ms: float) -> None:
        """Fold one flush's aggregate latency into every participating
        block's EMA. A persistent straggler participates only in slow
        flushes, so its EMA separates upward from blocks that also see
        fast, straggler-free flushes — which is what ``slowest_of`` keys
        timeout attribution on."""
        for m in blocks:
            self.blocks[int(m)].latency.update(latency_ms)

    def slowest_of(self, blocks) -> Optional[int]:
        """The participating block most implicated by latency evidence."""
        blocks = [int(m) for m in blocks if self.blocks[int(m)].alive]
        if not blocks:
            return None
        return max(blocks,
                   key=lambda m: self.blocks[m].latency.get(default=0.0))

    def record_failure(self, m: int, *, nonfinite: bool = False) -> bool:
        """Count one failure against block ``m``; True when its consecutive
        count crosses the retire threshold (the CALLER retires — policy
        actions stay in the scheduler)."""
        b = self.blocks[int(m)]
        b.n_failures += 1
        b.consecutive_failures += 1
        if nonfinite:
            b.n_nonfinite += 1
        return (b.alive and b.consecutive_failures
                >= self.policy.max_consecutive_failures)

    def record_success(self, blocks) -> None:
        for m in blocks:
            self.blocks[int(m)].consecutive_failures = 0

    # -- backoff -------------------------------------------------------------

    def backoff_ms(self, attempt: int) -> float:
        """Exponential backoff with seeded jitter for retry ``attempt``
        (0-based): ``base * 2^attempt * (1 ± jitter)``."""
        p = self.policy
        base = p.backoff_base_ms * (2.0 ** attempt)
        if p.backoff_jitter:
            base *= 1.0 + p.backoff_jitter * self._rng.uniform(-1.0, 1.0)
        return base

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        return {"n_blocks": self.n_blocks,
                "dead_blocks": self.dead_blocks(),
                "blocks": [b.snapshot() for b in self.blocks]}
