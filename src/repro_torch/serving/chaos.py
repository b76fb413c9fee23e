"""Deterministic fault injection for the serving runtime — port of
``repro.serving.chaos``.

Resilience claims that are only exercised by real failures are untestable
claims. This module makes every failure mode the health layer handles
REPRODUCIBLE: a frozen, seeded ``FaultPlan`` declares what goes wrong and
when (per-block straggle latency, block death, NaN posteriors, checkpoint
corruption, query bursts), and a ``FaultInjector`` instantiated from it is
attached to a tenant (``TenantScheduler.admit(..., chaos=...)``) where it
wraps scheduler dispatch:

* ``before_dispatch`` runs at the top of every flush attempt — it sleeps
  the declared straggle (through an injectable ``sleep``, so virtual-time
  tests advance a fake clock instead of wall time) and raises ``BlockDied``
  when a flush routes a real row at a block declared dead;
* ``poison`` runs on the flush outputs — it overwrites the rows routed at
  NaN-declared blocks with NaN, which is what the health layer's
  non-finite detection must catch. The outputs stay on the device: they
  are written with an index mask there (no host copy);
* ``corrupt`` deterministically flips bytes in a checkpoint artifact so
  the revive path's corruption handling (``serialize.CheckpointError``,
  never load) is testable;
* ``burst_at`` tells a traffic generator how many extra queries to slam in at
  a given step (admission-control pressure).

Everything is a pure function of (plan, flush index, seed): the same
FaultPlan replays the same failure schedule — the reference's byte picks
and flush indices included — which is what lets a test assert exact
recovery behavior.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch


class BlockDied(RuntimeError):
    """Injected hard failure: the flush routed a query at a block whose
    FaultPlan declares it dead. Carries the block id so the health layer
    can attribute the failure exactly."""

    def __init__(self, block: int, flush_index: int):
        self.block = int(block)
        self.flush_index = int(flush_index)
        super().__init__(f"injected failure: block {block} died "
                         f"(flush {flush_index})")


def _as_int_map(m: Mapping[int, float] | None) -> dict:
    return {} if m is None else {int(k): v for k, v in dict(m).items()}


def _active(sched, idx: int) -> bool:
    """True when a fail_at/nan_at schedule entry is active at flush ``idx``:
    a bare start index (permanent) or a half-open (start, stop) window."""
    if isinstance(sched, tuple):
        start, stop = sched
        return int(start) <= idx < int(stop)
    return idx >= int(sched)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One deterministic failure schedule (frozen + seeded).

    * ``straggle_ms`` — ``{block: added latency}``: every flush attempt in
      which the block participates (routes >= 1 real row) sleeps the
      declared extra milliseconds first — the paper's Sec. 6 straggler,
      serving-side. Multiple participating stragglers sleep the MAX (they
      straggle in parallel, the flush waits for the slowest).
    * ``fail_at`` — ``{block: flush index}`` or ``{block: (start, stop)}``:
      while active, any attempt routing a real row at the block raises
      ``BlockDied`` UNLESS the routing mask already excludes it — exactly a
      machine that stops answering until the health layer stops asking. A
      bare index is a permanent failure (active from there on); a
      half-open ``(start, stop)`` window is a transient one — the machine
      would answer again after ``stop``, which is what the
      revive-to-bitwise-recovery tests need.
    * ``nan_at`` — same scheduling forms: while active, rows routed at the
      block come back NaN (applied to the flush OUTPUT — the posterior the
      block "computed" is garbage, the program ran fine).
    * ``burst_at_steps`` — ``{step: n extra queries}`` for traffic generators.
    * ``seed`` — RNG stream for corruption byte picks.

    The flush index is the tenant's attempt counter maintained by the
    injector (every dispatch attempt increments it, retries included), so
    a schedule expressed in flush indices is reproducible run-to-run.
    """
    straggle_ms: Mapping[int, float] | None = None
    fail_at: Mapping[int, int] | None = None
    nan_at: Mapping[int, int] | None = None
    burst_at_steps: Mapping[int, int] | None = None
    seed: int = 0

    def burst_at(self, step: int) -> int:
        """Extra queries a traffic generator should inject at ``step``."""
        return _as_int_map(self.burst_at_steps).get(int(step), 0)


class FaultInjector:
    """Live injection state for one tenant: the FaultPlan plus the flush
    counter that advances its schedule. ``sleep`` is injectable so
    virtual-time tests advance a fake clock instead of wall time."""

    def __init__(self, plan: FaultPlan, *,
                 sleep: Callable[[float], None] = time.sleep):
        self.plan = plan
        self._sleep = sleep
        self._rng = np.random.RandomState(plan.seed)
        self.n_dispatches = 0
        self.n_injected_faults = 0

    # -- scheduler hooks -----------------------------------------------------

    def before_dispatch(self, assign: Optional[np.ndarray],
                        alive: Optional[np.ndarray]) -> None:
        """Run the pre-dispatch faults for one flush attempt. ``assign`` is
        the host-side routed block per real row (None for unrouted
        tenants: straggle applies to every block, death/NaN need routing);
        ``alive`` is the health layer's routing mask (None = all alive).
        Raises ``BlockDied`` only for a block the mask still routes to —
        once health has retired it, the tenant has stopped asking the dead
        machine and the fault no longer fires."""
        idx = self.n_dispatches
        self.n_dispatches += 1
        routed = (lambda m: True) if assign is None else \
            (lambda m: bool(np.any(assign == m)))
        routable = (lambda m: True) if alive is None else \
            (lambda m: bool(alive[m]))
        delay = 0.0
        for m, ms in _as_int_map(self.plan.straggle_ms).items():
            if routed(m) and routable(m):
                delay = max(delay, float(ms))
        if delay > 0:
            self._sleep(delay * 1e-3)
        for m, at in sorted(_as_int_map(self.plan.fail_at).items()):
            if _active(at, idx) and routed(m) and routable(m):
                self.n_injected_faults += 1
                raise BlockDied(m, idx)

    def poison(self, assign: Optional[np.ndarray], mean, var,
               alive: Optional[np.ndarray] = None):
        """Overwrite the rows routed at NaN-scheduled blocks with NaN —
        the non-finite posterior the health layer must detect. Operates on
        the flush outputs (tensors, on their device) and returns new ones;
        the index that gates the schedule is the attempt
        counter ``before_dispatch`` advanced. Rows whose block ``alive``
        already marks dead are spared: those rows were answered by the
        global posterior, not the faulty machine."""
        sched = _as_int_map(self.plan.nan_at)
        if not sched or assign is None:
            return mean, var
        idx = self.n_dispatches - 1     # the attempt just dispatched
        rows = np.zeros(len(assign), bool)
        for m, at in sched.items():
            if _active(at, idx) and (alive is None or bool(alive[m])):
                rows |= np.asarray(assign) == m
        if rows.any():
            mean, var = _nan_rows(mean, rows), _nan_rows(var, rows)
            self.n_injected_faults += 1
        return mean, var

    # -- artifact faults -----------------------------------------------------

    def corrupt(self, path, n_bytes: int = 8) -> None:
        """Deterministically flip ``n_bytes`` bytes spread through the file
        at ``path`` — a torn write / bit-rot checkpoint. The revive path
        must DETECT this (``serialize.CheckpointError``) and refuse to
        load; seeded byte picks make the corruption reproducible."""
        with open(path, "r+b") as fh:
            fh.seek(0, 2)
            size = fh.tell()
            if size == 0:
                return
            # skip the first 256 bytes: corrupting the zip local header of
            # the first entry is trivially detected; mid-payload flips are
            # the interesting (checksum-caught) case
            lo = min(256, size // 4)
            for off in sorted(self._rng.randint(lo, size, size=n_bytes)):
                fh.seek(int(off))
                b = fh.read(1)
                fh.seek(int(off))
                fh.write(bytes([b[0] ^ 0xFF]))
        self.n_injected_faults += 1

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        return {"n_dispatches": self.n_dispatches,
                "n_injected_faults": self.n_injected_faults}


def _nan_rows(a: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
    """A copy of ``a`` with the rows ``rows[:len(a)]`` set to NaN, on its
    device (an index mask: no sync)."""
    mask = torch.as_tensor(rows[:len(a)]).to(a.device)
    return a.masked_fill(mask, float("nan"))


def poison_state(state, block: int, fields: tuple[str, ...] = ("C_L", "Wy")):
    """A NaN-poisoned copy of a PIC state: block ``block``'s cached factors
    are overwritten with NaN — the in-memory analogue of a machine whose
    local factors went bad (bit flips, a partial in-place update). Swapping
    this into a tenant makes every query routed at the block produce NaN
    posteriors ORGANICALLY (through the real compute path, not the output
    poisoner), which the health ladder must then detect, retire, and
    recover from via checkpoint. The poisoned fields are clones of the
    state's tensors, on their device; the rest are shared."""
    repl = {}
    for f in fields:
        a = getattr(state, f).clone()
        a[int(block)] = float("nan")
        repl[f] = a
    return state._replace(**repl)
