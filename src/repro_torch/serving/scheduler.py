"""Weighted-deadline dispatch over per-tenant microbatch queues — port of
``repro.serving.scheduler``.

One process, many tenants, one dispatch loop. Each tenant keeps its own
queue, tickets, and flush policy (its ``GPServer`` semantics, unchanged);
what centralizes is WHEN queues drain: ``pump()`` replaces per-server
polling with earliest-weighted-deadline-first over every admitted tenant.

A tenant's oldest ticket is DUE at

    due = t_submit(oldest) + effective_deadline_ms / 1e3 / weight

so ``weight`` scales urgency (a weight-2 tenant's staleness budget is
effectively halved) without touching the declared budget, and ``weight=1``
with a fixed deadline reproduces ``GPServer`` exactly — the bitwise single-
tenant equivalence rests on that identity. ``pump()`` flushes EVERY due
tenant, ordered by (due, admission seq): a due tenant is never passed over
for a heavier-weighted one, which is the no-starvation property — skewed
weights reorder service, they cannot deny it.

The other two policies hang off the same loop:

* admission control — ``max_pending`` caps a tenant's queue depth at
  submit time; ``overflow="reject"`` raises ``AdmissionError`` (the caller
  holds no ticket), ``overflow="shed_oldest"`` drops the oldest queued
  ticket to admit the newest (the shed ticket will never resolve). Both
  are counted (``n_rejected``/``n_shed``) — load shedding that doesn't
  show up in stats is an outage that doesn't show up in monitoring.
* adaptive flusher — with an ``AdaptiveDeadline`` policy the effective
  deadline tracks ``gain x EMA(interarrival)`` clipped to
  [floor_ms, declared budget]: brisk tenants flush at the cadence their
  own traffic sets (low staleness), sparse tenants wait out the full
  budget (maximum batching). See ``registry.AdaptiveDeadline``.
* self-healing dispatch — tenants admitted with ``health=`` run every
  flush through ``_dispatch``'s policy ladder (``serving/health.py``):
  latency and output-finiteness evidence is attributed per block, failed
  flushes retry with exponential backoff (re-routing around blocks retired
  in between), a block crossing the failure threshold is auto-retired from
  ROUTING ONLY (its stranded queries served degraded from the global
  posterior — no new callable, every ticket still answered), and ``pump``
  background-revives retired blocks from the last good ``save_store``
  checkpoint. ``chaos=`` attaches deterministic fault injection
  (``serving/chaos.py``) for exercising all of the above.

Everything is driven by one injectable ``clock`` (seconds, monotonic) and
one injectable ``sleep`` (retry backoff) so scheduling and chaos tests run
on virtual time.

Asynchrony. A flush leaves its tickets' (mean, var) on the device as views
of the flush's one output and records one ``torch.cuda.Event`` after it;
``result`` waits on that event and ``sync`` on every pending one, and
nothing else blocks (no ``torch.cuda.synchronize`` per submit). The
health path reads finiteness on the device (``torch.isfinite``) and copies
only the flush's bad-row mask to the host: one sync per attempt, after
which the latency sample covers the device work. Results stay device
tensors on every path.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import api, clustering
from repro_torch.serving.registry import Tenant, TenantRegistry
from repro_torch.serving.stats import rollup


def _host_point(x) -> np.ndarray:
    """One query point as a host array: a tensor is copied to the host (a
    CUDA tensor costs one device-to-host copy), an array kept."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _FlushFault(Exception):
    """Internal: a health-dispatch attempt produced evidence bad enough to
    retry (non-finite healthy rows). Never escapes ``_dispatch``."""


class AdmissionError(RuntimeError):
    """Submit refused: the tenant's queue is at ``max_pending`` under the
    ``reject`` overflow policy. The request holds NO ticket."""


class TenantScheduler:
    """Central dispatch loop over a ``TenantRegistry``'s tenant queues.

    The request path mirrors ``GPServer`` per tenant — ``submit`` returns a
    ticket (per-tenant namespace, starting at 0), size/deadline/manual
    triggers drain the queue through one padded plan dispatch, ``result``
    blocks on exactly one ticket — plus the cross-tenant policies described
    in the module docstring. ``GPServer`` itself is a one-tenant client of
    this class.
    """

    def __init__(self, registry: TenantRegistry | None = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 log_len: int = 512):
        self.registry = registry if registry is not None else TenantRegistry()
        self._clock = clock
        self._sleep = sleep
        # (tenant_id, trigger, n_tickets) per flush, newest last — the
        # ordering the property tests (and a human debugging priority
        # inversions) inspect
        self.dispatch_log: deque = deque(maxlen=log_len)

    # -- membership (registry passthrough + drain semantics) ----------------

    def admit(self, tenant_id: str, model, spec=None, **kw) -> Tenant:
        """``TenantRegistry.admit`` — see there for the knobs."""
        return self.registry.admit(tenant_id, model, spec, **kw)

    def admit_from_checkpoint(self, tenant_id: str, path, **kw) -> Tenant:
        return self.registry.admit_from_checkpoint(tenant_id, path, **kw)

    def evict(self, tenant_id: str, *, drain: bool = True) -> Tenant:
        """Remove a tenant. ``drain=True`` (default) flushes its pending
        tickets first so already-promised work resolves into the returned
        record's ``ready`` map; ``drain=False`` abandons them."""
        if drain:
            self.flush(tenant_id)
        return self.registry.evict(tenant_id)

    # -- request path --------------------------------------------------------

    def submit(self, tenant_id: str, x) -> int:
        """Enqueue one query point (d,) for a tenant; returns its ticket.

        Points are staged on the host (NumPy), so that assembling a
        microbatch never touches the device: the plan then makes one
        host-to-device copy per flush. ``x`` may be a numpy array or a
        tensor; a CUDA tensor costs one copy to the host (and a sync) here.
        Admission control runs BEFORE enqueue; size/deadline triggers
        after, exactly as in ``GPServer.submit``."""
        t = self.registry.get(tenant_id)
        now = self._clock()
        if t.max_pending is not None and len(t.queue) >= t.max_pending:
            if t.overflow == "reject":
                t.stats.n_rejected += 1
                raise AdmissionError(
                    f"tenant {tenant_id!r}: queue depth {len(t.queue)} at "
                    f"max_pending={t.max_pending} (reject policy); pump or "
                    f"flush before resubmitting")
            t.queue.pop(0)
            t.stats.n_shed += 1
        t.stats.observe_arrival(now, t.last_arrival)
        t.last_arrival = now
        ticket = t.next_ticket
        t.next_ticket += 1
        t.queue.append((ticket, _host_point(x), now))
        if len(t.queue) >= t.max_batch:
            self._flush(t, "size")
        elif self._past_deadline(t, now):
            self._flush(t, "deadline")
        return ticket

    def pending(self, tenant_id: str) -> int:
        return self.registry.get(tenant_id).pending

    def oldest_age_ms(self, tenant_id: str) -> float:
        """Age of a tenant's oldest pending ticket (0.0 when empty)."""
        t = self.registry.get(tenant_id)
        if not t.queue:
            return 0.0
        return (self._clock() - t.queue[0][2]) * 1e3

    # -- deadline machinery --------------------------------------------------

    def effective_deadline_ms(self, tenant_id: str) -> Optional[float]:
        """The deadline actually in force for a tenant right now: the
        declared ``flush_deadline_ms``, tightened by the adaptive policy
        when one is set and interarrival data exists."""
        return self._eff_ms(self.registry.get(tenant_id))

    def _eff_ms(self, t: Tenant) -> Optional[float]:
        base = t.flush_deadline_ms
        if base is None or t.adaptive is None:
            return base
        ia = t.stats.interarrival.value
        if ia is None:
            return base
        return min(base, max(t.adaptive.floor_ms, t.adaptive.gain * ia * 1e3))

    def _due_at(self, t: Tenant) -> Optional[float]:
        """Absolute weighted due time of a tenant's oldest ticket (None
        when it has no deadline or an empty queue)."""
        eff = self._eff_ms(t)
        if eff is None or not t.queue:
            return None
        return t.queue[0][2] + eff * 1e-3 / t.weight

    def _past_deadline(self, t: Tenant, now: float) -> bool:
        due = self._due_at(t)
        return due is not None and now >= due

    def pump(self) -> int:
        """Deadline trigger: flush every tenant whose weighted due time has
        passed, earliest-weighted-deadline first (admission order breaks
        ties deterministically). Call from the serving loop whenever idle.
        Returns total tickets resolved (0 if nothing was due)."""
        now = self._clock()
        due = []
        for t in self.registry.tenants():
            if (t.health is not None and t.health.dead_blocks()
                    and t.health.policy.checkpoint is not None
                    and now >= t.health.revive_due):
                self._try_revive(t, now)
            d = self._due_at(t)
            if d is not None and now >= d:
                due.append((d, t.seq, t))
        due.sort(key=lambda e: (e[0], e[1]))
        return sum(self._flush(t, "deadline") for _, _, t in due)

    def _try_revive(self, t: Tenant, now: float) -> bool:
        """Background revive: reload the tenant's last known-good
        ``save_store`` checkpoint and swap it in via ``commit_store`` —
        pending tickets flush (degraded) against the old posterior FIRST,
        then the restored store's state rebinds on the same callables and
        the dead blocks return to routing. A corrupt/truncated artifact is
        detected (``serialize.CheckpointError``) and NEVER loaded: the
        tenant stays degraded-but-correct and the revive timer re-arms."""
        from repro_torch.core import serialize
        try:
            store = serialize.load_store(
                t.health.policy.checkpoint,
                kfn=t.store.kfn if t.store is not None else t.model.kfn,
                runner=t.store.runner if t.store is not None else None,
                device=api._state_device(t.model.state))
        except serialize.CheckpointError:
            t.stats.n_revive_failures += 1
            t.health.defer_revive(self._clock())
            return False
        self.commit_store(t.tenant_id, store)
        revived = t.health.revive_all(self._clock())
        t.stats.n_revives += 1
        self.dispatch_log.append((t.tenant_id, "revive", len(revived)))
        return True

    def flush(self, tenant_id: str | None = None, *,
              trigger: str = "manual") -> int:
        """Drain one tenant's queue (or every tenant's, ``tenant_id=None``)
        with one padded plan dispatch each. Returns tickets resolved.
        Dispatch is asynchronous — nothing blocks until ``result``/``sync``
        (the health path syncs once per attempt, see ``_dispatch``)."""
        if tenant_id is None:
            return sum(self._flush(t, trigger)
                       for t in self.registry.tenants())
        return self._flush(self.registry.get(tenant_id), trigger)

    def _flush(self, t: Tenant, trigger: str) -> int:
        if trigger not in ("size", "deadline", "manual"):
            # validate before touching the queue: a bad trigger must not
            # destroy pending tickets after predict but before resolution
            raise ValueError(f"unknown flush trigger {trigger!r}; "
                             f"expected 'size', 'deadline', or 'manual'")
        if not t.queue:
            return 0
        queue = t.queue
        U = np.stack([x for _, x, _ in queue])
        tickets = [tk for tk, _, _ in queue]
        # predict before clearing: a failing batch (e.g. one malformed
        # point) must not destroy the other pending tickets
        mean, var, deg = self._dispatch(t, U)
        now = self._clock()
        for _, _, t_sub in queue:
            t.stats.staleness.record((now - t_sub) * 1e3)
        t.stats.observe_flush(
            trigger, t.plan.stats.last_g if t.spec.routed else None)
        if deg is not None and deg.any():
            t.stats.n_degraded_flushes += 1
            t.stats.n_degraded_rows += int(deg.sum())
        t.queue.clear()
        self.dispatch_log.append((t.tenant_id, trigger, len(tickets)))
        event = None
        if mean.is_cuda:
            event = torch.cuda.Event()
            event.record()
        # each ticket's (mean, var) is a view of the flush's one output
        for i, (tk, m, v) in enumerate(zip(tickets, mean.unbind(0),
                                           var.unbind(0))):
            t.ready[tk] = (m, v)
            t.ready_events[tk] = event
            t.ready_degraded[tk] = bool(deg[i]) if deg is not None else False
        # bound memory against abandoned tickets: evict oldest results
        # (dicts preserve insertion order) beyond max_ready
        while len(t.ready) > t.max_ready:
            dropped = next(iter(t.ready))
            del t.ready[dropped]
            t.ready_degraded.pop(dropped, None)
            t.ready_events.pop(dropped, None)
            t.stats.n_evicted += 1
        return len(tickets)

    def done(self, tenant_id: str, ticket: int) -> bool:
        """True when a ticket's flush was dispatched (device values may
        still be in flight; ``result``/``sync`` do the blocking)."""
        return ticket in self.registry.get(tenant_id).ready

    def sync(self, tenant_id: str | None = None) -> None:
        """Block until every already-flushed result (of one tenant, or of
        all) has materialized — a measurement/shutdown barrier: one wait
        per pending flush's event."""
        tenants = (self.registry.tenants() if tenant_id is None
                   else [self.registry.get(tenant_id)])
        events = {id(e): e for t in tenants for e in t.ready_events.values()
                  if e is not None}
        for e in events.values():
            e.synchronize()

    def result(self, tenant_id: str, ticket: int):
        """(mean, var) for a tenant's ticket, device tensors; flushes its
        queue if the ticket is still pending. The only point this layer
        blocks on the device: it waits on the ticket's flush event."""
        t = self.registry.get(tenant_id)
        if ticket not in t.ready:
            self._flush(t, "manual")
        try:
            out = t.ready.pop(ticket)
        except KeyError:
            raise KeyError(
                f"ticket {ticket}: unknown, already collected, shed, or "
                f"evicted (max_ready={t.max_ready})") from None
        t.ready_degraded.pop(ticket, None)
        event = t.ready_events.pop(ticket, None)
        if event is not None:
            event.synchronize()
        return out

    def collect(self, tenant_id: str, ticket: int):
        """(mean, var, degraded) for a tenant's ticket — ``result`` plus
        the per-query degradation flag: True when the row's routed block
        was health-retired and the answer came from the global S-space
        posterior (bounded accuracy loss, see serving/health.py). Callers
        that ignore the flag can keep using ``result``."""
        t = self.registry.get(tenant_id)
        if ticket not in t.ready:
            self._flush(t, "manual")
        degraded = t.ready_degraded.get(ticket, False)
        mean, var = self.result(tenant_id, ticket)
        return mean, var, degraded

    # -- batch path ----------------------------------------------------------

    def predict(self, tenant_id: str, U):
        """Bucket-padded (mean, var) over a caller-held (u, d) batch for one
        tenant — one plan dispatch, no queue involved; device tensors, in
        flight until the caller reads them."""
        return self._predict(self.registry.get(tenant_id), U)

    def _predict(self, t: Tenant, U, block_alive=None):
        before = t.plan.stats.n_padded_rows
        if t.spec.routed:
            mean, var = t.plan.routed_diag(U, block_alive=block_alive)
        elif block_alive is not None:
            raise ValueError(f"tenant {t.tenant_id!r}: block_alive routing "
                             f"masks apply to routed tenants only")
        else:
            mean, var = t.plan.diag(U)
        t.stats.n_batches += 1
        t.stats.n_padded_rows += t.plan.stats.n_padded_rows - before
        return mean, var

    def _dispatch(self, t: Tenant, U):
        """One flush's (mean, var, degraded) through the self-healing policy
        ladder. Without ``health``/``chaos`` this IS ``_predict`` — the
        zero-overhead fast path every pre-existing tenant takes.

        With health, the loop walks the ladder per attempt: route host-side
        (same nearest-centroid float path as the plan — blame attribution
        must agree with the device scatter), dispatch with the current
        routing mask, read finiteness on the device and copy the (u,)
        bad-row mask to the host (one sync: the latency sample then covers
        the device work), attribute evidence, and either accept or retry
        after a seeded backoff. Every retry past the policy budget
        force-retires the blocks it blamed, so each extra attempt shrinks the
        set of blocks that can fail — the loop provably terminates with
        every ticket answered (worst case: all blocks retired, the whole
        flush served degraded from the global posterior). Exceptions never
        escape a health-managed dispatch."""
        h, c = t.health, t.chaos
        if h is None and c is None:
            mean, var = self._predict(t, U)
            return mean, var, None
        from repro_torch.serving.chaos import BlockDied
        max_retries = h.policy.max_retries if h is not None else 0
        attempt = 0
        while True:
            alive = h.alive_mask() if h is not None else None
            assign = None
            if t.spec.routed:
                # the plan's host copy of the centroids (a routed plan is
                # the PIC family's, which reads them once per state)
                assign = clustering.nearest_center_np(
                    U, t.plan._centroids_host)
            participating = ([] if assign is None else
                             sorted({int(m) for m in assign
                                     if alive is None or alive[m]}))
            t0 = self._clock()
            try:
                if c is not None:
                    c.before_dispatch(assign, alive)
                mean, var = self._predict(t, U, block_alive=alive)
                if c is not None:
                    mean, var = c.poison(assign, mean, var, alive)
                # finiteness on the device, the (u,) mask to the host: the
                # one sync of the attempt, so the latency covers the work
                bad = (~(torch.isfinite(mean) & torch.isfinite(var))
                       ).cpu().numpy()
                latency_ms = (self._clock() - t0) * 1e3
                # the routed plan keeps this mask on the host already
                deg = t.plan.stats.last_degraded if t.spec.routed else None
                if h is None:
                    return mean, var, deg
                h.observe_latency(participating, latency_ms)
                if deg is not None:
                    bad &= ~deg       # degraded rows came from the global
                                      # posterior, not a routed block
                if bad.any():
                    blamed = (participating if assign is None else
                              sorted({int(m) for m in assign[bad]
                                      if alive is None or alive[m]}))
                    if blamed:
                        t.stats.n_nonfinite_flushes += 1
                        raise _FlushFault(blamed)
                    # non-finite with nothing left to blame (the global
                    # posterior itself is bad): retrying cannot help —
                    # return what we have rather than loop or raise
                    t.stats.n_nonfinite_flushes += 1
                    return mean, var, deg
                p = h.policy
                if (p.flush_timeout_ms is not None
                        and latency_ms > p.flush_timeout_ms):
                    # a timeout is a LATENCY fault on a valid posterior:
                    # accept the result, count the evidence against the
                    # participating block the latency EMAs most implicate
                    t.stats.n_timeout_flushes += 1
                    culprit = h.slowest_of(participating)
                    if culprit is not None and h.record_failure(culprit):
                        if h.mark_dead(culprit, self._clock()):
                            t.stats.n_auto_retired += 1
                else:
                    h.record_success(participating)
                return mean, var, deg
            except (BlockDied, _FlushFault) as e:
                blamed = ([e.block] if isinstance(e, BlockDied)
                          else list(e.args[0]))
                if h is None:
                    raise    # chaos without health: faults hit the caller
                             # raw (the un-healed control experiment)
                now = self._clock()
                for m in blamed:
                    threshold = h.record_failure(
                        m, nonfinite=isinstance(e, _FlushFault))
                    if (threshold or attempt >= max_retries) \
                            and h.mark_dead(m, now):
                        t.stats.n_auto_retired += 1
                if attempt < max_retries:
                    self._sleep(h.backoff_ms(attempt) * 1e-3)
                t.stats.n_retries += 1
                attempt += 1

    # -- state lifecycle -----------------------------------------------------

    def swap_state(self, tenant_id: str, state: Any) -> None:
        """Hot-swap one tenant's posterior (``TenantRegistry.rebind``):
        callables are reused at unchanged shapes, other tenants are
        untouched. Does NOT flush — tickets already queued resolve against
        the new state; use ``commit_store`` for flush-then-swap."""
        self.registry.rebind(tenant_id, state)

    def commit_store(self, tenant_id: str, store) -> None:
        """Swap in a mutated store: pending tickets flush FIRST so every
        ticket resolves against the posterior it was submitted under.
        Atomic: rebind (and its routed-centroid validation) runs before the
        store is reassigned, so a rejected state leaves the tenant on the
        old store AND the old posterior."""
        t = self.registry.get(tenant_id)
        self._flush(t, "manual")
        self.registry.rebind(tenant_id, store.to_state())
        t.store = store
        t.stats.n_updates += 1

    # -- observability -------------------------------------------------------

    def stats(self, tenant_id: str):
        return self.registry.stats(tenant_id)

    def rollup(self) -> dict:
        """Fleet view: per-tenant snapshots + aggregate totals
        (``serving.stats.rollup`` over the registry)."""
        return rollup(self.registry.stats_by_tenant())
