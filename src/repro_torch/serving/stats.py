"""Per-tenant serving observability: counters, staleness percentiles,
G-ladder usage, and fleet rollups — port of ``repro.serving.stats`` (host
side, as the reference; ``Reservoir`` draws from the same seeded
``numpy.random.RandomState``, so its percentiles match draw for draw).

This is the serving-side generalization of ``runtime/monitor.py``'s
TrainMonitor/FailureDetector pattern: the monitor tracks ONE training
loop's EMAs and stalls; a serving fleet multiplexes many tenants, each
with its own traffic shape, so the stats object is per-tenant and the
rollup aggregates across the registry the way a fleet controller's
per-worker stats rollup does.

* ``ServeStats``   — one tenant's (or one ``GPServer``'s) counters. The
  flush-trigger split (size/deadline/manual) says WHAT drained the queue;
  ``n_shed``/``n_rejected`` account for admission control; ``g_hist``
  records which routed overflow programs actually ran (the ladder usage
  the plan's lazy-overflow design is about); ``staleness`` holds
  queue-time samples (submit -> flush dispatch, ms) for p50/p99 export.
* ``Reservoir``    — bounded percentile tracker (seeded-deterministic
  replacement above capacity, so long-running tenants keep a stable-memory
  latency profile instead of an unbounded sample list).
* ``interarrival`` — ``runtime.monitor.Ema`` over observed per-tenant
  interarrival times; the scheduler's adaptive flusher reads it to tune
  each tenant's effective deadline.
* ``rollup``       — fleet view: per-tenant snapshots + aggregate totals,
  what an exporter would scrape.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.runtime.monitor import Ema


class Reservoir:
    """Bounded sample store with deterministic reservoir replacement.

    Percentiles over ALL seen samples would need unbounded memory; a
    serving tenant lives for days. Classic reservoir sampling keeps a
    uniform sample of the stream in O(cap) memory; the RNG is seeded so
    two runs of the same traffic report identical percentiles."""

    def __init__(self, cap: int = 4096, seed: int = 0):
        if cap < 1:
            raise ValueError(f"Reservoir cap must be >= 1; got {cap}")
        self.cap = cap
        self._rng = np.random.RandomState(seed)
        self._buf: list[float] = []
        self.n_seen = 0

    def record(self, value: float) -> None:
        self.n_seen += 1
        if len(self._buf) < self.cap:
            self._buf.append(float(value))
        else:
            j = self._rng.randint(self.n_seen)
            if j < self.cap:
                self._buf[j] = float(value)

    def percentile(self, q: float) -> Optional[float]:
        if not self._buf:
            return None
        return float(np.percentile(self._buf, q))

    def snapshot(self) -> dict:
        return {"n": self.n_seen,
                "p50": self.percentile(50.0),
                "p99": self.percentile(99.0)}


@dataclasses.dataclass
class ServeStats:
    """Counters for one serving tenant (also ``GPServer.stats`` — the
    single-tenant server is a one-tenant client of the same runtime)."""
    n_requests: int = 0
    n_batches: int = 0
    n_padded_rows: int = 0
    n_state_swaps: int = 0
    n_updates: int = 0        # store-backed assimilate/retire/revive swaps
    n_evicted: int = 0
    # flush-trigger split: what actually drained the queue
    n_size_flushes: int = 0
    n_deadline_flushes: int = 0
    n_manual_flushes: int = 0
    # routed flushes served by the G=0 executable (no overflow dispatch)
    n_g0_flushes: int = 0
    # admission control: requests turned away (reject policy) / oldest
    # queued tickets dropped to admit newer ones (shed_oldest policy)
    n_rejected: int = 0
    n_shed: int = 0
    # self-healing ladder (serving/health.py): degraded serving, retries,
    # auto-retires, and checkpoint revives. All ints, so they flow into
    # snapshot() and the fleet rollup automatically.
    n_degraded_rows: int = 0      # rows answered from the global posterior
    n_degraded_flushes: int = 0   # flushes with >= 1 degraded row
    n_retries: int = 0            # dispatch attempts retried (backoff slept)
    n_auto_retired: int = 0       # blocks health-retired from routing
    n_revives: int = 0            # successful checkpoint revives
    n_revive_failures: int = 0    # revive attempts refused (bad checkpoint)
    n_nonfinite_flushes: int = 0  # flushes with non-finite healthy rows
    n_timeout_flushes: int = 0    # flushes over the latency budget
    # routed overflow-ladder usage: group count g -> flushes served by the
    # g-group program (which programs of the ladder traffic exercises)
    g_hist: dict = dataclasses.field(default_factory=dict)
    # queue time submit -> flush dispatch (ms); p50/p99 via snapshot()
    staleness: Reservoir = dataclasses.field(default_factory=Reservoir)
    # EMA of per-tenant interarrival seconds (adaptive flusher's input)
    interarrival: Ema = dataclasses.field(
        default_factory=lambda: Ema(alpha=0.8))

    def observe_arrival(self, now: float, last_arrival: Optional[float]
                        ) -> None:
        self.n_requests += 1
        if last_arrival is not None:
            self.interarrival.update(max(now - last_arrival, 0.0))

    def observe_flush(self, trigger: str, last_g: Optional[int]) -> None:
        field = {"size": "n_size_flushes", "deadline": "n_deadline_flushes",
                 "manual": "n_manual_flushes"}[trigger]
        setattr(self, field, getattr(self, field) + 1)
        if last_g is not None:
            self.g_hist[last_g] = self.g_hist.get(last_g, 0) + 1
            if last_g == 0:
                self.n_g0_flushes += 1

    @property
    def n_flushes(self) -> int:
        return (self.n_size_flushes + self.n_deadline_flushes
                + self.n_manual_flushes)

    def snapshot(self) -> dict:
        """Export view: plain scalars + staleness percentiles, the shape an
        exporter/bench scrapes (no live objects leak out)."""
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
               if f.name not in ("g_hist", "staleness", "interarrival")}
        out["n_flushes"] = self.n_flushes
        out["g_hist"] = dict(sorted(self.g_hist.items()))
        out["staleness_ms"] = self.staleness.snapshot()
        ia = self.interarrival.value
        out["interarrival_ms"] = None if ia is None else ia * 1e3
        return out


def rollup(stats_by_tenant: dict) -> dict:
    """Fleet view over ``{tenant_id: ServeStats}``: per-tenant snapshots
    plus aggregate counter totals (the controller/per-worker stats-rollup
    shape). Percentiles are per-tenant only — pooling latency samples
    across tenants with different traffic would manufacture a meaningless
    fleet p99."""
    tenants = {tid: st.snapshot() for tid, st in stats_by_tenant.items()}
    totals: dict = {}
    for snap in tenants.values():
        for k, v in snap.items():
            if isinstance(v, int):
                totals[k] = totals.get(k, 0) + v
    return {"tenants": tenants, "totals": totals,
            "n_tenants": len(tenants)}
