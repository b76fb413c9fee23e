"""Real-time microbatched GP prediction serving — single-tenant front-end;
port of ``repro.launch.gp_serve``.

The paper's headline claim is that low-rank parallel GPs make *real-time*
prediction possible. The serving-side realization (core/api.py two-phase
architecture):

* the expensive factors live in a cached posterior state (fit once, or
  streamed through an attached ``api.StateStore``);
* everything decided PER DEPLOYMENT — kernel spec, query tile, bucket
  ladder, routed dispatch, backend caches, overflow-program ladder — lives
  in an ``api.ServeSpec``, built once into an ``api.ServePlan``
  (``GPMethod.plan``). The server is a thin client: queueing, triggers,
  tickets and the streaming lifecycle are the runtime's; every prediction
  goes through ``plan.diag`` / ``plan.routed_diag``;
* incoming query points are staged on the host and padded to the plan's
  bucket ladder, so ONE dispatch (one host-to-device copy) serves the whole
  microbatch;
* flushes trigger on **size** (queue reaches ``max_batch``) or on **age**
  (oldest pending ticket exceeds ``flush_deadline_ms`` at the next
  ``pump()``), so p99 latency at low arrival rates is bounded by the
  deadline instead of by how long the queue takes to fill;
* flushes dispatch asynchronously: the predict and the per-ticket views go
  onto the CUDA stream, one event is recorded per flush, and nothing blocks
  until a ticket is resolved (``result`` waits on its flush's event), so
  device work overlaps with further submits. Results are device tensors;
* with ``routed=True`` (pPIC/PIC states carrying block centroids) the plan
  routes each flush's staged batch host-side once; that single assignment
  both selects the matching overflow program — balanced flushes run the
  G=0 program (``ServeStats.n_g0_flushes`` counts them) — and drives the
  device-side scatter, while each ticket's posterior stays invariant to
  what else arrived in the same microbatch (Remark 2);
* the state is hot-swappable: after an incremental-store update (or a
  refit) ``swap_state`` REBINDS the plan — the same callables serve the new
  posterior (``PlanStats.n_traces`` does not grow);
* with an attached ``api.StateStore`` the server owns the full streaming
  lifecycle: ``update(X_new, y_new)`` assimilates + hot-swaps,
  ``retire_machine``/``revive_machine`` fold machines out/in, and
  ``checkpoint``/``swap_from_checkpoint`` persist/restore the posterior —
  plus ``checkpoint_store``/``restore_store`` for the store itself
  (``core.serialize``, the reference's versioned npz; the ``ServeSpec``
  rides along so a restarted fleet member can reconstruct the whole
  deployment from one artifact).

``GPServer`` is a ONE-TENANT CLIENT of ``serving.TenantScheduler``: the
queue, triggers, tickets, admission hooks and stats all live in the
scheduler/registry; the server contributes only the single-tenant
ergonomics (no tenant_id on any call) and the store/checkpoint lifecycle.
Multi-tenant equivalence rests on this — serving a tenant through the
shared runtime IS serving it through a GPServer, bitwise.

The server runs wherever its model's state lives (the CUDA card, unless
the model was fitted with ``device="cpu"``); checkpoints it restores land
on that device.
"""
from __future__ import annotations

import time
from typing import Any, Callable

from repro_torch.core import api, serialize
from repro_torch.serving import ServeStats, TenantScheduler  # noqa: F401

# the ladder is spec-owned (core/api.py); re-exported, as the reference does
default_buckets = api.default_buckets


class GPServer:
    """Microbatching front-end over a ``FittedGP`` — a thin single-tenant
    client of the shared serving runtime (``repro_torch.serving``).

    ``submit`` enqueues query points and returns a ticket; ``flush`` runs one
    predict over the padded queue and resolves every ticket to a
    (mean, var) pair of device tensors. The queue drains on three triggers:

    * size     — ``submit`` auto-flushes when the queue reaches ``max_batch``;
    * deadline — when ``flush_deadline_ms`` is set, any ``submit``/``pump``
      that observes the oldest pending ticket older than the deadline flushes
      immediately (call ``pump()`` from the serving loop's idle path);
    * manual   — ``flush()``/``result()`` on a still-queued ticket.

    ``predict`` is the synchronous path for a caller-held batch (still
    bucket-padded, still amortized). ``clock`` is injectable for tests and
    simulation (seconds, monotonic).

    Construction: pass ``spec=api.ServeSpec(...)`` for the full serving
    policy, or the legacy keywords (``max_batch``/``buckets``/``routed``/
    ``block_q``), which assemble a spec. The plan is built once at admission
    and rebound on every state swap.

    ``health=`` (True or a ``serving.HealthPolicy``) opts a routed server
    into self-healing dispatch — per-block latency/finiteness tracking,
    retry with backoff, auto-retire of failing blocks from routing (their
    queries served degraded from the global posterior, flagged via
    ``collect``), and background checkpoint revive. ``chaos=`` (a
    ``serving.FaultPlan``/``FaultInjector``) attaches deterministic fault
    injection for tests and benches. ``sleep`` is the injectable retry
    backoff (virtual-time chaos tests pass a fake).
    """

    _TENANT = "default"

    def __init__(self, model: api.FittedGP, *, max_batch: int = 64,
                 buckets: tuple[int, ...] | None = None,
                 max_ready: int = 65536,
                 flush_deadline_ms: float | None = None,
                 routed: bool = False,
                 store: api.StateStore | None = None,
                 block_q: int | None = None,
                 spec: api.ServeSpec | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 health: Any = None,
                 chaos: Any = None):
        if spec is None:
            spec = api.ServeSpec(block_q=block_q, max_batch=max_batch,
                                 buckets=buckets, routed=routed)
        else:
            # an explicit spec OWNS the serving policy: a legacy kwarg that
            # disagrees must fail loudly, not be silently dropped (e.g.
            # routed=True alongside a non-routed spec would silently serve
            # the composition-DEPENDENT positional path)
            if routed or buckets is not None or block_q is not None or (
                    max_batch != 64 and (spec.max_batch is not None
                                         or spec.buckets is not None)):
                raise ValueError(
                    "GPServer got both spec= and legacy serving kwargs "
                    "(routed/buckets/block_q/max_batch); declare the "
                    "policy inside api.ServeSpec(...)")
        self._sched = TenantScheduler(clock=clock, sleep=sleep)
        self._t = self._sched.admit(
            self._TENANT, model, spec, store=store,
            flush_deadline_ms=flush_deadline_ms, max_ready=max_ready,
            max_batch=max_batch, health=health, chaos=chaos)

    # -- tenant-record views (the record is the single source of truth) ------

    @property
    def spec(self) -> api.ServeSpec:
        return self._t.spec

    @property
    def model(self) -> api.FittedGP:
        return self._t.model

    @property
    def plan(self) -> api.ServePlan:
        return self._t.plan

    @property
    def store(self) -> api.StateStore | None:
        return self._t.store

    @property
    def stats(self) -> ServeStats:
        return self._t.stats

    @property
    def routed(self) -> bool:
        return self._t.spec.routed

    @property
    def _device(self):
        """The device the served state lives on (checkpoints land there)."""
        return api._state_device(self._t.model.state)

    @property
    def max_batch(self) -> int:
        return self._t.max_batch

    @property
    def max_ready(self) -> int:
        return self._t.max_ready

    @property
    def block_q(self) -> int:
        return self._t.plan.block_q

    @property
    def buckets(self):
        return self._t.plan.buckets

    @property
    def flush_deadline_ms(self) -> float | None:
        return self._t.flush_deadline_ms

    @flush_deadline_ms.setter
    def flush_deadline_ms(self, value: float | None) -> None:
        self._t.flush_deadline_ms = value

    # -- request path -------------------------------------------------------

    def submit(self, x) -> int:
        """Enqueue one query point (d,); returns a ticket for ``result``.

        Points are staged on the host (NumPy), so assembling a microbatch
        never touches the device. ``x`` may be a numpy array or a tensor; a
        CUDA tensor costs one copy to the host (and a sync)."""
        return self._sched.submit(self._TENANT, x)

    @property
    def pending(self) -> int:
        return self._t.pending

    def oldest_age_ms(self) -> float:
        """Age of the oldest pending ticket (0.0 when the queue is empty)."""
        return self._sched.oldest_age_ms(self._TENANT)

    def pump(self) -> int:
        """Deadline trigger: flush if the oldest pending ticket is past
        ``flush_deadline_ms``. Call from the serving loop whenever idle.
        Returns the number of tickets resolved (0 if nothing was due)."""
        return self._sched.pump()

    def flush(self, *, trigger: str = "manual") -> int:
        """Serve the queue with one padded plan dispatch.

        Dispatch is asynchronous: the predict call and the per-ticket views
        go onto the CUDA stream without blocking, with one event recorded
        after them; the host returns to accepting submits immediately and
        each ticket is waited for at ``result`` time. Returns the number of
        tickets resolved.
        """
        return self._sched.flush(self._TENANT, trigger=trigger)

    def done(self, ticket: int) -> bool:
        """True when a ticket's result is ready to collect without flushing.

        'Ready' means the flush was dispatched — the device values may still
        be in flight; ``result``/``sync`` do the blocking."""
        return self._sched.done(self._TENANT, ticket)

    def sync(self) -> None:
        """Block until every already-flushed result has materialized.

        A measurement/shutdown barrier (benchmarks use it to charge real
        flush compute to the clock); normal serving lets ``result`` block
        per ticket instead."""
        self._sched.sync(self._TENANT)

    def result(self, ticket: int):
        """(mean, var) for a ticket, device tensors; flushes if it is still
        queued.

        This is the only point the serving layer blocks on the device (on
        the ticket's flush event) — everything upstream (flushes, views) was
        dispatched asynchronously.
        """
        return self._sched.result(self._TENANT, ticket)

    def collect(self, ticket: int):
        """(mean, var, degraded) for a ticket — ``result`` plus the
        per-query degradation flag (True when the query's routed block was
        health-retired and the answer came from the global posterior;
        always False without ``health=``)."""
        return self._sched.collect(self._TENANT, ticket)

    # -- health -------------------------------------------------------------

    @property
    def health(self):
        """The server's ``serving.HealthTracker`` (None without
        ``health=``) — routing mask, per-block ledgers, revive timer."""
        return self._t.health

    def health_snapshot(self) -> dict | None:
        """Export view of per-block health (None without ``health=``)."""
        return None if self._t.health is None else self._t.health.snapshot()

    # -- batch path ---------------------------------------------------------

    def predict(self, U):
        """Bucket-padded (mean, var) over a (u, d) batch of queries — one
        plan dispatch (padding, staging, and — for routed plans — the
        occupancy-driven program selection are host-side inside the plan).
        """
        return self._sched.predict(self._TENANT, U)

    # -- state hot-swap -----------------------------------------------------

    def swap_state(self, state: Any) -> None:
        """Install a new PosteriorState (after online assimilate/retire).

        The plan is REBOUND, not rebuilt: every serving callable is reused
        (the port runs eagerly, so a changed shape, e.g. pPIC after
        assimilate grew the block axis, builds nothing either). A routed
        server validates the state carries block centroids at swap time,
        not mid-flush under traffic.
        """
        self._sched.swap_state(self._TENANT, state)

    # -- incremental-store lifecycle (api.StateStore protocol) --------------

    def _require_store(self, op: str) -> api.StateStore:
        if self._t.store is None:
            raise ValueError(
                f"GPServer.{op} needs an attached StateStore — construct "
                f"with GPServer(model, store=api.init_store(...)) or call "
                f"attach_store")
        return self._t.store

    def attach_store(self, store: api.StateStore) -> None:
        """Attach (or replace) the incremental store backing ``update``."""
        self._t.store = store

    def update(self, X_new, y_new) -> None:
        """Assimilate a new data stream and hot-swap the posterior (Sec.
        5.2): O(|S|²·b) store update on the plan's callables. Pending
        tickets flush first; the swap is atomic
        (``TenantScheduler.commit_store``)."""
        self._sched.commit_store(
            self._TENANT, self._require_store("update").assimilate(X_new,
                                                                   y_new))

    def retire_machine(self, machine: int) -> None:
        """Fold a failed/decommissioned machine's contribution out and keep
        serving the (exact) surviving posterior."""
        self._sched.commit_store(
            self._TENANT, self._require_store("retire_machine").retire(
                machine))

    def revive_machine(self, machine: int) -> None:
        self._sched.commit_store(
            self._TENANT, self._require_store("revive_machine").revive(
                machine))

    # -- checkpoint / restore ----------------------------------------------

    def checkpoint(self, path) -> None:
        """Persist the CURRENT serving state (core.serialize, versioned
        npz). What a replica ships to its peers — states, not data."""
        serialize.save_state(path, self._t.model.state)

    def swap_from_checkpoint(self, path) -> None:
        """Restore a checkpointed state (on the served state's device) and
        hot-swap it under live traffic
        (pending tickets flush against the old state first). The routed
        centroid check of ``swap_state`` applies — a PITC checkpoint cannot
        be swapped into a routed server.

        Any attached store is DETACHED: it describes the pre-restore
        posterior, and a later ``update`` built on it would silently revert
        the restored state. Re-attach a store consistent with the
        checkpoint (``attach_store``) to resume streaming.
        """
        self.flush()
        self.swap_state(serialize.load_state(path, device=self._device))
        self._t.store = None

    def checkpoint_store(self, path) -> None:
        """Persist the attached ``StateStore`` itself (factors, block
        caches, pivot basis — core.serialize.save_store) with this server's
        ``ServeSpec`` embedded next to it: unlike a state checkpoint, a
        restarted process that loads this keeps ASSIMILATING, not just
        serving — and a restarted FLEET MEMBER can re-admit the whole
        deployment (store + serving policy) from the one artifact
        (``serving.TenantRegistry.admit_from_checkpoint``)."""
        serialize.save_store(path, self._require_store("checkpoint_store"),
                             spec=self._t.spec)

    def restore_store(self, path, *, kfn=None, runner=None) -> None:
        """Load a store checkpoint, attach it, and hot-swap its posterior
        (flushing pending tickets first) — the restarted-fleet resume path.
        ``kfn``/``runner`` override what the checkpoint could not encode
        (see ``core.serialize.load_store``). The server keeps ITS OWN
        serving spec — the embedded one (if any) exists for fleet
        re-admission, where no live server holds a policy yet."""
        store = serialize.load_store(path, kfn=kfn, runner=runner,
                                     device=self._device)
        self.flush()
        self.swap_state(store.to_state())
        self._t.store = store
