"""TenantRegistry: many posteriors, one card, shared serving callables —
port of ``repro.serving.registry``.

The paper parallelizes ONE posterior across machines; production inverts
it — many independent posteriors (per-tenant hyperparameters, regions,
sensor networks) multiplexed onto one process. What is shared is not the
state (a few factors per tenant) but the plan's serving callables and
their counters (``PlanStats``): per-tenant plans would each build the
whole program ladder.

The registry does so with the lineage map: a tenant is admitted as a
(tenant_id, FittedGP, ServeSpec[, StateStore]) tuple; its lineage key is

    (method name, ServeSpec.compat_key(kfn), state structure,
     params structure)

— exactly what the callables depend on. A structure is the state's type
name, its fields and each tensor's (shape, dtype), or the params' sorted
keys with (shape, dtype), and the device type of the tensors, so a CPU
tenant never shares a lineage with a CUDA one. Params, state and backend
caches are ARGUMENTS of every plan callable, so tenants with equal keys
run the same programs on different posterior values: the first admit
builds the plan, every later admit REBINDS the anchored lineage
(``dataclasses.replace`` keeps the callable dict and ``PlanStats`` shared
by reference), and ``PlanStats.n_traces`` (callables built) does not grow
across tenant interleavings at fixed shapes. The anchor itself is
stripped of params/state/caches so a lineage never pins an evicted
tenant's posterior.

Queue mechanics (weighted deadlines, admission control, flushing) live in
``serving/scheduler.py``; the registry owns membership, lineage dedup, and
the state/store lifecycle (``rebind`` = hot-swap with routed-state
validation, ``admit_from_checkpoint`` = fleet re-admission from one
``serialize.save_store(..., spec=...)`` artifact).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import api
from repro_torch.serving.stats import ServeStats


@dataclasses.dataclass(frozen=True)
class AdaptiveDeadline:
    """Adaptive-flusher policy: a tenant's EFFECTIVE deadline is

        clip(gain * EMA(interarrival), floor_ms, flush_deadline_ms)

    The declared ``flush_deadline_ms`` is a staleness BUDGET — the worst
    queue time a ticket may ever see. When traffic is brisk but below the
    size-trigger rate, holding a ticket for the whole budget buys little
    extra batching: ~``gain`` more arrivals is all a flush can gain, and
    those arrive within ``gain`` interarrival times. So the effective
    deadline tracks the observed rate (low staleness under load) and
    relaxes toward the declared budget as traffic thins (maximum batching
    when batches are hard to fill). Never exceeds the declared budget.
    """
    gain: float = 4.0
    floor_ms: float = 0.5

    def __post_init__(self):
        if self.gain <= 0 or self.floor_ms < 0:
            raise ValueError(f"AdaptiveDeadline needs gain > 0 and "
                             f"floor_ms >= 0; got {self}")


@dataclasses.dataclass
class Tenant:
    """One admitted tenant: its model/plan/store plus the scheduler-owned
    queue state. Mutable by design — the scheduler and registry are the
    only writers; everything observable rides in ``stats``."""
    tenant_id: str
    model: api.FittedGP
    spec: api.ServeSpec
    plan: api.ServePlan
    store: Optional[api.StateStore]
    weight: float
    flush_deadline_ms: Optional[float]
    adaptive: Optional[AdaptiveDeadline]
    max_pending: Optional[int]
    overflow: str
    max_ready: int
    max_batch: int
    seq: int                       # admission order: deterministic tie-break
    stats: ServeStats = dataclasses.field(default_factory=ServeStats)
    queue: list = dataclasses.field(default_factory=list)
    ready: dict = dataclasses.field(default_factory=dict)
    next_ticket: int = 0
    last_arrival: Optional[float] = None
    # self-healing (serving/health.py) + fault injection (serving/chaos.py);
    # None = the zero-overhead fast path in the scheduler's dispatch
    health: Optional[Any] = None        # HealthTracker
    chaos: Optional[Any] = None         # FaultInjector
    # ticket -> bool, maintained in lockstep with ``ready``: True when the
    # ticket's row was answered from the global posterior (its routed block
    # was health-retired). Collected via TenantScheduler.collect().
    ready_degraded: dict = dataclasses.field(default_factory=dict)
    # ticket -> the CUDA event recorded after its flush's outputs (one
    # event per flush, shared by its tickets; None on the CPU), in lockstep
    # with ``ready``: ``result`` waits on it, ``sync`` on all of them
    ready_events: dict = dataclasses.field(default_factory=dict)

    @property
    def pending(self) -> int:
        return len(self.queue)


def _leaf(v: torch.Tensor) -> tuple:
    """(shape, dtype, device type) of one tensor."""
    return (tuple(v.shape), str(v.dtype), v.device.type)


def _state_struct(state) -> tuple:
    """The state's type name, its fields and each field's leaf key."""
    return (type(state).__name__, tuple(state._fields),
            tuple(_leaf(v) for v in state))


def _params_struct(params: dict) -> tuple:
    """The params' sorted keys, each with its leaf key."""
    return tuple((k, _leaf(params[k])) for k in sorted(params))


def lineage_key(model: api.FittedGP, spec: api.ServeSpec) -> tuple:
    """What callable sharing legitimately depends on — and nothing else.
    Posterior VALUES are absent on purpose: they are arguments of the
    callables, so equal-key tenants share one callable cache."""
    return (model.method.name, spec.compat_key(model.kfn),
            _state_struct(model.state), _params_struct(model.params))


# store type -> the registry method whose plan serves it (fleet re-admission
# from a store checkpoint has no FittedGP to name the method)
_METHOD_FOR_STORE = {"PITCStore": "ppitc", "PICStore": "ppic",
                     "PICFStore": "picf"}


class TenantRegistry:
    """Membership + callable-lineage sharing for a multi-tenant serving
    process. See the module docstring for the sharing contract."""

    def __init__(self):
        self._tenants: dict[str, Tenant] = {}
        self._lineages: dict[tuple, api.ServePlan] = {}
        self._seq = 0

    # -- membership ---------------------------------------------------------

    def admit(self, tenant_id: str, model: api.FittedGP,
              spec: api.ServeSpec | None = None, *,
              store: api.StateStore | None = None,
              weight: float = 1.0,
              flush_deadline_ms: float | None = None,
              adaptive: AdaptiveDeadline | bool | None = None,
              max_pending: int | None = None,
              overflow: str = "reject",
              max_ready: int = 65536,
              max_batch: int = 64,
              health: Any = None,
              chaos: Any = None) -> Tenant:
        """Admit a tenant; returns its live ``Tenant`` record.

        ``weight`` scales deadline urgency (a weight-2 tenant's tickets
        are due in half the time); ``max_pending``/``overflow`` are the
        admission-control knobs (``"reject"`` raises at submit,
        ``"shed_oldest"`` drops the oldest queued ticket — both counted);
        ``adaptive=True`` opts into the default ``AdaptiveDeadline``.

        ``health`` opts into self-healing dispatch (``serving/health.py``):
        ``True`` for the default ``HealthPolicy``, or a ``HealthPolicy``
        instance. Requires a routed spec — degraded serving re-routes a
        retired block's queries to the global posterior, which only exists
        for routed states. ``chaos`` attaches deterministic fault injection
        (a ``chaos.FaultPlan`` or prebuilt ``chaos.FaultInjector``) for
        tests/benches; production tenants leave it None.
        """
        if tenant_id in self._tenants:
            raise ValueError(f"tenant {tenant_id!r} already admitted; "
                             f"evict it first to re-admit")
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0; got {weight} "
                             f"(zero/negative weight would starve the "
                             f"tenant forever)")
        if overflow not in ("reject", "shed_oldest"):
            raise ValueError(f"unknown overflow policy {overflow!r}; "
                             f"expected 'reject' or 'shed_oldest'")
        if spec is None:
            spec = api.ServeSpec(max_batch=max_batch)
        elif spec.max_batch is None and spec.buckets is None:
            # a multiplexed tenant NEEDS a finite ladder (identity
            # bucketing serves every distinct queue length at its own
            # shape; same contract as GPServer)
            spec = dataclasses.replace(spec, max_batch=max_batch)
        if spec.routed and model.method.predict_routed_diag_fn is None:
            raise ValueError(
                f"routed=True but method {model.method.name!r} has no "
                f"predict_routed_diag (needs a state with block centroids, "
                f"e.g. ppic/pic)")
        if adaptive is True:
            adaptive = AdaptiveDeadline()
        elif adaptive is False:
            adaptive = None
        if health is not None and health is not False:
            from repro_torch.serving.health import HealthPolicy, \
                HealthTracker
            if not spec.routed:
                raise ValueError(
                    f"tenant {tenant_id!r}: health tracking requires "
                    f"routed=True — degraded serving answers a retired "
                    f"block's queries from the global posterior, which "
                    f"needs per-query block routing")
            policy = HealthPolicy() if health is True else health
            health = HealthTracker(int(model.state.centroids.shape[0]),
                                   policy)
        else:
            health = None
        if chaos is not None:
            from repro_torch.serving.chaos import FaultInjector, FaultPlan
            if isinstance(chaos, FaultPlan):
                chaos = FaultInjector(chaos)
        plan = self._plan_for(model, spec)
        t = Tenant(tenant_id=tenant_id, model=model, spec=spec, plan=plan,
                   store=store, weight=weight,
                   flush_deadline_ms=flush_deadline_ms, adaptive=adaptive,
                   max_pending=max_pending, overflow=overflow,
                   max_ready=max_ready,
                   max_batch=(spec.max_batch if spec.max_batch is not None
                              else max(spec.buckets)),
                   seq=self._seq, health=health, chaos=chaos)
        self._seq += 1
        self._tenants[tenant_id] = t
        return t

    def _plan_for(self, model: api.FittedGP,
                  spec: api.ServeSpec) -> api.ServePlan:
        key = lineage_key(model, spec)
        anchor = self._lineages.get(key)
        if anchor is None:
            # through the model's per-spec memo, so a plan the caller
            # already built (or builds later via model.predict*) IS the
            # lineage. The anchor is stripped of the admitting tenant's
            # tensors: a lineage owns callables, never a posterior.
            plan = model.plan(spec)
            self._lineages[key] = dataclasses.replace(
                plan, params=None, state=None, caches=None)
            return plan
        plan = dataclasses.replace(
            anchor, params=model.params, state=model.state,
            caches=anchor._rebuild_caches(model.state))
        # install into the model's memo so direct model.predict* calls on
        # the same spec share the lineage too (instead of building anew)
        model.__dict__.setdefault("_plans", {})[spec] = plan
        return plan

    def admit_from_checkpoint(self, tenant_id: str, path, *, kfn=None,
                              runner=None, spec: api.ServeSpec | None = None,
                              method: str | None = None, device=None,
                              **tenant_kw) -> Tenant:
        """Re-admit a tenant from one ``serialize.save_store(..., spec=...)``
        artifact: the store resumes ASSIMILATING and the embedded ServeSpec
        reconstructs the serving policy — a restarted fleet member needs
        nothing else. ``spec=`` overrides the embedded spec (required when
        the file was saved without one); ``kfn``/``runner``/``device`` as
        in ``serialize.load_store`` (the CUDA card unless named)."""
        from repro_torch.core import serialize
        store, saved = serialize.load_store(path, kfn=kfn, runner=runner,
                                            with_spec=True, device=device)
        if spec is None:
            spec = saved
        if spec is None:
            raise ValueError(
                f"{path}: store checkpoint carries no ServeSpec (saved "
                f"before spec embedding, or via save_store without spec=); "
                f"pass admit_from_checkpoint(..., spec=...)")
        name = method or _METHOD_FOR_STORE.get(type(store).__name__)
        if name is None:
            raise ValueError(f"no registry method known for store type "
                             f"{type(store).__name__!r}; pass method=")
        m = api.get(name)
        model = api.FittedGP(m, store.kfn, store.params, store.to_state())
        return self.admit(tenant_id, model, spec, store=store, **tenant_kw)

    def evict(self, tenant_id: str) -> Tenant:
        """Remove a tenant (its record is returned — pending queue/ready
        state included, so the caller can drain or account for it). The
        lineage anchor stays: its callables are the shared asset
        and other tenants may reference them."""
        return self._tenants.pop(self._require(tenant_id).tenant_id)

    def get(self, tenant_id: str) -> Tenant:
        return self._require(tenant_id)

    def _require(self, tenant_id: str) -> Tenant:
        try:
            return self._tenants[tenant_id]
        except KeyError:
            raise KeyError(f"unknown tenant {tenant_id!r}; admitted: "
                           f"{sorted(self._tenants)}") from None

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self._tenants

    def __len__(self) -> int:
        return len(self._tenants)

    def ids(self) -> list[str]:
        return list(self._tenants)

    def tenants(self) -> list[Tenant]:
        return list(self._tenants.values())

    @property
    def n_lineages(self) -> int:
        return len(self._lineages)

    # -- state lifecycle ----------------------------------------------------

    def rebind(self, tenant_id: str, state: Any) -> Tenant:
        """Hot-swap one tenant's posterior: the plan is REBOUND (callables
        reused — none built at unchanged shapes), every other
        tenant is untouched. Validates routed-state compatibility BEFORE
        mutating, so a rejected swap leaves the tenant serving its old
        posterior."""
        t = self._require(tenant_id)
        if t.spec.routed and not hasattr(state, "centroids"):
            raise ValueError(
                f"routed tenant {tenant_id!r} requires a state with block "
                f"centroids; got {type(state).__name__} (a pPITC store "
                f"emits PITCState — stream through a PIC-family store, or "
                f"serve unrouted)")
        t.model = t.model.with_state(state)
        t.plan = t.model.plan(t.spec)
        t.stats.n_state_swaps += 1
        return t

    # -- observability ------------------------------------------------------

    def stats(self, tenant_id: str) -> ServeStats:
        return self._require(tenant_id).stats

    def stats_by_tenant(self) -> dict[str, ServeStats]:
        return {tid: t.stats for tid, t in self._tenants.items()}
