"""Elastic multi-tenant serving runtime — port of ``repro.serving``.

Many independent posteriors multiplexed onto one process: a
``TenantRegistry`` shares serving callables across plan-compatible
tenants, a ``TenantScheduler`` drains per-tenant microbatch queues
earliest-weighted-deadline-first with admission control, an adaptive
flusher, and self-healing dispatch (``serving.health``: per-block health
tracking, retry/retire/revive, bounded-degradation routed serving;
``serving.chaos``: the deterministic fault injection that exercises it),
and ``serving.stats`` exports per-tenant/fleet observability.
``launch.gp_serve.GPServer`` is the one-tenant client of this package.
"""
from repro_torch.serving.chaos import BlockDied, FaultInjector, FaultPlan
from repro_torch.serving.health import (BlockHealth, HealthPolicy,
                                        HealthTracker)
from repro_torch.serving.registry import (AdaptiveDeadline, Tenant,
                                          TenantRegistry, lineage_key)
from repro_torch.serving.scheduler import AdmissionError, TenantScheduler
from repro_torch.serving.stats import Ema, Reservoir, ServeStats, rollup

__all__ = [
    "AdaptiveDeadline",
    "AdmissionError",
    "BlockDied",
    "BlockHealth",
    "Ema",
    "FaultInjector",
    "FaultPlan",
    "HealthPolicy",
    "HealthTracker",
    "Reservoir",
    "ServeStats",
    "Tenant",
    "TenantRegistry",
    "TenantScheduler",
    "lineage_key",
    "rollup",
]
