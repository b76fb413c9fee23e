"""Runtime monitoring: heartbeats, failure detection, throughput metrics —
port of ``repro.runtime.monitor`` (pure Python, as the reference).

The fault-tolerance math (runtime/fault.py) needs a DETECTOR to drive it.
This module provides the control-plane piece: machines report heartbeats
(in simulation, a latency/crash model generates them); the detector flags
machines whose heartbeat age exceeds the timeout and emits fail/recover
events that the caller applies to the ClusterState (fault.fail /
fault.recover_reassign). Also tracks step timing and EMA throughput the way
a training-loop babysitter would.

Every component takes an injectable ``clock`` (seconds, monotonic) — the
same pattern as ``launch.gp_serve.GPServer`` — so heartbeat/sweep/stall
tests drive a virtual clock instead of sleeping. ``Ema`` is the shared
exponential-moving-average primitive: ``TrainMonitor`` uses it for step
time and loss, and the serving observability layer (``serving/stats.py``)
reuses it for per-tenant interarrival tracking (the adaptive flusher's
input).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass
class Ema:
    """Exponential moving average with explicit first-sample seeding.

    ``update(x)`` seeds the average with the first observation (no
    zero-bias warmup) and blends thereafter; ``value`` is ``None`` until a
    sample arrives, so consumers can distinguish "no data yet" from a
    genuinely small average (0.0 is a legal observation — truthiness tests
    on the value would misclassify it)."""
    alpha: float = 0.9
    value: Optional[float] = None

    def update(self, x: float) -> float:
        self.value = (x if self.value is None
                      else self.alpha * self.value + (1 - self.alpha) * x)
        return self.value

    def get(self, default: float = 0.0) -> float:
        return default if self.value is None else self.value


@dataclasses.dataclass
class MachineStatus:
    last_heartbeat: float
    alive: bool = True
    failures: int = 0


class FailureDetector:
    """Heartbeat-timeout failure detector (phi-accrual simplified)."""

    def __init__(self, n_machines: int, *, timeout: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        now = clock()
        self.machines = {m: MachineStatus(now) for m in range(n_machines)}

    def heartbeat(self, machine: int) -> None:
        st = self.machines[machine]
        st.last_heartbeat = self.clock()
        if not st.alive:
            st.alive = True          # recovered

    def sweep(self) -> list[int]:
        """Returns machines newly declared failed."""
        now = self.clock()
        newly = []
        for m, st in self.machines.items():
            if st.alive and now - st.last_heartbeat > self.timeout:
                st.alive = False
                st.failures += 1
                newly.append(m)
        return newly

    @property
    def alive_mask(self) -> list[bool]:
        return [self.machines[m].alive for m in sorted(self.machines)]


@dataclasses.dataclass
class StepMetrics:
    step: int = 0
    tokens_per_s: float = 0.0
    step_time_ema: float = 0.0
    loss_ema: float = 0.0


class TrainMonitor:
    """EMA step timing / throughput / loss tracking + stall detection."""

    def __init__(self, *, tokens_per_step: int, ema: float = 0.9,
                 stall_factor: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.tokens = tokens_per_step
        self.ema = ema
        self.stall_factor = stall_factor
        self.clock = clock
        self._last: Optional[float] = None
        self.metrics = StepMetrics()

        self._step_ema = Ema(alpha=ema)
        self._loss_ema = Ema(alpha=ema)

    def step(self, loss: float) -> StepMetrics:
        now = self.clock()
        m = self.metrics
        if self._last is not None:
            m.step_time_ema = self._step_ema.update(now - self._last)
            m.tokens_per_s = self.tokens / max(m.step_time_ema, 1e-9)
        self._last = now
        m.loss_ema = self._loss_ema.update(loss)
        m.step = m.step + 1
        return m

    def is_stalled(self) -> bool:
        """True when no step completed within stall_factor x EMA time."""
        if self._last is None or not self.metrics.step_time_ema:
            return False
        return (self.clock() - self._last
                > self.stall_factor * self.metrics.step_time_ema)
