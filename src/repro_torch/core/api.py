"""Unified GP method API: ``fit -> PosteriorState -> plan -> serve`` — port of
``repro.core.api`` (the FGP, PITC, PIC and pICF part).

Everything that is O((|D|/M)^3) or O(|S|^3) happens once at fit time and is
cached in a per-method state (a NamedTuple of tensors); a query then costs
only the cross-covariances against the cached factors.

Serving is two-phase. Phase 1: ``GPMethod.plan(kfn, params, state, spec) ->
ServePlan`` turns a ``ServeSpec`` into the plan's callables (built once per
entry point and shared across ``rebind``) and bucket ladder. Phase 2:
``plan.diag(U)`` / ``plan.full(U)`` serve. The reference jits one executable
per entry point; PyTorch runs eagerly, so a plan's "executables" are plain
callables and ``PlanStats.n_traces`` counts how many were built.

The incremental-state protocol (``StateStore``, ``init_store``) is the
reference's: a method's store folds data in and machines out and back, and
emits its state. ``ServeSpec.compat_key`` is what the multi-tenant registry
(``serving/registry.py``) shares plan callables on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.parallel.runner import ROUTED_ALPHA


# ---------------------------------------------------------------------------
# Per-method posterior states.
# ---------------------------------------------------------------------------

class FGPState(NamedTuple):
    """Exact GP: cached |D|x|D| Cholesky + weights (eqs. 1-2)."""
    X: torch.Tensor        # (n, d) training inputs
    L: torch.Tensor        # (n, n) chol(K_DD + noise)
    alpha: torch.Tensor    # (n,)   (K_DD + noise)^{-1} y


class PITCState(NamedTuple):
    """PITC/pPITC: everything global lives in S-space (eqs. 5-8)."""
    S: torch.Tensor        # (s, d) support set
    Kss_L: torch.Tensor    # (s, s) chol K_SS
    Sdd_L: torch.Tensor    # (s, s) chol Sigma-dot_DD  (eq. 6)
    alpha: torch.Tensor    # (s,)   Sdd^{-1} ydd       (eq. 7 weights)


class PICState(NamedTuple):
    """PIC/pPIC: PITC globals + per-block caches for the local correction
    (eqs. 12-14). Leading axis of the block fields is the machine axis M.

    ``centroids`` realizes Remark 2 on the serving side: the per-block data
    centroids fixed at fit time let ``ppic.predict_routed`` assign each query
    to the block whose local data best explains it, independent of how the
    query batch happens to be composed."""
    S: torch.Tensor          # (s, d)
    Kss_L: torch.Tensor      # (s, s)
    Sdd_L: torch.Tensor      # (s, s)
    alpha: torch.Tensor      # (s,)    Sdd^{-1} ydd
    Xb: torch.Tensor         # (M, b, d) data blocks
    yb: torch.Tensor         # (M, b)
    Ksd: torch.Tensor        # (M, s, b) cached K_S,Dm
    C_L: torch.Tensor        # (M, b, b) chol Sigma_{DmDm|S}
    Wy: torch.Tensor         # (M, b)    C^{-1} y_m
    ydot: torch.Tensor       # (M, s)    local summaries (eq. 3)
    beta: torch.Tensor       # (M, s)    Kss^{-1} ydot_m
    B: torch.Tensor          # (M, s, s) Kss^{-1} Sdot_m
    Sdot: torch.Tensor       # (M, s, s) local summaries (eq. 4)
    centroids: torch.Tensor  # (M, d)  block centroids (query routing)


class PICFState(NamedTuple):
    """pICF-based GP: distributed ICF factor + cached R-space solves
    (eqs. 19-23)."""
    Xb: torch.Tensor       # (M, b, d)
    yb: torch.Tensor       # (M, b)
    F: torch.Tensor        # (M, R, b) per-machine factor columns
    Phi_L: torch.Tensor    # (R, R)   chol(I + sum_m F_m F_m^T / s2)
    ydd: torch.Tensor      # (R,)     Phi^{-1} sum_m F_m y_m  (eq. 22)


# ---------------------------------------------------------------------------
# Incremental-state protocol (Sec. 5.2 summary algebra, method-owned).
# ---------------------------------------------------------------------------

@runtime_checkable
class StateStore(Protocol):
    """What a method's incremental state container must support.

    A store owns everything ``fit`` needed (kernel, hyperparameters, support
    set / rank, runner) plus the cached per-machine contributions, so the
    update algebra is closed over it:

    * ``assimilate(X_new, y_new)`` — fold a new data stream in as fresh
      machine blocks, reusing every already-paid local factorization (the
      paper's streaming add);
    * ``retire(machine)`` / ``revive(machine)`` — subtract / re-add one
      machine's contribution (failure, decommission, straggler deadline);
    * ``to_state()`` — assemble the method's cached state from whatever
      machines are alive. The global factor is kept up to date by rank-b
      Cholesky updates (``linalg.chol_update_rank``), so this is one
      O(|S|²) solve, not an O(|S|³) factorization.

    Stores are immutable: every mutation returns a new store (the same
    object where nothing changes), so serving can hold the old one until
    the hot-swap commits. The methods run on the host and launch device
    work; they read the alive mask on the host once a call (one sync), never
    inside a request.
    """

    def assimilate(self, X_new, y_new) -> "StateStore": ...

    def retire(self, machine: int) -> "StateStore": ...

    def revive(self, machine: int) -> "StateStore": ...

    def to_state(self) -> Any: ...


def check_machine_index(n_machines: int, machine: int) -> None:
    """Shared retire/revive guard: reject out-of-range machine ids up front
    (a negative index would otherwise address a machine from the end and
    silently retire the wrong one)."""
    if not 0 <= machine < n_machines:
        raise IndexError(
            f"machine {machine} out of range for {n_machines} machines")


def concrete_alive_mask(alive: torch.Tensor) -> np.ndarray:
    """Host view of a store's alive mask: one device sync. The port runs
    eagerly, so the mask is always a concrete tensor (the reference's
    ``None`` case, a mask traced under ``jit``, does not arise); the
    mutators and ``to_state`` read it once a call, never inside a request."""
    return alive.cpu().numpy()


# ---------------------------------------------------------------------------
# ServeSpec — phase 1's input: every per-deployment serving decision, once.
# ---------------------------------------------------------------------------

def default_buckets(max_batch: int, *, min_bucket: int = 8,
                    block_q: int = 1) -> tuple[int, ...]:
    """Powers of two from min_bucket up, capped by max_batch (inclusive),
    each rounded up to a multiple of ``block_q``; sorted, duplicate-free and
    covering (the top bucket is >= max_batch). Non-positive sizes raise."""
    if max_batch < 1 or min_bucket < 1 or block_q < 1:
        raise ValueError(
            f"default_buckets needs positive sizes; got max_batch="
            f"{max_batch}, min_bucket={min_bucket}, block_q={block_q}")
    align = lambda v: -(-v // block_q) * block_q
    sizes = []
    b = min_bucket
    while b < max_batch:
        sizes.append(align(b))
        b *= 2
    sizes.append(align(max_batch))
    return tuple(dict.fromkeys(sizes))


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Frozen per-deployment serving policy — phase 1's single input.

    * ``kernel``   — a ``cov.KernelSpec`` overriding the fit-time kernel
      callable; ``None`` serves with the plan's kernel.
    * ``block_q``  — serving query tile: this field, then the kernel's
      declared ``block_q``, then 8. Bucket ladders land on it.
    * ``max_batch`` / ``buckets`` / ``min_bucket`` — the bucket ladder.
      Explicit ``buckets`` win; otherwise ``default_buckets``; with neither
      the plan serves every batch at its exact size. Oversized batches round
      up to a multiple of the top bucket.
    * ``routed``   — serve through the batch-composition-invariant
      centroid-routed path (PIC family only).
    * ``alpha``    — routed main-bucket capacity multiplier (headroom vs
      skew, see ``runner.scatter_two_bucket``).
    * ``max_overflow_groups`` — bounds the routed overflow-program ladder:
      group counts snap up within {0, 1, 2, 4, ...}; a demand above this
      cap runs the worst-case-G program. ``None`` = the full ladder.
    * ``cached_cinv`` — precompute per-block ``C⁻¹ = (C_L C_Lᵀ)⁻¹`` at plan
      build, so the per-request batched triangular solve becomes one
      batched matmul. Off by default: a different float path.
    * ``dtype``    — query dtype policy: ``"preserve"``, ``"state"`` or
      ``"float32"``.
    """
    kernel: Any = None
    block_q: int | None = None
    max_batch: int | None = None
    buckets: tuple[int, ...] | None = None
    min_bucket: int = 8
    routed: bool = False
    alpha: int = ROUTED_ALPHA
    max_overflow_groups: int | None = None
    cached_cinv: bool = False
    dtype: str = "preserve"

    def __post_init__(self):
        # fail at construction, not inside routed_capacity at request time
        if self.alpha < 1:
            raise ValueError(f"ServeSpec.alpha must be >= 1; got "
                             f"{self.alpha}")
        if self.max_overflow_groups is not None \
                and self.max_overflow_groups < 0:
            raise ValueError(f"ServeSpec.max_overflow_groups must be >= 0; "
                             f"got {self.max_overflow_groups}")
        if self.cached_cinv and not self.routed:
            # the C^-1 cache serves the routed programs only; building it
            # for a diag-only plan would pay O(M b^3) per rebind for nothing
            raise ValueError(
                "ServeSpec(cached_cinv=True) serves the routed flush path; "
                "set routed=True as well")

    def resolve_kfn(self, kfn: Callable) -> Callable:
        served = self.kernel if self.kernel is not None else kfn
        if self.block_q is not None:
            from repro_torch.core import covariance as cov
            if isinstance(served, cov.KernelSpec) and \
                    served.block_q != self.block_q:
                # the fused dispatch reads the KernelSpec's tile
                served = dataclasses.replace(served, block_q=self.block_q)
        return served

    def resolve_block_q(self, kfn: Callable) -> int:
        if self.block_q is not None and self.block_q < 1:
            raise ValueError(f"ServeSpec.block_q must be a positive tile "
                             f"size; got {self.block_q}")
        kfn = self.resolve_kfn(kfn)
        return self.block_q or getattr(kfn, "block_q", None) or 8

    def resolve_buckets(self, kfn: Callable) -> tuple[int, ...] | None:
        """The ladder, or ``None`` for identity bucketing (no padding)."""
        if self.buckets is not None:
            buckets = tuple(sorted(dict.fromkeys(self.buckets)))
            if not buckets or buckets[0] < 1:
                raise ValueError(f"ServeSpec.buckets must be positive; got "
                                 f"{self.buckets}")
            if self.max_batch is not None and buckets[-1] < self.max_batch:
                raise ValueError(
                    f"largest bucket {buckets[-1]} < max_batch "
                    f"{self.max_batch}: the ladder would under-cover the "
                    f"serving queue")
            return buckets
        if self.max_batch is None:
            return None
        return default_buckets(self.max_batch, min_bucket=self.min_bucket,
                               block_q=self.resolve_block_q(kfn))

    def compat_key(self, kfn: Callable) -> tuple:
        """Hashable identity of the serving policy this spec resolves to
        over fit-time kernel ``kfn``.

        Two deployments whose keys match run the same serving callables:
        the same resolved kernel, tile, bucket ladder, routed dispatch,
        overflow ladder bound, backend caches and dtype policy. What the
        callables take as arguments (params, state, caches) is absent, so
        deployments that differ only in posterior values share one callable
        lineage (the multi-tenant registry adds the method name and the
        state's and params' structure; ``serving/registry.py``). Distinct
        specs can map to one key (``block_q=None`` vs an explicit
        ``block_q`` equal to the kernel's own): the key is the RESOLVED
        policy.
        """
        served = self.resolve_kfn(kfn)
        try:
            hash(served)
        except TypeError:       # a bespoke closure: identity is the key
            served = id(served)
        return (served, self.resolve_block_q(kfn), self.resolve_buckets(kfn),
                self.routed, self.alpha, self.max_overflow_groups,
                self.cached_cinv, self.dtype)


# ---------------------------------------------------------------------------
# ServePlan — phase 1's output: callables + ladder, owned per state.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlanStats:
    """Shared across ``rebind`` generations: the callable cache and its
    counters describe the plan lineage."""
    n_traces: int = 0          # serving callables built across the lineage
    n_diag_batches: int = 0
    n_routed_batches: int = 0
    n_full_batches: int = 0
    n_padded_rows: int = 0
    n_g0_batches: int = 0      # routed requests served by the G=0 program
    last_g: int | None = None  # overflow-group count of the last routed call
    # bounded degradation (PIC family): rows answered from the global
    # S-space posterior because their routed block was marked dead
    n_degraded_rows: int = 0
    last_degraded: Any = None  # (u,) bool of the last routed call, or None


def _state_device(state) -> torch.device:
    return next(iter(state)).device


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """Serving program for ONE (method, kernel, spec, state).

    * ``diag(U)``        — (mean, var) for any |U|: pad to the bucket
      ladder on the state's device, one dispatch, trim;
    * ``routed_diag(U)`` — the batch-composition-invariant path (PIC family;
      raises for methods without a routed program);
    * ``full(U)``        — the method's native posterior, un-padded;
    * ``rebind(state)``  — same plan, new posterior: the callables and stats
      are shared, so nothing is rebuilt; ``caches`` are rebuilt for it;
    * ``warmup(d)``      — run every bucket once (kernel builds and first
      launches are not charged to serving latency).

    ``caches`` is method-specific state precomputed per posterior (``None``
    here; pPIC's plan carries the blocks' whitened cross-covariances and,
    on request, the per-block ``C⁻¹``).
    """
    method: "GPMethod"
    kfn: Callable
    params: dict
    state: Any
    spec: ServeSpec
    block_q: int
    buckets: tuple[int, ...] | None
    caches: Any = None
    stats: PlanStats = dataclasses.field(default_factory=PlanStats)
    _exec: dict = dataclasses.field(default_factory=dict)

    def bucket_for(self, u: int) -> int:
        if self.buckets is None:        # identity bucketing: exact batches
            return u
        for b in self.buckets:
            if b >= u:
                return b
        big = self.buckets[-1]          # oversized: multiple of the top
        return -(-u // big) * big

    def _staged(self, U) -> torch.Tensor:
        """``U`` as a tensor on the state's device, under the spec's dtype
        policy (``"preserve"`` keeps the caller's dtype)."""
        policy = self.spec.dtype
        if policy == "preserve":
            target = None
        elif policy == "state":
            target = next(iter(self.state)).dtype
        elif policy == "float32":
            target = torch.float32
        else:
            raise ValueError(
                f"unknown ServeSpec.dtype policy {policy!r}; expected "
                f"'preserve', 'state', or 'float32'")
        if isinstance(U, (np.ndarray, list, tuple)):
            U = torch.as_tensor(np.asarray(U))
        return U.to(device=_state_device(self.state), dtype=target)

    def _padded(self, U) -> tuple[torch.Tensor, int]:
        U = self._staged(U)
        u = U.shape[0]
        bucket = self.bucket_for(u)
        if bucket == u:
            return U, u
        buf = U.new_zeros((bucket,) + tuple(U.shape[1:]))
        buf[:u] = U
        self.stats.n_padded_rows += bucket - u
        return buf, u

    def _program(self, key, build: Callable[[], Callable]) -> Callable:
        """The serving callable ``key``, made by ``build`` once and shared
        across rebinds; ``stats.n_traces`` counts the builds."""
        fn = self._exec.get(key)
        if fn is None:
            fn = self._exec[key] = build()
            self.stats.n_traces += 1
        return fn

    def _callable(self, key: str, impl: Callable) -> Callable:
        """The serving callable ``key`` over the method's raw ``impl``."""
        kfn = self.kfn
        return self._program(key, lambda: lambda params, state, U: impl(
            kfn, params, state, U))

    def diag(self, U) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, var) over a (u, d) batch — THE serving hot path."""
        Up, u = self._padded(U)
        mean, var = self._callable("diag", self.method.predict_diag_fn)(
            self.params, self.state, Up)
        self.stats.n_diag_batches += 1
        return mean[:u], var[:u]

    def routed_diag(self, U, block_alive=None):
        """Generic routed path: the method's raw routed impl with the plan's
        tile. The PIC family's ``PICServePlan`` overrides this with backend
        caches, the overflow-program ladder and bounded degradation
        (``block_alive``); methods with no routed impl raise — their
        posterior is composition-invariant already, use ``diag``."""
        impl, tile = self.method.predict_routed_diag_fn, self.block_q
        if block_alive is not None:
            raise ValueError(
                f"method {self.method.name!r}'s generic routed plan has no "
                f"bounded-degradation path (block_alive); only the PIC "
                f"family's PICServePlan serves dead-block traffic from the "
                f"global posterior")
        self.stats.last_degraded = None
        if impl is None:
            raise ValueError(
                f"method {self.method.name!r} has no routed serving "
                f"program; its posterior does not depend on query-block "
                f"assignment — use plan.diag")
        Up, u = self._padded(U)
        kfn = self.kfn
        fn = self._program("routed", lambda: lambda params, state, U: impl(
            kfn, params, state, U, tile=tile))
        mean, var = fn(self.params, self.state, Up)
        self.stats.n_routed_batches += 1
        self.stats.last_g = None
        return mean[:u], var[:u]

    def full(self, U):
        """The method's native posterior (mean + covariance). Queries are
        not bucket-padded: the covariance block shape is the output."""
        post = self._callable("full", self.method.predict_fn)(
            self.params, self.state, self._staged(U))
        self.stats.n_full_batches += 1
        return post

    def rebind(self, state) -> "ServePlan":
        """Hot-swap the posterior: a new plan over ``state`` sharing this
        plan's callables and stats, with its caches rebuilt for ``state``."""
        return dataclasses.replace(self, state=state,
                                   caches=self._rebuild_caches(state))

    def _rebuild_caches(self, state):
        """Recompute backend caches for a new state (none here)."""
        return None

    def warmup(self, d: int, *, dtype=torch.float32) -> "ServePlan":
        """Serve one zero batch per bucket (through the routed program for
        a routed spec of a method that has one), so kernel builds and first
        launches are paid before traffic; a no-op under identity
        bucketing. ``d`` is the query feature dimension."""
        dev = _state_device(self.state)
        routed = (self.spec.routed
                  and self.method.predict_routed_diag_fn is not None)
        serve = self.routed_diag if routed else self.diag
        for b in self.buckets or ():
            serve(torch.zeros((b, d), dtype=dtype, device=dev))
        if self.buckets and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return self


# ---------------------------------------------------------------------------
# Method registry.
# ---------------------------------------------------------------------------

_DEFAULT_SPEC = ServeSpec()


@dataclasses.dataclass(frozen=True)
class GPMethod:
    """One GP regression method behind the uniform state API.

    ``fit(kfn, params, X, y, **kw) -> state`` where ``kw`` is the subset of
    (S=, M=, rank=, runner=) the method needs. The ``*_fn`` fields are the
    raw prediction implementations (what plans call):

    * ``predict_fn(kfn, params, state, U)``      -> native posterior;
    * ``predict_diag_fn(kfn, params, state, U)`` -> (mean, var) vectors;
    * ``predict_routed_diag_fn(..., tile=)``     -> the batch-composition-
      invariant path (PIC family; ``None`` for methods whose posterior does
      not depend on query-block assignment);
    * ``init_store`` (optional) — the incremental-state entry point:
      ``init_store(kfn, params, X, y, **kw) -> StateStore`` with the same
      keyword subset as ``fit``. Methods without an incremental algebra
      (``fgp``) leave it ``None``; for the summary/factor methods ``fit``
      is ``init_store(...).to_state()``.
    * ``plan_fn(method, kfn, params, state, spec)`` — method-owned
      ``ServePlan`` factory (``None`` -> the generic plan); pPIC/PIC install
      one with per-block ``C⁻¹`` caches and the overflow-program ladder.
    """
    name: str
    fit: Callable[..., Any]
    predict_fn: Callable[..., Any]
    predict_diag_fn: Callable[..., Any]
    predict_routed_diag_fn: Callable[..., Any] | None = None
    init_store: Callable[..., "StateStore"] | None = None
    plan_fn: Callable[..., ServePlan] | None = None

    def plan(self, kfn, params, state, spec: ServeSpec | None = None
             ) -> ServePlan:
        """Build the serving program for ``state`` under ``spec``."""
        spec = spec if spec is not None else _DEFAULT_SPEC
        if spec.cached_cinv and self.plan_fn is None:
            raise ValueError(
                f"ServeSpec(cached_cinv=True) but method {self.name!r} has "
                f"no backend-cache plan (only the PIC family serves from "
                f"per-block C factors)")
        if self.plan_fn is not None:
            return self.plan_fn(self, kfn, params, state, spec)
        return ServePlan(self, spec.resolve_kfn(kfn), params, state, spec,
                         spec.resolve_block_q(kfn),
                         spec.resolve_buckets(kfn))


REGISTRY: dict[str, GPMethod] = {}


def register(method: GPMethod) -> GPMethod:
    REGISTRY[method.name] = method
    return method


def get(name: str) -> GPMethod:
    if name not in REGISTRY:
        # methods self-register at module import; pull the core modules in
        from repro_torch.core import gp, picf, pitc, ppic, ppitc  # noqa: F401
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown GP method {name!r}; have {names()}")


def names() -> list[str]:
    return sorted(REGISTRY)


# ---------------------------------------------------------------------------
# FittedGP — what serving / examples hold on to.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FittedGP:
    """A fitted model: method + kernel + hyperparameters + cached state.
    Every predict goes through a memoized ``ServePlan`` (one per spec);
    ``with_state`` rebinds the plans already built."""
    method: GPMethod
    kfn: Callable
    params: dict
    state: Any

    def plan(self, spec: ServeSpec | None = None) -> ServePlan:
        """The serving program for this model under ``spec`` (memoized)."""
        spec = spec if spec is not None else _DEFAULT_SPEC
        plans = self.__dict__.setdefault("_plans", {})
        if spec not in plans:
            plans[spec] = self.method.plan(self.kfn, self.params, self.state,
                                           spec)
        return plans[spec]

    def predict(self, U):
        return self.plan().full(U)

    def predict_diag(self, U):
        return self.plan().diag(U)

    def predict_routed_diag(self, U):
        """Centroid-routed (mean, var) — batch-composition-invariant."""
        if self.method.predict_routed_diag_fn is None:
            raise ValueError(
                f"method {self.method.name!r} has no routed prediction path; "
                f"its posterior does not depend on query-block assignment — "
                f"use predict_diag")
        return self.plan().routed_diag(U)

    def with_state(self, state) -> "FittedGP":
        """Hot-swap the cached posterior; plans already built are rebound."""
        new = dataclasses.replace(self, state=state)
        plans = self.__dict__.get("_plans")
        if plans:
            new.__dict__["_plans"] = {sp: pl.rebind(state)
                                      for sp, pl in plans.items()}
        return new


def _method_kwargs(S=None, M=None, rank=None, runner=None) -> dict:
    kw = {}
    if S is not None:
        kw["S"] = S
    if M is not None:
        kw["M"] = M
    if rank is not None:
        kw["rank"] = rank
    if runner is not None:
        kw["runner"] = runner
    return kw


def fit(name: str, kfn, params, X, y, *, S=None, M=None, rank=None,
        runner=None, device=None) -> FittedGP:
    """Registry front door: fit method ``name`` on ``device`` (the CUDA card
    unless named) and return a FittedGP. Data, support set and
    hyperparameters are moved there first."""
    dev = _device.resolve(device)
    method = get(name)
    params = {k: v.to(dev) for k, v in params.items()}
    X, y = X.to(dev), y.to(dev)
    S = S.to(dev) if S is not None else None
    state = method.fit(kfn, params, X, y,
                       **_method_kwargs(S, M, rank, runner))
    return FittedGP(method, kfn, params, state)


def init_store(name: str, kfn, params, X, y, *, S=None, M=None, rank=None,
               runner=None, device=None) -> StateStore:
    """Registry front door for the incremental-state protocol: build method
    ``name``'s ``StateStore`` from an initial data batch on ``device`` (the
    CUDA card unless named; data, support set and hyperparameters are moved
    there first). The cold-fit state is ``store.to_state()``; later
    ``assimilate``/``retire``/``revive`` calls mutate incrementally."""
    method = get(name)
    if method.init_store is None:
        raise ValueError(
            f"method {name!r} has no incremental StateStore (its cached "
            f"state has no cheap update algebra); have "
            f"{[m for m in names() if REGISTRY[m].init_store is not None]}")
    dev = _device.resolve(device)
    params = {k: v.to(dev) for k, v in params.items()}
    X, y = X.to(dev), y.to(dev)
    S = S.to(dev) if S is not None else None
    return method.init_store(kfn, params, X, y,
                             **_method_kwargs(S, M, rank, runner))
