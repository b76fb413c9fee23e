"""Contract auditor of the port's serving plans — port of
``repro.analysis.contracts``.

The no-rebuild claim — rebinding a posterior or interleaving tenants never
builds a new serving callable — is enforced dynamically by the
``PlanStats.n_traces`` counter (``core/api.py``: a plan's callables are
built once and shared across ``rebind``). A counter can only say *how
many* callables were built; it cannot say the calls run the *same
program*. This module proves the claim structurally:

* :func:`fingerprint` — sha256 of the aten ops a serving callable
  dispatches for a given call (op name, input and output shapes, dtypes
  and device types, recorded under a ``TorchDispatchMode``) and of the
  kernel launches it makes (each wrapper's launch-counter delta: the
  ctypes launches are not seen by the dispatcher). The call runs: eager
  PyTorch has nothing to trace without running. Posterior VALUES ride in
  as arguments and cannot influence the hash;
* :func:`audit_plan` — capture the live call arguments of every cached
  ``ServePlan`` callable by wrapping ``plan._exec`` during a traffic
  drive, then fingerprint each one;
* :func:`audit_rebind_generations` — serve, rebind onto value-perturbed
  same-shape states N times, and require the callable set, the build
  counter and every fingerprint (kernel launches included) to be
  identical across generations;
* :func:`audit_tenant_interleaving` — admit two tenants of one lineage,
  interleave their traffic, and require no growth of the shared callable
  cache and fingerprint-identical programs;
* :func:`no_retrace` — a decorator registry for module-level functions the
  plans call: after :func:`freeze`, a call with a never-seen (shape,
  dtype, device) signature is a contract violation (a new shape means new
  work at serving time: an allocation pattern or a kernel instance the
  warm-up did not cover);
* :func:`run_audit` — the CLI entry: builds a small synthetic routed pPIC
  deployment (on the card unless ``device`` names another) with the
  serving covariance spec (``covariance.make_spec("se")``: the rbf
  kernel's launches on the card), runs every audit, optionally writes a
  JSON report.

torch is imported lazily, so ``repro_torch.analysis``'s lint half stays
importable without it.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import pathlib
from typing import Any, Callable, Mapping

__all__ = [
    "fingerprint", "audit_plan", "audit_rebind_generations",
    "audit_tenant_interleaving", "no_retrace", "freeze", "violations",
    "registry_report", "reset_registry", "run_audit",
]


# ---------------------------------------------------------------------------
# dispatch fingerprints
# ---------------------------------------------------------------------------

def _launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch counter (the ``*_launches`` module
    ints of ``kernels/*/ops.py``)."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.linalg import ops as linalg_ops
    from repro_torch.kernels.rbf import ops as rbf_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    out = {}
    for mod in (rbf_ops, attn_ops, ssd_ops, linalg_ops):
        for name, v in vars(mod).items():
            if name.endswith("_launches") and isinstance(v, int):
                out[f"{mod.__name__.split('.')[-2]}.{name}"] = v
    return out


def _signature_of(t) -> str:
    return f"{tuple(t.shape)}:{str(t.dtype).split('.')[-1]}:{t.device.type}"


def _record(fn: Callable, args: tuple) -> tuple[list[str], dict[str, int]]:
    """(one line per aten op ``fn(*args)`` dispatches, the kernel launches
    it made by counter)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.lines: list[str] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            ins = [_signature_of(t) for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            outs = [_signature_of(t) for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            self.lines.append(f"{func} {ins} -> {outs}")
            return out

    before = _launch_counts()
    mode = _Ops()
    with mode:
        fn(*args)
    after = _launch_counts()
    launches = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    return mode.lines, launches


def _digest(lines: list[str], launches: dict[str, int]) -> str:
    text = "\n".join(lines) + "\n" + json.dumps(launches, sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()


def fingerprint(fn: Callable, args: tuple) -> str:
    """sha256 of the aten ops and kernel launches ``fn(*args)`` makes
    (``_record``). Two calls that fingerprint equal run the same program:
    the same ops on the same shapes, dtypes and devices, and the same
    kernel launches."""
    return _digest(*_record(fn, args))


def _capture_args(plan, drive: Callable[[Any], None]) -> dict:
    """Run ``drive(plan)`` with every cached callable wrapped by an
    argument recorder; returns ``{key: first call args}``. The wrap is
    reverted before returning even if the drive raises."""
    originals = dict(plan._exec)
    captured: dict = {}

    def wrap(key, fn):
        def spy(*args):
            captured.setdefault(key, args)
            return fn(*args)
        return spy

    plan._exec.update({k: wrap(k, f) for k, f in originals.items()})
    try:
        drive(plan)
    finally:
        # unwrap the spies but keep callables the drive created lazily:
        # deleting them would force a rebuild on the next drive and
        # corrupt the very build counter the audit protects
        created = {k: f for k, f in plan._exec.items() if k not in originals}
        plan._exec.clear()
        plan._exec.update(originals)
        plan._exec.update(created)
    return captured


def audit_plan(plan, drive: Callable[[Any], None]) -> dict:
    """Fingerprint every callable ``drive`` exercises on ``plan``.

    Returns ``{"fingerprints": {key: sha256}, "launches": {key: {counter:
    launches}}, "n_executables": int}``."""
    drive(plan)   # build lazily-selected callables before spying
    captured = _capture_args(plan, drive)
    fps, launches = {}, {}
    for k, args in sorted(captured.items(), key=lambda kv: str(kv[0])):
        lines, made = _record(plan._exec[k], args)
        fps[str(k)], launches[str(k)] = _digest(lines, made), made
    return {"fingerprints": fps, "launches": launches,
            "n_executables": len(plan._exec)}


# ---------------------------------------------------------------------------
# rebind-generation audit
# ---------------------------------------------------------------------------

def _perturbed(state, rel: float):
    """Same-shape, same-dtype state with every float leaf nudged: a
    stand-in for an assimilate-free online refresh (assimilation grows
    the support set and legitimately changes shapes)."""
    import torch

    def nudge(a):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a * (1 + rel)
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            return type(a)(*(nudge(v) for v in a))
        if isinstance(a, (tuple, list)):
            return type(a)(nudge(v) for v in a)
        if isinstance(a, dict):
            return {k: nudge(v) for k, v in a.items()}
        return a
    return nudge(state)


def audit_rebind_generations(plan, drive: Callable[[Any], None], *,
                             n_generations: int = 3) -> dict:
    """Serve, then rebind onto ``n_generations`` value-perturbed states
    and re-audit: the callable set, the build counter, every fingerprint
    and every callable's kernel launches must be identical across
    generations — the structural form of the no-rebuild-on-rebind
    claim."""
    base = audit_plan(plan, drive)
    keys0 = set(map(str, plan._exec))
    generations = [base["fingerprints"]]
    launches = [base["launches"]]
    traces0 = plan.stats.n_traces
    identical = True
    for i in range(1, n_generations):
        gen_plan = plan.rebind(_perturbed(plan.state, 1e-6 * i))
        audit = audit_plan(gen_plan, drive)
        generations.append(audit["fingerprints"])
        launches.append(audit["launches"])
        if audit["fingerprints"] != base["fingerprints"] or \
                audit["launches"] != base["launches"]:
            identical = False
        if set(map(str, gen_plan._exec)) != keys0:
            identical = False
    new_traces = plan.stats.n_traces - traces0
    return {
        "n_executables": base["n_executables"],
        "n_audited": len(base["fingerprints"]),
        "n_rebind_generations": n_generations,
        "rebind_identical": identical,
        "rebind_new_traces": int(new_traces),
        "fingerprints": base["fingerprints"],
        "generations": generations,
        "launches": launches,
    }


# ---------------------------------------------------------------------------
# tenant-interleaving audit
# ---------------------------------------------------------------------------

def audit_tenant_interleaving(model, spec, queries, *,
                              n_rounds: int = 3) -> dict:
    """Admit two tenants of one lineage (same method/spec/state shapes,
    independent posterior values), interleave their traffic, and require:
    one lineage, no callable-cache growth, no new builds, and
    fingerprint-identical programs before vs after the interleaving."""
    import numpy as np
    from repro_torch.serving.registry import TenantRegistry
    from repro_torch.serving.scheduler import TenantScheduler

    reg = TenantRegistry()
    sched = TenantScheduler(reg)
    ta = sched.admit("tenant-a", model, spec)
    sched.admit("tenant-b", model.with_state(_perturbed(model.state, 1e-5)),
                spec)
    n_lineages = reg.n_lineages
    # audit through tenant A's plan, which shares the lineage's callable
    # cache with tenant B's
    shared_plan = ta.plan
    q = np.asarray(queries)
    shared_plan.warmup(int(q.shape[-1]))

    def drive(plan):
        plan.diag(q)
        if plan.spec.routed:
            plan.routed_diag(q)

    before = audit_plan(shared_plan, drive)
    keys0 = set(map(str, shared_plan._exec))
    traces0 = shared_plan.stats.n_traces
    for r in range(n_rounds):
        for i, row in enumerate(q):
            sched.submit("tenant-a" if (i + r) % 2 == 0 else "tenant-b", row)
        sched.flush()
    after = audit_plan(shared_plan, drive)
    return {
        "n_lineages": int(n_lineages),
        "n_tenant_interleavings": n_rounds,
        "interleaving_identical": (
            n_lineages == 1
            and before["fingerprints"] == after["fingerprints"]
            and before["launches"] == after["launches"]
            and set(map(str, shared_plan._exec)) == keys0
            and shared_plan.stats.n_traces == traces0),
        "interleaving_new_traces": int(shared_plan.stats.n_traces - traces0),
    }


# ---------------------------------------------------------------------------
# @no_retrace registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _NoRetraceRecord:
    name: str
    signatures: set = dataclasses.field(default_factory=set)
    frozen: set | None = None
    n_calls: int = 0


_REGISTRY: dict[str, _NoRetraceRecord] = {}


def _abstract_signature(args: tuple, kwargs: Mapping) -> tuple:
    """A call's signature as far as shapes go: a tensor contributes
    (shape, dtype, device type), a Python scalar its type and repr, a
    container its structure, anything else its repr."""
    import torch

    def sig(v):
        if isinstance(v, torch.Tensor):
            return ("tensor", tuple(v.shape), str(v.dtype), v.device.type)
        if isinstance(v, (bool, int, float, complex)):
            return (type(v).__name__, repr(v))
        if isinstance(v, (tuple, list)):
            return (type(v).__name__, tuple(sig(x) for x in v))
        if isinstance(v, dict):
            return ("dict", tuple((k, sig(x)) for k, x in sorted(v.items())))
        return repr(v)
    return sig(tuple(args)), sig(dict(kwargs))


def no_retrace(name: str) -> Callable:
    """Register a function under the no-new-signature contract: after
    :func:`freeze`, any call with a never-seen (shape, dtype, device)
    signature is a violation. Purely observational: calls are never
    blocked."""
    def deco(fn: Callable) -> Callable:
        rec = _REGISTRY.setdefault(name, _NoRetraceRecord(name))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            rec.signatures.add(_abstract_signature(args, kwargs))
            rec.n_calls += 1
            return fn(*args, **kwargs)

        wrapper.__wrapped__ = fn
        return wrapper
    return deco


def freeze() -> None:
    """Snapshot every registered function's signature set — the post-warmup
    declaration that every shape has been seen."""
    for rec in _REGISTRY.values():
        rec.frozen = set(rec.signatures)


def violations() -> dict[str, int]:
    """``{name: n new signatures since freeze}`` for every frozen record
    that saw a never-before-seen signature."""
    return {rec.name: len(rec.signatures - rec.frozen)
            for rec in _REGISTRY.values()
            if rec.frozen is not None and rec.signatures - rec.frozen}


def registry_report() -> dict[str, dict]:
    return {rec.name: {"n_calls": rec.n_calls,
                       "n_signatures": len(rec.signatures),
                       "frozen": rec.frozen is not None}
            for rec in _REGISTRY.values()}


def reset_registry() -> None:
    """Test hook: drop all recorded signatures and freeze points (the
    decorated functions stay registered)."""
    for rec in _REGISTRY.values():
        rec.signatures.clear()
        rec.frozen = None
        rec.n_calls = 0


# ---------------------------------------------------------------------------
# CLI entry
# ---------------------------------------------------------------------------

def run_audit(report_path: str | None = None, *, n_rebinds: int = 3,
              seed: int = 0, device=None) -> dict:
    """Build a small synthetic routed pPIC deployment on ``device`` (the
    CUDA card unless named) and run the full audit: rebind generations,
    tenant interleaving, the no_retrace registry. Returns the report dict
    (and writes it as JSON to ``report_path``)."""
    import numpy as np
    import torch
    from repro_torch import device as _device
    from repro_torch.core import api
    from repro_torch.core import covariance as cov
    from repro_torch.parallel.runner import VmapRunner

    dev = _device.resolve(device)
    n, s, d, M, u = 64, 12, 3, 4, 10
    rng = np.random.RandomState(seed)
    X = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    S = torch.as_tensor(rng.standard_normal((s, d)), dtype=torch.float32)
    U = rng.standard_normal((u, d)).astype(np.float32)
    y = torch.sin(X[:, 0]) + 0.3 * torch.as_tensor(
        rng.standard_normal(n), dtype=torch.float32)
    params = cov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                             device=dev)
    # the serving covariance spec: on the card its blocks are the rbf
    # kernel's launches, which the fingerprints then cover
    kfn = cov.make_spec("se")

    model = api.fit("ppic", kfn, params, X, y, S=S, runner=VmapRunner(M=M),
                    device=dev)
    # cached_cinv exercises the @no_retrace contract on ppic.cinv_blocks:
    # plan build and every rebind recompute the block-inverse cache, which
    # must reuse one signature
    spec = api.ServeSpec(max_batch=16, routed=True, cached_cinv=True)
    plan = model.plan(spec)
    plan.warmup(d)
    freeze()

    def drive(p):
        p.diag(U)          # padded unrouted path
        p.routed_diag(U)   # padded routed path

    report: dict = {"seed": seed, "device": str(dev)}
    report.update(audit_rebind_generations(plan, drive,
                                           n_generations=n_rebinds))
    report.update(audit_tenant_interleaving(model, spec, U))
    report["no_retrace"] = registry_report()
    report["no_retrace_violations"] = violations()
    report["ok"] = bool(
        report["rebind_identical"]
        and report["rebind_new_traces"] == 0
        and report["interleaving_identical"]
        and not report["no_retrace_violations"])
    if report_path is not None:
        pathlib.Path(report_path).write_text(json.dumps(report, indent=2)
                                             + "\n")
    return report
