"""The port's serving runtime (``serving/{registry,scheduler,stats}``,
``launch/gp_serve.GPServer``, ``ServeSpec.compat_key``) against the JAX
package's, on the CPU in float64.

The same scripted arrivals on a virtual clock go through both packages'
``TenantScheduler``: the dispatch logs (tenant, trigger, count, in order),
the ``ServeStats`` rollups (counters and ``Reservoir`` percentiles) and
the lineage counts must be identical, and every ticket's (mean, var)
within 1e-10 (ROADMAP's runner-and-state tolerance). The port's own
bitwise invariants are proved again in-package: multiplexed vs isolated
serving, hot-swaps that build no callable, and pending tickets resolved
against the state they were submitted under. Inputs are made with numpy
from a seed and fed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import api as japi, covariance as jcov
from repro.launch.gp_serve import GPServer as JGPServer
from repro.parallel.runner import VmapRunner as JVmapRunner
from repro.serving import (AdaptiveDeadline as JAdaptiveDeadline,
                           AdmissionError as JAdmissionError,
                           Reservoir as JReservoir,
                           TenantRegistry as JTenantRegistry,
                           TenantScheduler as JTenantScheduler)
from repro_torch import convert
from repro_torch.core import api, covariance as cov, ppic, serialize
from repro_torch.launch.gp_serve import GPServer, ServeStats as ReExported
from repro_torch.parallel.runner import VmapRunner
from repro_torch.serving import (AdaptiveDeadline, AdmissionError, Ema,
                                 Reservoir, ServeStats, TenantRegistry,
                                 TenantScheduler, lineage_key, rollup)

STATE_TOL = 1e-10


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _err(got, want) -> float:
    return float(np.abs(_np(got) - _np(want)).max())


@pytest.fixture(scope="module")
def prob():
    """tests/helpers.make_problem's shapes (n=96, u=24, |S|=12, d=3, M=4),
    drawn with numpy; three pPIC tenants whose y differ by a roll (equal
    structure, different values: the lineage-sharing case), a pPITC model,
    in both packages."""
    rng = np.random.default_rng(0)
    n, u, s, d, M = 96, 24, 12, 3, 4
    X, S, U, X2 = (rng.normal(size=(k, d)) for k in (n, s, u, n))
    y = np.sin(X[:, 0]) * 2.0 + X[:, 1] - 0.5 * X[:, 2] ** 2 \
        + 0.3 * rng.normal(size=n)
    y2 = np.cos(X2[:, 0]) + 0.3 * rng.normal(size=n)
    jparams = jcov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                               dtype=jnp.float64)
    params = convert.params_from_arrays(jparams, device="cpu")
    kfn, jkfn = cov.make_kernel("se"), jcov.make_kernel("se")
    models, jmodels = [], []
    for r in (0, 7, 19):
        yr = np.roll(y, r)
        models.append(api.fit("ppic", kfn, params, _t(X), _t(yr), S=_t(S),
                              runner=VmapRunner(M=M), device="cpu"))
        jmodels.append(japi.fit("ppic", jkfn, jparams, jnp.asarray(X),
                                jnp.asarray(yr), S=jnp.asarray(S),
                                runner=JVmapRunner(M=M)))
    pitc = api.fit("ppitc", kfn, params, _t(X), _t(y), S=_t(S),
                   runner=VmapRunner(M=M), device="cpu")
    jpitc = japi.fit("ppitc", jkfn, jparams, jnp.asarray(X), jnp.asarray(y),
                     S=jnp.asarray(S), runner=JVmapRunner(M=M))
    return dict(X=X, y=y, S=S, U=U, X2=X2, y2=y2, M=M, params=params,
                jparams=jparams, kfn=kfn, jkfn=jkfn, models=models,
                jmodels=jmodels, pitc=pitc, jpitc=jpitc)


# ---------------------------------------------------------------------------
# The same scripted traffic through both packages
# ---------------------------------------------------------------------------

PORT = dict(api=api, Sched=TenantScheduler, Server=GPServer,
            Adaptive=AdaptiveDeadline, Admission=AdmissionError)
JAX = dict(api=japi, Sched=JTenantScheduler, Server=JGPServer,
           Adaptive=JAdaptiveDeadline, Admission=JAdmissionError)

# (tenant, seconds since the last event) — pump every third event
EVENTS = [("a", 0.001), ("b", 0.0), ("a", 0.002), ("c", 0.001), ("b", 0.0),
          ("a", 0.0), ("c", 0.03), ("b", 0.001), ("a", 0.06), ("b", 0.0),
          ("c", 0.0), ("a", 0.001), ("b", 0.002), ("c", 0.001), ("a", 0.0),
          ("b", 0.03), ("a", 0.004), ("c", 0.0), ("b", 0.05), ("a", 0.0)]

SCENARIOS = {
    # three tenants, one deadline, size and deadline flushes
    "interleaved": dict(a={}, b={}, c={}, max_batch=4, deadline=50.0),
    # skewed weights reorder service
    "weighted": dict(a=dict(weight=1.0), b=dict(weight=2.0),
                     c=dict(weight=4.0), max_batch=8, deadline=20.0),
    # the adaptive flusher tightens a brisk tenant's deadline
    "adaptive": dict(a=dict(adaptive=(2.0, 0.5)), b=dict(adaptive=True),
                     c={}, max_batch=8, deadline=100.0),
    # admission control: reject and shed_oldest, both counted
    "admission": dict(a=dict(max_pending=2, overflow="reject"),
                      b=dict(max_pending=2, overflow="shed_oldest"),
                      c={}, max_batch=8, deadline=None),
    # a routed tenant beside positional ones
    "routed": dict(a=dict(routed=True), b={}, c=dict(routed=True),
                   max_batch=8, deadline=5.0),
}


def _run_script(pkg, models, U, scenario, events=EVENTS, pump_every=3):
    """Drive ``events`` through one package's scheduler on a virtual clock;
    returns the dispatch log, the rollup, the per-ticket outputs (None for
    a ticket that never resolves) and the effective deadlines seen."""
    a = pkg["api"]
    clk = [0.0]
    sched = pkg["Sched"](clock=lambda: clk[0])
    for i, tid in enumerate("abc"):
        kw = dict(scenario[tid])
        spec = a.ServeSpec(max_batch=scenario["max_batch"],
                           routed=kw.pop("routed", False))
        if isinstance(kw.get("adaptive"), tuple):
            gain, floor = kw["adaptive"]
            kw["adaptive"] = pkg["Adaptive"](gain=gain, floor_ms=floor)
        sched.admit(tid, models[i], spec,
                    flush_deadline_ms=scenario["deadline"], **kw)
    tickets, effective = [], []
    for step, (tid, dt) in enumerate(events):
        clk[0] += dt
        try:
            tickets.append((tid, sched.submit(tid, U[step % len(U)])))
        except pkg["Admission"]:
            tickets.append((tid, None))
        effective.append(sched.effective_deadline_ms(tid))
        if step % pump_every == pump_every - 1:
            sched.pump()
    clk[0] += 1.0
    sched.pump()
    sched.flush()
    outs = []
    for tid, tk in tickets:
        try:
            outs.append(None if tk is None else sched.result(tid, tk))
        except KeyError:
            outs.append(None)
    return list(sched.dispatch_log), sched.rollup(), outs, effective


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scripted_traffic_matches_the_reference(prob, name):
    scenario = SCENARIOS[name]
    log, roll, outs, eff = _run_script(PORT, prob["models"], prob["U"],
                                       scenario)
    jlog, jroll, jouts, jeff = _run_script(JAX, prob["jmodels"], prob["U"],
                                           scenario)
    assert log == jlog
    assert roll == jroll
    assert eff == jeff
    assert [o is None for o in outs] == [o is None for o in jouts]
    for o, jo in zip(outs, jouts):
        if o is not None:
            assert isinstance(o[0], torch.Tensor)
            assert max(_err(o[0], jo[0]), _err(o[1], jo[1])) <= STATE_TOL
    if name == "admission":
        assert roll["tenants"]["a"]["n_rejected"] > 0
        assert roll["tenants"]["b"]["n_shed"] > 0
    if name == "routed":
        assert sum(roll["tenants"]["a"]["g_hist"].values()) > 0


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_random_traffic_matches_the_reference(prob, seed):
    r = np.random.RandomState(seed)
    events = [("abc"[r.randint(3)], float(r.choice([0.0, 1e-3, 0.03])))
              for _ in range(24)]
    scenario = dict(a=dict(weight=float(r.choice([1.0, 2.0]))), b={}, c={},
                    max_batch=int(r.choice([3, 4, 8])), deadline=20.0)
    log, roll, outs, _ = _run_script(PORT, prob["models"], prob["U"],
                                     scenario, events)
    jlog, jroll, jouts, _ = _run_script(JAX, prob["jmodels"], prob["U"],
                                        scenario, events)
    assert log == jlog and roll == jroll
    for o, jo in zip(outs, jouts):
        assert max(_err(o[0], jo[0]), _err(o[1], jo[1])) <= STATE_TOL


def _serve_one(pkg, model, U, **server_kw):
    """The reference's deadline-flusher script (tests/test_serving_runtime.
    py) on one GPServer: counts, pending queue and outputs."""
    clk = [0.0]
    srv = pkg["Server"](model, clock=lambda: clk[0], **server_kw)
    seen, tickets = [], []
    for i in range(7):
        tickets.append(srv.submit(U[i]))
        clk[0] += 0.004 * (i % 3)
        seen.append((srv.pump(), srv.pending, round(srv.oldest_age_ms(), 9)))
    srv.flush()
    outs = [srv.result(tk) for tk in tickets]
    return seen, srv.stats.snapshot(), outs


@pytest.mark.parametrize("routed", [False, True])
def test_gpserver_matches_the_reference(prob, routed):
    model, jmodel = ((prob["models"][0], prob["jmodels"][0]) if routed
                     else (prob["pitc"], prob["jpitc"]))
    kw = dict(max_batch=4, flush_deadline_ms=5.0, routed=routed)
    seen, snap, outs = _serve_one(PORT, model, prob["U"], **kw)
    jseen, jsnap, jouts = _serve_one(JAX, jmodel, prob["U"], **kw)
    assert seen == jseen and snap == jsnap
    for o, jo in zip(outs, jouts):
        assert max(_err(o[0], jo[0]), _err(o[1], jo[1])) <= STATE_TOL


def _specs(cov_mod, impl):
    k16 = cov_mod.KernelSpec("se", impl, True, 16)
    k_none = cov_mod.KernelSpec("se", impl, True, None)
    return [(), dict(block_q=8), dict(max_batch=8),
            dict(max_batch=8, block_q=8), dict(max_batch=16),
            dict(routed=True, max_batch=8), dict(kernel=k_none),
            dict(kernel=k16, max_batch=8), dict(kernel=k16, block_q=16,
                                                max_batch=8),
            dict(kernel=k16, block_q=8, max_batch=8),
            dict(max_batch=8, dtype="float32"),
            dict(max_batch=8, alpha=3), dict(buckets=(8, 16))]


def _classes(keys) -> list:
    """The partition of indices into equal-key classes."""
    out = []
    for i, k in enumerate(keys):
        for cls in out:
            if keys[cls[0]] == k:
                cls.append(i)
                break
        else:
            out.append([i])
    return out


def test_compat_key_classes_match_the_reference(prob):
    keys = [api.ServeSpec(**dict(kw)).compat_key(prob["kfn"])
            for kw in _specs(cov, "torch")]
    jkeys = [japi.ServeSpec(**dict(kw)).compat_key(prob["jkfn"])
             for kw in _specs(jcov, "jnp")]
    assert _classes(keys) == _classes(jkeys)
    assert len(_classes(keys)) < len(keys)      # some specs do coincide
    for k in keys:
        hash(k)
    # an unhashable kernel object keys by identity
    class Bespoke:
        __hash__ = None

        def __call__(self, params, X1, X2):
            return cov.se_ard(params, X1, X2)

    f = Bespoke()
    assert api.ServeSpec().compat_key(f)[0] == id(f)


def test_lineage_counts_match_the_reference(prob):
    m, jm = prob["models"], prob["jmodels"]
    reg, jreg = TenantRegistry(), JTenantRegistry()
    admits = [("a", 0, dict(max_batch=8)), ("b", 1, dict(max_batch=8)),
              ("c", 2, dict(max_batch=16)),
              ("d", 2, dict(max_batch=8, routed=True)),
              ("e", 0, dict(max_batch=8, routed=True))]
    for tid, i, kw in admits:
        reg.admit(tid, m[i], api.ServeSpec(**kw))
        jreg.admit(tid, jm[i], japi.ServeSpec(**kw))
        assert reg.n_lineages == jreg.n_lineages
    spec = api.ServeSpec(max_batch=8)
    assert lineage_key(m[0], spec) == lineage_key(m[1], spec)
    # another dtype, another device, another method: other lineages
    m32 = api.FittedGP(m[0].method, m[0].kfn,
                       {k: v.float() for k, v in m[0].params.items()},
                       type(m[0].state)(*(x.float() for x in m[0].state)))
    meta = api.FittedGP(m[0].method, m[0].kfn, m[0].params,
                        type(m[0].state)(*(x.to("meta")
                                           for x in m[0].state)))
    assert lineage_key(m32, spec) != lineage_key(m[0], spec)
    assert lineage_key(meta, spec) != lineage_key(m[0], spec)
    assert lineage_key(prob["pitc"], spec) != lineage_key(m[0], spec)


# ---------------------------------------------------------------------------
# The port's own bitwise invariants
# ---------------------------------------------------------------------------

def _mux_vs_isolated(prob, events, *, deadline_ms=50.0, max_batch=4,
                     pump_every=3):
    """The same per-tenant events through one multiplexed scheduler and
    one GPServer per tenant on one virtual clock: bitwise per ticket."""
    models = prob["models"]
    tids = sorted({tid for tid, _ in events})
    clk = [0.0]
    clock = lambda: clk[0]  # noqa: E731
    sched = TenantScheduler(clock=clock)
    for i, tid in enumerate(tids):
        sched.admit(tid, models[i], api.ServeSpec(max_batch=max_batch),
                    flush_deadline_ms=deadline_ms)
    solo = {tid: GPServer(models[i], spec=api.ServeSpec(max_batch=max_batch),
                          flush_deadline_ms=deadline_ms, clock=clock)
            for i, tid in enumerate(tids)}
    mux_tickets, solo_tickets = [], []
    for step, (tid, dt) in enumerate(events):
        clk[0] += dt
        x = prob["U"][step % prob["U"].shape[0]]
        mux_tickets.append((tid, sched.submit(tid, x)))
        solo_tickets.append((tid, solo[tid].submit(x)))
        if step % pump_every == pump_every - 1:
            sched.pump()
            for srv in solo.values():
                srv.pump()
    for (tid, tk_m), (_, tk_s) in zip(mux_tickets, solo_tickets):
        assert tk_m == tk_s
        mm, vm = sched.result(tid, tk_m)
        ms, vs = solo[tid].result(tk_s)
        assert torch.equal(mm, ms) and torch.equal(vm, vs)


def test_multiplexed_equals_isolated_bitwise(prob):
    _mux_vs_isolated(prob, EVENTS)


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_multiplexed_equals_isolated_random_traffic(prob, seed):
    r = np.random.RandomState(seed)
    events = [("abc"[r.randint(3)], float(r.choice([0.0, 1e-3, 0.03])))
              for _ in range(24)]
    _mux_vs_isolated(prob, events, max_batch=int(r.choice([3, 4, 8])))


def test_no_new_callables_across_interleavings(prob):
    spec = api.ServeSpec(max_batch=8)
    sched = TenantScheduler(clock=lambda: 0.0)
    for tid, m in zip("abc", prob["models"]):
        sched.admit(tid, m, spec)
    U = prob["U"][:5]
    sched.predict("a", U)
    traces = sched.registry.get("a").plan.stats.n_traces
    assert traces > 0
    for tid in "bacbcabccba":
        sched.predict(tid, U)
    assert sched.registry.get("a").plan.stats.n_traces == traces
    assert sched.registry.get("a").plan._exec is \
        sched.registry.get("c").plan._exec
    # a fourth tenant of the lineage builds nothing either
    sched.admit("d", prob["models"][1], spec)
    sched.predict("d", U)
    assert sched.registry.get("d").plan.stats.n_traces == traces


def test_rebind_swaps_one_tenant_only(prob):
    spec = api.ServeSpec(max_batch=8)
    sched = TenantScheduler(clock=lambda: 0.0)
    sched.admit("a", prob["models"][0], spec)
    sched.admit("b", prob["models"][1], spec)
    U = prob["U"][:5]
    mb0, vb0 = sched.predict("b", U)
    traces = sched.registry.get("a").plan.stats.n_traces
    sched.swap_state("a", prob["models"][2].state)
    ma, _ = sched.predict("a", U)
    mref, vref = sched.predict("b", U)
    assert torch.equal(mref, mb0) and torch.equal(vref, vb0)
    m2, _ = prob["models"][2].plan(spec).diag(U)
    assert torch.equal(ma, m2)
    assert sched.registry.get("a").plan.stats.n_traces == traces
    assert sched.stats("a").n_state_swaps == 1


def test_evict_drains_and_keeps_the_lineage(prob):
    spec = api.ServeSpec(max_batch=8)
    sched = TenantScheduler(clock=lambda: 0.0)
    sched.admit("a", prob["models"][0], spec)
    sched.admit("b", prob["models"][1], spec)
    t = sched.submit("a", prob["U"][0])
    rec = sched.evict("a")
    assert t in rec.ready and sched.registry.n_lineages == 1
    with pytest.raises(KeyError, match="unknown tenant"):
        sched.submit("a", prob["U"][0])


def _pitc_store_server(prob, **kw):
    store = api.init_store("ppitc", prob["kfn"], prob["params"],
                           _t(prob["X"]), _t(prob["y"]), S=_t(prob["S"]),
                           runner=VmapRunner(M=prob["M"]), device="cpu")
    model = api.FittedGP(api.get("ppitc"), prob["kfn"], prob["params"],
                         store.to_state())
    return GPServer(model, store=store, max_batch=8, **kw)


@pytest.mark.parametrize("op", ["update", "retire", "revive"])
def test_pending_tickets_resolve_against_the_old_state(prob, op):
    """Each store swap flushes the queue first: tickets pending across it
    equal the old plan's output bitwise, later ones the new plan's; the
    swap builds no callable."""
    srv = _pitc_store_server(prob)
    if op == "revive":
        srv.retire_machine(2)
    U = prob["U"][:5]
    srv.predict(U)
    traces = srv.plan.stats.n_traces
    old_plan = srv.plan
    tickets = [srv.submit(x) for x in U]
    assert srv.pending == 5
    if op == "update":
        srv.update(_t(prob["X2"]), _t(prob["y2"]))
    elif op == "retire":
        srv.retire_machine(1)
    else:
        srv.revive_machine(2)
    assert srv.pending == 0 and srv.plan is not old_plan
    m_old, v_old = old_plan.diag(U)
    got = [srv.result(tk) for tk in tickets]
    assert torch.equal(torch.stack([g[0] for g in got]), m_old)
    assert torch.equal(torch.stack([g[1] for g in got]), v_old)
    m_new, v_new = srv.plan.diag(U)
    tk = [srv.submit(x) for x in U]
    srv.flush()
    assert torch.equal(torch.stack([srv.result(k)[0] for k in tk]), m_new)
    assert not torch.equal(m_new, m_old)
    assert srv.plan.stats.n_traces == traces
    assert srv.stats.n_updates == (2 if op == "revive" else 1)


def test_hot_swap_routed_builds_no_callable(prob):
    m0, m1 = prob["models"][0], prob["models"][1]
    srv = GPServer(m0, max_batch=8, flush_deadline_ms=5, routed=True)
    U = prob["U"][:8]
    a, _ = srv.predict(U)
    traces = srv.plan.stats.n_traces
    srv.swap_state(m1.state)
    b, v = srv.predict(U)
    rm, rv = ppic.predict_routed_diag(prob["kfn"], prob["params"], m1.state,
                                      _t(U))
    assert _err(b, rm) <= 1e-12 and _err(v, rv) <= 1e-12
    assert float((a - b).abs().max()) > 1e-6
    assert srv.plan.stats.n_traces == traces
    assert srv.stats.n_state_swaps == 1


# ---------------------------------------------------------------------------
# Admission control, adaptive deadlines, the deadline flusher
# ---------------------------------------------------------------------------

def test_reject_policy_raises_and_counts(prob):
    sched = TenantScheduler(clock=lambda: 0.0)
    sched.admit("a", prob["models"][0], api.ServeSpec(max_batch=64),
                max_pending=2, overflow="reject")
    t0 = sched.submit("a", prob["U"][0])
    sched.submit("a", prob["U"][1])
    with pytest.raises(AdmissionError, match="max_pending=2"):
        sched.submit("a", prob["U"][2])
    s = sched.stats("a")
    assert s.n_rejected == 1 and s.n_requests == 2
    assert sched.pending("a") == 2
    sched.flush("a")
    assert sched.submit("a", prob["U"][2]) == t0 + 2


def test_shed_oldest_policy_drops_and_counts(prob):
    sched = TenantScheduler(clock=lambda: 0.0)
    sched.admit("a", prob["models"][0], api.ServeSpec(max_batch=64),
                max_pending=2, overflow="shed_oldest")
    t0 = sched.submit("a", prob["U"][0])
    t1 = sched.submit("a", prob["U"][1])
    t2 = sched.submit("a", prob["U"][2])
    assert sched.stats("a").n_shed == 1 and sched.pending("a") == 2
    sched.flush("a")
    sched.result("a", t1)
    sched.result("a", t2)
    with pytest.raises(KeyError, match="shed"):
        sched.result("a", t0)


def test_admission_guards(prob):
    reg = TenantRegistry()
    m = prob["models"]
    reg.admit("a", m[0], api.ServeSpec(max_batch=8))
    with pytest.raises(ValueError, match="already admitted"):
        reg.admit("a", m[1], api.ServeSpec(max_batch=8))
    with pytest.raises(ValueError, match="weight"):
        reg.admit("w", m[1], api.ServeSpec(max_batch=8), weight=0.0)
    with pytest.raises(ValueError, match="overflow"):
        reg.admit("o", m[1], api.ServeSpec(max_batch=8),
                  overflow="drop_newest")
    with pytest.raises(ValueError, match="predict_routed_diag"):
        reg.admit("r", prob["pitc"], api.ServeSpec(max_batch=8, routed=True))
    with pytest.raises(ValueError, match="routed"):
        reg.admit("h", m[0], api.ServeSpec(max_batch=8), health=True)


def test_adaptive_deadline(prob):
    with pytest.raises(ValueError, match="gain"):
        AdaptiveDeadline(gain=0.0)
    clk = [0.0]
    sched = TenantScheduler(clock=lambda: clk[0])
    sched.admit("a", prob["models"][0], api.ServeSpec(max_batch=64),
                flush_deadline_ms=100.0,
                adaptive=AdaptiveDeadline(gain=2.0, floor_ms=0.5))
    sched.submit("a", prob["U"][0])
    assert sched.effective_deadline_ms("a") == 100.0
    for i in range(8):
        clk[0] += 0.001
        sched.submit("a", prob["U"][i % 8])
    assert sched.effective_deadline_ms("a") == pytest.approx(2.0, rel=0.05)
    sched.flush("a")
    sched.submit("a", prob["U"][0])
    clk[0] += 0.005
    assert sched.pump() == 1
    # the floor bounds the tightening
    sched.admit("f", prob["models"][1], api.ServeSpec(max_batch=64),
                flush_deadline_ms=100.0,
                adaptive=AdaptiveDeadline(gain=4.0, floor_ms=3.0))
    for i in range(10):
        clk[0] += 1e-6
        sched.submit("f", prob["U"][i % 8])
    assert sched.effective_deadline_ms("f") == 3.0


def _pitc_server(prob, **kw):
    t = [0.0]
    return GPServer(prob["pitc"], clock=lambda: t[0], **kw), t


def test_deadline_flusher(prob):
    srv, t = _pitc_server(prob, max_batch=8, flush_deadline_ms=50)
    ticket = srv.submit(prob["U"][0])
    assert srv.pump() == 0 and srv.pending == 1
    t[0] += 0.049
    assert srv.pump() == 0 and srv.pending == 1
    t[0] += 0.002
    assert srv.pump() == 1 and srv.pending == 0 and srv.done(ticket)
    assert (srv.stats.n_deadline_flushes, srv.stats.n_size_flushes) == (1, 0)
    m, v = srv.result(ticket)
    rm, rv = prob["pitc"].predict_diag(_t(prob["U"][:1]))
    assert _err(m, rm[0]) <= 1e-12 and _err(v, rv[0]) <= 1e-12
    # an overdue queue drains on the next submit too
    srv.submit(prob["U"][0])
    t[0] += 0.06
    srv.submit(prob["U"][1])
    assert srv.pending == 0 and srv.stats.n_deadline_flushes == 2


def test_size_only_without_a_deadline_and_trigger_split(prob):
    srv, t = _pitc_server(prob, max_batch=4)
    srv.submit(prob["U"][0])
    t[0] += 1e6
    assert srv.pump() == 0 and srv.pending == 1
    for i in range(1, 4):
        srv.submit(prob["U"][i])
    assert srv.pending == 0 and srv.stats.n_size_flushes == 1
    srv, t = _pitc_server(prob, max_batch=2, flush_deadline_ms=100)
    srv.submit(prob["U"][0])
    srv.submit(prob["U"][1])
    srv.submit(prob["U"][2])
    t[0] += 0.2
    srv.pump()
    srv.submit(prob["U"][3])
    srv.flush()
    s = srv.stats
    assert (s.n_size_flushes, s.n_deadline_flushes, s.n_manual_flushes,
            s.n_batches) == (1, 1, 1, 3)


def test_bad_trigger_rejected_before_the_queue_is_touched(prob):
    srv, _ = _pitc_server(prob, max_batch=8)
    ticket = srv.submit(prob["U"][0])
    with pytest.raises(ValueError, match="unknown flush trigger"):
        srv.flush(trigger="timeout")
    assert srv.pending == 1
    srv.flush()
    assert srv.done(ticket)


def test_submit_takes_arrays_and_tensors_and_results_are_tensors(prob):
    srv, _ = _pitc_server(prob, max_batch=8)
    a = srv.submit(prob["U"][0])
    b = srv.submit(_t(prob["U"][0]))
    c = srv.submit(list(prob["U"][0]))
    srv.flush()
    srv.sync()
    ra, rb, rc = srv.result(a), srv.result(b), srv.result(c)
    assert all(isinstance(x, torch.Tensor) and x.shape == ()
               for x in ra + rb + rc)
    assert torch.equal(ra[0], rb[0]) and torch.equal(ra[0], rc[0])
    assert not srv._t.ready_events


def test_gpserver_spec_and_legacy_kwargs_conflict(prob):
    with pytest.raises(ValueError, match="legacy"):
        GPServer(prob["pitc"], spec=api.ServeSpec(max_batch=8), routed=True)
    with pytest.raises(ValueError, match="predict_routed_diag"):
        GPServer(prob["pitc"], routed=True)


def test_routed_swap_rejects_a_centroidless_state(prob):
    srv = GPServer(prob["models"][0], max_batch=8, routed=True)
    with pytest.raises(ValueError, match="centroids"):
        srv.swap_state(prob["pitc"].state)
    ticket = srv.submit(prob["U"][0])
    srv.flush()
    assert srv.done(ticket)


def test_routed_tickets_under_mixed_triggers(prob):
    model = prob["models"][0]
    t = [0.0]
    srv = GPServer(model, max_batch=4, flush_deadline_ms=50, routed=True,
                   clock=lambda: t[0])
    tickets = {}
    for i in range(6):
        tickets[i] = srv.submit(prob["U"][i])
        t[0] += 0.001
    assert srv.stats.n_size_flushes == 1 and srv.pending == 2
    t[0] += 0.06
    assert srv.pump() == 2
    ref_m, ref_v = model.predict_routed_diag(_t(prob["U"][:6]))
    for i in range(6):
        m, v = srv.result(tickets[i])
        assert _err(m, ref_m[i]) <= 1e-10 and _err(v, ref_v[i]) <= 1e-10


# ---------------------------------------------------------------------------
# Stats primitives, rollup, re-exports
# ---------------------------------------------------------------------------

def test_ema_and_reservoir_match_the_reference():
    e = Ema(alpha=0.5)
    assert e.value is None and e.get(7.0) == 7.0
    assert e.update(0.0) == 0.0 and e.update(2.0) == 1.0
    r, jr = Reservoir(cap=16, seed=3), JReservoir(cap=16, seed=3)
    for i in range(1000):
        r.record(float(i))
        jr.record(float(i))
    assert r._buf == jr._buf and r.snapshot() == jr.snapshot()
    assert r.n_seen == 1000 and len(r._buf) == 16
    with pytest.raises(ValueError, match="cap"):
        Reservoir(cap=0)


def test_rollup_and_the_gpserver_stats_schema(prob):
    clk = [0.0]
    sched = TenantScheduler(clock=lambda: clk[0])
    sched.admit("a", prob["models"][0], api.ServeSpec(max_batch=4))
    sched.admit("b", prob["models"][1], api.ServeSpec(max_batch=4))
    for i in range(4):
        clk[0] += 0.001
        sched.submit("a", prob["U"][i])
    sched.submit("b", prob["U"][0])
    sched.flush("b")
    r = sched.rollup()
    assert r["n_tenants"] == 2 and r["totals"]["n_requests"] == 5
    assert r["totals"]["n_flushes"] == 2
    snap = r["tenants"]["a"]
    assert snap["n_size_flushes"] == 1 and snap["staleness_ms"]["n"] == 4
    assert snap["interarrival_ms"] == pytest.approx(1.0)
    assert ReExported is ServeStats
    srv = GPServer(prob["models"][0], max_batch=4)
    t = srv.submit(prob["U"][0])
    srv.flush()
    srv.result(t)
    assert isinstance(srv.stats, ServeStats)
    assert rollup({"default": srv.stats})["totals"]["n_requests"] == 1


# ---------------------------------------------------------------------------
# Checkpoints through the server and the registry
# ---------------------------------------------------------------------------

def _pic_store_server(prob, **srv_kw):
    n1 = prob["X"].shape[0] // 2
    store = api.init_store("ppic", prob["kfn"], prob["params"],
                           _t(prob["X"][:n1]), _t(prob["y"][:n1]),
                           S=_t(prob["S"]), runner=VmapRunner(M=prob["M"]),
                           device="cpu")
    model = api.FittedGP(api.get("ppic"), prob["kfn"], prob["params"],
                         store.to_state())
    return GPServer(model, store=store, **srv_kw)


def test_admit_from_checkpoint_bitwise(prob, tmp_path):
    spec = api.ServeSpec(max_batch=8, routed=True)
    srv = _pic_store_server(prob, spec=spec)
    path = tmp_path / "tenant.store.npz"
    srv.checkpoint_store(path)
    assert serialize.peek_store(path)["serve_spec"]["routed"] is True
    reg = TenantRegistry()
    t = reg.admit_from_checkpoint("restored", path, device="cpu")
    assert t.spec == spec
    m0, v0 = srv.predict(prob["U"][:6])
    m1, v1 = t.plan.routed_diag(prob["U"][:6])
    assert torch.equal(m0, m1) and torch.equal(v0, v1)
    sched = TenantScheduler(reg)
    n1 = prob["X"].shape[0] // 2
    sched.commit_store("restored", t.store.assimilate(
        _t(prob["X"][n1:]), _t(prob["y"][n1:])))
    assert sched.stats("restored").n_updates == 1
    # a store saved without a spec needs one
    bare = tmp_path / "bare.store.npz"
    serialize.save_store(bare, srv.store)
    with pytest.raises(ValueError, match="no ServeSpec"):
        reg.admit_from_checkpoint("t", bare, device="cpu")
    t2 = reg.admit_from_checkpoint("t", bare, device="cpu",
                                   spec=api.ServeSpec(max_batch=8))
    assert t2.max_batch == 8


def test_restore_store_resumes_bitwise(prob, tmp_path):
    spec = api.ServeSpec(max_batch=8, routed=True)
    srv = _pic_store_server(prob, spec=spec)
    path = tmp_path / "s.npz"
    srv.checkpoint_store(path)
    other = GPServer(prob["models"][1], spec=spec)
    pend = other.submit(prob["U"][0])
    other.restore_store(path)
    assert other.done(pend)             # flushed against the old state
    m0, v0 = srv.predict(prob["U"])
    m1, v1 = other.predict(prob["U"])
    assert torch.equal(m0, m1) and torch.equal(v0, v1)
    other.update(_t(prob["X"][48:]), _t(prob["y"][48:]))
    srv.update(_t(prob["X"][48:]), _t(prob["y"][48:]))
    assert torch.equal(srv.predict(prob["U"])[0], other.predict(prob["U"])[0])


def test_checkpoint_swap_and_detach(prob, tmp_path):
    srv_a = _pitc_store_server(prob)
    st = srv_a.model.state
    srv_b = GPServer(api.FittedGP(api.get("ppitc"), prob["kfn"],
                                  prob["params"],
                                  st._replace(alpha=2.0 * st.alpha)),
                     max_batch=8, store=srv_a.store)
    path = tmp_path / "replica.npz"
    srv_a.checkpoint(path)
    srv_b.swap_from_checkpoint(path)
    assert srv_b.store is None
    with pytest.raises(ValueError, match="StateStore"):
        srv_b.update(_t(prob["X"]), _t(prob["y"]))
    assert torch.equal(srv_a.predict(prob["U"])[0],
                       srv_b.predict(prob["U"])[0])
    assert srv_b.stats.n_state_swaps == 1
    routed = GPServer(prob["models"][0], max_batch=8, routed=True)
    with pytest.raises(ValueError, match="centroids"):
        routed.swap_from_checkpoint(path)
