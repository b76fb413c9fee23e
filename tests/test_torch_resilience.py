"""The port's self-healing serving (``serving/{health,chaos}``, the
scheduler's health ladder) and ``runtime/monitor`` against the JAX
package's, on the CPU in float64.

The same ``FaultPlan`` seeds and the same traffic on a virtual clock go
through both packages' health ladders: the retire and revive events
(the dispatch logs), the degraded flags, the stats and the per-block
health ledgers must be identical, and every ticket's (mean, var) within
1e-10. Each package revives from a store checkpoint it wrote itself; a
corrupt one is detected and never loaded. The monitor's heartbeats and
detector events match the reference's on a virtual clock. Inputs are made
with numpy from a seed and fed to both packages.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi, covariance as jcov, serialize as jser
from repro.parallel.runner import VmapRunner as JVmapRunner
from repro.runtime import monitor as jmonitor
from repro.serving import (BlockDied as JBlockDied,
                           FaultInjector as JFaultInjector,
                           FaultPlan as JFaultPlan,
                           HealthPolicy as JHealthPolicy,
                           HealthTracker as JHealthTracker,
                           TenantScheduler as JTenantScheduler)
from repro_torch import convert
from repro_torch.core import api, clustering, covariance as cov, ppic, \
    serialize as ser
from repro_torch.launch.gp_serve import GPServer
from repro_torch.parallel.runner import VmapRunner
from repro_torch.runtime import monitor
from repro_torch.serving import (BlockDied, FaultInjector, FaultPlan,
                                 HealthPolicy, HealthTracker,
                                 TenantScheduler)
from repro_torch.serving.chaos import poison_state

STATE_TOL = 1e-10


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _err(got, want) -> float:
    return float(np.abs(_np(got) - _np(want)).max())


@pytest.fixture(scope="module")
def prob():
    """The reference's resilience problem (n=160, |S|=12, d=3, M=4), drawn
    with numpy: a pPIC store and its fitted model in both packages."""
    rng = np.random.default_rng(1)
    n, s, d, M = 160, 12, 3, 4
    X, S = rng.normal(size=(n, d)), rng.normal(size=(s, d))
    y = np.sin(X[:, 0]) * 2.0 + X[:, 1] - 0.5 * X[:, 2] ** 2 \
        + 0.3 * rng.normal(size=n)
    jparams = jcov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                               dtype=jnp.float64)
    params = convert.params_from_arrays(jparams, device="cpu")
    store = api.init_store("ppic", cov.make_kernel("se"), params, _t(X),
                           _t(y), S=_t(S), runner=VmapRunner(M=M),
                           device="cpu")
    jstore = japi.init_store("ppic", jcov.make_kernel("se"), jparams,
                             jnp.asarray(X), jnp.asarray(y),
                             S=jnp.asarray(S), runner=JVmapRunner(M=M))
    model = api.FittedGP(api.get("ppic"), store.kfn, store.params,
                         store.to_state())
    jmodel = japi.FittedGP(japi.get("ppic"), jstore.kfn, jstore.params,
                           jstore.to_state())
    return dict(M=M, d=d, store=store, jstore=jstore, model=model,
                jmodel=jmodel, params=params)


class Clock:
    """Virtual time: the scheduler's ``clock`` and every injectable
    ``sleep`` (backoff, straggle) advance the same counter."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds


PORT = dict(api=api, ser=ser, Sched=TenantScheduler, Policy=HealthPolicy,
            Injector=FaultInjector, Plan=FaultPlan, Died=BlockDied,
            store="store", model="model")
JAX = dict(api=japi, ser=jser, Sched=JTenantScheduler, Policy=JHealthPolicy,
           Injector=JFaultInjector, Plan=JFaultPlan, Died=JBlockDied,
           store="jstore", model="jmodel")


def _tenant(pkg, prob, tmp_path, plan_kw, policy_kw, max_batch=8):
    """A routed tenant with health and chaos on a virtual clock, reviving
    from a store checkpoint its own package wrote."""
    a = pkg["api"]
    ckpt = os.fspath(tmp_path / f"{pkg['store']}.npz")
    spec = a.ServeSpec(max_batch=max_batch, routed=True)
    pkg["ser"].save_store(ckpt, prob[pkg["store"]], spec=spec)
    clk = Clock()
    policy = pkg["Policy"](**{**dict(max_retries=2,
                                     max_consecutive_failures=1,
                                     revive_after_ms=50.0),
                              **policy_kw, "checkpoint": ckpt})
    inj = pkg["Injector"](pkg["Plan"](**plan_kw), sleep=clk.sleep)
    sched = pkg["Sched"](clock=clk, sleep=clk.sleep)
    t = sched.admit("t", prob[pkg["model"]], spec, store=prob[pkg["store"]],
                    health=policy, chaos=inj)
    return sched, t, clk


def _collect(sched, tickets):
    return [sched.collect("t", tk) for tk in tickets]


def _outcome(sched, t, outs):
    return dict(log=list(sched.dispatch_log), stats=t.stats.snapshot(),
                health=t.health.snapshot(), chaos=t.chaos.snapshot(),
                degraded=[bool(o[2]) for o in outs])


def _scenario_fail_window(pkg, prob, tmp_path):
    sched, t, clk = _tenant(pkg, prob, tmp_path,
                            dict(fail_at={1: (3, 6)}), {})
    rng = np.random.RandomState(7)
    U = rng.randn(40, prob["d"])
    tickets = [sched.submit("t", x) for x in U]
    sched.flush("t")
    outs = _collect(sched, tickets)
    clk.t += 1.0
    sched.pump()                       # background revive
    U2 = rng.randn(8, prob["d"])
    tickets = [sched.submit("t", x) for x in U2]
    sched.flush("t")
    return sched, t, outs + _collect(sched, tickets)


def _scenario_nan_window(pkg, prob, tmp_path):
    sched, t, clk = _tenant(pkg, prob, tmp_path, dict(nan_at={2: (0, 4)}),
                            {})
    U = np.random.RandomState(3).randn(24, prob["d"])
    tickets = [sched.submit("t", x) for x in U]
    sched.flush("t")
    return sched, t, _collect(sched, tickets)


def _scenario_straggler(pkg, prob, tmp_path):
    """Flushes alternate between straggler-free and straggler batches, so
    the latency EMAs separate and the blame lands on block 1."""
    sched, t, clk = _tenant(
        pkg, prob, tmp_path, dict(straggle_ms={1: 200.0}),
        dict(flush_timeout_ms=50.0, max_retries=1,
             max_consecutive_failures=2, revive_after_ms=1e9))
    C = np.asarray(prob["jmodel"].state.centroids)
    tickets = []
    for _ in range(3):
        for rows in (C[[0, 2, 3]], C[[0, 1]]):
            tickets += [sched.submit("t", x) for x in rows]
            sched.flush("t")
    return sched, t, _collect(sched, tickets)


def _scenario_random(pkg, prob, tmp_path):
    sched, t, clk = _tenant(
        pkg, prob, tmp_path,
        dict(fail_at={0: (2, 4), 2: (7, 9)}, straggle_ms={3: 0.2}), {})
    rng = np.random.RandomState(11)
    tickets = []
    for step in range(120):
        clk.t += float(rng.exponential(0.002))
        tickets.append(sched.submit("t", rng.randn(prob["d"])))
        if step % 17 == 16:
            clk.t += 0.2
            sched.pump()
    sched.flush("t")
    outs = _collect(sched, tickets)
    clk.t += 1.0
    sched.pump()
    tickets = [sched.submit("t", x) for x in rng.randn(16, prob["d"])]
    sched.flush("t")
    return sched, t, outs + _collect(sched, tickets)


def _scenario_corrupt(pkg, prob, tmp_path):
    sched, t, clk = _tenant(pkg, prob, tmp_path, dict(fail_at={1: (0, 2)}),
                            {})
    t.chaos.corrupt(t.health.policy.checkpoint)
    rng = np.random.RandomState(9)
    tickets = [sched.submit("t", x) for x in rng.randn(16, prob["d"])]
    sched.flush("t")
    clk.t += 1.0
    sched.pump()                       # refused: the artifact is corrupt
    tickets += [sched.submit("t", x) for x in rng.randn(8, prob["d"])]
    sched.flush("t")
    outs = _collect(sched, tickets)
    pkg["ser"].save_store(t.health.policy.checkpoint, prob[pkg["store"]],
                          spec=t.spec)
    clk.t += 1.0
    sched.pump()                       # repaired: revives
    return sched, t, outs


SCENARIOS = {"fail_window": _scenario_fail_window,
             "nan_window": _scenario_nan_window,
             "straggler": _scenario_straggler,
             "random_traffic": _scenario_random,
             "corrupt_checkpoint": _scenario_corrupt}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_health_ladder_matches_the_reference(prob, tmp_path, name):
    run = SCENARIOS[name]
    sched, t, outs = run(PORT, prob, tmp_path)
    jsched, jt, jouts = run(JAX, prob, tmp_path)
    got, want = _outcome(sched, t, outs), _outcome(jsched, jt, jouts)
    assert got == want
    assert len(outs) == len(jouts)
    for (m, v, _), (jm, jv, _) in zip(outs, jouts):
        assert isinstance(m, torch.Tensor)
        assert bool(torch.isfinite(m)) and bool(torch.isfinite(v))
        assert max(_err(m, jm), _err(v, jv)) <= STATE_TOL
    s = got["stats"]
    if name in ("fail_window", "random_traffic"):
        assert s["n_auto_retired"] >= 1 and s["n_revives"] >= 1
        assert any(e[1] == "revive" for e in got["log"])
        assert got["health"]["dead_blocks"] == []
    if name == "nan_window":
        assert s["n_nonfinite_flushes"] >= 1
        assert 2 in got["health"]["dead_blocks"]
    if name == "straggler":
        assert s["n_timeout_flushes"] >= 1
        assert got["health"]["dead_blocks"] == [1]
    if name == "corrupt_checkpoint":
        assert (s["n_revive_failures"], s["n_revives"]) == (1, 1)


def test_a_corrupt_checkpoint_is_never_loaded(prob, tmp_path, monkeypatch):
    """The revive reads the corrupt file, refuses it before making one
    tensor of it, counts the failure and keeps the tenant as it was
    (degraded, serving finite answers)."""
    sched, t, clk = _tenant(PORT, prob, tmp_path, dict(fail_at={1: (0, 2)}),
                            {})
    t.chaos.corrupt(t.health.policy.checkpoint)
    rng = np.random.RandomState(9)
    tickets = [sched.submit("t", x) for x in rng.randn(16, prob["d"])]
    sched.flush("t")
    assert t.health.dead_blocks() == [1]
    made = []
    real = ser._tensor
    monkeypatch.setattr(ser, "_tensor",
                        lambda *a: made.append(a[1]) or real(*a))
    store, state, plan = t.store, t.model.state, t.plan
    clk.t += 1.0
    sched.pump()
    assert made == []
    assert t.stats.n_revive_failures == 1 and t.stats.n_revives == 0
    assert t.store is store and t.model.state is state and t.plan is plan
    assert t.health.dead_blocks() == [1]
    with pytest.raises(ser.CheckpointError):
        ser.load_store(t.health.policy.checkpoint, device="cpu")
    for m, v, _ in _collect(sched, tickets):
        assert bool(torch.isfinite(m)) and bool(torch.isfinite(v))


def test_poisoned_state_heals_to_bitwise(prob, tmp_path):
    """NaN-poisoned block factors (``chaos.poison_state``) through the real
    compute path: retired on the first flush, its rows served degraded,
    revived from the checkpoint on ``pump``, then bitwise the unpoisoned
    output, with no new callable."""
    ckpt = tmp_path / "s.npz"
    spec = api.ServeSpec(max_batch=8, routed=True)
    ser.save_store(ckpt, prob["store"], spec=spec)
    clk = Clock()
    srv = GPServer(prob["model"], spec=spec, store=prob["store"], clock=clk,
                   sleep=clk.sleep,
                   health=HealthPolicy(max_consecutive_failures=1,
                                       checkpoint=ckpt))
    srv.plan.warmup(prob["d"], dtype=torch.float64)
    traces = srv.plan.stats.n_traces
    U = np.random.RandomState(5).randn(24, prob["d"])

    def serve():
        tk = [srv.submit(x) for x in U]
        srv.flush()
        return [srv.collect(k) for k in tk]

    before = serve()
    assign = clustering.nearest_center_np(U, srv.plan._centroids_host)
    k = int(np.bincount(assign).argmax())
    srv.swap_state(poison_state(srv.model.state, k))
    assert torch.isnan(srv.model.state.C_L[k]).all()
    assert not torch.isnan(prob["model"].state.C_L).any()
    during = serve()
    assert srv.health.dead_blocks() == [k]
    assert [bool(d) for _, _, d in during] == list(assign == k)
    for m, v, _ in during:
        assert bool(torch.isfinite(m)) and bool(torch.isfinite(v))
    srv.pump()
    assert srv.health.dead_blocks() == [] and srv.stats.n_revives == 1
    after = serve()
    for (m0, v0, _), (m1, v1, d1) in zip(before, after):
        assert not d1 and torch.equal(m0, m1) and torch.equal(v0, v1)
    assert srv.plan.stats.n_traces == traces


# ---------------------------------------------------------------------------
# Degraded routing through the port's plan
# ---------------------------------------------------------------------------

def test_degraded_rows_are_the_global_posterior(prob):
    model = prob["model"]
    plan = model.plan(api.ServeSpec(max_batch=16, routed=True))
    U = _t(np.random.RandomState(2).randn(16, prob["d"]))
    alive = np.ones(prob["M"], bool)
    alive[1] = False
    m_base, v_base = plan.routed_diag(U)
    m_deg, v_deg = plan.routed_diag(U, block_alive=alive)
    deg = plan.stats.last_degraded
    assign = clustering.nearest_center_np(_np(U), plan._centroids_host)
    assert np.array_equal(deg, assign == 1) and deg.any()
    m_glob, v_glob = ppic.global_diag(plan.kfn, plan.params, plan.state, U)
    dg = torch.as_tensor(deg)
    assert _err(m_deg[dg], m_glob[dg]) <= STATE_TOL
    assert _err(v_deg[dg], v_glob[dg]) <= STATE_TOL
    assert torch.equal(m_deg[~dg], m_base[~dg])
    assert torch.equal(v_deg[~dg], v_base[~dg])
    with pytest.raises(ValueError, match="block_alive"):
        plan.routed_diag(U, block_alive=np.ones(prob["M"] + 1, bool))


def test_chaos_without_health_hits_the_caller_raw(prob):
    sched = TenantScheduler(clock=Clock())
    sched.admit("t", prob["model"], api.ServeSpec(max_batch=8, routed=True),
                chaos=FaultPlan(fail_at={0: 0, 1: 0, 2: 0, 3: 0}))
    sched.submit("t", np.zeros(prob["d"]))
    with pytest.raises(BlockDied):
        sched.flush("t")
    assert sched.pending("t") == 1      # the queue survives the failure


# ---------------------------------------------------------------------------
# Health bookkeeping and the fault harness, against the reference
# ---------------------------------------------------------------------------

def test_policy_validation():
    for kw in (dict(max_retries=-1), dict(max_consecutive_failures=0),
               dict(backoff_jitter=1.5), dict(backoff_base_ms=-1.0)):
        with pytest.raises(ValueError):
            HealthPolicy(**kw)
        with pytest.raises(ValueError):
            JHealthPolicy(**kw)
    with pytest.raises(ValueError):
        HealthTracker(0, HealthPolicy())


def test_tracker_matches_the_reference():
    h = HealthTracker(3, HealthPolicy(max_consecutive_failures=2, seed=42))
    j = JHealthTracker(3, JHealthPolicy(max_consecutive_failures=2, seed=42))
    for tr in (h, j):
        tr.observe_latency([0, 1], 10.0)
        tr.observe_latency([1, 2], 90.0)
    assert h.slowest_of([0, 1, 2]) == j.slowest_of([0, 1, 2]) == 2
    assert h.slowest_of([0, 1]) == j.slowest_of([0, 1]) == 1
    steps = []
    for tr in (h, j):
        steps.append([tr.record_failure(1), tr.record_success([1]),
                      tr.record_failure(1), tr.record_failure(1),
                      tr.mark_dead(1, now=10.0), tr.mark_dead(1, now=11.0),
                      tr.dead_blocks(), tr.slowest_of([1]),
                      list(tr.alive_mask()), tr.snapshot(),
                      [tr.backoff_ms(i) for i in range(5)],
                      tr.revive_all(now=12.0), tr.snapshot()])
    assert steps[0] == steps[1]
    flat = HealthTracker(2, HealthPolicy(backoff_jitter=0.0,
                                         backoff_base_ms=2.0))
    assert [flat.backoff_ms(i) for i in range(3)] == [2.0, 4.0, 8.0]


def _chaos_log(Injector, Plan, Died, tensors: bool):
    """One schedule's events: the port's poison takes tensors, the
    reference's host arrays."""
    plan = Plan(fail_at={1: (2, 5)}, nan_at={0: 3}, straggle_ms={2: 1.0},
                seed=7)
    clk = Clock()
    inj = Injector(plan, sleep=clk.sleep)
    log = []
    assign = np.array([0, 1, 2])
    alive = np.ones(3, bool)
    for _ in range(6):
        try:
            inj.before_dispatch(assign, alive)
            log.append(("ok", round(clk.t, 6)))
        except Died as e:
            log.append(("died", e.block, e.flush_index))
        mean = torch.zeros(3, dtype=torch.float64) if tensors else \
            np.zeros(3)
        m2, v2 = inj.poison(assign, mean, mean.clone() if tensors else
                            mean.copy(), alive)
        log.append(tuple(bool(x) for x in np.isnan(_np(m2))))
        assert type(m2) is type(mean)
    log.append(inj.snapshot())
    return log


def test_fault_schedule_matches_the_reference():
    got = _chaos_log(FaultInjector, FaultPlan, BlockDied, True)
    assert got == _chaos_log(FaultInjector, FaultPlan, BlockDied, True)
    assert got == _chaos_log(JFaultInjector, JFaultPlan, JBlockDied, False)


def test_fault_windows_and_the_routing_mask():
    clk = Clock()
    inj = FaultInjector(FaultPlan(fail_at={0: (1, 3)}), sleep=clk.sleep)
    assign, alive = np.array([0]), np.ones(1, bool)
    inj.before_dispatch(assign, alive)
    for _ in range(2):
        with pytest.raises(BlockDied):
            inj.before_dispatch(assign, alive)
    inj.before_dispatch(assign, alive)
    assert inj.n_injected_faults == 2
    inj = FaultInjector(FaultPlan(fail_at={1: 0}))
    inj.before_dispatch(np.array([0, 1]), np.array([True, False]))
    with pytest.raises(BlockDied):
        inj.before_dispatch(np.array([0, 1]), np.array([True, True]))
    plan = FaultPlan(burst_at_steps={3: 10})
    assert plan.burst_at(3) == 10 and plan.burst_at(4) == 0


def test_poison_keeps_tensors_on_their_device_and_spares_dead_rows():
    inj = FaultInjector(FaultPlan(nan_at={1: 0}))
    inj.before_dispatch(None, None)
    mean = torch.arange(4, dtype=torch.float64)
    assign = np.array([0, 1, 1, 2])
    m, v = inj.poison(assign, mean, mean + 1)
    assert m.device == mean.device and not torch.isnan(mean).any()
    assert torch.isnan(m).tolist() == [False, True, True, False]
    m, _ = inj.poison(assign, mean, mean, alive=np.array([True, False,
                                                          True]))
    assert not torch.isnan(m).any()


def test_poison_state_organic_nan(prob):
    model = prob["model"]
    bad = api.FittedGP(model.method, model.kfn, model.params,
                       poison_state(model.state, 1))
    assert bad.state.Xb is model.state.Xb
    plan = bad.plan(api.ServeSpec(max_batch=16, routed=True))
    U = np.random.RandomState(4).randn(16, prob["d"])
    assign = clustering.nearest_center_np(U, plan._centroids_host)
    m, _ = plan.routed_diag(U)
    assert torch.isnan(m[torch.as_tensor(assign == 1)]).all()
    alive = np.ones(prob["M"], bool)
    alive[1] = False
    m2, v2 = plan.routed_diag(U, block_alive=alive)
    assert torch.isfinite(m2).all() and torch.isfinite(v2).all()


def test_health_gpserver_surface(prob):
    srv = GPServer(prob["model"], spec=api.ServeSpec(max_batch=4,
                                                      routed=True),
                   health=True)
    snap = srv.health_snapshot()
    assert snap["n_blocks"] == prob["M"] and snap["dead_blocks"] == []
    tk = srv.submit(np.zeros(prob["d"]))
    srv.flush()
    m, v, dg = srv.collect(tk)
    assert not dg and bool(torch.isfinite(m))
    plain = GPServer(prob["model"], spec=api.ServeSpec(max_batch=4,
                                                        routed=True))
    assert plain.health is None and plain.health_snapshot() is None
    assert dataclasses.replace(HealthPolicy(), seed=3).seed == 3


# ---------------------------------------------------------------------------
# runtime/monitor on a virtual clock, against the reference
# ---------------------------------------------------------------------------

def _detector_events(mod):
    t = [0.0]
    det = mod.FailureDetector(4, timeout=1.0, clock=lambda: t[0])
    events = []
    for now, beats in ((1.0, (0, 1, 3)), (1.8, ()), (2.5, (2,)),
                       (3.1, (0,)), (4.0, (1, 2, 3)), (5.2, ())):
        t[0] = now
        for m in beats:
            det.heartbeat(m)
        events.append((det.sweep(), det.alive_mask,
                       [det.machines[m].failures for m in range(4)]))
    return events


def _train_metrics(mod):
    t = [0.0]
    mon = mod.TrainMonitor(tokens_per_step=1000, stall_factor=5.0,
                           clock=lambda: t[0])
    out = []
    for i, dt in enumerate((0.1, 0.1, 0.12, 0.09, 0.3, 0.1)):
        t[0] += dt
        m = mon.step(loss=2.0 - 0.1 * i)
        out.append((dataclasses.astuple(m), mon.is_stalled()))
    t[0] += 10.0
    out.append(mon.is_stalled())
    e = mod.Ema(alpha=0.5)
    out.append((e.get(7.0), e.update(0.0), e.update(2.0), e.value))
    return out


def test_monitor_matches_the_reference():
    assert _detector_events(monitor) == _detector_events(jmonitor)
    assert _train_metrics(monitor) == _train_metrics(jmonitor)
    ev = _detector_events(monitor)
    assert ev[1][0] == [2] and ev[-1][0] == [0, 1, 2, 3]
