"""The port's fault, straggler and elastic runtimes (``repro_torch.runtime``)
against the JAX package, in float64 on the CPU — all of
``tests/test_runtime.py``, with the reference's limits, plus the states and
posteriors of both packages side by side within 1e-10.

The straggler latencies come from numpy and are fed to both packages: the
port draws from a ``torch.Generator`` where the reference takes a JAX key,
so the same seed gives other numbers (the model is the same, and is tested
on its own here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import covariance as jcov, ppitc as jppitc
from repro.parallel.runner import VmapRunner as JVmapRunner
from repro.runtime import elastic as jelastic, fault as jfault, \
    straggler as jstraggler
from repro_torch import convert
from repro_torch.core import covariance as cov, online, pitc, ppitc
from repro_torch.parallel.runner import VmapRunner
from repro_torch.runtime import elastic, fault, straggler

STATE_TOL = 1e-10
ORACLE_TOL = 5e-6


def _t(a):
    return torch.tensor(np.asarray(a))


def _err(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - np.asarray(want)).max())


def _problem(n=96, u=24, s=12, d=3, M=4, seed=0):
    rng = np.random.default_rng(seed)
    X, S, U = (rng.normal(size=(k, d)) for k in (n, s, u))
    y = np.sin(X[:, 0]) * 2.0 + X[:, 1] - 0.5 * X[:, 2] ** 2 \
        + 0.3 * rng.normal(size=n)
    jparams = jcov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                               dtype=jnp.float64)
    return dict(X=X, y=y, S=S, U=U, M=M, jparams=jparams,
                params=convert.params_from_arrays(jparams, device="cpu"),
                kfn=cov.make_kernel("se"), jkfn=jcov.make_kernel("se"))


@pytest.fixture(scope="module")
def prob():
    return _problem()


def _cluster(p):
    return fault.build(p["kfn"], p["params"], _t(p["S"]), _t(p["X"]),
                       _t(p["y"]), VmapRunner(M=p["M"]))


def _jcluster(p):
    return jfault.build(p["jkfn"], p["jparams"], jnp.asarray(p["S"]),
                        jnp.asarray(p["X"]), jnp.asarray(p["y"]),
                        JVmapRunner(M=p["M"]))


# the latencies both packages get: the reference's model, drawn by numpy
def _latencies(M, seed=0, straggle_p=0.1):
    rng = np.random.default_rng(seed)
    lat = 1.0 + rng.exponential(size=M) * 0.2
    slow = rng.random(M) < straggle_p
    return np.where(slow, lat * 10.0 * (1 + rng.random(M)), lat)


class TestFault:
    def test_failure_gives_exact_surviving_posterior(self, prob):
        p = prob
        cl = fault.fail(_cluster(p), 2)
        fault.recover_degraded(cl)
        mean, _ = cl.store.predict(_t(p["U"]))
        b = p["X"].shape[0] // p["M"]
        keep = np.r_[0:2 * b, 3 * b:4 * b]
        surv = pitc.pitc_predict_literal(p["kfn"], p["params"], _t(p["S"]),
                                         _t(p["X"][keep]), _t(p["y"][keep]),
                                         _t(p["U"]), p["M"] - 1)
        assert _err(mean, surv.mean.numpy()) < ORACLE_TOL
        jcl = jfault.fail(_jcluster(p), 2)
        jmean, _ = jcl.store.predict(jnp.asarray(p["U"]))
        assert _err(mean, jmean) < STATE_TOL

    def test_reassign_restores_full_posterior(self, prob):
        """Fail, then recompute only the lost block: the original global
        summary again."""
        p = prob
        cl = _cluster(p)
        g0 = cl.store.global_summary()
        cl = fault.fail(cl, 1)
        b = p["X"].shape[0] // p["M"]
        Xm, ym = _t(p["X"][b:2 * b]), _t(p["y"][b:2 * b])
        cl = fault.recover_reassign(cl, Xm, ym, machine=1, new_owner=3)
        g1 = cl.store.global_summary()
        assert _err(g0.Sdd, g1.Sdd.numpy()) < 1e-9
        assert _err(g0.ydd, g1.ydd.numpy()) < 1e-9
        assert cl.owner.tolist() == [0, 3, 2, 3]
        assert cl.owner.dtype == torch.int32

    def test_multiple_failures_graceful(self, prob):
        p = prob
        cl = _cluster(p)
        for m in (0, 3):
            cl = fault.fail(cl, m)
        mean, var = cl.store.predict(_t(p["U"]))
        assert bool(torch.isfinite(mean).all())
        assert bool((torch.diagonal(var) > 0).all())

    def test_ladder_matches_the_reference(self, prob):
        """fail, fail, reassign: the cluster's state and its degraded
        global summary against the reference's at each rung."""
        p = prob
        cl, jcl = _cluster(p), _jcluster(p)
        b = p["X"].shape[0] // p["M"]
        Xm = np.random.default_rng(3).normal(size=(b, 3))
        ym = np.sin(Xm[:, 0])
        steps = [(lambda c: fault.fail(c, 0), lambda c: jfault.fail(c, 0)),
                 (lambda c: fault.fail(c, 2), lambda c: jfault.fail(c, 2)),
                 (lambda c: fault.recover_reassign(
                     c, _t(Xm), _t(ym), machine=2, new_owner=1),
                  lambda c: jfault.recover_reassign(
                     c, jnp.asarray(Xm), jnp.asarray(ym), machine=2,
                     new_owner=1))]
        for step, jstep in steps:
            cl, jcl = step(cl), jstep(jcl)
            for a, b_ in zip(cl.store.to_state(), jcl.store.to_state()):
                assert _err(a, b_) < STATE_TOL
            for a, b_ in zip(fault.recover_degraded(cl),
                             jfault.recover_degraded(jcl)):
                assert _err(a, b_) < STATE_TOL
            assert cl.owner.tolist() == np.asarray(jcl.owner).tolist()


class TestStraggler:
    def test_deadline_tradeoff_monotone(self, prob):
        """A longer deadline includes more blocks; the full deadline gives
        the exact full posterior."""
        p = prob
        cl = _cluster(p)
        lat = _latencies(p["M"])
        r_short = straggler.aggregate_with_deadline(
            cl.store, _t(lat), float(lat.min()), _t(p["U"]))
        r_full = straggler.aggregate_with_deadline(
            cl.store, _t(lat), float(lat.max()) + 1, _t(p["U"]))
        assert float(r_short.fraction) <= float(r_full.fraction)
        assert float(r_full.fraction) == 1.0
        full = pitc.pitc_predict_literal(p["kfn"], p["params"], _t(p["S"]),
                                         _t(p["X"]), _t(p["y"]), _t(p["U"]),
                                         p["M"])
        assert _err(r_full.mean, full.mean.numpy()) < ORACLE_TOL

    def test_partial_posterior_valid(self, prob):
        p = prob
        cl = _cluster(p)
        lat = _latencies(p["M"], straggle_p=0.5)
        r = straggler.aggregate_with_deadline(
            cl.store, _t(lat), float(np.median(lat)), _t(p["U"]))
        assert bool(torch.isfinite(r.mean).all())
        assert bool((r.var > 0).all())

    @pytest.mark.parametrize("q", [0.0, 0.3, 0.6, 1.0])
    def test_deadlines_match_the_reference(self, q):
        """The same latencies in both packages: the included mask, the
        fraction and the posterior at each deadline. M = 12 (b = 8 < |S|),
        so small flips take the incremental path and large ones the
        refold."""
        p = _problem(M=12)
        cl, jcl = _cluster(p), _jcluster(p)
        lat = _latencies(12, seed=4, straggle_p=0.4)
        deadline = float(np.quantile(lat, q))
        r = straggler.aggregate_with_deadline(cl.store, _t(lat), deadline,
                                              _t(p["U"]))
        jr = jstraggler.aggregate_with_deadline(jcl.store, jnp.asarray(lat),
                                                deadline, jnp.asarray(p["U"]))
        assert np.array_equal(r.included.numpy(), np.asarray(jr.included))
        # a float32 mean in both (the reference's type), summed in another
        # order: one float32 ulp apart at most
        assert abs(float(r.fraction) - float(jr.fraction)) <= 1.2e-7
        assert _err(r.mean, jr.mean) < STATE_TOL
        assert _err(r.var, jr.var) < STATE_TOL

    def test_latency_model(self):
        """The reference's model drawn from a torch.Generator: a body of
        1 + 0.2 Exp(1) and stragglers slowed 10-20x; the same seed gives
        the same draws."""
        g = torch.Generator().manual_seed(0)
        lat = straggler.sample_latencies(g, 4000)
        assert lat.shape == (4000,) and lat.dtype == torch.float32
        body = lat[lat < 10]
        slow = lat[lat >= 10]
        assert float(body.min()) >= 1.0
        assert abs(float(body.mean()) - 1.2) < 0.02
        assert abs(slow.numel() / 4000 - 0.1) < 0.02
        assert float(slow.min()) >= 10.0
        again = straggler.sample_latencies(torch.Generator().manual_seed(0),
                                           4000)
        assert torch.equal(lat, again)
        none = straggler.sample_latencies(torch.Generator().manual_seed(1),
                                          50, straggle_p=0.0)
        assert float(none.max()) < 10

    def test_simulate_sweeps_deadlines(self, prob):
        p = prob
        cl = _cluster(p)
        rows = straggler.simulate(torch.Generator().manual_seed(0), cl.store,
                                  _t(p["U"]), _t(np.sin(p["U"][:, 0])),
                                  [0.5, 1.5, 100.0])
        assert [r["deadline"] for r in rows] == [0.5, 1.5, 100.0]
        fr = [r["fraction"] for r in rows]
        assert fr == sorted(fr) and fr[-1] == 1.0
        assert all(np.isfinite(r["rmse"]) for r in rows[1:])


class TestElastic:
    def test_block_partition_machine_count_invariance(self):
        """Predictions depend on the LOGICAL block partition, not on how
        blocks map to machines: B = 8 blocks run as 8 blocks whatever the
        machine count (the reference's contract), and the port's equals
        the reference's."""
        p = _problem(n=128, u=32, M=8)
        args = (p["params"], _t(p["S"]), _t(p["X"]), _t(p["y"]), _t(p["U"]))
        ref = ppitc.predict(p["kfn"], *args, VmapRunner(M=8))
        for _ in (4, 2):
            q = ppitc.predict(p["kfn"], *args, VmapRunner(M=8))
            assert torch.equal(q.mean, ref.mean)
        jref = jppitc.predict(p["jkfn"], p["jparams"], jnp.asarray(p["S"]),
                              jnp.asarray(p["X"]), jnp.asarray(p["y"]),
                              jnp.asarray(p["U"]), JVmapRunner(M=8))
        assert _err(ref.mean, jref.mean) < STATE_TOL

    def test_plan_assignment_balanced(self):
        plan = elastic.plan_assignment(10, 3)
        sizes = [len(r) for r in plan]
        assert sum(sizes) == 10 and max(sizes) - min(sizes) <= 1
        assert plan == jelastic.plan_assignment(10, 3)

    def test_reshard_roundtrip(self):
        tree = {"s": torch.arange(24.0).reshape(8, 3)}
        m = elastic.reshard(tree, 4)
        assert m["s"].shape == (4, 2, 3)
        back = elastic.unshard(m)
        assert torch.equal(back["s"], tree["s"])
        jm = jelastic.reshard({"s": jnp.arange(24.0).reshape(8, 3)}, 4)
        assert np.array_equal(m["s"].numpy(), np.asarray(jm["s"]))

    def test_reshard_maps_over_namedtuples_and_rejects_ragged(self, prob):
        """A store's stacked summaries (a NamedTuple of tensors) move as
        blocks; a block count that does not divide raises."""
        store = _cluster(prob).store.store
        m = elastic.machine_view(store.locals_, 2)
        assert type(m) is type(store.locals_)
        assert m.Sdot.shape == (2, 2, 12, 12)
        back = elastic.unshard(m)
        assert all(torch.equal(a, b) for a, b in zip(back, store.locals_))
        assert elastic.blocks_per_machine(8, 4) == 2
        with pytest.raises(ValueError, match="divide"):
            elastic.reshard(store.locals_, 3)

    def test_online_scaleup_assimilation(self, prob):
        """Scale-up via streaming: new machines' blocks fold in online,
        equal to the reference's."""
        p = prob
        store = online.build(p["kfn"], p["params"], _t(p["S"]), _t(p["X"]),
                             _t(p["y"]), VmapRunner(M=p["M"]))
        X2 = np.random.default_rng(5).normal(size=(48, 3))
        y2 = np.sin(X2[:, 0]) * 2 + X2[:, 1]
        grown = online.assimilate(store, p["kfn"], p["params"], _t(p["S"]),
                                  _t(X2), _t(y2), VmapRunner(M=2))
        assert grown.alive.shape[0] == p["M"] + 2
        mean, _ = online.predict_ppitc(grown, p["kfn"], p["params"],
                                       _t(p["S"]), _t(p["U"]))
        assert bool(torch.isfinite(mean).all())
        from repro.core import online as jonline
        jstore = jonline.build(p["jkfn"], p["jparams"], jnp.asarray(p["S"]),
                               jnp.asarray(p["X"]), jnp.asarray(p["y"]),
                               JVmapRunner(M=p["M"]))
        jgrown = jonline.assimilate(jstore, p["jkfn"], p["jparams"],
                                    jnp.asarray(p["S"]), jnp.asarray(X2),
                                    jnp.asarray(y2), JVmapRunner(M=2))
        jmean, _ = jonline.predict_ppitc(jgrown, p["jkfn"], p["jparams"],
                                         jnp.asarray(p["S"]),
                                         jnp.asarray(p["U"]))
        assert _err(mean, jmean) < STATE_TOL
