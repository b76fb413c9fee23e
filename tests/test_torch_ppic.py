"""The port's pPIC slice (fit, PICStore, positional and routed serving, the
plan with its overflow ladder, cached C⁻¹ and bounded degradation, the PIC
and PITC registrations) against the JAX package, in float64 on the CPU.

Tolerances are the reference's own: 1e-10 for state and serving
(tests/test_shardmap.py), ORACLE_TOL = 5e-6 against the centralized
oracles, and for the cached C⁻¹ against the trsm path 1e-3 in float32 and
1e-10 in float64 (tests/test_plan.py). Inputs are made with numpy from a
seed and fed to both packages; JAX-fitted states are carried across with
``convert.state_from_arrays``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi, covariance as jcov, online as jonline, \
    pitc as jpitc, ppic as jppic, ppitc as jppitc
from repro.parallel.runner import VmapRunner as JVmapRunner
from repro_torch import convert
from repro_torch.core import api, clustering, covariance as cov, online, \
    pitc, ppic, ppitc
from repro_torch.parallel.runner import VmapRunner, routed_capacity

STATE_TOL = 1e-10
ORACLE_TOL = 5e-6
CINV_TOL_F32 = 1e-3
CINV_TOL_F64 = 1e-10


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _err(got, want) -> float:
    return float(np.abs(_np(got).astype(np.float64)
                        - _np(want).astype(np.float64)).max())


def _make(dtype):
    """tests/helpers.make_problem's shapes (n=96, u=24, |S|=12, d=3, M=4),
    drawn with numpy; both packages fit the same arrays."""
    rng = np.random.default_rng(0)
    n, u, s, d, M = 96, 24, 12, 3, 4
    X, S, U = (rng.normal(size=(k, d)).astype(dtype) for k in (n, s, u))
    y = (np.sin(X[:, 0]) * 2.0 + X[:, 1] - 0.5 * X[:, 2] ** 2
         + 0.3 * rng.normal(size=n)).astype(dtype)
    jparams = jcov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                               dtype=jnp.dtype(dtype))
    params = convert.params_from_arrays(jparams, device="cpu")
    jkfn, kfn = jcov.make_kernel("se"), cov.make_kernel("se")
    jmodel = japi.fit("ppic", jkfn, jparams, jnp.asarray(X), jnp.asarray(y),
                      S=jnp.asarray(S), runner=JVmapRunner(M=M))
    model = api.fit("ppic", kfn, params, _t(X), _t(y), S=_t(S),
                    runner=VmapRunner(M=M), device="cpu")
    # the JAX state served by the port: identical inputs to both servers
    carried = api.FittedGP(api.get("ppic"), kfn, params,
                           convert.state_from_arrays(jmodel.state,
                                                     device="cpu"))
    return dict(X=X, y=y, S=S, U=U, M=M, jparams=jparams, params=params,
                jkfn=jkfn, kfn=kfn, jmodel=jmodel, model=model,
                carried=carried)


@pytest.fixture(scope="module")
def prob():
    return _make(np.float64)


@pytest.fixture(scope="module")
def prob32():
    return _make(np.float32)


# ---------------------------------------------------------------------------
# Fit.
# ---------------------------------------------------------------------------

def test_fit_state_matches_reference(prob):
    st, jst = prob["model"].state, prob["jmodel"].state
    assert isinstance(st, api.PICState)
    assert api.PICState._fields == type(jst)._fields
    for f in api.PICState._fields:
        assert getattr(st, f).shape == getattr(jst, f).shape, f
        assert _err(getattr(st, f), getattr(jst, f)) < STATE_TOL, f


def test_fit_pic_matches_reference(prob):
    st = pitc.fit_pic(prob["kfn"], prob["params"], _t(prob["X"]),
                      _t(prob["y"]), S=_t(prob["S"]), M=prob["M"])
    jst = jpitc.fit_pic(prob["jkfn"], prob["jparams"],
                        jnp.asarray(prob["X"]), jnp.asarray(prob["y"]),
                        S=jnp.asarray(prob["S"]), M=prob["M"])
    for f in api.PICState._fields:
        assert _err(getattr(st, f), getattr(jst, f)) < STATE_TOL, f
    model = api.fit("pic", prob["kfn"], prob["params"], _t(prob["X"]),
                    _t(prob["y"]), S=_t(prob["S"]), M=prob["M"],
                    device="cpu")
    for a, b in zip(model.state, st):
        assert torch.equal(a, b)


def test_fit_pitc_matches_reference(prob):
    st = pitc.fit(prob["kfn"], prob["params"], _t(prob["X"]),
                  _t(prob["y"]), S=_t(prob["S"]), M=prob["M"])
    jst = jpitc.fit(prob["jkfn"], prob["jparams"], jnp.asarray(prob["X"]),
                    jnp.asarray(prob["y"]), S=jnp.asarray(prob["S"]),
                    M=prob["M"])
    for f in api.PITCState._fields:
        assert _err(getattr(st, f), getattr(jst, f)) < STATE_TOL, f


def _stores(prob):
    args = (_t(prob["X"]), _t(prob["y"]))
    store = online.init_pic_store(prob["kfn"], prob["params"], *args,
                                  S=_t(prob["S"]),
                                  runner=VmapRunner(M=prob["M"]))
    jstore = jonline.init_pic_store(prob["jkfn"], prob["jparams"],
                                    jnp.asarray(prob["X"]),
                                    jnp.asarray(prob["y"]),
                                    S=jnp.asarray(prob["S"]),
                                    runner=JVmapRunner(M=prob["M"]))
    return store, jstore


def test_pic_store_blocks_match_reference(prob):
    store, jstore = _stores(prob)
    assert store.block_size == jstore.block_size == 24
    for f in online.PICBlocks._fields:
        assert _err(getattr(store.blocks, f),
                    getattr(jstore.blocks, f)) < STATE_TOL, f
    for f in ("F", "Kss_L", "Sdd_L", "ydd"):
        assert _err(getattr(store.store, f),
                    getattr(jstore.store, f)) < STATE_TOL, f


@pytest.mark.parametrize("dead", [(1,), (0, 3)])
def test_pic_store_to_state_gathers_alive_blocks(prob, dead):
    """``to_state`` over a store with dead blocks keeps only the alive
    blocks' caches and refreshes the centroids, as the reference does (the
    global factors are the store's own, unchanged here in both)."""
    store, jstore = _stores(prob)
    alive = np.ones(prob["M"], bool)
    alive[list(dead)] = False
    st = online.PICStore(store.kfn, store.params, store.S, store.runner,
                         store.store._replace(alive=_t(alive)),
                         store.blocks).to_state()
    jst = jonline.PICStore(
        jstore.kfn, jstore.params, jstore.S, jstore.runner,
        jstore.store._replace(alive=jnp.asarray(alive)),
        jstore.blocks).to_state()
    assert st.Xb.shape[0] == prob["M"] - len(dead)
    for f in api.PICState._fields:
        assert _err(getattr(st, f), getattr(jst, f)) < STATE_TOL, f


@pytest.mark.parametrize("call", [lambda s, X, y: s.assimilate(X, y),
                                  lambda s, X, y: s.retire(0),
                                  lambda s, X, y: s.retire(0).revive(0)])
def test_pic_store_streaming_waits_for_rank_updates(prob, call):
    """The store's streaming calls (they raised until the rank-b updates
    were ported) emit the reference's state: a wave of the same data
    assimilated, a block retired, and retired then revived."""
    store, jstore = _stores(prob)
    st = call(store, _t(prob["X"]), _t(prob["y"])).to_state()
    jst = call(jstore, jnp.asarray(prob["X"]),
               jnp.asarray(prob["y"])).to_state()
    for f in api.PICState._fields:
        assert getattr(st, f).shape == getattr(jst, f).shape, f
        assert _err(getattr(st, f), getattr(jst, f)) < STATE_TOL, f


# ---------------------------------------------------------------------------
# Serving on a JAX state carried across.
# ---------------------------------------------------------------------------

def _both(prob, name, U, **kw):
    state = prob["carried"].state
    got = getattr(ppic, name)(prob["kfn"], prob["params"], state, _t(U),
                              **kw)
    want = getattr(jppic, name)(prob["jkfn"], prob["jparams"],
                                prob["jmodel"].state, jnp.asarray(U), **kw)
    return got, want


@pytest.mark.parametrize("u", [1, 7, 24])
@pytest.mark.parametrize("name", ["predict_batch_diag", "predict_routed_diag",
                                  "predict_routed_diag_capacity",
                                  "global_diag"])
def test_diag_entry_points_match_reference(prob, name, u):
    (m, v), (jm, jv) = _both(prob, name, prob["U"][:u])
    assert m.shape == (u,) and v.shape == (u,)
    assert _err(m, jm) < STATE_TOL and _err(v, jv) < STATE_TOL


@pytest.mark.parametrize("u", [1, 7, 24])
@pytest.mark.parametrize("name", ["predict_batch", "predict_routed"])
def test_dense_entry_points_match_reference(prob, name, u):
    post, jpost = _both(prob, name, prob["U"][:u])
    assert post.cov.shape == (u, u)
    assert _err(post.mean, jpost.mean) < STATE_TOL
    assert _err(post.cov, jpost.cov) < STATE_TOL


def test_predict_blocks_matches_reference(prob):
    post, jpost = _both(prob, "predict_blocks", prob["U"])
    assert post.blocks.shape == (prob["M"], 6, 6)
    for a, b in ((post.mean, jpost.mean), (post.blocks, jpost.blocks),
                 (post.var, jpost.var)):
        assert _err(a, b) < STATE_TOL
    with pytest.raises(ValueError, match="must divide"):
        ppic.predict_blocks(prob["kfn"], prob["params"],
                            prob["carried"].state, _t(prob["U"][:5]))


def test_predict_from_summary_matches_reference(prob):
    """Eqs. (12)-(14) from the machines' summaries, every machine at once,
    against the reference's posterior of the fitted state over the same
    blocks (``predict_blocks``), which factors Sdd + jitter·mean diag(K_SS)
    as the port does. The reference's ``predict_from_summary`` factors
    Sdd + jitter·mean diag(Sdd), another matrix: it is held to the same
    blocks within the change that jitter makes (measured here, and more
    than 1e-10)."""
    import jax
    M = prob["M"]
    S, Xb = _t(prob["S"]), _t(prob["X"]).reshape(M, -1, 3)
    yb, Ub = _t(prob["y"]).reshape(M, -1), _t(prob["U"]).reshape(M, -1, 3)
    kfn, params = prob["kfn"], prob["params"]
    from repro_torch.core import linalg
    Kss_L = linalg.chol(kfn(params, S, S))
    loc, (Ksd, C_L, _) = ppitc.local_summary(kfn, params, S, Kss_L, Xb, yb)
    glob = ppitc.global_summary(kfn, params, S, loc,
                                axis_name=VmapRunner(M=M).axis)
    from repro.core import linalg as jlinalg
    jS = jnp.asarray(prob["S"])
    jKss_L = jlinalg.chol(prob["jkfn"](prob["jparams"], jS, jS))
    jloc, jglob = jppitc.summaries(prob["jkfn"], prob["jparams"], jS,
                                   jnp.asarray(prob["X"]),
                                   jnp.asarray(prob["y"]),
                                   JVmapRunner(M=M))
    jpost = jppic.predict_blocks(prob["jkfn"], prob["jparams"],
                                 prob["jmodel"].state, jnp.asarray(prob["U"]))
    jmean, jcovm = jax.vmap(
        lambda lo, Xm, ym, Um: jppic.predict_from_summary(
            prob["jkfn"], prob["jparams"], jS, jKss_L, lo, jglob, Xm,
            ym, Um))(jloc, jnp.asarray(_np(Xb)), jnp.asarray(_np(yb)),
                     jnp.asarray(_np(Ub)))
    jitter_gap = max(_err(jmean, jpost.mean.reshape(M, -1)),
                     _err(jcovm, jpost.blocks))
    assert jitter_gap > STATE_TOL
    for kw in (dict(), dict(Ksd=Ksd, C_L=C_L)):
        mean, covm = ppic.predict_from_summary(kfn, params, S, Kss_L, loc,
                                               glob, Xb, yb, Ub, **kw)
        assert _err(mean.reshape(-1), jpost.mean) < STATE_TOL
        assert _err(covm, jpost.blocks) < STATE_TOL
        assert max(_err(mean, jmean), _err(covm, jcovm)) <= 2 * jitter_gap


@pytest.mark.parametrize("cinv", [False, True])
@pytest.mark.parametrize("u", [1, 5, 24])
def test_plan_routed_diag_matches_reference(prob, cinv, u):
    spec = dict(max_batch=16, routed=True, cached_cinv=cinv)
    plan = prob["carried"].plan(api.ServeSpec(**spec))
    jplan = prob["jmodel"].plan(japi.ServeSpec(**spec))
    assert (plan.caches.Cinv is None) == (not cinv)
    m, v = plan.routed_diag(_t(prob["U"][:u]))
    jm, jv = jplan.routed_diag(prob["U"][:u])
    assert _err(m, jm) < STATE_TOL and _err(v, jv) < STATE_TOL
    assert plan.stats.last_g == jplan.stats.last_g
    assert plan.stats.n_g0_batches == jplan.stats.n_g0_batches


@pytest.mark.parametrize("cinv", [False, True])
@pytest.mark.parametrize("dead", [(1,), (0, 2), (0, 1, 2, 3)])
def test_plan_routed_diag_block_alive_matches_reference(prob, cinv, dead):
    spec = dict(max_batch=16, routed=True, cached_cinv=cinv)
    plan = prob["carried"].plan(api.ServeSpec(**spec))
    jplan = prob["jmodel"].plan(japi.ServeSpec(**spec))
    alive = np.ones(prob["M"], bool)
    alive[list(dead)] = False
    before = plan.stats.n_degraded_rows
    m, v = plan.routed_diag(_t(prob["U"]), block_alive=alive)
    jm, jv = jplan.routed_diag(prob["U"], block_alive=alive)
    assert _err(m, jm) < STATE_TOL and _err(v, jv) < STATE_TOL
    np.testing.assert_array_equal(plan.stats.last_degraded,
                                  np.asarray(jplan.stats.last_degraded))
    assert plan.stats.n_degraded_rows - before == \
        int(plan.stats.last_degraded.sum())


def test_plan_diag_and_full_match_reference(prob):
    plan = prob["carried"].plan(api.ServeSpec(max_batch=16))
    jplan = prob["jmodel"].plan(japi.ServeSpec(max_batch=16))
    for u in (3, 24):
        m, v = plan.diag(_t(prob["U"][:u]))
        jm, jv = jplan.diag(prob["U"][:u])
        assert _err(m, jm) < STATE_TOL and _err(v, jv) < STATE_TOL
    post, jpost = plan.full(_t(prob["U"])), jplan.full(prob["U"])
    assert _err(post.cov, jpost.cov) < STATE_TOL


def test_fitted_gp_predict_routed_diag(prob):
    m, v = prob["model"].predict_routed_diag(_t(prob["U"]))
    jm, jv = prob["jmodel"].predict_routed_diag(prob["U"])
    assert _err(m, jm) < STATE_TOL and _err(v, jv) < STATE_TOL


def test_routed_plan_matches_routed_literal_oracle(prob):
    """The port's plan, end to end (fit + routed serving), within
    ORACLE_TOL of the reference's literal routed PIC oracle."""
    m, v = prob["model"].plan(api.ServeSpec(max_batch=16, routed=True)) \
        .routed_diag(_t(prob["U"]))
    assign = clustering.nearest_center_np(
        prob["U"], prob["model"].state.centroids.numpy())
    lit = jpitc.pic_predict_literal_routed(
        prob["jkfn"], prob["jparams"], jnp.asarray(prob["S"]),
        jnp.asarray(prob["X"]), jnp.asarray(prob["y"]),
        jnp.asarray(prob["U"]), prob["M"], assign)
    assert _err(m, lit.mean) < ORACLE_TOL
    assert _err(v, jnp.diag(lit.cov)) < ORACLE_TOL


@pytest.mark.parametrize("method", ["pic", "ppic"])
def test_pic_family_serves_through_the_pic_plan(prob, method):
    kw = dict(M=prob["M"]) if method == "pic" else \
        dict(runner=VmapRunner(M=prob["M"]))
    model = api.fit(method, prob["kfn"], prob["params"], _t(prob["X"]),
                    _t(prob["y"]), S=_t(prob["S"]), device="cpu", **kw)
    plan = model.plan(api.ServeSpec(max_batch=8, routed=True))
    assert isinstance(plan, ppic.PICServePlan)
    m, _ = plan.routed_diag(_t(prob["U"][:6]))
    jm, _ = prob["jmodel"].plan(japi.ServeSpec(max_batch=8, routed=True)) \
        .routed_diag(prob["U"][:6])
    assert _err(m, jm) < STATE_TOL


# ---------------------------------------------------------------------------
# The plan: overflow ladder, pads, cached C⁻¹, degradation (float32, as the
# reference's tests/test_plan.py and tests/test_resilience.py).
# ---------------------------------------------------------------------------

def _skewed(c, target, u, seed):
    rng = np.random.RandomState(seed)
    return (np.tile(c[target], (u, 1))
            + 0.01 * rng.randn(u, c.shape[1])).astype(np.float32)


@pytest.mark.parametrize("u", [1, 5, 8, 24])
def test_routed_plan_equals_worst_case_program_bitwise(prob32, u):
    model = prob32["model"]
    plan = model.plan(api.ServeSpec(max_batch=16, routed=True))
    U = prob32["U"][:u]
    m, v = plan.routed_diag(U)
    Up = np.zeros((plan.bucket_for(u), 3), np.float32)
    Up[:u] = U
    rm, rv = ppic.predict_routed_diag(plan.kfn, model.params, model.state,
                                      _t(Up), tile=plan.block_q)
    assert torch.equal(m, rm[:u]) and torch.equal(v, rv[:u])


@pytest.mark.parametrize("target", range(4))
def test_skewed_overflow_program_matches_worst_case_bitwise(prob32, target):
    """A request needing 1-2 overflow groups runs a smaller program than the
    worst case and still gives bit-identical rows."""
    model = prob32["model"]
    plan = model.plan(api.ServeSpec(max_batch=32, routed=True))
    c = model.state.centroids.numpy()
    U = _skewed(c, target, 24, target)
    m, v = plan.routed_diag(U)
    assert plan.stats.last_g > 0
    Up = np.zeros((plan.bucket_for(24), 3), np.float32)
    Up[:24] = U
    rm, rv = ppic.predict_routed_diag(plan.kfn, model.params, model.state,
                                      _t(Up), tile=plan.block_q)
    assert torch.equal(m, rm[:24]) and torch.equal(v, rv[:24])


@pytest.mark.parametrize("u", [6, 13, 24, 32])
def test_ladder_selects_the_exact_group_count(prob32, u):
    """The host picks the smallest ladder program that holds the request's
    real overflow, and every rung serves the same rows."""
    model = prob32["model"]
    plan = model.plan(api.ServeSpec(max_batch=32, routed=True))
    c = model.state.centroids.numpy()
    U = _skewed(c, 2, u, u)
    m, v = plan.routed_diag(U)
    b = plan.bucket_for(u)
    cap, G = routed_capacity(b, prob32["M"], tile=plan.block_q)
    need = -(-max(u - cap, 0) // cap)
    assert plan.stats.last_g == ppic._snap_groups(need, G, None)
    assert plan.stats.last_g >= need
    Up = torch.zeros((b, 3))
    Up[:u] = _t(U)
    assign = torch.as_tensor(plan._route(Up.numpy(), u)[0])
    for g in range(need, G + 1):
        rm, rv = ppic._routed_diag_program(
            plan.kfn, model.params, model.state, None, Up, assign,
            alpha=plan.spec.alpha, tile=plan.block_q, n_groups=g)
        assert torch.equal(m, rm[:u]) and torch.equal(v, rv[:u])


def test_balanced_flush_selects_g0(prob32):
    model = prob32["model"]
    plan = model.plan(api.ServeSpec(max_batch=32, routed=True))
    c = model.state.centroids.numpy()
    rng = np.random.RandomState(1)
    U = np.concatenate([np.tile(c[m], (8, 1)) + 0.01 * rng.randn(8, 3)
                        for m in range(4)]).astype(np.float32)
    before = plan.stats.n_g0_batches
    m, _ = plan.routed_diag(U)                 # 32 rows, 8 per block == cap
    assert plan.stats.last_g == 0
    assert plan.stats.n_g0_batches == before + 1
    rm, _ = ppic.predict_routed_diag(plan.kfn, model.params, model.state,
                                     _t(U), tile=plan.block_q)
    assert torch.equal(m, rm)


@pytest.mark.parametrize("u", [1, 5, 13])
def test_partial_flush_pads_never_inflate_overflow_demand(prob32, u):
    """Pad rows pack into spare main-bucket capacity: a small balanced batch
    padded to a large bucket still runs the G=0 program."""
    model = prob32["model"]
    plan = model.plan(api.ServeSpec(max_batch=32, routed=True))
    c = model.state.centroids.numpy()
    rng = np.random.RandomState(3)
    U = np.stack([c[i % 4] + 0.01 * rng.randn(3)
                  for i in range(u)]).astype(np.float32)
    m, v = plan.routed_diag(U)
    assert plan.stats.last_g == 0
    assert m.shape == (u,) and bool(torch.isfinite(v).all())
    Up = np.zeros((plan.bucket_for(u), 3), np.float32)
    Up[:u] = U
    assign, _ = plan._route(Up, u)
    assert (assign[u:] != clustering.nearest_center_np(
        Up[u:], c)).any() or u == plan.bucket_for(u)   # pads not routed


def test_max_overflow_groups_falls_back_to_worst_case(prob32):
    model = prob32["model"]
    plan = model.plan(api.ServeSpec(max_batch=32, routed=True,
                                    max_overflow_groups=0))
    c = model.state.centroids.numpy()
    m, _ = plan.routed_diag(np.tile(c[0], (24, 1)).astype(np.float32))
    cap, G = routed_capacity(plan.bucket_for(24), prob32["M"],
                             tile=plan.block_q)
    assert plan.stats.last_g == G
    assert bool(torch.isfinite(m).all())


def test_cinv_matches_trsm_path_f32(prob32):
    model = prob32["model"]
    base = model.plan(api.ServeSpec(max_batch=16, routed=True))
    cinv = model.plan(api.ServeSpec(max_batch=16, routed=True,
                                    cached_cinv=True))
    assert cinv.caches.Cinv.shape == (4, 24, 24)
    m0, v0 = base.routed_diag(prob32["U"])
    m1, v1 = cinv.routed_diag(prob32["U"])
    torch.testing.assert_close(m1, m0, rtol=CINV_TOL_F32, atol=CINV_TOL_F32)
    torch.testing.assert_close(v1, v0, rtol=CINV_TOL_F32, atol=CINV_TOL_F32)


def test_cinv_f64_tight(prob):
    model = prob["model"]
    base = model.plan(api.ServeSpec(max_batch=16, routed=True))
    cinv = model.plan(api.ServeSpec(max_batch=16, routed=True,
                                    cached_cinv=True))
    m0, v0 = base.routed_diag(prob["U"])
    m1, v1 = cinv.routed_diag(prob["U"])
    assert _err(m1, m0) < CINV_TOL_F64 and _err(v1, v0) < CINV_TOL_F64
    jst = prob["jmodel"].state
    assert _err(cinv.caches.Cinv, jppic.cinv_blocks(jst.C_L)) < STATE_TOL


def test_rebind_refreshes_cache_without_rebuilding(prob32):
    model = prob32["model"]
    plan = model.plan(api.ServeSpec(max_batch=16, routed=True,
                                    cached_cinv=True))
    plan.routed_diag(prob32["U"][:8])
    traces = plan.stats.n_traces
    st2 = ppic.fit(model.kfn, model.params, _t(prob32["X"]),
                   _t(2.0 * prob32["y"]), S=_t(prob32["S"]),
                   runner=VmapRunner(M=prob32["M"]))
    plan2 = plan.rebind(st2)
    assert plan2.caches.Cinv is not plan.caches.Cinv
    assert plan2.caches.Q is not plan.caches.Q
    m, _ = plan2.routed_diag(prob32["U"][:8])
    assert plan.stats.n_traces == traces
    cold = model.method.plan(model.kfn, model.params, st2, plan.spec)
    cm, _ = cold.routed_diag(prob32["U"][:8])
    assert torch.equal(m, cm)
    swapped = model.with_state(st2)
    assert swapped.plan(plan.spec).caches.Cinv is not None


def test_degraded_rows_are_global_posterior(prob32):
    """Rows whose block is dead are answered by the global S-space (pPITC)
    posterior; alive rows are bitwise the baseline."""
    model = prob32["model"]
    plan = model.plan(api.ServeSpec(max_batch=16, routed=True))
    U = prob32["U"][:16]
    alive = np.ones(4, bool)
    alive[1] = False
    m_base, v_base = plan.routed_diag(U)
    before = plan.stats.n_degraded_rows
    m_deg, v_deg = plan.routed_diag(U, block_alive=alive)
    deg = plan.stats.last_degraded
    assign = clustering.nearest_center_np(U, model.state.centroids.numpy())
    np.testing.assert_array_equal(deg, assign == 1)
    assert deg.any() and plan.stats.n_degraded_rows - before == deg.sum()
    m_glob, v_glob = ppic.global_diag(plan.kfn, plan.params, plan.state,
                                      _t(U))
    assert torch.equal(m_deg[deg], m_glob[deg])
    assert torch.equal(v_deg[deg], v_glob[deg])
    assert torch.equal(m_deg[~deg], m_base[~deg])
    assert torch.equal(v_deg[~deg], v_base[~deg])


def test_dead_block_nan_factors_stay_out_of_the_output(prob32):
    """A dead block whose factors are NaN still serves finite rows: the
    per-row select never propagates the unselected branch."""
    model = prob32["model"]
    st = model.state
    C_L = st.C_L.clone()
    C_L[1] = float("nan")
    B = st.B.clone()
    B[1] = float("nan")
    poisoned = st._replace(C_L=C_L, B=B)
    plan = api.get("ppic").plan(model.kfn, model.params, poisoned,
                                api.ServeSpec(max_batch=16, routed=True))
    alive = np.ones(4, bool)
    alive[1] = False
    U = prob32["U"][:16]
    m, v = plan.routed_diag(U, block_alive=alive)
    assert bool(torch.isfinite(m).all() and torch.isfinite(v).all())
    deg = plan.stats.last_degraded
    m_glob, _ = ppic.global_diag(plan.kfn, plan.params, st, _t(U))
    assert deg.any() and torch.equal(m[deg], m_glob[deg])
    m_raw, _ = plan.routed_diag(U)            # no mask: the NaN shows
    assert not bool(torch.isfinite(m_raw[deg]).all())


def test_block_alive_validated_and_generic_plan_rejects_it(prob32):
    plan = prob32["model"].plan(api.ServeSpec(max_batch=8, routed=True))
    with pytest.raises(ValueError, match="block_alive"):
        plan.routed_diag(prob32["U"][:4], block_alive=np.ones(5, bool))
    fgp = api.fit("fgp", cov.make_kernel("se"), prob32["params"],
                  _t(prob32["X"]), _t(prob32["y"]), device="cpu")
    with pytest.raises(ValueError, match="bounded-degradation"):
        fgp.plan(api.ServeSpec(max_batch=8)).routed_diag(
            prob32["U"][:4], block_alive=np.ones(4, bool))
    with pytest.raises(ValueError, match="no routed serving"):
        fgp.plan(api.ServeSpec(max_batch=8)).routed_diag(prob32["U"][:4])


@pytest.mark.parametrize("degraded", [False, True])
def test_warmup_covers_the_ladder_with_no_rebuilds(prob32, degraded):
    plan = prob32["model"].method.plan(
        prob32["model"].kfn, prob32["model"].params, prob32["model"].state,
        api.ServeSpec(max_batch=16, routed=True))
    plan.warmup(3, degraded=degraded)
    traces0 = plan.stats.n_traces
    assert traces0 > 0
    rng = np.random.RandomState(0)
    c = plan.state.centroids.numpy()
    for k in range(1, 4):
        alive = np.ones(4, bool)
        alive[rng.choice(4, size=k, replace=False)] = False
        plan.routed_diag(rng.randn(5, 3).astype(np.float32))
        plan.routed_diag(_skewed(c, k, 16, k))
        if degraded:
            plan.routed_diag(rng.randn(9, 3).astype(np.float32),
                             block_alive=alive)
    assert plan.stats.n_traces == traces0


def test_unrouted_warmup_of_a_pic_plan_serves_diag(prob32):
    plan = prob32["model"].plan(api.ServeSpec(max_batch=16))
    plan.warmup(3)
    assert plan.stats.n_diag_batches == len(plan.buckets)
    assert plan.stats.n_routed_batches == 0


# ---------------------------------------------------------------------------
# API rules and registrations.
# ---------------------------------------------------------------------------

def test_serve_spec_rules_match_reference():
    for kw in (dict(routed=True, alpha=0), dict(routed=True,
                                                max_overflow_groups=-1),
               dict(cached_cinv=True)):
        with pytest.raises(ValueError):
            api.ServeSpec(**kw)
        with pytest.raises(ValueError):
            japi.ServeSpec(**kw)
    api.ServeSpec(routed=True, cached_cinv=True, alpha=3,
                  max_overflow_groups=0)


def test_cinv_requires_backend_cache_plan(prob):
    model = api.fit("ppitc", prob["kfn"], prob["params"], _t(prob["X"]),
                    _t(prob["y"]), S=_t(prob["S"]),
                    runner=VmapRunner(M=prob["M"]), device="cpu")
    with pytest.raises(ValueError, match="cached_cinv"):
        model.plan(api.ServeSpec(routed=True, cached_cinv=True))


def test_routedless_methods_expose_none():
    for name in ("fgp", "pitc", "ppitc"):
        assert api.get(name).predict_routed_diag_fn is None
        assert api.get(name).plan_fn is None
    for name in ("pic", "ppic"):
        assert api.get(name).predict_routed_diag_fn is not None
        assert api.get(name).plan_fn is not None
    assert {"fgp", "pic", "pitc", "ppic", "ppitc"} <= set(api.names())


def test_fitted_gp_routed_guard(prob):
    model = api.fit("ppitc", prob["kfn"], prob["params"], _t(prob["X"]),
                    _t(prob["y"]), S=_t(prob["S"]),
                    runner=VmapRunner(M=prob["M"]), device="cpu")
    with pytest.raises(ValueError, match="no routed prediction"):
        model.predict_routed_diag(_t(prob["U"]))
    # a routed spec on a routedless method serves its ordinary diag
    m, _ = model.plan(api.ServeSpec(max_batch=8, routed=True)).warmup(3) \
        .diag(_t(prob["U"][:3]))
    assert m.shape == (3,)


@pytest.mark.parametrize("name", ["pitc", "pic"])
def test_centralized_registrations_match_reference(prob, name):
    model = api.fit(name, prob["kfn"], prob["params"], _t(prob["X"]),
                    _t(prob["y"]), S=_t(prob["S"]), M=prob["M"],
                    device="cpu")
    jmodel = japi.fit(name, prob["jkfn"], prob["jparams"],
                      jnp.asarray(prob["X"]), jnp.asarray(prob["y"]),
                      S=jnp.asarray(prob["S"]), M=prob["M"])
    m, v = model.predict_diag(_t(prob["U"]))
    jm, jv = jmodel.predict_diag(prob["U"])
    assert _err(m, jm) < STATE_TOL and _err(v, jv) < STATE_TOL
    post, jpost = model.predict(_t(prob["U"])), jmodel.predict(prob["U"])
    assert _err(post.cov, jpost.cov) < STATE_TOL


def test_convert_carries_a_pic_state(prob):
    st = convert.state_from_arrays(prob["jmodel"].state, device="cpu",
                                   dtype=torch.float32)
    assert isinstance(st, api.PICState) and st.B.dtype == torch.float32
    assert _err(st.Sdot, prob["jmodel"].state.Sdot) < 1e-5 * float(
        np.abs(np.asarray(prob["jmodel"].state.Sdot)).max())


# ---------------------------------------------------------------------------
# The whitened form (a fault of the reference's eqs. 12-14 form in float32).
# ---------------------------------------------------------------------------

def _summary_diag(fns, jax_side, kfn, p, S, X, y, U, M):
    """Diagonal of ``predict_from_summary`` over all M machines' blocks,
    from one package (the reference's runs once per machine)."""
    linalg, ppitc_, ppic_ = fns
    Kss_L = linalg.chol(kfn(p, S, S))
    if jax_side:
        import jax
        loc, glob = ppitc_.summaries(kfn, p, S, X, y, JVmapRunner(M=M))
        mean, covm = jax.vmap(lambda lo, Xm, ym, Um: ppic_.predict_from_summary(
            kfn, p, S, Kss_L, lo, glob, Xm, ym, Um))(
            loc, X.reshape(M, -1, 3), y.reshape(M, -1), U.reshape(M, -1, 3))
        return mean.reshape(-1), jnp.diagonal(covm, axis1=-2,
                                              axis2=-1).reshape(-1)
    Xb, yb = X.reshape(M, -1, 3), y.reshape(M, -1)
    loc, (Ksd, C_L, _) = ppitc_.local_summary(kfn, p, S, Kss_L, Xb, yb)
    glob = ppitc_.global_summary(kfn, p, S, loc,
                                 axis_name=VmapRunner(M=M).axis)
    mean, covm = ppic_.predict_from_summary(
        kfn, p, S, Kss_L, loc, glob, Xb, yb, U.reshape(M, -1, 3), Ksd=Ksd,
        C_L=C_L)
    return mean.reshape(-1), torch.diagonal(covm, dim1=-2,
                                            dim2=-1).reshape(-1)


@pytest.mark.parametrize("path", ["routed", "summary"])
@pytest.mark.parametrize("seed", range(4))
def test_whitened_form_survives_float32(seed, path):
    """In float32 the port's routed pPIC, and its ``predict_from_summary``,
    stay within 10x pPITC's own float32-vs-float64 error + 1e-4
    (chip_smoke.py phase 4b's limit), where the reference's form (K_US B -
    Sdot_US and friends, which cancel; its float32 Sdd Cholesky, which
    also fails on some of these, and in ``predict_from_summary`` Sdd's
    jitter: ROADMAP §3) errs by far more or gives NaN."""
    from repro.core import linalg as jlinalg
    from repro_torch.core import linalg
    n, s, M = 400, 64, 4
    rng = np.random.default_rng(seed)
    X, S, U = (rng.normal(size=(k, 3)) for k in (n, s, 64))
    X = X[np.argsort(X[:, 0], kind="stable")]
    y = np.sin(X[:, 0]) * 2 + X[:, 1] + 0.1 * rng.normal(size=n)
    kfn, jkfn = cov.make_kernel("se"), jcov.make_kernel("se")
    out = {}
    for dt in (np.float32, np.float64):
        jp = jcov.init_params(3, signal=1.0, noise=0.1, lengthscale=1.0,
                              dtype=jnp.dtype(dt))
        jst = jppic.fit(jkfn, jp, jnp.asarray(X, dt), jnp.asarray(y, dt),
                        S=jnp.asarray(S, dt), runner=JVmapRunner(M=M))
        p = convert.params_from_arrays(jp, device="cpu")
        st = ppic.fit(kfn, p, _t(X.astype(dt)), _t(y.astype(dt)),
                      S=_t(S.astype(dt)), runner=VmapRunner(M=M))
        Ut = _t(U.astype(dt))
        if path == "routed":
            jres = jppic.predict_routed_diag(jkfn, jp, jst,
                                             jnp.asarray(U, dt))
            res = ppic.predict_routed_diag(kfn, p, st, Ut)
        else:
            jres = _summary_diag((jlinalg, jppitc, jppic), True, jkfn, jp,
                                 *(jnp.asarray(a, dt) for a in (S, X, y, U)),
                                 M)
            res = _summary_diag((linalg, ppitc, ppic), False, kfn, p,
                                *(_t(a.astype(dt)) for a in (S, X, y, U)), M)
        out[dt] = (jres, res, ppic.global_diag(kfn, p, st, Ut))
    errs = [max(_err(a[0], b[0]), _err(a[1], b[1]))
            for a, b in zip(out[np.float32], out[np.float64])]
    jax_err, pic_err, pitc_err = errs
    lim = 10 * pitc_err + 1e-4
    assert pic_err <= lim
    assert not jax_err <= lim          # the reference's form (NaN fails too)


def test_plan_builds_whitened_factors_once_per_state(prob):
    """A plan builds Q = L⁻¹ K_SD once per state (its ``caches``): requests
    read it and leave it as it is, and ``rebind`` builds it for the new
    state."""
    from repro_torch.core import linalg
    st = prob["model"].state
    plan = api.get("ppic").plan(prob["kfn"], prob["params"], st,
                                api.ServeSpec(max_batch=16, routed=True))
    Q = plan.caches.Q
    assert _err(Q, linalg.tri_solve(st.Kss_L, st.Ksd)) == 0.0
    assert plan.caches.Cinv is None
    m, v = plan.routed_diag(_t(prob["U"]))
    assert plan.caches.Q is Q
    jm, jv = prob["jmodel"].plan(japi.ServeSpec(
        max_batch=16, routed=True)).routed_diag(prob["U"])
    assert _err(m, jm) < STATE_TOL and _err(v, jv) < STATE_TOL
    st2 = st._replace(Ksd=2.0 * st.Ksd)
    Q2 = plan.rebind(st2).caches.Q
    assert _err(Q2, linalg.tri_solve(st2.Kss_L, st2.Ksd)) == 0.0

