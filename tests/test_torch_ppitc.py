"""The port's pPITC slice (summaries, fit state, plan API, convert) against
the JAX package, in float64 on the CPU: the state and plans within 1e-10,
the centralized PITC oracle within 5e-6 (the reference's own gates,
tests/test_shardmap.py and tests/test_routing_equivalence.py). Inputs are
made with numpy from a seed and fed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi, covariance as jcov, online as jonline, \
    pitc as jpitc, ppitc as jppitc
from repro.parallel.runner import VmapRunner as JVmapRunner
from repro_torch import convert
from repro_torch.core import api, covariance as cov, linalg, online, ppitc
from repro_torch.parallel.runner import VmapRunner

STATE_TOL = 1e-10
ORACLE_TOL = 5e-6


def _t(a):
    return torch.tensor(np.asarray(a))


def _err(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max())


@pytest.fixture(scope="module")
def prob():
    """tests/helpers.make_problem's shapes (n=96, u=24, |S|=12, d=3, M=4),
    drawn with numpy; both packages get the same arrays."""
    rng = np.random.default_rng(0)
    n, u, s, d, M = 96, 24, 12, 3, 4
    X, S, U = (rng.normal(size=(k, d)) for k in (n, s, u))
    y = np.sin(X[:, 0]) * 2.0 + X[:, 1] - 0.5 * X[:, 2] ** 2 \
        + 0.3 * rng.normal(size=n)
    jparams = jcov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                               dtype=jnp.float64)
    params = convert.params_from_arrays(jparams, device="cpu")
    jmodel = japi.fit("ppitc", jcov.make_kernel("se"), jparams,
                      jnp.asarray(X), jnp.asarray(y), S=jnp.asarray(S),
                      runner=JVmapRunner(M=M))
    model = api.fit("ppitc", cov.make_kernel("se"), params, _t(X), _t(y),
                    S=_t(S), runner=VmapRunner(M=M), device="cpu")
    return dict(X=X, y=y, S=S, U=U, M=M, jparams=jparams, params=params,
                jmodel=jmodel, model=model)


def test_fit_state_matches_reference(prob):
    assert isinstance(prob["model"].state, api.PITCState)
    for f in api.PITCState._fields:
        assert _err(getattr(prob["model"].state, f),
                    getattr(prob["jmodel"].state, f)) < STATE_TOL


def test_summaries_match_reference(prob):
    kfn, jkfn = cov.make_kernel("se"), jcov.make_kernel("se")
    loc, glob = ppitc.summaries(kfn, prob["params"], _t(prob["S"]),
                                _t(prob["X"]), _t(prob["y"]),
                                VmapRunner(M=prob["M"]))
    jloc, jglob = jppitc.summaries(jkfn, prob["jparams"],
                                   jnp.asarray(prob["S"]),
                                   jnp.asarray(prob["X"]),
                                   jnp.asarray(prob["y"]),
                                   JVmapRunner(M=prob["M"]))
    assert loc.ydot.shape == (prob["M"], 12)
    for a, b in zip(tuple(loc) + tuple(glob), tuple(jloc) + tuple(jglob)):
        assert _err(a, b) < STATE_TOL


def test_store_matches_reference(prob):
    kfn, jkfn = cov.make_kernel("se"), jcov.make_kernel("se")
    store = online.build(kfn, prob["params"], _t(prob["S"]), _t(prob["X"]),
                         _t(prob["y"]), VmapRunner(M=prob["M"]))
    jstore = jonline.build(jkfn, prob["jparams"], jnp.asarray(prob["S"]),
                           jnp.asarray(prob["X"]), jnp.asarray(prob["y"]),
                           JVmapRunner(M=prob["M"]))
    for f in ("F", "Kss", "Kss_L", "Sdd_L", "ydd"):
        assert _err(getattr(store, f), getattr(jstore, f)) < STATE_TOL
    assert store.alive.tolist() == np.asarray(jstore.alive).tolist()
    glob, jglob = online.global_summary(store), jonline.global_summary(jstore)
    assert _err(glob.Sdd, jglob.Sdd) < STATE_TOL
    assert _err(glob.ydd, jglob.ydd) < STATE_TOL


def test_sdd_factor_from_its_square_root_survives_float32():
    """The cold Sdd factor is the QR of [Kss_Lᵀ; F_mᵀ] — the same matrix
    the reference factorizes — so it equals the reference's factor in f64
    and stays finite where the reference's float32 Cholesky of the formed
    Sdd (cond ~1e10, as at the paper's |S| = 2048) breaks down."""
    rng = np.random.default_rng(0)
    s, M, b = 32, 2, 8
    Q, _ = np.linalg.qr(rng.normal(size=(s, s)))
    Kss = (Q * np.logspace(-3, 0, s)) @ Q.T
    F = rng.normal(size=(M, s, b)) * 1e3
    Sdd = Kss + np.einsum("msb,mtb->st", F, F)
    for dtype, jdtype in ((torch.float64, jnp.float64),
                          (torch.float32, jnp.float32)):
        L = online._sdd_chol(linalg.chol(_t(Kss).to(dtype)),
                             _t(F).to(dtype))
        jL = jonline._sdd_chol(jnp.asarray(Kss, jdtype),
                               jnp.asarray(Sdd, jdtype))
        if dtype == torch.float64:
            assert _err(L, jL) < 1e-10 * float(np.abs(jL).max())
        else:
            assert not np.isfinite(np.asarray(jL)).all()
            truth = np.linalg.cholesky(
                Sdd + 1e-6 * np.diag(Kss).mean() * np.eye(s))
            assert _err(L.double(), truth) < 1e-5 * np.abs(truth).max()


@pytest.mark.parametrize("spec_kw", [dict(), dict(max_batch=16),
                                     dict(buckets=(4, 32)),
                                     dict(max_batch=64, block_q=16)])
def test_plan_diag_and_full_match_reference_plan(prob, spec_kw):
    plan = prob["model"].plan(api.ServeSpec(**spec_kw))
    jplan = prob["jmodel"].plan(japi.ServeSpec(**spec_kw))
    assert plan.buckets == jplan.buckets
    for u in (1, 7, 24):
        U = prob["U"][:u]
        m, v = plan.diag(_t(U))
        jm, jv = jplan.diag(U)
        assert m.shape == (u,) and v.shape == (u,)
        assert _err(m, jm) < STATE_TOL and _err(v, jv) < STATE_TOL
    post, jpost = plan.full(_t(prob["U"])), jplan.full(prob["U"])
    assert _err(post.mean, jpost.mean) < STATE_TOL
    assert _err(post.cov, jpost.cov) < STATE_TOL


def test_plan_matches_centralized_pitc_oracle(prob):
    lit = jpitc.pitc_predict_literal(
        jcov.make_kernel("se"), prob["jparams"], jnp.asarray(prob["S"]),
        jnp.asarray(prob["X"]), jnp.asarray(prob["y"]),
        jnp.asarray(prob["U"]), prob["M"])
    m, v = prob["model"].plan(api.ServeSpec(max_batch=16)).diag(
        _t(prob["U"]))
    assert _err(m, lit.mean) < ORACLE_TOL
    assert _err(v, jnp.diag(lit.cov)) < ORACLE_TOL
    post = prob["model"].predict(_t(prob["U"]))
    assert _err(post.cov, lit.cov) < ORACLE_TOL


def test_predict_blocks_matches_reference(prob):
    kfn, jkfn = cov.make_kernel("se"), jcov.make_kernel("se")
    post = ppitc.predict_blocks(kfn, prob["params"], prob["model"].state,
                                _t(prob["U"]), prob["M"])
    jpost = jppitc.predict_blocks(jkfn, prob["jparams"],
                                  prob["jmodel"].state,
                                  jnp.asarray(prob["U"]), prob["M"])
    assert post.blocks.shape == (prob["M"], 6, 6)
    for a, b in ((post.mean, jpost.mean), (post.blocks, jpost.blocks),
                 (post.var, jpost.var), (post.cov, jpost.cov)):
        assert _err(a, b) < STATE_TOL


def test_jax_fitted_state_served_by_the_port(prob):
    """convert: the JAX package's fitted state and hyperparameters, served
    by the port's plan, answer as the JAX plan does."""
    state = convert.state_from_arrays(prob["jmodel"].state, device="cpu")
    params = convert.params_from_arrays(prob["jparams"], device="cpu")
    assert isinstance(state, api.PITCState)
    plan = api.get("ppitc").plan(cov.make_spec("se"), params, state,
                                 api.ServeSpec(max_batch=8))
    m, v = plan.diag(_t(prob["U"]))
    jm, jv = prob["jmodel"].plan(japi.ServeSpec(max_batch=8)).diag(
        prob["U"])
    assert _err(m, jm) < STATE_TOL and _err(v, jv) < STATE_TOL


def test_convert_fgp_state_and_dtype():
    from repro.core import gp as jgp
    rng = np.random.default_rng(4)
    X, y = rng.normal(size=(20, 2)), rng.normal(size=20)
    jp = jcov.init_params(2, dtype=jnp.float64)
    jst = jgp.fit(jcov.make_kernel("se"), jp, jnp.asarray(X), jnp.asarray(y))
    st = convert.state_from_arrays(jst, device="cpu", dtype=torch.float32)
    assert isinstance(st, api.FGPState) and st.L.dtype == torch.float32
    assert _err(st.L, jst.L) < 1e-6
    with pytest.raises(TypeError, match="no port state"):
        convert.state_from_arrays(jp, device="cpu")
    with pytest.raises(KeyError, match="log_noise"):
        convert.params_from_arrays({"log_signal": 0.0,
                                    "log_lengthscale": [0.0]}, device="cpu")


def test_plan_builds_each_callable_once_across_rebinds(prob):
    model = prob["model"]
    plan = api.get("ppitc").plan(cov.make_kernel("se"), model.params,
                                 model.state, api.ServeSpec(max_batch=16))
    plan.warmup(3, dtype=torch.float64)
    assert plan.stats.n_traces == 1
    assert plan.stats.n_diag_batches == len(plan.buckets)
    state2 = api.PITCState(*(t + 0 for t in model.state))
    plan2 = plan.rebind(state2)
    m, v = plan2.diag(_t(prob["U"][:5]))
    plan2.full(_t(prob["U"][:5]))
    assert plan2.stats is plan.stats and plan.stats.n_traces == 2
    assert plan.stats.n_padded_rows == 3            # 5 rows -> bucket 8
    m0, v0 = plan.diag(_t(prob["U"][:5]))
    torch.testing.assert_close((m, v), (m0, v0), rtol=0, atol=0)


def test_fitted_gp_memoizes_and_rebinds_plans(prob):
    model = prob["model"]
    spec = api.ServeSpec(max_batch=8)
    assert model.plan(spec) is model.plan(spec)
    swapped = model.with_state(model.state)
    assert swapped.plan(spec).stats is model.plan(spec).stats
    m, v = model.predict_diag(_t(prob["U"][:3]))
    assert m.shape == (3,)


@pytest.mark.parametrize("policy", ["preserve", "state", "float32"])
def test_serve_spec_dtype_policies_match_reference(prob, policy):
    U32 = prob["U"][:4].astype(np.float32)
    m, v = prob["model"].plan(api.ServeSpec(dtype=policy)).diag(U32)
    jm, jv = prob["jmodel"].plan(japi.ServeSpec(dtype=policy)).diag(U32)
    assert str(m.dtype).split(".")[1] == str(jm.dtype)
    assert _err(m, jm) < 1e-6 and _err(v, jv) < 1e-6


def test_unknown_dtype_policy_raises(prob):
    model = prob["model"]
    with pytest.raises(ValueError, match="dtype policy"):
        model.plan(api.ServeSpec(dtype="half")).diag(prob["U"][:4])


@pytest.mark.parametrize("kw", [dict(routed=True), dict(cached_cinv=True),
                                dict(routed=True, cached_cinv=True)])
def test_routed_serving_is_not_yet_ported(kw):
    """Routed ``ServeSpec`` rules, as the reference's: ``routed=True``
    (alone or with ``cached_cinv``) constructs, and ``cached_cinv``
    without ``routed`` raises."""
    jax_raises = kw == dict(cached_cinv=True)
    if jax_raises:
        with pytest.raises(ValueError, match="cached_cinv"):
            japi.ServeSpec(**kw)
        with pytest.raises(ValueError, match="cached_cinv"):
            api.ServeSpec(**kw)
    else:
        spec, jspec = api.ServeSpec(**kw), japi.ServeSpec(**kw)
        assert (spec.routed, spec.cached_cinv) == (jspec.routed,
                                                   jspec.cached_cinv)


def test_serve_spec_validation_matches_reference():
    for kw in (dict(alpha=0), dict(max_overflow_groups=-1)):
        with pytest.raises(ValueError):
            api.ServeSpec(**kw)
    with pytest.raises(ValueError, match="under-cover"):
        api.ServeSpec(buckets=(4, 8), max_batch=16).resolve_buckets(None)
    with pytest.raises(ValueError, match="positive"):
        api.ServeSpec(block_q=0).resolve_block_q(None)
    spec = api.ServeSpec(block_q=16, kernel=cov.make_spec("se"))
    assert spec.resolve_kfn(None).block_q == 16
    assert spec.resolve_block_q(None) == 16


def test_registry():
    with pytest.raises(ValueError, match="unknown GP method"):
        api.get("sgpr")                     # imports every core module
    assert {"fgp", "pic", "picf", "pitc", "ppic", "ppitc"} <= \
        set(api.names())
    assert api.get("ppitc").name == "ppitc"
