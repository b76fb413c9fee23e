"""The port's pICF slice (the distributed factor, fit state, serving, the
ICF predictors, parallel support selection) against the JAX package, in
float64 on the CPU.

Tolerances are ROADMAP's parity convention: 1e-10 against the reference's
factor, state and serving, ORACLE_TOL = 5e-6 against the centralized
oracle (``icf.icf_predict_literal``, Theorem 3). Inputs are made with numpy
from a seed and fed to both packages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi, covariance as jcov, icf as jicf, \
    picf as jpicf, support as jsupport
from repro.parallel.runner import VmapRunner as JVmapRunner
from repro_torch import convert
from repro_torch.core import api, covariance as cov, gp, icf, picf, support
from repro_torch.kernels.rbf import ops
from repro_torch.parallel.runner import VmapRunner

STATE_TOL = 1e-10
ORACLE_TOL = 5e-6
R = 48


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _err(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got.astype(np.float64)
                        - np.asarray(want).astype(np.float64)).max())


@pytest.fixture(scope="module")
def prob():
    """tests/helpers.make_problem's shapes (n=96, u=24, d=3, M=4), drawn
    with numpy; both packages fit the same arrays at rank 48."""
    rng = np.random.default_rng(0)
    n, u, d, M = 96, 24, 3, 4
    X, U = rng.normal(size=(n, d)), rng.normal(size=(u, d))
    y = np.sin(X[:, 0]) * 2.0 + X[:, 1] - 0.5 * X[:, 2] ** 2 \
        + 0.3 * rng.normal(size=n)
    jparams = jcov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                               dtype=jnp.float64)
    params = convert.params_from_arrays(jparams, device="cpu")
    jkfn, kfn = jcov.make_kernel("se"), cov.make_kernel("se")
    jmodel = japi.fit("picf", jkfn, jparams, jnp.asarray(X), jnp.asarray(y),
                      rank=R, runner=JVmapRunner(M=M))
    model = api.fit("picf", kfn, params, _t(X), _t(y), rank=R,
                    runner=VmapRunner(M=M), device="cpu")
    return dict(X=X, y=y, U=U, M=M, jparams=jparams, params=params,
                jkfn=jkfn, kfn=kfn, jmodel=jmodel, model=model)


def test_factor_matches_reference(prob):
    """The one centralized ICF cut into machine blocks is the reference's
    distributed factor: pivot inputs, F, residual and the pivot triangle
    Lp (its diagonal from the pivot values) within 1e-10."""
    got = picf.factor(prob["kfn"], prob["params"], _t(prob["X"]), R,
                      VmapRunner(M=prob["M"]))
    want = jpicf.factor(prob["jkfn"], prob["jparams"], jnp.asarray(prob["X"]),
                        R, JVmapRunner(M=prob["M"]))
    M, b = prob["M"], prob["X"].shape[0] // prob["M"]
    assert got.F.shape == (M, R, b) and got.Lp.shape == (M, R, R)
    assert got.pivots.shape == (M, R, 3) and got.residual.shape == (M, b)
    for f in picf.ICFLocal._fields:
        assert _err(getattr(got, f), getattr(want, f)) < STATE_TOL, f
    # the pivot inputs are exact copies of training rows
    assert _err(got.pivots, want.pivots) == 0.0


def test_pivot_triangle_takes_its_diagonal_from_the_pivot_values(prob):
    """F[i, p_i] equals sqrt(d_p) only up to rounding: the triangle's
    diagonal is sqrt(max(d_p, 1e-30)) of the pivot values themselves, and
    its strict lower part F[:i, p_i]."""
    fac, dp = icf.icf_factor(prob["kfn"], prob["params"], _t(prob["X"]), R,
                             pivot_values=True)
    Lp = picf.pivot_triangle(fac.F, fac.pivots, dp)
    assert torch.equal(torch.diagonal(Lp), torch.sqrt(dp.clamp(min=1e-30)))
    assert torch.equal(Lp.triu(1), torch.zeros_like(Lp))
    Fp = fac.F[:, fac.pivots]
    assert torch.equal(Lp.tril(-1), Fp.T.tril(-1))
    # Lp Lpᵀ is K at the pivots (the triangle is chol K_PP)
    X = _t(prob["X"])[fac.pivots]
    K = prob["kfn"](prob["params"], X, X)
    assert float((Lp @ Lp.T - K).abs().max()) < 1e-10


def test_fit_state_matches_reference(prob):
    st, jst = prob["model"].state, prob["jmodel"].state
    assert isinstance(st, api.PICFState)
    for f in api.PICFState._fields:
        assert _err(getattr(st, f), getattr(jst, f)) < STATE_TOL, f


def test_predict_batch_and_diag_match_reference(prob):
    kfn, jkfn, U = prob["kfn"], prob["jkfn"], prob["U"]
    st, jst = prob["model"].state, prob["jmodel"].state
    post = picf.predict_batch(kfn, prob["params"], st, _t(U))
    jpost = jpicf.predict_batch(jkfn, prob["jparams"], jst, jnp.asarray(U))
    assert _err(post.mean, jpost.mean) < STATE_TOL
    assert _err(post.cov, jpost.cov) < STATE_TOL
    dpost = picf.predict_batch(kfn, prob["params"], st, _t(U),
                               diag_only=True)
    jdpost = jpicf.predict_batch(jkfn, prob["jparams"], jst, jnp.asarray(U),
                                 diag_only=True)
    assert _err(dpost.cov, jdpost.cov) < STATE_TOL
    m, v = picf.predict_batch_diag(kfn, prob["params"], st, _t(U))
    jm, jv = jpicf.predict_batch_diag(jkfn, prob["jparams"], jst,
                                      jnp.asarray(U))
    assert _err(m, jm) < STATE_TOL and _err(v, jv) < STATE_TOL
    assert _err(v, torch.diagonal(post.cov)) < STATE_TOL


def test_theorem3_picf_equals_centralized_icf(prob):
    """pICF's posterior is the centralized ICF GP's (eqs. 28-29) at the
    same factor; the Woodbury form equals the literal one."""
    X, y, U = _t(prob["X"]), _t(prob["y"]), _t(prob["U"])
    fac = icf.icf_factor(prob["kfn"], prob["params"], X, R)
    lit = icf.icf_predict_literal(prob["kfn"], prob["params"], X, y, U,
                                  fac.F)
    q = picf.predict(prob["kfn"], prob["params"], X, y, U, R,
                     VmapRunner(M=prob["M"]))
    assert _err(q.mean, lit.mean) < ORACLE_TOL
    assert _err(q.cov, lit.cov) < ORACLE_TOL
    wb = icf.icf_predict(prob["kfn"], prob["params"], X, y, U, fac.F)
    assert _err(wb.mean, lit.mean) < ORACLE_TOL
    assert _err(wb.cov, lit.cov) < ORACLE_TOL


@pytest.mark.parametrize("name", ["icf_predict_literal", "icf_predict"])
def test_icf_predictors_match_reference(prob, name):
    X, y, U = prob["X"], prob["y"], prob["U"]
    jF = jicf.icf_factor(prob["jkfn"], prob["jparams"], jnp.asarray(X), R).F
    got = getattr(icf, name)(prob["kfn"], prob["params"], _t(X), _t(y),
                             _t(U), _t(jF))
    want = getattr(jicf, name)(prob["jkfn"], prob["jparams"],
                               jnp.asarray(X), jnp.asarray(y),
                               jnp.asarray(U), jF)
    assert _err(got.mean, want.mean) < STATE_TOL
    assert _err(got.cov, want.cov) < STATE_TOL


def test_full_rank_recovers_fgp(prob):
    """R = |D| makes the ICF exact, so pICF is FGP (the reference's own
    gate, 1e-5)."""
    X, y, U = _t(prob["X"]), _t(prob["y"]), _t(prob["U"])
    exact = gp.predict(prob["kfn"], prob["params"], X, y, U)
    q = picf.predict(prob["kfn"], prob["params"], X, y, U, X.shape[0],
                     VmapRunner(M=prob["M"]))
    assert _err(q.mean, exact.mean) < 1e-5
    assert _err(q.cov, exact.cov) < 1e-5


@pytest.mark.parametrize("spec_kw", [dict(), dict(max_batch=16),
                                     dict(buckets=(4, 32))])
def test_plan_matches_reference_plan(prob, spec_kw):
    plan = prob["model"].plan(api.ServeSpec(**spec_kw))
    jplan = prob["jmodel"].plan(japi.ServeSpec(**spec_kw))
    assert plan.buckets == jplan.buckets
    for u in (1, 7, 24):
        m, v = plan.diag(_t(prob["U"][:u]))
        jm, jv = jplan.diag(prob["U"][:u])
        assert m.shape == (u,)
        assert _err(m, jm) < STATE_TOL and _err(v, jv) < STATE_TOL
    post, jpost = plan.full(_t(prob["U"])), jplan.full(prob["U"])
    assert _err(post.mean, jpost.mean) < STATE_TOL
    assert _err(post.cov, jpost.cov) < STATE_TOL


def test_jax_state_served_by_the_port(prob):
    """convert: the reference's fitted pICF state and factor, carried
    across, serve and compare as the port's own."""
    st = convert.state_from_arrays(prob["jmodel"].state, device="cpu")
    assert isinstance(st, api.PICFState)
    m, v = picf.predict_batch_diag(prob["kfn"], prob["params"], st,
                                   _t(prob["U"]))
    jm, jv = prob["jmodel"].plan().diag(prob["U"])
    assert _err(m, jm) < STATE_TOL and _err(v, jv) < STATE_TOL
    jloc = jpicf.factor(prob["jkfn"], prob["jparams"], jnp.asarray(prob["X"]),
                        R, JVmapRunner(M=prob["M"]))
    loc = convert.state_from_arrays(jloc, device="cpu", dtype=torch.float32)
    assert isinstance(loc, picf.ICFLocal) and loc.F.dtype == torch.float32


def test_store_to_state_and_alive_gather(prob):
    store = picf.init_picf_store(prob["kfn"], prob["params"], _t(prob["X"]),
                                 _t(prob["y"]), rank=R,
                                 runner=VmapRunner(M=prob["M"]))
    jstore = jpicf.init_picf_store(prob["jkfn"], prob["jparams"],
                                   jnp.asarray(prob["X"]),
                                   jnp.asarray(prob["y"]), rank=R,
                                   runner=JVmapRunner(M=prob["M"]))
    for f in ("Xb", "yb", "F", "Xp", "Lp", "Phi_L", "yF"):
        assert _err(getattr(store, f), getattr(jstore, f)) < STATE_TOL, f
    assert store.block_size == jstore.block_size
    st = store.to_state()
    assert st.F is store.F                  # all alive: passed by reference
    alive = torch.tensor([True, False, True, True])
    part = dataclasses.replace(store, alive=alive).to_state()
    assert part.F.shape[0] == 3 and torch.equal(part.Xb, store.Xb[alive])


def test_select_support_parallel_matches_reference():
    rng = np.random.default_rng(3)
    C = rng.uniform(-2.0, 2.0, size=(120, 4))
    jparams = jcov.init_params(4, signal=1.3, noise=0.3, lengthscale=1.2,
                               dtype=jnp.float64)
    params = convert.params_from_arrays(jparams, device="cpu")
    got = support.select_support_parallel(
        cov.make_kernel("se"), params, _t(C), 20, VmapRunner(M=4),
        device="cpu")
    want = jsupport.select_support_parallel(
        jcov.make_kernel("se"), jparams, jnp.asarray(C), 20,
        JVmapRunner(M=4))
    assert _err(got, want) == 0.0           # the same rows, in order
    with pytest.raises(ValueError, match="does not divide"):
        support.select_support_parallel(cov.make_kernel("se"), params,
                                        _t(C[:118]), 20, VmapRunner(M=4),
                                        device="cpu")


def test_picf_on_the_cpu_launches_no_kernel(prob):
    ops.reset_counts()
    model = api.fit("picf", cov.make_spec("se"), prob["params"],
                    _t(prob["X"]), _t(prob["y"]), rank=R,
                    runner=VmapRunner(M=prob["M"]), device="cpu")
    model.plan(api.ServeSpec(max_batch=8)).diag(_t(prob["U"][:5]))
    assert (ops.icf_launches, ops.rbf_launches, ops.xcov_launches) == \
        (0, 0, 0)
    m, _ = prob["model"].plan(api.ServeSpec(max_batch=8)).diag(
        _t(prob["U"][:5]))
    assert _err(model.plan(api.ServeSpec(max_batch=8)).diag(
        _t(prob["U"][:5]))[0], m) < STATE_TOL


@pytest.mark.parametrize("op", ["assimilate", "retire", "revive"])
def test_store_streaming_raises_naming_item_6(prob, op):
    store = picf.init_picf_store(prob["kfn"], prob["params"], _t(prob["X"]),
                                 _t(prob["y"]), rank=R,
                                 runner=VmapRunner(M=prob["M"]))
    jstore = jpicf.init_picf_store(prob["jkfn"], prob["jparams"],
                                   jnp.asarray(prob["X"]),
                                   jnp.asarray(prob["y"]), rank=R,
                                   runner=JVmapRunner(M=prob["M"]))
    # item 6 is ported: each call (revive after a retire) emits the
    # reference's state
    if op == "revive":
        store, jstore = store.retire(0), jstore.retire(0)
    args = {"assimilate": (_t(prob["X"]), _t(prob["y"])),
            "retire": (0,), "revive": (0,)}[op]
    jargs = {"assimilate": (jnp.asarray(prob["X"]), jnp.asarray(prob["y"])),
             "retire": (0,), "revive": (0,)}[op]
    st = getattr(store, op)(*args).to_state()
    jst = getattr(jstore, op)(*jargs).to_state()
    for f in api.PICFState._fields:
        assert _err(getattr(st, f), getattr(jst, f)) < STATE_TOL, f


def test_registry_has_picf():
    with pytest.raises(ValueError, match="unknown GP method"):
        api.get("sgpr")                     # imports every core module
    assert {"fgp", "pic", "picf", "pitc", "ppic", "ppitc"} <= \
        set(api.names())
    assert api.get("picf").name == "picf"


# ---------------------------------------------------------------------------
# The method's instability at low rank (ROADMAP §3): reproduced, not fixed.
# ---------------------------------------------------------------------------

def _unstable_case(np_dtype):
    """n = 512 over M = 4 machines at rank 64, d = 3: the reference's pICF
    gives a negative variance at most of 200 test inputs, in float64 as in
    float32 (its variance subtracts K_UD K_DU / s2, of size |D|, from a
    rank-64 correction)."""
    rng = np.random.default_rng(0)
    n, d = 512, 3
    X = rng.uniform(-2.0, 2.0, size=(n, d))
    U = rng.uniform(-2.0, 2.0, size=(200, d))
    y = np.sin(2 * X[:, 0]) + X[:, 1] * np.cos(X[:, 2]) \
        + 0.3 * rng.normal(size=n)
    y = (y - y.mean()) / y.std()
    return tuple(a.astype(np_dtype) for a in (X, y, U))


@pytest.mark.parametrize("np_dtype,tol", [(np.float64, 0.0),
                                          (np.float32, 0.05)])
def test_negative_variances_as_the_reference(np_dtype, tol):
    """The same share of negative variances as the reference: equal in
    float64, within 0.05 in float32 (the ICF's pivots may part at near ties
    there, and the rounding of the cancelling terms differs)."""
    X, y, U = _unstable_case(np_dtype)
    jdt = jnp.dtype(np_dtype)
    jparams = jcov.init_params(3, signal=1.0, noise=0.3, lengthscale=1.0,
                               dtype=jdt)
    params = convert.params_from_arrays(jparams, device="cpu")
    jst = jpicf.fit(jcov.make_kernel("se"), jparams, jnp.asarray(X),
                    jnp.asarray(y), rank=64, runner=JVmapRunner(M=4))
    _, jv = jpicf.predict_batch_diag(jcov.make_kernel("se"), jparams, jst,
                                     jnp.asarray(U))
    st = picf.fit(cov.make_kernel("se"), params, _t(X), _t(y), rank=64,
                  runner=VmapRunner(M=4))
    _, v = picf.predict_batch_diag(cov.make_kernel("se"), params, st, _t(U))
    want = float(np.mean(np.asarray(jv) < 0))
    got = float((v < 0).double().mean())
    assert 0.5 < want < 1.0                 # the method fails, not always
    assert abs(got - want) <= tol
    if np_dtype == np.float64:
        assert _err(v, jv) < 1e-8 * float(np.abs(np.asarray(jv)).max())
