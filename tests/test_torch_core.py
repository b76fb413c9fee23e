"""The port's foundation modules (covariance, linalg, icf/support, FGP, the
runner, ``default_buckets``, data, configs) against the JAX package, in
float64 on the CPU. Inputs are made with numpy from a seed and fed to both
packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gp_experiments as jexp
from repro.core import api as japi, covariance as jcov, gp as jgp, \
    icf as jicf, linalg as jlinalg, support as jsupport
from repro.parallel import runner as jrunner
from repro_torch import convert
from repro_torch.configs import gp_experiments as texp
from repro_torch.core import api, covariance as cov, gp, icf, linalg, support
from repro_torch.data import synthetic
from repro_torch.parallel import runner

TOL = 1e-12


def _t(a):
    return torch.tensor(np.asarray(a))


def _err(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max())


@pytest.fixture(scope="module")
def prob():
    """tests/helpers.make_problem's shapes, drawn with numpy."""
    rng = np.random.default_rng(0)
    n, u, s, d = 96, 24, 12, 3
    X, S, U = (rng.normal(size=(k, d)) for k in (n, s, u))
    y = np.sin(X[:, 0]) * 2.0 + X[:, 1] - 0.5 * X[:, 2] ** 2 \
        + 0.3 * rng.normal(size=n)
    jparams = jcov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                               dtype=jnp.float64)
    return dict(X=X, y=y, S=S, U=U, jparams=jparams,
                params=convert.params_from_arrays(jparams, device="cpu"))


@pytest.mark.parametrize("name", ["se", "matern52", "rq"])
def test_kernels_match(prob, name):
    got = cov.make_kernel(name)(prob["params"], _t(prob["X"]), _t(prob["S"]))
    want = jcov.make_kernel(name)(prob["jparams"], jnp.asarray(prob["X"]),
                                  jnp.asarray(prob["S"]))
    assert got.dtype == torch.float64
    assert _err(got, want) < TOL


def test_init_params_and_variances_match():
    p = cov.init_params(4, signal=1.7, noise=0.2,
                        lengthscale=[0.5, 1.0, 2.0, 3.0], dtype=torch.float64,
                        device="cpu")
    jp = jcov.init_params(4, signal=1.7, noise=0.2,
                          lengthscale=jnp.asarray([0.5, 1.0, 2.0, 3.0]),
                          dtype=jnp.float64)
    for k in jp:
        assert _err(p[k], jp[k]) < TOL
    assert _err(cov.signal_var(p), jcov.signal_var(jp)) < TOL
    assert _err(cov.noise_var(p), jcov.noise_var(jp)) < TOL


def test_kdiag_and_add_noise_match(prob):
    X = _t(prob["X"][:10])
    for kfn, jkfn in ((cov.make_kernel("matern52"),
                       jcov.make_kernel("matern52")),
                      (cov.make_spec("se"), jcov.make_spec("se"))):
        got = cov.kdiag(kfn, prob["params"], X)
        want = jcov.kdiag(jkfn, prob["jparams"], jnp.asarray(prob["X"][:10]))
        assert _err(got, want) < TOL
    K = cov.se_ard(prob["params"], X, X)
    jK = jcov.se_ard(prob["jparams"], jnp.asarray(prob["X"][:10]),
                     jnp.asarray(prob["X"][:10]))
    assert _err(cov.add_noise(K, prob["params"]),
                jcov.add_noise(jK, prob["jparams"])) < TOL


def test_unknown_kernel_and_impl_rejected():
    with pytest.raises(ValueError, match="unknown kernel"):
        cov.make_spec("nope")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        cov.make_spec("se", impl="triton")
    with pytest.raises(ValueError, match="block_q"):
        cov.make_spec("se", block_q=0)


def test_se_pallas_matches_the_reference(prob):
    """``make_kernel("se_pallas")``, the name a reference checkpoint may
    record, against the reference's: as the reference runs it on the CPU
    (impl "auto" is dense jnp there) and through its Pallas kernel in
    interpret mode, both in float32 within the rbf tolerance."""
    from repro.kernels.rbf import ops as jrbf_ops
    f32 = {k: v.to(torch.float32) for k, v in prob["params"].items()}
    jf32 = {k: jnp.asarray(v, jnp.float32) for k, v in prob["jparams"].items()}
    X, S = (np.asarray(prob[k], np.float32) for k in ("X", "S"))
    got = cov.make_kernel("se_pallas")(f32, torch.tensor(X), torch.tensor(S))
    assert got.dtype == torch.float32
    want = jcov.make_kernel("se_pallas")(jf32, jnp.asarray(X), jnp.asarray(S))
    interp = jrbf_ops.rbf_covariance(
        jcov._scale(jf32, jnp.asarray(X)), jcov._scale(jf32, jnp.asarray(S)),
        jcov.signal_var(jf32), impl="pallas_interpret")
    assert _err(got, want) < 1e-5
    assert _err(got, interp) < 1e-5
    # float64 inputs: both accumulate in float32 and return float64
    got64 = cov.make_kernel("se_pallas")(prob["params"], _t(prob["X"]),
                                         _t(prob["S"]))
    want64 = jcov.make_kernel("se_pallas")(prob["jparams"],
                                           jnp.asarray(prob["X"]),
                                           jnp.asarray(prob["S"]))
    assert got64.dtype == torch.float64
    assert _err(got64, want64) < 1e-5


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_se_ard_pallas_is_the_references_public_name(prob, dtype):
    """``covariance.se_ard_pallas`` exists under the reference's name, is
    the function registered as "se_pallas" (``se_ard_kernel``, kept), and
    agrees with ``repro.core.covariance.se_ard_pallas`` (both accumulate
    in float32: the rbf tolerance)."""
    assert cov.se_ard_pallas is cov.se_ard_kernel
    assert cov.make_kernel("se_pallas") is cov.se_ard_pallas
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    params = {k: v.to(tdt) for k, v in prob["params"].items()}
    jparams = {k: jnp.asarray(v, dtype) for k, v in prob["jparams"].items()}
    X, S = (np.asarray(prob[k], dtype) for k in ("X", "S"))
    got = cov.se_ard_pallas(params, torch.tensor(X), torch.tensor(S))
    want = jcov.se_ard_pallas(jparams, jnp.asarray(X), jnp.asarray(S))
    assert got.dtype == tdt
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("name", ["se", "se_pallas"])
@pytest.mark.parametrize("alias,target", [("pallas", "cuda"),
                                          ("pallas_interpret", "torch"),
                                          ("jnp", "torch")])
def test_reference_impl_names_resolve(prob, name, alias, target):
    """The reference's impl names resolve as the port's own, and a spec
    that names one computes what the spec it resolves to computes."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    spec = cov.make_spec(name, impl=alias)
    assert spec.resolved_impl(cuda) == target
    assert spec.fuse(cuda) == cov.make_spec(name, impl=target).fuse(cuda)
    X, S = _t(prob["X"][:9]), _t(prob["S"])
    if target == "torch":
        assert spec.resolved_impl(cpu) == "torch"
        torch.testing.assert_close(spec(prob["params"], X, S),
                                   cov.se_ard(prob["params"], X, S),
                                   rtol=0, atol=0)
    else:   # "pallas" is the CUDA kernel: CPU tensors raise as for "cuda"
        for impl in (alias, target):
            with pytest.raises(ValueError, match="CUDA tensors only"):
                cov.KernelSpec(name, impl)(prob["params"], X, S)


def test_auto_spec_on_cpu_is_plain_se_bitwise(prob):
    spec = cov.make_spec("se")
    X, S = _t(prob["X"][:7]), _t(prob["S"])
    torch.testing.assert_close(spec(prob["params"], X, S),
                               cov.se_ard(prob["params"], X, S),
                               rtol=0, atol=0)
    assert spec.resolved_impl(X.device) == "torch"


def test_fuse_rule_has_no_size_cap():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert cov.make_spec("se").fuse(cuda)
    assert cov.make_spec("se", impl="cuda").fuse(cuda)
    assert not cov.make_spec("se").fuse(cpu)
    assert not cov.make_spec("se", impl="torch").fuse(cuda)
    assert not cov.make_spec("se", fused=False).fuse(cuda)
    assert not cov.make_spec("matern52").fuse(cuda)


def test_fused_diag_plain_path_equals_compose(prob):
    """``fused_diag`` under impl='torch' runs the kernel's plain version on
    the same inputs the CUDA kernel gets."""
    rng = np.random.default_rng(2)
    A = rng.normal(size=(12, 12))
    L1 = _t(np.linalg.cholesky(A @ A.T + 12 * np.eye(12)))
    L2 = _t(np.linalg.cholesky(A.T @ A + 24 * np.eye(12)))
    alpha = _t(rng.normal(size=12))
    U, S = _t(prob["U"]), _t(prob["S"])
    spec = cov.make_spec("se", impl="torch")
    m, v = spec.fused_diag(prob["params"], U, S, L1, alpha, L2)
    Kus = cov.se_ard(prob["params"], U, S)
    A1 = linalg.tri_solve(L1, Kus.T)
    A2 = linalg.tri_solve(L2, Kus.T)
    sig2 = cov.signal_var(prob["params"])
    assert _err(m, Kus @ alpha) < TOL
    assert _err(v, sig2 - (A1 * A1).sum(0) + (A2 * A2).sum(0)) < TOL


def _spd(n, seed):
    A = np.random.default_rng(seed).normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


def test_linalg_matches():
    K, B = _spd(9, 0), np.random.default_rng(1).normal(size=(9, 4))
    L, jL = linalg.chol(_t(K)), jlinalg.chol(jnp.asarray(K))
    assert _err(L, jL) < TOL
    assert _err(linalg.add_jitter(_t(K)), jlinalg.add_jitter(jnp.asarray(K))) \
        < TOL
    assert linalg.default_jitter(torch.float64) == \
        jlinalg.default_jitter(jnp.float64)
    assert linalg.default_jitter(torch.float32) == \
        jlinalg.default_jitter(jnp.float32)
    assert _err(linalg.chol_solve(L, _t(B)),
                jlinalg.chol_solve(jL, jnp.asarray(B))) < TOL
    assert _err(linalg.chol_solve_right(L, _t(B.T)),
                jlinalg.chol_solve_right(jL, jnp.asarray(B.T))) < TOL
    assert _err(linalg.psd_solve(_t(K), _t(B)),
                jlinalg.psd_solve(jnp.asarray(K), jnp.asarray(B))) < TOL
    for trans in (False, True):
        assert _err(linalg.tri_solve(L, _t(B), trans=trans),
                    jlinalg.tri_solve(jL, jnp.asarray(B), trans=trans)) < TOL
    U = L.T.contiguous()
    assert _err(linalg.tri_solve(U, _t(B), lower=False),
                jlinalg.tri_solve(jnp.asarray(U.numpy()), jnp.asarray(B),
                                  lower=False)) < TOL
    assert _err(linalg.logdet_from_chol(L), jlinalg.logdet_from_chol(jL)) \
        < TOL


def test_linalg_batches_over_the_machine_axis():
    Ks = np.stack([_spd(6, s) for s in range(3)])
    Ls = linalg.chol(_t(Ks))
    for m in range(3):
        assert _err(Ls[m], jlinalg.chol(jnp.asarray(Ks[m]))) < TOL


def test_chol_of_non_pd_is_nan_like_the_reference():
    A = -np.eye(3)
    got = linalg.chol(_t(A), jitter=0.0)
    want = jlinalg.chol(jnp.asarray(A), jitter=0.0)
    assert np.isnan(np.asarray(want)).any()
    assert (torch.isnan(got).numpy() == np.isnan(np.asarray(want))).all()


@pytest.mark.parametrize("kernel", ["se", "spec"])
def test_icf_pivots_equal_and_factor_close(prob, kernel):
    C = np.random.default_rng(5).normal(size=(64, 3))
    kfn = cov.make_spec("se") if kernel == "spec" else cov.make_kernel("se")
    jkfn = jcov.make_spec("se") if kernel == "spec" \
        else jcov.make_kernel("se")
    got = icf.icf_factor(kfn, prob["params"], _t(C), 20)
    want = jicf.icf_factor(jkfn, prob["jparams"], jnp.asarray(C), 20)
    assert got.pivots.tolist() == np.asarray(want.pivots).tolist()
    assert _err(got.F, want.F) < 1e-10
    assert _err(got.residual, want.residual) < 1e-10
    S = support.select_support(kfn, prob["params"], _t(C), 20, device="cpu")
    jS = jsupport.select_support(jkfn, prob["jparams"], jnp.asarray(C), 20)
    assert _err(S, jS) == 0.0


def test_fgp_matches_reference(prob):
    kfn, jkfn = cov.make_kernel("se"), jcov.make_kernel("se")
    st = gp.fit(kfn, prob["params"], _t(prob["X"]), _t(prob["y"]))
    jst = jgp.fit(jkfn, prob["jparams"], jnp.asarray(prob["X"]),
                  jnp.asarray(prob["y"]))
    for f in ("X", "L", "alpha"):
        assert _err(getattr(st, f), getattr(jst, f)) < 1e-10
    U, jU = _t(prob["U"]), jnp.asarray(prob["U"])
    post = gp.predict_batch(kfn, prob["params"], st, U)
    jpost = jgp.predict_batch(jkfn, prob["jparams"], jst, jU)
    assert _err(post.mean, jpost.mean) < 1e-10
    assert _err(post.cov, jpost.cov) < 1e-10
    assert _err(post.var, jpost.var) < 1e-10
    m, v = gp.predict_batch_diag(kfn, prob["params"], st, U)
    jm, jv = jgp.predict_batch_diag(jkfn, prob["jparams"], jst, jU)
    assert _err(m, jm) < 1e-10 and _err(v, jv) < 1e-10
    dpost = gp.predict_batch(kfn, prob["params"], st, U, diag_only=True)
    assert _err(dpost.var, jv) < 1e-10
    assert _err(gp.nlml(kfn, prob["params"], _t(prob["X"]), _t(prob["y"])),
                jgp.nlml(jkfn, prob["jparams"], jnp.asarray(prob["X"]),
                         jnp.asarray(prob["y"]))) < 1e-9


def test_fgp_plan_matches_reference_plan(prob):
    spec = api.ServeSpec(max_batch=16)
    model = api.fit("fgp", cov.make_kernel("se"), prob["params"],
                    _t(prob["X"]), _t(prob["y"]), device="cpu")
    jmodel = japi.fit("fgp", jcov.make_kernel("se"), prob["jparams"],
                      jnp.asarray(prob["X"]), jnp.asarray(prob["y"]))
    m, v = model.plan(spec).diag(_t(prob["U"]))
    jm, jv = jmodel.plan(japi.ServeSpec(max_batch=16)).diag(prob["U"])
    assert _err(m, jm) < 1e-10 and _err(v, jv) < 1e-10


def test_default_buckets_match_reference_grid():
    for max_batch in (1, 3, 7, 8, 9, 31, 64, 100, 256, 1000):
        for min_bucket in (1, 4, 8, 16):
            for block_q in (1, 3, 8, 16, 256):
                kw = dict(min_bucket=min_bucket, block_q=block_q)
                assert api.default_buckets(max_batch, **kw) == \
                    japi.default_buckets(max_batch, **kw)
    for bad in (dict(max_batch=0), dict(max_batch=8, min_bucket=0),
                dict(max_batch=8, block_q=0)):
        with pytest.raises(ValueError):
            api.default_buckets(**bad)


def test_runner_blocks_match_reference():
    X = np.arange(30.0).reshape(10, 3)
    r, jr = runner.VmapRunner(M=5), jrunner.VmapRunner(M=5)
    assert _err(r.shard_blocks(_t(X)), jr.shard_blocks(jnp.asarray(X))) == 0
    assert _err(r.unshard(r.shard_blocks(_t(X))), X) == 0
    with pytest.raises(ValueError, match="does not divide"):
        runner.VmapRunner(M=3).shard_blocks(_t(X))
    for M in (3, 4):
        got, n = runner.pad_blocks(_t(X), M)
        want, jn = jrunner.pad_blocks(jnp.asarray(X), M)
        assert n == jn and _err(got, want) == 0
    assert runner.ROUTED_ALPHA == jrunner.ROUTED_ALPHA
    assert r.map(lambda a, b: a + b, (_t(X),), (1.0,)).shape == (10, 3)


def test_synthetic_data_shapes_and_statistics():
    ds = synthetic.aimpeak_like(n=400, n_test=40, seed=3, device="cpu")
    assert ds.X.shape == (400, 5) and ds.X_test.shape == (40, 5)
    assert float(ds.X.min()) >= -2.0 and float(ds.X.max()) <= 2.0
    y = torch.cat([ds.y, ds.y_test])
    assert abs(float(y.mean()) - 49.5) < 5.0
    sd = synthetic.standardize(ds)
    assert abs(float(torch.cat([sd.y, sd.y_test]).std()) - 1.04) < 0.2
    again = synthetic.aimpeak_like(n=400, n_test=40, seed=3, device="cpu")
    torch.testing.assert_close(again.X, ds.X, rtol=0, atol=0)
    assert synthetic.sarcos_like(n=8, n_test=2, device="cpu").X.shape == (8, 21)


def test_experiment_grid_is_the_reference_grid():
    for domain in ("aimpeak", "sarcos"):
        assert dataclasses.asdict(texp.PAPER_GRID[domain]) == \
            dataclasses.asdict(jexp.PAPER_GRID[domain])
        assert dataclasses.asdict(texp.scaled_grid(domain)) == \
            dataclasses.asdict(jexp.scaled_grid(domain))
